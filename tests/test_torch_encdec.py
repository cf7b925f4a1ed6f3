"""Port parity for the audio family (``repro_torch.models.encdec``,
whisper) against ``repro.models.encdec`` on the CPU.

Configs: ``tests/test_decode_steps.py``'s ``AUDIO`` (RMSNorm, one encoder
layer, 9 frames) and a LayerNorm variant with two encoder layers, f32;
the JAX weights are carried across by ``bridge.params_from_numpy``, and
the same numpy-made frames and tokens go through both packages.

- ``encode``, ``forward``, ``loss_fn``, a plain and a ragged ``prefill``,
  a decoder prompt of 12 tokens against 9 frames (Sq > Sk in
  cross-attention), and 6 teacher-forced ``decode_step``s, with f32 and
  int8 weights, fused and not: rtol 1e-4 with an atol of 1e-4 times the
  scale, as ``tests/test_torch_model.py`` (the two frameworks add f32 in
  other orders; the sinusoids' pow/sin/cos differ in the last ulp). The
  caches the prefill writes (self KV, cross KV, cursor) are held to the
  same tolerance.
- ``decode_steps``: greedy tokens identical to the JAX package's and to
  sequential decodes, f32 and int8.
- ``fuse_params`` gives the unfused logits (same tolerance).
- ``init_cache`` has JAX's leaves and shapes, ``cache_spec`` names the one
  axis that changes with the batch (``tests/test_serve.py``'s ``i-aud``
  config among them).
- In bf16 the types flow as in JAX: prefill logits f32, decode logits and
  caches bf16.
- The whisper-small config equals JAX's and ``tests/test_models.py``'s
  numbers; ``ServeEngine`` refuses an encoder-decoder config with the JAX
  engine's text; ``make_batch`` makes frames of the config's shape; the
  token gate holds served tokens on their own frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import quantization as JQ
from repro.core.axllm_linear import deploy_quantize as j_deploy
from repro.models import encdec as JE
from repro.models.model import get_model as j_get_model
from repro.serve.decode import decode_steps as j_decode_steps
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec as E
from repro_torch.models.model import get_model, make_batch
from repro_torch.serve.decode import decode_steps
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.token_gate import token_gate
from test_torch_engine import jax_tree_to_numpy

AUDIO = dict(name="a", family="audio", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
             vocab_pad_multiple=64, act="gelu", is_encoder_decoder=True,
             n_enc_layers=1, enc_seq=9, d_feat=4, dtype="float32",
             remat=False)
CONFIGS = {"AUDIO": AUDIO,
           "AUDIO_LN": dict(AUDIO, name="a-ln", norm="layernorm",
                            n_enc_layers=2)}
MAX_LEN = 32
B, S = 3, 8
LENGTHS = np.array([5, 8, 3], np.int32)


@pytest.fixture(scope="module")
def weights():
    """Per config: (JAX config, port config, JAX f32 weights)."""
    out = {}
    for name, kw in CONFIGS.items():
        jcfg = JModelConfig(**kw)
        out[name] = (jcfg, ModelConfig(**kw),
                     j_get_model(jcfg).init(jax.random.PRNGKey(0)))
    return out


def _variant(jcfg, jparams, quant, fuse):
    """The JAX weights quantized and fused as asked, and their port copy."""
    if quant:
        jparams = j_deploy(jparams, JQ.QuantConfig())
    if fuse:
        jparams = JE.fuse_params(jparams, jcfg)
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


def _inputs(cfg, b=B, s=S, seed=1):
    rng = np.random.default_rng(seed)
    frames = rng.standard_normal((b, cfg.enc_seq, cfg.d_feat)
                                 ).astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    return frames, toks


def _close(got, want, atol_factor=1e-4):
    want = np.asarray(want, np.float32)
    atol = atol_factor * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().float().numpy(), want,
                               rtol=1e-4, atol=atol)


def _jbatch(frames, toks):
    return {"frames": jnp.asarray(frames), "tokens": jnp.asarray(toks)}


def _tbatch(frames, toks):
    return {"frames": torch.from_numpy(frames),
            "tokens": torch.from_numpy(toks)}


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_encode_forward_loss_match_jax(weights, name, quant):
    jcfg, tcfg, jparams = weights[name]
    jparams, tparams = _variant(jcfg, jparams, quant, False)
    frames, toks = _inputs(jcfg)
    _close(E.encode(tparams, torch.from_numpy(frames), tcfg),
           JE.encode(jparams, jnp.asarray(frames), jcfg))
    _close(E.forward(tparams, _tbatch(frames, toks), tcfg),
           JE.forward(jparams, _jbatch(frames, toks), jcfg))
    targets = np.roll(toks, -1, axis=1)
    jl = JE.loss_fn(jparams, {**_jbatch(frames, toks),
                              "targets": jnp.asarray(targets)}, jcfg)
    tl = E.loss_fn(tparams, {**_tbatch(frames, toks),
                             "targets": torch.from_numpy(targets)}, tcfg)
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-5)


# plain: every row S tokens; ragged: right-padded rows of LENGTHS; long: a
# 12-token decoder prompt against 9 frames (Sq > Sk in cross-attention)
PREFILLS = {"plain": (S, None), "ragged": (S, LENGTHS), "long": (12, None)}


@pytest.mark.parametrize("fuse", [False, True], ids=["unfused", "fused"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("case", sorted(PREFILLS))
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_prefill_and_decode_match_jax(weights, name, case, quant, fuse):
    jcfg, tcfg, jparams = weights[name]
    jparams, tparams = _variant(jcfg, jparams, quant, fuse)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    s, lengths = PREFILLS[case]
    frames, toks = _inputs(jcfg, s=s)
    assert s > jcfg.enc_seq or case != "long"
    jl = None if lengths is None else jnp.asarray(lengths)
    tl = None if lengths is None else torch.from_numpy(lengths)
    jlog, jcache = jax.jit(japi.prefill)(
        jparams, _jbatch(frames, toks), japi.init_cache(B, MAX_LEN),
        lengths=jl)
    tlog, tcache = tapi.prefill(tparams, _tbatch(frames, toks),
                                tapi.init_cache(B, MAX_LEN, "cpu"),
                                lengths=tl)
    _close(tlog, jlog)
    assert sorted(tcache) == sorted(jcache)
    for leaf in ("k", "v", "cross_k", "cross_v"):
        _close(tcache[leaf], jcache[leaf])
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    jdecode = jax.jit(japi.decode)
    for _ in range(6):
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1), np.int32)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
        _close(tlog, jlog)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_fuse_params_equals_unfused(weights, name):
    jcfg, tcfg, jparams = weights[name]
    _, plain = _variant(jcfg, jparams, True, False)
    fused = E.fuse_params(plain, tcfg)
    assert "wkv" in fused["dec_layers"]["cross_attn"]
    assert "wq" in fused["dec_layers"]["cross_attn"]
    assert "wqkv" in fused["enc_layers"]["attn"]
    assert E.fuse_params(fused, tcfg)["dec_layers"]["cross_attn"].keys() \
        == fused["dec_layers"]["cross_attn"].keys()
    frames, toks = _inputs(jcfg)
    _close(E.forward(fused, _tbatch(frames, toks), tcfg),
           E.forward(plain, _tbatch(frames, toks), tcfg).numpy())


@pytest.mark.parametrize("quant", [False, True], ids=["fp", "axllm-int8"])
def test_decode_steps_tokens_match_jax(weights, quant):
    """``tests/test_decode_steps.py``'s audio case on both packages: the
    chunked greedy tokens equal JAX's and sequential decodes'."""
    jcfg, tcfg, jparams = weights["AUDIO"]
    jparams, tparams = _variant(jcfg, jparams, quant, False)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    b, n = 2, 5
    frames, toks = _inputs(jcfg, b=b, s=6, seed=2)
    jlog, jcache = japi.prefill(jparams, _jbatch(frames, toks),
                                japi.init_cache(b, MAX_LEN))
    tlog, tcache = tapi.prefill(tparams, _tbatch(frames, toks),
                                tapi.init_cache(b, MAX_LEN, "cpu"))
    jlast = jnp.argmax(jlog[:, :jcfg.vocab_size], -1).astype(jnp.int32)
    tlast = torch.argmax(tlog[:, :tcfg.vocab_size], -1).to(torch.int32)
    np.testing.assert_array_equal(tlast.numpy(), np.asarray(jlast))
    jout = j_decode_steps(
        japi.decode, jparams, jlast, jcache, jax.random.PRNGKey(0),
        jnp.zeros((b,), bool), jnp.ones((b,), jnp.int32),
        jnp.full((b,), n + 10, jnp.int32), n=n,
        vocab_size=jcfg.vocab_size, max_len=MAX_LEN)
    seq_cache = {k: v.clone() for k, v in tcache.items()}
    tout = decode_steps(
        tapi.decode, tparams, tlast, tcache, None,
        torch.zeros((b,), dtype=torch.bool),
        torch.ones((b,), dtype=torch.int32),
        torch.full((b,), n + 10, dtype=torch.int32), n=n,
        vocab_size=tcfg.vocab_size, max_len=MAX_LEN)
    assert bool(tout.valid.all())
    np.testing.assert_array_equal(tout.tokens.numpy(),
                                  np.asarray(jout.tokens))
    last, seq = tlast, []
    for _ in range(n):
        logits, seq_cache = tapi.decode(tparams, last, seq_cache)
        last = torch.argmax(logits[:, :tcfg.vocab_size], -1).to(torch.int32)
        seq.append(last)
    np.testing.assert_array_equal(torch.stack(seq).numpy(),
                                  tout.tokens.numpy())


I_AUD = dict(name="i-aud", family="audio", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, d_ff=128, vocab_size=256, head_dim=16,
             vocab_pad_multiple=64, is_encoder_decoder=True, n_enc_layers=1,
             enc_seq=9, d_feat=4, dtype="float32")


@pytest.mark.parametrize("kw", [AUDIO, I_AUD, dict(AUDIO, quant_kv=True)],
                         ids=["AUDIO", "i-aud", "int8-kv"])
def test_cache_layout_matches_jax(kw):
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    assert tapi.cache_spec == japi.cache_spec
    for b in (3, 5):
        jc = jax.eval_shape(lambda: japi.init_cache(b, 16))
        tc = tapi.init_cache(b, 16, "cpu")
        assert sorted(tc) == sorted(jc)
        for k in jc:
            assert tuple(tc[k].shape) == tuple(jc[k].shape), k
            assert str(tc[k].dtype).split(".")[-1] == str(jc[k].dtype), k
    c3, c5 = tapi.init_cache(3, 16, "cpu"), tapi.init_cache(5, 16, "cpu")
    for k, ax in tapi.cache_spec.items():
        diff = [i for i, (x, y) in enumerate(zip(c3[k].shape, c5[k].shape))
                if x != y]
        assert diff == [ax], k


def test_bf16_dtype_flow_matches_jax(weights):
    """In bf16 the encoder and prefill streams are f32 (the frontend takes
    f32 frames), the prefill logits f32, the caches bf16 and the decode
    logits bf16, as in JAX; the logits agree within 2e-2 of their scale
    (bf16 weights and a bf16 decode step)."""
    kw = dict(AUDIO, dtype="bfloat16")
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    jparams = japi.init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    frames, toks = _inputs(jcfg, s=12)
    lengths = np.array([12, 4, 9], np.int32)
    jlog, jcache = japi.prefill(jparams, _jbatch(frames, toks),
                                japi.init_cache(B, MAX_LEN),
                                lengths=jnp.asarray(lengths))
    tlog, tcache = tapi.prefill(tparams, _tbatch(frames, toks),
                                tapi.init_cache(B, MAX_LEN, "cpu"),
                                lengths=torch.from_numpy(lengths))
    assert (str(jlog.dtype), tlog.dtype) == ("float32", torch.float32)
    for k in ("k", "v", "cross_k", "cross_v"):
        assert (str(jcache[k].dtype), tcache[k].dtype) == \
            ("bfloat16", torch.bfloat16), k
    _close(tlog, jlog, atol_factor=2e-2)
    nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1), np.int32)
    jlog, _ = japi.decode(jparams, jnp.asarray(nxt), jcache)
    tlog, _ = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
    assert (str(jlog.dtype), tlog.dtype) == ("bfloat16", torch.bfloat16)
    want = np.asarray(jlog, np.float32)
    err = float(np.abs(tlog.float().numpy() - want).max())
    assert err <= 2e-2 * max(1.0, float(np.abs(want).max()))


def test_whisper_small_config_matches_jax():
    t, j = get_config("whisper-small"), J_REGISTRY["whisper-small"]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    assert (t.n_layers, t.d_model, t.n_heads, t.n_kv_heads, t.d_ff,
            t.vocab_size) == (12, 768, 12, 12, 3072, 51865)
    assert t.is_encoder_decoder and t.family == "audio"
    assert (t.n_enc_layers, t.enc_seq, t.d_feat, t.padded_vocab) == \
        (12, 1500, 80, 51968)
    assert t.n_params() == j.n_params()
    small = dict(dtype="float32", remat=False)
    assert dataclasses.asdict(t.reduced(**small)) == \
        dataclasses.asdict(j.reduced(**small))
    api = get_model(t)
    assert api.ragged_prefill and not api.supports_lora
    assert api.init_paged_cache is None


def test_engine_refuses_encoder_decoder(weights):
    jcfg, tcfg, jparams = weights["AUDIO"]
    with pytest.raises(NotImplementedError) as jerr:
        JServeEngine(jcfg, jparams)
    with pytest.raises(NotImplementedError) as terr:
        ServeEngine(tcfg, None, mesh="refused later", paged=True,
                    device="cpu")
    assert str(terr.value) == str(jerr.value)


def test_make_batch_shapes():
    cfg = ModelConfig(**AUDIO)
    gen = torch.Generator().manual_seed(0)
    batch = make_batch(cfg, gen, 2, 5, device="cpu")
    assert tuple(batch["frames"].shape) == (2, cfg.enc_seq, cfg.d_feat)
    assert batch["frames"].dtype == torch.float32
    assert batch["tokens"].dtype == torch.int32
    assert int(batch["tokens"].max()) < cfg.vocab_size
    assert torch.equal(batch["targets"], torch.roll(batch["tokens"], -1, 1))
    again = make_batch(cfg, 0, 2, 5, device="cpu")
    assert torch.equal(again["frames"], make_batch(cfg, 0, 2, 5, "cpu")
                       ["frames"])
    assert "frames" not in make_batch(get_config("repro-100m").reduced(), 0,
                                      1, 4, device="cpu")


def test_token_gate_holds_served_tokens_on_their_frames(weights):
    """Greedy tokens of a ragged prefill and ``decode_steps`` pass the gate
    against the plain path on their own frames, and fail it on another
    request's frames."""
    jcfg, tcfg, jparams = weights["AUDIO_LN"]
    _, tparams = _variant(jcfg, jparams, True, False)
    api = get_model(tcfg)
    frames, toks = _inputs(jcfg, s=S)
    lengths = torch.from_numpy(LENGTHS)
    logits, cache = api.prefill(tparams, _tbatch(frames, toks),
                                api.init_cache(B, MAX_LEN, "cpu"),
                                lengths=lengths)
    first = torch.argmax(logits[:, :tcfg.vocab_size], -1).to(torch.int32)
    out = decode_steps(api.decode, tparams, first, cache, None,
                       torch.zeros((B,), dtype=torch.bool),
                       torch.ones((B,), dtype=torch.int32),
                       torch.full((B,), 6, dtype=torch.int32), n=5,
                       vocab_size=tcfg.vocab_size, max_len=MAX_LEN)
    prompts = [toks[i, :LENGTHS[i]] for i in range(B)]
    generated = [[int(first[i])] + out.tokens[:, i].tolist()
                 for i in range(B)]
    gate = token_gate(tcfg, tparams, prompts, generated, impl="ref",
                      tol_rel=1e-3, device="cpu", frames=list(frames))
    assert gate.ok and gate.positions == 6 * B
    assert gate.differ == 0
    swapped = token_gate(tcfg, tparams, prompts, generated, impl="ref",
                         tol_rel=1e-3, device="cpu",
                         frames=[frames[(i + 1) % B] for i in range(B)])
    assert swapped.min_slack < gate.min_slack
