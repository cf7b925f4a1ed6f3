"""Port parity for the recurrent families: ``ssm`` (xLSTM,
``repro_torch.models.xlstm``) and ``hybrid`` (zamba2: Mamba2 and a shared
attention block, ``repro_torch.models.hybrid``), against the JAX package
on the CPU.

- Logits of ``forward``, an equal-length ``prefill`` and 8 teacher-forced
  ``decode_step``s on ``xlstm-1.3b.reduced()`` and
  ``zamba2-1.2b.reduced()`` (f32) and on ``tests/test_decode_steps.py``'s
  ``SSM`` and ``HYBRID`` configs (the latter with a remainder Mamba
  layer), with f32 and int8 weights carried across from JAX (the 4-D
  ``[n_super, m_per, K, N]`` QTensors among them), with and without
  ``fuse_params``: rtol 1e-4 with an atol of 1e-4 times the logit scale,
  as in ``tests/test_torch_model.py`` (other orders of f32 additions).
- ``init_cache``'s leaves have JAX's shapes, and ``cache_spec`` names the
  one axis that changes with the batch.
- ``decode_steps(n)`` gives the tokens of n sequential decodes.
- The serving engine: greedy tokens and every integer ``EngineStats``
  counter equal to the JAX engine's on mixed prompt lengths (so a wave
  splits into equal-length sub-waves) in four modes: dense int8, the
  reuse matmul, fused projections, and overload (a queue deadline, a
  cancel, and a priority arrival preempting a running slot, which
  restores by recompute); the ``n_super == n_slots`` regression of
  ``tests/test_serve.py``; the JAX engine's refusals (paged, speculate,
  adapters, a prefill budget without paging); and the token gate on the
  served tokens.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import REGISTRY as J_REGISTRY
from repro.configs.base import ModelConfig as JModelConfig
from repro.core import quantization as JQ
from repro.core.axllm_linear import deploy_quantize as j_deploy
from repro.launch.serve import make_synthetic_adapters as j_adapters
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.core.axllm_linear import deploy_quantize
from repro_torch.core.quantization import QTensor, QuantConfig
from repro_torch.models.model import get_model
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.decode import decode_steps
from repro_torch.serve.engine import ServeEngine, _leaves
from repro_torch.serve.token_gate import token_gate
from test_torch_engine import jax_tree_to_numpy
from test_torch_moe import STATS

OVERRIDES = dict(dtype="float32", remat=False)
SMALL = {   # tests/test_decode_steps.py's SSM and HYBRID configs
    "SSM": dict(name="x", family="ssm", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=4, d_ff=0, vocab_size=256, vocab_pad_multiple=64,
                xlstm_slstm_every=2, dtype="float32", remat=False),
    "HYBRID": dict(name="h", family="hybrid", n_layers=5, d_model=64,
                   n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                   head_dim=16, vocab_pad_multiple=64, ssm_state=16,
                   ssm_head_dim=16, hybrid_attn_every=2, dtype="float32",
                   remat=False),
}
CONFIGS = ("xlstm-1.3b", "zamba2-1.2b", "SSM", "HYBRID")


def cfgs(name):
    """(JAX config, port config) of a registered name or a SMALL key."""
    if name in SMALL:
        return JModelConfig(**SMALL[name]), ModelConfig(**SMALL[name])
    return (J_REGISTRY[name].reduced(**OVERRIDES),
            get_config(name).reduced(**OVERRIDES))


@pytest.fixture(scope="module")
def weights():
    """Per config: the JAX weights (f32) and their port copies."""
    out = {}
    for name in CONFIGS:
        jcfg, tcfg = cfgs(name)
        jp = j_get_model(jcfg).init(jax.random.PRNGKey(0))
        out[name] = (jcfg, tcfg, jp,
                     params_from_numpy(jax_tree_to_numpy(jp), "cpu"))
    return out


def _close(got, want, atol_factor=1e-4):
    want = np.asarray(want, np.float32)
    atol = atol_factor * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=1e-4,
                               atol=atol)


MAX_LEN = 40


@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fused"])
@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", CONFIGS)
def test_forward_prefill_decode_match_jax(weights, name, quant, fuse):
    jcfg, tcfg, jparams, _ = weights[name]
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    if quant:
        jparams = j_deploy(jparams, JQ.QuantConfig())
    if fuse:
        jparams = japi.fuse_params(jparams)
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    if quant and tcfg.family == "ssm":
        wq = tparams["mlstm"]["wqk" if fuse else "wq"]
        assert isinstance(wq, QTensor) and wq.codes.ndim == 4
    rng = np.random.default_rng(1)
    b, s = 3, 16
    toks = rng.integers(0, jcfg.vocab_size, size=(b, s)).astype(np.int32)

    _close(tapi.forward(tparams, {"tokens": torch.from_numpy(toks)}),
           japi.forward(jparams, {"tokens": jnp.asarray(toks)}))
    jlog, jcache = jax.jit(japi.prefill)(
        jparams, {"tokens": jnp.asarray(toks)}, japi.init_cache(b, MAX_LEN))
    tlog, tcache = tapi.prefill(
        tparams, {"tokens": torch.from_numpy(toks)},
        tapi.init_cache(b, MAX_LEN, "cpu"))
    _close(tlog, jlog)
    jdecode = jax.jit(japi.decode)
    for _ in range(8):
        nxt = np.array(jnp.argmax(jlog[:, :jcfg.vocab_size], -1), np.int32)
        jlog, jcache = jdecode(jparams, jnp.asarray(nxt), jcache)
        tlog, tcache = tapi.decode(tparams, torch.from_numpy(nxt), tcache)
        _close(tlog, jlog)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))


@pytest.mark.parametrize("name", CONFIGS)
def test_cache_layout_matches_jax(name):
    """The port's cache has JAX's leaves, shapes and spec, and each
    spec axis is the one that changes with the batch."""
    jcfg, tcfg = cfgs(name)
    japi, tapi = j_get_model(jcfg), get_model(tcfg)
    assert jax.tree_util.tree_structure(japi.cache_spec) == \
        jax.tree_util.tree_structure(tapi.cache_spec)
    c3, c5 = tapi.init_cache(3, 16, "cpu"), tapi.init_cache(5, 16, "cpu")
    j3 = jax.eval_shape(lambda: japi.init_cache(3, 16))
    spec = tapi.cache_spec
    assert [tuple(t.shape) for t in jax.tree_util.tree_leaves(c3)] == \
        [tuple(j.shape) for j in jax.tree_util.tree_leaves(j3)]
    for (a, ax), (b, _) in zip(_leaves(c3, spec), _leaves(c5, spec)):
        assert [i for i, (x, y) in enumerate(zip(a.shape, b.shape))
                if x != y] == [ax]


@pytest.mark.parametrize("quant", [False, True], ids=["fp32", "int8"])
@pytest.mark.parametrize("name", ["SSM", "HYBRID"])
def test_decode_steps_equal_sequential_decodes(weights, name, quant):
    _, tcfg, _, tparams = weights[name]
    api = get_model(tcfg)
    if quant:
        tparams = deploy_quantize(tparams, QuantConfig())
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, tcfg.vocab_size, size=(2, 6)).astype(np.int32))

    def start():
        logits, cache = api.prefill(tparams, {"tokens": toks},
                                    api.init_cache(2, 32, "cpu"))
        return torch.argmax(logits[:, :tcfg.vocab_size], -1).int(), cache

    last, cache = start()
    seq = []
    for _ in range(5):
        logits, cache = api.decode(tparams, last, cache)
        last = torch.argmax(logits[:, :tcfg.vocab_size], -1).int()
        seq.append(last)
    last, cache = start()
    out = decode_steps(api.decode, tparams, last, cache, None,
                       torch.zeros(2, dtype=torch.bool),
                       torch.zeros(2, dtype=torch.int32),
                       torch.full((2,), 100, dtype=torch.int32), n=5,
                       vocab_size=tcfg.vocab_size, max_len=32)
    assert torch.equal(out.tokens, torch.stack(seq))
    assert bool(out.valid.all())


# ---------------------------------------------------------------------------
# the serving engine against the JAX engine
# ---------------------------------------------------------------------------

# mixed lengths with repeats: a wave of three admits two sub-waves
PROMPTS = [np.arange(8) + 1, np.arange(12) + 3, np.arange(8) + 40,
           np.arange(31) + 7, np.arange(12) + 90, np.arange(8) + 60]
ENGINE_KW = dict(n_slots=3, max_len=64, decode_chunk=4, quantize=True)


def _overload(eng_cls, cfg, params, **kw):
    """A queue deadline, a cancel and a priority arrival that preempts a
    running slot (dense mode: a recompute restore), on an injected
    clock."""
    clock = itertools.count()
    eng = eng_cls(cfg, params, clock=lambda: float(next(clock)), **kw)
    for p in PROMPTS[:3]:
        eng.submit(p, max_new=8)
    eng.step()
    eng.submit(PROMPTS[3], max_new=8, deadline_s=0.0)
    gone = eng.submit(PROMPTS[4], max_new=8)
    eng.cancel(gone)
    eng.submit(PROMPTS[5], max_new=8, priority=3)
    eng.run()
    return eng, {r.rid: (list(r.tokens), r.finish_reason)
                 for r in eng.finished}


ENGINE_MODES = {"dense": dict(), "reuse": dict(impl="reuse"),
                "fused": dict(fuse_qkv=True), "overload": dict()}


@pytest.mark.parametrize("mode", list(ENGINE_MODES))
@pytest.mark.parametrize("name", ["SSM", "HYBRID"])
def test_engine_matches_jax_engine(weights, name, mode):
    jcfg, tcfg, jparams, tparams = weights[name]
    kw = dict(ENGINE_KW, **ENGINE_MODES[mode])
    if mode == "overload":
        jeng, want = _overload(JServeEngine, jcfg, jparams, **kw)
        teng, got = _overload(ServeEngine, tcfg, tparams, device="cpu", **kw)
        assert teng.stats.preempted == 1 and teng.stats.restored == 1
        assert teng.stats.expired == 1 and teng.stats.cancelled == 1
    else:
        jeng = JServeEngine(jcfg, jparams, **kw)
        teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
        want = jeng.generate(PROMPTS, max_new=8)
        got = teng.generate(PROMPTS, max_new=8)
    assert got == want
    for stat in STATS:
        assert getattr(teng.stats, stat) == getattr(jeng.stats, stat), stat
    # sub-waves: more waves than a ragged engine would need
    assert teng.stats.prefill_waves > 2


def test_nslots_collides_with_stacked_dim(weights):
    """n_slots == n_super on xLSTM (4 layers, an sLSTM every 2): slot
    writes follow cache_spec's batch axis, not the first axis of the
    right size. Each request's tokens equal a solo engine's and the JAX
    engine's."""
    kw = dict(name="sx4", family="ssm", n_layers=4, d_model=64, n_heads=4,
              n_kv_heads=4, d_ff=0, vocab_size=256, vocab_pad_multiple=64,
              xlstm_slstm_every=2, dtype="float32", remat=False)
    jcfg, tcfg = JModelConfig(**kw), ModelConfig(**kw)
    jp = j_get_model(jcfg).init(jax.random.PRNGKey(1))
    tp = params_from_numpy(jax_tree_to_numpy(jp), "cpu")
    prompts = [np.arange(6), np.arange(6) + 50, np.arange(6) + 100]
    eng = ServeEngine(tcfg, tp, n_slots=2, max_len=64, device="cpu")
    assert eng.cache["mlstm"][1].shape[:3] == (2, 1, 2)   # n_super, m, B
    outs = eng.generate(prompts, max_new=5)
    for pr, o in zip(prompts, outs):
        solo = ServeEngine(tcfg, tp, n_slots=1, max_len=64, device="cpu")
        assert o == solo.generate([pr], max_new=5)[0]
    assert outs == JServeEngine(jcfg, jp, n_slots=2, max_len=64).generate(
        prompts, max_new=5)


REFUSALS = {
    "paged": (dict(paged=True), "has no paged KV cache path"),
    "speculate": (dict(speculate=True), "has no speculative path"),
    "budget": (dict(prefill_budget=32), "prefill_budget requires paged"),
}


@pytest.mark.parametrize("what", list(REFUSALS) + ["adapters"])
@pytest.mark.parametrize("name", ["SSM", "HYBRID"])
def test_engine_refusals_match_jax(weights, name, what):
    jcfg, tcfg, jparams, tparams = weights[name]
    if what == "adapters":
        jkw = dict(adapters=j_adapters(jcfg, 1)[0])
        tkw = dict(adapters=make_synthetic_adapters(tcfg, 1,
                                                    device="cpu")[0])
        match = "has no multi-LoRA serving path"
    else:
        jkw, match = REFUSALS[what]
        tkw = jkw
    with pytest.raises(ValueError, match=match) as jerr:
        JServeEngine(jcfg, jparams, **jkw)
    with pytest.raises(ValueError, match=match) as terr:
        ServeEngine(tcfg, tparams, device="cpu", **tkw)
    assert str(terr.value) == str(jerr.value)


@pytest.mark.parametrize("impl", ["auto", "reuse"])
@pytest.mark.parametrize("name", ["SSM", "HYBRID"])
def test_token_gate_passes_on_served_tokens(weights, name, impl):
    """The one-pass teacher-forced gate applies to a recurrent family: a
    position's output does not depend on how its wave was batched
    (sub-waves carry no padding). The served tokens are the plain
    path's argmax at every position."""
    _, tcfg, _, tparams = weights[name]
    eng = ServeEngine(tcfg, tparams, device="cpu", impl=impl, **ENGINE_KW)
    served = eng.generate(PROMPTS, max_new=8)
    gate = token_gate(tcfg, eng.params, PROMPTS, served,
                      impl="reuse_ref" if impl == "reuse" else "ref",
                      tol_rel=5e-2, device="cpu")
    assert gate.ok and gate.positions == 8 * len(PROMPTS)
    assert gate.differ == 0
