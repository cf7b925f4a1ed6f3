"""Port parity for multi-LoRA serving: the LoRA functions of
``core/axllm_linear.py``, the adapter registry's lifecycle, and the engine
serving mixed batches of base and adapter requests, against the JAX
package on the same weights, adapters and prompts. Adapters are drawn
with numpy and carried across by ``bridge.registry_from_numpy``.

Tolerances: the gathered delta and the LoRA products in float32 sum in
other orders than XLA's: rtol 1e-5 with an atol of 1e-5 times the output
scale. Rows with adapter -1 must be exact zeros. Greedy tokens and the
scheduler's counters must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.core import axllm_linear as JAL
from repro.core import quantization as JQ
from repro.models.model import get_model as j_get_model
from repro.serve.adapters import AdapterRegistry as JAdapterRegistry
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy, registry_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.core import axllm_linear as AL
from repro_torch.core import quantization as TQ
from repro_torch.kernels import ops
from repro_torch.models.model import get_model
from repro_torch.serve.adapters import AdapterRegistry, target_dims
from repro_torch.serve.engine import ServeEngine
from test_torch_engine import jax_tree_to_numpy
from test_torch_reuse import CFG_FIELDS

JCFG, TCFG = JModelConfig(**CFG_FIELDS), ModelConfig(**CFG_FIELDS)
LORA = dict(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
JLCFG, TLCFG = JAL.LoRAConfig(**LORA), AL.LoRAConfig(**LORA)


def _close(got, want, rtol=1e-5):
    want = np.asarray(want, np.float32)
    atol = rtol * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=rtol,
                               atol=atol)


def make_adapter(seed, scale=0.3, targets=None, rank=4):
    """Random numpy adapter with a non-zero B, so it changes tokens."""
    rng = np.random.default_rng(seed)
    ad = {}
    for t in targets or TLCFG.targets:
        n_in, n_out = target_dims(TCFG, t)
        ad[t] = {"lora_a": (rng.standard_normal((TCFG.n_layers, n_in, rank))
                            / np.sqrt(rank)).astype(np.float32),
                 "lora_b": (rng.standard_normal((TCFG.n_layers, rank, n_out))
                            * scale).astype(np.float32)}
    return ad


def _jax_adapter(ad):
    return {t: {k: jnp.asarray(v) for k, v in ab.items()}
            for t, ab in ad.items()}


def carry_registry(jreg, device="cpu"):
    """The port's copy of a JAX registry: its stacked arrays and row names
    through the bridge."""
    names = [None] * jreg.max_loras
    for n in jreg.names:
        names[jreg.index_of(n)] = n
    stacked = {t: {k: np.asarray(v) for k, v in ab.items()}
               for t, ab in jreg.stacked.items()}
    return registry_from_numpy(TCFG, stacked, names, TLCFG, device=device)


def registries(*named_seeds, max_loras=3):
    jreg = JAdapterRegistry(JCFG, JLCFG, max_loras=max_loras)
    for name, seed in named_seeds:
        jreg.add(name, _jax_adapter(make_adapter(seed)))
    return jreg, carry_registry(jreg)


@pytest.fixture(scope="module")
def weights():
    jparams = j_get_model(JCFG).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


# ---------------------------------------------------------------------------
# the LoRA functions
# ---------------------------------------------------------------------------

def test_delta_batched_matches_jax_and_unbatched_rows():
    """Row i of the gathered delta equals JAX's and the unbatched
    two-matmul delta of adapter idx[i]; -1 rows are exact zeros."""
    rng = np.random.default_rng(0)
    n_ad, n_in, r, n_out = 3, 16, 4, 24
    a = rng.standard_normal((n_ad, n_in, r)).astype(np.float32)
    b = rng.standard_normal((n_ad, r, n_out)).astype(np.float32)
    x = rng.standard_normal((4, 5, n_in)).astype(np.float32)
    idx = np.asarray([2, -1, 0, 1], np.int32)
    want = np.asarray(JAL.lora_delta_batched(
        jnp.asarray(x), {"lora_a": jnp.asarray(a), "lora_b": jnp.asarray(b)},
        jnp.asarray(idx), 0.5))
    got = AL.lora_delta_batched(
        torch.from_numpy(x), {"lora_a": torch.from_numpy(a),
                              "lora_b": torch.from_numpy(b)},
        torch.from_numpy(idx), 0.5)
    assert got.shape == (4, 5, n_out) and got.dtype == torch.float32
    assert not got[1].any() and not want[1].any()
    _close(got, want)
    for i, j in ((0, 2), (2, 0), (3, 1)):
        _close(got[i], 0.5 * (x[i] @ a[j]) @ b[j])


def test_delta_batched_all_base_is_zero():
    stack = {"lora_a": torch.ones(2, 8, 4), "lora_b": torch.ones(2, 4, 8)}
    out = AL.lora_delta_batched(torch.ones(3, 8), stack,
                                torch.full((3,), -1, dtype=torch.int32), 2.0)
    assert out.shape == (3, 8) and not out.any()


@pytest.mark.parametrize("quantized", [False, True], ids=["fp32", "int8"])
def test_lora_linear_matmul_merge_match_jax(quantized):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((6, 64)).astype(np.float32)
    w = rng.standard_normal((64, 48)).astype(np.float32)
    ad = {"lora_a": rng.standard_normal((64, 4)).astype(np.float32),
          "lora_b": rng.standard_normal((4, 48)).astype(np.float32)}
    jad = {k: jnp.asarray(v) for k, v in ad.items()}
    tad = {k: torch.from_numpy(v) for k, v in ad.items()}
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    if quantized:
        jw = JQ.quantize(jw, JQ.QuantConfig())
        tw = TQ.quantize(tw, TQ.QuantConfig())
    want = np.asarray(JAL.lora_linear(jnp.asarray(x), jw, jad, JLCFG))
    got = AL.lora_linear(torch.from_numpy(x), tw, tad, TLCFG)
    _close(got, want)
    dense = TQ.dequantize(tw) if quantized else tw
    _close(got, torch.from_numpy(x) @ AL.merge_lora(dense, tad, TLCFG),
           rtol=1e-4)
    if quantized:
        for impl in ("ref", "reuse_ref"):
            _close(ops.lora_matmul(torch.from_numpy(x), tw, tad["lora_a"],
                                   tad["lora_b"], TLCFG.scaling, impl=impl),
                   want)
    assert torch.equal(AL.lora_linear(torch.from_numpy(x), tw, None, TLCFG),
                       AL.linear(torch.from_numpy(x), tw))


def test_lora_init_shapes_and_scale():
    gen = torch.Generator().manual_seed(0)
    ad = AL.lora_init(gen, 256, 96, AL.LoRAConfig(rank=16))
    assert ad["lora_a"].shape == (256, 16) and ad["lora_b"].shape == (16, 96)
    assert not ad["lora_b"].any()
    # A ~ N(0, 1/r): 4096 draws give a std within 5% of 0.25
    assert abs(float(ad["lora_a"].std()) - 0.25) < 0.0125
    assert AL.LoRAConfig().scaling == 2.0


# ---------------------------------------------------------------------------
# registry lifecycle
# ---------------------------------------------------------------------------

def _reg(max_loras=2, lcfg=TLCFG):
    return AdapterRegistry(TCFG, lcfg, max_loras=max_loras, device="cpu")


def test_registry_add_index_evict():
    reg = _reg()
    assert len(reg) == 0
    row1 = reg.add("fr", make_adapter(1))
    row2 = reg.add("de", make_adapter(2))
    assert {row1, row2} == {0, 1}
    assert reg.index_of("de") == row2 and "fr" in reg
    reg.evict("fr")
    assert "fr" not in reg and len(reg) == 1
    for ab in reg.stacked.values():            # the freed row is zeroed
        assert not ab["lora_a"][:, row1].any()
        assert not ab["lora_b"][:, row1].any()
    assert reg.add("es", make_adapter(3)) == row1
    assert reg.names == ["es", "de"]


def test_registry_full_and_duplicate():
    reg = _reg(max_loras=1)
    reg.add("fr", make_adapter(1))
    with pytest.raises(ValueError, match="already registered"):
        reg.add("fr", make_adapter(2))
    with pytest.raises(RuntimeError, match="registry full"):
        reg.add("de", make_adapter(2))
    with pytest.raises(KeyError, match="unknown adapter"):
        reg.index_of("de")


def test_registry_rank_mismatch():
    with pytest.raises(ValueError, match="rank 8 != registry rank 4"):
        _reg().add("fr", make_adapter(1, rank=8))


def test_registry_rejects_quantized_adapter():
    ad = make_adapter(1)
    ad["wq"]["lora_b"] = TQ.quantize(torch.from_numpy(ad["wq"]["lora_b"]),
                                     TQ.QuantConfig())
    with pytest.raises(TypeError, match="QTensor"):
        _reg().add("fr", ad)


def test_registry_unknown_target_and_leaves():
    ad = make_adapter(1)
    ad["gate"] = ad.pop("wq")
    with pytest.raises(ValueError, match="targets"):
        _reg().add("fr", ad)
    with pytest.raises(ValueError, match="unsupported LoRA target"):
        _reg(lcfg=AL.LoRAConfig(rank=4, targets=("wq", "up")))
    ad = make_adapter(1)
    del ad["wq"]["lora_b"]
    with pytest.raises(ValueError, match="exactly"):
        _reg().add("fr", ad)


def test_registry_pins_and_place():
    reg = _reg()
    reg.add("fr", make_adapter(1))
    assert reg.acquire("fr") == 0 and reg.refcount("fr") == 1
    with pytest.raises(RuntimeError, match="active request"):
        reg.evict("fr")
    reg.release("fr")
    with pytest.raises(RuntimeError, match="without a matching acquire"):
        reg.release("fr")
    reg.evict("fr")
    # on a (1, 2) mesh each rank keeps its block (A whole, B cut by the
    # target's output name), and a later add cuts the adapter the same way
    from repro_torch.dist import sharding as shd
    from repro_torch.launch.mesh import Mesh
    full = _reg()
    full.add("fr", make_adapter(1))
    full.add("de", make_adapter(2))
    for rank in range(2):
        reg = _reg()
        reg.add("fr", make_adapter(1))
        mesh = Mesh(1, 2, rank, "cpu")
        specs = shd.adapter_specs(reg.stacked, mesh, shd.SERVE_HEAD_RULES)
        reg.place(specs)
        reg.add("de", make_adapter(2))
        for t in TLCFG.targets:
            for k in ("lora_a", "lora_b"):
                want = shd.local_shard(full.stacked[t][k], specs[t][k], mesh,
                                       rank)
                torch.testing.assert_close(reg.stacked[t][k], want, rtol=0,
                                           atol=0)
        assert reg.stacked["wq"]["lora_b"].shape[-1] == 32
        assert reg.stacked["wo"]["lora_b"].shape[-1] == 64     # embed: whole
        with pytest.raises(RuntimeError, match="placed already"):
            reg.place(specs)


def test_bridge_keeps_rows_and_values():
    jreg, treg = registries(("a1", 1), ("a2", 2))
    jreg.evict("a1")
    treg = carry_registry(jreg)
    assert treg.names == ["a2"] and treg.index_of("a2") == 1
    for t in TLCFG.targets:
        for k in ("lora_a", "lora_b"):
            np.testing.assert_array_equal(treg.stacked[t][k].numpy(),
                                          np.asarray(jreg.stacked[t][k]))


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------

PROMPTS = [np.arange(8), np.arange(8) + 50, np.arange(12) + 100,
           np.arange(31) + 7, np.arange(12) + 3, np.arange(8) + 60]
NAMES = [None, "a1", "a2", "a1", None, "a2"]
MODES = [dict(quantize=q, impl=i, fuse_qkv=f, paged=p)
         for q, i in ((False, "auto"), (True, "auto"), (True, "reuse"))
         for f in (False, True) for p in (False, True)]


def _mode_id(m):
    return "-".join(["int8" if m["quantize"] else "fp32", m["impl"],
                     "fused" if m["fuse_qkv"] else "unfused",
                     "paged" if m["paged"] else "dense"])


@pytest.mark.parametrize("mode", MODES, ids=_mode_id)
def test_mixed_batch_matches_jax_engine(weights, mode):
    jparams, tparams = weights
    jreg, treg = registries(("a1", 1), ("a2", 2))
    kw = dict(n_slots=3, max_len=64, decode_chunk=4, **mode)
    if mode["paged"]:
        kw["kv_block_size"] = 8
    jeng = JServeEngine(JCFG, jparams, adapters=jreg, **kw)
    teng = ServeEngine(TCFG, tparams, adapters=treg, device="cpu", **kw)
    want = jeng.generate(PROMPTS, max_new=8, adapters=NAMES)
    got = teng.generate(PROMPTS, max_new=8, adapters=NAMES)
    assert got == want
    for name in ("admitted", "finished", "steps", "decode_tokens",
                 "prefill_waves", "prefill_tokens", "lora_requests",
                 "prefix_hit_tokens"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.stats.lora_requests == 4
    assert all(treg.refcount(n) == 0 for n in treg.names)
    base = ServeEngine(TCFG, tparams, device="cpu", **kw).generate(
        PROMPTS, max_new=8)
    assert got[0] == base[0] and got[1] != base[1]


def test_paged_lora_requests_take_and_publish_no_prefix(weights):
    """One slot, four prompts sharing a 16-token head: the first (a1)
    publishes nothing, so the base request after it takes no hit; that
    base request publishes, so the next base request hits the head; the
    last (a2) takes no hit."""
    jparams, tparams = weights
    jreg, treg = registries(("a1", 1), ("a2", 2))
    head = np.arange(16) + 30
    prompts = [np.concatenate([head, np.arange(n) + 100 + 9 * i])
               for i, n in enumerate((4, 5, 6, 7))]
    names = ["a1", None, None, "a2"]
    kw = dict(n_slots=1, max_len=64, paged=True, kv_block_size=8,
              quantize=True)
    jeng = JServeEngine(JCFG, jparams, adapters=jreg, **kw)
    teng = ServeEngine(TCFG, tparams, adapters=treg, device="cpu", **kw)
    want = jeng.generate(prompts, max_new=6, adapters=names)
    assert teng.generate(prompts, max_new=6, adapters=names) == want
    assert teng.stats.prefix_hit_tokens == jeng.stats.prefix_hit_tokens \
        == 16
    assert teng.stats.lora_requests == 2


def test_hot_add_evict_between_waves(weights):
    jparams, tparams = weights
    jreg, treg = registries(("a1", 1), max_loras=2)
    jeng = JServeEngine(JCFG, jparams, n_slots=2, max_len=64, adapters=jreg)
    teng = ServeEngine(TCFG, tparams, n_slots=2, max_len=64, adapters=treg,
                       device="cpu")
    first = teng.generate([PROMPTS[0]], max_new=6, adapters=["a1"])
    assert first == jeng.generate([PROMPTS[0]], max_new=6, adapters=["a1"])
    stacked = treg.stacked["wq"]["lora_a"]
    for reg, ad in ((jreg, _jax_adapter(make_adapter(7))),
                    (treg, make_adapter(7))):
        reg.evict("a1")
        reg.add("a3", ad)
    assert treg.stacked["wq"]["lora_a"] is stacked      # swapped in place
    second = teng.generate([PROMPTS[0]], max_new=6, adapters=["a3"])
    assert second != first
    assert second == jeng.generate([PROMPTS[0]], max_new=6, adapters=["a3"])


def test_missing_target_is_identity(weights):
    """An adapter with only wq leaves its wv/wo rows zero: serving it
    equals JAX's, and is not the base model."""
    jparams, tparams = weights
    jreg = JAdapterRegistry(JCFG, JLCFG, max_loras=2)
    jreg.add("q-only", _jax_adapter(make_adapter(5, targets=("wq",))))
    treg = carry_registry(jreg)
    assert not treg.stacked["wv"]["lora_b"].any()
    kw = dict(n_slots=1, max_len=64)
    want = JServeEngine(JCFG, jparams, adapters=jreg, **kw).generate(
        [np.arange(8)], max_new=6, adapters=["q-only"])
    got = ServeEngine(TCFG, tparams, adapters=treg, device="cpu",
                      **kw).generate([np.arange(8)], max_new=6,
                                     adapters=["q-only"])
    assert got == want and len(got[0]) == 6


def test_lora_decode_matches_direct_api(weights):
    """The engine's tokens equal a greedy loop over api.prefill and
    api.decode with the same stacked adapters."""
    _, tparams = weights
    _, treg = registries(("a1", 1), ("a2", 2))
    api = get_model(TCFG)
    idx = torch.tensor([treg.index_of("a1")], dtype=torch.int32)
    lora = dict(adapters=treg.stacked, adapter_idx=idx,
                lora_scaling=treg.scaling)
    prompt = PROMPTS[1]
    with torch.inference_mode():
        logits, cache = api.prefill(
            tparams, {"tokens": torch.from_numpy(prompt[None])},
            api.init_cache(1, 64, "cpu"), **lora)
        toks = [int(logits[0, :TCFG.vocab_size].argmax())]
        while len(toks) < 6:
            logits, cache = api.decode(
                tparams, torch.tensor([toks[-1]], dtype=torch.int32), cache,
                **lora)
            toks.append(int(logits[0, :TCFG.vocab_size].argmax()))
    eng = ServeEngine(TCFG, tparams, n_slots=1, max_len=64, adapters=treg,
                      device="cpu")
    assert eng.generate([prompt], max_new=6, adapters=["a1"])[0] == toks


def test_engine_pins_and_validation(weights):
    _, tparams = weights
    _, treg = registries(("a1", 1), ("a2", 2))
    eng = ServeEngine(TCFG, tparams, n_slots=2, max_len=64, adapters=treg,
                      device="cpu")
    eng.submit(np.arange(8), max_new=4, adapter="a1")
    with pytest.raises(RuntimeError, match="active request"):
        treg.evict("a1")
    with pytest.raises(KeyError, match="unknown adapter"):
        eng.submit(np.arange(8), adapter="nope")
    eng.run()
    treg.evict("a1")                              # drained: now legal
    with pytest.raises(ValueError, match="AdapterRegistry"):
        ServeEngine(TCFG, tparams, n_slots=2, max_len=64,
                    device="cpu").submit(np.arange(8), adapter="a2")
    with pytest.raises(ValueError, match="adapters list length"):
        eng.generate([np.arange(8)], adapters=[None, None])
    other = dataclasses.replace(TCFG, n_layers=3)
    with pytest.raises(ValueError, match="n_layers"):
        ServeEngine(TCFG, tparams, adapters=AdapterRegistry(
            other, TLCFG, device="cpu"), device="cpu")
    with pytest.raises(ValueError, match="lives on"):
        ServeEngine(TCFG, tparams, adapters=AdapterRegistry(
            TCFG, TLCFG, device="meta"), device="cpu")


def test_cancelled_lora_request_releases_adapter(weights):
    _, tparams = weights
    _, treg = registries(("a1", 1), ("a2", 2))
    eng = ServeEngine(TCFG, tparams, n_slots=1, max_len=64, adapters=treg,
                      device="cpu")
    reqs = eng.generate([np.arange(8)] * 3, max_new=8, max_steps=2,
                        return_requests=True, adapters=["a1", "a1", "a2"])
    assert any(r.finish_reason == "cancelled" for r in reqs)
    assert treg.refcount("a1") == 0 and treg.refcount("a2") == 0
    treg.evict("a1")                              # nothing pinned
