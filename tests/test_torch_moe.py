"""Port parity for the MoE FFN (``repro_torch.models.moe``) and the moe
family's serving engine, against the JAX package on the CPU.

Every case of ``tests/test_moe.py`` but the gradient one runs on both
packages, on the JAX weights carried across by
``bridge.params_from_numpy``: the sort-based dispatch against the dense
oracle, the shared and dense-residual experts, padded experts never
chosen, router weights normalized, capacity drops. A capacity case at the
published factor 1.25 (S = 32, rows right-padded with one repeated pad
vector, two router columns tied) must drop exactly JAX's (token, choice)
pairs. Tolerance: f32 outputs within 1e-5 of their scale (other orders
of f32 additions; the port sums a token's k choices in choice order, JAX
in expert order).

The engine cases serve one prompt set on ``qwen2-moe-a2.7b.reduced()``
(f32, int8 weights) in seven modes (dense, paged with a prefix hit, the
reuse matmul, fused projections, a mixed LoRA batch, chunked prefill and
speculative decoding) on both engines: greedy tokens and every integer
``EngineStats`` counter must be equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.configs.qwen2_moe_a2_7b import CONFIG as J_QWEN
from repro.core import axllm_linear as JAL
from repro.models import moe as JM
from repro.models.model import get_model as j_get_model
from repro.serve.adapters import AdapterRegistry as JAdapterRegistry
from repro.serve.engine import ServeEngine as JServeEngine
from repro_torch.bridge import params_from_numpy, registry_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as T_QWEN
from repro_torch.core import axllm_linear as AL
from repro_torch.models import moe as TM
from repro_torch.serve.adapters import target_dims
from repro_torch.serve.engine import EngineStats, ServeEngine
from test_torch_engine import jax_tree_to_numpy

TOL = 1e-5


def _cfgs(**kw):
    base = dict(name="m", family="moe", n_layers=1, d_model=32, n_heads=4,
                n_kv_heads=4, d_ff=48, vocab_size=128, head_dim=8,
                n_experts=6, top_k=2, expert_pad_to=8, capacity_factor=8.0,
                dtype="float32")
    base.update(kw)
    return JModelConfig(**base), ModelConfig(**base)


def _params_and_x(jcfg, seed=0, t=32):
    p = JM.init_moe(jax.random.PRNGKey(seed), jcfg)
    x = jax.random.normal(jax.random.PRNGKey(seed + 1), (2, t, jcfg.d_model))
    return p, x, params_from_numpy(jax_tree_to_numpy(p), "cpu"), \
        torch.from_numpy(np.array(x))


def _close(got, want):
    want = np.asarray(want, np.float32)
    atol = TOL * max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=TOL,
                               atol=atol)


def test_dispatch_matches_dense_oracle():
    jcfg, tcfg = _cfgs()
    p, x, tp, tx = _params_and_x(jcfg)
    y = TM.moe_ffn(tp, tx, tcfg)
    _close(y, TM.moe_ffn_dense_oracle(tp, tx, tcfg).numpy())
    _close(y, JM.moe_ffn(p, x, jcfg))
    _close(TM.moe_ffn_dense_oracle(tp, tx, tcfg),
           JM.moe_ffn_dense_oracle(p, x, jcfg))


@pytest.mark.parametrize("kw", [dict(n_shared_experts=2),
                                dict(moe_dense_residual=True)],
                         ids=["shared", "dense_residual"])
def test_shared_and_dense_residual_paths(kw):
    jcfg, tcfg = _cfgs(**kw)
    p, x, tp, tx = _params_and_x(jcfg, seed=2)
    y = TM.moe_ffn(tp, tx, tcfg)
    _close(y, TM.moe_ffn_dense_oracle(tp, tx, tcfg).numpy())
    _close(y, JM.moe_ffn(p, x, jcfg))


def test_padded_experts_never_selected():
    jcfg, tcfg = _cfgs()
    p, x, tp, tx = _params_and_x(jcfg, seed=3)
    _, experts = TM._route(tp, tx.reshape(-1, tcfg.d_model), tcfg)
    assert int(experts.max()) < tcfg.n_experts       # dummies at -1e30
    _, jexperts = JM._route(p, x.reshape(-1, jcfg.d_model), jcfg)
    np.testing.assert_array_equal(experts.numpy(), np.asarray(jexperts))


def test_capacity_drop_reduces_output_not_crashes():
    """With a tiny capacity factor overflow pairs drop: the output is
    JAX's, finite, and no larger in norm than with room for every pair."""
    jcfg, tcfg = _cfgs(capacity_factor=0.1)
    p, x, tp, tx = _params_and_x(jcfg, seed=4, t=64)
    y_drop = TM.moe_ffn(tp, tx, tcfg)
    _close(y_drop, JM.moe_ffn(p, x, jcfg))
    y_full = TM.moe_ffn(tp, tx, dataclasses.replace(tcfg,
                                                    capacity_factor=16.0))
    assert bool(torch.isfinite(y_drop).all())
    assert float(torch.linalg.norm(y_drop)) <= \
        float(torch.linalg.norm(y_full)) + 1e-3


def test_router_weights_normalized():
    jcfg, tcfg = _cfgs()
    p, x, tp, tx = _params_and_x(jcfg, seed=5)
    w, _ = TM._route(tp, tx.reshape(-1, tcfg.d_model), tcfg)
    np.testing.assert_allclose(w.sum(-1).numpy(), 1.0, rtol=1e-5)
    jw, _ = JM._route(p, x.reshape(-1, jcfg.d_model), jcfg)
    _close(w, jw)


def test_capacity_drops_exactly_jax_pairs():
    """cf 1.25 (published), S = 32, top-2 of 6 real experts: cap =
    int(1.25 * 32 * 2 / 6) = 13, so pairs drop. Row 1's last 12 positions
    are one pad vector (a right-padded prompt), and router columns 0 and 1
    are equal (every token ties them). The port must keep exactly JAX's
    pairs, in JAX's sorted order, the lower expert winning each tie and
    real tokens taking capacity before the padding."""
    jcfg, tcfg = _cfgs(capacity_factor=1.25)
    s, k, e = 32, tcfg.top_k, tcfg.padded_experts
    rng = np.random.default_rng(7)
    router = rng.standard_normal((tcfg.d_model, e)).astype(np.float32)
    router[:, 1] = router[:, 0]
    x = rng.standard_normal((2, s, tcfg.d_model)).astype(np.float32)
    x[1, 20:] = rng.standard_normal(tcfg.d_model)      # the pad vector
    cap = TM.capacity(tcfg, s)
    assert cap == 13
    jw, je = JM._route({"router": jnp.asarray(router)},
                       jnp.asarray(x).reshape(-1, tcfg.d_model), jcfg)
    jmeta = jax.vmap(lambda xr, wr, er: JM._dispatch_row(
        xr, wr, er, e, cap, k)[1])(jnp.asarray(x), jw.reshape(2, s, k),
                                   je.reshape(2, s, k))
    tw, te = TM._route({"router": torch.from_numpy(router)},
                       torch.from_numpy(x).reshape(-1, tcfg.d_model), tcfg)
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    # the tie: expert 1 is chosen only right after expert 0
    chose0 = (te == 0).any(-1)
    assert bool(chose0.any())
    assert bool(((te[:, 1] == 1) <= (te[:, 0] == 0)).all())
    assert not bool((te[:, 0] == 1).any())
    tmeta = TM._dispatch_row(tw.reshape(2, s, k), te.reshape(2, s, k), e,
                             cap, k)
    # e_sorted, pos_clip, tok_sorted, keep: the same pairs, the same order
    for j in (0, 1, 2, 4):
        np.testing.assert_array_equal(tmeta[j].numpy(),
                                      np.asarray(jmeta[j]), err_msg=str(j))
    _close(tmeta[3], jmeta[3])
    keep = tmeta[4].numpy()
    assert 0 < int((~keep).sum()) < keep.size
    # where a pad token's pair was kept, every real token of its expert
    # in that row was kept too
    tok, exp = tmeta[2].numpy()[1], tmeta[0].numpy()[1]
    for ex in np.unique(exp[(tok >= 20) & keep[1]]):
        assert keep[1][(exp == ex) & (tok < 20)].all()


def test_combine_is_inverse_permutation_sum():
    """The combine weights each pair, takes it back to its token through
    the inverse permutation and adds a token's k outputs: a hand-written
    scatter-add of the sorted pairs (JAX's combine) agrees within f32
    rounding."""
    g = torch.Generator().manual_seed(0)
    b, s, k, d = 2, 5, 3, 4
    order = torch.stack([torch.randperm(s * k, generator=g)
                         for _ in range(b)])
    y_sorted = torch.randn(b, s * k, d, generator=g)
    w_sorted = torch.rand(b, s * k, generator=g)
    y = TM._combine_row(y_sorted, w_sorted, order, s, k)
    want = torch.zeros(b, s, d)
    for r in range(b):
        for i in range(s * k):
            tok = int(order[r, i]) // k
            want[r, tok] += y_sorted[r, i] * w_sorted[r, i]
    torch.testing.assert_close(y, want, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# the moe family's serving engine against the JAX engine
# ---------------------------------------------------------------------------

OVERRIDES = dict(dtype="float32", remat=False)
JCFG, TCFG = J_QWEN.reduced(**OVERRIDES), T_QWEN.reduced(**OVERRIDES)
HEAD = list(range(5, 21))                   # a 16-token shared head
PROMPTS = [np.arange(8) + 1, np.array(HEAD + [40, 41, 42]),
           np.arange(31) + 7, np.array(HEAD + list(range(60, 70))),
           np.arange(12) + 3, np.array(HEAD + [90, 91, 92, 93])]
NAMES = [None, "a1", "a2", "a1", None, "a2"]
LORA = dict(rank=4, alpha=8.0, targets=("wq", "wv", "wo"))
STATS = tuple(f.name for f in dataclasses.fields(EngineStats)
              if f.type in ("int", int))
MODES = {
    "dense": dict(),
    "paged": dict(paged=True, kv_block_size=8),
    "reuse": dict(impl="reuse"),
    "fused": dict(fuse_qkv=True),
    "lora": dict(),
    "chunked": dict(paged=True, kv_block_size=8, prefill_budget=16),
    "speculate": dict(speculate=True, spec_k=4),
}


def make_registries(jcfg, tcfg):
    """A JAX adapter registry of two random adapters (B non-zero) and the
    port's copy through the bridge."""
    jreg = JAdapterRegistry(jcfg, JAL.LoRAConfig(**LORA), max_loras=2)
    for name, seed in (("a1", 1), ("a2", 2)):
        rng = np.random.default_rng(seed)
        ad = {}
        for t in LORA["targets"]:
            n_in, n_out = target_dims(tcfg, t)
            ad[t] = {"lora_a": jnp.asarray(rng.standard_normal(
                (tcfg.n_layers, n_in, 4)).astype(np.float32) / 2),
                "lora_b": jnp.asarray(rng.standard_normal(
                    (tcfg.n_layers, 4, n_out)).astype(np.float32) * 0.3)}
        jreg.add(name, ad)
    names = [None] * jreg.max_loras
    for n in jreg.names:
        names[jreg.index_of(n)] = n
    stacked = {t: {k: np.asarray(v) for k, v in ab.items()}
               for t, ab in jreg.stacked.items()}
    return jreg, registry_from_numpy(tcfg, stacked, names,
                                     AL.LoRAConfig(**LORA), device="cpu")


def serve_both(jcfg, tcfg, jparams, tparams, mode):
    """(JAX engine, port engine, their tokens) of ``PROMPTS`` in ``mode``:
    int8 weights, 3 slots, max_len 64, decode chunk 4, 8 new tokens."""
    kw = dict(n_slots=3, max_len=64, decode_chunk=4, quantize=True,
              **MODES[mode])
    names = None
    jkw, tkw = {}, {}
    if mode == "lora":
        jkw["adapters"], tkw["adapters"] = make_registries(jcfg, tcfg)
        names = NAMES
    jeng = JServeEngine(jcfg, jparams, **kw, **jkw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw, **tkw)
    want = jeng.generate(PROMPTS, max_new=8, adapters=names)
    got = teng.generate(PROMPTS, max_new=8, adapters=names)
    return jeng, teng, want, got


def assert_same_serving(jeng, teng, want, got, mode):
    assert got == want
    for name in STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if mode == "paged":
        assert teng.stats.prefix_hit_tokens >= 2 * 8
    if mode == "lora":
        assert teng.stats.lora_requests == 4
    if mode == "chunked":
        assert teng.stats.prefill_chunks > teng.stats.prefill_waves
    if mode == "speculate":
        assert teng.stats.spec_rounds > 0
        assert teng.stats.acceptance_rate == jeng.stats.acceptance_rate


@pytest.fixture(scope="module")
def weights():
    jparams = j_get_model(JCFG).init(jax.random.PRNGKey(0))
    return jparams, params_from_numpy(jax_tree_to_numpy(jparams), "cpu")


@pytest.mark.parametrize("mode", list(MODES))
def test_moe_engine_matches_jax_engine(weights, mode):
    jparams, tparams = weights
    assert_same_serving(*serve_both(JCFG, TCFG, jparams, tparams, mode),
                        mode)


def test_moe_speculation_gate_is_the_paged_cache(weights):
    """The moe family has a position-addressable KV cache, so it
    speculates (the port's gate is JAX's), and its draft quantizes the
    expert banks too."""
    eng = ServeEngine(TCFG, weights[1], device="cpu", speculate=True,
                      draft_bits=4)
    bank = eng.draft_params["layers"]["ffn"]["expert_gate"]
    assert bank.bits == 4 and bank.shape == (
        TCFG.n_layers, TCFG.padded_experts, TCFG.d_model, TCFG.d_ff)


def test_token_gate_replays_the_moe_schedule():
    """At the published capacity factor the moe layer drops pairs, and
    what it drops depends on the padded length of the batch row. Served
    tokens (the plain path, so the two paths are the same computation)
    replayed through the gate's serving schedule (one wave of the padded
    prompt length, then a decode step a token) are the reference's argmax
    at every position."""
    from repro_torch.models.model import get_model
    from repro_torch.serve.engine import _pow2_bucket
    from repro_torch.serve.token_gate import token_gate
    cfg = dataclasses.replace(TCFG, capacity_factor=1.25)
    params = get_model(cfg).init(seed=1, device="cpu")
    prompts = PROMPTS[:4]
    eng = ServeEngine(cfg, params, n_slots=4, max_len=64, decode_chunk=4,
                      quantize=True, device="cpu")
    served = eng.generate(prompts, max_new=8)
    assert eng.stats.prefill_waves == 1
    pl = _pow2_bucket(max(len(p) for p in prompts), 8, 64)
    assert TM.capacity(cfg, pl) < pl * cfg.top_k    # pairs can drop
    gate = token_gate(cfg, eng.params, prompts, served, impl="ref",
                      tol_rel=5e-2, device="cpu",
                      prefill_lens=[pl] * len(prompts))
    assert gate.ok and gate.differ == 0 and gate.positions == 4 * 8


@pytest.mark.parametrize("gran", ["per_channel", "per_tensor", "per_group"])
def test_stacked_expert_bank_quantizes_like_jax(gran):
    """A stacked bank [L, E, d, d_ff] is quantized one matrix at a time;
    its codes and scales equal JAX's whole-leaf quantization."""
    from repro.core import quantization as JQ
    from repro_torch.core import quantization as TQ
    w = np.random.default_rng(3).standard_normal((2, 3, 64, 24)).astype(
        np.float32)
    kw = dict(bits=8, granularity=gran, group_size=32)
    got = TQ.quantize(torch.from_numpy(w), TQ.QuantConfig(**kw))
    want = JQ.quantize(jnp.asarray(w), JQ.QuantConfig(**kw))
    np.testing.assert_array_equal(got.codes.numpy(), np.asarray(want.codes))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))
    assert got.shape == tuple(want.shape)
    one = TQ.quantize(torch.from_numpy(w[1, 2]), TQ.QuantConfig(**kw))
    assert torch.equal(got.index(1).index(2).kernel_scale, one.kernel_scale)


def test_routing_gate_takes_and_holds_recorded_choices():
    """Expert choices recorded from one replay of the serving schedule and
    forced on the gate's own: every choice is the router's own (0 differ,
    no failure, no token without a record) and the tokens pass. A record
    changed to the router's last choice fails the routing gate."""
    from repro_torch.models.model import get_model
    from repro_torch.serve.token_gate import (Routes, replayed_logits,
                                              token_gate)
    cfg = dataclasses.replace(TCFG, capacity_factor=1.25)
    params = get_model(cfg).init(seed=2, device="cpu")
    prompts, pl = PROMPTS[:3], 32
    gen = [[int(t) for t in np.arange(6) + 10 * i] for i in range(3)]
    routes = Routes()
    with routes.record():
        replayed_logits(cfg, params, prompts, gen, pl, impl="ref",
                        device="cpu", routes=routes)
    n_tok = sum(len(p) + len(g) - 1 for p, g in zip(prompts, gen))
    assert len(routes.book) == n_tok * cfg.n_layers
    gate = token_gate(cfg, params, prompts, gen, impl="ref", tol_rel=5e-2,
                      device="cpu", prefill_lens=[pl] * 3, routes=routes)
    assert routes.ok and routes.tokens == n_tok * cfg.n_layers
    assert routes.differ == 0 and routes.min_slack > 0
    assert gate.routes is routes and gate.positions == 18
    # request 1's token at position 4, layer 0: two experts the router
    # did not choose
    key = (1, 0, 4)
    bad = Routes()
    bad.book = dict(routes.book)
    bad.book[key] = np.array([e for e in range(cfg.n_experts)
                              if e not in routes.book[key]][:cfg.top_k])
    worse = token_gate(cfg, params, prompts, gen, impl="ref", tol_rel=1e-6,
                       device="cpu", prefill_lens=[pl] * 3, routes=bad)
    # (the changed choice moves that token's later layers, and through
    # attention the later tokens, so more routings may differ)
    assert bad.differ >= 1 and bad.failures[0][0] == key
    assert not worse.ok
