"""Port parity for paged KV and prefix reuse: the plain paged decode and
prefix attention versions (reached through ops and through the CUDA
wrapper's CPU path), the host pager, and the ``paged=True`` engine,
against the JAX package on the same numpy inputs and weights.

Tolerances: attention in float32 sums in another order than XLA's and
agrees to about 1e-6 relative; the bound used is 2e-5, as the JAX
package's own paged tests use. Tokens, tables and counters must be equal.
"""

import dataclasses
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models.model import get_model as j_get_model
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops, ref
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_cuda
from repro_torch.serve.engine import ServeEngine
from repro_torch.serve.paged_cache import TRASH_BLOCK, PagedKVCache
from test_torch_engine import jax_tree_to_numpy
from test_torch_reuse import CFG_FIELDS, MIXED, SHARED

TOL = dict(rtol=2e-5, atol=2e-5)


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _kv_quant(x):
    s = np.maximum(np.abs(x).max(-1, keepdims=True), 1e-8) / 127.0
    return (np.clip(np.round(x / s), -127, 127).astype(np.int8),
            s.astype(np.float32))


# ---------------------------------------------------------------------------
# paged decode attention and prefix attention (plain versions)
# ---------------------------------------------------------------------------

PAGED_CASES = [
    # (B, bs, MB, H, Hk, d, int8 KV)
    (3, 16, 8, 8, 2, 64, False), (2, 32, 4, 4, 4, 32, False),
    (2, 16, 4, 8, 2, 64, True), (4, 16, 4, 12, 4, 64, True)]


def _paged_inputs(case, seed):
    b, bs, mb, h, hk, d, quant = case
    nb = b * mb + 4
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, d)).astype(np.float32)
    kp = rng.standard_normal((nb, bs, hk, d)).astype(np.float32)
    vp = rng.standard_normal((nb, bs, hk, d)).astype(np.float32)
    # a permutation of the pool; row 1 shares row 0's first block, and the
    # entries past each length point at trash block 0
    bt = (1 + rng.permutation(nb - 1)[:b * mb]).reshape(b, mb)
    bt = bt.astype(np.int32)
    bt[1, 0] = bt[0, 0]
    length = np.array([0, bs + 3, mb * bs, mb * bs + 9][:b], np.int32)
    for i, n in enumerate(length):
        bt[i, math.ceil(n / bs):] = TRASH_BLOCK
    if quant:
        (kp, ks), (vp, vs) = _kv_quant(kp), _kv_quant(vp)
        return q, kp, vp, bt, length, ks, vs
    return q, kp, vp, bt, length, None, None


def _opt(a, conv):
    return None if a is None else conv(a)


@pytest.mark.parametrize("case", PAGED_CASES, ids=str)
def test_paged_decode_plain_matches_jax(case):
    q, kp, vp, bt, length, ks, vs = _paged_inputs(case, seed=11)
    jargs = [jnp.asarray(a) for a in (q, kp, vp)]
    jkw = dict(k_scale=_opt(ks, jnp.asarray), v_scale=_opt(vs, jnp.asarray))
    want = np.asarray(jref.paged_decode_attention_ref(
        *jargs, jnp.asarray(bt), jnp.asarray(length), **jkw))
    want_k = np.asarray(jops.decode_attention(
        *jargs, jnp.asarray(length), block_tables=jnp.asarray(bt),
        impl="pallas_interpret", **jkw))
    np.testing.assert_allclose(want_k, want, **TOL)
    kw = dict(k_scale=_opt(ks, _t), v_scale=_opt(vs, _t))
    for got in (
            ops.decode_attention(_t(q), _t(kp), _t(vp), _t(length),
                                 block_tables=_t(bt), **kw),
            paged_decode_attention_cuda(_t(q), _t(kp), _t(vp), _t(bt),
                                        _t(length), **kw)):
        np.testing.assert_allclose(got.numpy(), want, **TOL)
        assert torch.count_nonzero(got[0]) == 0     # length 0 -> exactly 0


def test_paged_decode_equals_dense_on_gathered_cache():
    q, kp, vp, bt, length, _, _ = _paged_inputs(PAGED_CASES[0], seed=12)
    b, mb = bt.shape
    kd = _t(kp[bt].reshape(b, -1, *kp.shape[2:]))
    vd = _t(vp[bt].reshape(b, -1, *vp.shape[2:]))
    torch.testing.assert_close(
        ops.decode_attention(_t(q), _t(kp), _t(vp), _t(length),
                             block_tables=_t(bt), impl="ref"),
        ref.decode_attention_ref(_t(q), kd, vd, _t(length)),
        rtol=1e-6, atol=1e-6)


def test_prefix_attention_matches_jax_and_causal_oracle():
    rng = np.random.default_rng(13)
    b, s, h, hk, d, pad = 2, 6, 4, 2, 16, 8
    plen = np.array([5, 8], np.int32)
    kp, vp = (rng.standard_normal((b, pad, hk, d)).astype(np.float32)
              for _ in range(2))
    q = rng.standard_normal((b, s, h, d)).astype(np.float32)
    ks, vs = (rng.standard_normal((b, s, hk, d)).astype(np.float32)
              for _ in range(2))
    args = (q, kp, vp, plen, ks, vs)
    want = np.asarray(jref.prefix_attention_ref(*map(jnp.asarray, args)))
    got = ops.prefix_attention(*map(_t, args))
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    for impl in ("ref", "reuse", "reuse_ref"):
        torch.testing.assert_close(
            ops.prefix_attention(*map(_t, args), impl=impl), got)
    with pytest.raises(NotImplementedError, match="Pallas"):
        ops.prefix_attention(*map(_t, args), impl="cuda")
    for i in range(b):
        n = int(plen[i])
        kf = _t(np.concatenate([kp[i:i + 1, :n], ks[i:i + 1]], axis=1))
        vf = _t(np.concatenate([vp[i:i + 1, :n], vs[i:i + 1]], axis=1))
        full = ref.attention_ref(_t(q[i:i + 1]), kf, vf, causal=True)
        np.testing.assert_allclose(got[i:i + 1].numpy(), full.numpy(), **TOL)


# ---------------------------------------------------------------------------
# host pager: the same call sequence on both copies
# ---------------------------------------------------------------------------

def _drive_pager(cls, n_blocks):
    """Admissions, decode windows, finishes and publishes of three slots
    over prompts that share prefixes; returns every observable."""
    pgr = cls(n_slots=3, n_blocks=n_blocks, block_size=4,
              max_blocks_per_slot=6)
    rng = np.random.default_rng(0)
    heads = [list(range(8)), list(range(50, 62)), list(range(90, 94))]
    seated = {}                        # slot -> (tokens, position)
    log = []
    for step in range(40):
        for slot in range(3):
            if slot in seated:
                continue
            head = heads[int(rng.integers(len(heads)))]
            toks = head + list(rng.integers(100, 200,
                                            int(rng.integers(1, 6))))
            hit, n = pgr.match(toks)
            ok = pgr.admit(slot, hit, math.ceil((len(toks) - n) / 4))
            log.append(("admit", slot, list(hit), n, ok))
            if ok:
                pgr.insert(toks, pgr.slot_blocks(slot))
                seated[slot] = (toks, len(toks))
        for slot, (toks, pos) in sorted(seated.items()):
            span = int(rng.integers(1, 5))
            span = max(1, min(span, 6 * 4 - pos))
            log.append(("plan", slot, pgr.plan_decode(slot, pos, span)))
            log.append(("cow", slot, pgr.prepare_decode(slot, pos, span)))
            toks = toks + list(rng.integers(100, 200, span))
            seated[slot] = (toks, pos + span)
        for slot in sorted(seated):
            toks, pos = seated[slot]
            if pos >= 20 or rng.random() < 0.3:
                pgr.insert(toks[:pos], pgr.slot_blocks(slot))
                pgr.release_slot(slot)
                del seated[slot]
        pgr.check_consistency()
        log.append(("state", pgr.tables.tolist(), pgr.blocks_in_use,
                    pgr.evictions, pgr.evictable_blocks(),
                    pgr.can_allocate(5)))
    return log


@pytest.mark.parametrize("n_blocks", [20, 26])
def test_pager_matches_jax_call_for_call(n_blocks):
    got = _drive_pager(PagedKVCache, n_blocks)
    want = _drive_pager(JPagedKVCache, n_blocks)
    assert got == want
    assert got[-1][3] > 0                       # the run evicted


def test_pager_cow_and_rollback_match_jax():
    out = []
    for cls in (PagedKVCache, JPagedKVCache):
        p = cls(n_slots=2, n_blocks=12, block_size=4, max_blocks_per_slot=4)
        b0, b1 = p.alloc(), p.alloc()
        p.insert(list(range(8)), [b0, b1])
        p.acquire_blocks(0, [b0, b1])
        p.acquire_blocks(1, [b0, b1])
        cow = p.prepare_decode(0, 6, 2), p.prepare_decode(1, 6, 2)
        p.release_slot(1)
        ext = p.extend(0, 2), p.extend(0, 1)    # fills, then overflows
        too_big = p.admit(1, [b0], 4)
        p.check_consistency(external=[b0, b1])  # alloc()'s own references
        out.append((cow, ext, too_big, p.tables.tolist(), p.blocks_in_use))
    assert out[0] == out[1]
    with pytest.raises(ValueError, match="cannot back"):
        PagedKVCache(n_slots=2, n_blocks=9, block_size=4,
                     max_blocks_per_slot=4)


# ---------------------------------------------------------------------------
# engine: paged=True against the JAX engine
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def weights():
    jcfg = JModelConfig(**CFG_FIELDS)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    return (jcfg, jparams, ModelConfig(**CFG_FIELDS),
            params_from_numpy(jax_tree_to_numpy(jparams), "cpu"))


STATS = ("prefix_hit_tokens", "blocks_in_use", "cow_copies", "admitted",
         "finished", "steps", "decode_tokens", "prefill_waves",
         "prefill_tokens")
MODES = {
    "fp32": {}, "int8": dict(quantize=True), "int8kv": dict(quantize=True),
    "chunk1": dict(decode_chunk=1), "no-prefix-cache": dict(
        prefix_cache=False),
    "undersized-pool": dict(num_blocks=2 * 8 + 2),
    "reuse-int8": dict(quantize=True, impl="reuse")}


@pytest.mark.parametrize("mode", list(MODES))
def test_paged_engine_matches_jax(weights, mode):
    jcfg, jparams, tcfg, tparams = weights
    if mode == "int8kv":
        jcfg = dataclasses.replace(jcfg, quant_kv=True)
        tcfg = dataclasses.replace(tcfg, quant_kv=True)
    kw = dict(n_slots=2, max_len=64, paged=True, kv_block_size=8,
              **MODES[mode])
    jeng = JServeEngine(jcfg, jparams, **kw)
    teng = ServeEngine(tcfg, tparams, device="cpu", **kw)
    rounds = 2 if mode == "undersized-pool" else 1
    for _ in range(rounds):
        want = jeng.generate(MIXED + SHARED, max_new=6)
        assert teng.generate(MIXED + SHARED, max_new=6) == want
    for name in STATS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.pager.evictions == jeng.pager.evictions
    assert teng.pager.tables.tolist() == jeng.pager.tables.tolist()
    teng.pager.check_consistency()
    if mode == "undersized-pool":
        assert teng.pager.evictions > 0
    if mode == "no-prefix-cache":
        assert teng.stats.prefix_hit_tokens == teng.stats.blocks_in_use == 0
    else:
        assert teng.stats.prefix_hit_tokens >= 2 * 16   # SHARED's head


def _steal_free_blocks(pager):
    while pager.can_allocate(1):
        pager.alloc()


def test_pool_pressure_raises_where_jax_would_preempt(weights):
    """Where the pool cannot cover the next decode window the port no
    longer raises: it preempts, exactly where the JAX engine does, and
    both engines end with the same tokens, counters and tables."""
    jcfg, jparams, tcfg, tparams = weights
    engines = []
    for cls, cfg, params, kw in (
            (JServeEngine, jcfg, jparams, {}),
            (ServeEngine, tcfg, tparams, dict(device="cpu"))):
        eng = cls(cfg, params, n_slots=2, max_len=64, paged=True,
                  kv_block_size=8, **kw)
        for p in (np.arange(8), np.arange(8) + 30):
            eng.submit(p, max_new=6)
        eng._admit()                 # both seated, each in one full block
        _steal_free_blocks(eng.pager)   # the next decode window needs two
        eng.step()
        assert eng.stats.preempted == 1 and eng.queue
        eng.run()
        engines.append(eng)
    jeng, teng = engines
    want = {r.rid: (r.tokens, r.finish_reason) for r in jeng.finished}
    assert {r.rid: (r.tokens, r.finish_reason)
            for r in teng.finished} == want
    assert [len(t) for t, _ in want.values()] == [6, 6]
    for name in STATS + ("preempted", "restored", "fast_restores"):
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    assert teng.pager.tables.tolist() == jeng.pager.tables.tolist()
    assert teng.pager.evictions == jeng.pager.evictions


def test_admission_stalls_loudly_when_nothing_fits(weights):
    _, _, tcfg, tparams = weights
    eng = ServeEngine(tcfg, tparams, n_slots=2, max_len=64, paged=True,
                      kv_block_size=8, device="cpu")
    _steal_free_blocks(eng.pager)
    eng.submit(np.arange(12), max_new=4)
    with pytest.raises(RuntimeError, match="admission stalled"):
        eng.step()
    assert len(eng.queue) == 1 and eng.pager.slot_blocks(0) == []
