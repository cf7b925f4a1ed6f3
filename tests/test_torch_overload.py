"""Port parity for overload serving: the scheduler's queue policies,
victims, chunks and arrivals, the pager's overload calls (``admit``
rollback, ``lookup``, ``evict_prefixes``, ``truncate``), and the engine's
admission control, preemption with fast and recompute restore, and
adapter pins under cancel and fault, against the JAX package on the same
inputs and weights (the cases of ``tests/test_robustness.py`` but its
mesh ones).

Every engine case runs the same script on the JAX engine and on the
port's (``device="cpu"``): greedy tokens and finish reasons must be
equal request for request, and so must the scheduler's counters,
overload ones included.
"""

import dataclasses
import itertools
from typing import Callable

import jax
import numpy as np
import pytest
import torch

from repro.configs.base import ModelConfig as JModelConfig
from repro.launch.serve import make_synthetic_adapters as j_adapters
from repro.models.model import get_model as j_get_model
from repro.serve import scheduler as jsched
from repro.serve.engine import ServeEngine as JServeEngine
from repro.serve.engine import StopStream as JStopStream
from repro.serve.paged_cache import PagedKVCache as JPagedKVCache
from repro_torch.bridge import params_from_numpy
from repro_torch.configs.base import ModelConfig
from repro_torch.serve import scheduler as tsched
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.engine import ServeEngine, StopStream
from repro_torch.serve.paged_cache import PagedKVCache
from test_torch_engine import jax_tree_to_numpy

CFG_FIELDS = dict(name="s", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, vocab_pad_multiple=64, dtype="float32")
MIXED = [np.arange(8), np.arange(12) + 3, np.arange(31) + 7,
         np.arange(12) + 40]
COUNTERS = ("admitted", "finished", "truncated", "steps", "decode_tokens",
            "decode_chunks", "prefill_waves", "prefill_tokens",
            "lora_requests", "prefix_hit_tokens", "blocks_in_use",
            "cow_copies", "rejected", "expired", "preempted", "restored",
            "fast_restores", "cancelled", "prefill_chunks",
            "preempted_prefill")


@dataclasses.dataclass
class Side:
    """One package's engine, adapters and stream-stop exception, so that
    a test script runs unchanged against either."""
    name: str
    engine_cls: type
    cfg: object
    params: object
    engine_kw: dict
    adapters: Callable
    stop_stream: type

    def make(self, cfg=None, **kw):
        return self.engine_cls(cfg or self.cfg, self.params,
                               **self.engine_kw, **kw)

    def replace_cfg(self, **changes):
        return dataclasses.replace(self.cfg, **changes)


@pytest.fixture(scope="module")
def sides():
    jcfg = JModelConfig(**CFG_FIELDS)
    jparams = j_get_model(jcfg).init(jax.random.PRNGKey(0))
    tparams = params_from_numpy(jax_tree_to_numpy(jparams), "cpu")
    return (Side("jax", JServeEngine, jcfg, jparams, {}, j_adapters,
                 JStopStream),
            Side("torch", ServeEngine, ModelConfig(**CFG_FIELDS), tparams,
                 dict(device="cpu"),
                 lambda cfg, n: make_synthetic_adapters(cfg, n,
                                                        device="cpu"),
                 StopStream))


def outcomes(eng) -> dict:
    return {r.rid: (list(r.tokens), r.finish_reason) for r in eng.finished}


def tokens_by_rid(eng) -> list:
    got = outcomes(eng)
    return [got[rid][0] for rid in sorted(got)]


def mirror(sides, script):
    """Run ``script(side)`` on both packages; it returns its engine (or a
    tuple whose first item is the engine). The two engines' outcomes and
    counters must be equal. Returns the port's result and the JAX
    package's."""
    jres, tres = (script(s) for s in sides)
    jeng = jres[0] if isinstance(jres, tuple) else jres
    teng = tres[0] if isinstance(tres, tuple) else tres
    assert outcomes(teng) == outcomes(jeng)
    for name in COUNTERS:
        assert getattr(teng.stats, name) == getattr(jeng.stats, name), name
    if jeng.paged:
        assert teng.pager.tables.tolist() == jeng.pager.tables.tolist()
        assert teng.pager.evictions == jeng.pager.evictions
        teng.pager.check_consistency()
    return tres, jres


# ---------------------------------------------------------------------------
# Scheduler: queue policies, deadlines, victims, chunks, arrivals
# ---------------------------------------------------------------------------

class _Req:
    def __init__(self, rid, priority=0, deadline_s=None, t_submit=0.0):
        self.rid = rid
        self.priority = priority
        self.deadline_s = deadline_s
        self.t_submit = t_submit


def _queue_script(mod):
    """Offers, takes, expiries and evictions under each policy; returns
    what each call gave, as rids."""
    log = []
    rid = itertools.count()
    for policy, cap in (("block", None), ("block", 2), ("reject", 2),
                        ("evict", 2), ("evict", 3)):
        q = mod.WaitQueue(max_queue=cap, policy=policy)
        for prio, dl in ((0, None), (5, 1.0), (0, 100.0), (7, None),
                         (5, None), (1, 0.5)):
            req = _Req(next(rid), prio, dl, t_submit=0.0)
            d = q.offer(req)
            log.append((policy, req.rid, d.admitted, d.must_block,
                        None if d.evicted is None else d.evicted.rid))
        q.push_front(_Req(next(rid), priority=3))
        log.append(("full", q.full, q.peek_priority(), len(q)))
        log.append(("expire", [r.rid for r in q.expire(now=2.0)]))
        log.append(("take", [r.rid for r in q.take(2)], [r.rid for r in q]))
    return log


def test_queue_policies_match_jax():
    assert _queue_script(tsched) == _queue_script(jsched)


def test_queue_rejects_bad_arguments():
    for mod in (tsched, jsched):
        with pytest.raises(ValueError, match="admission policy"):
            mod.WaitQueue(policy="drop")
        with pytest.raises(ValueError, match="max_queue"):
            mod.WaitQueue(max_queue=0)


def test_pick_victim_matches_jax():
    reqs = [_Req(i, priority=p) for i, p in enumerate((2, 0, 0, 5, 1, 0))]
    rng = np.random.default_rng(0)
    for _ in range(50):
        slots = [r if rng.random() < 0.7 else None
                 for r in rng.permutation(reqs)]
        for below in (None, 0, 1, 2, 3, 6):
            assert tsched.pick_victim(slots, below_priority=below) == \
                jsched.pick_victim(slots, below_priority=below)
    assert tsched.pick_victim([None, None]) is None


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_prefill_chunk_matches_jax(bs):
    for remaining in (0, 1, 7, 8, 9, 31, 100):
        for budget in (0, 3, 7, 8, 16, 60, 64):
            assert tsched.prefill_chunk(remaining, budget, bs) == \
                jsched.prefill_chunk(remaining, budget, bs)


def test_arrivals_match_jax():
    for spec in ("fixed:2.0", "poisson:0.5", "poisson:7.25"):
        assert tsched.parse_arrival(spec) == jsched.parse_arrival(spec)
        np.testing.assert_array_equal(
            tsched.arrival_times(spec, 64, seed=3),
            jsched.arrival_times(spec, 64, seed=3))
    for bad in ("poisson:", "burst:1", "poisson:-1", "poisson:0"):
        with pytest.raises(ValueError):
            tsched.parse_arrival(bad)


# ---------------------------------------------------------------------------
# Pager: plan-then-commit admission, lookup, eviction, truncation
# ---------------------------------------------------------------------------

def _pager_script(cls):
    """Admission rollback under exhaustion, read-only planning, the
    uncapped lookup, forced eviction and truncation; returns every
    observable."""
    p = cls(n_slots=2, n_blocks=12, block_size=4, max_blocks_per_slot=4)
    log = []
    held = [p.alloc() for _ in range(9)]        # 11 usable, keep 2 free
    before = p.blocks_in_use
    log.append(("admit3", p.admit(0, [], 3), p.blocks_in_use == before,
                p.slot_blocks(0)))
    log.append(("admit2", p.admit(0, [], 2), p.slot_blocks(0)))
    log.append(("oversized", p.admit(1, [], 5)))
    log.append(("plan", p.plan_decode(0, pos0=7, n=4), p.blocks_in_use))
    toks = list(range(10))
    log.append(("insert", p.insert(toks[:8], p.slot_blocks(0))))
    log.append(("lookup", p.lookup(toks), p.lookup(toks[:8]),
                p.lookup(toks[:3]), p.match(toks[:8])))
    p.release_slot(0)
    for b in held:
        p._release_block(b)
    p.check_consistency()
    log.append(("evictable", p.evictable_blocks()))
    log.append(("evict1", p.evict_prefixes(1), p.lookup(toks)))
    log.append(("evict_all", p.evict_prefixes(), p.evictable_blocks(),
                p.blocks_in_use))
    assert p.admit(1, [], 4)
    log.append(("truncate", p.truncate(1, 16), p.truncate(1, 9),
                p.slot_blocks(1), p.truncate(1, 0), p.slot_blocks(1)))
    p.check_consistency()
    b = p.alloc()
    try:
        p.check_consistency()
        log.append(("ownerless", "passed"))
    except AssertionError:
        log.append(("ownerless", "refused"))
    p.check_consistency(external=[b])
    return log


def test_pager_overload_calls_match_jax():
    got, want = _pager_script(PagedKVCache), _pager_script(JPagedKVCache)
    assert got == want
    assert ("ownerless", "refused") in got


# ---------------------------------------------------------------------------
# Engine: preempt -> swap-out -> restore
# ---------------------------------------------------------------------------

def _paged(side, cfg=None, **kw):
    kw.setdefault("n_slots", 2)
    return side.make(cfg, max_len=64, paged=True, kv_block_size=8, **kw)


def _serve_preempted(side, prompts, max_new=10, evict=False, cfg=None,
                     **kw):
    """Drive by hand, preempting one running slot after the first step (so
    it holds generated tokens and a partial tail block)."""
    eng = _paged(side, cfg, **kw)
    for pr in prompts:
        eng.submit(np.asarray(pr, np.int32), max_new=max_new)
    steps = 0
    while eng.step():
        steps += 1
        if steps == 1:
            vic = next(i for i, s in enumerate(eng.slots)
                       if s is not None and not s.done)
            eng._preempt_slot(vic)
            if evict:
                eng.pager.evict_prefixes()      # destroy the published KV
        assert steps < 500, "preempted run failed to converge"
    return eng


def _plain_tokens(side, prompts, max_new=10, cfg=None, **kw):
    return _paged(side, cfg, **kw).generate(prompts, max_new=max_new)


MODES = {"fp32": {}, "int8": dict(quantize=True),
         "reuse": dict(quantize=True, impl="reuse"),
         "fused": dict(quantize=True, fuse_qkv=True),
         "chunk1": dict(decode_chunk=1)}


@pytest.mark.parametrize("mode", list(MODES))
def test_preempt_restore_token_identity(sides, mode):
    kw = MODES[mode]
    teng, _ = mirror(sides, lambda s: _serve_preempted(s, MIXED[:2], **kw))
    want = _plain_tokens(sides[1], MIXED[:2], **kw)
    assert tokens_by_rid(teng) == want
    assert teng.stats.preempted >= 1 and teng.stats.restored >= 1


def test_fast_restore_used_when_prefix_survives(sides):
    teng, _ = mirror(sides, lambda s: _serve_preempted(s, MIXED[:2]))
    assert teng.stats.fast_restores >= 1         # no recompute needed


def test_recompute_restore_after_eviction_storm(sides):
    """Evicting the preempted request's published KV forces the recompute
    path: still token-identical, through a fresh prefill."""
    teng, _ = mirror(sides,
                     lambda s: _serve_preempted(s, MIXED[:2], evict=True))
    assert teng.stats.fast_restores == 0 and teng.stats.restored >= 1
    assert tokens_by_rid(teng) == \
        _plain_tokens(sides[1], MIXED[:2])


def test_preempt_restore_identity_int8kv(sides):
    def script(s):
        cfg = s.replace_cfg(quant_kv=True)
        return _serve_preempted(s, MIXED, cfg=cfg, quantize=True)

    teng, _ = mirror(sides, script)
    assert teng.stats.preempted >= 1
    assert tokens_by_rid(teng) == _plain_tokens(
        sides[1], MIXED, cfg=sides[1].replace_cfg(quant_kv=True),
        quantize=True)
    assert teng.cache["k"].dtype == torch.int8


def test_swapped_tail_does_not_alias_the_pool(sides):
    """The tail swapped out at preemption is a copy: rewriting every free
    pool block (the tail's old block among them) before the fast restore
    leaves the restored tokens equal to the JAX engine's and to an
    unpreempted run."""
    def script(s):
        eng = _paged(s, decode_chunk=1)
        for pr in (MIXED[1], MIXED[3]):         # 12 tokens: a partial tail
            eng.submit(np.asarray(pr, np.int32), max_new=10)
        eng.step()
        eng.step()
        vic = 1
        tail_block = eng.pager.slot_blocks(vic)[-1]
        eng._preempt_slot(vic)
        r = eng.queue.take(1)[0]
        eng.queue.push_front(r)
        assert r._swap.tail is not None
        rng = np.random.default_rng(7)
        free = list(eng.pager._free)
        assert tail_block in free
        for name in eng._pool_leaves:
            pool = eng.cache[name]
            junk = rng.standard_normal((pool.shape[0], len(free))
                                       + tuple(pool.shape[2:])) * 100
            if s.name == "jax":
                eng.cache[name] = pool.at[:, np.asarray(free)].set(
                    junk.astype(pool.dtype))
            else:
                assert r._swap.tail[name].untyped_storage().data_ptr() != \
                    pool.untyped_storage().data_ptr()
                pool[:, torch.tensor(free)] = torch.from_numpy(junk).to(
                    pool.dtype)
        while eng.step():
            pass
        return eng

    teng, _ = mirror(sides, script)
    assert teng.stats.fast_restores == 1
    assert tokens_by_rid(teng) == _plain_tokens(
        sides[1], [MIXED[1], MIXED[3]], decode_chunk=1)


def test_priority_arrival_preempts_lower_priority(sides):
    def script(s):
        eng = _paged(s, decode_chunk=2)
        for pr in MIXED[:2]:
            eng.submit(np.asarray(pr, np.int32), max_new=8)
        eng.step()
        vip = eng.submit(np.asarray(MIXED[2], np.int32), max_new=8,
                         priority=3)
        while eng.step():
            pass
        return eng, vip

    (teng, vip), _ = mirror(sides, script)
    assert teng.stats.preempted == 1 and teng.stats.restored == 1
    assert outcomes(teng)[vip][1] == "max_new"


# ---------------------------------------------------------------------------
# Engine: admission policies, deadlines, pool exhaustion
# ---------------------------------------------------------------------------

def test_engine_reject_policy_is_nonraising(sides):
    def script(s):
        eng = _paged(s, max_queue=1, admission="reject")
        eng.submit(np.asarray(MIXED[0], np.int32), max_new=4)
        eng.step()                              # seat it; queue empties
        eng.submit(np.asarray(MIXED[1], np.int32), max_new=4)   # queued
        shed = eng.submit(np.asarray(MIXED[2], np.int32), max_new=4)
        eng.run()
        return eng, shed

    (teng, shed), _ = mirror(sides, script)
    assert outcomes(teng)[shed] == ([], "rejected")
    assert teng.stats.rejected == 1 and len(teng.finished) == 3
    assert not teng.queue and all(s is None for s in teng.slots)


def test_engine_evict_policy_prefers_low_priority(sides):
    def script(s):
        eng = _paged(s, max_queue=1, admission="evict")
        for i in range(2):
            eng.submit(np.asarray(MIXED[i], np.int32), max_new=4)
        eng.step()                              # both seated
        victim = eng.submit(np.asarray(MIXED[2], np.int32), max_new=4,
                            priority=0)         # queued
        vip = eng.submit(np.asarray(MIXED[3], np.int32), max_new=4,
                         priority=7)            # evicts the queued prio-0
        eng.run()
        return eng, victim, vip

    (teng, victim, vip), _ = mirror(sides, script)
    got = outcomes(teng)
    assert got[victim][1] == "rejected"
    assert got[vip][1] == "max_new" and len(got[vip][0]) == 4


def test_engine_block_policy_drains_until_a_position_frees(sides):
    def script(s):
        eng = _paged(s, n_slots=1, max_queue=1, admission="block",
                     decode_chunk=1)
        for pr in MIXED[:3]:
            eng.submit(np.asarray(pr, np.int32), max_new=3)
        eng.run()
        return eng

    teng, _ = mirror(sides, script)
    assert [f for _, f in outcomes(teng).values()] == ["max_new"] * 3


def test_engine_deadline_expires_queued_request(sides):
    def script(s):
        clock = itertools.count()               # 1 "second" per call
        eng = _paged(s, clock=lambda: float(next(clock)))
        for pr in MIXED[:2]:
            eng.submit(np.asarray(pr, np.int32), max_new=4)
        doomed = eng.submit(np.asarray(MIXED[2], np.int32), max_new=4,
                            deadline_s=0.0)
        eng.run()
        return eng, doomed

    (teng, doomed), _ = mirror(sides, script)
    assert outcomes(teng)[doomed] == ([], "expired")
    assert teng.stats.expired == 1 and teng.stats.finished == 2


def test_engine_pool_exhaust_stalls_then_recovers(sides):
    """With the whole pool stolen, admission rolls back cleanly, the stall
    guard refuses to spin, and returning the blocks lets the same queued
    request complete."""
    def script(s):
        eng = _paged(s)
        held = [eng.pager.alloc() for _ in range(len(eng.pager._free))]
        before = eng.pager.blocks_in_use
        eng.submit(np.asarray(MIXED[0], np.int32), max_new=4)
        with pytest.raises(RuntimeError, match="stalled"):
            eng.run()
        assert eng.pager.blocks_in_use == before
        assert len(eng.queue) == 1
        for b in held:
            eng.pager._release_block(b)
        eng.run()
        return eng

    teng, _ = mirror(sides, script)
    assert len(teng.finished) == 1 and len(teng.finished[0].tokens) == 4


# ---------------------------------------------------------------------------
# Adapter pins: released on every exit path
# ---------------------------------------------------------------------------

def _lora_engine(side, fault_hook=None):
    reg, names = side.adapters(side.cfg, 1)
    # decode_chunk=1 keeps requests mid-decode across steps, so the pin is
    # visibly held while running
    eng = side.make(n_slots=2, max_len=64, quantize=True, decode_chunk=1,
                    adapters=reg, fault_hook=fault_hook)
    return eng, reg, names[0]


def test_adapter_pin_released_on_cancel(sides):
    def script(s):
        eng, reg, name = _lora_engine(s)
        rid = eng.submit(np.asarray(MIXED[0], np.int32), max_new=8,
                         adapter=name)
        eng.step()                              # running, pin held
        with pytest.raises(RuntimeError):
            reg.evict(name)                     # pinned: must refuse
        r = eng._cancel(rid)
        reg.evict(name)                         # pin released: evictable
        assert not any(reg._refs)
        return eng, list(r.tokens), r.finish_reason

    (_, toks, reason), (_, jtoks, _) = mirror(sides, script)
    assert reason == "cancelled" and toks and toks == jtoks


def test_adapter_pin_survives_fault_then_releases(sides):
    def script(s):
        calls = {"n": 0}

        def hook(phase):
            calls["n"] += 1
            if calls["n"] == 1:
                raise RuntimeError("injected prefill fault")

        eng, reg, name = _lora_engine(s, fault_hook=hook)
        eng.submit(np.asarray(MIXED[0], np.int32), max_new=4, adapter=name)
        with pytest.raises(RuntimeError, match="injected"):
            eng.step()                          # wave requeued, pin kept
        assert reg.refcount(name) == 1 and len(eng.queue) == 1
        eng.run()                               # the retry succeeds
        assert not any(reg._refs)               # drained: pin released
        reg.evict(name)
        return eng

    teng, _ = mirror(sides, script)
    assert len(teng.finished) == 1 and len(teng.finished[0].tokens) == 4
