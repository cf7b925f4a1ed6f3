"""Port parity for streaming serving: chunked prefill under a budget,
token emission (``on_token``, ``stream()``), cancellation at every point
of a request's life, and TTFT / inter-token deadlines under an injected
clock, against the JAX engine on the same weights (the cases of
``tests/test_streaming.py`` but its speculative and ``adopt_compiled``
ones).

Each case runs the same script on both engines (the port's on the CPU):
greedy tokens, finish reasons and counters must be equal, and the JAX
test's own assertions must hold on the port.
"""

import itertools

import numpy as np
import pytest

from test_torch_overload import (mirror, outcomes,  # noqa: F401
                                 sides, tokens_by_rid)

MIXED = [np.arange(8), np.arange(31) + 7, np.arange(45) % 256,
         np.arange(12) + 40]
MAX_NEW = 6


@pytest.fixture(scope="module")
def reference(sides):  # noqa: F811
    """Unbudgeted dense tokens of MIXED; equal in both packages."""
    jref, tref = (s.make(n_slots=4, max_len=64).generate(MIXED,
                                                         max_new=MAX_NEW)
                  for s in sides)
    assert tref == jref
    return tref


def _paged(side, **kw):
    kw.setdefault("n_slots", 2)
    kw.setdefault("max_len", 64)
    kw.setdefault("kv_block_size", 8)
    return side.make(paged=True, **kw)


def _drain(eng):
    while eng.step():
        pass
    return eng


def _clock():
    count = itertools.count(0)             # 1 virtual second per read
    return lambda: float(next(count))


# ---------------------------------------------------------------------------
# Chunked prefill
# ---------------------------------------------------------------------------

def _serve_all(eng):
    for p in MIXED:
        eng.submit(p, max_new=MAX_NEW)
    return _drain(eng)


@pytest.mark.parametrize("budget", [16, 24])
def test_budgeted_prefill_token_identical(sides, reference, budget):
    teng, _ = mirror(sides, lambda s: _serve_all(
        _paged(s, prefill_budget=budget)))
    assert tokens_by_rid(teng) == reference
    # the 45-token prompt cannot fit one chunk: prefill was chunked
    assert teng.stats.prefill_chunks > len(MIXED)


def test_budget_bounds_every_steps_prefill(sides):
    budget = 16

    def script(s):
        eng = _paged(s, prefill_budget=budget)
        for p in MIXED:
            eng.submit(p, max_new=MAX_NEW)
        deltas = []
        while True:
            before = eng.stats.prefill_tokens
            if not eng.step():
                break
            deltas.append(eng.stats.prefill_tokens - before)
        return eng, deltas

    (teng, deltas), (_, jdeltas) = mirror(sides, script)
    assert deltas == jdeltas and deltas and max(deltas) <= budget
    # computed chunks and reused prefix tokens cover every prompt
    assert teng.stats.prefill_tokens + teng.stats.prefix_hit_tokens == \
        sum(len(p) for p in MIXED)


def test_prefill_budget_init_rejections(sides):  # noqa: F811
    for s in sides:
        with pytest.raises(ValueError, match="paged"):
            s.make(n_slots=2, max_len=64, prefill_budget=16)
        with pytest.raises(ValueError, match="kv_block_size"):
            _paged(s, prefill_budget=4)      # below one block
        with pytest.raises(ValueError, match="speculate"):
            _paged(s, prefill_budget=16, speculate=True)


def test_mid_prefill_preemption_token_identical(sides, reference):
    """A long prompt preempted mid-prefill by higher-priority arrivals
    publishes its consumed prefix and resumes token-identically."""
    def script(s):
        eng = _paged(s, prefill_budget=8, num_blocks=2 * 2 * 8 + 2)
        long_rid = eng.submit(MIXED[2], max_new=MAX_NEW, priority=0)
        eng.step()                            # first chunk consumed
        assert any(x is not None and x.prefilling for x in eng.slots)
        hi = [eng.submit(MIXED[0], max_new=MAX_NEW, priority=5),
              eng.submit(MIXED[3], max_new=MAX_NEW, priority=5)]
        return _drain(eng), long_rid, hi

    (teng, long_rid, hi), _ = mirror(sides, script)
    assert teng.stats.preempted_prefill >= 1
    got = outcomes(teng)
    assert got[long_rid][0] == reference[2]
    assert got[hi[0]][0] == reference[0] and got[hi[1]][0] == reference[3]


# ---------------------------------------------------------------------------
# Streaming emission
# ---------------------------------------------------------------------------

def test_on_token_emits_exactly_the_finished_tokens(sides, reference):
    def script(s):
        got = {}

        def tap(req, tok):
            got.setdefault(req.rid, []).append(tok)

        eng = _paged(s, decode_chunk=1)
        rids = [eng.submit(p, max_new=MAX_NEW, on_token=tap) for p in MIXED]
        return _drain(eng), rids, got

    (teng, rids, got), _ = mirror(sides, script)
    by_rid = outcomes(teng)
    for rid, want in zip(rids, reference):
        assert got[rid] == want == by_rid[rid][0]


def test_t_first_stamped_at_first_emission(sides):
    def script(s):
        eng = _paged(s, decode_chunk=1, clock=_clock())
        rid = eng.submit(MIXED[0], max_new=MAX_NEW)
        r = {x.rid: x for x in _drain(eng).finished}[rid]
        return eng, (r.t_submit, r.t_first, r.t_last)

    (_, stamps), (_, jstamps) = mirror(sides, script)
    t_submit, t_first, t_last = stamps
    assert stamps == jstamps
    assert t_first is not None and t_submit < t_first <= t_last


def test_stream_generator_matches_generate(sides, reference):
    for s in sides:
        eng = _paged(s)
        assert list(eng.stream(MIXED[1], max_new=MAX_NEW)) == reference[1]


def test_stream_early_close_cancels(sides, reference):
    def script(s):
        eng = _paged(s, decode_chunk=1)
        seen = []
        for tok in eng.stream(MIXED[0], max_new=MAX_NEW):
            seen.append(tok)
            if len(seen) == 2:
                break                         # the client walks away
        return eng, seen

    (teng, seen), _ = mirror(sides, script)
    assert seen == reference[0][:2]
    assert teng.stats.cancelled == 1
    assert all(s is None for s in teng.slots)
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


# ---------------------------------------------------------------------------
# Cancellation: queued / mid-prefill / mid-decode / from the callback
# ---------------------------------------------------------------------------

def test_cancel_while_queued(sides, reference):
    def script(s):
        eng = _paged(s, n_slots=1)
        keep = eng.submit(MIXED[0], max_new=MAX_NEW)
        victim = eng.submit(MIXED[3], max_new=MAX_NEW)
        assert eng.cancel(victim) is True
        _drain(eng)
        assert eng.cancel(victim) is False    # already finished
        with pytest.raises(KeyError):
            eng.cancel(10_000)
        return eng, keep, victim

    (teng, keep, victim), _ = mirror(sides, script)
    got = outcomes(teng)
    assert got[victim] == ([], "cancelled")
    assert got[keep][0] == reference[0]


def test_cancel_mid_prefill_chunk_keeps_published_prefix(sides, reference):
    def script(s):
        eng = _paged(s, prefill_budget=8, decode_chunk=1)
        victim = eng.submit(MIXED[2], max_new=MAX_NEW)
        eng.step()
        x = next(x for x in eng.slots if x is not None and x.rid == victim)
        assert x.prefilling and 0 < x.prefill_cursor < len(MIXED[2])
        assert eng.cancel(victim) is True
        assert all(x is None for x in eng.slots)
        eng.pager.check_consistency()
        hits_before = eng.stats.prefix_hit_tokens
        retry = eng.submit(MIXED[2], max_new=MAX_NEW)
        _drain(eng)
        assert eng.stats.prefix_hit_tokens > hits_before
        return eng, victim, retry

    (teng, victim, retry), _ = mirror(sides, script)
    got = outcomes(teng)
    assert got[victim] == ([], "cancelled")
    # the consumed chunks were published: the retry reused them and still
    # decodes token-identically
    assert got[retry][0] == reference[2]
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


def _seated_tokens(eng, rid):
    for s in eng.slots:
        if s is not None and s.rid == rid and not s.prefilling:
            return list(s.tokens)
    return []


def test_cancel_mid_decode_leaves_prefix_and_survivors_identical(
        sides, reference):
    def script(s):
        eng = _paged(s, decode_chunk=1)
        victim = eng.submit(MIXED[0], max_new=MAX_NEW)
        keep = eng.submit(MIXED[1], max_new=MAX_NEW)
        while not _seated_tokens(eng, victim):
            eng.step()
        assert eng.cancel(victim) is True
        return _drain(eng), victim, keep

    (teng, victim, keep), _ = mirror(sides, script)
    got = outcomes(teng)
    toks, reason = got[victim]
    assert reason == "cancelled" and 0 < len(toks) < len(reference[0])
    assert toks == reference[0][:len(toks)]
    assert got[keep][0] == reference[1]
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


def test_stop_stream_from_callback_cancels(sides, reference):
    def script(s):
        emitted = []

        def client(req, tok):
            emitted.append(tok)
            if len(emitted) == 3:
                raise s.stop_stream()

        eng = _paged(s)
        rid = eng.submit(MIXED[1], max_new=MAX_NEW, on_token=client)
        return _drain(eng), rid, emitted

    (teng, rid, emitted), _ = mirror(sides, script)
    assert outcomes(teng)[rid] == (reference[1][:3], "cancelled")
    assert emitted == reference[1][:3]
    assert teng.stats.cancelled == 1
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


def test_cancel_releases_adapter_pin(sides):
    def script(s):
        reg, names = s.adapters(s.cfg, 1)
        eng = _paged(s, adapters=reg, decode_chunk=1)
        rid = eng.submit(MIXED[0], max_new=MAX_NEW, adapter=names[0])
        eng.step()
        assert any(reg._refs)                 # pinned while in flight
        assert eng.cancel(rid) is True
        assert not any(reg._refs)
        eng.pager.evict_prefixes()
        assert eng.pager.blocks_in_use == 0
        return eng

    mirror(sides, script)


# ---------------------------------------------------------------------------
# Execution deadlines (injected clock)
# ---------------------------------------------------------------------------

def test_ttft_deadline_expires_mid_prefill(sides):
    def script(s):
        eng = _paged(s, prefill_budget=8, clock=_clock())
        rid = eng.submit(MIXED[2], max_new=MAX_NEW, ttft_deadline_s=2.0)
        return _drain(eng), rid

    (teng, rid), _ = mirror(sides, script)
    assert outcomes(teng)[rid] == ([], "expired")
    assert all(s is None for s in teng.slots)
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


def test_itl_deadline_expires_stalled_stream(sides, reference):
    def script(s):
        eng = _paged(s, decode_chunk=1, clock=_clock())
        rid = eng.submit(MIXED[0], max_new=MAX_NEW, itl_deadline_s=0.0)
        return _drain(eng), rid

    (teng, rid), _ = mirror(sides, script)
    toks, reason = outcomes(teng)[rid]
    # the virtual clock advances on every read, so any gap after the
    # first token passes an inter-token deadline of zero
    assert reason == "expired" and 0 < len(toks) < len(reference[0])
    assert toks == reference[0][:len(toks)]
    teng.pager.evict_prefixes()
    assert teng.pager.blocks_in_use == 0


def test_generous_deadlines_do_not_expire(sides, reference):
    def script(s):
        eng = _paged(s, prefill_budget=16)
        rids = [eng.submit(p, max_new=MAX_NEW, ttft_deadline_s=1e6,
                           itl_deadline_s=1e6) for p in MIXED]
        return _drain(eng), rids

    (teng, rids), _ = mirror(sides, script)
    assert teng.stats.expired == 0
    got = outcomes(teng)
    assert [got[rid][0] for rid in rids] == reference
