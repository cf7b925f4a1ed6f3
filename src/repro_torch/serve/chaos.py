"""Serving fault-injection harness: the port of the JAX package's
``serve/chaos.py``.

Each scenario drives a :class:`~repro_torch.serve.engine.ServeEngine`
through one failure mode (pool exhaustion, prefix-eviction storms,
injected dispatch faults, bursts of priority arrivals against a bounded
queue, adapter evictions racing in-flight LoRA requests, faults and pool
pressure under speculative decoding, long prompts
under a chunked-prefill budget, cancellation storms against streaming
clients) and then audits the engine against two invariants:

1. **Zero lost requests.** Every submitted request finishes exactly once
   with a ``finish_reason``; the engine ends drained (no slot, no queue,
   no leaked pool block, no adapter pin), and the pager's books pass
   ``check_consistency`` after every step.
2. **Zero corrupted requests.** Every request that finished with a
   generation reason holds the tokens of a fault-free reference run of
   the same prompt on the same device, preempted and restored ones
   included; a request cut short (expired or cancelled) holds a prefix
   of them. On the CPU they are bit-identical; on the card a budgeted
   chunk or a recompute restore runs other kernel shapes than the
   reference, so a differing request is listed in ``mismatches`` for the
   caller to hold to the token gate (``serve/token_gate.py``).

Faults are injected three ways, all deterministic:

- :class:`ServeFailureInjector`, the engine's ``fault_hook``: raises
  ``RuntimeError`` at chosen dispatch ordinals, right before a prefill or
  decode dispatch. The driver retries the step, which must replay
  cleanly (admission rolled back and requeued, the decode commit
  idempotent).
- :class:`BlockThief`: holds pool blocks that belong to no slot and no
  index entry, pressure LRU eviction cannot relieve; admission must defer
  and decode planning must preempt, and everything restores once the
  thief gives the blocks back.
- The scenario itself: eviction storms (``evict_prefixes``), bursts with
  mixed priorities and deadlines against a small ``max_queue``, and
  ``AdapterRegistry.evict`` racing pinned LoRA requests.

``speculation_storm`` injects its faults at the speculative engine's
"draft" and "verify" dispatches and holds the result to a fault-free
target-only run.

Run ``python -m repro_torch.serve.chaos --smoke --device cpu`` (or
``--device cuda``, the default); ``--scenario NAME`` runs one scenario.
The exit status is non-zero on any invariant violation.
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import json
import sys
from typing import Callable, Dict, List, Optional

import numpy as np

from repro_torch.configs.base import ModelConfig
from repro_torch.models.model import get_model
from repro_torch.serve.adapters import make_synthetic_adapters
from repro_torch.serve.engine import ServeEngine, StopStream
from repro_torch.serve.scheduler import pick_victim

CFG = ModelConfig(name="chaos", family="dense", n_layers=2, d_model=64,
                  n_heads=4, n_kv_heads=2, d_ff=128, vocab_size=256,
                  head_dim=16, vocab_pad_multiple=64, dtype="float32")

#: default chaos workload: mixed lengths, shared-prefix pairs
WORKLOAD = [np.arange(8), np.arange(12) + 3, np.arange(31) + 7,
            np.arange(12) + 40, np.arange(8) + 60, np.arange(31) + 90,
            np.arange(20) + 11, np.arange(9) + 120]

MAX_NEW = 6
MAX_LEN = 64
BLOCK = 8


class ServeFailureInjector:
    """Engine ``fault_hook`` raising at chosen dispatch ordinals.

    ``fail_at`` counts calls across the selected ``phases`` ("prefill" /
    "decode", or "draft" / "verify" under speculation); each listed
    ordinal raises once, before the dispatch, where the engine guarantees
    rollback."""

    def __init__(self, fail_at=(), phases=("prefill", "decode")):
        self.remaining = set(fail_at)
        self.phases = set(phases)
        self.calls = 0
        self.raised = 0

    def __call__(self, phase: str):
        if phase not in self.phases:
            return
        self.calls += 1
        if self.calls in self.remaining:
            self.remaining.discard(self.calls)
            self.raised += 1
            raise RuntimeError(
                f"injected {phase} fault at dispatch {self.calls}")


class BlockThief:
    """Holds pool blocks for a window of steps.

    Held blocks have no slot and no index entry, so LRU eviction cannot
    free them: from the engine's view the pool shrank. Admission must
    defer and decode planning must preempt while the window lasts."""

    def __init__(self, steal: int, hold_steps: int, start_step: int = 1):
        self.steal = steal
        self.hold_steps = hold_steps
        self.start_step = start_step
        self.step = 0
        self.held: List[int] = []

    def on_step(self, eng: ServeEngine):
        self.step += 1
        if self.step == self.start_step:
            # take the free list, not the index (stealing must not itself
            # evict); preemption and prefix eviction keep returning blocks
            for _ in range(min(self.steal, len(eng.pager._free))):
                self.held.append(eng.pager.alloc())
        if self.step == self.start_step + self.hold_steps:
            self.release(eng)

    def release(self, eng: ServeEngine):
        for b in self.held:
            eng.pager._release_block(b)
        self.held = []


@dataclasses.dataclass
class ChaosReport:
    scenario: str
    submitted: int = 0
    finished: int = 0                 # generation outcomes
    rejected: int = 0
    expired: int = 0
    cancelled: int = 0
    preempted: int = 0
    preempted_prefill: int = 0
    restored: int = 0
    fast_restores: int = 0
    faults_injected: int = 0
    step_retries: int = 0
    lost: int = 0                     # submitted but unaccounted for
    # requests whose tokens differ from (or, cut short, are no prefix of)
    # the fault-free run: rid, prompt, adapter, tokens, reference
    mismatches: List[dict] = dataclasses.field(default_factory=list)
    errors: List[str] = dataclasses.field(default_factory=list)
    # the audited engine (its weights and registry serve the token gate)
    engine: Optional[ServeEngine] = dataclasses.field(default=None,
                                                      repr=False)

    @property
    def mismatched(self) -> int:
        return len(self.mismatches)

    @property
    def ok(self) -> bool:
        return self.lost == 0 and not self.mismatches and not self.errors

    def as_dict(self) -> dict:
        d = {f.name: getattr(self, f.name)
             for f in dataclasses.fields(self)
             if f.name not in ("engine", "mismatches")}
        d["mismatches"] = [
            {k: (np.asarray(v).tolist() if k == "prompt" else v)
             for k, v in m.items()} for m in self.mismatches]
        d["mismatched"] = self.mismatched
        d["ok"] = self.ok
        return d


def _params(device):
    return get_model(CFG).init(seed=0, device=device)


def _reference(params, prompts, device, max_new=MAX_NEW, **kw) -> List[list]:
    """Fault-free tokens for ``prompts`` on a roomy engine."""
    eng = ServeEngine(CFG, params, n_slots=4, max_len=MAX_LEN, device=device,
                      **kw)
    return eng.generate(prompts, max_new=max_new)


def _drive(eng: ServeEngine, report: ChaosReport,
           post_step: Optional[Callable] = None,
           thief: Optional[BlockThief] = None,
           max_retries: int = 200) -> None:
    """Run the engine to drain, retrying steps killed by injected faults
    (anything else propagates: a real bug, not chaos)."""
    while True:
        try:
            while eng.step():
                if post_step is not None:
                    post_step(eng)
                if eng.paged:
                    eng.pager.check_consistency(
                        external=thief.held if thief else ())
            return
        except RuntimeError as e:
            if "injected" not in str(e):
                raise
            report.step_retries += 1
            if report.step_retries > max_retries:
                raise


def _audit(eng: ServeEngine, rid_to_prompt: Dict[int, int],
           prompts: list, reference: List[list], report: ChaosReport,
           adapters: Optional[list] = None) -> None:
    """Check the zero-lost and zero-corrupted invariants after the drain."""
    st = eng.stats
    report.engine = eng
    for name in ("finished", "rejected", "expired", "cancelled", "preempted",
                 "preempted_prefill", "restored", "fast_restores"):
        setattr(report, name, getattr(st, name))
    seen = {}
    for r in eng.finished:
        if r.rid in seen:
            report.errors.append(f"rid {r.rid} finished twice")
        seen[r.rid] = r
    report.lost = len(set(rid_to_prompt) - set(seen))
    if report.lost:
        report.errors.append(f"{report.lost} request(s) never finished")
    for rid, r in seen.items():
        if r.finish_reason is None:
            report.errors.append(f"rid {rid} finished without a reason")
        if r.finish_reason == "rejected":
            if r.tokens:
                report.errors.append(f"rid {rid} was rejected but has "
                                     f"tokens")
            continue
        i = rid_to_prompt[rid]
        want = reference[i]
        # cut short mid-stream (expired, cancelled): what the client got
        # must be a prefix of the fault-free tokens, partial, never corrupt
        partial = r.finish_reason in ("expired", "cancelled")
        if r.tokens != (want[:len(r.tokens)] if partial else want):
            report.mismatches.append(dict(
                rid=rid, prompt=prompts[i], tokens=list(r.tokens),
                reference=list(want), finish_reason=r.finish_reason,
                preemptions=r.preemptions,
                adapter=adapters[i] if adapters else None))
    if any(s is not None for s in eng.slots):
        report.errors.append("slots still held after drain")
    if eng.queue:
        report.errors.append("queue non-empty after drain")
    if eng.paged:
        eng.pager.check_consistency()
        for slot in range(eng.n_slots):
            if eng.pager.slot_blocks(slot):
                report.errors.append(f"slot {slot} leaked pool blocks")
    if eng.registry is not None and any(eng.registry._refs):
        report.errors.append(f"adapter pins leaked: "
                             f"{list(eng.registry._refs)}")


def _submit_all(eng, prompts, report, **kw) -> Dict[int, int]:
    rid_to_prompt = {}
    for i, p in enumerate(prompts):
        rid_to_prompt[eng.submit(p, MAX_NEW, **kw)] = i
        report.submitted += 1
    return rid_to_prompt


def _paged_engine(params, device, **kw) -> ServeEngine:
    kw.setdefault("n_slots", 4)
    return ServeEngine(CFG, params, max_len=kw.pop("max_len", MAX_LEN),
                       paged=True, kv_block_size=BLOCK, device=device, **kw)


# ---------------------------------------------------------------------------
# Scenarios
# ---------------------------------------------------------------------------

def scenario_pool_exhaustion(params, smoke: bool, device) -> ChaosReport:
    """A thief drains the free list mid-serve: admission defers, decode
    planning preempts victims (swap-out), and everything restores
    token-identically once the blocks return."""
    report = ChaosReport("pool_exhaustion")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)
    # decode_chunk=1 keeps requests in flight across steps, so the window
    # of pressure catches them mid-decode
    eng = _paged_engine(params, device, decode_chunk=1)
    thief = BlockThief(steal=10_000, hold_steps=6)
    rid_to_prompt = _submit_all(eng, prompts, report)
    try:
        _drive(eng, report, post_step=thief.on_step, thief=thief)
    finally:
        thief.release(eng)
    _drive(eng, report)               # drain anything deferred at the end
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if report.preempted == 0 and report.errors == []:
        report.errors.append("pool pressure never triggered a preemption "
                             "or deferral (thief too weak?)")
    return report


def scenario_eviction_storm(params, smoke: bool, device) -> ChaosReport:
    """Every cached prefix is evicted after every step, so a preempted
    request can never fast-restore: the recompute path must still be
    token-identical."""
    report = ChaosReport("eviction_storm")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)
    eng = _paged_engine(params, device, decode_chunk=1)
    thief = BlockThief(steal=10_000, hold_steps=6)

    def storm(e):
        thief.on_step(e)
        e.pager.evict_prefixes()      # drop every index-only block

    rid_to_prompt = _submit_all(eng, prompts, report)
    try:
        _drive(eng, report, post_step=storm, thief=thief)
    finally:
        thief.release(eng)
    _drive(eng, report)
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if report.fast_restores:
        report.errors.append("fast restore should be impossible under a "
                             "full eviction storm")
    if report.preempted == 0 and report.errors == []:
        report.errors.append("the storm never forced a preemption")
    return report


def scenario_dispatch_faults(params, smoke: bool, device) -> ChaosReport:
    """RuntimeError right before prefill and decode dispatches: every
    faulted step must retry cleanly (admission rolled back and requeued,
    the decode commit idempotent) with no lost work."""
    report = ChaosReport("dispatch_faults")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)
    inj = ServeFailureInjector(fail_at=(1, 3, 4, 7))
    eng = _paged_engine(params, device, n_slots=2, fault_hook=inj)
    rid_to_prompt = _submit_all(eng, prompts, report)
    _drive(eng, report)
    report.faults_injected = inj.raised
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if inj.raised == 0:
        report.errors.append("no fault was ever injected")
    return report


def scenario_burst_arrivals(params, smoke: bool, device) -> ChaosReport:
    """Bursts against a bounded queue with mixed priorities and deadlines
    (virtual clock): low-priority work is evicted or expires as the
    policy says, high-priority arrivals preempt running slots, and what
    finishes is token-identical."""
    report = ChaosReport("burst_arrivals")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)
    clock = itertools.count(0)        # 1 virtual second per observation
    eng = _paged_engine(params, device, n_slots=2, max_queue=3,
                        admission="evict", decode_chunk=1,
                        clock=lambda: float(next(clock)))
    rid_to_prompt = {}
    half = len(prompts) // 2
    # burst 1: low priority, generous deadlines
    for i, p in enumerate(prompts[:half]):
        rid = eng.submit(p, MAX_NEW, priority=0, deadline_s=10_000.0)
        rid_to_prompt[rid] = i
        report.submitted += 1
    eng.step()
    # burst 2: high priority; preempts burst-1 slots, evicts queued ones
    for i, p in enumerate(prompts[half:]):
        rid = eng.submit(p, MAX_NEW, priority=5)
        rid_to_prompt[rid] = half + i
        report.submitted += 1
    # one urgent straggler whose deadline has passed: it outranks everyone
    # (so the evict policy seats it in the full queue) but must expire at
    # the next admission scan, not run
    rid = eng.submit(prompts[0], MAX_NEW, priority=9, deadline_s=0.0)
    rid_to_prompt[rid] = 0
    report.submitted += 1
    _drive(eng, report)
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if report.expired == 0:
        report.errors.append("the deadline-0 request did not expire")
    if report.preempted == 0 and report.errors == []:
        report.errors.append("the high-priority burst never preempted a "
                             "running low-priority slot")
    return report


def scenario_adapter_race(params, smoke: bool, device) -> ChaosReport:
    """``AdapterRegistry.evict`` racing in-flight LoRA requests: evicting a
    pinned adapter must raise (not corrupt), pins must release at finish,
    also for requests that died to an injected prefill fault and were
    retried, and the evict must succeed after the drain."""
    report = ChaosReport("adapter_race")
    reg, names = make_synthetic_adapters(CFG, n=2, device=device)
    inj = ServeFailureInjector(fail_at=(2,), phases=("prefill",))
    # decode_chunk=1 so the first step leaves the requests mid-decode
    # with their pins held (one chunk of 8 would finish them)
    eng = _paged_engine(params, device, n_slots=2, quantize=True,
                        adapters=reg, fault_hook=inj, decode_chunk=1)
    prompts = [np.arange(8), np.arange(12) + 3, np.arange(8) + 60,
               np.arange(9) + 120]
    adapters = [names[0], names[1], names[0], None]
    ref_reg, ref_names = make_synthetic_adapters(CFG, n=2, device=device)
    ref_eng = ServeEngine(CFG, params, n_slots=4, max_len=MAX_LEN,
                          quantize=True, adapters=ref_reg, device=device)
    rename = dict(zip(names, ref_names))
    reference = ref_eng.generate(
        prompts, max_new=MAX_NEW,
        adapters=[None if a is None else rename[a] for a in adapters])
    rid_to_prompt = {}
    for i, (p, a) in enumerate(zip(prompts, adapters)):
        rid_to_prompt[eng.submit(p, MAX_NEW, adapter=a)] = i
        report.submitted += 1
    raced = 0
    try:
        eng.step()                    # adapters now pinned in flight
    except RuntimeError as e:
        if "injected" not in str(e):
            raise
        report.step_retries += 1
    for name in names:                # the race: evict while pinned
        try:
            reg.evict(name)
            report.errors.append(f"evict({name!r}) succeeded while pinned")
        except RuntimeError:
            raced += 1
    _drive(eng, report)
    report.faults_injected = inj.raised
    _audit(eng, rid_to_prompt, prompts, reference, report, adapters)
    if raced == 0:
        report.errors.append("no pinned-evict race was exercised")
    for name in names:                # pins released: evict is legal now
        try:
            reg.evict(name)
        except RuntimeError as e:
            report.errors.append(f"evict({name!r}) still pinned after "
                                 f"drain: {e}")
    return report


def scenario_speculation_storm(params, smoke: bool, device) -> ChaosReport:
    """Speculative decoding under fire: faults injected right before the
    draft and verify dispatches, and a thief forcing preemption of
    speculating slots mid-flight (or, where every window still fits, the
    storm preempting one itself). A retried round must replay bit for bit
    (the draft steps are deterministic and both caches' cursors are set
    from the host every round), rollback must return every rejected tail
    block, and the tokens must equal a fault-free TARGET-ONLY run, which
    also shows that speculation changes nothing."""
    report = ChaosReport("speculation_storm")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)   # target-only
    inj = ServeFailureInjector(fail_at=(1, 3, 4, 7),
                               phases=("draft", "verify"))
    eng = _paged_engine(params, device, fault_hook=inj, speculate=True,
                        spec_k=4)
    thief = BlockThief(steal=10_000, hold_steps=4, start_step=2)

    def storm(e):
        thief.on_step(e)
        # whether a verify window crosses a block boundary while the pool
        # is held depends on how much the draft's tokens are accepted,
        # which depends on the weights: one step into the theft, a storm
        # that has not preempted yet preempts a speculating slot itself,
        # as the pool's pressure would have (with the JAX harness's
        # weights the pressure has preempted by then, and this is a no-op)
        if thief.step == thief.start_step + 1 and e.stats.preempted == 0:
            victim = pick_victim(e.slots)
            if victim is not None:
                e._preempt_slot(victim)

    rid_to_prompt = _submit_all(eng, prompts, report)
    try:
        _drive(eng, report, post_step=storm, thief=thief)
    finally:
        thief.release(eng)
    _drive(eng, report)
    report.faults_injected = inj.raised
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if inj.raised == 0:
        report.errors.append("no draft/verify fault was ever injected")
    if report.preempted == 0 and report.errors == []:
        report.errors.append("the thief never preempted a speculating "
                             "slot")
    if report.fast_restores:
        report.errors.append("fast restore must be off under speculation "
                             "(stale draft KV)")
    if eng.stats.accepted_draft_tokens == 0 and report.errors == []:
        report.errors.append("speculation never accepted a draft token "
                             "(draft hopelessly misaligned?)")
    return report


def scenario_long_prompt_storm(params, smoke: bool, device) -> ChaosReport:
    """Long prompts under a chunked-prefill budget while a thief drains
    the pool: no step may prefill more than the budget, the mid-prefill
    victim must be preempted with its consumed prefix published (never
    swapped), and everything, long prompts restored from a partial cursor
    included, must finish token-identical to an unbudgeted fault-free
    run."""
    report = ChaosReport("long_prompt_storm")
    budget = 16
    max_len = 128
    # shorts first (small rids decode early), longs last (youngest, so the
    # preferred victims while still mid-prefill)
    prompts = [np.arange(8), np.arange(12) + 40, np.arange(9) + 120,
               np.arange(100) % 256]
    if not smoke:
        prompts += [np.arange(20) + 11, np.arange(100) + 50]
    ref = ServeEngine(CFG, params, n_slots=4, max_len=max_len, device=device)
    reference = ref.generate(prompts, max_new=MAX_NEW)
    eng = _paged_engine(params, device, n_slots=2, max_len=max_len,
                        decode_chunk=1, prefill_budget=budget)
    thief = BlockThief(steal=10_000, hold_steps=5, start_step=1)
    seen = {"prefill_tokens": 0}

    def storm(e):
        thief.on_step(e)
        delta = e.stats.prefill_tokens - seen["prefill_tokens"]
        seen["prefill_tokens"] = e.stats.prefill_tokens
        if delta > budget:
            report.errors.append(
                f"a step prefilled {delta} tokens > budget {budget}")

    rid_to_prompt = _submit_all(eng, prompts, report)
    try:
        _drive(eng, report, post_step=storm, thief=thief)
    finally:
        thief.release(eng)
    _drive(eng, report, post_step=storm)
    _audit(eng, rid_to_prompt, prompts, reference, report)
    if report.preempted_prefill == 0 and report.errors == []:
        report.errors.append("the storm never preempted a mid-prefill "
                             "slot (thief too weak / prompts too short?)")
    if eng.stats.prefill_chunks <= report.submitted and report.errors == []:
        report.errors.append("prefill was never actually chunked")
    return report


def scenario_cancel_storm(params, smoke: bool, device) -> ChaosReport:
    """Cancellation at every point of a request's life (queued,
    mid-prefill chunk, mid-decode, and a streaming client whose callback
    raises StopStream) while the rest of the workload runs: every
    teardown balances the books (slot, blocks, pins), a cancelled stream
    holds a prefix of the fault-free tokens, and the surviving streams
    stay token-identical."""
    report = ChaosReport("cancel_storm")
    prompts = WORKLOAD[:6] if smoke else WORKLOAD
    reference = _reference(params, prompts, device)
    # budget 8 takes the 31-token prompt through several chunks (a
    # mid-prefill window); decode_chunk=1 keeps streams in flight across
    # steps (a mid-decode window)
    eng = _paged_engine(params, device, n_slots=2, decode_chunk=1,
                        prefill_budget=8)
    hangup = {"tokens": 0}

    def client(req, tok):
        hangup["tokens"] += 1
        if hangup["tokens"] >= 2:
            raise StopStream()         # the client went away mid-stream

    rid_to_prompt = {}
    for i, p in enumerate(prompts):
        kw = {"on_token": client} if i == 1 else {}
        rid_to_prompt[eng.submit(p, MAX_NEW, **kw)] = i
        report.submitted += 1
    by_prompt = {v: k for k, v in rid_to_prompt.items()}
    rid_prefill, rid_decode = by_prompt[2], by_prompt[3]
    if not eng.cancel(by_prompt[4]):   # cancel while still queued
        report.errors.append("queued cancel returned False")
    fired = {"prefill": False, "decode": False}

    def storm(e):
        if not fired["prefill"]:
            for s in e.slots:
                if s is not None and s.rid == rid_prefill and s.prefilling:
                    e.cancel(rid_prefill)
                    fired["prefill"] = True
        if not fired["decode"]:
            for s in e.slots:
                if (s is not None and s.rid == rid_decode
                        and not s.prefilling and s.tokens):
                    e.cancel(rid_decode)
                    fired["decode"] = True

    _drive(eng, report, post_step=storm)
    _audit(eng, rid_to_prompt, prompts, reference, report)
    for point, did in fired.items():
        if not did:
            report.errors.append(f"mid-{point} cancel never found its "
                                 f"target in a slot")
    if hangup["tokens"] < 2:
        report.errors.append("the StopStream client never saw 2 tokens")
    if report.cancelled != 4:
        report.errors.append(f"expected 4 cancelled, got "
                             f"{report.cancelled}")
    # with every stream torn down or finished, evicting the cached
    # prefixes must drain the pool to zero: nothing leaked
    eng.pager.evict_prefixes()
    if eng.pager.blocks_in_use:
        report.errors.append(f"{eng.pager.blocks_in_use} pool blocks "
                             f"leaked after cancel teardown")
    return report


SCENARIOS = {
    "pool_exhaustion": scenario_pool_exhaustion,
    "eviction_storm": scenario_eviction_storm,
    "dispatch_faults": scenario_dispatch_faults,
    "burst_arrivals": scenario_burst_arrivals,
    "adapter_race": scenario_adapter_race,
    "speculation_storm": scenario_speculation_storm,
    "long_prompt_storm": scenario_long_prompt_storm,
    "cancel_storm": scenario_cancel_storm,
}


def run(scenarios=None, smoke: bool = False, device="cuda",
        params=None) -> List[ChaosReport]:
    """Run ``scenarios`` (default: all) on ``device``, with the harness's
    own seeded weights unless ``params`` are given."""
    names = list(scenarios or SCENARIOS)
    if params is None:
        params = _params(device)
    return [SCENARIOS[name](params, smoke, device) for name in names]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--scenario", choices=sorted(SCENARIOS),
                    default=None, help="run one scenario (default: all)")
    ap.add_argument("--smoke", action="store_true",
                    help="smaller workloads (CI lane)")
    ap.add_argument("--device", default="cuda",
                    help="device to serve on (default: cuda)")
    args = ap.parse_args(argv)
    names = [args.scenario] if args.scenario else None
    reports = run(names, smoke=args.smoke, device=args.device)
    print(json.dumps([r.as_dict() for r in reports], indent=2))
    bad = [r for r in reports if not r.ok]
    for r in bad:
        print(f"FAIL {r.scenario}: {'; '.join(r.errors)}; "
              f"{r.mismatched} mismatched", file=sys.stderr)
    print(f"chaos: {len(reports) - len(bad)}/{len(reports)} scenarios ok")
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
