"""Admission control of the serving engine: the bounded wait queue, the
preemption victim, the chunked-prefill chunk, open-loop arrivals.

Host-only request bookkeeping, copied from the JAX package's
``serve/scheduler.py``. ``max_queue=None`` (the default) is unbounded;
when a bounded queue is full, ``offer`` applies the admission policy:
"block" (the caller drains the engine and re-offers), "reject" (shed the
newcomer) or "evict" (shed the lowest-priority, youngest queued request
strictly below the newcomer). Requests admit in (priority desc, rid asc)
order, so a preempted request, which keeps its rid, re-enters ahead of
its priority class. :func:`pick_victim` chooses the running slot to
preempt, :func:`prefill_chunk` the prompt tokens a step spends under a
prefill budget, and :func:`arrival_times` a benchmark's arrival offsets.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np

#: offer() behaviors when the wait queue is at max_queue
ADMISSION_POLICIES = ("block", "reject", "evict")


@dataclasses.dataclass
class QueueDecision:
    """Outcome of offering a request to the queue."""
    admitted: bool                     # the offered request entered the queue
    evicted: Optional[object] = None   # queued request shed to make room
    must_block: bool = False           # queue full under "block": caller drains


class WaitQueue:
    """Bounded, priority-ordered wait queue. Stores engine ``Request``
    objects and reads only their ``rid``, ``priority``, ``deadline_s`` and
    ``t_submit`` attributes."""

    def __init__(self, max_queue: Optional[int] = None,
                 policy: str = "block"):
        if policy not in ADMISSION_POLICIES:
            raise ValueError(f"admission policy must be one of "
                             f"{ADMISSION_POLICIES}, got {policy!r}")
        if max_queue is not None and max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {max_queue}")
        self.max_queue = max_queue
        self.policy = policy
        self._items: List[object] = []

    def __len__(self) -> int:
        return len(self._items)

    def __bool__(self) -> bool:
        return bool(self._items)

    def __iter__(self):
        return iter(self._items)

    @property
    def full(self) -> bool:
        return self.max_queue is not None and len(self._items) >= \
            self.max_queue

    def offer(self, req) -> QueueDecision:
        """Apply the admission policy to ``req`` (see the module doc). An
        ``evicted`` request has been removed; the caller finishes it."""
        if not self.full:
            self._items.append(req)
            return QueueDecision(admitted=True)
        if self.policy == "block":
            return QueueDecision(admitted=False, must_block=True)
        if self.policy == "reject":
            return QueueDecision(admitted=False)
        victim_i = None
        for i, r in enumerate(self._items):
            if r.priority >= req.priority:
                continue
            if victim_i is None:
                victim_i = i
                continue
            v = self._items[victim_i]
            if (r.priority, -r.rid) < (v.priority, -v.rid):
                victim_i = i
        if victim_i is None:
            return QueueDecision(admitted=False)   # newcomer outranks nobody
        victim = self._items.pop(victim_i)
        self._items.append(req)
        return QueueDecision(admitted=True, evicted=victim)

    def push_front(self, req) -> None:
        """Unconditionally requeue an already admitted request."""
        self._items.append(req)

    def _order(self) -> None:
        self._items.sort(key=lambda r: (-r.priority, r.rid))

    def expire(self, now: float) -> List[object]:
        """Remove and return every queued request past its deadline."""
        dead = [r for r in self._items
                if r.deadline_s is not None
                and now - r.t_submit > r.deadline_s]
        if dead:
            gone = set(id(r) for r in dead)
            self._items = [r for r in self._items if id(r) not in gone]
        return dead

    def take(self, k: int) -> List[object]:
        """Pop up to ``k`` requests in admission order."""
        if k <= 0 or not self._items:
            return []
        self._order()
        taken, self._items = self._items[:k], self._items[k:]
        return taken

    def peek_priority(self) -> Optional[int]:
        """Highest queued priority (None when empty)."""
        if not self._items:
            return None
        return max(r.priority for r in self._items)

    def remove(self, req) -> bool:
        try:
            self._items.remove(req)
            return True
        except ValueError:
            return False


def pick_victim(slots: Sequence[object],
                below_priority: Optional[int] = None) -> Optional[int]:
    """Index of the running slot to preempt, or None.

    Victims are chosen lowest-priority first, then youngest (largest
    rid) — the request that has consumed the least service and delays
    the fewest others when rolled back. ``below_priority`` restricts to
    slots *strictly* below that priority (priority preemption must
    never preempt an equal — that would thrash two peers forever).
    ``slots`` entries are engine Requests or None (free slots skipped).
    """
    best = None
    for i, r in enumerate(slots):
        if r is None:
            continue
        if below_priority is not None and r.priority >= below_priority:
            continue
        if best is None:
            best = i
            continue
        b = slots[best]
        if (r.priority, -r.rid) < (b.priority, -b.rid):
            best = i
    return best


def prefill_chunk(remaining: int, budget: int, block_size: int) -> int:
    """Tokens of prompt to prefill this step under a chunked-prefill budget.

    A *final* chunk (everything left fits the budget) takes exactly
    ``remaining`` tokens so the request produces its first logits this
    step. A *non-final* chunk is floored to a whole number of KV blocks:
    the prefill cursor then always sits on a block boundary, which keeps
    the paged scatter whole-block and lets every completed chunk publish
    into the radix index immediately.

    >>> prefill_chunk(10, 64, 8)     # fits: take it all
    10
    >>> prefill_chunk(100, 64, 8)    # non-final: block-aligned floor
    64
    >>> prefill_chunk(100, 60, 8)
    56
    >>> prefill_chunk(100, 7, 8)     # budget below one block: no progress
    0
    >>> prefill_chunk(0, 64, 8)
    0
    """
    if remaining <= 0 or budget <= 0:
        return 0
    if remaining <= budget:
        return remaining
    return (budget // block_size) * block_size


# -- open-loop arrival processes -------------------------------------------

def parse_arrival(spec: str) -> Tuple[str, float]:
    """Parse an arrival spec ``"poisson:<rate>"`` / ``"fixed:<rate>"``.

    Rates are requests/second. Raises ValueError on anything else.

    >>> parse_arrival("fixed:2.5")
    ('fixed', 2.5)
    """
    kind, sep, val = spec.partition(":")
    if not sep or kind not in ("poisson", "fixed"):
        raise ValueError(
            f"arrival spec must be 'poisson:<rate>' or 'fixed:<rate>', "
            f"got {spec!r}")
    rate = float(val)
    if rate <= 0:
        raise ValueError(f"arrival rate must be > 0, got {rate}")
    return kind, rate


def arrival_times(spec: str, n: int, seed: int = 0) -> List[float]:
    """``n`` deterministic arrival offsets (seconds) for ``spec``.

    ``fixed:r`` spaces arrivals exactly ``1/r`` apart; ``poisson:r``
    draws i.i.d. exponential inter-arrival gaps with mean ``1/r`` from
    a seeded generator, so a benchmark's offered load is reproducible.
    """
    kind, rate = parse_arrival(spec)
    if kind == "fixed":
        return [(i + 1) / rate for i in range(n)]
    rng = np.random.default_rng(seed)
    gaps = rng.exponential(1.0 / rate, size=n)
    return list(np.cumsum(gaps))
