"""The serving engine's bounded, priority-ordered wait queue.

Host-only request bookkeeping, copied from the JAX package's
``serve/scheduler.py``. ``max_queue=None`` (the default) is unbounded;
when a bounded queue is full, ``offer`` applies the admission policy:
"block" (the caller drains the engine and re-offers), "reject" (shed the
newcomer) or "evict" (shed the lowest-priority, youngest queued request
strictly below the newcomer). Requests admit in (priority desc, rid asc)
order.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

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
