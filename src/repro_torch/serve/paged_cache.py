"""Host-side manager for the block-paged KV cache: free-list allocation,
copy-on-write refcounts, and the radix prefix index.

A copy of the JAX package's ``serve/paged_cache.py`` (plain Python and
numpy; it never touches a device). The device side is a shared pool
``[n_layers, n_blocks, block, Hk, hd]`` plus per-slot block tables
(``repro_torch.models.attention.init_paged_cache``); everything about
*ownership* lives here, because it changes at request granularity
(admission, chunk boundaries, finish), never inside a decode step:

- **Free-list allocator.** Blocks are fixed-size (``block_size`` tokens)
  and handed out from a free list. Block 0 is reserved as the *trash
  block*: unallocated table entries point at it and out-of-range writes
  (stopped slots riding through a decode chunk) are routed to it, so
  device code never needs a branch for "no block here".
- **Refcounts + copy-on-write.** A block's refcount counts the slots whose
  tables reference it plus one if the prefix index holds it. Writes only
  ever target uniquely owned blocks: :meth:`prepare_decode` detects a
  shared block in the write window and returns ``(src, dst)`` copy pairs
  for the engine to execute as one batched device copy (``cow_copies``).
  Today's engine flows never share a *writable* block (hits are full
  blocks strictly behind the write cursor and partial blocks are never
  published), so the copy-on-write branch is a defensive invariant.
- **Radix prefix index.** A trie over full *blocks* of token ids (one edge
  per ``block_size``-token chunk: a node's path from the root is the
  exact token prefix its block's KV was computed under). ``match()``
  walks the longest cached prefix of a new prompt; ``insert()`` publishes
  a finished prefill or generation so later requests reuse it. This is
  the paper's computation-reuse principle one level up from weight
  products: requests that share a system prompt skip its prefill.
- **Eviction.** When the free list runs dry, radix leaves that no slot
  references (refcount 1, held only by the index) are evicted in LRU
  order. Blocks referenced by live slots are never evicted, so a pool of
  ``n_slots * max_blocks_per_slot`` blocks (+ trash + one copy-on-write
  spare) never fails to allocate.
- **Plan-then-commit admission.** :meth:`admit` acquires a request's
  prefix hits and allocates its suffix blocks atomically: if the pool
  cannot supply the whole plan, everything taken is rolled back and the
  slot table is left as before. :meth:`plan_decode` and
  :meth:`can_allocate` give the engine the same guarantee for decode
  write windows: count what a chunk needs without mutating, check it
  against ``free + evictable``, and only then commit.

Partial blocks are never indexed or matched: a hit is a whole number of
blocks, capped at ``len(prompt) - 1`` so prefill always has at least one
suffix token to produce logits from.
"""

from __future__ import annotations

import itertools
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

TRASH_BLOCK = 0


class _RadixNode:
    """One cached block: edge key = its ``block_size`` token ids."""
    __slots__ = ("children", "parent", "key", "block", "last_used")

    def __init__(self, parent: Optional["_RadixNode"], key, block: int):
        self.children: Dict[tuple, _RadixNode] = {}
        self.parent = parent
        self.key = key
        self.block = block
        self.last_used = 0


class PagedKVCache:
    """Block allocator + prefix index for one engine's KV pool.

    Device arrays are owned by the engine; this class tracks which pool
    blocks exist, who references them, and which token prefixes they hold.
    """

    def __init__(self, *, n_slots: int, n_blocks: int, block_size: int,
                 max_blocks_per_slot: int, prefix_cache: bool = True):
        if block_size < 1 or block_size & (block_size - 1):
            raise ValueError(f"block_size must be a power of two, got "
                             f"{block_size}")
        min_blocks = n_slots * max_blocks_per_slot + 2  # + trash + CoW spare
        if n_blocks < min_blocks:
            raise ValueError(
                f"n_blocks={n_blocks} cannot back {n_slots} slots of "
                f"{max_blocks_per_slot} blocks each (need >= {min_blocks} "
                f"including the trash block and a copy-on-write spare)")
        self.n_slots = n_slots
        self.n_blocks = n_blocks
        self.block_size = block_size
        self.max_blocks = max_blocks_per_slot
        self.prefix_cache = prefix_cache
        # block 0 is the trash block — never allocated, never freed
        self._free: List[int] = list(range(n_blocks - 1, 0, -1))
        self._ref = np.zeros((n_blocks,), np.int32)
        self._ref[TRASH_BLOCK] = 1            # pin trash out of the free list
        # per-slot tables: allocated prefix of each row holds real block
        # ids, the rest points at trash
        self.tables = np.zeros((n_slots, max_blocks_per_slot), np.int32)
        self._slot_len = np.zeros((n_slots,), np.int32)   # allocated blocks
        self._root = _RadixNode(None, None, TRASH_BLOCK)
        self._clock = itertools.count(1)
        self.evictions = 0

    # -- allocator -----------------------------------------------------------
    @property
    def blocks_in_use(self) -> int:
        """Allocated blocks (trash excluded)."""
        return self.n_blocks - 1 - len(self._free)

    def alloc(self) -> int:
        """Pop a free block (refcount 1), evicting cached prefixes if dry."""
        if not self._free:
            self._evict_one()
        bid = self._free.pop()
        self._ref[bid] = 1
        return bid

    def _release_block(self, bid: int):
        if bid == TRASH_BLOCK:
            return
        self._ref[bid] -= 1
        if self._ref[bid] == 0:
            self._free.append(bid)
        assert self._ref[bid] >= 0, f"refcount underflow on block {bid}"

    def _evict_one(self):
        """Free the LRU evictable radix leaf (index-only refcount)."""
        best: Optional[_RadixNode] = None
        stack = [self._root]
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            if node is self._root or node.children:
                continue
            if self._ref[node.block] != 1:       # a slot still reads it
                continue
            if best is None or node.last_used < best.last_used:
                best = node
        if best is None:
            raise RuntimeError(
                "KV block pool exhausted: every block is referenced by a "
                "live slot and nothing is evictable — size the engine with "
                "more num_blocks (or fewer slots / shorter max_len)")
        del best.parent.children[best.key]
        self._release_block(best.block)
        self.evictions += 1

    def evictable_blocks(self) -> int:
        """Blocks the index could surrender under pressure.

        A node is reclaimable iff it is index-only (refcount 1) and its
        whole subtree is too — an interior node above a slot-referenced
        descendant can never become a leaf, so it (and its ancestors)
        are pinned. ``free + evictable`` is therefore the true
        allocation capacity :meth:`can_allocate` checks against.
        """
        def freeable(node: _RadixNode) -> Tuple[bool, int]:
            ok, count = True, 0
            for child in node.children.values():
                c_ok, c_count = freeable(child)
                count += c_count
                ok = ok and c_ok
            if node is self._root:
                return ok, count
            if ok and self._ref[node.block] == 1:
                return True, count + 1
            return False, count

        return freeable(self._root)[1]

    def can_allocate(self, n: int) -> bool:
        """Whether ``n`` fresh blocks can be produced (free + evictable)."""
        return len(self._free) + self.evictable_blocks() >= n

    def evict_prefixes(self, n: Optional[int] = None) -> int:
        """Force-evict up to ``n`` cached prefix blocks (all when None).

        Returns the number evicted. Used by the chaos harness's
        eviction-storm fault and by operators that want to drop the
        index wholesale (for example after a model hot-swap)."""
        done = 0
        while n is None or done < n:
            if self.evictable_blocks() == 0:
                break
            self._evict_one()
            done += 1
        return done

    # -- radix prefix index --------------------------------------------------
    def _chunks(self, tokens: Sequence[int]):
        bs = self.block_size
        for i in range(len(tokens) // bs):
            yield tuple(int(t) for t in tokens[i * bs:(i + 1) * bs])

    def match(self, tokens: Sequence[int]) -> Tuple[List[int], int]:
        """Longest cached full-block prefix of ``tokens``.

        Returns ``(block_ids, hit_tokens)`` with ``hit_tokens`` a multiple
        of ``block_size`` capped at ``len(tokens) - 1`` (at least one
        token must remain for prefill to produce logits). The matched
        blocks are NOT acquired — call :meth:`acquire_blocks` when a slot
        takes them, while they are still index-pinned and unevictable.
        """
        if not self.prefix_cache:
            return [], 0
        cap_blocks = max(0, (len(tokens) - 1) // self.block_size)
        node, hit = self._root, []
        for chunk in self._chunks(tokens):
            if len(hit) >= cap_blocks:
                break
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = next(self._clock)
            hit.append(child.block)
            node = child
        return hit, len(hit) * self.block_size

    def lookup(self, tokens: Sequence[int]) -> List[int]:
        """Uncapped full-chunk walk: block ids covering every complete
        ``block_size`` chunk of ``tokens`` still present in the index.

        Unlike :meth:`match` there is no ``len - 1`` cap: this is the
        swap-in path's query (are all of a preempted request's full
        blocks still cached?), not a prefill plan. Stops at the first
        missing chunk; touches LRU clocks as a match does."""
        if not self.prefix_cache:
            return []
        node, hit = self._root, []
        for chunk in self._chunks(tokens):
            child = node.children.get(chunk)
            if child is None:
                break
            child.last_used = next(self._clock)
            hit.append(child.block)
            node = child
        return hit

    def insert(self, tokens: Sequence[int], block_ids: Sequence[int]) -> int:
        """Publish ``tokens``' full blocks (backed by ``block_ids``, one
        per block-chunk) into the prefix index. Chunks already present
        keep their existing block (the duplicate stays slot-owned and
        simply is not published); new nodes acquire one index reference.
        Returns the number of newly indexed blocks.
        """
        if not self.prefix_cache:
            return 0
        node, added = self._root, 0
        for i, chunk in enumerate(self._chunks(tokens)):
            if i >= len(block_ids):
                break
            child = node.children.get(chunk)
            if child is None:
                bid = int(block_ids[i])
                child = _RadixNode(node, chunk, bid)
                node.children[chunk] = child
                self._ref[bid] += 1            # the index's reference
                added += 1
            child.last_used = next(self._clock)
            node = child
        return added

    # -- slot lifecycle ------------------------------------------------------
    def acquire_blocks(self, slot: int, block_ids: Sequence[int]):
        """Start a slot's table with already-cached blocks (prefix hits)."""
        n = len(block_ids)
        assert self._slot_len[slot] == 0, "slot table not released"
        for j, bid in enumerate(block_ids):
            self.tables[slot, j] = bid
            self._ref[bid] += 1
        self._slot_len[slot] = n

    def append_block(self, slot: int) -> int:
        """Allocate and append a fresh (uniquely owned) block to a slot."""
        j = int(self._slot_len[slot])
        if j >= self.max_blocks:
            raise RuntimeError(f"slot {slot} exceeded max_blocks="
                               f"{self.max_blocks}")
        bid = self.alloc()
        self.tables[slot, j] = bid
        self._slot_len[slot] = j + 1
        return bid

    def admit(self, slot: int, hit_blocks: Sequence[int], n_new: int) -> bool:
        """Atomically start ``slot`` with ``hit_blocks`` + ``n_new`` fresh
        blocks — all of it or none of it.

        Returns False (with the slot table and every refcount exactly as
        before) when the pool cannot supply ``n_new`` blocks even after
        evicting cached prefixes; the engine then defers the request
        instead of crashing mid-wave. Prefix evictions performed before
        the failure are not undone — they only shrink the cache, never
        corrupt it.
        """
        if n_new > self.max_blocks - len(hit_blocks):
            return False
        self.acquire_blocks(slot, hit_blocks)
        try:
            for _ in range(n_new):
                self.append_block(slot)
        except RuntimeError:
            self.release_slot(slot)         # rolls back hits + fresh blocks
            return False
        return True

    def extend(self, slot: int, n_new: int) -> bool:
        """Atomically append ``n_new`` fresh blocks to an already-seated
        slot — all of them or none of them.

        This is chunked prefill's per-chunk allocation: a partially
        prefilled slot asks for the next chunk's blocks before any device
        work runs. Returns False (slot table and refcounts exactly as
        before) when the pool cannot supply the full plan, so the engine
        defers the chunk or preempts a victim instead of crashing with a
        half-extended table. Prefix evictions performed before a failure
        are not undone — they only shrink the cache.
        """
        if n_new <= 0:
            return True
        start = int(self._slot_len[slot])
        if start + n_new > self.max_blocks:
            return False
        taken: List[int] = []
        try:
            for _ in range(n_new):
                taken.append(self.append_block(slot))
        except RuntimeError:
            for j in range(start + len(taken) - 1, start - 1, -1):
                self._release_block(int(self.tables[slot, j]))
                self.tables[slot, j] = TRASH_BLOCK
            self._slot_len[slot] = start
            return False
        return True

    def plan_decode(self, slot: int, pos0: int, n: int) -> Tuple[int, int]:
        """Read-only twin of :meth:`prepare_decode`: how many fresh blocks
        the write window ``[pos0, pos0 + n)`` needs as ``(appends, cows)``.

        The engine sums this over all active slots and checks
        :meth:`can_allocate` BEFORE committing anything, so a decode
        chunk either has its whole block budget reserved or preempts a
        victim first — allocation can never fail halfway through a step.
        """
        appends = cows = 0
        first = pos0 // self.block_size
        last = min((pos0 + n - 1) // self.block_size, self.max_blocks - 1)
        for j in range(first, last + 1):
            if j >= self._slot_len[slot]:
                appends += 1
            elif self._ref[int(self.tables[slot, j])] > 1:
                cows += 1
        return appends, cows

    def release_slot(self, slot: int):
        """Drop a slot's references; index-published blocks stay cached."""
        for j in range(int(self._slot_len[slot])):
            self._release_block(int(self.tables[slot, j]))
        self.tables[slot, :] = TRASH_BLOCK
        self._slot_len[slot] = 0

    def slot_blocks(self, slot: int) -> List[int]:
        return [int(b) for b in self.tables[slot, : self._slot_len[slot]]]

    def prepare_decode(self, slot: int, pos0: int, n: int
                       ) -> List[Tuple[int, int]]:
        """Make positions ``[pos0, pos0 + n)`` of ``slot`` writable.

        Appends fresh blocks where the table ends and copy-on-writes any
        shared block in the window. Returns ``(src, dst)`` block-id pairs
        the engine must copy on device BEFORE the decode chunk runs.
        """
        cow: List[Tuple[int, int]] = []
        first = pos0 // self.block_size
        last = min((pos0 + n - 1) // self.block_size, self.max_blocks - 1)
        for j in range(first, last + 1):
            if j >= self._slot_len[slot]:
                # decode windows are contiguous: the first unallocated
                # index is always exactly the table's current end
                assert j == self._slot_len[slot], (slot, j)
                self.append_block(slot)
                continue
            bid = int(self.tables[slot, j])
            if self._ref[bid] > 1:              # shared: copy before write
                new = self.alloc()
                cow.append((bid, new))
                self.tables[slot, j] = new
                self._release_block(bid)
        return cow

    def truncate(self, slot: int, new_len: int) -> int:
        """Shrink ``slot``'s table to cover ``new_len`` tokens, releasing
        whole trailing blocks back to the pool. Returns the number of
        blocks released.

        The engine calls it to roll a failed chunked-prefill continuation
        back to the slot's cursor (the blocks the chunk extended by go
        back to the pool), and speculative decoding calls it to drop
        the KV of rejected draft positions. Only trailing whole blocks
        are released, and released means refcount-decremented: a block
        the radix index also holds survives with its published prefix
        intact. A boundary block's stale tail is overwritten by the next
        write and never published, since :meth:`insert` only indexes
        full chunks of the actual token sequence.
        """
        keep = -(-new_len // self.block_size)          # ceil-div
        n = int(self._slot_len[slot])
        if keep >= n:
            return 0
        for j in range(keep, n):
            self._release_block(int(self.tables[slot, j]))
            self.tables[slot, j] = TRASH_BLOCK
        self._slot_len[slot] = keep
        return n - keep

    # -- invariants (tests, chaos harness) ----------------------------------
    def check_consistency(self, external: Sequence[int] = ()) -> None:
        """Assert the allocator's books balance; raises AssertionError.

        Recomputes every block's expected refcount from the slot tables
        plus the radix index and compares against ``_ref``, checks the
        free list holds exactly the zero-ref blocks (trash excluded) with
        no duplicates, and that no freed block is referenced by a live
        slot table or index node. ``external`` names blocks alloc'd by
        an outside owner that carry one ref with no slot/index entry. Any
        leak or double-free the rollback paths miss shows up here, not as
        silent corruption later.
        """
        want = np.zeros((self.n_blocks,), np.int64)
        want[TRASH_BLOCK] = 1
        for b in external:
            want[b] += 1
        for slot in range(self.n_slots):
            for j in range(int(self._slot_len[slot])):
                want[int(self.tables[slot, j])] += 1
            # beyond the allocated prefix, tables must point at trash
            for j in range(int(self._slot_len[slot]), self.max_blocks):
                assert self.tables[slot, j] == TRASH_BLOCK, (
                    f"slot {slot} entry {j} is {self.tables[slot, j]} past "
                    f"its allocated length {int(self._slot_len[slot])}")
        stack = list(self._root.children.values())
        while stack:
            node = stack.pop()
            stack.extend(node.children.values())
            want[node.block] += 1
        mismatch = [(b, int(self._ref[b]), int(want[b]))
                    for b in range(self.n_blocks) if self._ref[b] != want[b]]
        assert not mismatch, (
            f"refcount drift (block, have, want): {mismatch[:8]}")
        free = list(self._free)
        assert len(free) == len(set(free)), "free list holds duplicates"
        assert TRASH_BLOCK not in free, "trash block leaked into free list"
        for b in free:
            assert want[b] == 0, f"free block {b} still referenced"
        n_zero = int((want[1:] == 0).sum())
        assert n_zero == len(free), (
            f"{n_zero} zero-ref blocks but {len(free)} free-listed")
