"""Self-speculative decoding on the quantization ladder: the host-side
rules (PyTorch port of the JAX package's ``serve/speculative.py``).

The repo holds one model at several precisions sharing a tokenizer and
cache layout (bf16 / axllm-int8 / int4 / shiftadd), which is a natural
self-speculation stack: a cheap low-precision *draft* proposes ``k``
tokens per round, the serving-precision *target* checks all of them in
one teacher-forced scan (``repro_torch.serve.decode.verify_steps``), and
the engine keeps the longest agreeing prefix plus the target's own next
token. Greedy output equals target-only decode token for token by
construction: the draft only changes *how fast* tokens appear, never
*which* tokens.

One speculative round, per slot (``pos`` = KV positions held, i.e.
``len(prompt) + len(tokens) - 1``)::

      draft scan (k+1 steps)          verify scan (k+1 steps)
      last -> d1 -> d2 -> ... d_{k+1}   [last, d1, .., dk] -> t1 .. t_{k+1}
        writes draft KV @ pos..pos+k      writes target KV @ pos..pos+k
                                  |
                                  v
      accept m = longest agreeing prefix (d_i == t_i for i < m)
      emit  t1..t_{m+1}  (= d1..dm  ++  the target's correction token)
                                  |
                                  v
      rollback: new KV length = pos + m + 1  <= pos + k + 1
        dense: reset the per-row cursor (stale tail is overwritten)
        paged: ``PagedKVCache.truncate(slot, new_len)`` frees whole
               now-unused tail blocks back to the pool

    The draft runs k+1 steps (not k) and its last proposal is discarded:
    this leaves draft KV covering exactly the target's written range, so
    an all-accept round starts the next draft from fully valid KV.

This module owns the *pure host-side rules* of that loop, acceptance and
round sizing, so they are property-testable without an engine. The
device half is ``repro_torch.serve.decode.verify_steps`` and the engine
integration (draft and verify per round, draft prefill riding admission
waves, preemption) ``repro_torch.serve.engine``.
"""

from __future__ import annotations

from typing import Sequence

__all__ = ["accept_length", "emitted_tokens", "round_k"]


def accept_length(draft: Sequence[int], target: Sequence[int]) -> int:
    """Longest-agreeing-prefix rule: how many draft tokens the target
    confirms.

    ``draft`` holds the k proposals, ``target`` the k+1 greedy choices of
    the verify scan (``target[i]`` is the target's token after consuming
    ``draft[:i]``). The accept length is the index of the first
    disagreement — every draft token before it IS what target-only
    greedy decode would have produced, and ``target[m]`` is the
    correction (or bonus, when everything agreed) token.

    >>> accept_length([5, 7, 9], [5, 7, 2, 4])     # first mismatch at 2
    2
    >>> accept_length([5, 7, 9], [5, 7, 9, 4])     # all accepted
    3
    >>> accept_length([3], [8, 1])                 # immediate mismatch
    0
    >>> accept_length([], [6])                     # k == 0: plain decode
    0
    """
    if len(target) != len(draft) + 1:
        raise ValueError(
            f"verify scan must produce len(draft)+1 = {len(draft) + 1} "
            f"target tokens, got {len(target)}")
    m = 0
    while m < len(draft) and int(draft[m]) == int(target[m]):
        m += 1
    return m


def emitted_tokens(draft: Sequence[int], target: Sequence[int]) -> list:
    """Tokens one speculative round emits: the accepted draft prefix plus
    the target's correction token — always at least one token, so every
    round makes progress even at zero acceptance.

    The emitted block equals ``target[:m+1]`` (the target's own greedy
    tokens), which is WHY speculative greedy output is bit-identical to
    target-only decode: nothing the draft proposed survives unverified.

    >>> emitted_tokens([5, 7, 9], [5, 7, 2, 4])
    [5, 7, 2]
    >>> emitted_tokens([5, 7, 9], [5, 7, 9, 4])    # all-accept + bonus
    [5, 7, 9, 4]
    >>> emitted_tokens([], [6])                    # k == 0
    [6]
    """
    m = accept_length(draft, target)
    return [int(t) for t in target[: m + 1]]


def round_k(spec_k: int, *, max_len: int, positions: Sequence[int],
            budgets: Sequence[int], max_n: int | None = None) -> int:
    """Draft length for one speculative round over the active slots.

    Clamps ``spec_k`` so the round stays correct and useful for every
    slot, then buckets DOWN to ``{0} | {powers of two} | {spec_k}`` (a
    handful of round shapes instead of one per distinct clamp; the JAX
    engine compiles one scan per length, and the port keeps its rounds):

    - ``max_len``: the verify scan writes KV at ``pos .. pos+k`` for
      every slot, so ``k <= max_len - 1 - max(positions)`` keeps every
      write in bounds (no clamped/garbage writes to reason about).
    - ``budgets``: per-slot ``max_new - len(tokens)`` remainders; a
      round emits at most k+1 tokens per slot, so drafting past the
      largest remainder is pure waste.
    - ``max_n``: the caller's device-step budget (a round costs k+1
      target steps).

    ``k == 0`` degenerates to a plain (teacher-forced) decode step —
    the round still emits the target's token, so progress is guaranteed.

    >>> round_k(8, max_len=64, positions=[10, 20], budgets=[30, 30])
    8
    >>> round_k(8, max_len=64, positions=[60], budgets=[30])   # pos bound
    2
    >>> round_k(8, max_len=64, positions=[63], budgets=[30])   # no room
    0
    >>> round_k(8, max_len=64, positions=[10], budgets=[4])    # budget
    2
    >>> round_k(6, max_len=64, positions=[10], budgets=[30])   # own size
    6
    >>> round_k(6, max_len=64, positions=[59], budgets=[30])   # pow2 down
    4
    """
    if spec_k < 1:
        raise ValueError(f"spec_k must be >= 1, got {spec_k}")
    k = min(spec_k,
            min(max_len - 1 - int(p) for p in positions),
            max(int(b) for b in budgets) - 1)
    if max_n is not None:
        k = min(k, max_n - 1)
    if k <= 0:
        return 0
    if k >= spec_k:
        return spec_k
    return 1 << (k.bit_length() - 1)        # largest power of two <= k
