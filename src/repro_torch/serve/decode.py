"""Multi-token decode without a host round trip per token.

:func:`decode_steps` runs ``n`` decode steps back to back on the device:
sampling and the per-slot stop mask stay on the device, and the KV cache
is updated in place. The host reads the ``[n, B]`` token block and its
validity mask once per chunk.

Stop-mask rules (the same as ``ServeEngine._stop_reason``):
  - ``next == eos_id``           (EOS, when an eos id is configured)
  - ``gen >= max_new``           (per-slot generation budget)
  - ``cache["pos"] >= max_len``  (cache full: the next decode would write
                                  past the cache; flagged truncated by the
                                  engine at harvest)
A stopped slot keeps riding through the loop: its row computes values
that are masked out, and its cursor keeps advancing (a write past the
cache end is dropped). ``valid`` is a per-slot prefix, so harvesting is
"append tokens until the first False".

:func:`verify_steps` is the speculative engine's target half: the same
step body fed the draft's proposals instead of its own samples.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch


class DecodeChunk(NamedTuple):
    """Result of a chunked decode dispatch (tensors on the device)."""
    tokens: torch.Tensor     # [n, B] int32 sampled tokens (garbage if ~valid)
    valid: torch.Tensor      # [n, B] bool: slot was active when step ran
    last: torch.Tensor       # [B] int32 last valid token per slot
    cache: dict              # the cache, advanced in place
    stop_mask: torch.Tensor  # [B] bool: slot is finished
    gen: torch.Tensor        # [B] int32 tokens generated so far


def sample_tokens(logits, gen: Optional[torch.Generator], *, greedy: bool,
                  vocab_size: int, rows=None) -> torch.Tensor:
    """[B, V_padded] logits -> [B] int32 tokens over the real vocab.
    Greedy takes the first maximum (as ``jnp.argmax`` does). Sampled
    decoding draws one uniform number a row of the whole batch from
    ``gen`` and inverts each row's CDF with it; ``rows`` = (the batch's
    rows, the index of these B among them) when ``logits`` are a block of
    a batch cut over ranks, so that a row's token does not depend on the
    cut. Its numbers differ from JAX's."""
    logits = logits[..., :vocab_size]
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    total, index = rows if rows is not None else (logits.shape[0], slice(None))
    u = torch.rand(total, generator=gen, device=logits.device)[index]
    cdf = torch.cumsum(torch.softmax(logits.to(torch.float32), dim=-1), -1)
    tok = torch.searchsorted(cdf, (u * cdf[:, -1])[:, None], right=True)
    return tok[:, 0].clamp_max(vocab_size - 1).to(torch.int32)


def verify_steps(decode_fn, params, last, drafts, cache, *,
                 vocab_size: int):
    """Teacher-forced steps for speculative verification: feed ``[last,
    d_1, ..., d_k]`` through the target model and return its greedy token
    after each input.

    Where :func:`decode_steps` feeds each step the token it sampled, this
    feeds the draft's proposals. ``targets[i]`` is the target's greedy
    choice after consuming input ``i``, so the host's accept-longest-prefix
    rule (``serve.speculative``) compares ``targets[:k]`` with the drafts
    and always has ``targets[m]`` as the correction (or bonus) token.

    No stop machinery: EOS, budget and cache-full are re-derived on the
    host while the accepted tokens are appended (a stop may land inside an
    acceptance), and KV written for rejected positions is rolled back by
    the engine (cursor reset or ``PagedKVCache.truncate``), never read.

    decode_fn: ``(params, token [B], cache) -> (logits [B, V], cache)``.
    last: [B] int32 last accepted token per slot. drafts: [k, B] int32
    proposals (k == 0 is one plain greedy decode step).
    Returns ``(targets [k+1, B] int32, cache)``, the cache advanced by
    k+1 positions in place.
    """
    inputs = torch.cat([last.to(torch.int32)[None, :],
                        drafts.to(torch.int32)], dim=0)
    targets = []
    for tok in inputs:
        logits, cache = decode_fn(params, tok, cache)
        targets.append(sample_tokens(logits, None, greedy=True,
                                     vocab_size=vocab_size))
    return torch.stack(targets), cache


def decode_steps(decode_fn, params, last, cache, gen_rng, stop_mask, gen,
                 max_new, *, n: int, vocab_size: int, max_len: int,
                 eos_id: Optional[int] = None,
                 greedy: bool = True, rows=None) -> DecodeChunk:
    """Run ``n`` decode steps of ``decode_fn`` on the device.

    decode_fn: ``(params, token [B], cache) -> (logits [B, V], cache)``.
    last: [B] int32 last sampled token; stop_mask: [B] bool (True = dead
    slot); gen: [B] int32 tokens generated so far; max_new: [B] int32
    per-slot budget; gen_rng: the sampling generator (unused if greedy);
    rows: ``sample_tokens``' rows, for a block of the slots.
    """
    toks, valid = [], []
    for _ in range(n):
        logits, cache = decode_fn(params, last, cache)
        nxt = sample_tokens(logits, gen_rng, greedy=greedy,
                            vocab_size=vocab_size, rows=rows)
        active = ~stop_mask
        nxt = torch.where(active, nxt, last)
        gen = gen + active.to(torch.int32)
        hit = (gen >= max_new) | (cache["pos"] >= max_len)
        if eos_id is not None:
            hit = hit | (nxt == eos_id)
        stop_mask = stop_mask | (active & hit)
        last = nxt
        toks.append(nxt)
        valid.append(active)
    return DecodeChunk(torch.stack(toks), torch.stack(valid), last, cache,
                       stop_mask, gen)
