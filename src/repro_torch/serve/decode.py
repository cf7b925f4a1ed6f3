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
                  vocab_size: int) -> torch.Tensor:
    """[B, V_padded] logits -> [B] int32 tokens over the real vocab.
    Greedy takes the first maximum (as ``jnp.argmax`` does); sampled
    decoding draws from ``gen``, so its numbers differ from JAX's."""
    logits = logits[..., :vocab_size]
    if greedy:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32), dim=-1)
    return torch.multinomial(probs, 1, generator=gen)[:, 0].to(torch.int32)


def decode_steps(decode_fn, params, last, cache, gen_rng, stop_mask, gen,
                 max_new, *, n: int, vocab_size: int, max_len: int,
                 eos_id: Optional[int] = None,
                 greedy: bool = True) -> DecodeChunk:
    """Run ``n`` decode steps of ``decode_fn`` on the device.

    decode_fn: ``(params, token [B], cache) -> (logits [B, V], cache)``.
    last: [B] int32 last sampled token; stop_mask: [B] bool (True = dead
    slot); gen: [B] int32 tokens generated so far; max_new: [B] int32
    per-slot budget; gen_rng: the sampling generator (unused if greedy).
    """
    toks, valid = [], []
    for _ in range(n):
        logits, cache = decode_fn(params, last, cache)
        nxt = sample_tokens(logits, gen_rng, greedy=greedy,
                            vocab_size=vocab_size)
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
