"""Continuous-batching serving engine, dense subset (PyTorch port).

``ServeEngine(cfg, params, quantize=True)`` converts the weights to AxLLM
codes once (``deploy_quantize``: int8 affine per-channel by default), so
every projection runs the fused dequant-matmul kernel on the card. The
scheduler keeps ``n_slots`` request slots full:

- **Admission (prefill waves).** Every ``step()`` first admits queued
  requests into free slots in ONE right-padded ragged batch. The wave
  width is rounded up to a power of two (at most ``n_slots``) and the
  padded length to a power of two (at least 8, at most ``max_len``).
  Causal masking keeps real tokens from the pads; logits come from each
  row's last real position; the per-row cursor is the true length. The
  wave's cache rows are then copied into the seated slots.
- **Chunked decode.** ``step()`` runs up to ``decode_chunk`` decode steps
  back to back on the device (``serve.decode.decode_steps``), clamped to
  the largest per-slot remaining budget, and reads the tokens once per
  chunk. The cache is updated in place (the JAX engine donates it).
- **Stop conditions.** EOS (``eos_id``), ``max_new`` tokens, or
  cache-full (prompt + generated reaching ``max_len``, flagged
  ``truncated``). Finished slots free at the chunk boundary.
- **Long prompts.** ``long_prompt="truncate"`` keeps the last
  ``max_len - 1`` prompt tokens; ``"reject"`` raises at ``submit()``.
- **Reuse (LUT) matmul (``impl="reuse"``).** With ``quantize=True`` every
  projection runs the reuse kernel, the paper's Result Cache on device:
  a product table per activation, then gathers in place of multiplies.
- **Paged KV + prefix reuse (``paged=True``).** The dense per-slot cache
  becomes a block pool ``[L, num_blocks, kv_block_size]`` with per-slot
  block tables (``serve.paged_cache.PagedKVCache`` owns the free list,
  refcounts and radix prefix index). At admission each prompt's longest
  cached full-block prefix is taken by reference and prefill runs only
  on the uncached suffix, against the prefix gathered out of the pool
  (``ops.prefix_attention``); a wave with no hit takes the plain ragged
  prefill. A request the pool cannot hold is deferred, holding no blocks.
  Before each decode chunk the engine plans every slot's write window,
  then commits it (fresh blocks, one batched copy-on-write copy) and
  hands the device the cursors and block tables; decode reads KV through
  the tables in the paged kernel. Finished requests publish their full
  blocks (keyed by ``prompt ++ tokens[:-1]``, the sequence fed) and
  release their slot; LRU index-only blocks are evicted when the pool
  runs dry.

Multi-LoRA, fused projections, tensor parallelism, speculation, chunked
prefill, streaming, deadlines and preemption are not ported yet: asking
for them raises ``NotImplementedError`` naming the ROADMAP item. Where
the JAX engine would preempt a slot because the pool cannot cover a
decode window, the port raises the same way; the default pool never gets
there.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.axllm_linear import deploy_quantize
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models.model import ModelAPI, get_model
from repro_torch.serve.decode import decode_steps, sample_tokens
from repro_torch.serve.paged_cache import PagedKVCache
from repro_torch.serve.scheduler import WaitQueue


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


@dataclasses.dataclass
class Request:
    """One serving request: prompt in, generated ``tokens`` out."""
    rid: int
    prompt: np.ndarray            # [S] int32 (after the long-prompt policy)
    max_new: int = 32
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False           # generation cut short (cache/steps)
    prompt_truncated: bool = False    # prompt clipped by long_prompt policy
    priority: int = 0                 # queue order only (no preemption yet)
    deadline_s: Optional[float] = None
    finish_reason: Optional[str] = None   # eos / max_new / cache_full /
                                          # cancelled
    t_submit: float = 0.0


@dataclasses.dataclass
class EngineStats:
    admitted: int = 0
    finished: int = 0
    truncated: int = 0
    steps: int = 0                    # device decode steps executed
    decode_tokens: int = 0            # valid tokens harvested
    decode_chunks: int = 0            # host round trips
    prefill_waves: int = 0
    prefill_tokens: int = 0
    prefill_wall_s: float = 0.0       # host wall time inside prefill waves
    occupancy_sum: float = 0.0        # sum over steps of active / n_slots
    # paged mode: prompt tokens whose KV came from the prefix index, live
    # pool blocks, and copy-on-write block copies before decode chunks
    prefix_hit_tokens: int = 0
    blocks_in_use: int = 0
    cow_copies: int = 0

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.decode_tokens / self.steps if self.steps else 0.0

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_occupancy"] = self.mean_occupancy
        d["tokens_per_step"] = self.tokens_per_step
        return d


def _pow2_bucket(n: int, lo: int, hi: int) -> int:
    """Smallest power of two >= n, floored at lo, capped at hi.

    >>> _pow2_bucket(5, 1, 16)
    8
    >>> _pow2_bucket(3, 8, 64)
    8
    >>> _pow2_bucket(100, 8, 64)
    64
    """
    b = lo
    while b < n:
        b *= 2
    return min(b, hi)


def _params_to(tree, device):
    if isinstance(tree, dict):
        return {k: _params_to(v, device) for k, v in tree.items()}
    return tree.to(device)


class ServeEngine:
    """Continuous-batching scheduler over ``n_slots`` request slots on
    ``device`` (the card unless the caller passes ``device="cpu"``).

    ``quantize=True`` converts weight matrices to ``quant_bits`` AxLLM
    codes (``None`` takes ``cfg.quant_bits``; ``quant_mode`` picks affine
    or codebook levels); ``impl="reuse"`` multiplies them through the
    reuse (LUT) kernel. ``decode_chunk`` sets the decode steps per
    dispatch; ``eos_id`` / ``long_prompt`` / ``max_len`` define the stop
    conditions (see the module docstring).

    ``paged=True`` serves from the block-paged pool with prefix reuse:
    ``kv_block_size`` tokens per block (a power of two), ``num_blocks``
    pool blocks (default ``2 * n_slots * ceil(max_len / kv_block_size) +
    2``: a full dense equivalent per slot, the trash block, a
    copy-on-write spare, and as much again for retained prefixes);
    ``prefix_cache=False`` keeps the paging but disables the radix index.

    Serve with ``submit`` + ``step()`` / ``run()``, or the one-shot
    ``generate(prompts)``.
    """

    def __init__(self, cfg, params, *, n_slots: int = 4, max_len: int = 512,
                 quantize: bool = False, quant_bits: Optional[int] = None,
                 quant_mode: str = "affine", impl: str = "auto",
                 greedy: bool = True, seed: int = 0,
                 eos_id: Optional[int] = None, long_prompt: str = "truncate",
                 decode_chunk: Optional[int] = None,
                 fuse_qkv: Optional[bool] = None, adapters=None,
                 paged: bool = False, kv_block_size: int = 16,
                 num_blocks: Optional[int] = None,
                 prefix_cache: bool = True, mesh=None,
                 max_queue: Optional[int] = None,
                 speculate: bool = False,
                 prefill_budget: Optional[int] = None, device="cuda"):
        for on, what, item in (
                (adapters is not None, "multi-LoRA serving",
                 "ROADMAP queue 1 item 5"),
                (fuse_qkv if fuse_qkv is not None else cfg.fuse_qkv,
                 "fused projections", "ROADMAP queue 1 item 5"),
                (mesh is not None, "tensor-parallel serving",
                 "ROADMAP queue 1 item 12"),
                (speculate, "speculative decoding", "ROADMAP queue 1 item 9"),
                (prefill_budget is not None, "chunked prefill",
                 "ROADMAP queue 1 item 8"),
                (max_queue is not None, "a bounded wait queue",
                 "ROADMAP queue 1 item 8")):
            if on:
                raise _not_ported(what, item)
        if long_prompt not in ("truncate", "reject"):
            raise ValueError(f"long_prompt must be 'truncate' or 'reject', "
                             f"got {long_prompt!r}")
        if max_len < 2:
            raise ValueError("max_len must be >= 2 (prompt + 1 decode step)")
        if impl not in ops.IMPLS:
            raise ValueError(f"impl must be one of {ops.IMPLS}, got "
                             f"{impl!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        self.api: ModelAPI = get_model(cfg, impl=impl)
        params = _params_to(params, self.device)
        if quantize:
            bits = cfg.quant_bits if quant_bits is None else quant_bits
            params = deploy_quantize(
                params, QuantConfig(bits=bits, mode=quant_mode,
                                    granularity="per_channel"))
        self.params = params
        self.n_slots = n_slots
        self.max_len = max_len
        self.greedy = greedy
        self.eos_id = eos_id if eos_id is not None else cfg.eos_id
        self.long_prompt = long_prompt
        dc = cfg.decode_chunk if decode_chunk is None else decode_chunk
        if dc < 1:
            raise ValueError(f"decode_chunk must be >= 1, got {dc}")
        self.decode_chunk = dc
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.paged = paged
        self.kv_block_size = kv_block_size
        self.prefix_cache = prefix_cache
        if paged:
            self.max_blocks = math.ceil(max_len / kv_block_size)
            self.num_blocks = num_blocks if num_blocks is not None \
                else 2 * n_slots * self.max_blocks + 2
            self.pager = PagedKVCache(
                n_slots=n_slots, n_blocks=self.num_blocks,
                block_size=kv_block_size,
                max_blocks_per_slot=self.max_blocks,
                prefix_cache=prefix_cache)
            self.cache = self.api.init_paged_cache(
                n_slots, self.num_blocks, kv_block_size, self.max_blocks,
                self.device)
            self._pool_leaves = [k for k, ax in
                                 self.api.paged_cache_spec.items() if ax == 1]
        else:
            self.pager = None
            self.cache = self.api.init_cache(n_slots, max_len, self.device)
        self.slots: List[Optional[Request]] = [None] * n_slots
        self.queue = WaitQueue()
        self.finished: List[Request] = []
        self._rid = 0
        self.stats = EngineStats()

    # -- request management ---------------------------------------------------
    def submit(self, prompt, max_new: int = 32, adapter=None,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_token=None, ttft_deadline_s: Optional[float] = None,
               itl_deadline_s: Optional[float] = None) -> int:
        """Queue a prompt ([S] ints) for generation; returns a request id."""
        for on, what, item in (
                (adapter is not None, "submit(adapter=)",
                 "ROADMAP queue 1 item 5"),
                (priority != 0, "priority scheduling and preemption",
                 "ROADMAP queue 1 item 8"),
                (on_token is not None, "streaming (on_token=)",
                 "ROADMAP queue 1 item 8"),
                (deadline_s is not None or ttft_deadline_s is not None
                 or itl_deadline_s is not None, "request deadlines",
                 "ROADMAP queue 1 item 8")):
            if on:
                raise _not_ported(what, item)
        prompt = np.asarray(prompt, np.int32).reshape(-1)
        if prompt.size == 0:
            raise ValueError("empty prompt")
        cap = self.max_len - 1            # leave >= 1 decode position
        prompt_truncated = False
        if prompt.size > cap:
            if self.long_prompt == "reject":
                raise ValueError(
                    f"prompt length {prompt.size} exceeds max_len-1={cap}; "
                    f"resubmit shorter or use long_prompt='truncate'")
            prompt = prompt[-cap:]        # keep the most recent context
            prompt_truncated = True
        req = Request(self._rid, prompt, max_new,
                      prompt_truncated=prompt_truncated,
                      t_submit=time.monotonic())
        self._rid += 1
        self.queue.offer(req)             # unbounded: always admitted
        return req.rid

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    # -- KV sequences -----------------------------------------------------------
    def _kv_seq(self, r: Request) -> np.ndarray:
        """Tokens whose KV a running slot holds: prompt ++ tokens[:-1] (the
        last sampled token's KV is written by the next decode step). Keys
        the prefix-index publish at finish."""
        return np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                    np.int32)])

    # -- prefill waves ---------------------------------------------------------
    def _admit(self):
        free = self._free_slots()
        if not free or not self.queue:
            return
        group = self.queue.take(len(free))
        t0 = time.perf_counter()
        try:
            if self.paged:
                self._prefill_group_paged(group, free)
            else:
                self._prefill_group(group, free)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.stats.prefill_wall_s += time.perf_counter() - t0

    def _prefill_group(self, group: List[Request], free: List[int]):
        w = len(group)
        wb = _pow2_bucket(w, 1, self.n_slots)
        lens = [len(r.prompt) for r in group]
        pl = _pow2_bucket(max(lens), min(8, self.max_len), self.max_len)
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        for i, r in enumerate(group):
            toks[i, :lens[i]] = r.prompt
            lengths[i] = lens[i]
        wave_cache = self.api.init_cache(wb, pl, self.device)
        logits, wave_cache = self.api.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(self.device)},
            wave_cache, lengths=torch.from_numpy(lengths).to(self.device))
        first = self._sample(logits)
        src, dst = [], []
        for i, r in enumerate(group):
            r.tokens.append(int(first[i]))
            self.stats.admitted += 1
            self.stats.prefill_tokens += int(lengths[i])
            reason = self._stop_reason(r)
            if reason is not None:
                self._finish(r, reason)   # EOS/max_new on the first token
                continue
            slot = free.pop(0)
            self.slots[slot] = r
            src.append(i)
            dst.append(slot)
        if src:
            self._write_wave(wave_cache, src, dst)
        self.stats.prefill_waves += 1

    def _prefill_group_paged(self, group: List[Request], free: List[int]):
        """Admit one wave through the paged pool: match each sequence's
        longest cached full-block prefix, allocate blocks for the uncached
        suffix, prefill only the suffix (rows position-offset by their
        hit), and publish the sequence's full blocks so later requests
        reuse them.

        Admission is atomic per request (``pager.admit``): a request the
        pool cannot hold, even after LRU eviction, goes back to the queue
        holding zero blocks. A failure in the prefill dispatch releases
        every admitted request's blocks and requeues the wave."""
        pgr, bs = self.pager, self.kv_block_size
        admitted, slots_for, seqs, hits, hit_toks = [], [], [], [], []
        for r in group:
            seq = r.prompt
            hit, ht = pgr.match(seq)
            slot = free[0]
            if not pgr.admit(slot, hit, math.ceil((len(seq) - ht) / bs)):
                self.queue.push_front(r)     # defer: the pool is dry now
                continue
            free.pop(0)
            admitted.append(r)
            slots_for.append(slot)
            seqs.append(seq)
            hits.append(hit)
            hit_toks.append(ht)
        if not admitted:
            return
        takes = [len(seq) - ht for seq, ht in zip(seqs, hit_toks)]
        wb = _pow2_bucket(len(admitted), 1, self.n_slots)
        pl = _pow2_bucket(max(takes), bs, self.max_blocks * bs)
        npb_max = max(len(h) for h in hits)
        npb = _pow2_bucket(npb_max, 1, self.max_blocks) if npb_max else 0
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        prefix_len = np.zeros((wb,), np.int32)
        pbt = np.zeros((wb, max(npb, 1)), np.int32)
        sbt = np.zeros((wb, pl // bs), np.int32)
        for i, slot in enumerate(slots_for):
            chunk = seqs[i][hit_toks[i]:]
            toks[i, :len(chunk)] = chunk
            lengths[i] = len(chunk)
            prefix_len[i] = hit_toks[i]
            nh = len(hits[i])
            pbt[i, :nh] = hits[i]
            nsb = math.ceil(len(chunk) / bs)
            sbt[i, :nsb] = pgr.tables[slot, nh:nh + nsb]
        try:
            logits = self._paged_prefill(toks, lengths, prefix_len,
                                         pbt if npb else None, sbt)
        except Exception:
            for r, slot in zip(admitted, slots_for):
                pgr.release_slot(slot)
                self.queue.push_front(r)
            self.stats.blocks_in_use = pgr.blocks_in_use
            raise
        first = self._sample(logits)
        for i, (r, slot) in enumerate(zip(admitted, slots_for)):
            r.tokens.append(int(first[i]))
            self.stats.admitted += 1
            self.stats.prefill_tokens += int(lengths[i])
            self.stats.prefix_hit_tokens += hit_toks[i]
            # publish now: later waves reuse this prefill while the slot
            # is still decoding
            pgr.insert(seqs[i], pgr.slot_blocks(slot))
            reason = self._stop_reason(r)
            if reason is not None:
                pgr.release_slot(slot)
                self._finish(r, reason)   # EOS/max_new on the first token
                free.append(slot)
                continue
            self.slots[slot] = r
        self.stats.prefill_waves += 1
        self.stats.blocks_in_use = pgr.blocks_in_use

    def _paged_prefill(self, toks, lengths, prefix_len, pbt, sbt):
        """One paged prefill dispatch: gather the rows' cached prefix KV out
        of the pool through ``pbt`` (None: no row has a hit, plain ragged
        prefill), run the suffix-only prefill, and scatter the suffix KV
        into the rows' fresh blocks ``sbt``. Padded rows and entries point
        at trash block 0, so the scatter sees repeated indices; nobody
        reads the trash block, so any winner is fine."""
        dev, bs = self.device, self.kv_block_size
        wb, pl = toks.shape
        wave = self.api.init_cache(wb, pl, dev)
        kw = {"lengths": torch.from_numpy(lengths).to(dev)}
        if pbt is not None:
            idx = torch.from_numpy(pbt).to(dev).long()
            prefix = {"len": torch.from_numpy(prefix_len).to(dev)}
            for name in self._pool_leaves:
                g = self.cache[name][:, idx]      # [L, wb, npb, bs, Hk, x]
                prefix[name] = g.reshape(g.shape[0], wb, -1, *g.shape[4:])
            kw["prefix"] = prefix
        logits, wave = self.api.prefill(
            self.params, {"tokens": torch.from_numpy(toks).to(dev)}, wave,
            **kw)
        sidx = torch.from_numpy(sbt).to(dev).long()
        for name in self._pool_leaves:
            pool, w = self.cache[name], wave[name]  # w: [L, wb, pl, Hk, x]
            pool[:, sidx] = w.reshape(w.shape[0], wb, pl // bs, bs,
                                      *w.shape[3:]).to(pool.dtype)
        return logits

    def _copy_blocks(self, pairs):
        """Copy pool blocks ``src`` onto ``dst`` on every pool leaf: the
        device half of copy-on-write, one batched copy per chunk."""
        src = torch.tensor([p[0] for p in pairs], device=self.device)
        dst = torch.tensor([p[1] for p in pairs], device=self.device)
        for name in self._pool_leaves:
            self.cache[name][:, dst] = self.cache[name][:, src]

    def _write_wave(self, wave_cache, src, dst):
        """Copy wave rows ``src`` into engine slots ``dst`` on each leaf's
        batch axis (``api.cache_spec``). The wave cache covers the padded
        length only; slot entries past it are never read before decode
        overwrites them."""
        s = torch.tensor(src, device=self.device)
        d = torch.tensor(dst, device=self.device)
        for name, ax in self.api.cache_spec.items():
            full, one = self.cache[name], wave_cache[name]
            if ax == 0:
                full[d] = one[s].to(full.dtype)
            else:
                full[:, d, :one.shape[2]] = one[:, s].to(full.dtype)

    # -- sampling and stopping -------------------------------------------------
    def _sample(self, logits) -> np.ndarray:
        toks = sample_tokens(logits, self.rng, greedy=self.greedy,
                             vocab_size=self.cfg.vocab_size)
        return toks.cpu().numpy()

    def _stop_reason(self, r: Request) -> Optional[str]:
        if self.eos_id is not None and r.tokens[-1] == self.eos_id:
            return "eos"
        if len(r.tokens) >= r.max_new:
            return "max_new"
        # next decode would write at pos = prompt + generated - 1
        if len(r.prompt) + len(r.tokens) - 1 >= self.max_len:
            r.truncated = True
            return "cache_full"
        return None

    def _finish(self, r: Request, reason: str):
        r.done = True
        r.finish_reason = reason
        self.finished.append(r)
        self.stats.finished += 1
        if r.truncated:
            self.stats.truncated += 1

    # -- decode ----------------------------------------------------------------
    def _chunk_len(self, active, max_n: Optional[int]) -> int:
        """Largest per-slot remaining budget, clamped to decode_chunk and
        the caller's step budget."""
        remaining = 1
        for i in active:
            r = self.slots[i]
            rem = min(r.max_new - len(r.tokens),
                      self.max_len - (len(r.prompt) + len(r.tokens) - 1))
            remaining = max(remaining, rem)
        return max(1, min(self.decode_chunk, remaining,
                          max_n if max_n is not None else remaining))

    def step(self, max_n: Optional[int] = None) -> bool:
        """Admit a prefill wave, then run ONE chunked decode dispatch of up
        to min(decode_chunk, max_n, largest remaining budget) steps.
        Returns False when no work is left."""
        with torch.inference_mode():
            return self._step(max_n)

    def _step(self, max_n: Optional[int]) -> bool:
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        while not active and self.queue:
            # a whole wave can finish at prefill (EOS/max_new on the first
            # token); keep admitting so queued work is never stranded
            before = (len(self.queue), len(self.finished))
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active and before == (len(self.queue),
                                         len(self.finished)):
                # every slot is free yet nothing admits or finishes: the
                # pool can never hold the queued requests (a sizing bug)
                raise RuntimeError(
                    f"admission stalled: {len(self.queue)} queued "
                    f"request(s) cannot fit an empty engine "
                    f"(num_blocks={getattr(self, 'num_blocks', None)})")
        if not active:
            return False
        n = self._chunk_len(active, max_n)
        windows = {}
        if self.paged:
            # plan: the block budget of every slot's write window
            need = 0
            for i in active:
                r = self.slots[i]
                pos0 = len(r.prompt) + len(r.tokens) - 1
                rem = min(r.max_new - len(r.tokens), self.max_len - pos0)
                windows[i] = (pos0, max(1, min(n, rem)))
                a, c = self.pager.plan_decode(i, *windows[i])
                need += a + c
            if not self.pager.can_allocate(need) and len(active) > 1:
                raise NotImplementedError(
                    "the KV pool cannot cover this decode chunk: the JAX "
                    "engine would preempt a slot here, and preemption is "
                    "not ported yet (ROADMAP queue 1 item 8)")
        last = np.zeros((self.n_slots,), np.int32)
        gen = np.zeros((self.n_slots,), np.int32)
        budget = np.zeros((self.n_slots,), np.int32)
        stop = np.ones((self.n_slots,), bool)
        for i in active:
            r = self.slots[i]
            last[i] = r.tokens[-1]
            gen[i] = len(r.tokens)
            budget[i] = r.max_new
            stop[i] = False
        dev = self.device
        if self.paged:
            # commit: fresh blocks past each table's end and one batched
            # copy-on-write copy, then the cursors and tables from the host
            cow = []
            pos_host = np.zeros((self.n_slots,), np.int32)
            for i, (pos0, span) in windows.items():
                pos_host[i] = pos0
                cow += self.pager.prepare_decode(i, pos0, span)
            if cow:
                self._copy_blocks(cow)
                self.stats.cow_copies += len(cow)
            self.cache["pos"] = torch.from_numpy(pos_host).to(dev)
            self.cache["block_tables"] = torch.from_numpy(
                self.pager.tables.copy()).to(dev)
            self.stats.blocks_in_use = self.pager.blocks_in_use
        out = decode_steps(
            self.api.decode, self.params, torch.from_numpy(last).to(dev),
            self.cache, self.rng, torch.from_numpy(stop).to(dev),
            torch.from_numpy(gen).to(dev), torch.from_numpy(budget).to(dev),
            n=n, vocab_size=self.cfg.vocab_size, max_len=self.max_len,
            eos_id=self.eos_id, greedy=self.greedy)
        self.cache = out.cache
        toks = out.tokens.cpu().numpy()
        valid = out.valid.cpu().numpy()
        self.stats.steps += n
        self.stats.decode_chunks += 1
        self.stats.decode_tokens += int(valid.sum())
        self.stats.occupancy_sum += float(valid.sum()) / self.n_slots
        for i in active:
            r = self.slots[i]
            for t in range(n):
                if not valid[t, i]:
                    break
                r.tokens.append(int(toks[t, i]))
            reason = self._stop_reason(r)
            if reason is not None:
                if self.paged:
                    # publish the generated tokens' full blocks too, keyed
                    # by the sequence fed, then drop the slot's references
                    self.pager.insert(self._kv_seq(r),
                                      self.pager.slot_blocks(i))
                    self.pager.release_slot(i)
                self._finish(r, reason)
                self.slots[i] = None
        if self.paged:
            self.stats.blocks_in_use = self.pager.blocks_in_use
        return True

    def run(self, max_steps: int = 10000):
        """Serve until drained or ``max_steps`` device decode steps ran."""
        while (self.queue or any(s is not None for s in self.slots)) \
                and max_steps > 0:
            before = self.stats.steps
            if not self.step(max_n=max_steps):
                break
            max_steps -= self.stats.steps - before
        return self.finished

    def generate(self, prompts, max_new: int = 32, max_steps: int = 10000,
                 return_requests: bool = False):
        """Serve ``prompts``; returns one token list per prompt (in order).

        Requests still in flight after ``max_steps`` are cancelled: they
        come back with their partial tokens and ``truncated=True``."""
        start = len(self.finished)
        ids = [self.submit(p, max_new) for p in prompts]
        self.run(max_steps)
        want = set(ids)
        new = self.finished[start:]
        by_id = {r.rid: r for r in new}
        out = [by_id[rid] if rid in by_id else self._cancel(rid)
               for rid in ids]
        # results are handed to the caller: drop them from the engine log
        del self.finished[start:]
        self.finished.extend(r for r in new if r.rid not in want)
        return out if return_requests else [r.tokens for r in out]

    def _cancel(self, rid: int) -> Request:
        """Evict an in-flight or queued request, flagged truncated."""
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self.slots[i] = None
                if self.paged:
                    self.pager.release_slot(i)
                r = s
                break
        else:
            r = next(q for q in self.queue if q.rid == rid)
            self.queue.remove(r)
        r.truncated = True
        r.finish_reason = "cancelled"
        self.stats.truncated += 1
        return r
