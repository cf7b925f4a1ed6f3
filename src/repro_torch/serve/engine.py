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
- **Fused projections (``fuse_qkv=True`` or ``cfg.fuse_qkv``).** After
  quantization ``api.fuse_params`` rewrites wq/wk/wv into one wqkv and
  gate/up into one gate_up, so a decode step runs 4 quantized matmuls a
  layer instead of 7.
- **Multi-LoRA (``adapters=AdapterRegistry``).** Mixed batches of the
  frozen base model and up to ``max_loras`` registered LoRA fine-tunes
  run in the same waves and decode chunks: ``submit(..., adapter=name)``
  pins a registered adapter until the request finishes, and a per-slot
  adapter-row array (-1 = base) rides with every prefill wave and decode
  chunk, so each attention projection adds its rows' gathered low-rank
  delta beside the untouched (quantized, fused included) base matmul.
  In paged mode LoRA requests neither take nor publish prefixes: an
  adapter on wk/wv makes their KV adapter-specific.
- **Overload (admission control + preemption).** The wait queue is
  bounded and priority-ordered (``serve.scheduler.WaitQueue``):
  ``submit(..., priority=, deadline_s=)`` applies the engine's
  ``admission`` policy when ``max_queue`` is reached ("block" drives
  ``step()`` until a position frees, "reject" and "evict" shed a request
  with ``finish_reason="rejected"``; nothing raises), and a request whose
  queue wait passes ``deadline_s`` finishes ``"expired"``. When the pool
  cannot cover a decode window, or a strictly higher-priority request
  waits, the engine preempts the lowest-priority, youngest running slot:
  its full KV blocks are published into the radix index, its partial
  tail block is copied to the host (``SwapState``), its blocks are
  released and it requeues with its rid. Restore is fast (an uncapped
  index ``lookup`` and the tail written into a fresh block, straight back
  to decode) when every full block survived, else a recompute through
  the prefill path on ``prompt ++ tokens``; both resume token-identically.
  Admission is plan-then-commit (``PagedKVCache.admit``) and each decode
  window's blocks are reserved before the pool changes, and the
  ``fault_hook`` (``serve.chaos``) fires right before each prefill and
  decode dispatch: an exception there rolls admission back and requeues
  the wave (adapter pins intact), and leaves the decode step retryable.
- **Chunked prefill (``prefill_budget=N``, paged only).** No ``step()``
  spends more than N prompt tokens on prefill (first chunks and
  continuations together), so a long prompt is consumed over several
  steps between decode chunks. A slot mid-prefill holds a block-aligned
  ``prefill_cursor``, extends its blocks chunk by chunk
  (``PagedKVCache.extend``), publishes each chunk at once, and its
  block-table row goes to the device as all-trash (a decode chunk writes
  KV for every row). Preempted mid-prefill it publishes what it consumed
  and re-admits through the prefill path, which hits those blocks again.
  Wave shapes come from a fixed lattice (power-of-two widths up to
  ``n_slots``, power-of-two lengths capped by the budget). Continuation
  chunks attend to their own prefix through ``ops.prefix_attention``;
  a wave with no prefix takes flash attention. Greedy output equals
  unbudgeted serving's.
- **Streaming, cancellation, deadlines.** ``submit(on_token=f)`` calls
  ``f(request, token)`` for each token at harvest (the prefill's first
  token, each decode chunk); ``stream()`` wraps submit and step into a
  generator. ``cancel(rid)``, or ``StopStream`` raised from the callback,
  tears a request down (slot, blocks and adapter pin released, published
  prefixes kept, ``finish_reason="cancelled"``, partial tokens kept).
  ``t_first`` is stamped at the first emission. ``ttft_deadline_s`` and
  ``itl_deadline_s`` bound time to first token and the gap between tokens
  while running, checked each step against the engine's ``clock``
  (injectable; every time stamp comes from it): a request past either
  finishes ``"expired"`` with its partial tokens.

Tensor parallelism and speculative decoding are not ported yet: asking
for them raises ``NotImplementedError`` naming the ROADMAP item.
"""


from __future__ import annotations

import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.axllm_linear import deploy_quantize
from repro_torch.core.quantization import QuantConfig
from repro_torch.kernels import ops
from repro_torch.models.model import ModelAPI, get_model
from repro_torch.serve.adapters import AdapterRegistry, target_dims
from repro_torch.serve.decode import decode_steps, sample_tokens
from repro_torch.serve.paged_cache import TRASH_BLOCK, PagedKVCache
from repro_torch.serve.scheduler import WaitQueue, pick_victim, prefill_chunk


def _not_ported(what: str, item: str):
    return NotImplementedError(f"{what} is not ported yet ({item})")


class StopStream(Exception):
    """Raise from an ``on_token`` callback to cancel the stream.

    The engine catches it where it emits and tears the request down as
    :meth:`ServeEngine.cancel` does: slot freed, KV blocks released
    (published prefixes stay in the radix index), adapter pin dropped,
    ``finish_reason="cancelled"``. Tokens emitted before the raise stay
    on the request.
    """


@dataclasses.dataclass
class SwapState:
    """Host-side remainder of a preempted slot's KV (paged mode).

    Full blocks are published into the radix index at swap-out (base
    requests), so the swap state carries only what the index cannot: the
    partial tail block's KV rows, copied to the host (never a view of the
    pool, whose block is reused as soon as it is freed). A restore first
    tries the fast path (uncapped index lookup, tail written back into a
    fresh block, no recompute); if a full block was evicted meanwhile it
    recomputes the KV through the prefill path, as dense mode and LoRA
    requests (whose KV is never indexed) always do.
    """
    seq_len: int                      # KV positions covered at swap-out
    full_blocks: int                  # seq_len // block_size
    tail: Optional[Dict[str, torch.Tensor]] = None  # pool leaf -> [L, bs, ...]


@dataclasses.dataclass
class Request:
    """One serving request: prompt in, generated ``tokens`` out."""
    rid: int
    prompt: np.ndarray            # [S] int32 (after the long-prompt policy)
    max_new: int = 32
    adapter: Optional[str] = None     # LoRA adapter name (None = base)
    tokens: list = dataclasses.field(default_factory=list)
    done: bool = False
    truncated: bool = False           # generation cut short (cache/steps)
    prompt_truncated: bool = False    # prompt clipped by long_prompt policy
    priority: int = 0                 # larger admits first, may preempt
    deadline_s: Optional[float] = None    # max queue wait before expiry
    finish_reason: Optional[str] = None   # eos / max_new / cache_full /
                                          # rejected / expired / cancelled
    t_submit: float = 0.0             # engine-clock submit time
    t_first: Optional[float] = None   # first-token emission time (TTFT)
    t_last: Optional[float] = None    # last-token time (ITL base)
    preemptions: int = 0              # times swapped out of a slot
    _swap: Optional[SwapState] = None     # host tail KV while preempted
    # streaming: called per token at harvest; raising StopStream from it
    # cancels the request
    on_token: Optional[object] = None
    # execution deadlines (deadline_s bounds only the queue wait)
    ttft_deadline_s: Optional[float] = None   # submit -> first emission
    itl_deadline_s: Optional[float] = None    # largest gap between tokens
    # chunked prefill: a seated slot may hold only a prefix of its prompt
    prefilling: bool = False          # seated, prompt not fully consumed
    prefill_cursor: int = 0           # admission-sequence tokens consumed
    _emitted: int = 0                 # tokens already streamed to on_token
    _admitted: bool = False           # counted in stats.admitted (vs restore)


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
    lora_requests: int = 0            # admitted requests with an adapter
    occupancy_sum: float = 0.0        # sum over steps of active / n_slots
    # paged mode: prompt tokens whose KV came from the prefix index, live
    # pool blocks, and copy-on-write block copies before decode chunks
    prefix_hit_tokens: int = 0
    blocks_in_use: int = 0
    cow_copies: int = 0
    # overload: admission-control and preemption outcomes
    rejected: int = 0                 # shed by the admission policy
    expired: int = 0                  # deadline passed (queued or running)
    preempted: int = 0                # swap-outs of running slots
    restored: int = 0                 # re-admissions after preemption
    fast_restores: int = 0            # restores that skipped recompute
    # streaming and chunked prefill
    cancelled: int = 0                # torn down by cancel() / StopStream
    prefill_chunks: int = 0           # budgeted prefill chunks executed
    preempted_prefill: int = 0        # preemptions of mid-prefill slots

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

    ``fuse_qkv`` (None takes ``cfg.fuse_qkv``) fuses the projections;
    ``adapters`` attaches an :class:`AdapterRegistry` on the engine's
    device for multi-LoRA serving (see the module docstring).

    Overload: ``max_queue`` bounds the wait queue and ``admission``
    ("block", "reject", "evict") says what a full queue does; ``clock``
    (default ``time.monotonic``) stamps and checks every deadline;
    ``fault_hook(phase)`` is called with "prefill" or "decode" right
    before each dispatch; ``prefill_budget`` (paged only, at least one
    block) caps the prompt tokens each ``step()`` prefills.

    Serve with ``submit`` + ``step()`` / ``run()``, ``stream()``, or the
    one-shot ``generate(prompts)``; ``cancel(rid)`` ends a request.
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
                 max_queue: Optional[int] = None, admission: str = "block",
                 clock=None, fault_hook=None,
                 speculate: bool = False,
                 prefill_budget: Optional[int] = None, device="cuda"):
        if prefill_budget is not None:
            if not paged:
                raise ValueError(
                    "prefill_budget requires paged=True: chunked prefill "
                    "allocates and publishes KV one block at a time, which "
                    "the dense per-slot cache cannot express")
            if speculate:
                raise ValueError(
                    "prefill_budget is incompatible with speculate=True: "
                    "the draft cache is dense and prefills whole sequences "
                    "in one wave, so a mid-prefill slot would enter a "
                    "speculative round with no draft KV behind its cursor")
            if prefill_budget < kv_block_size:
                raise ValueError(
                    f"prefill_budget={prefill_budget} is below one KV block "
                    f"(kv_block_size={kv_block_size}): a non-final chunk is "
                    "floored to whole blocks, so no chunk could ever make "
                    "progress")
        for on, what, item in (
                (mesh is not None, "tensor-parallel serving",
                 "ROADMAP queue 1 item 12"),
                (speculate, "speculative decoding", "ROADMAP queue 1 item 9")):
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
        if cfg.fuse_qkv if fuse_qkv is None else fuse_qkv:
            params = self.api.fuse_params(params)
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
        self.registry = adapters
        if adapters is not None:
            self._validate_adapters(adapters)
        # per-slot adapter row into registry.stacked; -1 = base only
        self.adapter_slots = np.full((n_slots,), -1, np.int32)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
        self.paged = paged
        self.kv_block_size = kv_block_size
        self.prefix_cache = prefix_cache
        self.prefill_budget = prefill_budget
        # the per-step chunked-prefill ledger (reset at the top of _step)
        self._prefill_left = prefill_budget
        self._prefill_progress = False
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
        # bounded priority wait queue; max_queue=None with "block" is the
        # unbounded FIFO of a closed-loop caller
        self.queue = WaitQueue(max_queue, admission)
        # injectable clock (deadlines, TTFT) and fault hook (chaos harness:
        # called with "prefill" / "decode" right before each dispatch)
        self._clock = time.monotonic if clock is None else clock
        self.fault_hook = fault_hook
        self.finished: List[Request] = []
        self._rid = 0
        self.stats = EngineStats()

    def _validate_adapters(self, reg: AdapterRegistry):
        """The family must take the LoRA kwargs, and the registry must be
        built for a config of the same dims, on the engine's device."""
        if not self.api.supports_lora:
            raise ValueError(f"family {self.cfg.family!r} has no multi-LoRA "
                             "serving path")
        if reg.cfg.n_layers != self.cfg.n_layers:
            raise ValueError(
                f"adapter registry built for n_layers={reg.cfg.n_layers} "
                f"but engine serves n_layers={self.cfg.n_layers}")
        for t in reg.targets:
            if target_dims(reg.cfg, t) != target_dims(self.cfg, t):
                raise ValueError(
                    f"adapter registry target {t!r} dims "
                    f"{target_dims(reg.cfg, t)} != model dims "
                    f"{target_dims(self.cfg, t)}")
        if reg.device != self.device:
            raise ValueError(f"adapter registry lives on {reg.device}, the "
                             f"engine on {self.device}")

    def _lora_kw(self, aidx: np.ndarray) -> dict:
        """The multi-LoRA kwargs of a prefill or decode call for per-row
        adapter rows ``aidx`` (none without a registry)."""
        if self.registry is None:
            return {}
        return dict(adapters=self.registry.stacked,
                    adapter_idx=torch.from_numpy(aidx).to(self.device),
                    lora_scaling=self.registry.scaling)

    def _adapter_row(self, r: Request) -> int:
        return -1 if r.adapter is None else \
            self.registry.index_of(r.adapter)

    # -- request management ---------------------------------------------------
    def _now(self) -> float:
        return self._clock()

    def submit(self, prompt, max_new: int = 32, adapter=None,
               priority: int = 0, deadline_s: Optional[float] = None,
               on_token=None, ttft_deadline_s: Optional[float] = None,
               itl_deadline_s: Optional[float] = None) -> int:
        """Queue a prompt ([S] ints) for generation; returns a request id.

        ``adapter`` names a registered LoRA adapter to serve the request
        with (the engine needs ``adapters=``; an unknown name raises
        KeyError here). It stays pinned until the request finishes.

        ``priority``: larger admits first, and a strictly higher-priority
        arrival may preempt a running lower-priority slot. ``deadline_s``:
        the longest the request may wait in the queue before it finishes
        ``"expired"`` with no tokens. When the queue is at ``max_queue``
        the admission policy decides: "block" drives ``step()`` until a
        position frees, "reject" / "evict" shed a request
        (``finish_reason="rejected"``) without raising.

        ``on_token``: streaming callback ``f(request, token)`` called for
        each token as the engine harvests it; raising :class:`StopStream`
        from it cancels the request (any other exception propagates out of
        ``step()``). ``ttft_deadline_s`` / ``itl_deadline_s``: execution
        deadlines checked each step, for the first token after submit and
        for the gap since the last token; a request past either finishes
        ``"expired"`` keeping its partial tokens."""
        if adapter is not None and self.registry is None:
            raise ValueError("submit(adapter=...) needs an engine built with "
                             "adapters=AdapterRegistry")
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
        if adapter is not None:
            self.registry.acquire(adapter)    # KeyError on an unknown name
        req = Request(self._rid, prompt, max_new, adapter=adapter,
                      prompt_truncated=prompt_truncated, priority=priority,
                      deadline_s=deadline_s, t_submit=self._now(),
                      on_token=on_token, ttft_deadline_s=ttft_deadline_s,
                      itl_deadline_s=itl_deadline_s)
        self._rid += 1
        dec = self.queue.offer(req)
        while dec.must_block:
            # backpressure: drain the engine until a queue position frees
            if not self.step():
                raise RuntimeError(
                    "admission blocked with a drained engine: the wait "
                    "queue is full but nothing in it can make progress")
            dec = self.queue.offer(req)
        if dec.evicted is not None:
            self._finish(dec.evicted, "rejected")
        if not dec.admitted:
            self._finish(req, "rejected")
        return req.rid

    def _free_slots(self):
        return [i for i, s in enumerate(self.slots) if s is None]

    # -- KV sequences ---------------------------------------------------------
    def _admission_seq(self, r: Request) -> np.ndarray:
        """Tokens a (re-)admission prefills: the prompt plus everything
        generated so far. A fresh request prefills its prompt; a
        recompute restore re-enters with its generated tokens, so the
        prefill's last-position logits give exactly the token an
        uninterrupted decode would have."""
        if not r.tokens:
            return r.prompt
        return np.concatenate([r.prompt, np.asarray(r.tokens, np.int32)])

    def _kv_seq(self, r: Request) -> np.ndarray:
        """Tokens whose KV a running slot holds: prompt ++ tokens[:-1] (the
        last sampled token's KV is written by the next decode step). Keys
        the prefix-index publish at finish and at swap-out."""
        return np.concatenate([r.prompt, np.asarray(r.tokens[:-1],
                                                    np.int32)])

    # -- preemption (swap-out) and restore ------------------------------------
    def _preempt_slot(self, i: int):
        """Swap the request in slot ``i`` out without losing work.

        Paged mode releases the slot's blocks through the radix index:
        full blocks are published under the KV sequence (a fast restore,
        or any request sharing the prefix, finds them) and the partial
        tail block's rows are copied to the host. Dense mode abandons the
        slot's rows (restore recomputes). The request requeues with its
        rid, so it admits ahead of its priority class."""
        r = self.slots[i]
        if self.paged and r.prefilling:
            # a mid-prefill victim's consumed prefix is whole blocks (the
            # cursor is block-aligned): publish them and drop the slot; the
            # prefill path re-hits them at re-admission, so no swap state
            if r.adapter is None:
                self.pager.insert(self._admission_seq(r)[:r.prefill_cursor],
                                  self.pager.slot_blocks(i))
            r.prefilling = False
            r.prefill_cursor = 0
            self.pager.release_slot(i)
            self.stats.blocks_in_use = self.pager.blocks_in_use
            self.stats.preempted_prefill += 1
        elif self.paged:
            seq = self._kv_seq(r)
            bs = self.kv_block_size
            full = len(seq) // bs
            blocks = self.pager.slot_blocks(i)
            if r.adapter is None and full:
                self.pager.insert(seq, blocks[:full])
            tail = None
            if len(seq) % bs and full < len(blocks):
                # a copy on the host: pool[:, tb] is a view, and the block
                # is rewritten as soon as the pool hands it out again
                tb = blocks[full]
                tail = {name: self.cache[name][:, tb].to("cpu", copy=True)
                        for name in self._pool_leaves}
            r._swap = SwapState(seq_len=len(seq), full_blocks=full,
                                tail=tail)
            self.pager.release_slot(i)
            self.stats.blocks_in_use = self.pager.blocks_in_use
        self.slots[i] = None
        self.adapter_slots[i] = -1
        r.preemptions += 1
        self.stats.preempted += 1
        self.queue.push_front(r)

    def _try_fast_restore(self, r: Request, slot: int) -> bool:
        """Re-seat a swapped-out request without recompute: every full KV
        block must still be in the radix index (uncapped ``lookup``) and
        the partial tail, if any, in the host swap buffer. On success the
        slot goes straight back to decode. Returns False (recompute) if
        anything was evicted meanwhile."""
        sw = r._swap
        if sw is None or not self.paged:
            return False
        if r.adapter is not None and sw.full_blocks:
            return False               # LoRA KV is never in the index
        hit = self.pager.lookup(self._kv_seq(r)) if sw.full_blocks else []
        if len(hit) < sw.full_blocks:
            return False               # prefix (partly) evicted
        hit = hit[:sw.full_blocks]
        tail_len = sw.seq_len % self.kv_block_size
        if tail_len and sw.tail is None:
            return False
        if not self.pager.admit(slot, hit, 1 if tail_len else 0):
            return False               # pool dry even after eviction
        if tail_len:
            tb = int(self.pager.tables[slot, sw.full_blocks])
            for name in self._pool_leaves:
                self.cache[name][:, tb] = sw.tail[name].to(self.device)
        r._swap = None
        self.slots[slot] = r
        self.adapter_slots[slot] = self._adapter_row(r)
        self.stats.restored += 1
        self.stats.fast_restores += 1
        return True

    def _priority_preempt(self):
        """Make room for strictly higher-priority queued requests: for
        each waiting request beyond what the free slots take, preempt the
        lowest-priority running slot strictly below it (never an equal:
        two peers must not thrash)."""
        if not self.queue:
            return
        nfree = len(self._free_slots())
        waiting = sorted(self.queue,
                         key=lambda q: (-q.priority, q.rid))[nfree:]
        for req in waiting:
            victim = pick_victim(self.slots, below_priority=req.priority)
            if victim is None:
                break
            self._preempt_slot(victim)

    # -- execution deadlines (TTFT / inter-token) -----------------------------
    def _deadline_passed(self, r: Request, now: float) -> bool:
        if r.ttft_deadline_s is not None and r.t_first is None \
                and now - r.t_submit > r.ttft_deadline_s:
            return True
        if r.itl_deadline_s is not None and r.t_last is not None \
                and now - r.t_last > r.itl_deadline_s:
            return True
        return False

    def _expire_deadlines(self):
        """Enforce the TTFT and inter-token deadlines wherever a request
        is: queued (a preempted one too), mid-prefill or decoding. An
        expired runner keeps its partial tokens, publishes its reusable
        prefix and frees its slot, blocks and pin."""
        now = self._now()
        dead = [r for r in self.queue if self._deadline_passed(r, now)]
        for r in dead:
            self.queue.remove(r)
            self._finish(r, "expired")
        for i, r in enumerate(self.slots):
            if r is not None and self._deadline_passed(r, now):
                self._teardown_slot(i)
                self._finish(r, "expired")

    def _teardown_slot(self, i: int):
        """Release slot ``i`` without finishing its request: publish the
        full blocks of the sequence the slot holds (``_kv_seq`` when
        decoding, the block-aligned cursor when mid-prefill), release its
        blocks and clear the slot. The caller finishes the request."""
        r = self.slots[i]
        if self.paged:
            if r.adapter is None:
                seq = (self._admission_seq(r)[:r.prefill_cursor]
                       if r.prefilling else self._kv_seq(r))
                self.pager.insert(seq, self.pager.slot_blocks(i))
            self.pager.release_slot(i)
            self.stats.blocks_in_use = self.pager.blocks_in_use
        self.slots[i] = None
        self.adapter_slots[i] = -1

    # -- streaming (per-token emission + cancellation) ------------------------
    def _emit(self, r: Request, now: float) -> bool:
        """Stream the tokens appended since the last harvest to
        ``on_token``, stamping ``t_first`` at the first emission. Returns
        True when the callback raised :class:`StopStream`: the caller then
        cancels the request unless a stop reason already finished it."""
        new = r.tokens[r._emitted:]
        if not new:
            return False
        if r.t_first is None:
            r.t_first = now
        if r.on_token is None:
            r._emitted = len(r.tokens)
            return False
        for t in new:
            r._emitted += 1
            try:
                r.on_token(r, int(t))
            except StopStream:
                # the client took exactly _emitted tokens: drop the rest of
                # this harvest so the request holds what was streamed
                del r.tokens[r._emitted:]
                return True
        return False

    def cancel(self, rid: int) -> bool:
        """End a queued or running request: ``finish_reason="cancelled"``,
        the tokens emitted so far kept, its slot, KV blocks (published
        full prefix blocks stay in the radix index) and adapter pin
        released. Returns True when it was live, False when it had
        already finished. An unknown rid raises KeyError."""
        for i, s in enumerate(self.slots):
            if s is not None and s.rid == rid:
                self._teardown_slot(i)
                self._finish(s, "cancelled")
                return True
        for r in list(self.queue):
            if r.rid == rid:
                self.queue.remove(r)
                self._finish(r, "cancelled")
                return True
        if any(r.rid == rid for r in self.finished):
            return False
        raise KeyError(f"request {rid} not found")

    def stream(self, prompt, max_new: int = 32, **kw):
        """Generator of one request's tokens as they are produced: submits
        the prompt and drives ``step()``. Closing it early (``break``,
        ``.close()``, garbage collection) cancels the request and releases
        what it held. Keyword arguments go to :meth:`submit`; a caller's
        ``on_token`` runs before the stream's own buffering (and may raise
        :class:`StopStream`)."""
        buf: List[int] = []
        user_cb = kw.pop("on_token", None)

        def tap(req, tok):
            if user_cb is not None:
                user_cb(req, tok)       # StopStream propagates to the engine
            buf.append(tok)

        rid = self.submit(prompt, max_new, on_token=tap, **kw)
        try:
            while True:
                while buf:
                    yield buf.pop(0)
                if any(r.rid == rid for r in self.finished):
                    return
                if not self.step():
                    return              # drained with the request resolved
        finally:
            if not any(r.rid == rid for r in self.finished):
                self.cancel(rid)

    # -- prefill waves --------------------------------------------------------
    def _admit(self):
        for r in self.queue.expire(self._now()):
            self._finish(r, "expired")
        self._expire_deadlines()
        self._priority_preempt()
        self._continue_prefill()
        free = self._free_slots()
        if not free or not self.queue:
            return
        pending = []
        for r in self.queue.take(len(free)):
            if self.paged and r._swap is not None and free \
                    and self._try_fast_restore(r, free[0]):
                free.pop(0)
                continue
            pending.append(r)
        if not pending:
            return
        t0 = time.perf_counter()
        try:
            if self.paged:
                self._prefill_group_paged(pending, free)
            else:
                self._prefill_group(pending, free)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        finally:
            self.stats.prefill_wall_s += time.perf_counter() - t0

    def _seat(self, r: Request, slot: int, row: int):
        self.slots[slot] = r
        self.adapter_slots[slot] = row

    def _first_token(self, r: Request, tok: int, now: float) -> Optional[str]:
        """Append the prefill's first token, stamp and stream it; returns
        the reason the request ends here, if it does."""
        r.tokens.append(tok)
        r.t_last = now
        want_cancel = self._emit(r, now)
        reason = self._stop_reason(r)
        if reason is None and want_cancel:
            reason = "cancelled"
        return reason

    def _count_admission(self, r: Request):
        """A fresh request counts as admitted; a recompute restore as
        restored."""
        if not r._admitted:
            r._admitted = True
            self.stats.admitted += 1
            self.stats.lora_requests += r.adapter is not None
        else:
            self.stats.restored += 1
        r._swap = None

    def _prefill_group(self, group: List[Request], free: List[int]):
        w = len(group)
        wb = _pow2_bucket(w, 1, self.n_slots)
        seqs = [self._admission_seq(r) for r in group]
        lens = [len(s) for s in seqs]
        pl = _pow2_bucket(max(lens), min(8, self.max_len), self.max_len)
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        aidx = np.full((wb,), -1, np.int32)
        for i, (r, seq) in enumerate(zip(group, seqs)):
            toks[i, :lens[i]] = seq
            lengths[i] = lens[i]
            aidx[i] = self._adapter_row(r)
        wave_cache = self.api.init_cache(wb, pl, self.device)
        try:
            if self.fault_hook is not None:
                self.fault_hook("prefill")
            logits, wave_cache = self.api.prefill(
                self.params,
                {"tokens": torch.from_numpy(toks).to(self.device)},
                wave_cache, lengths=torch.from_numpy(lengths).to(self.device),
                **self._lora_kw(aidx))
        except Exception:
            # nothing was changed yet: requeue the whole group, so no
            # request (or its adapter pin) is lost
            for r in group:
                self.queue.push_front(r)
            raise
        first = self._sample(logits)
        now = self._now()
        src, dst = [], []
        for i, r in enumerate(group):
            self._count_admission(r)
            self.stats.prefill_tokens += int(lengths[i])
            reason = self._first_token(r, int(first[i]), now)
            if reason is not None:
                self._finish(r, reason)   # EOS/max_new on the first token
                continue
            slot = free.pop(0)
            self._seat(r, slot, aidx[i])
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
        reuse them. Under a ``prefill_budget`` each row takes at most what
        is left of the step's budget (a non-final chunk whole blocks) and
        seats mid-prefill when its prompt is not consumed.

        Admission is atomic per request (``pager.admit``): a request the
        pool cannot hold, even after LRU eviction, goes back to the queue
        holding zero blocks (deferral, not preemption: a victim would
        compete for the same blocks at once). A failure in the prefill
        dispatch releases every admitted request's blocks and requeues
        the wave.

        LoRA requests bypass the prefix index: an adapter on wk/wv makes
        their KV adapter-specific, so they neither take nor publish
        prefixes."""
        pgr, bs = self.pager, self.kv_block_size
        budgeted = self.prefill_budget is not None
        admitted, slots_for, seqs, hits, hit_toks, takes = \
            [], [], [], [], [], []
        for r in group:
            seq = self._admission_seq(r)
            hit, ht = pgr.match(seq) if r.adapter is None else ([], 0)
            take = len(seq) - ht
            if budgeted:
                take = prefill_chunk(take, self._prefill_left, bs)
                if take == 0:
                    self.queue.push_front(r)   # the step's budget is spent
                    continue
            slot = free[0]
            if not pgr.admit(slot, hit, math.ceil(take / bs)):
                self.queue.push_front(r)     # defer: the pool is dry now
                continue
            free.pop(0)
            if budgeted:
                self._prefill_left -= take
            admitted.append(r)
            slots_for.append(slot)
            seqs.append(seq)
            hits.append(hit)
            hit_toks.append(ht)
            takes.append(take)
        if not admitted:
            return
        wb = _pow2_bucket(len(admitted), 1, self.n_slots)
        pl = _pow2_bucket(max(takes), bs, self._max_chunk())
        npb_max = max(len(h) for h in hits)
        npb = _pow2_bucket(npb_max, 1, self.max_blocks) if npb_max else 0
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        prefix_len = np.zeros((wb,), np.int32)
        pbt = np.zeros((wb, max(npb, 1)), np.int32)
        sbt = np.zeros((wb, pl // bs), np.int32)
        aidx = np.full((wb,), -1, np.int32)
        for i, slot in enumerate(slots_for):
            aidx[i] = self._adapter_row(admitted[i])
            chunk = seqs[i][hit_toks[i]:hit_toks[i] + takes[i]]
            toks[i, :len(chunk)] = chunk
            lengths[i] = len(chunk)
            prefix_len[i] = hit_toks[i]
            nh = len(hits[i])
            pbt[i, :nh] = hits[i]
            nsb = math.ceil(len(chunk) / bs)
            sbt[i, :nsb] = pgr.tables[slot, nh:nh + nsb]
        try:
            if self.fault_hook is not None:
                self.fault_hook("prefill")
            logits = self._paged_prefill(toks, lengths, prefix_len,
                                         pbt if npb else None, sbt, aidx)
        except Exception:
            for r, slot in zip(admitted, slots_for):
                pgr.release_slot(slot)
                self.queue.push_front(r)
            self.stats.blocks_in_use = pgr.blocks_in_use
            raise
        first = self._sample(logits)
        now = self._now()
        for i, (r, slot) in enumerate(zip(admitted, slots_for)):
            self._count_admission(r)
            self.stats.prefill_tokens += int(lengths[i])
            self.stats.prefix_hit_tokens += hit_toks[i]
            if budgeted:
                self.stats.prefill_chunks += 1
                self._prefill_progress = True
            if hit_toks[i] + takes[i] < len(seqs[i]):
                # a partial first chunk: the slot seats mid-prefill with a
                # block-aligned cursor and no token (the chunk's logits are
                # mid-prompt and dropped), and publishes the consumed blocks
                r.prefilling = True
                r.prefill_cursor = hit_toks[i] + takes[i]
                if r.adapter is None:
                    pgr.insert(seqs[i][:r.prefill_cursor],
                               pgr.slot_blocks(slot))
                self._seat(r, slot, aidx[i])
                continue
            r.prefilling = False
            r.prefill_cursor = len(seqs[i])
            # publish now: later waves reuse this prefill while the slot
            # is still decoding (base model only)
            if r.adapter is None:
                pgr.insert(seqs[i], pgr.slot_blocks(slot))
            reason = self._first_token(r, int(first[i]), now)
            if reason is not None:
                pgr.release_slot(slot)
                self._finish(r, reason)   # EOS/max_new on the first token
                free.append(slot)
                continue
            self._seat(r, slot, aidx[i])
        self.stats.prefill_waves += 1
        self.stats.blocks_in_use = pgr.blocks_in_use

    def _max_chunk(self) -> int:
        """The longest padded chunk a paged wave may take: the context
        without a budget, else the budget's power-of-two bucket."""
        max_ctx = self.max_blocks * self.kv_block_size
        if self.prefill_budget is None:
            return max_ctx
        return min(max_ctx, _pow2_bucket(self.prefill_budget,
                                         self.kv_block_size, max_ctx))

    def _continue_prefill(self):
        """Advance every mid-prefill slot by one budgeted chunk, before new
        requests draw on the step's budget (in-flight prompts finish
        sooner and free their slots sooner). The continuations run as one
        wave with the slots' own consumed blocks as the prefix."""
        if self.prefill_budget is None:
            return
        bs = self.kv_block_size
        items = []                      # (slot, request, seq, take)
        for i, r in enumerate(self.slots):
            if r is None or not r.prefilling:
                continue
            seq = self._admission_seq(r)
            take = prefill_chunk(len(seq) - r.prefill_cursor,
                                 self._prefill_left, bs)
            if take == 0:
                continue                # the step's budget is spent
            self._prefill_left -= take
            items.append((i, r, seq, take))
        if not items:
            return
        t0 = time.perf_counter()
        try:
            self._continue_prefill_wave(items)
        finally:
            self.stats.prefill_wall_s += time.perf_counter() - t0

    def _continue_prefill_wave(self, items):
        """One continuation wave. Blocks are allocated all-or-nothing per
        slot (``pager.extend``); while the pool cannot cover the wave,
        victims are preempted (mid-prefill slots too) until it can or one
        slot is left. A fault in the dispatch truncates the extension back
        to the cursor: the slots stay seated and a retried step runs the
        same chunk."""
        pgr, bs = self.pager, self.kv_block_size
        while True:
            need = sum(math.ceil(take / bs) for _, _, _, take in items)
            if pgr.can_allocate(need):
                break
            if sum(s is not None for s in self.slots) <= 1:
                break                   # extend() defers per slot below
            victim = pick_victim(self.slots)
            self._preempt_slot(victim)
            items = [it for it in items if it[0] != victim]
            if not items:
                return
        ran = [it for it in items if pgr.extend(it[0], math.ceil(it[3] / bs))]
        if not ran:
            return                      # every chunk deferred to next step
        wb = _pow2_bucket(len(ran), 1, self.n_slots)
        pl = _pow2_bucket(max(t for *_, t in ran), bs, self._max_chunk())
        npb = _pow2_bucket(max(r.prefill_cursor // bs for _, r, _, _ in ran),
                           1, self.max_blocks)
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        prefix_len = np.zeros((wb,), np.int32)
        pbt = np.zeros((wb, npb), np.int32)
        sbt = np.zeros((wb, pl // bs), np.int32)
        aidx = np.full((wb,), -1, np.int32)
        for j, (slot, r, seq, take) in enumerate(ran):
            cur = r.prefill_cursor      # block-aligned by construction
            toks[j, :take] = seq[cur:cur + take]
            lengths[j] = take
            prefix_len[j] = cur
            nh = cur // bs
            pbt[j, :nh] = pgr.tables[slot, :nh]
            nsb = math.ceil(take / bs)
            sbt[j, :nsb] = pgr.tables[slot, nh:nh + nsb]
            aidx[j] = self.adapter_slots[slot]
        try:
            if self.fault_hook is not None:
                self.fault_hook("prefill")
            logits = self._paged_prefill(toks, lengths, prefix_len, pbt, sbt,
                                         aidx)
        except Exception:
            # back to the cursor: the slots stay seated mid-prefill and a
            # retried step plans the same chunk
            for slot, r, _, _ in ran:
                pgr.truncate(slot, r.prefill_cursor)
            self.stats.blocks_in_use = pgr.blocks_in_use
            raise
        first = self._sample(logits)
        now = self._now()
        for j, (slot, r, seq, take) in enumerate(ran):
            r.prefill_cursor += take
            self.stats.prefill_tokens += take
            self.stats.prefill_chunks += 1
            self._prefill_progress = True
            if r.adapter is None:
                pgr.insert(seq[:r.prefill_cursor], pgr.slot_blocks(slot))
            if r.prefill_cursor < len(seq):
                continue                # still mid-prompt
            # the final chunk: its last-position logits end the prompt
            r.prefilling = False
            reason = self._first_token(r, int(first[j]), now)
            if reason is not None:
                pgr.release_slot(slot)
                self._finish(r, reason)
                self.slots[slot] = None
                self.adapter_slots[slot] = -1
        self.stats.prefill_waves += 1
        self.stats.blocks_in_use = pgr.blocks_in_use

    def _paged_prefill(self, toks, lengths, prefix_len, pbt, sbt, aidx):
        """One paged prefill dispatch: gather the rows' cached prefix KV out
        of the pool through ``pbt`` (None: no row has a prefix, plain
        ragged prefill through flash attention), run the suffix-only
        prefill with the rows' adapter rows ``aidx``, and scatter the
        suffix KV into the rows' fresh blocks ``sbt``. Padded rows and
        entries point at trash block 0, so the scatter sees repeated
        indices; nobody reads the trash block, so any winner is fine."""
        dev, bs = self.device, self.kv_block_size
        wb, pl = toks.shape
        wave = self.api.init_cache(wb, pl, dev)
        kw = {"lengths": torch.from_numpy(lengths).to(dev),
              **self._lora_kw(aidx)}
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

    # -- sampling and stopping ------------------------------------------------
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
        """Terminal bookkeeping of every outcome. ``finished`` (the list)
        holds all of them; ``stats.finished`` counts only generation
        outcomes (eos / max_new / cache_full), and rejected, expired and
        cancelled requests are counted apart."""
        r.done = True
        r.finish_reason = reason
        r._swap = None
        r.prefilling = False
        if r.adapter is not None:
            self.registry.release(r.adapter)  # unpin: evict becomes legal
        self.finished.append(r)
        if reason in ("rejected", "expired", "cancelled"):
            setattr(self.stats, reason, getattr(self.stats, reason) + 1)
            return
        self.stats.finished += 1
        if r.truncated:
            self.stats.truncated += 1

    # -- decode ---------------------------------------------------------------
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

    def _window(self, i: int, n: int):
        """(first position, length) of slot ``i``'s decode write window."""
        r = self.slots[i]
        pos0 = len(r.prompt) + len(r.tokens) - 1
        rem = min(r.max_new - len(r.tokens), self.max_len - pos0)
        return pos0, max(1, min(n, rem))

    def step(self, max_n: Optional[int] = None) -> bool:
        """Admit a prefill wave, then run ONE chunked decode dispatch of up
        to min(decode_chunk, max_n, largest remaining budget) steps.
        Returns False when no work is left."""
        with torch.inference_mode():
            return self._step(max_n)

    def _decoding(self) -> List[int]:
        return [i for i, s in enumerate(self.slots)
                if s is not None and not s.prefilling]

    def _step(self, max_n: Optional[int]) -> bool:
        if self.prefill_budget is not None:
            # the per-step prefill ledger: first chunks and continuations
            # both draw on it, so no step prefills more than the budget
            self._prefill_left = self.prefill_budget
            self._prefill_progress = False
        self._admit()
        active = [i for i, s in enumerate(self.slots) if s is not None]
        while not active and self.queue:
            # a whole wave can finish at prefill (EOS/max_new on the first
            # token); keep admitting so queued work is never stranded
            before = (len(self.queue), len(self.finished),
                      self.stats.restored)
            self._admit()
            active = [i for i, s in enumerate(self.slots) if s is not None]
            if not active and before == (len(self.queue),
                                         len(self.finished),
                                         self.stats.restored):
                # every slot is free yet nothing admits, finishes or
                # expires: the pool can never hold the queued requests
                raise RuntimeError(
                    f"admission stalled: {len(self.queue)} queued "
                    f"request(s) cannot fit an empty engine "
                    f"(num_blocks={getattr(self, 'num_blocks', None)})")
        if not active:
            return False
        # mid-prefill slots hold blocks but no token to decode yet: they
        # sit out the decode chunk (their table rows go out as trash below)
        decode_active = self._decoding()
        if not decode_active:
            if self._prefill_progress:
                return True             # a prefill-only step did work
            # nothing decodable and no chunk ran (budget spent before these
            # slots, or the pool deferred every extension): preempt one
            # victim so its freed blocks let the next step progress
            victim = pick_victim(self.slots)
            if victim is not None:
                self._preempt_slot(victim)
                return True
            return False
        n = self._chunk_len(decode_active, max_n)
        if self.paged:
            # plan -> commit: reserve the whole write window's blocks before
            # touching the pool, preempting the lowest-priority slot while
            # the window cannot fit. One slot always fits (pool >= one
            # slot's most + trash), so this ends with a runner.
            while True:
                need = 0
                for i in decode_active:
                    a, c = self.pager.plan_decode(i, *self._window(i, n))
                    need += a + c
                if self.pager.can_allocate(need):
                    break
                if sum(s is not None for s in self.slots) <= 1:
                    break
                self._preempt_slot(pick_victim(self.slots))
                decode_active = self._decoding()
                if not decode_active:
                    # the last decoder was the victim: the preemption is
                    # this step's progress
                    return True
                n = self._chunk_len(decode_active, max_n)
        last = np.zeros((self.n_slots,), np.int32)
        gen = np.zeros((self.n_slots,), np.int32)
        budget = np.zeros((self.n_slots,), np.int32)
        stop = np.ones((self.n_slots,), bool)
        for i in decode_active:
            r = self.slots[i]
            last[i] = r.tokens[-1]
            gen[i] = len(r.tokens)
            budget[i] = r.max_new
            stop[i] = False
        dev = self.device
        if self.paged:
            # commit: fresh blocks past each table's end and one batched
            # copy-on-write copy (planned above, so nothing fails halfway;
            # a rerun after a decode fault is a no-op), then the cursors
            # and tables from the host
            cow = []
            pos_host = np.zeros((self.n_slots,), np.int32)
            for i in decode_active:
                pos0, span = self._window(i, n)
                pos_host[i] = pos0
                cow += self.pager.prepare_decode(i, pos0, span)
            if cow:
                self._copy_blocks(cow)
                self.stats.cow_copies += len(cow)
            self.cache["pos"] = torch.from_numpy(pos_host).to(dev)
            # the decode chunk writes KV for every row. A free slot's row is
            # all trash already; a mid-prefill slot's row holds real blocks
            # from index 0, which a write at pos 0 would corrupt, so it goes
            # to the device as trash (the pager's own table is untouched)
            tables = self.pager.tables.copy()
            for i, s in enumerate(self.slots):
                if s is not None and s.prefilling:
                    tables[i, :] = TRASH_BLOCK
            self.cache["block_tables"] = torch.from_numpy(tables).to(dev)
            self.stats.blocks_in_use = self.pager.blocks_in_use
        if self.fault_hook is not None:
            # after the (idempotent) pager commit, before the dispatch: a
            # fault here leaves the step retryable
            self.fault_hook("decode")
        lora = self._lora_kw(self.adapter_slots)

        def decode(p, t, c):
            return self.api.decode(p, t, c, **lora)

        out = decode_steps(
            decode, self.params, torch.from_numpy(last).to(dev),
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
        now = self._now()
        for i in decode_active:
            r = self.slots[i]
            got = 0
            for t in range(n):
                if not valid[t, i]:
                    break
                r.tokens.append(int(toks[t, i]))
                got += 1
            if got:
                r.t_last = now
            want_cancel = self._emit(r, now)
            reason = self._stop_reason(r)
            if reason is None and want_cancel:
                reason = "cancelled"
            if reason is not None:
                if self.paged:
                    # publish the generated tokens' full blocks too, keyed
                    # by the sequence fed (base model only), then drop the
                    # slot's references
                    if r.adapter is None:
                        self.pager.insert(self._kv_seq(r),
                                          self.pager.slot_blocks(i))
                    self.pager.release_slot(i)
                self._finish(r, reason)
                self.slots[i] = None
                self.adapter_slots[i] = -1
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
                 return_requests: bool = False, adapters=None):
        """Serve ``prompts``; returns one token list per prompt (in order).

        ``adapters``: an optional per-prompt list of registered adapter
        names (None = base model). Requests still in flight after
        ``max_steps`` are cancelled: they come back with their partial
        tokens and ``truncated=True``, and release their slots, blocks
        and adapter pins, as they do when an exception propagates."""
        if adapters is None:
            adapters = [None] * len(prompts)
        if len(adapters) != len(prompts):
            raise ValueError(f"adapters list length {len(adapters)} != "
                             f"{len(prompts)} prompts")
        start = len(self.finished)
        ids = []
        try:
            for p, a in zip(prompts, adapters):
                ids.append(self.submit(p, max_new, adapter=a))
            self.run(max_steps)
        except Exception:
            # leave the engine clean behind the error: every request of
            # this call still queued or running releases what it holds
            resolved = {r.rid for r in self.finished[start:]}
            for rid in ids:
                if rid not in resolved:
                    self._cancel(rid)
            raise
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
                self.adapter_slots[i] = -1
                if self.paged:
                    self.pager.release_slot(i)
                r = s
                break
        else:
            r = next(q for q in self.queue if q.rid == rid)
            self.queue.remove(r)
        if r.adapter is not None:
            self.registry.release(r.adapter)
        r.truncated = True
        r.finish_reason = "cancelled"
        r._swap = None
        self.stats.truncated += 1
        return r
