"""Continuous-batching serving engine (PyTorch port): the transformer
families and the recurrent ones (ssm, hybrid).

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
- **Recurrent families (ssm, hybrid).** Their prefill folds every
  position into the state, so it takes no padding
  (``api.ragged_prefill`` False): a wave splits into equal-length
  sub-waves, one per admission length, each at its exact length (the
  width still a power of two), passed no ``lengths``. Slot writes follow
  each cache leaf's batch axis through the nested ``cache_spec``. These
  families have no paged cache, no LoRA hooks and no speculative
  rollback, and the engine refuses ``paged``, ``adapters`` and
  ``speculate`` for them, with the JAX engine's errors. A preempted slot
  restores by recompute: ``prompt ++ tokens`` re-prefills as one
  equal-length group.
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

- **Speculative decoding (``speculate=True``).** The quantization ladder
  doubles as a draft model: ``core.quantization.derive_draft_params``
  derives it once from the raw weights (``draft_bits`` affine or codebook
  codes, or the shift-add reparameterization with
  ``draft_mode="shiftadd"``, dense float32), fused when the target is.
  Each round the draft proposes up to ``spec_k`` greedy tokens from its
  own dense cache (dense even when the target pages), the target checks
  all of them in one teacher-forced pass (``serve.decode.verify_steps``),
  and the engine appends the longest agreeing prefix plus the target's
  correction token (``serve.speculative``). Greedy output equals
  target-only decode token for token: acceptance only moves throughput.
  The KV written for rejected positions is rolled back by a host cursor
  reset (dense) or ``PagedKVCache.truncate`` (paged: whole tail blocks
  back to the pool, published prefixes untouched). Requires
  ``greedy=True``; a preempted speculating slot restores by recompute
  (a fast restore would resume on stale draft KV). Stats:
  ``drafted_tokens``, ``accepted_draft_tokens``, ``acceptance_rate``,
  ``accepted_tokens_per_step``.

- **Serving on a mesh (``mesh=``).** Given a ``launch.mesh.Mesh`` of
  D x P ranks over ("data", "model") (each rank runs its own engine, with
  the same arguments and the same requests), the engine picks the rules
  (``dist.sharding.serve_rules_for``) and, over "model", the layout
  (``dist.tensor_parallel.plan``), keeps its rank's block of the raw
  weights (column-parallel wq/wk/wv and gate/up, row-parallel wo and
  down, the vocabulary cut, the routed experts cut on their expert dim,
  the recurrent mixers' projections as ``tensor_parallel`` lists;
  ``params`` whole or as those blocks), quantizes its blocks into the
  single-device codes (a row block's per-column scale from one
  all-reduce MAX), fuses them, and cuts the dense cache or the paged pool
  along KV heads, or the dense cache along its sequence when the KV heads
  do not divide P (decode then runs ``kernels.sharded_decode``); a
  recurrent state stays whole over "model". Over "data" a rank runs the
  device rows of its block of the slots (``tensor_parallel.slot_rows``:
  where ``cache_specs`` cuts the batch, every row where it falls back to
  whole), and of a prefill wave the rows whose requests take slots of
  its block (a row seated in another block than planned, after a row
  before it ended on its first token, moves its cache rows over the data
  group); after each wave and decode chunk the rows' tokens are gathered
  over the data group. The paged pool is whole on every data
  rank (``paged_cache_specs``), so a paged engine runs its rows whole
  there: every replica of the pool takes the same writes, and a prefix
  hit reads the same blocks on every rank. The adapters, the draft and
  its cache follow the target's layout and rows. Block tables, the pager
  and every host decision are whole on every rank, and the clock reads
  global rank 0's, so the ranks keep one schedule. Tokens and every
  counter equal the single-device engine's, sampled ones too: every rank
  draws the whole batch's numbers from one generator and a row takes its
  own (``decode.sample_tokens``' rows). A mesh of size 1 is the
  single-device engine.
"""


from __future__ import annotations

import contextlib
import dataclasses
import math
import time
from typing import Dict, List, Optional

import numpy as np
import torch

from repro_torch.core.axllm_linear import deploy_quantize
from repro_torch.core.quantization import (QuantConfig, derive_draft_params,
                                           quantize_tree)
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models.model import ATTENTION_FAMILIES, ModelAPI, get_model
from repro_torch.serve.adapters import AdapterRegistry, target_dims
from repro_torch.serve.decode import decode_steps, sample_tokens, verify_steps
from repro_torch.serve.paged_cache import TRASH_BLOCK, PagedKVCache
from repro_torch.serve.scheduler import WaitQueue, pick_victim, prefill_chunk
from repro_torch.serve.speculative import accept_length, round_k


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


def refuse_unservable(cfg) -> None:
    """Raise the JAX engine's error for a config it does not serve: an
    encoder-decoder model (the engine prefills tokens only; there is no
    frames ingress). The engine checks this before anything else, and
    the launcher before it makes any weights."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(
            "ServeEngine drives token-only prefill; encoder-decoder "
            "serving needs a frames ingress (future PR)")


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
    # speculative decoding (speculate=True): draft/verify round outcomes
    spec_rounds: int = 0              # engine-level draft + verify rounds
    spec_slot_rounds: int = 0         # sum over rounds of speculating slots
    drafted_tokens: int = 0           # draft proposals checked by the target
    accepted_draft_tokens: int = 0    # proposals the target agreed with
    spec_emitted_tokens: int = 0      # tokens appended by spec rounds

    @property
    def mean_occupancy(self) -> float:
        return self.occupancy_sum / self.steps if self.steps else 0.0

    @property
    def tokens_per_step(self) -> float:
        return self.decode_tokens / self.steps if self.steps else 0.0

    @property
    def acceptance_rate(self) -> float:
        """Fraction of draft proposals the target confirmed."""
        return (self.accepted_draft_tokens / self.drafted_tokens
                if self.drafted_tokens else 0.0)

    @property
    def accepted_tokens_per_step(self) -> float:
        """Tokens emitted per slot-round (one draft + verify round of one
        slot): at least 1 when rounds ran (each emits the target's own
        token), above 1 iff speculation accepted anything."""
        return (self.spec_emitted_tokens / self.spec_slot_rounds
                if self.spec_slot_rounds else 0.0)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["mean_occupancy"] = self.mean_occupancy
        d["tokens_per_step"] = self.tokens_per_step
        d["acceptance_rate"] = self.acceptance_rate
        d["accepted_tokens_per_step"] = self.accepted_tokens_per_step
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


def _leaves(tree, spec):
    """(tensor, batch axis) of every leaf of a cache ``tree`` and its
    ``spec`` (the same nesting of dicts and tuples, an int at each
    leaf), in the spec's order."""
    if isinstance(spec, dict):
        for k, sub in spec.items():
            yield from _leaves(tree[k], sub)
    elif isinstance(spec, tuple):
        for t, sub in zip(tree, spec):
            yield from _leaves(t, sub)
    else:
        yield tree, spec


def _leaf_keys(spec, key=""):
    """The dict key of every leaf of a cache ``spec``, in ``_leaves``'
    order."""
    if isinstance(spec, dict):
        for k, sub in spec.items():
            yield from _leaf_keys(sub, k)
    elif isinstance(spec, tuple):
        for sub in spec:
            yield from _leaf_keys(sub, key)
    else:
        yield key


def _shapes(tree):
    if isinstance(tree, dict):
        return {k: _shapes(v) for k, v in tree.items()}
    return tuple(tree.shape)


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
    ``fault_hook(phase)`` is called with "prefill" or "decode" (under
    speculation "draft" and "verify") right before each dispatch;
    ``prefill_budget`` (paged only, at least one block) caps the prompt
    tokens each ``step()`` prefills.

    ``speculate=True`` (greedy only) drafts up to ``spec_k`` tokens a round
    with a draft derived from the raw weights (``draft_bits``,
    ``draft_mode``: "affine", "codebook" or "shiftadd") and verifies them
    with the target (see the module docstring).

    ``mesh`` (a ``launch.mesh.Mesh``, one engine a rank) serves tensor
    parallel over its "model" axis (see the module docstring); every rank
    gets the same arguments and requests and gives the same tokens.

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
                 speculate: bool = False, spec_k: int = 4,
                 draft_bits: int = 4, draft_mode: str = "affine",
                 prefill_budget: Optional[int] = None, device="cuda"):
        refuse_unservable(cfg)
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
        self.api: ModelAPI = get_model(cfg, impl=impl)
        if paged and self.api.init_paged_cache is None:
            raise ValueError(
                f"family {cfg.family!r} has no paged KV cache path: "
                "recurrent/enc-dec state folding exposes no per-position "
                "KV to page — serve it with paged=False (attention "
                "families only)")
        if speculate:
            if not greedy:
                raise ValueError(
                    "speculate=True requires greedy=True: the accept rule "
                    "compares the target's deterministic argmax with the "
                    "draft's (sampled verification needs rejection "
                    "sampling, which this engine does not implement)")
            if cfg.family not in ATTENTION_FAMILIES:
                raise ValueError(
                    f"family {cfg.family!r} has no speculative path: "
                    "rollback needs position-addressable KV (truncate a "
                    "cursor / block table); recurrent state folding "
                    "cannot rewind k rejected positions (attention "
                    "families only)")
            if spec_k < 1:
                raise ValueError(f"spec_k must be >= 1, got {spec_k}")
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
        params = _params_to(params, self.device)
        qcfg = QuantConfig(
            bits=cfg.quant_bits if quant_bits is None else quant_bits,
            mode=quant_mode, granularity="per_channel") if quantize else None
        fuse = cfg.fuse_qkv if fuse_qkv is None else fuse_qkv
        self.speculate = speculate
        self.spec_k = spec_k
        self.draft_bits = draft_bits
        self.draft_mode = draft_mode
        self.mesh = mesh
        self.paged = paged
        self._rules = self._layout = self._rows = None
        if mesh is not None:
            self._rules, self._layout, whole = self.mesh_layout(
                cfg, mesh, params, n_slots=n_slots, max_len=max_len,
                paged=paged, quant=qcfg, speculate=speculate,
                draft_bits=draft_bits, draft_mode=draft_mode)
            if mesh.shape["data"] > 1:
                self._rows = tp.slot_rows(mesh, self._rules, n_slots,
                                          whole=paged)
        if self._layout is None:
            # the draft from the raw weights: a draft of quantized target
            # weights would compound two quantization errors
            draft = derive_draft_params(params, bits=draft_bits,
                                        mode=draft_mode) if speculate \
                else None
            if quantize:
                params = deploy_quantize(params, qcfg)
        else:
            params, draft = self._cut_params(params, whole, qcfg)
        if fuse:
            params = self.api.fuse_params(params)
            draft = draft if draft is None else self.api.fuse_params(draft)
        self.params = params
        self.draft_params = draft
        self.n_slots = n_slots
        self.max_len = max_len
        # always dense, even when the target pages: draft KV is private
        # scratch (never shared, published or swapped)
        self.draft_cache = self._new_cache(self._n_rows(n_slots), max_len) \
            if speculate else None
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
            if self._layout is not None:
                adapters.place(tp.layout_specs(
                    adapters.stacked, shd.adapter_specs(
                        adapters.stacked, mesh, self._rules), self._layout))
        # per-slot adapter row into registry.stacked; -1 = base only
        self.adapter_slots = np.full((n_slots,), -1, np.int32)
        # one generator on every rank: a sampled row draws the same number
        # whichever data rank runs it (``sample_tokens``' rows)
        self.rng = torch.Generator(device=self.device).manual_seed(seed)
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
                self.device if self._layout is None else "meta")
            if self._layout is not None:
                self.cache = tp.local_cache(self.cache, tp.cache_layout_specs(
                    self.cache, self._layout, paged=True), self.device)
            self._pool_leaves = [k for k, ax in
                                 self.api.paged_cache_spec.items() if ax == 1]
        else:
            self.pager = None
            self.cache = self._new_cache(self._n_rows(n_slots), max_len)
        self._validate_cache_spec()
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

    def _validate_cache_spec(self):
        """Every cache leaf must have its slots (paged pool leaves: its
        blocks) on the axis the family's spec names."""
        if self.paged:
            for name, ax in self.api.paged_cache_spec.items():
                want = self.num_blocks if ax == 1 else self.n_slots
                got = self.cache[name].shape[ax]
                if got != want:
                    raise ValueError(
                        f"paged_cache_spec says axis {ax} of {name!r} is "
                        f"the {'block' if ax == 1 else 'slot'} axis but "
                        f"shape {tuple(self.cache[name].shape)} has {got} "
                        f"!= {want} there")
            return
        rows = self._n_rows(self.n_slots)
        for leaf, ax in _leaves(self.cache, self.api.cache_spec):
            if leaf.shape[ax] != rows:
                raise ValueError(
                    f"cache_spec says batch axis {ax} but leaf shape "
                    f"{tuple(leaf.shape)} has {leaf.shape[ax]} != the "
                    f"{rows} slot rows this rank runs there")

    def _validate_adapters(self, reg: AdapterRegistry):
        """The family must take the LoRA kwargs, and the registry must be
        built for a config of the same dims, on the engine's device."""
        if not self.api.supports_lora:
            raise ValueError(
                f"family {self.cfg.family!r} has no multi-LoRA serving "
                "path: its recurrent state folding offers no per-slot "
                "projection hook for the delta pipeline (attention "
                "families only)")
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

    def _new_cache(self, batch: int, length: int, wave: bool = False):
        """A dense cache of ``batch`` rows (this rank's) and ``length``
        positions: this rank's block under a layout, its sequence cut only
        for the serving cache (a prefill wave keeps every position on every
        rank: each rank computes them all and ``_write_wave`` keeps its
        rows)."""
        if self._layout is None:
            return self.api.init_cache(batch, length, self.device)
        meta = self.api.init_cache(batch, length, "meta")
        return tp.local_cache(meta, tp.cache_layout_specs(
            meta, self._layout, paged=False, wave=wave), self.device)

    @staticmethod
    def mesh_layout(cfg, mesh, params, *, n_slots: int, max_len: int,
                    paged: bool, quant: Optional[QuantConfig] = None,
                    speculate: bool = False, draft_bits: int = 4,
                    draft_mode: str = "affine"):
        """(rules, layout, whole) of serving ``params`` (whole, or this
        rank's blocks) on ``mesh`` with these engine arguments
        (``quant``: the target's QuantConfig, None for dense): the serving
        rules, the tensor-parallel layout (None on a mesh of size 1) and
        the single-device tree (``tp.whole_like``). The launcher restores
        a checkpoint onto the blocks of the same layout."""
        rules = shd.serve_rules_for(mesh, cfg.n_kv_heads)
        if mesh.shape["model"] == 1:
            return rules, None, params
        whole = tp.whole_like(params, cfg, mesh, rules)
        trees = [whole if quant is None else quantize_tree(whole, quant)]
        if speculate:
            trees.append(quantize_tree(whole, QuantConfig(
                bits=draft_bits, mode=draft_mode))
                if draft_mode in ("affine", "codebook") else whole)
        return rules, tp.plan(cfg, mesh, rules, n_slots=n_slots,
                              max_len=max_len, paged=paged,
                              trees=trees), whole

    def _cut_params(self, params, whole, qcfg):
        """(target, draft) as this rank's blocks: the raw leaves cut (or
        taken as given), then quantized into the single-device codes
        (``tp.quantize_blocks``); the draft likewise, or, for a shiftadd
        draft, derived from the whole raw weights and cut (its column
        means span the rows a rank cuts)."""
        lay = self._layout
        specs = tp.layout_specs(whole, shd.param_specs(whole, lay.mesh,
                                                       lay.rules), lay)
        blocks = tp.shard_params(params, whole, specs)
        draft = None
        if self.speculate and self.draft_mode in ("affine", "codebook"):
            draft = tp.quantize_blocks(blocks, specs, QuantConfig(
                bits=self.draft_bits, mode=self.draft_mode))
        elif self.speculate:
            if _shapes(params) != _shapes(whole):
                raise ValueError("a shiftadd draft on a mesh is derived "
                                 "from the whole raw weights: give them "
                                 "whole")
            draft = tp.shard_params(derive_draft_params(
                params, bits=self.draft_bits, mode=self.draft_mode),
                whole, specs)
        if qcfg is not None:
            blocks = tp.quantize_blocks(blocks, specs, qcfg)
        return blocks, draft

    # -- rows over the "data" axis ---------------------------------------------
    def _n_rows(self, total: int) -> int:
        """The slot rows of ``total`` slots that this rank runs."""
        return total if self._rows is None else self._rows.n

    def _take(self, a):
        """This rank's rows of the slots' ``a``."""
        return a if self._rows is None else self._rows.take(a)

    def _gather(self, t: torch.Tensor, dim: int = 0):
        """Every slot row of a result this rank computed for its rows."""
        if self._rows is None:
            return t
        return tp.gather_rows(t, self._rows, dim)

    def _sampling_rows(self):
        """``sample_tokens``' rows for this rank's slot rows, or None."""
        if self._rows is None or not self._rows.cut:
            return None
        return self._rows.total, slice(self._rows.lo, self._rows.lo +
                                       self._rows.n)

    def _wave_mine(self, slots) -> Optional[np.ndarray]:
        """The rows of a prefill wave that this rank prefills, where a data
        axis cuts the slots: those whose request takes a slot of its block
        (``slots``, the slot of each row when every row is seated); None
        where this rank runs every row."""
        if self._rows is None or not self._rows.cut:
            return None
        lo, n = self._rows.lo, self._rows.n
        return np.array([i for i, s in enumerate(slots) if lo <= s < lo + n],
                        np.int64)

    def _seated_rows(self, wave_cache, mine, slots, src, dst):
        """The wave cache and its row of each seated pair (wave row ``src``
        -> slot ``dst``) for ``_write_wave``. A rank that ran every row has
        them all. On a data axis, a rank holds its rows (``mine``, planned
        on ``slots``); a row seated in another block than planned (a row
        before it ended on its first token and took no slot) moves: the
        moved rows alone are gathered over the data group and appended."""
        if mine is None:
            return wave_cache, src
        n, at = self._rows.n, {int(i): j for j, i in enumerate(mine)}
        moved = [i for i, d in zip(src, dst) if slots[i] // n != d // n]
        if moved:
            have = [j for j, i in enumerate(moved) if i in at]
            sel = torch.tensor([at[moved[j]] for j in have],
                               dtype=torch.long, device=self.device)

            def append(tree, spec):
                if isinstance(spec, dict):
                    return {k: append(tree[k], sub) for k, sub in spec.items()}
                if isinstance(spec, tuple):
                    return tuple(append(t, sub) for t, sub in zip(tree, spec))
                got = tp.gather_index(tree.index_select(spec, sel), have,
                                      len(moved), self.mesh, spec)
                return torch.cat([tree, got], spec)
            wave_cache = append(wave_cache, self.api.cache_spec)
        return wave_cache, [len(mine) + moved.index(i) if i in moved
                            else at.get(i, -1) for i in src]

    def _mesh_ctx(self):
        """The engine's (mesh, rules, layout) for the model code; nothing
        without a mesh."""
        if self.mesh is None:
            return contextlib.nullcontext()
        return shd.activate(self.mesh, self._rules, self._layout)

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
        """The clock; on a mesh of ranks, global rank 0's reading on every
        rank, so that every rank takes the same deadline decisions."""
        if self.mesh is None or self.mesh.size == 1:
            return self._clock()
        return tp.broadcast_host(self._clock(), self.mesh)

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
        if self.speculate:
            # the draft cache is not swapped out, so a fast restore would
            # resume on stale draft KV; the recompute path rebuilds the
            # target's and the draft's KV token-identically
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
        if self.api.ragged_prefill:
            groups = [pending]
        else:
            # a recurrent family folds every position into its state, so
            # it prefills equal-length sub-waves, one per admission length
            by_len = {}
            for r in pending:
                by_len.setdefault(len(self._admission_seq(r)), []).append(r)
            groups = list(by_len.values())
        t0 = time.perf_counter()
        gi = -1
        try:
            for gi, group in enumerate(groups):
                if self.paged:
                    self._prefill_group_paged(group, free)
                else:
                    self._prefill_group(group, free)
            if self.device.type == "cuda":
                torch.cuda.synchronize(self.device)
        except Exception:
            # the failing group requeued itself; the groups after it never
            # ran and requeue here, adapter pins intact
            for group in groups[gi + 1:]:
                for r in group:
                    self.queue.push_front(r)
            raise
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
        ragged = self.api.ragged_prefill
        if ragged:
            pl = _pow2_bucket(max(lens), min(8, self.max_len), self.max_len)
        else:
            pl = lens[0]                # an equal-length group, exact
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        aidx = np.full((wb,), -1, np.int32)
        for i, (r, seq) in enumerate(zip(group, seqs)):
            toks[i, :lens[i]] = seq
            lengths[i] = lens[i]
            aidx[i] = self._adapter_row(r)
        # on a data axis, this rank's rows: the requests seated in its
        # block of the slots (each row takes free[i] unless a row before it
        # ends on its first token)
        planned = free[:w]
        mine = self._wave_mine(planned)
        if mine is not None:
            toks, lengths_l, aidx_l = toks[mine], lengths[mine], aidx[mine]
        else:
            lengths_l, aidx_l = lengths, aidx
        kw = self._lora_kw(aidx_l)
        if ragged:
            kw["lengths"] = torch.from_numpy(lengths_l).to(self.device)
        wave_cache = self._new_cache(len(toks), pl, wave=True)
        logits = torch.zeros((0, self.cfg.padded_vocab), device=self.device)
        try:
            if self.fault_hook is not None:
                self.fault_hook("prefill")
            if len(toks):
                logits, wave_cache = self.api.prefill(
                    self.params,
                    {"tokens": torch.from_numpy(toks).to(self.device)},
                    wave_cache, **kw)
        except Exception:
            # nothing was changed yet: requeue the whole group, so no
            # request (or its adapter pin) is lost
            for r in group:
                self.queue.push_front(r)
            raise
        first = self._sample(logits, None if mine is None else (wb, mine))
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
            self._write_wave(self.cache, *self._seated_rows(
                wave_cache, mine, planned, src, dst), dst)
            if self.speculate:
                # the draft prefills the same wave (its logits are unused:
                # the first token is the target's), so seated slots start
                # each round with draft KV covering the target's positions
                dwave = self._new_cache(len(toks), pl, wave=True)
                if len(toks):
                    _, dwave = self.api.prefill(
                        self.draft_params,
                        {"tokens": torch.from_numpy(toks).to(self.device)},
                        dwave, **kw)
                self._write_wave(self.draft_cache, *self._seated_rows(
                    dwave, mine, planned, src, dst), dst)
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
        if self.speculate:
            self._draft_prefill_paged(admitted, slots_for, seqs)
        self.stats.prefill_waves += 1
        self.stats.blocks_in_use = pgr.blocks_in_use

    def _draft_prefill_paged(self, admitted, slots_for, seqs):
        """The draft's side of a paged admission wave. The draft cache is
        dense, so it cannot take the suffix-only paged prefill: the whole
        sequence of every request the wave seated prefills through the
        plain dense path (a prefix hit saves target work only; the draft
        is the cheap model). Runs after the target wave committed, so a
        request deferred or finished at prefill never gets here."""
        keep = [(i, slot) for i, (r, slot) in enumerate(zip(admitted,
                                                            slots_for))
                if self.slots[slot] is r]
        if not keep:
            return
        wb = _pow2_bucket(len(keep), 1, self.n_slots)
        pl = _pow2_bucket(max(len(seqs[i]) for i, _ in keep),
                          min(8, self.max_len), self.max_len)
        toks = np.zeros((wb, pl), np.int32)
        lengths = np.ones((wb,), np.int32)
        aidx = np.full((wb,), -1, np.int32)
        for j, (i, slot) in enumerate(keep):
            toks[j, :len(seqs[i])] = seqs[i]
            lengths[j] = len(seqs[i])
            aidx[j] = self.adapter_slots[slot]
        dev = self.device
        _, dwave = self.api.prefill(
            self.draft_params, {"tokens": torch.from_numpy(toks).to(dev)},
            self._new_cache(wb, pl, wave=True),
            lengths=torch.from_numpy(lengths).to(dev), **self._lora_kw(aidx))
        self._write_wave(self.draft_cache, dwave, list(range(len(keep))),
                         [slot for _, slot in keep])

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
        wave = self._new_cache(wb, pl, wave=True)
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

    def _write_wave(self, cache, wave_cache, src, dst):
        """Copy wave rows ``src`` into the slots ``dst`` of the dense
        ``cache`` (the target's or the draft's) on each leaf's declared
        batch axis (``api.cache_spec``, nested dicts and tuples). A KV
        leaf of the wave covers its padded length only, so only the wave's
        leading entries of each axis after the batch axis are written;
        slot entries past them are never read before decode overwrites
        them. A cache cut along its sequence over the ranks takes the
        wave's positions in this rank's rows; a cache of a block of the
        slots (a data axis) takes the slots in its block."""
        if self._rows is not None and self._rows.cut:
            lo, n = self._rows.lo, self._rows.n
            pairs = [(a, b - lo) for a, b in zip(src, dst)
                     if lo <= b < lo + n]
            if not pairs:
                return
            src, dst = [a for a, _ in pairs], [b for _, b in pairs]
        s = torch.tensor(src, device=self.device)
        d = torch.tensor(dst, device=self.device)
        spec = self.api.cache_spec
        for (full, ax), (one, _), key in zip(_leaves(cache, spec),
                                             _leaves(wave_cache, spec),
                                             _leaf_keys(spec)):
            one = one.index_select(ax, s)
            rows = [slice(0, n) for n in one.shape[ax + 1:]]
            if rows and self._layout is not None and self._layout.seq \
                    and key in ("k", "v", "k_scale", "v_scale"):
                lo = self._layout.rank * full.shape[ax + 1]
                n = max(0, min(full.shape[ax + 1], one.shape[ax + 1] - lo))
                rows[0] = slice(0, n)
                one = one.narrow(ax + 1, min(lo, one.shape[ax + 1]), n)
            idx = (slice(None),) * ax + (d,) + tuple(rows)
            full[idx] = one.to(full.dtype)

    # -- sampling and stopping ------------------------------------------------
    def _sample(self, logits, rows=None) -> np.ndarray:
        """The tokens of a wave's rows: from ``logits`` of every row, or of
        this rank's ``rows`` = (the wave's rows, their index) on a data
        axis, gathered over the data group."""
        toks = sample_tokens(
            logits, self.rng, greedy=self.greedy,
            vocab_size=self.cfg.vocab_size,
            rows=None if rows is None else (rows[0], torch.from_numpy(
                rows[1]).to(logits.device)))
        if rows is not None:
            toks = tp.gather_index(toks, rows[1], rows[0], self.mesh)
        elif self._rows is not None:    # rows whole: data rank 0's
            toks = tp.gather_rows(toks, tp.Rows(self.mesh, len(toks), 0,
                                                len(toks)))
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
        with torch.inference_mode(), self._mesh_ctx():
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
        if self.speculate:
            return self._spec_step(decode_active, max_n)
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
        lora = self._lora_kw(self._take(self.adapter_slots))

        def decode(p, t, c):
            return self.api.decode(p, t, c, **lora)

        def rows(a):
            return torch.from_numpy(self._take(a)).to(dev)

        out = decode_steps(
            decode, self.params, rows(last), self.cache, self.rng, rows(stop),
            rows(gen), rows(budget), n=n, vocab_size=self.cfg.vocab_size,
            max_len=self.max_len, eos_id=self.eos_id, greedy=self.greedy,
            rows=self._sampling_rows())
        self.cache = out.cache
        toks = self._gather(out.tokens, dim=1).cpu().numpy()
        valid = self._gather(out.valid.to(torch.int32),
                             dim=1).cpu().numpy().astype(bool)
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

    # -- speculative decode ---------------------------------------------------
    def _spec_fns(self):
        """The round's two halves over the slots' adapter rows: the draft's
        k+1 stop-free greedy steps (``decode_steps`` with no EOS, an
        unlimited budget and a position bound that cannot fire, so a
        retried round replays bit for bit; the (k+1)-th step puts draft KV
        at the same ``pos .. pos+k`` the verify pass writes) and the
        target's teacher-forced verify pass."""
        lora = self._lora_kw(self._take(self.adapter_slots))
        vocab = self.cfg.vocab_size
        b = self._n_rows(self.n_slots)

        def decode(p, t, c):
            return self.api.decode(p, t, c, **lora)

        def draft_fn(last, stop, k):
            zeros = torch.zeros((b,), dtype=torch.int32, device=self.device)
            return decode_steps(
                decode, self.draft_params, last, self.draft_cache, self.rng,
                stop, zeros, torch.full_like(zeros, 1 << 30), n=k + 1,
                vocab_size=vocab, max_len=self.max_len + 2, eos_id=None,
                greedy=True)

        def verify_fn(last, drafts):
            return verify_steps(decode, self.params, last, drafts, self.cache,
                                vocab_size=vocab)

        return draft_fn, verify_fn

    def _spec_step(self, active, max_n: Optional[int]) -> bool:
        """One speculative round over the active slots: the draft proposes
        k tokens, the target verifies them in one pass, each slot appends
        the longest agreeing prefix plus the target's correction token, and
        the KV written for rejected positions is rolled back (a cursor
        reset, or block truncation when paged). Every appended token is the
        target's own argmax, so the output equals target-only decode.

        Retry after a fault: both caches' cursors are set from the host at
        the top of every round and the draft steps are deterministic, so a
        round that faults at the "draft" or "verify" hook reruns the same,
        rewriting the positions a partial round wrote with the same
        values."""
        positions = {i: len(self.slots[i].prompt)
                     + len(self.slots[i].tokens) - 1 for i in active}

        def pick_k():
            return round_k(
                self.spec_k, max_len=self.max_len,
                positions=[positions[i] for i in active],
                budgets=[self.slots[i].max_new - len(self.slots[i].tokens)
                         for i in active],
                max_n=max_n)

        k = pick_k()
        dev = self.device
        if self.paged:
            # plan -> commit over the whole k+1 verify window, preempting
            # while it cannot fit (one slot always fits: k is clamped to
            # its own room)
            while len(active) > 1:
                need = 0
                for i in active:
                    a, c = self.pager.plan_decode(i, positions[i], k + 1)
                    need += a + c
                if self.pager.can_allocate(need):
                    break
                self._preempt_slot(pick_victim(self.slots))
                active = self._decoding()
                k = pick_k()
            cow = []
            for i in active:
                cow += self.pager.prepare_decode(i, positions[i], k + 1)
            if cow:
                self._copy_blocks(cow)
                self.stats.cow_copies += len(cow)
            self.cache["block_tables"] = torch.from_numpy(
                self.pager.tables.copy()).to(dev)
            self.stats.blocks_in_use = self.pager.blocks_in_use
        # both cursors from the host: the dense rollback is this reset (the
        # last round's verify pass left the cursor at pos + k + 1; the stale
        # tail is dead weight the next window overwrites)
        pos_host = np.zeros((self.n_slots,), np.int32)
        last = np.zeros((self.n_slots,), np.int32)
        stop = np.ones((self.n_slots,), bool)
        for i in active:
            pos_host[i] = positions[i]
            last[i] = self.slots[i].tokens[-1]
            stop[i] = False
        pos_host, last, stop = (self._take(a) for a in (pos_host, last, stop))
        self.cache["pos"] = torch.from_numpy(pos_host).to(dev)
        self.draft_cache["pos"] = torch.from_numpy(pos_host.copy()).to(dev)
        last_dev = torch.from_numpy(last).to(dev)
        draft_fn, verify_fn = self._spec_fns()
        if k:
            if self.fault_hook is not None:
                self.fault_hook("draft")
            dout = draft_fn(last_dev, torch.from_numpy(stop).to(dev), k)
            self.draft_cache = dout.cache
            drafts_dev = dout.tokens[:k]
            drafts = self._gather(drafts_dev, dim=1).cpu().numpy()
        else:
            drafts_dev = torch.zeros((0, len(last)), dtype=torch.int32,
                                     device=dev)
            drafts = np.zeros((0, self.n_slots), np.int32)
        if self.fault_hook is not None:
            self.fault_hook("verify")
        targets_dev, self.cache = verify_fn(last_dev, drafts_dev)
        targets = self._gather(targets_dev, dim=1).cpu().numpy()   # [k+1, B]
        now = self._now()
        emitted = 0
        for i in active:
            r = self.slots[i]
            m = accept_length(drafts[:, i], targets[:, i])
            got = 0
            reason = None
            for t in range(m + 1):
                # a stop is re-derived per appended token: an EOS, budget or
                # cache-full inside the acceptance drops the rest
                r.tokens.append(int(targets[t, i]))
                got += 1
                reason = self._stop_reason(r)
                if reason is not None:
                    break
            r.t_last = now
            emitted += got
            self.stats.spec_slot_rounds += 1
            self.stats.drafted_tokens += k
            # of the kept tokens all but a final correction (or bonus) token
            # were draft proposals
            self.stats.accepted_draft_tokens += min(got, m)
            if self.paged:
                # rollback: keep exactly the KV the kept tokens stand on
                # (prompt ++ tokens[:-1]); whole tail blocks written for
                # rejected positions go back to the pool
                self.pager.truncate(i, positions[i] + got)
            want_cancel = self._emit(r, now)
            if reason is None and want_cancel:
                reason = "cancelled"
            if reason is not None:
                if self.paged:
                    if r.adapter is None:
                        self.pager.insert(self._kv_seq(r),
                                          self.pager.slot_blocks(i))
                    self.pager.release_slot(i)
                self._finish(r, reason)
                self.slots[i] = None
                self.adapter_slots[i] = -1
        self.stats.spec_rounds += 1
        self.stats.spec_emitted_tokens += emitted
        self.stats.decode_tokens += emitted
        self.stats.steps += k + 1                  # target decode steps
        self.stats.decode_chunks += 2 if k else 1  # dispatches this round
        self.stats.occupancy_sum += (k + 1) * len(active) / self.n_slots
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
