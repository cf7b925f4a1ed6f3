"""Per-channel absmax quantization: wrapper of the CUDA kernel
``csrc/quantize.cu``, and the plan of its launch.

Replaces the TPU kernel ``quantize_pallas``
(``src/repro/kernels/quantize.py:33``). Its plain version is
:func:`repro_torch.kernels.ref.quantize_ref`, which the kernel matches bit
for bit, NaN and inf columns included.

The kernel is bound by the bytes of the weights it reads. A cluster of
blocks owns a strip of columns of one matrix (a work item), each block a
contiguous slice of its rows: a block loads its slice into shared memory
once (16-byte cp.async where N allows), the cluster exchanges the
column maxima through distributed shared memory, and each block rounds
its own slice, so each weight is read from HBM once (the "held" route).
The clusters that fit on the card walk the items in turn, loading the
next item while they reduce one and round the one before. Where a
cluster cannot hold a strip's K, the blocks stream their slices twice
(the "streamed" route). :func:`quantize_plan` picks the strip, the
cluster size, the rows of a split, the route and the access width from
the shapes alone, once per shape.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Tuple

import torch

from repro_torch.kernels import _build, ref

THREADS = 256               # threads a block (csrc/quantize.cu kThreads)
RING = 3                    # chunk slots of the streamed route (kRing)
HELD_SLOTS = 3              # held slices a block keeps (kHeldSlots)
STASH_BYTES = 32 * 1024     # a held slice at most (a block holds three)
CHUNK_BYTES = 16 * 1024     # a streamed chunk, about
MIN_SPLIT_ROWS = 64         # K is not cut into shorter splits
BLOCKS_PER_SM = 1           # work blocks the plan aims for, per SM
PORTABLE_CLUSTER = 8        # larger clusters need the non-portable opt-in
STRIP_BYTES = (128, 64)     # a strip row's bytes, widest first


@dataclasses.dataclass(frozen=True)
class QuantizePlan:
    """How a launch cuts a stack of ``batch`` matrices [k, n]: ``strips``
    strips of ``strip`` columns, each owned by a cluster of ``cluster``
    blocks, block r of a cluster owning rows [r rows, (r + 1) rows) of
    the strip, walked in chunks of ``chunk_rows`` rows (on the held
    route one chunk holds the whole slice). A thread reads ``vec``
    weights and stores ``vec`` codes an access; a block takes ``smem``
    bytes of dynamic shared memory, the one place its layout is sized:
    the kernel traps if it does not fit."""
    batch: int
    k: int
    n: int
    elem: int
    strip: int
    strips: int
    cluster: int
    rows: int
    chunk_rows: int
    vec: int
    smem: int

    @property
    def held(self) -> bool:
        return self.chunk_rows >= self.rows

    @property
    def route(self) -> str:
        return "held" if self.held else "streamed"

    @property
    def blocks(self) -> int:
        """Block slices of work: the launch runs them on the clusters that
        fit on the card at once, in turn."""
        return self.batch * self.strips * self.cluster

    @property
    def piece(self) -> int:
        """Bytes of one global load of w (16 where N allows)."""
        return min(16, self.vec * self.elem)

    def k_ranges(self):
        """[(k0, k1)] of each split of a strip."""
        return [(r * self.rows, min(self.k, (r + 1) * self.rows))
                for r in range(self.cluster)]

    def describe(self) -> str:
        return (f"{self.route}: "
                f"{self.strips} strips of {self.strip} x cluster "
                f"{self.cluster} of {self.rows} rows = {self.blocks} slices, "
                f"{self.vec}-column accesses, {self.smem} B shared")


def _smem(strip: int, vec: int, chunk_rows: int, slots: int,
          elem: int) -> int:
    """Dynamic shared memory of a block: the chunk slots, then the partial
    maxima, the block's column maxima, scales and reciprocals of two
    items (f32 rows of the strip), as ``csrc/quantize.cu`` lays them
    out."""
    g = strip // vec
    partial_rows = THREADS // g if g >= 32 else THREADS // 32
    return (slots * chunk_rows * strip * elem
            + (partial_rows + 6) * strip * 4)


def _plan(batch: int, k: int, n: int, elem: int, strip: int, cluster: int,
          vec: int, chunk_rows: int = 0) -> QuantizePlan:
    """Held (one chunk, the slice) unless ``chunk_rows`` is given."""
    rows = -(-k // cluster)
    chunk_rows = chunk_rows or rows
    held = chunk_rows >= rows
    return QuantizePlan(
        batch=batch, k=k, n=n, elem=elem, strip=strip,
        strips=-(-n // strip), cluster=cluster, rows=rows,
        chunk_rows=chunk_rows, vec=vec,
        smem=_smem(strip, vec, chunk_rows, HELD_SLOTS if held else RING,
                   elem))


@functools.lru_cache(maxsize=None)
def quantize_plan(batch: int, k: int, n: int, dtype: torch.dtype,
                  sms: int = 132, align: int = 16) -> QuantizePlan:
    """The launch plan for ``batch`` matrices [k, n] of ``dtype`` (float32
    or bfloat16) on a card of ``sms`` SMs, w's base address a multiple of
    ``align`` bytes. A function of shapes only; cached per shape.

    - Access width ``vec``: the widest of 16, 8, 4, 2, 1 columns that
      divides n (and whose load piece divides ``align``), so every access
      of a row of w and of codes is aligned and a group of ``vec``
      columns is wholly inside or outside the matrix.
    - Held route: the strip (128-byte rows, then 64-byte rows) and the
      cluster size (1, 2, 4, 8 blocks, each split at least
      ``MIN_SPLIT_ROWS`` rows) whose block slice fits ``STASH_BYTES``
      and whose items give ``BLOCKS_PER_SM`` blocks an SM; widest strip
      and fewest blocks a cluster first (fewer, larger items: each item
      pays a cluster barrier). Failing that, the held plan with the most
      blocks, portable clusters before clusters of 16.
    - Streamed route, where no cluster holds a strip's K: the narrower
      strip and the largest cluster K allows (up to 16), chunks of about
      ``CHUNK_BYTES`` in a ring of ``RING`` slots.
    """
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {dtype}")
    if batch < 1 or k < 1 or n < 1:
        raise ValueError(f"no plan for {batch} x [{k}, {n}]")
    elem = 2 if dtype == torch.bfloat16 else 4
    vec = next(v for v in (16, 8, 4, 2, 1)
               if n % v == 0 and align % min(16, v * elem) == 0)
    max_split = max(1, k // MIN_SPLIT_ROWS)
    clusters = [c for c in (1, 2, 4, 8, 16) if c <= max_split]
    options = [_plan(batch, k, n, elem, sb // elem, c, vec)
               for sb in STRIP_BYTES for c in clusters]
    held = [p for p in options
            if p.chunk_rows * p.strip * elem <= STASH_BYTES]
    portable = [p for p in held if p.cluster <= PORTABLE_CLUSTER]
    for p in portable:
        if p.blocks >= BLOCKS_PER_SM * sms:
            return p
    if portable or held:
        return max(portable or held, key=lambda p: p.blocks)
    strip = STRIP_BYTES[-1] // elem
    cluster = clusters[-1]
    chunk = CHUNK_BYTES // (strip * elem)
    return _plan(batch, k, n, elem, strip, cluster, vec, chunk)


def _align(ptr: int) -> int:
    return 16 if ptr % 16 == 0 else ptr & -ptr


def quantize_cuda(w: torch.Tensor, bits: int = 8
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(codes int8 [..., K, N], scale f32 [..., 1, N]) of w [..., K, N]
    f32/bf16, reducing over K. Leading dims are flattened into one launch.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if w.device.type == "cpu":
        return ref.quantize_ref(w, bits)
    if w.ndim < 2:
        raise ValueError(f"w must be [..., K, N], got {tuple(w.shape)}")
    if w.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"w must be float32 or bfloat16, got {w.dtype}")
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8] (int8 codes), got {bits}")
    *lead, k, n = w.shape
    if k == 0:
        raise ValueError("w has no rows to take the channel maximum over")
    w = w.contiguous()
    codes = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    scale = torch.empty((*lead, 1, n), dtype=torch.float32, device=w.device)
    if scale.numel() == 0:
        return codes, scale
    plan = quantize_plan(scale.numel() // n, k, n, w.dtype,
                         _build.sm_count(w.device), _align(w.data_ptr()))
    _build.launch(
        "quantize", w.data_ptr(), int(w.dtype == torch.bfloat16),
        codes.data_ptr(), scale.data_ptr(), plan.batch, k, n, bits,
        plan.strip, plan.cluster, plan.rows, plan.chunk_rows, plan.vec,
        plan.smem,
        torch.cuda.current_stream(w.device).cuda_stream)
    return codes, scale
