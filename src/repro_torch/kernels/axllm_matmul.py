"""Fused AxLLM dequant-matmul: wrapper of the CUDA kernel
``csrc/axllm_matmul.cu``.

Replaces the TPU kernel ``axllm_matmul_pallas``
(``src/repro/kernels/axllm_matmul.py:104``). Its plain version is
:func:`repro_torch.kernels.ref.axllm_matmul_ref`. On an H100 the decode
call (M = n_slots) is bound by the bytes of the int8 codes and the prefill
call by its operations. :func:`matmul_path` picks, before the launch, one
of the library's three kernels: the tensor-core kernel
(``csrc/quant_gemm_sm90.cuh``, counted also under
``LAUNCHES["axllm_matmul.wgmma"]``) for the prefill calls it can take, the
split-K decode kernel (``csrc/quant_gemv.cuh``, under
``LAUNCHES["axllm_matmul.gemv"]``) for M <= ``GEMV_MAX_M``, and the SIMT
tile kernel for the rest. The decode kernel's plan (:func:`gemv_plan`,
from shapes alone) and its scratch and counters are made once per
(device, stream, shape); :func:`ref.quant_gemv_split_ref` computes what
it does, split by split. The source says what each design does about
its bound.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantization import QTensor, resolve_codebook
from repro_torch.kernels import _build, ref

GEMV_MAX_M = 16   # rows the split-K decode kernels take, at most
# rows from which the tensor-core path is the faster: above the decode
# kernels' M it beats the tile kernels at every M (chip_smoke.py's sweep)
TC_MIN_M = GEMV_MAX_M + 1
TC_BK = 64        # its K tile (csrc/quant_gemm_sm90.cuh kBK)
GEMV_BN = 32      # the decode kernel's columns per block (csrc kGemvBN)
REUSE_GEMV_BN = 256   # the reuse decode kernel's (csrc kBN)
GEMV_SPLITS = 64  # K splits a plan aims at, at most
GEMV_MERGE = 16   # splits the reuse plan takes before it shrinks its M tile
REUSE_GEMV_MT = 4  # the reuse decode kernel's M tile, at most: one 16-byte
                   # table read a code (8 rows: two, and 1.5x the time)
GEMV_SMEM = 96 * 1024  # shared bytes of a split's codes and x, at most


def tensor_core_path(m: int, dtype: torch.dtype, qt: QTensor) -> bool:
    """Whether an [m, K] @ qt call takes the tensor-core (wgmma) kernel of
    ``csrc/quant_gemm_sm90.cuh``, shared by this kernel and
    ``reuse_matmul``: bf16 activations, an affine alphabet (exact in
    bf16), one scale row or groups of a multiple of ``TC_BK`` rows, M at
    least ``TC_MIN_M``, and rows that TMA can address (K a multiple of 8,
    N of 16, of 32 when packed). Everything else keeps a CUDA-core kernel:
    f32 activations, codebooks, decode M and odd group sizes."""
    k, n = qt.shape[-2], qt.shape[-1]
    return (dtype == torch.bfloat16 and qt.mode == "affine"
            and m >= TC_MIN_M and k % 8 == 0
            and n % (32 if qt.packed else 16) == 0
            and (qt.granularity != "per_group" or qt.group_size % TC_BK == 0))


def gemv_path(m: int, qt: QTensor) -> bool:
    """Whether an [m, K] @ qt call takes a split-K decode kernel
    (``axllm_matmul.gemv``, ``reuse_matmul.gemv``): 1 <= m <=
    ``GEMV_MAX_M``, any alphabet and x dtype, and codes that 16-byte
    vectors can read (a 16-byte aligned base, N a multiple of 16, of 32
    when packed)."""
    n = qt.shape[-1]
    return (1 <= m <= GEMV_MAX_M and n % (32 if qt.packed else 16) == 0
            and qt.codes.data_ptr() % 16 == 0)


def matmul_path(m: int, dtype: torch.dtype, qt: QTensor,
                x_aligned: bool = True) -> str:
    """The kernel an [m, K] @ qt call of both quantized matmuls takes,
    chosen before the launch by shape, type and alignment: "wgmma" (the
    tensor cores, :func:`tensor_core_path`, x 16-byte aligned), "gemv"
    (:func:`gemv_path`) or "tile" (the SIMT kernel of ``axllm_matmul``,
    the product-table kernel over all of K of ``reuse_matmul``)."""
    if tensor_core_path(m, dtype, qt) and x_aligned:
        return "wgmma"
    return "gemv" if gemv_path(m, qt) else "tile"


@dataclasses.dataclass(frozen=True)
class GemvPlan:
    """How a decode kernel cuts [K, N]: ``n_tiles`` column tiles of ``bn``
    times ``m_tiles`` M tiles of ``mt`` rows times ``splits`` K splits of
    ``k_per_split`` rows (the last may be shorter). A split never
    straddles a scale group of ``group_rows``: it holds whole groups, or
    lies inside one and leaves its sum for the merge to scale
    (``defer``)."""
    k: int
    bn: int
    n_tiles: int
    mt: int
    m_tiles: int
    splits: int
    k_per_split: int
    group_rows: int

    @property
    def blocks(self) -> int:
        return self.n_tiles * self.m_tiles * self.splits

    @property
    def defer(self) -> bool:
        return self.k_per_split < self.group_rows

    def k_ranges(self):
        """[(k0, k1)] of each split, in merge order."""
        return [(z * self.k_per_split,
                 min(self.k, (z + 1) * self.k_per_split))
                for z in range(self.splits)]


def gemv_plan(m: int, k: int, n: int, group_rows: int, sms: int, *,
              reuse: bool = False, packed: bool = False) -> GemvPlan:
    """The decode kernels' plan for an [m, k] @ [k, n] call with scale
    groups of ``group_rows`` rows (k for one scale row) on a card of
    ``sms`` SMs. Column tiles of ``GEMV_BN`` (the reuse kernel's
    ``REUSE_GEMV_BN``, a multiple of every counting segment), and K split
    into near-equal splits so that the card gets at least one block per
    SM, at most ``GEMV_SPLITS`` splits. The reuse kernel's M tile is the
    power of two >= m up to ``REUSE_GEMV_MT``, halved while its
    256-column tiles would need more than ``GEMV_MERGE`` splits to fill
    the card, and its split count (a block builds tables and gathers,
    so SMs that run two blocks take twice as long) the one of up to twice
    that many that spreads its blocks most evenly over the SMs; the axllm
    kernel's M tile is 8 rows up to m = 8, else 16. A
    split's codes and x fit ``GEMV_SMEM``. A function of shapes only, so
    a launch needs no host sync."""
    if not 1 <= m <= GEMV_MAX_M or k < 1 or n < 1 or k % group_rows:
        raise ValueError(f"no decode plan for M{m} K{k} N{n} with groups "
                         f"of {group_rows}")
    bn = REUSE_GEMV_BN if reuse else GEMV_BN
    n_tiles = -(-n // bn)
    if reuse:
        mt = min(REUSE_GEMV_MT, 1 << (m - 1).bit_length())
        while mt > 1 and n_tiles * -(-m // mt) * GEMV_MERGE < sms:
            mt //= 2
    else:
        mt = 8 if m <= 8 else 16
    m_tiles = -(-m // mt)
    tiles = n_tiles * m_tiles
    want = min(GEMV_SPLITS, -(-sms // tiles))
    if reuse:   # heavy blocks: the count in [want, 2 want] that loads the
        # SMs most evenly (fewest waves of ``sms`` blocks per split)
        want = min(range(want, min(2 * want, GEMV_SPLITS) + 1),
                   key=lambda s: -(-tiles * s // sms) / s)
    row_bytes = bn // 2 if packed else bn
    cap = max(1, GEMV_SMEM // (row_bytes + 4 * mt))
    ks = max(1, min(cap, -(-k // want)))
    if group_rows < k:       # no split straddles a group boundary
        if ks >= group_rows:
            ks -= ks % group_rows
        else:
            ks = max(d for d in range(1, ks + 1) if group_rows % d == 0)
    splits = -(-k // ks)
    return GemvPlan(k=k, bn=bn, n_tiles=n_tiles, mt=mt, m_tiles=m_tiles,
                    splits=splits, k_per_split=k if splits == 1 else ks,
                    group_rows=group_rows)


_GEMV: dict = {}


def gemv_buffers(x2: torch.Tensor, qt: QTensor, stream: int,
                 reuse: bool = False) -> tuple:
    """(plan, partials, counters) of a decode launch of x2 @ qt: the plan
    of :func:`gemv_plan`, an f32 scratch for every split's partial tile and
    an int32 arrival counter per output tile at 0 (a launch leaves them at
    0); None, None for one split. Made once per (device, stream, shape)
    and kept: launches on one stream run in order, so each reuses them, a
    call pays one dict lookup and allocates no workspace."""
    m, (k, n) = x2.shape[0], qt.shape
    g_rows = k // qt.kernel_scale.shape[0]
    key = (x2.device, stream, m, k, n, g_rows, qt.packed, reuse)
    hit = _GEMV.get(key)
    if hit is None:
        plan = gemv_plan(m, k, n, g_rows, _build.sm_count(x2.device),
                         reuse=reuse, packed=qt.packed)
        part = counters = None
        if plan.splits > 1:
            tiles = plan.n_tiles * plan.m_tiles
            part = torch.empty(tiles * plan.splits * plan.mt * plan.bn,
                               dtype=torch.float32, device=x2.device)
            counters = torch.zeros(tiles, dtype=torch.int32,
                                   device=x2.device)
        hit = _GEMV[key] = (plan, part, counters)
    return hit


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def out_buffer(x2: torch.Tensor, n: int, out_dtype, path: str):
    """The [M, n] output the kernel of ``path`` writes: the caller's dtype
    where the kernel can write it (the tensor-core and decode kernels: f32
    or bf16), else f32."""
    dtype = out_dtype if path != "tile" and out_dtype in (
        torch.float32, torch.bfloat16) else torch.float32
    return torch.empty((x2.shape[0], n), dtype=dtype, device=x2.device)


def check_operands(x2: torch.Tensor, qt: QTensor,
                   kernel: str = "axllm_matmul") -> None:
    """Checks shared by the two quantized-matmul kernels (this one and
    ``reuse_matmul``): x2 [M, K] f32/bf16 and one [K, N] QTensor, all
    contiguous on x2's device."""
    if len(qt.shape) != 2:
        raise ValueError(f"{kernel} takes one [K, N] weight, got logical "
                         f"shape {qt.shape}")
    k, n = qt.shape
    if x2.ndim != 2 or x2.shape[1] != k:
        raise ValueError(f"x must be [M, {k}], got {tuple(x2.shape)}")
    if x2.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x2.dtype}")
    want = (torch.uint8, (k, n // 2)) if qt.packed else (torch.int8, (k, n))
    if (qt.codes.dtype, tuple(qt.codes.shape)) != want:
        raise ValueError(f"codes must be {want}, got "
                         f"{(qt.codes.dtype, tuple(qt.codes.shape))}")
    if qt.packed and n % 2:
        raise ValueError("packed int4 codes need an even N")
    for name, t in (("x", x2), ("codes", qt.codes),
                    ("kernel_scale", qt.kernel_scale)):
        if t.device != x2.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {x2.device}")


def axllm_matmul_cuda(x2: torch.Tensor, qt: QTensor,
                      out_dtype=torch.float32) -> torch.Tensor:
    """y[M, N] = x2[M, K] @ deq(qt) for a 2-D QTensor, in ``out_dtype``
    (the sums run in f32).

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel that :func:`matmul_path` picks, or raises.
    """
    if x2.device.type == "cpu":
        return ref.axllm_matmul_ref(x2, qt, out_dtype)
    check_operands(x2, qt)
    return launch(x2, qt, out_dtype, matmul_path(
        x2.shape[0], x2.dtype, qt, x2.data_ptr() % 16 == 0))


def launch(x2: torch.Tensor, qt: QTensor, out_dtype,
           path: str) -> torch.Tensor:
    """Launch the kernel of ``path`` ("wgmma", "gemv" or "tile") on
    checked operands."""
    k, n = qt.shape
    m = x2.shape[0]
    y = out_buffer(x2, n, out_dtype, path)
    if m == 0:
        return y.to(out_dtype)
    scale = qt.kernel_scale
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    out_bf16 = int(y.dtype == torch.bfloat16)
    if path == "wgmma":
        _build.launch(
            "axllm_matmul.wgmma", x2.data_ptr(), qt.codes.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, k, n, int(qt.packed),
            scale.shape[0], out_bf16, stream)
        return y
    cb = resolve_codebook(qt)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    if path == "gemv":
        plan, part, counters = gemv_buffers(x2, qt, stream)
        _build.launch(
            "axllm_matmul.gemv", x2.data_ptr(), x_bf16, qt.codes.data_ptr(),
            scale.data_ptr(), _ptr(cb), y.data_ptr(), out_bf16, _ptr(part),
            _ptr(counters), m, k, n, int(qt.packed),
            0 if cb is None else cb.numel(), scale.shape[0],
            plan.k_per_split, plan.splits, stream)
        return y if y.dtype == out_dtype else y.to(out_dtype)
    _build.launch(
        "axllm_matmul", x2.data_ptr(), x_bf16, qt.codes.data_ptr(),
        scale.data_ptr(), _ptr(cb), y.data_ptr(), m, k, n, int(qt.packed),
        0 if cb is None else cb.numel(), scale.shape[0], stream)
    return y.to(out_dtype)
