"""Reuse (LUT) matmul, the paper's Result Cache on device: wrapper of the
CUDA kernel ``csrc/reuse_matmul.cu``.

Replaces the TPU kernel ``reuse_matmul_pallas``
(``src/repro/kernels/reuse_matmul.py:115``). Its plain version is
:func:`repro_torch.kernels.ref.reuse_matmul_ref` for ``y`` and
:func:`repro_torch.kernels.ref.reuse_mult_count` for the multiply count.
The kernel builds a product table of every activation with the code
alphabet (``core.reuse.rc_alphabet``) in shared memory and gathers from it
once per code. :func:`~repro_torch.kernels.axllm_matmul.matmul_path` picks
the library's kernel before the launch: at decode (M <= 16) the split-K
table kernel (counted also under ``LAUNCHES["reuse_matmul.gemv"]``; its
plan, scratch and counters as ``axllm_matmul.gemv_buffers`` keeps them),
which writes the caller's dtype in one launch; for the prefill calls that
:func:`~repro_torch.kernels.axllm_matmul.tensor_core_path` accepts (bf16
activations at M >= 17, every alphabet) the library's tensor-core kernel
(``csrc/quant_gemm_sm90.cuh``, counted also under
``LAUNCHES["reuse_matmul.wgmma"]``) runs the same association instead:
for an affine alphabet ``sign(c) * levels[|c|] == c``, and a codebook
level (NF4, identity-8) is the exact sum of three bf16 terms, so the group
sums of ``x * level`` scaled after each sum are the table kernel's, and
the multiplies run on the tensor cores rather than being skipped; it
writes the caller's f32 or bf16. The table kernel over all of K takes the
rest (f32 activations above M = 16, odd group sizes). The count stays the
Result Cache's on every path. The source says what bounds each path and
what its design does about that.

The count depends on the column segment it is taken over. The segment is
fixed here by the JAX rule for the reuse branch of ``pick_blocks``: the
largest power of two <= 256 that divides N (256 at every full-width
repro-100m projection), so the kernel's count equals the JAX kernel's.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.core.reuse import rc_alphabet
from repro_torch.kernels import _build, ref
from repro_torch.kernels.axllm_matmul import (_ptr, check_operands,
                                              gemv_buffers, matmul_path,
                                              out_buffer, tc_alphabet)


def segment(n: int) -> int:
    """Counting segment for N columns: the largest power of two <= 256
    dividing N, else N (``ops.pick_blocks``'s reuse rule in the JAX
    package)."""
    for b in (256, 128, 64, 32, 16, 8):
        if b <= n and n % b == 0:
            return b
    return n


@functools.lru_cache(maxsize=None)
def _alphabet_on(bits: int, mode: str, device: str):
    # one constant alphabet per (bits, mode, device), copied to the card
    # once: the decode loop reads it for every projection
    levels, fold = rc_alphabet(bits, mode)
    return torch.from_numpy(levels).to(device), fold


def reuse_matmul_cuda(x2: torch.Tensor, qt: QTensor, with_stats: bool = False,
                      out_dtype=torch.float32
                      ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """(y[M, N], mults) = reuse matmul of x2[M, K] and a 2-D QTensor, y in
    ``out_dtype`` (the sums run in f32).

    ``mults`` is the multiply count per activation row (an int32 scalar
    tensor on the card, counted by the kernel) when ``with_stats``, else
    None. A CPU tensor takes the plain versions; a CUDA tensor launches the
    kernel that ``matmul_path`` picks, or raises.
    """
    if x2.device.type == "cpu":
        y = ref.reuse_matmul_ref(x2, qt, out_dtype)
        return y, (ref.reuse_mult_count(qt, segment(qt.shape[1]))
                   if with_stats else None)
    check_operands(x2, qt, "reuse_matmul")
    if qt.shape[1] % 8:
        raise ValueError(f"the kernel counts over power-of-two segments: N "
                         f"must be a multiple of 8, got {qt.shape[1]}")
    return launch(x2, qt, with_stats, out_dtype, matmul_path(
        x2.shape[0], x2.dtype, qt, x2.data_ptr() % 16 == 0))


def launch(x2: torch.Tensor, qt: QTensor, with_stats: bool, out_dtype,
           path: str) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Launch the kernel of ``path`` ("wgmma", "gemv" or "tile": the
    product table over all of K) on checked operands."""
    k, n = qt.shape
    m = x2.shape[0]
    levels, fold = _alphabet_on(qt.bits, qt.mode, str(x2.device))
    scale = qt.kernel_scale
    y = out_buffer(x2, n, out_dtype, path)
    mults = (torch.zeros((), dtype=torch.int32, device=x2.device)
             if with_stats else None)
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    out_bf16 = int(y.dtype == torch.bfloat16)
    x_bf16 = int(x2.dtype == torch.bfloat16)
    if path == "wgmma":
        _build.launch(
            "reuse_matmul.wgmma", x2.data_ptr(), qt.codes.data_ptr(),
            scale.data_ptr(), levels.data_ptr(), y.data_ptr(), _ptr(mults),
            m, k, n, int(qt.packed), levels.numel(), int(fold),
            *tc_alphabet(qt), scale.shape[0], segment(n), out_bf16, stream)
        return y, mults
    if path == "gemv":
        plan, part, counters = gemv_buffers(x2, qt, stream, reuse=True)
        _build.launch(
            "reuse_matmul.gemv", x2.data_ptr(), x_bf16, qt.codes.data_ptr(),
            scale.data_ptr(), levels.data_ptr(), y.data_ptr(), out_bf16,
            _ptr(part), _ptr(counters), _ptr(mults), m, k, n, int(qt.packed),
            levels.numel(), int(fold), scale.shape[0], segment(n), plan.mt,
            plan.k_per_split, plan.splits, stream)
        return (y if y.dtype == out_dtype else y.to(out_dtype)), mults
    _build.launch(
        "reuse_matmul", x2.data_ptr(), x_bf16, qt.codes.data_ptr(),
        scale.data_ptr(), levels.data_ptr(), y.data_ptr(), _ptr(mults), m, k,
        n, int(qt.packed), levels.numel(), int(fold), scale.shape[0],
        segment(n), stream)
    return y.to(out_dtype), mults
