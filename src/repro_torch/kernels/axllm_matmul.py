"""Fused AxLLM dequant-matmul: wrapper of the CUDA kernel
``csrc/axllm_matmul.cu``.

Replaces the TPU kernel ``axllm_matmul_pallas``
(``src/repro/kernels/axllm_matmul.py:104``). Its plain version is
:func:`repro_torch.kernels.ref.axllm_matmul_ref`. On an H100 the decode
call (M = n_slots) is bound by the bytes of the int8 codes and the prefill
call by its operations; the source says what the kernel's design does
about each.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, resolve_codebook
from repro_torch.kernels import _build, ref


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


def axllm_matmul_cuda(x2: torch.Tensor, qt: QTensor) -> torch.Tensor:
    """y[M, N] f32 = x2[M, K] @ deq(qt) for a 2-D QTensor.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if x2.device.type == "cpu":
        return ref.axllm_matmul_ref(x2, qt)
    check_operands(x2, qt)
    k, n = qt.shape
    m = x2.shape[0]
    y = torch.empty((m, n), dtype=torch.float32, device=x2.device)
    if m == 0:
        return y
    scale = qt.kernel_scale
    cb = resolve_codebook(qt)
    _build.launch(
        "axllm_matmul", x2.data_ptr(), int(x2.dtype == torch.bfloat16),
        qt.codes.data_ptr(), scale.data_ptr(),
        None if cb is None else cb.data_ptr(), y.data_ptr(), m, k, n,
        int(qt.packed), 0 if cb is None else cb.numel(), scale.shape[0],
        torch.cuda.current_stream(x2.device).cuda_stream)
    return y
