"""Fused AxLLM dequant-matmul: wrapper of the CUDA kernel
``csrc/axllm_matmul.cu``.

Replaces the TPU kernel ``axllm_matmul_pallas``
(``src/repro/kernels/axllm_matmul.py:104``). Its plain version is
:func:`repro_torch.kernels.ref.axllm_matmul_ref`. On an H100 the decode
call (M = n_slots) is bound by the bytes of the int8 codes and the prefill
call by its operations. :func:`tensor_core_path` picks, before the launch,
the library's tensor-core kernel (``csrc/quant_gemm_sm90.cuh``, counted
also under ``LAUNCHES["axllm_matmul.wgmma"]``) for the prefill calls it
can take and the SIMT kernel for the rest; the source says what each
design does about its bound.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, resolve_codebook
from repro_torch.kernels import _build, ref

TC_MIN_M = 64     # rows from which the tensor-core path is the faster
TC_BK = 64        # its K tile (csrc/quant_gemm_sm90.cuh kBK)


def tensor_core_path(m: int, dtype: torch.dtype, qt: QTensor) -> bool:
    """Whether an [m, K] @ qt call takes the tensor-core (wgmma) kernel of
    ``csrc/quant_gemm_sm90.cuh``, shared by this kernel and
    ``reuse_matmul``: bf16 activations, an affine alphabet (exact in
    bf16), one scale row or groups of a multiple of ``TC_BK`` rows, M at
    least ``TC_MIN_M``, and rows that TMA can address (K a multiple of 8,
    N of 16, of 32 when packed). Everything else keeps its SIMT kernel:
    f32 activations, codebooks, decode M and odd group sizes."""
    k, n = qt.shape[-2], qt.shape[-1]
    return (dtype == torch.bfloat16 and qt.mode == "affine"
            and m >= TC_MIN_M and k % 8 == 0
            and n % (32 if qt.packed else 16) == 0
            and (qt.granularity != "per_group" or qt.group_size % TC_BK == 0))


def out_buffer(x2: torch.Tensor, n: int, out_dtype, tensor_cores: bool):
    """The [M, n] output the kernel writes: the caller's dtype where the
    tensor-core kernel can write it (f32 or bf16), else f32."""
    dtype = out_dtype if tensor_cores and out_dtype in (
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
    kernel that :func:`tensor_core_path` picks, or raises.
    """
    if x2.device.type == "cpu":
        return ref.axllm_matmul_ref(x2, qt, out_dtype)
    check_operands(x2, qt)
    return launch(x2, qt, out_dtype,
                  tensor_core_path(x2.shape[0], x2.dtype, qt)
                  and x2.data_ptr() % 16 == 0)


def launch(x2: torch.Tensor, qt: QTensor, out_dtype,
           tensor_cores: bool) -> torch.Tensor:
    """Launch the tensor-core or the SIMT kernel on checked operands."""
    k, n = qt.shape
    m = x2.shape[0]
    y = out_buffer(x2, n, out_dtype, tensor_cores)
    if m == 0:
        return y.to(out_dtype)
    scale = qt.kernel_scale
    stream = torch.cuda.current_stream(x2.device).cuda_stream
    if tensor_cores:
        _build.launch(
            "axllm_matmul.wgmma", x2.data_ptr(), qt.codes.data_ptr(),
            scale.data_ptr(), y.data_ptr(), m, k, n, int(qt.packed),
            scale.shape[0], int(y.dtype == torch.bfloat16), stream)
        return y.to(out_dtype)
    cb = resolve_codebook(qt)
    _build.launch(
        "axllm_matmul", x2.data_ptr(), int(x2.dtype == torch.bfloat16),
        qt.codes.data_ptr(), scale.data_ptr(),
        None if cb is None else cb.data_ptr(), y.data_ptr(), m, k, n,
        int(qt.packed), 0 if cb is None else cb.numel(), scale.shape[0],
        stream)
    return y.to(out_dtype)
