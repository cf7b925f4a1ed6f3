"""Per-channel absmax quantization: wrapper of the CUDA kernel
``csrc/quantize.cu``.

Replaces the TPU kernel ``quantize_pallas``
(``src/repro/kernels/quantize.py:33``). Its plain version is
:func:`repro_torch.kernels.ref.quantize_ref`, which the kernel matches bit
for bit. The kernel is bound by the bytes of the weights it reads; the
source says what its design does about that.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import _build, ref


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
    batch = scale.numel() // n
    _build.launch(
        "quantize", w.data_ptr(), int(w.dtype == torch.bfloat16),
        codes.data_ptr(), scale.data_ptr(), batch, k, n, bits,
        torch.cuda.current_stream(w.device).cuda_stream)
    return codes, scale
