"""Causal or non-causal GQA flash attention: wrapper of the CUDA kernel
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:81``). Its plain version is
:func:`repro_torch.kernels.ref.attention_ref`. On an H100, at the prefill
wave's shapes, it is bound by its operations; the kernel skips key tiles
above the causal diagonal and masks ragged edges itself.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)


def _check(q, k, v) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be [B, Sq, H, d] and k/v [B, Sk, Hk, d], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    if k.shape != (b, sk, hk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    if sq > sk or d not in HEAD_DIMS or h % hk or b * h > 65535:
        raise ValueError(f"unsupported attention shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}")
    if q.dtype not in (torch.float32, torch.bfloat16) or \
            k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def flash_attention_cuda(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         causal: bool = True) -> torch.Tensor:
    """q: [B, Sq, H, d]; k, v: [B, Sk, Hk, d] -> [B, Sq, H, d].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    _check(q, k, v)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    _build.launch(
        "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, hk, d, int(q.dtype == torch.bfloat16),
        int(causal), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
