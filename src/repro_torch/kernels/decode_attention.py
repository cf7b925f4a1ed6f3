"""One-token decode attention: wrapper of the CUDA kernel
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention.py:71``). Its plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`. On an H100 it is
bound by the bytes of the valid KV prefix; the kernel reads only that
prefix, once per GQA group, and clamps each row's length to the cache.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (32, 64, 128)
MAX_REP = 8          # query heads per KV head the kernel holds in registers


def check_operands(q, k, v, length, k_scale, v_scale, names, extra=()):
    """Checks shared by the dense and the paged decode kernels: q [B, H, d]
    f32/bf16; ``k``/``v`` (named ``names``) [X, Y, Hk, d] in q's type, or
    int8 with f32 scales [X, Y, Hk, 1]; length int32 [B]; these and the
    ``extra`` (name, tensor) pairs contiguous on q's device."""
    if q.ndim != 3 or k.ndim != 4:
        raise ValueError(f"q must be [B, H, d] and {names[0]} [., ., Hk, d], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, h, d = q.shape
    hk = k.shape[2]
    if k.shape[3] != d or v.shape != k.shape:
        raise ValueError(f"{names[0]}/{names[1]} shapes {tuple(k.shape)}, "
                         f"{tuple(v.shape)} do not match q {tuple(q.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_REP:
        raise ValueError(f"unsupported head layout H={h}, Hk={hk}, d={d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("give both k_scale and v_scale or neither")
    kv_dtype = torch.int8 if quantized else q.dtype
    if k.dtype != kv_dtype or v.dtype != kv_dtype:
        raise TypeError(f"{names[0]}/{names[1]} must be {kv_dtype}, got "
                        f"{k.dtype}")
    tensors = [("q", q), (names[0], k), (names[1], v), ("length", length),
               *extra]
    if quantized:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.shape != (*k.shape[:3], 1) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 "
                                 f"{[*k.shape[:3], 1]}")
            tensors.append((name, sc))
    if length.shape != (b,) or length.dtype != torch.int32:
        raise ValueError("length must be int32 [B]")
    for name, t in tensors:
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def decode_attention_cuda(q: torch.Tensor, k_cache: torch.Tensor,
                          v_cache: torch.Tensor, length: torch.Tensor,
                          k_scale: Optional[torch.Tensor] = None,
                          v_scale: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
    """q: [B, H, d]; caches: [B, S, Hk, d]; length: [B] -> [B, H, d].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return ref.decode_attention_ref(q, k_cache, v_cache, length,
                                        k_scale=k_scale, v_scale=v_scale)
    check_operands(q, k_cache, v_cache, length, k_scale, v_scale,
                   ("k_cache", "v_cache"))
    if k_cache.shape[0] != q.shape[0]:
        raise ValueError(f"caches have {k_cache.shape[0]} rows, q has "
                         f"{q.shape[0]}")
    b, h, d = q.shape
    _, s, hk, _ = k_cache.shape
    out = torch.empty_like(q)
    quantized = k_scale is not None
    _build.launch(
        "decode_attention", q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), k_scale.data_ptr() if quantized else None,
        v_scale.data_ptr() if quantized else None, length.data_ptr(),
        out.data_ptr(), b, s, h, hk, d, int(q.dtype == torch.bfloat16),
        int(quantized), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    return out
