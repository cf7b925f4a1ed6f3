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


def _check(q, k_cache, v_cache, length, k_scale, v_scale) -> None:
    if q.ndim != 3 or k_cache.ndim != 4:
        raise ValueError(f"q must be [B, H, d] and caches [B, S, Hk, d], got "
                         f"{tuple(q.shape)} and {tuple(k_cache.shape)}")
    b, h, d = q.shape
    _, s, hk, _ = k_cache.shape
    if k_cache.shape != (b, s, hk, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"cache shapes {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)} do not match q "
                         f"{tuple(q.shape)}")
    if d not in HEAD_DIMS or h % hk or h // hk > MAX_REP:
        raise ValueError(f"unsupported head layout H={h}, Hk={hk}, d={d}")
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"q must be float32 or bfloat16, got {q.dtype}")
    quantized = k_scale is not None
    if quantized != (v_scale is not None):
        raise ValueError("give both k_scale and v_scale or neither")
    kv_dtype = torch.int8 if quantized else q.dtype
    if k_cache.dtype != kv_dtype or v_cache.dtype != kv_dtype:
        raise TypeError(f"caches must be {kv_dtype}, got {k_cache.dtype}")
    tensors = [("q", q), ("k_cache", k_cache), ("v_cache", v_cache),
               ("length", length)]
    if quantized:
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.shape != (b, s, hk, 1) or sc.dtype != torch.float32:
                raise ValueError(f"{name} must be float32 [B, S, Hk, 1]")
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
    _check(q, k_cache, v_cache, length, k_scale, v_scale)
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
