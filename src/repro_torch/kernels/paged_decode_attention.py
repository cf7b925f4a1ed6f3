"""One-token decode attention through a block-paged KV pool: wrapper of the
CUDA kernel ``csrc/paged_decode_attention.cu``.

Replaces the TPU kernel ``paged_decode_attention_pallas``
(``src/repro/kernels/paged_decode_attention.py:81``). Its plain version is
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`. On an H100 it
is bound by the bytes of the valid KV entries; the kernel reads them once
per GQA group, through the block table, and clamps each row's length to
its table (``MB * bs``). Its body is the dense kernel's, split-KV
(:func:`repro_torch.kernels.decode_attention.split_plan`); its split
arithmetic is :func:`ref.paged_decode_attention_split_ref`.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref
from repro_torch.kernels.decode_attention import (_ptr, check_operands,
                                                  plan_rows, split_buffers)


def paged_decode_attention_cuda(q: torch.Tensor, k_pool: torch.Tensor,
                                v_pool: torch.Tensor,
                                block_tables: torch.Tensor,
                                length: torch.Tensor,
                                k_scale: Optional[torch.Tensor] = None,
                                v_scale: Optional[torch.Tensor] = None
                                ) -> torch.Tensor:
    """q: [B, H, d]; pools: [NB, bs, Hk, d]; block_tables: [B, MB];
    length: [B] -> [B, H, d].

    A CPU tensor takes the plain version; a CUDA tensor launches the
    kernel or raises.
    """
    if q.device.type == "cpu":
        return ref.paged_decode_attention_ref(
            q, k_pool, v_pool, block_tables, length, k_scale=k_scale,
            v_scale=v_scale)
    check_operands(q, k_pool, v_pool, length, k_scale, v_scale,
                   ("k_pool", "v_pool"), [("block_tables", block_tables)])
    if (block_tables.ndim != 2 or block_tables.shape[0] != q.shape[0]
            or block_tables.dtype != torch.int32):
        raise ValueError("block_tables must be int32 [B, MB]")
    b, h, d = q.shape
    nb, bs, hk, _ = k_pool.shape
    mb = block_tables.shape[1]
    out = torch.empty_like(q)
    quantized = k_scale is not None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, split_len, part, counters = split_buffers(
        q, mb * bs, plan_rows(b, h, hk), stream, bs)
    _build.launch(
        "paged_decode_attention", q.data_ptr(), k_pool.data_ptr(),
        v_pool.data_ptr(), _ptr(k_scale), _ptr(v_scale),
        block_tables.data_ptr(), length.data_ptr(), out.data_ptr(),
        _ptr(part), _ptr(counters), b, h, hk, d, nb, bs, mb,
        int(q.dtype == torch.bfloat16), int(quantized), n_split, split_len,
        1.0 / (d ** 0.5), stream)
    return out
