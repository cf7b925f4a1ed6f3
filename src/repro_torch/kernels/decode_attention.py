"""One-token decode attention: wrapper of the CUDA kernel
``csrc/decode_attention.cu``.

Replaces the TPU kernel ``decode_attention_pallas``
(``src/repro/kernels/decode_attention.py:71``). Its plain version is
:func:`repro_torch.kernels.ref.decode_attention_ref`. On an H100 it is
bound by the bytes of the valid KV prefix; the kernel reads only that
prefix, once per GQA group, and clamps each row's length to the cache.
It splits each row's keys across blocks (:func:`split_plan`, from shapes
alone: the wrapper never reads a length back from the card) and merges
the splits in the same launch; :func:`ref.decode_attention_split_ref`
computes what it does, split by split.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
MAX_REP = 8          # query heads a block holds in registers (a group)
SPLIT_KEYS = 64      # a split's length is a multiple of this many keys
BLOCKS_PER_SM = 2    # the split grid aims at this many blocks per SM
TABLE = 256          # block-table entries a paged block stages
                     # (csrc/decode_attention_body.cuh kDecodeTable)


def head_groups(h: int, hk: int) -> tuple:
    """(n_grp, gs): the ``h // hk`` query heads of a KV head split into
    ``n_grp`` groups of at most ``MAX_REP``, ``gs`` heads each (the last
    may hold fewer); a block of the decode kernels serves one group, and
    every group's blocks read the same KV rows
    (``csrc/decode_attention_body.cuh`` decode_groups)."""
    rep = h // hk
    n_grp = -(-rep // MAX_REP)
    return n_grp, -(-rep // n_grp)


def plan_rows(b: int, h: int, hk: int) -> int:
    """The ``rows`` of :func:`split_plan`: (row, KV head, query-head
    group) triples, one block each per split."""
    return b * hk * head_groups(h, hk)[0]


def split_plan(limit: int, rows: int, sms: int, bs=None) -> tuple:
    """(n_split, split_len) of the split-KV decode kernels for ``rows`` =
    :func:`plan_rows` (row, KV head, query-head group) triples over up to
    ``limit`` keys (S, or MB * bs paged with ``bs``-key blocks) on a card
    of ``sms`` SMs: about ``BLOCKS_PER_SM`` blocks per SM, each split a
    multiple of ``SPLIT_KEYS`` keys (and, paged, at most ``TABLE - 1``
    blocks).
    Splits cover every position: n_split * split_len >= limit. A function
    of shapes only, so the launch needs no host sync."""
    want = max(1, -(-BLOCKS_PER_SM * sms // rows))
    split_len = -(-limit // want)
    split_len = -(-split_len // SPLIT_KEYS) * SPLIT_KEYS
    if bs is not None:
        split_len = min(split_len, max(
            SPLIT_KEYS, (TABLE - 1) * bs // SPLIT_KEYS * SPLIT_KEYS))
    return -(-limit // split_len), split_len


_SPLITS: dict = {}


def split_buffers(q: torch.Tensor, limit: int, rows: int, stream: int,
                  bs=None) -> tuple:
    """(n_split, split_len, partials, counters) of a split launch of ``q``
    [B, H, d] over ``rows`` = :func:`plan_rows` triples and up to ``limit``
    keys (``bs``-key blocks if paged): the plan of :func:`split_plan`, an
    f32 scratch for every split's partial (``gs`` heads a row), and
    ``rows`` int32 arrival counters at 0 (a launch leaves them at 0);
    None, None for one split. Made once per (device, stream, shapes) and
    kept: launches on one stream run in order, so each reuses them, and a
    decode step, bound by the host, pays one dict lookup. Serving has one
    decode shape per engine."""
    key = (q.device, stream, tuple(q.shape), limit, rows, bs)
    hit = _SPLITS.get(key)
    if hit is None:
        n_split, split_len = split_plan(limit, rows,
                                        _build.sm_count(q.device), bs)
        part = counters = None
        if n_split > 1:
            b, h, d = q.shape
            gs = -(-h // (rows // b))     # the heads of a group
            part = torch.empty(rows * n_split * gs * (d + 1),
                               dtype=torch.float32, device=q.device)
            counters = torch.zeros(rows, dtype=torch.int32, device=q.device)
        hit = _SPLITS[key] = (n_split, split_len, part, counters)
    return hit


def _ptr(t) -> Optional[int]:
    return None if t is None else t.data_ptr()


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
    if d not in HEAD_DIMS or h % hk:
        raise ValueError(f"unsupported head layout H={h}, Hk={hk}, d={d}: "
                         f"the decode kernels take head dims {HEAD_DIMS} "
                         f"and H a multiple of Hk")
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    n_split, split_len, part, counters = split_buffers(
        q, s, plan_rows(b, h, hk), stream)
    _build.launch(
        "decode_attention", q.data_ptr(), k_cache.data_ptr(),
        v_cache.data_ptr(), _ptr(k_scale), _ptr(v_scale), length.data_ptr(),
        out.data_ptr(), _ptr(part), _ptr(counters), b, s, h, hk, d,
        int(q.dtype == torch.bfloat16), int(quantized), n_split, split_len,
        1.0 / (d ** 0.5), stream)
    return out
