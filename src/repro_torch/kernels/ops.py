"""Public kernel entry points: a hand-written CUDA kernel on the card, the
plain PyTorch version elsewhere.

Every op takes ``impl`` in {"auto", "cuda", "ref"}:
  auto -> the CUDA kernel for a CUDA tensor, the plain version for a CPU one
  cuda -> the CUDA kernel; raises for a tensor that is not on the card
  ref  -> the plain version (``kernels/ref.py``) on any device

The JAX package's reuse impls, paged decode (``block_tables=``), prefix
attention and the KV quantization kernel are not ported yet and raise
``NotImplementedError`` naming their ROADMAP item. There is no block-size
table here: each CUDA kernel picks its own tiles and masks its own ragged
edges.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import flash_attention_cuda

IMPLS = ("auto", "cuda", "ref")
REUSE_IMPLS = ("reuse", "reuse_interpret", "reuse_ref")


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl in REUSE_IMPLS:
        raise NotImplementedError(
            f"impl={impl!r}: the reuse (LUT) matmul is not ported yet "
            "(ROADMAP queue 1 item 6, queue 2 item 4)")
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda" and not x.is_cuda:
        raise ValueError(f"impl='cuda' needs tensors on the card, got one on "
                         f"{x.device}")
    return impl == "cuda" or (impl == "auto" and x.is_cuda)


# ---------------------------------------------------------------------------
# AxLLM quantized matmul
# ---------------------------------------------------------------------------

def axllm_matmul(x: torch.Tensor, qt: QTensor, *, impl: str = "auto",
                 out_dtype=None) -> torch.Tensor:
    """y = x @ deq(qt). x: [..., K]; qt: [K, N]. Returns [..., N] in
    ``out_dtype`` (default x's), accumulated in f32."""
    out_dtype = out_dtype or x.dtype
    kdim, n = qt.shape[-2], qt.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim)
    if _use_kernel(impl, x):
        y = axllm_matmul_cuda(x2.contiguous(), qt)
    else:
        y = _ref.axllm_matmul_ref(x2, qt)
    return y.reshape(*lead, n).to(out_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    impl: str = "auto") -> torch.Tensor:
    """q: [B, Sq, H, d]; k, v: [B, Sk, Hk, d] -> [B, Sq, H, d]."""
    if _use_kernel(impl, q):
        return flash_attention_cuda(q.contiguous(), k.contiguous(),
                                    v.contiguous(), causal=causal)
    # memory-safe plain version once the [B, H, Sq, Sk] scores grow large
    if q.shape[1] * k.shape[1] > 1024 * 1024:
        return _ref.chunked_attention_ref(q, k, v, causal=causal)
    return _ref.attention_ref(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, length, *, k_scale=None,
                     v_scale=None, block_tables=None,
                     impl: str = "auto") -> torch.Tensor:
    """q: [B, H, d]; caches [B, S, Hk, d] (int8 if scales given); length
    [B] int32, clamped to S by the kernel (and masked by the plain
    version)."""
    if block_tables is not None:
        raise NotImplementedError(
            "paged decode attention (block_tables=) is not ported yet "
            "(ROADMAP queue 1 item 7, queue 2 item 5)")
    if _use_kernel(impl, q):
        return decode_attention_cuda(q.contiguous(), k_cache, v_cache,
                                     length, k_scale=k_scale, v_scale=v_scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, length,
                                     k_scale=k_scale, v_scale=v_scale)


def prefix_attention(*args, **kwargs):
    raise NotImplementedError(
        "prefix attention (suffix-only prefill against a cached prefix) is "
        "not ported yet (ROADMAP queue 1 item 7)")


def quantize_channels(*args, **kwargs):
    raise NotImplementedError(
        "the per-channel quantization kernel is not ported yet "
        "(ROADMAP queue 2 item 6)")
