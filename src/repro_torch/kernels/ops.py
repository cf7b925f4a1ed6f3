"""Public kernel entry points: a hand-written CUDA kernel on the card, the
plain PyTorch version elsewhere.

Every op takes ``impl`` in {"auto", "cuda", "ref", "reuse", "reuse_ref"}:
  auto      -> the CUDA kernel for a CUDA tensor, the plain version for a
               CPU one
  cuda      -> the CUDA kernel; raises for a tensor that is not on the card
  ref       -> the plain version (``kernels/ref.py``) on any device
  reuse     -> the quantized matmul runs the reuse (LUT) kernel, the
               Result Cache on device (its plain version on the CPU)
  reuse_ref -> the reuse kernel's plain version on any device
Attention ops treat "reuse" as "auto" and "reuse_ref" as "ref": the reuse
mode changes how quantized weights are multiplied, not how attention
dispatches. The JAX package's "reuse_interpret" and "pallas_interpret"
run a Pallas body in Python; the port has no interpret mode and raises
``ValueError`` for them.

``prefix_attention`` runs its plain version on every device: the JAX
package has no Pallas kernel for it to port. There is no block-size
table here: each CUDA kernel picks its own tiles and masks its own ragged
edges.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.kernels import ref as _ref
from repro_torch.kernels.axllm_matmul import axllm_matmul_cuda
from repro_torch.kernels.decode_attention import decode_attention_cuda
from repro_torch.kernels.flash_attention import (FlashAttentionFn,
                                                 flash_attention_cuda)
from repro_torch.kernels.paged_decode_attention import \
    paged_decode_attention_cuda
from repro_torch.kernels.quantize import quantize_cuda
from repro_torch.kernels.reuse_matmul import reuse_matmul_cuda, segment

IMPLS = ("auto", "cuda", "ref", "reuse", "reuse_ref")
REUSE_IMPLS = ("reuse", "reuse_ref")


def _base_impl(impl: str) -> str:
    """What non-matmul ops see: "reuse" -> "auto", "reuse_ref" -> "ref"."""
    return {"reuse": "auto", "reuse_ref": "ref"}.get(impl, impl)


def _use_kernel(impl: str, x: torch.Tensor) -> bool:
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r} (the "
                         "port has no interpret mode)")
    impl = _base_impl(impl)
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
    ``out_dtype`` (default x's), accumulated in f32. ``impl`` in
    ``REUSE_IMPLS`` routes through :func:`reuse_matmul`."""
    if impl in REUSE_IMPLS:
        return reuse_matmul(x, qt, impl=impl, out_dtype=out_dtype)[0]
    out_dtype = out_dtype or x.dtype
    kdim, n = qt.shape[-2], qt.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim)
    if _use_kernel(impl, x):   # the kernel writes out_dtype itself
        y = axllm_matmul_cuda(x2.contiguous(), qt, out_dtype)
    else:
        y = _ref.axllm_matmul_ref(x2, qt, out_dtype)
    return y.reshape(*lead, n)


def reuse_matmul(x: torch.Tensor, qt: QTensor, *, impl: str = "auto",
                 out_dtype=None, with_stats: bool = False
                 ) -> Tuple[torch.Tensor, Optional[object]]:
    """Reuse (LUT) matmul: ``(y, mults)`` = x @ deq(qt), gathering cached
    alphabet products instead of multiplying every code (paper §III.b).

    x: [..., K]; qt: [K, N]; ``y`` is [..., N]. ``mults`` is the multiply
    count per activation row: the distinct alphabet cells per (k-row,
    segment) summed, what a Result Cache executes for one input row
    against the baseline's K*N. The segment is
    ``kernels.reuse_matmul.segment(N)`` (256 at every full-width N). It is
    an int32 scalar tensor counted by the kernel on the card and a host
    int on the plain path; ``with_stats=False`` (the serving default)
    returns None and the kernel skips the count.

    impl: "auto"/"reuse"/"cuda" -> the kernel for a CUDA tensor;
    "ref"/"reuse_ref" -> the plain versions.
    """
    out_dtype = out_dtype or x.dtype
    kdim, n = qt.shape[-2], qt.shape[-1]
    lead = x.shape[:-1]
    x2 = x.reshape(-1, kdim)
    if _use_kernel(impl, x):   # the kernel writes out_dtype itself
        y, mults = reuse_matmul_cuda(x2.contiguous(), qt, with_stats,
                                     out_dtype)
    else:
        y = _ref.reuse_matmul_ref(x2, qt, out_dtype)
        mults = _ref.reuse_mult_count(qt, segment(n)) if with_stats else None
    return y.reshape(*lead, n), mults


def lora_matmul(x: torch.Tensor, qt: QTensor, a: torch.Tensor,
                b: torch.Tensor, scaling: float, *, impl: str = "auto",
                out_dtype=None) -> torch.Tensor:
    """y = x @ deq(qt) + scaling * (x @ A) @ B (paper Fig. 5 combined path).

    The base product goes through :func:`axllm_matmul` (the kernel on the
    card) with an f32 output; the low-rank delta is a plain f32 product,
    as in the JAX package, which computes it outside any Pallas kernel."""
    out_dtype = out_dtype or x.dtype
    base = axllm_matmul(x, qt, impl=impl, out_dtype=torch.float32)
    xa = torch.matmul(x.to(torch.float32), a.to(torch.float32))
    delta = torch.matmul(xa, b.to(torch.float32))
    return (base + scaling * delta).to(out_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def flash_attention(q, k, v, *, causal: bool = True,
                    impl: str = "auto") -> torch.Tensor:
    """q: [B, Sq, H, d]; k, v: [B, Sk, Hk, d] -> [B, Sq, H, d].

    On the card, a call that autograd records (grad enabled and an input
    requiring grad: training) goes through :class:`FlashAttentionFn`,
    whose backward is a kernel too; any other call (serving runs under
    ``torch.inference_mode()``) launches the forward kernel alone, without
    the Function's host cost. The plain versions are differentiated by
    autograd."""
    if _use_kernel(impl, q):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            return FlashAttentionFn.apply(q, k, v, causal)
        return flash_attention_cuda(q, k, v, causal=causal)
    # memory-safe plain version once the [B, H, Sq, Sk] scores grow large
    if q.shape[1] * k.shape[1] > 1024 * 1024:
        return _ref.chunked_attention_ref(q, k, v, causal=causal)
    return _ref.attention_ref(q, k, v, causal=causal)


def decode_attention(q, k_cache, v_cache, length, *, k_scale=None,
                     v_scale=None, block_tables=None,
                     impl: str = "auto") -> torch.Tensor:
    """q: [B, H, d]; caches [B, S, Hk, d] (int8 if scales given); length
    [B] int32, clamped to S by the kernel (and masked by the plain
    version).

    With ``block_tables`` ([B, MB] int32) the caches are a shared paged
    pool [NB, bs, Hk, d] instead: each row's logical sequence is the
    concatenation of its table's blocks, read through the table by the
    paged kernel, and the length is clamped to MB * bs.
    """
    if block_tables is not None:
        if _use_kernel(impl, q):
            return paged_decode_attention_cuda(
                q.contiguous(), k_cache, v_cache, block_tables, length,
                k_scale=k_scale, v_scale=v_scale)
        return _ref.paged_decode_attention_ref(
            q, k_cache, v_cache, block_tables, length, k_scale=k_scale,
            v_scale=v_scale)
    if _use_kernel(impl, q):
        return decode_attention_cuda(q.contiguous(), k_cache, v_cache,
                                     length, k_scale=k_scale, v_scale=v_scale)
    return _ref.decode_attention_ref(q, k_cache, v_cache, length,
                                     k_scale=k_scale, v_scale=v_scale)


def prefix_attention(q, k_prefix, v_prefix, prefix_len, k_suffix, v_suffix,
                     *, impl: str = "auto") -> torch.Tensor:
    """Suffix-prefill attention against a cached (right-padded) prefix.

    q/k_suffix/v_suffix: [B, S, H|Hk, d]; k/v_prefix: [B, P, Hk, d] with
    per-row valid lengths ``prefix_len`` [B]. The plain version runs on
    every device: the JAX package has no Pallas kernel for it, so there is
    none to port, and ``impl="cuda"`` raises instead of running it.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "cuda":
        raise NotImplementedError(
            "prefix_attention has no CUDA kernel: the JAX package has no "
            "Pallas kernel for it to port; use impl='auto'")
    return _ref.prefix_attention_ref(q, k_prefix, v_prefix, prefix_len,
                                     k_suffix, v_suffix)


# ---------------------------------------------------------------------------
# Per-channel quantization
# ---------------------------------------------------------------------------

def quantize_channels(w: torch.Tensor, *, bits: int = 8,
                      impl: str = "auto"):
    """Per-channel absmax quantization: (codes int8 [..., K, N], scale f32
    [..., 1, N]) of w [..., K, N] f32/bf16, reducing over K.

    This entry point is the only caller of the quantization kernel: no
    serve path calls it. Deploy-time weight quantization goes through
    ``core.quantization.quantize`` and the serve-time KV quantizer is
    ``models.attention._quantize_kv``, both plain PyTorch.
    """
    if _use_kernel(impl, w):
        return quantize_cuda(w, bits)
    return _ref.quantize_ref(w, bits)
