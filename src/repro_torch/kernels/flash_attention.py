"""Causal or non-causal GQA flash attention: wrapper of the CUDA kernels
``csrc/flash_attention.cu``.

Replaces the TPU kernel ``flash_attention_pallas``
(``src/repro/kernels/flash_attention.py:81``). Its plain version is
:func:`repro_torch.kernels.ref.attention_ref`. :func:`tensor_core_path`
picks, before the launch, the library's tensor-core kernel (TMA + wgmma,
counted also under ``LAUNCHES["flash_attention.wgmma"]``) for bf16 at
head dim 64 or 128, whose arithmetic :func:`ref.flash_attention_tc_ref`
emulates (P rounded to bf16 before P V), and the SIMT kernel for the
rest (f32, head dims 16 and 32); the source says what each design does
about its bound.

Its gradient: :class:`FlashAttentionFn` runs that forward and, as its
backward, :func:`flash_attention_bwd_cuda`, the kernel of
``csrc/flash_attention_bwd.cu`` (counted under
``LAUNCHES["flash_attention_bwd"]``), whose plain version is
:func:`ref.flash_attention_bwd_ref`. The TPU kernel has no VJP, so the
backward replaces none.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import _build, ref

HEAD_DIMS = (16, 32, 64, 128)
TC_HEAD_DIMS = (64, 128)   # head dims of the tensor-core kernel


def tensor_core_path(q: torch.Tensor) -> bool:
    """Whether attention of ``q`` [B, Sq, H, d] takes the tensor-core
    kernel: bf16 at a head dim of ``TC_HEAD_DIMS``. Reads q's dtype and
    shape, never its values. f32 keeps the SIMT kernel (the tensor cores
    would round it to bf16), and so do d = 16 and 32, below one 128-byte
    TMA row."""
    return q.dtype == torch.bfloat16 and q.shape[-1] in TC_HEAD_DIMS


def _check(q, k, v, causal: bool = True) -> None:
    if q.ndim != 4 or k.ndim != 4:
        raise ValueError(f"q must be [B, Sq, H, d] and k/v [B, Sk, Hk, d], "
                         f"got {tuple(q.shape)} and {tuple(k.shape)}")
    b, sq, h, d = q.shape
    _, sk, hk, _ = k.shape
    if k.shape != (b, sk, hk, d) or v.shape != k.shape:
        raise ValueError(f"k/v shapes {tuple(k.shape)}, {tuple(v.shape)} do "
                         f"not match q {tuple(q.shape)}")
    # causal queries sit at the last Sq key positions, so a causal call
    # needs Sq <= Sk; a non-causal one (whisper's cross-attention under a
    # decoder prompt longer than the frames) has no offset and takes any Sq
    if (causal and sq > sk) or d not in HEAD_DIMS or h % hk or \
            b * h > 65535:
        raise ValueError(f"unsupported attention shape q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}: the kernels take Sq <= Sk, "
                         f"head dims {HEAD_DIMS}, H a multiple of Hk and "
                         f"B * H <= 65535")
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
    kernel that :func:`tensor_core_path` picks, or raises.
    """
    if q.device.type == "cpu":
        return ref.attention_ref(q, k, v, causal=causal)
    _check(q, k, v, causal)
    return launch(q, k, v, causal, tensor_core_path(q))


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
           tensor_cores: bool) -> torch.Tensor:
    """Launch the tensor-core or the SIMT kernel on checked operands."""
    if tensor_cores and not tensor_core_path(q):
        raise ValueError(f"the tensor-core kernel takes bf16 at head dims "
                         f"{TC_HEAD_DIMS}, got {q.dtype} d={q.shape[-1]}")
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    out = torch.empty_like(q)
    stream = torch.cuda.current_stream(q.device).cuda_stream
    if not tensor_cores:
        _build.launch(
            "flash_attention", q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, sq, sk, h, hk, d,
            int(q.dtype == torch.bfloat16), int(causal), 1.0 / (d ** 0.5),
            stream)
        return out
    _build.launch(
        "flash_attention.wgmma", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        out.data_ptr(), b, sq, sk, h, hk, d, int(causal), 1.0 / (d ** 0.5),
        stream)
    return out


def _check_bwd(q, k, v, o, do, causal: bool) -> None:
    _check(q, k, v, causal)
    for name, t in (("o", o), ("do", do)):
        if t.shape != q.shape or t.dtype != q.dtype:
            raise ValueError(f"{name} must be {q.dtype} {tuple(q.shape)}, "
                             f"got {t.dtype} {tuple(t.shape)}")
        if t.device != q.device or not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous on {q.device}")


def flash_attention_bwd_cuda(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, o: torch.Tensor,
                             do: torch.Tensor, causal: bool = True):
    """(dq, dk, dv) of attention of q [B, Sq, H, d] over k, v [B, Sk, Hk,
    d], given the forward's output ``o`` and its gradient ``do`` (both
    like q); each gradient in its input's dtype.

    A CPU tensor takes the plain version; a CUDA tensor launches the
    backward kernel (any head dim of ``HEAD_DIMS``, f32 or bf16), or
    raises.
    """
    if q.device.type == "cpu":
        return ref.flash_attention_bwd_ref(q, k, v, o, do, causal)
    _check_bwd(q, k, v, o, do, causal)
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    # the row statistics (log-sum-exp, then rowsum(dO * O)) the kernel's
    # first launch writes and its other two read
    stats = torch.empty((2, b, h, sq), dtype=torch.float32, device=q.device)
    _build.launch(
        "flash_attention_bwd", q.data_ptr(), k.data_ptr(), v.data_ptr(),
        o.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), stats.data_ptr(), b, sq, sk, h, hk, d,
        int(q.dtype == torch.bfloat16), int(causal), 1.0 / (d ** 0.5),
        torch.cuda.current_stream(q.device).cuda_stream)
    return dq, dk, dv


class FlashAttentionFn(torch.autograd.Function):
    """Differentiable flash attention: the forward of
    :func:`flash_attention_cuda` (the tensor-core or the SIMT kernel),
    saving q, k, v and its output, and the backward of
    :func:`flash_attention_bwd_cuda`. On CPU tensors both take their plain
    versions. ``apply(q, k, v, causal)`` with contiguous q, k, v."""

    @staticmethod
    def forward(ctx, q, k, v, causal):
        out = flash_attention_cuda(q, k, v, causal)
        ctx.save_for_backward(q, k, v, out)
        ctx.causal = causal
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, do.contiguous(),
                                              ctx.causal)
        return dq, dk, dv, None
