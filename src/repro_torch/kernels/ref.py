"""Plain PyTorch versions of the kernels on the serving path.

Each is the correctness reference of one hand-written CUDA kernel in this
package and the path that a CPU tensor takes. They follow the JAX
package's ``kernels/ref.py`` operation for operation. They run on any
device, so ``chip_smoke.py`` also holds each kernel against them on the
card.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import QTensor, dequantize

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# AxLLM quantized matmul
# ---------------------------------------------------------------------------

def axllm_matmul_ref(x: torch.Tensor, qt: QTensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ deq(W) with f32 accumulation. x: [M, K]; qt: [K, N]."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _repeat_kv(k: torch.Tensor, n_rep: int) -> torch.Tensor:
    """[B, S, Hk, d] -> [B, S, Hk*n_rep, d] (GQA head broadcast)."""
    if n_rep == 1:
        return k
    b, s, hk, d = k.shape
    return k[:, :, :, None, :].expand(b, s, hk, n_rep, d) \
        .reshape(b, s, hk * n_rep, d)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, scale: Optional[float] = None,
                  bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full softmax attention. q: [B, Sq, H, d]; k, v: [B, Sk, Hk, d].
    Causal queries occupy the LAST Sq positions of the Sk-long keys."""
    b, sq, h, d = q.shape
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    if bias is not None:
        logits = logits + bias
    if causal:
        sk = k.shape[1]
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        logits = torch.where(mask[None, None], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, v.to(torch.float32))
    return out.to(q.dtype)


def _length_bias(length: torch.Tensor, s: int) -> torch.Tensor:
    mask = torch.arange(s, device=length.device)[None, :] < length[:, None]
    zero = torch.zeros((), dtype=torch.float32, device=length.device)
    return torch.where(mask, zero, NEG_INF)[:, None, None, :]  # [B,1,1,S]


def decode_attention_ref(q: torch.Tensor, k_cache: torch.Tensor,
                         v_cache: torch.Tensor, length: torch.Tensor,
                         k_scale: Optional[torch.Tensor] = None,
                         v_scale: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """One-token attention against a (possibly int8) KV cache.

    q: [B, H, d]; caches: [B, S, Hk, d] (int8 codes if *_scale given, with
    scales [B, S, Hk, 1]); length: [B] valid prefix lengths (a length past
    S reads the whole cache).
    """
    s = k_cache.shape[1]
    if k_scale is not None:
        k_cache = k_cache.to(torch.float32) * k_scale
    if v_scale is not None:
        v_cache = v_cache.to(torch.float32) * v_scale
    out = attention_ref(q[:, None], k_cache, v_cache, causal=False,
                        bias=_length_bias(length, s))
    # length == 0 rows: every key is masked and the softmax renormalizes a
    # uniform distribution over garbage; force the exact zero that the
    # online-softmax kernel produces (l == 0 -> acc / max(l, eps) == 0)
    keep = (length > 0)[:, None, None]
    return torch.where(keep, out[:, 0], torch.zeros((), dtype=out.dtype,
                                                     device=out.device))


def chunked_attention_ref(q, k, v, causal: bool = True,
                          chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over KV chunks (memory-safe for long
    prompts), numerically equal to :func:`attention_ref`."""
    b, sq, h, d = q.shape
    n_rep = h // k.shape[2]
    k = _repeat_kv(k, n_rep)
    v = _repeat_kv(v, n_rep)
    sk = k.shape[1]
    scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32)
    qpos = torch.arange(sq, device=q.device) + (sk - sq)
    m = torch.full((b, h, sq), float("-inf"), device=q.device)
    l = torch.zeros((b, h, sq), device=q.device)
    acc = torch.zeros((b, h, sq, d), device=q.device)
    for start in range(0, sk, chunk):
        kb = k[:, start:start + chunk].to(torch.float32)
        vb = v[:, start:start + chunk].to(torch.float32)
        kpos = torch.arange(start, start + kb.shape[1], device=q.device)
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kb) * scale
        if causal:
            valid = qpos[:, None] >= kpos[None, :]
            logits = torch.where(valid[None, None], logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(-1))
        p = torch.exp(logits - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(-1)
        acc = acc * corr[..., None] + torch.einsum("bhqk,bkhd->bhqd", p, vb)
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 2, 1, 3).to(q.dtype)
