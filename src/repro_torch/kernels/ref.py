"""Plain PyTorch versions of the kernels on the serving path.

Each is the correctness reference of one hand-written CUDA kernel in this
package and the path that a CPU tensor takes. They follow the JAX
package's ``kernels/ref.py`` operation for operation. They run on any
device, so ``chip_smoke.py`` also holds each kernel against them on the
card. ``prefix_attention_ref`` has no kernel: the JAX package has none
to port, and every device runs it; nor has ``lora_matmul_ref``, whose
base product is ``axllm_matmul``'s and whose low-rank delta is a plain
product in both packages.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.quantization import QTensor, decode_codes, dequantize

NEG_INF = -1e30


# ---------------------------------------------------------------------------
# AxLLM quantized matmul
# ---------------------------------------------------------------------------

def axllm_matmul_ref(x: torch.Tensor, qt: QTensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ deq(W) with f32 accumulation. x: [M, K]; qt: [K, N]."""
    w = dequantize(qt, torch.float32)
    return torch.matmul(x.to(torch.float32), w).to(out_dtype)


def reuse_matmul_ref(x: torch.Tensor, qt: QTensor,
                     out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ deq(W) with the reuse (LUT) association.

    Each product is ``x[m, k] * levels[cell]`` (the table entry; the sign
    is applied on read for folded affine alphabets), partial sums run
    within each scale group, and the group scale multiplies the group
    sum, not each product as in :func:`axllm_matmul_ref`. In the dyadic
    integer regime both associations are exact and bitwise equal;
    elsewhere they differ by normal rounding. x: [M, K]; qt: [K, N].
    """
    from repro_torch.core.reuse import rc_alphabet
    levels, fold = rc_alphabet(qt.bits, qt.mode)
    levels = torch.from_numpy(levels).to(x.device)
    c = decode_codes(qt).to(torch.int64)
    if fold:
        vals = levels[c.abs()]
        vals = torch.where(c < 0, -vals, vals)
    else:
        vals = levels[c + (levels.shape[0] >> 1)]
    kdim, n = qt.shape[-2], qt.shape[-1]
    m = x.shape[0]
    scale = _reuse_scale(qt)                          # [G, N]
    g_rows = scale.shape[0]
    xg = x.to(torch.float32).reshape(m, g_rows, kdim // g_rows)
    vg = vals.reshape(g_rows, kdim // g_rows, n)
    part = torch.einsum("mgk,gkn->gmn", xg, vg)
    return torch.sum(part * scale[:, None, :], dim=0).to(out_dtype)


def _reuse_scale(qt: QTensor) -> torch.Tensor:
    """[G, N] f32 group scales with the affine 1/qmax folded in (G = 1 for
    per-channel and per-tensor): the factor applied after each group
    sum, and the scale every quantized-matmul kernel consumes."""
    n = qt.shape[-1]
    if qt.granularity == "per_group":
        s = qt.scale.reshape(-1, n)
    elif qt.scale.numel() == n:
        s = qt.scale.reshape(1, n)
    else:
        s = qt.scale.reshape(1, 1).expand(1, n)
    if qt.mode == "affine":
        s = s / ((1 << (qt.bits - 1)) - 1)
    return s.to(torch.float32)


def reuse_mult_count(qt: QTensor, segment: int) -> int:
    """Multiplies per activation row the reuse path executes: distinct
    alphabet cells per (k-row, ``segment``-wide column block), summed,
    under the kernel's own alphabet fold. Host side: reads the codes.
    Multiply by M for the total of an [M, K] @ [K, N] call."""
    from repro_torch.core.reuse import rc_alphabet, segment_unique_counts
    _, fold = rc_alphabet(qt.bits, qt.mode)
    return int(segment_unique_counts(qt, segment, fold_sign=fold).sum())


def lora_matmul_ref(x: torch.Tensor, qt: QTensor, a: torch.Tensor,
                    b: torch.Tensor, scaling: float,
                    out_dtype=torch.float32) -> torch.Tensor:
    """y = x @ deq(W) + scaling * (x @ A) @ B (paper §III, LoRA support)."""
    base = axllm_matmul_ref(x, qt, torch.float32)
    xa = torch.matmul(x.to(torch.float32), a.to(torch.float32))
    delta = torch.matmul(xa, b.to(torch.float32))
    return (base + scaling * delta).to(out_dtype)


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


def paged_decode_attention_ref(q: torch.Tensor, k_pool: torch.Tensor,
                               v_pool: torch.Tensor,
                               block_tables: torch.Tensor,
                               length: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None
                               ) -> torch.Tensor:
    """One-token attention through a block-paged pool: gather each row's
    logical KV sequence through its block table, then the dense decode
    version (which keeps the exact 0 for length 0).

    q: [B, H, d]; pools: [NB, bs, Hk, d] (int8 codes if *_scale given,
    scales [NB, bs, Hk, 1]); block_tables: [B, MB] int32; length: [B].
    Table entries past a row's length may point anywhere (trash block 0
    by convention): the length mask keeps them out.
    """
    b, mb = block_tables.shape
    bs = k_pool.shape[1]
    idx = block_tables.long()

    def gather(pool):
        return pool[idx].reshape(b, mb * bs, *pool.shape[2:])

    return decode_attention_ref(
        q, gather(k_pool), gather(v_pool), length,
        k_scale=None if k_scale is None else gather(k_scale),
        v_scale=None if v_scale is None else gather(v_scale))


def prefix_attention_ref(q: torch.Tensor, k_prefix: torch.Tensor,
                         v_prefix: torch.Tensor, prefix_len: torch.Tensor,
                         k_suffix: torch.Tensor, v_suffix: torch.Tensor
                         ) -> torch.Tensor:
    """Suffix-only prefill attention against a cached prefix: query i of
    row b sits at position ``prefix_len[b] + i`` and attends every valid
    prefix key (j < prefix_len[b]) plus the causal suffix keys (j <= i),
    in one joint f32 softmax over [prefix ++ suffix].

    q: [B, S, H, d]; k/v_prefix: [B, P, Hk, d] (right-padded);
    prefix_len: [B]; k/v_suffix: [B, S, Hk, d]. Returns [B, S, H, d].
    """
    b, s, h, d = q.shape
    p = k_prefix.shape[1]
    n_rep = h // k_prefix.shape[2]
    scale = 1.0 / (d ** 0.5)
    qf = q.to(torch.float32)
    lp = torch.einsum("bqhd,bkhd->bhqk", qf,
                      _repeat_kv(k_prefix, n_rep).to(torch.float32)) * scale
    ls = torch.einsum("bqhd,bkhd->bhqk", qf,
                      _repeat_kv(k_suffix, n_rep).to(torch.float32)) * scale
    dev = q.device
    pmask = torch.arange(p, device=dev)[None, :] < prefix_len[:, None]
    lp = torch.where(pmask[:, None, None, :], lp, NEG_INF)
    smask = torch.arange(s, device=dev)[:, None] >= \
        torch.arange(s, device=dev)[None, :]
    ls = torch.where(smask[None, None], ls, NEG_INF)
    probs = torch.softmax(torch.cat([lp, ls], dim=-1), dim=-1)
    vcat = torch.cat([_repeat_kv(v_prefix, n_rep),
                      _repeat_kv(v_suffix, n_rep)], dim=1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vcat.to(torch.float32))
    return out.to(q.dtype)


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


# ---------------------------------------------------------------------------
# Per-channel quantization
# ---------------------------------------------------------------------------

def quantize_ref(w: torch.Tensor, bits: int = 8):
    """Per-channel absmax quantization of w [..., K, N] over K: returns
    (codes int8 [..., K, N], scale f32 [..., 1, N]). ``torch.round`` rounds
    half to even, as ``jnp.round`` does.

    qmax divides as a tensor on w's device: PyTorch's CUDA division by a
    Python scalar multiplies by its reciprocal instead, one ulp off the
    IEEE quotient in some columns, and the scale is an IEEE division on
    every device."""
    if not 2 <= bits <= 8:
        raise ValueError(f"bits must be in [2, 8] (int8 codes), got {bits}")
    qmax = (1 << (bits - 1)) - 1
    wf = w.to(torch.float32)
    absmax = wf.abs().amax(dim=-2, keepdim=True)
    scale = torch.clamp(absmax, min=1e-8) / torch.tensor(
        float(qmax), dtype=torch.float32, device=w.device)
    codes = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return codes.to(torch.int8), scale
