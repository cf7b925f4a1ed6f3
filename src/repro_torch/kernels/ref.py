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

from repro_torch.core.quantization import (QTensor, decode_codes,
                                          dequantize, resolve_codebook)

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
    vals = _reuse_values(qt, x.device)
    kdim, n = qt.shape[-2], qt.shape[-1]
    m = x.shape[0]
    scale = _reuse_scale(qt)                          # [G, N]
    g_rows = scale.shape[0]
    xg = x.to(torch.float32).reshape(m, g_rows, kdim // g_rows)
    vg = vals.reshape(g_rows, kdim // g_rows, n)
    part = torch.einsum("mgk,gkn->gmn", xg, vg)
    return torch.sum(part * scale[:, None, :], dim=0).to(out_dtype)


def level_terms(levels: torch.Tensor) -> torch.Tensor:
    """[3, L] f32 bf16 terms of each f32 level, as the tensor-core path
    splits a codebook (``csrc/quant_gemm_sm90.cuh`` store_terms): hi =
    bf16(l), mid = bf16(l - hi), lo = bf16(l - hi - mid), each rounded to
    nearest even. Every subtraction is exact in f32, and hi + mid + lo ==
    l."""
    rest = levels.to(torch.float32)
    terms = []
    for _ in range(3):
        t = rest.to(torch.bfloat16).to(torch.float32)
        terms.append(t)
        rest = rest - t
    return torch.stack(terms)


# rows of K a codebook's partial sum spans at most on the tensor-core path:
# the wrappers pass it to the kernel (kernels/axllm_matmul.py tc_alphabet)
CODEBOOK_SUM_ROWS = 256


def quant_gemm_ref(x: torch.Tensor, qt: QTensor, k_tile: int = 64,
                   out_dtype=torch.float32) -> torch.Tensor:
    """The tensor-core path's arithmetic (``csrc/quant_gemm_sm90.cuh``),
    step by step, for the calls it takes (bf16 x, one scale row or groups
    of a multiple of ``k_tile`` rows): x times each step's bf16 B values,
    every product exact in f32. An affine code is its own B value (exact
    in bf16); a codebook level is three steps, its :func:`level_terms`.
    f32 sums over each ``k_tile`` rows of K, step by step, added in order
    into a partial sum that spans its scale row's rows (all of K with one
    row) and, for a codebook, at most ``CODEBOOK_SUM_ROWS`` of them; each
    partial times its scale row added into the output in order. It is the
    association of :func:`reuse_matmul_ref` term for term; only the order
    of the f32 additions differs. x: [M, K] bf16; qt: [K, N]."""
    if x.dtype != torch.bfloat16:
        raise ValueError(f"the tensor-core path takes bf16 x, got {x.dtype}")
    kdim = qt.shape[-2]
    scale = _reuse_scale(qt).to(x.device)             # [G, N]
    grouped = scale.shape[0] > 1
    g_rows = kdim // scale.shape[0]
    if grouped and g_rows % k_tile:
        raise ValueError(f"the tensor-core path takes groups of a multiple "
                         f"of {k_tile} rows, got {g_rows}")
    c = decode_codes(qt).to(torch.int64).to(x.device)
    cb = resolve_codebook(qt)
    if cb is None:
        steps = [c.to(torch.float32)]
    else:
        steps = list(level_terms(cb.to(x.device))[:, c + (cb.shape[0] >> 1)])
    span = g_rows if cb is None else min(g_rows, CODEBOOK_SUM_ROWS)
    xb = x.to(torch.float32)
    out = torch.zeros((x.shape[0], qt.shape[-1]), dtype=torch.float32,
                      device=x.device)
    for r0 in range(0, kdim, g_rows):                 # each scale row
        for s0 in range(r0, r0 + g_rows, span):       # each partial sum
            s1 = min(s0 + span, r0 + g_rows)
            part = torch.zeros_like(out)
            for k0 in range(s0, s1, k_tile):
                k1 = min(k0 + k_tile, s1)
                for b in steps:
                    part = part + xb[:, k0:k1] @ b[k0:k1]
            out = out + part * scale[r0 // g_rows]
    return out.to(out_dtype)


def quant_gemv_split_ref(x: torch.Tensor, qt: QTensor, plan,
                         reuse: bool = False,
                         out_dtype=torch.float32) -> torch.Tensor:
    """The split-K decode kernels' arithmetic (``csrc/quant_gemv.cuh``,
    ``axllm_matmul.gemv`` with ``reuse=False``, ``reuse_matmul.gemv``
    with ``reuse=True``) over the K ranges of ``plan``
    (``axllm_matmul.gemv_plan``): each split's f32 partial sum of
    ``x * level`` per scale group it holds; a split that holds whole
    groups adds each group's sum times its scale, one inside a group
    (``plan.defer``) leaves its sum unscaled; the splits merged in order,
    a deferred group's splits added first and their total scaled. The
    level is the code (affine, 1/qmax in the scale) or its codebook entry;
    the reuse kernel reads it from its product table, the same value.
    x: [M, K]; qt: [K, N]."""
    vals = _reuse_values(qt, x.device) if reuse else \
        _code_levels(qt).to(x.device)
    scale = qt.kernel_scale.to(x.device)                # [G, N]
    xf = x.to(torch.float32)
    g_rows = plan.group_rows
    parts = []
    for k0, k1 in plan.k_ranges():
        acc = None
        s0 = k0
        while s0 < k1:
            s1 = min(k1, (s0 // g_rows + 1) * g_rows)
            piece = xf[:, s0:s1] @ vals[s0:s1]
            if plan.defer:
                acc = piece
            else:
                piece = piece * scale[s0 // g_rows]
                acc = piece if acc is None else acc + piece
            s0 = s1
        parts.append(acc)
    total = torch.zeros_like(parts[0])
    if not plan.defer:
        for p in parts:
            total = total + p
        return total.to(out_dtype)
    group = torch.zeros_like(total)
    for z, (k0, _) in enumerate(plan.k_ranges()):
        group = group + parts[z]
        g = k0 // g_rows
        if z == plan.splits - 1 or \
                (z + 1) * plan.k_per_split // g_rows != g:
            total = total + group * scale[g]
            group = torch.zeros_like(total)
    return total.to(out_dtype)


def _code_levels(qt: QTensor) -> torch.Tensor:
    """[K, N] f32 level of each code: the code itself (affine) or its
    codebook entry, unscaled."""
    c = decode_codes(qt).to(torch.int64)
    cb = resolve_codebook(qt)
    if cb is None:
        return c.to(torch.float32)
    return cb.to(c.device)[c + (cb.shape[0] >> 1)]


def _reuse_values(qt: QTensor, device) -> torch.Tensor:
    """[K, N] f32 signed product-table value of each code, as the reuse
    kernels read it: ``sign(c) * levels[|c|]`` for a folded affine
    alphabet, ``levels[c + L/2]`` for a codebook."""
    from repro_torch.core.reuse import rc_alphabet
    levels, fold = rc_alphabet(qt.bits, qt.mode)
    levels = torch.from_numpy(levels).to(device)
    c = decode_codes(qt).to(torch.int64).to(device)
    if fold:
        vals = levels[c.abs()]
        return torch.where(c < 0, -vals, vals)
    return levels[c + (levels.shape[0] >> 1)]


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


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            do: torch.Tensor, causal: bool = True,
                            scale: Optional[float] = None):
    """Backward of :func:`attention_ref` by its formula, not by autograd:
    (dq, dk, dv) in the dtypes of q, k and v, every sum in f32.

    q, o, do: [B, Sq, H, d]; k, v: [B, Sk, Hk, d]; ``o`` is the forward's
    output. With the row log-sum-exp ``lse`` of the scaled, masked scores
    S, P = exp(S - lse) and D = rowsum(dO * O): dP = dO V^T, dS = P (dP -
    D), dQ = scale dS K, and dK = scale dS^T Q and dV = P^T dO, each
    summed over the H / Hk query heads of its KV head. Causal queries sit
    at the last Sq keys (offset Sk - Sq), as in the forward; a
    non-causal call takes any Sq."""
    b, sq, h, d = q.shape
    sk, hk = k.shape[1], k.shape[2]
    rep = h // hk
    scale = scale if scale is not None else 1.0 / (d ** 0.5)
    qf, of, dof = q.to(torch.float32), o.to(torch.float32), \
        do.to(torch.float32)
    kf = _repeat_kv(k.to(torch.float32), rep)
    vf = _repeat_kv(v.to(torch.float32), rep)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if causal:
        qpos = torch.arange(sq, device=q.device) + (sk - sq)
        mask = qpos[:, None] >= torch.arange(sk, device=q.device)[None, :]
        s = torch.where(mask[None, None], s, NEG_INF)
    lse = torch.logsumexp(s, dim=-1)                       # [B, H, Sq]
    p = torch.exp(s - lse[..., None])     # a masked score weighs exactly 0
    delta = (dof * of).sum(-1).permute(0, 2, 1)            # [B, H, Sq]
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - delta[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale   # [B, Sk, H, d]
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dk = dk.reshape(b, sk, hk, rep, d).sum(3)
    dv = dv.reshape(b, sk, hk, rep, d).sum(3)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


LOG2E = 1.4426950408889634


def _scale_log2(d: int) -> torch.Tensor:
    """The kernels' score scale in log2 units: the f32 1/sqrt(d) times the
    f32 log2(e), one f32 multiply."""
    return (torch.tensor(1.0 / (d ** 0.5), dtype=torch.float32)
            * torch.tensor(LOG2E, dtype=torch.float32))


def _merge_splits(parts) -> torch.Tensor:
    """Merge split partials [(o, lse)] (o normalized, lse = log2-sum-exp
    in log2 units or NEG_INF for an empty split) as the kernels do: the
    weights exp2(lse - max lse), an empty split weighing exactly 0."""
    lse = torch.stack([p[1] for p in parts])
    mx = lse.amax(0)
    w = torch.where(lse == NEG_INF, torch.zeros((), device=lse.device),
                    torch.exp2(lse - mx))
    o = sum(w[i][..., None] * parts[i][0] for i in range(len(parts)))
    return o / torch.clamp(w.sum(0), min=1e-30)[..., None]


def flash_attention_tc_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           causal: bool = True) -> torch.Tensor:
    """The tensor-core flash kernel's arithmetic (``csrc/flash_attention.cu``
    ``fa::``), step by step: q, k, v read as bf16; per 64-row query tile,
    the key tiles up to the tile's causal end (128 keys each at d = 64, 64
    at d = 128), an f32 online softmax in log2 units per key tile, with P
    rounded to bf16 before P V (the one rounding the plain version has
    not) and the row sums taken before that rounding. q: [B, Sq, H, d]; k,
    v: [B, Sk, Hk, d]; causal queries at the last Sq key positions."""
    b, sq, h, d = q.shape
    sk = k.shape[1]
    bn = 128 if d == 64 else 64
    rep = h // k.shape[2]
    qf = q.to(torch.bfloat16).to(torch.float32)
    kf = _repeat_kv(k.to(torch.bfloat16).to(torch.float32), rep)
    vf = _repeat_kv(v.to(torch.bfloat16).to(torch.float32), rep)
    scale = _scale_log2(d).to(q.device)
    off = sk - sq
    out = torch.empty((b, sq, h, d), dtype=torch.float32, device=q.device)
    for q0 in range(0, sq, 64):
        q1 = min(q0 + 64, sq)
        qpos = torch.arange(q0, q1, device=q.device) + off
        k_end = min(sk, q1 + off) if causal else sk
        m = torch.full((b, h, q1 - q0), NEG_INF, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, h, q1 - q0, d), device=q.device)
        for k0 in range(0, k_end, bn):
            k1 = min(k0 + bn, sk)
            x = torch.einsum("bqhd,bkhd->bhqk", qf[:, q0:q1],
                             kf[:, k0:k1]) * scale
            if causal:
                kpos = torch.arange(k0, k1, device=q.device)
                x = torch.where((kpos[None, :] <= qpos[:, None])[None, None],
                                x, NEG_INF)
            # every row sees key 0 in its first tile: m is finite from then
            m_new = torch.maximum(m, x.amax(-1))
            corr = torch.exp2(m - m_new)
            p = torch.exp2(x - m_new[..., None])
            l = l * corr + p.sum(-1)
            pb = p.to(torch.bfloat16).to(torch.float32)
            acc = acc * corr[..., None] + torch.einsum(
                "bhqk,bkhd->bhqd", pb, vf[:, k0:k1])
            m = m_new
        out[:, q0:q1] = (acc / l[..., None]).permute(0, 2, 1, 3)
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


def decode_attention_split_ref(q: torch.Tensor, k_cache: torch.Tensor,
                               v_cache: torch.Tensor, length: torch.Tensor,
                               k_scale: Optional[torch.Tensor] = None,
                               v_scale: Optional[torch.Tensor] = None,
                               n_split: int = 1,
                               split_len: Optional[int] = None
                               ) -> torch.Tensor:
    """The split-KV decode kernels' arithmetic
    (``csrc/decode_attention_body.cuh``): the length clamped to [0, S];
    q pre-scaled by the f32 scale in log2 units; int8 keys' dot products
    times their scale, values dequantized; split s (keys [s * split_len,
    (s + 1) * split_len) of the clamped length, default one split of S)
    reduced to its normalized partial and log2-sum-exp, an empty split to
    0 and -1e30; the splits merged with an empty one weighing exactly 0, so
    a length-0 row is exactly 0. Shapes as :func:`decode_attention_ref`."""
    b, h, d = q.shape
    s, hk = k_cache.shape[1], k_cache.shape[2]
    split_len = split_len or s
    if n_split * split_len < s:
        raise ValueError(f"{n_split} splits of {split_len} keys do not cover "
                         f"S = {s}")
    rep = h // hk
    qs = q.to(torch.float32) * _scale_log2(d).to(q.device)
    kf = _repeat_kv(k_cache.to(torch.float32), rep)
    vf = _repeat_kv(v_cache.to(torch.float32), rep)
    x = torch.einsum("bhd,bshd->bhs", qs, kf)
    if k_scale is not None:
        x = x * _repeat_kv(k_scale, rep)[..., 0].permute(0, 2, 1)
    if v_scale is not None:
        vf = vf * _repeat_kv(v_scale, rep)
    n = torch.clamp(length.to(torch.int64), 0, s)[:, None]      # [B, 1]
    pos = torch.arange(s, device=q.device)[None, :]
    parts = []
    for sp in range(n_split):
        valid = (pos >= sp * split_len) & (pos < torch.minimum(
            n, torch.full_like(n, (sp + 1) * split_len)))       # [B, S]
        xs = torch.where(valid[:, None], x, NEG_INF)
        m = xs.amax(-1)
        p = torch.where(valid[:, None], torch.exp2(xs - m[..., None]),
                        torch.zeros((), device=q.device))
        l = p.sum(-1)
        o = torch.einsum("bhs,bshd->bhd", p, vf) / torch.clamp(
            l, min=1e-30)[..., None]
        lse = torch.where(l > 0, m + torch.log2(torch.clamp(l, min=1e-30)),
                          NEG_INF)
        parts.append((o, lse))
    out = parts[0][0] if n_split == 1 else _merge_splits(parts)
    return out.to(q.dtype)


def paged_decode_attention_split_ref(q: torch.Tensor, k_pool: torch.Tensor,
                                     v_pool: torch.Tensor,
                                     block_tables: torch.Tensor,
                                     length: torch.Tensor,
                                     k_scale: Optional[torch.Tensor] = None,
                                     v_scale: Optional[torch.Tensor] = None,
                                     n_split: int = 1,
                                     split_len: Optional[int] = None
                                     ) -> torch.Tensor:
    """:func:`decode_attention_split_ref` through a block-paged pool: each
    row's logical sequence gathered through its table, entries clamped
    into [0, NB - 1] as the kernel clamps them. Shapes as
    :func:`paged_decode_attention_ref`."""
    b, mb = block_tables.shape
    bs = k_pool.shape[1]
    idx = torch.clamp(block_tables.long(), 0, k_pool.shape[0] - 1)

    def gather(pool):
        return pool[idx].reshape(b, mb * bs, *pool.shape[2:])

    return decode_attention_split_ref(
        q, gather(k_pool), gather(v_pool), length,
        None if k_scale is None else gather(k_scale),
        None if v_scale is None else gather(v_scale), n_split, split_len)


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


# the distance from an integer below which a product rounds as the
# quotient does (csrc/quantize.cu)
RCP_DECIDED = 0.5 - 2.0 ** -16


def quantize_rcp_ref(w: torch.Tensor, scale: torch.Tensor, bits: int = 8):
    """The CUDA kernel's rounding of w [..., K, N] by its scale [..., 1, N]
    (``csrc/quantize.cu``): the exact product y = w * r with r = 1 / s in
    float32 (the kernel's fma(w, r, 1.5 * 2^23), whose sum rounds y half to
    even), taken where t = y - rint(y), rounded once to float32 (the
    kernel's second fma), lies within ``RCP_DECIDED`` of 0; elsewhere (near
    a half, or NaN) the division ``clip(round(w / s))``. The product of two
    float32 values is exact in float64. Returns (codes int8, decided
    bool): the codes equal ``quantize_ref``'s wherever s is w's own
    scale."""
    qmax = (1 << (bits - 1)) - 1
    wf = w.to(torch.float32)
    y = wf.to(torch.float64) * torch.reciprocal(scale).to(torch.float64)
    near = torch.round(y)
    t = (y - near).to(torch.float32)
    decided = (t.abs() < RCP_DECIDED) & (y.abs() < 2.0 ** 22)
    divided = torch.clamp(torch.round(wf / scale), -qmax, qmax)
    return torch.where(decided, near.to(torch.float32),
                       divided).to(torch.int8), decided
