"""Sequence-sharded decode attention: fused cache update and flash-decode
with a cross-rank softmax combine (PyTorch port of the JAX package's
``kernels/sharded_decode.py``, which is ``shard_map`` code in plain
``jnp``, not a Pallas kernel).

Why: when the KV heads are too few to cut over the "model" axis (glm4-9b
has 2), the dense cache is cut along its sequence axis instead. Then:

  * every rank owns rows [lo, hi) of the sequence; the new token's K/V
    (and its int8 scales) is written only by the owner, in place;
  * each rank computes a partial flash-decode (m, l, acc) over its rows;
  * the combine is the flash-decode reduction: m* = all-reduce MAX of m,
    then l* = SUM of l e^{m - m*} and acc* = SUM of acc e^{m - m*} (one
    all-reduce of both); communication is O(B H d) a layer, not O(B S Hk d).

A row of length 0 gives exactly 0 (acc / max(l, 1e-30)). The body is plain
PyTorch, as JAX's is plain ``jnp``: a partial-output mode of the decode
kernel (m and l beside acc) would put it on the card's kernel (ROADMAP 2b).
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp

NEG_INF = -1e30


def _local_update(cache: torch.Tensor, new_val: torch.Tensor,
                  pos: torch.Tensor, lo: int) -> None:
    """Write new_val [B, Hk, d] at sequence row pos[b] - lo of the local
    cache [B, S_loc, Hk, d], in place, where this rank owns it."""
    s_local = cache.shape[1]
    rows = torch.arange(cache.shape[0], device=cache.device)
    local = pos.long() - lo
    owned = ((local >= 0) & (local < s_local))[:, None, None]
    idx = torch.clamp(local, 0, s_local - 1)
    cache[rows, idx] = torch.where(owned, new_val.to(cache.dtype),
                                   cache[rows, idx])


def _partial_attend(q, k, v, k_scale, v_scale, lo, length, scale):
    """Local flash-decode over this rank's rows. q: [B, H, d]; k/v: [B,
    S_loc, Hk, d]; returns (m [B, H], l [B, H], acc [B, H, d]) in f32."""
    b, h, d = q.shape
    s_loc, hk = k.shape[1], k.shape[2]
    kf, vf = k.to(torch.float32), v.to(torch.float32)
    if k_scale is not None:
        kf = kf * k_scale
        vf = vf * v_scale
    qg = q.to(torch.float32).reshape(b, hk, h // hk, d)
    s = torch.einsum("bgrd,bsgd->bgrs", qg, kf).reshape(b, h, s_loc) * scale
    kpos = lo + torch.arange(s_loc, device=q.device)
    valid = kpos[None, None, :] < length.to(q.device)[:, None, None]
    s = torch.where(valid, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1)
    p = torch.exp(s - m[..., None]) * valid.to(torch.float32)
    l = p.sum(dim=-1)
    acc = torch.einsum("bgrs,bsgd->bgrd", p.reshape(b, hk, h // hk, s_loc),
                       vf).reshape(b, h, d)
    return m, l, acc


def _all_reduce(x: torch.Tensor, group, op: str) -> torch.Tensor:
    """A fresh tensor of the ``op`` of ``x`` over ``group`` (None: one
    rank), in x's type (float32 here)."""
    x = x.clone()
    return x if group is None else tp._all_reduce(x, group, op)


def decode_attention_seqsharded(q, k_cache, v_cache, new_k, new_v, pos,
                                length, mesh, seq_axes: Tuple[str, ...],
                                batch_axes: Tuple[str, ...],
                                k_scale=None, v_scale=None,
                                new_k_scale=None, new_v_scale=None):
    """Fused update and attend on this rank's block. Shapes: q: [B, H, d]
    (all heads, on every rank); new_k, new_v: [B, Hk, d]; caches: the
    rank's rows [B, S/P, Hk, d] of the [B, S, Hk, d] cache (int8 codes with
    f32 scales [B, S/P, Hk, 1] when quantized); pos, length: [B]. The
    caches are updated in place. Returns (out [B, H, d], k_cache, v_cache)
    and, quantized, the two scale caches after them: JAX's results.

    ``mesh`` is the rank's ``launch.mesh.Mesh``. The sequence is cut over
    ``seq_axes``: its "model" axis (the serving rules' "cache_seq"), or
    ("model", "data") (the "cache_seq_long" rule: the long-context cells,
    whose batch of one leaves "data" idle), block ``i * D + j`` at model
    rank i and data rank j, as JAX's ``PartitionSpec(("model", "data"))``
    lays it out. The batch, where it is cut, is cut over ``batch_axes``,
    any of ("pod", "data") that the sequence does not take (JAX's
    ``_seq_shard_ctx``): the rows are the rank's own, and the combine runs
    over the sequence's group only."""
    seq_axes, batch_axes = tuple(seq_axes), tuple(batch_axes)
    if seq_axes not in (("model",), ("model", "data")):
        raise ValueError(f"sequence axes {seq_axes}: the sequence is cut "
                         "over ('model',) or ('model', 'data')")
    if not set(batch_axes) <= {"pod", "data"} - set(seq_axes):
        raise ValueError(f"batch axes {batch_axes}: the batch is cut over "
                         "'pod' and 'data', and not over an axis the "
                         f"sequence {seq_axes} takes")
    d = q.shape[-1]
    s_local = k_cache.shape[1]
    coords, block = shd.mesh_coords(mesh, mesh.rank), 0
    for ax in seq_axes:
        block = block * mesh.shape.get(ax, 1) + coords.get(ax, 0)
    lo = block * s_local
    group = mesh.group_of(*seq_axes)
    quantized = k_scale is not None
    _local_update(k_cache, new_k, pos, lo)
    _local_update(v_cache, new_v, pos, lo)
    if quantized:
        _local_update(k_scale, new_k_scale, pos, lo)
        _local_update(v_scale, new_v_scale, pos, lo)
    m, l, acc = _partial_attend(q, k_cache, v_cache, k_scale, v_scale, lo,
                                length, 1.0 / (d ** 0.5))
    m_g = _all_reduce(m, group, "MAX")
    corr = torch.exp(m - m_g)
    both = torch.cat([acc * corr[..., None], (l * corr)[..., None]], -1)
    both = _all_reduce(both, group, "SUM")
    acc, l = both[..., :d], both[..., d]
    out = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    if quantized:
        return out, k_cache, v_cache, k_scale, v_scale
    return out, k_cache, v_cache

