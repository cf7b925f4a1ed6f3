"""GQA attention block: full-sequence (forward/prefill) and cached decode.

KV cache layout: {"k"/"v": [L, B, S_max, Hk, hd]} (+ "k_scale"/"v_scale"
[L, B, S_max, Hk, 1] f32 when cfg.quant_kv, with int8 "k"/"v"), plus
"pos": [B] int32 write cursor. A layer reads and writes its slice
``cache[name][i]``, a view. Unlike the JAX package, which returns a new
cache (and donates the old one), the port updates the cache in place.

The block-paged variant (:func:`init_paged_cache`) keeps KV in a pool
shared by every slot, {"k"/"v": [L, NB, bs, Hk, hd]} (+ scales), with
per-slot "block_tables" [B, MB]; decode reads and writes it through the
tables (:func:`attention_decode_paged`).
"""

from __future__ import annotations

import torch

from repro_torch.core.axllm_linear import linear
from repro_torch.kernels import ops
from repro_torch.models import layers as L


def init_attention(gen, cfg, dtype=torch.float32, lead=()):
    d, h, hk, hd = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                    cfg.resolved_head_dim)
    p = {
        "wq": L.init_linear(gen, d, h * hd, dtype, lead),
        "wk": L.init_linear(gen, d, hk * hd, dtype, lead),
        "wv": L.init_linear(gen, d, hk * hd, dtype, lead),
        "wo": L.init_linear(gen, h * hd, d, dtype, lead),
    }
    dev = gen.device
    if cfg.qkv_bias:
        p["wq_bias"] = torch.zeros((*lead, h * hd), dtype=dtype, device=dev)
        p["wk_bias"] = torch.zeros((*lead, hk * hd), dtype=dtype, device=dev)
        p["wv_bias"] = torch.zeros((*lead, hk * hd), dtype=dtype, device=dev)
    if cfg.qk_norm:
        p["q_norm"] = {"scale": torch.ones((*lead, hd), device=dev)}
        p["k_norm"] = {"scale": torch.ones((*lead, hd), device=dev)}
    return p


def _project_qkv(p, x, cfg, impl):
    """Project x [B, S, d] -> q [B, S, H, hd], k and v [B, S, Hk, hd]."""
    if "wqkv" in p:
        raise NotImplementedError("fused wqkv projections are not ported "
                                  "yet (ROADMAP queue 1 item 5)")
    b, s, _ = x.shape
    h, hk, hd = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    q = linear(x, p["wq"], impl=impl)
    k = linear(x, p["wk"], impl=impl)
    v = linear(x, p["wv"], impl=impl)
    if cfg.qkv_bias:
        q = q + p["wq_bias"].to(q.dtype)
        k = k + p["wk_bias"].to(k.dtype)
        v = v + p["wv_bias"].to(v.dtype)
    q = q.reshape(b, s, h, hd)
    k = k.reshape(b, s, hk, hd)
    v = v.reshape(b, s, hk, hd)
    if cfg.qk_norm:
        q = L.norm_fwd(p["q_norm"], q, cfg.norm_eps)
        k = L.norm_fwd(p["k_norm"], k, cfg.norm_eps)
    return q, k, v


def init_cache(cfg, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    """Stacked-over-layers KV cache (leading L dim)."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    nl = cfg.n_layers
    kv_dtype = torch.int8 if cfg.quant_kv else dtype
    cache = {
        "k": torch.zeros((nl, batch, max_len, hk, hd), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((nl, batch, max_len, hk, hd), dtype=kv_dtype,
                         device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if cfg.quant_kv:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((nl, batch, max_len, hk, 1),
                                      dtype=torch.float32, device=device)
    return cache


def cache_spec(cfg):
    """Batch axis per cache leaf (the engine's slot-insertion contract)."""
    spec = {"k": 1, "v": 1, "pos": 0}
    if cfg.quant_kv:
        spec["k_scale"] = 1
        spec["v_scale"] = 1
    return spec


def init_paged_cache(cfg, batch: int, n_blocks: int, block_size: int,
                     max_blocks: int, dtype=torch.bfloat16, device="cuda"):
    """Block-paged KV cache: one pool shared by every slot, plus per-slot
    block tables (position p of a slot lives in block ``table[p // bs]``
    at offset ``p % bs``). Block 0 is the trash block: table entries past
    a row's allocation point there and out-of-range writes go there;
    nothing reads it. Ownership (free list, refcounts, prefix index) is
    host state in :class:`repro_torch.serve.paged_cache.PagedKVCache`."""
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    nl = cfg.n_layers
    kv_dtype = torch.int8 if cfg.quant_kv else dtype
    shape = (nl, n_blocks, block_size, hk)
    cache = {
        "k": torch.zeros((*shape, hd), dtype=kv_dtype, device=device),
        "v": torch.zeros((*shape, hd), dtype=kv_dtype, device=device),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
        "block_tables": torch.zeros((batch, max_blocks), dtype=torch.int32,
                                    device=device),
    }
    if cfg.quant_kv:
        for name in ("k_scale", "v_scale"):
            cache[name] = torch.zeros((*shape, 1), dtype=torch.float32,
                                      device=device)
    return cache


def paged_cache_spec(cfg):
    """Paged variant of :func:`cache_spec`: pool leaves name their block
    axis (1), ``pos`` and ``block_tables`` their slot axis (0)."""
    spec = {"k": 1, "v": 1, "pos": 0, "block_tables": 0}
    if cfg.quant_kv:
        spec["k_scale"] = 1
        spec["v_scale"] = 1
    return spec


def _quantize_kv(x):
    """Per-(position, head) int8 quantization of new KV entries."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    codes = torch.clamp(torch.round(x / s), -127, 127).to(torch.int8)
    return codes, s.to(torch.float32)


def attention_fwd(p, x, cfg, *, impl: str = "auto"):
    """Full-sequence causal attention (no cache)."""
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    q, k, v = _project_qkv(p, x, cfg, impl)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    out = ops.flash_attention(q, k, v, causal=True, impl=impl)
    return linear(out.reshape(b, s, -1), p["wo"], impl=impl)


def _kv_entries(cfg, k, v):
    """The cache leaves' new entries for keys/values k, v."""
    if cfg.quant_kv:
        kq, ks = _quantize_kv(k)
        vq, vs = _quantize_kv(v)
        return {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    return {"k": k, "v": v}


def attention_prefill(p, x, cfg, layer_cache, *, impl: str = "auto",
                      prefix=None, prefix_len=None):
    """Full-sequence attention that also writes positions [0, S) of this
    layer's cache slice ({"k": [B, S_max, Hk, hd], ...}) in place.

    ``prefix``/``prefix_len``: suffix-only prefill against a cached prompt
    head. ``prefix`` is this layer's gathered prefix KV {"k"/"v": [B, P,
    Hk, hd]} (int8 codes + "k_scale"/"v_scale" [B, P, Hk, 1] when
    cfg.quant_kv), right-padded to per-row lengths ``prefix_len`` [B].
    Rows are position-offset by their prefix length, queries attend the
    valid prefix plus the causal suffix, and only the suffix KV is
    written: the prefix already lives in the shared pool.
    """
    b, s, _ = x.shape
    positions = torch.arange(s, device=x.device).expand(b, s)
    if prefix is not None:
        positions = prefix_len[:, None].to(positions.dtype) + positions
    q, k, v = _project_qkv(p, x, cfg, impl)
    q = L.rope(q, positions, cfg.rope_theta)
    k = L.rope(k, positions, cfg.rope_theta)
    if prefix is None:
        out = ops.flash_attention(q, k, v, causal=True, impl=impl)
    else:
        kp, vp = prefix["k"], prefix["v"]
        if cfg.quant_kv:      # the pool holds int8 codes + scales
            kp = kp.to(torch.float32) * prefix["k_scale"]
            vp = vp.to(torch.float32) * prefix["v_scale"]
        out = ops.prefix_attention(q, kp, vp, prefix_len, k, v, impl=impl)
    for name, new in _kv_entries(cfg, k, v).items():
        layer_cache[name][:, :s] = new.to(layer_cache[name].dtype)
    return linear(out.reshape(b, s, -1), p["wo"], impl=impl)


def _write_at(buf: torch.Tensor, pos: torch.Tensor, new: torch.Tensor):
    """buf[b, pos[b]] = new[b], in place, for every row with pos[b] < S.

    Rows at or past the end write nothing, as JAX drops an out-of-bounds
    scatter write: stopped and free serving slots keep advancing their
    cursor past the cache. The row's last entry is rewritten with its own
    value instead, so the write needs no host sync.
    """
    s = buf.shape[1]
    rows = torch.arange(buf.shape[0], device=buf.device)
    at = torch.clamp(pos, max=s - 1)
    inside = (pos < s).view(-1, *([1] * (new.ndim - 1)))
    buf[rows, at] = torch.where(inside, new.to(buf.dtype), buf[rows, at])


def attention_decode(p, x, cfg, layer_cache, pos, *, impl: str = "auto"):
    """One-token decode. x: [B, 1, d]; pos: [B] current positions. Writes
    this token's KV at ``pos`` of the layer's cache slice in place."""
    b = x.shape[0]
    q, k, v = _project_qkv(p, x, cfg, impl)             # [B, 1, ...]
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    for name, new in _kv_entries(cfg, k, v).items():
        _write_at(layer_cache[name], pos, new[:, 0])
    length = (pos + 1).to(torch.int32)
    out = ops.decode_attention(
        q[:, 0], layer_cache["k"], layer_cache["v"], length,
        k_scale=layer_cache.get("k_scale"),
        v_scale=layer_cache.get("v_scale"), impl=impl)
    return linear(out.reshape(b, 1, -1), p["wo"], impl=impl)


def attention_decode_paged(p, x, cfg, layer_pool, pos, block_tables, *,
                           impl: str = "auto"):
    """One-token decode through a block-paged pool. x: [B, 1, d]; pos: [B]
    current positions; layer_pool: this layer's pool slice {"k"/"v": [NB,
    bs, Hk, hd], ...}; block_tables: [B, MB] int32.

    The new KV entry is written in place at ``(table[pos // bs], pos %
    bs)``; the scheduler guarantees that block is uniquely owned. A row
    whose position ran past its table (a stopped slot riding through a
    decode chunk) writes to trash block 0, offset 0. Free and stopped
    slots all write there, so the write sees repeated indices; nobody
    reads the trash block, so any winner is fine.
    """
    b = x.shape[0]
    bs = layer_pool["k"].shape[1]
    mb = block_tables.shape[1]
    q, k, v = _project_qkv(p, x, cfg, impl)             # [B, 1, ...]
    q = L.rope(q, pos[:, None], cfg.rope_theta)
    k = L.rope(k, pos[:, None], cfg.rope_theta)
    blk = pos // bs
    in_range = blk < mb
    rows = torch.arange(b, device=x.device)
    bid = torch.where(in_range, block_tables[rows, torch.clamp(blk, 0, mb - 1)],
                      0).long()
    off = torch.where(in_range, pos % bs, 0).long()
    for name, new in _kv_entries(cfg, k, v).items():
        layer_pool[name][bid, off] = new[:, 0].to(layer_pool[name].dtype)
    out = ops.decode_attention(
        q[:, 0], layer_pool["k"], layer_pool["v"], (pos + 1).to(torch.int32),
        k_scale=layer_pool.get("k_scale"), v_scale=layer_pool.get("v_scale"),
        block_tables=block_tables, impl=impl)
    return linear(out.reshape(b, 1, -1), p["wo"], impl=impl)
