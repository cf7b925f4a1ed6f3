"""Whisper-small style encoder-decoder (arXiv:2212.04356), the ``audio``
family (PyTorch port of ``repro.models.encdec``).

The conv/mel frontend is a stub, as in the JAX package: callers supply
precomputed frame features [B, enc_seq, d_feat], and a linear projection
maps them to d_model. The backbone is a bidirectional encoder and a
causal decoder with cross-attention; sinusoidal positions on both sides.
The decoder's self-attention goes through ``attention_prefill`` and
``attention_decode``, so it takes RoPE on top of its sinusoidal
positions, as in the JAX package.

Types follow the JAX package exactly: the frontend takes the frames in
float32, so the whole encoder stream is float32 whatever ``cfg.dtype``
is, and so is the decoder's prefill stream (it takes the encoder
output's type); ``decode_step`` runs in ``cfg.dtype``, and the caches are
``cfg.dtype``.

Decode caches: per-layer self-attention KV (stacked, as
``attention.init_cache``) and cross-attention KV computed once at prefill
from the encoder output, stacked over layers with the batch on axis 1.
The JAX package computes the frontend and the cross K/V projections
without an ``impl``; here they take ``ops._base_impl(impl)`` ("reuse" ->
"auto"), which is the same kernel choice and keeps the plain path plain.
Prefill and decode write the cache in place.

Under a training layout that cuts the heads (``tp.train_layout``) the
encoder's attention, the decoder's self-attention and its
cross-attention each attend over the rank's heads and end in one
all-reduce (``attention.attention_fwd``'s form); the encoder output
enters the decoder once, so its gradient is summed over the ranks. The
frontend, the sinusoids and the norms stay whole.
"""

from __future__ import annotations

import torch

from repro_torch.core.axllm_linear import concat_weights, linear
from repro_torch.dist import tensor_parallel as tp
from repro_torch.kernels import ops
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.transformer import layer_slice, param_dtype

# cache leaves that are not a layer's self-attention KV
_NOT_SELF = ("pos", "cross_k", "cross_v")


def _sinusoid_at(pos: torch.Tensor, d: int) -> torch.Tensor:
    """[N] positions -> [N, d] f32 sinusoids (sin on even, cos on odd
    columns)."""
    pos = pos.to(torch.float32)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32,
                       device=pos.device)[None, :]
    angle = pos / torch.pow(torch.tensor(10000.0, device=pos.device),
                            dim / d)
    pe = torch.zeros((pos.shape[0], d), dtype=torch.float32,
                     device=pos.device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle)
    return pe


def _sinusoid(s: int, d: int, device="cpu"):
    return _sinusoid_at(torch.arange(s, device=device), d)


def init_enc_layer(gen, cfg, dtype, lead=()):
    dev = gen.device
    return {
        "ln1": L.init_norm(cfg, dev, lead),
        "attn": A.init_attention(gen, cfg, dtype, lead),
        "ln2": L.init_norm(cfg, dev, lead),
        "mlp": L.init_mlp(gen, cfg, dtype, lead),
    }


def init_dec_layer(gen, cfg, dtype, lead=()):
    dev = gen.device
    return {
        "ln1": L.init_norm(cfg, dev, lead),
        "self_attn": A.init_attention(gen, cfg, dtype, lead),
        "ln_x": L.init_norm(cfg, dev, lead),
        "cross_attn": A.init_attention(gen, cfg, dtype, lead),
        "ln2": L.init_norm(cfg, dev, lead),
        "mlp": L.init_mlp(gen, cfg, dtype, lead),
    }


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights made from ``seed`` on ``device`` (on "meta": their
    shapes and dtypes only); layers stacked on a leading axis
    (``n_enc_layers`` and ``n_layers``)."""
    dtype = param_dtype(cfg)
    gen = L.generator(device, seed)
    return {
        "embed": L.init_embed(gen, cfg, dtype),
        "frontend": L.init_linear(gen, cfg.d_feat, cfg.d_model, dtype),
        "enc_layers": init_enc_layer(gen, cfg, dtype, (cfg.n_enc_layers,)),
        "dec_layers": init_dec_layer(gen, cfg, dtype, (cfg.n_layers,)),
        "enc_norm": L.init_norm(cfg, device),
        "final_norm": L.init_norm(cfg, device),
    }


def encode(params, frames, cfg, impl: str = "auto"):
    """frames: [B, F, d_feat] -> [B, F, d], float32."""
    x = linear(frames.to(torch.float32), params["frontend"],
               impl=ops._base_impl(impl))
    x = x + _sinusoid(x.shape[1], cfg.d_model, device=x.device).to(x.dtype)

    def body(lp, x):
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attention_fwd(lp["attn"], h, cfg, impl=impl, causal=False,
                                rope=False)
        h2 = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        return x + L.mlp_fwd(lp["mlp"], h2, cfg, impl=impl)

    for i in range(cfg.n_enc_layers):   # rematerialized under cfg.remat
        x = L.remat(cfg, body, layer_slice(params["enc_layers"], i), x)
    return L.norm_fwd(params["enc_norm"], x, cfg.norm_eps)


def fuse_cross_attention_params(p):
    """Cross-attention fusion: only wk/wv share an input (the encoder
    output), so they fuse into wkv; wq runs on the decoder stream and
    stays separate."""
    if "wkv" in p or "wk" not in p:
        return p
    p2 = {k: v for k, v in p.items() if k not in ("wk", "wv")}
    p2["wkv"] = concat_weights([p["wk"], p["wv"]])
    return p2


def fuse_params(params, cfg):
    """Deploy-time fused-projection rewrite over the encoder's
    self-attention, the decoder's self- and cross-attention and both MLP
    stacks. Apply after ``deploy_quantize``, so QTensors concatenate
    exactly."""
    enc = dict(params["enc_layers"])
    enc["attn"] = A.fuse_attention_params(enc["attn"])
    enc["mlp"] = L.fuse_mlp_params(enc["mlp"])
    dec = dict(params["dec_layers"])
    dec["self_attn"] = A.fuse_attention_params(dec["self_attn"])
    dec["cross_attn"] = fuse_cross_attention_params(dec["cross_attn"])
    dec["mlp"] = L.fuse_mlp_params(dec["mlp"])
    return {**params, "enc_layers": enc, "dec_layers": dec}


def _cross_kv(lp, enc_out, cfg, impl: str = "auto"):
    """Cross-attention K/V of the encoder output: [B, F, Hk, hd] each (a
    rank's KV heads under a layout that cuts them)."""
    b, f, _ = enc_out.shape
    hk, hd = tp.local_heads(cfg, tp.active())[1], cfg.resolved_head_dim
    ca, impl = lp["cross_attn"], ops._base_impl(impl)
    if "wkv" in ca:      # fused: one [d, 2·Hk·hd] pass over the encoder out
        k, v = torch.chunk(linear(enc_out, ca["wkv"], impl=impl), 2, dim=-1)
    else:
        k = linear(enc_out, ca["wk"], impl=impl)
        v = linear(enc_out, ca["wv"], impl=impl)
    return k.reshape(b, f, hk, hd), v.reshape(b, f, hk, hd)


def _dec_layer(lp, x, cfg, impl, enc_out=None, cross_kv=None,
               self_cache=None, pos=None, mode="train", cross_lengths=None):
    """One decoder layer. ``mode``: "train" (no cache; cross K/V from
    ``enc_out``), "prefill" (writes positions [0, S) of ``self_cache``)
    or "decode" (one token at ``pos``, cross-attending ``cross_lengths``
    frames a row); the last two take ``cross_kv``."""
    b, s = x.shape[0], x.shape[1]
    lay = tp.active()
    cut = lay is not None and lay.heads
    h, hd = tp.local_heads(cfg, lay)[0], cfg.resolved_head_dim
    hh = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
    if mode == "train":
        att = A.attention_fwd(lp["self_attn"], hh, cfg, impl=impl)
    elif mode == "prefill":
        att = A.attention_prefill(lp["self_attn"], hh, cfg, self_cache,
                                  impl=impl)
    else:
        att = A.attention_decode(lp["self_attn"], hh, cfg, self_cache, pos,
                                 impl=impl)
    x = x + att
    hx = L.norm_fwd(lp["ln_x"], x, cfg.norm_eps)
    if cut:
        hx = tp.enter(hx, lay.mesh)
    q = linear(hx, lp["cross_attn"]["wq"], impl=impl).reshape(b, s, h, hd)
    if mode == "train":
        ck, cv = _cross_kv(lp, enc_out, cfg, impl)
        if A._regroup(lay):
            ck, cv = tp.kv_for_heads(ck, cfg, lay), tp.kv_for_heads(cv, cfg,
                                                                     lay)
        catt = ops.flash_attention(q, ck, cv, causal=False, impl=impl)
    else:
        ck, cv = cross_kv
        if mode == "decode":
            catt = ops.decode_attention(q[:, 0], ck, cv, cross_lengths,
                                        impl=impl)[:, None]
        else:
            catt = ops.flash_attention(q, ck, cv, causal=False, impl=impl)
    x = x + L.row_parallel(catt.reshape(b, s, -1), lp["cross_attn"]["wo"],
                           impl, lay if cut else None)
    h2 = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
    return x + L.mlp_fwd(lp["mlp"], h2, cfg, impl=impl)


def _embed(params, tokens, cfg, dtype):
    x = L.embed_fwd(params["embed"], tokens).to(dtype)
    return x + _sinusoid(tokens.shape[1], cfg.d_model,
                         device=x.device).to(dtype)


def forward(params, batch, cfg, impl: str = "auto"):
    """batch: {"frames": [B, F, d_feat], "tokens": [B, S]} -> logits [B, S,
    V_padded]."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    x = _embed(params, batch["tokens"], cfg, enc_out.dtype)
    lay = tp.active()
    if lay is not None and lay.heads:
        # every layer's column-parallel cross K/V reads the encoder output:
        # one entry sums its gradient over the ranks, all layers' at once
        enc_out = tp.enter(enc_out, lay.mesh)
    for i in range(cfg.n_layers):   # rematerialized under cfg.remat
        x = L.remat(cfg, lambda lp, x, enc: _dec_layer(lp, x, cfg, impl,
                                                       enc_out=enc),
                    layer_slice(params["dec_layers"], i), x, enc_out)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    return L.head_fwd(params["embed"], x, cfg, impl=impl)


def loss_fn(params, batch, cfg, impl: str = "auto"):
    logits = forward(params, batch, cfg, impl=impl)
    return L.cross_entropy(logits, batch["targets"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda", dtype=None):
    """Self-attention KV as ``attention.init_cache`` (and ``pos``), plus
    "cross_k"/"cross_v" [n_layers, B, enc_seq, Hk, hd] in ``dtype``
    (default ``cfg.dtype``)."""
    dtype = dtype or param_dtype(cfg)
    hk, hd = cfg.n_kv_heads, cfg.resolved_head_dim
    cache = A.init_cache(cfg, batch, max_len, dtype, device)
    cache["cross_k"] = torch.zeros((cfg.n_layers, batch, cfg.enc_seq, hk,
                                    hd), dtype=dtype, device=device)
    cache["cross_v"] = torch.zeros_like(cache["cross_k"])
    return cache


def cache_spec(cfg):
    """Batch axis per cache leaf: self-attention KV per
    ``attention.cache_spec``, cross KV stacked over layers (axis 1)."""
    spec = A.cache_spec(cfg)
    spec["cross_k"] = 1
    spec["cross_v"] = 1
    return spec


def _self_cache(cache, i: int):
    return {k: v[i] for k, v in cache.items() if k not in _NOT_SELF}


def prefill(params, batch, cfg, cache, impl: str = "auto", lengths=None,
            all_positions: bool = False):
    """Encode the frames, compute every layer's cross K/V (written to the
    cache in its dtype), prefill the decoder's self KV.

    Returns (last-position logits [B, V], cache); ``all_positions``
    returns the logits of every position, [B, S, V], instead (a
    teacher-forced pass, ``serve/token_gate.py``). ``lengths`` ([B] int32)
    takes right-padded ragged decoder prompts: the decoder's
    self-attention is causal, so real tokens never see the padding; the
    logits come from each row's last real position and the cursor is set
    per row. The cache must hold the batch's rows and F = ``enc_seq``
    frames; every one of its rows is written."""
    enc_out = encode(params, batch["frames"], cfg, impl=impl)
    tokens = batch["tokens"]
    b, s = tokens.shape
    x = _embed(params, tokens, cfg, enc_out.dtype)
    for i in range(cfg.n_layers):
        lp = layer_slice(params["dec_layers"], i)
        ck, cv = _cross_kv(lp, enc_out, cfg, impl)
        x = _dec_layer(lp, x, cfg, impl, cross_kv=(ck, cv),
                       self_cache=_self_cache(cache, i), mode="prefill")
        cache["cross_k"][i].copy_(ck)
        cache["cross_v"][i].copy_(cv)
    if lengths is None:
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
        last = x[:, -1:]
    else:
        pos = lengths.to(device=x.device, dtype=torch.int32)
        last = x[torch.arange(b, device=x.device), pos.long() - 1][:, None]
    if not all_positions:
        x = last
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)
    cache["pos"] = pos
    return (logits if all_positions else logits[:, 0]), cache


def decode_step(params, token, cfg, cache, impl: str = "auto"):
    """token: [B] int -> (logits [B, V], cache advanced by one in place).
    The step runs in ``cfg.dtype``, each row at its own sinusoid position;
    cross-attention reads all F frames of the cached cross K/V."""
    pos = cache["pos"]
    x = L.embed_fwd(params["embed"], token[:, None]).to(param_dtype(cfg))
    x = x + _sinusoid_at(pos, cfg.d_model)[:, None].to(x.dtype)
    # every row attends all F frames; one lengths tensor for every layer
    cross_len = torch.full((x.shape[0],), cache["cross_k"].shape[2],
                           dtype=torch.int32, device=x.device)
    for i in range(cfg.n_layers):
        x = _dec_layer(layer_slice(params["dec_layers"], i), x, cfg, impl,
                       cross_kv=(cache["cross_k"][i], cache["cross_v"][i]),
                       self_cache=_self_cache(cache, i), pos=pos,
                       mode="decode", cross_lengths=cross_len)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
