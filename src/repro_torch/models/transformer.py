"""Decoder-only transformer LM, dense family.

Layer parameters are stacked on a leading ``L`` axis (the JAX package's
layout) and a Python loop over the layers takes the place of its
``lax.scan``. Prefill and decode write the stacked KV cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.models import attention as A
from repro_torch.models import layers as L


def param_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights made from ``seed`` on ``device``."""
    dtype = param_dtype(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    lead = (cfg.n_layers,)
    layers = {
        "ln1": L.init_norm(cfg, device, lead=lead),
        "attn": A.init_attention(gen, cfg, dtype, lead),
        "ln2": L.init_norm(cfg, device, lead=lead),
        "ffn": L.init_mlp(gen, cfg, dtype, lead),
    }
    return {"embed": L.init_embed(gen, cfg, dtype), "layers": layers,
            "final_norm": L.init_norm(cfg, device)}


def layer_slice(tree, i: int):
    """Entry ``i`` of every leaf's leading (stacked-layer) dim, as views."""
    if isinstance(tree, dict):
        return {k: layer_slice(v, i) for k, v in tree.items()}
    if isinstance(tree, QTensor):
        return tree.index(i)
    return tree[i]


def _ffn_fwd(p, x, cfg, impl):
    if cfg.family != "dense":
        raise NotImplementedError(f"family {cfg.family!r} is not ported yet "
                                  "(ROADMAP queue 1 item 10)")
    return L.mlp_fwd(p, x, cfg, impl=impl)


def forward(params, tokens, cfg, impl: str = "auto"):
    """tokens: [B, S] -> logits [B, S, V_padded]."""
    x = L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attention_fwd(lp["attn"], h, cfg, impl=impl)
        h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_fwd(lp["ffn"], h, cfg, impl)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    return L.head_fwd(params["embed"], x, cfg, impl=impl)


# ---------------------------------------------------------------------------
# Serving: prefill + decode over the stacked cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    return A.init_cache(cfg, batch, max_len, param_dtype(cfg), device)


def cache_spec(cfg):
    return A.cache_spec(cfg)


def _layer_cache(cache, i: int):
    return {k: v[i] for k, v in cache.items() if k != "pos"}


def prefill(params, tokens, cfg, cache, impl: str = "auto", lengths=None):
    """tokens: [B, S] -> (last-position logits [B, V], cache).

    Writes positions [0, S) of every row of ``cache`` in place. With
    ``lengths`` ([B] int32, right-padded ragged prompts) logits come from
    each row's last real position and the cursor is set to ``lengths``;
    causal masking keeps real tokens from seeing the pads, and pad KV lies
    past the cursor, where decode never reads it before overwriting it.
    """
    b, s = tokens.shape
    x = L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attention_prefill(lp["attn"], h, cfg, _layer_cache(cache, i),
                                    impl=impl)
        h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_fwd(lp["ffn"], h, cfg, impl)
    if lengths is None:
        x = x[:, -1:]
        pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    else:
        pos = lengths.to(device=x.device, dtype=torch.int32)
        x = x[torch.arange(b, device=x.device), pos.long() - 1][:, None]
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["pos"] = pos
    return logits, cache


def decode_step(params, token, cfg, cache, impl: str = "auto"):
    """token: [B] int -> (logits [B, V], cache advanced by one in place).

    Every row writes its KV at its cursor and advances it, stopped and free
    slots included; a cursor past the cache end writes nothing.
    """
    pos = cache["pos"]
    x = L.embed_fwd(params["embed"], token[:, None]).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attention_decode(lp["attn"], h, cfg, _layer_cache(cache, i),
                                   pos, impl=impl)
        h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_fwd(lp["ffn"], h, cfg, impl)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
