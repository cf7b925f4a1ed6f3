"""Zamba2-style hybrid: a Mamba2 backbone and ONE shared attention block
applied every ``cfg.hybrid_attn_every`` layers (arXiv:2411.15242), the
``hybrid`` family (PyTorch port of ``repro.models.hybrid``).

The shared block's weights serve every site, and each site keeps its own
KV cache (stacked on a leading site dim). As in Zamba, the block sees
concat(hidden, initial embedding) projected back to d_model
("concat_proj"). Each site's attention runs ``attention_prefill`` (flash
attention) and ``attention_decode`` (decode attention) on its own KV
slice.

Layer layout: n_layers = full_groups * every + remainder; a group is
[shared-attn site, ``every`` mamba layers]; the remainder mamba layers
(``*_rem``) close the stack. Nested Python loops take the place of the
JAX package's scans; prefill and decode write the cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.core.axllm_linear import linear
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import ssm as S
from repro_torch.models.transformer import layer_slice, param_dtype


def _groups(cfg):
    """(full groups, remainder layers, layers a group)."""
    every = cfg.hybrid_attn_every
    if every <= 0:
        raise ValueError("the hybrid family needs hybrid_attn_every > 0")
    return cfg.n_layers // every, cfg.n_layers % every, every


def init_shared_block(gen, cfg, dtype):
    dev = gen.device
    return {
        "concat_proj": L.init_linear(gen, 2 * cfg.d_model, cfg.d_model,
                                     dtype),
        "ln1": L.init_norm(cfg, dev),
        "attn": A.init_attention(gen, cfg, dtype),
        "ln2": L.init_norm(cfg, dev),
        "mlp": L.init_mlp(gen, cfg, dtype),
    }


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights made from ``seed`` on ``device`` (on "meta": their
    shapes and dtypes only)."""
    dtype = param_dtype(cfg)
    gen = L.generator(device, seed)
    n_full, rem, every = _groups(cfg)
    p = {
        "embed": L.init_embed(gen, cfg, dtype),
        "mamba": S.init_mamba2(gen, cfg, dtype, (n_full, every)),
        "shared": init_shared_block(gen, cfg, dtype),
        "final_norm": L.init_norm(cfg, device),
    }
    if rem:
        p["mamba_rem"] = S.init_mamba2(gen, cfg, dtype, (rem,))
    return p


def fuse_params(params, cfg):
    """Deploy-time fused-projection rewrite of the shared attention block
    (wqkv and gate_up). The Mamba backbone's projections are fused at init
    already (in_proj carries x/z/B/C/dt together). Apply after
    ``deploy_quantize``, so QTensors concatenate exactly."""
    shared = dict(params["shared"])
    shared["attn"] = A.fuse_attention_params(shared["attn"])
    shared["mlp"] = L.fuse_mlp_params(shared["mlp"])
    return {**params, "shared": shared}


def _shared_fwd(sp, x, x0, cfg, impl, site=None, pos=None, mode="train"):
    """The shared attention block. x, x0: [B, S, d]; ``site``: this
    site's KV slice (prefill and decode modes), written in place."""
    xin = linear(torch.cat([x, x0], -1), sp["concat_proj"],
                 impl=S.mixer_impl(impl))
    h = L.norm_fwd(sp["ln1"], xin, cfg.norm_eps)
    if mode == "train":
        att = A.attention_fwd(sp["attn"], h, cfg, impl=impl)
    elif mode == "prefill":
        att = A.attention_prefill(sp["attn"], h, cfg, site, impl=impl)
    else:
        att = A.attention_decode(sp["attn"], h, cfg, site, pos, impl=impl)
    xin = xin + att
    h2 = L.norm_fwd(sp["ln2"], xin, cfg.norm_eps)
    return x + xin + L.mlp_fwd(sp["mlp"], h2, cfg, impl=impl)


def _embed(params, tokens, cfg):
    return L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))


def forward(params, tokens, cfg, impl: str = "auto"):
    """tokens: [B, S] -> logits [B, S, V_padded]."""
    n_full, rem, every = _groups(cfg)
    x = x0 = _embed(params, tokens, cfg)

    def mamba_body(p, x):
        return x + S.mamba2_fwd(p, x, cfg, impl=impl)

    for g in range(n_full):
        x = _shared_fwd(params["shared"], x, x0, cfg, impl)
        gp = layer_slice(params["mamba"], g)
        for j in range(every):   # rematerialized as in the JAX package
            x = L.remat(cfg, mamba_body, layer_slice(gp, j), x)
    for j in range(rem):         # the remainder is not, there as here
        x = mamba_body(layer_slice(params["mamba_rem"], j), x)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    return L.head_fwd(params["embed"], x, cfg, impl=impl)


def loss_fn(params, batch, cfg, impl: str = "auto"):
    """Mean cross-entropy of ``forward`` on ``batch["tokens"]`` against
    ``batch["targets"]``."""
    logits = forward(params, batch["tokens"], cfg, impl=impl)
    return L.cross_entropy(logits, batch["targets"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    """One KV cache per attention site ({"k"/"v": [sites, B, max_len, Hk,
    hd], "pos"}), the Mamba states stacked [n_full, every, B, ...] and the
    remainder layers' [rem, B, ...], and the cursor ``pos``."""
    n_full, rem, every = _groups(cfg)
    dtype = param_dtype(cfg)
    conv, ssm = S.init_mamba_state(cfg, batch, dtype, device, (n_full, every))
    cache = {
        "attn": A.init_cache(cfg, batch, max_len, dtype, device,
                             n_layers=n_full),
        "conv": conv,
        "ssm": ssm,
        "pos": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if rem:
        cache["conv_rem"], cache["ssm_rem"] = S.init_mamba_state(
            cfg, batch, dtype, device, (rem,))
    return cache


def cache_spec(cfg):
    """Batch axis per cache leaf. The sites' KV stacks over sites (batch
    axis 1, pos axis 0: ``attention.cache_spec``); Mamba states stack
    [n_full, every, B, ...] (axis 2), remainder layers [rem, B, ...]
    (axis 1)."""
    n_full, rem, every = _groups(cfg)
    spec = {"attn": A.cache_spec(cfg), "conv": 2, "ssm": 2, "pos": 0}
    if rem:
        spec["conv_rem"] = 1
        spec["ssm_rem"] = 1
    return spec


def _site(cache, g: int):
    return {k: v[g] for k, v in cache["attn"].items() if k != "pos"}


def decode_step(params, token, cfg, cache, impl: str = "auto"):
    """token: [B] int -> (logits [B, V], cache advanced by one in place)."""
    n_full, rem, every = _groups(cfg)
    pos = cache["pos"]
    x = x0 = _embed(params, token[:, None], cfg)

    def mamba(lp, x, conv, ssm, idx):
        out, (ncv, nst) = S.mamba2_step(lp, x, cfg, conv[idx], ssm[idx],
                                        impl=impl)
        conv[idx], ssm[idx] = ncv, nst
        return x + out

    for g in range(n_full):
        x = _shared_fwd(params["shared"], x, x0, cfg, impl,
                        site=_site(cache, g), pos=pos, mode="decode")
        gp = layer_slice(params["mamba"], g)
        for j in range(every):
            x = mamba(layer_slice(gp, j), x, cache["conv"], cache["ssm"],
                      (g, j))
    for j in range(rem):
        x = mamba(layer_slice(params["mamba_rem"], j), x, cache["conv_rem"],
                  cache["ssm_rem"], j)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["attn"]["pos"] = pos + 1
    cache["pos"] = pos + 1
    return logits, cache


def prefill(params, tokens, cfg, cache, impl: str = "auto", lengths=None,
            all_positions: bool = False):
    """Parallel prefill: chunkwise SSD over the whole prompt and each
    site's attention prefill, writing every recurrent state and the sites'
    KV into ``cache`` in place. tokens: [B, S] -> (last-position logits
    [B, V], cache); ``all_positions`` returns [B, S, V].

    The Mamba backbone is recurrent, so ragged (``lengths``) prefill is
    refused: the serve engine batches equal-length prompts instead."""
    if lengths is not None:
        raise NotImplementedError(
            "hybrid prefill is recurrent (Mamba backbone): padded positions "
            "would enter the state (ragged_prefill=False).")
    n_full, rem, every = _groups(cfg)
    b, s = tokens.shape
    x = x0 = _embed(params, tokens, cfg)

    def mamba(lp, x, conv, ssm, idx):
        out, (cv, st) = S.mamba2_fwd(lp, x, cfg, impl=impl,
                                     return_state=True)
        conv[idx], ssm[idx] = cv, st
        return x + out

    for g in range(n_full):
        x = _shared_fwd(params["shared"], x, x0, cfg, impl,
                        site=_site(cache, g), mode="prefill")
        gp = layer_slice(params["mamba"], g)
        for j in range(every):
            x = mamba(layer_slice(gp, j), x, cache["conv"], cache["ssm"],
                      (g, j))
    for j in range(rem):
        x = mamba(layer_slice(params["mamba_rem"], j), x, cache["conv_rem"],
                  cache["ssm_rem"], j)
    if not all_positions:
        x = x[:, -1:]
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)
    pos = torch.full((b,), s, dtype=torch.int32, device=x.device)
    cache["attn"]["pos"] = pos
    cache["pos"] = pos.clone()
    return (logits if all_positions else logits[:, 0]), cache
