"""Decoder-only transformer LM: the dense, moe and vlm families.

The vlm family (chameleon-34b) is the dense decoder with ``qk_norm``; the
moe family swaps the FFN for :func:`repro_torch.models.moe.moe_ffn`.
Layer parameters are stacked on a leading ``L`` axis (the JAX package's
layout) and a Python loop over the layers takes the place of its
``lax.scan``. Prefill and decode write the stacked KV cache in place.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models import moe as M


def param_dtype(cfg) -> torch.dtype:
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def init_params(cfg, seed: int = 0, device="cuda"):
    """Random weights made from ``seed`` on ``device`` (on "meta": their
    shapes and dtypes only)."""
    dtype = param_dtype(cfg)
    gen = L.generator(device, seed)
    lead = (cfg.n_layers,)
    layers = {
        "ln1": L.init_norm(cfg, device, lead=lead),
        "attn": A.init_attention(gen, cfg, dtype, lead),
        "ln2": L.init_norm(cfg, device, lead=lead),
        "ffn": (M.init_moe(gen, cfg, dtype, lead) if cfg.family == "moe"
                else L.init_mlp(gen, cfg, dtype, lead)),
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


def fuse_params(params, cfg):
    """Deploy-time fused-projection rewrite (``cfg.fuse_qkv`` or the
    engine's ``fuse_qkv=``): wq/wk/wv -> wqkv and gate/up -> gate_up across
    the stacked layers. MoE routed experts keep their bank layout (only
    the shared and dense-residual MLPs fuse). Apply after
    ``deploy_quantize``, so QTensors concatenate exactly."""
    layers = dict(params["layers"])
    layers["attn"] = A.fuse_attention_params(layers["attn"])
    ffn = layers["ffn"]
    if cfg.family == "moe":
        ffn = {k: L.fuse_mlp_params(v) if k in ("shared", "dense") else v
               for k, v in ffn.items()}
    else:
        ffn = L.fuse_mlp_params(ffn)
    layers["ffn"] = ffn
    return {**params, "layers": layers}


def _ffn_fwd(p, x, cfg, impl):
    if cfg.family == "moe":
        return M.moe_ffn(p, x, cfg, impl=impl)
    return L.mlp_fwd(p, x, cfg, impl=impl)


def _layer_fwd(lp, x, cfg, impl):
    h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
    x = x + A.attention_fwd(lp["attn"], h, cfg, impl=impl)
    h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
    return x + _ffn_fwd(lp["ffn"], h, cfg, impl)


def forward(params, tokens, cfg, impl: str = "auto"):
    """tokens: [B, S] -> logits [B, S, V_padded]. Each layer is
    rematerialized under ``cfg.remat`` (``layers.remat``)."""
    x = L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        x = L.remat(cfg, _layer_fwd, layer_slice(params["layers"], i), x,
                    cfg, impl)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    return L.head_fwd(params["embed"], x, cfg, impl=impl)


def loss_fn(params, batch, cfg, impl: str = "auto"):
    """Mean cross-entropy of ``forward`` on ``batch["tokens"]`` against
    ``batch["targets"]``."""
    logits = forward(params, batch["tokens"], cfg, impl=impl)
    return L.cross_entropy(logits, batch["targets"], cfg.vocab_size)


# ---------------------------------------------------------------------------
# Serving: prefill + decode over the stacked cache
# ---------------------------------------------------------------------------

def init_cache(cfg, batch: int, max_len: int, device="cuda"):
    return A.init_cache(cfg, batch, max_len, param_dtype(cfg), device)


def cache_spec(cfg):
    return A.cache_spec(cfg)


def init_paged_cache(cfg, batch: int, n_blocks: int, block_size: int,
                     max_blocks: int, device="cuda"):
    return A.init_paged_cache(cfg, batch, n_blocks, block_size, max_blocks,
                              param_dtype(cfg), device)


def paged_cache_spec(cfg):
    return A.paged_cache_spec(cfg)


# per-slot leaves, not stacked over layers
_SLOT_LEAVES = ("pos", "block_tables")


def _layer_cache(cache, i: int):
    return {k: v[i] for k, v in cache.items() if k not in _SLOT_LEAVES}


def prefill(params, tokens, cfg, cache, impl: str = "auto", lengths=None,
            adapters=None, adapter_idx=None, lora_scaling: float = 1.0,
            prefix=None, all_positions: bool = False):
    """tokens: [B, S] -> (last-position logits [B, V], cache).

    ``all_positions`` returns the logits of every position, [B, S, V],
    instead: a teacher-forced pass (``serve/token_gate.py``).

    Writes positions [0, S) of every row of ``cache`` in place. With
    ``lengths`` ([B] int32, right-padded ragged prompts) logits come from
    each row's last real position and the cursor is set to ``lengths``;
    causal masking keeps real tokens from seeing the pads, and pad KV lies
    past the cursor, where decode never reads it before overwriting it.

    ``adapters`` ({target: {"lora_a": [n_layers, max_loras, n_in, r],
    "lora_b": [n_layers, max_loras, r, n_out]}}) and ``adapter_idx`` ([B]
    int32, -1 = base only) run the multi-LoRA delta pipeline: each layer
    takes its slice of the stacked adapters, and each attention block adds
    its rows' gathered deltas.

    ``prefix`` (needs ``lengths``) makes this a suffix-only prefill
    against a cached prompt head: {"k"/"v": [L, B, P, Hk, hd]} (+
    "k_scale"/"v_scale" when cfg.quant_kv) and "len": [B]. ``tokens`` and
    ``lengths`` then describe only the uncached tail, every row is
    position-offset by its prefix length, the cache receives the suffix
    KV only, and the cursor lands at ``prefix_len + lengths``.
    """
    b, s = tokens.shape
    prefix_len = None
    if prefix is not None:
        if lengths is None:
            raise ValueError("prefix-reuse prefill needs per-row lengths")
        prefix_len = prefix["len"].to(device=tokens.device,
                                      dtype=torch.int32)
    x = L.embed_fwd(params["embed"], tokens).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        pf = None if prefix is None else {
            k: v[i] for k, v in prefix.items() if k != "len"}
        ad = None if adapters is None else layer_slice(adapters, i)
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        x = x + A.attention_prefill(lp["attn"], h, cfg, _layer_cache(cache, i),
                                    impl=impl, adapters=ad,
                                    adapter_idx=adapter_idx,
                                    lora_scaling=lora_scaling, prefix=pf,
                                    prefix_len=prefix_len)
        h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_fwd(lp["ffn"], h, cfg, impl)
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
    cache["pos"] = pos if prefix_len is None else pos + prefix_len
    if all_positions:
        return logits, cache
    logits = logits[:, 0]
    return logits, cache


def decode_step(params, token, cfg, cache, impl: str = "auto",
                adapters=None, adapter_idx=None, lora_scaling: float = 1.0):
    """token: [B] int -> (logits [B, V], cache advanced by one in place).

    Every row writes its KV at its cursor and advances it, stopped and free
    slots included; a cursor past the cache end writes nothing. A cache
    that carries "block_tables" (:func:`init_paged_cache`) routes every
    layer through the block-paged path: KV lands at ``(table[pos // bs],
    pos % bs)`` in the shared pool and attention reads through the table.
    ``adapters``/``adapter_idx``/``lora_scaling`` as in :func:`prefill`:
    a mixed batch of base rows and rows of different adapters decodes in
    one step.
    """
    pos = cache["pos"]
    block_tables = cache.get("block_tables")
    x = L.embed_fwd(params["embed"], token[:, None]).to(param_dtype(cfg))
    for i in range(cfg.n_layers):
        lp = layer_slice(params["layers"], i)
        lora = dict(adapters=None if adapters is None
                    else layer_slice(adapters, i),
                    adapter_idx=adapter_idx, lora_scaling=lora_scaling)
        h = L.norm_fwd(lp["ln1"], x, cfg.norm_eps)
        if block_tables is not None:
            x = x + A.attention_decode_paged(
                lp["attn"], h, cfg, _layer_cache(cache, i), pos,
                block_tables, impl=impl, **lora)
        else:
            x = x + A.attention_decode(lp["attn"], h, cfg,
                                       _layer_cache(cache, i), pos, impl=impl,
                                       **lora)
        h = L.norm_fwd(lp["ln2"], x, cfg.norm_eps)
        x = x + _ffn_fwd(lp["ffn"], h, cfg, impl)
    x = L.norm_fwd(params["final_norm"], x, cfg.norm_eps)
    logits = L.head_fwd(params["embed"], x, cfg, impl=impl)[:, 0]
    cache["pos"] = pos + 1
    return logits, cache
