"""Family dispatcher: one API over the model families the port serves.

    api = get_model(cfg)
    params = api.init(seed, device)
    logits = api.forward(params, {"tokens": tokens})
    loss = api.loss(params, {"tokens": tokens, "targets": targets})
    cache = api.init_cache(batch, max_len, device)
    logits, cache = api.prefill(params, {"tokens": tokens}, cache, lengths)
    # all_positions=True: [B, S, V] logits of every position
    logits, cache = api.decode(params, token, cache)

``cache_spec`` gives the batch axis of every cache leaf (the serve
engine's slot-insertion contract); ``ragged_prefill`` says that
``prefill`` takes right-padded mixed-length prompts with ``lengths``.
``init_paged_cache(batch, n_blocks, block_size, max_blocks, device)`` and
``paged_cache_spec`` (block axis for pool leaves, slot axis for ``pos``
and ``block_tables``) back the engine's paged mode, and ``prefill``
takes ``prefix=`` for suffix-only prefill against cached blocks.
``fuse_params`` is the deploy-time fused-projection rewrite (wqkv,
gate_up; apply after quantization), and ``supports_lora`` says that
``prefill`` and ``decode`` take the multi-LoRA kwargs ``adapters=``,
``adapter_idx=`` and ``lora_scaling=``. The port serves the transformer
families (dense, moe, vlm), the recurrent ones (ssm: xLSTM; hybrid:
zamba2) and the audio encoder-decoder (whisper). A recurrent family's
``prefill`` refuses ``lengths`` and is fed equal-length batches
(``ragged_prefill=False``); it has no paged cache and no LoRA hooks
(``init_paged_cache`` None, ``supports_lora`` False), so the engine
refuses those modes. The audio family's ``forward`` and ``prefill`` take
``{"frames": [B, enc_seq, d_feat], "tokens": [B, S]}`` and its prefill
takes ragged ``lengths``; it has no paged cache and no LoRA hooks either.
:func:`make_batch` makes a random batch of any family.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import encdec, hybrid, transformer, xlstm


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    loss: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_spec: Any
    ragged_prefill: bool
    # None for the recurrent families: their state folding has no
    # per-position KV to page, so the engine refuses paged=True
    init_paged_cache: Optional[Callable[..., Any]] = None
    paged_cache_spec: Any = None
    fuse_params: Optional[Callable[[Any], Any]] = None
    supports_lora: bool = False


# the families whose KV cache is position-addressable (a cursor or a block
# table to truncate), as the JAX package's ``init_paged_cache`` says: paged
# serving and speculative rollback need one.
ATTENTION_FAMILIES = ("dense", "moe", "vlm")
RECURRENT_FAMILIES = {"ssm": xlstm, "hybrid": hybrid}


def get_model(cfg: ModelConfig, impl: str = "auto") -> ModelAPI:
    if cfg.family in RECURRENT_FAMILIES:
        mod = RECURRENT_FAMILIES[cfg.family]
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device="cuda": mod.init_params(cfg, seed,
                                                               device),
            forward=lambda p, b: mod.forward(p, b["tokens"], cfg, impl=impl),
            loss=lambda p, b: mod.loss_fn(p, b, cfg, impl=impl),
            init_cache=lambda batch, max_len, device="cuda": mod.init_cache(
                cfg, batch, max_len, device),
            prefill=lambda p, b, c, lengths=None, all_positions=False:
            mod.prefill(p, b["tokens"], cfg, c, impl=impl, lengths=lengths,
                        all_positions=all_positions),
            decode=lambda p, t, c: mod.decode_step(p, t, cfg, c, impl=impl),
            cache_spec=mod.cache_spec(cfg),
            ragged_prefill=False,
            fuse_params=lambda p: mod.fuse_params(p, cfg),
        )
    if cfg.family == "audio":
        mod = encdec
        return ModelAPI(
            cfg=cfg,
            init=lambda seed=0, device="cuda": mod.init_params(cfg, seed,
                                                               device),
            forward=lambda p, b: mod.forward(p, b, cfg, impl=impl),
            loss=lambda p, b: mod.loss_fn(p, b, cfg, impl=impl),
            init_cache=lambda batch, max_len, device="cuda": mod.init_cache(
                cfg, batch, max_len, device),
            prefill=lambda p, b, c, lengths=None, all_positions=False:
            mod.prefill(p, b, cfg, c, impl=impl, lengths=lengths,
                        all_positions=all_positions),
            decode=lambda p, t, c: mod.decode_step(p, t, cfg, c, impl=impl),
            cache_spec=mod.cache_spec(cfg),
            ragged_prefill=True,
            fuse_params=lambda p: mod.fuse_params(p, cfg),
        )
    if cfg.family not in ATTENTION_FAMILIES:
        raise ValueError(f"unknown family {cfg.family!r}")
    mod = transformer
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, device="cuda": mod.init_params(cfg, seed, device),
        forward=lambda p, b: mod.forward(p, b["tokens"], cfg, impl=impl),
        loss=lambda p, b: mod.loss_fn(p, b, cfg, impl=impl),
        init_cache=lambda batch, max_len, device="cuda": mod.init_cache(
            cfg, batch, max_len, device),
        prefill=lambda p, b, c, lengths=None, adapters=None,
        adapter_idx=None, lora_scaling=1.0, prefix=None,
        all_positions=False: mod.prefill(
            p, b["tokens"], cfg, c, impl=impl, lengths=lengths,
            adapters=adapters, adapter_idx=adapter_idx,
            lora_scaling=lora_scaling, prefix=prefix,
            all_positions=all_positions),
        decode=lambda p, t, c, adapters=None, adapter_idx=None,
        lora_scaling=1.0: mod.decode_step(
            p, t, cfg, c, impl=impl, adapters=adapters,
            adapter_idx=adapter_idx, lora_scaling=lora_scaling),
        cache_spec=mod.cache_spec(cfg),
        ragged_prefill=True,
        init_paged_cache=lambda batch, n_blocks, block_size, max_blocks,
        device="cuda": mod.init_paged_cache(cfg, batch, n_blocks, block_size,
                                            max_blocks, device),
        paged_cache_spec=mod.paged_cache_spec(cfg),
        fuse_params=lambda p: mod.fuse_params(p, cfg),
        supports_lora=True,
    )


def make_batch(cfg: ModelConfig, rng, batch: int, seq: int, device="cuda"):
    """A random batch: ``tokens`` [B, S] int32 over the vocab, ``targets``
    (the tokens shifted left by one, wrapping) and, for an
    encoder-decoder config, ``frames`` [B, enc_seq, d_feat] float32 from a
    standard normal. ``rng`` is a seed or a ``torch.Generator`` on
    ``device``."""
    gen = rng if isinstance(rng, torch.Generator) else \
        torch.Generator(device=device).manual_seed(int(rng))
    tokens = torch.randint(0, cfg.vocab_size, (batch, seq), generator=gen,
                           device=device, dtype=torch.int32)
    out = {"tokens": tokens, "targets": torch.roll(tokens, -1, dims=1)}
    if cfg.is_encoder_decoder:
        out["frames"] = torch.randn((batch, cfg.enc_seq, cfg.d_feat),
                                    generator=gen, device=device,
                                    dtype=torch.float32)
    return out
