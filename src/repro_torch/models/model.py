"""Family dispatcher: one API over the model families the port serves.

    api = get_model(cfg)
    params = api.init(seed, device)
    logits = api.forward(params, {"tokens": tokens})
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
``adapter_idx=`` and ``lora_scaling=``. Only the dense family is ported
so far.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class ModelAPI:
    cfg: ModelConfig
    init: Callable[..., Any]
    forward: Callable[..., Any]
    init_cache: Callable[..., Any]
    prefill: Callable[..., Any]
    decode: Callable[..., Any]
    cache_spec: Any
    ragged_prefill: bool
    init_paged_cache: Callable[..., Any]
    paged_cache_spec: Any
    fuse_params: Callable[[Any], Any]
    supports_lora: bool


def get_model(cfg: ModelConfig, impl: str = "auto") -> ModelAPI:
    if cfg.family != "dense":
        raise NotImplementedError(
            f"family {cfg.family!r} is not ported yet (ROADMAP queue 1 "
            "item 10); the port serves the dense family")
    mod = transformer
    return ModelAPI(
        cfg=cfg,
        init=lambda seed=0, device="cuda": mod.init_params(cfg, seed, device),
        forward=lambda p, b: mod.forward(p, b["tokens"], cfg, impl=impl),
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
