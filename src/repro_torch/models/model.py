"""Family dispatcher: one API over the model families the port serves.

    api = get_model(cfg)
    params = api.init(seed, device)
    logits = api.forward(params, {"tokens": tokens})
    cache = api.init_cache(batch, max_len, device)
    logits, cache = api.prefill(params, {"tokens": tokens}, cache, lengths)
    logits, cache = api.decode(params, token, cache)

``cache_spec`` gives the batch axis of every cache leaf (the serve
engine's slot-insertion contract); ``ragged_prefill`` says that
``prefill`` takes right-padded mixed-length prompts with ``lengths``.
Only the dense family is ported so far.
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
        prefill=lambda p, b, c, lengths=None: mod.prefill(
            p, b["tokens"], cfg, c, impl=impl, lengths=lengths),
        decode=lambda p, t, c: mod.decode_step(p, t, cfg, c, impl=impl),
        cache_spec=mod.cache_spec(cfg),
        ragged_prefill=True,
    )
