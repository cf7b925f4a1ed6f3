"""Config registry of the port: the models it can serve so far."""

from __future__ import annotations

from repro_torch.configs.base import ModelConfig
from repro_torch.configs.repro_100m import CONFIG as _repro100m

REGISTRY = {c.name: c for c in [_repro100m]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
