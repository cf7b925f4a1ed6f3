"""Config registry of the port: the models it can serve so far, the
transformer families (dense, moe, vlm) and the recurrent ones (ssm:
xlstm-1.3b; hybrid: zamba2-1.2b). The audio config (whisper-small) comes
with its family (ROADMAP queue 1 item 10c)."""

from __future__ import annotations

from repro_torch.configs.arctic_480b import CONFIG as _arctic
from repro_torch.configs.base import ModelConfig
from repro_torch.configs.chameleon_34b import CONFIG as _chameleon
from repro_torch.configs.glm4_9b import CONFIG as _glm4
from repro_torch.configs.granite_3_8b import CONFIG as _granite
from repro_torch.configs.internlm2_20b import CONFIG as _internlm2
from repro_torch.configs.qwen2_72b import CONFIG as _qwen2
from repro_torch.configs.qwen2_moe_a2_7b import CONFIG as _qwen2_moe
from repro_torch.configs.repro_100m import CONFIG as _repro100m
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

REGISTRY = {c.name: c for c in [
    _chameleon, _arctic, _qwen2_moe, _xlstm, _internlm2, _qwen2, _granite,
    _glm4, _zamba2, _repro100m,
]}


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]
