"""Config registry of the port: ``--arch <id>`` resolution for every
architecture of the JAX package's registry (the transformer families
dense, moe and vlm; the recurrent ssm and hybrid; the audio
encoder-decoder whisper-small) and ``--set key=value`` overrides."""

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
from repro_torch.configs.whisper_small import CONFIG as _whisper
from repro_torch.configs.xlstm_1_3b import CONFIG as _xlstm
from repro_torch.configs.zamba2_1_2b import CONFIG as _zamba2

REGISTRY = {c.name: c for c in [
    _chameleon, _arctic, _qwen2_moe, _xlstm, _internlm2, _qwen2, _granite,
    _glm4, _whisper, _zamba2, _repro100m,
]}

# the assigned architectures, in the JAX package's order: the dry run's
# (arch x shape) cells (``launch.shapes.all_cells``)
ASSIGNED = [c.name for c in [
    _chameleon, _arctic, _qwen2_moe, _xlstm, _internlm2, _qwen2, _granite,
    _glm4, _whisper, _zamba2,
]]


def get_config(name: str) -> ModelConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(REGISTRY)}")
    return REGISTRY[name]


def apply_overrides(cfg: ModelConfig, overrides: dict) -> ModelConfig:
    """CLI ``--set key=value`` support, typed by the dataclass fields'
    types (as the JAX package's ``apply_overrides``)."""
    import dataclasses

    fields = {f.name: f for f in dataclasses.fields(cfg)}
    typed = {}
    for k, v in overrides.items():
        if k not in fields:
            raise KeyError(f"unknown config field {k!r}")
        t = fields[k].type
        if t in ("int", int):
            typed[k] = int(v)
        elif t == "Optional[int]":
            typed[k] = None if str(v).lower() in ("none", "") else int(v)
        elif t in ("float", float):
            typed[k] = float(v)
        elif t in ("bool", bool):
            typed[k] = str(v).lower() in ("1", "true", "yes")
        else:
            typed[k] = v
    return dataclasses.replace(cfg, **typed)
