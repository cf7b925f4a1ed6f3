"""AdamW optimizer state (PyTorch port of ``repro.optim.adamw``'s state).

The port keeps what a checkpoint holds: the config, the blockwise-int8
moment :class:`Q8` and :func:`init`, which builds zero moments shaped as
the JAX package's, so that ``train/checkpoint.restore`` reads a
``(params, adamw.init(params))`` checkpoint that either package wrote.
The update rule, ``global_norm``, the schedule and the int8 moments'
quantizers go with training (ROADMAP queue 1 item 12).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

BLOCK = 256


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4                 # peak; the schedule multiplies it
    beta1: float = 0.9
    beta2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    int8_moments: bool = False


@dataclasses.dataclass
class Q8:
    """Blockwise-int8 moment: ``codes`` int8 in the parameter's own shape
    (blocks of ``BLOCK`` run along the last dim, padded by ``pad``),
    ``scale`` f32 [..., n_blocks]."""
    codes: Any
    scale: Any
    shape: tuple
    pad: int = 0


def _zeros_like_moment(p, int8: bool):
    """A zero moment for parameter ``p`` on its device: a :class:`Q8`
    when ``int8`` and ``p`` holds at least one block, else f32 zeros."""
    shape, device = tuple(p.shape), p.device
    if int8 and math.prod(shape) >= BLOCK and len(shape) >= 1:
        last = shape[-1]
        pad = (-last) % BLOCK
        nblk = (last + pad) // BLOCK
        return Q8(torch.zeros(shape, dtype=torch.int8, device=device),
                  torch.zeros(shape[:-1] + (nblk,), dtype=torch.float32,
                              device=device), shape, pad)
    return torch.zeros(shape, dtype=torch.float32, device=device)


def _map(fn, tree):
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return fn(tree)


def init(params, cfg: AdamWConfig):
    """{"m", "v": zero moments shaped as ``params``, each on its
    parameter's device; "count": an int32 0 on the host}."""
    def moments():
        return _map(lambda p: _zeros_like_moment(p, cfg.int8_moments),
                    params)

    return {"m": moments(), "v": moments(),
            "count": torch.zeros((), dtype=torch.int32)}
