"""Carry weights and LoRA adapters across from the JAX package's layout.

The tree arrives as nested dicts of numpy arrays (the caller converts any
framework arrays to numpy first); a quantized weight arrives as a dict of
the :class:`QTensor` fields. Layouts are kept as they are: weights
``[in, out]``, layers stacked on a leading ``L`` axis. An adapter
registry arrives as its stacked A/B arrays and its row names, and an
AdamW state as its moments (f32 arrays, or a blockwise-int8 moment as a
dict of the ``Q8`` fields) and its step count.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.axllm_linear import LoRAConfig
from repro_torch.core.quantization import QTensor
from repro_torch.optim.adamw import Q8
from repro_torch.serve.adapters import AdapterRegistry

_QTENSOR_FIELDS = frozenset(f.name for f in dataclasses.fields(QTensor)
                            ) - {"kernel_scale"}    # derived, not stored
_Q8_FIELDS = frozenset(f.name for f in dataclasses.fields(Q8))


def tensor_from_numpy(a, device="cuda") -> torch.Tensor:
    """numpy array -> tensor on ``device``. bfloat16 arrays (ml_dtypes),
    which ``torch.from_numpy`` cannot take, go through float32, which
    holds every bfloat16 value exactly."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(
            device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts of numpy arrays (QTensors as dicts of their fields) ->
    the port's parameter tree on ``device``."""
    if isinstance(tree, dict) and set(tree) == _QTENSOR_FIELDS:
        return QTensor(
            codes=tensor_from_numpy(tree["codes"], device),
            scale=tensor_from_numpy(tree["scale"], device), codebook=None,
            bits=int(tree["bits"]), mode=str(tree["mode"]),
            granularity=str(tree["granularity"]),
            group_size=int(tree["group_size"]), packed=bool(tree["packed"]),
            shape=tuple(int(s) for s in tree["shape"]))
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    return tensor_from_numpy(tree, device)


def registry_from_numpy(cfg, stacked, names, lora_cfg: LoRAConfig = None,
                        device="cuda") -> AdapterRegistry:
    """An adapter registry's stacked A/B as numpy arrays -> the port's
    :class:`AdapterRegistry` on ``device``, every adapter in the same row.

    stacked: ``{target: {"lora_a": [n_layers, max_loras, n_in, r],
    "lora_b": [n_layers, max_loras, r, n_out]}}``; names: the name of each
    of the ``max_loras`` rows, None for a free row (all-zero there).
    """
    reg = AdapterRegistry(cfg, lora_cfg, max_loras=len(names),
                          device=device)
    for row, name in enumerate(names):
        if name is None:
            continue
        adapter = {t: {k: tensor_from_numpy(v[:, row], "cpu")
                       for k, v in ab.items()} for t, ab in stacked.items()}
        reg._validate(name, adapter)
        reg._write(row, name, adapter)
    return reg


def opt_state_from_numpy(state, device="cuda"):
    """A JAX AdamW state as numpy -> the port's (``optim.adamw.init``'s
    layout): ``{"m", "v": moment trees, "count": int32 scalar}``. A
    moment leaf is an f32 array or a dict of the ``Q8`` fields (``codes``
    int8, ``scale`` f32, ``shape``, ``pad``). Moments go to ``device``;
    the count stays on the host, as ``init`` keeps it."""
    def moment(tree):
        if isinstance(tree, dict) and set(tree) == _Q8_FIELDS:
            return Q8(tensor_from_numpy(tree["codes"], device),
                      tensor_from_numpy(tree["scale"], device),
                      tuple(int(s) for s in tree["shape"]),
                      int(tree["pad"]))
        if isinstance(tree, dict):
            return {k: moment(v) for k, v in tree.items()}
        return tensor_from_numpy(tree, device)

    return {"m": moment(state["m"]), "v": moment(state["v"]),
            "count": torch.tensor(int(state["count"]), dtype=torch.int32)}
