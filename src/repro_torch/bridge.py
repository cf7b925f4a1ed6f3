"""Carry weights across from the JAX package's parameter layout.

The tree arrives as nested dicts of numpy arrays (the caller converts any
framework arrays to numpy first); a quantized weight arrives as a dict of
the :class:`QTensor` fields. Layouts are kept as they are: weights
``[in, out]``, layers stacked on a leading ``L`` axis.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.quantization import QTensor

_QTENSOR_FIELDS = frozenset(f.name for f in dataclasses.fields(QTensor)
                            ) - {"kernel_scale"}    # derived, not stored


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
