"""Model-facing AxLLM linear layer and deploy-time quantization.

A linear weight is a plain tensor (dense path) or a :class:`QTensor` (the
AxLLM serving path, dispatched to the fused dequant-matmul kernel on the
card). Every weight is stored ``[in, out]``.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, QuantConfig, quantize_tree
from repro_torch.kernels import ops


def linear(x: torch.Tensor, w, *, impl: str = "auto",
           out_dtype=None) -> torch.Tensor:
    """x @ w where w is a tensor (dense path) or QTensor (AxLLM path)."""
    if isinstance(w, QTensor):
        return ops.axllm_matmul(x, w, impl=impl, out_dtype=out_dtype)
    y = torch.matmul(x, w.to(x.dtype))
    return y if out_dtype is None else y.to(out_dtype)


def deploy_quantize(params, qcfg: QuantConfig):
    """Post-training conversion of a parameter tree to the AxLLM serving
    representation (every weight matrix becomes a QTensor)."""
    return quantize_tree(params, qcfg)
