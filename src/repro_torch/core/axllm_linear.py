"""Model-facing AxLLM linear layer, fused projections, LoRA and deploy-time
quantization.

A linear weight is a plain tensor (dense path) or a :class:`QTensor` (the
AxLLM serving path, dispatched to the fused dequant-matmul kernel on the
card). Every weight is stored ``[in, out]``. A LoRA adapter rides beside
the untouched base weight as a dense low-rank delta (paper §III).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.quantization import (QTensor, QuantConfig, qconcat,
                                           quantize_tree)
from repro_torch.kernels import ops


def linear(x: torch.Tensor, w, *, impl: str = "auto",
           out_dtype=None) -> torch.Tensor:
    """x @ w where w is a tensor (dense path) or QTensor (AxLLM path)."""
    if isinstance(w, QTensor):
        return ops.axllm_matmul(x, w, impl=impl, out_dtype=out_dtype)
    y = torch.matmul(x, w.to(x.dtype))
    return y if out_dtype is None else y.to(out_dtype)


def concat_weights(ws):
    """Concatenate linear weights along the output dim for a fused
    projection: all-dense concatenates tensors, all-QTensor goes through
    :func:`qconcat` (exact). A mix is an error: fuse after
    ``deploy_quantize``, not across the quantization boundary."""
    ws = list(ws)
    n_q = sum(isinstance(w, QTensor) for w in ws)
    if n_q == len(ws):
        return qconcat(ws)
    if n_q:
        raise TypeError("concat_weights: cannot fuse a mix of QTensor and "
                        "dense weights — quantize first, then fuse")
    return torch.cat(ws, dim=-1)


@dataclasses.dataclass(frozen=True)
class LoRAConfig:
    rank: int = 16
    alpha: float = 32.0
    # which weight names get adapters (the attention projections)
    targets: tuple = ("wq", "wk", "wv", "wo")

    @property
    def scaling(self) -> float:
        return self.alpha / self.rank


def lora_init(gen: torch.Generator, n_in: int, n_out: int, cfg: LoRAConfig,
              dtype=torch.float32) -> dict:
    """A ~ N(0, 1/r), B = 0, drawn from ``gen`` on its device. The numbers
    differ from JAX's for the same seed; tests carry adapters across."""
    a = torch.randn((n_in, cfg.rank), generator=gen, device=gen.device,
                    dtype=torch.float32) / cfg.rank ** 0.5
    b = torch.zeros((cfg.rank, n_out), dtype=dtype, device=gen.device)
    return {"lora_a": a.to(dtype), "lora_b": b}


def lora_linear(x: torch.Tensor, w, adapter: Optional[dict],
                cfg: LoRAConfig, *, impl: str = "auto",
                out_dtype=None) -> torch.Tensor:
    """y = x @ W + scaling * (x @ A) @ B; W may be a QTensor (Fig. 5 path)."""
    if adapter is None:
        return linear(x, w, impl=impl, out_dtype=out_dtype)
    if isinstance(w, QTensor):
        return ops.lora_matmul(x, w, adapter["lora_a"], adapter["lora_b"],
                               cfg.scaling, impl=impl, out_dtype=out_dtype)
    y = torch.matmul(x, w.to(x.dtype))
    xa = torch.matmul(x, adapter["lora_a"].to(x.dtype))
    y = y + cfg.scaling * torch.matmul(xa, adapter["lora_b"].to(x.dtype))
    return y if out_dtype is None else y.to(out_dtype)


def lora_delta_batched(x: torch.Tensor, adapter: dict, idx: torch.Tensor,
                       scaling: float) -> torch.Tensor:
    """Gathered multi-adapter LoRA delta, the serve path's second pipeline:
    ``scaling * (x @ A[idx]) @ B[idx]`` with one adapter row per batch row.

    x: ``[B, ..., n_in]``; adapter: ``{"lora_a": [L, n_in, r], "lora_b":
    [L, r, n_out]}`` (``L`` stacked adapters, one layer's slice of an
    :class:`~repro_torch.serve.adapters.AdapterRegistry` target); idx:
    ``[B]`` int adapter row per batch row, ``-1`` for base-only (that row
    gathers row 0 and is masked to exact zeros by a multiply). Returns a
    float32 ``[B, ..., n_out]`` delta, cast at the call site.
    """
    idx = idx.to(device=x.device, dtype=torch.int64)
    safe = torch.clamp(idx, min=0)
    a = adapter["lora_a"][safe].to(torch.float32)       # [B, n_in, r]
    b = adapter["lora_b"][safe].to(torch.float32)       # [B, r, n_out]
    xf = x.to(torch.float32)
    xa = torch.einsum("b...k,bkr->b...r", xf, a)
    delta = torch.einsum("b...r,brn->b...n", xa, b)
    mask = (idx >= 0).to(torch.float32)
    mask = mask.reshape(idx.shape[0], *([1] * (x.ndim - 1)))
    return scaling * delta * mask


def merge_lora(w: torch.Tensor, adapter: dict,
               cfg: LoRAConfig) -> torch.Tensor:
    """Fold the adapter into a dense weight (for equivalence tests)."""
    return w + cfg.scaling * (adapter["lora_a"] @ adapter["lora_b"]).to(
        w.dtype)


def deploy_quantize(params, qcfg: QuantConfig):
    """Post-training conversion of a parameter tree to the AxLLM serving
    representation (every weight matrix becomes a QTensor)."""
    return quantize_tree(params, qcfg)
