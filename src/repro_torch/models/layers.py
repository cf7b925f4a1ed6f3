"""Shared building blocks: functions over nested-dict parameter trees.

Parameters are nested dicts of tensors built by the ``init_*`` helpers and
read by the matching ``*_fwd`` functions. Every weight matrix is stored
``[in, out]`` (the JAX package's layout), so deploy-time quantization and
the weight bridge apply uniformly. ``lead`` adds leading dims, e.g. the
stacked-layer ``L`` axis.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core.axllm_linear import linear
from repro_torch.core.quantization import QTensor, dequantize


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=gen)
    return t.to(dtype) * std


def init_linear(gen, n_in: int, n_out: int, dtype=torch.float32, lead=()):
    return truncated_normal(gen, (*lead, n_in, n_out), n_in ** -0.5, dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, device, lead=()):
    d = cfg.d_model
    p = {"scale": torch.ones((*lead, d), dtype=torch.float32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros((*lead, d), dtype=torch.float32,
                                device=device)
    return p


def norm_fwd(p, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm (or LayerNorm when ``p`` has a bias), computed in f32 and
    cast back to x's dtype."""
    xf = x.to(torch.float32)
    if "bias" in p:
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
        y = y * p["scale"] + p["bias"]
    else:
        var = (xf ** 2).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + eps) * p["scale"]
    return y.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP (SwiGLU / GELU)
# ---------------------------------------------------------------------------

def init_mlp(gen, cfg, dtype=torch.float32, lead=()):
    d, d_ff = cfg.d_model, cfg.d_ff
    if cfg.act == "swiglu":
        return {"gate": init_linear(gen, d, d_ff, dtype, lead),
                "up": init_linear(gen, d, d_ff, dtype, lead),
                "down": init_linear(gen, d_ff, d, dtype, lead)}
    return {"up": init_linear(gen, d, d_ff, dtype, lead),
            "down": init_linear(gen, d_ff, d, dtype, lead)}


def mlp_fwd(p, x, cfg, impl: str = "auto"):
    if "gate" in p:
        h = F.silu(linear(x, p["gate"], impl=impl)) \
            * linear(x, p["up"], impl=impl)
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, p["up"], impl=impl), approximate="tanh")
    return linear(h, p["down"], impl=impl)


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float = 1e4) -> torch.Tensor:
    """x: [..., S, H, d]; positions: broadcastable [..., S]. Computed in f32
    and cast back to x's dtype."""
    half = x.shape[-1] // 2
    exponent = torch.arange(0, half, dtype=torch.float32,
                            device=x.device) / half
    freqs = 1.0 / (theta ** exponent)
    angles = positions[..., None].to(torch.float32) * freqs
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------

def init_embed(gen, cfg, dtype=torch.float32):
    v, d = cfg.padded_vocab, cfg.d_model
    p = {"embedding": truncated_normal(gen, (v, d), 0.02, dtype)}
    if not cfg.tie_embeddings:
        p["lm_head"] = init_linear(gen, d, v, dtype)
    return p


def embed_fwd(p, tokens: torch.Tensor) -> torch.Tensor:
    return p["embedding"][tokens]


def head_fwd(p, x, cfg, impl: str = "auto"):
    """Logits over the padded vocab. The tied head is a plain product on
    the (dense) embedding, as in the JAX package; it runs no AxLLM kernel."""
    if cfg.tie_embeddings:
        w = p["embedding"]
        if isinstance(w, QTensor):
            w = dequantize(w, x.dtype)
        return torch.matmul(x, w.T.to(x.dtype))
    return linear(x, p["lm_head"], impl=impl)
