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
import torch.utils.checkpoint

from repro_torch.core.axllm_linear import concat_weights, linear
from repro_torch.core.quantization import QTensor, dequantize
from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp


class MetaGenerator:
    """The generator of an init on the meta device: shapes and dtypes
    without values (``torch.Generator`` has no meta device)."""
    device = torch.device("meta")


def generator(device, seed: int):
    """The weights' generator on ``device``, seeded; on "meta" a
    :class:`MetaGenerator`."""
    if torch.device(device).type == "meta":
        return MetaGenerator()
    return torch.Generator(device=device).manual_seed(seed)


def truncated_normal(gen: torch.Generator, shape, std: float,
                     dtype=torch.float32) -> torch.Tensor:
    t = torch.empty(shape, dtype=torch.float32, device=gen.device)
    if not t.is_meta:
        torch.nn.init.trunc_normal_(t, a=-3.0, b=3.0, generator=gen)
    return t.to(dtype) * std


def uniform(gen, shape) -> torch.Tensor:
    """Float32 draws from U[0, 1) of ``shape`` (on "meta": the shape
    only)."""
    if isinstance(gen, MetaGenerator):
        return torch.empty(shape, device="meta")
    return torch.rand(shape, generator=gen, device=gen.device)


def init_linear(gen, n_in: int, n_out: int, dtype=torch.float32, lead=()):
    return truncated_normal(gen, (*lead, n_in, n_out), n_in ** -0.5, dtype)


def remat(cfg, fn, *args):
    """``fn(*args)``, under activation checkpointing when ``cfg.remat``
    and autograd records the call: its activations are recomputed in the
    backward instead of kept (the JAX package's ``jax.checkpoint`` around
    the same bodies). The bodies draw no random numbers, so no RNG state
    is saved. The recomputation runs under the sharding context of the
    call (the autograd engine runs a card's backward on a thread of its
    own, where the caller's context is not bound)."""
    if cfg.remat and torch.is_grad_enabled():
        bound = shd.current_binding()

        def run(*a):
            if bound is None:
                return fn(*a)
            with shd.activate(*bound):
                return fn(*a)
        return torch.utils.checkpoint.checkpoint(
            run, *args, use_reentrant=False, preserve_rng_state=False)
    return fn(*args)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def init_norm(cfg, device, lead=(), d=None):
    d = d or cfg.d_model
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

def init_mlp(gen, cfg, dtype=torch.float32, lead=(), d_ff=None):
    d, d_ff = cfg.d_model, d_ff or cfg.d_ff
    if cfg.act == "swiglu":
        return {"gate": init_linear(gen, d, d_ff, dtype, lead),
                "up": init_linear(gen, d, d_ff, dtype, lead),
                "down": init_linear(gen, d_ff, d, dtype, lead)}
    return {"up": init_linear(gen, d, d_ff, dtype, lead),
            "down": init_linear(gen, d_ff, d, dtype, lead)}


def fuse_mlp_params(p):
    """Replace gate/up with one fused gate_up ``[d, 2·d_ff]`` (columns
    gate | up), the MLP analogue of the fused wqkv. A GELU MLP (no gate)
    comes back unchanged; :func:`mlp_fwd` dispatches on the keys."""
    if "gate_up" in p or "gate" not in p:
        return p
    p2 = {k: v for k, v in p.items() if k not in ("gate", "up")}
    p2["gate_up"] = concat_weights([p["gate"], p["up"]])
    return p2


def row_parallel(x, w, impl: str, lay) -> torch.Tensor:
    """``linear(x, w)`` for a row-parallel weight: with a layout (``lay``),
    each rank's partial product in float32, summed over the ranks by one
    all-reduce and cast to x's type once."""
    if lay is None:
        return linear(x, w, impl=impl)
    y = linear(x, w, impl=impl, out_dtype=torch.float32)
    return tp.all_reduce_sum(y, lay.mesh).to(x.dtype)


def mlp_fwd(p, x, cfg, impl: str = "auto", reduce: bool = True):
    """The MLP block; under a tensor-parallel layout that cuts it, gate/up
    hold the rank's d_ff columns and down its rows (one all-reduce, or,
    with ``reduce=False``, the rank's float32 partial for the caller's
    all-reduce)."""
    lay = tp.active()
    if lay is not None and lay.mlp:
        x = tp.enter(x, lay.mesh)
    if "gate_up" in p:   # fused: one activation pass over [d, 2·d_ff]
        g, u = torch.chunk(linear(x, p["gate_up"], impl=impl), 2, dim=-1)
        h = F.silu(g) * u
    elif "gate" in p:
        h = F.silu(linear(x, p["gate"], impl=impl)) \
            * linear(x, p["up"], impl=impl)
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(linear(x, p["up"], impl=impl), approximate="tanh")
    if not reduce and lay is not None and lay.mlp:
        return linear(h, p["down"], impl=impl, out_dtype=torch.float32)
    return row_parallel(h, p["down"], impl,
                        lay if lay is not None and lay.mlp else None)


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
    """Embedding rows; under a layout that cuts the vocabulary, each rank
    reads the ids in its range and one all-reduce completes the rows."""
    lay = tp.active()
    if lay is not None and lay.vocab:
        return tp.vocab_embed(p["embedding"], tokens, lay)
    return p["embedding"][tokens]


def head_fwd(p, x, cfg, impl: str = "auto"):
    """Logits over the padded vocab. The tied head is a plain product on
    the (dense) embedding, as in the JAX package; it runs no AxLLM kernel.
    Under a layout that cuts the vocabulary, each rank computes its columns
    and the logits are gathered on every rank."""
    lay = tp.active()
    if lay is not None and lay.vocab:
        x = tp.enter(x, lay.mesh)
    if cfg.tie_embeddings:
        w = p["embedding"]
        if isinstance(w, QTensor):
            w = dequantize(w, x.dtype)
        logits = torch.matmul(x, w.T.to(x.dtype))
    else:
        logits = linear(x, p["lm_head"], impl=impl)
    if lay is not None and lay.vocab:
        logits = tp.gather_last(logits, lay.mesh)
    return logits


def cross_entropy(logits, targets, vocab_size: int):
    """Mean cross-entropy over all positions in f32; the padded vocab
    columns (ids >= ``vocab_size``) are masked out of the normalizer.
    Under a training layout whose batch is cut over ranks, a rank's rows
    are its part of the global batch: their sum over the global batch's
    positions (the mean of the rank's, over the count of batch blocks),
    which the ranks' sum makes the global mean."""
    lf = logits.to(torch.float32)
    padded_v = lf.shape[-1]
    if padded_v > vocab_size:
        mask = torch.arange(padded_v, device=lf.device) >= vocab_size
        lf = torch.where(mask, torch.full_like(lf, -1e30), lf)
    logz = torch.logsumexp(lf, dim=-1)
    gold = torch.gather(lf, -1, targets.long()[..., None])[..., 0]
    lay = tp.active()
    if lay is not None and lay.train and lay.batch_axes:
        return (logz - gold).mean() / lay.mesh.axis_size(*lay.batch_axes)
    return (logz - gold).mean()
