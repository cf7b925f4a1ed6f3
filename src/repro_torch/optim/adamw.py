"""AdamW with optional blockwise-int8 moments (PyTorch port of
``repro.optim.adamw``).

:func:`init` builds zero moments shaped as the JAX package's, so that
``train/checkpoint.restore`` reads a ``(params, adamw.init(params))``
checkpoint that either package wrote. :func:`update` is the JAX update
rule, scalar for scalar in f32: the global gradient norm (reported before
the clip), the clip, the bias corrections ``1 - beta ** count``, the
per-element step clipped to +-3, weight decay on parameters of two or
more dims only, and each new parameter cast back to its own dtype (no f32
master copy). It is functional, as JAX's is: it returns new tensors and
writes into none it was given, so a checkpoint's host snapshot and a
restore never see a half-updated tree. Leaves are visited in the JAX
package's order (dict keys sorted), so the norm sums them in the same
order.

The int8 moments (:class:`Q8`) are blockwise absmax codes over blocks of
``BLOCK`` along the last dim; the second moment is stored in the sqrt
domain (:func:`_q8` ``unsigned_sqrt``). Rounding is half to even in both
packages (``torch.round`` and ``jnp.round``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch
import torch.nn.functional as F

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


# ---------------------------------------------------------------------------
# Blockwise-int8 moments
# ---------------------------------------------------------------------------

def _q8(x: torch.Tensor, *, unsigned_sqrt: bool = False) -> Q8:
    """Blockwise absmax int8 along the last dim. ``unsigned_sqrt`` (the
    non-negative second moment) stores round(255 sqrt(v / blockmax)) - 128,
    which keeps small entries representable."""
    xf = x.to(torch.float32)
    last = xf.shape[-1]
    pad = (-last) % BLOCK
    if pad:
        xf = F.pad(xf, (0, pad))
    grp = xf.reshape(*xf.shape[:-1], -1, BLOCK)
    if unsigned_sqrt:
        blockmax = torch.clamp(grp.amax(dim=-1), min=1e-20)   # [..., nblk]
        root = torch.sqrt(grp / blockmax[..., None])
        codes = torch.clamp(torch.round(root * 255.0) - 128, -128, 127)
    else:
        blockmax = torch.clamp(grp.abs().amax(dim=-1), min=1e-12) / 127.0
        codes = torch.clamp(torch.round(grp / blockmax[..., None]), -127,
                            127)
    codes = codes.to(torch.int8).reshape(*xf.shape[:-1], last + pad)
    return Q8(codes[..., :last].contiguous(), blockmax, tuple(x.shape), pad)


def _deq8(q: Q8, *, unsigned_sqrt: bool = False) -> torch.Tensor:
    codes = q.codes.to(torch.float32)
    if q.pad:
        codes = F.pad(codes, (0, q.pad))
    grp = codes.reshape(*codes.shape[:-1], -1, BLOCK)
    if unsigned_sqrt:
        root = (grp + 128.0) / 255.0
        fp = root * root * q.scale[..., None]
    else:
        fp = grp * q.scale[..., None]
    last = q.shape[-1]
    return fp.reshape(*codes.shape[:-1], last + q.pad)[..., :last]


# ---------------------------------------------------------------------------
# The update
# ---------------------------------------------------------------------------

def tree_leaves(tree) -> list:
    """The leaves of a nested dict / list / tuple tree, dict keys sorted
    (the JAX package's pytree order); a :class:`Q8` is one leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def tree_unflatten(like, leaves) -> Any:
    """``like``'s structure filled with ``leaves`` in
    :func:`tree_leaves`' order."""
    it = iter(leaves)

    def fill(node):
        if isinstance(node, dict):
            out = {k: fill(node[k]) for k in sorted(node)}
            return {k: out[k] for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v) for v in node)
        return next(it)

    return fill(like)


def global_norm(tree, specs=None) -> torch.Tensor:
    """sqrt of the sum over leaves of each leaf's f32 sum of squares,
    summed in leaf order. With ``specs`` (a NamedSharding a leaf of a
    mesh) the leaves are this rank's blocks: each leaf's sum of squares
    is the sum over its blocks, every element of the whole leaf counted
    once (a block only from the ranks at index 0 of the axes its spec
    does not cut), through one all-reduce of the per-leaf sums; every
    rank gets the same norm."""
    leaves = tree_leaves(tree)
    sums = [torch.sum(torch.square(x.to(torch.float32))) for x in leaves]
    if specs is not None:
        sums = _sum_blocks(sums, tree_leaves(specs))
    return torch.sqrt(sum(sums))


def _sum_blocks(sums, specs):
    """Each leaf's sum over the whole mesh, counted once a block."""
    mesh = specs[0].mesh
    if mesh.size == 1:
        return sums
    coords = mesh.coords
    owner = [all(coords[a] == 0 for a in mesh.shape
                 if a not in tuple(sp.spec)) for sp in specs]
    vec = torch.stack([x if own else torch.zeros_like(x)
                       for x, own in zip(sums, owner)])
    from repro_torch.dist import tensor_parallel as tp
    vec = tp._sum_over(vec, mesh.group_of(*mesh.shape))
    return list(vec.unbind(0))


def state_specs(state, param_specs):
    """The shardings of an :func:`init` state (``state``, of the whole
    parameters: a meta tree will do) whose parameters are cut by
    ``param_specs``: each moment as its parameter (a Q8 moment by
    ``dist.sharding.moment_spec``), the count whole."""
    from repro_torch.dist import sharding as shd

    def moments(tree, specs):
        if isinstance(tree, dict):
            return {k: moments(tree[k], specs[k]) for k in tree}
        if isinstance(tree, Q8):
            return shd.moment_spec(specs, tree.shape, True)
        return specs

    mesh = tree_leaves(param_specs)[0].mesh
    return {"m": moments(state["m"], param_specs),
            "v": moments(state["v"], param_specs),
            "count": shd.NamedSharding(mesh, ())}


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.float32)


def update(params, grads, state, cfg: AdamWConfig, lr_scale=1.0,
           specs=None):
    """One AdamW step. Returns (new_params, new_state, {"grad_norm"}).

    ``grads`` has ``params``' structure (each leaf in its parameter's
    dtype or f32); ``state`` is :func:`init`'s. The scalars that depend
    on the step only (the bias corrections, the learning rate) are f32 on
    the host; the norm and the clip are f32 on the gradients' device.

    ``specs`` (the parameters' NamedShardings on a mesh): the leaves are
    this rank's blocks. The norm is the whole tree's (:func:`global_norm`),
    and a Q8 moment kept whole over an axis its parameter's last dim is
    cut over (``dist.sharding.moment_spec``) is updated from the gradient
    and parameter gathered over that axis, the rank keeping its block of
    the new parameter: every number is the single-device step's."""
    count = state["count"] + 1
    gnorm = global_norm(grads, specs)
    # a true division (a float over a tensor would take the reciprocal)
    clip = torch.clamp(torch.div(_f32(cfg.clip_norm).to(gnorm.device),
                                 torch.clamp(gnorm, min=1e-12)), max=1.0)
    countf = count.to(torch.float32)
    bc1 = 1.0 - torch.pow(_f32(cfg.beta1), countf)
    bc2 = 1.0 - torch.pow(_f32(cfg.beta2), countf)
    lr = _f32(lr_scale) * cfg.lr

    def upd(p, g, m, v, spec):
        whole_over = None
        if isinstance(m, Q8) and m.codes.shape[-1] != p.shape[-1]:
            from repro_torch.dist import tensor_parallel as tp
            whole_over = spec.spec[p.ndim - 1]
            p_in, p = p, tp._gather_dim(p, spec.mesh, whole_over, p.ndim - 1)
            g = tp._gather_dim(g, spec.mesh, whole_over, g.ndim - 1)
        g = g.to(torch.float32) * clip
        m_f = _deq8(m) if isinstance(m, Q8) else m
        v_f = _deq8(v, unsigned_sqrt=True) if isinstance(v, Q8) else v
        m_new = cfg.beta1 * m_f + (1 - cfg.beta1) * g
        v_new = cfg.beta2 * v_f + (1 - cfg.beta2) * g * g
        mhat = m_new / bc1
        vhat = v_new / bc2
        step = mhat / (torch.sqrt(vhat) + cfg.eps)
        # quantized moments: bound the per-element trust region against
        # residual quantization noise in tiny-v blocks
        step = torch.clamp(step, -3.0, 3.0)
        pf = p.to(torch.float32)
        if p.ndim >= 2:
            step = step + cfg.weight_decay * pf
        new_p = (pf - lr * step).to(p.dtype)
        if whole_over is not None:
            new_p = tp._take_dim(new_p, spec.mesh, whole_over,
                                 p_in.ndim - 1)
        m_out = _q8(m_new) if isinstance(m, Q8) else m_new
        v_out = _q8(v_new, unsigned_sqrt=True) if isinstance(v, Q8) \
            else v_new
        return new_p, m_out, v_out

    leaves = tree_leaves(params)
    spec_leaves = [None] * len(leaves) if specs is None \
        else tree_leaves(specs)
    out = [upd(p, g, m, v, sp) for p, g, m, v, sp in zip(
        leaves, tree_leaves(grads), tree_leaves(state["m"]),
        tree_leaves(state["v"]), spec_leaves)]
    new_state = {"m": tree_unflatten(state["m"], [o[1] for o in out]),
                 "v": tree_unflatten(state["v"], [o[2] for o in out]),
                 "count": count}
    return (tree_unflatten(params, [o[0] for o in out]), new_state,
            {"grad_norm": gnorm})


# ---------------------------------------------------------------------------
# LR schedule
# ---------------------------------------------------------------------------

def warmup_cosine(step, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup to 1 over ``warmup`` steps, then a cosine to
    ``floor`` at ``total``: an f32 scalar tensor, computed in f32 as the
    JAX schedule is."""
    s = _f32(step)
    warm = torch.clamp(s / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * prog))
    return warm * cos
