"""Training step factory: gradient accumulation over microbatches, then
AdamW (PyTorch port of ``repro.train.loop``).

``make_train_step`` builds the step the launcher and the tests call:
``step(params, opt_state, batch, step_index) -> (params, opt_state,
metrics)``. The gradients are ``torch.autograd.grad`` of the model API's
``loss`` with respect to every parameter leaf; a microbatch loop over
``cfg.grad_accum`` equal slices of the batch takes the place of JAX's
``lax.scan``, summing loss and gradients in ``cfg.grad_accum_dtype`` and
dividing both by the count. The update is functional (new tensors), as
in JAX.

``grad_specs`` (the parameters' NamedShardings on a mesh, usually
``dist.sharding.param_specs`` under ``DEFAULT_RULES``) makes it the step
of one rank of that mesh. JAX constrains the gradients to the specs and
lets GSPMD partition the program; the port writes the partition out
(``dist.tensor_parallel.train_layout``): the parameters and the AdamW
moments are this rank's blocks under the specs (FSDP over "data",
tensor-parallel over "model"), the batch is the rank's rows over ("pod",
"data") (``data.pipeline.shard_batch``), the forward reads the blocks
gathered into its layout (``tensor_parallel.to_compute``), whose
collectives autograd goes through, and every gradient comes out as the
rank's block of the whole batch's gradient. The microbatch loop carries
blocks. The metrics are the whole batch's, the same on every rank.

:func:`jit_train_step` is JAX's ``jax.jit`` with shardings: PyTorch runs
the step eagerly, so it only cuts the inputs that arrive whole.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from repro_torch.dist import sharding as shd
from repro_torch.dist import tensor_parallel as tp
from repro_torch.optim import adamw


def _grad_fn(api):
    """(loss, grads) of ``api.loss`` at ``params`` on ``batch``: the
    gradient of every leaf, in its dtype (zeros for a leaf the loss does
    not read, as JAX gives)."""
    def grad_fn(params, batch):
        leaves = adamw.tree_leaves(params)
        with torch.enable_grad():
            diff = [p.detach().requires_grad_(True) for p in leaves]
            loss = api.loss(adamw.tree_unflatten(params, diff), batch)
            grads = torch.autograd.grad(loss, diff, allow_unused=True,
                                        materialize_grads=True)
        return loss.detach(), adamw.tree_unflatten(params, list(grads))
    return grad_fn


def _mesh_grad_fn(api, specs, lay):
    """(the loss summed over the batch's ranks, the block gradients) of one
    rank's ``params`` blocks on its rows ``batch``."""
    def grad_fn(params, batch):
        leaves = adamw.tree_leaves(params)
        with torch.enable_grad():
            diff = [p.detach().requires_grad_(True) for p in leaves]
            blocks = adamw.tree_unflatten(params, diff)
            # bound through the backward too: remat recomputes each layer
            with shd.activate(lay.mesh, lay.rules, lay):
                loss = api.loss(tp.to_compute(blocks, specs, lay), batch)
                grads = torch.autograd.grad(loss, diff, allow_unused=True,
                                            materialize_grads=True)
        return (tp.sum_over_batch(loss, lay),
                adamw.tree_unflatten(params, list(grads)))
    return grad_fn


def _mesh_of(specs):
    leaves = adamw.tree_leaves(specs)
    if not leaves or not all(isinstance(s, shd.NamedSharding)
                             for s in leaves):
        raise ValueError("grad_specs: a NamedSharding for every parameter "
                         "leaf (dist.sharding.param_specs)")
    mesh = leaves[0].mesh
    if any(s.mesh is not mesh for s in leaves):
        raise ValueError("grad_specs: every spec on one mesh")
    return mesh


def make_train_step(api, opt_cfg: adamw.AdamWConfig, total_steps: int = 10000,
                    warmup: int = 100, grad_specs=None) -> Callable:
    """The training step of ``api`` (a ``models.model.ModelAPI``) under
    ``opt_cfg``, with the warmup-cosine schedule over ``total_steps``.
    Metrics: ``loss`` (the mean over microbatches), ``lr_scale`` and
    ``grad_norm`` (before the clip).

    ``grad_specs``: the parameters' NamedShardings on a mesh of ranks. The
    step then takes and returns this rank's blocks of the parameters and
    the moments (``adamw.state_specs``) and the rank's rows of the batch;
    the gradient of each leaf ends as the rank's block under its spec.
    Every family trains so. Specs the step cannot honour raise ValueError
    (see ``tensor_parallel.train_layout``). On a mesh of one the specs cut
    nothing and the step is the single-device one."""
    cfg = api.cfg
    accum = max(cfg.grad_accum, 1)
    grad_fn = _grad_fn(api)
    lay = whole = None
    if grad_specs is not None:
        mesh = _mesh_of(grad_specs)
        if mesh.size > 1:
            whole = api.init(seed=0, device="meta")
            lay = tp.train_layout(cfg, mesh, grad_specs, whole)
            grad_fn = _mesh_grad_fn(api, grad_specs, lay)
            blocks = [tuple(s.stop - s.start for s in shd.block_index(
                w.shape, sp, mesh, mesh.rank)) for w, sp in zip(
                adamw.tree_leaves(whole), adamw.tree_leaves(grad_specs))]
    acc_dtype = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" \
        else torch.float32

    def check_blocks(params):
        for x, want in zip(adamw.tree_leaves(params), blocks):
            if tuple(x.shape) != want:
                raise ValueError(
                    f"a parameter of shape {tuple(x.shape)}, and this "
                    f"rank's block under grad_specs is {want}: the step "
                    "takes blocks (jit_train_step cuts whole inputs)")

    def train_step(params, opt_state, batch, step):
        if lay is not None:
            check_blocks(params)
        if accum > 1:
            rows = next(iter(batch.values())).shape[0]
            if rows % accum:
                raise ValueError(f"{rows} batch rows on this rank do not "
                                 f"split into grad_accum={accum} "
                                 "microbatches")

            def split(x, i):
                b = x.shape[0] // accum
                return x[i * b:(i + 1) * b]

            loss = 0.0
            grads = [torch.zeros(p.shape, dtype=acc_dtype, device=p.device)
                     for p in adamw.tree_leaves(params)]
            for i in range(accum):
                mb_loss, mb_grads = grad_fn(
                    params, {k: split(v, i) for k, v in batch.items()})
                grads = [a + g.to(acc_dtype) for a, g in
                         zip(grads, adamw.tree_leaves(mb_grads))]
                loss = loss + mb_loss
            loss = loss / accum
            grads = adamw.tree_unflatten(params, [g / accum for g in grads])
        else:
            loss, grads = grad_fn(params, batch)

        lr_scale = adamw.warmup_cosine(step, warmup, total_steps)
        params, opt_state, metrics = adamw.update(
            params, grads, opt_state, opt_cfg, lr_scale,
            specs=grad_specs if lay is not None else None)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale)
        return params, opt_state, metrics

    train_step.layout, train_step.whole = lay, whole
    train_step.opt_cfg = opt_cfg
    return train_step


def make_eval_step(api) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return api.loss(params, batch)
    return eval_step


def _cut_whole(tree, whole, specs):
    """Each leaf of ``tree`` that has its ``whole`` shape cut to this
    rank's block under ``specs``; a leaf already a block kept."""
    if isinstance(tree, dict):
        return {k: _cut_whole(tree[k], whole[k], specs[k]) for k in tree}
    w = whole.codes if isinstance(whole, adamw.Q8) else whole
    t = tree.codes if isinstance(tree, adamw.Q8) else tree
    if specs is None or tuple(t.shape) != tuple(w.shape):
        return tree
    return shd.local_shard(tree, specs, specs.mesh, specs.mesh.rank)


def jit_train_step(train_step, mesh=None, param_sharding=None,
                   opt_sharding=None, batch_sharding=None, donate=True):
    """The step with explicit shardings (JAX: ``jax.jit`` with
    ``in_shardings``/``out_shardings`` and donated parameters). PyTorch
    runs the step eagerly, so there is nothing to compile: a parameter or
    moment that arrives whole (the whole leaf's shape, from the step's
    ``api.init`` on the meta device) is cut to this rank's block under
    ``param_sharding`` / ``opt_sharding`` and one that arrives as the
    block is kept; a batch array on the host is cut to the rank's rows
    under ``batch_sharding`` ({key: NamedSharding}, or ``data.pipeline.
    batch_specs``' InputSpecs) and put on the mesh's device. The step
    returns blocks. ``donate`` has no effect: the step is functional and
    the caller's tensors are freed when it drops them."""
    whole = getattr(train_step, "whole", None)
    opt_whole = None
    if whole is not None:
        opt_whole = adamw.init(whole, train_step.opt_cfg)

    def step(params, opt_state, batch, step_index):
        if whole is not None and param_sharding is not None:
            params = _cut_whole(params, whole, param_sharding)
        if opt_whole is not None and opt_sharding is not None:
            opt_state = dict(opt_state, **{
                k: _cut_whole(opt_state[k], opt_whole[k], opt_sharding[k])
                for k in ("m", "v")})
        if batch_sharding is not None:
            batch = {k: _rows(v, batch_sharding[k], mesh)
                     for k, v in batch.items()}
        return train_step(params, opt_state, batch, step_index)

    return step


def _rows(v, spec, mesh):
    spec = getattr(spec, "sharding", spec)
    if not isinstance(v, np.ndarray):
        return v
    mesh = mesh if mesh is not None else spec.mesh
    block = shd.local_shard(np.ascontiguousarray(v), spec, mesh, mesh.rank)
    return torch.from_numpy(np.ascontiguousarray(block)).to(mesh.device)
