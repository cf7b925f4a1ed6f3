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

Not ported: ``grad_specs`` (sharding constraints on the gradients; any
value other than None raises) and ``jit_train_step`` (``jax.jit`` with
shardings and donation), whose parts wait for distribution (ROADMAP
queue 1 item 12c); PyTorch runs the step eagerly.
"""

from __future__ import annotations

from typing import Callable

import torch

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


def make_train_step(api, opt_cfg: adamw.AdamWConfig, total_steps: int = 10000,
                    warmup: int = 100, grad_specs=None) -> Callable:
    """The training step of ``api`` (a ``models.model.ModelAPI``) under
    ``opt_cfg``, with the warmup-cosine schedule over ``total_steps``.
    Metrics: ``loss`` (the mean over microbatches), ``lr_scale`` and
    ``grad_norm`` (before the clip)."""
    if grad_specs is not None:
        raise NotImplementedError(
            "make_train_step(grad_specs=): sharding constraints on the "
            "gradients are not ported yet (ROADMAP queue 1 item 12c)")
    cfg = api.cfg
    accum = max(cfg.grad_accum, 1)
    grad_fn = _grad_fn(api)
    acc_dtype = torch.bfloat16 if cfg.grad_accum_dtype == "bfloat16" \
        else torch.float32

    def train_step(params, opt_state, batch, step):
        if accum > 1:
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
        params, opt_state, metrics = adamw.update(params, grads, opt_state,
                                                  opt_cfg, lr_scale)
        metrics = dict(metrics, loss=loss, lr_scale=lr_scale)
        return params, opt_state, metrics

    return train_step


def make_eval_step(api) -> Callable:
    def eval_step(params, batch):
        with torch.no_grad():
            return api.loss(params, batch)
    return eval_step
