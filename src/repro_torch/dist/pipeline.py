"""Stage-parallel (pipeline) execution over a "stage" axis (PyTorch port
of the JAX package's ``dist/pipeline.py``).

A GPipe schedule: stage s holds its slice of the stacked per-stage
parameters; microbatches enter stage 0 one tick apart and activations
hop stage -> stage+1 each tick (``dist.ring.ring_shift``, a
``batch_isend_irecv`` over the stage group, where JAX ``ppermute``s).
With S stages and M microbatches the schedule runs M + S - 1 ticks:
bubble fraction (S-1)/(M+S-1), amortized by raising M.

The returned apply is numerically identical to running the stages
sequentially on each microbatch: invalid ticks are left out of the
output accumulation, and the final sum over the stage group both gathers
the last stage's writes and gives every rank the result.
"""

from __future__ import annotations

from typing import Callable

import torch


def _stage_slice(tree, s: int, n_stages: int):
    """Stage ``s``'s entry of each leaf's leading dim: a whole [S, ...]
    leaf is indexed at s, a leaf given as the rank's block [1, ...] at 0."""
    if isinstance(tree, dict):
        return {k: _stage_slice(v, s, n_stages) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_stage_slice(v, s, n_stages) for v in tree)
    if tree.shape[0] == n_stages:
        return tree[s]
    if tree.shape[0] == 1:
        return tree[0]
    raise ValueError(f"a stage parameter of leading dim {tree.shape[0]}: "
                     f"{n_stages} stages (whole) or 1 (this rank's)")


def make_pipelined_apply(stage_fn: Callable, mesh, n_micro: int,
                         axis: str = "stage") -> Callable:
    """Build apply(stage_params, x) -> y, run on every rank of ``mesh``.

    stage_fn: (params_s, act) -> act, one pipeline stage.
    stage_params: pytree with a leading [S] dim (or this rank's [1]).
    x: [n_micro, micro_batch, ...] microbatched input, the same on every
    rank. y: the last stage's outputs, on every rank."""
    from repro_torch.dist.ring import ring_shift
    n_stages = mesh.shape[axis]

    def apply(stage_params, x):
        import torch.distributed as dist
        s = mesh.coords[axis]
        w = _stage_slice(stage_params, s, n_stages)
        outs = torch.zeros_like(x)
        recv = torch.zeros_like(x[0])
        last = n_micro + n_stages - 2
        for t in range(n_micro + n_stages - 1):
            m = t - s                       # microbatch at stage s now
            inp = x[min(max(t, 0), n_micro - 1)] if s == 0 else recv
            y = stage_fn(w, inp)
            # only the last stage's valid ticks write output; the others
            # compute on stale ring data and are dropped here
            if s == n_stages - 1 and 0 <= m < n_micro:
                outs[m] += y.to(outs.dtype)
            if t != last:
                recv = ring_shift(y, mesh, axis)
        group = mesh.group_of(axis)
        if group is not None:
            dist.all_reduce(outs, group=group)
        return outs

    return apply
