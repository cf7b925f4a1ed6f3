"""Training launcher of the port: makes weights from seed 0, trains them
with AdamW on the synthetic (or byte) data pipeline under the
auto-restart driver, checkpointing every ``--save-every`` steps, on the
card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch repro-100m \\
      --batch 8 --seq 256 --steps 40 --lr 1e-3 --save-every 10 --ckpt DIR

The flags and the lines it prints are the JAX launcher's
(``repro.launch.train``): ``arch=... devices=... mesh=...``, one ``step N
loss X`` line per logged step, and ``done: restarts=R stragglers=S``.
``--ckpt DIR`` resumes from the latest step there, and the checkpoints it
writes (``train/checkpoint.py``, the JAX layout) are what
``python -m repro_torch.launch.serve --ckpt DIR`` restores.

``--mesh`` lays the ranks out as the JAX launcher's mesh does
(``launch.mesh.make_train_mesh``: "auto", "DxM" as ("data", "model"),
"PxDxM" as ("pod", "data", "model")). A shape above one rank spawns its
ranks (``launch.mesh.run_ranks``; gloo when they share the card), each
running the same training on its blocks (``train_ranks``): the
parameters and moments cut by ``dist.sharding.param_specs`` under
``DEFAULT_RULES`` (FSDP over "data", tensor-parallel over "model"), the
batch over ("pod", "data"); rank 0 prints the lines, ``devices=`` the
world size. ``--distributed`` joins the group ``torchrun`` made
(``launch.mesh.init_from_env``) and lays ``--mesh`` over its world
("auto" by the JAX rule); outside torchrun it raises. "auto" without
``--distributed`` is one card.

The step is deterministic on the card, so a run that crashes and resumes
from a checkpoint ends bit-equal to one that did not:
``torch.use_deterministic_algorithms(True)`` while it trains (restored
after), which takes the sorting, atomic-free backward of the embedding
gather and of the loss's target gather, with the cuBLAS workspace setting
that mode asks for (``CUBLAS_WORKSPACE_CONFIG``, set before CUDA starts
when the module runs as a program). The launcher runs on the card and
fails where there is none; a caller may ask for the CPU with
``main(argv, device="cpu")`` (a Python keyword, not a flag), as the
tests do.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import math
import os
import sys

import torch

CUBLAS_WORKSPACE = ":4096:8"   # what deterministic cuBLAS asks for


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="repro-100m")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--mesh", default="auto",
                    help='"auto", "DxM" (e.g. 4x2), or "PxDxM"')
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--data", default="synthetic", choices=["synthetic",
                                                            "bytes"])
    ap.add_argument("--save-every", type=int, default=50)
    ap.add_argument("--distributed", action="store_true",
                    help="initialize jax.distributed from env (multi-host)")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (repeatable)")
    return ap.parse_args(argv)


def build_mesh(spec: str, world: int = 1) -> dict:
    """The mesh of a ``--mesh`` value over ``world`` ranks, as the axis
    sizes the JAX launcher prints (``launch.mesh.make_train_mesh``)."""
    from repro_torch.launch.mesh import make_train_mesh
    return make_train_mesh(spec, world)


@contextlib.contextmanager
def deterministic():
    """Deterministic algorithms for the block, the previous setting
    restored after. Every output the step allocates is written in full, so
    the mode's fill of uninitialized memory is left off."""
    from torch.utils import deterministic as det
    was, was_fill = torch.are_deterministic_algorithms_enabled(), \
        det.fill_uninitialized_memory
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    torch.use_deterministic_algorithms(True)
    det.fill_uninitialized_memory = False
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(was)
        det.fill_uninitialized_memory = was_fill


def configure(args, world=None):
    """(cfg, mesh axis sizes) of parsed ``args`` over ``world`` ranks (by
    default: the ranks an explicit ``--mesh`` shape names, one card for
    "auto")."""
    from repro_torch.configs import apply_overrides, get_config
    cfg = get_config(args.arch)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    if world is None:
        world = 1 if args.mesh == "auto" else math.prod(
            int(x) for x in args.mesh.split("x"))
    return cfg, build_mesh(args.mesh, world)


def train(args, cfg, device, fail_hook=None, monitor=None, log_every=10,
          mesh=None):
    """Train ``cfg`` as ``main`` does, on ``device``, without printing;
    on ``mesh`` (above one rank) this rank's part of the mesh's training,
    on the mesh's device. ``fail_hook``, ``monitor`` and ``log_every`` go
    to the auto-restart loop (``resilient_train``). Returns (params,
    opt_state, history, restarts, monitor): on a mesh, the rank's
    blocks."""
    from repro_torch.data.pipeline import make_dataset, shard_batch
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.fault_tolerance import StepMonitor, \
        resilient_train
    from repro_torch.train.loop import make_train_step

    api = get_model(cfg)
    ocfg = adamw.AdamWConfig(lr=args.lr, int8_moments=cfg.int8_optimizer)
    sharded = mesh is not None and mesh.size > 1
    with deterministic():
        if sharded:
            params, opt, pspec, shardings = init_blocks(api, ocfg, mesh)
        else:
            params = api.init(seed=0, device=device)
            opt = adamw.init(params, ocfg)
            pspec = shardings = None
        step_fn = make_train_step(api, ocfg, total_steps=args.steps,
                                  warmup=max(args.steps // 20, 5),
                                  grad_specs=pspec)

        def step(p, o, batch, s):
            if sharded:
                return step_fn(p, o, shard_batch(batch, mesh), s)
            return step_fn(p, o, shard_batch(batch, device=device), s)

        ds = make_dataset(cfg, batch=args.batch, seq=args.seq, seed=0,
                          source=args.data)
        monitor = monitor or StepMonitor()
        params, opt, history, restarts = resilient_train(
            train_step=step, params=params, opt_state=opt, dataset=ds,
            ckpt_dir=args.ckpt, total_steps=args.steps,
            save_every=args.save_every, monitor=monitor, fail_hook=fail_hook,
            log_every=log_every, shardings=shardings)
    return params, opt, history, restarts, monitor


def init_blocks(api, ocfg, mesh, params=None):
    """(params, opt_state, param specs, (param specs, state specs)) of
    this rank of ``mesh``: the whole weights ``params`` (default: made
    from seed 0 on the rank's device, the single-card run's) cut by
    ``param_specs`` under ``DEFAULT_RULES``, the moments zeros of the
    rank's blocks (``adamw.state_specs`` of the whole tree's, which
    decides int8 by the whole leaf)."""
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adamw
    whole = api.init(seed=0, device="meta")
    pspec = shd.param_specs(whole, mesh, shd.DEFAULT_RULES)
    ospec = adamw.state_specs(adamw.init(whole, ocfg), pspec)
    if params is None:
        params = api.init(seed=0, device=mesh.device)
    params = _blocks(params, pspec, mesh)
    opt = adamw.init(whole, ocfg)
    opt = {"m": _zero_blocks(opt["m"], ospec["m"], mesh),
           "v": _zero_blocks(opt["v"], ospec["v"], mesh),
           "count": opt["count"]}
    return params, opt, pspec, (pspec, ospec)


def _blocks(tree, specs, mesh):
    if isinstance(tree, dict):
        return {k: _blocks(tree[k], specs[k], mesh) for k in tree}
    from repro_torch.dist import sharding as shd
    return shd.local_shard(tree, specs, mesh, mesh.rank)


def _zero_blocks(meta, specs, mesh):
    """Zeros of this rank's block of each leaf of a meta moment tree."""
    if isinstance(meta, dict):
        return {k: _zero_blocks(meta[k], specs[k], mesh) for k in meta}
    from repro_torch.dist import sharding as shd
    from repro_torch.optim.adamw import Q8
    block = shd.local_shard(meta, specs, mesh, mesh.rank)

    def zeros(t):
        return torch.zeros(t.shape, dtype=t.dtype, device=mesh.device)
    if isinstance(block, Q8):
        return Q8(zeros(block.codes), zeros(block.scale), block.shape,
                  block.pad)
    return zeros(block)


def block_digests(tree) -> dict:
    """{checkpoint leaf name: sha1 of the bytes of this rank's block}."""
    import hashlib
    from repro_torch.train import checkpoint
    out = {}
    for name, t in checkpoint._flatten(tree):
        t = t.detach().cpu().contiguous()
        raw = t.reshape(-1).view(torch.uint8) if t.numel() else t
        out[name] = hashlib.sha1(raw.numpy().tobytes()).hexdigest()
    return out


def tree_bytes(tree) -> int:
    """The bytes of a tree's tensors (a Q8 moment's codes and scales)."""
    from repro_torch.optim import adamw
    total = 0
    for x in adamw.tree_leaves(tree):
        for t in ((x.codes, x.scale) if isinstance(x, adamw.Q8) else (x,)):
            total += t.numel() * t.element_size()
    return total


def _run(args, cfg, device, mesh, fail_hook, monitor, log_every,
         shape=None):
    """Print the JAX launcher's lines around ``train`` (on a mesh, every
    rank prints them). Returns (params, opt_state)."""
    world = 1 if mesh is None else mesh.size
    shape = dict(mesh.shape) if mesh is not None else shape
    print(f"arch={cfg.name} devices={world} mesh={shape}")
    params, opt, history, restarts, monitor = train(
        args, cfg, device, fail_hook, monitor, log_every, mesh)
    for s, l in history:
        print(f"step {s:5d}  loss {l:.4f}")
    print(f"done: restarts={restarts} stragglers={len(monitor.events)}")
    return params, opt


def train_ranks(mesh, argv, fail_hook=None, log_every=10):
    """One rank of a spawned mesh: train, and return its printed lines
    (``out``), its kernel launches, a digest of each block it holds at the
    end (``digests``, by checkpoint leaf name) and the bytes of its
    parameters plus moments (``bytes``) beside those its specs give it
    (``spec_bytes``) and the whole tree's (``whole_bytes``)."""
    from repro_torch.kernels import _build
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    args = parse_args(argv)
    cfg, _ = configure(args, mesh.size)
    _build.reset_launches()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        params, opt = _run(args, cfg, mesh.device, mesh, fail_hook, None,
                           log_every)
    whole = get_model(cfg).init(seed=0, device="meta")
    moments = adamw.init(whole, adamw.AdamWConfig(
        int8_moments=cfg.int8_optimizer))
    return {"out": buf.getvalue(), "launches": dict(_build.LAUNCHES),
            "digests": block_digests((params, opt)),
            "bytes": tree_bytes((params, opt["m"], opt["v"])),
            "spec_bytes": spec_bytes(whole, moments, mesh),
            "whole_bytes": tree_bytes((whole, moments["m"], moments["v"]))}


def spec_bytes(whole, moments, mesh) -> int:
    """The bytes of the parameters and moments a rank of ``mesh`` holds as
    ``param_specs`` under ``DEFAULT_RULES`` (and ``adamw.state_specs``)
    cut them, from the whole trees on the meta device."""
    from repro_torch.dist import sharding as shd
    from repro_torch.optim import adamw
    pspec = shd.param_specs(whole, mesh, shd.DEFAULT_RULES)
    ospec = adamw.state_specs(moments, pspec)
    return tree_bytes((_blocks(whole, pspec, mesh),
                       _blocks(moments["m"], ospec["m"], mesh),
                       _blocks(moments["v"], ospec["v"], mesh)))


def main(argv=None, device="cuda", *, fail_hook=None, monitor=None,
         log_every: int = 10):
    """Parse ``argv``, train and print the JAX launcher's lines. The
    keywords (Python only, no flags) reach the driver: a failure injector
    ``fail_hook(step)``, a ``StepMonitor`` to observe the step times, and
    the logging interval of the ``step N  loss X`` lines (the JAX
    launcher's 10). Returns the trained parameters; for a mesh this call
    spawned, each rank's result (:func:`train_ranks`; ``fail_hook`` goes
    to every rank, ``monitor`` to none)."""
    args = parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the training launcher runs on the card, and "
                           "torch.cuda.is_available() is false (callers "
                           "may ask for the CPU with main(argv, "
                           "device='cpu'))")
    from repro_torch.launch import mesh as M
    if args.distributed:
        rank_device = M.init_from_env(device)
        if rank_device is None:
            raise RuntimeError(
                "--distributed joins the process group torchrun describes, "
                "and RANK and WORLD_SIZE are not set: launch under torchrun "
                "(or drop --distributed: --mesh DxM spawns its ranks)")
        import torch.distributed as dist
        cfg, shape = configure(args, dist.get_world_size())
        mesh = M.make_host_mesh(shape, device=rank_device)
        params, _ = _run(args, cfg, rank_device, mesh, fail_hook, monitor,
                         log_every) if mesh.rank == 0 else _quiet(
            args, cfg, rank_device, mesh, fail_hook, monitor, log_every)
        return params
    cfg, shape = configure(args)
    world = math.prod(shape.values())
    if world == 1:
        params, _ = _run(args, cfg, device, None, fail_hook, monitor,
                         log_every, shape)
        return params
    argv = sys.argv[1:] if argv is None else list(argv)
    results = M.run_ranks(train_ranks, world, device, argv, fail_hook,
                          log_every, mesh_shape=shape)
    print(results[0]["out"], end="")
    return results


def _quiet(*a):
    with contextlib.redirect_stdout(io.StringIO()):
        return _run(*a)


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    main()
