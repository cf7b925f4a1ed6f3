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

One card is a mesh of one: ``--mesh auto`` and any shape whose sizes
multiply to 1 run; a larger mesh and ``--distributed`` raise until
distribution is ported (ROADMAP queue 1 item 12c).

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
import math
import os

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


def build_mesh(spec: str) -> dict:
    """The mesh of a ``--mesh`` value, as the axis sizes the JAX launcher
    prints: one card gives ``{"data": 1, "model": 1}`` for "auto", and a
    shape ("DxM" or "PxDxM") is taken when its sizes multiply to 1; any
    other raises."""
    if spec == "auto":
        return {"data": 1, "model": 1}
    dims = tuple(int(x) for x in spec.split("x"))
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    if math.prod(dims) != 1:
        raise NotImplementedError(
            f"a {spec} training mesh: sharded training is not ported yet "
            "(ROADMAP queue 1 item 12c); one card is a mesh of one")
    return dict(zip(axes, dims))


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


def configure(args):
    """(cfg, mesh) of parsed ``args``; raises for ``--distributed`` and a
    mesh larger than one card."""
    from repro_torch.configs import apply_overrides, get_config
    if args.distributed:
        raise NotImplementedError(
            "--distributed: multi-host training is not ported yet (ROADMAP "
            "queue 1 item 12c)")
    cfg = get_config(args.arch)
    overrides = dict(kv.split("=", 1) for kv in args.set)
    if overrides:
        cfg = apply_overrides(cfg, overrides)
    return cfg, build_mesh(args.mesh)


def train(args, cfg, device, fail_hook=None, monitor=None, log_every=10):
    """Train ``cfg`` as ``main`` does, on ``device``, without printing.
    ``fail_hook``, ``monitor`` and ``log_every`` go to the auto-restart
    driver (``resilient_train``). Returns (params, opt_state, history,
    restarts, monitor)."""
    from repro_torch.data.pipeline import make_dataset, shard_batch
    from repro_torch.models.model import get_model
    from repro_torch.optim import adamw
    from repro_torch.train.fault_tolerance import StepMonitor, \
        resilient_train
    from repro_torch.train.loop import make_train_step

    api = get_model(cfg)
    with deterministic():
        params = api.init(seed=0, device=device)
        ocfg = adamw.AdamWConfig(lr=args.lr, int8_moments=cfg.int8_optimizer)
        opt = adamw.init(params, ocfg)
        step_fn = make_train_step(api, ocfg, total_steps=args.steps,
                                  warmup=max(args.steps // 20, 5))

        def step(p, o, batch, s):
            return step_fn(p, o, shard_batch(batch, device=device), s)

        ds = make_dataset(cfg, batch=args.batch, seq=args.seq, seed=0,
                          source=args.data)
        monitor = monitor or StepMonitor()
        params, opt, history, restarts = resilient_train(
            train_step=step, params=params, opt_state=opt, dataset=ds,
            ckpt_dir=args.ckpt, total_steps=args.steps,
            save_every=args.save_every, monitor=monitor, fail_hook=fail_hook,
            log_every=log_every)
    return params, opt, history, restarts, monitor


def main(argv=None, device="cuda", *, fail_hook=None, monitor=None,
         log_every: int = 10):
    """Parse ``argv``, train and print the JAX launcher's lines. The
    keywords (Python only, no flags) reach the driver: a failure injector
    ``fail_hook(step)``, a ``StepMonitor`` to observe the step times, and
    the logging interval of the ``step N  loss X`` lines (the JAX
    launcher's 10). Returns the trained parameters."""
    args = parse_args(argv)
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("the training launcher runs on the card, and "
                           "torch.cuda.is_available() is false (callers "
                           "may ask for the CPU with main(argv, "
                           "device='cpu'))")
    cfg, mesh = configure(args)
    print(f"arch={cfg.name} devices=1 mesh={mesh}")
    params, _, history, restarts, monitor = train(
        args, cfg, device, fail_hook, monitor, log_every)
    for s, l in history:
        print(f"step {s:5d}  loss {l:.4f}")
    print(f"done: restarts={restarts} stragglers={len(monitor.events)}")
    return params


if __name__ == "__main__":
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", CUBLAS_WORKSPACE)
    main()
