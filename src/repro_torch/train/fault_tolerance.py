"""Fault tolerance: the step-time watchdog, failure injection and the
auto-restart driver (PyTorch port of ``repro.train.fault_tolerance``).

* checkpoints every ``save_every`` steps through the asynchronous saver
  (``train/checkpoint.py``): lost work is bounded by the interval;
* the data pipeline is random-access by step, so after a restore at step
  k, batch k+1 is bit-identical to the uninterrupted run's, and with a
  deterministic step the resumed run ends bit-equal to it;
* ``StepMonitor`` flags stragglers (a step slower than ``factor`` x the
  EMA of step times);
* ``FailureInjector`` raises at given steps to exercise the restart path.

Where JAX blocks on the loss (``jax.block_until_ready``), the port
synchronises the loss's device, so a step's time is its device time and
a fault inside the step raises inside it. On a mesh of ranks
(``shardings=``) every rank runs the loop on its blocks: the restores
cut the checkpoint's whole leaves to the rank's blocks, and the saves
gather the blocks to rank 0, which writes them.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Optional

import torch

from repro_torch.train import checkpoint as ckpt_lib

log = logging.getLogger("repro_torch.fault")


@dataclasses.dataclass
class StepMonitor:
    """EMA step-time watchdog; straggler events feed the restart policy."""
    ema_decay: float = 0.9
    straggler_factor: float = 3.0
    warmup_steps: int = 3
    _ema: Optional[float] = None
    _count: int = 0
    events: list = dataclasses.field(default_factory=list)

    def observe(self, step: int, dt: float) -> bool:
        self._count += 1
        if self._ema is None:
            self._ema = dt
            return False
        is_straggler = (self._count > self.warmup_steps
                        and dt > self.straggler_factor * self._ema)
        if is_straggler:
            self.events.append((step, dt, self._ema))
            log.warning("straggler: step %d took %.3fs (ema %.3fs)",
                        step, dt, self._ema)
        self._ema = self.ema_decay * self._ema + (1 - self.ema_decay) * dt
        return is_straggler


class FailureInjector:
    """Raises RuntimeError at the given global steps (once each)."""

    def __init__(self, fail_at=()):
        self.remaining = set(fail_at)

    def __call__(self, step: int):
        if step in self.remaining:
            self.remaining.discard(step)
            raise RuntimeError(f"injected failure at step {step}")


def _block_until_ready(t: torch.Tensor) -> None:
    if t.is_cuda:
        torch.cuda.synchronize(t.device)


def resilient_train(*, train_step: Callable, params, opt_state, dataset,
                    ckpt_dir: str, total_steps: int, save_every: int = 20,
                    max_restarts: int = 5, fail_hook: Optional[Callable] = None,
                    monitor: Optional[StepMonitor] = None,
                    shardings=None, log_every: int = 10):
    """Run to ``total_steps``, checkpointing and auto-restarting on
    failure (RuntimeError, FloatingPointError). Resumes from the latest
    checkpoint under ``ckpt_dir`` if there is one.

    ``shardings`` (the blocks' shardings of ``(params, opt_state)`` on a
    mesh; every rank of the mesh runs this loop): both restores lay the
    checkpoint onto this rank's blocks, and every save gathers the blocks
    to rank 0, which writes them; the ranks meet after each wait for a
    write, so all read the same latest step. A failure must be raised on
    every rank at the same step (an injector on each), so that the
    collectives stay in step; a rank that dies stops the spawn
    (``launch.mesh.run_ranks`` reports it).

    Returns (params, opt_state, metrics_history, restarts)."""
    saver = ckpt_lib.AsyncSaver()
    mesh = None if shardings is None else ckpt_lib.mesh_of(shardings)

    def meet():
        if mesh is not None and mesh.size > 1:
            import torch.distributed as dist
            dist.barrier(group=mesh.host_group)
    monitor = monitor or StepMonitor()
    restarts = 0
    history = []
    step = 0

    # resume if a checkpoint already exists
    existing = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
    if existing is not None:
        (params, opt_state), step = ckpt_lib.restore(
            ckpt_dir, (params, opt_state), shardings=shardings)
        log.info("resumed from step %d", step)

    while step < total_steps:
        try:
            while step < total_steps:
                batch = dataset.batch_at(step)
                t0 = time.monotonic()
                if fail_hook is not None:
                    fail_hook(step)
                params, opt_state, metrics = train_step(
                    params, opt_state, batch, step)
                _block_until_ready(metrics["loss"])
                dt = time.monotonic() - t0
                monitor.observe(step, dt)
                step += 1
                if step % log_every == 0 or step == total_steps:
                    history.append((step, float(metrics["loss"])))
                if ckpt_dir and step % save_every == 0:
                    saver.save(ckpt_dir, step, (params, opt_state),
                               shardings=shardings)
            break
        except (RuntimeError, FloatingPointError) as e:  # node failure class
            restarts += 1
            log.warning("failure at step %d: %s (restart %d/%d)",
                        step, e, restarts, max_restarts)
            if restarts > max_restarts:
                raise
            saver.wait()
            meet()
            latest = ckpt_lib.latest_step(ckpt_dir) if ckpt_dir else None
            if latest is None:
                step = 0  # restart from scratch
                continue
            (params, opt_state), step = ckpt_lib.restore(
                ckpt_dir, (params, opt_state), shardings=shardings)
            log.info("restored step %d", step)

    saver.wait()
    if ckpt_dir:
        ckpt_lib.save(ckpt_dir, step, (params, opt_state),
                      shardings=shardings)
    meet()
    return params, opt_state, history, restarts
