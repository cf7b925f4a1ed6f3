"""Serving meshes of processes (PyTorch port of the JAX package's
``launch/mesh.py``, the part that serving calls).

A :class:`Mesh` is a ("data", "model") grid of ranks, one process each,
built with ``torch.distributed.device_mesh.init_device_mesh`` over the
initialized process group; its ``.shape`` is the mapping that
``dist.sharding.resolve_spec`` reads, as a JAX mesh's is. JAX runs a mesh
from one process over many devices; PyTorch runs one process per rank, so
the JAX package's ``force_host_device_count`` (more host devices for one
process) has no meaning here. Its place is taken by :func:`run_ranks`,
which spawns the ranks, each running the same function, and returns their
results; under ``torchrun`` the launcher joins the group torchrun made
instead (:func:`init_from_env`).

A rank's device is ``cuda:{rank % device_count}``. With a card per rank
the ranks talk over NCCL; ranks that share a card talk over gloo (NCCL
refuses two ranks on one card): the kernels still run on the card, and
each collective goes through the host. No rank falls back to the CPU: a
mesh asked for on the card fails where there is none. The production
meshes of the dry-run tools wait for ROADMAP queue 1 item 12d.

Importing this module starts no process and joins no group.
"""

from __future__ import annotations

import os
import queue as queue_mod
import shutil
import sys
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional

import torch


def parse_mesh_shape(spec: str):
    """Parse a ``--mesh-shape`` string into (data, model) sizes.

    Accepts a bare model-axis size ("8" -> data=1, model=8) or an
    explicit "DATAxMODEL" / "DATA,MODEL" pair ("2x4" -> data=2, model=4).

    >>> parse_mesh_shape("8")
    (1, 8)
    >>> parse_mesh_shape("2x4")
    (2, 4)
    """
    parts = [int(p) for p in spec.lower().replace("x", ",").split(",") if p]
    if not parts or any(p < 1 for p in parts) or len(parts) > 2:
        raise ValueError(f"mesh shape {spec!r}: expected 'MODEL' or "
                         "'DATAxMODEL' with positive sizes")
    if len(parts) == 1:
        return 1, parts[0]
    return parts[0], parts[1]


class Mesh:
    """This process's place in a ("data", "model") mesh of ranks.

    ``shape``: {"data": D, "model": M}; ``rank``: this process's rank
    (row-major over the axes); ``device``: its device (the card unless the
    caller passes ``device="cpu"``); ``group``: the process group of its
    "model" row (None for a mesh of one), over which the tensor-parallel
    collectives run; ``data_group``: the group of its "data" column, over
    which a step's slot rows are gathered; ``host_group``: a gloo group of
    the whole world for host values (the engine's clock, read from global
    rank 0), which NCCL cannot carry; ``backend``: "nccl" or "gloo";
    ``device_mesh``: the ``DeviceMesh``."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int, rank: int = 0, device="cuda",
                 group=None, host_group=None, backend: Optional[str] = None,
                 device_mesh=None, data_group=None):
        self.shape: Dict[str, int] = {"data": data, "model": model}
        self.rank = rank
        self.device = torch.device(device)
        self.group = group
        self.data_group = data_group
        self.host_group = host_group
        self.backend = backend
        self.device_mesh = device_mesh

    @property
    def size(self) -> int:
        return self.shape["data"] * self.shape["model"]

    @property
    def model_rank(self) -> int:
        return self.rank % self.shape["model"]

    @property
    def data_rank(self) -> int:
        return self.rank // self.shape["model"]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


def single_device_mesh(device="cuda") -> Mesh:
    """A (1, 1) mesh: every spec resolves to replication, and an engine on
    it runs the single-device program."""
    return Mesh(1, 1, 0, device)


def _rank_device(rank: int, device) -> torch.device:
    dev = torch.device(device)
    if dev.type != "cuda":
        return dev
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("a mesh on the card, and torch.cuda reports no "
                           "device")
    return torch.device("cuda", rank % count)


def backend_for(world: int, device) -> str:
    """NCCL with a card per rank, gloo when ranks share a card or run on
    the host."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def make_host_mesh(data: int, model: int, device=None) -> Mesh:
    """The (data, model) mesh over the initialized process group, whose
    size must be ``data * model``; ``device`` is this rank's device
    (default: its card, ``cuda:{rank % device_count}``, whichever the
    backend; the host only when the caller passes ``device="cpu"``). A
    (1, 1) mesh needs no group."""
    import torch.distributed as dist
    if data * model == 1:
        return single_device_mesh("cuda" if device is None else device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {data}x{model} mesh needs the ranks' process group: run "
            "under repro_torch.launch.mesh.run_ranks or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != data * model:
        raise ValueError(f"a {data}x{model} mesh over {world} ranks")
    backend = dist.get_backend()
    device = _rank_device(rank, "cuda" if device is None else device)
    from torch.distributed.device_mesh import init_device_mesh
    # a gloo group carries tensors of either device, so its DeviceMesh is
    # made on the host: ranks that share a card need no device of their own
    dm = init_device_mesh("cuda" if backend == "nccl" else "cpu",
                          (data, model), mesh_dim_names=("data", "model"))
    # every rank makes every group, in the same order
    host_group = dist.new_group(backend="gloo")
    return Mesh(data, model, rank, device, dm.get_group("model"), host_group,
                backend, dm, dm.get_group("data"))


def make_serve_mesh(spec: str, device=None) -> Mesh:
    """The ("data", "model") serving mesh of a ``--mesh-shape`` value over
    the initialized process group (a malformed value raises the parser's
    ValueError)."""
    data, model = parse_mesh_shape(spec)
    return make_host_mesh(data, model, device)


def init_from_env(device) -> Optional[torch.device]:
    """Join the process group ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``...), with this rank on
    ``cuda:{LOCAL_RANK % device_count}`` for a card. Returns this rank's
    device, or None outside torchrun."""
    if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
        return None
    import torch.distributed as dist
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = _rank_device(int(os.environ.get("LOCAL_RANK", rank)), device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group(backend_for(world, device),
                                init_method="env://", rank=rank,
                                world_size=world)
    return dev


def _rank_main(fn, rank, world, shape, device, backend, init, threads, out,
               args):
    import torch.distributed as dist
    try:
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
        mesh = make_host_mesh(*shape, device=dev)
        out.put((rank, True, fn(mesh, *args)))
    except BaseException:
        out.put((rank, False, traceback.format_exc()))
        raise
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


# how long run_ranks waits for every rank's result
RANKS_TIMEOUT_S = 1800.0


def run_ranks(fn: Callable, world: int, device, *args,
              mesh_shape=None, threads: Optional[int] = None) -> List[Any]:
    """Run ``fn(mesh, *args)`` in ``world`` spawned processes, one rank of a
    ``mesh_shape`` mesh (default (1, world)) each, and return their results
    in rank order.

    ``fn`` must be importable from a module (spawned processes re-import
    it) and should return host values (numpy, lists). Ranks meet through a
    file under a fresh temporary directory (``init_method="file://..."``),
    never a fixed port, so concurrent runs cannot collide. ``threads`` sets
    each rank's intra-op threads. The backend is printed on stderr. A rank
    that raises or dies, or ranks that have not all finished after
    ``RANKS_TIMEOUT_S``, stop every rank, and the failure is raised here
    with the rank's traceback."""
    import torch.multiprocessing as mp
    shape = tuple(mesh_shape or (1, world))
    if shape[0] * shape[1] != world:
        raise ValueError(f"mesh {shape} over {world} ranks")
    backend = backend_for(world, device)
    # on stderr: a launcher's stdout stays the JAX lines
    print(f"run_ranks: {world} ranks on {torch.device(device).type}, "
          f"mesh {shape[0]}x{shape[1]}, backend {backend}",
          file=sys.stderr, flush=True)
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    procs = [ctx.Process(target=_rank_main,
                         args=(fn, r, world, shape, str(device), backend,
                               init, threads, out, args))
             for r in range(world)]
    results: Dict[int, Any] = {}
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        while len(results) < world:
            try:
                rank, ok, value = out.get(timeout=1.0)
            except queue_mod.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode is not None]
                # a rank flushes its result into the pipe before it exits:
                # look at the pipe only after reading the exit codes, so a
                # result that came in since the get above is not lost
                if dead and out.empty():
                    raise RuntimeError(f"rank(s) {dead} exited without a "
                                       "result (exit codes "
                                       f"{[procs[r].exitcode for r in dead]})")
                if time.monotonic() > deadline:
                    raise TimeoutError(f"ranks did not finish in "
                                       f"{RANKS_TIMEOUT_S} s")
                continue
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{value}")
            results[rank] = value
        for p in procs:
            p.join()
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
        for p in procs:
            p.join()
        shutil.rmtree(tmp, ignore_errors=True)
    return [results[r] for r in range(world)]
