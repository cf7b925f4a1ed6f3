"""Meshes of processes (PyTorch port of the JAX package's
``launch/mesh.py``, the part that serving and training call).

A :class:`Mesh` is a grid of ranks over named axes, one process each: the
("data", "model") serving mesh, the training launcher's ("data",
"model") or ("pod", "data", "model") mesh (:func:`make_train_mesh`, the
JAX launcher's ``--mesh`` rule), or one axis over the whole world such as
``{"stage": 4}``. It is built over the initialized process group with one
process group per combination of its axes; its ``.shape`` is the mapping
that ``dist.sharding.resolve_spec`` reads, as a JAX mesh's is. JAX runs a
mesh from one process over many devices; PyTorch runs one process per
rank, so the JAX package's ``force_host_device_count`` (more host devices
for one process) has no meaning here. Its place is taken by
:func:`run_ranks`, which spawns the ranks, each running the same
function, and returns their results; under ``torchrun`` a launcher joins
the group torchrun made instead (:func:`init_from_env`).

A rank's device is ``cuda:{rank % device_count}``. With a card per rank
the ranks talk over NCCL; ranks that share a card talk over gloo (NCCL
refuses two ranks on one card): the kernels still run on the card, and
each collective goes through the host. No rank falls back to the CPU: a
mesh asked for on the card fails where there is none. The dry-run tools'
production meshes (:func:`make_production_mesh`, over
:func:`make_fake_mesh`) are one rank's place in 256 or 512 ranks on the
meta device, over a process group that moves no data.

Importing this module starts no process and joins no group.
"""

from __future__ import annotations

import itertools
import math
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
    """This process's place in a mesh of ranks over named axes.

    ``shape``: the axis sizes in order, {"data": D, "model": M} for a
    serving mesh (``Mesh(D, M, ...)``), or any ordered axes of "pod",
    "data", "model" and "stage" (``axes=``); ``rank``: this process's rank
    (row-major over the axes); ``device``: its device (the card unless the
    caller passes ``device="cpu"``); ``groups``: {axes: process group} for
    every combination of the axes of size above 1 (in mesh order), the
    group of the ranks that share this rank's coordinates on the other
    axes; ``group``: the "model" group (None for a model axis of one),
    over which the tensor-parallel collectives run; ``data_group``: the
    "data" group, over which a step's slot rows are gathered;
    ``host_group``: a gloo group of the whole world for host values (the
    engine's clock, read from global rank 0; a checkpoint's blocks), which
    NCCL cannot carry; ``backend``: "nccl" or "gloo"."""

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0,
                 device="cuda", group=None, host_group=None,
                 backend: Optional[str] = None, data_group=None, *,
                 axes: Optional[Dict[str, int]] = None, groups=None):
        self.shape: Dict[str, int] = dict(axes) if axes is not None \
            else {"data": data, "model": model}
        unknown = set(self.shape) - set(AXES)
        if unknown:
            raise ValueError(f"mesh axes {sorted(unknown)}: a mesh names "
                             f"its axes from {AXES}")
        self.rank = rank
        self.device = torch.device(device)
        self.groups = dict(groups or {})
        for axis, g in (("model", group), ("data", data_group)):
            if g is not None:
                self.groups.setdefault((axis,), g)
        self.group = self.groups.get(("model",))
        self.data_group = self.groups.get(("data",))
        self.host_group = host_group
        self.backend = backend

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    @property
    def coords(self) -> Dict[str, int]:
        """This rank's index along each axis."""
        coords, r = {}, self.rank
        for ax, n in reversed(list(self.shape.items())):
            coords[ax] = r % n
            r //= n
        return coords

    @property
    def model_rank(self) -> int:
        return self.coords.get("model", 0)

    @property
    def data_rank(self) -> int:
        return self.coords.get("data", 0)

    def axis_size(self, *axes: str) -> int:
        return math.prod(self.shape.get(a, 1) for a in axes)

    def group_of(self, *axes: str):
        """The process group over ``axes`` (those of size 1 dropped), or
        None when they span one rank: a collective over None is skipped."""
        key = tuple(a for a in self.shape if a in axes and self.shape[a] > 1)
        return self.groups.get(key) if key else None

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, device={self.device}, "
                f"backend={self.backend})")


# the axis names a mesh may use: the JAX package's meshes' ("pod", "data",
# "model") and the pipeline's "stage"
AXES = ("pod", "data", "model", "stage")


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


def _as_axes(shape) -> Dict[str, int]:
    """{axis: size} of a (data, model) pair or an axis mapping."""
    if isinstance(shape, dict):
        return dict(shape)
    data, model = shape
    return {"data": data, "model": model}


def _make_groups(axes: Dict[str, int], rank: int) -> dict:
    """{combination of axes: this rank's group over it}, for every
    combination of the axes of size above 1. Every rank makes every group
    of every combination, in the same order, as ``new_group`` asks."""
    import torch.distributed as dist
    names = list(axes)
    sizes = [axes[a] for a in names]
    coords = list(itertools.product(*(range(n) for n in sizes)))
    wide = [a for a in names if axes[a] > 1]
    groups = {}
    for k in range(1, len(wide) + 1):
        for combo in itertools.combinations(wide, k):
            members: Dict[tuple, list] = {}
            for r, c in enumerate(coords):
                key = tuple(ci for a, ci in zip(names, c) if a not in combo)
                members.setdefault(key, []).append(r)
            for ranks in members.values():
                g = dist.new_group(ranks)
                if rank in ranks:
                    groups[combo] = g
    return groups


def make_host_mesh(data=1, model: int = 1, device=None) -> Mesh:
    """The mesh over the initialized process group, whose size must be the
    mesh's: ``(data, model)`` sizes, or an axis mapping as ``data`` (such
    as ``{"pod": 2, "data": 1, "model": 2}`` or ``{"stage": 4}``);
    ``device`` is this rank's device (default: its card, ``cuda:{rank %
    device_count}``, whichever the backend; the host only when the caller
    passes ``device="cpu"``). A mesh of one needs no group."""
    import torch.distributed as dist
    axes = _as_axes(data if isinstance(data, dict) else (data, model))
    n = math.prod(axes.values())
    if n == 1:
        return Mesh(axes=axes, device="cuda" if device is None else device)
    if not dist.is_initialized():
        raise RuntimeError(
            f"a {_spec_name(axes)} mesh needs the ranks' process group: run "
            "under repro_torch.launch.mesh.run_ranks or torchrun")
    world, rank = dist.get_world_size(), dist.get_rank()
    if world != n:
        raise ValueError(f"a {_spec_name(axes)} mesh over {world} ranks")
    backend = dist.get_backend()
    device = _rank_device(rank, "cuda" if device is None else device)
    groups = _make_groups(axes, rank)
    host_group = dist.new_group(backend="gloo")
    return Mesh(rank=rank, device=device, host_group=host_group,
                backend=backend, axes=axes, groups=groups)


def make_production_mesh(*, multi_pod: bool = False, rank: int = 0) -> Mesh:
    """Rank ``rank``'s place in a production mesh of the dry-run tools:
    (16, 16) ("data", "model"), or (2, 16, 16) ("pod", "data", "model")
    with ``multi_pod``, the JAX package's shapes, on the meta device
    (:func:`make_fake_mesh`)."""
    return make_fake_mesh({"pod": 2, "data": 16, "model": 16} if multi_pod
                          else {"data": 16, "model": 16}, rank)


def make_fake_mesh(axes: Dict[str, int], rank: int = 0) -> Mesh:
    """Rank ``rank``'s place in a mesh of ``axes`` on the meta device, in
    this one process. Its groups are made over torch's "fake" backend
    (``torch.testing._internal.distributed.fake_pg``, torch's internal
    test backend): every collective returns at once and moves nothing, so
    one process runs one rank's program with every collective in place,
    on tensors that hold no data. There is no gloo host group. The fake
    group is the process's default group: a mesh of another world size or
    rank destroys it and makes it again, and a process whose default group
    is another backend's raises."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    axes = dict(axes)
    world = math.prod(axes.values())
    if dist.is_initialized():
        if dist.get_backend() != "fake":
            raise RuntimeError("a fake mesh needs the fake process group; "
                               f"this process is in a {dist.get_backend()} "
                               "group")
        if dist.get_world_size() != world or dist.get_rank() != rank:
            dist.destroy_process_group()
    if not dist.is_initialized():
        dist.init_process_group("fake", store=FakeStore(), rank=rank,
                                world_size=world)
    return Mesh(rank=rank, device="meta", backend="fake", axes=axes,
                groups=_make_groups(axes, rank))


def _spec_name(axes: Dict[str, int]) -> str:
    return "x".join(str(n) for n in axes.values())


def make_train_mesh(spec: str, world: int) -> Dict[str, int]:
    """The axis sizes of a training launcher's ``--mesh`` over ``world``
    ranks, by the JAX launcher's rule (``repro.launch.train.build_mesh``):
    "auto" puts the largest power of two up to 8 that divides the world on
    "model" and the rest on "data"; "DxM" is ("data", "model") and "PxDxM"
    ("pod", "data", "model"). A shape whose sizes do not multiply to the
    world raises.

    >>> make_train_mesh("auto", 8)
    {'data': 1, 'model': 8}
    >>> make_train_mesh("2x1x2", 4)
    {'pod': 2, 'data': 1, 'model': 2}
    """
    if spec == "auto":
        model = 1
        while model * 2 <= world and world % (model * 2) == 0 and model < 8:
            model *= 2
        return {"data": world // model, "model": model}
    dims = tuple(int(x) for x in spec.split("x"))
    if len(dims) not in (2, 3) or any(d < 1 for d in dims):
        raise ValueError(f"--mesh {spec!r}: expected 'auto', 'DxM' or "
                         "'PxDxM' with positive sizes")
    axes = {2: ("data", "model"), 3: ("pod", "data", "model")}[len(dims)]
    if math.prod(dims) != world:
        raise ValueError(f"--mesh {spec}: {math.prod(dims)} ranks, and the "
                         f"world has {world}")
    return dict(zip(axes, dims))


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


def _rank_main(job, rank, world, shape, device, backend, init, threads, out):
    import pickle
    import torch.distributed as dist
    try:
        with open(job, "rb") as f:
            fn, args = pickle.load(f)
        if threads:
            torch.set_num_threads(threads)
        dev = _rank_device(rank, device)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist.init_process_group(backend, init_method=init, rank=rank,
                                world_size=world)
        mesh = make_host_mesh(shape, device=dev)
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
    ``mesh_shape`` mesh (default (1, world); a (data, model) pair or an
    axis mapping such as ``{"stage": 4}``) each, and return their results
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
    shape = _as_axes(mesh_shape or (1, world))
    if math.prod(shape.values()) != world:
        raise ValueError(f"mesh {shape} over {world} ranks")
    backend = backend_for(world, device)
    # on stderr: a launcher's stdout stays the JAX lines
    print(f"run_ranks: {world} ranks on {torch.device(device).type}, "
          f"mesh {_spec_name(shape)}, backend {backend}",
          file=sys.stderr, flush=True)
    import pickle
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    tmp = tempfile.mkdtemp(prefix="repro_torch_ranks_")
    init = "file://" + os.path.join(tmp, "rendezvous")
    # the function and its arguments go through a file: a process's
    # arguments larger than a pipe's buffer block its start until the child
    # has imported torch, which would start the ranks one after another
    job = os.path.join(tmp, "job.pkl")
    with open(job, "wb") as f:
        pickle.dump((fn, args), f)
    procs = [ctx.Process(target=_rank_main,
                         args=(job, r, world, shape, str(device), backend,
                               init, threads, out))
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
