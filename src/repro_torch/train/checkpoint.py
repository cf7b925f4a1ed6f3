"""Checkpoints in the JAX package's on-disk layout (PyTorch port of
``repro.train.checkpoint``).

Layout: ``<dir>/step_<N>/`` holding one ``.npy`` per tree leaf (path
names joined by ``__``; a QTensor's arrays under ``@qt_codes``,
``@qt_scale`` and, when it carries one, ``@qt_codebook``; a Q8
moment's under ``@q8_codes`` and ``@q8_scale``) and ``manifest.json``
(step, extra, each leaf's shape and dtype). Writes are atomic (a tmp dir,
then a rename); a ``latest`` marker advances last; all but ``keep`` steps
are removed. The files are byte for byte those the JAX package writes for
the same values, so a checkpoint that either package writes, the other
restores.

bfloat16 leaves: numpy has no bfloat16 of its own. The JAX package saves
them as ml_dtypes arrays, whose ``.npy`` header says ``<V2`` (raw two-byte
voids); ``np.load`` gives them back as voids, and ``restore`` reinterprets
their bits against the dtype the manifest recorded at save time. Here a
bfloat16 tensor is written as its 16-bit patterns under that same header,
and read back by viewing the bits as ``torch.bfloat16``: no value passes
through float32.

A QTensor's table is a function of its mode and bits in both packages
(``resolve_codebook``), and ``quantize`` stores none, so its
``@qt_codebook`` is written only when a QTensor carries one explicitly.
``restore`` takes a ``device``, or ``shardings``: then each rank reads
each leaf (through ``mmap``) and keeps its block, as JAX's ``device_put``
against shardings lays a restored tree onto a mesh. ``save`` (and
``AsyncSaver.save``) from a mesh takes the ``shardings`` of the ranks'
blocks: the blocks are gathered to rank 0 over the mesh's host group,
which writes the whole leaves once, so a checkpoint does not depend on
the mesh that wrote it (JAX's elastic reshard): one saved on (2, 2)
restores on (1, 2) or one device.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import threading
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core.quantization import QTensor, qslice
from repro_torch.dist import sharding as shd
from repro_torch.optim.adamw import Q8, tree_leaves

_SEP = "__"
_BF16_DESCR = "<V2"     # the header numpy writes for an ml_dtypes bfloat16


def _flatten(tree):
    """(path, leaf) pairs; QTensor and Q8 are decomposed into their
    arrays."""
    out = []

    def visit(path, node):
        if isinstance(node, dict):
            for k in sorted(node):
                visit(path + [str(k)], node[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                visit(path + [str(i)], v)
        elif isinstance(node, QTensor):
            visit(path + ["@qt_codes"], node.codes)
            visit(path + ["@qt_scale"], node.scale)
            if node.codebook is not None:
                visit(path + ["@qt_codebook"], node.codebook)
        elif isinstance(node, Q8):
            visit(path + ["@q8_codes"], node.codes)
            visit(path + ["@q8_scale"], node.scale)
        else:
            out.append((_SEP.join(path), node))

    visit([], tree)
    return out


def _host(leaf):
    """A leaf on the host: (numpy array to write, dtype name, header
    descr or None for numpy's own)."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy(), "bfloat16", _BF16_DESCR
        arr = t.numpy()
    else:
        arr = np.asarray(leaf)
    return arr, str(arr.dtype), None


def _write_npy(path: str, arr: np.ndarray, descr: Optional[str]) -> None:
    if descr is None:
        np.save(path, arr)
        return
    arr = np.ascontiguousarray(arr)
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(
            f, {"descr": descr, "fortran_order": False, "shape": arr.shape})
        f.write(arr.tobytes())


def save(ckpt_dir: str, step: int, tree, extra: Optional[dict] = None,
         keep: int = 3, shardings=None) -> Optional[str]:
    """Synchronous atomic save. Returns the final step directory.
    ``shardings`` (of ``tree``'s blocks on a mesh; every rank calls): the
    whole tree is gathered to rank 0 and written there; the other ranks
    write nothing and get None."""
    if shardings is not None:
        tree = gather_whole(tree, shardings)
        if tree is None:
            return None
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    manifest = {"step": step, "extra": extra or {}, "leaves": {}}
    for name, leaf in _flatten(tree):
        arr, dtype, descr = _host(leaf)
        _write_npy(os.path.join(tmp, name + ".npy"), arr, descr)
        manifest["leaves"][name] = {"shape": list(arr.shape), "dtype": dtype}
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    with open(os.path.join(ckpt_dir, "latest.tmp"), "w") as f:
        f.write(os.path.basename(final))
    os.replace(os.path.join(ckpt_dir, "latest.tmp"),
               os.path.join(ckpt_dir, "latest"))
    _gc(ckpt_dir, keep)
    return final


def _snapshot(tree):
    """The tree with every tensor copied to the host (QTensor and Q8
    kept as such)."""
    if isinstance(tree, dict):
        return {k: _snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_snapshot(v) for v in tree)
    if isinstance(tree, QTensor):
        return tree.to("cpu")
    if isinstance(tree, Q8):
        return Q8(tree.codes.detach().cpu().clone(),
                  tree.scale.detach().cpu().clone(), tree.shape, tree.pad)
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().clone()
    return tree


def mesh_of(shardings):
    """The mesh of a shardings tree (None when no leaf names one)."""
    return next((s.mesh for s in tree_leaves(shardings) if s is not None),
                None)


def _gather_array(block: torch.Tensor, spec, mesh) -> Optional[torch.Tensor]:
    """Rank 0's whole tensor of every rank's ``block`` (cut by ``spec``),
    gathered as bytes over the host group (None on the other ranks)."""
    import torch.distributed as dist
    t = block.detach().cpu().contiguous()
    raw = t.reshape(-1).view(torch.uint8) if t.numel() else \
        torch.zeros(0, dtype=torch.uint8)
    rank0 = mesh.rank == 0
    parts = [torch.empty_like(raw) for _ in range(mesh.size)] \
        if rank0 else None
    dist.gather(raw, parts, dst=0, group=mesh.host_group)
    if not rank0:
        return None
    shape = shd.whole_shape(t.shape, spec, mesh)
    whole = torch.empty(shape, dtype=t.dtype)
    for r, part in enumerate(parts):
        whole[shd.block_index(shape, spec, mesh, r)] = \
            part.view(t.dtype).reshape(t.shape)
    return whole


def gather_whole(tree, shardings):
    """The whole tree of every rank's blocks ``tree`` (cut by
    ``shardings``, None where whole) on rank 0's host, None on the other
    ranks: a block of a leaf is taken from each rank, a whole leaf from
    rank 0. Every rank calls, in the same order."""
    mesh = mesh_of(shardings)
    if mesh is None or mesh.size == 1:
        return _snapshot(tree)
    rank0 = mesh.rank == 0

    def visit(node, spec):
        if isinstance(node, dict):
            return {k: visit(node[k], None if spec is None else spec[k])
                    for k in node}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            return type(node)(visit(v, None if spec is None else spec[i])
                              for i, v in enumerate(node))
        if spec is None or not any(e is not None for e in spec.spec):
            return _snapshot(node) if rank0 else None
        if isinstance(node, Q8):
            codes = _gather_array(node.codes, spec, mesh)
            scale = _gather_array(node.scale, spec, mesh)
            return None if codes is None else Q8(
                codes, scale, tuple(codes.shape),
                shd.q8_pad(codes.shape[-1], scale.shape[-1]))
        return _gather_array(node, spec, mesh)

    whole = visit(tree, shardings)
    return whole if rank0 else None


class AsyncSaver:
    """Snapshot to the host synchronously, write on a background thread
    (one write in flight). ``shardings`` as for :func:`save`: the
    snapshot is the gathered whole tree, written by rank 0."""

    def __init__(self):
        self._thread: Optional[threading.Thread] = None

    def save(self, ckpt_dir: str, step: int, tree, extra=None, keep: int = 3,
             shardings=None):
        snapshot = _snapshot(tree) if shardings is None \
            else gather_whole(tree, shardings)
        self.wait()
        if snapshot is None:
            return
        self._thread = threading.Thread(
            target=save, args=(ckpt_dir, step, snapshot, extra, keep),
            daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None


def latest_step(ckpt_dir: str) -> Optional[int]:
    marker = os.path.join(ckpt_dir, "latest")
    if not os.path.exists(marker):
        return None
    with open(marker) as f:
        name = f.read().strip()
    if not os.path.isdir(os.path.join(ckpt_dir, name)):
        return None
    return int(name.split("_")[1])


def _tensor(arr: np.ndarray, saved: Optional[str], device) -> torch.Tensor:
    """A loaded array as a tensor on ``device``; raw voids reinterpreted
    against the save-time dtype ``saved``."""
    if arr.dtype.kind == "V":
        if saved != "bfloat16" or arr.dtype.itemsize != 2:
            raise TypeError(f"cannot read a {arr.dtype} leaf saved as "
                            f"{saved!r}: the port reads bfloat16 voids only")
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16).to(device)
    return torch.from_numpy(np.array(arr, copy=True)).to(device)


def _device_of(leaf, device):
    if device is not None:
        return device
    return leaf.device if isinstance(leaf, torch.Tensor) else "cpu"


def _leaf_shardings(like, shardings) -> dict:
    """{leaf path: sharding} for the leaves ``shardings`` cuts: a tree of
    ``like``'s structure whose nodes are NamedSharding (a tensor; a Q8
    moment, by ``dist.sharding.moment_spec``), QSharding (a QTensor) or
    None (whole), None at a subtree leaving it whole."""
    out = {}

    def visit(path, node, spec):
        if spec is None:
            return
        if isinstance(node, dict):
            for k in node:
                visit(path + [str(k)], node[k], spec[k])
        elif isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            for i, v in enumerate(node):
                visit(path + [str(i)], v, spec[i])
        elif isinstance(node, QTensor):
            out[_SEP.join(path + ["@qt_codes"])] = spec.codes
            out[_SEP.join(path + ["@qt_scale"])] = spec.scale
        elif isinstance(node, Q8):      # its moment_spec cuts both
            out[_SEP.join(path + ["@q8_codes"])] = spec
            out[_SEP.join(path + ["@q8_scale"])] = spec
        else:
            out[_SEP.join(path)] = spec

    visit([], like, shardings)
    return out


def restore(ckpt_dir: str, like, step: Optional[int] = None,
            shardings: Optional[Any] = None, device=None):
    """Restore into the structure of ``like``. Each leaf comes back in the
    dtype it was saved in, on ``device`` (default: the device of
    ``like``'s leaf). ``shardings`` (a tree of ``like``'s structure, see
    :func:`_leaf_shardings`) restores onto a mesh: each leaf it cuts comes
    back as this rank's block (``dist.sharding.local_shard``, the rank
    and its device from the sharding's mesh), read through ``mmap``.
    Returns (tree, step)."""
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    d = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(d, "manifest.json")) as f:
        saved_dtypes = {k: v["dtype"]
                        for k, v in json.load(f)["leaves"].items()}
    cuts = {} if shardings is None else _leaf_shardings(like, shardings)
    loaded = {}
    for name, node in _flatten(like):
        path = os.path.join(d, name + ".npy")
        spec = cuts.get(name)
        if spec is None or not any(e is not None for e in spec.spec):
            # a leaf no axis cuts comes back whole where its template is
            # (an AdamW count stays on the host, as the step keeps it)
            loaded[name] = _tensor(np.load(path), saved_dtypes.get(name),
                                   _device_of(node, device))
            continue
        mesh = spec.mesh
        block = shd.local_shard(np.load(path, mmap_mode="r"), spec, mesh,
                                mesh.rank)
        loaded[name] = _tensor(np.asarray(block), saved_dtypes.get(name),
                               mesh.device if device is None else device)
    return _unflatten_like(like, loaded), step


def _unflatten_like(like, loaded: dict):
    def visit(path, node):
        if isinstance(node, dict):
            return {k: visit(path + [str(k)], v) for k, v in node.items()}
        if isinstance(node, (list, tuple)) and not hasattr(node, "shape"):
            vals = [visit(path + [str(i)], v) for i, v in enumerate(node)]
            return type(node)(vals)
        if isinstance(node, QTensor):
            cb = None
            if node.codebook is not None:
                cb = loaded[_SEP.join(path + ["@qt_codebook"])]
            # the logical shape follows the codes: a restored block's own
            return dataclasses.replace(
                qslice(node, loaded[_SEP.join(path + ["@qt_codes"])],
                       loaded[_SEP.join(path + ["@qt_scale"])]),
                codebook=cb)
        if isinstance(node, Q8):
            # a restored block's own shape and padding
            codes = loaded[_SEP.join(path + ["@q8_codes"])]
            scale = loaded[_SEP.join(path + ["@q8_scale"])]
            return Q8(codes, scale, tuple(codes.shape),
                      shd.q8_pad(codes.shape[-1], scale.shape[-1]))
        return loaded[_SEP.join(path)]

    return visit([], like)


def _gc(ckpt_dir: str, keep: int):
    steps = sorted(
        d for d in os.listdir(ckpt_dir)
        if d.startswith("step_") and not d.endswith(".tmp")
        and os.path.isdir(os.path.join(ckpt_dir, d)))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(ckpt_dir, d), ignore_errors=True)
