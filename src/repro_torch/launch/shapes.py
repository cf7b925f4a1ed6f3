"""Assigned input-shape sets and the 40-cell (arch x shape) enumeration
(PyTorch port of the JAX package's ``launch/shapes.py``).

    train_4k     seq 4,096   global_batch 256   runs the train step
    prefill_32k  seq 32,768  global_batch 32    runs prefill
    decode_32k   seq 32,768  global_batch 128   runs one decode step (1
                                                token, KV/state cache of
                                                seq_len)
    long_500k    seq 524,288 global_batch 1     runs one decode step; ONLY
                                                for sub-quadratic-state
                                                archs (ssm/hybrid) —
                                                pure-attention archs skip

The input specs are JAX's ShapeDtypeStructs with their shardings: each is
a :class:`ShapeDtypeStruct`, the global shape and dtype with a meta tensor
of one rank's block and its ``dist.sharding.NamedSharding``, so that
nothing is allocated anywhere on the dry-run path.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import torch

from repro_torch.configs import ASSIGNED, get_config
from repro_torch.configs.base import ModelConfig
from repro_torch.dist import sharding as shd


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq: int
    global_batch: int
    kind: str                     # train | prefill | decode


SHAPES: Dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class Cell:
    arch: str
    shape: str
    skip: Optional[str] = None    # reason, when sanctioned by the assignment

    @property
    def key(self) -> str:
        return f"{self.arch}:{self.shape}"


def all_cells() -> List[Cell]:
    cells = []
    for arch in ASSIGNED:
        cfg = get_config(arch)
        for sname in SHAPES:
            skip = None
            if sname == "long_500k" and not cfg.supports_long_context:
                skip = ("pure full-attention arch: 500k context requires "
                        "sub-quadratic state (assignment-sanctioned skip)")
            cells.append(Cell(arch, sname, skip))
    return cells


@dataclasses.dataclass(frozen=True)
class ShapeDtypeStruct:
    """JAX's ``ShapeDtypeStruct`` with a sharding: the global ``shape``
    and ``dtype``, the ``sharding`` and ``block``, a meta tensor of the
    block that the mesh's rank holds."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    sharding: shd.NamedSharding
    block: torch.Tensor


def sds(shape, dtype, names, mesh) -> ShapeDtypeStruct:
    sharding = shd.NamedSharding(
        mesh, shd.resolve_spec(shape, names, mesh, shd._active_rules(None)))
    block = shd.local_shard(torch.empty(shape, dtype=dtype, device="meta"),
                            sharding, mesh, mesh.rank)
    return ShapeDtypeStruct(tuple(shape), dtype, sharding, block)


def batch_input_specs(cfg: ModelConfig, spec: ShapeSpec, mesh,
                      targets: bool = True):
    b, s = spec.global_batch, spec.seq
    out = {"tokens": sds((b, s), torch.int32, ("batch", "seq"), mesh)}
    if targets:     # a buffer of its own (JAX passes the tokens' struct)
        out["targets"] = sds((b, s), torch.int32, ("batch", "seq"), mesh)
    if cfg.is_encoder_decoder:
        out["frames"] = sds((b, cfg.enc_seq, cfg.d_feat), torch.float32,
                            ("batch", None, None), mesh)
    return out


def token_input_specs(cfg: ModelConfig, spec: ShapeSpec, mesh):
    """Decode-step inputs: one new token per sequence."""
    b = spec.global_batch
    return sds((b,), torch.int32, ("batch",), mesh)
