"""Deterministic, restart-safe data pipeline (PyTorch port of
``repro.data.pipeline``).

Every batch is a pure function of (seed, step): random access by step is
what the fault-tolerance layer relies on (after a restore at step k, batch
k+1 is bit-identical to the uninterrupted run's). Batches are host numpy
arrays made by the JAX package's generator, so both packages train on the
same tokens bit for bit. Two sources:

* SyntheticLM: Zipf unigram plus a fixed successor table (half the
  positions follow the previous token's successor): signal enough for
  the loss to fall, no external data.
* ByteCorpus: a byte-level LM over the text files under a directory,
  chunked deterministically.

:func:`shard_batch` puts a host batch on the device, or, on a mesh,
this rank's rows of it: every rank draws the same global batch from the
seed and keeps its block of rows over ("pod", "data"), whole over
"model". :func:`batch_specs` gives the dry run's input specs: the shapes,
dtypes and shardings JAX gives, as meta tensors beside the port's
``NamedSharding``.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from typing import Dict, Iterator, Optional

import numpy as np
import torch


def _rng_for(seed: int, step: int) -> np.random.Generator:
    mix = hashlib.blake2b(f"{seed}:{step}".encode(), digest_size=8).digest()
    return np.random.default_rng(int.from_bytes(mix, "little"))


@dataclasses.dataclass
class SyntheticLM:
    vocab_size: int
    batch: int
    seq: int
    seed: int = 0
    frames: Optional[tuple] = None      # (enc_seq, d_feat) for enc-dec archs

    def __post_init__(self):
        rng = _rng_for(self.seed, -1)
        v = self.vocab_size
        # fixed Zipf unigram + a deterministic successor table => learnable
        self._probs = 1.0 / np.arange(1, v + 1)
        self._probs /= self._probs.sum()
        self._succ = rng.permutation(v)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step)
        b, s, v = self.batch, self.seq, self.vocab_size
        base = rng.choice(v, size=(b, s), p=self._probs)
        # 50% of positions follow the successor table of the previous token
        follow = rng.random((b, s)) < 0.5
        shifted = self._succ[np.roll(base, 1, axis=1)]
        tokens = np.where(follow, shifted, base).astype(np.int32)
        out = {"tokens": tokens,
               "targets": np.roll(tokens, -1, axis=1).astype(np.int32)}
        if self.frames:
            f, d = self.frames
            out["frames"] = rng.standard_normal((b, f, d)).astype(np.float32)
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


@dataclasses.dataclass
class ByteCorpus:
    """Byte-level LM over the text files under ``root`` (deterministic)."""
    batch: int
    seq: int
    root: str = "."
    seed: int = 0
    exts: tuple = (".py", ".md", ".txt")
    vocab_size: int = 256

    def __post_init__(self):
        blobs = []
        for dirpath, _, files in sorted(os.walk(self.root)):
            if any(part.startswith(".") for part in dirpath.split(os.sep)):
                continue
            for f in sorted(files):
                if f.endswith(self.exts):
                    try:
                        with open(os.path.join(dirpath, f), "rb") as fh:
                            blobs.append(fh.read())
                    except OSError:
                        pass
        data = b"\n".join(blobs) or b"empty corpus " * 1024
        self._data = np.frombuffer(data, dtype=np.uint8)

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = _rng_for(self.seed, step)
        n = len(self._data) - self.seq - 1
        starts = rng.integers(0, max(n, 1), size=self.batch)
        tok = np.stack([self._data[s:s + self.seq] for s in starts])
        tgt = np.stack([self._data[s + 1:s + self.seq + 1] for s in starts])
        return {"tokens": tok.astype(np.int32),
                "targets": tgt.astype(np.int32)}

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1


def make_dataset(cfg, batch: int, seq: int, seed: int = 0,
                 source: str = "synthetic"):
    if source == "bytes":
        return ByteCorpus(batch=batch, seq=seq, seed=seed)
    frames = (cfg.enc_seq, cfg.d_feat) if cfg.is_encoder_decoder else None
    return SyntheticLM(vocab_size=cfg.vocab_size, batch=batch, seq=seq,
                       seed=seed, frames=frames)


_BATCH_LOGICAL = {"tokens": ("batch", "seq"), "targets": ("batch", "seq"),
                  "frames": ("batch", "seq", None)}


def _batch_spec(key, shape, mesh):
    from repro_torch.dist import sharding as shd
    names = _BATCH_LOGICAL.get(key, ("batch",))[:len(shape)]
    return shd.NamedSharding(mesh, shd.resolve_spec(
        shape, names, mesh, shd._active_rules(None)))


def shard_batch(batch: Dict[str, np.ndarray], mesh=None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (one copy per array); on a
    ``mesh``, this rank's rows of it, on the mesh's device: the "batch"
    rule's cut, over ("pod", "data"). A global batch whose rows do not
    split over those axes raises: the training step's loss divides each
    rank's rows by the global count, and JAX's fallback (the batch
    replicated over an axis it does not divide) would count them twice."""
    if mesh is None:
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
                for k, v in batch.items()}
    from repro_torch.dist import sharding as shd
    from repro_torch.dist import tensor_parallel as tp
    out = {}
    for k, v in batch.items():
        spec = _batch_spec(k, v.shape, mesh)
        cut = () if spec.spec[0] is None else (
            (spec.spec[0],) if isinstance(spec.spec[0], str)
            else tuple(spec.spec[0]))
        if cut != tp.batch_axes(mesh):
            raise ValueError(
                f"{k}: {v.shape[0]} rows do not split over the batch axes "
                f"{tp.batch_axes(mesh)} of {mesh.shape}")
        block = shd.local_shard(np.ascontiguousarray(v), spec, mesh,
                                mesh.rank)
        out[k] = torch.from_numpy(np.ascontiguousarray(block)).to(
            mesh.device)
    return out


@dataclasses.dataclass(frozen=True)
class InputSpec:
    """An input's shape and dtype (a meta tensor: JAX's
    ``ShapeDtypeStruct``) and its ``sharding`` (a NamedSharding)."""
    meta: torch.Tensor
    sharding: object

    @property
    def shape(self):
        return tuple(self.meta.shape)

    @property
    def dtype(self):
        return self.meta.dtype


def batch_specs(cfg, batch: int, seq: int, mesh, train: bool = True):
    """The dry run's input specs (JAX's ``batch_specs``): {"tokens",
    "targets" (always: JAX's ``if train or True``), and "frames" for an
    encoder-decoder: :class:`InputSpec`}, the batch over the "batch" rule's
    axes where its size divides them (JAX's fallback otherwise)."""
    def spec(shape, dtype, key):
        return InputSpec(torch.empty(shape, dtype=dtype, device="meta"),
                         _batch_spec(key, shape, mesh))

    specs = {"tokens": spec((batch, seq), torch.int32, "tokens")}
    if train or True:
        specs["targets"] = specs["tokens"]
    if cfg.is_encoder_decoder:
        specs["frames"] = spec((batch, cfg.enc_seq, cfg.d_feat),
                               torch.float32, "frames")
    return specs
