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

:func:`shard_batch` puts a host batch on the device. One card has no
mesh; a mesh raises until distribution is ported (ROADMAP queue 1 item
12), and so does the dry run's ``batch_specs``, which is not ported.
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


def shard_batch(batch: Dict[str, np.ndarray], mesh=None,
                device="cuda") -> Dict[str, torch.Tensor]:
    """A host batch as tensors on ``device`` (one copy per array). A mesh
    raises: sharding the batch axis is not ported yet."""
    if mesh is not None:
        raise NotImplementedError(
            "shard_batch(mesh=): sharding a batch over a mesh is not ported "
            "yet (ROADMAP queue 1 item 12c)")
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}
