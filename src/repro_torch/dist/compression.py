"""int8 error-feedback gradient exchange for the cross-pod "pod" axis
(PyTorch port of the JAX package's ``dist/compression.py``).

The multi-pod mesh runs pure data parallelism between pods, so each step
moves a full gradient copy over the slowest link. This module compresses
that exchange to int8 blocks with per-block scales (about 3.9x fewer
bytes, :func:`wire_bytes`) and keeps the quantization residual LOCALLY as
error feedback: the residual is added to the next step's gradient before
quantizing, so the accumulated update converges to the exact accumulated
gradient (the EF-SGD argument).

:func:`compressed_allreduce_mean` runs on every rank of a mesh
(``launch.mesh.Mesh``; by default the one ``dist.sharding.activate``
binds) over the group of ``axis_name``, where JAX runs it inside
``shard_map``. The round trip through the codes is an elementwise pass
and a reduction, written in PyTorch as the JAX package writes it in
``jnp``, outside any Pallas kernel; the sum over the ranks is one
all-reduce of the dequantized values (what the codes and scales carry).
The training step does not call it, as in JAX.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

BLOCK = 256          # elements per scale block
_QMAX = 127.0
_SCALE_BYTES = 4     # one f32 scale per block


def _block_quantize(v: torch.Tensor, block: int) -> torch.Tensor:
    """Round-trip ``v`` through int8 codes with per-block absmax scales
    over its flattened elements (the last block zero-padded). Returns the
    dequantized value, in v's dtype: the bits that cross the wire."""
    flat = v.reshape(-1)
    n = flat.shape[0]
    pad = (-n) % block
    if pad:
        flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = torch.clamp(blocks.abs().amax(dim=1, keepdim=True),
                        min=1e-12) / _QMAX
    codes = torch.clamp(torch.round(blocks / scale), -_QMAX, _QMAX)
    deq = (codes.to(torch.float32) * scale).reshape(-1)[:n]
    return deq.reshape(v.shape).to(v.dtype)


def compressed_allreduce_mean(x: torch.Tensor, axis_name: str,
                              err: Optional[torch.Tensor] = None,
                              block: int = BLOCK, mesh=None
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Mean of ``x`` over the ranks of ``axis_name`` through an int8 wire,
    with error feedback.

    x:   this rank's gradient (any shape).
    err: residual carried from the previous call (same shape; None or
         zeros on the first step).
    Returns (approximate mean, new residual). The residual never crosses
    the wire: feed it back into the next call."""
    from repro_torch.dist.sharding import active_mesh
    mesh = active_mesh(mesh)
    v = x if err is None else x + err
    deq = _block_quantize(v, block)
    new_err = v - deq
    total = deq.contiguous().clone()
    group = mesh.group_of(axis_name)
    if group is not None:
        import torch.distributed as dist
        dist.all_reduce(total, group=group)
    return total / mesh.axis_size(axis_name), new_err


def wire_bytes(x, block: int = BLOCK) -> Tuple[int, int]:
    """(compressed, uncompressed) bytes for one rank's exchange of ``x``.

    compressed = 1 byte/element + one f32 scale per block;
    uncompressed = the raw dtype bytes (f32 gradients: 4/element)."""
    n = 1
    for d in x.shape:
        n *= int(d)
    n_blocks = -(-n // block)
    itemsize = torch.empty((), dtype=x.dtype).element_size() \
        if isinstance(x.dtype, torch.dtype) else x.dtype.itemsize
    return n + n_blocks * _SCALE_BYTES, n * itemsize
