"""Ring collective matmuls: tensor-parallel products whose communication
is split into one hop per block (PyTorch port of the JAX package's
``dist/collective_matmul.py``).

A tensor-parallel matmul is all-gather-then-matmul (or matmul-then-
reduce-scatter): the collective serializes against the product. The ring
forms split the contraction into one block per rank and alternate a
block product with a hop around the ring (``dist.ring.ring_shift``), so
each hop can hide behind the previous block's product (the "collective
matmul" pattern).

Both run on every rank of a mesh, over the group of ``axis_name`` (the
mesh passed, or the one ``dist.sharding.activate`` binds), where JAX runs
them inside ``shard_map``, and equal the dense ``x @ w`` (f32 tolerance:
the same block products, another summation order for the reduce-scatter
form).

  ring_allgather_matmul      x:[B, K/p]  w:[K, N/p]  -> y:[B, N/p]
    (x is column-cut; instead of gathering x up front, x blocks rotate
     around the ring and each adds x_blk @ w[rows(blk)])

  ring_matmul_reducescatter  x:[B, K/p]  w:[K/p, N]  -> y:[B, N/p]
    (the partial products are reduced while rotating: each output block
     travels the ring once, each rank adding its part)

``w`` may be a QTensor block (the deploy-quantized layout): each hop's
block then cuts the codes' rows or columns (packed int4 codes pack along
the output dim, so a K-row cut never splits a byte) with the matching
scale rows, by :func:`_qslice`'s rules, and each block product goes
through ``kernels.ops.axllm_matmul``: on the card the decode kernels
(``axllm_matmul.gemv`` / ``reuse_matmul.gemv``) at M <= 16 and the
tensor-core mainloop at bf16 M >= 17; ``impl="reuse"`` runs each block
through the reuse (LUT) kernel. In the dyadic regime the accumulated
result is bit-equal to ``ops.reuse_matmul`` on the gathered operand,
since every block product and the f32 accumulation are exact there.
"""

from __future__ import annotations

import torch

from repro_torch.core.quantization import QTensor, qslice
from repro_torch.dist.sharding import active_mesh
from repro_torch.kernels import ops


def _qslice(qt: QTensor, start: int, size: int, axis: int) -> QTensor:
    """A [size]-wide block of a 2-D [K, N] QTensor along K (axis=0) or N
    (axis=1) from ``start``, codes, scale and shape consistent. K-blocks
    must cover whole scale groups, N-blocks of packed int4 codes whole
    bytes (JAX's ValueErrors)."""
    if axis == 0:
        if qt.granularity == "per_group" and size % qt.group_size:
            raise ValueError(
                f"ring K-block {size} must be a multiple of the scale "
                f"group size {qt.group_size}")
        codes = qt.codes.narrow(0, start, size)
        scale = qt.scale
        if qt.granularity == "per_group":
            g = qt.group_size
            scale = scale.narrow(0, start // g, size // g)
    else:
        csize, cstart = size, start
        if qt.packed:
            if size % 2:
                raise ValueError(
                    f"ring N-block {size} of packed int4 codes must be even")
            csize, cstart = size // 2, start // 2
        codes = qt.codes.narrow(-1, cstart, csize)
        scale = qt.scale
        if qt.granularity in ("per_channel", "per_group"):
            scale = scale.narrow(-1, start, size)
    return qslice(qt, codes.contiguous(), scale.contiguous())


def _block_dot(xb: torch.Tensor, wb, impl: str) -> torch.Tensor:
    if isinstance(wb, QTensor):
        return ops.axllm_matmul(xb, wb, impl=impl, out_dtype=torch.float32)
    return torch.matmul(xb.to(torch.float32), wb.to(torch.float32))


def ring_allgather_matmul(x: torch.Tensor, w, axis_name: str, *,
                          impl: str = "auto", mesh=None) -> torch.Tensor:
    """y_local = x_global @ w_local without materializing x_global.

    x: [B, K_loc] (this rank's column block of the [B, K] activations);
    w: [K, N_loc] (the whole contraction dim, this rank's output columns),
    dense or QTensor; ``impl`` selects the quantized block kernel."""
    from repro_torch.dist.ring import ring_shift
    mesh = active_mesh(mesh)
    n, idx = mesh.shape[axis_name], mesh.coords[axis_name]
    k_loc = x.shape[-1]
    acc = torch.zeros((x.shape[0], w.shape[-1]), dtype=torch.float32,
                      device=x.device)
    xb = x
    for t in range(n):
        src = (idx - t) % n            # owner of the block xb holds
        if isinstance(w, QTensor):
            wb = _qslice(w, src * k_loc, k_loc, axis=0)
        else:
            wb = w.narrow(0, src * k_loc, k_loc)
        acc = acc + _block_dot(xb, wb, impl)
        if t != n - 1:
            xb = ring_shift(xb, mesh, axis_name)
    return acc.to(x.dtype)


def ring_matmul_reducescatter(x: torch.Tensor, w, axis_name: str, *,
                              impl: str = "auto", mesh=None) -> torch.Tensor:
    """y_local = reduce_scatter(x_local @ w_local) fused into the ring.

    x: [B, K_loc]; w: [K_loc, N] (this rank's rows of the whole weight,
    dense or QTensor). No rank's [B, N] partial is made: output column
    blocks circulate the ring, each rank adding its partial for the block
    it holds; after p-1 hops every block lands on its owner, reduced."""
    from repro_torch.dist.ring import ring_shift
    mesh = active_mesh(mesh)
    n, idx = mesh.shape[axis_name], mesh.coords[axis_name]
    n_loc = w.shape[-1] // n
    # the block products take x in its own type (a bf16 wave reaches the
    # tensor cores) and give f32, which the ring accumulates (JAX casts x
    # to f32 first: the same products, exact in f32 either way)
    acc = torch.zeros((x.shape[0], n_loc), dtype=torch.float32,
                      device=x.device)
    for t in range(n):
        # the block in hand is bound for rank (idx - t - 1); at the last
        # step that is this rank: its own partial is added last, and kept
        blk = (idx - t - 1) % n
        if isinstance(w, QTensor):
            wb = _qslice(w, blk * n_loc, n_loc, axis=1)
        else:
            wb = w.narrow(-1, blk * n_loc, n_loc)
        acc = acc + _block_dot(x, wb, impl)
        if t != n - 1:
            acc = ring_shift(acc, mesh, axis_name)
    return acc.to(x.dtype)
