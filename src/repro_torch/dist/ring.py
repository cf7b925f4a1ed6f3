"""The ring step shared by the pipeline and the collective matmuls: JAX's
``ppermute`` of a tensor one place around an axis of the mesh, j -> j+1.

It is one ``batch_isend_irecv`` over the axis's group. NCCL moves card
tensors itself; gloo (ranks that share a card, or the host) sends host
tensors, so a card tensor goes through the host there.
"""

from __future__ import annotations

import torch


def neighbour(mesh, axis: str, step: int) -> int:
    """The global rank ``step`` places along ``axis`` from this rank."""
    coords = mesh.coords
    coords[axis] = (coords[axis] + step) % mesh.shape[axis]
    rank = 0
    for ax, n in mesh.shape.items():
        rank = rank * n + coords[ax]
    return rank


def ring_shift(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Every rank's ``x`` sent to the next rank of ``axis`` (the last to
    the first); returns what the previous rank sent."""
    import torch.distributed as dist
    if mesh.shape[axis] == 1:
        return x
    host = x.is_cuda and mesh.backend != "nccl"
    send = (x.cpu() if host else x).contiguous()
    recv = torch.empty_like(send)
    group = mesh.group_of(axis)
    ops = [dist.P2POp(dist.isend, send, neighbour(mesh, axis, 1), group),
           dist.P2POp(dist.irecv, recv, neighbour(mesh, axis, -1), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return recv.to(x.device) if host else recv
