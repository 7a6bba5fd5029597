"""The collectives of the single-controller mesh.

What ``jax.lax`` gives the JAX package inside ``shard_map`` (``all_gather``,
``psum_scatter``, ``all_to_all``, ``psum``) over a mesh axis, here over
tensors held one a position (a sequence in worker order ``w = d * S + s``,
see :class:`~fps_tpu_torch.parallel.mesh.PSMesh`). Each returns one result a
position, on that position's device. Besides them: the moves between the
controller's home device and the positions (a batch's columns out to the
workers, the step's metrics and tap outputs back).

Every sum is a left fold in index order, on the receiving position's device,
so its float32 rounding does not depend on where the positions run, and
every replica of a sum is the same bits. Data moves with
``Tensor.to(device, non_blocking=True)``, a no-op where the devices are the
same. This module is the only one in the port that moves data between
positions (ROADMAP.md Queue 1 item 4b replaces it with process-group calls).

An axis of size 1 returns each position's own tensor, with no copy.
"""

from __future__ import annotations

from typing import Sequence

import torch

from fps_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, PSMesh

Tensor = torch.Tensor


def _to(x: Tensor, device: torch.device) -> Tensor:
    return x.to(device, non_blocking=True)


def groups(mesh: PSMesh, axis: str) -> list[list[int]]:
    """The positions of each group along ``axis``, in index order: along
    ``shard`` the ``S`` positions of one data replica, along ``data`` the
    ``D`` replicas of one shard."""
    D, S = mesh.shape[DATA_AXIS], mesh.shape[SHARD_AXIS]
    if axis == SHARD_AXIS:
        return [[d * S + s for s in range(S)] for d in range(D)]
    if axis == DATA_AXIS:
        return [[d * S + s for d in range(D)] for s in range(S)]
    raise ValueError(f"unknown mesh axis {axis!r}")


def _fold(parts: Sequence[Tensor], device: torch.device) -> Tensor:
    """``parts[0] + parts[1] + ...`` in that order, on ``device``."""
    acc = _to(parts[0], device)
    for p in parts[1:]:
        acc = acc + _to(p, device)
    return acc


def _check(mesh: PSMesh, xs: Sequence) -> None:
    if len(xs) != len(mesh.positions):
        raise ValueError(f"{len(xs)} tensors for a mesh of "
                         f"{len(mesh.positions)} positions")


def all_gather(mesh: PSMesh, xs: Sequence[Tensor], axis: str, *,
               dim: int = 0, copy: bool = False) -> list[Tensor]:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: each position
    receives its group's tensors joined along ``dim`` in index order.
    ``copy=True`` gives new memory on an axis of size 1 too."""
    _check(mesh, xs)
    out = [None] * len(xs)
    for g in groups(mesh, axis):
        for p in g:
            dev = mesh.positions[p]
            if len(g) == 1:
                out[p] = xs[p].clone() if copy else xs[p]
            else:
                out[p] = torch.cat([_to(xs[q], dev) for q in g], dim)
    return out


def psum_scatter(mesh: PSMesh, xs: Sequence[Tensor],
                 axis: str) -> list[Tensor]:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: the
    group's tensors summed, and the ``i``-th of ``n`` equal pieces along
    dim 0 to the group's ``i``-th position."""
    _check(mesh, xs)
    out = [None] * len(xs)
    for g in groups(mesh, axis):
        n = len(g)
        for i, p in enumerate(g):
            rows = xs[p].shape[0] // n
            out[p] = _fold([xs[q][i * rows:(i + 1) * rows] for q in g],
                           mesh.positions[p])
    return out


def all_to_all(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``
    over ``(n, ...)`` tensors: the group's ``i``-th position receives
    ``(n, ...)`` whose ``j``-th entry is the ``j``-th position's entry
    ``i``."""
    _check(mesh, xs)
    out = [None] * len(xs)
    for g in groups(mesh, axis):
        for i, p in enumerate(g):
            dev = mesh.positions[p]
            out[p] = (xs[p] if len(g) == 1 else
                      torch.stack([_to(xs[q][i], dev) for q in g]))
    return out


def psum(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.psum(x, axis)``: each position receives its group's sum."""
    _check(mesh, xs)
    out = [None] * len(xs)
    for g in groups(mesh, axis):
        for p in g:
            out[p] = _fold([xs[q] for q in g], mesh.positions[p])
    return out


# ---------------------------------------------------------------------------
# Between the home device and the positions.
# ---------------------------------------------------------------------------

def scatter_workers(mesh: PSMesh, x: Tensor, dim: int = 0) -> list[Tensor]:
    """Worker ``w``'s ``w``-th of ``W`` equal pieces of ``x`` along ``dim``,
    on its device (``x`` sharded over both axes, the JAX package's
    ``P(('data', 'shard'))``). One worker takes ``x`` itself."""
    pos = mesh.positions
    if len(pos) == 1:
        return [_to(x, pos[0])]
    return [_to(piece, dev) for piece, dev in
            zip(torch.tensor_split(x, len(pos), dim), pos)]


def replicate(mesh: PSMesh, pieces: Sequence[Tensor]) -> list[Tensor]:
    """Shard ``s``'s piece (``pieces[s]``) on every position ``(d, s)``: a
    table's blocks from its ``S`` pieces. With more than one data replica
    each position gets memory of its own (a replica's block is updated in
    place by its own pushes)."""
    S = mesh.shape[SHARD_AXIS]
    if len(pieces) != S:
        raise ValueError(f"{len(pieces)} pieces for {S} shards")
    copy = mesh.shape[DATA_AXIS] > 1
    return [pieces[p % S].to(dev, non_blocking=True, copy=copy)
            for p, dev in enumerate(mesh.positions)]


def broadcast(mesh: PSMesh, x: Tensor) -> list[Tensor]:
    """``x`` (on the home device) on every position: an input the JAX
    package places replicated (``P()``). Positions on ``x``'s device share
    it."""
    return [_to(x, dev) for dev in mesh.positions]


def gather_home(mesh: PSMesh, xs: Sequence[Tensor]) -> list[Tensor]:
    """Every position's tensor on the home device."""
    return [_to(x, mesh.device) for x in xs]


def sum_home(mesh: PSMesh, xs: Sequence[Tensor]) -> Tensor:
    """``psum(psum(x, 'shard'), 'data')`` on the home device: each replica's
    shards folded in index order, then the replicas."""
    _check(mesh, xs)
    return _fold([_fold([xs[p] for p in g], mesh.device)
                  for g in groups(mesh, SHARD_AXIS)], mesh.device)
