"""The collectives of the mesh.

What ``jax.lax`` gives the JAX package inside ``shard_map`` (``all_gather``,
``psum_scatter``, ``all_to_all``, ``psum``, ``pmax``, ``pmin``) over a mesh
axis, here over tensors held one a position (a sequence in worker order
``w = d * S + s``, this process's positions only, see
:class:`~fps_tpu_torch.parallel.mesh.PSMesh`). Each returns one result a
position of this process, on that position's device. Besides them: the moves
between the process's home device and its positions (a batch's columns out
to the workers, the step's metrics and tap outputs back).

Every sum (and every maximum and minimum) is a left fold in index order,
on the receiving position's device, so its float32 rounding does not depend
on where the positions run, and every replica of a sum is the same bits.
Within a process data moves with ``Tensor.to(device, non_blocking=True)``,
a no-op where the devices are the same. This module is the only one in the
port that moves data between positions.

**Across processes.** A group that lies inside the process works as on one
process. Where an axis's groups cross processes, the process first fetches
what its positions need from the others through the axis's process group
(made with the mesh): the tensors of every member (``all_gather``, for
:func:`all_gather` and :func:`psum`) or each member's piece for each
receiving member (``all_to_all_single``, for :func:`psum_scatter` and
:func:`all_to_all`), and then folds them on the receiving position in index
order, as on one process. No reduction of the library (its all-reduce or
reduce-scatter) is used: its order is the library's choice, and the
fixed-order folds (the dense route's sums, the shard-major stream of a
push) must hold. Tensors travel as bytes, so every dtype takes one path.
:func:`gather_home` (behind :func:`sum_home_each`) fetches every
position's tensor over all processes, so every process sums the step's
metrics in the same order and gets the same bits; :func:`gather_first`
(behind :attr:`Blocks.distinct`) broadcasts a global array's first replica
only. On a gloo group a CUDA tensor is staged through pinned host memory
(gloo's collectives take host tensors): every exchange above stages so on
gloo, and none does on NCCL. The kernels run on the positions' devices
either way. A process holds all its positions on one device
(:func:`~fps_tpu_torch.parallel.mesh.make_ps_mesh` refuses more), so its
tensors travel joined in one buffer.

An axis of size 1 returns each position's own tensor, with no copy.

While a program record is taken on the calling thread
(:mod:`fps_tpu_torch.analysis.record`), each public collective is recorded:
``all_gather``, ``psum_scatter`` as ``reduce_scatter``, ``all_to_all``,
``psum`` / ``pmax`` / ``pmin`` and ``sum_home_each`` as ``all_reduce``, and
the placements ``replicate``, ``broadcast`` and ``gather_home`` under their
names. Otherwise the decorator costs one thread-local read a call.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from fps_tpu_torch.analysis.record import recorded_collective
from fps_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    PSMesh,
    axis_groups,
)

Tensor = torch.Tensor


def _to(x: Tensor, device: torch.device) -> Tensor:
    return x.to(device, non_blocking=True)


def groups(mesh: PSMesh, axis: str) -> list[list[int]]:
    """The positions of each group along ``axis`` (every group of the mesh,
    in index order)."""
    return axis_groups(mesh.shape[DATA_AXIS], mesh.shape[SHARD_AXIS], axis)


def _member(mesh: PSMesh, axis: str, p: int) -> tuple[tuple[int, ...], int]:
    """Position ``p``'s group along ``axis`` and its index in it."""
    try:
        return mesh.member[axis][p]
    except KeyError:
        raise ValueError(f"unknown mesh axis {axis!r}") from None


def _fold(parts: Sequence[Tensor], device: torch.device,
          op: Callable[[Tensor, Tensor], Tensor] = torch.add) -> Tensor:
    """``op(op(parts[0], parts[1]), ...)`` in that order, on ``device``
    (by default ``parts[0] + parts[1] + ...``)."""
    acc = _to(parts[0], device)
    for p in parts[1:]:
        acc = op(acc, _to(p, device))
    return acc


def _check(mesh: PSMesh, xs: Sequence) -> None:
    if len(xs) != len(mesh.positions):
        raise ValueError(f"{len(xs)} tensors for a mesh of "
                         f"{len(mesh.positions)} positions")


# ---------------------------------------------------------------------------
# The exchange between processes: tensors as bytes.
# ---------------------------------------------------------------------------

def _staged(group, like: Tensor) -> bool:
    """Whether an exchange of ``like``'s kind stages through host memory:
    a CUDA tensor on a gloo group."""
    import torch.distributed as dist

    return like.is_cuda and dist.get_backend(group) == "gloo"


def _pack(xs: Sequence[Tensor], staged: bool) -> Tensor:
    """``xs`` joined as one flat byte tensor (on the host when staged)."""
    flat = torch.cat([x.contiguous().reshape(-1).view(torch.uint8)
                      for x in xs])
    if not staged:
        return flat
    host = torch.empty(flat.shape, dtype=torch.uint8, pin_memory=True)
    return host.copy_(flat)


def _empty(nbytes: int, like: Tensor, staged: bool) -> Tensor:
    if staged:
        return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    return torch.empty(nbytes, dtype=torch.uint8, device=like.device)


def _unpack(buf: Tensor, like: Tensor, device: torch.device) -> Tensor:
    """``buf`` read as a tensor of ``like``'s dtype and shape, on
    ``device``."""
    if buf.storage_offset() % like.element_size():
        buf = buf.clone()
    return _to(buf.view(like.dtype).reshape(like.shape), device)


def _nbytes(x: Tensor) -> int:
    return x.numel() * x.element_size()


def _gather(group, ranks: Sequence[int], mesh: PSMesh,
            xs: Sequence[Tensor]) -> dict[int, Tensor]:
    """Every position of ``ranks``' processes: its tensor (each process's
    tensors of one shape and dtype, ``xs`` its own), on this process's home
    device; one ``all_gather`` over ``group``."""
    import torch.distributed as dist

    like = xs[0]
    staged = _staged(group, like)
    send = _pack(xs, staged)
    recv = [_empty(send.numel(), like, staged) for _ in ranks]
    dist.all_gather(recv, send, group=group)
    out, n = {}, _nbytes(like)
    for r, buf in zip(ranks, recv):
        for i, w in enumerate(mesh.procs.positions_of(r)):
            out[w] = _unpack(buf[i * n:(i + 1) * n], like, mesh.device)
    return out


def _known(mesh: PSMesh, xs: Sequence[Tensor], axis: str):
    """Every tensor this process's positions need along ``axis``, indexed
    by position: ``xs`` itself where the axis's groups lie inside the
    process, else the members' tensors fetched from the group's
    processes."""
    cross = mesh.procs.groups.get(axis) if mesh.procs is not None else None
    if cross is None:
        if mesh.procs is None:
            return xs
        return {w: x for w, x in zip(mesh.local, xs)}
    known = _gather(*cross, mesh, xs)
    known.update(zip(mesh.local, xs))
    return known


def _pieces(mesh: PSMesh, xs: Sequence[Tensor], axis: str,
            piece: Callable[[Tensor, int, int], Tensor]):
    """``{(q, p): tensor}``: position ``q``'s piece for position ``p`` of
    its group along ``axis`` (``piece(x_q, index of p, group size)``) for
    every ``q`` of another process and every ``p`` of this one, through
    one ``all_to_all_single`` over the axis's process group; ``None`` where
    the axis's groups lie inside the process."""
    cross = mesh.procs.groups.get(axis) if mesh.procs is not None else None
    if cross is None:
        return None
    import torch.distributed as dist

    group, ranks = cross
    procs, slot = mesh.procs, mesh.slot

    def own(q, p):
        g, i = _member(mesh, axis, p)
        return piece(xs[slot[q]], i, len(g))

    def pairs(src: int, dst: int) -> list[tuple[int, int]]:
        dsts = procs.positions_of(dst)
        return [(q, p) for q in procs.positions_of(src) for p in dsts
                if p in _member(mesh, axis, q)[0]]

    like = own(mesh.local[0], mesh.local[0])
    staged = _staged(group, like)
    send = _pack([own(q, p) for r in ranks for q, p in pairs(procs.rank, r)],
                 staged)
    recv = _empty(send.numel(), like, staged)
    dist.all_to_all_single(recv, send, group=group)
    got, n, off = {}, _nbytes(like), 0
    for r in ranks:
        for q, p in pairs(r, procs.rank):
            if slot[q] < 0:
                got[q, p] = _unpack(recv[off:off + n], like,
                                    mesh.positions[slot[p]])
            off += n
    return got


# ---------------------------------------------------------------------------
# The collectives over an axis.
# ---------------------------------------------------------------------------

@recorded_collective("all_gather")
def all_gather(mesh: PSMesh, xs: Sequence[Tensor], axis: str, *,
               dim: int = 0, copy: bool = False) -> list[Tensor]:
    """``lax.all_gather(x, axis, axis=dim, tiled=True)``: each position
    receives its group's tensors joined along ``dim`` in index order.
    ``copy=True`` gives new memory on an axis of size 1 too."""
    _check(mesh, xs)
    known = _known(mesh, xs, axis)
    out = []
    for i, (p, dev) in enumerate(zip(mesh.local, mesh.positions)):
        g, _ = _member(mesh, axis, p)
        if len(g) == 1:
            out.append(xs[i].clone() if copy else xs[i])
        else:
            out.append(torch.cat([_to(known[q], dev) for q in g], dim))
    return out


def _rows(x: Tensor, i: int, n: int) -> Tensor:
    rows = x.shape[0] // n
    return x[i * rows:(i + 1) * rows]


@recorded_collective("reduce_scatter")
def psum_scatter(mesh: PSMesh, xs: Sequence[Tensor],
                 axis: str) -> list[Tensor]:
    """``lax.psum_scatter(x, axis, scatter_dimension=0, tiled=True)``: the
    group's tensors summed, and the ``i``-th of ``n`` equal pieces along
    dim 0 to the group's ``i``-th position."""
    _check(mesh, xs)
    got, slot = _pieces(mesh, xs, axis, _rows), mesh.slot
    out = []
    for p, dev in zip(mesh.local, mesh.positions):
        g, i = _member(mesh, axis, p)
        n = len(g)
        out.append(_fold([_rows(xs[slot[q]], i, n) if slot[q] >= 0
                          else got[q, p] for q in g], dev))
    return out


@recorded_collective("all_to_all")
def all_to_all(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.all_to_all(x, axis, split_axis=0, concat_axis=0, tiled=False)``
    over ``(n, ...)`` tensors: the group's ``i``-th position receives
    ``(n, ...)`` whose ``j``-th entry is the ``j``-th position's entry
    ``i``."""
    _check(mesh, xs)
    got, slot = _pieces(mesh, xs, axis, lambda x, i, n: x[i]), mesh.slot
    out = []
    for k, (p, dev) in enumerate(zip(mesh.local, mesh.positions)):
        g, i = _member(mesh, axis, p)
        out.append(xs[k] if len(g) == 1 else torch.stack([
            _to(xs[slot[q]][i] if slot[q] >= 0 else got[q, p], dev)
            for q in g]))
    return out


def _reduce(mesh: PSMesh, xs: Sequence[Tensor], axis: str,
            op: Callable[[Tensor, Tensor], Tensor]) -> list[Tensor]:
    """Each position receives its group's tensors folded by ``op`` in index
    order."""
    _check(mesh, xs)
    known = _known(mesh, xs, axis)
    return [_fold([known[q] for q in _member(mesh, axis, p)[0]], dev, op)
            for p, dev in zip(mesh.local, mesh.positions)]


@recorded_collective("all_reduce")
def psum(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.psum(x, axis)``: each position receives its group's sum."""
    return _reduce(mesh, xs, axis, torch.add)


@recorded_collective("all_reduce")
def pmax(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.pmax(x, axis)``: each position receives its group's
    elementwise maximum."""
    return _reduce(mesh, xs, axis, torch.maximum)


@recorded_collective("all_reduce")
def pmin(mesh: PSMesh, xs: Sequence[Tensor], axis: str) -> list[Tensor]:
    """``lax.pmin(x, axis)``: each position receives its group's
    elementwise minimum."""
    return _reduce(mesh, xs, axis, torch.minimum)


# ---------------------------------------------------------------------------
# Between the home device and the positions.
# ---------------------------------------------------------------------------

def scatter_workers(mesh: PSMesh, x: Tensor, dim: int = 0) -> list[Tensor]:
    """Worker ``w``'s ``w``-th of ``W`` equal pieces of ``x`` along ``dim``,
    on its device, for this process's workers (``x`` sharded over both
    axes, the JAX package's ``P(('data', 'shard'))``: every process passes
    the same ``x``). One worker takes ``x`` itself."""
    pos = mesh.positions
    W = len(mesh.slot)
    if W == 1:
        return [_to(x, pos[0])]
    pieces = torch.tensor_split(x, W, dim)
    return [_to(pieces[w], dev) for w, dev in zip(mesh.local, pos)]


def scatter_local(mesh: PSMesh, x: Tensor, dim: int = 0) -> list[Tensor]:
    """This process's workers' equal pieces of ``x`` along ``dim``, which
    holds their columns only, each on its worker's device (on one process
    :func:`scatter_workers`). One worker takes ``x`` itself."""
    pos = mesh.positions
    if len(pos) == 1:
        return [_to(x, pos[0])]
    return [_to(piece, dev) for piece, dev in
            zip(torch.tensor_split(x, len(pos), dim), pos)]


def own_columns(mesh: PSMesh, columns: dict, dim: int) -> dict:
    """Each of ``columns`` (numpy arrays or tensors whose ``dim`` holds
    every worker's equal share, worker-major) cut to this process's
    workers' shares; on one process, the columns themselves."""
    if mesh.procs is None:
        return columns
    W, lo, n = len(mesh.slot), mesh.local[0], len(mesh.local)
    out = {}
    for k, v in columns.items():
        share = v.shape[dim] // W
        index = [slice(None)] * dim + [slice(lo * share, (lo + n) * share)]
        out[k] = v[tuple(index)]
    return out


@recorded_collective("replicate")
def replicate(mesh: PSMesh, pieces: Sequence[Tensor]) -> list[Tensor]:
    """Shard ``s``'s piece (``pieces[s]``) on every position ``(d, s)`` of
    this process: a table's blocks from its ``S`` pieces. With more than
    one data replica each position gets memory of its own (a replica's
    block is updated in place by its own pushes)."""
    S = mesh.shape[SHARD_AXIS]
    if len(pieces) != S:
        raise ValueError(f"{len(pieces)} pieces for {S} shards")
    copy = mesh.shape[DATA_AXIS] > 1
    return [pieces[p % S].to(dev, non_blocking=True, copy=copy)
            for p, dev in zip(mesh.local, mesh.positions)]


@recorded_collective("broadcast")
def broadcast(mesh: PSMesh, x: Tensor) -> list[Tensor]:
    """``x`` (on the home device) on every position of this process: an
    input the JAX package places replicated (``P()``). Positions on ``x``'s
    device share it."""
    return [_to(x, dev) for dev in mesh.positions]


def home(mesh: PSMesh, xs: Sequence[Tensor]) -> list[Tensor]:
    """``xs`` on the process's home device (no exchange)."""
    return [_to(x, mesh.device) for x in xs]


@recorded_collective("gather_home")
def gather_home(mesh: PSMesh, xs: Sequence[Tensor]) -> list[Tensor]:
    """Every position's tensor (``xs``: this process's, of one shape and
    dtype), ``W`` of them in worker order, on the home device. Over several
    processes a collective: one ``all_gather`` over all of them, and every
    process gets every tensor."""
    _check(mesh, xs)
    if mesh.procs is None:
        return home(mesh, xs)
    import torch.distributed as dist

    known = _gather(dist.group.WORLD, range(mesh.procs.world), mesh, xs)
    return [known[w] for w in range(len(mesh.slot))]


def gather_first(mesh: PSMesh, xs: Sequence[Tensor], n: int) -> list[Tensor]:
    """The tensors of positions ``[0, n)`` (``xs``: this process's, of one
    shape and dtype), on the home device of every process of a mesh over
    several processes: a collective, in which each process that holds some
    of them broadcasts those, so each process receives each tensor once."""
    _check(mesh, xs)
    import torch.distributed as dist

    procs, like = mesh.procs, xs[0]
    staged, size = _staged(dist.group.WORLD, like), _nbytes(like)
    out = []
    for r in range(procs.world):
        held = [w for w in procs.positions_of(r) if w < n]
        if not held:
            break
        if r == procs.rank:
            buf = _pack([xs[mesh.slot[w]] for w in held], staged)
        else:
            buf = _empty(len(held) * size, like, staged)
        dist.broadcast(buf, src=r)
        out += [_unpack(buf[i * size:(i + 1) * size], like, mesh.device)
                for i in range(len(held))]
    return out


def _sum_in_order(mesh: PSMesh, every: Sequence[Tensor]) -> Tensor:
    """Each replica's shards folded in index order, then the replicas."""
    return _fold([_fold([every[p] for p in g], mesh.device)
                  for g in groups(mesh, SHARD_AXIS)], mesh.device)


@recorded_collective("all_reduce")
def sum_home_each(mesh: PSMesh, leaves: Sequence[Sequence[Tensor]]
                  ) -> list[Tensor]:
    """``psum(psum(x, 'shard'), 'data')`` of each ``x`` of ``leaves`` (one
    tensor a position of this process), on the home device: each replica's
    shards folded in index order, then the replicas. Over several processes
    every position's leaves travel in one exchange, joined as bytes, and
    every process folds every position's in that order."""
    if mesh.procs is None:
        return [_sum_in_order(mesh, xs) for xs in leaves]
    if not leaves:
        return []
    likes = [xs[0] for xs in leaves]
    sizes = [_nbytes(x) for x in likes]
    packed = [_pack([xs[i] for xs in leaves], False)
              for i in range(len(mesh.local))]
    every = gather_home(mesh, packed)
    out, off = [], 0
    for like, n in zip(likes, sizes):
        out.append(_sum_in_order(mesh, [
            _unpack(b[off:off + n], like, mesh.device) for b in every]))
        off += n
    return out
