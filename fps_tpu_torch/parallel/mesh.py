"""The parameter-server mesh of the PyTorch port.

Port of ``fps_tpu/parallel/mesh.py``. The mesh keeps the JAX package's two
named axes, ``data`` (tables replicated, examples split) and ``shard``
(tables row-sharded, the reference's ``psParallelism``), so code written
against ``mesh.shape[DATA_AXIS]`` / ``mesh.shape[SHARD_AXIS]`` reads the
same in both packages.

Position ``w = d * S + s`` (the JAX package's row-major ``(data, shard)``
order, its worker index) runs on ``mesh.devices[d][s]``; positions may name
the same device, which is how the tests run an 8-position mesh on the CPU
and how a host with one card runs a ``(1, 4)`` mesh. What lives on the mesh
is held as :class:`Blocks`, one tensor a position. Data moves between
positions only through :mod:`fps_tpu_torch.parallel.collectives`. Every
model family of the port runs on a mesh of any shape: MF, PA and logistic
regression through the ``Trainer``, word2vec through it and
``Word2VecDevicePlan``, iALS through its own solver and top-k retrieval
where the table lies.

**One process** (no :func:`init_distributed`) drives every position of the
mesh, as the JAX package drives every device of its mesh from one process.

**Several processes** (``torch.distributed``; the JAX package's
multi-controller mode): every process calls :func:`init_distributed`, then
:func:`make_ps_mesh` with the global shape and its own devices. Rank ``r`` of
``P`` owns the contiguous run of positions ``[r * W / P, (r + 1) * W / P)``
in worker order (``jax.devices()``'s process-major order), holds and drives
only those (``PSMesh.local``), and makes only their blocks. Collectives
whose group crosses processes exchange tensors through the process groups
the mesh made for them (NCCL between cards, gloo on the CPU). Host reads
(:meth:`Blocks.numpy`, :attr:`Blocks.distinct`, the store's ``table``,
``lookup_host`` and ``dump_model``, ``recommend_topk``) are collectives:
every process calls them, and each gets the whole result (the JAX
package's contract: every rank calls, rank 0 uses it). The JAX package's
``key_to_replicated`` has no counterpart: the port's seeds are host ints,
the same in every process.
"""

from __future__ import annotations

import dataclasses
import datetime
import math
from typing import Any, Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True, eq=False)
class Procs:
    """The processes a mesh spans: this process's ``rank`` of ``world``,
    ``per_rank`` positions each, and for each axis whose groups cross
    processes, the process group of this rank's groups on it and its ranks
    (``groups[axis] = (group, ranks)``; an axis whose groups lie inside
    every process is absent)."""

    rank: int
    world: int
    per_rank: int
    groups: Mapping[str, tuple[Any, tuple[int, ...]]]

    def positions_of(self, rank: int) -> range:
        return range(rank * self.per_rank, (rank + 1) * self.per_rank)


@dataclasses.dataclass(frozen=True)
class PSMesh:
    """A ``(data, shard)`` mesh of torch devices.

    ``shape`` maps axis name to size, as ``jax.sharding.Mesh.shape`` does.
    ``devices`` is the ``(data, shard)`` grid of devices, a tuple of rows
    (over several processes, each position's device as its rank named it).
    ``local`` holds this process's positions (worker indices, ascending):
    every position on one process. ``procs`` is ``None`` on one process.
    ``member[axis][w]`` is position ``w``'s group along ``axis`` (as
    :func:`axis_groups` gives it) and its index in that group.
    """

    shape: Mapping[str, int]
    devices: tuple[tuple[torch.device, ...], ...]
    local: tuple[int, ...] | None = None
    procs: Procs | None = None

    def __post_init__(self):
        W = self.shape[DATA_AXIS] * self.shape[SHARD_AXIS]
        if self.local is None:
            object.__setattr__(self, "local", tuple(range(W)))
        grid = [dev for row in self.devices for dev in row]
        object.__setattr__(self, "_positions",
                           tuple(grid[w] for w in self.local))
        slot = [-1] * W
        for i, w in enumerate(self.local):
            slot[w] = i
        object.__setattr__(self, "slot", tuple(slot))
        member = {}
        for axis in (SHARD_AXIS, DATA_AXIS):
            at = [None] * W
            for g in axis_groups(self.shape[DATA_AXIS],
                                 self.shape[SHARD_AXIS], axis):
                for i, p in enumerate(g):
                    at[p] = (tuple(g), i)
            member[axis] = tuple(at)
        object.__setattr__(self, "member", member)

    @property
    def device(self) -> torch.device:
        """The process's home device (its first position's): the step's
        metrics, the step tap's outputs and host reads land there."""
        return self._positions[0]

    @property
    def positions(self) -> tuple[torch.device, ...]:
        """This process's positions' devices, in worker order ``w = d * S +
        s`` (every position's on one process)."""
        return self._positions


def _device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"make_ps_mesh: unsupported device {device}")
    return device


def make_ps_mesh(num_shards: int | None = None, num_data: int = 1, *,
                 devices: Sequence | None = None,
                 device: torch.device | str | None = None) -> PSMesh:
    """Build the ``(data, shard)`` mesh.

    Args:
      num_shards: size of the parameter-shard axis (the reference's
        ``psParallelism``). Default: ``len(devices) // num_data`` (over
        several processes: every process's devices counted).
      num_data: size of the replicated data-parallel axis.
      devices: this process's torch devices, one a position, in row-major
        ``(data, shard)`` order; a device may repeat. Default: every visible
        CUDA device, as the JAX package's default is ``jax.devices()``
        (over several processes: the card :func:`init_distributed` made
        current, with one position on it, or ``W / P`` where ``num_shards``
        is given).
      device: put every position of this process on this one device
        (``"cpu"`` for the tests; ``"cuda:0"`` for several positions on one
        card). Then ``num_shards`` defaults to 1.

    After :func:`init_distributed` the shape is global and every process
    passes its own devices (``device``: ``W / P`` positions on it), all of
    them one device (the exchanges between processes join a process's
    tensors in one buffer, and NCCL takes one card a process): rank
    ``r`` owns positions ``[r * W / P, (r + 1) * W / P)``. Every process must
    call it, with the same shape: it makes the process groups of the axes
    that cross processes, each process calling ``new_group`` for every group
    in the same order.

    Raises:
      RuntimeError: neither ``devices`` nor ``device`` given, and CUDA is not
        available.
      ValueError: the devices do not divide by ``num_data``, or the shape
        does not cover them (the JAX package's words); over several
        processes, the positions do not split evenly over the processes, a
        group would take unequal counts from them, or a process names more
        than one device.
    """
    if devices is not None and device is not None:
        raise ValueError("make_ps_mesh: pass devices or device, not both")
    if num_data < 1 or (num_shards is not None and num_shards < 1):
        raise ValueError(f"mesh {num_data}x{num_shards}: sizes must be >= 1")
    world = _world()
    if device is not None:
        n = num_data * (num_shards or 1)
        if world > 1 and n % world:
            raise ValueError(f"mesh of {n} positions over {world} processes")
        devices = [_device(device)] * (n // max(world, 1))
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_ps_mesh: CUDA is not available and no device was "
                "given; pass device='cpu' to run on the CPU")
        if world:
            # One card a process, the one init_distributed made current.
            per_rank = 1
            if num_shards is not None:
                n = num_data * num_shards
                if n % world:
                    raise ValueError(
                        f"mesh of {n} positions over {world} processes")
                per_rank = n // world
            devices = [_device("cuda")] * per_rank
        else:
            devices = [torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
    local = None
    if world:
        if len(set(devices)) > 1:
            raise ValueError(
                "make_ps_mesh: over several processes a process holds its "
                f"positions on one device, not on {len(set(devices))} "
                f"({', '.join(sorted(map(str, set(devices))))})")
        devices, local = _global_devices(devices, world)
    n = len(devices)
    if num_shards is None:
        if n % num_data != 0:
            raise ValueError(
                f"{n} devices not divisible by num_data={num_data}")
        num_shards = n // num_data
    if num_data * num_shards != n:
        raise ValueError(
            f"mesh {num_data}x{num_shards} does not cover {n} devices")
    grid = tuple(tuple(devices[d * num_shards:(d + 1) * num_shards])
                 for d in range(num_data))
    shape = {DATA_AXIS: num_data, SHARD_AXIS: num_shards}
    procs = None if not world else _make_procs(shape, len(local), world)
    return PSMesh(shape, grid, local, procs)


# ---------------------------------------------------------------------------
# Several processes.
# ---------------------------------------------------------------------------

def init_distributed(init_method: str, world_size: int, rank: int, *,
                     backend: str | None = None,
                     device: torch.device | str | None = None,
                     timeout: datetime.timedelta = datetime.timedelta(
                         minutes=5)) -> None:
    """Join this process to a mesh over ``world_size`` processes (the JAX
    package's ``init_distributed``; call once a process, before
    :func:`make_ps_mesh`).

    Every argument is explicit: nothing is read from the environment.
    ``init_method`` is a ``torch.distributed`` rendezvous
    (``"tcp://host:port"`` or ``"file:///path"``). ``device`` is where this
    process's positions will live (default: its current CUDA device when
    CUDA is available, else the CPU); ``backend`` defaults to ``"nccl"`` for
    a CUDA device and ``"gloo"`` for the CPU. NCCL takes one process a card.
    ``timeout`` bounds every collective, so that a peer that died fails the
    others instead of hanging them.
    """
    import torch.distributed as dist

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = _device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=init_method,
                            world_size=world_size, rank=rank,
                            timeout=timeout)


def shutdown_distributed() -> None:
    """Leave the processes' group (every process, at its end)."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _world() -> int:
    """Processes of the default group, 0 without ``torch.distributed``."""
    if not torch.distributed.is_available():
        return 0
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 0


def _global_devices(devices, world: int):
    """Every process's devices in rank order (one host read a process, at
    build), and this process's positions; every process must bring the
    same count."""
    import torch.distributed as dist

    named = [None] * world
    dist.all_gather_object(named, [str(d) for d in devices])
    counts = [len(n) for n in named]
    if len(set(counts)) != 1:
        raise ValueError(f"make_ps_mesh: processes bring {counts} positions; "
                         "each must bring the same count")
    c, rank = len(devices), dist.get_rank()
    everyone = [torch.device(d) for n in named for d in n]
    everyone[rank * c:(rank + 1) * c] = devices
    return everyone, tuple(range(rank * c, (rank + 1) * c))


def _make_procs(shape: Mapping[str, int], per_rank: int, world: int) -> Procs:
    """The process groups of the axis groups that cross processes: for each
    axis, the distinct rank sets of its groups, each made by every process
    in the same order."""
    import torch.distributed as dist

    D, S = shape[DATA_AXIS], shape[SHARD_AXIS]
    if per_rank >= S and per_rank % S or per_rank < S and S % per_rank:
        raise ValueError(
            f"mesh {D}x{S} over {world} processes of {per_rank} positions: "
            "each process must hold whole data replicas or an equal part "
            "of one")
    rank = dist.get_rank()
    groups = {}
    for axis in (SHARD_AXIS, DATA_AXIS):
        sets = []
        for g in axis_groups(D, S, axis):
            ranks = tuple(sorted({w // per_rank for w in g}))
            if len(ranks) > 1 and ranks not in sets:
                sets.append(ranks)
        for ranks in sets:
            pg = dist.new_group(list(ranks))
            if rank in ranks:
                groups[axis] = (pg, ranks)
    return Procs(rank, world, per_rank, groups)


def host_to_replicated(x, mesh: PSMesh) -> list[torch.Tensor]:
    """A host array replicated over the mesh: every process passes the same
    array and gets it on each of its positions (the JAX package's ``P()``
    placement)."""
    t = torch.as_tensor(np.asarray(x))
    return [t.to(dev) for dev in mesh.positions]


def host_to_sharded(x, mesh: PSMesh, dim: int = 0) -> "Blocks":
    """A global host array sharded over both axes (``P(('data',
    'shard'))`` on ``dim``): every process passes the same array and keeps
    the pieces of its own positions, worker ``w``'s the ``w``-th of ``W``
    equal pieces."""
    t = torch.as_tensor(np.asarray(x))
    pieces = torch.tensor_split(t, num_workers_of(mesh), dim)
    return Blocks([pieces[w].to(dev) for w, dev in zip(mesh.local,
                                                       mesh.positions)],
                  mesh=mesh)


def default_mesh_shape(n_devices: int) -> tuple[int, int]:
    """Factor ``n_devices`` into a (data, shard) shape, square-ish with
    shard >= data (sharding is the scarce resource: device memory)."""
    best = (1, n_devices)
    d = int(math.isqrt(n_devices))
    while d >= 1:
        if n_devices % d == 0 and n_devices // d >= d:
            best = (d, n_devices // d)
            break
        d -= 1
    return best


def axis_groups(D: int, S: int, axis: str) -> list[list[int]]:
    """The positions of each group along ``axis`` of a ``(D, S)`` mesh, in
    index order: along ``shard`` the ``S`` positions of one data replica,
    along ``data`` the ``D`` replicas of one shard."""
    if axis == SHARD_AXIS:
        return [[d * S + s for s in range(S)] for d in range(D)]
    if axis == DATA_AXIS:
        return [[d * S + s for d in range(D)] for s in range(S)]
    raise ValueError(f"unknown mesh axis {axis!r}")


def num_workers_of(mesh: PSMesh) -> int:
    """Worker count: every position of the mesh is a worker."""
    return mesh.shape[DATA_AXIS] * mesh.shape[SHARD_AXIS]


class Blocks(tuple):
    """A global array held on the mesh as one block a position, in worker
    order ``w = d * S + s``: the port's counterpart of a ``jax.Array``
    sharded over the mesh.

    The global array is the first ``W // replicas`` blocks, joined along
    axis 0; the other blocks repeat them. A table is replicated over the
    data axis (``replicas = D``: block ``d * S + s`` holds shard ``s``),
    worker-local state is not (``replicas = 1``: block ``w`` is worker
    ``w``'s rows). On a one-position mesh there is one block.

    ``mesh``: the mesh the blocks lie on. Over several processes a
    ``Blocks`` holds this process's blocks only, block ``i`` at position
    ``mesh.local[i]``, and :attr:`distinct` and :meth:`numpy` are
    collectives (every process calls them). Without a mesh, or on one
    process, the blocks are every position's.
    """

    def __new__(cls, blocks, replicas: int = 1, mesh: PSMesh | None = None):
        self = super().__new__(cls, blocks)
        spans = mesh is not None and mesh.procs is not None
        W = num_workers_of(mesh) if spans else len(self)
        if replicas < 1 or W % replicas:
            raise ValueError(f"Blocks: {W} blocks do not hold "
                             f"{replicas} replicas")
        if spans and len(self) != len(mesh.local):
            raise ValueError(f"Blocks: {len(self)} blocks for a process of "
                             f"{len(mesh.local)} positions")
        self.replicas = replicas
        self.mesh = mesh if spans else None
        return self

    @property
    def distinct(self) -> tuple:
        """The blocks that make the global array (no replicas). Over
        several processes a collective: every process gets them all, on
        its home device, each sent once by the process that holds its
        first replica."""
        if self.mesh is None:
            return tuple(self[:len(self) // self.replicas])
        from fps_tpu_torch.parallel import collectives

        return tuple(collectives.gather_first(
            self.mesh, list(self),
            num_workers_of(self.mesh) // self.replicas))

    def numpy(self) -> np.ndarray:
        """The global array on the host (the JAX package's layout); a
        collective over several processes."""
        parts = [b.detach().cpu().numpy() for b in self.distinct]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
