"""The parameter-server mesh of the PyTorch port.

Port of ``fps_tpu/parallel/mesh.py``. The mesh keeps the JAX package's two
named axes, ``data`` (tables replicated, examples split) and ``shard``
(tables row-sharded, the reference's ``psParallelism``), so code written
against ``mesh.shape[DATA_AXIS]`` / ``mesh.shape[SHARD_AXIS]`` reads the
same in both packages.

One process drives every position of the mesh (a single controller, as the
JAX package drives every device of its mesh from one process). Position
``w = d * S + s`` (the JAX package's row-major ``(data, shard)`` order, its
worker index) runs on ``mesh.devices[d][s]``; positions may name the same
device, which is how the tests run an 8-position mesh on the CPU and how a
host with one card runs a ``(1, 4)`` mesh. What lives on the mesh is held as
:class:`Blocks`, one tensor a position. Data moves between positions only
through :mod:`fps_tpu_torch.parallel.collectives`. Every model family of the
port runs on a mesh of any shape: MF, PA and logistic regression through the
``Trainer``, word2vec through it and ``Word2VecDevicePlan``, iALS through its
own solver and top-k retrieval where the table lies.

A mesh over several processes (``torch.distributed``) is ROADMAP.md Queue 1
item 4b.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

import numpy as np
import torch

DATA_AXIS = "data"
SHARD_AXIS = "shard"


@dataclasses.dataclass(frozen=True)
class PSMesh:
    """A ``(data, shard)`` mesh of torch devices.

    ``shape`` maps axis name to size, as ``jax.sharding.Mesh.shape`` does.
    ``devices`` is the ``(data, shard)`` grid of devices, a tuple of rows.
    """

    shape: Mapping[str, int]
    devices: tuple[tuple[torch.device, ...], ...]

    @property
    def device(self) -> torch.device:
        """The controller's home device (position 0's): the step's metrics,
        the step tap's outputs and host reads land there."""
        return self.devices[0][0]

    @property
    def positions(self) -> tuple[torch.device, ...]:
        """Each position's device, in worker order ``w = d * S + s``."""
        return tuple(dev for row in self.devices for dev in row)


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
        ``psParallelism``). Default: ``len(devices) // num_data``.
      num_data: size of the replicated data-parallel axis.
      devices: ``num_data * num_shards`` torch devices in row-major
        ``(data, shard)`` order; a device may repeat. Default: every visible
        CUDA device, as the JAX package's default is ``jax.devices()``.
      device: put every position on this one device (``"cpu"`` for the
        tests; ``"cuda:0"`` for several positions on one card). Then
        ``num_shards`` defaults to 1.

    Raises:
      RuntimeError: neither ``devices`` nor ``device`` given, and CUDA is not
        available.
      ValueError: the devices do not divide by ``num_data``, or the shape
        does not cover them (the JAX package's words).
    """
    if devices is not None and device is not None:
        raise ValueError("make_ps_mesh: pass devices or device, not both")
    if num_data < 1 or (num_shards is not None and num_shards < 1):
        raise ValueError(f"mesh {num_data}x{num_shards}: sizes must be >= 1")
    if device is not None:
        devices = [_device(device)] * (num_data * (num_shards or 1))
    elif devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "make_ps_mesh: CUDA is not available and no device was "
                "given; pass device='cpu' to run on the CPU")
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    devices = [_device(d) for d in devices]
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
    return PSMesh({DATA_AXIS: num_data, SHARD_AXIS: num_shards}, grid)


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


def num_workers_of(mesh: PSMesh) -> int:
    """Worker count: every position of the mesh is a worker."""
    return mesh.shape[DATA_AXIS] * mesh.shape[SHARD_AXIS]


class Blocks(tuple):
    """A global array held on the mesh as one block a position, in worker
    order ``w = d * S + s``: the port's counterpart of a ``jax.Array``
    sharded over the mesh.

    The global array is the first ``len(self) // replicas`` blocks, joined
    along axis 0; the other blocks repeat them. A table is replicated over
    the data axis (``replicas = D``: block ``d * S + s`` holds shard ``s``),
    worker-local state is not (``replicas = 1``: block ``w`` is worker
    ``w``'s rows). On a one-position mesh there is one block.
    """

    def __new__(cls, blocks, replicas: int = 1):
        self = super().__new__(cls, blocks)
        if replicas < 1 or len(self) % replicas:
            raise ValueError(f"Blocks: {len(self)} blocks do not hold "
                             f"{replicas} replicas")
        self.replicas = replicas
        return self

    @property
    def distinct(self) -> tuple:
        """The blocks that make the global array (no replicas)."""
        return tuple(self[:len(self) // self.replicas])

    def numpy(self) -> np.ndarray:
        """The global array on the host (the JAX package's layout)."""
        parts = [b.detach().cpu().numpy() for b in self.distinct]
        return parts[0] if len(parts) == 1 else np.concatenate(parts)
