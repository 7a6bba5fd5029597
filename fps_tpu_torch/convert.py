"""Weights carried across from the JAX package.

The port draws its own random numbers, so its initial tables are not the
JAX package's. To run both packages from the same state, read the JAX
package's tables and local state as numpy arrays (``np.asarray`` of the jax
arrays: the global arrays, tables in their owner-major physical layout) and
hand them to :func:`tables_from_jax` / :func:`local_state_from_jax`, which
cut them into the port's blocks, one a mesh position
(:class:`~fps_tpu_torch.parallel.mesh.Blocks`). Shapes and dtypes are
checked against the port's own; a mismatch raises. Over several processes
every process passes the same global arrays and takes its own positions'
pieces. :func:`to_numpy` is the way back, for comparisons: a table's blocks
give the JAX package's global physical table, the local state's the global
local state (a collective over several processes).

The hot tier's entries come across too, so a tiered run starts from the JAX
package's state: a replica (``name::hot``, ``(H, dim)``) goes to every
position, a hot fold's state (``name::fold``, or a snapshot's
``fold::name``; ``(ceil(H / S) * S, cols)`` in reduce-scatter slice order)
is cut into ``S`` slices, slice ``s`` on every position ``(d, s)``. So do
the mapped tier's: a slot map (``name::hotmap``, ``(num_ids + 1,)``
int32), a hot id array (``name::hotids``, ``(H,)`` int32) and a tracker's
window (``name::sketch``, ``(depth, width)`` float32), each to every
position. :func:`retierer_from_jax` builds a port
:class:`~fps_tpu_torch.tiering.Retierer` from the JAX package's
``Retierer.snapshot()``, so both packages start from the same tracker.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch

from fps_tpu_torch.core.api import WorkerLogic
from fps_tpu_torch.core.store import (
    ParamStore,
    fold_key,
    hot_key,
    ids_key,
    map_key,
    padded_rows,
    sketch_key,
    split_tiering,
)
from fps_tpu_torch.parallel.mesh import DATA_AXIS, Blocks, num_workers_of

_META = torch.device("meta")


def _check_array(what: str, array: np.ndarray, shape: tuple,
                 dtype: torch.dtype) -> None:
    if tuple(array.shape) != tuple(shape):
        raise ValueError(f"{what}: shape {tuple(array.shape)} != "
                         f"expected {tuple(shape)}")
    if torch.from_numpy(np.zeros((), array.dtype)).dtype != dtype:
        raise ValueError(f"{what}: dtype {array.dtype} != expected {dtype}")


def tables_from_jax(store: ParamStore, arrays: Mapping[str, np.ndarray], *,
                    device=None) -> dict[str, Blocks]:
    """The JAX package's tables (``{name: array}``, each the global
    ``(S * rps, dim)`` physical table) as the port's blocks on the store's
    mesh: shard ``s``'s rows on every position ``(d, s)``, each position
    its own copy. ``device``: every block there instead of its position's
    device. The hot tier's entries may come along (see the module's
    docstring); their tables must be among the store's."""
    arrays = {(fold_key(k[len("fold::"):]) if k.startswith("fold::")
               else k): v for k, v in arrays.items()}
    arrays, replicas, maps, gids, sketches, folds = split_tiering(arrays)
    if set(arrays) != set(store.specs):
        raise ValueError(f"tables {sorted(arrays)} != store tables "
                         f"{sorted(store.specs)}")
    for name in (list(replicas) + list(maps) + list(gids) + list(sketches)
                 + list(folds)):
        if name not in store.specs:
            raise ValueError(f"hot tier entry of {name!r}, which is not a "
                             "store table")
    mesh = store.mesh
    positions = (mesh.positions if device is None
                 else [torch.device(device)] * len(mesh.positions))
    if device is not None and mesh.procs is not None:
        raise ValueError("tables_from_jax: device= is for a mesh of one "
                         "process")
    S = store.num_shards

    def everywhere(array):
        return Blocks([torch.from_numpy(np.array(array, copy=True)).to(dev)
                       for dev in positions],
                      replicas=len(mesh.slot), mesh=mesh)

    out = {}
    for name, spec in store.specs.items():
        array = np.asarray(arrays[name])
        _check_array(f"table {name!r}", array,
                     (padded_rows(spec.num_ids, S), spec.dim), spec.dtype)
        out[name] = _sharded(array, S, mesh, positions)
    for name, array in replicas.items():
        spec = store.specs[name]
        array = np.asarray(array)
        _check_array(f"replica of {name!r}", array,
                     (array.shape[0], spec.dim), spec.dtype)
        out[hot_key(name)] = everywhere(array)
    for name, array in maps.items():
        array = np.asarray(array)
        _check_array(f"slot map of {name!r}", array,
                     (store.specs[name].num_ids + 1,), torch.int32)
        out[map_key(name)] = everywhere(array)
    for name, array in gids.items():
        array = np.asarray(array)
        _check_array(f"hot ids of {name!r}", array, (array.size,),
                     torch.int32)
        out[ids_key(name)] = everywhere(array)
    for name, array in sketches.items():
        array = np.asarray(array)
        if array.ndim != 2:
            raise ValueError(f"window of {name!r}: shape {array.shape} is "
                             "not (depth, width)")
        _check_array(f"window of {name!r}", array, array.shape,
                     torch.float32)
        out[sketch_key(name)] = everywhere(array)
    for name, array in folds.items():
        array = np.asarray(array)
        if array.ndim != 2 or array.shape[0] % S:
            raise ValueError(f"fold state of {name!r}: shape {array.shape} "
                             f"is not {S} equal slices")
        out[fold_key(name)] = _sharded(array, S, mesh, positions)
    return out


def _sharded(array: np.ndarray, S: int, mesh, positions) -> Blocks:
    """``array`` cut into ``S`` slices, slice ``s`` on every position
    ``(d, s)``, each position its own copy."""
    shards = np.split(array, S)
    return Blocks([torch.from_numpy(np.array(shards[p % S],
                                             copy=True)).to(dev)
                   for p, dev in zip(mesh.local, positions)],
                  replicas=mesh.shape[DATA_AXIS], mesh=mesh)


def local_state_from_jax(logic: WorkerLogic, array: np.ndarray, *,
                         device=None, num_workers: int = 1,
                         mesh=None) -> Blocks:
    """The JAX package's worker-local state (one global array, sharded over
    the workers on axis 0) as the port's blocks, worker ``w``'s rows
    ``[w * n, (w + 1) * n)`` on its position's device (``mesh``; this
    process's workers), or on ``device`` for each of ``num_workers``
    workers. The expected shape and dtype are those of
    ``logic.init_local_state`` for that many workers."""
    if mesh is not None:
        positions, own = list(mesh.positions), list(mesh.local)
        num_workers = num_workers_of(mesh)
    elif device is not None:
        positions = [torch.device(device)] * num_workers
        own = list(range(num_workers))
    else:
        raise ValueError("local_state_from_jax: pass mesh or device")
    like = logic.init_local_state(0, num_workers, _META)
    if not isinstance(like, torch.Tensor):
        raise TypeError(f"{type(logic).__name__}'s local state is not one "
                        "tensor")
    array = np.asarray(array)
    _check_array("local state", array, like.shape, like.dtype)
    parts = np.split(array, num_workers)
    return Blocks([torch.from_numpy(np.array(parts[w], copy=True)).to(dev)
                   for w, dev in zip(own, positions)], mesh=mesh)


def retierer_from_jax(snapshot: Mapping, **kwargs):
    """A port :class:`~fps_tpu_torch.tiering.Retierer` (made with
    ``kwargs``) holding the tracker state of the JAX package's
    ``Retierer.snapshot()``: its decayed sketches, hot sets, fold count,
    plans (as the port's :class:`~fps_tpu_torch.tiering.TierPlan`), seed
    windows and counts."""
    from fps_tpu_torch.tiering import Retierer, TierPlan

    plans = snapshot["plans"]
    if plans:
        plans = {n: TierPlan(**dict(p.to_json() if hasattr(p, "to_json")
                                    else p))
                 for n, p in plans.items()}
    rt = Retierer(**kwargs)
    rt.restore_snapshot(dict(snapshot, plans=plans,
                             state={k: np.asarray(v) for k, v in
                                    snapshot["state"].items()},
                             hot_ids={k: np.asarray(v) for k, v in
                                      snapshot["hot_ids"].items()}))
    return rt


def to_numpy(x: Any):
    """Tensors and :class:`Blocks` (or a dict of them) as numpy arrays on
    the host; a ``Blocks`` gives its global array."""
    if isinstance(x, Mapping):
        return {k: to_numpy(v) for k, v in x.items()}
    if isinstance(x, Blocks):
        return x.numpy()
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)
