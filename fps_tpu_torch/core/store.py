"""The parameter store: tables, pull and push.

Port of the untiered part of ``fps_tpu/core/store.py``. A table is one
``(rows, dim)`` array in the JAX package's **owner-major cyclic** layout:
id ``i`` lives at physical row ``(i % S) * rps + i // S`` for ``S`` shards of
``rps`` rows each, shard ``s`` holding rows ``[s * rps, (s + 1) * rps)``. On
the mesh a table is held as :class:`~fps_tpu_torch.parallel.mesh.Blocks`,
one ``(rps, dim)`` block a position, replicated over the data axis.

:func:`pull` and :func:`push` take every position's block and every
worker's ids at once (the single controller) and do what the JAX package's
do under ``shard_map``, with the collectives of
:mod:`fps_tpu_torch.parallel.collectives` in place of ``jax.lax``'s: each
shard's gather and scatter-add run on its block through
:mod:`fps_tpu_torch.ops`, so on the card on the port's hand-written
kernels. On a one-position mesh every collective is the identity: a pull is
one row gather and a push one scatter-add (or a combine-then-fold).

``TableSpec.hot_ids`` takes an int (the frequency-ranked head: the scalar
tables' head-prefix route, and the hot/cold push split of wider tables
through kernel K3) or ``"auto"`` (the whole shard through K3 when it has
no more rows than :func:`fps_tpu_torch.ops.packed_crossover_rows` allows
at its width, and through K2 otherwise). ``TableSpec.dense_collectives``
``True`` takes the dense route on a mesh of more than one position;
``"auto"`` keeps the gathered route (the JAX package's size threshold was
measured on a TPU's interconnect).

**The static hot tier** (``TableSpec.hot_tier = H``, the NuPS design of a
replicated head and a sharded tail). A tiered table also keeps its leading
``H`` ids as an ``(H, dim)`` replica on every position (the tables dict's
``hot_key(name)`` entry) and, inside a call, a pending-delta buffer a
position. :func:`pull_hot` serves ``id < H`` from the replica with no
collective; the cold residue takes the table's routes with the hot slots
masked to ``-1`` (or packed into a ``cold_budget`` lane by
:func:`compact_cold`). :func:`accumulate_hot` folds the hot pushes into the
buffer, and :func:`reconcile_hot` folds the buffers into the replica and the
owners' head rows of the canonical table every
``TrainerConfig.hot_sync_every`` steps and at the end of every call, so at
a call's boundary the replica equals the canonical head rows bit for bit.
The reconcile is a reduce-scatter over the shard axis, a sum over the data
axis, an optional :class:`~fps_tpu_torch.core.api.HotFold` on the owned
slice (its state the ``fold_key(name)`` entry, sharded) and an all-gather,
all through the fixed-order folds of
:mod:`fps_tpu_torch.parallel.collectives`.

**The mapped (adaptive) tier** (a :class:`~fps_tpu_torch.tiering.Retierer`
attached to the trainer). The replica holds an arbitrary hot id set: slot
``j`` holds global id ``hot_ids[j]``. The set rides the tables dict as
data of fixed shapes, replicated on every position: an id -> slot map
(``map_key(name)``, :func:`hot_slot_map`) and its inverse
(``ids_key(name)``), so a re-rank swaps values, never shapes. Membership is
a slot lookup (:func:`lookup_hot_slots`), the hot half of a push is in slot
space (:func:`split_hot_push_slots`), and :func:`reconcile_hot_mapped`
scatters the window's step into the owners' rows of the current ids.
:meth:`ParamStore.rows_replica` derives the replica of any id set from
the canonical table by a copy; :func:`replica_from_shard` and
:func:`device_slot_map` do the same from ids on the device, with no host
read (the megastep's tier tick). ``sketch_key(name)`` holds the tracker's
count-min window of the pulled ids.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.rng import fold_seed, uniform_by_id
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Blocks, PSMesh

Tensor = torch.Tensor


# ---------------------------------------------------------------------------
# Physical layout helpers (owner-major cyclic); ints, numpy or torch.
# ---------------------------------------------------------------------------

def rows_per_shard(num_ids: int, num_shards: int) -> int:
    return -(-num_ids // num_shards)  # ceil


def padded_rows(num_ids: int, num_shards: int) -> int:
    return rows_per_shard(num_ids, num_shards) * num_shards


def id_to_phys(ids, num_shards: int, rps: int):
    """Global physical row index of each parameter id."""
    return (ids % num_shards) * rps + ids // num_shards


def phys_to_id(phys, num_shards: int, rps: int):
    """Inverse of :func:`id_to_phys` (may exceed num_ids for padding rows)."""
    return (phys % rps) * num_shards + phys // rps


def _positions(x) -> tuple[bool, list]:
    """``(one, seq)``: a lone tensor is the one position of a one-position
    mesh; a sequence holds one tensor a position, in worker order."""
    if isinstance(x, Tensor):
        return True, [x]
    return False, list(x)


def _mesh_of(blocks: list[Tensor], num_shards: int,
             mesh: PSMesh | None = None) -> PSMesh:
    """The mesh the blocks lie on: ``mesh`` when given (its process's
    blocks), else one process's ``len(blocks) // num_shards`` data replicas
    of ``num_shards`` shards, each position on its block's device."""
    if mesh is not None:
        if len(blocks) != len(mesh.local) or mesh.shape[
                SHARD_AXIS] != num_shards:
            raise ValueError(f"{len(blocks)} blocks of {num_shards} shards "
                             f"on a mesh {dict(mesh.shape)} of "
                             f"{len(mesh.local)} own positions")
        return mesh
    W = len(blocks)
    if num_shards < 1 or W % num_shards:
        raise ValueError(f"{W} blocks do not make data replicas of "
                         f"{num_shards} shards")
    devs = [b.device for b in blocks]
    grid = tuple(tuple(devs[d * num_shards:(d + 1) * num_shards])
                 for d in range(W // num_shards))
    return PSMesh({DATA_AXIS: W // num_shards, SHARD_AXIS: num_shards}, grid)


def _result(one: bool, out: list):
    return out[0] if one else out


# ---------------------------------------------------------------------------
# The static hot tier: a replicated head, pending deltas, the reconcile.
# ---------------------------------------------------------------------------

# The tier's entries ride the tables dict beside the tables they serve,
# under reserved suffixes: the replica (every position's copy), the mapped
# tier's id -> slot map and slot -> id array and the tracker's count-min
# window (each replicated), and the hot fold's state (sharded over the
# shard axis). The canonical tables are the keys without a suffix.
HOT_KEY_SUFFIX = "::hot"
MAP_KEY_SUFFIX = "::hotmap"
IDS_KEY_SUFFIX = "::hotids"
SKETCH_KEY_SUFFIX = "::sketch"
FOLD_KEY_SUFFIX = "::fold"
AUX_KEY_SUFFIXES = (HOT_KEY_SUFFIX, MAP_KEY_SUFFIX, IDS_KEY_SUFFIX,
                    SKETCH_KEY_SUFFIX, FOLD_KEY_SUFFIX)


def hot_key(name: str) -> str:
    """Tables-dict key of ``name``'s replicated head."""
    return name + HOT_KEY_SUFFIX


def map_key(name: str) -> str:
    """Tables-dict key of ``name``'s replicated id -> slot map."""
    return name + MAP_KEY_SUFFIX


def ids_key(name: str) -> str:
    """Tables-dict key of ``name``'s replicated slot -> id array."""
    return name + IDS_KEY_SUFFIX


def sketch_key(name: str) -> str:
    """Tables-dict key of ``name``'s count-min window of pulled ids."""
    return name + SKETCH_KEY_SUFFIX


def fold_key(name: str) -> str:
    """Tables-dict key of ``name``'s sharded hot-fold state."""
    return name + FOLD_KEY_SUFFIX


def is_hot_key(key: str) -> bool:
    return key.endswith(HOT_KEY_SUFFIX)


def is_aux_key(key: str) -> bool:
    """Whether ``key`` is a tier entry (a replica, a slot map, an id array,
    a sketch window or a fold state)."""
    return any(key.endswith(s) for s in AUX_KEY_SUFFIXES)


def hot_base(key: str) -> str:
    """Inverse of :func:`hot_key`."""
    return key[: -len(HOT_KEY_SUFFIX)]


def split_tiering(tables: Mapping[str, Any]
                  ) -> tuple[dict, dict, dict, dict, dict, dict]:
    """``(canonical, replicas, maps, gids, sketches, folds)`` of a tables
    dict, the tier's entries keyed by their table's name."""
    parts = {s: {} for s in AUX_KEY_SUFFIXES}
    canonical = {}
    for k, v in tables.items():
        for suffix, part in parts.items():
            if k.endswith(suffix):
                part[k[: -len(suffix)]] = v
                break
        else:
            canonical[k] = v
    return (canonical, parts[HOT_KEY_SUFFIX], parts[MAP_KEY_SUFFIX],
            parts[IDS_KEY_SUFFIX], parts[SKETCH_KEY_SUFFIX],
            parts[FOLD_KEY_SUFFIX])


def hot_slot_map(num_ids: int, hot_gids) -> np.ndarray:
    """The ``(num_ids + 1,)`` int32 id -> slot map of a hot id set: entry
    ``i`` is global id ``i``'s replica slot (``-1``: cold), and the trailing
    sentinel entry stays ``-1``, so every id outside ``[0, num_ids)`` can be
    looked up there (:func:`lookup_hot_slots`)."""
    gids = np.asarray(hot_gids, np.int64)
    if gids.size and (gids.min() < 0 or gids.max() >= num_ids):
        raise ValueError(f"hot ids outside [0, {num_ids}): "
                         f"[{gids.min()}, {gids.max()}]")
    if len(np.unique(gids)) != len(gids):
        raise ValueError("hot id set contains duplicates")
    m = np.full(num_ids + 1, -1, np.int32)
    m[gids] = np.arange(len(gids), dtype=np.int32)
    return m


def device_slot_map(num_ids: int, hot_gids: Tensor) -> Tensor:
    """:func:`hot_slot_map` built on ``hot_gids``' device, with no host
    read: the megastep's tier tick draws the ids from ``arange``, so
    nothing is validated. For the same ids the same bits as
    :func:`hot_slot_map` (a function of the ids' order)."""
    m = torch.full((num_ids + 1,), -1, dtype=torch.int32,
                   device=hot_gids.device)
    return m.index_put_(
        (hot_gids.to(torch.int64),),
        torch.arange(hot_gids.shape[0], dtype=torch.int32,
                     device=hot_gids.device))


def lookup_hot_slots(slot_map: Tensor, ids: Tensor) -> Tensor:
    """Each id's replica slot, ``-1`` for a cold id, padding or any id
    outside ``[0, num_ids)``: those are mapped to the sentinel entry before
    the lookup (the JAX package's ``jnp.take`` fills an index past the map
    with ``INT_MIN`` instead; both are ``slot < 0``, cold)."""
    sentinel = slot_map.shape[0] - 1
    idx = torch.where((ids >= 0) & (ids < sentinel), ids, sentinel)
    return slot_map.index_select(0, idx.to(torch.int64))


def split_hot_push_slots(ids: Tensor, deltas: Tensor, slots: Tensor
                         ) -> tuple[tuple[Tensor, Tensor],
                                    tuple[Tensor, Tensor]]:
    """:func:`split_hot_push` of the mapped tier, on ``slots >= 0``:
    ``((cold_ids, cold_deltas), (hot_slots, hot_deltas))``, each with the
    other tier's entries masked to ``-1`` and zero deltas; the hot half is
    in slot space, for :func:`accumulate_hot`."""
    hot = slots >= 0
    zero = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    cold = (torch.where(hot, -1, ids).to(ids.dtype),
            torch.where(hot[:, None], zero, deltas))
    hots = (torch.where(hot, slots, -1).to(slots.dtype),
            torch.where(hot[:, None], deltas, zero))
    return cold, hots


def pull_hot(replica: Tensor, ids: Tensor, *,
             hot_ids: int) -> tuple[Tensor, Tensor]:
    """``(values, hot_mask)``: the replica's rows for ``id < hot_ids`` and
    zero rows elsewhere (the other slots are gathered as ``-1``), so the
    caller can ``where`` them against the cold route's rows, which are zero
    on the hot slots. One gather (K1, or K5 on a scalar table), no
    collective."""
    hot = (ids >= 0) & (ids < hot_ids)
    return ops.gather_rows(replica, torch.where(hot, ids, -1)), hot


def split_hot_push(ids: Tensor, deltas: Tensor, *, hot_ids: int
                   ) -> tuple[tuple[Tensor, Tensor], tuple[Tensor, Tensor]]:
    """``((cold_ids, cold_deltas), (hot_ids, hot_deltas))`` of one push on
    ``id < hot_ids``, each with the other tier's slots masked to ``-1`` and
    zero deltas (the store drops ``-1``)."""
    hot = (ids >= 0) & (ids < hot_ids)
    zero = torch.zeros((), dtype=deltas.dtype, device=deltas.device)
    cold = (torch.where(hot, -1, ids).to(ids.dtype),
            torch.where(hot[:, None], zero, deltas))
    hots = (torch.where(hot, ids, -1).to(ids.dtype),
            torch.where(hot[:, None], deltas, zero))
    return cold, hots


def delta_counted(combine: str, fold) -> bool:
    """Whether a pending-delta buffer carries the push-count column: the
    ``"mean"`` combine needs it to normalize, a stateful fold to apply to
    touched rows only."""
    return combine == "mean" or fold is not None


def compact_cold(ids: Tensor, deltas: Tensor | None, *, budget: int
                 ) -> tuple[Tensor, Tensor | None, Tensor, Tensor]:
    """Pack a masked cold-id stream into a ``(budget,)`` lane.

    ``ids`` is a ``(B,)`` stream whose hot and padding slots are ``-1``;
    its live entries are packed in order (cumsum positions) into the lane,
    padded with ``-1``, so the collective routes carry the lane, not the
    batch. Live entries past the budget are dropped (their pulls read zero
    rows): the trainer dispatches the compacted route only for chunks its
    host certifier proved to fit, and the overflow count is the device's
    net.

    Returns ``(lane_ids, lane_deltas, pos, overflowed)``: ``pos`` maps each
    slot of the batch to its lane position (``-1``: masked or dropped), for
    scattering the lane's pulled rows back; ``overflowed`` is the count of
    dropped live entries (an int32 scalar tensor).
    """
    live = ids >= 0
    pos = torch.cumsum(live.to(torch.int32), 0, dtype=torch.int32) - 1
    pos = torch.where(live & (pos < budget), pos, -1)
    # Masked and dropped slots land on an extra last row, cut off after.
    safe = torch.where(pos >= 0, pos, budget).to(torch.int64)
    lane_ids = torch.full((budget + 1,), -1, dtype=ids.dtype,
                          device=ids.device).index_copy_(
        0, safe, ids)[:budget]
    lane_deltas = None
    if deltas is not None:
        lane_deltas = torch.zeros(
            (budget + 1,) + tuple(deltas.shape[1:]), dtype=deltas.dtype,
            device=deltas.device).index_copy_(0, safe, deltas)[:budget]
    overflowed = torch.clamp(live.sum(dtype=torch.int32) - budget, min=0)
    return lane_ids, lane_deltas, pos, overflowed


def _extremum_fill(combine: str, dtype) -> float:
    lim = torch.finfo(dtype).max
    return -lim if combine == "max" else lim


def hot_delta_init(hot_rows: int, dim: int, dtype, *, combine: str = "sum",
                   fold=None, device=None) -> Tensor:
    """A fresh pending-delta buffer of one tiered table on ``device``.

    It accumulates in at least float32. ``"mean"`` (and any stateful fold)
    appends a push-count column; ``"max"`` / ``"min"`` keep an elementwise
    extremum, filled with the extremal sentinel, with a touched-indicator
    column (the extremum push's one-scatter form)."""
    acc_dt = torch.promote_types(dtype, torch.float32)
    if combine in ("max", "min"):
        return torch.full((hot_rows, dim + 1),
                          _extremum_fill(combine, acc_dt), dtype=acc_dt,
                          device=device)
    cols = dim + (1 if delta_counted(combine, fold) else 0)
    return torch.zeros((hot_rows, cols), dtype=acc_dt, device=device)


def _reset_delta(delta_buf: Tensor, combine: str) -> Tensor:
    """The window's end: a buffer of zeros, or of the extremal sentinel for
    ``"max"`` / ``"min"``."""
    if combine in ("max", "min"):
        return torch.full_like(delta_buf,
                               _extremum_fill(combine, delta_buf.dtype))
    return torch.zeros_like(delta_buf)


def accumulate_hot(delta_buf: Tensor, hot_ids_arr: Tensor,
                   hot_deltas: Tensor, *, combine: str = "sum",
                   fold=None) -> Tensor:
    """Fold one step's hot pushes (from :func:`split_hot_push`: cold slots
    ``-1`` with zero deltas) into the pending buffer, in place; returns it.

    The additive combines scatter-add through :func:`fps_tpu_torch.ops.
    scatter_add_` (K2, or K4 on a scalar buffer), the count riding as an
    appended column where the buffer has one. ``"max"`` / ``"min"`` take
    ``scatter_reduce_`` with the touched indicator as an appended ones
    column; a masked slot carries the sentinel, which changes no row.
    Purely local: the collectives run once a window, in
    :func:`reconcile_hot`."""
    vals = hot_deltas.to(delta_buf.dtype)
    live = (hot_ids_arr >= 0) & (hot_ids_arr < delta_buf.shape[0])
    if combine in ("max", "min"):
        filled = torch.cat([vals, torch.ones_like(vals[:, :1])], 1)
        filled = torch.where(live[:, None], filled, torch.full_like(
            filled, _extremum_fill(combine, delta_buf.dtype)))
        idx = torch.where(live, hot_ids_arr, 0).to(torch.int64)
        return delta_buf.scatter_reduce_(
            0, idx[:, None].expand(-1, delta_buf.shape[1]), filled,
            reduce="amax" if combine == "max" else "amin")
    if delta_counted(combine, fold):
        vals = torch.cat([vals, (hot_ids_arr >= 0).to(vals.dtype)[:, None]],
                         1)
    return ops.scatter_add_(delta_buf, hot_ids_arr.to(torch.int32),
                            vals.contiguous())


def hot_fold_state_shape(fold, H: int, dim: int,
                         num_shards: int) -> tuple[int, int]:
    """The global shape of a table's hot-fold state: ``ceil(H / S)`` rows a
    shard in reduce-scatter slice order (slice ``s`` holds head rows
    ``[s * Hs, (s + 1) * Hs)``), by
    :meth:`~fps_tpu_torch.core.api.HotFold.state_cols` columns."""
    Hs = rows_per_shard(H, num_shards)
    return (Hs * num_shards, fold.state_cols(dim))


def apply_hot_fold(fold, state: Tensor, g: Tensor,
                   counts: Tensor) -> tuple[Tensor, Tensor]:
    """``(step, new_state)``: a stateful fold on the owned slice.

    ``g`` is the window's combined delta of this position's slice of the
    head (after the ``combine`` normalization), ``counts`` its rows' push
    counts, ``state`` the position's slice of the fold state. Rows with no
    push this window keep their state and take a zero step."""
    dt = g.dtype
    t1 = (counts > 0)[:, None]
    zero = torch.zeros((), dtype=dt, device=g.device)
    if fold.kind == "adagrad":
        G = state + torch.where(t1, g * g, zero).to(state.dtype)
        step = torch.where(
            t1, fold.lr * g / (_sqrt(G).to(dt) + fold.eps), zero)
        return step, G
    dim = g.shape[1]
    m, v, t = state[:, :dim], state[:, dim:2 * dim], state[:, 2 * dim]
    t_new = t + (counts > 0).to(state.dtype)
    m_new = torch.where(t1, fold.beta1 * m + (1.0 - fold.beta1) * g, m)
    v_new = torch.where(t1, fold.beta2 * v + (1.0 - fold.beta2) * g * g, v)
    tc = torch.clamp(t_new, min=1.0)
    mhat = m_new / (1.0 - _pow(fold.beta1, tc))[:, None]
    vhat = v_new / (1.0 - _pow(fold.beta2, tc))[:, None]
    step = torch.where(t1, fold.lr * mhat.to(dt)
                       / (_sqrt(vhat).to(dt) + fold.eps), zero)
    return step, torch.cat([m_new, v_new, t_new[:, None]], 1)


def _pow(base: float, t: Tensor) -> Tensor:
    """``base ** t`` in ``t``'s dtype, ``base`` rounded to it first (as the
    JAX package's ``fold.beta1 ** tc`` takes it): taken in float64 and
    rounded once, as :func:`_sqrt` is."""
    b = torch.tensor(base, dtype=t.dtype).to(torch.float64)
    return torch.pow(b.to(t.device), t.to(torch.float64)).to(t.dtype)


def _sqrt(x: Tensor) -> Tensor:
    """``sqrt(x)`` correctly rounded on every device: taken in float64 and
    rounded once. On the CPU, ``torch.sqrt`` of float32 is not correctly
    rounded (measured: 1 ulp off on about 0.6 % of the elements) and its
    result has differed between two calls on the same input, which would
    break the replicas' bit-equality, since each data replica folds its
    own slice. (A float32 square root taken in float64 and rounded once is
    the correctly rounded one.)"""
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def _reconcile_combine(mesh: PSMesh, replicas, bufs, *, num_shards: int,
                       combine: str, fold=None, fold_states=None):
    """The window's combined step from every position's pending buffer
    (this process's positions' lists in, lists out).

    1. Each buffer is padded to ``ceil(H / S) * S`` rows and reduce-scattered
       over the shard axis: position ``(d, s)`` receives the summed slice of
       head rows ``[s * Hs, (s + 1) * Hs)``;
    2. the slices are summed over the data axis;
    3. ``"mean"`` normalizes by the count column;
    4. a :class:`~fps_tpu_torch.core.api.HotFold` turns the slice into its
       step against the position's slice of the fold state;
    5. the slices are all-gathered, so every position holds the same step.

    ``"max"`` / ``"min"`` take a full-head ``pmax`` / ``pmin`` over the shard
    axis, then the data axis, and carry no fold state.

    Returns ``(combined, fold_states)``: the ``(H, dim)`` step a position.
    """
    H, dim = replicas[0].shape
    D = mesh.shape[DATA_AXIS]
    if combine in ("max", "min"):
        red = collectives.pmax if combine == "max" else collectives.pmin
        g = red(mesh, bufs, SHARD_AXIS)
        if D > 1:
            g = red(mesh, g, DATA_AXIS)
        zero = torch.zeros((), dtype=replicas[0].dtype)
        # Touched rows carry indicator 1.0; untouched the sentinel.
        return [torch.where((x[:, dim].abs() <= 1.0)[:, None],
                            x[:, :dim].to(r.dtype), zero.to(r.device))
                for x, r in zip(g, replicas)], fold_states
    Hs = rows_per_shard(H, num_shards)
    pad = Hs * num_shards - H
    if pad:
        bufs = [torch.cat([b, b.new_zeros((pad, b.shape[1]))]) for b in bufs]
    sl = collectives.psum_scatter(mesh, bufs, SHARD_AXIS)
    if D > 1:
        sl = collectives.psum(mesh, sl, DATA_AXIS)
    steps, states = [], []
    for i, x in enumerate(sl):
        counts = x[:, dim] if x.shape[1] > dim else None
        g = x[:, :dim]
        if combine == "mean":
            g = g * (1.0 / torch.clamp(counts, min=1.0))[:, None]
        if fold is not None:
            g, st = apply_hot_fold(fold, fold_states[i], g, counts)
            states.append(st)
        steps.append(g.to(replicas[i].dtype))
    full = collectives.all_gather(mesh, steps, SHARD_AXIS)
    return ([f[:H] if pad else f for f in full],
            states if fold is not None else fold_states)


def reconcile_hot(cold_blocks, replicas, bufs, *, num_shards: int,
                  combine: str = "sum", fold=None, fold_states=None,
                  inplace: bool = False, mesh: PSMesh | None = None):
    """The window's reconcile of one tiered table: fold every position's
    pending buffer into the replicas and into the owners' head rows of the
    canonical table.

    ``cold_blocks``, ``replicas``, ``bufs`` and ``fold_states`` hold one
    tensor a position (this process's, in worker order; ``mesh`` as in
    :func:`pull`). The combined step (:func:`_reconcile_combine`: the
    reduce-scatter, the sum over the data axis, the normalization, the
    fold, the all-gather) is added to every replica, which stays the same
    bits on every position, and to the canonical shard: global id ``h``
    lives on shard ``h % S`` at local row ``h // S``, so shard ``s``'s head
    ids are its local rows ``[0, ceil(H / S))``, gathered from the step
    (K1, or K5 on a scalar table; a row past ``H`` gathers ``-1``, a zero
    row). ``inplace`` updates the blocks and replicas themselves.

    Returns ``(cold_blocks, replicas, fresh_bufs, fold_states)``.
    """
    mesh = _mesh_of(list(cold_blocks), num_shards, mesh)
    S = num_shards
    combined, fold_states = _reconcile_combine(
        mesh, replicas, bufs, num_shards=S, combine=combine, fold=fold,
        fold_states=fold_states)
    H = replicas[0].shape[0]
    hl = -(-H // S)  # local head rows on every shard
    new_cold, new_rep = [], []
    for p, blk, rep, comb in zip(mesh.local, cold_blocks, replicas,
                                 combined):
        gids = (torch.arange(hl, dtype=torch.int32, device=blk.device) * S
                + p % S)
        mine = ops.gather_rows(comb, torch.where(gids < H, gids, -1))
        if not inplace:
            blk, rep = blk.clone(), rep.clone()
        blk[:hl] += mine.to(blk.dtype)
        new_cold.append(blk)
        new_rep.append(rep.add_(comb))
    return (new_cold, new_rep, [_reset_delta(b, combine) for b in bufs],
            fold_states)


def _owned_rows(gids: Tensor, shard: int, num_shards: int) -> Tensor:
    """Shard ``shard``'s local row of each global id it owns (id ``g`` lives
    on shard ``g % S`` at local row ``g // S``), ``-1`` elsewhere."""
    owned = (gids >= 0) & ((gids % num_shards) == shard)
    return torch.where(owned, gids // num_shards, -1).to(torch.int32)


def replica_from_shard(mesh: PSMesh, blocks, hot_gids: Tensor, *,
                       num_shards: int) -> Blocks:
    """The ``(H, dim)`` replica of the global ids ``hot_gids`` (an int
    tensor of ids in ``[0, num_ids)``, on any device) on every position of
    this process, from the canonical ``blocks``, with no host read: each
    shard gathers the rows it owns (K1, or K5 on a scalar table; ``-1``
    elsewhere), the gathers are all-gathered over the shard axis, and each
    slot's row is selected from its owner's. A copy, so the canonical rows'
    bits, ``-0.0`` included (the JAX package's sums the gathers with zero
    rows). :meth:`ParamStore.rows_replica` validates host ids and calls
    it; the megastep's tier tick calls it on the ids it ranked on the
    device. Over several processes a collective."""
    S, H = num_shards, hot_gids.shape[0]
    blocks = list(blocks)
    owned = [ops.gather_rows(b, _owned_rows(hot_gids.to(b.device), p % S, S))
             for p, b in zip(mesh.local, blocks)]
    every = collectives.all_gather(mesh, owned, SHARD_AXIS)
    # Slot j's row is shard (ids[j] % S)'s gather row j.
    g = hot_gids.to(torch.int64)
    rows = (g % S) * H + torch.arange(H, dtype=torch.int64, device=g.device)
    return Blocks([e.index_select(0, rows.to(e.device)) for e in every],
                  replicas=len(mesh.slot), mesh=mesh)


def reconcile_hot_mapped(cold_blocks, replicas, bufs, hot_gids, *,
                         num_shards: int, combine: str = "sum", fold=None,
                         fold_states=None, inplace: bool = False,
                         mesh: PSMesh | None = None):
    """:func:`reconcile_hot` for an arbitrary hot id set: replica slot ``j``
    holds global id ``hot_gids[j]`` (``hot_gids``: one ``(H,)`` int32 copy a
    position). The combined step (:func:`_reconcile_combine`, shared with
    the static tier) is added to every replica, and scattered into shard
    ``s``'s owned rows ``hot_gids // S`` where ``hot_gids % S == s`` (``-1``
    elsewhere, dropped): K2 on a table wider than one column, K4 on a
    scalar table (:func:`fps_tpu_torch.ops.scatter_add_`). The ids are
    distinct, so each owned row takes one add, as the static tier's do.

    Returns ``(cold_blocks, replicas, fresh_bufs, fold_states)``.
    """
    mesh = _mesh_of(list(cold_blocks), num_shards, mesh)
    S = num_shards
    combined, fold_states = _reconcile_combine(
        mesh, replicas, bufs, num_shards=S, combine=combine, fold=fold,
        fold_states=fold_states)
    new_cold, new_rep = [], []
    for p, blk, rep, comb, g in zip(mesh.local, cold_blocks, replicas,
                                    combined, hot_gids):
        if not inplace:
            blk, rep = blk.clone(), rep.clone()
        ops.scatter_add_(blk, _owned_rows(g, p % S, S),
                         comb.to(blk.dtype).contiguous())
        new_cold.append(blk)
        new_rep.append(rep.add_(comb))
    return (new_cold, new_rep, [_reset_delta(b, combine) for b in bufs],
            fold_states)


# ---------------------------------------------------------------------------
# Pull / push.
# ---------------------------------------------------------------------------

def pull(blocks, ids, *, num_shards: int, dense: bool = False,
         hot_rows: int = 0, head_prefix: int = 0, exact: bool = False,
         mesh: PSMesh | None = None):
    """Rows of the table for each worker's ``ids`` (``(B,)`` int32):
    ``(B, dim)`` a worker, zero rows for padding (``-1``) and other
    out-of-range ids. Replaces the reference's pull / ``onPullRecv`` /
    ``answerPull`` round trip.

    ``blocks`` are the table's ``(rps, dim)`` blocks and ``ids`` the
    workers' ids, one a mesh position in worker order (position
    ``w = d * S + s`` holds shard ``s``); a lone tensor for each is a
    one-position mesh, and then the result is a tensor too, else a list a
    worker.

    The gathered route (the default): every shard sees the ids of its data
    replica's workers (``all_gather``), gathers the rows it owns through
    :func:`fps_tpu_torch.ops.gather_rows` (``hot_rows`` / ``head_prefix``:
    its head-prefix route, which only a one-shard mesh keeps), and the
    ``psum_scatter`` hands each worker its rows. ``dense``: the
    replicate-on-read route, each worker gathering by physical row from the
    all-gathered table.

    ``mesh``: the mesh of the blocks, which must be given when it spans
    several processes (then ``blocks`` and ``ids`` are this process's
    positions' and so is the result); by default the blocks are every
    position's, on one process.
    """
    one, blocks = _positions(blocks)
    ids = _positions(ids)[1]
    mesh = _mesh_of(blocks, num_shards, mesh)
    S = num_shards
    if dense:
        full = collectives.all_gather(mesh, blocks, SHARD_AXIS)
        rps = blocks[0].shape[0]
        return _result(one, [ops.gather_rows(f, _dense_rows(i, S, rps),
                                             exact=exact)
                             for f, i in zip(full, ids)])
    vals = []
    for p, blk, a in zip(mesh.local, blocks, collectives.all_gather(
            mesh, ids, SHARD_AXIS)):
        if S == 1:
            # One shard owns every id at its own row: the gathered stream
            # is its data replica's, the worker's own on a one-position
            # mesh, where the head-prefix guarantee holds.
            vals.append(ops.gather_rows(
                blk, a, hot_rows=hot_rows,
                head_prefix=head_prefix if len(mesh.slot) == 1 else 0,
                exact=exact))
            continue
        owned = (a % S) == p % S
        v = ops.gather_rows(blk, torch.where(owned, a // S, 0),
                            hot_rows=hot_rows, exact=exact)
        vals.append(torch.where(owned[:, None], v, torch.zeros_like(v)))
    # Exactly one shard contributed each row.
    return _result(one, collectives.psum_scatter(mesh, vals, SHARD_AXIS))


def pull_local(local_shard: Tensor, ids: Tensor, *, num_shards: int) -> Tensor:
    """Rows the calling worker owns (``ids % num_shards`` is its index), as
    for MF's worker-local user factors; no communication at any count."""
    return ops.gather_rows(local_shard, ids // num_shards)


def push(blocks, ids, deltas, *, num_shards: int,
         apply_fn: Callable[[Tensor, Tensor], Tensor] | None = None,
         combine: str | Callable[[Tensor, Tensor], Tensor] = "sum",
         hot_rows: int = 0, head_prefix: int = 0, dense: bool = False,
         inplace: bool = False, mesh: PSMesh | None = None):
    """Fold every worker's ``deltas`` for its ``ids`` into the table.

    Args:
      blocks: the table's ``(rps, dim)`` blocks, one a mesh position in
        worker order (see :func:`pull`); a lone tensor is a one-position
        mesh.
      ids: each worker's ``(B,)`` int32 ids. Negative ids are dropped
        entirely (``-1`` marks padding), also for non-additive folds.
      deltas: each worker's ``(B, dim)``.
      apply_fn: ``(current_rows, combined) -> new_rows``, applied only to
        rows with at least one push; ``None`` is addition (the reference's
        ``paramUpdate = _ + _``).
      combine: how duplicate ids of this push merge: ``"sum"`` (every
        message folds in), ``"mean"`` (one averaged step per touched row),
        ``"max"`` / ``"min"`` (elementwise extremum), or a callable
        ``(summed, counts) -> combined`` over each row's delta sum
        ``(rps, dim)`` and push count ``(rps,)``; untouched rows are masked
        out after it.
      hot_rows: local leading rows of the table declared write-hot
        (``TableSpec.hot_ids``). With ``head_prefix`` on the additive fold of
        a scalar table, the head-prefix route of
        :func:`fps_tpu_torch.ops.scatter_add_`; otherwise, on a table wider
        than one column, the hot/cold split (kernel K3 for the head, K2 for
        the tail), for the additive fold and for the sum-and-count scatter
        of the mean, callable and ``apply_fn`` folds alike.
      head_prefix: count of leading ids guaranteed in ``[0, hot_rows) ∪
        {-1}``; only a one-position mesh keeps it (the gathered stream is
        then the worker's own).
      dense: the dense route of the additive fold (other folds keep the
        gathered route): each worker scatter-adds its own pushes into a
        zeros buffer of the whole physical table, an ``all_to_all`` hands
        each shard its window from every peer, and the windows are summed
        in shard order, then over the data replicas in replica order.
      inplace: update the blocks themselves (what ``TrainerConfig.donate``
        asks for) instead of returning new tensors.
      mesh: the mesh of the blocks, as in :func:`pull`.

    The gathered route gathers the pushes over the data axis, then over the
    shard axis, as the JAX package does, so the stream every shard folds
    runs shard-major: position ``s * (D * B) + d * B + b`` holds worker
    ``(d, s)``'s push ``b``. The scatter-add combines duplicates in stream
    order, so this order is what keeps the float32 sums the JAX package's.
    Every data replica of a shard folds the same stream, so the replicas
    stay bit-equal.

    Returns:
      The updated blocks (a tensor for a lone tensor, else a list).
    """
    if not callable(combine) and combine not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown combine mode {combine!r}")
    one, blocks = _positions(blocks)
    ids, deltas = _positions(ids)[1], _positions(deltas)[1]
    mesh = _mesh_of(blocks, num_shards, mesh)
    S = num_shards
    if dense and apply_fn is None and combine == "sum":
        return _result(one, _dense_push(mesh, blocks, ids, deltas, S,
                                        inplace))
    gids = collectives.all_gather(
        mesh, collectives.all_gather(mesh, ids, DATA_AXIS), SHARD_AXIS)
    gdeltas = collectives.all_gather(
        mesh, collectives.all_gather(mesh, deltas, DATA_AXIS), SHARD_AXIS)
    hp = head_prefix if len(mesh.slot) == 1 else 0
    return _result(one, [
        _fold(blk, a, dl, shard=p % S, num_shards=S, apply_fn=apply_fn,
              combine=combine, hot_rows=hot_rows, head_prefix=hp,
              inplace=inplace)
        for p, blk, a, dl in zip(mesh.local, blocks, gids, gdeltas)])


def _dense_rows(ids: Tensor, S: int, rps: int) -> Tensor:
    """Physical rows of ``ids`` in the whole table, ``-1`` (a zero row, a
    dropped push) for an id outside ``[0, S * rps)``, as on the gathered
    route. (The JAX package's dense route drops only negative ids:
    id_to_phys's floor-mod would wrap them onto a live row. An id past the
    table lands there on another shard's row.)"""
    ok = (ids >= 0) & (ids < S * rps)
    return torch.where(ok, id_to_phys(ids, S, rps), -1).to(torch.int32)


def _dense_push(mesh: PSMesh, blocks, ids, deltas, S: int, inplace: bool):
    """The dense route of :func:`push`: never a reduction whose order a
    library picks, so every replica of a shard sums the same way."""
    rps, dim = blocks[0].shape
    bufs = []
    for blk, i, dl in zip(blocks, ids, deltas):
        bufs.append(ops.scatter_add_(
            torch.zeros((rps * S, dim), dtype=blk.dtype, device=blk.device),
            _dense_rows(i, S, rps), dl.to(blk.dtype).contiguous()
        ).reshape(S, rps, dim))
    mine = []
    for parts in collectives.all_to_all(mesh, bufs, SHARD_AXIS):
        acc = parts[0]
        for j in range(1, S):  # the shard peers, in index order
            acc = acc + parts[j]
        mine.append(acc)
    mine = collectives.psum(mesh, mine, DATA_AXIS)
    return [blk.add_(m) if inplace else blk + m
            for blk, m in zip(blocks, mine)]


def _fold(local_shard: Tensor, ids: Tensor, deltas: Tensor, *, shard: int,
          num_shards: int, apply_fn, combine, hot_rows: int,
          head_prefix: int, inplace: bool) -> Tensor:
    """Shard ``shard``'s fold of the gathered pushes into its block."""
    rps = local_shard.shape[0]
    owned = ids >= 0
    if num_shards > 1:
        owned = owned & ((ids % num_shards) == shard)
    # Dropped rows get an out-of-range index, which the scatter drops.
    local_idx = torch.where(owned, ids // num_shards, rps).to(torch.int32)

    if apply_fn is None and combine == "sum":
        fold = ops.scatter_add_ if inplace else ops.scatter_add
        return fold(local_shard, local_idx, deltas.contiguous(),
                    hot_rows=hot_rows, head_prefix=head_prefix)

    dim = deltas.shape[1]
    # Accumulate in at least f32, never below the table's own precision.
    acc_dt = torch.promote_types(local_shard.dtype, torch.float32)
    if combine in ("max", "min"):
        # One scatter-max/min of the raw deltas, with the touched indicator
        # riding as an appended column (1.0 against the fill sentinel). Row
        # rps takes the dropped pushes and is cut off afterwards.
        lim = torch.finfo(acc_dt).max
        fill = -lim if combine == "max" else lim
        filled = torch.cat([deltas.to(acc_dt),
                            torch.ones_like(deltas[:, :1], dtype=acc_dt)], 1)
        filled = torch.where(owned[:, None], filled,
                             torch.full_like(filled, fill))
        target = torch.full((rps + 1, dim + 1), fill, dtype=acc_dt,
                            device=local_shard.device)
        # Ids past the block land on row rps too.
        idx = torch.clamp(local_idx.to(torch.int64), max=rps)[:, None].expand(
            -1, dim + 1)
        ext = target.scatter_reduce_(
            0, idx, filled, reduce="amax" if combine == "max" else "amin")
        ext = ext[:rps]
        counts = (ext[:, dim].abs() <= 1.0).to(acc_dt)
        combined = torch.where((counts > 0)[:, None], ext[:, :dim],
                               torch.zeros_like(ext[:, :dim]))
    else:
        # Sums and counts ride ONE scatter, counts as an appended column.
        withcnt = torch.cat([
            torch.where(owned[:, None], deltas.to(acc_dt),
                        torch.zeros((), dtype=acc_dt, device=deltas.device)),
            owned.to(acc_dt)[:, None]], 1)
        acc = ops.scatter_add_(
            torch.zeros((rps, dim + 1), dtype=acc_dt,
                        device=local_shard.device),
            local_idx, withcnt, hot_rows=hot_rows)
        combined, counts = acc[:, :dim], acc[:, dim]
        if combine == "mean":
            combined = combined * (1.0 / torch.clamp(counts, min=1.0))[:, None]
        elif callable(combine):
            combined = torch.where((counts > 0)[:, None],
                                   combine(combined, counts),
                                   torch.zeros_like(combined))
    combined = combined.to(local_shard.dtype)
    if apply_fn is None:
        # Additive fold: untouched rows receive exactly zero.
        return local_shard.add_(combined) if inplace else local_shard + combined
    new_rows = torch.where((counts > 0)[:, None],
                           apply_fn(local_shard, combined), local_shard)
    return local_shard.copy_(new_rows) if inplace else new_rows


# ---------------------------------------------------------------------------
# Table spec + store container.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TableSpec:
    """One parameter table (one ``id -> vector`` map).

    ``init_fn(seed, ids) -> (len(ids), dim)`` must depend on ``ids`` and the
    seed only, so that a row's initial value does not depend on which shard
    holds it (the reference's id-seeded initializers).

    ``hot_ids`` is an int ``H >= 0``: global ids ``[0, H)`` are the
    frequency-ranked head of the table. The driver gives it to the store's
    pull and push as ``hot_rows``: the head-prefix route of scalar tables,
    and the hot/cold push split of wider ones (kernel K3 for the head).
    ``hot_ids="auto"`` sends a shard's whole push through K3 when the shard
    has at most :func:`fps_tpu_torch.ops.packed_crossover_rows` rows (the
    H100 sweep against K2 with its radix sort: 16,384 rows at up to 10
    columns, 8,192 at up to 32, 1,024 at up to 100, 512 at up to 200, none
    wider), and through K2 otherwise; ``Trainer`` resolves it, and raises ``ValueError``
    on any other string. ``dense_collectives`` is the route of the table's
    pulls and additive pushes on a mesh of more than one position: ``True``
    the dense route, ``"auto"`` and ``False`` the gathered one (the JAX
    package's ``"auto"`` goes dense below a table size measured on a TPU;
    on a one-position mesh both packages take the gathered route).

    ``hot_tier = H > 0`` replicates the leading ``H`` global ids on every
    position (the static hot tier, see the module's docstring; ids
    frequency-ranked, hottest first; ``H >= num_ids`` replicates the whole
    table and leaves it no pull or push exchange). It engages only where the
    ``Trainer`` resolves it on: a mesh of more than one position,
    ``TrainerConfig.hot_sync_every > 1`` and a ``"sum"``, ``"mean"``,
    ``"max"`` or ``"min"`` server fold without ``apply_fn``; otherwise the
    untiered program runs. ``cold_budget = C > 0``, with a partial head on
    the gathered route, packs each worker's cold ids of a step into a lane
    of ``C`` before the collectives, for the chunks the trainer's host
    certifier proves to fit (the others take the static route, the same
    bits). The trainer checks both values.
    """

    name: str
    num_ids: int
    dim: int
    init_fn: Callable[[int, Tensor], Tensor] | None = None
    dtype: Any = torch.float32
    hot_ids: int | str = 0
    dense_collectives: bool | str = "auto"
    hot_tier: int = 0
    cold_budget: int = 0

    def __post_init__(self):
        if not isinstance(self.hot_ids, (int, str)) or (
                isinstance(self.hot_ids, int) and self.hot_ids < 0):
            raise ValueError(f"TableSpec.hot_ids={self.hot_ids!r} for table "
                             f"{self.name!r}: expected an int >= 0 or "
                             "'auto'")
        if self.dense_collectives not in (True, False, "auto"):
            raise ValueError(
                f"TableSpec.dense_collectives={self.dense_collectives!r} for "
                f"table {self.name!r}: expected a bool or 'auto'")

    def zeros_init(self) -> "TableSpec":
        return dataclasses.replace(
            self, init_fn=lambda seed, ids: torch.zeros(
                (ids.shape[0], self.dim), dtype=self.dtype, device=ids.device))


def ranged_uniform_init(min_val: float, max_val: float, dim: int,
                        dtype=torch.float32):
    """Per-id seeded uniform init in ``[min_val, max_val)`` (the reference's
    ranged-random factor initializer): row ``i`` depends on the seed and
    ``i`` only (:func:`fps_tpu_torch.core.rng.uniform_by_id`)."""

    def init(seed: int, ids: Tensor) -> Tensor:
        return uniform_by_id(seed, ids, dim, min_val, max_val, dtype)

    return init


def make_table_values(seed: int, num_ids: int, dim: int, num_shards: int,
                      init_fn: Callable[[int, Tensor], Tensor] | None = None,
                      dtype=torch.float32, device=None,
                      shard: int | None = None) -> Tensor:
    """A full ``(rps * num_shards, dim)`` table in owner-major layout on
    ``device``, or only shard ``shard``'s ``(rps, dim)`` block of it.
    Padding rows get values as if they were ids too, so every real id's row
    is the same at any shard count."""
    rps = rows_per_shard(num_ids, num_shards)
    lo, hi = (0, rps * num_shards) if shard is None else (
        shard * rps, (shard + 1) * rps)
    phys = torch.arange(lo, hi, dtype=torch.int64, device=device)
    ids = phys_to_id(phys, num_shards, rps)
    fn = init_fn or ranged_uniform_init(-0.01, 0.01, dim, dtype)
    return fn(seed, ids).to(dtype)


def _stable_hash(s: str) -> int:
    h = 0
    for c in s.encode():
        h = (h * 131 + c) % (2**31 - 1)
    return h


class ParamStore:
    """Creates and tracks the parameter tables on the mesh.

    ``tables`` is the live ``{name: Blocks}`` dict, each table one
    ``(rps, dim)`` block a mesh position (:class:`~fps_tpu_torch.parallel.
    mesh.Blocks`, replicated over the data axis; over several processes
    this process's positions' blocks); the trainer keeps it pointed at the
    newest blocks after every chunk. :meth:`table` reads a whole table,
    :meth:`put` writes one. Over several processes :meth:`table`,
    :meth:`lookup_host` and :meth:`dump_model` are collectives: every
    process calls them, and each gets the whole result.
    """

    def __init__(self, mesh: PSMesh,
                 specs: Mapping[str, TableSpec] | list[TableSpec]):
        if not isinstance(specs, Mapping):
            specs = {s.name: s for s in specs}
        self.mesh = mesh
        self.specs = dict(specs)
        self.num_shards = mesh.shape[SHARD_AXIS]
        self.tables: dict[str, Blocks] = {}

    def init(self, seed: int) -> dict[str, Blocks]:
        """Make every table from ``seed`` (each table from its own
        sub-seed, keyed by its name): each of this process's positions makes
        its shard's block from the id-seeded initializer, on its own
        device. The tables are the canonical ones only: a hot tier's entries
        from an earlier run are dropped, so the trainer derives them from
        the fresh tables (the JAX package's ``init`` keeps them, and a run
        from its fresh state then starts from the old run's replica)."""
        S, mesh = self.num_shards, self.mesh
        self.tables = {}
        for name, spec in self.specs.items():
            sub = fold_seed(seed, _stable_hash(name))
            self.tables[name] = Blocks(
                [make_table_values(sub, spec.num_ids, spec.dim, S,
                                   spec.init_fn, spec.dtype, dev,
                                   shard=p % S)
                 for p, dev in zip(mesh.local, mesh.positions)],
                replicas=mesh.shape[DATA_AXIS], mesh=mesh)
        return self.tables

    def table(self, name: str) -> Tensor:
        """The whole ``(S * rps, dim)`` physical table on the mesh's home
        device: on one process and one shard the live block itself (no
        copy), else the shards of data replica 0 joined."""
        parts = self.tables[name].distinct
        if len(parts) == 1:
            return parts[0]
        return torch.cat(collectives.home(self.mesh, parts))

    def head_replica(self, name: str, hot_rows: int,
                     table: Blocks | None = None) -> Blocks:
        """The ``(hot_rows, dim)`` replica of ``name``'s leading ids on every
        position of this process (one copy a position), derived from the
        canonical table (``table``, default the live one): each shard's
        head rows ``[0, ceil(H / S))`` are all-gathered over the shard axis
        and put in id order. A copy, so it is the canonical head rows' bits;
        over several processes a collective."""
        spec = self.specs[name]
        if not 0 < hot_rows <= spec.num_ids:
            raise ValueError(f"table {name!r}: hot_rows={hot_rows} outside "
                             f"(0, {spec.num_ids}]")
        blocks = list(self.tables[name] if table is None else table)
        S = self.num_shards
        hl = rows_per_shard(hot_rows, S)
        heads = collectives.all_gather(self.mesh, [b[:hl] for b in blocks],
                                       SHARD_AXIS)
        # Shard s's head row j (global id j * S + s) sits at row s * hl + j.
        rows = id_to_phys(torch.arange(hot_rows, dtype=torch.int64), S, hl)
        return Blocks([h.index_select(0, rows.to(h.device)) for h in heads],
                      replicas=len(self.mesh.slot), mesh=self.mesh)

    def rows_replica(self, name: str, ids, table: Blocks | None = None
                     ) -> Blocks:
        """The ``(len(ids), dim)`` replica of arbitrary global ids of
        ``name`` on every position of this process (the mapped tier's
        :meth:`head_replica`), from the canonical table (``table``, default
        the live one). Each shard gathers the rows it owns of ``ids`` (K1,
        or K5 on a scalar table; ``-1`` elsewhere), the gathers are
        all-gathered over the shard axis, and each slot's row is selected
        from its owner's: a copy, so the canonical rows' bits, ``-0.0``
        included. Over several processes a collective."""
        spec = self.specs[name]
        ids = np.asarray(ids, np.int64)
        if ids.size == 0 or ids.min() < 0 or ids.max() >= spec.num_ids:
            raise ValueError(
                f"table {name!r}: replica ids must be a non-empty subset "
                f"of [0, {spec.num_ids})")
        return replica_from_shard(
            self.mesh, self.tables[name] if table is None else table,
            torch.from_numpy(ids.astype(np.int32)),
            num_shards=self.num_shards)

    def put(self, name: str, full: Tensor) -> Blocks:
        """Set table ``name`` from its whole ``(S * rps, dim)`` physical
        table: shard ``s``'s rows go to every position ``(d, s)``."""
        self.tables[name] = Blocks(
            collectives.replicate(
                self.mesh, torch.chunk(full, self.num_shards)),
            replicas=self.mesh.shape[DATA_AXIS], mesh=self.mesh)
        return self.tables[name]

    def lookup_host(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Host (numpy) read of the current values of ``ids``."""
        spec = self.specs[name]
        rps = rows_per_shard(spec.num_ids, self.num_shards)
        table = self.tables[name].numpy()
        return table[np.asarray(id_to_phys(np.asarray(ids), self.num_shards,
                                           rps))]

    def dump_model(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """``(ids, values)`` for the whole table, padding rows excluded."""
        ids = np.arange(self.specs[name].num_ids)
        return ids, self.lookup_host(name, ids)
