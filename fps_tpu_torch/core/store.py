"""The parameter store: tables, pull and push.

Port of the untiered part of ``fps_tpu/core/store.py``. A table is one
``(rows, dim)`` tensor in the JAX package's **owner-major cyclic** layout:
id ``i`` lives at physical row ``(i % S) * rps + i // S`` for ``S`` shards of
``rps`` rows each. The layout helpers keep their ``num_shards`` argument so
that the multi-device slices reuse them; :func:`pull` and :func:`push` run on
a one-device mesh (``S == 1``) and raise on more.

On one device the JAX package's collectives are identities: :func:`pull` is
a row gather and :func:`push` a scatter-add (or a combine-then-fold) into
the local block, through :mod:`fps_tpu_torch.ops`, so on the card both run
on the port's hand-written kernels.

``TableSpec.hot_ids`` takes an int (the frequency-ranked head: the scalar
tables' head-prefix route, and the hot/cold push split of wider tables
through kernel K3) or ``"auto"`` (the whole table through K3 when it has
no more rows than :func:`fps_tpu_torch.ops.packed_crossover_rows` allows
at its width, and through K2 otherwise). Not ported,
and rejected when set: ``hot_tier``, ``cold_budget`` and
``dense_collectives=True`` (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.rng import fold_seed, uniform_by_id
from fps_tpu_torch.parallel.mesh import MULTI_DEVICE_ITEM, SHARD_AXIS, PSMesh

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


def _one_shard(fn: str, num_shards: int) -> None:
    if num_shards != 1:
        raise NotImplementedError(
            f"{fn} over {num_shards} shards needs collectives: "
            f"{MULTI_DEVICE_ITEM}")


# ---------------------------------------------------------------------------
# Pull / push.
# ---------------------------------------------------------------------------

def pull(local_shard: Tensor, ids: Tensor, *, num_shards: int,
         hot_rows: int = 0, head_prefix: int = 0,
         exact: bool = False) -> Tensor:
    """Rows of the table for ``ids`` (``(B,)`` int32): ``(B, dim)``, zero rows
    for padding (``-1``) and other out-of-range ids. Replaces the
    reference's pull / ``onPullRecv`` / ``answerPull`` round trip.
    ``hot_rows`` / ``head_prefix``: the head-prefix route of
    :func:`fps_tpu_torch.ops.gather_rows`."""
    _one_shard("pull", num_shards)
    return ops.gather_rows(local_shard, ids, hot_rows=hot_rows,
                           head_prefix=head_prefix, exact=exact)


def pull_local(local_shard: Tensor, ids: Tensor, *, num_shards: int) -> Tensor:
    """Rows the calling worker owns (``ids % num_shards`` is its index), as
    for MF's worker-local user factors; no communication at any count."""
    return ops.gather_rows(local_shard, ids // num_shards)


def push(local_shard: Tensor, ids: Tensor, deltas: Tensor, *,
         num_shards: int,
         apply_fn: Callable[[Tensor, Tensor], Tensor] | None = None,
         combine: str | Callable[[Tensor, Tensor], Tensor] = "sum",
         hot_rows: int = 0, head_prefix: int = 0,
         inplace: bool = False) -> Tensor:
    """Fold ``deltas`` for ``ids`` into the table.

    Args:
      local_shard: the ``(rps, dim)`` table block.
      ids: ``(B,)`` int32 ids. Negative ids are dropped entirely (``-1``
        marks padding), also for non-additive folds.
      deltas: ``(B, dim)``.
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
        {-1}``.
      inplace: update ``local_shard`` itself (what ``TrainerConfig.donate``
        asks for) instead of returning a new tensor.

    Returns:
      The updated ``(rps, dim)`` block.
    """
    _one_shard("push", num_shards)
    if not callable(combine) and combine not in ("sum", "mean", "max", "min"):
        raise ValueError(f"unknown combine mode {combine!r}")
    rps = local_shard.shape[0]
    owned = ids >= 0
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
        idx = local_idx.to(torch.int64)[:, None].expand(-1, dim + 1)
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
    H100 sweep against K2 with its radix sort: 8,192 rows at up to 10
    columns, 2,048 at up to 32, none wider), and through K2 otherwise; ``Trainer`` resolves it, and raises ``ValueError``
    on any other string. ``hot_tier``, ``cold_budget`` and
    ``dense_collectives=True`` select routes this port does not have yet;
    setting them raises. ``dense_collectives`` ``"auto"`` and ``False`` both
    mean the gathered route, which is what the JAX package takes on a
    one-device mesh.
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
        unported = {"hot_tier": self.hot_tier != 0,
                    "cold_budget": self.cold_budget != 0,
                    "dense_collectives": self.dense_collectives is True}
        for field, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"TableSpec.{field}={getattr(self, field)!r} for table "
                    f"{self.name!r}: this route is not ported yet "
                    "(ROADMAP.md Queue 1)")

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
                      dtype=torch.float32, device=None) -> Tensor:
    """A full ``(rps * num_shards, dim)`` table in owner-major layout on
    ``device``. Padding rows get values as if they were ids too, so every
    real id's row is the same at any shard count."""
    rps = rows_per_shard(num_ids, num_shards)
    phys = torch.arange(rps * num_shards, dtype=torch.int64, device=device)
    ids = phys_to_id(phys, num_shards, rps)
    fn = init_fn or ranged_uniform_init(-0.01, 0.01, dim, dtype)
    return fn(seed, ids).to(dtype)


def _stable_hash(s: str) -> int:
    h = 0
    for c in s.encode():
        h = (h * 131 + c) % (2**31 - 1)
    return h


class ParamStore:
    """Creates and tracks the parameter tables on the mesh's device.

    ``tables`` is the live ``{name: tensor}`` dict; the trainer keeps it
    pointed at the newest tensors after every chunk.
    """

    def __init__(self, mesh: PSMesh,
                 specs: Mapping[str, TableSpec] | list[TableSpec]):
        if not isinstance(specs, Mapping):
            specs = {s.name: s for s in specs}
        self.mesh = mesh
        self.specs = dict(specs)
        self.num_shards = mesh.shape[SHARD_AXIS]
        self.tables: dict[str, Tensor] = {}

    def init(self, seed: int) -> dict[str, Tensor]:
        """Make every table from ``seed`` (each table from its own
        sub-seed, keyed by its name)."""
        for name, spec in self.specs.items():
            self.tables[name] = make_table_values(
                fold_seed(seed, _stable_hash(name)), spec.num_ids, spec.dim,
                self.num_shards, spec.init_fn, spec.dtype, self.mesh.device)
        return self.tables

    def lookup_host(self, name: str, ids: np.ndarray) -> np.ndarray:
        """Host (numpy) read of the current values of ``ids``."""
        spec = self.specs[name]
        rps = rows_per_shard(spec.num_ids, self.num_shards)
        table = self.tables[name].detach().cpu().numpy()
        return table[np.asarray(id_to_phys(np.asarray(ids), self.num_shards,
                                           rps))]

    def dump_model(self, name: str) -> tuple[np.ndarray, np.ndarray]:
        """``(ids, values)`` for the whole table, padding rows excluded."""
        ids = np.arange(self.specs[name].num_ids)
        return ids, self.lookup_host(name, ids)
