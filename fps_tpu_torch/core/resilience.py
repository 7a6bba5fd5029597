"""Resilience: the step guard, rollback and the snapshots' integrity types.

Port of ``fps_tpu/core/resilience.py``. Two failure classes a long run must
absorb:

* **poison updates**: one bad batch (a corrupt row, an overflowed feature)
  pushes NaN, Inf or exploded deltas, and under the additive fold one such
  push destroys every row it touches for good;
* **torn snapshots**: a crash or a disk fault mid-write (or bit rot) leaves
  the newest ``.npz`` unreadable (:mod:`fps_tpu_torch.core.checkpoint`
  verifies every entry and falls back).

This module holds the policy objects and the screens; the driver
(:mod:`fps_tpu_torch.core.driver`) runs the screens in the step and the
rollback in its host loops.

The screens are elementwise tensor code on the device of their inputs
(the card's own ops; no kernel of the port's), and their counts are int32
tensors on that device: nothing here reads a value on the host, so a
guarded step adds launches but no host sync. With ``TrainerConfig.guard``
``None`` the driver calls none of this, and a step launches what it
launches without a guard.

:func:`tree_flatten` is the one flatten of the port's pytrees (nested
dicts, tuples and lists): leaves in the order ``jax.tree.flatten`` gives
them (dict keys sorted, sequences in order), so a snapshot's ``ls::i``
leaves are the same in both packages.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Mapping

import numpy as np
import torch

from fps_tpu_torch.core.snapshot_format import array_crc32  # noqa: F401

Tensor = torch.Tensor
Pytree = Any

HEALTH_KEY = "health"

# Health-channel entry of the worker-local plane (GuardConfig.local); the
# trainer refuses a table of this name when the local guard is on.
LOCAL_STATE_KEY = "local_state"

# Out-channel entry of the hot tier's counters. A rollback under the tier
# copies the whole tables dict, replicas included, so a quarantine restores
# the replica and the canonical table as one unit (every call ends in a
# reconcile, so the pending buffers are empty at the boundary).
HOT_TIER_KEY = "hot_tier"

GUARD_MODES = ("observe", "mask")


class SnapshotCorruptionError(RuntimeError):
    """A snapshot failed its integrity check (truncated, bit-flipped or
    otherwise unreadable). Raised by the checkpoint layer when the caller
    pinned an explicit step; a restore of the newest falls back to the
    previous surviving snapshot instead."""


class PoisonedStreamError(RuntimeError):
    """The rollback policy exhausted its quarantine budget: the input
    stream keeps producing poisoned chunks."""


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """The push-delta guard (``TrainerConfig.guard``).

    In every step, each table's push deltas are screened a row at a time
    before they reach the server fold:

    * rows with a non-finite element count as ``nonfinite``;
    * rows whose L2 norm exceeds ``norm_limit`` (when set) count as
      ``norm``;
    * in ``mode="mask"`` offending rows are dropped (id ``-1``, delta 0),
      so a poison batch becomes a lost update; ``mode="observe"`` only
      counts (pair it with a :class:`RollbackPolicy` to quarantine).

    The counts ride the worker's out channel as a ``"health"`` entry,
    summed over the workers as every metric is.

    ``tables``: guard only these (``None``: all). ``local``: screen the
    worker-local state's update too (:func:`guard_local_state`), counted
    under ``"local_state"``.

    Frozen and hashable, as the reference's (part of its compile key).
    """

    mode: str = "mask"
    norm_limit: float | None = None
    tables: tuple[str, ...] | None = None
    local: bool = False

    def __post_init__(self):
        if self.mode not in GUARD_MODES:
            raise ValueError(
                f"guard mode {self.mode!r} — expected one of {GUARD_MODES}")
        if self.norm_limit is not None and not self.norm_limit > 0:
            raise ValueError(f"norm_limit must be > 0, got {self.norm_limit}")
        if self.tables is not None:
            object.__setattr__(self, "tables", tuple(self.tables))


def as_guard(guard) -> GuardConfig | None:
    """Coerce ``TrainerConfig.guard`` (``None``, a mode string or a
    :class:`GuardConfig`)."""
    if guard is None or isinstance(guard, GuardConfig):
        return guard
    if isinstance(guard, str):
        return GuardConfig(mode=guard)
    raise TypeError(
        f"guard must be None, 'observe'/'mask', or a GuardConfig; "
        f"got {type(guard).__name__}")


def _zero(device) -> Tensor:
    return torch.zeros((), dtype=torch.int32, device=device)


def _count(mask: Tensor) -> Tensor:
    return torch.sum(mask, dtype=torch.int32)


def guard_pushes(pushes: Mapping[str, tuple[Tensor, Tensor]],
                 guard: GuardConfig
                 ) -> tuple[dict[str, tuple[Tensor, Tensor]],
                            dict[str, dict[str, Tensor]]]:
    """Screen one worker's ``{table: (ids, deltas)}`` pushes.

    Returns ``(guarded_pushes, health)``, ``health[table]`` the int32
    counts ``{"nonfinite", "norm", "masked"}`` of this worker's batch.
    Padding rows (id ``-1``) never count.

    In mask mode a bad row's id becomes ``-1`` and its delta 0, and a
    non-finite delta is zeroed on a padding row too: the count column of
    the mean combine, the head scatter-add of the hot/cold split and the
    ``cold_budget`` lanes carry a padding row's delta past the id test, and
    ``0 * NaN`` would poison them.
    """
    out_pushes: dict[str, tuple[Tensor, Tensor]] = {}
    health: dict[str, dict[str, Tensor]] = {}
    for name, (ids, deltas) in pushes.items():
        if guard.tables is not None and name not in guard.tables:
            out_pushes[name] = (ids, deltas)
            continue
        live = ids >= 0
        finite = torch.isfinite(deltas).all(dim=-1)
        nonfinite = live & ~finite
        if guard.norm_limit is not None:
            # Over zero-substituted rows, so a NaN row never counts twice.
            clean = torch.where(finite[:, None], deltas, 0.0)
            sq = torch.sum(clean.to(torch.float32) ** 2, dim=-1)
            exploded = live & finite & (sq > guard.norm_limit ** 2)
        else:
            exploded = torch.zeros_like(nonfinite)
        bad = nonfinite | exploded
        counts = {"nonfinite": _count(nonfinite), "norm": _count(exploded)}
        if guard.mode == "mask":
            ids = torch.where(bad, -1, ids)
            scrub = bad | ~finite
            deltas = torch.where(scrub[:, None], 0.0, deltas)
            counts["masked"] = _count(bad)
        else:
            counts["masked"] = _zero(ids.device)
        out_pushes[name] = (ids, deltas)
        health[name] = counts
    return out_pushes, health


def guard_local_state(old: Pytree, new: Pytree, guard: GuardConfig,
                      touched=None) -> tuple[Pytree, dict | None]:
    """Screen one worker's local-state update.

    For every float leaf a row is one index on axis 0 (the whole leaf for
    a 0-d one): rows of ``new`` with a non-finite element count as
    ``nonfinite``, rows whose update ``new - old`` has an L2 norm over
    ``guard.norm_limit`` as ``norm``; in mask mode offending rows revert
    to ``old``'s values.

    ``touched`` (``WorkerLogic.touched_local_rows``): one entry a
    flattened leaf, an int id tensor (``-1`` ignored) that restricts that
    leaf's row screen to the rows the step can write, or ``None`` for the
    whole leaf. A non-finite row outside the touched rows still counts as
    ``nonfinite`` (it cannot be reverted: its old value is its new one).
    Duplicate touched ids count once an occurrence.

    Returns ``(guarded_new, counts)``, or ``(new, None)`` when the tree has
    no float leaf.
    """
    old_leaves, treedef = tree_flatten(old)
    new_leaves, new_treedef = tree_flatten(new)
    if treedef != new_treedef:
        raise ValueError(
            "guard.local requires the worker step to preserve the "
            f"local_state pytree structure (got {treedef} -> {new_treedef})")
    if touched is not None:
        touched = list(touched)
        if len(touched) != len(new_leaves):
            raise ValueError(
                "touched_local_rows must return one entry per flattened "
                f"local-state leaf ({len(new_leaves)}), got {len(touched)}")
    counts = None
    out_leaves = []
    for i, (o, n) in enumerate(zip(old_leaves, new_leaves)):
        if not (isinstance(n, Tensor) and n.is_floating_point()):
            out_leaves.append(n)
            continue
        if counts is None:
            counts = {k: _zero(n.device)
                      for k in ("nonfinite", "norm", "masked")}
        t = touched[i] if touched is not None else None
        if t is not None and n.dim() >= 1:
            n, leaf_counts = _guard_rows_touched(o, n, guard, t)
        else:
            n, leaf_counts = _guard_rows_full(o, n, guard)
        for k, v in leaf_counts.items():
            counts[k] = counts[k] + v
        out_leaves.append(n)
    if counts is None:
        return new, None
    return tree_unflatten(treedef, out_leaves), counts


def _row_all(x: Tensor) -> Tensor:
    """``x`` (bool) all-reduced over every axis but the first (a 0-d
    ``x`` as it is)."""
    if x.dim() <= 1:
        return x
    return x.reshape(x.shape[0], -1).all(dim=1)


def _row_sum(x: Tensor) -> Tensor:
    if x.dim() <= 1:
        return x
    return x.reshape(x.shape[0], -1).sum(dim=1)


def _rows(mask: Tensor, like: Tensor) -> Tensor:
    """A row mask broadcast over ``like``'s trailing axes."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - mask.dim()))


def _screen(o: Tensor, n: Tensor, guard: GuardConfig, valid=None):
    """The row screen of rows ``n`` against ``o``: ``(nonfinite,
    exploded)`` row masks (restricted to ``valid`` when given)."""
    finite = _row_all(torch.isfinite(n))
    nonfinite = ~finite if valid is None else valid & ~finite
    if guard.norm_limit is not None:
        delta = torch.where(_rows(finite, n), (n - o).to(torch.float32),
                            0.0)
        sq = _row_sum(delta * delta)
        exploded = finite & (sq > guard.norm_limit ** 2)
        if valid is not None:
            exploded = valid & exploded
    else:
        exploded = torch.zeros_like(nonfinite)
    return nonfinite, exploded


def _guard_rows_full(o: Tensor, n: Tensor, guard: GuardConfig):
    """The whole-leaf row screen (``touched`` ``None``)."""
    nonfinite, exploded = _screen(o, n, guard)
    bad = nonfinite | exploded
    counts = {"nonfinite": _count(nonfinite), "norm": _count(exploded),
              "masked": _zero(n.device)}
    if guard.mode == "mask":
        n = torch.where(_rows(bad, n), o, n).to(n.dtype)
        counts["masked"] = _count(bad)
    return n, counts


def _guard_rows_touched(o: Tensor, n: Tensor, guard: GuardConfig, t):
    """The screen of the touched rows, then the leaf-wide net for a
    non-finite row outside them. Ids outside ``[0, rows)`` are inert like
    ``-1``. A reverted row takes ``old``'s value, so the revert is a
    ``where`` over a per-row flag (summed in int32 by ``index_add_``;
    out-of-range ids land on a spare row), with no host sync."""
    rows = n.shape[0]
    t = torch.as_tensor(t, device=n.device).reshape(-1).to(torch.int64)
    valid = (t >= 0) & (t < rows)
    safe = torch.where(valid, t, 0)
    idx = torch.where(valid, t, rows)
    n_t = n.index_select(0, safe)
    o_t = o.index_select(0, safe)
    nonfinite_t, exploded_t = _screen(o_t, n_t, guard, valid)
    bad_t = nonfinite_t | exploded_t
    counts = {"nonfinite": _count(nonfinite_t), "norm": _count(exploded_t),
              "masked": _zero(n.device)}

    def row_flags(per_id: Tensor) -> Tensor:
        flags = torch.zeros(rows + 1, dtype=torch.int32, device=n.device)
        flags.index_add_(0, idx, per_id.to(torch.int32))
        return flags[:rows] > 0

    if guard.mode == "mask":
        n = torch.where(_rows(row_flags(bad_t), n), o, n).to(n.dtype)
        counts["masked"] = _count(bad_t)
    touched_rows = row_flags(torch.ones_like(valid))
    finite_rows = _row_all(torch.isfinite(n))
    counts["nonfinite"] = counts["nonfinite"] + _count(
        ~finite_rows & ~touched_rows)
    return n, counts


def health_total(metrics: Pytree) -> int:
    """Poison events in one chunk's or epoch's HOST metrics: the
    ``nonfinite`` and ``norm`` counts of every table over every step
    (``masked`` follows from them and is left out). 0 without a health
    channel."""
    h = metrics.get(HEALTH_KEY) if isinstance(metrics, Mapping) else None
    if not h:
        return 0
    total = 0
    for counters in h.values():
        for kind in ("nonfinite", "norm"):
            if kind in counters:
                total += int(np.sum(np.asarray(counters[kind])))
    return total


def health_by_segment(metrics: Pytree, segments: int,
                      steps_per_segment: int) -> list[int]:
    """Poison totals a segment of ``steps_per_segment`` steps of one HOST
    metrics tree (the chunk segments of one ``Trainer.run_megastep``
    dispatch), counted as :func:`health_total` counts; trailing segments a
    shorter tree does not reach report 0."""
    h = metrics.get(HEALTH_KEY) if isinstance(metrics, Mapping) else None
    totals = [0] * segments
    if not h:
        return totals
    for counters in h.values():
        for kind in ("nonfinite", "norm"):
            if kind not in counters:
                continue
            v = np.asarray(counters[kind])
            if not v.ndim:
                totals[0] += int(v)
                continue
            for i in range(segments):
                sl = v[i * steps_per_segment:(i + 1) * steps_per_segment]
                totals[i] += int(np.sum(sl))
    return totals


@dataclasses.dataclass
class RollbackPolicy:
    """The host loop's quarantine for ``fit_stream`` and ``run_indexed``.

    When a chunk's (or epoch's) health channel reports poison (a nonzero
    ``nonfinite`` or ``norm`` count), the driver restores the state copied
    just before that chunk, records its index in :attr:`quarantined` and
    goes on with the next: the draws key off the index, so later chunks
    are unaffected. It needs ``TrainerConfig.guard``; each guarded chunk
    pays one copy of the state on the device and one host read of its
    metrics.

    ``preset`` indices are skipped outright: consumed from the stream,
    never run (no copy, no metrics entry), which is how a quarantine
    outlives a restart. A preset-only policy needs no guard.

    Each skip, rollback and abort goes to the run journal through the
    process-default recorder (:func:`fps_tpu_torch.obs.events.emit`; a
    no-op when none is installed).
    """

    max_rollbacks: int = 8
    quarantined: list = dataclasses.field(default_factory=list)
    preset: frozenset = frozenset()
    skipped: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        self.preset = frozenset(int(i) for i in self.preset)

    def skip(self, index: int) -> None:
        """Record one preset index skipped without running (no budget)."""
        self.skipped.append(index)
        from fps_tpu_torch.obs import events as _obs_events

        _obs_events.emit("preset_skip", index=int(index),
                         total=len(self.skipped))

    def record(self, index: int) -> None:
        """Record a quarantined index; raises :class:`PoisonedStreamError`
        once the budget is exceeded (the index is appended first). The
        driver restores the last good state before calling this."""
        self.quarantined.append(index)
        from fps_tpu_torch.obs import events as _obs_events

        _obs_events.emit("rollback", index=int(index),
                         total=len(self.quarantined),
                         budget=self.max_rollbacks)
        if len(self.quarantined) > self.max_rollbacks:
            _obs_events.emit("poisoned_stream_abort",
                             quarantined=list(self.quarantined),
                             budget=self.max_rollbacks)
            raise PoisonedStreamError(
                f"rollback budget exhausted ({self.max_rollbacks}); "
                f"quarantined chunks: {self.quarantined}")


def tree_copy(tree: Pytree) -> Pytree:
    """Fresh memory for every tensor of a tree, on its device: the port's
    tables update in place, so a state kept for later (a rollback's last
    good state, a checkpoint's boundary copy) must be a clone, never the
    live tensors. :class:`~fps_tpu_torch.parallel.mesh.Blocks` keep their
    replica count and mesh."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(tree, Blocks):
        return Blocks([b.clone() for b in tree], replicas=tree.replicas,
                      mesh=tree.mesh)
    if isinstance(tree, Tensor):
        return tree.clone()
    if isinstance(tree, Mapping):
        return {k: tree_copy(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_copy(v) for v in tree)
    return tree


# ---------------------------------------------------------------------------
# The port's pytree flatten, in jax.tree.flatten's order.
# ---------------------------------------------------------------------------

def _is_node(x) -> bool:
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, Blocks):
        return False
    return x is None or isinstance(x, (Mapping, tuple, list))


def tree_flatten(tree: Pytree) -> tuple[list, Any]:
    """``(leaves, treedef)`` of nested dicts, tuples, lists and ``None``:
    dict keys sorted, sequences in order, ``None`` an empty node, as
    ``jax.tree.flatten`` orders them. Tensors, arrays and
    :class:`~fps_tpu_torch.parallel.mesh.Blocks` are leaves. ``treedef``
    is a hashable description that compares equal for equal structures."""
    leaves: list = []

    def walk(x):
        if not _is_node(x):
            leaves.append(x)
            return "*"
        if x is None:
            return None
        if isinstance(x, Mapping):
            keys = sorted(x)
            return ("dict", tuple(keys), tuple(walk(x[k]) for k in keys))
        return (type(x).__name__, type(x), tuple(walk(v) for v in x))

    return leaves, walk(tree)


def tree_unflatten(treedef, leaves) -> Pytree:
    """Inverse of :func:`tree_flatten`."""
    it = iter(leaves)

    def build(d):
        if d == "*":
            return next(it)
        if d is None:
            return None
        if d[0] == "dict":
            return {k: build(sub) for k, sub in zip(d[1], d[2])}
        return d[1](build(sub) for sub in d[2])

    out = build(treedef)
    rest = list(it)
    if rest:
        raise ValueError(f"tree_unflatten: {len(rest)} leaves left over")
    return out
