"""The training driver: sync and SSP step loops over chunks.

Port of the trainer core of ``fps_tpu/core/driver.py``: ``TrainerConfig``,
``Trainer.init_state``, the step (prepare → pull ids → pull → worker step →
pushes), the synchronous loop and the SSP rounds, ``run_chunk``,
``fit_stream`` and the index-fed ``run_indexed``. Where the JAX package
compiles a chunk (or a slice of an epoch) into one ``lax.scan`` under
``shard_map``, the port runs a Python loop over the steps; each pull and push
launches the port's kernels on the card (CUDA graphs over a chunk are later
work).

On a mesh of ``W`` positions one process drives every worker (a single
controller), or, over several processes, each process its own workers
(``mesh.local``): worker ``w`` takes columns ``[w * B, (w + 1) * B)`` of
each ``(steps, W * B)`` batch, draws from ``fold_seed(seed, w)`` (``w``
global, so a draw does not depend on the process count) and holds its
block of the local state; every worker pulls as the step begins, then one
collective push a table lands all the workers' deltas
(:mod:`fps_tpu_torch.core.store`), and the metrics are summed over the
shards, then over the data replicas (every process gets the same sums).
Tables and local-state leaves are
:class:`~fps_tpu_torch.parallel.mesh.Blocks`, one block a position (this
process's). A one-position mesh runs the same code with ``W = 1``. Over
several processes every process runs the same calls with the same
arguments (the same chunk iterator, the same plan).

* **sync**: every step pulls from the live tables and its pushes land before
  the next step.
* **SSP** (``sync_every=s``): chunks are shaped ``(R, s, B, ...)``; each
  round of ``s`` steps pulls from a snapshot of the tables taken when the
  round starts, while pushes go to the live tables. Worker-local state is
  always live.

* **run_indexed**: epochs over a plan whose data already lies on the device
  (:class:`~fps_tpu_torch.core.device_ingest.DeviceEpochPlan`, word2vec's
  ``Word2VecDevicePlan``); each call's batches are built there, so no chunk
  crosses from the host.

``TrainerConfig.step_tap`` runs a tap with table access after each step's
push; its outputs ride the metrics under ``"tap"``.

* **push_delay** (``d``): a step's pushes reach the tables ``d`` steps after
  they were computed (the reference's pushes in flight); what is still in
  flight when a call ends is delivered then, oldest first.
* **prefetch**: ``fit_stream`` assembles and places chunks up to
  ``prefetch`` chunks ahead on a worker thread
  (:mod:`fps_tpu_torch.core.prefetch`); the tables and metrics are the same
  bits either way.

* **the static hot tier** (``TableSpec.hot_tier``, ``TrainerConfig.
  hot_sync_every = E > 1``): a tiered table's hot reads come from its
  replica, its hot pushes go to a pending buffer a position, and the
  buffers are reconciled into the replica and the canonical table
  (:func:`~fps_tpu_torch.core.store.reconcile_hot`) after every ``E``
  steps counted from the call's first step and once more after the call's
  ragged tail (sync), or at the end of every round, before the next
  round's snapshot (SSP). Every call returns one canonical table, its
  replica equal to its head rows. Each chunk of ``run_chunk`` is certified
  for the ``cold_budget`` lanes at dispatch; ``run_indexed`` never packs.
* **the adaptive tier** (``Trainer.retierer``, a
  :class:`~fps_tpu_torch.tiering.Retierer`, or ``TrainerConfig.auto_tier``,
  which attaches one as a run begins): a tiered table with a partial head
  takes the mapped tier, membership by slot (``name::hotmap`` and
  ``name::hotids``, replicated data), and each tracked table's pulled ids
  go into a count-min window on every position each step (K4), summed
  over the mesh at the end of the call into ``name::sketch``. After every
  chunk of ``fit_stream`` and every epoch of ``run_indexed`` the
  retierer folds the windows and may re-rank the hot set or plan the
  knobs; every call's replica equals the canonical rows of the current hot
  ids.

* **durability** (:mod:`fps_tpu_torch.core.checkpoint`,
  :mod:`fps_tpu_torch.core.resilience`): ``TrainerConfig.guard`` screens
  every push (and, with ``GuardConfig.local``, the local state's update)
  in the step and counts the bad rows under ``"health"``;
  ``fit_stream`` and ``run_indexed`` save to a checkpointer every
  ``checkpoint_every`` chunks or epochs and at the end, and quarantine a
  poisoned chunk or epoch under a
  :class:`~fps_tpu_torch.core.resilience.RollbackPolicy`;
  :meth:`Trainer.restore_checkpoint` restores onto any mesh.

* **run_megastep**: K chunk segments of a device plan in one Python
  dispatch (:mod:`fps_tpu_torch.core.megastep`): the per-chunk
  ``run_indexed`` loop bit for bit, the ``cold_budget`` lanes certified by
  a vote on the device, the adaptive tier's boundary a
  :class:`~fps_tpu_torch.tiering.MegastepTick` on the device, and
  ``chunks_per_dispatch="auto"`` (:mod:`fps_tpu_torch.core.autok`).

* **telemetry** (:mod:`fps_tpu_torch.obs`): ``Trainer(recorder=...)`` (or
  each call's ``recorder``) times every chunk's and epoch's host phases
  (:class:`~fps_tpu_torch.obs.PhaseTimer`), counts the ``driver.*``,
  ``health.*``, ``rollback.*``, ``hot_tier.*`` and ``cold_route.*`` leaves
  and journals ``chunk`` / ``epoch`` events; ``health`` (a
  :class:`~fps_tpu_torch.obs.HealthMonitor`) escalates the guard from
  observe to mask or aborts, and ``watchdog`` (a
  :class:`~fps_tpu_torch.obs.StepWatchdog`) flags stalled chunks. A
  recorder changes no table, launch or host synchronisation: its phases
  time the syncs the loop already makes. While a profiler runs, the step
  names its pulls, compute and pushes with ``record_function`` ranges
  (``fps.pull``, ``fps.compute``, ``fps.push``, ...); otherwise it opens
  none.

* **the program auditor** (:mod:`fps_tpu_torch.analysis`):
  ``Trainer(audit=...)`` records the first call of every program it runs (a
  chunk's, an indexed call's, a megastep's, keyed by what shapes it) as a
  :class:`~fps_tpu_torch.analysis.record.ProgramRecord` and certifies it;
  :meth:`Trainer.lowered_chunk_text` and :meth:`Trainer.
  lowered_megastep_text` return the record's text of one extra call, on
  fresh state, leaving the trainer as they found it. Recording changes no
  table, launch or host synchronisation of the call.
"""

from __future__ import annotations

import collections
import contextlib
import copy
import dataclasses
import logging
import warnings
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch import sketch as sklib
from fps_tpu_torch.analysis import record as _record
from fps_tpu_torch.core import resilience
from fps_tpu_torch.core.api import ServerLogic, WorkerLogic, as_hot_fold
from fps_tpu_torch.core.ingest import per_worker_cold_counts
from fps_tpu_torch.core.prefetch import (
    ChunkPrefetcher,
    PlacedChunk,
    place_columns,
    placed_batches,
)
from fps_tpu_torch.core.resilience import RollbackPolicy, tree_copy
from fps_tpu_torch.core.rng import fold_seed
from fps_tpu_torch.obs.health import (
    HEALTH_ABORT,
    HEALTH_ESCALATE,
    HealthMonitor,
    StepWatchdog,
)
from fps_tpu_torch.obs.timing import PhaseTimer
from fps_tpu_torch.core.store import (
    ParamStore,
    accumulate_hot,
    compact_cold,
    fold_key,
    hot_delta_init,
    hot_fold_state_shape,
    hot_key,
    hot_slot_map,
    id_to_phys,
    ids_key,
    lookup_hot_slots,
    map_key,
    pull,
    pull_hot,
    push,
    reconcile_hot,
    reconcile_hot_mapped,
    rows_per_shard,
    sketch_key,
    split_hot_push,
    split_hot_push_slots,
    split_tiering,
)
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    Blocks,
    PSMesh,
    host_to_replicated,
    num_workers_of,
)

Tensor = torch.Tensor

__all__ = ["TrainerConfig", "Trainer", "num_workers_of"]

_log = logging.getLogger("fps_tpu_torch.driver")

# The out channel's key for the hot tier's counters.
HOT_TIER_KEY = resilience.HOT_TIER_KEY

# fit_stream's end of stream.
_STREAM_END = object()

_NULL = contextlib.nullcontext()
_autograd_profiler = torch.autograd.profiler


def _phase(timer: PhaseTimer | None, name: str):
    """Timer phase scope, or a free no-op when telemetry is off."""
    return timer.phase(name) if timer is not None else _NULL


def _watch(watchdog: StepWatchdog | None, what: str, index: int):
    return watchdog.watch(what, index) if watchdog is not None else _NULL


def _find_heartbeat(rec):
    """The supervised run's progress beacon riding ``rec``'s sinks, if any.

    Duck-typed on the sink's ``heartbeat`` attribute (the
    :class:`fps_tpu_torch.supervise.child.HeartbeatSink` shape), so the
    driver never imports the supervise package. With a beacon the drivers
    beat between chunk boundaries (the prefetch or ingest wait, the
    dispatch) with a ``phase`` field, as the reference's do, so a death
    there attributes to its sub-phase in the supervisor's records."""
    for s in getattr(rec, "sinks", ()) if rec is not None else ():
        hb = getattr(s, "heartbeat", None)
        if hb is not None and hasattr(hb, "beat"):
            return hb
    return None


def _beat(hb, index: int, phase: str) -> None:
    """A sub-phase liveness beat (nothing without a beacon): the index
    being worked on and the sub-phase's name. Host-only: a file replace,
    no launch and no device read."""
    if hb is not None:
        hb.beat(index=int(index), phase=phase)


def _scope(name: str):
    """A ``torch.profiler.record_function`` range named ``name`` while a
    profiler runs (the reference's ``jax.named_scope``); otherwise a free
    no-op, since opening a range is a dispatcher call even with no
    profiler."""
    if _autograd_profiler._is_profiler_enabled:
        return torch.profiler.record_function(name)
    return _NULL


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Execution-mode knobs: the JAX package's fields, in its order.

    ``sync_every``: ``None`` is the synchronous mode; ``s`` is SSP with
    staleness bound ``s``.

    ``push_delay``: a worker's pushes reach the tables ``push_delay`` steps
    after they were computed (0: at once). Worker-local state updates at
    once. What is still in flight when a call (a ``run_chunk``, a
    ``run_indexed`` call) ends is delivered then, oldest first. With
    ``sync_every`` it brackets the reference's asynchrony from both sides:
    stale reads and delayed writes.

    ``step_tap``: ``tap(tables, batch, local_state, t) -> pytree`` (nested
    dicts, tuples or lists of tensors), run after step ``t``'s push delivery
    on the tables as they are then (with ``push_delay > 0`` the push
    delivered is the one from ``push_delay`` steps before), the step's raw
    (pre-``prepare``) batch and the new local state; ``t`` is the step's
    index in its chunk (:meth:`Trainer.run_chunk`) or epoch
    (:meth:`Trainer.run_indexed`). The metrics gain a ``"tap"`` entry whose
    leaves are ``(T, W, ...)``: steps, then workers, as the JAX package
    gathers them (the tap runs on each worker's blocks of the tables, raw
    batch and local state, as under the JAX package's ``shard_map``). A tap
    with the attribute ``collective = True`` reaches every position at
    once, as a JAX tap reaches the others through ``jax.lax`` collectives:
    it is called once a step as ``tap(tables, batches, local_states, t)``,
    ``tables`` mapping each name to its blocks, one a position, and
    ``batches`` / ``local_states`` one a worker, and it returns one pytree a
    worker; it moves data between positions only through
    :mod:`fps_tpu_torch.parallel.collectives`
    (:func:`~fps_tpu_torch.models.recommendation.make_online_topk_tap` is
    one). The worker's out channel must be a dict without a ``"tap"`` key.

    ``donate``: as in the JAX package, the caller hands its tables over to
    the call. Here that means the tables are updated **in place**: the
    tensors passed to :meth:`Trainer.run_chunk` hold the new values
    afterwards. With ``False`` every push makes a new tensor and the
    caller's tables are left as they were.

    ``prefetch``: depth of :meth:`Trainer.fit_stream`'s background pipeline
    (0: the synchronous host loop); ``prefetch_max > 0`` lets the depth
    rise to it when the driver keeps finding the buffer empty
    (:class:`~fps_tpu_torch.core.prefetch.ChunkPrefetcher`). ``health_lag``
    is 0 or 1; it acts where a rollback policy, a health monitor or a
    watchdog forces a host read of every chunk's metrics: at 1, chunk
    ``i - 1``'s are read while chunk ``i`` runs, a quarantine of ``i - 1``
    restores the state from before it and runs chunk ``i`` again, and the
    tables and metrics are those of 0 bit for bit (a monitor's escalation
    lands one chunk later). ``metrics_drain_every``: without ``on_chunk``,
    ``fit_stream`` moves the buffered metrics to the host every this many
    chunks (0: at the end only).

    ``max_steps_per_call`` bounds the steps of one call of
    :meth:`Trainer.run_indexed` (rounded to whole SSP rounds); each call
    draws from its own seed, as the JAX package's calls draw from their own
    key. ``run_chunk`` does not read it.

    ``hot_sync_every``: the hot tier's window (``TableSpec.hot_tier``):
    pending hot deltas are reconciled every this many steps of a sync call
    (and at its end). 1, the default, is the exact mode: the untiered
    program runs, bit for bit.

    ``auto_tier``: attach :meth:`~fps_tpu_torch.tiering.Retierer.auto_for`
    as a ``fit_stream`` or ``run_indexed`` run begins (unless
    ``Trainer.retierer`` is set): the tables are tracked, the planner sets
    each table's tier knobs and ``hot_sync_every`` after its warm-up, and
    the hot sets are re-ranked as the traffic drifts. It cannot combine
    with ``push_delay`` (raised as the run begins).

    ``guard``: the push-delta guard
    (:class:`~fps_tpu_torch.core.resilience.GuardConfig`, or its mode
    ``"observe"`` / ``"mask"``): every table's push rows are screened in
    the step for non-finite values (and norms over ``norm_limit``), counted
    under the out channel's ``"health"`` entry, and in mask mode dropped
    before the hot/cold split and the push. ``None`` runs none of it: a
    step launches what it launches without a guard.
    """

    sync_every: int | None = None
    push_delay: int = 0
    step_tap: Callable[..., Any] | None = None
    guard: Any = None
    donate: bool = True
    prefetch: int = 0
    prefetch_max: int = 0
    health_lag: int = 0
    metrics_drain_every: int = 8
    hot_sync_every: int = 1
    auto_tier: bool = False
    max_steps_per_call: int | None = None

    def __post_init__(self):
        if self.sync_every is not None and self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")
        if self.push_delay < 0:
            raise ValueError(f"push_delay must be >= 0, got {self.push_delay}")
        if self.max_steps_per_call is not None and self.max_steps_per_call < 1:
            raise ValueError("max_steps_per_call must be >= 1, got "
                             f"{self.max_steps_per_call}")


class Trainer:
    """Runs the parameter-server training loop for one WorkerLogic: the
    analog of the reference's ``FlinkParameterServer.transform``.
    """

    def __init__(self, mesh: PSMesh, param_store: ParamStore,
                 worker_logic: WorkerLogic,
                 server_logic: Mapping[str, ServerLogic] | ServerLogic = (
                     ServerLogic()),
                 config: TrainerConfig | None = None, recorder=None,
                 audit=None):
        # Telemetry (fps_tpu_torch.obs.Recorder): host-side only; None
        # means the drivers make no obs call. Assignable after
        # construction and overridable per fit_stream / run_indexed call.
        self.recorder = recorder
        # The program auditor (fps_tpu_torch.analysis): a ProgramAuditor,
        # a ProgramContract, True or "strict". The first call of every
        # program (by its key, _program_key) is recorded and certified
        # against the contract (default: contract_for_trainer) through the
        # recorder; "strict" raises ContractViolationError after that call.
        # A bad value fails here; False means off. Assignable later: a
        # program already recorded is not recorded again.
        if audit is not None:
            from fps_tpu_torch.analysis import as_auditor

            audit = as_auditor(audit)
        self.audit = audit
        self._audited: set = set()
        self.mesh = mesh
        self.device = mesh.device
        self.store = param_store
        self.logic = worker_logic
        if isinstance(server_logic, ServerLogic):
            server_logic = {name: server_logic for name in param_store.specs}
        self.server_logic = dict(server_logic)
        self.config = config or TrainerConfig()
        guard = resilience.as_guard(self.config.guard)  # fail fast on typos
        if guard is not None and guard.tables is not None:
            unknown = set(guard.tables) - set(param_store.specs)
            if unknown:
                raise ValueError(
                    f"guard.tables names unknown tables {sorted(unknown)} — "
                    f"store has {sorted(param_store.specs)}; a typo here "
                    "would silently disable the guard")
        if (guard is not None and guard.local
                and resilience.LOCAL_STATE_KEY in param_store.specs):
            raise ValueError(
                f"guard.local reserves the {resilience.LOCAL_STATE_KEY!r} "
                "health-channel entry, but the store has a table of that "
                "name — rename the table or disable the local guard")
        self.num_shards = mesh.shape[SHARD_AXIS]
        self.num_workers = num_workers_of(mesh)
        # The adaptive tier's manager (fps_tpu_torch.tiering.Retierer): set
        # before the first call, or let TrainerConfig.auto_tier attach one.
        self.retierer = None
        self._tier_warned: set[str] = set()

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int) -> tuple[dict[str, Blocks], Any]:
        """Tables and worker-local state, made from ``seed``: each table
        :class:`~fps_tpu_torch.parallel.mesh.Blocks` of the mesh's
        positions, each local-state leaf the ``Blocks`` of the workers'
        rows of the global leaf that ``init_local_state`` makes (the JAX
        package shards it over the workers on axis 0; over several
        processes, this process's workers' rows)."""
        tables = self.store.init(fold_seed(seed, 0))
        local_state = self.logic.init_local_state(
            fold_seed(seed, 1), self.num_workers, self.device)
        return tables, _tree_map(self._worker_blocks, local_state)

    def _worker_blocks(self, leaf) -> Blocks:
        """A local-state leaf as the workers' blocks: a global tensor is cut
        into ``W`` equal pieces on axis 0, this process's workers' kept."""
        if isinstance(leaf, Blocks):
            return leaf
        return Blocks(collectives.scatter_workers(self.mesh, leaf),
                      mesh=self.mesh)

    def _worker_states(self, local_state) -> list:
        """Each of this process's workers' local state (its block of every
        leaf)."""
        blocks = _tree_map(self._worker_blocks, local_state)
        return [_tree_map(lambda b, i=i: b[i], blocks)
                for i in range(len(self.mesh.local))]

    def _worker_batches(self, batches: Mapping[str, Tensor]) -> list[dict]:
        """Each of this process's workers' columns of a call's batches:
        ``(steps, n * B, ...)`` columns of its ``n`` workers (every worker's
        on one process) cut on axis 1 in worker order, on its device."""
        cut = {k: collectives.scatter_local(self.mesh, v, 1)
               for k, v in batches.items()}
        return [{k: v[i] for k, v in cut.items()}
                for i in range(len(self.mesh.local))]

    # -- routes -----------------------------------------------------------

    def _hot_rows(self, name: str) -> int:
        """Local hot-row count of a table's pull and push (the JAX package's
        ``_resolve_hot_rows``).

        ``hot_ids="auto"`` routes the whole shard through the head kernel K3
        when the shard is at most :func:`fps_tpu_torch.ops.
        packed_crossover_rows` rows (measured on the H100 against K2 with its
        radix sort: 512 to 16,384 rows by width, none past 200 columns), and
        resolves to 0 (K2) otherwise. An int is the global head count: global hot ids
        ``[0, H)`` sit in local rows ``[0, ceil(H / S))`` under the
        owner-major layout.
        """
        spec = self.store.specs[name]
        if spec.hot_ids == "auto":
            rps = rows_per_shard(spec.num_ids, self.num_shards)
            return rps if rps <= ops.packed_crossover_rows(spec.dim) else 0
        if isinstance(spec.hot_ids, str):
            raise ValueError(
                f"table {spec.name!r}: hot_ids={spec.hot_ids!r}: expected an "
                "int or the literal 'auto'")
        return -(-spec.hot_ids // self.num_shards) if spec.hot_ids else 0

    def _dense(self, name: str) -> bool:
        """The dense route for this table (the JAX package's
        ``_resolve_dense``): never on a one-position mesh, where the
        gathered route has no collective to save; else
        ``TableSpec.dense_collectives is True``. ``"auto"`` keeps the
        gathered route: the JAX package's threshold
        (``DENSE_TABLE_BYTES``) was measured on a TPU's interconnect."""
        return (self.num_workers > 1
                and self.store.specs[name].dense_collectives is True)

    def _head_prefix(self, batch) -> dict[str, int]:
        """The worker's head-prefix guarantee for this batch, for tables that
        declare their head (an int ``hot_ids > 0``). Honoured only on a
        one-position mesh: the collective pull and push reorder the id
        streams (the all-gather across workers)."""
        if self.num_workers != 1:
            return {}
        out = {}
        for name, n in self.logic.head_prefix(batch).items():
            spec = self.store.specs.get(name)
            if (spec is not None and isinstance(spec.hot_ids, int)
                    and spec.hot_ids > 0 and n):
                out[name] = int(n)
        return out

    # -- the static hot tier: resolution ----------------------------------

    def _resolve_hot_tier(self, spec) -> int:
        """The table's replicated head rows on this mesh under this config
        (0: untiered; the JAX package's ``_resolve_hot_tier``).

        The tier engages only where it can win and stay correct: a mesh of
        more than one position, ``hot_sync_every > 1`` (1 is the exact mode,
        the untiered program itself) and a ``"sum"``, ``"mean"``, ``"max"``
        or ``"min"`` fold without ``apply_fn`` (the window's buffer holds
        delta sums, with counts, or extrema, which commute with those
        combines). A table with ``apply_fn`` or a callable combine keeps its
        route, with one warning."""
        H = spec.hot_tier
        if not isinstance(H, int):
            raise ValueError(
                f"table {spec.name!r}: hot_tier={H!r}: expected an int")
        if H < 0:
            raise ValueError(f"table {spec.name!r}: hot_tier={H} must be "
                             ">= 0")
        if not H or self.num_workers == 1 or self.config.hot_sync_every <= 1:
            self._check_hot_fold(spec, 0)
            return 0
        sl = self.server_logic[spec.name]
        if sl.apply_fn is not None or not (
                isinstance(sl.combine, str)
                and sl.combine in ("sum", "mean", "max", "min")):
            if spec.name not in self._tier_warned:
                self._tier_warned.add(spec.name)
                fold = ("apply_fn" if sl.apply_fn is not None
                        else "a callable combine")
                warnings.warn(
                    f"table {spec.name!r}: hot_tier={H} requested but the "
                    f"per-push server fold ({fold}) keeps the gathered "
                    "route: windowed hot-delta accumulation commutes with "
                    "the 'sum'/'mean'/'max'/'min' combines only, so the "
                    "tier is disabled for this table (the untiered program "
                    "runs)", stacklevel=3)
            self._check_hot_fold(spec, 0)
            return 0
        H = min(H, spec.num_ids)
        self._check_hot_fold(spec, H)
        return H

    def _check_hot_fold(self, spec, resolved_H: int) -> None:
        """Raise where a stateful hot fold cannot engage (a silent drop to
        plain addition would change the optimizer): it needs the tier on
        with the whole table replicated (a partial head would give head rows
        the scaled step and tail rows the raw one) and a ``"sum"`` or
        ``"mean"`` combine (the fold takes the window's delta sum)."""
        sl = self.server_logic[spec.name]
        fold = as_hot_fold(sl.hot_fold)
        if fold is None:
            return
        if not resolved_H:
            raise ValueError(
                f"table {spec.name!r}: hot_fold={fold.kind!r} requires the "
                "hot tier to resolve ON (mesh of more than one position, "
                "hot_tier > 0, hot_sync_every > 1, no apply_fn): a silently "
                "ignored server optimizer would change training semantics")
        if resolved_H < spec.num_ids:
            raise ValueError(
                f"table {spec.name!r}: hot_fold={fold.kind!r} with a "
                f"PARTIAL head (H={resolved_H} < {spec.num_ids}): head rows "
                "would take the adaptive step while cold-tail pushes fold "
                "additively; set hot_tier >= num_ids (the fold's state is "
                "sharded, so full replication does not replicate it)")
        if sl.combine not in ("sum", "mean"):
            raise ValueError(
                f"table {spec.name!r}: hot_fold={fold.kind!r} needs a "
                f"'sum'/'mean' combine (got {sl.combine!r}): the fold takes "
                "the window's combined delta sum")

    def _hot_tier_map(self) -> dict[str, int]:
        """``{table: H}`` for every table the tier resolves on for; empty:
        the untiered program."""
        tier = {}
        for name, spec in self.store.specs.items():
            H = self._resolve_hot_tier(spec)
            if H:
                tier[name] = H
        if tier and self.config.push_delay:
            raise ValueError(
                "hot_tier and push_delay cannot combine: delayed delivery "
                "would re-order the windowed reconcile against the pushes "
                f"in flight. Disable one (hot tier tables: {sorted(tier)})")
        return tier

    def _hot_fold_map(self) -> dict:
        """``{table: HotFold}`` for the tiered tables with a stateful fold
        (checked by :meth:`_check_hot_fold`)."""
        out = {}
        for name in self._hot_tier_map():
            fold = as_hot_fold(self.server_logic[name].hot_fold)
            if fold is not None:
                out[name] = fold
        return out

    def _cold_compact_map(self) -> dict[str, int]:
        """``{table: lane}`` for the tables on the compacted cold routes
        (``TableSpec.cold_budget``): a partial head (``0 < H < num_ids``) on
        the gathered route with a positive budget. Whether a chunk may take
        them is :meth:`_certify_cold`'s call."""
        out = {}
        for name, H in sorted(self._hot_tier_map().items()):
            spec = self.store.specs[name]
            C = int(spec.cold_budget or 0)
            if C <= 0 or H >= spec.num_ids or self._dense(name):
                continue
            out[name] = C
        return out

    def _certify_cold(self, host_ids) -> tuple[bool, list[str]]:
        """``(fits, overflowed_tables)``: whether every ``(step, worker)``
        slice of a chunk has no more cold ids than its table's lane.
        ``host_ids`` is ``WorkerLogic.pulled_ids_host``'s dict, or ``None``
        (uncertifiable: every compacted table overflows). Padding counts
        like any id, as the device's compaction sees it."""
        tier = self._hot_tier_map()
        mapped = self._mapped_tables()
        overflowed = []
        for name, C in self._cold_compact_map().items():
            arr = None if host_ids is None else host_ids.get(name)
            member = None
            if name in mapped:
                # The mapped tier's current hot set, the sentinel False.
                member = np.zeros(self.store.specs[name].num_ids + 1, bool)
                member[self.retierer.hot_ids_for(name, mapped[name])] = True
            if arr is None or int(per_worker_cold_counts(
                    arr, self.num_workers, hot_head=tier[name],
                    hot_member=member).max(initial=0)) > C:
                overflowed.append(name)
        return not overflowed, overflowed

    def _host_cert_ids(self, chunk):
        """The logic's certification stream for a chunk: ``None`` when no
        table is compacted, or when the chunk already lies on a device
        (its columns are tensors, which the host cannot read without a
        wait)."""
        if not self._cold_compact_map() or any(
                isinstance(v, Tensor) for v in chunk.values()):
            return None
        return self.logic.pulled_ids_host(chunk)

    def _mapped_tables(self) -> dict[str, int]:
        """``{table: H}`` of the tables on the mapped (adaptive) tier: with
        a retierer, every tiered table with a partial head (``0 < H <
        num_ids``) that it manages. A whole replicated table has nothing
        to re-rank, and without a retierer the static head runs."""
        if self.retierer is None:
            return {}
        return {name: H for name, H in sorted(self._hot_tier_map().items())
                if H < self.store.specs[name].num_ids
                and self.retierer.manages(name)}

    def _track_specs(self) -> dict:
        """``{table: CountMinSpec}`` of the tables whose pulled ids each
        step sketches: none without a retierer; every managed table during
        an ``auto_plan`` warm-up (the planner needs every density); after
        it, or with the knobs set by hand, the mapped tables only. So a
        disengaged tier (the exact mode, one position, a fold the window
        cannot carry) runs the untiered program even with a retierer."""
        if self.retierer is None:
            return {}
        track = self.retierer.track_specs(self.store.specs)
        if self.retierer.auto_plan and not self.retierer.planned:
            return track
        mapped = self._mapped_tables()
        return {n: cm for n, cm in sorted(track.items()) if n in mapped}

    def _replicated(self, arr: np.ndarray) -> Blocks:
        """A host array on every position of this process (every process
        passes the same array)."""
        return Blocks(host_to_replicated(np.ascontiguousarray(arr),
                                         self.mesh),
                      replicas=len(self.mesh.slot), mesh=self.mesh)

    def _attach_hot(self, tables, timer=None):
        """``tables`` with exactly the tier entries the resolution calls for:
        each tiered table's replica (kept when live and of its size, else
        derived from the canonical table: the static head by
        :meth:`~fps_tpu_torch.core.store.ParamStore.head_replica`, the
        mapped tier's hot set by :meth:`~fps_tpu_torch.core.store.
        ParamStore.rows_replica`), each mapped table's slot map and id
        array (from the retierer's current hot set), each tracked table's
        window (the retierer's seed, else zeros) and each hot fold's state
        (kept when of its shape, else zeros, sharded over the shard axis in
        slice order); stale entries are dropped, so a tier turned off runs
        the untiered program again. Called at the entry of ``run_chunk``,
        ``fit_stream`` and ``run_indexed`` and by the retierer's plans:
        the replicas are valid at any call boundary, since every call ends
        in a reconcile. Only a derivation is timed (``timer``'s
        ``reconcile`` phase): the steady per-chunk call checks shapes
        only."""
        tier = self._hot_tier_map()
        mapped = self._mapped_tables()
        track = self._track_specs()
        folds = self._hot_fold_map()
        canonical = split_tiering(tables)[0]
        if not (tier or track) and len(canonical) == len(tables):
            return tables
        S = self.num_shards

        def fold_shape(name):
            rows, cols = hot_fold_state_shape(
                folds[name], tier[name], self.store.specs[name].dim, S)
            return rows // S, cols

        # The shape of each entry the resolution calls for (a block's).
        shapes = {}
        for name, H in tier.items():
            shapes[hot_key(name)] = (H, self.store.specs[name].dim)
        for name, H in mapped.items():
            shapes[map_key(name)] = (self.store.specs[name].num_ids + 1,)
            shapes[ids_key(name)] = (H,)
        for name, cm in track.items():
            shapes[sketch_key(name)] = (cm.depth, cm.width)
        for name in folds:
            shapes[fold_key(name)] = fold_shape(name)
        out = {k: v for k, v in tables.items()
               if k in canonical or tuple(v[0].shape) == shapes.get(k)}
        if all(k in out for k in shapes):
            return out
        with _phase(timer, "reconcile"):
            self._derive_tier(out, tier, mapped, track, folds, fold_shape)
        return out

    def _derive_tier(self, out, tier, mapped, track, folds, fold_shape):
        """The missing tier entries of :meth:`_attach_hot`, added to
        ``out``."""
        for name in sorted(tier):
            if hot_key(name) in out:
                continue
            if name in mapped:
                out[hot_key(name)] = self.store.rows_replica(
                    name, self.retierer.hot_ids_for(name, mapped[name]),
                    out[name])
            else:
                out[hot_key(name)] = self.store.head_replica(
                    name, tier[name], out[name])
        for name in sorted(mapped):
            if map_key(name) in out and ids_key(name) in out:
                continue
            hot = self.retierer.hot_ids_for(name, mapped[name])
            out[ids_key(name)] = self._replicated(hot.astype(np.int32))
            out[map_key(name)] = self._replicated(
                hot_slot_map(self.store.specs[name].num_ids, hot))
        for name in sorted(track):
            if sketch_key(name) in out:
                continue
            cm = track[name]
            win = self.retierer.device_window(name)
            if win is None or win.shape != (cm.depth, cm.width):
                win = np.zeros((cm.depth, cm.width), np.float32)
            out[sketch_key(name)] = self._replicated(
                np.asarray(win, np.float32))
        for name in sorted(folds):
            if fold_key(name) not in out:
                rows, cols = fold_shape(name)
                out[fold_key(name)] = Blocks(
                    [torch.zeros((rows, cols), dtype=torch.float32,
                                 device=dev)
                     for dev in self.mesh.positions],
                    replicas=self.mesh.shape[DATA_AXIS], mesh=self.mesh)

    def _enter_tiering(self) -> None:
        """A run's entry (``fit_stream``, ``run_indexed``): attach
        ``TrainerConfig.auto_tier``'s retierer, and let the retierer apply
        a plan it already made, so the run resolves the tier it had."""
        if self.config.auto_tier and self.retierer is None:
            from fps_tpu_torch.tiering import Retierer

            self.retierer = Retierer.auto_for(self)
        if self.retierer is not None:
            if self.retierer.auto_plan and self.config.push_delay:
                # As hot_tier with push_delay, but raised here rather than
                # at the boundary where the plan would land.
                raise ValueError(
                    "auto_tier and push_delay cannot combine: the planner "
                    "would turn on a hot tier whose windowed reconcile "
                    "re-orders against the delayed pushes. Disable one.")
            self.retierer.on_run_entry(self)

    # -- one step ---------------------------------------------------------

    def _compute_step(self, tables, snapshot, states, batches, keys,
                      tier=None, track=None):
        """Every worker's step: pull (from the live tables, or the SSP
        ``snapshot`` when given) and run the worker step; return the
        workers' pushes unapplied, the head-prefix guarantee for them, the
        new local states, the step's outputs (one a worker) and the hot
        tier's pull counts (one dict a worker).

        With ``tier`` (a :class:`_Tier`), a sync pull of a tiered table
        reads ids ``< H`` from the position's replica and the cold residue
        through the table's route with the hot slots masked to ``-1``
        (packed into the ``cold_budget`` lane first, where the chunk
        certified; the route is skipped when ``H`` covers the table). SSP
        pulls read the round's snapshot, whose head rows the reconcile
        before it already made the replica's. A mapped table's membership
        is its slot map's.

        With ``track`` (a :class:`_Track`), each tracked table's pulled ids
        go into every position's window first (:func:`~fps_tpu_torch.
        sketch.cm_update`, K4; padding is dropped)."""
        batches = [self.logic.prepare(b, k) for b, k in zip(batches, keys)]
        hp = self._head_prefix(batches[0])
        ids = [self.logic.pull_ids(b) for b in batches]
        if track is not None:
            with _scope("fps.sketch"):
                for name, cm in sorted(track.specs.items()):
                    if name in ids[0]:
                        track.windows[name] = [
                            sklib.cm_update(cm, w, i[name])
                            for w, i in zip(track.windows[name], ids)]
        with _scope("fps.pull"):
            pulled = [{} for _ in batches]
            counts = [{} for _ in batches]
            heads = tier.heads if tier is not None else {}
            for name in ids[0]:
                tids = [i[name] for i in ids]
                route = dict(hot_rows=self._hot_rows(name),
                             head_prefix=hp.get(name, 0))
                H = heads.get(name, 0)
                if snapshot is None and H:
                    vals = self._pull_tiered(tables, tier, name, H, tids,
                                             counts)
                elif snapshot is None:
                    vals = pull(tables[name], tids,
                                num_shards=self.num_shards,
                                dense=self._dense(name), mesh=self.mesh,
                                **route)
                else:
                    rps = tables[name][0].shape[0]
                    # -1 padding stays -1 (a zero row): the floor-mod of
                    # id_to_phys would wrap it onto a live row for S > 1.
                    # On one shard phys == ids, so the head guarantee
                    # holds.
                    vals = [ops.gather_rows(
                        snap, torch.where(t >= 0, id_to_phys(
                            t, self.num_shards, rps), -1), **route)
                        for snap, t in zip(snapshot[name], tids)]
                for p, v in zip(pulled, vals):
                    p[name] = v
        with _scope("fps.compute"):
            outs = [self.logic.step(b, p, s, k)
                    for b, p, s, k in zip(batches, pulled, states, keys)]
            guard = resilience.as_guard(self.config.guard)
            if guard is not None:
                outs = [self._guard_step(guard, o, s, b)
                        for o, s, b in zip(outs, states, batches)]
        return ([o.pushes for o in outs], hp, [o.local_state for o in outs],
                [o.out for o in outs], counts)

    def _guard_step(self, guard, out, old_state, batch):
        """One worker's step output through the guard
        (:func:`~fps_tpu_torch.core.resilience.guard_pushes`, and with
        ``guard.local`` :func:`~fps_tpu_torch.core.resilience.
        guard_local_state` over the rows ``touched_local_rows`` names), its
        counts mounted on the out channel under ``"health"``."""
        pushes, health = resilience.guard_pushes(out.pushes, guard)
        new_local = out.local_state
        if guard.local:
            new_local, local_health = resilience.guard_local_state(
                old_state, new_local, guard,
                touched=self.logic.touched_local_rows(batch))
            if local_health is not None:
                health[resilience.LOCAL_STATE_KEY] = local_health
        outch = out.out
        if health:
            if not isinstance(outch, dict):
                raise TypeError(
                    "TrainerConfig.guard requires the worker's out "
                    "channel to be a dict so the health counters can "
                    f"ride it (got {type(outch).__name__})")
            if resilience.HEALTH_KEY in outch:
                raise ValueError(
                    "the worker's out channel already has a 'health' "
                    "key — it would collide with the guard's counters")
            outch = dict(outch, **{resilience.HEALTH_KEY: health})
        return dataclasses.replace(out, pushes=pushes, local_state=new_local,
                                   out=outch)

    def _pull_tiered(self, tables, tier, name: str, H: int, tids, counts):
        """A sync pull of tiered table ``name``: every worker's rows, its
        counts (``hot_rows``, ``pulled_rows``, ``cold_dropped`` on a
        compacted table) added to ``counts``."""
        live = [torch.sum(t >= 0, dtype=torch.int32) for t in tids]
        reps = tier.replicas[name]
        if H >= self.store.specs[name].num_ids:
            # The whole table is replicated: no collective route at all.
            for c, n in zip(counts, live):
                c[name] = {"hot_rows": n, "pulled_rows": n}
            return [ops.gather_rows(r, t) for r, t in zip(reps, tids)]
        if name in tier.maps:
            # The mapped tier: membership and the replica's row by slot.
            slots = [lookup_hot_slots(m, t)
                     for m, t in zip(tier.maps[name], tids)]
            hots = [(ops.gather_rows(r, sl), sl >= 0)
                    for r, sl in zip(reps, slots)]
        else:
            hots = [pull_hot(r, t, hot_ids=H) for r, t in zip(reps, tids)]
        cold = [torch.where(m, -1, t).to(t.dtype)
                for (_, m), t in zip(hots, tids)]
        for c, (_, m), n in zip(counts, hots, live):
            c[name] = {"hot_rows": torch.sum(m, dtype=torch.int32),
                       "pulled_rows": n}
        if name in tier.compact:
            # The cold residue packed into the certified lane, pulled, and
            # its rows scattered back to their batch positions (masked and
            # dropped slots read zero rows).
            lanes = [compact_cold(t, None, budget=tier.compact[name])
                     for t in cold]
            lane_vals = pull(tables[name], [ln[0] for ln in lanes],
                             num_shards=self.num_shards, dense=False,
                             hot_rows=self._hot_rows(name), mesh=self.mesh)
            vals = [ops.gather_rows(v, ln[2])
                    for v, ln in zip(lane_vals, lanes)]
            for c, ln in zip(counts, lanes):
                c[name]["cold_dropped"] = ln[3]
        else:
            vals = pull(tables[name], cold, num_shards=self.num_shards,
                        dense=self._dense(name),
                        hot_rows=self._hot_rows(name), mesh=self.mesh)
        return [torch.where(m[:, None], hv, v)
                for (hv, m), v in zip(hots, vals)]

    def _apply_pushes(self, tables, pushes, head_prefix):
        """One collective push a table lands every worker's deltas."""
        new_tables = dict(tables)
        for name in pushes[0]:
            sl = self.server_logic[name]
            new_tables[name] = push(
                tables[name], [p[name][0] for p in pushes],
                [p[name][1] for p in pushes], num_shards=self.num_shards,
                apply_fn=sl.apply_fn, combine=sl.combine,
                hot_rows=self._hot_rows(name),
                head_prefix=head_prefix.get(name, 0),
                dense=self._dense(name), inplace=self.config.donate,
                mesh=self.mesh)
        return new_tables

    def _apply_hot_split(self, tables, tier, pushes, head_prefix):
        """Split each tiered table's pushes on ``id < H`` (a mapped table's
        on its slot map, the hot part in slot space): the cold part
        goes through the table's routes (packed into the lane where the
        chunk certified; none when ``H`` covers the table), the hot part
        into the positions' pending buffers (:func:`~fps_tpu_torch.core.
        store.accumulate_hot`, in place). Returns the new tables and the
        lanes' overflow counts, a list a worker by table."""
        cold = [{} for _ in pushes]
        dropped = {}
        for name in pushes[0]:
            per = [p[name] for p in pushes]
            H = tier.heads.get(name, 0)
            if not H:
                for c, x in zip(cold, per):
                    c[name] = x
                continue
            if H >= self.store.specs[name].num_ids:
                hots = per  # no cold residue to push
            else:
                if name in tier.maps:
                    parts = [split_hot_push_slots(i, d,
                                                  lookup_hot_slots(m, i))
                             for (i, d), m in zip(per, tier.maps[name])]
                else:
                    parts = [split_hot_push(i, d, hot_ids=H)
                             for i, d in per]
                hots = [h for _, h in parts]
                rest = [c for c, _ in parts]
                if name in tier.compact:
                    lanes = [compact_cold(i, d, budget=tier.compact[name])
                             for i, d in rest]
                    rest = [(ln[0], ln[1]) for ln in lanes]
                    dropped[name] = [ln[3] for ln in lanes]
                for c, x in zip(cold, rest):
                    c[name] = x
            sl = self.server_logic[name]
            fold = as_hot_fold(sl.hot_fold)
            with _scope("fps.hot_accumulate"):
                tier.deltas[name] = [
                    accumulate_hot(buf, i, d, combine=sl.combine, fold=fold)
                    for buf, (i, d) in zip(tier.deltas[name], hots)]
        if cold[0]:
            tables = self._apply_pushes(tables, cold, head_prefix)
        return tables, dropped

    def _reconcile(self, tables, tier):
        """The window's end: every tiered table's pending buffers folded
        into its replicas and canonical rows of its hot ids, its fold state
        advanced and its buffers reset (:func:`~fps_tpu_torch.core.store.
        reconcile_hot`, or :func:`~fps_tpu_torch.core.store.
        reconcile_hot_mapped` on a mapped table)."""
        tables = dict(tables)
        for name in sorted(tier.heads):
            sl = self.server_logic[name]
            args = (tables[name], tier.replicas[name], tier.deltas[name])
            if name in tier.gids:
                fn, args = reconcile_hot_mapped, args + (tier.gids[name],)
            else:
                fn = reconcile_hot
            (tables[name], tier.replicas[name], tier.deltas[name],
             fstate) = fn(
                *args, num_shards=self.num_shards, combine=sl.combine,
                fold=as_hot_fold(sl.hot_fold),
                fold_states=tier.folds.get(name),
                inplace=self.config.donate, mesh=self.mesh)
            if fstate is not None:
                tier.folds[name] = fstate
        return tables

    def _mount_hot_channel(self, outs, counts, dropped, tier):
        """Each worker's out channel with the tier's counters under
        ``"hot_tier"``: a dict a tiered table of its pull counts (sync),
        ``cold_dropped`` on a compacted table (the lanes' overflow; 0 for a
        certified chunk) and ``delta_sq``, the sum of the position's pending
        deltas squared (the staleness gauge). Summed over the workers with
        the other metrics."""
        mounted = []
        for w, out in enumerate(outs):
            if not isinstance(out, dict):
                raise TypeError(
                    "TableSpec.hot_tier requires the worker's out channel to "
                    "be a dict so the hot-tier counters can ride it (got "
                    f"{type(out).__name__})")
            if HOT_TIER_KEY in out:
                raise ValueError(
                    "the worker's out channel already has a 'hot_tier' key; "
                    "it would collide with the tier's counters")
            chan = {}
            for name in sorted(tier.heads):
                c = dict(counts[w].get(name, {}))
                if name in dropped:
                    c["cold_dropped"] = (c["cold_dropped"] + dropped[name][w]
                                         if "cold_dropped" in c
                                         else dropped[name][w])
                buf = tier.deltas[name][w]
                dim = tier.replicas[name][w].shape[1]
                vals = buf[:, :dim].to(torch.float32)
                if self.server_logic[name].combine in ("max", "min"):
                    # The extremum buffer holds the sentinel on untouched
                    # rows; only touched rows carry real magnitudes.
                    vals = torch.where((buf[:, dim].abs() <= 1.0)[:, None],
                                       vals, torch.zeros_like(vals))
                c["delta_sq"] = torch.sum(vals * vals)
                chan[name] = c
            mounted.append(dict(out, **{HOT_TIER_KEY: chan}))
        return mounted

    def _run_tap(self, out, tables, batches, states, t: int):
        """``out`` with the step tap's outputs under ``"tap"``: the tap runs
        on each worker's blocks, raw batch and local state (a collective tap:
        once, on all of this process's), and its leaves gain the worker axis
        ``W`` on the home device (every worker's, in every process)."""
        tap = self.config.step_tap
        if tap is None:
            return out
        if not isinstance(out, dict):
            raise TypeError(
                "step_tap requires the worker's out channel to be a dict "
                f"(got {type(out).__name__})")
        if "tap" in out:
            raise ValueError(
                "the worker's out channel already has a 'tap' key; it would "
                "be clobbered by the step_tap output")
        if getattr(tap, "collective", False):
            tapped = tap(tables, batches, states, t)
        else:
            tapped = [tap({name: tb[i] for name, tb in tables.items()}, b, s,
                          t)
                      for i, (b, s) in enumerate(zip(batches, states))]
        return dict(out, tap=_tree_stack(tapped, lambda xs: torch.stack(
            collectives.gather_home(self.mesh, xs))))

    def _step(self, tables, snapshot, states, batches, keys, t, outs,
              in_flight, tier=None, track=None):
        _record.mark_step()
        pushes, hp, states, out, counts = self._compute_step(
            tables, snapshot, states, batches, keys, tier, track)
        if tier is not None:
            # push_delay is 0 with the tier on (_hot_tier_map).
            with _scope("fps.push"):
                tables, dropped = self._apply_hot_split(tables, tier,
                                                        pushes, hp)
            out = self._mount_hot_channel(out, counts, dropped, tier)
        else:
            # This step's pushes go in flight, with the head-prefix
            # guarantee of the batch that made them; the pushes of
            # push_delay steps ago land (at push_delay = 0, this step's own).
            in_flight.append((pushes, hp))
            with _scope("fps.push"):
                while len(in_flight) > self.config.push_delay:
                    tables = self._apply_pushes(tables,
                                                *in_flight.popleft())
        # Metrics summed over the shards, then the data replicas.
        out = _sum_metrics(self.mesh, out)
        outs.append(self._run_tap(out, tables, batches, states, t))
        return tables, states

    def _run_steps(self, tables, local_state, batches, num_steps: int,
                   seed: int, t0: int = 0, compact=None):
        """Run ``num_steps`` steps over ``batches`` (columns with leading
        dims ``(num_steps, n * B)``, this process's ``n`` workers' columns,
        on the home device); the step tap sees
        step ``i`` as step ``t0 + i``. Sync: one step after the other. SSP:
        rounds of ``sync_every`` steps, each round's pulls from a snapshot
        of the tables (each position's all-gathered physical table) taken
        as the round begins. Worker ``w`` draws from one ``torch.Generator``
        seeded by ``fold_seed(seed, w)``, or, when it is ``step_seeded``,
        from step ``i``'s seed ``fold_seed(fold_seed(seed, w), i)``, ``w``
        the global worker index.
        Returns ``(tables, local_state, metrics)`` with ``(num_steps,)``
        device tensors on the home device, summed over the workers (the
        tap's leaves ``(num_steps, W, ...)``).

        With ``push_delay = d`` the pushes wait in a queue of at most ``d``
        steps' pushes (every worker's): step ``i`` delivers step ``i - d``'s,
        and the call ends by delivering what is left, oldest first, as the
        JAX package's ring buffer does. The ring's cold slots (ids ``-1``,
        zero deltas) change no row, so they are not delivered at all: each
        real push lands exactly once, and a call launches the kernels it
        launches at ``d = 0``. A queued push holds the worker's own tensors
        (ids from the batch, freshly computed deltas), which no later step
        rewrites.

        With tiered tables (``tables`` as :meth:`_attach_hot` made them)
        every position starts the call with fresh pending buffers, which
        are reconciled after steps ``E - 1, 2E - 1, ...`` and after the
        last step (sync, ``E = hot_sync_every``), or after every round
        (SSP). ``compact``: ``{table: lane}`` of the tables whose cold
        routes this call packs (a certified chunk). Each tracked table's
        windows start the call at zero, and the call ends by adding their
        sum over the mesh to its ``::sketch`` entry (:func:`merge_windows`).
        """
        mesh = self.mesh
        canonical, replicas, maps, gids, sketches, folds = split_tiering(
            tables)
        tables = {name: list(tb) for name, tb in canonical.items()}
        tier = None
        heads = self._hot_tier_map()
        if heads:
            mapped = self._mapped_tables()
            tier = _Tier(
                heads=heads, compact=dict(compact or {}),
                replicas={n: list(replicas[n]) for n in heads},
                deltas=self._init_hot_deltas(tables, heads),
                folds={n: list(folds[n]) for n in self._hot_fold_map()},
                maps={n: list(maps[n]) for n in mapped},
                gids={n: list(gids[n]) for n in mapped})
        track = None
        specs = self._track_specs()
        if specs:
            track = _Track(specs=specs, windows={
                n: [torch.zeros_like(w) for w in sketches[n]]
                for n in specs})
        states = self._worker_states(local_state)
        per_worker = self._worker_batches(batches)
        seeds = [fold_seed(seed, w) for w in mesh.local]
        if self.logic.step_seeded:
            def key(i):
                return [fold_seed(sw, i) for sw in seeds]
        else:
            gens = []
            for sw, dev in zip(seeds, mesh.positions):
                gens.append(torch.Generator(device=dev))
                gens[-1].manual_seed(sw)

            def key(i):
                return gens

        def batch_at(i):
            return [{k: v[i] for k, v in b.items()} for b in per_worker]

        outs: list[dict[str, Tensor]] = []
        in_flight = collections.deque()
        s = self.config.sync_every
        if s is None:
            E = self.config.hot_sync_every
            for i in range(num_steps):
                tables, states = self._step(
                    tables, None, states, batch_at(i), key(i), t0 + i,
                    outs, in_flight, tier, track)
                # A window ends every E steps from the call's first, and
                # the call ends with its ragged tail's.
                if tier is not None and ((i + 1) % E == 0
                                         or i == num_steps - 1):
                    with _scope("fps.reconcile"):
                        tables = self._reconcile(tables, tier)
        else:
            for r in range(num_steps // s):
                # The round's reads see the tables as the round begins: a
                # copy, since the round's pushes may update them in place.
                snapshot = {name: collectives.all_gather(
                    mesh, tb, SHARD_AXIS, copy=True)
                    for name, tb in tables.items()}
                for j in range(r * s, (r + 1) * s):
                    tables, states = self._step(
                        tables, snapshot, states, batch_at(j), key(j),
                        t0 + j, outs, in_flight, tier, track)
                if tier is not None:
                    # Before the next round's snapshot, which must see the
                    # reconciled head rows.
                    with _scope("fps.reconcile"):
                        tables = self._reconcile(tables, tier)
        with _scope("fps.push"):
            while in_flight:  # the call's end: deliver what is in flight
                tables = self._apply_pushes(tables, *in_flight.popleft())
        D = mesh.shape[DATA_AXIS]
        tables = {name: Blocks(tb, replicas=D, mesh=mesh)
                  for name, tb in tables.items()}
        if tier is not None:
            for name in sorted(tier.heads):
                tables[hot_key(name)] = Blocks(
                    tier.replicas[name], replicas=len(mesh.slot), mesh=mesh)
            for name in sorted(tier.folds):
                tables[fold_key(name)] = Blocks(tier.folds[name],
                                                replicas=D, mesh=mesh)
            for name in sorted(tier.maps):
                tables[map_key(name)] = maps[name]
                tables[ids_key(name)] = gids[name]
        if track is not None:
            with _scope("fps.sketch_merge"):
                for name in sorted(track.specs):
                    tables[sketch_key(name)] = merge_windows(
                        mesh, sketches[name], track.windows[name])
        local_state = _tree_stack(states, lambda xs: Blocks(xs, mesh=mesh))
        return tables, local_state, _tree_stack(outs, torch.stack)

    def _init_hot_deltas(self, tables, heads) -> dict[str, list]:
        """Fresh pending-delta buffers, one a position, for every tiered
        table: made as a call begins and reconciled before it returns."""
        out = {}
        for name, H in heads.items():
            sl = self.server_logic[name]
            blk = tables[name][0]
            out[name] = [hot_delta_init(
                H, blk.shape[1], blk.dtype, combine=sl.combine,
                fold=as_hot_fold(sl.hot_fold), device=dev)
                for dev in self.mesh.positions]
        return out

    # -- chunks -----------------------------------------------------------

    def run_chunk(self, tables, local_state, batches, seed: int, *,
                  timer=None, recorder=None):
        """Run one chunk of steps.

        Args:
          tables: ``{name: tensor}`` (from :meth:`init_state` or the last
            chunk).
          local_state: the worker-local state.
          batches: dict of host arrays (or tensors) with leading dims
            ``(T, B)`` (sync) or ``(R, s, B)`` (SSP); ``B`` is the global
            batch, worker-major (over several processes every process passes
            the same chunk and places its own workers' columns, the JAX
            package's ``host_to_sharded`` contract). Tensors already on the
            trainer's device
            (:func:`~fps_tpu_torch.core.device_ingest.device_epoch_chunks`)
            are used as they are, with no copy. A
            :class:`~fps_tpu_torch.core.prefetch.PlacedChunk` (the
            pipeline's) is already placed: its copies are waited for on the
            current stream, not made again. Where a table takes the
            compacted cold routes, the chunk is certified here: a host chunk
            through ``WorkerLogic.pulled_ids_host``, a ``PlacedChunk``
            through its ``host_ids``; a chunk already on the device cannot
            be certified and takes the static routes.
          seed: seed of this chunk's ``torch.Generator`` (for ``prepare`` /
            ``step`` draws, e.g. negative sampling).
          timer: optional :class:`fps_tpu_torch.obs.PhaseTimer`: the
            placement goes to ``place``, the steps' launches to
            ``dispatch``. ``fit_stream`` passes its own; standalone callers
            may too.
          recorder: optional :class:`fps_tpu_torch.obs.Recorder` for the
            cold lanes' certification counters (``cold_route.*``; default
            ``self.recorder``).

        Returns:
          ``(tables, local_state, metrics)``: metrics is a dict of ``(T,)``
          tensors on the device, one entry per step, summed over workers.
        """
        rec = recorder if recorder is not None else self.recorder
        tables = self._attach_hot(tables, timer)
        compact = self._cold_compact_map()
        if compact:
            # The chunk takes the compacted lanes only where it certifies;
            # an overflowing chunk takes the static routes, the same bits
            # as cold_budget = 0.
            fits, overflowed = self._certify_cold(
                batches.host_ids if isinstance(batches, PlacedChunk)
                else self._host_cert_ids(batches))
            if rec is not None:
                if fits:
                    rec.inc("cold_route.compact_chunks")
                else:
                    for t in overflowed:
                        rec.inc("cold_route.overflow_chunks", table=t)
            if not fits:
                compact = {}
        with _phase(timer, "place"):
            if not isinstance(batches, PlacedChunk):
                batches = self._place_chunk(batches)
            batches = placed_batches(batches, self.device)
        steps, batches = self._chunk_steps(batches)
        with _phase(timer, "dispatch"):
            tables, local_state, metrics = self._audited_call(
                "chunk", (tuple(sorted(compact.items())),),
                "chunk/" + self._mode() + ("+compact" if compact else ""),
                tables, lambda: self._run_steps(
                    tables, local_state, batches, steps, seed,
                    compact=compact))
        # Keep the store's host reads (lookup_host / dump_model) on the
        # live tensors.
        self.store.tables = dict(tables)
        return tables, local_state, metrics

    def _chunk_steps(self, batches):
        """``(steps, batches)`` of a placed chunk: an SSP chunk's ``(R, s,
        ...)`` columns joined to ``(R * s, ...)``."""
        lead = next(iter(batches.values())).shape
        if self.config.sync_every is None:
            return lead[0], batches
        if lead[1] != self.config.sync_every:
            raise ValueError(
                f"SSP chunk rounds of {lead[1]} steps, config "
                f"sync_every={self.config.sync_every}")
        steps = lead[0] * lead[1]
        return steps, {k: v.reshape((steps,) + v.shape[2:])
                       for k, v in batches.items()}

    # -- the program auditor ------------------------------------------------

    def _mode(self) -> str:
        return "sync" if self.config.sync_every is None else "ssp"

    def _program_key(self, kind: str, *extra) -> tuple:
        """What shapes a program of ``kind`` (the fields of the JAX
        package's compile keys): a program with a new key is audited on
        its first call."""
        logic = tuple(
            (name, sl.combine, sl.apply_fn, as_hot_fold(sl.hot_fold))
            for name, sl in sorted(self.server_logic.items()))
        return (kind, self._mode(), self.device.type,
                self.config.push_delay, self.config.step_tap,
                resilience.as_guard(self.config.guard), logic,
                self.config.hot_sync_every,
                tuple(sorted(self._hot_tier_map().items())),
                tuple(sorted(self._mapped_tables().items())),
                tuple(sorted(self._track_specs().items()))) + extra

    def _audited_call(self, kind: str, extra: tuple, label: str, tables,
                      call):
        """``call()`` (a ``_run_steps`` call or a megastep dispatch over
        ``tables``), recorded and certified when the auditor is on and
        this program's key is new; otherwise just ``call()``."""
        if self.audit is None or self.audit is False:
            return call()
        from fps_tpu_torch.analysis import as_auditor, contract_for_trainer

        auditor = as_auditor(self.audit)
        self.audit = auditor  # one auditor keeps the certificates
        key = self._program_key(kind, *extra)
        if key in self._audited:
            return call()
        out, prog = self._record_call(label, tables, call)
        self._audited.add(key)
        contract = auditor.contract or contract_for_trainer(
            self, self._mode(), program=kind)
        auditor.certify(label, prog, contract=contract,
                        recorder=self.recorder)
        return out

    def _record_call(self, label: str, tables, call):
        """``(call(), its ProgramRecord)``; ``tables``' canonical ones are
        the record's arguments."""
        canonical = {name: list(tables[name]) for name in self.store.specs
                     if name in tables}
        return _record.record_call(label, canonical, call,
                                   off_cpu=self.device.type != "cpu")

    def _lowering_state(self):
        """What a lowering call may change, to be put back after it: the
        store's tables, the retierer (and its tracker's state), the
        warnings already given and the global random states."""
        rt = self.retierer
        return (dict(self.store.tables), rt,
                rt.snapshot() if rt is not None else None,
                set(self._tier_warned), torch.random.get_rng_state(),
                torch.cuda.get_rng_state_all()
                if torch.cuda.is_initialized() else None)

    def _restore_lowering_state(self, saved) -> None:
        tables, rt, snap, warned, rng, cuda_rng = saved
        self.store.tables = tables
        self.retierer = rt
        if rt is not None:
            rt.restore_snapshot(snap)
        self._tier_warned = warned
        torch.random.set_rng_state(rng)
        if cuda_rng is not None:
            torch.cuda.set_rng_state_all(cuda_rng)

    def _check_mode(self, mode: str) -> None:
        if mode != self._mode():
            raise ValueError(
                f"mode={mode!r}, but the trainer's config runs "
                f"{self._mode()!r} (sync_every={self.config.sync_every})")

    def lowered_chunk_text(self, chunk, mode: str = "sync") -> str:
        """The record's text (:class:`~fps_tpu_torch.analysis.record.
        ProgramRecord`) of the exact per-chunk program ``fit_stream`` runs
        for ``chunk``: fresh state (``init_state(0)``) with the tier's
        entries attached, the chunk placed and certified for the compacted
        lanes as :meth:`run_chunk` does, one ``_run_steps`` call with seed
        1, recorded. The entry point of the analysis tools
        (``fps_tpu_torch/examples/audit_programs.py``,
        :func:`~fps_tpu_torch.tiering.lowered_plan_text`,
        :meth:`~fps_tpu_torch.obs.drift.BudgetDriftDetector.
        observe_trainer_chunk`). The call passes no recorder, and the
        trainer is left as it was found: the store's tables, the
        retierer's state, the global random states; a run after it is the
        same bits as one without it. ``mode`` must be the config's
        (``"ssp"`` with ``sync_every``)."""
        self._check_mode(mode)
        saved = self._lowering_state()
        try:
            tables, ls = self.init_state(0)
            tables = self._attach_hot(tables)
            compact = self._cold_compact_map()
            if compact and not self._certify_cold(
                    self._host_cert_ids(chunk))[0]:
                compact = {}
            steps, batches = self._chunk_steps(placed_batches(
                self._place_chunk(chunk), self.device))
            label = "chunk/" + mode + ("+compact" if compact else "")
            _, prog = self._record_call(label, tables, lambda: self._run_steps(
                tables, ls, batches, steps, 1, compact=compact))
            return prog.to_text()
        finally:
            self._restore_lowering_state(saved)

    def _place_chunk(self, batches) -> PlacedChunk:
        """Place one chunk's columns on the trainer's device: the placement
        that :meth:`run_chunk` and the pipeline's worker thread both run, so
        prefetch on and off give the same device inputs by construction
        (:func:`~fps_tpu_torch.core.prefetch.place_columns`). Over several
        processes only this process's workers' columns are placed."""
        dim = 1 if self.config.sync_every is None else 2
        return place_columns(
            collectives.own_columns(self.mesh, batches, dim), self.device)

    def _place_for_prefetch(self, batches) -> PlacedChunk:
        """The pipeline's placement: :meth:`_place_chunk`, with the chunk's
        certification stream kept beside it (``PlacedChunk.host_ids``) for
        :meth:`run_chunk` to certify at dispatch."""
        placed = self._place_chunk(batches)
        placed.host_ids = self._host_cert_ids(batches)
        return placed

    # -- checkpoint plumbing ----------------------------------------------

    def _host_local_state(self, local_state):
        """The local state as host arrays: each leaf's global array
        (:meth:`~fps_tpu_torch.parallel.mesh.Blocks.numpy`, a collective
        over several processes: every process reaches the boundary
        together, as for the tables' dump)."""
        def to_host(leaf):
            if isinstance(leaf, Blocks):
                return leaf.numpy()
            if isinstance(leaf, Tensor):
                return leaf.detach().cpu().numpy()
            return leaf

        return _tree_map(to_host, local_state)

    def _save_checkpoint(self, checkpointer, step: int, local_state, *,
                         tables=None, touched=None, final=False,
                         ready=None) -> None:
        """Save the tables and the local state, the local state in the
        logic's worker-count-independent export form (tagged
        ``"exported"``, so a mismatched restore fails loudly).

        ``tables``: boundary copies (clones on the device) to save instead
        of the live store: the overlapped paths take them at the boundary
        and save after the next chunk was dispatched. With an
        :class:`~fps_tpu_torch.core.checkpoint.AsyncCheckpointer` on one
        process, the device-to-host capture itself moves to the writer
        thread (``save_deferred``), which first waits for ``ready`` (the
        CUDA event recorded after the copies); over several processes the
        capture is a collective and stays on this thread.

        ``touched``: ``(ids_by_table, marker, tracker)`` from a
        :class:`~fps_tpu_torch.core.checkpoint.TouchedRowsTracker` at the
        same boundary, committed once the save was accepted. ``final``:
        the end-of-run save, forced to land (``when_full="block"``)."""
        kwargs = {}
        if touched is not None:
            kwargs["touched_rows"] = touched[0]
        if final and hasattr(checkpointer, "when_full"):
            kwargs["when_full"] = "block"
        try:
            if (tables is not None
                    and hasattr(checkpointer, "save_deferred")
                    and self.mesh.procs is None):
                # The writer gets a private store view over the copies;
                # everything the closure touches is frozen.
                view = copy.copy(self.store)
                view.tables = dict(tables)
                ckpt, logic = checkpointer, self.logic
                ls_dev = local_state

                def collect():
                    if ready is not None:
                        ready.synchronize()
                    return ckpt._collect(
                        view, logic.export_local_state(
                            self._host_local_state(ls_dev)), "exported")

                checkpointer.save_deferred(step, collect, **kwargs)
            else:
                prev = None
                if tables is not None:
                    prev = self.store.tables
                    self.store.tables = dict(tables)
                try:
                    checkpointer.save(
                        step, self.store, self.logic.export_local_state(
                            self._host_local_state(local_state)),
                        local_state_format="exported", **kwargs)
                finally:
                    if prev is not None:
                        self.store.tables = prev
            if touched is not None:
                touched[2].commit(touched[1])
        except Exception as e:
            from fps_tpu_torch.core.checkpoint import _fenced

            if _fenced(e):
                _log.error("run fenced off by the pod at step %d: %s", step,
                           e)
            raise

    def restore_checkpoint(self, checkpointer, local_state_like, *,
                           step: int | None = None):
        """Restore a snapshot onto this trainer's mesh: tables onto any
        shard count (the elastic re-split, asserted), local state onto any
        worker count for an ``"exported"`` snapshot whose logic has
        ``import_local_state``, else onto ``local_state_like``'s shapes
        (the same worker count). Every process places its own positions.

        ``local_state_like``: the local state of :meth:`init_state`.
        Returns ``(tables, local_state, step)``; the next run's entry
        derives the hot tier's entries from the restored tables.
        """
        from fps_tpu_torch.core.checkpoint import place_like

        step, values, leaves, fmt = checkpointer.read_snapshot(step)
        tables = checkpointer.load_tables(self.store, step, values)
        imported = NotImplemented
        if fmt == "exported":
            imported = self.logic.import_local_state(leaves,
                                                     self.num_workers)
        like_leaves, treedef = resilience.tree_flatten(local_state_like)
        if imported is NotImplemented:
            # The raw layout (or an identity export): shapes must match
            # this worker count's local state exactly.
            if len(like_leaves) != len(leaves):
                raise ValueError(
                    f"checkpoint step {step} has {len(leaves)} local-state "
                    f"leaves, local_state_like has {len(like_leaves)}")
            for saved, like in zip(leaves, like_leaves):
                shape = self._global_shape(like)
                if shape is not None and tuple(saved.shape) != shape:
                    raise ValueError(
                        f"checkpoint local-state leaf shape {saved.shape} "
                        f"!= expected {shape} — was the snapshot taken at "
                        "a different worker count with a logic that has "
                        "no import_local_state?")
            imported = resilience.tree_unflatten(treedef, leaves)
        got = resilience.tree_flatten(imported)[0]
        if len(got) != len(like_leaves):
            raise ValueError(
                f"imported local state has {len(got)} leaves, "
                f"local_state_like has {len(like_leaves)}")
        placed = [place_like(self.mesh, np.asarray(leaf), like)
                  for leaf, like in zip(got, like_leaves)]
        return tables, resilience.tree_unflatten(treedef, placed), step

    def _global_shape(self, like) -> tuple | None:
        """The global shape of a local-state leaf (``None``: not an
        array)."""
        if isinstance(like, Blocks):
            rows = self.num_workers // like.replicas * like[0].shape[0]
            return (rows,) + tuple(like[0].shape[1:])
        if isinstance(like, (Tensor, np.ndarray)):
            return tuple(like.shape)
        return None

    def _check_rollback(self, rollback) -> None:
        if rollback is None:
            return
        if not isinstance(rollback, RollbackPolicy):
            raise TypeError(f"rollback must be a RollbackPolicy, got "
                            f"{type(rollback).__name__}")
        if (resilience.as_guard(self.config.guard) is None
                and not rollback.preset):
            # A preset-only policy needs no health channel; a quarantine
            # does.
            raise ValueError(
                "a rollback policy needs the health channel: set "
                "TrainerConfig.guard ('observe' for pure quarantine "
                "semantics, 'mask' to also drop poison rows in-step)")

    def _check_health(self, health) -> None:
        if health is None:
            return
        if not isinstance(health, HealthMonitor):
            raise TypeError(
                f"health must be a fps_tpu_torch.obs.HealthMonitor, got "
                f"{type(health).__name__}")
        if resilience.as_guard(self.config.guard) is None:
            raise ValueError(
                "a HealthMonitor needs the health channel: set "
                "TrainerConfig.guard ('observe' to run cheap until the "
                "monitor escalates to mask, or 'mask' outright)")

    def _record_health(self, rec, metrics) -> int:
        """Fold one host metrics dict's health channel into the recorder
        (per-table counters) and return the poisoned-row total that the
        HealthMonitor thresholds (the nonfinite and norm tiers)."""
        h = (metrics.get(resilience.HEALTH_KEY)
             if isinstance(metrics, Mapping) else None)
        if not h:
            return 0
        poison = 0
        for table, counters in h.items():
            nf = int(np.sum(np.asarray(counters.get("nonfinite", 0))))
            nm = int(np.sum(np.asarray(counters.get("norm", 0))))
            mk = int(np.sum(np.asarray(counters.get("masked", 0))))
            if rec is not None:
                # Zero increments too: a clean guarded run's digest shows
                # the table at 0 rather than as unguarded.
                rec.inc("health.nonfinite_rows", nf, table=table)
                rec.inc("health.norm_rows", nm, table=table)
                rec.inc("health.masked_rows", mk, table=table)
            poison += nf + nm
        return poison

    def _fold_metrics_accounting(self, rec, metrics, ev=None) -> int:
        """The one per-chunk / per-epoch telemetry fold of a host metrics
        dict: the per-table health counters (and
        ``health.poisoned_chunks``), the hot tier's counters, the example
        and step counters from the ``"n"`` leaf, and, with a journal event
        dict ``ev``, its ``examples`` / ``poison_rows`` fields. Returns
        the poisoned-row total."""
        poison = self._record_health(rec, metrics)
        ht = (metrics.get(HOT_TIER_KEY)
              if isinstance(metrics, Mapping) else None)
        if ht and rec is not None:
            for table, counters in ht.items():
                # .get: an SSP run's reads come from the round snapshot,
                # not the replica, and carry no pull counters.
                rec.inc("hot_tier.hot_rows", float(np.sum(np.asarray(
                    counters.get("hot_rows", 0)))), table=table)
                rec.inc("hot_tier.pulled_rows", float(np.sum(np.asarray(
                    counters.get("pulled_rows", 0)))), table=table)
                if "cold_dropped" in counters:
                    # Always zero for a certified chunk: nonzero would be a
                    # certifier bug, surfaced rather than lost.
                    rec.inc("hot_tier.cold_dropped", float(np.sum(
                        np.asarray(counters["cold_dropped"]))), table=table)
                # Peak pending-delta magnitude over the call's steps.
                ds = np.asarray(counters.get("delta_sq", 0.0))
                rec.set("hot_tier.pending_delta",
                        float(np.sqrt(np.max(ds))) if ds.size else 0.0,
                        table=table)
        if rec is not None:
            if poison:
                rec.inc("health.poisoned_chunks")
                if ev is not None:
                    ev["poison_rows"] = poison
            if isinstance(metrics, Mapping) and "n" in metrics:
                n = float(np.sum(metrics["n"]))
                rec.inc("driver.examples", n)
                rec.inc("driver.steps", int(np.shape(metrics["n"])[0]))
                if ev is not None:
                    ev["examples"] = n
        return poison

    def _apply_health_decision(self, health, rec, index, poison, what):
        """Feed the monitor and apply its decision: escalate swaps this
        trainer's guard observe -> mask (the next chunk or epoch screens in
        mask mode), abort raises PoisonedStreamError after flushing the
        telemetry."""
        if health is None:
            return
        decision = health.update(index, poison)
        if decision == HEALTH_ESCALATE:
            guard = resilience.as_guard(self.config.guard)
            if guard is not None and guard.mode == "observe":
                self.config = dataclasses.replace(
                    self.config,
                    guard=dataclasses.replace(guard, mode="mask"))
                _log.warning(
                    "health monitor: escalating guard observe->mask at "
                    "%s %d (%d poisoned rows >= %d)", what, index,
                    health.poison_rows, health.escalate_after_rows)
                if rec is not None:
                    rec.event("guard_escalated", index=int(index), what=what,
                              poison_rows=health.poison_rows)
        elif decision == HEALTH_ABORT:
            if rec is not None:
                rec.event("health_abort", index=int(index), what=what,
                          poisoned_chunks=health.poisoned_chunks,
                          poison_rows=health.poison_rows)
                rec.flush()
            raise resilience.PoisonedStreamError(
                f"health monitor abort at {what} {index}: "
                f"{health.poisoned_chunks} poisoned {what}s (threshold "
                f"{health.abort_after_chunks}), {health.poison_rows} "
                "poisoned rows total")

    def _maybe_quarantine(self, rollback, last_good, metrics, index, what):
        """The rollback step of ``fit_stream`` (chunks) and ``run_indexed``
        (epochs): the metrics to the host and, when the health channel
        reports poison, the state from before the call restored and the
        index recorded. Returns ``(host_metrics, restored_or_None)``. The
        state (and the store's view) is restored before ``record()``,
        whose budget check may raise."""
        metrics = _to_host(metrics)
        poison = resilience.health_total(metrics)
        if not poison:
            return metrics, None
        tables, local_state = last_good
        self.store.tables = dict(tables)
        _log.warning("%s %d poisoned (%d bad push rows): rolled back and "
                     "quarantined", what, index, poison)
        rollback.record(index)
        return metrics, (tables, local_state)

    def _boundary_ready(self):
        """A CUDA event recorded on the current stream after a boundary's
        copies (``None`` off the card): the writer thread waits on it
        before it reads them."""
        if self.device.type != "cuda":
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def fit_stream(self, tables, local_state, chunks: Iterable[Mapping],
                   seed: int, metrics_reduce=None, checkpointer=None,
                   checkpoint_every: int = 0, start_step: int = 0,
                   on_chunk=None, rollback=None, recorder=None, health=None,
                   watchdog=None):
        """Run :meth:`run_chunk` over a stream of chunks (the JAX package's
        parameters, in its order; ``key`` is ``seed``).

        Chunk ``j = start_step + i`` (the ``i``-th the iterator yields) runs
        from seed ``fold_seed(seed, j)``: to resume a stream, pass the index
        of its next chunk with an iterator positioned there. ``on_chunk(j,
        metrics)`` is called after each chunk with its metrics as numpy
        arrays (that waits for the device). Without it the metrics stay on
        the device and move to the host every
        ``TrainerConfig.metrics_drain_every`` chunks (0: when the stream
        ends).

        ``checkpointer`` (a :class:`~fps_tpu_torch.core.checkpoint.
        Checkpointer`) with ``checkpoint_every = k``: the tables and the
        local state are saved as step ``j + 1`` after every ``k``-th chunk
        and once more at the end of the stream (forced to land), and the
        checkpointer is flushed on every exit path. With a
        :class:`~fps_tpu_torch.core.checkpoint.DeltaPolicy` each save is
        planned against the chunks' pulled ids
        (``WorkerLogic.pulled_ids_host``). With the pipeline on (or
        ``health_lag = 1``) a boundary's save runs from clones of the state
        taken at the boundary, after the next chunk was dispatched.

        ``rollback`` (a :class:`~fps_tpu_torch.core.resilience.
        RollbackPolicy`, with ``TrainerConfig.guard``): a chunk whose
        health channel reports poison is undone (the state cloned before
        it restored), recorded in ``rollback.quarantined`` and left out of
        the metrics and the checkpoints; ``rollback.preset`` chunks are
        consumed and never run.

        With ``TrainerConfig.prefetch > 0`` the chunks are assembled and
        placed on a worker thread, ``prefetch`` chunks ahead
        (:class:`~fps_tpu_torch.core.prefetch.ChunkPrefetcher`); the worker
        is joined on every exit path, and an error in the source or in a
        copy re-raises here at its chunk's position.

        Telemetry (:mod:`fps_tpu_torch.obs`): ``recorder`` (default
        ``self.recorder``) times each chunk's phases (``ingest``,
        ``place``, ``dispatch``, ``host_sync``, ``checkpoint``,
        ``callback``; the pipeline's worker adds ``prefetch``), journals
        ``chunk`` events and folds the health channel into per-table
        counters; it forces no host read of its own, so a recorder costs
        host bookkeeping only. ``health`` (a
        :class:`~fps_tpu_torch.obs.HealthMonitor`, with a guard) escalates
        this trainer's guard from observe to mask after N poisoned rows and
        aborts with ``PoisonedStreamError`` after M poisoned chunks;
        ``watchdog`` (a :class:`~fps_tpu_torch.obs.StepWatchdog`) flags a
        chunk whose launches and read overrun its deadline. Health and the
        watchdog, like ``rollback``, read every chunk's metrics as it
        happens; ``health_lag = 1`` makes that read lag by one chunk
        (chunk ``i - 1``'s is read while chunk ``i`` runs): the tables
        equal lag 0's, except that an escalation lands one chunk later.

        Returns:
          ``(tables, local_state, metrics)``: the per-chunk host metrics
          list, or ``metrics_reduce(list)`` when given.

        Raises:
          ValueError: ``prefetch`` or ``metrics_drain_every`` below 0,
            ``health_lag`` other than 0 and 1, or a rollback policy or a
            HealthMonitor without a guard.
          TypeError: ``health`` that is not a HealthMonitor.
        """
        self._check_rollback(rollback)
        self._check_health(health)
        cfg = self.config
        if cfg.prefetch < 0:
            raise ValueError(
                f"TrainerConfig.prefetch must be >= 0, got {cfg.prefetch}")
        if cfg.health_lag not in (0, 1):
            raise ValueError("TrainerConfig.health_lag must be 0 or 1, got "
                             f"{cfg.health_lag}")
        if cfg.metrics_drain_every < 0:
            raise ValueError("TrainerConfig.metrics_drain_every must be >= "
                             f"0, got {cfg.metrics_drain_every}")
        rec = recorder if recorder is not None else self.recorder
        timer = PhaseTimer(rec) if rec is not None else None
        hb = _find_heartbeat(rec)
        # A health-based quarantine needs the guard; a preset-only policy
        # pays neither the copies nor the per-chunk host read.
        quarantine = (rollback if rollback is not None
                      and resilience.as_guard(cfg.guard) is not None
                      else None)
        # Rollback, health and the watchdog read every chunk's metrics as
        # it happens: a host read a chunk (lagged by one at health_lag 1).
        sync_each = (quarantine is not None or health is not None
                     or watchdog is not None)
        lag = 1 if (cfg.health_lag and sync_each) else 0
        saves = checkpointer is not None and checkpoint_every > 0
        overlap_ckpt = saves and (cfg.prefetch > 0 or lag > 0)
        saved_at = None  # step of the last periodic save
        all_metrics = []
        delta_touched = None
        if saves and getattr(checkpointer, "delta_policy", None) is not None:
            from fps_tpu_torch.core.checkpoint import TouchedRowsTracker

            delta_touched = TouchedRowsTracker(self.store.specs)

        def capture_touched():
            if delta_touched is None:
                return None
            ids, marker = delta_touched.capture()
            return (ids, marker, delta_touched)

        def chunk_touched_ids(c):
            if isinstance(c, PlacedChunk):
                return c.host_ids
            if any(isinstance(v, Tensor) for v in c.values()):
                # A chunk already on the device: reading its ids back
                # would stall; the save takes the exact compare instead.
                return None
            return self.logic.pulled_ids_host(c)

        def place_for_prefetch(b):
            placed = self._place_for_prefetch(b)
            if placed.host_ids is None and delta_touched is not None:
                placed.host_ids = self.logic.pulled_ids_host(b)
            return placed

        self._enter_tiering()
        # The tier's entries at the stream's entry; run_chunk keeps them.
        tables = self._attach_hot(tables, timer)
        it = iter(chunks)
        pf = None
        if cfg.prefetch:
            it = pf = ChunkPrefetcher(
                it, place_for_prefetch, depth=cfg.prefetch,
                max_depth=cfg.prefetch_max or None, recorder=rec,
                timer=timer, start_index=start_step,
                skip_place=(rollback.preset if rollback is not None
                            else frozenset()),
                device=self.device)
        i = start_step - 1
        pending = None       # health_lag 1: the chunk not yet adjudicated
        pending_save = None  # the deferred boundary save

        def retier_boundary(j):
            nonlocal tables
            if self.retierer is None:
                return
            with _phase(timer, "retier"):
                tables = self.retierer.on_boundary(self, tables, j,
                                                   recorder=rec)
            self.store.tables = dict(tables)

        def save_due(j):
            return saves and (j + 1) % checkpoint_every == 0

        def boundary_copy(j):
            """The state after chunk ``j`` as clones on the device, the
            touched-rows capture of the same boundary and the event the
            writer waits on."""
            tb, ls = tree_copy(tables), tree_copy(local_state)
            return (j + 1, tb, ls, capture_touched(), self._boundary_ready())

        def flush_save():
            nonlocal pending_save, saved_at
            if pending_save is None:
                return
            step, tb, ls, tc, ready = pending_save
            pending_save = None
            with _phase(timer, "checkpoint"):
                self._save_checkpoint(checkpointer, step, ls, tables=tb,
                                      touched=tc, ready=ready)
            saved_at = step

        def sync_entry(entry):
            """The forced host read of one chunk's metrics: ``(metrics,
            restored_or_None)``."""
            if quarantine is not None:
                with _phase(timer, "host_sync"):
                    return self._maybe_quarantine(
                        quarantine, entry["last_good"], entry["metrics"],
                        entry["index"], "chunk")
            if sync_each:
                with _phase(timer, "host_sync"):
                    return _to_host(entry["metrics"]), None
            return entry["metrics"], None

        def account_entry(entry, metrics, restored):
            """Telemetry, callbacks and the boundary save of one
            adjudicated chunk; True when it was quarantined (the state then
            restored)."""
            nonlocal tables, local_state, pending_save, saved_at
            j = entry["index"]
            ev = {"index": j} if rec is not None else None
            poison = 0
            if sync_each and (rec is not None or health is not None):
                poison = self._fold_metrics_accounting(rec, metrics, ev)
            if rec is not None:
                rec.inc("driver.chunks")
                if restored is not None:
                    rec.inc("rollback.quarantined")
                    ev["quarantined"] = True
            self._apply_health_decision(health, rec, j, poison, "chunk")
            if restored is not None:
                if rec is not None:
                    rec.event("chunk", phases=timer.chunk_summary(), **ev)
                    rec.flush()
                if (self.retierer is not None
                        and entry.get("retier_state") is not None):
                    # The tracker rolls back with the tables.
                    self.retierer.restore_snapshot(entry["retier_state"])
                tables, local_state = restored
                return True
            if on_chunk is not None:
                with _phase(timer, "host_sync"):
                    metrics = _to_host(metrics)
                if rec is not None and not sync_each:
                    # on_chunk paid the host read: the same accounting as
                    # the forced reads.
                    self._fold_metrics_accounting(rec, metrics, ev)
                all_metrics.append(metrics)
                with _phase(timer, "callback"):
                    on_chunk(j, metrics)
            else:
                # An unbounded stream must not pile up device buffers.
                all_metrics.append(metrics)
                de = cfg.metrics_drain_every
                if de and (j - start_step) % de == de - 1:
                    with _phase(timer, "host_sync"):
                        all_metrics[-de:] = [_to_host(m)
                                             for m in all_metrics[-de:]]
            if save_due(j):
                if entry.get("save") is not None:
                    # Lag: the copies were taken when the chunk ran.
                    pending_save = entry["save"]
                    flush_save()
                elif overlap_ckpt:
                    pending_save = boundary_copy(j)
                else:
                    with _phase(timer, "checkpoint"):
                        self._save_checkpoint(checkpointer, j + 1,
                                              local_state,
                                              touched=capture_touched())
                    saved_at = j + 1
            if rec is not None:
                # After the callback and checkpoint phases, so the event's
                # breakdown covers the whole chunk; flushed at every
                # boundary, so a kill loses at most one chunk of JSONL.
                rec.event("chunk", phases=timer.chunk_summary(), **ev)
                rec.flush()
            return False

        try:
            while True:
                with _phase(timer, "ingest"):
                    _beat(hb, i + 1, "prefetch" if pf is not None
                          else "ingest")
                    chunk = next(it, _STREAM_END)
                if chunk is _STREAM_END:
                    break
                i += 1
                if rollback is not None and i in rollback.preset:
                    # Quarantined before: consumed, never run; the draws
                    # key off i, so later chunks are unaffected.
                    rollback.skip(i)
                    if rec is not None:
                        rec.inc("rollback.preset_skipped")
                        rec.flush()
                    continue
                if delta_touched is not None:
                    delta_touched.observe(chunk_touched_ids(chunk))
                if quarantine is not None:
                    last_good = (tree_copy(tables), tree_copy(local_state))
                    rt_snap = (self.retierer.snapshot()
                               if self.retierer is not None else None)
                else:
                    last_good = rt_snap = None
                cseed = fold_seed(seed, i)
                _beat(hb, i, "dispatch")
                if lag:
                    prev, pending = pending, None
                    with _watch(watchdog, "chunk", i):
                        tables, local_state, metrics = self.run_chunk(
                            tables, local_state, chunk, cseed, timer=timer,
                            recorder=rec)
                        save = boundary_copy(i) if save_due(i) else None
                        # Chunk i - 1 is judged while chunk i runs.
                        pmetrics = prestored = None
                        if prev is not None:
                            pmetrics, prestored = sync_entry(prev)
                    if prev is not None:
                        if account_entry(prev, pmetrics, prestored):
                            # Chunk i ran on the poisoned state: run it
                            # again from the restored one, as lag 0 would
                            # have.
                            if quarantine is not None:
                                last_good = (tree_copy(tables),
                                             tree_copy(local_state))
                                rt_snap = (self.retierer.snapshot()
                                           if self.retierer is not None
                                           else None)
                            with _watch(watchdog, "chunk", i):
                                tables, local_state, metrics = (
                                    self.run_chunk(tables, local_state,
                                                   chunk, cseed, timer=timer,
                                                   recorder=rec))
                            save = (boundary_copy(i) if save_due(i)
                                    else None)
                        else:
                            retier_boundary(prev["index"])
                    pending = {"index": i, "metrics": metrics,
                               "last_good": last_good, "save": save,
                               "retier_state": rt_snap}
                else:
                    with _watch(watchdog, "chunk", i):
                        tables, local_state, metrics = self.run_chunk(
                            tables, local_state, chunk, cseed, timer=timer,
                            recorder=rec)
                        entry = {"index": i, "metrics": metrics,
                                 "last_good": last_good, "save": None,
                                 "retier_state": rt_snap}
                        metrics, restored = sync_entry(entry)
                    # The previous boundary's deferred save: the device is
                    # already past it.
                    flush_save()
                    if not account_entry(entry, metrics, restored):
                        retier_boundary(i)
            if pending is not None:
                # Lag 1: the last chunk is still to be judged; its forced
                # read keeps the watchdog's cover, like every other.
                prev, pending = pending, None
                with _watch(watchdog, "chunk", prev["index"]):
                    pmetrics, prestored = sync_entry(prev)
                if not account_entry(prev, pmetrics, prestored):
                    retier_boundary(prev["index"])
            flush_save()
            # The end of the stream is saved unless it already is (also
            # when a quarantined last chunk skipped its periodic save).
            if (checkpointer is not None and i >= start_step
                    and saved_at != i + 1):
                self.store.tables = dict(tables)
                with _phase(timer, "checkpoint"):
                    self._save_checkpoint(checkpointer, i + 1, local_state,
                                          touched=capture_touched(),
                                          final=True)
        finally:
            if pf is not None:
                pf.close()
            if checkpointer is not None:
                try:
                    # An accepted boundary's deferred save must not vanish
                    # because the stream stopped before it ran.
                    flush_save()
                except Exception:
                    _log.exception("deferred checkpoint save failed during "
                                   "stream teardown")
                with _phase(timer, "checkpoint"):
                    checkpointer.flush()
        self.store.tables = dict(tables)
        if on_chunk is None:
            with _phase(timer, "host_sync"):
                all_metrics = [_to_host(m) for m in all_metrics]
            if rec is not None and not sync_each:
                # A stream read only at its end still gets its whole-run
                # health totals and example counts.
                for m in all_metrics:
                    self._fold_metrics_accounting(rec, m)
        if rec is not None:
            rec.flush()
        if metrics_reduce is not None and all_metrics:
            return tables, local_state, metrics_reduce(all_metrics)
        return tables, local_state, all_metrics

    # -- index-fed epochs -------------------------------------------------

    def _indexed_call_steps(self, plan) -> int:
        """Steps per call of :meth:`run_indexed`: the whole epoch, capped by
        ``max_steps_per_call`` (rounded to a ``sync_every`` multiple)."""
        T = plan.steps_per_epoch
        cap = self.config.max_steps_per_call
        if cap is None or cap >= T:
            return T
        s = self.config.sync_every
        if s:
            if s > cap:
                warnings.warn(
                    f"sync_every={s} exceeds max_steps_per_call={cap}; a "
                    f"call must hold whole SSP rounds, so each call runs {s} "
                    "steps", stacklevel=3)
            cap = max(s, (cap // s) * s)
        return cap

    def run_indexed(self, tables, local_state, plan, seed: int, *,
                    epochs: int = 1, on_epoch=None, checkpointer=None,
                    checkpoint_every: int = 0, start_epoch: int = 0,
                    as_numpy: bool = True, rollback=None, recorder=None,
                    health=None, watchdog=None):
        """Run ``epochs`` full passes over a device-resident dataset.

        ``plan`` is an epoch plan whose ``sync_every`` matches the trainer's
        config: a :class:`~fps_tpu_torch.core.device_ingest.DeviceEpochPlan`
        or a :class:`~fps_tpu_torch.models.word2vec.Word2VecDevicePlan`.
        Both give ``steps_per_epoch``, ``epoch_args(e)`` and
        ``call_batches(args, start, steps)``: the batches of a call's steps
        for this process's workers (every worker's on one process), one
        device tensor a column with a leading step axis, built on the
        device (no host copy). Each epoch runs in calls of
        :meth:`_indexed_call_steps` steps; call ``c`` of epoch ``e`` draws
        from seed ``fold_seed(fold_seed(seed, e), c)``. The last call runs
        only the steps left
        in the epoch (the JAX package pads it to the full call length with
        weight-0 steps, which leave the state as it is), so each epoch's
        metrics have ``plan.steps_per_epoch`` rows. To resume, restore
        from the checkpointer and pass ``start_epoch``: the shuffle and the
        seeds derive from the epoch index.

        ``on_epoch(e, host_metrics)`` runs after each epoch, with the store
        already pointing at the live tables. ``as_numpy=False`` returns the
        metrics as device tensors (no effect with ``on_epoch``).

        ``checkpointer`` with ``checkpoint_every = k``: saved as step
        ``e + 1`` after every ``k``-th epoch and at the end (unless that
        state is already saved), and flushed on every exit path.
        ``rollback``: as in :meth:`fit_stream`, an epoch at a time.

        Telemetry: ``recorder`` (default ``self.recorder``) times each
        epoch's phases (``dispatch``, ``host_sync``, ``checkpoint``,
        ``callback``; no ``ingest`` or ``place``, the batches are built on
        the device) and journals ``epoch`` events; ``health`` and
        ``watchdog`` act as in :meth:`fit_stream`, an epoch at a time, and
        like ``rollback`` read every epoch's metrics as it ends.

        Returns ``(tables, local_state, per-epoch metrics list)``.

        Raises:
          ValueError: ``plan.sync_every`` differs from the config, or a
            rollback policy or a HealthMonitor without a guard.
          TypeError: ``health`` that is not a HealthMonitor.
        """
        self._check_rollback(rollback)
        self._check_health(health)
        if (self.config.sync_every or None) != (plan.sync_every or None):
            raise ValueError("plan.sync_every must match TrainerConfig")
        rec = recorder if recorder is not None else self.recorder
        timer = PhaseTimer(rec) if rec is not None else None
        hb = _find_heartbeat(rec)
        quarantine = (rollback if rollback is not None
                      and resilience.as_guard(self.config.guard) is not None
                      else None)
        sync_each = (quarantine is not None or health is not None
                     or watchdog is not None)
        T = plan.steps_per_epoch
        T_call = self._indexed_call_steps(plan)
        n_calls = -(-T // T_call)
        end_epoch = start_epoch + epochs
        saved_at = None
        self._enter_tiering()
        # The tier's entries at the run's entry; each call keeps them and
        # never packs its cold routes (its batches are on the device).
        tables = self._attach_hot(tables, timer)
        all_metrics = []
        try:
            for e in range(start_epoch, end_epoch):
                if rollback is not None and e in rollback.preset:
                    rollback.skip(e)
                    if rec is not None:
                        rec.inc("rollback.preset_skipped")
                        rec.flush()
                    continue
                if quarantine is not None:
                    last_good = (tree_copy(tables), tree_copy(local_state))
                    rt_snap = (self.retierer.snapshot()
                               if self.retierer is not None else None)
                args = plan.epoch_args(e)
                parts = []
                restored = None
                _beat(hb, e, "dispatch")
                with _watch(watchdog, "epoch", e):
                    for c in range(n_calls):
                        # T and T_call are sync_every multiples, so is the
                        # rest.
                        steps = min(T_call, T - c * T_call)
                        # Each step's batch is a view of the call's
                        # batches.
                        batches = plan.call_batches(args, c * T_call, steps)
                        with _phase(timer, "dispatch"):
                            tables, local_state, metrics = (
                                self._audited_call(
                                    "indexed", (plan,),
                                    "indexed/" + self._mode(), tables,
                                    lambda e=e, c=c: self._run_steps(
                                        tables, local_state, batches, steps,
                                        fold_seed(fold_seed(seed, e), c),
                                        c * T_call)))
                        parts.append(metrics)
                    metrics = _tree_stack(parts, torch.cat)
                    if quarantine is not None:
                        with _phase(timer, "host_sync"):
                            metrics, restored = self._maybe_quarantine(
                                quarantine, last_good, metrics, e, "epoch")
                    elif sync_each:
                        with _phase(timer, "host_sync"):
                            metrics = _to_host(metrics)
                ev = {"index": e} if rec is not None else None
                poison = 0
                if sync_each and (rec is not None or health is not None):
                    poison = self._fold_metrics_accounting(rec, metrics, ev)
                if rec is not None:
                    rec.inc("driver.epochs")
                    if restored is not None:
                        rec.inc("rollback.quarantined")
                        ev["quarantined"] = True
                self._apply_health_decision(health, rec, e, poison, "epoch")
                if restored is not None:
                    if rec is not None:
                        rec.event("epoch", phases=timer.chunk_summary(), **ev)
                        rec.flush()
                    if rt_snap is not None:
                        self.retierer.restore_snapshot(rt_snap)
                    tables, local_state = restored
                    continue
                all_metrics.append(metrics)
                # Host reads through the store see the live tables before
                # any callback runs.
                self.store.tables = dict(tables)
                if on_epoch is not None:
                    with _phase(timer, "host_sync"):
                        host = _to_host(metrics)
                    if rec is not None and not sync_each:
                        # on_epoch paid the host read: the same accounting
                        # as the forced reads.
                        self._fold_metrics_accounting(rec, host, ev)
                    all_metrics[-1] = host
                    with _phase(timer, "callback"):
                        on_epoch(e, host)
                if (checkpointer is not None and checkpoint_every > 0
                        and (e + 1) % checkpoint_every == 0):
                    with _phase(timer, "checkpoint"):
                        self._save_checkpoint(checkpointer, e + 1,
                                              local_state)
                    saved_at = e + 1
                if rec is not None:
                    # After the callback and checkpoint phases, so the
                    # event's breakdown covers the whole epoch.
                    rec.event("epoch", phases=timer.chunk_summary(), **ev)
                    rec.flush()
                if self.retierer is not None:
                    # The adaptive tier's boundary: fold the epoch's
                    # windows, maybe re-rank or plan.
                    with _phase(timer, "retier"):
                        tables = self.retierer.on_boundary(
                            self, tables, e, recorder=rec)
                    self.store.tables = dict(tables)
            self.store.tables = dict(tables)
            if (checkpointer is not None and epochs > 0
                    and saved_at != end_epoch):
                with _phase(timer, "checkpoint"):
                    self._save_checkpoint(checkpointer, end_epoch,
                                          local_state)
        finally:
            if checkpointer is not None:
                with _phase(timer, "checkpoint"):
                    checkpointer.flush()
        if on_epoch is None and as_numpy:
            with _phase(timer, "host_sync"):
                all_metrics = [_to_host(m) for m in all_metrics]
            if rec is not None and not sync_each:
                # A run read only at its end still gets its whole-run
                # health totals and example counts.
                for m in all_metrics:
                    self._fold_metrics_accounting(rec, m)
        if rec is not None:
            rec.flush()
        return tables, local_state, all_metrics

    # -- megasteps ----------------------------------------------------------

    def run_megastep(self, tables, local_state, plan, seed: int, *,
                     epochs: int = 1, chunks_per_dispatch=4,
                     on_megastep=None, checkpointer=None,
                     checkpoint_every: int = 0, start_megastep: int = 0,
                     as_numpy: bool = True, rollback=None, recorder=None,
                     health=None, watchdog=None, tick=None):
        """Run ``epochs`` passes over a device plan in megasteps of
        ``chunks_per_dispatch`` chunk segments (an int >= 1 or ``"auto"``),
        one Python dispatch each: the per-chunk :meth:`run_indexed` loop
        (``max_steps_per_call`` steps a chunk) bit for bit, in tables,
        metrics and checkpoints, with no host read between the segments but
        the overflow vote of the ``cold_budget`` lanes, once a group. A
        :class:`~fps_tpu_torch.tiering.MegastepTick` (``tick``) re-ranks the
        mapped tier on the device every ``tick.check_every`` segments;
        without it, no retierer may be attached (the tick is the boundary).
        The JAX package's parameters, in its order (``key`` is ``seed``);
        see :func:`fps_tpu_torch.core.megastep.run_megastep`."""
        from fps_tpu_torch.core import megastep as _megastep

        return _megastep.run_megastep(
            self, tables, local_state, plan, seed, epochs=epochs,
            chunks_per_dispatch=chunks_per_dispatch,
            on_megastep=on_megastep, checkpointer=checkpointer,
            checkpoint_every=checkpoint_every,
            start_megastep=start_megastep, as_numpy=as_numpy,
            rollback=rollback, recorder=recorder, health=health,
            watchdog=watchdog, tick=tick)

    def lowered_megastep_text(self, plan, *, chunks_per_dispatch: int,
                              mode: str = "sync", tick=None) -> str:
        """The record's text of the exact megastep :meth:`run_megastep`
        dispatches: one dispatch of ``chunks_per_dispatch`` segments from
        the start of epoch 0, on fresh state (``init_state(0)``), seed 1,
        ``tick`` attached as the retierer for it, the vote on where the
        run would vote. The cadence is checked as :meth:`run_megastep`
        checks it. Leaves the trainer as it was found, like
        :meth:`lowered_chunk_text`."""
        from fps_tpu_torch.core import megastep as _megastep

        if tick is not None and chunks_per_dispatch % tick.check_every:
            raise ValueError(
                f"chunks_per_dispatch={chunks_per_dispatch} must be a "
                f"multiple of tick.check_every={tick.check_every}")
        self._check_mode(mode)
        saved = self._lowering_state()
        try:
            if tick is not None and self.retierer is None:
                self.retierer = tick
            tables, ls = self.init_state(0)
            tables = self._attach_hot(tables)
            lanes = None
            if (self._cold_compact_map()
                    and _megastep.vote_certifiable_tables(self, plan)):
                lanes = dict(self._cold_compact_map())
            tick_ops = tick.tick_ops(self) if tick is not None else None
            _, prog = self._record_call(
                "megastep/" + mode, tables, lambda: _megastep.dispatch(
                    self, tables, ls, plan, plan.epoch_args(0),
                    fold_seed(1, 0), 0, int(chunks_per_dispatch),
                    lanes=lanes, tick=tick, tick_ops=tick_ops))
            return prog.to_text()
        finally:
            self._restore_lowering_state(saved)


@dataclasses.dataclass
class _Tier:
    """One call's hot-tier state, this process's positions' lists:
    ``heads`` ``{table: H}``, ``compact`` ``{table: lane}`` (the compacted
    tables of a certified chunk), each tiered table's ``replicas`` and
    pending ``deltas``, each hot fold's state slices (``folds``), and each
    mapped table's slot maps (``maps``) and hot id arrays (``gids``)."""

    heads: dict
    compact: dict
    replicas: dict
    deltas: dict
    folds: dict
    maps: dict
    gids: dict


@dataclasses.dataclass
class _Track:
    """One call's tracker: each tracked table's count-min spec and its
    window a position of this process."""

    specs: dict
    windows: dict


def merge_windows(mesh: PSMesh, incoming, windows) -> Blocks:
    """The end of a call's tracking: every position's window summed over
    the shard axis, then the data axis (fixed-order folds), added to the
    incoming replicated window; every position gets the same bits."""
    merged = collectives.psum(mesh, collectives.psum(
        mesh, list(windows), SHARD_AXIS), DATA_AXIS)
    return Blocks([inc + m for inc, m in zip(incoming, merged)],
                  replicas=len(mesh.slot), mesh=mesh)


def _tree_map(fn, tree):
    """``fn`` over the leaves of nested dicts, tuples and lists: tensors and
    :class:`Blocks`."""
    if isinstance(tree, Blocks):
        return fn(tree)
    if isinstance(tree, Mapping):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return fn(tree)


def _tree_stack(trees: list, join):
    """One tree of the same structure as each of ``trees``, each leaf
    ``join`` (``torch.stack`` or ``torch.cat``) of theirs."""
    first = trees[0]
    if isinstance(first, Mapping):
        return {k: _tree_stack([t[k] for t in trees], join) for k in first}
    if isinstance(first, (tuple, list)):
        return type(first)(_tree_stack(list(z), join)
                           for z in zip(*trees))
    return join(trees)


def _sum_metrics(mesh: PSMesh, outs: list):
    """The workers' step outputs (one tree a worker of this process) as one
    tree, each leaf summed over every worker in the mesh's order
    (:func:`~fps_tpu_torch.parallel.collectives.sum_home_each`; over
    several processes every leaf travels in one exchange)."""
    leaves = []
    _tree_stack(outs, leaves.append)
    sums = iter(collectives.sum_home_each(mesh, leaves))
    return _tree_stack(outs, lambda xs: next(sums))


def _to_host(metrics: Mapping[str, Any]) -> dict[str, Any]:
    return _tree_map(lambda v: v.detach().cpu().numpy()
                     if isinstance(v, Tensor) else v, metrics)
