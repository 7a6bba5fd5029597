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
controller): worker ``w`` takes columns ``[w * B, (w + 1) * B)`` of each
``(steps, W * B)`` batch, draws from ``fold_seed(seed, w)`` and holds its
block of the local state; every worker pulls as the step begins, then one
collective push a table lands all the workers' deltas
(:mod:`fps_tpu_torch.core.store`), and the metrics are summed over the
shards, then over the data replicas. Tables and local-state leaves are
:class:`~fps_tpu_torch.parallel.mesh.Blocks`, one block a position. A
one-position mesh runs the same code with ``W = 1``.

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

Not ported, and refused with ``NotImplementedError`` naming the ROADMAP.md
Queue 1 item that ports each: ``guard`` (item 8), ``hot_sync_every``
(item 7b), ``auto_tier`` (item 7c); checkpoint hooks and rollback (item 8),
telemetry and supervision (item 9).
"""

from __future__ import annotations

import collections
import dataclasses
import warnings
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.api import ServerLogic, WorkerLogic
from fps_tpu_torch.core.prefetch import (
    ChunkPrefetcher,
    PlacedChunk,
    place_columns,
    placed_batches,
)
from fps_tpu_torch.core.rng import fold_seed
from fps_tpu_torch.core.store import (
    ParamStore,
    id_to_phys,
    pull,
    push,
    rows_per_shard,
)
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    Blocks,
    PSMesh,
    num_workers_of,
)

Tensor = torch.Tensor

__all__ = ["TrainerConfig", "Trainer", "num_workers_of"]


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
    is 0 or 1; it acts only where rollback, a health monitor or a watchdog
    forces a host sync after every chunk, none of which is ported, so both
    values run the same loop. ``metrics_drain_every``: without ``on_chunk``,
    ``fit_stream`` moves the buffered metrics to the host every this many
    chunks (0: at the end only).

    ``max_steps_per_call`` bounds the steps of one call of
    :meth:`Trainer.run_indexed` (rounded to whole SSP rounds); each call
    draws from its own seed, as the JAX package's calls draw from their own
    key. ``run_chunk`` does not read it.

    ``guard`` (ROADMAP.md Queue 1 item 8), ``hot_sync_every`` (item 7b) and
    ``auto_tier`` (item 7c) are not ported; any value but the default
    raises ``NotImplementedError``.
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
        unported = {
            "guard": (self.guard is not None, "item 8, slice E: durability"),
            "hot_sync_every": (self.hot_sync_every != 1,
                               "item 7b, slice D: the hot tier"),
            "auto_tier": (bool(self.auto_tier),
                          "item 7c, slice D: adaptive tiering")}
        for field, (set_, where) in unported.items():
            if set_:
                raise NotImplementedError(
                    f"TrainerConfig.{field}={getattr(self, field)!r} is not "
                    f"ported yet (ROADMAP.md Queue 1 {where})")
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
                 config: TrainerConfig | None = None):
        self.mesh = mesh
        self.device = mesh.device
        self.store = param_store
        self.logic = worker_logic
        if isinstance(server_logic, ServerLogic):
            server_logic = {name: server_logic for name in param_store.specs}
        self.server_logic = dict(server_logic)
        self.config = config or TrainerConfig()
        self.num_shards = mesh.shape[SHARD_AXIS]
        self.num_workers = num_workers_of(mesh)

    # -- state ------------------------------------------------------------

    def init_state(self, seed: int) -> tuple[dict[str, Blocks], Any]:
        """Tables and worker-local state, made from ``seed``: each table
        :class:`~fps_tpu_torch.parallel.mesh.Blocks` of the mesh's
        positions, each local-state leaf the ``Blocks`` of the workers'
        rows of the global leaf that ``init_local_state`` makes (the JAX
        package shards it over the workers on axis 0)."""
        tables = self.store.init(fold_seed(seed, 0))
        local_state = self.logic.init_local_state(
            fold_seed(seed, 1), self.num_workers, self.device)
        return tables, _tree_map(self._worker_blocks, local_state)

    def _worker_blocks(self, leaf) -> Blocks:
        """A local-state leaf as the workers' blocks: a global tensor is cut
        into ``W`` equal pieces on axis 0."""
        if isinstance(leaf, Blocks):
            return leaf
        return Blocks(collectives.scatter_workers(self.mesh, leaf))

    def _worker_states(self, local_state) -> list:
        """Each worker's local state (its block of every leaf)."""
        blocks = _tree_map(self._worker_blocks, local_state)
        return [_tree_map(lambda b, w=w: b[w], blocks)
                for w in range(self.num_workers)]

    def _worker_batches(self, batches: Mapping[str, Tensor]) -> list[dict]:
        """Each worker's columns of a call's batches: ``(steps, W * B, ...)``
        columns cut on axis 1, worker ``w`` taking ``[w * B, (w + 1) * B)``,
        on its device."""
        cut = {k: collectives.scatter_workers(self.mesh, v, 1)
               for k, v in batches.items()}
        return [{k: v[w] for k, v in cut.items()}
                for w in range(self.num_workers)]

    # -- one step ---------------------------------------------------------

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

    def _compute_step(self, tables, snapshot, states, batches, keys):
        """Every worker's step: pull (from the live tables, or the SSP
        ``snapshot`` when given) and run the worker step; return the
        workers' pushes unapplied, the head-prefix guarantee for them, the
        new local states and the step's outputs (one a worker)."""
        W = self.num_workers
        batches = [self.logic.prepare(b, k) for b, k in zip(batches, keys)]
        hp = self._head_prefix(batches[0])
        ids = [self.logic.pull_ids(b) for b in batches]
        pulled = [{} for _ in range(W)]
        for name in ids[0]:
            tids = [i[name] for i in ids]
            route = dict(hot_rows=self._hot_rows(name),
                         head_prefix=hp.get(name, 0))
            if snapshot is None:
                vals = pull(tables[name], tids, num_shards=self.num_shards,
                            dense=self._dense(name), **route)
            else:
                rps = tables[name][0].shape[0]
                # -1 padding stays -1 (a zero row): the floor-mod of
                # id_to_phys would wrap it onto a live row for S > 1.
                # On one shard phys == ids, so the head guarantee holds.
                vals = [ops.gather_rows(
                    snap, torch.where(t >= 0, id_to_phys(
                        t, self.num_shards, rps), -1), **route)
                    for snap, t in zip(snapshot[name], tids)]
            for w in range(W):
                pulled[w][name] = vals[w]
        outs = [self.logic.step(b, p, s, k)
                for b, p, s, k in zip(batches, pulled, states, keys)]
        return ([o.pushes for o in outs], hp, [o.local_state for o in outs],
                [o.out for o in outs])

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
                dense=self._dense(name), inplace=self.config.donate)
        return new_tables

    def _run_tap(self, out, tables, batches, states, t: int):
        """``out`` with the step tap's outputs under ``"tap"``: the tap runs
        on each worker's blocks, raw batch and local state (a collective tap:
        once, on all of them), and its leaves gain the worker axis ``W`` on
        the home device."""
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
            tapped = [tap({name: tb[w] for name, tb in tables.items()}, b, s,
                          t)
                      for w, (b, s) in enumerate(zip(batches, states))]
        return dict(out, tap=_tree_stack(tapped, lambda xs: torch.stack(
            collectives.gather_home(self.mesh, xs))))

    def _step(self, tables, snapshot, states, batches, keys, t, outs,
              in_flight):
        pushes, hp, states, out = self._compute_step(
            tables, snapshot, states, batches, keys)
        # This step's pushes go in flight, with the head-prefix guarantee of
        # the batch that made them; the pushes of push_delay steps ago land
        # (at push_delay = 0, this step's own).
        in_flight.append((pushes, hp))
        while len(in_flight) > self.config.push_delay:
            tables = self._apply_pushes(tables, *in_flight.popleft())
        # Metrics summed over the shards, then the data replicas.
        out = _tree_stack(out, lambda xs: collectives.sum_home(self.mesh, xs))
        outs.append(self._run_tap(out, tables, batches, states, t))
        return tables, states

    def _run_steps(self, tables, local_state, batches, num_steps: int,
                   seed: int, t0: int = 0):
        """Run ``num_steps`` steps over ``batches`` (columns with leading
        dims ``(num_steps, W * B)``, on the home device); the step tap sees
        step ``i`` as step ``t0 + i``. Sync: one step after the other. SSP:
        rounds of ``sync_every`` steps, each round's pulls from a snapshot
        of the tables (each position's all-gathered physical table) taken
        as the round begins. Worker ``w`` draws from one ``torch.Generator``
        seeded by ``fold_seed(seed, w)``, or, when it is ``step_seeded``,
        from step ``i``'s seed ``fold_seed(fold_seed(seed, w), i)``.
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
        """
        mesh = self.mesh
        tables = {name: list(tb) for name, tb in tables.items()}
        states = self._worker_states(local_state)
        per_worker = self._worker_batches(batches)
        seeds = [fold_seed(seed, w) for w in range(self.num_workers)]
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
            for i in range(num_steps):
                tables, states = self._step(
                    tables, None, states, batch_at(i), key(i), t0 + i,
                    outs, in_flight)
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
                        t0 + j, outs, in_flight)
        while in_flight:  # the end of the call: deliver what is in flight
            tables = self._apply_pushes(tables, *in_flight.popleft())
        D = mesh.shape[DATA_AXIS]
        tables = {name: Blocks(tb, replicas=D) for name, tb in tables.items()}
        local_state = _tree_stack(states, Blocks)
        return tables, local_state, _tree_stack(outs, torch.stack)

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
            batch, worker-major. Tensors already on the trainer's device
            (:func:`~fps_tpu_torch.core.device_ingest.device_epoch_chunks`)
            are used as they are, with no copy. A
            :class:`~fps_tpu_torch.core.prefetch.PlacedChunk` (the
            pipeline's) is already placed: its copies are waited for on the
            current stream, not made again.
          seed: seed of this chunk's ``torch.Generator`` (for ``prepare`` /
            ``step`` draws, e.g. negative sampling).
          timer, recorder: the JAX package's phase timer and recorder
            (telemetry, ROADMAP.md Queue 1 item 9); not ported, any value
            but ``None`` raises ``NotImplementedError``.

        Returns:
          ``(tables, local_state, metrics)``: metrics is a dict of ``(T,)``
          tensors on the device, one entry per step, summed over workers.
        """
        _refuse("run_chunk", timer=(timer, "item 9, slice F"),
                recorder=(recorder, "item 9, slice F"))
        if not isinstance(batches, PlacedChunk):
            batches = self._place_chunk(batches)
        batches = placed_batches(batches, self.device)
        lead = next(iter(batches.values())).shape
        if self.config.sync_every is None:
            steps = lead[0]
        else:
            if lead[1] != self.config.sync_every:
                raise ValueError(
                    f"SSP chunk rounds of {lead[1]} steps, config "
                    f"sync_every={self.config.sync_every}")
            steps = lead[0] * lead[1]
            batches = {k: v.reshape((steps,) + v.shape[2:])
                       for k, v in batches.items()}
        tables, local_state, metrics = self._run_steps(
            tables, local_state, batches, steps, seed)
        # Keep the store's host reads (lookup_host / dump_model) on the
        # live tensors.
        self.store.tables = dict(tables)
        return tables, local_state, metrics

    def _place_chunk(self, batches) -> PlacedChunk:
        """Place one chunk's columns on the trainer's device: the placement
        that :meth:`run_chunk` and the pipeline's worker thread both run, so
        prefetch on and off give the same device inputs by construction
        (:func:`~fps_tpu_torch.core.prefetch.place_columns`)."""
        return place_columns(batches, self.device)

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

        With ``TrainerConfig.prefetch > 0`` the chunks are assembled and
        placed on a worker thread, ``prefetch`` chunks ahead
        (:class:`~fps_tpu_torch.core.prefetch.ChunkPrefetcher`); the worker
        is joined on every exit path, and an error in the source or in a
        copy re-raises here at its chunk's position.

        Returns:
          ``(tables, local_state, metrics)``: the per-chunk host metrics
          list, or ``metrics_reduce(list)`` when given.

        Raises:
          NotImplementedError: ``checkpointer`` / ``checkpoint_every`` /
            ``rollback`` (durability, ROADMAP.md Queue 1 item 8) or
            ``recorder`` / ``health`` / ``watchdog`` (telemetry and
            supervision, item 9).
          ValueError: ``prefetch`` or ``metrics_drain_every`` below 0, or
            ``health_lag`` other than 0 and 1.
        """
        _refuse("fit_stream", checkpointer=(checkpointer, "item 8, slice E"),
                checkpoint_every=(checkpoint_every or None, "item 8, slice E"),
                rollback=(rollback, "item 8, slice E"),
                recorder=(recorder, "item 9, slice F"),
                health=(health, "item 9, slice F"),
                watchdog=(watchdog, "item 9, slice F"))
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
        it = iter(chunks)
        pf = None
        if cfg.prefetch:
            it = pf = ChunkPrefetcher(
                it, self._place_chunk, depth=cfg.prefetch,
                max_depth=cfg.prefetch_max or None, start_index=start_step,
                device=self.device)
        all_metrics = []
        de = cfg.metrics_drain_every
        try:
            for j, chunk in enumerate(it, start_step):
                tables, local_state, metrics = self.run_chunk(
                    tables, local_state, chunk, fold_seed(seed, j))
                if on_chunk is not None:
                    metrics = _to_host(metrics)
                    all_metrics.append(metrics)
                    on_chunk(j, metrics)
                    continue
                # An unbounded stream must not pile up device buffers.
                all_metrics.append(metrics)
                if de and (j - start_step) % de == de - 1:
                    all_metrics[-de:] = [_to_host(m)
                                         for m in all_metrics[-de:]]
        finally:
            if pf is not None:
                pf.close()
        all_metrics = [_to_host(m) for m in all_metrics]
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
        ``call_batches(args, start, steps)``: the batches of a call's steps,
        one device tensor a column with a leading step axis, built on the
        device (no host copy). Each epoch runs in calls of
        :meth:`_indexed_call_steps` steps; call ``c`` of epoch ``e`` draws
        from seed ``fold_seed(fold_seed(seed, e), c)``. The last call runs
        only the steps left
        in the epoch (the JAX package pads it to the full call length with
        weight-0 steps, which leave the state as it is), so each epoch's
        metrics have ``plan.steps_per_epoch`` rows. To resume, pass
        ``start_epoch``: the
        shuffle and the seeds derive from the epoch index.

        ``on_epoch(e, host_metrics)`` runs after each epoch, with the store
        already pointing at the live tables. ``as_numpy=False`` returns the
        metrics as device tensors (no effect with ``on_epoch``).

        Returns ``(tables, local_state, per-epoch metrics list)``.

        Raises:
          NotImplementedError: ``checkpointer`` / ``checkpoint_every`` /
            ``rollback`` (durability, ROADMAP.md Queue 1 item 8) or
            ``recorder`` / ``health`` / ``watchdog`` (telemetry and
            supervision, item 9).
          ValueError: ``plan.sync_every`` differs from the config.
        """
        _refuse("run_indexed", checkpointer=(checkpointer, "item 8, slice E"),
                checkpoint_every=(checkpoint_every or None, "item 8, slice E"),
                rollback=(rollback, "item 8, slice E"),
                recorder=(recorder, "item 9, slice F"),
                health=(health, "item 9, slice F"),
                watchdog=(watchdog, "item 9, slice F"))
        if (self.config.sync_every or None) != (plan.sync_every or None):
            raise ValueError("plan.sync_every must match TrainerConfig")
        T = plan.steps_per_epoch
        T_call = self._indexed_call_steps(plan)
        n_calls = -(-T // T_call)
        all_metrics = []
        for e in range(start_epoch, start_epoch + epochs):
            args = plan.epoch_args(e)
            parts = []
            for c in range(n_calls):
                # T and T_call are sync_every multiples, so is the rest.
                steps = min(T_call, T - c * T_call)
                # Each step's batch is a view of the call's batches.
                batches = plan.call_batches(args, c * T_call, steps)
                tables, local_state, metrics = self._run_steps(
                    tables, local_state, batches, steps,
                    fold_seed(fold_seed(seed, e), c), c * T_call)
                parts.append(metrics)
            metrics = _tree_stack(parts, torch.cat)
            all_metrics.append(metrics)
            # Host reads through the store see the live tables before any
            # callback runs.
            self.store.tables = dict(tables)
            if on_epoch is not None:
                all_metrics[-1] = _to_host(metrics)
                on_epoch(e, all_metrics[-1])
        self.store.tables = dict(tables)
        if on_epoch is None and as_numpy:
            all_metrics = [_to_host(m) for m in all_metrics]
        return tables, local_state, all_metrics


def _refuse(fn: str, **args) -> None:
    """Raise ``NotImplementedError`` for the first unported argument of
    ``fn`` that was given: ``args`` maps its name to ``(value, item)``,
    ``None`` meaning not given."""
    for name, (value, item) in args.items():
        if value is not None:
            raise NotImplementedError(
                f"{fn}({name}=...) is not ported yet (ROADMAP.md Queue 1 "
                f"{item})")


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


def _to_host(metrics: Mapping[str, Any]) -> dict[str, Any]:
    return _tree_map(lambda v: v.detach().cpu().numpy()
                     if isinstance(v, Tensor) else v, metrics)
