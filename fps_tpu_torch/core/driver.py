"""The training driver: sync and SSP step loops over chunks.

Port of the trainer core of ``fps_tpu/core/driver.py``: ``TrainerConfig``,
``Trainer.init_state``, the step (prepare → pull ids → pull → worker step →
pushes), the synchronous loop and the SSP rounds, ``run_chunk``,
``fit_stream`` and the index-fed ``run_indexed``. Where the JAX package
compiles a chunk (or a slice of an epoch) into one ``lax.scan`` under
``shard_map``, the port runs a Python loop over the steps; each pull and push
launches the port's kernels on the card (CUDA graphs over a chunk are later
work).

* **sync**: every step pulls from the live tables and its pushes land before
  the next step.
* **SSP** (``sync_every=s``): chunks are shaped ``(R, s, B, ...)``; each
  round of ``s`` steps pulls from a snapshot of the tables taken when the
  round starts, while pushes go to the live tables. Worker-local state is
  always live.

* **run_indexed**: epochs over a :class:`~fps_tpu_torch.core.device_ingest.
  DeviceEpochPlan`, whose columns already lie on the device; each call's
  batches are an index-select over them, so no chunk crosses from the host.

Not ported, and rejected when set: ``push_delay``, ``step_tap``, ``guard``
and ``hot_sync_every``; checkpoint hooks, rollback, telemetry, tiering,
prefetch and megastep (ROADMAP.md Queue 1 and slices D-F).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.api import ServerLogic, WorkerLogic
from fps_tpu_torch.core.rng import fold_seed
from fps_tpu_torch.core.store import (
    ParamStore,
    id_to_phys,
    pull,
    push,
    rows_per_shard,
)
from fps_tpu_torch.parallel.mesh import SHARD_AXIS, PSMesh, num_workers_of

Tensor = torch.Tensor

__all__ = ["TrainerConfig", "Trainer", "num_workers_of"]


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Execution-mode knobs.

    ``sync_every``: ``None`` is the synchronous mode; ``s`` is SSP with
    staleness bound ``s``.

    ``donate``: as in the JAX package, the caller hands its tables over to
    the call. Here that means the tables are updated **in place**: the
    tensors passed to :meth:`Trainer.run_chunk` hold the new values
    afterwards. With ``False`` every push makes a new tensor and the
    caller's tables are left as they were.

    ``max_steps_per_call`` bounds the steps of one call of
    :meth:`Trainer.run_indexed` (rounded to whole SSP rounds); each call
    draws from its own seed, as the JAX package's calls draw from their own
    key. ``run_chunk`` does not read it.

    ``push_delay``, ``step_tap``, ``guard`` and ``hot_sync_every`` are not
    ported; any value but the default raises ``NotImplementedError``.
    """

    sync_every: int | None = None
    push_delay: int = 0
    step_tap: Callable[..., Any] | None = None
    guard: Any = None
    donate: bool = True
    hot_sync_every: int = 1
    max_steps_per_call: int | None = None

    def __post_init__(self):
        unported = {"push_delay": self.push_delay != 0,
                    "step_tap": self.step_tap is not None,
                    "guard": self.guard is not None,
                    "hot_sync_every": self.hot_sync_every != 1}
        for field, set_ in unported.items():
            if set_:
                raise NotImplementedError(
                    f"TrainerConfig.{field}={getattr(self, field)!r} is not "
                    "ported yet (ROADMAP.md Queue 1)")
        if self.sync_every is not None and self.sync_every < 1:
            raise ValueError(f"sync_every must be >= 1, got {self.sync_every}")
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

    def init_state(self, seed: int) -> tuple[dict[str, Tensor], Any]:
        """Tables and worker-local state, made from ``seed``."""
        tables = self.store.init(fold_seed(seed, 0))
        local_state = self.logic.init_local_state(
            fold_seed(seed, 1), self.num_workers, self.device)
        return tables, local_state

    # -- one step ---------------------------------------------------------

    def _hot_rows(self, name: str) -> int:
        """Local hot-row count of a table's pull and push (the JAX package's
        ``_resolve_hot_rows``).

        ``hot_ids="auto"`` routes the whole shard through the head kernel K3
        when the shard is at most :func:`fps_tpu_torch.ops.
        packed_crossover_rows` rows (measured on the H100 against K2 with its
        radix sort: a few thousand rows at narrow widths, none past 32
        columns), and resolves to 0 (K2) otherwise. An int is the global head count: global hot ids
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

    def _head_prefix(self, batch) -> dict[str, int]:
        """The worker's head-prefix guarantee for this batch, for tables that
        declare their head (an int ``hot_ids > 0``). The port's mesh is one
        device, where the pull and push streams are the worker's own, so the
        guarantee holds as given."""
        out = {}
        for name, n in self.logic.head_prefix(batch).items():
            spec = self.store.specs.get(name)
            if (spec is not None and isinstance(spec.hot_ids, int)
                    and spec.hot_ids > 0 and n):
                out[name] = int(n)
        return out

    def _compute_step(self, tables, snapshot, local_state, batch, gen):
        """Pull (from the live tables, or the SSP ``snapshot`` when given)
        and run the worker step; return its pushes unapplied, the head-prefix
        guarantee for them, the new local state and the step's outputs."""
        batch = self.logic.prepare(batch, gen)
        hp = self._head_prefix(batch)
        pulled = {}
        for name, tids in self.logic.pull_ids(batch).items():
            route = dict(hot_rows=self._hot_rows(name),
                         head_prefix=hp.get(name, 0))
            if snapshot is None:
                pulled[name] = pull(tables[name], tids,
                                    num_shards=self.num_shards, **route)
            else:
                rps = tables[name].shape[0]
                # -1 padding stays -1 (a zero row): the floor-mod of
                # id_to_phys would wrap it onto a live row for S > 1.
                # On one shard phys == ids, so the head guarantee holds.
                phys = torch.where(
                    tids >= 0, id_to_phys(tids, self.num_shards, rps), -1)
                pulled[name] = ops.gather_rows(snapshot[name], phys, **route)
        out = self.logic.step(batch, pulled, local_state, gen)
        return out.pushes, hp, out.local_state, out.out

    def _apply_pushes(self, tables, pushes, head_prefix):
        new_tables = dict(tables)
        for name, (pids, pdeltas) in pushes.items():
            sl = self.server_logic[name]
            new_tables[name] = push(
                tables[name], pids, pdeltas, num_shards=self.num_shards,
                apply_fn=sl.apply_fn, combine=sl.combine,
                hot_rows=self._hot_rows(name),
                head_prefix=head_prefix.get(name, 0),
                inplace=self.config.donate)
        return new_tables

    def _step(self, tables, snapshot, local_state, batch, gen, outs):
        pushes, hp, local_state, out = self._compute_step(
            tables, snapshot, local_state, batch, gen)
        outs.append(out)
        return self._apply_pushes(tables, pushes, hp), local_state

    def _run_steps(self, tables, local_state, batch_at, num_steps: int,
                   seed: int):
        """Run ``num_steps`` steps; ``batch_at(i)`` is step ``i``'s batch (a
        dict of device tensors). Sync: one step after the other. SSP: rounds
        of ``sync_every`` steps, each round's pulls from a snapshot of the
        tables taken as the round begins. Returns ``(tables, local_state,
        metrics)`` with ``(num_steps,)`` device tensors."""
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_seed(seed, 0))  # worker 0 of the one-device mesh
        outs: list[dict[str, Tensor]] = []
        s = self.config.sync_every
        if s is None:
            for i in range(num_steps):
                tables, local_state = self._step(
                    tables, None, local_state, batch_at(i), gen, outs)
        else:
            for r in range(num_steps // s):
                # The round's reads see the tables as the round begins.
                snapshot = {name: tb.clone() for name, tb in tables.items()}
                for j in range(r * s, (r + 1) * s):
                    tables, local_state = self._step(
                        tables, snapshot, local_state, batch_at(j), gen, outs)
        metrics = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
        return tables, local_state, metrics

    # -- chunks -----------------------------------------------------------

    def run_chunk(self, tables, local_state, batches, seed: int):
        """Run one chunk of steps.

        Args:
          tables: ``{name: tensor}`` (from :meth:`init_state` or the last
            chunk).
          local_state: the worker-local state.
          batches: dict of host arrays (or tensors) with leading dims
            ``(T, B)`` (sync) or ``(R, s, B)`` (SSP); ``B`` is the global
            batch, worker-major. Tensors already on the trainer's device
            (:func:`~fps_tpu_torch.core.device_ingest.device_epoch_chunks`)
            are used as they are, with no copy.
          seed: seed of this chunk's ``torch.Generator`` (for ``prepare`` /
            ``step`` draws, e.g. negative sampling).

        Returns:
          ``(tables, local_state, metrics)``: metrics is a dict of ``(T,)``
          tensors on the device, one entry per step, summed over workers.
        """
        batches = {k: torch.as_tensor(v).to(self.device)
                   for k, v in batches.items()}
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
            tables, local_state, lambda i: {k: v[i] for k, v in
                                            batches.items()}, steps, seed)
        # Keep the store's host reads (lookup_host / dump_model) on the
        # live tensors.
        self.store.tables = dict(tables)
        return tables, local_state, metrics

    def fit_stream(self, tables, local_state, chunks: Iterable[Mapping],
                   seed: int, metrics_reduce=None, on_chunk=None):
        """Run :meth:`run_chunk` over a stream of chunks.

        Chunk ``i`` runs from seed ``fold_seed(seed, i)``. ``on_chunk(i,
        metrics)`` is called after each chunk with its metrics as numpy
        arrays (that waits for the device); without it the metrics stay on
        the device until the stream ends.

        Returns:
          ``(tables, local_state, metrics)``: the per-chunk host metrics
          list, or ``metrics_reduce(list)`` when given.
        """
        all_metrics = []
        for i, chunk in enumerate(chunks):
            tables, local_state, metrics = self.run_chunk(
                tables, local_state, chunk, fold_seed(seed, i))
            if on_chunk is not None:
                metrics = _to_host(metrics)
                on_chunk(i, metrics)
            all_metrics.append(metrics)
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

        ``plan`` is a :class:`~fps_tpu_torch.core.device_ingest.
        DeviceEpochPlan` whose ``sync_every`` matches the trainer's config.
        Each epoch runs in calls of :meth:`_indexed_call_steps` steps; call
        ``c`` of epoch ``e`` draws from seed ``fold_seed(fold_seed(seed, e),
        c)`` and reads its batches straight from the resident columns
        (``plan.call_rows``, then one index-select per column for the
        call's steps; no host copy). The last call runs only the steps left
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
            ``rollback`` (durability, slice E) or ``recorder`` / ``health``
            / ``watchdog`` (telemetry and supervision, slice F).
          ValueError: ``plan.sync_every`` differs from the config.
        """
        unported = {"checkpointer": (checkpointer, "E"),
                    "checkpoint_every": (checkpoint_every or None, "E"),
                    "rollback": (rollback, "E"),
                    "recorder": (recorder, "F"), "health": (health, "F"),
                    "watchdog": (watchdog, "F")}
        for name, (value, slice_) in unported.items():
            if value is not None:
                raise NotImplementedError(
                    f"run_indexed({name}=...) is not ported yet: slice "
                    f"{slice_} (ROADMAP.md, later slices)")
        if (self.config.sync_every or None) != (plan.sync_every or None):
            raise ValueError("plan.sync_every must match TrainerConfig")
        T = plan.steps_per_epoch
        T_call = self._indexed_call_steps(plan)
        n_calls = plan.calls_per_epoch(T_call)
        all_metrics = []
        for e in range(start_epoch, start_epoch + epochs):
            args = plan.epoch_args(e)
            parts = []
            for c in range(n_calls):
                # T and T_call are sync_every multiples, so is the rest.
                steps = min(T_call, T - c * T_call)
                # One index-select per column for the call's steps; each
                # step's batch is a view of it.
                batches = plan.gather(*plan.call_rows(args, c * T_call,
                                                      steps))
                tables, local_state, metrics = self._run_steps(
                    tables, local_state,
                    lambda i, b=batches: {k: v[i] for k, v in b.items()},
                    steps, fold_seed(fold_seed(seed, e), c))
                parts.append(metrics)
            metrics = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
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


def _to_host(metrics: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, Tensor) else v
            for k, v in metrics.items()}
