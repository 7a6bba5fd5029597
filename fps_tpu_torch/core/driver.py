"""The training driver: sync and SSP step loops over chunks.

Port of the trainer core of ``fps_tpu/core/driver.py``: ``TrainerConfig``,
``Trainer.init_state``, the step (prepare → pull ids → pull → worker step →
pushes), the synchronous loop and the SSP rounds, ``run_chunk`` and
``fit_stream``. Where the JAX package compiles a chunk into one ``lax.scan``
under ``shard_map``, the port runs a Python loop over the chunk's steps; each
pull and push launches the port's kernels on the card (CUDA graphs over a
chunk are later work).

* **sync**: every step pulls from the live tables and its pushes land before
  the next step.
* **SSP** (``sync_every=s``): chunks are shaped ``(R, s, B, ...)``; each
  round of ``s`` steps pulls from a snapshot of the tables taken when the
  round starts, while pushes go to the live tables. Worker-local state is
  always live.

Not ported, and rejected when set: ``push_delay``, ``step_tap``, ``guard``
and ``hot_sync_every``; checkpoint hooks, rollback, tiering, prefetch,
megastep and ``run_indexed`` (ROADMAP.md Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Iterable, Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.api import ServerLogic, WorkerLogic
from fps_tpu_torch.core.rng import fold_seed
from fps_tpu_torch.core.store import ParamStore, id_to_phys, pull, push
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

    ``max_steps_per_call`` bounds the steps of one call of the JAX package's
    ``run_indexed``; it is carried for that driver, which arrives with
    device-resident ingest, and ``run_chunk`` does not read it.

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
        """Local hot-row count of a table: global head ids ``[0, H)`` sit in
        local rows ``[0, ceil(H / S))`` under the owner-major layout."""
        return -(-self.store.specs[name].hot_ids // self.num_shards)

    def _head_prefix(self, batch) -> dict[str, int]:
        """The worker's head-prefix guarantee for this batch, for tables that
        declare their head (an int ``hot_ids > 0``). The port's mesh is one
        device, where the pull and push streams are the worker's own, so the
        guarantee holds as given."""
        out = {}
        for name, n in self.logic.head_prefix(batch).items():
            spec = self.store.specs.get(name)
            if spec is not None and spec.hot_ids > 0 and n:
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

    # -- chunks -----------------------------------------------------------

    def run_chunk(self, tables, local_state, batches, seed: int):
        """Run one chunk of steps.

        Args:
          tables: ``{name: tensor}`` (from :meth:`init_state` or the last
            chunk).
          local_state: the worker-local state.
          batches: dict of host arrays (or tensors) with leading dims
            ``(T, B)`` (sync) or ``(R, s, B)`` (SSP); ``B`` is the global
            batch, worker-major.
          seed: seed of this chunk's ``torch.Generator`` (for ``prepare`` /
            ``step`` draws, e.g. negative sampling).

        Returns:
          ``(tables, local_state, metrics)``: metrics is a dict of ``(T,)``
          tensors on the device, one entry per step, summed over workers.
        """
        sync = self.config.sync_every is None
        batches = {k: torch.as_tensor(v).to(self.device)
                   for k, v in batches.items()}
        gen = torch.Generator(device=self.device)
        gen.manual_seed(fold_seed(seed, 0))  # worker 0 of the one-device mesh
        outs: list[dict[str, Tensor]] = []
        lead = next(iter(batches.values())).shape
        if sync:
            for t in range(lead[0]):
                tables, local_state = self._step(
                    tables, None, local_state,
                    {k: v[t] for k, v in batches.items()}, gen, outs)
        else:
            if lead[1] != self.config.sync_every:
                raise ValueError(
                    f"SSP chunk rounds of {lead[1]} steps, config "
                    f"sync_every={self.config.sync_every}")
            for r in range(lead[0]):
                # The round's reads see the tables as the round begins.
                snapshot = {name: tb.clone() for name, tb in tables.items()}
                for s in range(lead[1]):
                    tables, local_state = self._step(
                        tables, snapshot, local_state,
                        {k: v[r, s] for k, v in batches.items()}, gen, outs)
        metrics = {k: torch.stack([o[k] for o in outs]) for k in outs[0]}
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


def _to_host(metrics: Mapping[str, Any]) -> dict[str, np.ndarray]:
    return {k: v.detach().cpu().numpy() if isinstance(v, Tensor) else v
            for k, v in metrics.items()}
