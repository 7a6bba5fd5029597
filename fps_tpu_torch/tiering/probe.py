"""A pull-and-push probe workload: the store's data plane without a model.

Port of ``fps_tpu/tiering/probe.py``. :class:`ProbeLogic` is the least
:class:`~fps_tpu_torch.core.api.WorkerLogic` whose steps are exactly the
store's: pull ``B`` ids a table and push deltas of the same shape back (a
small fraction of the pulled rows, so every push depends on its pull), with
one scalar out. A trainer over it runs the routes a plan sets and nothing
else: the pulls and pushes, the tier's reconcile, the tracker's windows.
:func:`probe_chunk` makes its host chunks, and :func:`lowered_plan_text`
the record of the per-chunk program a plan runs, for the program auditor
(:mod:`fps_tpu_torch.analysis`) and its collective profile.
"""

from __future__ import annotations

import numpy as np
import torch

from fps_tpu_torch.core.api import StepOutput, WorkerLogic


class ProbeLogic(WorkerLogic):
    """Pull and push over every table of a store. The batch carries one
    ``{name}_ids`` column a table; ``step`` pushes ``-0.001 * pulled``."""

    def __init__(self, table_names):
        self.table_names = tuple(sorted(table_names))

    def pull_ids(self, batch):
        return {name: batch[f"{name}_ids"] for name in self.table_names}

    def step(self, batch, pulled, local_state, key):
        pushes = {name: (batch[f"{name}_ids"], -0.001 * pulled[name])
                  for name in self.table_names}
        n = torch.sum((batch[f"{self.table_names[0]}_ids"] >= 0).to(
            torch.float32))
        return StepOutput(pushes=pushes, local_state=local_state,
                          out={"n": n})


def probe_chunk(table_specs, *, num_workers: int, local_batch: int = 32,
                steps_per_chunk: int = 4, seed: int = 0) -> dict:
    """One host chunk of uniform random ids a table, ``(T, B_global)`` int32
    columns for the sync driver: the JAX package's draws, for the same
    seed."""
    rng = np.random.default_rng(seed)
    B = num_workers * local_batch
    return {
        f"{name}_ids": rng.integers(
            0, spec.num_ids, (steps_per_chunk, B)).astype(np.int32)
        for name, spec in sorted(table_specs.items())
    }


def lowered_plan_text(mesh, specs, plans, *, hot_sync_every: int,
                      retierer=None, local_batch: int = 32,
                      steps_per_chunk: int = 4) -> str:
    """Build a probe trainer with ``plans`` (``{table: TierPlan}``) applied
    over ``specs`` and return the record's text of the exact per-chunk
    program it would run (:meth:`~fps_tpu_torch.core.driver.Trainer.
    lowered_chunk_text`): what ``collective_profile`` measures a plan's
    collective budget from.

    ``retierer``: attach one to record the adaptive (mapped and tracked)
    program instead of the static tier's.
    """
    import dataclasses

    from fps_tpu_torch.core.driver import Trainer, TrainerConfig, num_workers_of
    from fps_tpu_torch.core.store import ParamStore

    planned = {}
    for name, spec in sorted(specs.items()):
        plan = plans.get(name)
        if plan is not None:
            spec = dataclasses.replace(
                spec, hot_tier=plan.hot_tier,
                dense_collectives=plan.dense)
        planned[name] = spec
    store = ParamStore(mesh, planned)
    trainer = Trainer(mesh, store, ProbeLogic(planned),
                      config=TrainerConfig(hot_sync_every=hot_sync_every))
    trainer.retierer = retierer
    chunk = probe_chunk(planned, num_workers=num_workers_of(mesh),
                        local_batch=local_batch,
                        steps_per_chunk=steps_per_chunk)
    return trainer.lowered_chunk_text(chunk, "sync")
