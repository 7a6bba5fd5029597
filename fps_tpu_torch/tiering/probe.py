"""A pull-and-push probe workload: the store's data plane without a model.

Port of ``fps_tpu/tiering/probe.py``. :class:`ProbeLogic` is the least
:class:`~fps_tpu_torch.core.api.WorkerLogic` whose steps are exactly the
store's: pull ``B`` ids a table and push deltas of the same shape back (a
small fraction of the pulled rows, so every push depends on its pull), with
one scalar out. A trainer over it runs the routes a plan sets and nothing
else: the pulls and pushes, the tier's reconcile, the tracker's windows.
:func:`probe_chunk` makes its host chunks. (The JAX package's
``lowered_plan_text``, the lowered program's text for the program auditor,
is ROADMAP.md Queue 1 item 10.)
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


def lowered_plan_text(*args, **kwargs) -> str:
    """The JAX package's lowered program of a plan: the program auditor's
    input, not ported (ROADMAP.md Queue 1 item 10, slice G)."""
    raise NotImplementedError(
        "lowered_plan_text is not ported yet (ROADMAP.md Queue 1 item 10, "
        "slice G: the program auditor)")
