"""WorkerLogic combinators: wrappers that decorate a worker without changing
it.

Port of ``fps_tpu/core/combinators.py`` (the reference's ``WorkerLogic``
companion, whose pull limiter the SSP bound ``TrainerConfig.sync_every``
serves in a step loop). What remains useful as wrappers are transformations
of the pushed deltas and of the ``WOut`` outputs:

* :func:`clip_pushes`: per-row L2 clip of pushed deltas;
* :func:`scale_pushes`: constant scaling of pushed deltas (e.g. ``1/W``);
* :func:`tap_outputs`: extra per-step statistics on the out channel (push
  norm, push count) without touching the logic.

A wrapper hands the driver the inner worker's ``step_seeded``, so a worker
that draws from a per-step seed (word2vec) keeps getting one.
"""

from __future__ import annotations

from typing import Callable, Mapping

import torch

from fps_tpu_torch.core.api import StepOutput, WorkerLogic

Tensor = torch.Tensor


class _Wrapped(WorkerLogic):
    """Delegates everything to the inner logic; subclasses override step()."""

    def __init__(self, inner: WorkerLogic):
        self.inner = inner

    @property
    def step_seeded(self) -> bool:
        return self.inner.step_seeded

    def init_local_state(self, seed, num_workers, device):
        return self.inner.init_local_state(seed, num_workers, device)

    def prepare(self, batch, gen):
        return self.inner.prepare(batch, gen)

    def pull_ids(self, batch):
        return self.inner.pull_ids(batch)

    def step(self, batch, pulled, local_state, gen) -> StepOutput:
        return self.inner.step(batch, pulled, local_state, gen)


def _map_pushes(out: StepOutput, fn) -> StepOutput:
    pushes = {name: (ids, fn(name, ids, deltas))
              for name, (ids, deltas) in out.pushes.items()}
    return StepOutput(pushes=pushes, local_state=out.local_state, out=out.out)


def clip_pushes(logic: WorkerLogic, max_norm: float,
                tables: tuple[str, ...] | None = None) -> WorkerLogic:
    """Clip each pushed row to L2 norm ``max_norm`` (per delta row).

    ``tables`` limits clipping to the named tables (default: all).
    """

    class Clipped(_Wrapped):
        def step(self, batch, pulled, local_state, gen):
            out = self.inner.step(batch, pulled, local_state, gen)

            def clip(name, ids, deltas):
                if tables is not None and name not in tables:
                    return deltas
                norm = torch.linalg.vector_norm(
                    deltas.to(torch.float32), dim=-1, keepdim=True)
                scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-12),
                                    max=1.0)
                return deltas * scale.to(deltas.dtype)

            return _map_pushes(out, clip)

    return Clipped(logic)


def scale_pushes(logic: WorkerLogic, scale: float,
                 tables: tuple[str, ...] | None = None) -> WorkerLogic:
    """Multiply pushed deltas by a constant (e.g. ``1 / num_workers``)."""

    class Scaled(_Wrapped):
        def step(self, batch, pulled, local_state, gen):
            out = self.inner.step(batch, pulled, local_state, gen)

            def f(name, ids, deltas):
                if tables is not None and name not in tables:
                    return deltas
                return deltas * torch.tensor(scale, dtype=deltas.dtype,
                                             device=deltas.device)

            return _map_pushes(out, f)

    return Scaled(logic)


def tap_outputs(
    logic: WorkerLogic,
    tap: Callable[[Mapping[str, tuple[Tensor, Tensor]]], Mapping[str, Tensor]]
    | None = None,
) -> WorkerLogic:
    """Augment the ``WOut`` stream with per-step push statistics.

    The default tap adds, per table, ``push_norm/<table>`` (L2 norm of all
    pushed deltas of live ids) and ``push_count/<table>`` (rows actually
    pushed, id >= 0).
    """

    def default_tap(pushes):
        extra = {}
        for name, (ids, deltas) in pushes.items():
            live = (ids >= 0).to(torch.float32)
            extra[f"push_norm/{name}"] = torch.sqrt(torch.sum(
                (deltas.to(torch.float32) ** 2) * live[:, None]))
            extra[f"push_count/{name}"] = torch.sum(live)
        return extra

    tap_fn = tap or default_tap

    class Tapped(_Wrapped):
        def step(self, batch, pulled, local_state, gen):
            out = self.inner.step(batch, pulled, local_state, gen)
            if not isinstance(out.out, Mapping):
                raise TypeError(
                    "tap_outputs requires the wrapped logic's StepOutput.out "
                    f"to be a Mapping (got {type(out.out).__name__}); wrap "
                    "your metrics in a dict or pass a custom tap")
            merged = dict(out.out)
            merged.update(tap_fn(out.pushes))
            return StepOutput(pushes=out.pushes, local_state=out.local_state,
                              out=merged)

    return Tapped(logic)
