"""The user contract: WorkerLogic / ServerLogic, over torch tensors.

Port of ``fps_tpu/core/api.py``. The reference's callback pair (``onRecv`` →
``pull`` → ``onPullRecv``) collapses, as in the JAX package, into one batch
step: :meth:`WorkerLogic.pull_ids` names the rows each table must supply,
and :meth:`WorkerLogic.step` consumes them and returns pushes, the new
worker-local state and the ``WOut`` outputs.

Differences from the JAX package: random draws come from an explicit
``torch.Generator`` handed to :meth:`WorkerLogic.prepare` and
:meth:`WorkerLogic.step` (in place of a ``jax.random`` key), or, for a
worker with ``step_seeded = True``, from an int seed of the step that the
same hash turns into the same bits on every device
(:func:`fps_tpu_torch.core.rng.counter_bits`); initial state is made from an
integer seed on an explicit ``torch.device``. :class:`HotFold` is the hot
tier's stateful server fold (:mod:`fps_tpu_torch.core.store`).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping

import torch

Tensor = torch.Tensor
Pytree = Any


@dataclasses.dataclass
class StepOutput:
    """What one worker step returns.

    Attributes:
      pushes: per-table ``(ids, deltas)``: ids ``(B,)`` int32, deltas
        ``(B, dim)``. Padding rows carry id ``-1``, which the store drops
        even for non-additive server folds.
      local_state: the updated worker-local state.
      out: the reference's ``WOut`` channel: a dict of scalar tensors, summed
        over workers and stacked over steps by the driver.
    """

    pushes: Mapping[str, tuple[Tensor, Tensor]]
    local_state: Pytree
    out: Mapping[str, Tensor]


class WorkerLogic:
    """Base class for worker-side algorithm logic.

    ``step_seeded``: ``False`` (the default) hands :meth:`prepare` and
    :meth:`step` the call's ``torch.Generator``; ``True`` hands them an int,
    the step's own seed (the analog of the JAX package's per-step key), for
    draws that must be the same on the CPU and the card.
    """

    step_seeded = False

    def init_local_state(self, seed: int, num_workers: int,
                         device: torch.device) -> Pytree:
        """Worker-local state, made from ``seed`` on ``device``."""
        return ()

    def prepare(self, batch: Mapping[str, Tensor],
                gen: torch.Generator) -> Mapping[str, Tensor]:
        """Augment the batch before pulling (e.g. sample negative ids from
        ``gen``). Default: identity."""
        return batch

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        """Map table name -> ``(B,)`` int32 ids to pull for this batch."""
        raise NotImplementedError

    def pulled_ids_host(self, chunk) -> Mapping[str, Any] | None:
        """Optional host stream that certifies a chunk for the compacted
        cold routes (``TableSpec.cold_budget``): ``{table: int id array}``
        from the raw host chunk, its last axis the worker-major ids of a
        step (``(T, B, k)`` columns flattened to ``(T, B * k)``), covering
        every id the step pulls or pushes for that table. Padding may carry
        any id; it is counted as the device's compaction sees it. ``None``
        (the default): this logic's chunks cannot be certified, and take
        the static cold routes."""
        return None

    def pulled_ids_traced(self, batch) -> Mapping[str, Tensor] | None:
        """Optional device stream that certifies the megastep's segments for
        the compacted cold routes (its overflow vote,
        :mod:`fps_tpu_torch.core.megastep`), where no host id stream
        exists: ``{table: int id tensor}`` from one worker's raw
        (un-``prepare``-d) batch, covering every id the step pulls or pushes
        for that table. The megastep hands it a worker's batches with a
        leading step axis and counts each step's ids apart; any trailing
        shape is flattened. ``None`` (the default): uncertifiable, and every
        segment takes the static cold routes."""
        return None

    def head_prefix(self, batch) -> Mapping[str, int]:
        """Optional static guarantee: table name -> count of leading ids (in
        both :meth:`pull_ids` order and the step's push order) that lie in
        ``[0, spec.hot_ids) ∪ {-1}``, the frequency head a sorted-slot
        layout (``head_sort_slots``) puts first. The driver turns it into the
        head-prefix route of :mod:`fps_tpu_torch.ops`. Counts are plain ints
        from batch shapes. Default: no guarantee."""
        return {}

    def step(self, batch, pulled: Mapping[str, Tensor], local_state,
             gen: torch.Generator) -> StepOutput:
        """The fused onRecv/onPullRecv body."""
        raise NotImplementedError

    def touched_local_rows(self, batch):
        """Optional: per local-state leaf, the axis-0 rows this batch's
        :meth:`step` can touch (``-1`` = none), or ``None`` for "any row".
        Default: no guarantee."""
        return None

    def export_local_state(self, local_state) -> Pytree:
        """Worker-count-independent host form of the local state. Default:
        the state itself."""
        return local_state

    def import_local_state(self, leaves: list, num_workers: int):
        """Inverse of :meth:`export_local_state` for ``num_workers``
        workers; ``NotImplemented`` (the default) means same-count only."""
        return NotImplemented


@dataclasses.dataclass(frozen=True)
class HotFold:
    """Stateful server fold on the hot tier: Adagrad or Adam state for the
    replicated head, sharded over the shard axis.

    The window's reconcile reduce-scatters the pending deltas, so each
    position of a data replica applies a disjoint slice of the head
    (:func:`fps_tpu_torch.core.store.reconcile_hot`); a ``HotFold`` turns the
    slice's combined delta ``g`` (after the ``combine`` normalization) into
    a scaled step:

    * ``"adagrad"``: ``G += g * g; step = lr * g / (sqrt(G) + eps)``;
    * ``"adam"``: lazy per-row Adam: a row untouched in a window keeps its
      moments and its step count, a touched row updates ``m`` and ``v``
      with bias correction by its own window count ``t``.

    The state is never replicated and never part of the canonical table; at
    a call's end the canonical table already holds the folded steps. It
    needs the tier on with the whole table replicated (``hot_tier >=
    num_ids``; a partial head would give head rows the scaled step and tail
    rows the raw one), which the trainer checks.
    """

    kind: str  # "adagrad" | "adam"
    lr: float = 1.0
    eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999

    def __post_init__(self):
        if self.kind not in ("adagrad", "adam"):
            raise ValueError(
                f"HotFold.kind {self.kind!r}: expected 'adagrad' or 'adam'")

    def state_cols(self, dim: int) -> int:
        """Columns of a row's state: Adagrad keeps ``G``; Adam ``(m, v, t)``
        with the window count as a column."""
        return dim if self.kind == "adagrad" else 2 * dim + 1


def as_hot_fold(fold) -> HotFold | None:
    """The ``ServerLogic.hot_fold`` shorthand made a :class:`HotFold`: a
    string names the kind with the default hyperparameters; ``None`` passes
    through."""
    if fold is None or isinstance(fold, HotFold):
        return fold
    if isinstance(fold, str):
        return HotFold(kind=fold)
    raise TypeError("hot_fold must be a HotFold, a kind string, or None, "
                    f"got {type(fold).__name__}")


@dataclasses.dataclass(frozen=True)
class ServerLogic:
    """Per-table server fold: the reference's ``SimplePSLogic`` plus its
    combining senders.

    ``apply_fn(current_rows, combined_deltas) -> new_rows``; ``None`` is
    plain addition. ``combine`` merges duplicate ids of one push: ``"sum"``,
    ``"mean"``, ``"max"``, ``"min"`` or a callable ``(summed, counts) ->
    combined`` (see :func:`fps_tpu_torch.core.store.push`).

    ``hot_fold`` (a :class:`HotFold` or its kind string) adds Adagrad or
    Adam state to the table's hot tier (see :class:`HotFold` for when it
    may engage).
    """

    apply_fn: Callable[[Tensor, Tensor], Tensor] | None = None
    combine: str | Callable[[Tensor, Tensor], Tensor] = "sum"
    hot_fold: "HotFold | str | None" = None

    def __post_init__(self):
        if not callable(self.combine) and self.combine not in (
                "sum", "mean", "max", "min"):
            raise ValueError(f"unknown combine mode {self.combine!r}")
        as_hot_fold(self.hot_fold)  # TypeError / ValueError on a bad fold


ADDITIVE = ServerLogic(apply_fn=None)
MEAN_COMBINE = ServerLogic(apply_fn=None, combine="mean")
