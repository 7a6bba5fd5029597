"""Passive-aggressive classifier (binary and multiclass) on the port.

Port of ``fps_tpu/models/passive_aggressive.py``. The model is a weight
vector (binary: an ``(NF, 1)`` table) or per-class weight vectors
(multiclass: ``(NF, C)``), keyed by feature id. A batch of sparse examples
pulls the rows of all its features in one gather, computes every margin and
closed-form step size densely, and pushes all per-feature deltas in one
scatter-add (mini-batch PA: updates within a batch see the same pulled
weights). On the card the binary model's pulls and pushes run on the scalar
kernels K5 and K4, the multiclass model's on K1 and K2 (and K3 for the
write-hot head with ``hot_features``).

Closed-form step sizes (Crammer et al. 2006), hinge loss
``l = max(0, 1 - y * m)``:

* PA    : tau = l / ||x||^2
* PA-I  : tau = min(C, l / ||x||^2)
* PA-II : tau = l / (||x||^2 + 1/(2C))
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from fps_tpu_torch.core.api import StepOutput, WorkerLogic
from fps_tpu_torch.core.store import ParamStore, TableSpec

Tensor = torch.Tensor

WEIGHT_TABLE = "weights"


@dataclasses.dataclass
class PAConfig:
    """``batch_average=True`` (default) scales each example's PA step by
    1/local_batch: each worker applies the average of its batch's
    closed-form steps. ``batch_average=False`` sums them raw (safe for PA-I
    with small C or tiny batches).

    ``hot_features = H`` with ``head_prefix_cols = q`` is the head-prefix
    route of the binary model: lay the dataset out with
    ``fps_tpu_torch.utils.datasets.head_sort_slots(data, H)``, whose ``q`` is
    the number of leading slot columns guaranteed to carry ids in
    ``[0, H)``; the worker then flattens ids nnz-major so that those ``q * B``
    leading ids read and write through the head view ``table[:H]``. A
    routing hint: the results are those of the plain layout, up to the order
    of float32 sums. ``hot_features`` without ``head_prefix_cols`` marks the
    write-hot head all the same: on the multiclass ``(NF, C)`` table the
    push takes the hot/cold split (kernel K3 for the head, K2 for the tail);
    on the binary ``(NF, 1)`` table it stays on K4.
    """

    num_features: int
    num_classes: int = 2  # 2 => binary (single weight vector)
    variant: str = "PA-I"  # "PA" | "PA-I" | "PA-II"
    C: float = 1.0
    batch_average: bool = True
    hot_features: int = 0
    head_prefix_cols: int = 0
    dtype: torch.dtype = torch.float32

    @property
    def table_dim(self) -> int:
        return 1 if self.num_classes == 2 else self.num_classes


def _tau(variant: str, C: float, loss: Tensor, x2: Tensor) -> Tensor:
    x2 = torch.clamp(x2, min=1e-12)
    if variant == "PA":
        return loss / x2
    if variant == "PA-I":
        return torch.clamp(loss / x2, max=C)
    if variant == "PA-II":
        return loss / (x2 + 1.0 / (2.0 * C))
    raise ValueError(f"unknown PA variant {variant!r}")


def _outputs(mistakes: Tensor, loss: Tensor, w: Tensor) -> dict:
    return {"mistakes": mistakes.to(torch.float32),
            "loss": torch.sum(loss * w).to(torch.float32),
            "n": torch.sum(w).to(torch.float32)}


class PassiveAggressiveWorker(WorkerLogic):
    """Binary PA: batch of sparse examples, one gather, one scatter-add.

    Batch columns: ``feat_ids (B, nnz)`` int32 (pad slots may hold any id as
    long as ``feat_vals`` is 0 there), ``feat_vals (B, nnz)``, ``label (B,)``
    in {-1, +1}, ``weight (B,)``.
    """

    def __init__(self, cfg: PAConfig):
        if cfg.num_classes != 2:
            raise ValueError("use MulticlassPassiveAggressiveWorker")
        self.cfg = cfg

    def _flatten(self, a: Tensor) -> Tensor:
        """(B, nnz[, ...]) -> (B*nnz[, ...]): nnz-major when head-prefix
        routing is on (so the head-sorted leading columns become the leading
        flat entries), row-major otherwise."""
        if self.cfg.head_prefix_cols:
            a = a.transpose(0, 1)
        return a.reshape((-1,) + tuple(a.shape[2:]))

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        return {WEIGHT_TABLE: self._flatten(
            batch["feat_ids"].to(torch.int32))}

    def head_prefix(self, batch) -> Mapping[str, int]:
        q = self.cfg.head_prefix_cols
        if not q:
            return {}
        B, nnz = batch["feat_ids"].shape
        return {WEIGHT_TABLE: min(q, nnz) * B}

    def step(self, batch, pulled, local_state, gen) -> StepOutput:
        cfg = self.cfg
        B, nnz = batch["feat_ids"].shape
        x = batch["feat_vals"].to(cfg.dtype)  # (B, nnz)
        y = batch["label"].to(cfg.dtype)  # (B,)
        w = batch["weight"].to(cfg.dtype)  # (B,)

        if cfg.head_prefix_cols:  # nnz-major pull order (see _flatten)
            wrows = pulled[WEIGHT_TABLE].reshape(nnz, B).T
        else:
            wrows = pulled[WEIGHT_TABLE].reshape(B, nnz)
        margin = torch.sum(wrows * x, -1)
        loss = torch.clamp(1.0 - y * margin, min=0.0)
        x2 = torch.sum(x * x, -1)
        tau = _tau(cfg.variant, cfg.C, loss, x2) * w  # zero for padding
        if cfg.batch_average:
            tau = tau / torch.clamp(torch.sum(w), min=1.0)

        # Per-feature delta: tau * y * x_f; dropped slots push id -1.
        deltas = (tau * y)[:, None] * x  # (B, nnz)
        active = (x != 0.0) & (w[:, None] > 0)
        push_ids = torch.where(active, batch["feat_ids"].to(torch.int32), -1)

        mistakes = torch.sum(w * (torch.sign(margin) != y))
        pushes = {WEIGHT_TABLE: (self._flatten(push_ids),
                                 self._flatten(deltas)[:, None])}
        return StepOutput(pushes=pushes, local_state=local_state,
                          out=_outputs(mistakes, loss, w))


class MulticlassPassiveAggressiveWorker(WorkerLogic):
    """Multiclass PA: per-class weight columns, max-margin violation update.

    For true class r and highest-scoring wrong class s:
    ``l = max(0, 1 - (score_r - score_s))``, tau per variant with ||x||^2
    doubled (the update touches two class columns), push ``+tau * x`` to
    column r and ``-tau * x`` to column s.
    """

    def __init__(self, cfg: PAConfig):
        if cfg.num_classes < 3:
            raise ValueError("use PassiveAggressiveWorker for binary")
        if cfg.head_prefix_cols:
            raise ValueError(
                "head_prefix_cols is binary-only (the multiclass table is not "
                "a scalar table; no head-prefix route exists for it)")
        self.cfg = cfg

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        return {WEIGHT_TABLE: batch["feat_ids"].to(torch.int32).reshape(-1)}

    def step(self, batch, pulled, local_state, gen) -> StepOutput:
        cfg = self.cfg
        B, nnz = batch["feat_ids"].shape
        C = cfg.num_classes
        x = batch["feat_vals"].to(cfg.dtype)  # (B, nnz)
        r = batch["label"].to(torch.int64)  # (B,) class index
        w = batch["weight"].to(cfg.dtype)

        wrows = pulled[WEIGHT_TABLE].reshape(B, nnz, C)
        scores = torch.einsum("bn,bnc->bc", x, wrows)  # (B, C)
        r_onehot = torch.nn.functional.one_hot(r, C).to(cfg.dtype)
        score_r = torch.sum(scores * r_onehot, -1)
        masked = torch.where(r_onehot > 0, -torch.inf, scores)
        s = torch.argmax(masked, -1)  # ties: the first class, as in JAX
        score_s = torch.amax(masked, -1)

        loss = torch.clamp(1.0 - (score_r - score_s), min=0.0)
        x2 = 2.0 * torch.sum(x * x, -1)
        tau = _tau(cfg.variant, cfg.C, loss, x2) * w
        if cfg.batch_average:
            tau = tau / torch.clamp(torch.sum(w), min=1.0)

        s_onehot = torch.nn.functional.one_hot(s, C).to(cfg.dtype)
        class_dir = r_onehot - s_onehot  # (B, C)
        # delta[b, f, c] = tau_b * x_bf * class_dir_bc
        deltas = tau[:, None, None] * x[:, :, None] * class_dir[:, None, :]

        active = (x != 0.0) & (w[:, None] > 0)
        push_ids = torch.where(active, batch["feat_ids"].to(torch.int32), -1)

        mistakes = torch.sum(w * (torch.argmax(scores, -1) != r))
        pushes = {WEIGHT_TABLE: (push_ids.reshape(-1),
                                 deltas.reshape(-1, C))}
        return StepOutput(pushes=pushes, local_state=local_state,
                          out=_outputs(mistakes, loss, w))


def make_store(mesh, cfg: PAConfig) -> ParamStore:
    spec = TableSpec(
        name=WEIGHT_TABLE,
        num_ids=cfg.num_features,
        dim=cfg.table_dim,
        dtype=cfg.dtype,
        hot_ids=min(cfg.hot_features, cfg.num_features),
    ).zeros_init()  # reference: paramInit = 0.0 per feature
    return ParamStore(mesh, [spec])


def passive_aggressive(mesh, cfg: PAConfig, *, sync_every: int | None = None,
                       donate: bool = True,
                       max_steps_per_call: int | None = None, guard=None):
    """(trainer, store): the analog of
    ``PassiveAggressiveParameterServer.transformBinary`` /
    ``transformMulticlass``. ``guard`` is ``TrainerConfig.guard`` (the push-delta guard)."""
    from fps_tpu_torch.core.driver import Trainer, TrainerConfig

    store = make_store(mesh, cfg)
    worker = (PassiveAggressiveWorker(cfg) if cfg.num_classes == 2
              else MulticlassPassiveAggressiveWorker(cfg))
    trainer = Trainer(
        mesh, store, worker,
        config=TrainerConfig(sync_every=sync_every, donate=donate,
                             max_steps_per_call=max_steps_per_call,
                             guard=guard),
    )
    return trainer, store


def predict_host(store: ParamStore, feat_ids: np.ndarray,
                 feat_vals: np.ndarray, num_classes: int = 2) -> np.ndarray:
    """Host-side predictions from the live table (binary: {-1, +1};
    multiclass: class index)."""
    rows = store.lookup_host(WEIGHT_TABLE, feat_ids.reshape(-1))
    B, nnz = feat_ids.shape
    rows = rows.reshape(B, nnz, -1)
    scores = np.einsum("bn,bnc->bc", feat_vals, rows)
    if num_classes == 2:
        return np.where(scores[:, 0] > 0, 1.0, -1.0)
    return np.argmax(scores, axis=-1)
