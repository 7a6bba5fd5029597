"""Sparse logistic regression with bounded-staleness SGD (Criteo CTR style).

Port of ``fps_tpu/models/logistic_regression.py``, the canonical exerciser
of the SSP driver (``sync_every=s``): the worker reads weights from a
snapshot up to ``s`` steps stale, computes sigmoid-loss gradients over hashed
sparse features and pushes per-feature deltas that land in the live table
every step. With ``optimizer="sgd"`` the table is ``(NF, 1)`` and its pulls
and pushes run on the scalar kernels K5 and K4 on the card; ``"adagrad"``
keeps its accumulator in column 1 of an ``(NF, 2)`` table, on K1 and K2
(and K3 for the write-hot head with ``hot_features``).

Batch columns: ``feat_ids (B, nnz)``, ``feat_vals (B, nnz)``,
``label (B,)`` in {0, 1}, ``weight (B,)``.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from fps_tpu_torch.core.api import ServerLogic, StepOutput, WorkerLogic
from fps_tpu_torch.core.store import ParamStore, TableSpec

Tensor = torch.Tensor

WEIGHT_TABLE = "weights"


@dataclasses.dataclass
class LogRegConfig:
    """``optimizer``: ``"sgd"``, the worker pushes lr-scaled deltas into an
    additive fold; ``"adagrad"``, the worker pushes raw ``[grad, grad^2]``
    pairs and the server fold (:func:`adagrad_fold`) keeps a per-coordinate
    accumulator in column 1 of the table.

    ``dense_features = d``: the fixed-slot dense head of the Criteo layout
    (batch slot ``j < d`` carries feature id ``j`` in every example). The
    worker pulls those ``d`` weights once per step and pushes one
    batch-combined delta per column, instead of ``B * d`` gathered and
    scattered rows; the same per-id sums under the additive fold, up to the
    order of float32 sums.

    ``hot_features = H``: feature ids ``[0, H)`` are the write-hot head
    (ids frequency-ranked, as the generators and loaders rank them). Under
    AdaGrad the ``apply_fn`` push's sum-and-count scatter, ``(NF, 3)``,
    takes the hot/cold split: the head through kernel K3, the tail through
    K2. Under SGD the table has one column and its push stays on K4, which
    sums hot runs without walking them.
    """

    num_features: int
    learning_rate: float = 0.1
    l2: float = 0.0
    batch_average: bool = True  # average grads over the local batch
    optimizer: str = "sgd"
    adagrad_eps: float = 1e-6
    hot_features: int = 0
    dense_features: int = 0
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if self.optimizer not in ("sgd", "adagrad"):
            raise ValueError(f"unknown optimizer {self.optimizer!r}")
        if not 0 <= self.dense_features <= self.num_features:
            raise ValueError(
                f"dense_features={self.dense_features} out of range")

    @property
    def table_width(self) -> int:
        """Columns per feature row: weight (+ AdaGrad accumulator)."""
        return 2 if self.optimizer == "adagrad" else 1


class LogisticRegressionWorker(WorkerLogic):
    def __init__(self, cfg: LogRegConfig):
        self.cfg = cfg

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        d = self.cfg.dense_features
        ids = batch["feat_ids"].to(torch.int32)
        if not d:
            return {WEIGHT_TABLE: ids.reshape(-1)}
        # Dense head: one static d-row pull (slot j carries id j for j < d)
        # and the sparse tail per example.
        head = torch.arange(d, dtype=torch.int32, device=ids.device)
        return {WEIGHT_TABLE: torch.cat([head, ids[:, d:].reshape(-1)])}

    def pulled_ids_host(self, chunk):
        """The ids each step pulls and pushes, as a host stream (what the
        JAX package's cold-route certifier and touched-rows tracker read):
        ``(..., B, nnz)`` flattens to ``(..., B * nnz)``. A dense head pulls
        its ``d`` ids outside the batch columns, which this stream cannot
        express, so those configurations return ``None``."""
        if self.cfg.dense_features:
            return None
        ids = np.asarray(chunk["feat_ids"])
        if ids.ndim >= 2:
            ids = ids.reshape(*ids.shape[:-2], -1)
        return {WEIGHT_TABLE: ids}

    def step(self, batch, pulled, local_state, gen) -> StepOutput:
        cfg = self.cfg
        d = cfg.dense_features
        B, nnz = batch["feat_ids"].shape
        x = batch["feat_vals"].to(cfg.dtype)
        y = batch["label"].to(cfg.dtype)  # {0, 1}
        w = batch["weight"].to(cfg.dtype)

        width = cfg.table_width
        flat = pulled[WEIGHT_TABLE]
        if d:
            head = flat[:d, 0][None].expand(B, d)
            tail = flat[d:].reshape(B, nnz - d, width)[:, :, 0]
            wrows = torch.cat([head, tail], 1)
        else:
            wrows = flat.reshape(B, nnz, width)[:, :, 0]
        logit = torch.sum(wrows * x, -1)
        p = torch.sigmoid(logit)
        g = (p - y) * w  # dL/dlogit, zero for padding

        norm = (torch.clamp(torch.sum(w), min=1.0) if cfg.batch_average
                else 1.0)
        grads = (g[:, None] * x + cfg.l2 * wrows * w[:, None]) / norm
        if cfg.optimizer == "adagrad":
            # Raw gradient and its square; the server fold applies lr.
            deltas = torch.stack([grads, grads * grads], -1)
        else:
            deltas = (-cfg.learning_rate * grads)[:, :, None]

        active = (x != 0.0) & (w[:, None] > 0)
        ids = batch["feat_ids"].to(torch.int32)
        if d:
            # Head: combined over the batch on the worker (the per-id sum
            # the server fold would compute) -> d pushed rows, not B * d.
            head_deltas = torch.sum(
                torch.where(active[:, :d, None], deltas[:, :d, :], 0.0), 0)
            tail_ids = torch.where(active[:, d:], ids[:, d:], -1)
            push_ids = torch.cat([
                torch.arange(d, dtype=torch.int32, device=ids.device),
                tail_ids.reshape(-1)])
            push_deltas = torch.cat([head_deltas.to(cfg.dtype),
                                     deltas[:, d:, :].reshape(-1, width)])
        else:
            push_ids = torch.where(active, ids, -1).reshape(-1)
            push_deltas = deltas.reshape(-1, width)

        # Log loss, clipped for monitoring stability.
        eps = 1e-7
        ll = -(y * torch.log(p + eps) + (1 - y) * torch.log(1 - p + eps))
        mistakes = torch.sum(w * ((p > 0.5) != (y > 0.5)))
        out = {
            "logloss": torch.sum(ll * w).to(torch.float32),
            "mistakes": mistakes.to(torch.float32),
            "n": torch.sum(w).to(torch.float32),
        }
        pushes = {WEIGHT_TABLE: (push_ids, push_deltas.contiguous())}
        return StepOutput(pushes=pushes, local_state=local_state, out=out)


def make_store(mesh, cfg: LogRegConfig) -> ParamStore:
    spec = TableSpec(
        name=WEIGHT_TABLE, num_ids=cfg.num_features, dim=cfg.table_width,
        dtype=cfg.dtype, hot_ids=min(cfg.hot_features, cfg.num_features),
    ).zeros_init()
    return ParamStore(mesh, [spec])


def adagrad_fold(lr: float, eps: float):
    """Server fold holding AdaGrad state in the table: column 0 = weight,
    column 1 = squared-gradient accumulator. The combined push delta is
    ``[sum g, sum g^2]`` per touched id."""

    def apply_fn(rows, delta):
        wcol, acc = rows[:, 0], rows[:, 1]
        gsum, g2sum = delta[:, 0], delta[:, 1]
        acc_new = acc + g2sum
        w_new = wcol - lr * gsum / (torch.sqrt(acc_new) + eps)
        return torch.stack([w_new, acc_new], -1)

    return apply_fn


def logistic_regression(mesh, cfg: LogRegConfig, *,
                        sync_every: int | None = None, push_delay: int = 0,
                        donate: bool = True,
                        max_steps_per_call: int | None = None, guard=None):
    """(trainer, store); pass ``sync_every=s`` for SSP bounded staleness
    and ``push_delay=d`` for delayed pushes (``TrainerConfig``'s). ``guard``
    is ``TrainerConfig.guard`` (the push-delta guard)."""
    from fps_tpu_torch.core.driver import Trainer, TrainerConfig

    store = make_store(mesh, cfg)
    server_logic = (
        ServerLogic(apply_fn=adagrad_fold(cfg.learning_rate, cfg.adagrad_eps))
        if cfg.optimizer == "adagrad" else ServerLogic())
    trainer = Trainer(
        mesh, store, LogisticRegressionWorker(cfg),
        server_logic=server_logic,
        config=TrainerConfig(sync_every=sync_every, push_delay=push_delay,
                             donate=donate,
                             max_steps_per_call=max_steps_per_call,
                             guard=guard),
    )
    return trainer, store


def predict_proba_host(store: ParamStore, feat_ids: np.ndarray,
                       feat_vals: np.ndarray) -> np.ndarray:
    rows = store.lookup_host(WEIGHT_TABLE, feat_ids.reshape(-1))
    B, nnz = feat_ids.shape
    weights = rows[:, 0]  # column 0 is the weight for every optimizer
    logit = np.sum(weights.reshape(B, nnz) * feat_vals, axis=-1)
    return 1.0 / (1.0 + np.exp(-logit))
