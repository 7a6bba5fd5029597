"""The tiny deterministic logistic-regression workload of the supervised
scenarios (:mod:`fps_tpu_torch.testing.supervised_demo`) and the port's
resilience tests: one copy of the harness.

Port of ``fps_tpu/testing/workloads.py``: the same planted data (seed 7),
the same chunks (seed 3, local batch 32, 8 steps a chunk), the same
learning rate; the JAX package's ``jax.random.key(0)`` / ``key(1)`` are
the host seeds 0 and 1 here (``Trainer.init_state(seed)``,
``fit_stream(..., seed)``). Same mesh and same calls give the same bits.
"""

from __future__ import annotations

import numpy as np

from fps_tpu_torch.core.ingest import multi_epoch_chunks
from fps_tpu_torch.models.logistic_regression import (
    LogRegConfig,
    logistic_regression,
    predict_proba_host,
)
from fps_tpu_torch.utils.datasets import (
    synthetic_sparse_classification,
    train_test_split,
)

# Small enough that every route stays fast on the CPU, big enough that the
# planted structure is clearly learnable (accuracy above about 0.75).
NF, NNZ = 400, 8


def logreg_data(num_examples: int = 4000, num_features: int = NF):
    """(train, test) split of the planted sparse-classification set."""
    data = synthetic_sparse_classification(num_examples, num_features, NNZ,
                                           seed=7, noise=0.05)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    return train_test_split(data)


def logreg_chunks(train, num_workers: int, epochs: int = 3):
    return list(
        multi_epoch_chunks(
            train, epochs, num_workers=num_workers, local_batch=32,
            steps_per_chunk=8, seed=3,
        )
    )


def run_logreg(mesh, chunks, *, guard=None, rollback=None):
    """Train the standard tiny logistic regression over ``chunks``; returns
    ``(trainer, store, per-chunk metrics list)``."""
    cfg = LogRegConfig(num_features=NF, learning_rate=0.5)
    trainer, store = logistic_regression(mesh, cfg, guard=guard)
    tables, ls = trainer.init_state(0)
    tables, ls, m = trainer.fit_stream(tables, ls, iter(chunks), 1,
                                       rollback=rollback)
    return trainer, store, m


def accuracy(store, test) -> float:
    p = predict_proba_host(store, test["feat_ids"], test["feat_vals"])
    return float(np.mean((p > 0.5) == (test["label"] > 0.5)))


def weights(store, num_features: int = NF) -> np.ndarray:
    return store.lookup_host("weights", np.arange(num_features))


def health_sum(metrics, table: str, kind: str) -> int:
    """Total of one health counter over a run's per-chunk metrics list."""
    return sum(
        int(np.sum(np.asarray(m["health"][table][kind])))
        for m in metrics
        if "health" in m
    )
