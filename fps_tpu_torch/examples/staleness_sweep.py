"""Staleness sweep: convergence by (sync_every s, push_delay d) on MF, SSP
logistic regression and word2vec, over an 8-worker mesh ``(1, 8)``.

Port of ``tools/staleness_sweep.py`` (the table of ``docs/STALENESS.md``):
the same grid, data, seeds, learning rates, epoch multipliers and table
format. The w2v column is a QUALITY metric (planted-synonym
nearest-neighbour partner recovery@5, chance 5/(2*V2)), not loss: stale
embeddings must still resolve the planted semantics. Its negatives come
from the port's counter hash (``fps_tpu_torch.core.rng``), not
``jax.random``, so that column alone is not the reference's bits.

The mesh's positions are on the card unless ``--device`` names another
device (``--device cpu``). ``--rows`` picks grid rows by index (``0,3`` is
``(None, 0)`` and ``(4, 4)``); the default is the whole grid.

Run:
  python -m fps_tpu_torch.examples.staleness_sweep [--device cpu]
      [--rows 0,3]
"""

from __future__ import annotations

import argparse
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__" and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

import numpy as np  # noqa: E402

from fps_tpu_torch.core.driver import num_workers_of  # noqa: E402
from fps_tpu_torch.core.ingest import multi_epoch_chunks  # noqa: E402
from fps_tpu_torch.models.logistic_regression import (  # noqa: E402
    LogRegConfig,
    logistic_regression,
    predict_proba_host,
)
from fps_tpu_torch.models.matrix_factorization import (  # noqa: E402
    MFConfig,
    online_mf,
    predict_host,
    rmse,
)
from fps_tpu_torch.parallel.mesh import make_ps_mesh  # noqa: E402
from fps_tpu_torch.utils.datasets import (  # noqa: E402
    synthetic_corpus,
    synthetic_ratings,
    synthetic_sparse_classification,
    train_test_split,
)

# (s, d, lr multiplier, epoch multiplier): the async-SGD recipe — scale
# the learning rate down and the steps up with the TOTAL staleness.
GRID = (
    (None, 0, 1.0, 1),
    (1, 0, 1.0, 1),
    (4, 0, 1.0, 1),
    (4, 4, 0.5, 2),
    (16, 0, 0.5, 2),
    (16, 16, 0.25, 2),
    (64, 0, 0.25, 4),
    (64, 64, 1 / 16, 4),
)
MF_LR0, MF_EP0 = 0.08, 3
LG_LR0, LG_EP0 = 0.5, 3
WV_LR0, WV_EP0 = 0.05, 4
NU, NI = 96, 64
NF = 4000
V2 = 100


def mf_run(mesh, train, test, nu, ni, *, s, d, lr, epochs):
    W = num_workers_of(mesh)
    cfg = MFConfig(num_users=nu, num_items=ni, rank=4, learning_rate=lr,
                   reg=0.005)
    trainer, store = online_mf(mesh, cfg, sync_every=s, push_delay=d)
    t, l = trainer.init_state(0)
    chunks = multi_epoch_chunks(
        train, epochs, num_workers=W, local_batch=32,
        steps_per_chunk=max(8, s or 0), route_key="user", sync_every=s,
        seed=11,
    )
    t, l, _ = trainer.fit_stream(t, l, chunks, 1)
    pred = predict_host(store, l, W, test["user"], test["item"])
    return rmse(pred, test["rating"])


def logreg_run(mesh, train, test, nf, *, s, d, lr, epochs):
    W = num_workers_of(mesh)
    cfg = LogRegConfig(num_features=nf, learning_rate=lr)
    trainer, store = logistic_regression(mesh, cfg, sync_every=s,
                                         push_delay=d)
    t, l = trainer.init_state(0)
    chunks = multi_epoch_chunks(
        train, epochs, num_workers=W, local_batch=32,
        steps_per_chunk=max(8, s or 0), sync_every=s, seed=11,
    )
    t, l, _ = trainer.fit_stream(t, l, chunks, 1)
    p = predict_proba_host(store, test["feat_ids"], test["feat_vals"])
    return float(np.mean((p > 0.5) == (test["label"] > 0.5)))


def w2v_run(mesh, tokens, uni, v2, *, s, d, lr, epochs):
    from fps_tpu_torch.models.word2vec import (
        W2VConfig,
        nearest_neighbors,
        skipgram_chunks,
        word2vec,
    )

    W = num_workers_of(mesh)
    cfg = W2VConfig(vocab_size=2 * v2, dim=16, window=3, negatives=4,
                    learning_rate=lr, subsample_t=None)
    trainer, store = word2vec(mesh, cfg, uni, sync_every=s, push_delay=d)
    t, l = trainer.init_state(0)
    for e in range(epochs):
        chunks = skipgram_chunks(tokens, uni, cfg, num_workers=W,
                                 local_batch=64,
                                 steps_per_chunk=max(8, s or 0),
                                 sync_every=s, seed=11 + e)
        t, l, _ = trainer.fit_stream(t, l, chunks, e)
    probes = np.argsort(-uni[:v2])[:40]
    ids, _ = nearest_neighbors(store, probes, k=5)
    partner = probes + v2
    return float(np.mean([partner[i] in ids[i] for i in range(len(probes))]))


def sweep_data():
    """The reference's three data sets: ``(mf, logreg, w2v)`` splits and
    corpus, from its seeds."""
    mf_data = synthetic_ratings(NU, NI, 6000, rank=3, noise=0.05, seed=3)
    lg_data = synthetic_sparse_classification(8000, NF, 8, seed=7,
                                              noise=0.05)
    lg_data["label"] = (lg_data["label"] > 0).astype(np.float32)
    wrng = np.random.default_rng(17)
    wbase = synthetic_corpus(V2, 40_000, num_topics=8, seed=0)
    wtokens = np.where(wrng.random(len(wbase)) < 0.5, wbase,
                       wbase + V2).astype(np.int32)
    wuni = np.bincount(wtokens, minlength=2 * V2).astype(np.float64)
    return (train_test_split(mf_data), train_test_split(lg_data),
            (wtokens, wuni))


def main(argv=None):
    ap = argparse.ArgumentParser(
        description="convergence by (sync_every, push_delay) on MF, "
                    "logistic regression and word2vec (fps_tpu_torch)")
    ap.add_argument("--device", default=None,
                    help="where the 8 positions live (default: the card, "
                         "cuda:0; 'cpu' for the tests)")
    ap.add_argument("--rows", default=None, metavar="I[,I...]",
                    help=f"grid rows by index, 0-{len(GRID) - 1} (default: "
                         "all)")
    args = ap.parse_args(argv)
    rows_at = (range(len(GRID)) if args.rows is None
               else [int(i) for i in args.rows.split(",") if i])
    if any(not 0 <= i < len(GRID) for i in rows_at):
        ap.error(f"--rows wants indices in [0, {len(GRID) - 1}], got "
                 f"{args.rows!r}")

    import torch

    device = args.device
    if device is None:
        if not torch.cuda.is_available():
            print("staleness_sweep: CUDA is not available and no --device "
                  "was given; the sweep runs on the card", file=sys.stderr)
            return 2
        device = "cuda:0"
    if torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
    mesh = make_ps_mesh(num_shards=8, num_data=1, device=device)
    (mf_train, mf_test), (lg_train, lg_test), (wtokens, wuni) = sweep_data()

    rows = []
    for i in rows_at:
        s, d, lrm, epm = GRID[i]
        r = mf_run(mesh, mf_train, mf_test, NU, NI, s=s, d=d,
                   lr=MF_LR0 * lrm, epochs=MF_EP0 * epm)
        a = logreg_run(mesh, lg_train, lg_test, NF, s=s, d=d,
                       lr=LG_LR0 * lrm, epochs=LG_EP0 * epm)
        w = w2v_run(mesh, wtokens, wuni, V2, s=s, d=d,
                    lr=WV_LR0 * lrm, epochs=WV_EP0 * epm)
        tag = "sync" if s is None else f"s={s}"
        rows.append((tag, d, lrm, epm, r, a, w))
        print(f"{tag:6s} d={d:3d} lr x{lrm:<5g} ep x{epm}: "
              f"MF test RMSE {r:.4f}   logreg test acc {a:.4f}   "
              f"w2v partner-rec@5 {w:.3f}",
              flush=True)

    print("\n| reads | push delay | lr scale | epochs scale | "
          "MF test RMSE | logreg test acc | w2v partner-rec@5 |")
    print("|---|---|---|---|---|---|---|")
    for tag, d, lrm, epm, r, a, w in rows:
        print(f"| {tag} | {d} | x{lrm:g} | x{epm} | {r:.4f} | {a:.4f} "
              f"| {w:.3f} |")
    return 0


if __name__ == "__main__":
    sys.exit(main())
