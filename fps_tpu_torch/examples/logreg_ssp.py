"""Bounded-staleness logistic regression on the PyTorch port (Criteo CTR
style).

Port of ``fps_tpu/examples/logreg_ssp.py`` with the flags the port
supports: device-resident or host ingest (``--ingest``), the mesh flags
(``--num-shards``, ``--num-data``).
``--sync-every s`` (default 8: this job exists to exercise SSP) bounds how
stale a step's weights may be. Prints one JSON line per event, ending in a
``"done"`` event with the held-out ``test_accuracy``.

    python -m fps_tpu_torch.examples.logreg_ssp --num-features 1000000 \\
        --nnz 39 --dense-features 13 --num-examples 1000000 \\
        --local-batch 16384
    python -m fps_tpu_torch.examples.logreg_ssp --device cpu

``--dense-features d`` gives the synthetic examples the Criteo loader's
fixed-slot head (slot ``j < d`` carries feature ``j``) and lets the worker
pull and push those weights once per step; a Criteo ``--input`` sets it to
13. ``--profile DIR`` traces one chunk on the card (see
:mod:`fps_tpu_torch.examples.common`).
"""

from __future__ import annotations

import time

import numpy as np

from fps_tpu_torch.examples.common import (
    attach_obs,
    durability,
    finish,
    make_guard,
    make_watchdog,
    maybe_serve,
    maybe_warm_start,
    apply_host_pipeline,
    apply_hot_tier,
    base_parser,
    emit,
    make_chunks,
    make_mesh,
    profiler,
)


def main(argv=None) -> int:
    ap = base_parser("SSP logistic regression on the PyTorch PS")
    ap.add_argument("--input", default=None,
                    help="Criteo TSV or svmlight file (default: synthetic)")
    ap.add_argument("--input-format", default="auto",
                    choices=["auto", "svmlight", "criteo"])
    ap.add_argument("--nnz-cap", type=int, default=None,
                    help="svmlight rows keep at most this many features")
    ap.add_argument("--num-features", type=int, default=1 << 18,
                    help="hashed feature space size")
    ap.add_argument("--num-examples", type=int, default=100_000)
    ap.add_argument("--nnz", type=int, default=32)
    ap.add_argument("--dense-features", type=int, default=0,
                    help="synthetic data: fixed-slot dense head width")
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--l2", type=float, default=0.0)
    ap.add_argument("--optimizer", default="sgd", choices=["sgd", "adagrad"])
    args = ap.parse_args(argv)
    if args.sync_every is None:
        args.sync_every = 8

    from fps_tpu_torch.models.logistic_regression import (
        LogRegConfig,
        logistic_regression,
        predict_proba_host,
    )
    from fps_tpu_torch.utils.datasets import (
        load_sparse,
        sniff_sparse_format,
        synthetic_sparse_classification,
        train_test_split,
    )

    mesh = make_mesh(args)
    dense = args.dense_features
    if args.input:
        fmt = args.input_format
        if fmt == "auto":
            fmt = sniff_sparse_format(args.input)
        data, args.num_features = load_sparse(
            args.input, fmt=fmt,
            num_features=args.num_features if fmt == "criteo" else None,
            nnz_cap=args.nnz_cap)
        # Only the Criteo loader guarantees the fixed-slot head.
        dense = 13 if fmt == "criteo" else 0
    else:
        data = synthetic_sparse_classification(
            args.num_examples, args.num_features, args.nnz, seed=args.seed,
            dense_features=dense)
    data["label"] = (data["label"] > 0).astype(np.float32)  # {0, 1}
    train, test = train_test_split(data, test_frac=0.1, seed=args.seed + 1)
    emit({"event": "start", "workload": "logreg_ssp",
          "sync_every": args.sync_every, "optimizer": args.optimizer,
          "num_features": args.num_features, "dense_features": dense,
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = LogRegConfig(num_features=args.num_features,
                       learning_rate=args.learning_rate, l2=args.l2,
                       optimizer=args.optimizer, dense_features=dense)
    trainer, store = logistic_regression(mesh, cfg,
                                         sync_every=args.sync_every,
                                         guard=make_guard(args))
    apply_host_pipeline(args, trainer)
    apply_hot_tier(args, trainer)
    rec = attach_obs(args, trainer, workload="logreg")
    tables, local_state = trainer.init_state(args.seed)
    tables = maybe_warm_start(args, store, tables)
    chunks = make_chunks(args, mesh, train)
    prof, prof_step = profiler(args, mesh.device)
    t0 = time.perf_counter()

    def report(i, m):
        n = max(1.0, float(np.sum(m["n"])))
        emit({"event": "chunk", "i": i,
              "logloss": float(np.sum(m["logloss"]) / n),
              "error_rate": float(np.sum(m["mistakes"]) / n), "examples": n,
              "seconds": time.perf_counter() - t0})
        prof_step()

    with prof, maybe_serve(args, rec):
        tables, local_state, _ = trainer.fit_stream(
            tables, local_state, chunks, args.seed, on_chunk=report,
            watchdog=make_watchdog(args, rec),
            **durability(args))
    seconds = time.perf_counter() - t0
    p = predict_proba_host(store, test["feat_ids"], test["feat_vals"])
    emit({"event": "done",
          "test_accuracy": float(np.mean((p > 0.5) == (test["label"] > 0.5))),
          "seconds": seconds})
    finish(args, store, recorder=rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
