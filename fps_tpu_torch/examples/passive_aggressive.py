"""Passive-aggressive classification on the PyTorch port (RCV1-style sparse
examples).

Port of ``fps_tpu/examples/passive_aggressive.py`` with the flags the port
supports: device-resident or host ingest (``--ingest``), the mesh flags
(``--num-shards``, ``--num-data``), sync or SSP. ``--num-classes 2`` (the default) runs the binary model, ``> 2`` the
multiclass one. Prints one JSON line per event, ending in a ``"done"`` event
with the held-out ``test_accuracy``.

    python -m fps_tpu_torch.examples.passive_aggressive --num-features 47236 \\
        --nnz 64 --num-examples 800000 --local-batch 16384 --head-features 2048
    python -m fps_tpu_torch.examples.passive_aggressive --device cpu

``--head-features H`` lays the examples out with ``head_sort_slots`` and
turns on the binary model's head-prefix route (``PAConfig.hot_features`` and
``head_prefix_cols``), as the JAX package's bench does on one device.
``--profile DIR`` traces one chunk on the card (see
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
    ap = base_parser("Passive-aggressive classification on the PyTorch PS")
    ap.add_argument("--input", default=None,
                    help="svmlight or Criteo file (default: synthetic)")
    ap.add_argument("--input-format", default="auto",
                    choices=["auto", "svmlight", "criteo"])
    ap.add_argument("--nnz-cap", type=int, default=None,
                    help="svmlight rows keep at most this many features")
    ap.add_argument("--num-features", type=int, default=10_000)
    ap.add_argument("--num-classes", type=int, default=2)
    ap.add_argument("--num-examples", type=int, default=50_000)
    ap.add_argument("--nnz", type=int, default=16)
    ap.add_argument("--variant", default="PA-I",
                    choices=["PA", "PA-I", "PA-II"])
    ap.add_argument("--C", type=float, default=1.0)
    ap.add_argument("--head-features", type=int, default=0,
                    help="binary only: head-prefix route over this many "
                         "frequency-ranked features (0: off)")
    args = ap.parse_args(argv)

    from fps_tpu_torch.models.passive_aggressive import (
        PAConfig,
        passive_aggressive,
        predict_host,
    )
    from fps_tpu_torch.utils.datasets import (
        head_sort_slots,
        load_sparse,
        sniff_sparse_format,
        synthetic_sparse_classification,
        synthetic_sparse_multiclass,
        train_test_split,
    )

    mesh = make_mesh(args)
    if args.input:
        # Binary {-1, +1}. svmlight: the feature space comes from the file;
        # criteo: the hashed space size is --num-features.
        fmt = args.input_format
        if fmt == "auto":
            fmt = sniff_sparse_format(args.input)
        data, args.num_features = load_sparse(
            args.input, fmt=fmt,
            num_features=args.num_features if fmt == "criteo" else None,
            nnz_cap=args.nnz_cap)
        if args.num_classes != 2:
            raise SystemExit("--input provides binary labels; "
                             "--num-classes must be 2")
    elif args.num_classes == 2:
        data = synthetic_sparse_classification(
            args.num_examples, args.num_features, args.nnz, seed=args.seed)
    else:
        data = synthetic_sparse_multiclass(
            args.num_examples, args.num_features, args.num_classes, args.nnz,
            seed=args.seed)
    q = 0
    if args.head_features:
        if args.num_classes != 2:
            raise SystemExit("--head-features is binary-only")
        data, q = head_sort_slots(data, args.head_features)
    train, test = train_test_split(data, test_frac=0.1, seed=args.seed + 1)
    emit({"event": "start", "workload": "passive_aggressive",
          "variant": args.variant, "num_classes": args.num_classes,
          "num_features": args.num_features, "head_prefix_cols": q,
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = PAConfig(num_features=args.num_features,
                   num_classes=args.num_classes, variant=args.variant,
                   C=args.C, hot_features=args.head_features if q else 0,
                   head_prefix_cols=q)
    trainer, store = passive_aggressive(mesh, cfg,
                                        sync_every=args.sync_every,
                                        guard=make_guard(args))
    apply_host_pipeline(args, trainer)
    apply_hot_tier(args, trainer)
    rec = attach_obs(args, trainer, workload="pa")
    tables, local_state = trainer.init_state(args.seed)
    tables = maybe_warm_start(args, store, tables)
    chunks = make_chunks(args, mesh, train)
    prof, prof_step = profiler(args, mesh.device)
    t0 = time.perf_counter()

    def report(i, m):
        n = max(1.0, float(np.sum(m["n"])))
        emit({"event": "chunk", "i": i,
              "error_rate": float(np.sum(m["mistakes"]) / n),
              "hinge_loss": float(np.sum(m["loss"]) / n), "examples": n,
              "seconds": time.perf_counter() - t0})
        prof_step()

    with prof, maybe_serve(args, rec):
        tables, local_state, _ = trainer.fit_stream(
            tables, local_state, chunks, args.seed, on_chunk=report,
            watchdog=make_watchdog(args, rec),
            **durability(args))
    seconds = time.perf_counter() - t0
    pred = predict_host(store, test["feat_ids"], test["feat_vals"],
                        num_classes=args.num_classes)
    emit({"event": "done",
          "test_accuracy": float(np.mean(pred == test["label"])),
          "seconds": seconds})
    finish(args, store, recorder=rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
