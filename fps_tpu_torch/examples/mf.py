"""Online matrix factorization on the PyTorch port (MovieLens-style ratings).

Port of ``fps_tpu/examples/mf.py`` with the flags the port supports:
device-resident or host ingest (``--ingest``), one device, sync or SSP.
Prints one JSON line per event, ending in a ``"done"`` event with the
held-out ``test_rmse``.

    python -m fps_tpu_torch.examples.mf --scale 20m --local-batch 32768
    python -m fps_tpu_torch.examples.mf --scale 100k --device cpu

``--profile DIR`` traces one chunk on the card (see
:mod:`fps_tpu_torch.examples.common`).
"""

from __future__ import annotations

import time

import numpy as np

from fps_tpu_torch.examples.common import (
    base_parser,
    emit,
    make_chunks,
    profiler,
)


def main(argv=None) -> int:
    ap = base_parser("Online MF (SGD) on the PyTorch parameter server")
    ap.add_argument("--input", default=None,
                    help="u.data-format ratings file (default: synthetic)")
    ap.add_argument("--scale", default="100k", choices=["100k", "1m", "20m"],
                    help="synthetic size when no --input is given")
    ap.add_argument("--rank", type=int, default=10)
    ap.add_argument("--learning-rate", type=float, default=0.05)
    ap.add_argument("--reg", type=float, default=0.01)
    ap.add_argument("--combine", default="sum", choices=["sum", "mean"],
                    help="how duplicate items of one batch merge")
    args = ap.parse_args(argv)

    from fps_tpu_torch.models.matrix_factorization import (
        MFConfig,
        online_mf,
        predict_host,
        rmse,
    )
    from fps_tpu_torch.parallel.mesh import make_ps_mesh, num_workers_of
    from fps_tpu_torch.utils.datasets import load_movielens, train_test_split

    mesh = make_ps_mesh(device=args.device)
    data, nu, ni = load_movielens(args.input, args.scale)
    train, test = train_test_split(data, test_frac=0.1, seed=args.seed + 1)
    W = num_workers_of(mesh)
    emit({"event": "start", "workload": "mf", "num_users": nu,
          "num_items": ni, "num_ratings": len(data["user"]),
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = MFConfig(num_users=nu, num_items=ni, rank=args.rank,
                   learning_rate=args.learning_rate, reg=args.reg)
    trainer, store = online_mf(mesh, cfg, sync_every=args.sync_every,
                               combine=args.combine)
    tables, local_state = trainer.init_state(args.seed)

    chunks = make_chunks(args, mesh, train, route_key="user")
    prof, prof_step = profiler(args, mesh.device)
    t0 = time.perf_counter()

    def report(i, m):
        se, n = float(np.sum(m["se"])), max(1.0, float(np.sum(m["n"])))
        emit({"event": "chunk", "i": i, "train_rmse": float(np.sqrt(se / n)),
              "examples": n, "seconds": time.perf_counter() - t0})
        prof_step()

    with prof:
        tables, local_state, _ = trainer.fit_stream(
            tables, local_state, chunks, args.seed, on_chunk=report)
    pred = predict_host(store, local_state, W, test["user"], test["item"])
    emit({"event": "done", "test_rmse": rmse(pred, test["rating"]),
          "seconds": time.perf_counter() - t0})
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
