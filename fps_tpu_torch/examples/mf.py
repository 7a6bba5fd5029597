"""Online matrix factorization on the PyTorch port (MovieLens-style ratings).

Port of ``fps_tpu/examples/mf.py`` with the flags the port supports:
device-resident or host ingest (``--ingest``), the mesh flags
(``--num-shards``, ``--num-data``), sync or SSP.
Prints one JSON line per event, ending in a ``"done"`` event with the
held-out ``test_rmse``. ``--topk K --topk-every N`` ranks the top-K items of
the first users of every N-th step's batch inside the training loop (a step
tap; one ``"topk_online"`` event per such step); ``--topk K`` alone ranks
them for a few test users after training (``"topk"`` events).
``--negative-samples N`` adds N sampled unrated items a rating as
pseudo-negatives of weight ``--negative-weight``.

    python -m fps_tpu_torch.examples.mf --scale 20m --local-batch 32768
    python -m fps_tpu_torch.examples.mf --scale 100k --device cpu

``--profile DIR`` traces one chunk on the card (see
:mod:`fps_tpu_torch.examples.common`).
"""

from __future__ import annotations

import dataclasses
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
    report_tiering,
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
    ap.add_argument("--topk", type=int, default=0,
                    help="after training, print top-K items for sample users")
    ap.add_argument("--topk-every", type=int, default=0,
                    help="emit top-K (for the users being trained) every N "
                         "steps from inside the training loop, the "
                         "reference's streaming ...AndTopK shape; requires "
                         "--topk")
    ap.add_argument("--negative-samples", type=int, default=0,
                    help="sample this many unrated items per rating as "
                         "weighted pseudo-negatives (implicit feedback)")
    ap.add_argument("--negative-weight", type=float, default=0.5)
    args = ap.parse_args(argv)
    if args.topk_every and not args.topk:
        ap.error("--topk-every requires --topk")

    from fps_tpu_torch.models.matrix_factorization import (
        ITEM_TABLE,
        MFConfig,
        online_mf,
        predict_host,
        rmse,
    )
    from fps_tpu_torch.parallel.mesh import num_workers_of
    from fps_tpu_torch.utils.datasets import load_movielens, train_test_split

    mesh = make_mesh(args)
    data, nu, ni = load_movielens(args.input, args.scale)
    train, test = train_test_split(data, test_frac=0.1, seed=args.seed + 1)
    W = num_workers_of(mesh)
    emit({"event": "start", "workload": "mf", "num_users": nu,
          "num_items": ni, "num_ratings": len(data["user"]),
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = MFConfig(num_users=nu, num_items=ni, rank=args.rank,
                   learning_rate=args.learning_rate, reg=args.reg,
                   negative_samples=args.negative_samples,
                   negative_weight=args.negative_weight)
    trainer, store = online_mf(mesh, cfg, sync_every=args.sync_every,
                               combine=args.combine, guard=make_guard(args))
    apply_host_pipeline(args, trainer)
    apply_hot_tier(args, trainer)
    if args.topk_every:
        from fps_tpu_torch.models.recommendation import (
            make_online_topk_tap,
            mf_topk_query_fn,
        )

        trainer.config = dataclasses.replace(
            trainer.config, step_tap=make_online_topk_tap(
                store, ITEM_TABLE, args.topk, every=args.topk_every,
                query_fn=mf_topk_query_fn(W, 2)))
    rec = attach_obs(args, trainer, workload="mf")
    tables, local_state = trainer.init_state(args.seed)
    tables = maybe_warm_start(args, store, tables)

    chunks = make_chunks(args, mesh, train, route_key="user")
    prof, prof_step = profiler(args, mesh.device)
    t0 = time.perf_counter()

    def report(i, m):
        se, n = float(np.sum(m["se"])), max(1.0, float(np.sum(m["n"])))
        emit({"event": "chunk", "i": i, "train_rmse": float(np.sqrt(se / n)),
              "examples": n, "seconds": time.perf_counter() - t0})
        if "tap" in m:
            users = m["tap"]["topk_query"]  # (T, W, q)
            items = m["tap"]["topk_ids"]  # (T, W, q, k)
            for t in np.flatnonzero((users >= 0).any(axis=(1, 2))):
                emit({"event": "topk_online", "chunk": i, "step": int(t),
                      "users": users[t].reshape(-1).tolist(),
                      "items": items[t].reshape(users[t].size, -1).tolist()})
        prof_step()

    with prof, maybe_serve(args, rec):
        tables, local_state, _ = trainer.fit_stream(
            tables, local_state, chunks, args.seed, on_chunk=report,
            watchdog=make_watchdog(args, rec),
            **durability(args))
    report_tiering(trainer)
    pred = predict_host(store, local_state, W, test["user"], test["item"])
    emit({"event": "done", "test_rmse": rmse(pred, test["rating"]),
          "seconds": time.perf_counter() - t0})

    if args.topk:
        from fps_tpu_torch.models.recommendation import (
            mf_user_vectors,
            recommend_topk,
        )

        users = np.unique(test["user"])[:8]
        q = mf_user_vectors(local_state.numpy(), W, users)
        ids, scores = recommend_topk(store, ITEM_TABLE, q, args.topk)
        for u, row_i, row_s in zip(users, ids, scores):
            emit({"event": "topk", "user": int(u), "items": row_i.tolist(),
                  "scores": np.round(row_s, 4).tolist()})
    finish(args, store, recorder=rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
