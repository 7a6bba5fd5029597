"""Unbounded-stream online MF on the PyTorch port.

Port of ``fps_tpu/examples/streaming_mf.py``: an unbounded source (a
synthetic rating generator, ``streaming_rating_batches``; any iterator of
columnar batches would do), framed into fixed-shape chunks as records
buffer (``core.ingest.stream_chunks``, keyed by user), and ``fit_stream``
training on each chunk as it arrives, the ``WOut`` metrics reported live.
The stream stops on ``--max-records`` (the source dries up) or, with
``--target-rmse``, as soon as a chunk's train RMSE falls below it (raised
from the ``on_chunk`` callback). The chunks always come from the host, as an
unbounded stream does; ``--ingest`` is not read.

    python -m fps_tpu_torch.examples.streaming_mf --device cpu --max-records 50000 --local-batch 1024
    python -m fps_tpu_torch.examples.streaming_mf --device cpu --max-records 0 --target-rmse 0.3

``--profile DIR`` traces one chunk on the card (see
:mod:`fps_tpu_torch.examples.common`).
"""

from __future__ import annotations

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
    make_mesh,
    profiler,
)


class _TargetReached(Exception):
    pass


def main(argv=None) -> int:
    ap = base_parser("Unbounded-stream online MF on the PyTorch parameter "
                     "server")
    ap.add_argument("--num-users", type=int, default=500)
    ap.add_argument("--num-items", type=int, default=300)
    ap.add_argument("--rank", type=int, default=8)
    ap.add_argument("--learning-rate", type=float, default=0.1)
    ap.add_argument("--max-records", type=int, default=500_000,
                    help="stop when the source has produced this many "
                         "records (0 = run until --target-rmse)")
    ap.add_argument("--target-rmse", type=float, default=None,
                    help="stop as soon as a chunk's train RMSE falls below")
    ap.add_argument("--source-batch", type=int, default=4096)
    args = ap.parse_args(argv)
    if args.max_records <= 0 and args.target_rmse is None:
        ap.error("an unbounded source (--max-records 0) needs --target-rmse "
                 "as its stop condition")

    from fps_tpu_torch.core.ingest import stream_chunks
    from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
    from fps_tpu_torch.parallel.mesh import num_workers_of
    from fps_tpu_torch.utils.datasets import streaming_rating_batches

    mesh = make_mesh(args)
    W = num_workers_of(mesh)
    emit({"event": "start", "workload": "streaming_mf",
          "mesh": dict(mesh.shape), "device": str(mesh.device)})

    cfg = MFConfig(num_users=args.num_users, num_items=args.num_items,
                   rank=args.rank, learning_rate=args.learning_rate)
    trainer, store = online_mf(mesh, cfg, sync_every=args.sync_every,
                               guard=make_guard(args))
    apply_host_pipeline(args, trainer)
    apply_hot_tier(args, trainer)
    rec = attach_obs(args, trainer, workload="streaming_mf")
    tables, local_state = trainer.init_state(args.seed)
    tables = maybe_warm_start(args, store, tables)

    source = streaming_rating_batches(
        args.num_users, args.num_items, rank=args.rank, seed=args.seed,
        batch=args.source_batch,
        max_records=args.max_records if args.max_records > 0 else None)
    chunks = stream_chunks(
        source, num_workers=W, local_batch=args.local_batch,
        steps_per_chunk=args.steps_per_chunk, route_key="user",
        sync_every=args.sync_every)

    prof, prof_step = profiler(args, mesh.device)
    seen = 0.0

    def on_chunk(i, m):
        nonlocal seen
        n = max(1.0, float(np.sum(m["n"])))
        seen += n
        train_rmse = float(np.sqrt(np.sum(m["se"]) / n))
        emit({"event": "chunk", "i": i, "train_rmse": train_rmse,
              "records_seen": seen})
        prof_step()
        if args.target_rmse is not None and train_rmse < args.target_rmse:
            raise _TargetReached

    try:
        with prof, maybe_serve(args, rec):
            trainer.fit_stream(tables, local_state, chunks, args.seed,
                               on_chunk=on_chunk,
                               watchdog=make_watchdog(args, rec),
                               **durability(args))
        stopped = "stream_exhausted"
    except _TargetReached:
        stopped = "target_rmse"
    emit({"event": "done", "stopped_by": stopped, "records_seen": seen})
    finish(args, store, recorder=rec)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
