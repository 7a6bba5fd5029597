"""Implicit-feedback iALS on the PyTorch port.

Port of ``fps_tpu/examples/ials.py`` with the flags the port supports: the
tables sharded over ``--num-shards`` positions (``--num-data`` is held at 1,
as in the JAX package's example; the solver itself takes a data axis),
``--ingest device`` (the interactions resident on the device, each
chunk built there) or ``--ingest host`` (numpy chunks copied over);
``--prefetch N`` assembles and places them N chunks ahead on a worker
thread.
Alternating normal-equation solves (``fps_tpu_torch.models.ials``). Prints
one JSON line per event: ``start``, an ``epoch`` event with the weighted
loss and the epoch's seconds (its weighted loss on the host included), and
``done`` with the held-out recall@k. ``--checkpoint-dir`` with
``--checkpoint-every N`` saves both factor tables every N epochs, which
``--serve-port`` serves while the solver runs.

    python -m fps_tpu_torch.examples.ials --device cpu
    python -m fps_tpu_torch.examples.ials --num-users 32768 --num-items 16384 --per-user 64 --data-rank 8 --local-batch 65536 --steps-per-chunk 4 --topk 20 --epochs 8

(the second is ``bench.py run_ials``'s data and batching).
"""

from __future__ import annotations

import contextlib
import time

import numpy as np

from fps_tpu_torch.examples.common import (
    apply_hot_tier,
    attach_obs,
    base_parser,
    emit,
    make_epoch_source,
    make_mesh,
    make_watchdog,
    maybe_checkpointer,
    maybe_serve,
)


def main(argv=None) -> int:
    ap = base_parser("Implicit-feedback iALS on the PyTorch parameter server")
    ap.add_argument("--input", default=None,
                    help="u.data-format ratings file, ratings clipped at 0 "
                         "(default: synthetic implicit interactions)")
    ap.add_argument("--num-users", type=int, default=2_000)
    ap.add_argument("--num-items", type=int, default=1_000)
    ap.add_argument("--per-user", type=int, default=20)
    ap.add_argument("--data-rank", type=int, default=4,
                    help="rank of the synthetic data's planted preference")
    ap.add_argument("--rank", type=int, default=16)
    ap.add_argument("--alpha", type=float, default=40.0)
    ap.add_argument("--reg", type=float, default=0.1)
    ap.add_argument("--topk", type=int, default=10)
    args = ap.parse_args(argv)
    args.num_data = 1  # the solver takes a data axis; the example shards
    if args.profile:
        ap.error("--profile: the iALS example has no chunk loop to trace")

    from fps_tpu_torch.models.ials import IALSConfig, IALSSolver, recall_at_k
    from fps_tpu_torch.utils.datasets import (
        load_movielens,
        synthetic_implicit,
        train_test_split,
    )

    if args.input:
        data, nu, ni = load_movielens(args.input, "20m")
        data["rating"] = np.maximum(data["rating"], 0.0)
    else:
        nu, ni = args.num_users, args.num_items
        data = synthetic_implicit(nu, ni, args.per_user, rank=args.data_rank,
                                  seed=args.seed)
    train, test = train_test_split(data, test_frac=0.1, seed=args.seed + 1)

    mesh = make_mesh(args)
    emit({"event": "start", "workload": "ials", "num_users": nu,
          "num_items": ni, "interactions": len(train["user"]),
          "ingest": args.ingest, "mesh": dict(mesh.shape),
          "device": str(mesh.device)})

    apply_hot_tier(args, None)  # no pull/push trainer to tier
    solver = IALSSolver(mesh, IALSConfig(num_users=nu, num_items=ni,
                                         rank=args.rank, alpha=args.alpha,
                                         reg=args.reg))
    # The solver drives its own loop, so --prefetch lands on it directly.
    if args.prefetch < 0:
        raise SystemExit(f"--prefetch must be >= 0, got {args.prefetch}")
    solver.prefetch = args.prefetch
    solver.init(args.seed)
    # The solver drives its own loop (no Trainer): the recorder journals
    # the run, and its epochs are recorded below.
    rec = attach_obs(args, workload="ials")
    wd = make_watchdog(args, rec)
    ckpt = maybe_checkpointer(args)
    # The interactions split over every device (no worker-local state to
    # route for); each epoch consumes its chunks twice, once a side.
    source = make_epoch_source(args, mesh, train)
    t0 = time.perf_counter()
    with maybe_serve(args, rec):
        for epoch in range(args.epochs):
            te = time.perf_counter()
            with (wd.watch("epoch", epoch) if wd is not None
                  else contextlib.nullcontext()):
                solver.epoch(lambda e=epoch: source(e, 1))
            loss = solver.weighted_loss(train["user"], train["item"],
                                        train["rating"])
            emit({"event": "epoch", "epoch": epoch, "weighted_loss": loss,
                  "seconds": time.perf_counter() - te})
            if rec is not None:
                rec.inc("driver.epochs")
                rec.event("epoch", index=epoch, weighted_loss=float(loss))
            if ckpt is not None and (epoch + 1) % args.checkpoint_every == 0:
                ckpt.save(epoch + 1, solver.store)
        if ckpt is not None:
            # The solver drives its own loop, so it owns the durability
            # barrier the Trainer's drivers give: the async writer's last
            # snapshot is on disk before the run reports done.
            ckpt.flush()
    r = recall_at_k(solver, test["user"][:2000], test["item"][:2000],
                    k=args.topk, exclude=(train["user"], train["item"]))
    emit({"event": "done", f"recall_at_{args.topk}": r,
          "seconds": time.perf_counter() - t0})
    if rec is not None:
        rec.close()  # the journal's run_end and the final flush
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
