"""Ms a step of online MF at ML-20M width on a mesh, for comparing trees.

The single-controller mesh runs a one-position mesh through the same code
as a mesh of several positions. This times what a step costs there: MF
(rank 10, lr 0.1, mean combine, the global batch of 32,768) through
``run_indexed`` over the data of ``load_movielens(None, "20m")``, a warm-up
epoch and then ``--epochs`` timed epochs sync, each timed by the host's
clock between two synchronisations of the card.

``--tree`` imports ``fps_tpu_torch`` from another checkout, so that two
trees can be compared in one run on the card (a tree before the mesh
takes only ``--shape 1x1``); ``--shape`` takes a comma-separated list,
timed one after the other over the same data:

    python3 fps_tpu_torch/utils/mesh_step_cost.py --tree DIR --shape 1x1,1x4

prints one JSON line a shape: the tree, the card's name and power limit,
the mesh, ms a step of each timed epoch and the launch counts a step.
``--device cpu --ratings 200000`` runs on the CPU at a hundredth of the
data (a check of the script, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

USERS, ITEMS, RATINGS = 138_493, 26_744, 20_000_263
BATCH = 32_768


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tree", default=None,
                    help="checkout to import fps_tpu_torch from")
    ap.add_argument("--shape", default="1x1",
                    help="data x shard, or several, comma-separated")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--ratings", type=int, default=RATINGS)
    args = ap.parse_args(argv)
    tree = os.path.abspath(args.tree or os.path.join(
        os.path.dirname(__file__), "..", ".."))
    sys.path.insert(0, tree)
    import torch

    import fps_tpu_torch as fps
    from fps_tpu_torch.ops import kernels
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    cuda = args.device.startswith("cuda")
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = False
    data = synthetic_ratings(USERS, ITEMS, args.ratings)
    card = (subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=False).stdout.strip() if cuda else "cpu")
    for shape in args.shape.split(","):
        D, S = (int(x) for x in shape.split("x"))
        W = D * S
        mesh = (fps.make_ps_mesh(device=args.device) if W == 1
                else fps.make_ps_mesh(S, D, device=args.device))
        cfg = fps.MFConfig(num_users=USERS, num_items=ITEMS, rank=10,
                           learning_rate=0.1, reg=0.01)
        trainer, _ = fps.online_mf(mesh, cfg, combine="mean",
                                   max_steps_per_call=64)
        plan = fps.DeviceEpochPlan(fps.DeviceDataset(mesh, data),
                                   num_workers=W, local_batch=BATCH // W,
                                   route_key="user", seed=0)
        tables, local = trainer.init_state(0)
        tables, local, _ = trainer.run_indexed(tables, local, plan, 1)
        ms = []
        for e in range(1, args.epochs + 1):
            sync()
            kernels.reset_launch_counts()
            t0 = time.perf_counter()
            tables, local, _ = trainer.run_indexed(tables, local, plan, 1,
                                                   start_epoch=e)
            sync()
            ms.append((time.perf_counter() - t0) / plan.steps_per_epoch
                      * 1e3)
        print(json.dumps({
            "tree": tree, "card": card, "mesh": dict(mesh.shape),
            "steps_per_epoch": plan.steps_per_epoch, "ms_per_step": ms,
            "launches_per_step": {k: v / plan.steps_per_epoch
                                  for k, v in kernels.launch_counts().items()
                                  if v}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
