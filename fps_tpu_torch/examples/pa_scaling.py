"""Weak-scaling curve of passive-aggressive over the positions of a mesh.

Port of ``tools/pa_scaling.py``: the same PA-I workload (47,236 features,
64 non-zeros an example, 65,536 examples a worker, local batch 4,096,
calls of 8 steps, data seed 3), the same ``auto`` / ``dense`` /
``gathered`` routes of the weight table, and W over {1, 2, 4, 8} positions
of a ``(1, W)`` mesh at a fixed batch a worker (weak scaling: the work
grows with W). Each point runs a warm-up epoch, then 3 timed
``run_indexed`` epochs (``--iters``), and reports the median and range of
their seconds, the aggregate examples a second, its ratio to W = 1, and
the work an example relative to W = 1 (``rate(1) / rate(W)``).

What the curve measures here: the positions are spread round-robin over
the visible cards, and on a one-card host they all share that card, driven
by one process. So the curve is a single controller's host cost as the
positions grow, not scaling over cards: a flat work an example would mean
the cost of an example does not grow with W. ``auto`` keeps the gathered
route in the port (the JAX package's dense threshold was measured on a
TPU's interconnect). Nothing is re-executed: the port's positions may
share a device, where the reference needs a subprocess with virtual XLA
devices.

Run:
  python -m fps_tpu_torch.examples.pa_scaling [auto] [dense] [gathered]
      [--device cpu] [--iters E] [--scale F]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import statistics
import sys
import time

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__" and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from fps_tpu_torch.core.device_ingest import (  # noqa: E402
    DeviceDataset,
    DeviceEpochPlan,
)
from fps_tpu_torch.entry import positions  # noqa: E402
from fps_tpu_torch.models.passive_aggressive import (  # noqa: E402
    WEIGHT_TABLE,
    PAConfig,
    passive_aggressive,
)
from fps_tpu_torch.parallel.mesh import make_ps_mesh  # noqa: E402
from fps_tpu_torch.utils import route_timing as rt  # noqa: E402
from fps_tpu_torch.utils.datasets import (  # noqa: E402
    synthetic_sparse_classification,
)

PER_WORKER_EX = 65_536
LOCAL_BATCH = 4_096
NF, NNZ = 47_236, 64
WS = (1, 2, 4, 8)
ROUTES = ("auto", "dense", "gathered")
EPOCHS = 3


def data_for(W: int, scale: float = 1.0) -> dict:
    """The reference's data for W workers: ``65,536 W`` examples (cut by
    ``scale``) from seed 3."""
    return synthetic_sparse_classification(
        rt.scaled(PER_WORKER_EX, scale) * W, NF, NNZ, seed=3, noise=0.05)


def point(route: str, W: int, data: dict, device, card, *,
          epochs: int = EPOCHS, scale: float = 1.0) -> dict:
    """One point of the curve: PA-I over ``(1, W)`` on ``route``; a warm-up
    epoch, then ``epochs`` timed ones."""
    mesh = make_ps_mesh(W, 1, devices=positions(W, device))
    trainer, store = passive_aggressive(
        mesh, PAConfig(num_features=NF, variant="PA-I", C=1.0),
        max_steps_per_call=8)
    if route != "auto":
        store.specs[WEIGHT_TABLE] = dataclasses.replace(
            store.specs[WEIGHT_TABLE], dense_collectives=(route == "dense"))
    tables, ls = trainer.init_state(0)
    plan = DeviceEpochPlan(DeviceDataset(mesh, data), num_workers=W,
                           local_batch=rt.scaled(LOCAL_BATCH, scale), seed=1)
    tables, ls, _ = trainer.run_indexed(tables, ls, plan, 9)
    seconds, examples = [], 0.0
    for r in range(epochs):
        for dev in set(mesh.positions):
            rt.sync(dev)
        t0 = time.perf_counter()
        tables, ls, m = trainer.run_indexed(tables, ls, plan, 1 + r)
        seconds.append(time.perf_counter() - t0)  # the metrics' host read
        examples = float(m[0]["n"].sum())           # waited for the card
    nex = len(data["label"])
    if examples != nex:
        raise AssertionError(f"PA {route} W={W}: an epoch processed "
                             f"{examples} of {nex} examples")
    med = statistics.median(seconds)
    return {"tool": "pa_scaling", "route": route, "W": W, "examples": nex,
            "steps_per_epoch": plan.steps_per_epoch, "seconds": med,
            "seconds_range": [min(seconds), max(seconds)],
            "ex_per_s": nex / med, "device": str(device), "card": card}


def run_curves(routes, device, card, *, epochs: int = EPOCHS,
               scale: float = 1.0, ws=WS) -> list[dict]:
    """Every route's curve over ``ws``, each W's data made once; one JSON
    line a point, with its ratios to the route's W = 1."""
    data = {W: data_for(W, scale) for W in ws}
    out = []
    for route in routes:
        base = None
        for W in ws:
            p = point(route, W, data[W], device, card, epochs=epochs,
                      scale=scale)
            base = base or p["ex_per_s"]
            p["rate_vs_w1"] = p["ex_per_s"] / base
            p["work_per_example_vs_w1"] = base / p["ex_per_s"]
            out.append(rt.emit(p))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("routes", nargs="*",
                    help="of auto / dense / gathered (default: dense "
                         "gathered, as the reference)")
    ap.add_argument("--device", default=None,
                    help="every position on this device (default: the "
                         "visible cards; 'cpu' for the CPU)")
    ap.add_argument("--iters", type=int, default=EPOCHS,
                    help="timed epochs a point")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cut the examples and batch a worker (tests)")
    args = ap.parse_args(argv)
    routes = args.routes or ["dense", "gathered"]
    bad = [r for r in routes if r not in ROUTES]
    if bad:
        ap.error(f"unknown route(s) {bad!r}; choose from auto / dense / "
                 "gathered")
    device = rt.device_arg(args.device)
    card = rt.card_line(device)
    print(card, flush=True)
    run_curves(routes, None if args.device is None else device, card,
               epochs=args.iters, scale=args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
