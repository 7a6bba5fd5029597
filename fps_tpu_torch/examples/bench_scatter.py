"""Scatter-add and gather routes on the card at the workloads' shapes.

Port of ``tools/bench_scatter.py``, with the same shapes, the same
popularity id draw (``p ~ 1 / rank^alpha``, ``default_rng(0)``) and the
same ``T = 256`` steps:

* ``run`` (no argument): the five shapes of the reference (the MF item
  mean push at D + 1, the raw MF item, the MF user, the logreg shard and
  w2v at one card), each timed three ways: the library ``index_add_``
  (where the reference times XLA), K3 over the whole table (``hot_rows =
  R``, the reference's packed arm) and K2, the port's other route.
* ``dim1``: the PA shape (R 47,236, B 2^20, Zipf 0.9): K4 and K5 against
  ``index_add_`` and ``index_select``.
* ``sweep``: K3 over the whole table against K2 and the library at small
  R (256 to 16,384 rows) by D (10, 32, 100), B 32,768. A shape past four
  times ``fps_tpu_torch.ops.packed_crossover_rows(D)`` (the
  ``hot_ids="auto"`` policy, measured on the H100) is skipped: the policy
  never sends it to K3 (the reference's skip is its TPU flop budget).

The table and ids come from numpy as in the reference; the deltas (5 GB at
the w2v shape) are made on the device from a seed. Every shape's spot
checks are gates: K3's and K2's results (and K4's) within the float32
bound of the exact sum, as the library's, on step 0; K5's equal to the
library's. Times as :mod:`fps_tpu_torch.utils.route_timing` sets out, µs a
step, with the bytes bound of step 0. One JSON line a shape, after the
card's line.

Run:
  python -m fps_tpu_torch.examples.bench_scatter [sweep|dim1]
      [--device cpu] [--iters T] [--scale F]
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
import torch  # noqa: E402

from fps_tpu_torch import ops  # noqa: E402
from fps_tpu_torch.utils import route_timing as rt  # noqa: E402

T = 256
# (name, R, D, B, alpha): the reference's run() shapes.
SHAPES = (
    ("MF item (mean push D+1)", 26744, 11, 32768, 0.8),
    ("MF item (raw)", 26744, 10, 32768, 0.8),
    ("MF user", 138496, 10, 32768, 0.8),
    ("logreg shard (1/8 of 1M)", 131072, 2, 16384 * 39 // 8, 0.8),
    ("w2v 1chip", 50000, 100, 49152, 0.75),
)
DIM1_R, DIM1_B, DIM1_ALPHA = 47_236, 16_384 * 64, 0.9
SWEEP_B = 32768
SWEEP_D = (10, 32, 100)
SWEEP_R = (256, 1024, 2048, 4096, 8192, 16384)

# Each arm updates ``table`` in place with one step's ``ids`` and
# ``deltas``, or reads ``table`` at ``ids``; K2-K5 through
# ``fps_tpu_torch.ops``, which takes the plain versions on the CPU.
SCATTERS = {
    "library index_add_": lambda t, i, d: t.index_add_(0, i, d),
    "K3 whole table": lambda t, i, d: ops.scatter_add_(
        t, i, d, hot_rows=t.shape[0]),
    "K2": lambda t, i, d: ops.scatter_add_(t, i, d),
}
DIM1_SCATTERS = {
    "library index_add_": SCATTERS["library index_add_"],
    "K4": lambda t, i, d: ops.scatter_add_(t, i, d),
}
DIM1_GATHERS = {
    "library index_select": lambda t, i: t.index_select(0, i),
    "K5": lambda t, i: ops.gather_rows(t, i),
}


def draw(R: int, D: int, B: int, alpha: float, iters: int,
         device: torch.device):
    """``(table, ids)`` as the reference draws them from ``default_rng(0)``
    (the table first, then the ``(T, B)`` ids), and the ``(T, B, D)``
    deltas made on the device."""
    rng = np.random.default_rng(0)
    tab = rng.normal(0, 0.1, (R, D)).astype(np.float32)
    ids = rt.popularity_ids(rng, R, (iters, B), alpha)
    return tab, ids, rt.device_normal((iters, B, D), 1e-4, 1, device)


def run(name: str, R: int, D: int, B: int, alpha: float, device, card, *,
        iters: int = T, part: str = "run") -> dict:
    """One shape: the library, K3 over the whole table, and K2."""
    tab_np, ids_np, deltas = draw(R, D, B, alpha, iters, device)
    tab, ids = rt.on(device, tab_np), rt.on(device, ids_np)
    times = {}
    for arm, op in SCATTERS.items():
        state = tab.clone()
        times[arm] = rt.time_steps(
            lambda t, op=op, state=state: op(state, ids[t], deltas[t]),
            iters, device)
    library = tab.clone().index_add_(0, ids[0], deltas[0])
    checks = [rt.check_scatter(
        f"{name}: {arm} vs exact", tab, ids[0], deltas[0],
        SCATTERS[arm](tab.clone(), ids[0], deltas[0]), library)
        for arm in ("K3 whole table", "K2")]
    return rt.emit({
        "tool": "bench_scatter", "part": part, "shape": name, "R": R,
        "D": D, "B": B, "T": iters, "alpha": alpha,
        "dup_frac": rt.dup_frac(ids_np[0]),
        "bound_us": rt.scatter_bound_us(ids_np[0], D), "arms": times,
        "checks": checks, "device": str(device), "card": card})


def main_shapes(device, card, *, iters: int = T, scale: float = 1.0):
    return [run(name, rt.scaled(R, scale), D, rt.scaled(B, scale), alpha,
                device, card, iters=iters)
            for name, R, D, B, alpha in SHAPES]


def dim1_shapes(device, card, *, iters: int = T, scale: float = 1.0
                ) -> dict:
    """The scalar-table kernels at the PA shape: K4 and K5 against the
    library's scatter-add and gather."""
    R, B = rt.scaled(DIM1_R, scale), rt.scaled(DIM1_B, scale)
    tab_np, ids_np, deltas = draw(R, 1, B, DIM1_ALPHA, iters, device)
    tab, ids = rt.on(device, tab_np), rt.on(device, ids_np)
    scatters, gathers = DIM1_SCATTERS, DIM1_GATHERS
    times = {}
    for arm, op in scatters.items():
        state = tab.clone()
        times[arm] = rt.time_steps(
            lambda t, op=op, state=state: op(state, ids[t], deltas[t]),
            iters, device)
    for arm, op in gathers.items():
        times[arm] = rt.time_steps(lambda t, op=op: op(tab, ids[t]), iters,
                                   device)
    checks = [
        rt.check_scatter("PA shape: K4 vs exact", tab, ids[0], deltas[0],
                         scatters["K4"](tab.clone(), ids[0], deltas[0]),
                         tab.clone().index_add_(0, ids[0], deltas[0])),
        rt.check_gather("PA shape: K5 vs library", gathers["K5"](tab, ids[0]),
                        tab.index_select(0, ids[0]))]
    return rt.emit({
        "tool": "bench_scatter", "part": "dim1", "shape": "PA", "R": R,
        "D": 1, "B": B, "T": iters, "alpha": DIM1_ALPHA,
        "dup_frac": rt.dup_frac(ids_np[0]),
        "bound_us": {"scatter": rt.scatter_bound_us(ids_np[0], 1),
                     "gather": rt.gather_bound_us(ids_np[0], 1)},
        "arms": times, "checks": checks, "device": str(device),
        "card": card})


def small_r_sweep(device, card, *, iters: int = T, scale: float = 1.0
                  ) -> list[dict]:
    """K3 over the whole table against K2 and the library at small R by D;
    shapes the ``hot_ids="auto"`` policy keeps far from K3 are skipped."""
    out = []
    for D in SWEEP_D:
        budget = 4 * ops.packed_crossover_rows(D)
        for R in SWEEP_R:
            if R > budget:
                out.append(rt.emit({
                    "tool": "bench_scatter", "part": "sweep", "D": D,
                    "R": R, "skipped": f"R > 4 x packed_crossover_rows({D})"
                    f" = {budget}", "card": card}))
                continue
            out.append(run(f"sweep D={D}", rt.scaled(R, scale), D,
                           rt.scaled(SWEEP_B, scale), 0.8, device, card,
                           iters=iters, part="sweep"))
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("part", nargs="?", default="run",
                    choices=["run", "sweep", "dim1"],
                    help="run (default): the five workload shapes; sweep: "
                         "the small-R sweep; dim1: the PA shape")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--iters", type=int, default=T,
                    help="steps of each timed pass (T)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cut R and B by this factor (tests)")
    args = ap.parse_args(argv)
    device = rt.device_arg(args.device)
    card = rt.card_line(device)
    print(card, flush=True)
    {"run": main_shapes, "sweep": small_r_sweep, "dim1": dim1_shapes}[
        args.part](device, card, iters=args.iters, scale=args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
