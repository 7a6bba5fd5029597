"""Scalar-table routes on the card at the logistic-regression shape.

Port of ``tools/bench_logreg_routes.py``. The logreg workload pushes and
pulls a 1M-row scalar table: B = 16,384 examples x 26 sparse slots =
425,984 ids a step, Zipf(0.9) ids from :func:`make_ids` (the reference's
draw and seeds), T = 256 steps. The stages, by the reference's names:

* ``a``: the library's scatter-add and gather (``index_add_``,
  ``index_select``) on the full stream, with the head coverage at H in
  {16k, 64k, 128k}.
* ``b1`` / ``b2``: K4 and K5 over the whole table at R in {131k, 262k}
  and {524k, 1M}, beside the library.
* ``c``: K4 and K5 through the head route over ``table[:H]`` on the full
  stream, H in {16k, 64k, 128k}: K4 on the head view (ids past H
  dropped), K5 with ``head_rows = H`` and ``head_prefix = B`` (every
  position reads against the head).
* ``d``: the library on reduced column counts (4, 8, 12, 16 slots).
* ``pa_head``: the PA shape's ceiling (R 47,236, B 2^20, H 2,048): K4 and
  K5 over the whole table against the head route.
* ``tune``: the launch parameters K4's plan (``kernels.Dim1Plan``) exposes,
  in place of the Pallas kernel's ``batch_tile``: the tile pass's clusters
  at the card's plan, a half and a quarter of it, on the H = 64k head. On
  the CPU there is no plan: the stage says so and times the default.

The ids are the reference's. Its tables and deltas come from numpy's
``default_rng(1)`` (``3`` at the PA shape), the deltas first; the port
makes the deltas on the device from a seed, so its tables are drawn from
the same seeds but are not the reference's values. Every stage's spot
checks are gates: K4 within the float32 bound of the
exact sum (as the library), K5 equal to the library's gather. Times as
:mod:`fps_tpu_torch.utils.route_timing` sets out, in µs a step. One JSON
line a stage row, after the card's line.

Run:
  python -m fps_tpu_torch.examples.bench_logreg_routes [a b1 b2 c d
      pa_head tune] [--device cpu] [--iters T] [--scale F]
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
from fps_tpu_torch.ops import kernels  # noqa: E402
from fps_tpu_torch.utils import route_timing as rt  # noqa: E402

T = 256
R_FULL = 1_000_000
B_EX, NNZ = 16_384, 26
B = B_EX * NNZ
ALPHA = 0.9
HEADS = (16_384, 65_536, 131_072)
PA_R, PA_B, PA_H = 47_236, 16_384 * 64, 2_048
TUNE_H = 65_536


def make_ids(R, B, T_, alpha=ALPHA, seed=0):
    """The reference's ``make_ids``: ``(T_, B)`` int32 popularity ids over
    ``R`` rows from ``default_rng(seed)``."""
    return rt.popularity_ids(np.random.default_rng(seed), R, (T_, B), alpha)


class Stage:
    """One stage's sizes, device, card line and the rows it emits."""

    def __init__(self, name, device, card, iters, scale):
        self.name, self.device, self.card = name, device, card
        self.iters, self.scale = iters, scale
        self.R = rt.scaled(R_FULL, scale)
        self.B = rt.scaled(B, scale)
        self.rows: list[dict] = []

    def row(self, **fields) -> dict:
        self.rows.append(rt.emit({"tool": "bench_logreg_routes",
                                  "stage": self.name, **fields,
                                  "T": self.iters, "device": str(self.device),
                                  "card": self.card}))
        return self.rows[-1]

    def table(self, rng, R) -> torch.Tensor:
        return rt.on(self.device, rng.normal(0, 0.1, (R, 1)).astype(
            np.float32))

    def deltas(self, B_, seed=1) -> torch.Tensor:
        return rt.device_normal((self.iters, B_, 1), 1e-4, seed, self.device)

    def scatter(self, op, tab, ids, deltas) -> dict:
        state = tab.clone()
        return rt.time_steps(lambda t: op(state, ids[t], deltas[t]),
                             self.iters, self.device)

    def gather(self, op, tab, ids) -> dict:
        return rt.time_steps(lambda t: op(tab, ids[t]), self.iters,
                             self.device)


def lib_scatter(t, i, d):
    return t.index_add_(0, i, d)


def lib_gather(t, i):
    return t.index_select(0, i)


def k4(t, i, d):
    return ops.scatter_add_(t, i, d)


def k5(t, i):
    return ops.gather_rows(t, i)


def head_k4(H):
    """K4 on the head view ``table[:H]``: pushes to ids past H dropped."""
    return lambda t, i, d: ops.scatter_add_(t[:H], i, d)


def head_k5(H):
    """K5's head route: every position reads against ``table[:H]``."""
    return lambda t, i: ops.gather_rows(t, i, hot_rows=H,
                                        head_prefix=i.shape[0])


def checks(label, tab, ids, deltas, scatter, gather, H=None) -> list[dict]:
    """The gates on step 0: the scatter within the float32 bound of the
    exact sum, the gather equal to the library's (on the head: ids past H
    read zero)."""
    want_ids = ids[0] if H is None else torch.where(ids[0] < H, ids[0], -1)
    view = tab if H is None else tab[:H]
    got = scatter(tab.clone(), ids[0], deltas[0])
    got = got if H is None else got[:H]
    library = view.clone().index_add_(0, ids[0][ids[0] < view.shape[0]],
                                      deltas[0][ids[0] < view.shape[0]])
    return [rt.check_scatter(f"{label}: K4 vs exact", view, ids[0],
                             deltas[0], got, library),
            rt.check_gather(f"{label}: K5 vs library", gather(tab, ids[0]),
                            kernels.gather_rows_plain(tab, want_ids))]


def stage_a(st: Stage):
    rng = np.random.default_rng(1)
    ids_np = make_ids(st.R, st.B, st.iters)
    ids = rt.on(st.device, ids_np)
    deltas = st.deltas(st.B)
    tab = st.table(rng, st.R)
    heads = {H: float(np.mean(ids_np[0] < rt.scaled(H, st.scale)))
             for H in HEADS}
    st.row(row="library, full stream", R=st.R, B=st.B,
           dup_frac=rt.dup_frac(ids_np[0]), head_coverage=heads,
           scatter=st.scatter(lib_scatter, tab, ids, deltas),
           gather=st.gather(lib_gather, tab, ids),
           bound_us={"scatter": rt.scatter_bound_us(ids_np[0], 1),
                     "gather": rt.gather_bound_us(ids_np[0], 1)})


def stage_b(st: Stage, rs):
    rng = np.random.default_rng(1)
    deltas = st.deltas(st.B)
    for R in rs:
        R = rt.scaled(R, st.scale)
        tab = st.table(rng, R)
        ids_np = make_ids(R, st.B, st.iters, seed=2)
        ids = rt.on(st.device, ids_np)
        st.row(row=f"R={R}", R=R, B=st.B,
               scatter={"library": st.scatter(lib_scatter, tab, ids, deltas),
                        "K4": st.scatter(k4, tab, ids, deltas)},
               gather={"library": st.gather(lib_gather, tab, ids),
                       "K5": st.gather(k5, tab, ids)},
               bound_us={"scatter": rt.scatter_bound_us(ids_np[0], 1),
                         "gather": rt.gather_bound_us(ids_np[0], 1)},
               checks=checks(f"b R={R}", tab, ids, deltas, k4, k5))


def stage_c(st: Stage):
    rng = np.random.default_rng(1)
    ids = rt.on(st.device, make_ids(st.R, st.B, st.iters))
    deltas = st.deltas(st.B)
    tab = st.table(rng, st.R)
    for H in HEADS:
        H = rt.scaled(H, st.scale)
        st.row(row=f"head H={H}, full stream", H=H, R=st.R, B=st.B,
               scatter=st.scatter(head_k4(H), tab, ids, deltas),
               gather=st.gather(head_k5(H), tab, ids),
               checks=checks(f"c H={H}", tab, ids, deltas, head_k4(H),
                             head_k5(H), H=H))


def stage_d(st: Stage):
    rng = np.random.default_rng(1)
    ids_np = make_ids(st.R, st.B, st.iters)
    deltas = st.deltas(st.B)
    tab = st.table(rng, st.R)
    for cols in (4, 8, 12, 16):
        bt = min(st.B, rt.scaled(B_EX, st.scale) * cols)
        it = rt.on(st.device, ids_np[:, :bt])
        dt = deltas[:, :bt].contiguous()
        st.row(row=f"library tail cols={cols}", cols=cols, B=bt, R=st.R,
               scatter=st.scatter(lib_scatter, tab, it, dt),
               gather=st.gather(lib_gather, tab, it))


def stage_pa_head(st: Stage):
    """The PA shape: if the head route costs about what the whole-table
    kernels cost, a guaranteed-prefix scheme has little to win."""
    R, Bp, H = (rt.scaled(PA_R, st.scale), rt.scaled(PA_B, st.scale),
                rt.scaled(PA_H, st.scale))
    rng = np.random.default_rng(3)
    tab = st.table(rng, R)
    ids = rt.on(st.device, make_ids(R, Bp, st.iters, seed=4))
    deltas = rt.device_normal((st.iters, Bp, 1), 1e-4, 3, st.device)
    st.row(row=f"PA whole table R={R}", R=R, B=Bp,
           scatter=st.scatter(k4, tab, ids, deltas),
           gather=st.gather(k5, tab, ids),
           checks=checks("pa whole", tab, ids, deltas, k4, k5))
    st.row(row=f"PA head H={H}", H=H, R=R, B=Bp,
           scatter=st.scatter(head_k4(H), tab, ids, deltas),
           gather=st.gather(head_k5(H), tab, ids),
           checks=checks("pa head", tab, ids, deltas, head_k4(H), head_k5(H),
                         H=H))


def stage_tune(st: Stage):
    """K4's clusters on the head H = 64k at the logreg shape."""
    rng = np.random.default_rng(1)
    ids = rt.on(st.device, make_ids(st.R, st.B, st.iters))
    deltas = st.deltas(st.B)
    tab = st.table(rng, st.R)
    H = rt.scaled(TUNE_H, st.scale)
    if st.device.type != "cuda":
        st.row(row=f"head H={H}, default", H=H, B=st.B,
               note="no K4 plan on the CPU: the plain version, default",
               scatter=st.scatter(head_k4(H), tab, ids, deltas))
        return
    plan = kernels.card_dim1_plan(st.device, st.B, H)
    for clusters in sorted({plan.clusters, max(1, plan.clusters // 2),
                            max(1, plan.clusters // 4)}, reverse=True):
        p = plan._replace(clusters=clusters, kernels=(
            (2 if plan.buckets > 1 else 0) + 1 + (clusters > 1)))

        def op(t, i, d, p=p):
            return kernels.scatter_add_dim1_cuda_(t[:H], i, d, plan=p)

        st.row(row=f"head H={H}, clusters={clusters} of {plan.cluster} "
               "blocks", H=H, B=st.B, plan=p._asdict(),
               scatter=st.scatter(op, tab, ids, deltas),
               checks=checks(f"tune clusters={clusters}", tab, ids, deltas,
                             op, head_k5(H), H=H))


STAGES = {
    "a": stage_a,
    "b1": lambda st: stage_b(st, [131_072, 262_144]),
    "b2": lambda st: stage_b(st, [524_288, 1_000_000]),
    "c": stage_c,
    "d": stage_d,
    "pa_head": stage_pa_head,
    "tune": stage_tune,
}


def run_stages(names, device, card, *, iters: int = T,
               scale: float = 1.0) -> list[dict]:
    """Run the named stages in order; returns every row emitted."""
    out = []
    for name in names:
        st = Stage(name, device, card, iters, scale)
        STAGES[name](st)
        out += st.rows
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("stages", nargs="*",
                    help=f"stages to run, in order, of {', '.join(STAGES)} "
                         "(default: all)")
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--iters", type=int, default=T,
                    help="steps of each timed pass (T)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cut R, B and H by this factor (tests)")
    args = ap.parse_args(argv)
    unknown = [s for s in args.stages if s not in STAGES]
    if unknown:
        ap.error(f"unknown stage(s) {unknown}; choose from {list(STAGES)}")
    device = rt.device_arg(args.device)
    card = rt.card_line(device)
    print(card, flush=True)
    run_stages(args.stages or list(STAGES), device, card, iters=args.iters,
               scale=args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
