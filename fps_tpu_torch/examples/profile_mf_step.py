"""Ablation profile of the ML-20M MF step: where a step's microseconds go.

Port of ``tools/profile_mf_step.py``: the same shapes (26,744 items,
138,496 users, rank 10, B = 32,768 ratings a step, T = 512 steps, and the
packed ``(N, 3)`` int32 ingest matrix of N = 20,000,263 rows, 240 MB), the
same ``default_rng(0)`` draws and the same eight arms, each a component of
the step knocked out on its own. Where the reference calls its routed
kernel (``fps_tpu.ops``) the port calls ``fps_tpu_torch.ops``: K1 for the
item gather, K2 for the item scatter-add. Where the reference calls XLA
directly (``jnp.take``, ``.at[].add``, ``segment_sum``, ``argsort``) the
port calls the matching PyTorch library op (``index_select``,
``index_add_``, ``torch.sort``). So the full-step analog runs K1 for the
item pull, the library for the user side, and the reference's mean push.

Each arm chains its state through ``T`` in-place steps and is timed as
:mod:`fps_tpu_torch.utils.route_timing` sets out: µs a step, the median and
range of 3 timed passes after a warm-up pass. One JSON line an arm, after
the card's line.

Run:
  python -m fps_tpu_torch.examples.profile_mf_step [--device cpu]
      [--iters T] [--scale F]
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

R_ITEMS = 26744
R_USERS = 138496
RANK = 10
B = 32768
T = 512
N = 20_000_263
LR, REG = 0.05, 0.01

ARMS = ("batch build gather (N,3)", "item gather (B,10)",
        "item scatter-add sum (B,10)", "item mean-combine push (B,10)",
        "dedup(sort)+scatter (B,10)", "user gather+scatter (B,10)",
        "2 gathers + SGD math", "full step analog")
# What each arm runs: the port's kernel (K1, K2) or the library.
ROUTES = ("library", "K1", "K2", "library", "library sort + K2",
          "library", "library", "K1 + library")


def make_data(device: torch.device, iters: int = T, scale: float = 1.0):
    """The reference's draws, in its order, from ``default_rng(0)``; sizes
    cut by ``scale`` (rank and the packed matrix's 3 columns kept)."""
    ri, ru = rt.scaled(R_ITEMS, scale), rt.scaled(R_USERS, scale)
    b, n = rt.scaled(B, scale), rt.scaled(N, scale)
    rng = np.random.default_rng(0)
    items = rng.integers(0, ri, (iters, b)).astype(np.int32)
    users = rng.integers(0, ru, (iters, b)).astype(np.int32)
    ratings = rng.normal(0, 1, (iters, b)).astype(np.float32)
    qtab = rng.normal(0, 0.1, (ri, RANK)).astype(np.float32)
    ptab = rng.normal(0, 0.1, (ru, RANK)).astype(np.float32)
    packed = rng.integers(0, 2**30, (n, 3)).astype(np.int32)
    slots = rng.integers(0, n, (iters, b)).astype(np.int32)
    return {k: rt.on(device, v) for k, v in (
        ("items", items), ("users", users), ("ratings", ratings),
        ("qtab", qtab), ("ptab", ptab), ("packed", packed),
        ("slots", slots))}


def mean_push_(tab: torch.Tensor, ids: torch.Tensor,
               deltas: torch.Tensor) -> torch.Tensor:
    """The reference's mean-combine push, in place: each touched row moves
    by the mean of its deltas (two segment sums, a division, a select)."""
    rps = tab.shape[0]
    summed = tab.new_zeros((rps + 1, tab.shape[1])).index_add_(
        0, ids, deltas)[:rps]
    counts = torch.zeros(rps + 1, dtype=torch.int32,
                         device=tab.device).index_add_(
        0, ids, torch.ones_like(ids))[:rps]
    summed = summed / torch.clamp(counts, min=1)[:, None].to(torch.float32)
    return torch.where((counts > 0)[:, None], tab + summed, tab, out=tab)


def full_step_(qtab: torch.Tensor, ptab: torch.Tensor, ids: torch.Tensor,
               u: torch.Tensor, r: torch.Tensor):
    """One step of the full-step analog, both tables in place: the item
    pull through ``ops.gather_rows`` (K1 on the card), the user side
    through the library, the item push by :func:`mean_push_`. Returns the
    step's ``(squared error sum, B)``."""
    q = ops.gather_rows(qtab, ids)
    p = ptab.index_select(0, u)
    pred = torch.sum(p * q, dim=-1)
    err = r - pred
    dp = LR * (err[:, None] * q - REG * p)
    dq = LR * (err[:, None] * p - REG * q)
    ptab.index_add_(0, u, dp)
    mean_push_(qtab, ids, dq)
    return torch.sum(err * err), float(ids.shape[0])


def arm_fns(d: dict):
    """The eight arms: ``fn(t)`` running step ``t`` of each, over state
    made fresh from ``d`` (tables copied, accumulators at zero)."""
    dev = d["qtab"].device
    qtab, ptab = d["qtab"], d["ptab"]
    items, users, ratings = d["items"], d["users"], d["ratings"]
    ri = qtab.shape[0]
    ones = torch.ones((1, RANK), dtype=torch.float32, device=dev)
    acc_i = torch.zeros((), dtype=torch.int64, device=dev)
    acc = [torch.zeros((), dtype=torch.float32, device=dev)
           for _ in range(2)]
    tabs = [qtab.clone() for _ in range(3)] + [ptab.clone()]
    full = (qtab.clone(), ptab.clone())
    sq = torch.zeros((), dtype=torch.float32, device=dev)
    bsz = items.shape[1]

    def build(t):
        acc_i.add_(d["packed"].index_select(0, d["slots"][t]).sum())

    def pull(t):
        acc[0].add_(ops.gather_rows(qtab, items[t]).sum())

    def scatter(t):
        ops.scatter_add_(tabs[0], items[t], ratings[t][:, None] * ones)

    def mean(t):
        mean_push_(tabs[1], items[t], ratings[t][:, None] * ones)

    def dedup(t):
        ids = items[t]
        deltas = ratings[t][:, None] * ones
        sids, order = torch.sort(ids)
        sdel = deltas.index_select(0, order)
        seg_start = torch.ones_like(sids, dtype=torch.bool)
        seg_start[1:] = sids[1:] != sids[:-1]
        seg_id = torch.cumsum(seg_start.to(torch.int32), 0) - 1
        summed = deltas.new_zeros((bsz, RANK)).index_add_(0, seg_id, sdel)
        first = torch.full((bsz,), torch.iinfo(torch.int32).min,
                           dtype=torch.int32, device=dev)
        first.scatter_reduce_(0, seg_id.long(), torch.where(
            seg_start, sids, -1), "amax")
        ops.scatter_add_(tabs[2], first, summed)

    def user(t):
        tab, ids = tabs[3], users[t]
        p = tab.index_select(0, ids)
        tab.index_add_(0, ids, ratings[t][:, None] * p)

    def math(t):
        ids, r = items[t], ratings[t]
        q = qtab.index_select(0, ids)
        p = qtab.index_select(0, torch.clamp(users[t], max=ri - 1))
        pred = torch.sum(p * q, dim=-1)
        err = r - pred
        dp = LR * (err[:, None] * q - REG * p)
        dq = LR * (err[:, None] * p - REG * q)
        acc[1].add_(dp.sum() + dq.sum())

    def step(t):
        se, _ = full_step_(full[0], full[1], items[t], users[t], ratings[t])
        sq.add_(se)

    return (build, pull, scatter, mean, dedup, user, math, step), full


def profile(device: torch.device, card: str, *, iters: int = T,
            scale: float = 1.0) -> list[dict]:
    """Time the eight arms and emit one JSON line each; returns the
    lines."""
    d = make_data(device, iters, scale)
    fns, full = arm_fns(d)
    out = []
    for arm, route, fn in zip(ARMS, ROUTES, fns):
        out.append(rt.emit({
            "tool": "profile_mf_step", "arm": arm, "route": route,
            "B": d["items"].shape[1], "T": iters, "rank": RANK,
            **rt.time_steps(fn, iters, device), "device": str(device),
            "card": card}))
    for name, tab in zip(("item", "user"), full):
        if not np.isfinite(tab.cpu().numpy()).all():
            raise AssertionError(f"full step analog: {name} factors not "
                                 "finite")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="default: the card; 'cpu' runs the plain versions")
    ap.add_argument("--iters", type=int, default=T,
                    help="steps of each timed pass (T)")
    ap.add_argument("--scale", type=float, default=1.0,
                    help="cut rows, batch and N by this factor (tests)")
    args = ap.parse_args(argv)
    device = rt.device_arg(args.device)
    card = rt.card_line(device)
    print(card, flush=True)
    profile(device, card, iters=args.iters, scale=args.scale)
    return 0


if __name__ == "__main__":
    sys.exit(main())
