"""Host µs a call of the gathers (K1, K5) at the shapes of their paths.

A step of the port is host-bound: the host enqueues its kernels more slowly
than the card runs them. This times what the host spends on one gather
call, wrapper checks, plan and launch included, with the card held busy
(``torch.cuda._sleep``) so that no call waits on the device: rounds of 100
back-to-back calls on the host's clock, the median of 9 rounds. Each shape
is timed through ``fps_tpu_torch.ops.gather_rows`` (what a step calls; at
binary PA the head-prefix route) and through the kernel's wrapper alone.

``--tree`` imports ``fps_tpu_torch`` from another checkout, so that two
trees can be compared in one run:

    python3 fps_tpu_torch/utils/gather_host_cost.py --tree DIR

prints one JSON line: the tree, the card's name and power limit and, for
each shape, ``ops_us`` and ``wrapper_us``. ``--device cpu --scale 1000``
runs the plain versions at a thousandth of the sizes (a check of the
script, not a measurement).
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np

# About 20 ms of the card's clock: longer than the host takes to enqueue a
# round of calls, so that none of them waits on the device.
HOLD_CYCLES = 40_000_000

# (label, rows, D, batch, head rows, head prefix): the K1 and K5 shapes of
# chip_smoke.py's paths.
SHAPES = [
    ("K1 MF items", 26_744, 10, 32_768, 0, 0),
    ("K1 MF users", 138_493, 10, 32_768, 0, 0),
    ("K1 PA multiclass", 47_236, 20, 1 << 20, 0, 0),
    ("K1 logreg adagrad", 1_000_000, 2, 425_997, 0, 0),
    ("K5 PA head prefix", 47_236, 1, 1 << 20, 2048, 294_912),
    ("K5 logreg", 1_000_000, 1, 425_997, 0, 0),
]


def host_us(torch, call, cuda: bool, calls: int = 100,
            rounds: int = 9) -> float:
    """Median over ``rounds`` of the host µs a call of ``calls``
    back-to-back calls, the card held busy through each round."""
    call()
    per = []
    for _ in range(rounds):
        if cuda:
            torch.cuda.synchronize()
            torch.cuda._sleep(HOLD_CYCLES)
        t0 = time.perf_counter()
        for _ in range(calls):
            call()
        per.append((time.perf_counter() - t0) / calls * 1e6)
    if cuda:
        torch.cuda.synchronize()
    return statistics.median(per)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=".",
                    help="checkout whose fps_tpu_torch is timed")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--scale", type=int, default=1,
                    help="divide rows and batches by this")
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    from fps_tpu_torch import ops
    from fps_tpu_torch.ops import kernels

    cuda = args.device != "cpu"
    if cuda and not torch.cuda.is_available():
        print("gather_host_cost: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device(args.device)
    card = "not measured (CPU)"
    if cuda:
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    rng = np.random.default_rng(0)
    out = {"tree": os.path.abspath(args.tree), "card": card, "shapes": {}}
    for label, R, D, B, H, q in SHAPES:
        R, B, H, q = (max(1, x // args.scale) if x else 0
                      for x in (R, B, H, q))
        table = torch.from_numpy(
            rng.normal(0, 1, (R, D)).astype(np.float32)).to(dev)
        ids = torch.from_numpy(
            rng.integers(-1, R + 1, B).astype(np.int32)).to(dev)
        if cuda:
            wrapper = (kernels.gather_rows_dim1_cuda if D == 1
                       else kernels.gather_rows_cuda)
        else:
            wrapper = (kernels.gather_rows_dim1_plain if D == 1
                       else kernels.gather_rows_plain)
        row = {"R": R, "D": D, "B": B, "head": [H, q],
               "ops_us": host_us(torch, lambda H=H, q=q: ops.gather_rows(
                   table, ids, hot_rows=H, head_prefix=q), cuda),
               "wrapper_us": host_us(torch, lambda: wrapper(table, ids),
                                     cuda)}
        out["shapes"][label] = row
        print(f"{label}: {json.dumps(row)}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
