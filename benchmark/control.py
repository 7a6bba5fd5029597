"""The readings that the limits of ``correct`` are set from, for one cell.

For each seed it drives the program through the first three steps exactly
as a run does (:func:`benchmark.harness.first_steps`), then computes the
plain reference in float32 and reads, against it, the compared numbers of

* ``program``: the program (the lower readings of a limit);
* ``tf32``, ``bf16``: the reference put in the program's place and computed
  one precision below the configuration's (the controls, upper readings);
* ``half``: the reference with the second half of every batch left out;
* ``frozen``: a step that leaves the state unchanged.

    python3 -m benchmark.control --workload mf_ml20m.hot2048 --seeds 1,2,3

One JSON line a seed on standard output. The benchmark's own runs never run
this; it sets and re-checks the limits in ``workloads/<cell>.json``.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys

import torch

from benchmark import checks, harness

CONTROLS = ("tf32", "bf16")
FAULTS = ("half", "frozen")


def seed_readings(cell: dict, cfg: dict, seed: int, device,
                  controls=CONTROLS, faults=FAULTS) -> dict:
    """Every reading of one seed (see the module's docstring)."""
    device = torch.device(device)
    fam = harness.family(cfg["family"])
    job, data, weights0, prog = harness.first_steps(fam, cfg, cell, seed,
                                                    device)
    del job
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    w0 = {k: v.to(device) for k, v in weights0.items()}
    seeds3 = harness.check_step_seeds(seed)
    ref = fam.reference(cfg, cell, data, seed, w0, seeds3)
    out = {"seed": seed, "program": checks.readings(prog, ref, weights0)}
    for c in controls:
        ctl = fam.reference(cfg, cell, data, seed, w0, seeds3, precision=c)
        out[c] = checks.readings(ctl, ref, weights0)
    for f in faults:
        if f == "frozen":
            bad = {"losses": ref["losses"],
                   "states": [weights0] * len(ref["states"])}
        else:
            bad = fam.reference(cfg, cell, data, seed, w0, seeds3, fault=f)
        out[f] = checks.readings(bad, ref, weights0)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell, cfg = harness.load_cell(args.workload)
    for s in args.seeds.split(","):
        r = seed_readings(cell, cfg, int(s), "cuda:0")
        print(json.dumps({"workload": args.workload, **r}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
