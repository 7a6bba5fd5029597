"""Run one cell of the benchmark of the PyTorch/CUDA port, on the CUDA
card this process sees, and print its result as the last line.

    python3 -m benchmark.run --workload mf_ml20m.hot2048 --seed 7 \
        --seconds 10 --trace 0

``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer metrics (from a profiled stretch after the same timed window).
Without a CUDA card, or with fewer than the cell asks for, it prints no
result and exits with 2. Each number that decides ``correct`` is printed
beside its limit, as the last lines of standard error and under ``checks``,
the result's last key. A run that ends with JAX or the JAX package loaded
prints no result and exits with 3.
"""

from __future__ import annotations

import time

T_NOW = time.perf_counter()


def _process_start() -> float:
    """This process's start on the ``perf_counter`` clock (from
    ``/proc``), or the module's import where that is unreadable."""
    import os

    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        age = uptime - int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return T_NOW - max(0.0, age)
    except (OSError, ValueError, IndexError):
        return T_NOW


T_START = _process_start()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "fps_tpu")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one of
    :data:`FORBIDDEN`, compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unread"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    def log(msg: str) -> None:
        print(f"[benchmark] {msg}", file=sys.stderr, flush=True)

    os.environ.setdefault("USE_FLAX", "0")
    import torch

    from benchmark import harness

    with open(harness.BENCHMARK_JSON) as f:
        bench = json.load(f)
    entry = [w for w in bench["workloads"] if w["name"] == args.workload]
    if not entry:
        log(f"no cell {args.workload!r} in BENCHMARK.json")
        return 2
    chips = int(entry[0]["chips"])
    cell, cfg = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        log(f"no CUDA card to run on (available: "
            f"{torch.cuda.is_available()}, count: "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
            f", the cell asks for {chips})")
        return 2
    card = power_limit()
    log(f"card: {card}")
    result, compared = harness.run(cell, cfg, args.seed, args.seconds,
                                   bool(args.trace), "cuda:0", T_START,
                                   bench=bench, log=log)
    found = forbidden_modules()
    if found:
        log(f"forbidden modules loaded: {found}")
        return 3
    result["card"] = card
    result["checks"] = compared
    for name, c in compared.items():
        log(f"check {name}: {c['value']!r} (limit {c['limit']!r})")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
