"""What the port's route-timing tools share: the device flag, the card's
line, the popularity id draw, the timed loop, the float32 bound of a
scatter-add and the JSON lines.

The tools (``fps_tpu_torch/examples/profile_mf_step.py``,
``bench_scatter.py``, ``bench_logreg_routes.py`` and ``pa_scaling.py``, the
ports of ``tools/`` of the same names) time a route as ``T`` eager steps
whose state chains through in-place updates, after one warm-up pass, three
times, and report microseconds a step as the median and the range of the
three (:func:`time_steps`). An eager launch is never elided, so a gather's
output needs no chain. Two times are taken on the card:

* ``us_per_step``, the device's: the steps in segments of
  :data:`SEGMENT`, each enqueued while the card is held busy
  (``torch.cuda._sleep``, twice the warm-up's time for the segment) and
  timed between CUDA events, so the host's launch cost falls outside; the
  reference's compiled scans have none.
* ``loop_us_per_step``, the eager loop's: the ``T`` steps between two CUDA
  events on an idle card, the host's enqueue included, as a training step
  pays it.

On the CPU the same loop runs the plain versions on the host's clock (both
keys): a check of the tool, not a measurement.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

EPS32 = float(np.finfo(np.float32).eps)


def device_arg(name: str | None) -> torch.device:
    """The tools' ``--device``: the card unless the caller names another
    device. Without CUDA and without a device the tool exits non-zero."""
    if name is not None:
        return torch.device(name)
    if not torch.cuda.is_available():
        raise SystemExit("CUDA is not available and no --device was given; "
                         "pass --device cpu to run on the CPU")
    return torch.device("cuda", torch.cuda.current_device())


def card_line(device: torch.device) -> str:
    """``nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`` of
    the card (its first line), or ``cpu`` off the card."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[device.index or 0]


def emit(record: dict) -> dict:
    """One JSON line on stdout; returns the record."""
    json.dump(record, sys.stdout)
    sys.stdout.write("\n")
    sys.stdout.flush()
    return record


def scaled(n: int, scale: float) -> int:
    """A size cut by ``scale`` (the tests' small runs), at least 1."""
    return max(1, int(round(n * scale)))


def popularity_ids(rng: np.random.Generator, num_rows: int, shape,
                   alpha: float) -> np.ndarray:
    """The reference tools' id draw: ``p ~ 1 / rank^alpha`` over
    ``num_rows`` rows, by ``np.searchsorted`` of the cumulative
    popularities at ``rng.random(shape)``; int32. Every id must lie in
    ``[0, num_rows)`` (the library arms index with them), else this
    raises."""
    pop = 1.0 / np.arange(1, num_rows + 1) ** alpha
    pop /= pop.sum()
    cdf = np.cumsum(pop)
    ids = np.searchsorted(cdf, rng.random(shape)).astype(np.int32)
    if ids.size and int(ids.max()) >= num_rows:
        raise ValueError(f"popularity draw past the table: {int(ids.max())} "
                         f">= {num_rows} rows")
    return ids


def dup_frac(ids: np.ndarray) -> float:
    """The share of a step's ids that repeat an earlier one."""
    return 1.0 - len(np.unique(ids)) / max(1, ids.size)


def device_normal(shape, std: float, seed: int,
                  device: torch.device) -> torch.Tensor:
    """float32 normals of ``std`` made on ``device`` from ``seed`` (the
    deltas: the reference draws them with numpy, the port on the device,
    where the largest are several GB)."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    out = torch.empty(shape, dtype=torch.float32, device=device)
    return out.normal_(0.0, std, generator=gen)


def on(device: torch.device, array: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(array)).to(device)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# Steps a held segment: at most a few hundred launches, which the host
# enqueues while the card sleeps (the launch queue holds about a thousand).
SEGMENT = 16
# Cycles a second of the sleep's clock (an H100's boost clock is 1.98 GHz;
# a slower clock only lengthens the hold).
SLEEP_HZ = 2.0e9


def _events(pairs) -> float:
    pairs[-1][1].synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) * 1e3


def time_steps(fn, steps: int, device: torch.device, *,
               repeats: int = 3) -> dict:
    """``fn(t)`` for ``t`` in ``range(steps)``: once to warm up, then
    ``repeats`` timed passes. Returns µs a step, each the median of the
    passes with its range and the passes: ``us_per_step`` (the device's,
    held segments; the host's clock on the CPU) and ``loop_us_per_step``
    (the eager loop's on an idle card)."""
    t0 = time.perf_counter()
    for t in range(steps):
        fn(t)
    sync(device)
    warm_s = (time.perf_counter() - t0) / steps
    held, loop = [], []
    for _ in range(repeats):
        if device.type != "cuda":
            t0 = time.perf_counter()
            for t in range(steps):
                fn(t)
            held.append((time.perf_counter() - t0) * 1e6 / steps)
            loop.append(held[-1])
            continue
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for t in range(steps):
            fn(t)
        end.record()
        loop.append(_events([(start, end)]) / steps)
        pairs = []
        for s0 in range(0, steps, SEGMENT):
            seg = range(s0, min(steps, s0 + SEGMENT))
            torch.cuda._sleep(int(2 * warm_s * len(seg) * SLEEP_HZ))
            pairs.append((torch.cuda.Event(enable_timing=True),
                          torch.cuda.Event(enable_timing=True)))
            pairs[-1][0].record()
            for t in seg:
                fn(t)
            pairs[-1][1].record()
        held.append(_events(pairs) / steps)
    return {"us_per_step": statistics.median(held),
            "us_range": [min(held), max(held)], "us_repeats": held,
            "loop_us_per_step": statistics.median(loop),
            "loop_us_range": [min(loop), max(loop)]}


def scatter_bound_excess(before: torch.Tensor, ids: torch.Tensor,
                         deltas: torch.Tensor, got: torch.Tensor) -> float:
    """How far ``got`` (``before`` with ``deltas`` added at ``ids``, ids
    outside ``[0, R)`` dropped) lies outside the float32 bound of the exact
    sum: a float32 sum of ``k`` terms in any order lies within ``k * eps32
    * (sum of the terms' magnitudes)`` of the exact sum, ``k`` a row's
    pushes plus one. At most 0 within the bound."""
    keep = (ids >= 0) & (ids < before.shape[0])
    kid, kd = ids[keep].long(), deltas[keep].double()
    exact = before.double().index_add_(0, kid, kd)
    mag = before.double().abs().index_add_(0, kid, kd.abs())
    count = torch.zeros(before.shape[0], dtype=torch.float64,
                        device=before.device)
    count.index_add_(0, kid, torch.ones_like(kid, dtype=torch.float64))
    tol = (count + 1)[:, None] * EPS32 * mag
    return float(((got.double() - exact).abs() - tol).max())


def check_scatter(label: str, before: torch.Tensor, ids: torch.Tensor,
                  deltas: torch.Tensor, got: torch.Tensor,
                  library: torch.Tensor) -> dict:
    """The tools' scatter-add spot check, a gate: the route's result and
    the library's each within the float32 bound of the exact sum. Returns
    the excesses and the largest difference between the two."""
    out = {"check": label,
           "excess": scatter_bound_excess(before, ids, deltas, got),
           "library_excess": scatter_bound_excess(before, ids, deltas,
                                                  library),
           "max_abs_diff": float((got - library).abs().max())}
    if out["excess"] > 0 or out["library_excess"] > 0:
        raise AssertionError(f"{label}: outside the float32 bound of the "
                             f"exact sum: {out}")
    return out


def check_gather(label: str, got: torch.Tensor, library: torch.Tensor
                 ) -> dict:
    """The gathers' spot check, a gate: bit-equal to the library's (as
    bytes, so that -0.0 and 0.0 differ)."""
    if not np.array_equal(got.cpu().numpy().view(np.uint8),
                          library.cpu().numpy().view(np.uint8)):
        raise AssertionError(f"{label}: the gather differs from the "
                             "library's")
    return {"check": label, "max_abs_diff": 0.0}


# H100 SXM device memory rate (NVIDIA data sheet): the bytes bound of a
# route is its least bytes over this rate.
HBM_BYTES_PER_S = 3.35e12


def scatter_bound_us(ids: np.ndarray, dim: int) -> float:
    """µs the card needs at least for one scatter-add of this step: its
    ids and deltas read once, each touched row read and written once."""
    touched = len(np.unique(ids))
    return (ids.size * (4 + 4 * dim) + 2 * touched * 4 * dim) \
        / HBM_BYTES_PER_S * 1e6


def gather_bound_us(ids: np.ndarray, dim: int) -> float:
    """µs the card needs at least for one gather of this step: its ids
    read once, each touched row read once, the rows written once."""
    touched = len(np.unique(ids))
    return (ids.size * (4 + 4 * dim) + touched * 4 * dim) \
        / HBM_BYTES_PER_S * 1e6
