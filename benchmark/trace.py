"""Reading a ``torch.profiler`` Chrome trace into the benchmark's numbers.

The device's own activity is its kernels, copies and memsets (``cat``
``kernel`` / ``gpu_memcpy`` / ``gpu_memset``); busy time is the union of
their intervals. Each device event is tied to the host call that launched
it by its ``correlation`` id (the ``cuda_runtime`` or ``cuda_driver`` event
with the same id), and so to the innermost host range (a ``user_annotation``:
the program's ``fps.*`` ranges, the benchmark's ``bench.*`` spans) open at
the launch. An idle gap of the device is labelled by the innermost range
open on the host when the gap began.
"""

from __future__ import annotations

import gzip
import json

import numpy as np

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
RANGE_PREFIXES = ("fps.", "bench.")


def load(path: str) -> dict:
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        return json.load(f)


def _innermost(ranges: list[tuple[float, float, str]],
               points: np.ndarray) -> list[str | None]:
    """For each point, the name of the shortest range that holds it."""
    if not ranges or not len(points):
        return [None] * len(points)
    starts = np.array([r[0] for r in ranges])
    ends = np.array([r[1] for r in ranges])
    spans = ends - starts
    names = [r[2] for r in ranges]
    out = []
    for chunk in np.array_split(points, max(1, len(points) // 4096)):
        inside = (starts[None, :] <= chunk[:, None]) & (
            chunk[:, None] < ends[None, :])
        width = np.where(inside, spans[None, :], np.inf)
        best = np.argmin(width, axis=1)
        hit = np.isfinite(width[np.arange(len(chunk)), best])
        out += [names[b] if h else None for b, h in zip(best, hit)]
    return out


def summarize(trace: dict, window: str = "bench.stretch",
              top: int = 10) -> dict:
    """Device activity inside the host range named ``window``.

    Returns the window's span and the device's busy time in it (seconds),
    its count of device operations, the device seconds of the operations
    launched under each host range (``by_range``), the operations that took
    most time (``device_ops``) and the idle seconds by the host range open
    when each gap began (``idle_gaps``), each list of at most ``top``
    entries ``[name, seconds]``, longest first.
    """
    events = [e for e in trace["traceEvents"] if e.get("ph") == "X"]
    wins = [e for e in events if e.get("cat") == "user_annotation"
            and e.get("name") == window]
    if not wins:
        raise ValueError(f"the trace has no host range {window!r}")
    w0 = float(wins[0]["ts"])
    w1 = w0 + float(wins[0]["dur"])
    ranges = sorted(
        (float(e["ts"]), float(e["ts"]) + float(e["dur"]), e["name"])
        for e in events if e.get("cat") == "user_annotation"
        and e.get("name", "").startswith(RANGE_PREFIXES)
        and e["name"] != window)
    launch_ts = {e["args"]["correlation"]: float(e["ts"]) for e in events
                 if e.get("cat") in LAUNCH_CATS
                 and "correlation" in e.get("args", {})}
    dev = sorted((float(e["ts"]), float(e["ts"]) + float(e["dur"]),
                  e["name"], launch_ts.get(e.get("args", {}).get(
                      "correlation")))
                 for e in events if e.get("cat") in DEVICE_CATS
                 and w0 <= float(e["ts"]) < w1)
    busy, last = 0.0, float("-inf")
    gaps = []
    by_name: dict[str, float] = {}
    for start, end, name, _ in dev:
        if start > last and last > float("-inf"):
            gaps.append((last, start - last))
        if end > last:
            busy += end - max(start, last)
            last = end
        by_name[name] = by_name.get(name, 0.0) + (end - start)
    if dev and w1 > last:
        gaps.append((last, w1 - last))
    if dev and dev[0][0] > w0:
        gaps.append((w0, dev[0][0] - w0))
    launches = np.array([d[3] if d[3] is not None else np.nan for d in dev])
    owners = _innermost(ranges, launches)
    by_range: dict[str, float] = {}
    for (start, end, _, _), owner in zip(dev, owners):
        if owner is not None:
            by_range[owner] = by_range.get(owner, 0.0) + (end - start)
    idle: dict[str, float] = {}
    for (at, length), owner in zip(gaps, _innermost(
            ranges, np.array([g[0] for g in gaps]))):
        key = owner or "host"
        idle[key] = idle.get(key, 0.0) + length
    us = 1e-6
    return {
        "window_s": (w1 - w0) * us,
        "busy_s": busy * us,
        "device_ops": len(dev),
        "by_range": {k: v * us for k, v in by_range.items()},
        "device_ops_top": [[n[:120], t * us] for n, t in sorted(
            by_name.items(), key=lambda kv: -kv[1])[:top]],
        "idle_gaps_top": [[n, t * us] for n, t in sorted(
            idle.items(), key=lambda kv: -kv[1])[:top]],
    }
