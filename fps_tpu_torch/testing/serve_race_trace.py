"""Repeat the ``serve_while_train`` chaos scenario and trace its watcher.

``run_serve_while_train_scenario`` plants a torn snapshot candidate at the
first served step + 50 and requires the reader to reject it
(``rejected_snapshots >= 1``); once on the card the reader rejected none
(ROADMAP.md Queue 3, H3). This runs the scenario ``--runs`` times and
prints one JSON line a run: its verdict, the rejections, the swap trail
and, for a failed run (or ``--all``), the watcher's timeline: every
directory scan (the steps it listed) and every open it tried (the step,
the step it served or ``null``, the rejections so far), in seconds from
the run's start, repeated events collapsed.

Run:
  python -m fps_tpu_torch.testing.serve_race_trace [--runs N] [--all]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile
import time


def traced_runs(runs: int, device: str, show_all: bool = False):
    """Yield one record a run of the scenario (see the module's
    docstring)."""
    from fps_tpu_torch.serve import watcher
    from fps_tpu_torch.testing import supervised_demo

    cls = watcher.SnapshotWatcher
    listed, opened = cls._scan_dir, cls._try_open
    timeline: list = []
    t0 = [0.0]

    def now():
        return round(time.monotonic() - t0[0], 3)

    def traced_scan(self):
        steps = listed(self)
        timeline.append([now(), "scan", steps])
        return steps

    def traced_open(self, step):
        snap = opened(self, step)
        timeline.append([now(), "try", step,
                         None if snap is None else snap.step, self.rejected])
        return snap

    cls._scan_dir, cls._try_open = traced_scan, traced_open
    try:
        for run in range(runs):
            timeline.clear()
            t0[0] = time.monotonic()
            with tempfile.TemporaryDirectory() as d:
                ok, detail = supervised_demo.run_serve_while_train_scenario(
                    d, device=device)
            record = {"run": run, "ok": ok,
                      "rejected": detail.get("rejected_snapshots"),
                      "trail": detail.get("swap_trail")}
            if show_all or not ok:
                record["timeline"] = _collapsed(timeline)
            yield record
    finally:
        cls._scan_dir, cls._try_open = listed, opened


def _collapsed(timeline):
    """The timeline with runs of identical events (times aside) kept
    once, at their first time."""
    out, prev = [], None
    for event in timeline:
        if event[1:] != prev:
            out.append(event)
        prev = event[1:]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=8)
    ap.add_argument("--all", action="store_true",
                    help="print the timeline of every run, not only of "
                         "the failed ones")
    ap.add_argument("--device", default="cuda:0")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda"):
        from fps_tpu_torch.ops import _build

        _build.library()  # the children only load it
    failed = 0
    for record in traced_runs(args.runs, args.device, args.all):
        failed += not record["ok"]
        print(json.dumps(record), flush=True)
    print(json.dumps({"runs": args.runs, "failed": failed}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
