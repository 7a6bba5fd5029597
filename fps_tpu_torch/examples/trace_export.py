"""Render obs/pod directories into one Chrome-trace / Perfetto JSON: the
merged causal view of a (possibly multi-host) run.

The port's copy of ``tools/trace_export.py``, beside the port's other CLIs
(``examples/serve.py``, ``examples/supervise.py``): the same spans, the
same output and the same command line, over either package's journals
(their event names and span fields are the same).

Input: one or more directories holding ``journal-*.jsonl`` files (an
``--obs-dir``, a supervisor ``--state-dir``, or a whole pod dir — the
tool walks subdirectories, so pointing it at ``pod_dir`` picks up the
pod journal, every member's supervisor journal, and every child's run
journals in one pass). Each journal line becomes a span:

* ``journal-pod.jsonl`` — the pod root span (``pod_start`` →
  shutdown/give-up), one **decision span per coordinated restart**
  (``pod_launch``/``pod_restart``, closed by the next decision), and
  instants for lease churn / fences / membership changes;
* ``journal-supervisor.jsonl`` — one span per supervisor run and one per
  **attempt** (``attempt_start``/``attempt_end`` pairs, parented to the
  pod decision that commanded them via the control record's span id,
  carrying the fencing epoch);
* ``journal-p<K>.jsonl`` — one span per training run (``run_start`` →
  ``run_end``, parented to the attempt via the env contract), per chunk
  (phase breakdown from the ``PhaseTimer`` fields on ``chunk``/``epoch``
  events), and per checkpoint publish; plus every explicit ``span``
  event a :class:`fps_tpu_torch.obs.trace.Tracer` emitted.

The result: a ``pod_kill_one_host`` chaos run exports ONE causally
linked span tree — leader decision → per-host attempts → per-chunk
phases — instead of N disconnected per-host fragments. Open the output
in ``chrome://tracing`` or https://ui.perfetto.dev.

Pure host tool: stdlib only, no torch, numpy or package imports (loadable
by file path from the pod scenarios and from hosts without torch).

Usage:
  python3 fps_tpu_torch/examples/trace_export.py DIR [DIR...] \
      [-o trace.json] [--pretty]
"""

from __future__ import annotations

import argparse
import json
import os
import sys

# Serial driver phases, in pipeline order (mirrors
# fps_tpu_torch.obs.timing.DRIVER_PHASES minus the overlapped 'prefetch';
# this tool is deliberately import-free).
_SERIAL_PHASES = ("ingest", "place", "dispatch", "host_sync",
                  "checkpoint", "callback", "reconcile", "retier")
_OVERLAPPED_PHASES = ("prefetch",)

# Journal events rendered as zero-duration instants, by source.
_POD_INSTANTS = (
    "lease_acquired", "lease_seized", "lease_lost", "fence_written",
    "member_failed", "member_evicted", "member_readmitted",
    "member_synced", "pod_quarantine", "readmit_deferred",
    "decision_abandoned",
)
_SUP_INSTANTS = ("deadline_abort", "supervisor_restart",
                 "chunk_quarantined", "member_stall_detected",
                 "heartbeat_rejected", "supervisor_give_up")
_RUN_INSTANTS = ("checkpoint_enqueued", "checkpoint_fallback",
                 "checkpoint_fenced", "checkpoint_resplit", "rollback",
                 "preset_skip", "guard_escalated", "stall",
                 "stall_recovered", "health_abort", "serve_swap",
                 "budget_drift")

_POD_DECISIONS = ("pod_launch", "pod_restart")
_POD_TERMINALS = ("pod_shutdown", "pod_give_up")


def _read_jsonl(path: str):
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    return  # torn tail of a live/killed writer
    except OSError:
        return


def _journal_files(dirs):
    """Every journal-*.jsonl under the given dirs (recursive), with the
    immediate parent directory's basename as the host hint."""
    out = []
    for d in dirs:
        if os.path.isfile(d):
            out.append((d, os.path.basename(os.path.dirname(d))))
            continue
        for root, subdirs, files in os.walk(d):
            subdirs[:] = sorted(s for s in subdirs if s != "__pycache__")
            for f in sorted(files):
                if f.startswith("journal-") and f.endswith(".jsonl"):
                    out.append((os.path.join(root, f),
                                os.path.basename(root) or d))
    return out


class _Minted:
    """Deterministic fallback span ids for records that carry none."""

    def __init__(self):
        self.n = 0

    def __call__(self) -> str:
        self.n += 1
        return f"synth-{self.n:06d}"


def _span(name, t0, t1, rec, *, span_id, parent_id, host, cat,
          attrs=None) -> dict:
    return {
        "name": name,
        "cat": cat,
        "t0": float(t0),
        "t1": float(max(t0, t1)),
        "trace_id": rec.get("trace_id"),
        "span_id": span_id,
        "parent_id": parent_id,
        "host": host,
        "attrs": dict(attrs or {}),
    }


def _pod_spans(records, host_hint, mint) -> list[dict]:
    spans = []
    max_t = max((r.get("t", 0.0) for r in records), default=0.0)
    root = None
    decisions = []  # open decision spans, closed by the next decision
    for rec in records:
        et = rec.get("event")
        t = float(rec.get("t", 0.0))
        if et == "pod_start":
            root = _span("pod", t, max_t, rec,
                         span_id=rec.get("span_id") or mint(),
                         parent_id=None, host=rec.get("host", host_hint),
                         cat="pod",
                         attrs={k: rec.get(k) for k in
                                ("roster", "pod_size", "elastic")})
            spans.append(root)
        elif et in _POD_DECISIONS + _POD_TERMINALS:
            for d in decisions:
                d["t1"] = max(d["t0"], t)  # closed by this decision
            decisions.clear()
            if et in _POD_DECISIONS:
                s = _span(et, t, max_t, rec,
                          span_id=rec.get("span_id") or mint(),
                          parent_id=rec.get("parent_id")
                          or (root and root["span_id"]),
                          host=rec.get("host", host_hint), cat="decision",
                          attrs={k: rec.get(k) for k in
                                 ("epoch", "step", "world", "members",
                                  "failed", "reason", "restarts",
                                  "quarantined")})
                decisions.append(s)
                spans.append(s)
            else:
                spans.append(_span(
                    et, t, t, rec, span_id=rec.get("span_id") or mint(),
                    parent_id=rec.get("parent_id")
                    or (root and root["span_id"]),
                    host=rec.get("host", host_hint), cat="decision",
                    attrs={k: rec.get(k) for k in ("epoch", "reason")}))
        elif et in _POD_INSTANTS:
            attrs = {k: v for k, v in rec.items()
                     if k not in ("kind", "t", "event", "trace_id",
                                  "span_id", "parent_id")}
            spans.append(_span(
                et, t, t, rec, span_id=rec.get("span_id") or mint(),
                parent_id=rec.get("parent_id")
                or (root and root["span_id"]),
                host=rec.get("host", host_hint), cat="pod_event",
                attrs=attrs))
    return spans


def _supervisor_spans(records, host_hint, mint) -> list[dict]:
    spans = []
    max_t = max((r.get("t", 0.0) for r in records), default=0.0)
    run_span = None
    attempts = {}  # span_id -> span (open until attempt_end)
    by_attempt = {}  # attempt number -> span_id
    for rec in records:
        et = rec.get("event")
        t = float(rec.get("t", 0.0))
        if et == "supervisor_start" or et == "pod_member_start":
            run_span = _span(
                "supervise", t, max_t, rec,
                span_id=rec.get("span_id") or mint(),
                parent_id=rec.get("parent_id"),
                host=rec.get("host", host_hint), cat="supervise",
                attrs={})
            spans.append(run_span)
        elif et in ("supervised_run_end", "pod_member_end"):
            if run_span is not None:
                run_span["t1"] = max(run_span["t0"], t)
                run_span["attrs"].update(
                    {k: rec.get(k) for k in ("success", "reason")
                     if k in rec})
        elif et == "attempt_start":
            sid = rec.get("span_id") or mint()
            s = _span("attempt", t, max_t, rec, span_id=sid,
                      parent_id=rec.get("parent_id")
                      or (run_span and run_span["span_id"]),
                      host=rec.get("host", host_hint), cat="attempt",
                      attrs={k: rec.get(k) for k in
                             ("attempt", "pid", "pod_epoch")
                             if rec.get(k) is not None})
            attempts[sid] = s
            if rec.get("attempt") is not None:
                by_attempt[rec["attempt"]] = sid
            spans.append(s)
        elif et == "attempt_end":
            s = attempts.get(rec.get("span_id"))
            if s is not None:
                s["t1"] = max(s["t0"], t)
                s["attrs"].update({k: rec.get(k) for k in
                                   ("rc", "aborted", "stall_kind",
                                    "last_index", "pod_epoch")
                                   if rec.get(k) is not None})
        elif et in _SUP_INSTANTS:
            parent = by_attempt.get(rec.get("attempt"))
            attrs = {k: v for k, v in rec.items()
                     if k not in ("kind", "t", "event", "trace_id",
                                  "span_id", "parent_id", "cmd")}
            spans.append(_span(
                et, t, t, rec, span_id=rec.get("span_id") or mint(),
                parent_id=parent or (run_span and run_span["span_id"]),
                host=rec.get("host", host_hint), cat="sup_event",
                attrs=attrs))
    return spans


def _run_spans(records, host_hint, mint) -> list[dict]:
    spans = []
    max_t = max((r.get("t", 0.0) for r in records), default=0.0)
    run_span = None
    for rec in records:
        et = rec.get("event")
        t = float(rec.get("t", 0.0))
        if et == "run_start":
            run_span = _span(
                "run", t, max_t, rec,
                span_id=rec.get("span_id") or mint(),
                parent_id=rec.get("parent_id"),
                host=rec.get("host", host_hint), cat="run",
                attrs={k: rec.get(k) for k in
                       ("process", "config_digest", "run_id", "workload")
                       if rec.get(k) is not None})
            spans.append(run_span)
        elif et == "run_end":
            if run_span is not None:
                run_span["t1"] = max(run_span["t0"], t)
        elif et == "span":
            spans.append(_span(
                rec.get("span", "span"), rec.get("t0", t),
                rec.get("t1", t), rec,
                span_id=rec.get("span_id") or mint(),
                parent_id=rec.get("parent_id")
                or (run_span and run_span["span_id"]),
                host=rec.get("host", host_hint), cat="span",
                attrs={k: v for k, v in rec.items()
                       if k not in ("kind", "t", "event", "span",
                                    "trace_id", "span_id", "parent_id",
                                    "t0", "t1", "run_id")}))
        elif et in ("chunk", "epoch"):
            phases = rec.get("phases") or {}
            serial = sum(float(phases.get(p, 0.0))
                         for p in _SERIAL_PHASES)
            serial += sum(float(v) for k, v in phases.items()
                          if k not in _SERIAL_PHASES
                          and k not in _OVERLAPPED_PHASES)
            t0 = t - serial
            parent = run_span and run_span["span_id"]
            sid = mint()
            spans.append(_span(
                et, t0, t, rec, span_id=sid, parent_id=parent,
                host=rec.get("host", host_hint), cat="chunk",
                attrs={k: rec.get(k) for k in
                       ("index", "quarantined", "examples")
                       if rec.get(k) is not None}))
            cursor = t0
            for p in _SERIAL_PHASES:
                dur = float(phases.get(p, 0.0))
                if dur <= 0.0:
                    continue
                spans.append(_span(
                    p, cursor, cursor + dur, rec, span_id=mint(),
                    parent_id=sid, host=rec.get("host", host_hint),
                    cat="phase", attrs={}))
                cursor += dur
            for p in _OVERLAPPED_PHASES:
                dur = float(phases.get(p, 0.0))
                if dur > 0.0:
                    # Worker-thread time overlapped with the serial
                    # phases — rendered alongside, flagged as such.
                    spans.append(_span(
                        p, t0, t0 + dur, rec, span_id=mint(),
                        parent_id=sid, host=rec.get("host", host_hint),
                        cat="phase", attrs={"overlapped": True}))
        elif et == "checkpoint_saved":
            dur = float(rec.get("seconds", 0.0) or 0.0)
            spans.append(_span(
                "checkpoint_publish", t - dur, t, rec, span_id=mint(),
                parent_id=run_span and run_span["span_id"],
                host=rec.get("host", host_hint), cat="checkpoint",
                attrs={k: rec.get(k) for k in ("step", "bytes")
                       if rec.get(k) is not None}))
        elif et in _RUN_INSTANTS:
            attrs = {k: v for k, v in rec.items()
                     if k not in ("kind", "t", "event", "trace_id",
                                  "span_id", "parent_id", "run_id")}
            spans.append(_span(
                et, t, t, rec, span_id=rec.get("span_id") or mint(),
                parent_id=rec.get("parent_id")
                or (run_span and run_span["span_id"]),
                host=rec.get("host", host_hint), cat="run_event",
                attrs=attrs))
    return spans


def collect_spans(dirs) -> list[dict]:
    """Every span reconstructable from the journals under ``dirs`` (see
    module docstring for the per-journal synthesis rules)."""
    mint = _Minted()
    spans: list[dict] = []
    for path, host_hint in _journal_files(dirs):
        records = list(_read_jsonl(path))
        if not records:
            continue
        base = os.path.basename(path)
        if base == "journal-pod.jsonl":
            spans.extend(_pod_spans(records, host_hint, mint))
        elif base == "journal-supervisor.jsonl":
            spans.extend(_supervisor_spans(records, host_hint, mint))
        else:
            spans.extend(_run_spans(records, host_hint, mint))
    return spans


def children_of(spans) -> dict:
    """``parent span_id -> [child spans]`` index."""
    out: dict = {}
    for s in spans:
        if s.get("parent_id"):
            out.setdefault(s["parent_id"], []).append(s)
    return out


def coordinated_restart_trees(spans) -> list[dict]:
    """One entry per coordinated-restart DECISION span (``pod_restart``),
    with the child spans hanging under it (the per-host attempts the
    control record commanded). The chaos scenarios assert on this:
    exactly one tree per restart, with the fencing epoch on every child
    attempt span."""
    kids = children_of(spans)
    out = []
    for s in spans:
        if s["name"] != "pod_restart":
            continue
        out.append({
            "epoch": s["attrs"].get("epoch"),
            "span": s,
            "children": sorted(kids.get(s["span_id"], ()),
                               key=lambda c: (c.get("host") or "",
                                              c["t0"])),
        })
    return sorted(out, key=lambda e: (e["epoch"] or 0))


def export_chrome(spans) -> dict:
    """Chrome trace-event JSON (also loadable in Perfetto): one complete
    ('X') event per span, processes keyed by host, plus process-name
    metadata."""
    pids: dict = {}
    events = []
    tids = {"pod": 0, "decision": 1, "pod_event": 2, "supervise": 3,
            "attempt": 4, "sup_event": 5, "run": 6, "chunk": 7,
            "phase": 8, "checkpoint": 9, "run_event": 10, "span": 11}
    for s in sorted(spans, key=lambda x: x["t0"]):
        host = s.get("host") or "?"
        pid = pids.setdefault(host, len(pids) + 1)
        args = {"span_id": s["span_id"], "parent_id": s.get("parent_id"),
                "trace_id": s.get("trace_id"), **s["attrs"]}
        events.append({
            "name": s["name"],
            "cat": s["cat"],
            "ph": "X",
            "ts": int(s["t0"] * 1e6),
            "dur": max(1, int((s["t1"] - s["t0"]) * 1e6)),
            "pid": pid,
            "tid": tids.get(s["cat"], 12),
            "args": args,
        })
    meta = [{"name": "process_name", "ph": "M", "pid": pid,
             "args": {"name": host}} for host, pid in pids.items()]
    return {"traceEvents": meta + events, "displayTimeUnit": "ms"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Export fps_tpu_torch journals as one Chrome/Perfetto "
                    "trace")
    ap.add_argument("dirs", nargs="+",
                    help="obs / supervisor-state / pod directories "
                         "(walked recursively for journal-*.jsonl)")
    ap.add_argument("-o", "--out", default=None,
                    help="output path (default: stdout)")
    ap.add_argument("--pretty", action="store_true")
    args = ap.parse_args(argv)
    spans = collect_spans(args.dirs)
    if not spans:
        print(f"no journal-*.jsonl spans under {args.dirs}",
              file=sys.stderr)
        return 2
    doc = export_chrome(spans)
    text = json.dumps(doc, indent=2 if args.pretty else None,
                      allow_nan=False, default=str)
    if args.out:
        with open(args.out, "w", encoding="utf-8") as f:
            f.write(text + "\n")
        trees = coordinated_restart_trees(spans)
        print(f"wrote {args.out}: {len(spans)} spans, "
              f"{len(trees)} coordinated restart(s)", file=sys.stderr)
    else:
        print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
