"""Budget-drift detection: live data-plane traffic vs certified budgets.

Port of ``fps_tpu/obs/drift.py``. The audit pins exact per-program
collective count and byte budgets (``fps_tpu_torch/examples/
audit_programs.py``'s ``BUDGETS``, or an ``AUDIT_r*.json`` file of the JAX
package), but nothing at run time checks the live data plane against them:
a re-plan, a route demotion or a silent cold-budget regression changes what
the run moves while the pinned file stays green. This module folds the
measured shape of what the trainer is running (the programs' collective
profiles from ``fps_tpu_torch.analysis.collective_profile``, weighted by
the live dispatch counters the data plane already emits:
``cold_route.compact_chunks`` / ``overflow_chunks`` / ``driver.chunks``)
against the pinned budgets, and emits:

* ``analysis.budget_drift{program=...}`` — gauge: measured/pinned byte
  ratio per observed program (1.0 = on budget);
* a ``budget_drift`` incident event whenever measured traffic departs
  from the certified shape (byte ratio outside tolerance, collective
  count mismatch, or an observed program with no pinned row).

Host-side only: the detector re-reads texts and counters the run already
produced. Stdlib-only (the profile objects are duck-typed), so fleet
tooling can load it without torch.
"""

from __future__ import annotations

import dataclasses
import json
import math

__all__ = [
    "load_pinned_budgets", "profile_budget", "DriftReport",
    "BudgetDriftDetector",
]


def load_pinned_budgets(path: str) -> dict:
    """Pinned per-program budgets from an audit output file (the
    ``--out`` of ``fps_tpu_torch/examples/audit_programs.py``, or an
    ``AUDIT_r*.json`` of the JAX package): ``{program: {"count": int,
    "bytes": int, "per_kind": {kind: {"count", "bytes"}}}}``."""
    with open(path, encoding="utf-8") as f:
        doc = json.load(f)
    rows = doc.get("audit_programs", doc)
    out = {}
    for name, row in rows.items():
        colls = (row or {}).get("collectives")
        if not isinstance(colls, dict):
            continue
        out[name] = {
            "count": int(colls.get("count", 0)),
            "bytes": int(colls.get("bytes", 0)),
            "per_kind": {k: {"count": int(v.get("count", 0)),
                             "bytes": int(v.get("bytes", 0))}
                         for k, v in (colls.get("per_kind") or {}).items()},
        }
    return out


def profile_budget(profile) -> dict:
    """Normalize a live program's collective profile — an iterable of
    ``fps_tpu_torch.analysis`` Collective objects, ``(kind, payload_bytes)``
    tuples, or ``{"kind", "payload_bytes"}`` dicts — into the same
    ``{"count", "bytes", "per_kind"}`` shape as the pinned rows."""
    count, total = 0, 0
    per_kind: dict = {}
    for c in profile:
        if isinstance(c, dict):
            kind, b = c.get("kind", "?"), int(c.get("payload_bytes", 0))
        elif isinstance(c, (tuple, list)):
            kind, b = c[0], int(c[1])
        else:
            kind, b = c.kind, int(c.payload_bytes)
        count += 1
        total += b
        pk = per_kind.setdefault(kind, {"count": 0, "bytes": 0})
        pk["count"] += 1
        pk["bytes"] += b
    return {"count": count, "bytes": total, "per_kind": per_kind}


@dataclasses.dataclass(frozen=True)
class DriftReport:
    """One observed program's measured-vs-pinned verdict."""

    program: str
    chunks: int
    pinned_bytes: int | None
    measured_bytes: int
    pinned_count: int | None
    measured_count: int
    byte_ratio: float | None  # measured / pinned (None when unpinned)
    ok: bool
    reasons: tuple[str, ...] = ()

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class BudgetDriftDetector:
    """Folds live program observations against pinned budgets.

    Args:
      pinned: ``{program: {"count", "bytes", "per_kind"}}`` — the
        :func:`load_pinned_budgets` shape (an ``AUDIT_r*.json`` file
        loaded via the audit pipeline).
      recorder: optional ``fps_tpu_torch.obs.Recorder``; when given,
        ``evaluate()`` emits the gauge/incident telemetry (falls back to
        the process-default recorder otherwise).
      byte_rel_tol: allowed relative departure of measured from pinned
        payload bytes before an incident fires (floats-per-row payloads
        are exact, so the default tolerance only absorbs pinning noise
        like replica-group padding).
      count_tol: allowed absolute collective-count difference.
      allow_unpinned: observed programs with no pinned row pass quietly
        when True (a new workload mid-rollout); False makes them
        incidents (CI semantics — everything dispatched must be pinned).

    Typical wiring — once per run or per re-plan boundary::

        det = BudgetDriftDetector(load_pinned_budgets("AUDIT_r10.json"),
                                  recorder=rec)
        det.observe("mf_tiered_compact", collective_profile(hlo_compact),
                    chunks=rec.counter_value("cold_route.compact_chunks"))
        det.observe("mf_tiered_gathered", collective_profile(hlo_static),
                    chunks=overflow_chunks)
        reports = det.evaluate()

    The live dispatch counters decide WHAT gets checked: each program a
    counter proves was dispatched is compared against its OWN pinned row
    (per-dispatch payloads are exact, so per-program comparison IS the
    measured-traffic check — there is no averaging that could let an
    over-budget program hide behind an under-budget one), and an
    observation with ``chunks=0`` carried no traffic, so it reports its
    ratio but can never fire an incident. ``chunks`` also rides the
    report/incident so responders see how much traffic drifted.
    """

    def __init__(self, pinned: dict, *, recorder=None,
                 byte_rel_tol: float = 0.05, count_tol: int = 0,
                 allow_unpinned: bool = True):
        if byte_rel_tol < 0 or count_tol < 0:
            raise ValueError("byte_rel_tol and count_tol must be >= 0")
        self.pinned = dict(pinned)
        self.recorder = recorder
        self.byte_rel_tol = float(byte_rel_tol)
        self.count_tol = int(count_tol)
        self.allow_unpinned = bool(allow_unpinned)
        self._observed: list[tuple[str, dict, int]] = []

    def observe(self, program: str, profile=None, *, chunks: int = 1,
                budget: dict | None = None) -> None:
        """Record that ``program`` (live profile ``profile``, or an
        already-normalized ``budget`` dict) was dispatched for
        ``chunks`` chunks. ``chunks=0`` observations are kept — their
        report documents the program exists and its ratio — but they
        moved no traffic, so ``evaluate()`` never turns their
        departures into incidents."""
        if (profile is None) == (budget is None):
            raise ValueError("pass exactly one of profile= or budget=")
        b = budget if budget is not None else profile_budget(profile)
        self._observed.append((program, dict(b), max(int(chunks), 0)))

    def evaluate(self, *, emit: bool = True) -> list[DriftReport]:
        """Compare every observation against its pinned row; optionally
        (default) emit ``analysis.budget_drift`` gauges and
        ``budget_drift`` incident events for departures."""
        reports = []
        for program, measured, chunks in self._observed:
            pin = self.pinned.get(program)
            reasons = []
            ratio = None
            if pin is None:
                if not self.allow_unpinned:
                    reasons.append("no pinned budget for observed "
                                   f"program {program!r}")
                pinned_bytes = pinned_count = None
            else:
                pinned_bytes = int(pin["bytes"])
                pinned_count = int(pin["count"])
                if pinned_bytes:
                    ratio = measured["bytes"] / pinned_bytes
                    if not math.isclose(ratio, 1.0,
                                        rel_tol=self.byte_rel_tol):
                        reasons.append(
                            f"collective bytes {measured['bytes']} vs "
                            f"pinned {pinned_bytes} "
                            f"(ratio {ratio:.4f}, tol "
                            f"{self.byte_rel_tol})")
                elif measured["bytes"]:
                    ratio = math.inf
                    reasons.append(
                        f"collective bytes {measured['bytes']} vs "
                        "pinned 0")
                else:
                    ratio = 1.0
                if abs(measured["count"] - pinned_count) > self.count_tol:
                    reasons.append(
                        f"collective count {measured['count']} vs "
                        f"pinned {pinned_count}")
                for kind, pk in (pin.get("per_kind") or {}).items():
                    got = measured["per_kind"].get(
                        kind, {"count": 0, "bytes": 0})
                    if abs(got["count"] - pk["count"]) > self.count_tol:
                        reasons.append(
                            f"{kind}: count {got['count']} vs pinned "
                            f"{pk['count']}")
                for kind in measured["per_kind"]:
                    if kind not in (pin.get("per_kind") or {}):
                        reasons.append(f"unpinned collective kind "
                                       f"{kind!r} appeared")
            if chunks == 0:
                # Zero dispatches moved zero traffic: the report keeps
                # the ratio as evidence, but nothing drifted LIVE.
                reasons = []
            report = DriftReport(
                program=program,
                chunks=chunks,
                pinned_bytes=pinned_bytes,
                measured_bytes=int(measured["bytes"]),
                pinned_count=pinned_count,
                measured_count=int(measured["count"]),
                byte_ratio=(round(ratio, 6)
                            if ratio is not None
                            and math.isfinite(ratio) else ratio),
                ok=not reasons,
                reasons=tuple(reasons),
            )
            reports.append(report)
            if emit:
                self._emit(report)
        return reports

    # -- telemetry --------------------------------------------------------

    def _emit(self, report: DriftReport) -> None:
        rec = self.recorder
        ratio = report.byte_ratio
        gauge = (float(ratio) if ratio is not None
                 and math.isfinite(ratio) else float("nan"))
        if rec is not None:
            rec.set("analysis.budget_drift", gauge,
                    program=report.program)
        else:
            from fps_tpu_torch.obs import events

            events.record_metric("set", "analysis.budget_drift", gauge,
                                 program=report.program)
        if report.ok:
            return
        fields = {k: v for k, v in report.to_json().items()
                  if k != "ok"}
        fields["reasons"] = list(report.reasons)
        if rec is not None:
            rec.event("budget_drift", **fields)
        else:
            from fps_tpu_torch.obs import events

            events.emit("budget_drift", **fields)

    # -- convenience ------------------------------------------------------

    def observe_trainer_chunk(self, trainer, chunk, *, program: str,
                              mode: str = "sync",
                              chunks: int = 1) -> None:
        """Observe the exact program ``trainer.fit_stream`` would run for
        ``chunk`` (recorded by ``Trainer.lowered_chunk_text``, profiled by
        ``fps_tpu_torch.analysis.collective_profile``) — the one-call
        wiring for tests and end-of-run checks."""
        from fps_tpu_torch.analysis import collective_profile

        hlo = trainer.lowered_chunk_text(chunk, mode)
        self.observe(program, collective_profile(hlo), chunks=chunks)
