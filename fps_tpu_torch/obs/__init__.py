"""fps_tpu_torch.obs — telemetry for the PyTorch parameter server.

Port of ``fps_tpu/obs/`` (see ``docs/observability.md``), the same record
shapes and files, so the reference's ``tools/obs_report.py`` and
``tools/trace_export.py`` read the port's runs:

* **schema** — :class:`MetricsRegistry` / :class:`MetricSpec` name and
  type every metrics leaf; :class:`Recorder` validates emissions and fans
  them out to pluggable sinks (:class:`JsonlSink`,
  :class:`PrometheusSink`, :class:`MemorySink`).
* **timing** — :class:`PhaseTimer` splits each chunk into host phases
  (ingest/place/dispatch/host_sync/checkpoint/callback);
  :class:`Throughput` and :func:`trace` (``torch.profiler``) complete the
  clock set.
* **alerting** — :class:`HealthMonitor` thresholds the guard's health
  channel (observe→mask escalation, poison abort);
  :class:`StepWatchdog` deadline-flags stalled chunks/stragglers.
* **journal** — :class:`RunJournal` writes the per-process run narrative
  that ``tools/obs_report.py`` renders into a digest.
* **tracing** — :mod:`fps_tpu_torch.obs.trace` mints trace/span ids
  propagated through the supervised-child env contract (the reference's
  env-var names).
* **fleet** — :mod:`fps_tpu_torch.obs.fleet` tails N per-host obs dirs
  into windowed rollups with declarative SLO burn-rate evaluation.

* **drift** — :mod:`fps_tpu_torch.obs.drift` checks the live data plane's
  collective traffic against the budgets the program auditor pinned
  (``analysis.budget_drift`` + incidents).

Everything is host-side: attaching a recorder changes no table, launch or
host synchronisation (tested, and gated on the card by ``chip_smoke.py``),
and ``recorder=None`` costs nothing.
"""

from __future__ import annotations

import os

from fps_tpu_torch.obs import events
from fps_tpu_torch.obs.drift import BudgetDriftDetector, load_pinned_budgets
from fps_tpu_torch.obs.fleet import (
    DEFAULT_SLOS,
    SLO,
    evaluate_slos,
    fleet_digest,
)
from fps_tpu_torch.obs.health import (
    HEALTH_ABORT,
    HEALTH_ESCALATE,
    HEALTH_OK,
    HealthMonitor,
    StepWatchdog,
)
from fps_tpu_torch.obs.journal import (
    RunJournal,
    config_digest,
    new_run_id,
    process_index,
)
from fps_tpu_torch.obs.registry import (
    MetricSpec,
    MetricsRegistry,
    Recorder,
    default_registry,
)
from fps_tpu_torch.obs.sinks import JsonlSink, MemorySink, PrometheusSink, Sink
from fps_tpu_torch.obs.trace import (
    PARENT_SPAN_ENV,
    TRACE_ID_ENV,
    TraceContext,
    Tracer,
    new_span_id,
    new_trace_id,
)

# After the trace submodule: ``obs.trace`` is the profiler context
# manager, not the module.
from fps_tpu_torch.obs.timing import DRIVER_PHASES, PhaseTimer, Throughput, trace

__all__ = [
    "MetricSpec", "MetricsRegistry", "Recorder", "default_registry",
    "Sink", "JsonlSink", "MemorySink", "PrometheusSink",
    "PhaseTimer", "Throughput", "trace", "DRIVER_PHASES",
    "HealthMonitor", "StepWatchdog",
    "HEALTH_OK", "HEALTH_ESCALATE", "HEALTH_ABORT",
    "RunJournal", "new_run_id", "config_digest", "process_index",
    "TraceContext", "Tracer", "new_trace_id", "new_span_id",
    "TRACE_ID_ENV", "PARENT_SPAN_ENV",
    "SLO", "DEFAULT_SLOS", "evaluate_slos", "fleet_digest",
    "BudgetDriftDetector", "load_pinned_budgets",
    "events", "open_run",
]


def open_run(obs_dir: str, *, config=None, run_id: str | None = None,
             meta: dict | None = None, registry: MetricsRegistry | None = None,
             install: bool = True) -> Recorder:
    """Standard on-disk telemetry for one training run (the ``--obs-dir``
    CLI path): under ``obs_dir`` this process writes

    * ``events-p<K>.jsonl``  — every metric sample + event (JSONL),
    * ``journal-p<K>.jsonl`` — events only, bracketed run_start/run_end,
    * ``metrics-p<K>.prom``  — Prometheus text exposition (rewritten at
      flush; point a file scrape at it),

    where ``<K>`` is the process index (the ``torch.distributed`` rank;
    over several processes one set per process, ``tools/obs_report.py``
    joins on the shared run id). ``config`` is
    digested into the journal's run_start record; ``install=True`` also
    makes this the process-default recorder so checkpoint/rollback events
    flow without explicit plumbing. Close (or ``with``-scope) the
    recorder to get the run_end record and final flush.
    """
    run_id = run_id or new_run_id()
    proc = process_index()
    os.makedirs(obs_dir, exist_ok=True)
    # Causal tracing (fps_tpu_torch.obs.trace): inherit the trace/parent-span
    # from the supervisor env contract (or mint a standalone trace) and
    # mint this run's own span — the journal's run_start is the causal
    # anchor everything in this obs dir hangs under when
    # tools/trace_export.py renders the tree. Host-side only: these are
    # env vars and journal fields, never on the device.
    ctx = TraceContext.from_env()
    run_span = new_span_id()
    run_meta = {"process": proc, "config_digest": config_digest(config),
                "trace_id": ctx.trace_id or new_trace_id(),
                "span_id": run_span, "parent_id": ctx.parent_id}
    if meta:
        run_meta.update(meta)
    journal = RunJournal(
        os.path.join(obs_dir, f"journal-p{proc}.jsonl"),
        run_id=run_id, meta=run_meta,
    )
    rec = Recorder(
        registry,
        sinks=[
            JsonlSink(os.path.join(obs_dir, f"events-p{proc}.jsonl")),
            PrometheusSink(os.path.join(obs_dir, f"metrics-p{proc}.prom")),
            journal,
        ],
        run_id=run_id,
        base_labels={"process": str(proc)},
    )
    # The run's tracer: explicit spans emitted through it parent under
    # this run's span by default (rec.trace.span("my_phase"): ...).
    rec.trace = Tracer(rec, trace_id=run_meta["trace_id"],
                       parent_id=run_span)
    if install:
        events.set_default_recorder(rec)
        _prev_close = rec.close

        def close_and_uninstall():
            if events.get_default_recorder() is rec:
                events.set_default_recorder(None)
            _prev_close()

        rec.close = close_and_uninstall
    return rec
