"""Typed metrics registry + recorder — the front door of the telemetry
subsystem.

Port of ``fps_tpu/obs/registry.py``, spec for spec: every metrics leaf the
framework emits is a :class:`MetricSpec` (name, kind, unit, allowed labels,
and the reference's help text, word for word) registered in a
:class:`MetricsRegistry`, and every emission goes through a
:class:`Recorder` that validates against the schema and fans the sample
out to pluggable sinks (:mod:`fps_tpu_torch.obs.sinks`: JSONL event log,
Prometheus text exposition, in-memory ring for tests). The registry is a
schema: every leaf of the JAX package's registry is declared, so a file
written by either package validates against the other's registry.

Host-side only, stdlib-only: nothing here runs on the device or touches a
tensor, so attaching or detaching a recorder changes no table, launch or
host synchronisation (asserted in ``tests/test_torch_obs_driver.py`` and
on the card by ``chip_smoke.py``'s phase 12). ``recorder=None`` everywhere
in the driver means zero calls into this module — the off state costs
nothing.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Iterable, Mapping

METRIC_KINDS = ("counter", "gauge", "histogram")


@dataclasses.dataclass(frozen=True)
class MetricSpec:
    """One named, typed metrics leaf.

    ``labels`` declares the allowed label KEYS (e.g. ``("table",)`` for a
    per-table counter, ``("phase",)`` for the phase timer histogram) —
    recording with an undeclared key raises, so a typo'd label surfaces at
    the emission site instead of silently forking a new series.
    """

    name: str
    kind: str
    unit: str = ""
    labels: tuple[str, ...] = ()
    help: str = ""

    def __post_init__(self):
        if self.kind not in METRIC_KINDS:
            raise ValueError(
                f"metric {self.name!r}: kind {self.kind!r} — expected one "
                f"of {METRIC_KINDS}"
            )
        if not self.name or any(c.isspace() for c in self.name):
            raise ValueError(f"metric name {self.name!r} must be non-empty "
                             "and whitespace-free")
        object.__setattr__(self, "labels", tuple(self.labels))


class MetricsRegistry:
    """Name → :class:`MetricSpec` map; the single source of truth for what
    the framework can emit. Duplicate registration with a different spec
    raises (same spec is idempotent, so library + user code can both
    declare shared leaves)."""

    def __init__(self, specs: Iterable[MetricSpec] = ()):
        self._specs: dict[str, MetricSpec] = {}
        for s in specs:
            self.register(s)

    def register(self, spec: MetricSpec) -> MetricSpec:
        have = self._specs.get(spec.name)
        if have is not None and have != spec:
            raise ValueError(
                f"metric {spec.name!r} already registered as {have}"
            )
        self._specs[spec.name] = spec
        return spec

    def get(self, name: str) -> MetricSpec:
        try:
            return self._specs[name]
        except KeyError:
            raise KeyError(
                f"unregistered metric {name!r} — declare it with "
                "MetricsRegistry.register(MetricSpec(...)) (typed leaves, "
                "not anonymous pytrees)"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._specs

    @property
    def specs(self) -> Mapping[str, MetricSpec]:
        return dict(self._specs)


def default_registry() -> MetricsRegistry:
    """A fresh registry pre-declaring every leaf the framework emits."""
    return MetricsRegistry([
        # Driver progress.
        MetricSpec("driver.chunks", "counter", unit="chunks",
                   help="compiled chunks completed (fit_stream)"),
        MetricSpec("driver.epochs", "counter", unit="epochs",
                   help="epochs completed (run_indexed)"),
        MetricSpec("driver.steps", "counter", unit="steps",
                   help="scan steps completed"),
        MetricSpec("driver.examples", "counter", unit="examples",
                   help="examples consumed (sum of the 'n' metrics leaf)"),
        # Phase timers (fps_tpu_torch.obs.timing.PhaseTimer).
        MetricSpec("driver.phase_seconds", "histogram", unit="s",
                   labels=("phase",),
                   help="host wall-clock per phase segment: ingest / place "
                        "/ dispatch / host_sync / checkpoint / callback / "
                        "reconcile / retier / megastep"),
        # Device-resident megastep (fps_tpu.core.megastep;
        # docs/performance.md "Megastep").
        MetricSpec("megastep.windows", "counter", unit="windows",
                   help="in-graph chunk windows executed by megastep "
                        "dispatches (chunks_per_dispatch per call — each "
                        "ends with the flush reconcile + sketch merge the "
                        "per-chunk host loop ran between dispatches)"),
        MetricSpec("megastep.chunks_per_dispatch", "gauge", unit="chunks",
                   help="K of the current megastep program: chunk "
                        "segments fused into one compiled dispatch"),
        MetricSpec("megastep.auto_k", "gauge", unit="chunks",
                   help="K chosen by the auto-K calibration window "
                        "(chunks_per_dispatch='auto'): smallest K whose "
                        "modeled host-serial share h/(h+K*c) clears the "
                        "target, rounded up to the tick cadence"),
        MetricSpec("cold_route.vote_compact_windows", "counter",
                   unit="windows",
                   help="megastep chunk windows whose device-side "
                        "overflow VOTE certified every cold_budget lane "
                        "(the window ran the compacted cold routes; the "
                        "in-graph analog of cold_route.compact_chunks)"),
        MetricSpec("cold_route.vote_overflow_windows", "counter",
                   unit="windows",
                   help="megastep chunk windows whose single AND-ed "
                        "device vote overflowed (or could not certify) "
                        "some cold_budget lane and ran the bit-identical "
                        "static-route branch — unlabeled: the verdict is "
                        "one bit per window, a per-table attribution "
                        "would multiply-count it"),
        # Host pipeline (fps_tpu.core.prefetch).
        MetricSpec("prefetch.chunks", "counter", unit="chunks",
                   help="chunks assembled+placed by the background "
                        "prefetch pipeline"),
        MetricSpec("prefetch.queue_depth", "gauge", unit="chunks",
                   help="placed chunks buffered ahead of the driver "
                        "(sampled at every pipeline put/get)"),
        MetricSpec("prefetch.depth_adjustments", "counter", unit="steps",
                   help="adaptive depth raises: the consumer kept "
                        "draining the buffer empty inside a stall "
                        "window and host memory allowed one more "
                        "buffered chunk"),
        # Two-tier hot storage (TableSpec.hot_tier / TrainerConfig.
        # hot_sync_every; docs/performance.md "Two-tier storage").
        MetricSpec("hot_tier.hot_rows", "counter", unit="rows",
                   labels=("table",),
                   help="pulled rows served by the replicated hot tier "
                        "(local gather, zero collectives)"),
        MetricSpec("hot_tier.pulled_rows", "counter", unit="rows",
                   labels=("table",),
                   help="total live rows pulled from a tiered table "
                        "(hot_rows / pulled_rows = the hit rate)"),
        MetricSpec("hot_tier.pending_delta", "gauge", unit="l2",
                   labels=("table",),
                   help="peak within-call root-sum-square of the hot "
                        "tier's per-device pending (un-reconciled) delta "
                        "buffers — a parameter-plane staleness PROXY: "
                        "the delta a reconcile actually applies is the "
                        "psum, whose norm can exceed this by up to "
                        "sqrt(num_devices) when device deltas align"),
        # Payload-proportional cold routing (TableSpec.cold_budget;
        # docs/performance.md "Payload-proportional routing").
        MetricSpec("cold_route.compact_chunks", "counter", unit="chunks",
                   help="chunks host-certified to fit every cold_budget "
                        "lane and dispatched through the COMPACTED "
                        "cold-route program (O(cold traffic) collective "
                        "payload)"),
        MetricSpec("cold_route.overflow_chunks", "counter", unit="chunks",
                   labels=("table",),
                   help="chunks that overflowed (or could not certify) a "
                        "table's cold_budget lane and fell back to the "
                        "static full-payload cold routes — incremented "
                        "once per overflowing table per chunk"),
        MetricSpec("hot_tier.cold_dropped", "counter", unit="rows",
                   labels=("table",),
                   help="cold rows dropped by the device-side compaction "
                        "lane (the observability net: zero for every "
                        "host-certified chunk by construction)"),
        # Adaptive tiering (fps_tpu.tiering; docs/performance.md
        # "Adaptive tiering"): online hot-set re-ranking + auto-planner.
        MetricSpec("tiering.re_ranks", "counter", unit="re_ranks",
                   labels=("table",),
                   help="hot-set re-ranks applied (replica + slot-map "
                        "swap; never a recompile)"),
        MetricSpec("tiering.churn", "gauge", unit="fraction",
                   labels=("table",),
                   help="last measured churn: |sketched top-H \\ current "
                        "hot set| / H at the most recent check"),
        MetricSpec("tiering.promoted_rows", "counter", unit="rows",
                   labels=("table",),
                   help="ids promoted into the hot set by re-ranks"),
        MetricSpec("tiering.demoted_rows", "counter", unit="rows",
                   labels=("table",),
                   help="ids demoted out of the hot set by re-ranks"),
        MetricSpec("tiering.replans", "counter", unit="replans",
                   labels=("changed",),
                   help="periodic re-planning checks (Retierer."
                        "replan_every): changed=true re-applied a new "
                        "plan (one deliberate recompile), changed=false "
                        "was a strict no-op (zero recompiles)"),
        # Health channel (thresholded by fps_tpu_torch.obs.health.HealthMonitor).
        MetricSpec("health.nonfinite_rows", "counter", unit="rows",
                   labels=("table",),
                   help="push rows dropped/flagged with non-finite values"),
        MetricSpec("health.norm_rows", "counter", unit="rows",
                   labels=("table",),
                   help="push rows over the guard's norm_limit"),
        MetricSpec("health.masked_rows", "counter", unit="rows",
                   labels=("table",),
                   help="push rows masked in guard='mask' mode"),
        MetricSpec("health.poisoned_chunks", "counter", unit="chunks",
                   help="chunks/epochs whose health channel reported poison"),
        # Resilience / persistence events.
        MetricSpec("rollback.quarantined", "counter", unit="chunks",
                   help="chunks/epochs rolled back and quarantined"),
        MetricSpec("rollback.preset_skipped", "counter", unit="chunks",
                   help="chunks/epochs skipped via a supervisor-carried "
                        "quarantine preset (never dispatched)"),
        MetricSpec("checkpoint.saves", "counter", unit="snapshots"),
        MetricSpec("checkpoint.enqueues", "counter", unit="snapshots",
                   help="async snapshots accepted for background write "
                        "(checkpoint.saves marks the durability point)"),
        MetricSpec("checkpoint.save_seconds", "histogram", unit="s"),
        MetricSpec("checkpoint.dump_seconds", "histogram", unit="s",
                   help="what a save costs the TRAINING thread: the "
                        "inline device->host capture, or — on the "
                        "deferred path — just the enqueue of the "
                        "boundary copies (capture itself then rides "
                        "checkpoint.capture_seconds on the writer)"),
        MetricSpec("checkpoint.capture_seconds", "histogram", unit="s",
                   help="device->host snapshot capture time (touched-row "
                        "device_get + CRC prep) wherever it runs — on "
                        "the writer thread under deferred capture, "
                        "inline otherwise; dump_seconds minus this is "
                        "the training thread's residual share"),
        MetricSpec("checkpoint.bytes", "gauge", unit="bytes",
                   help="size of the last written FULL snapshot (delta "
                        "publications ride checkpoint.delta_bytes; the "
                        "two together are the payload-proportionality "
                        "ratio)"),
        MetricSpec("checkpoint.fallbacks", "counter", unit="snapshots",
                   help="corrupt snapshots quarantined by fallback restore"),
        # Delta-snapshot chains (Checkpointer(delta=DeltaPolicy(...))).
        MetricSpec("checkpoint.delta_publishes", "counter",
                   unit="snapshots",
                   help="publications written as row-sparse DELTAS "
                        "against the previous publication (checkpoint."
                        "saves counts fulls and deltas alike)"),
        MetricSpec("checkpoint.delta_bytes", "counter", unit="bytes",
                   help="total bytes published as deltas — against "
                        "checkpoint.bytes' full-snapshot size, the "
                        "payload-proportionality evidence (publish "
                        "bytes ~ touched rows, not table size)"),
        MetricSpec("checkpoint.compactions", "counter", unit="folds",
                   help="LSM-style chain compactions: a delta chain "
                        "folded into a fresh full at its head step "
                        "(atomic-rename + fence-precommit, crash-safe "
                        "at every phase)"),
        MetricSpec("checkpoint.fenced_publishes", "counter",
                   unit="snapshots",
                   help="publishes refused by a pod fence (the writer's "
                        "epoch predates the pod's current attempt — "
                        "fps_tpu.supervise.pod)"),
        MetricSpec("checkpoint.resplits", "counter", unit="restores",
                   help="restores that re-split tables onto a different "
                        "mesh shape than the snapshot's (the elastic "
                        "W±1 path; each is asserted bit-identical)"),
        # Hostile-filesystem survival (fps_tpu.core.retry + degraded-
        # mode storage; docs/resilience.md "Hostile filesystem").
        MetricSpec("storage.retries", "counter", unit="ops",
                   labels=("plane",),
                   help="file operations retried after a transient I/O "
                        "error (bounded deterministic backoff; plane: "
                        "checkpoint / sidecar / ...)"),
        MetricSpec("storage.degraded_publishes", "counter",
                   unit="snapshots",
                   help="checkpoint publishes SKIPPED after the retry "
                        "budget on a transient storage failure — "
                        "training continues on last-good durable state; "
                        "each skip spends recency (the storage-"
                        "staleness SLO), never correctness"),
        MetricSpec("checkpoint.publish_backlog", "gauge",
                   unit="snapshots",
                   help="consecutive degraded (skipped) publishes since "
                        "the last landed one — drains to 0 the moment a "
                        "publish lands, because a landed snapshot fully "
                        "describes its step"),
        MetricSpec("storage.poll_errors", "counter", unit="polls",
                   labels=("plane",),
                   help="read-plane polls degraded by a transient "
                        "filesystem error (plane: watcher / fleet) — "
                        "the reader served last-good state and retried "
                        "next tick, never froze or crashed"),
        MetricSpec("storage.sidecar_skips", "counter", unit="writes",
                   help="tiering sidecar writes skipped after the retry "
                        "budget (advisory state: a resume past that "
                        "boundary cold-starts the tracker, warned "
                        "loudly)"),
        MetricSpec("storage.compaction_aborts", "counter", unit="folds",
                   help="LSM chain compactions aborted by an I/O "
                        "failure mid-fold (ENOSPC and kin): the chain "
                        "stays intact and the fold retries at the next "
                        "publish"),
        # Watchdog.
        MetricSpec("watchdog.stalls", "counter", unit="stalls",
                   help="chunk/epoch dispatches that overran the deadline"),
        # Read-path serving tier (fps_tpu.serve; docs/serving.md).
        MetricSpec("serve.requests", "counter", unit="requests",
                   labels=("op",),
                   help="ReadServer queries answered (op: pull / score / "
                        "topk)"),
        MetricSpec("serve.rows", "counter", unit="rows",
                   help="parameter rows served across all requests"),
        MetricSpec("serve.request_seconds", "histogram", unit="s",
                   labels=("op",),
                   help="per-request service latency (p50/p99 over the "
                        "retained window via ReadServer.latency_s)"),
        MetricSpec("serve.snapshot_step", "gauge", unit="step",
                   help="training step of the snapshot currently served"),
        MetricSpec("serve.snapshot_lag_steps", "gauge", unit="steps",
                   help="newest step the trainer has written minus the "
                        "served step — the freshness SLO in steps (NaN "
                        "when the served step was quarantined and nothing "
                        "survives)"),
        MetricSpec("serve.write_to_servable_s", "gauge", unit="s",
                   help="durability (checkpoint_saved) to servable "
                        "wall-clock lag of the last publish — the "
                        "end-to-end write->servable freshness SLO"),
        MetricSpec("serve.swaps", "counter", unit="swaps",
                   labels=("direction",),
                   help="snapshot hot-swaps published to the ReadServer "
                        "(direction: forward, or backward when the "
                        "trainer quarantined the served snapshot)"),
        MetricSpec("serve.rejected_snapshots", "counter", unit="snapshots",
                   help="snapshot candidates that failed CRC/structural "
                        "verification and were never served"),
        MetricSpec("serve.fence_step", "gauge", unit="step",
                   help="the serving fleet's shared step fence "
                        "(fps_tpu.serve.fleet): the step this reader "
                        "last swapped to under the fence — "
                        "forward-monotone fleet-wide within a fencing "
                        "epoch; backward only on a coordinated "
                        "quarantine rollback (epoch bump)"),
        MetricSpec("serve.reader_heartbeat_age_s", "gauge", unit="s",
                   labels=("reader",),
                   help="age of a fleet reader's newest liveness "
                        "beacon at the last liveness pass "
                        "(fps_tpu.serve.fleet.liveness_check); beyond "
                        "the liveness timeout the reader is classified "
                        "reader_wedged — an incident, never a silent "
                        "0 q/s (BENCH_r14)"),
        MetricSpec("serve.batches", "counter", unit="batches",
                   help="coalesced/multi batches executed by the "
                        "ReadServer (one merged fancy-index gather per "
                        "table per batch; docs/serving.md \"Batched "
                        "reads\")"),
        MetricSpec("serve.batch_size", "histogram", unit="requests",
                   help="requests merged into each coalesced/multi "
                        "batch — the batch-size/latency curve's x-axis "
                        "(bench serve_scale)"),
        MetricSpec("serve.fleet_size", "gauge", unit="readers",
                   help="fleet membership after each autoscaler "
                        "evaluation (fps_tpu.serve.fleet."
                        "ReadAutoscaler)"),
        MetricSpec("serve.autoscale_actions", "counter", unit="actions",
                   labels=("action",),
                   help="autoscaler scale decisions taken (action: "
                        "scale_up / scale_down / replace) — each one "
                        "also journaled as an autoscale_evaluate span "
                        "with its evidence"),
        # Wire plane (fps_tpu.serve.wire / serve.net; docs/resilience.md
        # "Hostile network").
        MetricSpec("net.retries", "counter", unit="requests",
                   labels=("peer_class",),
                   help="wire requests re-sent after a transient "
                        "network failure (classify_net: refused / "
                        "reset / timeout / torn frame), on the bounded "
                        "sha256-jittered backoff schedule"),
        MetricSpec("net.reconnects", "counter", unit="connections",
                   help="client reconnects that re-handshook and "
                        "resumed under the same session id (resends "
                        "dedupe server-side by (session, req_id))"),
        MetricSpec("net.torn_frames", "counter", unit="frames",
                   help="inbound frames rejected by the length/CRC "
                        "gates (short read, bad magic, checksum "
                        "mismatch) — counted and dropped with the "
                        "connection, NEVER decoded"),
        MetricSpec("net.shed_requests", "counter", unit="requests",
                   help="requests shed with a retryable BUSY frame by "
                        "admission control (bounded in-flight queue) — "
                        "the shed-rate SLO burns on this; lost work, "
                        "never lost correctness"),
        MetricSpec("net.deadline_exceeded", "counter", unit="requests",
                   help="requests abandoned on an exhausted deadline "
                        "budget — client side (retry budget ran out "
                        "inside the per-request deadline) or server "
                        "side (dead-on-arrival envelope)"),
        MetricSpec("net.replay_cache_evictions", "counter",
                   unit="responses",
                   help="cached (session, req_id) replay responses "
                        "evicted by the byte-bounded LRU (max_bytes "
                        "cap): an evicted entry's resend is re-executed "
                        "instead of replayed — duplicate work, never a "
                        "duplicate side effect for idempotent reads"),
        MetricSpec("net.bin_responses", "counter", unit="responses",
                   help="responses answered on the zero-copy binary "
                        "framing (CAP_BIN negotiated): table rows ride "
                        "as raw scatter-gather segments straight off "
                        "the snapshot's mapped pages, never "
                        "JSON-materialized"),
        MetricSpec("net.crc_light_frames", "counter", unit="frames",
                   help="large responses sent with a header-only CRC "
                        "trailer (CAP_CRC_LIGHT negotiated AND payload "
                        "over the threshold) on loopback-trusted "
                        "sessions; default sessions keep the "
                        "full-payload CRC"),
        # Shadow serving (fps_tpu.serve.shadow): old-vs-new snapshot
        # scoring gates fleet promotion (docs/STALENESS.md).
        MetricSpec("serve.shadow_promotions", "counter", unit="snapshots",
                   help="snapshot candidates promoted by the shadow "
                        "scorer (score(new) >= score(approved) + "
                        "min_delta) — the gated fleet's fence may now "
                        "advance to them"),
        MetricSpec("serve.shadow_held", "counter", unit="snapshots",
                   help="snapshot candidates HELD by the shadow scorer "
                        "(scored worse than the approved snapshot "
                        "beyond min_delta): the fleet keeps serving the "
                        "old approved step — lost freshness, never "
                        "wrong answers"),
        # Program contract auditor (fps_tpu_torch.analysis;
        # Trainer(audit=...)).
        MetricSpec("analysis.certified_programs", "counter",
                   unit="programs",
                   help="compiled step programs certified clean against "
                        "their ProgramContract at compile time"),
        MetricSpec("analysis.contract_violations", "counter",
                   unit="violations", labels=("rule",),
                   help="static-analysis contract violations (per pass: "
                        "collective_budget / host_transfer / donation / "
                        "dtype_drift / replica_consistency) — each also "
                        "emits an analysis.contract_violation event"),
        # Runtime budget-drift detection (fps_tpu_torch.obs.drift): the live
        # data plane's measured collective traffic vs the budgets pinned
        # in AUDIT_r*.json.
        MetricSpec("analysis.budget_drift", "gauge", unit="ratio",
                   labels=("program",),
                   help="measured/pinned collective payload-byte ratio "
                        "for one observed program (1.0 = on certified "
                        "budget; NaN = unpinned/unbounded); departures "
                        "beyond tolerance also emit a budget_drift "
                        "incident event"),
    ])


class Recorder:
    """Validates samples against a registry and fans them out to sinks.

    One record shape for everything (so a single JSONL stream interleaves
    metrics and events in arrival order):

    * metric sample: ``{"kind": "metric", "t": ..., "name": ...,
      "mtype": "counter"|"gauge"|"histogram", "value": float,
      "labels": {...}}``
    * event: ``{"kind": "event", "t": ..., "event": <type>, **fields}``

    The recorder also keeps in-memory aggregates (counter sums, last
    gauge value, histogram count/sum/min/max) so tests and end-of-run
    digests don't need to re-read a sink. Thread-safe: the watchdog timer
    thread records through the same instance as the training loop.

    ``run_id`` and ``base_labels`` stamp every record — in multi-host runs
    each process opens its own recorder (and sink files), and the report
    tool joins on ``run_id``.
    """

    def __init__(self, registry: MetricsRegistry | None = None,
                 sinks: Iterable = (), *, run_id: str | None = None,
                 base_labels: Mapping[str, str] | None = None,
                 time_fn: Callable[[], float] = time.time):
        self.registry = registry or default_registry()
        self.sinks = list(sinks)
        self.run_id = run_id
        self.base = dict(base_labels or {})
        self._time = time_fn
        self._lock = threading.Lock()
        self._counters: dict[tuple, float] = {}
        self._gauges: dict[tuple, float] = {}
        self._hists: dict[tuple, dict] = {}
        self.closed = False

    # -- emission ---------------------------------------------------------

    def _key(self, name: str, labels: dict) -> tuple:
        return (name,) + tuple(sorted(labels.items()))

    def _record(self, kind: str, name: str, value: float, labels: dict):
        spec = self.registry.get(name)
        if spec.kind != kind:
            raise TypeError(
                f"metric {name!r} is a {spec.kind}, recorded as a {kind}"
            )
        unknown = set(labels) - set(spec.labels)
        if unknown:
            raise ValueError(
                f"metric {name!r}: undeclared labels {sorted(unknown)} "
                f"(declared: {list(spec.labels)})"
            )
        value = float(value)
        key = self._key(name, labels)
        with self._lock:
            if kind == "counter":
                self._counters[key] = self._counters.get(key, 0.0) + value
            elif kind == "gauge":
                self._gauges[key] = value
            else:
                h = self._hists.setdefault(
                    key, {"count": 0, "sum": 0.0, "min": None, "max": None}
                )
                h["count"] += 1
                h["sum"] += value
                h["min"] = value if h["min"] is None else min(h["min"], value)
                h["max"] = value if h["max"] is None else max(h["max"], value)
            rec = {"kind": "metric", "t": self._time(), "name": name,
                   "mtype": kind, "value": value}
            if self.run_id:
                rec["run_id"] = self.run_id
            if labels or self.base:
                rec["labels"] = {**self.base, **labels}
            for s in self.sinks:
                s.write(rec)

    def inc(self, name: str, value: float = 1.0, **labels) -> None:
        """Add to a counter (monotonic; negative increments raise)."""
        if value < 0:
            raise ValueError(f"counter {name!r}: negative increment {value}")
        self._record("counter", name, value, labels)

    def set(self, name: str, value: float, **labels) -> None:
        """Set a gauge to its current value."""
        self._record("gauge", name, value, labels)

    def observe(self, name: str, value: float, **labels) -> None:
        """Record one histogram observation."""
        self._record("histogram", name, value, labels)

    def event(self, etype: str, **fields) -> None:
        """Append a structured event (journal entries ride this)."""
        rec = {"kind": "event", "t": self._time(), "event": etype, **fields}
        if self.run_id:
            rec.setdefault("run_id", self.run_id)
        with self._lock:
            for s in self.sinks:
                s.write(rec)

    # -- aggregates -------------------------------------------------------

    def counter_value(self, name: str, **labels) -> float:
        return self._counters.get(self._key(name, labels), 0.0)

    def snapshot(self) -> dict:
        """Aggregated view: ``{"counters": {...}, "gauges": {...},
        "histograms": {...}}`` with ``name{k=v,...}`` flat keys."""
        def flat(key):
            name, *lbls = key
            if not lbls:
                return name
            return name + "{" + ",".join(f"{k}={v}" for k, v in lbls) + "}"

        with self._lock:
            return {
                "counters": {flat(k): v for k, v in self._counters.items()},
                "gauges": {flat(k): v for k, v in self._gauges.items()},
                "histograms": {flat(k): dict(v)
                               for k, v in self._hists.items()},
            }

    def phase_totals(self) -> dict[str, dict]:
        """Per-phase ``{"s": total_seconds, "n": count}`` from the
        ``driver.phase_seconds`` histogram — the bench.py breakdown."""
        out = {}
        with self._lock:
            for key, h in self._hists.items():
                if key[0] != "driver.phase_seconds":
                    continue
                labels = dict(key[1:])
                phase = labels.get("phase", "?")
                out[phase] = {"s": round(h["sum"], 6), "n": h["count"]}
        return out

    # -- lifecycle --------------------------------------------------------

    def flush(self) -> None:
        # Under the lock: every sink WRITE happens under it (via
        # _record/event), so flush — which e.g. iterates PrometheusSink's
        # aggregate dicts to render the exposition — must serialize with
        # concurrent writers (the watchdog timer thread flushes while the
        # training thread records).
        with self._lock:
            for s in self.sinks:
                s.flush()

    def close(self) -> None:
        with self._lock:
            if self.closed:
                return
            self.closed = True
            for s in self.sinks:
                s.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
