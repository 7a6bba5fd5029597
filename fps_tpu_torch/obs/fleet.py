"""Fleet telemetry: windowed rollups + SLO burn over N per-host obs dirs.

``tools/obs_report.py`` digests ONE obs directory; a pod run produces N
of them (one per member/host) plus the pod journal. This module tails
them all and folds the per-host event streams into **time-windowed
rollups** of the fleet-level signals the ROADMAP fronts need:

* throughput — examples/s from ``driver.examples`` counter increments;
* tiering hit rate — ``hot_tier.hot_rows / hot_tier.pulled_rows``;
* cold-route certification rate —
  ``cold_route.compact_chunks / (compact + overflow)`` (the
  payload-proportionality health of the data plane, incl. under SSP);
* write→servable freshness — ``serve.write_to_servable_s`` samples;
* restart / fence counts — ``pod_restart`` + ``supervisor_restart``
  events and ``checkpoint.fenced_publishes`` increments.

On top of the rollup, declarative :class:`SLO` objects evaluate each
window and report **burn rate**: the fraction of bad windows divided by
the SLO's error budget (``1 - objective``) — burn > 1 means the
objective is being missed at an unsustainable rate, the standard
multi-window burn-rate alerting form.

Everything here is **post-hoc and host-side**: rollups re-read files the
training loop already wrote, lagged by the sinks' flush cadence (one
chunk of JSONL at most) — they never add work to, let alone block, the
hot path (see the telemetry-lag row in ``docs/STALENESS.md``).

Stdlib-only, zero package imports. Port of ``fps_tpu/obs/fleet.py``: the
same series, windows, SLOs and burn rates over the same files, so either
package's rollup reads either package's obs dirs, and the per-tenant
rollups (``tenant_fleet_digest`` over the tenancy layout) either
package's tenants root.
"""

from __future__ import annotations

import dataclasses
import glob
import json
import math
import os

__all__ = [
    "SLO", "DEFAULT_SLOS", "host_series", "rollup", "evaluate_slos",
    "fleet_digest", "FLEET_SCHEMA_VERSION",
    "TENANTS_DIRNAME", "discover_tenants", "apply_slo_overrides",
    "tenant_fleet_digest",
]

FLEET_SCHEMA_VERSION = 1

# Counter names folded into per-window sums (each JSONL metric record
# carries the INCREMENT, so a window's value is the sum of its samples).
_WINDOW_COUNTERS = (
    "driver.examples",
    "driver.chunks",
    "driver.steps",
    "hot_tier.hot_rows",
    "hot_tier.pulled_rows",
    "cold_route.compact_chunks",
    "cold_route.overflow_chunks",
    "checkpoint.fenced_publishes",
    "checkpoint.saves",
    # Hostile-filesystem degradation (fps_tpu.core.retry + the async
    # writer's degraded mode): skipped publishes spend the storage-
    # staleness budget; degraded read-plane polls count liveness cost.
    "storage.degraded_publishes",
    "storage.poll_errors",
    # Hostile-network survival (fps_tpu.serve.wire / serve.net): shed
    # requests burn the shed-rate SLO; retries/torn frames quantify how
    # hard the wire is fighting back.
    "net.shed_requests",
    "net.retries",
    "net.torn_frames",
    "serve.requests",
)
# Gauge/sample names kept as (t, value) series for per-window max/last.
# serve.fence_step feeds the fleet fence-lag rollup: the fence's last
# published step per window, compared against the newest
# checkpoint_saved step the trainers reported by then.
# serve.reader_heartbeat_age_s feeds the heartbeat-staleness SLO: worst
# beacon age per window across readers.
_WINDOW_SAMPLES = ("serve.write_to_servable_s", "serve.fence_step",
                   "serve.reader_heartbeat_age_s")
# Journal events counted per window.
_WINDOW_EVENTS = ("pod_restart", "supervisor_restart", "budget_drift",
                  "checkpoint_fenced", "checkpoint_degraded",
                  "reader_wedged")


def _read_jsonl(path):
    try:
        with open(path, encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except json.JSONDecodeError:
                    return  # torn tail: everything before it is valid
    except OSError:
        return


def host_series(obs_dir: str) -> dict:
    """One host's raw time series from an obs/state directory:
    ``{"counters": {name: [(t, inc), ...]}, "samples": {name: [...]},
    "events": {name: [t, ...]}}`` — the minimal input :func:`rollup`
    windows over. Reads ``events-p*.jsonl`` for metrics and every
    ``journal-*.jsonl`` for events (incident events are deduped on
    content across the two sources, like ``tools/obs_report.py``)."""
    counters = {n: [] for n in _WINDOW_COUNTERS}
    samples = {n: [] for n in _WINDOW_SAMPLES}
    events = {n: [] for n in _WINDOW_EVENTS}
    published = []  # (t, step) from checkpoint_saved — fence-lag ref
    seen_events = set()
    for path in sorted(glob.glob(os.path.join(obs_dir, "events-p*.jsonl"))):
        for rec in _read_jsonl(path):
            kind = rec.get("kind")
            if kind == "metric":
                name = rec.get("name")
                t = rec.get("t")
                raw = rec.get("value")
                v = math.nan if raw is None else float(raw)
                if name in counters and t is not None:
                    counters[name].append((float(t), v))
                elif name in samples and t is not None:
                    samples[name].append((float(t), v))
            elif kind == "event":
                _fold_event(rec, events, seen_events, published)
    for path in sorted(glob.glob(os.path.join(obs_dir,
                                              "journal-*.jsonl"))):
        for rec in _read_jsonl(path):
            if rec.get("kind") == "event":
                _fold_event(rec, events, seen_events, published)
    return {"counters": counters, "samples": samples, "events": events,
            "published": published}


def _fold_event(rec, events, seen, published=None) -> None:
    et = rec.get("event")
    capture_pub = (published is not None and et == "checkpoint_saved"
                   and rec.get("t") is not None
                   and rec.get("step") is not None)
    if et not in events and not capture_pub:
        return
    key = json.dumps(rec, sort_keys=True, default=str)
    if key in seen:
        return
    seen.add(key)
    if rec.get("t") is None:
        return
    if capture_pub:
        try:
            published.append((float(rec["t"]), int(rec["step"])))
        except (TypeError, ValueError):
            pass
    if et in events:
        events[et].append(float(rec["t"]))


def _ratio(num, den, digits=4):
    return round(num / den, digits) if den else None


def _window_stats(series_by_host, t0, t1) -> dict:
    """Fold every host's series into one window's rollup row."""
    c = {n: 0.0 for n in _WINDOW_COUNTERS}
    ev = {n: 0 for n in _WINDOW_EVENTS}
    fresh = []
    fence_lag = None
    hb_age_max = None
    # The fence-lag reference: newest step ANY trainer durably
    # published by the end of this window (fence readers lag it by
    # design; the SLO bounds by how much).
    newest_pub = max((s for series in series_by_host.values()
                      for t, s in series.get("published", ())
                      if t < t1), default=None)
    for series in series_by_host.values():
        for name, pts in series["counters"].items():
            c[name] += sum(v for t, v in pts
                           if t0 <= t < t1 and math.isfinite(v))
        for t, v in series["samples"]["serve.write_to_servable_s"]:
            if t0 <= t < t1 and math.isfinite(v):
                fresh.append(v)
        # serve.fence_step lag vs the newest published step: per host,
        # the LAST fence sample in the window; fold as the worst lag
        # across hosts (one straggling reader burns the SLO).
        fence_last = None
        for t, v in series["samples"]["serve.fence_step"]:
            if t0 <= t < t1 and math.isfinite(v):
                fence_last = v  # samples arrive in time order
        if fence_last is not None and newest_pub is not None:
            lag = max(0.0, float(newest_pub) - float(fence_last))
            fence_lag = lag if fence_lag is None else max(fence_lag, lag)
        # Heartbeat staleness: worst beacon age seen in the window
        # across every reader on every host — one wedged reader burns
        # the SLO.
        for t, v in series["samples"]["serve.reader_heartbeat_age_s"]:
            if t0 <= t < t1 and math.isfinite(v):
                hb_age_max = (v if hb_age_max is None
                              else max(hb_age_max, v))
        for name, ts in series["events"].items():
            ev[name] += sum(1 for t in ts if t0 <= t < t1)
    dt = max(t1 - t0, 1e-9)
    compact = c["cold_route.compact_chunks"]
    overflow = c["cold_route.overflow_chunks"]
    return {
        "t0": round(t0, 3),
        "t1": round(t1, 3),
        "examples": c["driver.examples"],
        "chunks": int(c["driver.chunks"]),
        "examples_per_sec": round(c["driver.examples"] / dt, 1),
        "hot_hit_rate": _ratio(c["hot_tier.hot_rows"],
                               c["hot_tier.pulled_rows"]),
        "cold_route_cert_rate": _ratio(compact, compact + overflow),
        "freshness_s_max": round(max(fresh), 4) if fresh else None,
        "restarts": ev["pod_restart"] + ev["supervisor_restart"],
        # The counter and the journal event fire together; max() keeps a
        # dir holding both sources from double-counting (the
        # obs_report.py rule).
        "fenced_publishes": max(int(c["checkpoint.fenced_publishes"]),
                                ev["checkpoint_fenced"]),
        "budget_drift_incidents": ev["budget_drift"],
        "checkpoint_saves": int(c["checkpoint.saves"]),
        # Hostile-filesystem degradation (same max() dedup rule as the
        # fence counter: event and counter fire together).
        "degraded_publishes": max(
            int(c["storage.degraded_publishes"]),
            ev["checkpoint_degraded"]),
        "storage_poll_errors": int(c["storage.poll_errors"]),
        "fence_lag_steps": (round(fence_lag, 1)
                            if fence_lag is not None else None),
        # Hostile-network survival: shed RATE is sheds over sheds +
        # served (None when the wire moved no traffic in the window —
        # neither good nor bad for the SLO).
        "net_shed_requests": int(c["net.shed_requests"]),
        "net_retries": int(c["net.retries"]),
        "net_torn_frames": int(c["net.torn_frames"]),
        "net_shed_rate": _ratio(
            c["net.shed_requests"],
            c["net.shed_requests"] + c["serve.requests"]),
        "reader_heartbeat_age_s_max": (
            round(hb_age_max, 3) if hb_age_max is not None else None),
        "reader_wedged_incidents": ev["reader_wedged"],
    }


def rollup(dirs, *, window_s: float | None = None,
           num_windows: int = 6) -> dict:
    """Windowed fleet rollup over N obs/state dirs. ``window_s`` fixes
    the window width (default: the observed span divided into
    ``num_windows``). Returns ``{"hosts", "window_s", "windows",
    "totals"}`` — ``totals`` is the single whole-span window."""
    series_by_host = {}
    for d in dirs:
        name = os.path.basename(os.path.normpath(d)) or d
        # Two dirs with one basename (rare) must not silently merge.
        key = name if name not in series_by_host else d
        series_by_host[key] = host_series(d)
    ts = [t
          for s in series_by_host.values()
          for group in ("counters", "samples")
          for pts in s[group].values()
          for t, _ in pts] + [t for s in series_by_host.values()
                              for tl in s["events"].values()
                              for t in tl]
    if not ts:
        return {"hosts": sorted(series_by_host), "window_s": None,
                "windows": [], "totals": None}
    t_min, t_max = min(ts), max(ts)
    span = max(t_max - t_min, 1e-9)
    w = float(window_s) if window_s else span / max(num_windows, 1)
    # Half-open windows need the final edge strictly PAST t_max; a
    # fixed +1e-9 vanishes below float epsilon at unix-epoch magnitudes
    # (~1.8e9), silently dropping the newest sample — nextafter is the
    # smallest representable bump at any magnitude.
    t_end = math.nextafter(t_max, math.inf)
    windows = []
    t0 = t_min
    while t0 < t_max or not windows:
        t1 = t0 + w
        windows.append(_window_stats(
            series_by_host, t0, t1 if t1 < t_max else t_end))
        t0 = t1
    return {
        "hosts": sorted(series_by_host),
        "window_s": round(w, 3),
        "windows": windows,
        "totals": _window_stats(series_by_host, t_min, t_end),
    }


@dataclasses.dataclass(frozen=True)
class SLO:
    """One declarative service-level objective over rollup windows.

    A window is GOOD when ``field`` compares to ``target`` under ``op``
    (windows where the field is None — no samples — are skipped, they
    are neither good nor bad). ``objective`` is the required good
    fraction; the **burn rate** is ``bad_fraction / (1 - objective)`` —
    burn > 1 means the error budget is being spent faster than the
    objective tolerates."""

    name: str
    field: str
    op: str  # ">=" or "<="
    target: float
    objective: float = 0.9
    description: str = ""

    def __post_init__(self):
        if self.op not in (">=", "<="):
            raise ValueError(f"SLO {self.name!r}: op must be '>=' or "
                             f"'<=', got {self.op!r}")
        if not 0.0 < self.objective < 1.0:
            raise ValueError(f"SLO {self.name!r}: objective must be in "
                             f"(0, 1), got {self.objective}")

    def good(self, value) -> bool | None:
        if value is None:
            return None
        v = float(value)
        return v >= self.target if self.op == ">=" else v <= self.target


DEFAULT_SLOS = (
    SLO("cold_route_certification", "cold_route_cert_rate", ">=", 0.9,
        objective=0.75,
        description="share of chunks the compacted cold route certified "
                    "(payload-proportional routing healthy)"),
    SLO("write_to_servable_freshness", "freshness_s_max", "<=", 60.0,
        objective=0.9,
        description="worst write->servable lag per window (the serving "
                    "freshness SLO, docs/serving.md)"),
    SLO("restart_quiet", "restarts", "<=", 0.0, objective=0.75,
        description="windows free of coordinated/supervised restarts"),
    SLO("budget_drift_quiet", "budget_drift_incidents", "<=", 0.0,
        objective=0.9,
        description="windows free of measured-vs-certified collective "
                    "budget drift incidents (fps_tpu_torch.obs.drift)"),
    # Hostile-filesystem survival (docs/resilience.md, docs/STALENESS.md
    # storage row): degraded publishes are the storage-STALENESS budget —
    # each one is recency deliberately spent to keep training alive
    # through a brownout, never corruption; sustained burn means the
    # filesystem (not the framework) needs attention.
    SLO("storage_staleness_budget", "degraded_publishes", "<=", 0.0,
        objective=0.75,
        description="windows free of degraded (skipped) checkpoint "
                    "publishes — burn = the shared filesystem is "
                    "costing snapshot recency"),
    # Fleet fence lag vs the newest published step: the fence trails
    # the trainer by verification + quorum; the
    # SLO bounds how far before the serving plane counts as stale.
    SLO("serve_fence_lag", "fence_lag_steps", "<=", 8.0, objective=0.75,
        description="fleet fence (serve.fence_step) within budget of "
                    "the newest checkpoint_saved step"),
    # Hostile-network survival (docs/resilience.md "Hostile network"):
    # shedding is the wire's staleness-budget twin — lost WORK spent
    # deliberately to bound latency, never lost correctness; sustained
    # burn means capacity (not the framework) needs attention.
    SLO("net_shed_rate", "net_shed_rate", "<=", 0.05, objective=0.75,
        description="share of wire requests shed with BUSY by "
                    "admission control (load lost to keep the serving "
                    "plane bounded)"),
    # A beacon older than the liveness timeout in any window means a
    # reader sat wedged (SIGSTOP, deadlock, partition) — the incident
    # the supervisor must act on, never a silent 0 q/s (BENCH_r14).
    SLO("reader_heartbeat_fresh", "reader_heartbeat_age_s_max", "<=",
        5.0, objective=0.75,
        description="worst fleet-reader liveness-beacon age per window "
                    "within the reader_wedged timeout"),
)


def evaluate_slos(roll: dict, slos=DEFAULT_SLOS) -> dict:
    """Per-SLO verdicts over a :func:`rollup` result: evaluated window
    count, bad windows, bad fraction, burn rate, and ok (burn <= 1)."""
    out = {}
    for slo in slos:
        verdicts = [slo.good(w.get(slo.field)) for w in roll["windows"]]
        evaluated = [v for v in verdicts if v is not None]
        bad = sum(1 for v in evaluated if not v)
        frac = bad / len(evaluated) if evaluated else 0.0
        burn = frac / max(1.0 - slo.objective, 1e-9)
        out[slo.name] = {
            "field": slo.field,
            "op": slo.op,
            "target": slo.target,
            "objective": slo.objective,
            "windows_evaluated": len(evaluated),
            "bad_windows": bad,
            "bad_fraction": round(frac, 4),
            "burn_rate": round(burn, 4),
            "ok": burn <= 1.0,
        }
    return out


def fleet_digest(dirs, *, window_s: float | None = None,
                 num_windows: int = 6, slos=DEFAULT_SLOS,
                 digest_fn=None) -> dict:
    """The ``obs_report --fleet`` payload: rollup + SLO burn (+ each
    host's standard single-dir digest when the caller passes its
    ``render_digest`` as ``digest_fn`` — kept injectable so this module
    stays import-free of the tools)."""
    roll = rollup(dirs, window_s=window_s, num_windows=num_windows)
    out = {
        "schema": FLEET_SCHEMA_VERSION,
        "dirs": [os.path.abspath(d) for d in dirs],
        "rollup": roll,
        "slo": evaluate_slos(roll, slos),
    }
    if digest_fn is not None:
        hosts = {}
        for d in dirs:
            name = os.path.basename(os.path.normpath(d)) or d
            # Same collision rule as rollup(): two dirs sharing one
            # basename must not silently merge into one entry.
            key = name if name not in hosts else d
            try:
                hosts[key] = digest_fn(d)
            except FileNotFoundError:
                hosts[key] = None  # a member dir with no obs files yet
        out["host_digests"] = hosts
    return out


# ---------------------------------------------------------------------------
# Multi-tenant pods (fps_tpu_torch.tenancy): per-tenant rollups + SLO burn.
#
# These constants MIRROR fps_tpu_torch/tenancy/paths.py: this module is
# stdlib-only and loads by file path without torch, so it cannot import
# the package (tests/test_torch_tenancy.py pins the mirror).
TENANTS_DIRNAME = "tenants"
TENANT_MANIFEST_FILENAME = "tenant.json"
TENANT_OBS_DIRNAME = "obs"
TENANT_STATE_DIRNAME = "state"
# Mirrors fps_tpu_torch/supervise/supervisor.py JOURNAL_FILENAME.
SUPERVISOR_JOURNAL_FILENAME = "journal-supervisor.jsonl"


def discover_tenants(root: str) -> dict:
    """``{name: {"dir", "obs_dir", "state_dir", "manifest"}}`` for every
    ``<root>/tenants/<name>/`` carrying a ``tenant.json`` manifest (the
    :class:`fps_tpu_torch.tenancy.TenantManager` layout). An unreadable or
    torn manifest degrades to ``{}`` — the tenant still reports."""
    out = {}
    base = os.path.join(root, TENANTS_DIRNAME)
    try:
        names = sorted(os.listdir(base))
    except OSError:
        return out
    for name in names:
        tdir = os.path.join(base, name)
        mpath = os.path.join(tdir, TENANT_MANIFEST_FILENAME)
        if not os.path.isfile(mpath):
            continue
        try:
            with open(mpath, encoding="utf-8") as f:
                manifest = json.load(f)
        except (OSError, ValueError):
            manifest = {}
        out[name] = {
            "dir": tdir,
            "obs_dir": os.path.join(tdir, TENANT_OBS_DIRNAME),
            "state_dir": os.path.join(tdir, TENANT_STATE_DIRNAME),
            "manifest": manifest if isinstance(manifest, dict) else {},
        }
    return out


def apply_slo_overrides(slos, overrides) -> tuple:
    """Per-tenant SLO overrides (``TenantSpec.slo`` via the tenant.json
    manifest): ``{slo_name: {"target": x, "objective": y}}`` replaces
    just those knobs on the matching default SLO. Unknown SLO names and
    non-dict values are ignored — a manifest written by a newer spec
    must not break an older report."""
    if not overrides or not isinstance(overrides, dict):
        return tuple(slos)
    out = []
    for slo in slos:
        ov = overrides.get(slo.name)
        if isinstance(ov, dict):
            try:
                kw = {k: float(ov[k]) for k in ("target", "objective")
                      if k in ov}
                if kw:
                    slo = dataclasses.replace(slo, **kw)
            except (TypeError, ValueError):
                pass  # malformed override: keep the default knobs
        out.append(slo)
    return tuple(out)


def _load_supervisor():
    """``fps_tpu_torch/supervise/supervisor.py`` for :func:`recovery_times`,
    by file path when the package is not already imported (the rule by
    which a torch-free reader loads THIS file)."""
    import importlib.util
    import sys as _sys

    for name in ("fps_tpu_torch.supervise.supervisor",
                 "_fps_torch_supervisor_fleet"):
        mod = _sys.modules.get(name)
        if mod is not None:
            return mod
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        os.pardir, "supervise", "supervisor.py")
    spec = importlib.util.spec_from_file_location(
        "_fps_torch_supervisor_fleet", path)
    mod = importlib.util.module_from_spec(spec)
    _sys.modules[spec.name] = mod  # dataclasses resolve via sys.modules
    spec.loader.exec_module(mod)
    return mod


def tenant_fleet_digest(root: str, *, window_s: float | None = None,
                        num_windows: int = 6, slos=DEFAULT_SLOS) -> dict:
    """Per-tenant rollup + SLO burn over ``<root>/tenants/<name>/``.

    Blast-radius isolation extends to telemetry: each tenant's obs +
    supervisor-state dirs fold into its OWN rollup and its OWN burn
    rates (with manifest SLO overrides applied), so one tenant's
    incidents never burn a neighbor's error budget. The supervisor
    journal's recovery times (attempt kill -> first post-restart
    dispatch) ride along as the tenant's MTTR evidence."""
    out = {"schema": FLEET_SCHEMA_VERSION,
           "root": os.path.abspath(root), "tenants": {}}
    sup = None
    for name, info in discover_tenants(root).items():
        roll = rollup([info["obs_dir"], info["state_dir"]],
                      window_s=window_s, num_windows=num_windows)
        manifest = info["manifest"]
        t_slos = apply_slo_overrides(slos, manifest.get("slo"))
        journal = os.path.join(info["state_dir"],
                               SUPERVISOR_JOURNAL_FILENAME)
        times = []
        if os.path.isfile(journal):
            if sup is None:
                sup = _load_supervisor()
            times = sup.recovery_times(journal)
        try:
            weight = float(manifest.get("weight", 1.0))
        except (TypeError, ValueError):
            weight = 1.0
        out["tenants"][name] = {
            "weight": weight,
            "slo_overrides": sorted(manifest.get("slo") or ())
                             if isinstance(manifest.get("slo"), dict)
                             else [],
            "rollup": roll,
            "slo": evaluate_slos(roll, t_slos),
            "recovery": {
                "count": len(times),
                "times_s": times,
                "mean_s": (round(sum(times) / len(times), 3)
                           if times else None),
                "max_s": round(max(times), 3) if times else None,
            },
        }
    return out
