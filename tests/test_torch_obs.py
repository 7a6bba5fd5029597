"""Telemetry of the port (``fps_tpu_torch.obs``) against the JAX package's
``fps_tpu.obs``: the same emissions through both give the same records,
text, aggregates and decisions.

The oracles are ``tests/test_obs.py`` and ``tests/test_trace.py``: the
default registry equals the reference's spec for spec; the same samples
and events through both packages' ``Recorder`` with a ``JsonlSink``, a
``PrometheusSink`` and a ``MemorySink`` give the same JSONL records
(timestamps masked), the same exposition text and the same aggregates;
non-finite values come out as strict JSON; ``PhaseTimer``,
``Throughput``, ``HealthMonitor``'s decisions over one sequence and
``StepWatchdog``'s stall and recovery equal the reference's;
``config_digest``, the trace ids' form, their env round trip (the same
variable names) and ``open_run``'s files and installed default match.

The port's own: ``obs.trace`` writes a Chrome trace that names the
step's ``fps.pull`` / ``fps.push`` ranges, the step opens no range
without a profiler, ``Trainer(audit=)`` waits for the program auditor,
no obs module imports torch at module level, and every metric name the
port emits is registered (the port's copy of
``test_every_emitted_metric_name_is_registered``).
"""

from __future__ import annotations

import ast
import json
import logging
import os
import re
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fps_tpu import obs as jobs
from fps_tpu.obs import events as jevents
from fps_tpu.obs import trace as jtrace

from fps_tpu_torch import MFConfig, make_ps_mesh, obs as tobs, online_mf
from fps_tpu_torch.obs import events as tevents
from fps_tpu_torch.obs import sinks as tsinks
from fps_tpu_torch.obs.trace import (
    PARENT_SPAN_ENV,
    TRACE_ID_ENV,
    TraceContext,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"jax": jobs, "port": tobs}
MF_KW = dict(num_users=40, num_items=30, rank=4, learning_rate=0.08)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _clock():
    """A deterministic ``time_fn``: 1000.0, 1000.5, 1001.0, ..."""
    t = [999.5]

    def now():
        t[0] += 0.5
        return t[0]

    return now


def _emit_all(rec):
    """One fixed sequence of samples and events, every kind and label."""
    rec.inc("driver.chunks")
    rec.inc("driver.examples", 4096.0)
    rec.inc("health.nonfinite_rows", 4, table="weights")
    rec.inc("health.nonfinite_rows", 0, table="item_factors")
    rec.set("checkpoint.bytes", 1024)
    rec.set("prefetch.queue_depth", 2.0)
    rec.set("serve.snapshot_lag_steps", float("nan"))
    for v in (0.25, 0.5, 0.125):
        rec.observe("driver.phase_seconds", v, phase="dispatch")
    rec.observe("driver.phase_seconds", 0.75, phase="host_sync")
    rec.event("chunk", index=0, phases={"dispatch": 0.25}, examples=4096.0)
    rec.event("guard_escalated", index=1, what="chunk", poison_rows=7)
    rec.event("weird", value=np.float32(1.5), arr=np.arange(3),
              bad=float("inf"))


# ---------------------------------------------------------------------------
# Registry and recorder.
# ---------------------------------------------------------------------------

def test_default_registry_equals_the_reference_spec_for_spec():
    want = jobs.default_registry().specs
    got = tobs.default_registry().specs
    assert list(got) == list(want)
    for name in want:
        w, g = want[name], got[name]
        assert (g.name, g.kind, g.unit, g.labels, g.help) == (
            w.name, w.kind, w.unit, w.labels, w.help), name
    assert tobs.DRIVER_PHASES == jobs.DRIVER_PHASES


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_metric_spec_validation(pkg):
    obs = PKGS[pkg]
    with pytest.raises(ValueError, match="kind"):
        obs.MetricSpec("x", "timer")
    with pytest.raises(ValueError, match="name"):
        obs.MetricSpec("a b", "counter")
    reg = obs.MetricsRegistry([obs.MetricSpec("x", "counter")])
    reg.register(obs.MetricSpec("x", "counter"))  # same spec: idempotent
    with pytest.raises(ValueError, match="already registered"):
        reg.register(obs.MetricSpec("x", "gauge"))
    with pytest.raises(KeyError, match="unregistered"):
        reg.get("nope")


def test_recorder_typed_leaves_and_aggregates_match():
    def run(obs):
        reg = obs.MetricsRegistry([
            obs.MetricSpec("c", "counter", labels=("table",)),
            obs.MetricSpec("g", "gauge"),
            obs.MetricSpec("h", "histogram"),
        ])
        sink = obs.MemorySink()
        rec = obs.Recorder(reg, sinks=[sink], run_id="r1", time_fn=_clock())
        rec.inc("c", 2, table="a")
        rec.inc("c", 3, table="a")
        rec.inc("c", 1, table="b")
        rec.set("g", 7.5)
        for v in (0.1, 0.3):
            rec.observe("h", v)
        errors = []
        for fn, kw, exc in ((rec.set, dict(table="a"), TypeError),
                            (rec.inc, {}, KeyError),
                            (rec.inc, dict(shard="a"), ValueError)):
            with pytest.raises(exc) as e:
                fn("unknown" if exc is KeyError else "c", 1, **kw)
            errors.append(str(e.value))
        with pytest.raises(ValueError, match="negative"):
            rec.inc("c", -1, table="a")
        return rec.snapshot(), list(sink.records), errors

    assert run(tobs) == run(jobs)
    snap, records, _ = run(tobs)
    assert snap["counters"]["c{table=a}"] == 5
    assert len(records) == 6 and all(r["run_id"] == "r1" for r in records)


def test_sinks_give_the_reference_records_and_text(tmp_path):
    """The same emissions through both packages' recorders: the same JSONL
    lines (timestamps masked), the same Prometheus text, the same memory
    records and aggregates."""
    out = {}
    for pkg, obs in PKGS.items():
        d = tmp_path / pkg
        mem = obs.MemorySink()
        rec = obs.Recorder(
            sinks=[obs.JsonlSink(str(d / "ev.jsonl")),
                   obs.PrometheusSink(str(d / "m.prom")), mem],
            run_id="run", base_labels={"process": "0"}, time_fn=_clock())
        _emit_all(rec)
        rec.close()
        lines = [json.loads(ln) for ln in open(d / "ev.jsonl")]
        out[pkg] = (lines, open(d / "m.prom").read(),
                    json.dumps(list(mem.records), default=repr),
                    json.dumps(rec.snapshot()), rec.phase_totals())
    assert out["port"] == out["jax"]
    lines, text = out["port"][:2]
    assert "NaN" not in json.dumps(lines) and "Infinity" not in text
    assert 'fps_tpu_health_nonfinite_rows{process="0",table="weights"} 4' \
        in text
    assert out["port"][4]["dispatch"] == {"s": 0.875, "n": 3}


def test_jsonl_sink_nonfinite_is_strict_json(tmp_path):
    path = str(tmp_path / "ev.jsonl")
    sink = tobs.JsonlSink(path, flush_every=1)
    sink.write({"kind": "metric", "name": "serve.snapshot_lag_steps",
                "mtype": "gauge", "value": float("nan")})
    sink.write({"kind": "metric", "name": "g", "mtype": "gauge",
                "value": np.float32("inf")})
    sink.write({"kind": "metric", "name": "t", "value": torch.tensor(2.5)})
    sink.write({"kind": "metric", "name": "ok", "value": 2.0})
    sink.close()
    raw = open(path).read()
    assert "NaN" not in raw and "Infinity" not in raw
    lines = [json.loads(ln) for ln in raw.splitlines()]
    assert lines[0]["value"] is None and lines[1]["value"] is None
    assert lines[2]["value"] == 2.5 and lines[3]["value"] == 2.0


@pytest.mark.parametrize("value", [
    float("nan"), [1.0, float("-inf"), {"a": float("inf")}],
    np.array([1.0, np.nan]), np.float32(3.0), ("x", 2), {"k": [np.inf]},
], ids=["nan", "nested", "array", "np_scalar", "tuple", "dict"])
def test_scrub_nonfinite_matches(value):
    from fps_tpu.obs.sinks import scrub_nonfinite as jscrub

    assert json.dumps(tsinks.scrub_nonfinite(value)) == json.dumps(
        jscrub(value))


def test_a_file_error_is_latched_and_logged_once(tmp_path, caplog):
    """A sink whose file fails drops its telemetry after one log line and
    never raises into the caller (training)."""
    sink = tobs.JsonlSink(str(tmp_path / "ev.jsonl"), flush_every=1)
    sink._f.close()  # every later write fails
    with caplog.at_level(logging.WARNING, logger="fps_tpu_torch.obs"):
        rec = tobs.Recorder(sinks=[sink])
        for _ in range(3):
            rec.inc("driver.chunks")
            rec.event("chunk", index=0)
        rec.flush()
        rec.close()
    assert caplog.text.count("dropping telemetry") == 1
    assert rec.counter_value("driver.chunks") == 3


def test_memory_sink_ring_bound():
    sink = tobs.MemorySink(capacity=3)
    for i in range(10):
        sink.write({"kind": "event", "event": "e", "i": i})
    assert [r["i"] for r in sink.records] == [7, 8, 9]
    with pytest.raises(ValueError):
        tobs.MemorySink(capacity=0)


# ---------------------------------------------------------------------------
# Timers, throughput, health, watchdog.
# ---------------------------------------------------------------------------

def test_phase_timer_matches_the_reference():
    def run(obs):
        rec = obs.Recorder(sinks=[], time_fn=_clock())
        t = obs.PhaseTimer(rec)
        for name, s in (("dispatch", 0.5), ("dispatch", 0.25),
                        ("host_sync", 0.125), ("prefetch", 1.0)):
            t.add(name, s)
        first = t.chunk_summary()
        with t.phase("callback"):
            pass
        peek = t.chunk_summary(reset=False)
        return first, sorted(peek), sorted(t.chunk_summary()), \
            t.chunk_summary(), rec.phase_totals()

    got, want = run(tobs), run(jobs)
    assert got[0] == want[0] == {"dispatch": 0.75, "host_sync": 0.125,
                                 "prefetch": 1.0}
    assert got[1:4] == want[1:4] == (["callback"], ["callback"], {})
    assert {k: v["n"] for k, v in got[4].items()} == {
        k: v["n"] for k, v in want[4].items()}


def test_phase_timer_takes_a_worker_threads_segments():
    t = tobs.PhaseTimer()
    threads = [threading.Thread(target=lambda: [t.add("prefetch", 0.5)
                                                for _ in range(100)])
               for _ in range(4)]
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    assert t.chunk_summary() == {"prefetch": 200.0}


def test_throughput_matches_the_reference(monkeypatch):
    def run(obs):
        clock = iter([10.0, 12.0, 13.0, 13.5])
        monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
        tp = obs.Throughput()  # constructed at 10.0
        tp(0, {"n": np.array([100.0, 100.0])})
        tp(1, {"n": np.array([50.0])})
        tp(2, {"other": 1})
        return tp.summary(), tp.first_s, tp.examples_per_sec

    want = run(jobs)
    assert run(tobs) == want
    assert want[0]["chunks"] == 3 and want[1] == 2.0


@pytest.mark.parametrize("kw,seq", [
    (dict(escalate_after_rows=5), [0, 3, 0, 2, 9]),
    (dict(abort_after_chunks=2), [0, 1, 0, 4]),
    (dict(escalate_after_rows=1, abort_after_chunks=3), [2, 0, 1, 1]),
    (dict(), [5, 5]),
], ids=["escalate", "abort", "both", "off"])
def test_health_monitor_decisions_match(kw, seq):
    def run(obs):
        m = obs.HealthMonitor(**kw)
        decisions = [m.update(i, rows) for i, rows in enumerate(seq)]
        return (decisions, m.poison_rows, m.poisoned_chunks, m.escalated_at,
                m.aborted_at, m.log)

    assert run(tobs) == run(jobs)
    with pytest.raises(ValueError):
        tobs.HealthMonitor(escalate_after_rows=0)


def _watch_run(obs, sleep_s, *, raise_in_body=False):
    sink = obs.MemorySink()
    rec = obs.Recorder(sinks=[sink])
    seen = []
    wd = obs.StepWatchdog(0.05, on_stall=seen.append, recorder=rec)
    try:
        with wd.watch("chunk", 3):
            time.sleep(sleep_s)
            if raise_in_body:
                raise RuntimeError("died")
    except RuntimeError:
        pass
    return ([e["event"] for e in sink.events()],
            rec.counter_value("watchdog.stalls"),
            [{k: v for k, v in s.items() if k != "elapsed_s"}
             for s in wd.stalls], seen)


@pytest.mark.parametrize("case", ["clean", "stall", "stall_then_raise"])
def test_step_watchdog_stall_and_recovery_match(case):
    sleep_s = 0.0 if case == "clean" else 0.3
    raise_in_body = case == "stall_then_raise"
    got = _watch_run(tobs, sleep_s, raise_in_body=raise_in_body)
    assert got == _watch_run(jobs, sleep_s, raise_in_body=raise_in_body)
    if case == "stall":
        assert got[0] == ["stall", "stall_recovered"] and got[1] == 1
        assert got[3] == [{"what": "chunk", "index": 3, "deadline_s": 0.05}]
    elif case == "stall_then_raise":
        assert got[0] == ["stall"]  # a region that died did not recover
    else:
        assert got == ([], 0.0, [], [])


def test_watchdog_callback_exception_swallowed():
    def boom(info):
        raise RuntimeError("callback bug")

    wd = tobs.StepWatchdog(0.05, on_stall=boom)
    with wd.watch("epoch", 0):
        time.sleep(0.2)
    assert len(wd.stalls) == 1 and wd.stalls[0]["elapsed_s"] >= 0.05
    with pytest.raises(ValueError):
        tobs.StepWatchdog(0)


# ---------------------------------------------------------------------------
# Journal, ids, files.
# ---------------------------------------------------------------------------

def test_run_journal_keeps_events_only_as_the_reference(tmp_path):
    out = {}
    for pkg, obs in PKGS.items():
        path = str(tmp_path / f"{pkg}.jsonl")
        j = obs.RunJournal(path, run_id="r", meta={"process": 0})
        rec = obs.Recorder(sinks=[j], run_id="r", time_fn=_clock())
        _emit_all(rec)
        rec.close()
        j.close()  # idempotent
        out[pkg] = [{k: v for k, v in json.loads(ln).items()
                     if k not in ("t", "pid")} for ln in open(path)]
    assert out["port"] == out["jax"]
    kinds = [r["event"] for r in out["port"]]
    assert kinds == ["run_start", "chunk", "guard_escalated", "weird",
                     "run_end"]


@pytest.mark.parametrize("config", [
    {"lr": 0.1, "rank": 10}, {"b": [1, 2], "a": {"x": None}},
    {"arr": np.arange(3), "f": np.float32(0.5)}, None, "plain",
], ids=["flat", "nested", "numpy", "none", "str"])
def test_config_digest_matches_the_reference(config):
    assert tobs.config_digest(config) == jobs.config_digest(config)
    assert len(tobs.config_digest(config)) == 16


def test_config_digest_stable_and_discriminating():
    a = tobs.config_digest({"lr": 0.1, "rank": 10})
    assert a == tobs.config_digest({"rank": 10, "lr": 0.1})
    assert a != tobs.config_digest({"lr": 0.2, "rank": 10})


def test_run_ids_and_trace_ids_have_the_reference_form():
    for mod in (tobs, jobs):
        assert re.fullmatch(r"\d{8}-\d{6}-[0-9a-f]{8}", mod.new_run_id())
    assert re.fullmatch(r"[0-9a-f]{32}", tobs.new_trace_id())
    assert len(tobs.new_span_id()) == len(jobs.new_span_id())
    assert tobs.new_trace_id() != tobs.new_trace_id()
    assert (TRACE_ID_ENV, PARENT_SPAN_ENV) == (
        jtrace.TRACE_ID_ENV, jtrace.PARENT_SPAN_ENV)


def test_trace_context_env_round_trip_across_packages(monkeypatch):
    """A context handed on by one package's ``child_env`` is read by the
    other's ``from_env``: a supervisor of either links the other's runs."""
    for w, r in ((TraceContext, jtrace.TraceContext),
                 (jtrace.TraceContext, TraceContext)):
        ctx = w(trace_id=tobs.new_trace_id(), parent_id=tobs.new_span_id())
        env = ctx.child_env(parent_id="c" * 16)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        got = r.from_env()
        assert (got.trace_id, got.parent_id) == (ctx.trace_id, "c" * 16)
        assert got.active and r.from_env(environ=env) == got
    monkeypatch.delenv(TRACE_ID_ENV)
    monkeypatch.delenv(PARENT_SPAN_ENV)
    assert not TraceContext.from_env().active


def test_tracer_span_records_match():
    out = {}
    for pkg, obs in PKGS.items():
        sink = obs.MemorySink()
        rec = obs.Recorder(sinks=[sink], time_fn=_clock())
        tr = obs.Tracer(rec, trace_id="t" * 32, parent_id="p",
                        clock=_clock())
        sid = tr.emit("a", 1.0, 2.0, span_id="s1", k=1)
        with tr.span("b", parent_id=sid):
            pass
        tr.instant("c")
        out[pkg] = [{k: v for k, v in e.items() if k != "span_id"
                     or v == "s1"} for e in sink.events("span")]
    assert out["port"] == out["jax"]
    assert [e["span"] for e in out["port"]] == ["a", "b", "c"]
    assert out["port"][1]["parent_id"] == "s1"


def test_open_run_files_and_installed_default_match(tmp_path, monkeypatch):
    for v in (TRACE_ID_ENV, PARENT_SPAN_ENV):
        monkeypatch.delenv(v, raising=False)
    starts = {}
    for pkg, obs in PKGS.items():
        ev = {"jax": jevents, "port": tevents}[pkg]
        d = str(tmp_path / pkg)
        rec = obs.open_run(d, config={"lr": 0.1}, meta={"workload": "mf"})
        assert ev.get_default_recorder() is rec
        rec.inc("driver.chunks")
        ev.emit("checkpoint_saved", step=1)
        rec.close()
        assert ev.get_default_recorder() is None
        assert sorted(os.listdir(d)) == ["events-p0.jsonl",
                                         "journal-p0.jsonl",
                                         "metrics-p0.prom"]
        journal = [json.loads(ln) for ln in open(os.path.join(
            d, "journal-p0.jsonl"))]
        assert [r["event"] for r in journal] == [
            "run_start", "checkpoint_saved", "run_end"]
        starts[pkg] = journal[0]
        assert "fps_tpu_driver_chunks" in open(os.path.join(
            d, "metrics-p0.prom")).read()
    assert sorted(starts["port"]) == sorted(starts["jax"])
    assert starts["port"]["config_digest"] == starts["jax"]["config_digest"]
    assert starts["port"]["parent_id"] is None


def test_open_run_carries_the_supervisors_trace_context(tmp_path,
                                                       monkeypatch):
    monkeypatch.setenv(TRACE_ID_ENV, "a" * 32)
    monkeypatch.setenv(PARENT_SPAN_ENV, "b" * 16)
    rec = tobs.open_run(str(tmp_path), install=False)
    assert tevents.get_default_recorder() is None
    with rec.trace.span("phase"):
        pass
    rec.close()
    journal = [json.loads(ln) for ln in open(tmp_path / "journal-p0.jsonl")]
    start = journal[0]
    assert (start["trace_id"], start["parent_id"]) == ("a" * 32, "b" * 16)
    span = [r for r in journal if r["event"] == "span"][0]
    assert span["trace_id"] == "a" * 32
    assert span["parent_id"] == start["span_id"]


def test_default_recorder_scoped_and_noop(caplog):
    tevents.emit("whatever")  # nothing installed: a silent no-op
    tevents.record_metric("inc", "driver.chunks", 1)
    sink = tobs.MemorySink()
    with tevents.default_recorder(tobs.Recorder(sinks=[sink])):
        tevents.emit("rollback", index=1)
        tevents.record_metric("inc", "rollback.quarantined", 1)
        with caplog.at_level(logging.WARNING, logger="fps_tpu_torch.obs"):
            for _ in range(2):  # a rejected name: dropped, logged once
                tevents.record_metric("inc", "no.such_metric", 1)
    assert tevents.get_default_recorder() is None
    assert [e["event"] for e in sink.events()] == ["rollback"]
    assert sink.metrics("rollback.quarantined")
    assert caplog.text.count("dropping background metric") == 1


def test_process_index_is_0_without_a_process_group():
    assert tobs.process_index() == 0
    assert not torch.distributed.is_initialized()


def test_obs_modules_import_no_torch_at_module_level():
    """Telemetry is host bookkeeping: no obs module imports torch when
    imported (``timing.trace`` imports it when called), so the watchdog's
    timer thread can make no CUDA call."""
    d = os.path.join(ROOT, "fps_tpu_torch", "obs")
    for fn in sorted(os.listdir(d)):
        if not fn.endswith(".py"):
            continue
        tree = ast.parse(open(os.path.join(d, fn)).read())
        for node in tree.body:
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            assert not any(n.split(".")[0] in ("torch", "jax", "fps_tpu")
                           for n in names), (fn, names)


def test_profiling_shim_reexports_the_obs_clocks():
    from fps_tpu_torch.utils import profiling

    assert profiling.trace is tobs.trace
    assert profiling.Throughput is tobs.Throughput


# ---------------------------------------------------------------------------
# The profiler ranges, the audit refusal.
# ---------------------------------------------------------------------------

def _mf_step_inputs():
    from fps_tpu.utils import datasets as jdatasets
    from fps_tpu_torch.core.ingest import epoch_chunks

    data = jdatasets.synthetic_ratings(40, 30, 400, rank=3, seed=3)
    chunk = next(iter(epoch_chunks(data, num_workers=1, local_batch=16,
                                   steps_per_chunk=2, route_key="user",
                                   seed=1)))
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    return trainer, chunk


def test_trace_writes_a_chrome_trace_naming_the_steps_ranges(tmp_path):
    trainer, chunk = _mf_step_inputs()
    tables, local = trainer.init_state(0)
    with tobs.trace(str(tmp_path / "tr")):
        trainer.run_chunk(tables, local, chunk, 1)
    doc = json.load(open(tmp_path / "tr" / "trace.json"))
    names = {e.get("name") for e in doc["traceEvents"]}
    assert {"fps.pull", "fps.compute", "fps.push"} <= names


def test_the_step_opens_no_range_without_a_profiler(monkeypatch):
    """``record_function`` is a dispatcher call even with no profiler: the
    step opens its ranges only while one runs."""
    def refuse(*a, **k):
        raise AssertionError("a range was opened without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    trainer, chunk = _mf_step_inputs()
    tables, local = trainer.init_state(0)
    trainer.run_chunk(tables, local, chunk, 1)


def test_trainer_takes_a_recorder_and_audit_waits_for_item_10():
    from fps_tpu_torch import Trainer

    trainer, _ = _mf_step_inputs()
    rec = tobs.Recorder()
    t2 = Trainer(trainer.mesh, trainer.store, trainer.logic,
                 trainer.server_logic, trainer.config, rec)
    assert t2.recorder is rec and trainer.recorder is None
    # The program auditor is taken (it was refused before it was ported):
    # the first chunk is recorded and certified through the recorder.
    from fps_tpu_torch.analysis import ProgramAuditor

    mem = tobs.MemorySink()
    t3 = Trainer(trainer.mesh, trainer.store, trainer.logic,
                 trainer.server_logic, trainer.config,
                 tobs.Recorder(sinks=[mem]), audit=True)
    assert isinstance(t3.audit, ProgramAuditor)
    _, chunk = _mf_step_inputs()
    tables, local = t3.init_state(0)
    t3.run_chunk(tables, local, chunk, 1)
    assert [c.program for c in t3.audit.certificates] == ["chunk/sync"]
    assert t3.audit.certificates[0].ok
    assert t3.recorder.counter_value("analysis.certified_programs") == 1


# ---------------------------------------------------------------------------
# Every emitted name is registered.
# ---------------------------------------------------------------------------

_NAME_RE = re.compile(r"^[a-z][a-z0-9_]*(\.[a-z0-9_]+)+$")
_EMITTERS = {"inc", "set", "observe", "record_metric", "_obs_metric"}


def _emitted_metric_names():
    """Every metric-name-shaped string literal passed to an emission call
    anywhere in ``fps_tpu_torch/`` (direct recorder calls, the
    process-default path and the modules' ``_obs_metric`` wrappers)."""
    found = {}
    base = os.path.join(ROOT, "fps_tpu_torch")
    for dirpath, _, files in os.walk(base):
        for fn in files:
            if not fn.endswith(".py"):
                continue
            path = os.path.join(dirpath, fn)
            for node in ast.walk(ast.parse(open(path).read())):
                if not isinstance(node, ast.Call):
                    continue
                f = node.func
                name = (f.attr if isinstance(f, ast.Attribute)
                        else getattr(f, "id", None))
                if name not in _EMITTERS:
                    continue
                for arg in node.args:
                    if (isinstance(arg, ast.Constant)
                            and isinstance(arg.value, str)
                            and _NAME_RE.match(arg.value)):
                        found.setdefault(arg.value, f"{fn}:{node.lineno}")
                        break
    return found


def test_every_emitted_metric_name_is_registered():
    emitted = _emitted_metric_names()
    for expected in ("driver.chunks", "checkpoint.saves", "tiering.churn",
                     "prefetch.queue_depth", "storage.sidecar_skips",
                     "cold_route.compact_chunks", "hot_tier.pulled_rows"):
        assert expected in emitted, f"scan lost {expected}"
    registry = tobs.default_registry()
    unregistered = {n: site for n, site in sorted(emitted.items())
                    if n not in registry}
    assert not unregistered, unregistered


def test_registry_scan_catches_a_seeded_unregistered_emission():
    src = 'rec.inc("totally.unregistered_metric", 2, table="x")\n'
    call = ast.parse(src).body[0].value
    assert call.func.attr in _EMITTERS
    [arg] = [a for a in call.args if isinstance(a, ast.Constant)
             and isinstance(a.value, str) and _NAME_RE.match(a.value)]
    assert arg.value not in tobs.default_registry()


# ---------------------------------------------------------------------------
# What telemetry leaves to later items still names them.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("flag,item", [("--pod-dir", "item 9d")])
def test_the_examples_unported_flags_exit_naming_their_item(flag, item,
                                                            tmp_path):
    """The supervisor CLI's pod flags, refused until the pod was ported
    (``item``), now run a pod: ``flag`` with ``--pod-host h0`` and
    ``--pod-size 1`` over the stub child is a pod of one that leads
    itself and succeeds (``--heartbeat``, refused until the supervisor
    was ported, is lifted below)."""
    cli = os.path.join(ROOT, "fps_tpu_torch", "examples", "supervise.py")
    stub = os.path.join(ROOT, "tests", "_torch_supervised_stub.py")
    pod = tmp_path / "pod"
    r = subprocess.run([sys.executable, cli, flag, str(pod), "--pod-host",
                        "h0", "--pod-size", "1", "--poll-s", "0.05",
                        "--lease-ttl-s", "1.0", "--", sys.executable, stub,
                        "--dir", str(pod / "{host}"), "--chunks", "3",
                        "--chunk-s", "0.02"], capture_output=True,
                       text=True, timeout=60, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert item not in r.stderr
    digest = json.loads(r.stdout.strip().splitlines()[-1])
    assert digest["success"] and digest["pod"]["world"] == 1
    assert json.loads((pod / "h0" / "result.json").read_text())["done"] == 3


def test_the_examples_heartbeat_beats_and_carries_the_quarantine(
        tmp_path, monkeypatch):
    """``--heartbeat P`` beats ``P`` at every chunk and the drivers'
    sub-phases (its last beat the stream's end, at the ingest wait); a
    supervisor state file naming chunk k (``FPS_TPU_SUPERVISOR_STATE``)
    is carried into the RollbackPolicy with a ``quarantine_carried``
    event, and chunk k is skipped."""
    from fps_tpu_torch.examples import common, mf
    from fps_tpu_torch.supervise import child

    events = []
    monkeypatch.setattr(common, "emit", events.append)
    monkeypatch.setattr(mf, "emit", events.append)
    monkeypatch.delenv(child.HEARTBEAT_ENV, raising=False)
    state = tmp_path / "supervisor_state.json"
    state.write_text(json.dumps({"quarantined": [1]}))
    monkeypatch.setenv(child.STATE_ENV, str(state))
    hb = tmp_path / "hb.json"
    argv = ["--scale", "100k", "--device", "cpu", "--rank", "4",
            "--local-batch", "2048", "--steps-per-chunk", "4",
            "--ingest", "host", "--heartbeat", str(hb)]
    assert mf.main(argv) == 0
    beat = json.loads(hb.read_text())
    chunks = [e["i"] for e in events if e["event"] == "chunk"]
    assert beat["phase"] == "ingest" and beat["index"] == chunks[-1] + 1
    assert beat["version"] == child.HEARTBEAT_VERSION
    assert [e for e in events if e["event"] == "quarantine_carried"] == [
        {"event": "quarantine_carried", "indices": [1]}]
    assert 1 not in chunks and 0 in chunks and 2 in chunks


def test_the_examples_serve_port_answers_a_pull_while_training(
        tmp_path, monkeypatch):
    """``--serve-port 0`` (refused until the serving plane was ported)
    serves the run's snapshots over TCP while it trains: at the second
    chunk's event, with training held inside it, one framed ``pull``
    answers from a published step, and the run ends with a ``served``
    event. It needs ``--checkpoint-dir`` and ``--checkpoint-every``."""
    from fps_tpu_torch.core import snapshot_format
    from fps_tpu_torch.examples import common, mf
    from fps_tpu_torch.serve import WireClient

    events, answers = [], []
    d = str(tmp_path / "ck")

    def emit(record):
        events.append(record)
        chunks = [e for e in events if e["event"] == "chunk"]
        if record["event"] != "chunk" or len(chunks) != 2:
            return
        port = next(e["port"] for e in events if e["event"] == "serving")
        deadline = time.monotonic() + 30.0
        with WireClient("127.0.0.1", port, timeout=10.0) as c:
            while True:
                r = c.request({"op": "pull", "table": "item_factors",
                               "ids": [0, 1, 2]})
                if r["ok"] or time.monotonic() > deadline:
                    break
                time.sleep(0.05)  # the watcher polls every 0.5 s
        answers.append((r, set(snapshot_format.publications(d))))

    monkeypatch.setattr(common, "emit", emit)
    monkeypatch.setattr(mf, "emit", emit)
    assert mf.main(["--scale", "100k", "--device", "cpu", "--rank", "4",
                    "--local-batch", "2048", "--steps-per-chunk", "4",
                    "--ingest", "host", "--checkpoint-dir", d,
                    "--checkpoint-every", "1", "--serve-port", "0"]) == 0
    [(r, published)] = answers
    assert r["ok"] and r["step"] in published
    assert np.asarray(r["values"]).shape == (3, 4)
    served = next(e for e in events if e["event"] == "served")
    assert served["requests"] >= 1
    with pytest.raises(SystemExit, match="requires --checkpoint-dir"):
        mf.main(["--device", "cpu", "--serve-port", "0"])


def test_the_network_fault_env_installs_the_ports_faultnet(tmp_path):
    """``FPS_TPU_FAULTNET`` (refused until the wire was ported) installs
    the port's ``FaultNet`` at the first seam crossing of a fresh
    process, never the JAX package's, and its schedule fires there."""
    spec = json.dumps({"seed": 3, "rules": [
        {"peer_class": "serve", "op": "connect", "fault": "refuse",
         "start": 0, "count": 1}]})
    code = (
        "import sys\n"
        "from fps_tpu_torch.core import retry\n"
        "try:\n"
        "    retry.net_fault_check('connect', 'serve')\n"
        "    raise SystemExit('no fault fired')\n"
        "except ConnectionRefusedError:\n"
        "    pass\n"
        "assert retry.net_fault_check('connect', 'serve') is None\n"
        "inj = retry.get_net_injector()\n"
        "print(type(inj).__module__, type(inj).__name__, inj.seed)\n"
        "bad = [m for m in sys.modules if m == 'fps_tpu' or "
        "m.startswith(('fps_tpu.', 'jax'))]\n"
        "assert not bad, bad\n")
    env = dict(os.environ, FPS_TPU_FAULTNET=spec)
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["_fps_torch_faultnet", "FaultNet", "3"]


def test_the_examples_obs_dir_writes_the_run(tmp_path, capsys):
    """``--obs-dir`` (refused until telemetry was ported) writes the
    standard files and emits an ``obs`` event; ``--obs-watchdog-s`` needs
    it."""
    from fps_tpu_torch.examples import logreg_ssp

    d = str(tmp_path / "obs")
    assert logreg_ssp.main([
        "--device", "cpu", "--num-features", "500", "--nnz", "4",
        "--num-examples", "2000", "--local-batch", "64", "--epochs", "1",
        "--obs-dir", d, "--obs-watchdog-s", "60"]) == 0
    events = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert any(e["event"] == "obs" and e["dir"] == d for e in events)
    assert sorted(os.listdir(d)) == ["events-p0.jsonl", "journal-p0.jsonl",
                                     "metrics-p0.prom"]
    journal = [json.loads(ln) for ln in open(os.path.join(
        d, "journal-p0.jsonl"))]
    assert journal[0]["event"] == "run_start"
    assert journal[-1]["event"] == "run_end"
    assert any(r["event"] == "chunk" for r in journal)
    with pytest.raises(SystemExit, match="requires --obs-dir"):
        logreg_ssp.main(["--device", "cpu", "--obs-watchdog-s", "1"])
