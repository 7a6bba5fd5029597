"""The port's external run supervisor (fps_tpu_torch.supervise and the CLI
fps_tpu_torch/examples/supervise.py) against tests/test_supervise.py and
against the JAX package's supervisor.

Each case of tests/test_supervise.py has its counterpart here, at stub
speed: a torch-free child (``tests/_torch_supervised_stub.py``) that beats,
saves its progress and misbehaves on demand, driven through the port's CLI
in a subprocess with torch and jax unimportable (a supervisor that reaches
for either fails). Then the two packages side by side: the reference's
``tools/supervise.py`` and the port's CLI over the same stub scenarios give
the same digests (times and ids aside), state files and journal event
sequences; the env contract and the beat records are equal field for
field; and the fence's ``StaleEpochError`` is one class.
"""

import argparse
import importlib
import importlib.util
import json
import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STUB = os.path.join(_ROOT, "tests", "_torch_supervised_stub.py")
_CLI = os.path.join(_ROOT, "fps_tpu_torch", "examples", "supervise.py")
_REF_CLI = os.path.join(_ROOT, "tools", "supervise.py")
# Runs a script by path with torch and jax unimportable.
_NO_TORCH = ("import runpy, sys; sys.modules['torch'] = None; "
             "sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")


def _run_cli(cli, state_dir, child_cmd, *flags, timeout=120):
    r = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, cli, "--state-dir",
         str(state_dir), *flags, "--", *child_cmd],
        capture_output=True, text=True, timeout=timeout, cwd=_ROOT,
    )
    assert r.stdout.strip(), r.stderr[-2000:]
    return r.returncode, json.loads(r.stdout.strip().splitlines()[-1])


def _run_supervised(state_dir, child_cmd, *flags, timeout=120):
    """The port's CLI round trip; returns (rc, digest dict)."""
    return _run_cli(_CLI, state_dir, child_cmd, *flags, timeout=timeout)


def _stub_cmd(workdir, *extra):
    return [sys.executable, _STUB, "--dir", str(workdir), "--chunks", "8",
            "--chunk-s", "0.05", *extra]


def _journal(state_dir):
    with open(os.path.join(state_dir, "journal-supervisor.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def _state(state_dir):
    with open(os.path.join(state_dir, "supervisor_state.json"),
              encoding="utf-8") as f:
        return json.load(f)


def _load_by_path(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


# ---------------------------------------------------------------------------
# The tier-1 smoke: wedge -> deadline abort -> backoff restart -> resume.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wedge_mode", ["sigstop", "sleep"])
def test_wedged_child_aborted_and_resumed(tmp_path, wedge_mode):
    rc, digest = _run_supervised(
        tmp_path / "state",
        _stub_cmd(tmp_path / "work", "--wedge-at", "3",
                  "--wedge-mode", wedge_mode),
        "--stall-timeout-s", "1.0", "--startup-grace-s", "10",
        "--term-grace-s", "0.5", "--backoff-base-s", "0.1",
        "--max-restarts", "2", "--poll-s", "0.1",
    )
    assert rc == 0 and digest["success"], digest
    assert digest["deadline_aborts"] == 1
    assert digest["restarts"] == 1
    assert digest["quarantined"] == []
    with open(tmp_path / "work" / "result.json", encoding="utf-8") as f:
        result = json.load(f)
    assert result["done"] == 8
    assert result["attempt"] == 1
    assert result["ran"] == [3, 4, 5, 6, 7]
    events = [e["event"] for e in _journal(tmp_path / "state")]
    for expected in ("supervisor_start", "deadline_abort",
                     "supervisor_restart", "supervised_run_end"):
        assert expected in events, events


def test_deterministic_crash_is_quarantined(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        _stub_cmd(tmp_path / "work", "--crash-at", "2"),
        "--stall-timeout-s", "5", "--backoff-base-s", "0.05",
        "--max-restarts", "3", "--poll-s", "0.05",
    )
    assert rc == 0 and digest["success"], digest
    assert digest["quarantined"] == [2]
    assert digest["restarts"] == 2
    with open(tmp_path / "work" / "result.json", encoding="utf-8") as f:
        result = json.load(f)
    assert 2 not in result["ran"]
    state = _state(tmp_path / "state")
    assert state["quarantined"] == [2]
    assert [a["rc"] for a in state["attempts"]] == [3, 3, 0]


def test_first_signal_events_and_recovery_times(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        _stub_cmd(tmp_path / "work", "--crash-at", "2"),
        "--stall-timeout-s", "5", "--backoff-base-s", "0.05",
        "--max-restarts", "3", "--poll-s", "0.05",
    )
    assert rc == 0 and digest["success"], digest
    journal = tmp_path / "state" / "journal-supervisor.jsonl"
    events = _journal(tmp_path / "state")
    firsts = [e["attempt"] for e in events
              if e["event"] == "attempt_first_signal"]
    assert firsts == sorted(set(firsts)), firsts
    assert firsts[0] == 0 and firsts[-1] == 2, firsts
    from fps_tpu_torch.supervise.supervisor import recovery_times

    times = recovery_times(str(journal))
    assert len(times) == len([a for a in firsts if a > 0]), (firsts, times)
    assert times, times
    assert all(0 <= t < 60 for t in times), times
    assert recovery_times(str(tmp_path / "nope.jsonl")) == []


def test_wall_deadline_gives_up(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        _stub_cmd(tmp_path / "work", "--wedge-at", "0", "--wedge-always"),
        "--stall-timeout-s", "0.7", "--wall-deadline-s", "4",
        "--term-grace-s", "0.3", "--backoff-base-s", "0.1",
        "--max-restarts", "10", "--poll-s", "0.1",
        "--quarantine-after", "99",
    )
    assert rc == 1 and not digest["success"]
    assert digest["reason"] == "wall_deadline"
    assert digest["wall_s"] < 15


def test_aborted_attempt_exiting_zero_is_not_success(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        _stub_cmd(tmp_path / "work", "--wedge-at", "3",
                  "--wedge-mode", "sleep", "--trap-term"),
        "--stall-timeout-s", "1.0", "--startup-grace-s", "10",
        "--term-grace-s", "2", "--backoff-base-s", "0.1",
        "--max-restarts", "2", "--poll-s", "0.1",
    )
    assert rc == 0 and digest["success"], digest
    assert digest["deadline_aborts"] == 1
    assert digest["restarts"] == 1
    state = _state(tmp_path / "state")
    assert state["attempts"][0]["rc"] == 0
    assert state["attempts"][0]["aborted"] == "stall"
    assert os.path.exists(tmp_path / "work" / "result.json")


def test_retry_budget_exhaustion(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        [sys.executable, "-c", "import sys; sys.exit(7)"],
        "--stall-timeout-s", "5", "--backoff-base-s", "0.05",
        "--max-restarts", "2", "--poll-s", "0.05",
    )
    assert rc == 1 and not digest["success"]
    assert digest["reason"] == "retry_budget_exhausted"
    assert digest["attempts"] == 3
    assert digest["quarantined"] == []


# ---------------------------------------------------------------------------
# Library pieces (no subprocess).
# ---------------------------------------------------------------------------

def test_env_contract_mirrored():
    from fps_tpu_torch.supervise import child, supervisor

    assert supervisor.HEARTBEAT_ENV == child.HEARTBEAT_ENV
    assert supervisor.STATE_ENV == child.STATE_ENV
    assert supervisor.ATTEMPT_ENV == child.ATTEMPT_ENV
    assert supervisor.HEARTBEAT_VERSION == child.HEARTBEAT_VERSION
    assert supervisor.TRACE_ID_ENV == child.TRACE_ID_ENV
    assert supervisor.PARENT_SPAN_ENV == child.PARENT_SPAN_ENV
    trace = importlib.import_module("fps_tpu_torch.obs.trace")
    assert trace.TRACE_ID_ENV == child.TRACE_ID_ENV
    assert trace.PARENT_SPAN_ENV == child.PARENT_SPAN_ENV


def test_backoff_jitter_deterministic(tmp_path):
    from fps_tpu_torch.supervise import RunSupervisor, SupervisorConfig

    cfg = SupervisorConfig(backoff_base_s=1.0, backoff_factor=2.0,
                           backoff_max_s=8.0, backoff_jitter=0.25)
    a = RunSupervisor(["true"], state_dir=str(tmp_path / "a"), config=cfg)
    a2 = RunSupervisor(["true"], state_dir=str(tmp_path / "a"), config=cfg)
    b = RunSupervisor(["true"], state_dir=str(tmp_path / "b"), config=cfg)
    sched_a = [a.backoff_s(i) for i in range(4)]
    assert sched_a == [a2.backoff_s(i) for i in range(4)]
    assert sched_a != [b.backoff_s(i) for i in range(4)]
    for i, s in enumerate(sched_a):
        base = cfg.backoff_s(i)
        assert base <= s <= base * 1.25, (i, s, base)
    plain = RunSupervisor(
        ["true"], state_dir=str(tmp_path / "a"),
        config=SupervisorConfig(backoff_jitter=0.0))
    assert plain.backoff_s(1) == plain.config.backoff_s(1)
    with pytest.raises(ValueError):
        SupervisorConfig(backoff_jitter=1.5)
    # The schedule is the JAX package's, for the same directory.
    from fps_tpu.supervise import RunSupervisor as JRunSupervisor
    from fps_tpu.supervise import SupervisorConfig as JSupervisorConfig

    j = JRunSupervisor(["true"], state_dir=str(tmp_path / "a"),
                       config=JSupervisorConfig(
                           backoff_base_s=1.0, backoff_factor=2.0,
                           backoff_max_s=8.0, backoff_jitter=0.25))
    assert [j.backoff_s(i) for i in range(4)] == sched_a


def test_heartbeat_rejected_unknown_version_and_wrong_host(tmp_path):
    from fps_tpu_torch.supervise import RunSupervisor

    sup = RunSupervisor(["true"], state_dir=str(tmp_path), host="h0")

    def write_beat(rec):
        with open(sup.heartbeat_path, "w", encoding="utf-8") as f:
            json.dump(rec, f)
        os.utime(sup.heartbeat_path)

    write_beat({"version": 99, "index": 3})
    assert sup._read_heartbeat() == (None, None, None)
    write_beat({"version": 2, "host": "h1", "index": 4})
    assert sup._read_heartbeat() == (None, None, None)
    state = _state(tmp_path)
    assert state["heartbeat_rejected"] == 2
    rejected = [e for e in _journal(tmp_path)
                if e["event"] == "heartbeat_rejected"]
    assert len(rejected) == 2
    assert "version" in rejected[0]["reason"]
    assert "host" in rejected[1]["reason"]
    write_beat({"version": 2, "host": "h0", "index": 5})
    assert sup._read_heartbeat()[1] == 5
    write_beat({"version": 2, "index": 6})
    assert sup._read_heartbeat()[1] == 6
    anyhost = RunSupervisor(["true"], state_dir=str(tmp_path / "s2"))
    with open(anyhost.heartbeat_path, "w", encoding="utf-8") as f:
        json.dump({"version": 2, "host": "whoever", "index": 7}, f)
    assert anyhost._read_heartbeat()[1] == 7


def test_state_schema_version_and_migration(tmp_path):
    from fps_tpu_torch.supervise import RunSupervisor
    from fps_tpu_torch.supervise.supervisor import STATE_SCHEMA_VERSION

    state_path = tmp_path / "supervisor_state.json"
    state_path.write_text(json.dumps(
        {"restarts": 3, "quarantined": [7], "attempts": []}))
    sup = RunSupervisor(["true"], state_dir=str(tmp_path))
    assert sup.state["schema"] == STATE_SCHEMA_VERSION
    assert sup.state["quarantined"] == [7]
    assert sup.state["restarts"] == 3

    state_path.write_text(json.dumps({"schema": STATE_SCHEMA_VERSION + 1}))
    with pytest.raises(ValueError):
        RunSupervisor(["true"], state_dir=str(tmp_path))


def test_quarantine_cap_oldest_first(tmp_path):
    from fps_tpu_torch.supervise import RunSupervisor
    from fps_tpu_torch.supervise.supervisor import QUARANTINE_CAP

    sup = RunSupervisor(["true"], state_dir=str(tmp_path))
    sup.state["quarantined"] = list(range(QUARANTINE_CAP + 10))
    sup._cap_quarantine()
    assert sup.state["quarantined"] == list(range(10, QUARANTINE_CAP + 10))
    evicted = [e for e in _journal(tmp_path)
               if e["event"] == "quarantine_evicted"]
    assert evicted and evicted[0]["evicted"] == list(range(10))
    sup._cap_quarantine()
    assert len([e for e in _journal(tmp_path)
                if e["event"] == "quarantine_evicted"]) == 1


def test_supervisor_module_loads_without_fps_tpu_torch(tmp_path):
    """Both modules load by file path in a bare interpreter with torch and
    jax unimportable, and import neither package; the CLI's own loader
    does the same through its stubbed package roots."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        f"root = {os.path.join(_ROOT, 'fps_tpu_torch', 'supervise')!r}\n"
        "for name in ('child', 'supervisor'):\n"
        "    spec = importlib.util.spec_from_file_location(\n"
        "        '_sup_' + name, root + '/' + name + '.py')\n"
        "    mod = importlib.util.module_from_spec(spec)\n"
        "    sys.modules[spec.name] = mod\n"
        "    spec.loader.exec_module(mod)\n"
        "mod.SupervisorConfig(stall_timeout_s=1.0)\n"
        f"cli = {_CLI!r}\n"
        "spec = importlib.util.spec_from_file_location('_cli', cli)\n"
        "c = importlib.util.module_from_spec(spec)\n"
        "spec.loader.exec_module(c)\n"
        "c.load_supervise_module('supervisor').SupervisorConfig()\n"
        "c.load_supervise_module('child').Heartbeat\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and (\n"
        "    m.split('.')[0] in ('jax', 'torch', 'fps_tpu')\n"
        "    or m.startswith('fps_tpu_torch.') and not\n"
        "    m.startswith('fps_tpu_torch.supervise'))]\n"
        "assert not bad, bad\n"
        "assert not hasattr(sys.modules['fps_tpu_torch'], '__file__')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]


def test_backoff_schedule_and_validation():
    from fps_tpu_torch.supervise import SupervisorConfig

    cfg = SupervisorConfig(backoff_base_s=1.0, backoff_factor=2.0,
                           backoff_max_s=5.0)
    assert [cfg.backoff_s(i) for i in range(5)] == [1.0, 2.0, 4.0, 5.0, 5.0]
    with pytest.raises(ValueError):
        SupervisorConfig(stall_timeout_s=0)
    with pytest.raises(ValueError):
        SupervisorConfig(max_restarts=-1)
    with pytest.raises(ValueError):
        SupervisorConfig(quarantine_after=0)


def test_heartbeat_beat_and_sink(tmp_path):
    from fps_tpu_torch.supervise import Heartbeat, HeartbeatSink

    hb = Heartbeat(str(tmp_path / "hb.json"))
    hb.beat(index=4, extra="x")
    rec = json.load(open(tmp_path / "hb.json"))
    assert rec["index"] == 4 and rec["extra"] == "x" and rec["pid"]

    sink = HeartbeatSink(hb)
    sink.write({"kind": "metric", "name": "driver.chunks"})
    assert json.load(open(tmp_path / "hb.json"))["index"] == 4
    sink.write({"kind": "event", "event": "chunk", "index": 7})
    assert json.load(open(tmp_path / "hb.json"))["index"] == 8
    sink.write({"kind": "event", "event": "checkpoint_saved", "index": 9})
    assert json.load(open(tmp_path / "hb.json"))["index"] == 8
    sink.write({"kind": "event", "event": "run_start"})
    assert json.load(open(tmp_path / "hb.json"))["index"] is None

    hb.on_chunk()(3, {})
    assert json.load(open(tmp_path / "hb.json"))["index"] == 4


def test_quarantine_needs_consecutive_failures(tmp_path):
    from fps_tpu_torch.supervise import RunSupervisor, SupervisorConfig

    sup = RunSupervisor(["true"], state_dir=str(tmp_path),
                        config=SupervisorConfig(quarantine_after=2))
    fail = {"rc": 1, "last_index": 5}
    sup.state["attempts"] = [dict(fail), {"rc": 0, "last_index": 9},
                             dict(fail)]
    sup._maybe_quarantine(dict(fail))
    assert sup.state["quarantined"] == []
    sup.state["attempts"].append(dict(fail))
    sup._maybe_quarantine(dict(fail))
    assert sup.state["quarantined"] == [5]
    sup.state["quarantined"] = []
    sup.state["attempts"] = [{"rc": 1, "last_index": None}] * 3
    sup._maybe_quarantine({"rc": 1, "last_index": None})
    assert sup.state["quarantined"] == []
    stall = {"rc": -9, "last_index": 4, "aborted": "stall"}
    sup.state["attempts"] = [dict(stall)] * 3
    sup._maybe_quarantine(dict(stall))
    assert sup.state["quarantined"] == []
    sup.state["attempts"] = [dict(fail), dict(stall), dict(fail)]
    sup._maybe_quarantine(dict(fail))
    assert sup.state["quarantined"] == [5]


def test_quarantine_round_trip_through_env(tmp_path, monkeypatch):
    from fps_tpu_torch.supervise import child

    state_path = tmp_path / "supervisor_state.json"
    state_path.write_text(json.dumps({"quarantined": [3, 5]}))
    monkeypatch.setenv(child.STATE_ENV, str(state_path))
    assert child.quarantined_from_env() == frozenset({3, 5})
    monkeypatch.setenv(child.STATE_ENV, str(tmp_path / "missing.json"))
    assert child.quarantined_from_env() == frozenset()


def test_heartbeat_only_recorder_via_common(tmp_path, monkeypatch):
    """examples/common.attach_obs: a supervised run without --obs-dir
    still gets a heartbeat-only recorder, so chunk events beat."""
    from fps_tpu_torch.examples import common
    from fps_tpu_torch.supervise import child

    hb_path = tmp_path / "hb.json"
    monkeypatch.setenv(child.HEARTBEAT_ENV, str(hb_path))
    args = argparse.Namespace(obs_dir=None, obs_watchdog_s=None,
                              heartbeat=None)
    rec = common.attach_obs(args)
    assert rec is not None
    rec.event("chunk", index=11)
    assert json.load(open(hb_path))["index"] == 12


def _stall_child(phase, index):
    return (
        "import json, os, time\n"
        "p = os.environ['FPS_TPU_HEARTBEAT']\n"
        f"json.dump({{'version': 2, 'index': {index}, 'phase': {phase!r}}},"
        " open(p, 'w'))\n"
        "time.sleep(120)\n"
    )


def test_source_stall_classified_and_surfaced(tmp_path):
    """A stalled ``prefetch`` beat is a wedged SOURCE: classified in the
    attempt record and the journal, counted in the digest, and folded by
    the reference's tools/obs_report.py from the port's journal."""
    rc, digest = _run_supervised(
        tmp_path / "state",
        [sys.executable, "-c", _stall_child("prefetch", 2)],
        "--stall-timeout-s", "0.8", "--startup-grace-s", "10",
        "--term-grace-s", "0.3", "--max-restarts", "0", "--poll-s", "0.1",
        timeout=60,
    )
    assert digest["deadline_aborts"] == 1
    assert digest["source_stalls"] == 1
    state = _state(tmp_path / "state")
    assert state["attempts"][-1]["stall_kind"] == "source_stall"
    assert state["attempts"][-1]["last_phase"] == "prefetch"
    assert digest["quarantined"] == []
    aborts = [e for e in _journal(tmp_path / "state")
              if e.get("event") == "deadline_abort"]
    assert aborts and aborts[0]["stall_kind"] == "source_stall"
    report = _load_by_path("_obs_report",
                           os.path.join(_ROOT, "tools", "obs_report.py"))
    folded = report.render_digest(str(tmp_path / "state"))
    assert folded["source_stalls"] == 1


def test_driver_stall_not_classified_as_source(tmp_path):
    rc, digest = _run_supervised(
        tmp_path / "state",
        [sys.executable, "-c", _stall_child("dispatch", 1)],
        "--stall-timeout-s", "0.8", "--startup-grace-s", "10",
        "--term-grace-s", "0.3", "--max-restarts", "0", "--poll-s", "0.1",
        timeout=60,
    )
    assert digest["deadline_aborts"] == 1
    assert digest["source_stalls"] == 0
    assert _state(tmp_path / "state")["attempts"][-1]["stall_kind"] == (
        "driver_stall")


# ---------------------------------------------------------------------------
# The two packages side by side.
# ---------------------------------------------------------------------------

# Stub scenarios whose every decision is fixed by the stub, not by timing:
# (child args, supervisor flags). The wall deadline lands inside the first
# attempt, before the stall deadline could.
_PARITY = {
    "wedge_sigstop": (("--wedge-at", "3", "--wedge-mode", "sigstop"),
                      ("--stall-timeout-s", "1.0", "--startup-grace-s", "10",
                       "--term-grace-s", "0.5", "--backoff-base-s", "0.1",
                       "--max-restarts", "2", "--poll-s", "0.1")),
    "wedge_sleep": (("--wedge-at", "3", "--wedge-mode", "sleep"),
                    ("--stall-timeout-s", "1.0", "--startup-grace-s", "10",
                     "--term-grace-s", "0.5", "--backoff-base-s", "0.1",
                     "--max-restarts", "2", "--poll-s", "0.1")),
    "crash_quarantine": (("--crash-at", "2"),
                         ("--stall-timeout-s", "5", "--backoff-base-s",
                          "0.05", "--max-restarts", "3", "--poll-s",
                          "0.05")),
    "retry_exhaustion": (None,
                         ("--stall-timeout-s", "5", "--backoff-base-s",
                          "0.05", "--max-restarts", "2", "--poll-s",
                          "0.05")),
    "wall_deadline": (("--wedge-at", "1", "--wedge-always"),
                      ("--stall-timeout-s", "30", "--wall-deadline-s", "2",
                       "--term-grace-s", "0.3", "--backoff-base-s", "0.1",
                       "--max-restarts", "3", "--poll-s", "0.1")),
}
# Times, paths and ids differ run to run.
_DIGEST_VARIES = ("wall_s", "restart_to_first_signal_s", "state_path",
                  "journal_path")


@pytest.mark.parametrize("scenario", sorted(_PARITY))
def test_port_supervisor_matches_the_reference_over_a_stub(tmp_path,
                                                           scenario):
    child_args, flags = _PARITY[scenario]
    out = {}
    for name, cli in (("ref", _REF_CLI), ("port", _CLI)):
        cmd = ([sys.executable, "-c", "import sys; sys.exit(7)"]
               if child_args is None
               else _stub_cmd(tmp_path / name / "work", *child_args))
        state = tmp_path / name / "state"
        rc, digest = _run_cli(cli, state, cmd, *flags)
        attempts = [{k: a.get(k) for k in
                     ("rc", "last_index", "last_phase", "aborted",
                      "stall_kind")}
                    for a in _state(state)["attempts"]]
        # attempt_first_signal is an observation of timing: a crashing
        # attempt may die between two polls. Both supervisors must see
        # the first and the last attempt's signal (checked below).
        events = [e["event"] for e in _journal(state)
                  if e["event"] != "attempt_first_signal"]
        firsts = [e["attempt"] for e in _journal(state)
                  if e["event"] == "attempt_first_signal"]
        out[name] = (rc, {k: v for k, v in digest.items()
                          if k not in _DIGEST_VARIES},
                     attempts, _state(state)["quarantined"], events, firsts)
    ref, port = out["ref"], out["port"]
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3]
    assert port[4] == ref[4]
    if child_args is not None and scenario != "wall_deadline":
        for firsts, n in ((ref[5], ref[1]["attempts"]),
                          (port[5], port[1]["attempts"])):
            assert firsts[0] == 0 and firsts[-1] == n - 1, firsts


def test_env_contract_and_constants_equal_across_packages():
    from fps_tpu.supervise import child as jchild
    from fps_tpu.supervise import supervisor as jsup

    from fps_tpu_torch.supervise import child, supervisor

    for name in ("HEARTBEAT_ENV", "STATE_ENV", "ATTEMPT_ENV",
                 "POD_HOST_ENV", "POD_EPOCH_ENV", "POD_WORLD_ENV",
                 "POD_STEP_ENV", "TRACE_ID_ENV", "PARENT_SPAN_ENV",
                 "HEARTBEAT_VERSION", "FENCE_FILENAME"):
        assert getattr(child, name) == getattr(jchild, name), name
    for name in ("HEARTBEAT_ENV", "STATE_ENV", "ATTEMPT_ENV",
                 "TRACE_ID_ENV", "PARENT_SPAN_ENV", "HEARTBEAT_VERSION",
                 "STATE_FILENAME", "HEARTBEAT_FILENAME", "JOURNAL_FILENAME",
                 "STATE_SCHEMA_VERSION", "QUARANTINE_CAP"):
        assert getattr(supervisor, name) == getattr(jsup, name), name
    import fps_tpu.supervise as jpkg

    import fps_tpu_torch.supervise as pkg

    assert set(pkg.__all__) == set(jpkg.__all__)


def test_heartbeat_records_equal_across_packages(tmp_path, monkeypatch):
    """The same beats and sink records give the same beat files field for
    field, ``t`` and ``pid`` aside; the env readers agree."""
    from fps_tpu.supervise import child as jchild

    from fps_tpu_torch.supervise import child

    monkeypatch.setenv(child.POD_HOST_ENV, "h3")
    monkeypatch.setenv(child.POD_EPOCH_ENV, "4")
    monkeypatch.setenv(child.POD_STEP_ENV, "12")
    monkeypatch.setenv(child.ATTEMPT_ENV, "2")
    monkeypatch.setenv(child.TRACE_ID_ENV, "abc")
    state = tmp_path / "state.json"
    state.write_text(json.dumps({"quarantined": [4, 9]}))
    monkeypatch.setenv(child.STATE_ENV, str(state))

    def beats(mod, d):
        hb = mod.Heartbeat(str(tmp_path / d / "hb.json"))
        sink = mod.HeartbeatSink(hb)
        seen = []

        def read():
            with open(hb.path, encoding="utf-8") as f:
                rec = json.load(f)
            seen.append({k: v for k, v in rec.items()
                         if k not in ("t", "pid")})

        hb.beat(index=3, phase="dispatch")
        read()
        hb.beat()
        read()
        hb.on_chunk()(5, {})
        read()
        for rec in ({"kind": "event", "event": "run_start"},
                    {"kind": "event", "event": "chunk", "index": 7},
                    {"kind": "event", "event": "epoch", "index": 1},
                    {"kind": "event", "event": "checkpoint_saved",
                     "index": 2},
                    {"kind": "metric", "name": "driver.chunks"}):
            sink.write(rec)
            read()
        return seen, (mod.pod_env(), mod.attempt_from_env(),
                      mod.quarantined_from_env(), mod.trace_from_env())

    assert beats(child, "port") == beats(jchild, "ref")


def test_one_stale_epoch_error(tmp_path):
    """The fence is defined once: the checkpoint layer's StaleEpochError
    and helpers are the supervisor's, and a fenced publish raises it."""
    import numpy as np

    import fps_tpu_torch.supervise as pkg
    from fps_tpu_torch import TableSpec, make_ps_mesh
    from fps_tpu_torch.core import checkpoint
    from fps_tpu_torch.core.store import ParamStore
    from fps_tpu_torch.supervise import child

    assert checkpoint.StaleEpochError is child.StaleEpochError
    assert pkg.StaleEpochError is child.StaleEpochError
    for name in ("read_fence", "write_fence", "fence_allows",
                 "FENCE_FILENAME", "POD_EPOCH_ENV"):
        assert getattr(checkpoint, name) is getattr(child, name), name
    store = ParamStore(make_ps_mesh(device="cpu"),
                       [TableSpec("w", num_ids=8, dim=2)])
    store.init(0)
    d = str(tmp_path / "ck")
    child.write_fence(d, 5, 0)
    ck = checkpoint.Checkpointer(d, fence_epoch=4)
    with pytest.raises(child.StaleEpochError):
        ck.save(1, store, None)
    assert checkpoint.Checkpointer(d, fence_epoch=5).save(1, store, None)
    assert np.isfinite(store.lookup_host("w", np.arange(8))).all()


@pytest.mark.parametrize("flag", [["--pod-dir", "P"], ["--pod-host", "h0"],
                                  []])
def test_the_clis_pod_flags_exit_naming_item_9d(tmp_path, flag):
    """Pod mode is ported (item 9d is done): the pod flags are now the
    reference's usage cases (``test_cli_pod_flag_validation`` of
    tests/test_pod.py). --pod-dir and --pod-host travel together, and
    --state-dir is required outside pod mode: exit 2, nothing started."""
    flag = [str(tmp_path) if f == "P" else f for f in flag]
    r = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, _CLI, *flag, "--", "true"],
        capture_output=True, text=True, timeout=60, cwd=_ROOT)
    assert r.returncode == 2, r.stderr
    assert "usage:" in r.stderr, r.stderr
    assert not os.path.exists(tmp_path / "journal-supervisor.jsonl")


def test_compilation_cache_dir_is_passed_through(tmp_path):
    """As the reference does: the directory reaches every attempt as
    JAX_COMPILATION_CACHE_DIR (a child of the port compiles nothing at
    run time)."""
    out = tmp_path / "env.txt"
    rc, digest = _run_supervised(
        tmp_path / "state",
        [sys.executable, "-c",
         "import os; open(%r, 'w').write(os.environ["
         "'JAX_COMPILATION_CACHE_DIR'])" % str(out)],
        "--compilation-cache-dir", str(tmp_path / "cc"),
        "--max-restarts", "0")
    assert rc == 0 and digest["success"]
    assert out.read_text() == str(tmp_path / "cc")
