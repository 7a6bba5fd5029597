"""The port's chaos sweep (``fps_tpu_torch/examples/chaos_sweep.py``)
against ``tools/chaos_sweep.py``.

* ``--list`` prints the reference's 34 names in its order.
* The seven in-process scenarios give the reference's digest: the same
  survival map, totals, quarantine, rollback budget and per-table health
  totals, the same mesh, and a clean accuracy within 0.01.
* The harness's gates: the program certificate holds on the port's pinned
  census and a trainer with one extra collective fails it; ``--only``
  globs, an unknown pattern and ``--shard`` select as the reference's do
  (each CLI over the same stub registry); a scenario that sleeps past
  ``--timeout-s`` is named in ``failed``; a ``time_to_recovered_s`` over
  its bound is a breach, with the reference's SLO constants.
* One cheap subprocess scenario runs through the port's CLI on the CPU.
"""

from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import io
import json
import os
import subprocess
import sys
import time

import pytest
import torch

from fps_tpu_torch.examples import chaos_sweep as tsweep
from fps_tpu_torch.parallel import collectives

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REF = os.path.join(ROOT, "tools", "chaos_sweep.py")
IN_PROCESS = ("nan_mask,inf_mask,huge_norm_mask,observe_rollback,"
              "ckpt_truncate,ckpt_bitflip,tmp_sweep")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def jsweep():
    """``tools/chaos_sweep.py`` as a module (it imports jax: the tests'
    environment sees 8 CPU devices)."""
    spec = importlib.util.spec_from_file_location("_ref_chaos_sweep", REF)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _ref_env():
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    env["PYTHONPATH"] = ROOT + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    return env


def _main(mod, argv):
    """``(exit code, digest or None, stderr)`` of one CLI's ``main``."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = mod.main(argv)
        except SystemExit as e:
            rc = e.code
    lines = out.getvalue().strip().splitlines()
    return rc, (json.loads(lines[-1]) if lines else None), err.getvalue()


def test_list_equals_the_reference_line_for_line():
    ref = subprocess.run([sys.executable, REF, "--list"], env=_ref_env(),
                         capture_output=True, text=True, timeout=300)
    assert ref.returncode == 0, ref.stderr
    port = subprocess.run(
        [sys.executable, "-m", "fps_tpu_torch.examples.chaos_sweep",
         "--device", "cpu", "--list"], cwd=ROOT, capture_output=True,
        text=True, timeout=300)
    assert port.returncode == 0, port.stderr
    names = port.stdout.splitlines()
    assert names == ref.stdout.splitlines()
    assert len(names) == 34 and names[:7] == IN_PROCESS.split(",")


def test_slo_constants_are_the_references(jsweep):
    assert tsweep.RECOVERY_SLO_DEFAULT_S == jsweep.RECOVERY_SLO_DEFAULT_S
    assert tsweep.RECOVERY_SLO_OVERRIDES_S == jsweep.RECOVERY_SLO_OVERRIDES_S
    assert tsweep._NEEDS_HARNESS == jsweep._NEEDS_HARNESS
    for name in ("nan_mask", "pod_kill_one_host", "tenant_reader_wedge"):
        for base in (None, 30.0, 240.0):
            assert (tsweep.recovery_slo_for(name, base)
                    == jsweep.recovery_slo_for(name, base))


def test_in_process_digest_equals_the_references(jsweep):
    jrc, ref, _ = _main(jsweep, ["--only", IN_PROCESS])
    rc, got, _ = _main(tsweep, ["--device", "cpu", "--only", IN_PROCESS])
    assert jrc == 0 and rc == 0
    assert set(got) == set(ref) | {"device"} and got["device"] == "cpu"
    for key in ("chaos_sweep", "survived", "total", "failed", "mesh",
                "fleet", "time_to_recovered_s", "recovery_slo",
                "namespace_audit"):
        assert got[key] == ref[key], key
    assert got["survived"] == got["total"] == 7
    # Per-table health totals of the poisoned runs, the quarantine and the
    # rollback budget: the defences saw the same poison in both packages.
    assert got["detail"] == ref["detail"]
    rb = got["detail"]["observe_rollback"]
    assert rb["quarantined"] == [1] and rb["rollback_budget"] == 8
    assert got["detail"]["nan_mask"]["health"]["weights"]["nonfinite"] > 0
    assert abs(got["clean_test_acc"] - ref["clean_test_acc"]) <= 0.01
    cert = got["program_certificate"]
    assert cert["ok"] and cert["program"] == "chaos/logreg"


def _psum_tap(mesh):
    """A collective step tap: one extra all-reduce a step over ``mesh``."""
    def tap(tables, batches, states, t):
        out = collectives.psum(mesh, [torch.ones(512) for _ in range(8)],
                               "shard")
        return [{"x": o[:1]} for o in out]

    tap.collective = True
    return tap


def test_certificate_pins_the_port_census_and_fails_a_mutant():
    from fps_tpu_torch.examples.audit_programs import BUDGETS

    h = tsweep.build_harness("cpu")
    cert = tsweep.program_certificate(h["trainer"], h["chunks"])
    assert cert["ok"], cert["violations"]
    row = BUDGETS["logreg"]
    assert cert["contract"]["exact_collectives"] is True
    assert cert["contract"]["max_collectives"] == row["max_collectives"]
    assert cert["contract"]["per_kind_max"] == row["per_kind_max"]
    assert cert["collectives"]["count"] == row["max_collectives"]
    trainer = h["trainer"]
    trainer.config = dataclasses.replace(trainer.config,
                                         step_tap=_psum_tap(h["mesh"]))
    bad = tsweep.program_certificate(trainer, h["chunks"])
    assert not bad["ok"]
    assert {v["pass_name"] for v in bad["violations"]} == {
        "collective_budget"}


# ---------------------------------------------------------------------------
# Selection, timeout and SLO gates over one stub registry in both CLIs.
# ---------------------------------------------------------------------------

STUB_NAMES = [n for n in tsweep._harness_scenarios() if
              n not in tsweep._NEEDS_HARNESS]


def _stubs(overrides=None):
    reg = {n: (lambda h: (True, None)) for n in STUB_NAMES}
    reg.update(overrides or {})
    return reg


@pytest.fixture
def stubbed(jsweep, monkeypatch):
    """Both modules' registries replaced by the same stubs; returns a
    setter for per-name overrides."""
    def install(overrides=None):
        reg = _stubs(overrides)
        monkeypatch.setattr(jsweep, "_harness_scenarios", lambda: reg)
        monkeypatch.setattr(tsweep, "_harness_scenarios",
                            lambda device=None: reg)
    install()
    return install


SELECTIONS = [
    ["--only", "pod_*"],
    ["--only", "tenant_*,net_slow_peer", "--only", "supervised"],
    ["--only", "*_kill", "--shard", "2/3"],
    ["--shard", "1/4"],
    ["--shard", "4/4"],
]


@pytest.mark.parametrize("argv", SELECTIONS,
                         ids=["glob", "repeated", "glob_shard", "shard_1",
                              "shard_last"])
def test_selection_matches_the_reference(jsweep, stubbed, argv):
    jrc, ref, _ = _main(jsweep, argv)
    rc, got, _ = _main(tsweep, ["--device", "cpu"] + argv)
    assert jrc == rc == 0
    assert list(got["chaos_sweep"]) == list(ref["chaos_sweep"])
    assert got["chaos_sweep"]


@pytest.mark.parametrize("argv", [["--only", "no_such_*"],
                                  ["--only", "pod_kill_one_host,bogus"],
                                  ["--shard", "0/3"], ["--shard", "2"]])
def test_bad_selection_errors_as_the_reference(jsweep, stubbed, argv):
    jrc, _, jerr = _main(jsweep, argv)
    rc, _, err = _main(tsweep, ["--device", "cpu"] + argv)
    assert jrc == rc == 2
    assert jerr.splitlines()[-1].split("error: ")[1] == \
        err.splitlines()[-1].split("error: ")[1]


def test_a_scenario_past_its_timeout_is_named_in_failed(stubbed):
    stubbed({"net_slow_peer": lambda h: time.sleep(30) or (True, None)})
    t0 = time.monotonic()
    rc, got, err = _main(tsweep, ["--device", "cpu", "--only",
                                  "net_slow_peer,net_torn_frames",
                                  "--timeout-s", "0.5"])
    assert time.monotonic() - t0 < 20
    assert rc == 1 and got["failed"] == ["net_slow_peer"]
    assert got["chaos_sweep"] == {"net_slow_peer": False,
                                  "net_torn_frames": True}
    assert got["detail"]["net_slow_peer"] == {"error": "timeout",
                                              "timeout_s": 0.5}
    assert "net_slow_peer timed out" in err and "FAILED" in err


def test_late_recovery_is_a_breach_as_in_the_reference(jsweep, stubbed):
    late = {"supervised": (61.0, True), "pod_kill_one_host": (61.0, False),
            "tenant_reader_wedge": (119.0, False)}
    stubbed({n: (lambda h, t=t: (True, {"time_to_recovered_s": t}))
             for n, (t, _) in late.items()})
    argv = ["--only", ",".join(late)]
    jrc, ref, _ = _main(jsweep, argv)
    rc, got, err = _main(tsweep, ["--device", "cpu"] + argv)
    assert jrc == rc == 1
    assert got["failed"] == ref["failed"] == ["supervised"]
    assert got["recovery_slo"] == ref["recovery_slo"]
    assert got["recovery_slo"]["breaches"] == {
        "supervised": {"time_to_recovered_s": 61.0, "slo_s": 60.0}}
    assert got["time_to_recovered_s"] == ref["time_to_recovered_s"]
    assert "over its 60.0s SLO" in err
    # Rescaled, and switched off.
    rc, got, _ = _main(tsweep, ["--device", "cpu", "--recovery-slo-s",
                                "120"] + argv)
    assert rc == 0 and got["recovery_slo"]["bounds_s"]["pod_kill_one_host"] \
        == 240.0
    rc, got, _ = _main(tsweep, ["--device", "cpu", "--recovery-slo-s",
                                "0"] + argv)
    assert rc == 0 and got["recovery_slo"]["enforced"] is False


def test_one_subprocess_scenario_through_the_cli_on_the_cpu(tmp_path):
    """``enospc_compaction`` (a storage scenario handed ``device``) through
    the CLI: no harness built, the device recorded."""
    r = subprocess.run(
        [sys.executable, "-m", "fps_tpu_torch.examples.chaos_sweep",
         "--device", "cpu", "--only", "enospc_compaction", "--timeout-s",
         "300"], cwd=ROOT, capture_output=True, text=True, timeout=400,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    assert r.returncode == 0, r.stderr[-2000:]
    got = json.loads(r.stdout.strip().splitlines()[-1])
    assert got["chaos_sweep"] == {"enospc_compaction": True}
    assert got["device"] == "cpu" and got["program_certificate"] is None
    assert "mesh" not in got and got["clean_test_acc"] is None
    assert got["detail"]["enospc_compaction"]["compactions_completed"] >= 1


def test_without_cuda_and_without_device_it_exits_nonzero(stubbed,
                                                          monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    rc, got, err = _main(tsweep, ["--only", "net_slow_peer"])
    assert rc == 2 and got is None and "CUDA is not available" in err


def test_serve_race_trace_records_the_watcher_and_restores_it():
    """``testing/serve_race_trace.py`` runs ``serve_while_train`` with the
    watcher's scans and opens traced, and puts the watcher back."""
    from fps_tpu_torch.serve import watcher
    from fps_tpu_torch.testing import serve_race_trace

    methods = (watcher.SnapshotWatcher._scan_dir,
               watcher.SnapshotWatcher._try_open)
    (record,) = serve_race_trace.traced_runs(1, "cpu", show_all=True)
    assert record["ok"] and record["rejected"] >= 1, record
    kinds = {event[1] for event in record["timeline"]}
    assert kinds == {"scan", "try"}
    assert any(event[1] == "try" and event[3] is None
               for event in record["timeline"])  # the torn candidate
    assert (watcher.SnapshotWatcher._scan_dir,
            watcher.SnapshotWatcher._try_open) == methods

