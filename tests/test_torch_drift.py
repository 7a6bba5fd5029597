"""Budget-drift detection (fps_tpu_torch.obs.drift) against the JAX
package's detector.

Both detectors, given the same pinned rows (``AUDIT_r10.json`` read as a
file) and the same profiles, give equal reports and equal emissions. Live:
a clean tiered MF run of the port stays quiet against the port's pinned
budget (``fps_tpu_torch/examples/audit_programs.py``), and a seeded budget
mutation (the pinned bytes halved) fires exactly one ``budget_drift``
incident.
"""

from __future__ import annotations

import copy
import importlib.util
import json
import math
import os
import sys

import pytest
import torch

from fps_tpu import obs as jobs
from fps_tpu.obs import drift as jdrift
from fps_tpu_torch import obs as tobs
from fps_tpu_torch.analysis import collective_profile
from fps_tpu_torch.examples import audit_programs as ap
from fps_tpu_torch.obs import drift as tdrift

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AUDIT = os.path.join(ROOT, "AUDIT_r10.json")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pinned_budgets_load_equal():
    got = tdrift.load_pinned_budgets(AUDIT)
    assert got == jdrift.load_pinned_budgets(AUDIT)
    assert got["mf_tiered"]["count"] == 4 and got["mf_tiered"]["bytes"] == 6144


def _strip(events):
    """Events without the per-process stamps (time, run ids)."""
    keep = ("program", "chunks", "pinned_bytes", "measured_bytes",
            "pinned_count", "measured_count", "byte_ratio", "reasons")
    return [{k: e[k] for k in keep if k in e} for e in events]


# (id, observations [(program, profile, chunks)], detector kwargs)
CASES = [
    ("quiet", [("mf_tiered", [("all_gather", 1024), ("all_to_all", 2048),
                              ("all_gather", 2048),
                              ("reduce_scatter", 1024)], 2)], {}),
    ("bytes", [("mf", [("all_gather", 4096), ("all_to_all", 2048)], 1)],
     {}),
    ("count_and_kind", [("logreg", [("all_gather", 1600),
                                    ("all_to_all", 1600),
                                    ("psum", 64)], 3)], {}),
    ("within_tol", [("mf", [("all_gather", 2048), ("all_to_all", 2100)],
                     1)], {"byte_rel_tol": 0.05}),
    ("unpinned_allowed", [("new", [("all_gather", 64)], 1)], {}),
    ("unpinned_strict", [("new", [("all_gather", 64)], 1)],
     {"allow_unpinned": False}),
    ("zero_chunks", [("mf", [("all_gather", 9999)], 0)], {}),
    ("count_tol", [("mf", [("all_gather", 2048), ("all_to_all", 2048),
                           ("all_gather", 1)], 1)], {"count_tol": 1}),
    ("several", [("mf", [("all_gather", 2048), ("all_to_all", 2048)], 3),
                 ("w2v", [("all_gather", 40448)], 2),
                 ("mf", [{"kind": "all_gather", "payload_bytes": 4096}],
                  1)], {}),
]


@pytest.mark.parametrize("obs_list,kw", [c[1:] for c in CASES],
                         ids=[c[0] for c in CASES])
def test_detectors_report_and_emit_equal(obs_list, kw):
    out = []
    for pkg, drift in ((jobs, jdrift), (tobs, tdrift)):
        mem = pkg.MemorySink()
        rec = pkg.Recorder(sinks=[mem])
        det = drift.BudgetDriftDetector(drift.load_pinned_budgets(AUDIT),
                                        recorder=rec, **kw)
        for program, profile, chunks in obs_list:
            det.observe(program, profile, chunks=chunks)
        reports = [r.to_json() for r in det.evaluate()]
        out.append((reports, _strip(mem.events("budget_drift")),
                    rec.snapshot()["gauges"]))
    assert out[0][0] == out[1][0]
    assert out[0][1] == out[1][1]
    j = {k: v for k, v in out[0][2].items() if "budget_drift" in k}
    t = {k: v for k, v in out[1][2].items() if "budget_drift" in k}
    assert j.keys() == t.keys()
    for k in j:
        assert (j[k] == t[k]) or (math.isnan(j[k]) and math.isnan(t[k]))


def test_profile_budget_and_argument_checks():
    class C:
        kind, payload_bytes = "all_gather", 512

    for profile in ([C(), C()], [("all_gather", 512)] * 2,
                    [{"kind": "all_gather", "payload_bytes": 512}] * 2):
        assert tdrift.profile_budget(profile) == jdrift.profile_budget(
            profile) == {"count": 2, "bytes": 1024, "per_kind": {
                "all_gather": {"count": 2, "bytes": 1024}}}
    with pytest.raises(ValueError):
        tdrift.BudgetDriftDetector({}, byte_rel_tol=-1)
    det = tdrift.BudgetDriftDetector({})
    with pytest.raises(ValueError):
        det.observe("p")
    with pytest.raises(ValueError):
        det.observe("p", [("a", 1)], budget={"count": 1, "bytes": 1,
                                             "per_kind": {}})
    assert tobs.BudgetDriftDetector is tdrift.BudgetDriftDetector
    assert tobs.load_pinned_budgets is tdrift.load_pinned_budgets


def _obs_report():
    spec = importlib.util.spec_from_file_location(
        "_obs_report", os.path.join(ROOT, "tools", "obs_report.py"))
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def test_emissions_land_in_an_obs_dir_the_digest_reads(tmp_path):
    d = str(tmp_path / "obs")
    rec = tobs.open_run(d, config=None, install=False)
    pinned = {"p": {"count": 2, "bytes": 1000, "per_kind": {
        "all_gather": {"count": 2, "bytes": 1000}}}}
    det = tdrift.BudgetDriftDetector(pinned, recorder=rec)
    det.observe("p", [("all_gather", 500), ("all_gather", 500)], chunks=3)
    det.observe("p", [("all_gather", 2000)], chunks=1)
    assert [r.ok for r in det.evaluate()] == [True, False]
    rec.close()
    digest = _obs_report().render_digest(d)
    assert digest["analysis"]["budget_drift_incidents"] == 1
    assert digest["analysis"]["budget_drift_ratio_max"] == 2.0
    [incident] = digest["incidents"]["budget_drift"]
    assert incident["program"] == "p" and incident["chunks"] == 1


# -- live: a tiered MF run of the port vs its pinned budget -----------------


@pytest.fixture(scope="module")
def mf_tiered_live():
    """The audit's tiered MF, run for two chunks with a recorder: (the
    dispatched program's profile, the recorder)."""
    mesh = ap.make_mesh((1, 8))
    trainer, chunks = ap._mf_pieces(mesh, hot_tier=32, hot_sync_every=2)
    chunks = list(chunks)
    text = trainer.lowered_chunk_text(chunks[0], "sync")
    rec = tobs.Recorder(sinks=[tobs.MemorySink()])
    trainer.recorder = rec
    tables, ls = trainer.init_state(0)
    trainer.fit_stream(tables, ls, iter(chunks[:2]), 1)
    return trainer, chunks, collective_profile(text), rec


def test_clean_tiered_mf_run_stays_quiet(mf_tiered_live):
    _, _, profile, rec = mf_tiered_live
    chunks = int(rec.counter_value("driver.chunks"))
    assert chunks == 2
    det = tdrift.BudgetDriftDetector(ap.pinned_budgets(), recorder=rec)
    det.observe("mf_tiered", profile, chunks=chunks)
    [r] = det.evaluate()
    assert r.ok and r.byte_ratio == pytest.approx(1.0), r.reasons
    assert (r.measured_count, r.measured_bytes) == (
        ap.BUDGETS["mf_tiered"]["max_collectives"],
        ap.BUDGETS["mf_tiered"]["max_collective_bytes"])
    assert rec.snapshot()["gauges"][
        "analysis.budget_drift{program=mf_tiered}"] == 1.0
    assert rec.sinks[0].events("budget_drift") == []


def test_seeded_budget_mutation_fires_one_incident(mf_tiered_live):
    _, _, profile, _ = mf_tiered_live
    pinned = copy.deepcopy(ap.pinned_budgets())
    pinned["mf_tiered"]["bytes"] //= 2
    mem = tobs.MemorySink()
    det = tdrift.BudgetDriftDetector(pinned,
                                     recorder=tobs.Recorder(sinks=[mem]))
    det.observe("mf_tiered", profile, chunks=2)
    [r] = det.evaluate()
    assert not r.ok and r.byte_ratio == pytest.approx(2.0)
    [event] = mem.events("budget_drift")
    assert event["program"] == "mf_tiered"
    assert any("bytes" in reason for reason in event["reasons"])


def test_observe_trainer_chunk_records_the_dispatched_program(
        mf_tiered_live):
    trainer, chunks, profile, _ = mf_tiered_live
    before = {k: torch.stack(list(v)).clone()
              for k, v in trainer.store.tables.items()}
    det = tdrift.BudgetDriftDetector(ap.pinned_budgets())
    det.observe_trainer_chunk(trainer, chunks[0], program="mf_tiered",
                              chunks=2)
    [r] = det.evaluate(emit=False)
    assert r.ok and r.measured_bytes == tdrift.profile_budget(
        profile)["bytes"]
    for k, v in before.items():
        assert torch.equal(torch.stack(list(trainer.store.tables[k])), v)
    json.dumps(r.to_json())
