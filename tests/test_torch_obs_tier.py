"""Telemetry of the port's tiers, checkpoints and tools against the JAX
package's.

* **The tier's counters.** Logistic regression with the static hot tier
  (``hot_tier=64``, window 3) at (1, 4), (2, 4) and (2, 4) SSP, with and
  without ``cold_budget`` lanes: the ``hot_tier.*`` and ``cold_route.*``
  counters equal the reference's (oracles:
  ``tests/test_hot_tier.py::test_hot_tier_recorder_counters`` and the
  counter checks of ``tests/test_cold_route.py``), the
  ``hot_tier.pending_delta`` gauge within float32 rounding.
* **Re-ranks and plans.** The mapped tier re-ranked at every check
  (``churn_threshold=-1``), and the auto-planner with re-plans: the
  ``tiering.*`` counters, the churn gauges and the ``tiering_rerank`` /
  ``tiering_plan`` events equal the reference's.
* **Checkpoints.** The checkpoint journal trail of saves and a fallback
  equals the reference's (oracle:
  ``tests/test_obs.py::test_checkpoint_save_and_fallback_events``).
* **The reference's tools.** ``tools/obs_report.py`` and
  ``tools/trace_export.py`` (stdlib-only) read a port run's ``open_run``
  directory and digest it as they digest the JAX package's run of the
  same chunks.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from fps_tpu import obs as jobs
from fps_tpu.core import checkpoint as jck
from fps_tpu.core import ingest as jingest
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.obs import events as jevents
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.testing import chaos as jchaos
from fps_tpu.tiering import retier as jretier
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import LogRegConfig, logistic_regression, obs as tobs
from fps_tpu_torch import tiering
from fps_tpu_torch.convert import tables_from_jax
from fps_tpu_torch.core import checkpoint as tck
from fps_tpu_torch.obs import events as tevents
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.testing import chaos as tchaos

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NF = 200
LR_KW = dict(num_features=NF, learning_rate=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _lr_data(seed=7):
    data = jdatasets.synthetic_sparse_classification(2048, NF, 8, seed=seed,
                                                     noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def _chunks(W, sync_every=None, n=6, local_batch=16):
    return list(jingest.epoch_chunks(
        _lr_data(), num_workers=W, local_batch=local_batch,
        steps_per_chunk=4, sync_every=sync_every, seed=3))[:n]


def _pair(D, S, *, sync_every=None, guard=None, H=64, E=3, **spec):
    """The JAX package's logreg trainer and the port's, the tier set alike
    on both, from the same state."""
    jtr, jst = jlogistic_regression(
        jmesh.make_ps_mesh(num_shards=S, num_data=D,
                           devices=jax.devices()[:D * S]),
        JLogRegConfig(**LR_KW), sync_every=sync_every, guard=guard)
    ttr, tst = logistic_regression(tmesh.make_ps_mesh(S, D, device="cpu"),
                                   LogRegConfig(**LR_KW),
                                   sync_every=sync_every, guard=guard)
    for tr, st in ((jtr, jst), (ttr, tst)):
        if H:
            st.specs["weights"] = dataclasses.replace(
                st.specs["weights"], hot_tier=H, **spec)
        tr.config = dataclasses.replace(tr.config, hot_sync_every=E)
    jt, _ = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    return (jtr, jt), (ttr, tt)


def _recorders():
    js, ts = jobs.MemorySink(), tobs.MemorySink()
    return (jobs.Recorder(sinks=[js]), js), (tobs.Recorder(sinks=[ts]), ts)


def _fit_both(pair, chunks, **kw):
    (jtr, jt), (ttr, tt) = pair
    (jr, js), (tr, ts) = _recorders()
    jtr.fit_stream(jt, (), iter(chunks), jax.random.key(1), recorder=jr,
                   on_chunk=lambda i, m: None, **kw)
    ttr.fit_stream(tt, (), iter(chunks), 1, recorder=tr,
                   on_chunk=lambda i, m: None, **kw)
    return (jr, js), (tr, ts)


def _same_gauges(got, want, rtol=1e-5):
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=rtol, atol=1e-6,
                                   err_msg=k)


# ---------------------------------------------------------------------------
# The hot tier's and the cold lanes' counters.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,S,sync_every", [(1, 4, None), (2, 4, None),
                                            (2, 4, 2)],
                         ids=["1x4", "2x4", "2x4-ssp"])
def test_hot_tier_counters_match(D, S, sync_every):
    pair = _pair(D, S, sync_every=sync_every)
    (jr, _), (tr, _) = _fit_both(pair, _chunks(D * S, sync_every))
    want, got = jr.snapshot(), tr.snapshot()
    assert got["counters"] == want["counters"]
    _same_gauges(got["gauges"], want["gauges"])
    if sync_every is None:
        hot = tr.counter_value("hot_tier.hot_rows", table="weights")
        pulled = tr.counter_value("hot_tier.pulled_rows", table="weights")
        assert 0 < hot <= pulled
    assert any(k.startswith("hot_tier.pending_delta")
               for k in got["gauges"])


@pytest.mark.parametrize("budget", [2, 24, 400],
                         ids=["overflow", "mixed", "fits"])
def test_cold_route_counters_match(budget):
    """The ``cold_budget`` lanes certified at dispatch: the compact and
    overflow chunk counts and the (zero) dropped rows equal the
    reference's."""
    pair = _pair(1, 4, cold_budget=budget, dense_collectives=False)
    chunks = _chunks(4, local_batch=32)
    (jr, _), (tr, _) = _fit_both(pair, chunks)
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    compact = tr.counter_value("cold_route.compact_chunks")
    over = tr.counter_value("cold_route.overflow_chunks", table="weights")
    assert compact + over == len(chunks)
    assert tr.counter_value("hot_tier.cold_dropped", table="weights") == 0
    if budget == 400:
        assert compact == len(chunks)
    elif budget == 2:
        assert over == len(chunks)


# ---------------------------------------------------------------------------
# The adaptive tier's re-ranks and plans.
# ---------------------------------------------------------------------------

def _tier_events(sink):
    out = []
    for e in sink.events():
        if e["event"].startswith("tiering"):
            out.append({k: v for k, v in e.items() if k not in ("t",)})
    return out


@pytest.mark.parametrize("D,S,sync_every", [(1, 4, None), (2, 4, 2)],
                         ids=["1x4", "2x4-ssp"])
def test_forced_reranks_record_what_the_reference_records(D, S,
                                                          sync_every):
    pair = _pair(D, S, sync_every=sync_every)
    pair[0][0].retierer = jretier.Retierer(check_every=2,
                                           churn_threshold=-1.0)
    pair[1][0].retierer = tiering.Retierer(check_every=2,
                                           churn_threshold=-1.0)
    (jr, js), (tr, ts) = _fit_both(pair, _chunks(D * S, sync_every))
    want, got = jr.snapshot(), tr.snapshot()
    assert got["counters"] == want["counters"]
    assert tr.counter_value("tiering.re_ranks", table="weights") >= 1
    _same_gauges(got["gauges"], want["gauges"])
    assert _tier_events(ts) == _tier_events(js)
    assert [e["event"] for e in ts.events()] == [
        e["event"] for e in js.events()]


def test_auto_plans_and_replans_record_what_the_reference_records():
    """The auto-planner after one fold, re-planning every two: the
    ``tiering_plan`` events (with their plans) and the
    ``tiering.replans`` counters equal the reference's (with
    ``dense_table_bytes=0`` on both sides, as
    ``tests/test_torch_tiering.py`` compares plans)."""
    pair = _pair(1, 4, H=0, E=1)
    kw = dict(auto_plan=True, check_every=1, replan_every=2,
              plan_kwargs={"dense_table_bytes": 0})
    pair[0][0].retierer = jretier.Retierer(**kw)
    pair[1][0].retierer = tiering.Retierer(**kw)
    (jr, js), (tr, ts) = _fit_both(pair, _chunks(4))
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    assert ts.events("tiering_plan")
    assert _tier_events(ts) == _tier_events(js)


# ---------------------------------------------------------------------------
# The checkpoint trail.
# ---------------------------------------------------------------------------

def test_checkpoint_journal_trail_matches_the_reference(tmp_path):
    """Two saves, the newest truncated, a restore falling back to step 1:
    the ``checkpoint_saved`` / ``checkpoint_fallback`` trail (steps, bytes,
    published paths) and the counters equal the reference's."""
    (jtr, jt), (ttr, tt) = _pair(1, 1, H=0)
    ttr.store.tables = dict(tt)
    trails = {}
    for pkg, ev, obs, ck, chaos, tr, tables in (
            ("jax", jevents, jobs, jck, jchaos, jtr, jt),
            ("port", tevents, tobs, tck, tchaos, ttr, tt)):
        d = str(tmp_path / pkg)
        sink = obs.MemorySink()
        rec = obs.Recorder(sinks=[sink])
        with ev.default_recorder(rec):
            ckpt = ck.Checkpointer(d, keep=2)
            ckpt.save(1, tr.store)
            ckpt.save(2, tr.store)
            chaos.corrupt_latest_snapshot(d, "truncate")
            _, step = ckpt.restore_tables(tr.store)
        assert step == 1
        trails[pkg] = ([{k: (os.path.basename(v) if k == "path" else v)
                         for k, v in e.items() if k not in ("t", "seconds")}
                        for e in sink.events()],
                       rec.snapshot()["counters"])
    assert trails["port"] == trails["jax"]
    kinds = [e["event"] for e in trails["port"][0]]
    assert kinds == ["checkpoint_saved", "checkpoint_saved",
                     "checkpoint_fallback"]
    assert trails["port"][1]["checkpoint.saves"] == 2
    assert trails["port"][1]["checkpoint.fallbacks"] == 1


# ---------------------------------------------------------------------------
# The reference's tools over a port run.
# ---------------------------------------------------------------------------

def _obs_runs(tmp_path):
    """One guarded logreg stream with checkpoints, written by each
    package's ``open_run`` into its own directory."""
    chunks = _chunks(4, n=4)
    (jtr, jt), (ttr, tt) = _pair(1, 4, guard="observe")
    dirs = {}
    for pkg, obs, ck, tr, tables, key in (
            ("jax", jobs, jck, jtr, jt, jax.random.key(1)),
            ("port", tobs, tck, ttr, tt, 1)):
        d = str(tmp_path / pkg / "obs")
        rec = obs.open_run(d, config={"workload": "logreg"})
        tr.recorder = rec
        tr.fit_stream(tables, (), iter(chunks), key,
                      checkpointer=ck.Checkpointer(str(tmp_path / pkg /
                                                       "ck")),
                      checkpoint_every=2, on_chunk=lambda i, m: None)
        rec.close()
        dirs[pkg] = d
    return dirs


def _tool(name, *args):
    out = subprocess.run([sys.executable, os.path.join(ROOT, "tools", name),
                          *args], capture_output=True, text=True,
                         timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return out.stdout


def test_the_reference_tools_digest_a_port_run_as_a_jax_run(tmp_path):
    dirs = _obs_runs(tmp_path)
    digests = {pkg: json.loads(_tool("obs_report.py", d, "--json"))
               for pkg, d in dirs.items()}
    keys = ("chunks", "epochs", "steps", "examples", "health",
            "poisoned_chunks", "checkpoint_saves", "quarantined",
            "run_complete", "watchdog_stalls", "rollbacks", "processes",
            "aggregated_runs")
    got, want = digests["port"], digests["jax"]
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["chunks"] == 4 and got["run_complete"] is True
    assert set(got["phase_seconds"]) == set(want["phase_seconds"])
    traces = {}
    for pkg, d in dirs.items():
        doc = json.loads(_tool("trace_export.py", d))
        traces[pkg] = sorted((e.get("name"), e.get("ph"))
                             for e in doc["traceEvents"])
    assert traces["port"] == traces["jax"]
    assert any(ph == "X" for _, ph in traces["port"])


def test_obs_report_fleet_reads_port_dirs(tmp_path):
    dirs = _obs_runs(tmp_path)
    out = json.loads(_tool("obs_report.py", "--fleet", dirs["port"],
                           dirs["jax"], "--json"))
    assert len(out["dirs"]) == 2
    totals = out["rollup"]["totals"]
    assert totals["chunks"] == 8 and totals["checkpoint_saves"] == 4
    assert len(out["host_digests"]) == 2
