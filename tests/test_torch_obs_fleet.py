"""Fleet rollups and SLO burn of the port (``fps_tpu_torch.obs.fleet``)
against the JAX package's (``fps_tpu.obs.fleet``), over the same files.

The aggregator is a pure JSONL consumer, so both packages read the same
directories: synthetic per-host trails (the shape of
``tests/test_fleet.py``'s, with restarts, freshness and tier counters)
and the port's own ``open_run`` directories of two tiered MF ranks' runs.
``host_series``, ``rollup`` (at several window widths),
``evaluate_slos`` (default and custom SLOs) and ``fleet_digest`` give the
same results, and ``tools/obs_report.py --fleet`` reads the port's dirs.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest
import torch

from fps_tpu.obs import fleet as jfleet
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import MFConfig, make_ps_mesh, obs as tobs, online_mf
from fps_tpu_torch.core.ingest import epoch_chunks
from fps_tpu_torch.obs import fleet as tfleet

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _metric(t, name, value, mtype="counter", **labels):
    rec = {"kind": "metric", "t": t, "name": name, "mtype": mtype,
           "value": value}
    if labels:
        rec["labels"] = labels
    return rec


def _write(path, records):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w", encoding="utf-8") as f:
        for r in records:
            f.write(json.dumps(r) + "\n")


def _synthetic(tmp_path, name, *, t0, chunks=4, restart_at=None):
    d = str(tmp_path / name)
    events = []
    journal = [{"kind": "event", "t": t0, "event": "run_start",
                "run_id": name + "-run"}]
    for i in range(chunks):
        t = t0 + 10.0 * i
        events += [
            _metric(t, "driver.chunks", 1),
            _metric(t, "driver.examples", 1000),
            _metric(t, "hot_tier.hot_rows", 90, table="item"),
            _metric(t, "hot_tier.pulled_rows", 100, table="item"),
            _metric(t, "cold_route.compact_chunks", 1),
            _metric(t, "checkpoint.saves", 1),
            _metric(t, "serve.write_to_servable_s", 2.0 + i, mtype="gauge"),
        ]
        if i == chunks - 1:
            events.append(_metric(t, "cold_route.overflow_chunks", 1,
                                  table="item"))
    if restart_at is not None:
        journal.append({"kind": "event", "t": t0 + restart_at,
                        "event": "supervisor_restart", "attempt": 1})
    _write(os.path.join(d, "events-p0.jsonl"), events)
    _write(os.path.join(d, "journal-supervisor.jsonl"), journal)
    return d


def _port_runs(tmp_path, n=2):
    """``n`` tiered MF runs of the port, each written by ``open_run`` into
    its own directory (a fleet of one-host members)."""
    data = jdatasets.synthetic_ratings(60, 40, 1200, rank=3, seed=3)
    dirs = []
    for h in range(n):
        trainer, store = online_mf(make_ps_mesh(2, 1, device="cpu"),
                                   MFConfig(num_users=60, num_items=40,
                                            rank=4))
        store.specs["item_factors"] = dataclasses.replace(
            store.specs["item_factors"], hot_tier=8)
        trainer.config = dataclasses.replace(trainer.config,
                                             hot_sync_every=2)
        d = str(tmp_path / f"host{h}")
        rec = tobs.open_run(d, install=False)
        trainer.recorder = rec
        tables, local = trainer.init_state(h)
        chunks = list(epoch_chunks(data, num_workers=2, local_batch=16,
                                   steps_per_chunk=4, route_key="user",
                                   seed=h))[:5]
        trainer.fit_stream(tables, local, iter(chunks), 1,
                           on_chunk=lambda i, m: None)
        rec.close()
        dirs.append(d)
    return dirs


@pytest.fixture
def fleet_dirs(tmp_path):
    return {
        "synthetic": [_synthetic(tmp_path, "a", t0=1000.0),
                      _synthetic(tmp_path, "b", t0=1005.0, chunks=6,
                                 restart_at=25.0)],
        "port": _port_runs(tmp_path),
    }


@pytest.mark.parametrize("which", ["synthetic", "port"])
def test_host_series_matches(fleet_dirs, which):
    for d in fleet_dirs[which]:
        assert tfleet.host_series(d) == jfleet.host_series(d)


@pytest.mark.parametrize("window_s", [None, 5.0, 1e-3])
@pytest.mark.parametrize("which", ["synthetic", "port"])
def test_rollup_matches(fleet_dirs, which, window_s):
    got = tfleet.rollup(fleet_dirs[which], window_s=window_s)
    want = jfleet.rollup(fleet_dirs[which], window_s=window_s)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    if which == "port":
        assert got["totals"]["chunks"] == 10
        assert got["totals"]["hot_hit_rate"] is not None


@pytest.mark.parametrize("which", ["synthetic", "port"])
def test_slo_burn_rates_match(fleet_dirs, which):
    roll = jfleet.rollup(fleet_dirs[which], num_windows=4)
    slos = {"default": (tfleet.DEFAULT_SLOS, jfleet.DEFAULT_SLOS),
            "custom": ((tfleet.SLO("tp", "examples_per_sec", ">=", 50.0,
                                   objective=0.5),),
                       (jfleet.SLO("tp", "examples_per_sec", ">=", 50.0,
                                   objective=0.5),))}
    for mine, ref in slos.values():
        got = tfleet.evaluate_slos(roll, mine)
        want = jfleet.evaluate_slos(roll, ref)
        assert json.dumps(got, sort_keys=True) == json.dumps(
            want, sort_keys=True)
    assert [s.name for s in tfleet.DEFAULT_SLOS] == [
        s.name for s in jfleet.DEFAULT_SLOS]


def test_slo_semantics():
    slo = tfleet.SLO("x", "examples_per_sec", ">=", 10.0, objective=0.5)
    roll = {"windows": [{"examples_per_sec": v} for v in (5.0, 20.0, None,
                                                         1.0)]}
    [got] = tfleet.evaluate_slos(roll, (slo,))
    [want] = jfleet.evaluate_slos(roll, (jfleet.SLO(
        "x", "examples_per_sec", ">=", 10.0, objective=0.5),))
    assert got == want
    with pytest.raises(ValueError):
        tfleet.SLO("y", "examples_per_sec", "~", 1.0)


@pytest.mark.parametrize("which", ["synthetic", "port"])
def test_fleet_digest_matches(fleet_dirs, which):
    got = tfleet.fleet_digest(fleet_dirs[which], num_windows=3)
    want = jfleet.fleet_digest(fleet_dirs[which], num_windows=3)
    assert json.dumps(got, sort_keys=True) == json.dumps(want,
                                                         sort_keys=True)
    assert got["schema"] == tfleet.FLEET_SCHEMA_VERSION


def test_the_port_fleet_module_imports_nothing_of_either_package():
    src = open(os.path.join(ROOT, "fps_tpu_torch", "obs", "fleet.py")).read()
    assert "import fps_tpu" not in src and "from fps_tpu" not in src
    # The per-tenant rollups are ported: the module's names are the
    # reference's, the tenant ones included.
    assert set(tfleet.__all__) == set(jfleet.__all__)
    assert "tenant_fleet_digest" in tfleet.__all__
    np.testing.assert_equal(tfleet.FLEET_SCHEMA_VERSION,
                            jfleet.FLEET_SCHEMA_VERSION)
