"""The harness finds every cell, configuration, family and metric by name,
from files alone, and a later addition needs new files only."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from benchmark import harness

from conftest import tiny

with open(harness.BENCHMARK_JSON) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_match_benchmark_json(name):
    cell, cfg = harness.load_cell(name)
    entry = next(w for w in BENCH["workloads"] if w["name"] == name)
    assert cell["config"] == entry["config"]
    assert cell["traffic"] == entry["traffic"]
    conf = next(c for c in BENCH["configs"] if c["name"] == cell["config"])
    assert conf["file"] == f"benchmark/configs/{cell['config']}.json"
    assert conf["reduced"] == cfg["reduced"]
    fam = harness.family(cfg["family"])
    for attr in ("make_data", "make_weights", "Job", "reference", "work"):
        assert hasattr(fam, attr)
    assert set(cell["limits"]) == {"loss_gap", "grad_gap", "change_gap"}


@pytest.mark.parametrize("name", METRICS)
def test_every_metric_has_a_reader(name):
    assert callable(harness.reader(name).read)


def test_per_layer_metrics_move_a_reported_metric():
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
    assert "setup_s" in e2e


def test_additions_are_found_from_files_alone(tmp_path, monkeypatch):
    """A new cell, configuration and metric, added as files to a copy of
    the folder, run without an edit to any file that was there."""
    root = tmp_path / "benchmark"
    shutil.copytree(harness.HERE, root,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = set(os.listdir(root / "workloads"))
    cell, cfg = tiny("mf_ml20m.sync")
    cfg = dict(cfg, reduced=[])
    (root / "configs" / "mf_small.json").write_text(json.dumps(cfg))
    new_cell = {k: v for k, v in cell.items() if k != "name"}
    new_cell.update(config="mf_small", traffic="b512", local_batch=512)
    (root / "workloads" / "mf_small.b512.json").write_text(
        json.dumps(new_cell))
    (root / "metrics" / "epochs.seen.py").write_text(
        "def read(ctx):\n    return float(ctx.window['epochs'])\n")
    monkeypatch.setattr(harness, "HERE", str(root))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "mf_small.b512", "config": "mf_small",
                               "traffic": "b512", "chips": 1, "why": "test"})
    bench["end_to_end"].append({"name": "epochs.seen", "unit": "epochs",
                                "better": "higher", "bound": 0.1,
                                "source": "host_clock",
                                "workloads": ["mf_small.b512"]})
    found, fcfg = harness.load_cell("mf_small.b512")
    assert found["local_batch"] == 512 and fcfg["num_users"] == 500
    result, _ = harness.run(found, fcfg, 3, 0.2, False, "cpu", 0.0,
                            bench=bench)
    assert set(result["metrics"]) == {"examples_per_s", "setup_s",
                                      "epochs.seen"}
    assert result["metrics"]["epochs.seen"]["unit"] == "epochs"
    assert result["correct"]
    assert set(os.listdir(root / "workloads")) == before | {
        "mf_small.b512.json"}
