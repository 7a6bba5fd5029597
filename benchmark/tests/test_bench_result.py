"""The shape of a run's result, and the runs that must print none."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

from benchmark import checks, harness, run

from conftest import tiny

REPO = os.path.dirname(harness.HERE)
KEYS = ["correct", "attempted", "failed", "metrics", "device"]


def test_untraced_result_shape():
    cell, cfg = tiny("mf_ml20m.sync")
    result, compared = harness.run(cell, cfg, 2**31 + 77, 0.3, False, "cpu",
                                   0.0)
    assert list(result)[:5] == KEYS
    assert result["correct"] is True
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(result["metrics"]) == {"examples_per_s", "setup_s"}
    for m in result["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert result["metrics"]["examples_per_s"]["unit"] == "examples/s"
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert list(compared) == checks.compared(cell["limits"])
    for c in compared.values():
        assert set(c) == {"value", "limit"}


def test_traced_result_on_the_cpu_holds_no_device_number():
    cell, cfg = tiny("w2v_text8.block")
    result, _ = harness.run(cell, cfg, 5, 0.2, True, "cpu", 0.0)
    # No device activity on the CPU: no device metric, busy time 0.
    assert result["metrics"] == {}
    assert result["device"]["busy_s"] == 0.0
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_no_card_no_result():
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mf_ml20m.hot2048", "--seed", str(2**31 + 5), "--seconds", "1",
         "--trace", "0"], cwd=REPO, capture_output=True, text=True,
        env=dict(os.environ, CUDA_VISIBLE_DEVICES=""), timeout=300)
    assert proc.returncode == 2
    assert proc.stdout == ""
    assert "no CUDA card" in proc.stderr


def test_forbidden_modules_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "fps_tpu_torch_extra", object())
    assert "fps_tpu" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "fps_tpu.core", object())
    assert run.forbidden_modules() == ["fps_tpu"]


@pytest.mark.cuda
def test_card_run_prints_one_result_line(cuda_card, tmp_path):
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mf_ml20m.hot2048", "--seed", str(2**31 + 9), "--seconds", "1",
         "--trace", "1"], cwd=REPO, capture_output=True, text=True,
        timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    line = json.loads(proc.stdout.strip().splitlines()[-1])
    assert list(line)[:5] == KEYS and list(line)[-1] == "checks"
    assert line["correct"] is True
    assert line["device"]["busy_s"] > 0


@pytest.mark.cuda
def test_card_run_without_the_program_fails(cuda_card, tmp_path):
    """A checkout of only BENCHMARK.json and the benchmark's folder."""
    import shutil

    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(harness.HERE, tmp_path / "benchmark")
    proc = subprocess.run(
        [sys.executable, "-m", "benchmark.run", "--workload",
         "mf_ml20m.hot2048", "--seed", "1", "--seconds", "1", "--trace",
         "0"], cwd=tmp_path, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert proc.stdout == ""
    assert "fps_tpu_torch" in proc.stderr
