"""The trace reader on a small synthetic Chrome trace."""

from __future__ import annotations

import json

import pytest

from benchmark import trace


def _x(cat, name, ts, dur, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": 1, "tid": 1}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


TRACE = {"traceEvents": [
    _x("user_annotation", "bench.stretch", 0, 1000),
    _x("user_annotation", "bench.call", 5, 985),
    _x("user_annotation", "fps.pull", 10, 10),
    _x("user_annotation", "fps.compute", 20, 30),
    _x("user_annotation", "fps.push", 50, 40),
    _x("user_annotation", "other", 0, 1000),
    _x("cuda_runtime", "cudaLaunchKernel", 12, 1, 1),
    _x("cuda_runtime", "cudaLaunchKernel", 25, 1, 2),
    _x("cuda_runtime", "cudaMemcpyAsync", 60, 1, 3),
    _x("cuda_driver", "cuLaunchKernel", 95, 1, 4),
    _x("kernel", "k_gather", 100, 10, 1),
    _x("kernel", "k_step", 105, 25, 2),
    _x("gpu_memcpy", "Memcpy DtoD", 200, 50, 3),
    _x("kernel", "k_gather", 300, 10, 4),
    _x("kernel", "outside", 2000, 10, 5),
]}


def test_summary_of_a_synthetic_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps(TRACE))
    s = trace.summarize(trace.load(str(path)))
    assert s["window_s"] == pytest.approx(1000e-6)
    assert s["busy_s"] == pytest.approx(90e-6)  # [100,130) + 50 + 10
    assert s["device_ops"] == 4
    assert s["by_range"] == pytest.approx({
        "fps.pull": 10e-6, "fps.compute": 25e-6, "fps.push": 50e-6,
        "bench.call": 10e-6})
    assert s["device_ops_top"][0] == ["Memcpy DtoD", pytest.approx(50e-6)]
    assert s["device_ops_top"][1] == ["k_step", pytest.approx(25e-6)]
    assert s["device_ops_top"][2] == ["k_gather", pytest.approx(20e-6)]
    idle = dict(s["idle_gaps_top"])
    # Before the first op (no range open at 0), then two gaps and the tail
    # inside bench.call.
    assert idle["host"] == pytest.approx(100e-6)
    assert idle["bench.call"] == pytest.approx(70e-6 + 50e-6 + 690e-6)
    assert s["busy_s"] + sum(idle.values()) == pytest.approx(s["window_s"])


def test_a_trace_without_the_window_range_raises():
    with pytest.raises(ValueError):
        trace.summarize({"traceEvents": TRACE["traceEvents"][1:]})
