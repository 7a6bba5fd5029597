"""The least bytes and FLOPs against hand counts at tiny shapes, and the
readers' arithmetic."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from benchmark import harness
from benchmark.reference import mf, w2v


def test_mf_work_by_hand():
    # 4 ratings; one step of 8 holds them all (grid 2 x 2).
    data = {"user": torch.tensor([0, 0, 1, 2], dtype=torch.int32),
            "item": torch.tensor([1, 1, 2, 0], dtype=torch.int32),
            "rating": torch.ones(4)}
    cfg = {"num_ratings": 4, "rank": 2}
    w = mf.work(data, cfg, {"local_batch": 8}, seed=3, epoch=0, steps=1)
    # n = 4, unique items 3, unique users 3, D = 2, 4 bytes each.
    assert w["pull_bytes"] == 4 * 4 + 3 * 2 * 4 + 4 * 2 * 4
    assert w["push_bytes"] == 4 * 4 + 4 * 2 * 4 + 2 * 3 * 2 * 4
    assert w["step_bytes"] == 3 * 4 * 4 + 2 * (3 + 3) * 2 * 4
    assert w["step_flops"] == 6 * 2 * 4


def _corpus(mode: str) -> w2v.Corpus:
    toks = np.array([0, 1] * 20 + [0], np.int32)  # 41 tokens, 2 words
    data = {"tokens": torch.from_numpy(toks), "tokens_host": toks,
            "counts_host": np.bincount(toks, minlength=2).astype(np.int64)}
    # subsample_t = 10 keeps every token.
    cfg = {"window": 1, "negatives": 1, "dim": 2, "subsample_t": 10.0,
           "neg_power": 0.75, "learning_rate": 0.025}
    cell = {"mode": mode, "block_len": 4, "neg_group_size": 1}
    return w2v.Corpus(data, cfg, cell, plan_seed=7)


def test_w2v_pairs_work_by_hand():
    w = w2v.work(_corpus("pairs"), 0, [11])
    # 8 live pairs (both orientations of 4 adjacencies), K = 1: 8 IN ids,
    # 16 OUT ids, 2 unique rows in each table, D = 2.
    pull_in = 8 * 4 + 8 * 2 * 4 + 2 * 2 * 4
    pull_out = 16 * 4 + 16 * 2 * 4 + 2 * 2 * 4
    assert w["pull_bytes"] == pull_in + pull_out
    assert w["push_bytes"] == pull_in + 2 * 2 * 4 + pull_out + 2 * 2 * 4
    assert w["step_bytes"] == 5 * 4 + 2 * (2 + 2) * 2 * 4
    assert w["step_flops"] == 6 * 2 * (1 + 1) * 8


def test_w2v_block_work_by_hand():
    w = w2v.work(_corpus("block"), 0, [11])
    # 5 block positions, instances 1, 2, 2, 2, 1; 5 groups of one
    # negative: 5 IN ids, 10 OUT ids, 2 unique rows in each table.
    pull_in = 5 * 4 + 5 * 2 * 4 + 2 * 2 * 4
    pull_out = 10 * 4 + 10 * 2 * 4 + 2 * 2 * 4
    assert w["pull_bytes"] == pull_in + pull_out
    assert w["push_bytes"] == pull_in + 2 * 2 * 4 + pull_out + 2 * 2 * 4
    assert w["step_bytes"] == 5 * 4 + 2 * (2 + 2) * 2 * 4
    assert w["step_flops"] == 6 * 2 * 8 + 6 * 2 * 1 * 5


def _ctx(**kw):
    peaks = {"fp32_flops_per_s": 67e12, "hbm_bytes_per_s": 3.35e12}
    base = dict(cell={}, config={}, peaks=peaks, setup_s=1.0,
                window={"seconds": 1.0, "steps": 10, "epochs": 1,
                        "examples": 100})
    base.update(kw)
    return harness.Context(**base)


def test_readers_by_hand():
    tr = {"device_ops": 40, "busy_s": 0.25, "window_s": 1.0,
          "by_range": {"fps.pull": 1e-6, "fps.push": 2e-6,
                       "fps.hot_accumulate": 2e-6, "fps.compute": 8e-6}}
    work = {"steps": 2, "pull_bytes": 3.35e6, "push_bytes": 3.35e6,
            "step_bytes": 1.0, "step_flops": 2 * 67e9}
    ctx = _ctx(trace=tr, work=work)
    r = {m: harness.reader(m).read(ctx) for m in (
        "launches_per_step", "pull_roofline", "push_roofline",
        "compute_us_per_step", "device_idle_share", "step_mfu",
        "examples_per_s", "setup_s")}
    assert r["launches_per_step"] == 20
    assert r["pull_roofline"] == pytest.approx(100.0)
    assert r["push_roofline"] == pytest.approx(25.0)
    assert r["compute_us_per_step"] == pytest.approx(4.0)
    assert r["device_idle_share"] == pytest.approx(75.0)
    # 67 GFLOP a step at 67 TFLOP/s is 1 ms of a 100 ms step.
    assert r["step_mfu"] == pytest.approx(1.0)
    assert ctx.notes["step_mfu_bound"] == "flops"
    assert r["examples_per_s"] == 100 and r["setup_s"] == 1.0


def test_readers_without_a_trace_read_nothing():
    ctx = _ctx()
    for m in ("launches_per_step", "pull_roofline", "push_roofline",
              "compute_us_per_step", "device_idle_share", "step_mfu"):
        assert harness.reader(m).read(ctx) is None
