"""The plain reference against the program on the CPU at tiny sizes; the
control and the planted faults against the limits.

Each cell's run must come out correct; the reference computed one
precision lower (bfloat16) and the reference with half of every batch left
out must fail the cell's committed limits; and a run whose timed path is
broken underneath (a step that leaves the state unchanged, half of every
batch left out, a token altered where the batch is made) must come out not
correct.
"""

from __future__ import annotations

import contextlib

import pytest
import torch

import fps_tpu_torch.core.driver as driver
from benchmark import checks, control, harness
from fps_tpu_torch.core.device_ingest import DeviceEpochPlan
from fps_tpu_torch.models.word2vec import Word2VecDevicePlan

from conftest import TINY_CELL, tiny

CELLS = sorted(TINY_CELL)


@pytest.mark.parametrize("name", CELLS)
def test_program_follows_the_reference(name):
    cell, cfg = tiny(name)
    result, compared = harness.run(cell, cfg, 2**31 + 101, 0.2, False,
                                   "cpu", 0.0)
    assert result["correct"], compared
    for c in compared.values():
        assert c["value"] < c["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_and_faults_fail_the_limits(name):
    cell, cfg = tiny(name)
    r = control.seed_readings(cell, cfg, 2**31 + 202, "cpu",
                              controls=("bf16",))
    assert checks.judge(r["program"], cell["limits"])
    for bad in ("bf16", "half", "frozen"):
        assert not checks.judge(r[bad], cell["limits"]), (bad, r[bad])


def _frozen_step(self, tables, snapshot, states, batches, keys, t, outs,
                 in_flight, tier=None, track=None):
    """A step that computes and returns the state it was given."""
    _, _, _, out, _ = self._compute_step(tables, snapshot, states, batches,
                                         keys, tier, track)
    outs.append(driver._sum_metrics(self.mesh, out))
    return tables, states


def _half(batch: dict) -> dict:
    b = dict(batch)
    if "weight" in b:
        w = b["weight"].clone()
        w[:, w.shape[1] // 2:] = 0.0
        b["weight"] = w
    else:
        L = b["half"].shape[1]
        b["valid_len"] = torch.clamp(b["valid_len"], max=L // 2)
    return b


def _altered(batch: dict) -> dict:
    b = dict(batch)
    for k in ("item", "context", "block"):
        if k in b:
            b[k] = torch.roll(b[k], 1, dims=1)
    return b


@contextlib.contextmanager
def _planted(fault: str, monkeypatch):
    if fault == "frozen":
        monkeypatch.setattr(driver.Trainer, "_step", _frozen_step)
    else:
        edit = _half if fault == "half" else _altered
        for cls in (DeviceEpochPlan, Word2VecDevicePlan):
            orig = cls.call_batches

            def call_batches(self, args, start, steps, orig=orig):
                return edit(orig(self, args, start, steps))

            monkeypatch.setattr(cls, "call_batches", call_batches)
    yield


@pytest.mark.parametrize("fault", ["frozen", "half", "altered"])
@pytest.mark.parametrize("name", CELLS)
def test_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    cell, cfg = tiny(name)
    with _planted(fault, monkeypatch):
        result, compared = harness.run(cell, cfg, 2**31 + 303, 0.2, False,
                                       "cpu", 0.0)
    assert result["correct"] is False, compared
