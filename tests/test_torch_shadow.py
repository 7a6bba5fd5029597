"""The port's shadow serving (``fps_tpu_torch.serve.shadow``) against the
JAX package's: the oracle of ``tests/test_shadow.py``, case for case, each
case run against both packages (``_serve_pkgs``).

* ``ShadowGate``: empty until the first approval, forward-monotone, a
  garbage record reads as unapproved;
* a gated ``FleetReader`` serves nothing before the first approval and is
  capped at the approved step;
* ``ShadowScorer``: the first candidate promotes, a regression is held
  and not re-judged, a recovery promotes past it, ``min_delta`` tolerates
  noise, and an approved snapshot that cannot be opened cannot hold the
  gate.

Across the packages: each package's scorer approves what the other's
gated reader serves, through the one gate file.
"""


import os

import numpy as np
import pytest
import torch

from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.serve import FleetReader
from fps_tpu_torch.serve.shadow import GATE_NAME, ShadowGate, ShadowScorer

import _serve_pkgs


@pytest.fixture(autouse=True, params=_serve_pkgs.PACKAGES)
def pkg(request, monkeypatch):
    """Every case runs twice: against the JAX package's serving plane,
    then against the port's (the names above, rebound by
    :func:`_serve_pkgs.rebind`)."""
    _serve_pkgs.rebind(globals(), request.param, monkeypatch)
    return request.param


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def write_full(dirpath, step, tables):
    arrays = {f"table::{k}": np.asarray(v) for k, v in tables.items()}
    arrays["meta::ls_format"] = np.array("exported")
    for k in list(arrays):
        arrays["meta::crc::" + k] = np.uint32(fmt.array_crc32(arrays[k]))
    os.makedirs(dirpath, exist_ok=True)
    np.savez(fmt.snapshot_path(dirpath, step), **arrays)


def _table(seed, nrows=16, dim=3):
    rng = np.random.default_rng(seed)
    return rng.normal(size=(nrows, dim)).astype(np.float32)


def _scorer(d, scores, **kw):
    """A scorer whose judgment is a fixed step->score lookup."""
    return ShadowScorer(d, lambda snap: scores[snap.step], **kw)


# ---------------------------------------------------------------------------
# ShadowGate


def test_gate_empty_then_forward_monotone(tmp_path):
    gate = ShadowGate(str(tmp_path))
    assert gate.approved_step() is None
    gate.approve(3, score_new=0.9)
    assert gate.approved_step() == 3
    # Stale approvals no-op; newer ones advance.
    gate.approve(2)
    assert gate.approved_step() == 3
    gate.approve(5)
    assert gate.approved_step() == 5
    rec = gate.read_record()
    assert rec["approved_step"] == 5
    assert os.path.basename(gate.path) == GATE_NAME


def test_gate_garbage_record_reads_as_unapproved(tmp_path):
    gate = ShadowGate(str(tmp_path))
    os.makedirs(gate.dir, exist_ok=True)
    with open(gate.path, "w", encoding="utf-8") as f:
        f.write('{"not_a_step": 1}')
    assert gate.approved_step() is None


# ---------------------------------------------------------------------------
# Gated FleetReader


def test_gated_reader_serves_nothing_before_first_approval(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    reader = FleetReader(d, "r0", quorum=1, shadow=True)
    for _ in range(3):
        reader.poll()
    # Verified and candidate-ready, but the gate has never approved.
    assert reader.server._snap is None
    assert reader.fence.read() is None
    ShadowGate(d).approve(1)
    reader.poll()
    assert reader.server._snap.step == 1


def test_gated_reader_capped_at_approved_step(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    write_full(d, 2, {"w": _table(1)})
    ShadowGate(d).approve(1)
    reader = FleetReader(d, "r0", quorum=1, shadow=True)
    for _ in range(3):
        reader.poll()
    # The unapproved step 2 is published and verified, yet invisible:
    # readiness and the fence both stop at the approved step.
    assert reader.server._snap.step == 1
    assert reader.fence.read() == (0, 1)
    ShadowGate(d).approve(2)
    for _ in range(2):
        reader.poll()
    assert reader.server._snap.step == 2


# ---------------------------------------------------------------------------
# ShadowScorer


def test_scorer_bootstrap_promotes_first_candidate(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    scorer = _scorer(d, {1: 1.0})
    rec = scorer.poll()
    assert rec["decision"] == "promoted"
    assert rec["prev_approved"] is None
    assert rec["score_old"] is None
    assert scorer.gate.approved_step() == 1
    assert scorer.promotions == 1
    # Nothing new: the next poll judges nothing.
    assert scorer.poll() is None


def test_scorer_holds_regression_and_skips_rejudging_it(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    scorer = _scorer(d, {1: 1.0, 2: 0.5})
    assert scorer.poll()["decision"] == "promoted"
    write_full(d, 2, {"w": _table(1)})
    rec = scorer.poll()
    assert rec == {"step": 2, "prev_approved": 1, "score_new": 0.5,
                   "score_old": 1.0, "decision": "held"}
    assert scorer.gate.approved_step() == 1
    assert scorer.holds == 1
    # The held step is judged once; only a NEWER candidate re-opens
    # the question.
    assert scorer.poll() is None
    assert scorer.holds == 1


def test_recovery_promotes_past_held_step(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    scorer = _scorer(d, {1: 1.0, 2: 0.5, 3: 1.1})
    scorer.poll()
    write_full(d, 2, {"w": _table(1)})
    assert scorer.poll()["decision"] == "held"
    write_full(d, 3, {"w": _table(2)})
    rec = scorer.poll()
    assert rec["decision"] == "promoted"
    assert rec["step"] == 3
    # The gate jumps 1 -> 3: the regressed step 2 is never served.
    assert scorer.gate.approved_step() == 3
    assert scorer.promotions == 2


def test_min_delta_tolerates_small_noise(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    # Default bar (-0.02): candidate may be slightly worse and still
    # promote — freshness is worth a little noise.
    scorer = _scorer(d, {1: 1.0, 2: 0.99})
    scorer.poll()
    write_full(d, 2, {"w": _table(1)})
    assert scorer.poll()["decision"] == "promoted"
    assert scorer.gate.approved_step() == 2


def test_unopenable_approved_snapshot_cannot_hold_the_gate(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": _table(0)})
    scorer = _scorer(d, {1: 1.0, 2: 0.1})
    scorer.poll()
    # The approved snapshot vanishes (pruned/quarantined): a regressed
    # candidate must still promote — there is nothing left to compare
    # against, and an unservable approval must not wedge the tenant.
    os.remove(fmt.snapshot_path(d, 1))
    write_full(d, 2, {"w": _table(1)})
    rec = scorer.poll()
    assert rec["decision"] == "promoted"
    assert rec["score_old"] is None
    assert scorer.gate.approved_step() == 2


# ---------------------------------------------------------------------------
# Across the packages: one gate file.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["across"])  # overrides the fixture
def test_each_packages_scorer_gates_the_others_reader(tmp_path):
    """The JAX package's scorer approves what the port's gated reader
    serves and the reverse, through the one ``shadow_gate.json``; both
    packages' gates read the same approved step."""
    counterpart = _serve_pkgs.counterpart
    scores = {1: 0.5, 2: 0.1, 3: 0.9}
    for scorer_cls, reader_cls in ((counterpart(ShadowScorer), FleetReader),
                                   (ShadowScorer, counterpart(FleetReader))):
        d = str(tmp_path / scorer_cls.__module__)
        scorer = scorer_cls(d, lambda snap: scores[snap.step])
        reader = reader_cls(d, "r0", quorum=1, shadow=True)
        for step in (1, 2, 3):
            write_full(d, step, {"w": _table(step)})
            decision = scorer.poll()
            reader.poll()
            reader.poll()
            want = {1: 1, 2: 1, 3: 3}[step]
            assert decision["decision"] == ("held" if step == 2
                                            else "promoted")
            assert reader.server.snapshot.step == want
            assert (ShadowGate(d).approved_step()
                    == counterpart(ShadowGate)(d).approved_step() == want)
