"""The port's step-fenced serving fleet and delta-aware read plane against
the JAX package's: the oracle of ``tests/test_serve_fleet.py``, case for
case, each case run against both packages (``_serve_pkgs``).

* ``DeltaView``: overlay lookups agree with patching a copy;
* the delta-aware ``SnapshotWatcher``: incremental swaps (one delta and a
  multi-delta catch-up), no chain through a ``*.corrupt`` base, chain
  rejections not pinned in the per-inode cache, the poll-loop
  FileNotFoundError race skipped;
* ``StepFence``: quorum advance, forward monotonicity, epoch-bumped
  rollback, the reader-side clamp;
* ``FleetReader`` / ``ServingFleet``: readers swap only to the fence, a
  restarted reader never serves below it, a quarantine rolls the fleet
  back together, the warm-row cache changes no answer.

Across the packages: the same fleet schedule run by each leaves the same
fence, readiness and shadow-gate files. End to end: the port's MF trainer
on the CPU publishes a delta chain through the async writer while a
3-reader ``ServingFleet`` answers; once it converges, every item's pull
equals ``ParamStore.table`` at the fenced step, bit for bit.
"""


import json
import os
import threading
import time

import numpy as np
import pytest
import torch

from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.obs.registry import Recorder
from fps_tpu_torch.obs.sinks import MemorySink
from fps_tpu_torch.serve import (
    DeltaView,
    FleetReader,
    ServableSnapshot,
    ServingFleet,
    SnapshotRejected,
    SnapshotWatcher,
    StepFence,
    liveness_check,
    tiering_hot_ids,
)
from fps_tpu_torch.serve.shadow import ShadowGate

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



def write_full(dirpath, step, tables, *, ls=(), epoch=None):
    arrays = {f"table::{k}": np.asarray(v) for k, v in tables.items()}
    for i, leaf in enumerate(ls):
        arrays[f"ls::{i}"] = np.asarray(leaf)
    arrays["meta::ls_format"] = np.array("exported")
    if epoch is not None:
        arrays[fmt.POD_EPOCH_KEY] = np.int64(epoch)
    for k in list(arrays):
        arrays["meta::crc::" + k] = np.uint32(fmt.array_crc32(arrays[k]))
    os.makedirs(dirpath, exist_ok=True)
    np.savez(fmt.snapshot_path(dirpath, step), **arrays)
    return arrays


def write_delta(dirpath, step, base, rows_by_table, *, epoch=None,
                base_step=None):
    arrays = {fmt.BASE_STEP_KEY: np.int64(
        base if base_step is None else base_step)}
    arrays["meta::ls_format"] = np.array("exported")
    if epoch is not None:
        arrays[fmt.POD_EPOCH_KEY] = np.int64(epoch)
    for name, (ids, rows) in rows_by_table.items():
        arrays[fmt.DELTA_IDS_PREFIX + f"table::{name}"] = np.asarray(
            ids, np.int64)
        arrays[fmt.DELTA_ROWS_PREFIX + f"table::{name}"] = np.asarray(
            rows)
    for k in list(arrays):
        arrays["meta::crc::" + k] = np.uint32(fmt.array_crc32(arrays[k]))
    np.savez(fmt.delta_path(dirpath, step, base), **arrays)
    return arrays


def chain_dir(tmp_path, *, steps=4, nrows=64, dim=3, seed=0):
    """full@1 + deltas 2..steps; returns (dir, expected final table)."""
    d = str(tmp_path)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(nrows, dim)).astype(np.float32)
    write_full(d, 1, {"w": table})
    cur = table.copy()
    for step in range(2, steps + 1):
        ids = np.unique(rng.integers(0, nrows, 6))
        rows = (cur[ids] + step).astype(np.float32)
        cur[ids] = rows
        write_delta(d, step, step - 1, {"w": (ids, rows)})
    return d, cur


# ---------------------------------------------------------------------------
# DeltaView.
# ---------------------------------------------------------------------------

def test_delta_view_lookup_matches_materialized():
    rng = np.random.default_rng(0)
    base = rng.normal(size=(32, 4)).astype(np.float32)
    ids = np.array([2, 7, 30], np.int64)
    rows = rng.normal(size=(3, 4)).astype(np.float32)
    v = DeltaView(base, ids, rows)
    mat = base.copy()
    mat[ids] = rows
    np.testing.assert_array_equal(np.asarray(v), mat)
    idx = np.array([[0, 2, 7], [30, 30, 5]])
    np.testing.assert_array_equal(v[idx], mat[idx])
    np.testing.assert_array_equal(v[3], mat[3])  # scalar index
    np.testing.assert_array_equal(v[np.array([], np.int64)],
                                  mat[np.array([], np.int64)])
    assert v.shape == base.shape and v.dtype == base.dtype
    assert len(v) == 32 and v.overlay_rows == 3


def test_delta_view_validates_overlay():
    base = np.zeros((8, 2), np.float32)
    with pytest.raises(ValueError):
        DeltaView(base, [3, 1], np.zeros((2, 2)))  # unsorted
    with pytest.raises(ValueError):
        DeltaView(base, [1, 9], np.zeros((2, 2)))  # out of range
    with pytest.raises(ValueError):
        DeltaView(base, [1], np.zeros((2, 2)))  # length mismatch


# ---------------------------------------------------------------------------
# ServableSnapshot: chains, incremental swap, warm cache.
# ---------------------------------------------------------------------------

def test_open_chain_resolves_and_with_delta_increments(tmp_path):
    d, want = chain_dir(tmp_path, steps=4)
    snap = ServableSnapshot.open_chain(d, 4)
    assert snap.step == 4 and snap.chain_len == 4
    np.testing.assert_array_equal(snap.lookup("w", np.arange(64)), want)
    # Incremental: open the base full, then extend link by link.
    s = ServableSnapshot.open(fmt.snapshot_path(d, 1))
    for step in (2, 3, 4):
        s = s.with_delta(fmt.delta_path(d, step, step - 1))
    np.testing.assert_array_equal(s.lookup("w", np.arange(64)), want)
    assert s.chain_len == 4


def test_with_delta_refuses_wrong_base_and_stale_epoch(tmp_path):
    d = str(tmp_path)
    write_full(d, 1, {"w": np.zeros((8, 2), np.float32)}, epoch=2)
    write_delta(d, 2, 1, {"w": ([0], np.ones((1, 2), np.float32))},
                epoch=2)
    write_delta(d, 3, 2, {"w": ([1], np.ones((1, 2), np.float32))},
                epoch=1)  # stale zombie
    snap = ServableSnapshot.open(fmt.snapshot_path(d, 1))
    assert snap.pod_epoch == 2
    snap2 = snap.with_delta(fmt.delta_path(d, 2, 1))
    with pytest.raises(SnapshotRejected, match="epoch"):
        snap2.with_delta(fmt.delta_path(d, 3, 2))
    with pytest.raises(SnapshotRejected, match="chains from"):
        snap.with_delta(fmt.delta_path(d, 3, 2))  # base mismatch


def test_warm_cache_admits_ranking_without_changing_answers(tmp_path):
    d, want = chain_dir(tmp_path, steps=3)
    snap = ServableSnapshot.open_chain(d, 3)
    warm = snap.warmed({"w": np.arange(10), "unknown": np.arange(4)})
    assert warm.warm_rows == 10
    np.testing.assert_array_equal(warm.lookup("w", np.arange(64)), want)
    # Admission from the adaptive tier's sidecar ranking.
    np.savez(os.path.join(d, "tiering-3.npz"),
             **{"hot::w": np.arange(5)})
    ids = tiering_hot_ids(d)
    np.testing.assert_array_equal(ids["w"], np.arange(5))
    assert tiering_hot_ids(str(tmp_path / "missing")) == {}


# ---------------------------------------------------------------------------
# Watcher: delta-aware discovery + the FNF poll race.
# ---------------------------------------------------------------------------

def test_watcher_swaps_incrementally_through_chain(tmp_path):
    d, want = chain_dir(tmp_path, steps=1)
    w = SnapshotWatcher(d)
    w.poll()
    assert w.current.step == 1
    rng = np.random.default_rng(9)
    cur = want.copy()
    for step in (2, 3):
        ids = np.unique(rng.integers(0, 64, 5))
        rows = (cur[ids] + step).astype(np.float32)
        cur[ids] = rows
        write_delta(d, step, step - 1, {"w": (ids, rows)})
        w.poll()
        assert w.current.step == step
        assert w.current.chain_len == step  # incremental, not re-opened
    np.testing.assert_array_equal(
        w.current.lookup("w", np.arange(64)), cur)
    # Multi-delta catch-up: two publishes land between polls — the swap
    # extends the served chain by BOTH links (no base re-open).
    for step in (4, 5):
        ids = np.array([step], np.int64)
        rows = (cur[ids] + step).astype(np.float32)
        cur[ids] = rows
        write_delta(d, step, step - 1, {"w": (ids, rows)})
    w.poll()
    assert w.current.step == 5 and w.current.chain_len == 5
    np.testing.assert_array_equal(
        w.current.lookup("w", np.arange(64)), cur)


def test_watcher_never_resolves_through_corrupt_base(tmp_path):
    """Satellite: a quarantined full's chained deltas are unservable —
    the reader must not resolve a chain through a ``*.corrupt`` base."""
    d, _ = chain_dir(tmp_path, steps=3)
    # Fresh watcher (no incremental state): base quarantined before the
    # first poll.
    os.replace(fmt.snapshot_path(d, 1), fmt.snapshot_path(d, 1)
               + ".corrupt")
    w = SnapshotWatcher(d)
    assert w.poll() is None and w.current is None
    # A later, independent full becomes servable; the orphaned deltas
    # never do.
    table = np.full((64, 3), 7.0, np.float32)
    write_full(d, 4, {"w": table})
    w.poll()
    assert w.current.step == 4
    np.testing.assert_array_equal(
        w.current.lookup("w", np.arange(64)), table)


def test_watcher_backward_swap_past_quarantined_chain_suffix(tmp_path):
    d, _ = chain_dir(tmp_path, steps=4)
    w = SnapshotWatcher(d)
    w.poll()
    assert w.current.step == 4
    served = w.current.lookup("w", np.arange(64)).copy()
    # The trainer quarantines deltas 3 and 4 (chain truncation): the
    # reader swaps BACKWARD to the surviving verified link.
    for s, b in ((4, 3), (3, 2)):
        p = fmt.delta_path(d, s, b)
        os.replace(p, p + ".corrupt")
    w.poll()
    assert w.current.step == 2
    assert w.swaps["backward"] == 1
    assert not np.array_equal(
        w.current.lookup("w", np.arange(64)), served)


def test_fnf_race_skipped_not_rejected(tmp_path):
    """Satellite regression: a candidate swept/renamed between the
    watcher's stat and its open must read as "gone, retry next poll" —
    no raise, no rejection verdict, and the step serves once it
    reappears."""
    d = str(tmp_path)
    w = SnapshotWatcher(d)
    # A journal-announced step whose file was already swept: candidates
    # include it, the file is gone.
    w._saved_events[5] = (fmt.snapshot_path(d, 5), 0.0)
    w.max_written_step = 5
    assert w.poll() is None
    assert w.rejected == 0 and w._rejected == {}
    # ServableSnapshot.open on a vanished path raises FileNotFoundError
    # (never a corruption verdict), with and without the CRC pass.
    with pytest.raises(FileNotFoundError):
        ServableSnapshot.open(fmt.snapshot_path(d, 5))
    with pytest.raises(FileNotFoundError):
        ServableSnapshot.open(fmt.snapshot_path(d, 5), verify=False)
    # The step re-published later serves normally.
    write_full(d, 5, {"w": np.ones((8, 2), np.float32)})
    w.poll()
    assert w.current.step == 5 and w.rejected == 0


def test_chain_rejection_not_pinned_in_cache(tmp_path):
    """A chain failure can be transient (link mid-quarantine/compaction
    when walked): it must be re-checked next poll, unlike a torn
    single-file candidate whose (inode, mtime) verdict is permanent."""
    d, want = chain_dir(tmp_path, steps=3)
    # Temporarily break the chain: move the mid link aside.
    link = fmt.delta_path(d, 2, 1)
    os.replace(link, link + ".hidden")
    w = SnapshotWatcher(d)
    w.poll()
    assert w.current.step == 1  # head 3 unservable, falls back
    # The head's verdict was NOT cached: restoring the link lifts it.
    os.replace(link + ".hidden", link)
    w.poll()
    assert w.current.step == 3
    np.testing.assert_array_equal(
        w.current.lookup("w", np.arange(64)), want)


# ---------------------------------------------------------------------------
# StepFence.
# ---------------------------------------------------------------------------

def test_fence_quorum_advance_and_monotonicity(tmp_path):
    d = str(tmp_path)
    f1, f2, f3 = (StepFence(d, f"r{i}") for i in range(3))
    assert f1.read() is None
    f1.ready(4)
    assert f1.advance(2) is None  # one reader ready: no quorum of 2
    f2.ready(3)
    assert f1.advance(2) == (0, 3)  # 2 readers at >= 3
    f3.ready(5)
    f1.ready(5)
    assert f2.advance(2) == (0, 5)
    # Forward-monotone: a stale advance attempt cannot regress.
    f2.ready(1)
    assert f3.advance(2) == (0, 5)
    # max_step caps at the advancing reader's own verified step.
    f1.ready(9)
    f2.ready(9)
    assert f3.advance(2, max_step=6) == (0, 6)


def test_fence_rollback_bumps_epoch(tmp_path):
    d = str(tmp_path)
    f1, f2 = StepFence(d, "a"), StepFence(d, "b")
    f1.ready(7)
    f2.ready(7)
    assert f1.advance(2) == (0, 7)
    assert f1.rollback(4) == (1, 4)
    # The lower step under the HIGHER epoch wins for every observer.
    assert f2.read() == (1, 4)
    # Within the new epoch, forward motion resumes.
    f1.ready(6)
    f2.ready(6)
    assert f2.advance(2) == (1, 6)


def test_fence_reader_clamps_regressed_file(tmp_path):
    import json

    d = str(tmp_path)
    f = StepFence(d, "a")
    f.ready(5)
    StepFence(d, "b").ready(5)
    assert f.advance(2) == (0, 5)
    # A racing stale write regresses the FILE; observers clamp to the
    # max (epoch, step) they have seen.
    with open(f.fence_path, "w", encoding="utf-8") as fh:
        json.dump({"epoch": 0, "step": 2}, fh)
    assert f.read() == (0, 5)


# ---------------------------------------------------------------------------
# FleetReader / ServingFleet.
# ---------------------------------------------------------------------------

def test_fleet_swaps_only_to_fence_and_converges(tmp_path):
    d, want = chain_dir(tmp_path, steps=3)
    fleet = ServingFleet(d, 3, quorum=2)
    for _ in range(3):
        fleet.poll()
    stats = fleet.stats()
    assert {s["step"] for s in stats} == {3}
    assert {tuple(s["fence"]) for s in stats} == {(0, 3)}
    for r in fleet.readers:
        _, got = r.server.pull("w", np.arange(64))
        np.testing.assert_array_equal(got, want)
        # Served trail is fence-monotone.
        assert all(b >= a for a, b in zip(r.served_steps,
                                          r.served_steps[1:]))


def test_restarted_reader_never_serves_below_fence(tmp_path):
    d, want = chain_dir(tmp_path, steps=4)
    fleet = ServingFleet(d, 3, quorum=2)
    for _ in range(3):
        fleet.poll()
    fence = fleet.readers[0].fence.read()
    assert fence == (0, 4)
    # Reader killed mid-swap: a fresh instance with the same id must
    # boot on the fence, not on whatever it last had mapped.
    nr = FleetReader(d, "r1", quorum=2)
    assert nr.server._snap is None  # serves NOTHING until fence-able
    nr.poll()
    assert nr.server._snap is not None
    assert nr.server._snap.step >= fence[1]
    assert nr.served_steps[0] >= fence[1]


def test_fleet_quarantine_rolls_back_coordinated(tmp_path):
    d, _ = chain_dir(tmp_path, steps=4)
    fleet = ServingFleet(d, 3, quorum=2)
    for _ in range(3):
        fleet.poll()
    assert {s["step"] for s in fleet.stats()} == {4}
    # The trainer quarantines the head links: chain truncation.
    for s, b in ((4, 3), (3, 2)):
        p = fmt.delta_path(d, s, b)
        os.replace(p, p + ".corrupt")
    for _ in range(4):
        fleet.poll()
    stats = fleet.stats()
    assert {s["step"] for s in stats} == {2}
    fence = fleet.readers[0].fence.read()
    assert fence[0] >= 1 and fence[1] == 2  # epoch-bumped rollback
    for r in fleet.readers:
        _, got = r.server.pull("w", [0, 1])
        assert np.all(np.isfinite(got))


def test_fleet_warm_cache_from_ranking(tmp_path):
    d, want = chain_dir(tmp_path, steps=2)
    np.savez(os.path.join(d, "tiering-2.npz"), **{"hot::w": np.arange(8)})
    fleet = ServingFleet(d, 2, quorum=1, warm_from="tiering")
    for _ in range(2):
        fleet.poll()
    stats = fleet.stats()
    assert all(s["warm_rows"] == 8 for s in stats)
    for r in fleet.readers:
        _, got = r.server.pull("w", np.arange(64))
        np.testing.assert_array_equal(got, want)


def test_fence_step_metric_emitted(tmp_path):
    d, _ = chain_dir(tmp_path, steps=2)
    sink = MemorySink()
    rec = Recorder(sinks=[sink])
    reader = FleetReader(d, "r0", quorum=1, recorder=rec)
    reader.poll()
    vals = [r for r in sink.records
            if r.get("kind") == "metric"
            and r.get("name") == "serve.fence_step"]
    assert vals and vals[-1]["value"] == 2.0


def test_watcher_verify_false_broken_chain_no_raise(tmp_path):
    """poll() is documented never to raise on bad candidates — a broken
    chain (base swept with no *.corrupt marker) under verify=False must
    read as unservable, not as an escaped ChainError."""
    d, _ = chain_dir(tmp_path, steps=3)
    os.remove(fmt.snapshot_path(d, 1))
    w = SnapshotWatcher(d, verify=False)
    assert w.poll() is None and w.current is None
    wv = SnapshotWatcher(d)  # verify=True takes the rejection path
    assert wv.poll() is None and wv.current is None


def test_fence_ready_write_is_idempotent_per_step(tmp_path):
    d = str(tmp_path)
    f = StepFence(d, "a")
    f.ready(3)
    path = f._ready_path("a")
    ino = os.stat(path).st_ino
    f.ready(3)  # unchanged: no rewrite (no fsync churn per poll tick)
    assert os.stat(path).st_ino == ino
    f.ready(4)
    assert os.stat(path).st_ino != ino
    assert f.ready_steps() == {"a": 4}


def test_fence_read_repairs_regressed_file(tmp_path):
    import json

    d = str(tmp_path)
    f1, f2 = StepFence(d, "a"), StepFence(d, "b")
    f1.ready(7)
    f2.ready(7)
    assert f1.advance(2) == (0, 7)
    assert f1.rollback(4) == (1, 4)
    # A racing advance clobbers the rollback (last-writer-wins file).
    with open(f1.fence_path, "w", encoding="utf-8") as fh:
        json.dump({"epoch": 0, "step": 7}, fh)
    # The reader that observed the bump REPAIRS the file on read, so
    # peers that never saw (1, 4) converge to it instead of serving 7.
    assert f1.read() == (1, 4)
    assert StepFence(d, "c").read() == (1, 4)


def test_fleet_rollback_survives_clobbered_fence(tmp_path):
    """A forward advance racing the quarantine rollback may clobber the
    epoch bump in the fence FILE; the rollback is evidence-based and
    re-asserted every poll, so the fleet must still converge on the
    surviving step under a bumped epoch."""
    import json

    d, _ = chain_dir(tmp_path, steps=4)
    fleet = ServingFleet(d, 3, quorum=2)
    for _ in range(3):
        fleet.poll()
    assert {s["step"] for s in fleet.stats()} == {4}
    for s, b in ((4, 3), (3, 2)):
        p = fmt.delta_path(d, s, b)
        os.replace(p, p + ".corrupt")
    fleet.readers[0].poll()  # observes quarantine, proposes rollback
    # Simulate the racing writer: regress the fence file to the
    # quarantined step under the OLD epoch.
    with open(fleet.readers[0].fence.fence_path, "w",
              encoding="utf-8") as fh:
        json.dump({"epoch": 0, "step": 4}, fh)
    for _ in range(4):
        fleet.poll()
    stats = fleet.stats()
    assert {s["step"] for s in stats} == {2}
    fence = fleet.readers[2].fence.read()
    assert fence[0] >= 1 and fence[1] == 2


def test_incremental_swap_refuses_stale_base(tmp_path):
    """Quarantine -> rollback-replay re-publishes the served step with
    DIFFERENT content, then a delta chains on the NEW file. The
    incremental paths must detect that the served snapshot's mapped
    file is no longer the on-disk publication (src_id identity) and
    re-open the chain instead of overlaying the delta on stale maps."""
    d = str(tmp_path)
    old = np.zeros((16, 2), np.float32)
    write_full(d, 1, {"w": old})
    w = SnapshotWatcher(d)
    w.poll()
    assert w.current.step == 1
    # Atomic re-publish of step 1 with ROLLED-BACK (different) content.
    new = np.full((16, 2), 5.0, np.float32)
    import tempfile

    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    os.close(fd)
    os.remove(tmp)
    write_full(str(tmp_path / "stage"), 1, {"w": new})
    os.replace(fmt.snapshot_path(str(tmp_path / "stage"), 1),
               fmt.snapshot_path(d, 1))
    # A delta chained on the NEW step-1 file.
    ids = np.array([3], np.int64)
    rows = np.full((1, 2), 9.0, np.float32)
    write_delta(d, 2, 1, {"w": (ids, rows)})
    w.poll()
    assert w.current.step == 2
    want = new.copy()
    want[ids] = rows
    # Rows untouched by the delta must come from the RE-PUBLISHED base,
    # not the stale pre-quarantine maps.
    np.testing.assert_array_equal(
        w.current.lookup("w", np.arange(16)), want)


def test_warm_cache_reads_the_port_retierers_sidecar(tmp_path):
    """``tiering_hot_ids`` reads the sidecar the port's ``Retierer``
    writes beside the checkpoints (the newest one), and a fleet warmed
    from it admits those rows without changing an answer."""
    from fps_tpu_torch.tiering import Retierer

    d, want = chain_dir(tmp_path, steps=2)
    rt = Retierer(state_dir=d, keep=4)
    for step, ids in ((1, [1, 2]), (2, [3, 5, 8, 13])):
        rt.hot_ids = {"w": np.asarray(ids, np.int64)}
        rt._save_sidecar(step, {})
    got = tiering_hot_ids(d)
    assert list(got) == ["w"] and got["w"].tolist() == [3, 5, 8, 13]
    assert tiering_hot_ids(d, table="other") == {}
    fleet = ServingFleet(d, 2, quorum=1, warm_from="tiering")
    for _ in range(2):
        fleet.poll()
    assert all(s["warm_rows"] == 4 for s in fleet.stats())
    for r in fleet.readers:
        _, rows = r.server.pull("w", np.arange(64))
        assert rows.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# Across the packages: the same fence and gate files.
# ---------------------------------------------------------------------------

# A test parametrized on ``pkg`` directly overrides the autouse fixture:
# its names stay the port's, and it reaches the JAX package's through
# ``_serve_pkgs.counterpart``.
ACROSS = pytest.mark.parametrize("pkg", ["across"])


def _fleet_files(d):
    """Every JSON file under ``d/fleet/``, wall-clock fields dropped."""
    out = {}
    fdir = os.path.join(d, "fleet")
    for f in sorted(os.listdir(fdir)):
        with open(os.path.join(fdir, f), encoding="utf-8") as fh:
            rec = json.load(fh)
        out[f] = {k: v for k, v in rec.items() if k != "t"}
    return out


def _fleet_schedule(fleet_cls, scorer_cls, liveness, d):
    """One tenant's fleet life over a chain published a step at a time:
    a gated 3-reader fleet at quorum 2, a scorer that promotes 1-3, holds
    4 (a regression) and promotes 5; then the trainer quarantines 5's
    link and the fleet rolls back. Returns the trail of (fence, served
    steps) after each round and the liveness verdicts."""
    scores = {1: 0.5, 2: 0.6, 3: 0.7, 4: 0.1, 5: 0.8}
    rng = np.random.default_rng(0)
    table = rng.normal(size=(64, 3)).astype(np.float32)
    write_full(d, 1, {"w": table})
    scorer = scorer_cls(d, lambda snap: scores[snap.step])
    fleet = fleet_cls(d, 3, quorum=2, shadow=True)
    trail = []

    def rounds(n):
        for _ in range(n):
            scorer.poll()
            fleet.poll()
            trail.append((fleet.readers[0].fence.read(),
                          [r.server._snap.step if r.server._snap else None
                           for r in fleet.readers]))

    rounds(2)
    for step in range(2, 6):
        ids = np.unique(rng.integers(0, 64, 6))
        table[ids] += step
        write_delta(d, step, step - 1, {"w": (ids, table[ids])})
        rounds(3)
    p = fmt.delta_path(d, 5, 4)
    os.replace(p, p + ".corrupt")
    rounds(4)
    now = time.time()
    verdicts = [liveness(d, expected=["r0", "r1", "r2", "r9"], now=now),
                liveness(d, timeout_s=0.0, now=now + 1.0)]
    return trail, [{"wedged": v["wedged"], "ages": sorted(v["ages"])}
                   for v in verdicts]


@ACROSS
def test_both_packages_leave_the_same_fence_and_gate_files(tmp_path):
    """The same schedule (fence advance at quorum, the shadow gate's
    promotions and hold, a quarantine's epoch-bumped rollback, liveness)
    run by each package in its own directory leaves the same fence,
    readiness, heartbeat and gate files, and each package reads the
    other's."""
    from fps_tpu_torch.serve.shadow import ShadowScorer

    runs = {}
    for name, resolve in (("fps_tpu_torch", lambda x: x),
                          ("fps_tpu", _serve_pkgs.counterpart)):
        d = str(tmp_path / name)
        runs[name] = (d, _fleet_schedule(resolve(ServingFleet),
                                         resolve(ShadowScorer),
                                         resolve(liveness_check), d))
    (td, trun), (jd, jrun) = runs["fps_tpu_torch"], runs["fps_tpu"]
    assert trun == jrun
    trail, verdicts = trun
    assert trail[1] == ((0, 1), [1, 1, 1])
    assert trail[10] == ((0, 3), [3, 3, 3])  # 4 held: the fence stays
    assert trail[13] == ((0, 5), [5, 5, 5])  # 5 promoted past the hold
    # 5 quarantined: back to 4 (under the approved 5) at a bumped epoch.
    assert trail[-1] == ((1, 4), [4, 4, 4])
    assert verdicts == [{"wedged": ["r9"], "ages": ["r0", "r1", "r2", "r9"]},
                        {"wedged": ["r0", "r1", "r2"],
                         "ages": ["r0", "r1", "r2"]}]
    assert _fleet_files(td) == _fleet_files(jd)
    assert sorted(_fleet_files(td)) == [
        "heartbeat_r0.json", "heartbeat_r1.json", "heartbeat_r2.json",
        "ready_r0.json", "ready_r1.json", "ready_r2.json",
        "serve_fence.json", "shadow_gate.json"]
    # Each package reads the other's files.
    for d, fence_cls, gate_cls in (
            (td, _serve_pkgs.counterpart(StepFence),
             _serve_pkgs.counterpart(ShadowGate)),
            (jd, StepFence, ShadowGate)):
        assert fence_cls(d, "reader").read() == trail[-1][0]
        assert gate_cls(d).approved_step() == 5


@ACROSS
def test_a_fleet_of_both_packages_converges_on_one_fence(tmp_path):
    """Readers of either package share one fleet directory: the JAX
    package's r0 and the port's r1 and r2 advance one fence and serve the
    same rows."""
    d, want = chain_dir(tmp_path, steps=4)
    readers = [_serve_pkgs.counterpart(FleetReader)(d, "r0", quorum=2),
               FleetReader(d, "r1", quorum=2), FleetReader(d, "r2",
                                                          quorum=2)]
    for _ in range(3):
        for r in readers:
            r.poll()
    assert {r.fence.read() for r in readers} == {(0, 4)}
    for r in readers:
        step, got = r.server.pull("w", np.arange(64))
        assert step == 4
        assert got.tobytes() == want.tobytes()


# ---------------------------------------------------------------------------
# End to end: the port's trainer publishes, a 3-reader fleet answers.
# ---------------------------------------------------------------------------

@ACROSS
def test_mf_trainer_publishes_while_a_fleet_answers(tmp_path):
    """The port's MF trainer on the CPU publishes a delta chain through
    ``AsyncCheckpointer`` at every chunk while a 3-reader ``ServingFleet``
    (quorum 2) polls on threads and a client pulls from every reader.
    Every answer's step is a published one and its rows equal the table
    at that step; once the fleet converges on the last step, every item
    row equals ``ParamStore.table`` read back and every user row the
    exported local state, bit for bit."""
    from fps_tpu_torch import MFConfig, online_mf
    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer, DeltaPolicy
    from fps_tpu_torch.core.ingest import multi_epoch_chunks
    from fps_tpu_torch.core.store import id_to_phys, rows_per_shard
    from fps_tpu_torch.parallel.mesh import make_ps_mesh
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    NU, NI, S = 96, 40, 4
    ITEM = "item_factors"
    trainer, store = online_mf(make_ps_mesh(S, 1, device="cpu"), MFConfig(
        num_users=NU, num_items=NI, rank=4, learning_rate=0.1))
    tables, local = trainer.init_state(0)
    data = synthetic_ratings(NU, NI, 3000, seed=0)
    chunks = list(multi_epoch_chunks(data, 2, num_workers=S, local_batch=8,
                                     steps_per_chunk=2, route_key="user",
                                     seed=5))[:12]
    d = str(tmp_path / "ckpt")
    phys = id_to_phys(np.arange(NI), S, rows_per_shard(NI, S))

    def item_rows():
        return store.table(ITEM).numpy()[phys]

    at_step = {}

    def on_chunk(j, _metrics):
        at_step[j + 1] = item_rows().copy()

    fleet = ServingFleet(d, 3, quorum=2)
    stop = threading.Event()
    answers, errors = [], []

    def client():
        ids = np.arange(NI)
        while not stop.is_set():
            for r in fleet.readers:
                try:
                    answers.append(r.server.pull(ITEM, ids))
                except Exception as e:  # noqa: BLE001 — sorted below
                    if type(e).__name__ != "NoSnapshotError":
                        errors.append(repr(e))
            time.sleep(0.002)

    ckpt = AsyncCheckpointer(d, keep=64, delta=DeltaPolicy(full_every=4))
    thread = threading.Thread(target=client, daemon=True)
    fleet.start(interval_s=0.005)
    thread.start()
    try:
        tables, local, _ = trainer.fit_stream(
            tables, local, chunks, 0, checkpointer=ckpt,
            checkpoint_every=1, on_chunk=on_chunk)
        last = len(chunks)
        deadline = time.monotonic() + 30.0
        while {r.server._snap.step if r.server._snap else None
               for r in fleet.readers} != {last}:
            assert time.monotonic() < deadline, fleet.stats()
            time.sleep(0.01)
    finally:
        stop.set()
        thread.join(timeout=30)
        fleet.stop()
    assert not thread.is_alive()
    assert not errors, errors[:3]
    assert ckpt.delta_publishes >= 4 and ckpt.full_publishes >= 2
    assert answers
    for step, values in answers:
        assert step in at_step
        assert values.tobytes() == at_step[step].tobytes(), step
    users = trainer.logic.export_local_state(local.numpy())
    for r in fleet.readers:
        assert r.fence.read()[1] == last
        step, got = r.server.pull(ITEM, np.arange(NI))
        assert step == last and got.tobytes() == item_rows().tobytes()
        ls = r.server.snapshot.local_state[0]
        assert np.asarray(ls).tobytes() == np.asarray(users).tobytes()
        assert all(b >= a for a, b in zip(r.served_steps,
                                          r.served_steps[1:]))
