"""The port's serving plane (``fps_tpu_torch.serve``) against the JAX
package's (``fps_tpu.serve``): the oracle of ``tests/test_serve.py``, case
for case, each case run against both packages (``_serve_pkgs``), and the
answers of both over the same snapshot files held bit for bit equal.

* the snapshot contract: zero-copy maps agree with ``np.load``, the
  verifier rejects what the checkpoint layer rejects, on real
  ``Checkpointer`` output of each package too;
* ``SnapshotWatcher``: forward-monotone publication, the per-inode
  rejection cache, journal tailing through truncation and replacement, and
  the BACKWARD swap past a quarantine;
* ``ReadServer``: pull / score / top-k against numpy, the atomic hot swap
  and a swap cost independent of table size;
* the framed TCP transport, and each package's serving CLI with its
  training stack poisoned in the subprocess (``tools/serve.py`` without
  jax; ``fps_tpu_torch/examples/serve.py`` without torch, jax or
  ``fps_tpu``).
"""


import json
import os
import socket
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from fps_tpu_torch import obs
from fps_tpu_torch.core import checkpoint
from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.serve import (
    JsonlClient,
    NoSnapshotError,
    ReadServer,
    ServableSnapshot,
    SnapshotRejected,
    SnapshotWatcher,
    TcpServe,
)
from fps_tpu_torch.serve import wire
from fps_tpu_torch.serve.watcher import _JournalTail
from fps_tpu_torch.testing import chaos

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


ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def write_snapshot(dirpath, step, *, tables=None, ls=(),
                   ls_format="exported", seed=0):
    """Handcraft a snapshot in the checkpoint writer's exact npz layout
    (uncompressed members + per-array ``meta::crc`` tags). Returns the
    raw arrays for reference checks."""
    rng = np.random.default_rng(seed)
    if tables is None:
        tables = {"weights": rng.normal(size=(32, 3)).astype(np.float32),
                  "item_factors": rng.normal(size=(16, 4)).astype(
                      np.float32)}
    arrays = {f"table::{k}": np.asarray(v) for k, v in tables.items()}
    for i, leaf in enumerate(ls):
        arrays[f"ls::{i}"] = np.asarray(leaf)
    arrays["meta::ls_format"] = np.array(ls_format)
    for k in list(arrays):
        arrays["meta::crc::" + k] = np.uint32(fmt.array_crc32(arrays[k]))
    os.makedirs(dirpath, exist_ok=True)
    np.savez(fmt.snapshot_path(dirpath, step), **arrays)
    return arrays


def journal_append(path, records):
    with open(path, "a", encoding="utf-8") as f:
        for rec in records:
            f.write(json.dumps(rec) + "\n")


def saved_event(step, path, t=None):
    return {"kind": "event", "event": "checkpoint_saved", "step": step,
            "path": path, "t": time.time() if t is None else t,
            "bytes": os.path.getsize(path)}


# ---------------------------------------------------------------------------
# snapshot_format: the jax-free on-disk contract.
# ---------------------------------------------------------------------------

def test_map_snapshot_arrays_is_zero_copy_and_exact(tmp_path):
    d = str(tmp_path)
    ref = write_snapshot(d, 3, ls=[np.arange(12, dtype=np.float32)
                                   .reshape(4, 3)])
    path = fmt.snapshot_path(d, 3)
    mapped = fmt.map_snapshot_arrays(path)
    with np.load(path) as z:  # the ground truth the maps must equal
        for key, arr in mapped.items():
            assert isinstance(arr, np.memmap), key
            assert not arr.flags.writeable
            np.testing.assert_array_equal(np.asarray(arr), z[key])
    assert sorted(mapped) == ["ls::0", "table::item_factors",
                              "table::weights"]
    np.testing.assert_array_equal(mapped["table::weights"],
                                  ref["table::weights"])


def test_map_snapshot_arrays_rejects_compressed(tmp_path):
    path = str(tmp_path / "ckpt_000000000001.npz")
    np.savez_compressed(path, **{"table::t": np.zeros((4, 2), np.float32)})
    with pytest.raises(ValueError, match="compressed"):
        fmt.map_snapshot_arrays(path)


def test_verify_snapshot_file_catches_corruption(tmp_path):
    d = str(tmp_path)
    write_snapshot(d, 1, seed=1)
    path = fmt.snapshot_path(d, 1)
    assert fmt.verify_snapshot_file(path) == (True, None)

    chaos.bitflip_file(path, nflips=8, seed=0)
    ok, reason = fmt.verify_snapshot_file(path)
    assert not ok and reason

    write_snapshot(d, 2, seed=2)
    chaos.truncate_file(fmt.snapshot_path(d, 2), keep_frac=0.5)
    ok, reason = fmt.verify_snapshot_file(fmt.snapshot_path(d, 2))
    assert not ok
    assert fmt.verify_snapshot_file(str(tmp_path / "nope.npz")) == (
        False, "no such file")


def test_latest_valid_snapshot_skips_corrupt_newest(tmp_path):
    d = str(tmp_path)
    assert fmt.snapshot_steps(str(tmp_path / "missing")) == []
    assert fmt.latest_valid_snapshot(d) is None
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 5, seed=5)
    chaos.truncate_file(fmt.snapshot_path(d, 5))
    assert fmt.snapshot_steps(d) == [1, 5]
    assert fmt.latest_valid_snapshot(d) == (1, fmt.snapshot_path(d, 1))
    # Read-only: the corrupt file is left in place (trainer owns quarantine).
    assert os.path.exists(fmt.snapshot_path(d, 5))


def _store(pkg, devices8):
    """A one-position store of one zero table ``t`` (16, 2), initialised:
    the JAX package's on one virtual CPU device, the port's on the CPU."""
    if pkg == "fps_tpu":
        import jax

        from fps_tpu.core.store import ParamStore, TableSpec
        from fps_tpu.parallel.mesh import make_ps_mesh

        mesh = make_ps_mesh(num_shards=1, num_data=1, devices=devices8[:1])
        store = ParamStore(mesh, [TableSpec("t", 16, 2).zeros_init()])
        store.init(jax.random.key(0))
        return store
    from fps_tpu_torch.core.store import ParamStore, TableSpec
    from fps_tpu_torch.parallel.mesh import make_ps_mesh

    mesh = make_ps_mesh(num_shards=1, num_data=1, device="cpu")
    store = ParamStore(mesh, [TableSpec("t", 16, 2).zeros_init()])
    store.init(0)
    return store


def test_real_checkpointer_output_is_servable(tmp_path, pkg, devices8):
    """The two planes cannot drift: a REAL Checkpointer snapshot (CRC
    tags, exported local state) opens, verifies, and serves the exact
    table and local-state bytes the store holds."""
    store = _store(pkg, devices8)
    ls = [np.arange(8, dtype=np.float32).reshape(4, 2)]
    ckpt = checkpoint.Checkpointer(str(tmp_path), keep=2)
    ckpt.save(7, store, ls, local_state_format="exported")

    snap = ServableSnapshot.open(fmt.snapshot_path(str(tmp_path), 7))
    assert snap.step == 7 and snap.local_state_format == "exported"
    np.testing.assert_array_equal(np.asarray(snap.table("t")),
                                  store.dump_model("t")[1])
    np.testing.assert_array_equal(np.asarray(snap.local_state[0]), ls[0])
    # And the serving-plane verifier agrees with the checkpoint layer's.
    assert ckpt.verify_snapshot(7)
    assert fmt.verify_snapshot_file(fmt.snapshot_path(str(tmp_path), 7))[0]


def test_snapshot_constants_are_shared_with_checkpoint_layer():
    assert checkpoint.SNAPSHOT_RE is fmt.SNAPSHOT_RE
    assert checkpoint.SNAPSHOT_FMT is fmt.SNAPSHOT_FMT
    assert checkpoint._CRC_PREFIX == fmt.CRC_PREFIX
    assert checkpoint._IO_ERRORS == fmt.IO_ERRORS


# ---------------------------------------------------------------------------
# ServableSnapshot.
# ---------------------------------------------------------------------------

def test_servable_snapshot_rejects_torn_file(tmp_path):
    d = str(tmp_path)
    write_snapshot(d, 1)
    chaos.truncate_file(fmt.snapshot_path(d, 1))
    with pytest.raises(SnapshotRejected):
        ServableSnapshot.open(fmt.snapshot_path(d, 1))
    with pytest.raises(ValueError, match="naming contract"):
        ServableSnapshot.open(str(tmp_path / "model.npz"))


def test_servable_snapshot_lookup_contract(tmp_path):
    d = str(tmp_path)
    ref = write_snapshot(d, 2)
    snap = ServableSnapshot.open(fmt.snapshot_path(d, 2))
    out = snap.lookup("weights", [0, 5, -1])
    np.testing.assert_array_equal(out[0], ref["table::weights"][0])
    np.testing.assert_array_equal(out[2], np.zeros(3, np.float32))
    with pytest.raises(IndexError):
        snap.lookup("weights", [999])
    # Only -1 is the padding sentinel; other negatives are client bugs
    # and must not silently read as zero rows.
    with pytest.raises(IndexError, match="padding sentinel"):
        snap.lookup("weights", [-7, 3])
    with pytest.raises(KeyError, match="no table"):
        snap.table("nope")
    man = snap.manifest()
    assert man["step"] == 2
    assert man["tables"]["weights"]["shape"] == [32, 3]


# ---------------------------------------------------------------------------
# SnapshotWatcher: publication, rejection, rollback, journal tailing.
# ---------------------------------------------------------------------------

def test_watcher_forward_swaps_and_rejection_cache(tmp_path):
    d = str(tmp_path)
    server, watcher = ReadServer.over(d)
    assert watcher.current is None
    with pytest.raises(NoSnapshotError):
        server.pull("weights", [0])

    write_snapshot(d, 1, seed=1)
    assert watcher.poll().step == 1
    write_snapshot(d, 2, seed=2)
    assert watcher.poll().step == 2
    assert watcher.swaps == {"forward": 2, "backward": 0}

    # A torn candidate is rejected TWICE per inode — the second read
    # CONFIRMS the verdict (one failing open can be a transient stale
    # read on a hostile filesystem, not evidence about the durable
    # bytes) — then the cache pins it: no further re-verify churn, and
    # it is never served.
    with open(fmt.snapshot_path(d, 9), "wb") as f:
        f.write(b"PK\x03\x04junk")
    assert watcher.poll() is None
    assert watcher.poll() is None
    assert watcher.poll() is None
    assert watcher.rejected == 2
    assert server.snapshot.step == 2
    # An atomic RE-publish of the same step gets a fresh verdict.
    write_snapshot(d, 9, seed=9)
    assert watcher.poll().step == 9


def test_watcher_swaps_backward_past_quarantine(tmp_path):
    d = str(tmp_path)
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 2, seed=2)
    server, watcher = ReadServer.over(d)
    assert server.snapshot.step == 2
    # The trainer's on-disk quarantine verdict: *.corrupt rename.
    os.replace(fmt.snapshot_path(d, 2), fmt.snapshot_path(d, 2) + ".corrupt")
    watcher.poll()
    assert server.snapshot.step == 1
    assert watcher.swaps["backward"] == 1
    # In-flight maps on the quarantined snapshot would still be valid;
    # new requests answer from the surviving step.
    assert server.pull("weights", [0])[0] == 1


def test_watcher_serves_republished_step_after_quarantine(tmp_path):
    """The rollback-replay path: the trainer quarantines ckpt_N
    (*.corrupt sibling lingers), restores N-1, replays, and publishes a
    FRESH valid ckpt_N. The re-publish supersedes the quarantine verdict
    — readers must not stay pinned behind it until N+1 appears."""
    d = str(tmp_path)
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 2, seed=2)
    server, watcher = ReadServer.over(d)
    assert server.snapshot.step == 2
    os.replace(fmt.snapshot_path(d, 2), fmt.snapshot_path(d, 2) + ".corrupt")
    watcher.poll()
    assert server.snapshot.step == 1  # rolled back with the trainer
    ref = write_snapshot(d, 2, seed=22)  # the replayed re-publish
    assert watcher.poll().step == 2
    _, rows = server.pull("weights", [0])
    np.testing.assert_array_equal(rows[0], ref["table::weights"][0])
    # open->2, quarantine->1 (backward), re-publish->2 (forward again).
    assert watcher.swaps == {"forward": 2, "backward": 1}


def test_watcher_reopens_served_step_replaced_between_polls(tmp_path):
    """The quarantine→replay cycle can complete ENTIRELY between two
    polls: the watcher never sees the *.corrupt sibling, only the same
    step name atomically pointing at a fresh inode. Identity is (inode,
    mtime), not (step, exists) — readers must get the replayed bytes,
    not the stale mapping, and a torn re-publish must fall back."""
    d = str(tmp_path)
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 2, seed=2)
    server, watcher = ReadServer.over(d)
    assert server.snapshot.step == 2
    # Same step, fresh inode (np.savez writes a new file in place; give
    # the mtime a distinct value for coarse-clock filesystems).
    ref = write_snapshot(d, 2, seed=22)
    os.utime(fmt.snapshot_path(d, 2), ns=(1, 1))
    assert watcher.poll().step == 2
    _, rows = server.pull("weights", [0])
    np.testing.assert_array_equal(rows[0], ref["table::weights"][0])
    assert watcher.swaps == {"forward": 2, "backward": 0}
    # A TORN re-publish of the served step swaps backward instead.
    write_snapshot(d, 2, seed=222)
    chaos.truncate_file(fmt.snapshot_path(d, 2))
    watcher.poll()
    assert server.snapshot.step == 1
    assert watcher.swaps["backward"] == 1 and watcher.rejected == 1


def test_topk_rejects_negative_user_ids(tmp_path):
    """Negative user ids must error, not wrap to another user's rows."""
    d = str(tmp_path)
    write_snapshot(d, 1, ls=[np.random.default_rng(0).normal(
        size=(8, 4)).astype(np.float32)])
    server = ReadServer(ServableSnapshot.open(fmt.snapshot_path(d, 1)))
    with pytest.raises(IndexError, match="user ids"):
        server.topk([-1], k=2)
    with pytest.raises(IndexError, match="user ids"):
        server.topk([99], k=2)
    with pytest.raises(ValueError, match="k must be"):
        server.topk([0], k=0)


def test_watcher_swaps_backward_when_served_file_vanishes(tmp_path):
    """The served snapshot deleted WITHOUT a *.corrupt rename (operator
    cleanup, aggressive GC) while its step lingers in the journal's
    saved events: the watcher must still fall back to the surviving
    snapshot, not keep serving the unlinked inode forever."""
    d = str(tmp_path / "ckpt")
    jpath = str(tmp_path / "journal-p0.jsonl")
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 2, seed=2)
    rec = obs.Recorder(sinks=[])
    server, watcher = ReadServer.over(d, journal=jpath, recorder=rec)
    journal_append(jpath, [saved_event(1, fmt.snapshot_path(d, 1)),
                           saved_event(2, fmt.snapshot_path(d, 2))])
    watcher.poll()
    assert server.snapshot.step == 2

    os.remove(fmt.snapshot_path(d, 2))
    watcher.poll()
    assert server.snapshot.step == 1
    assert watcher.swaps["backward"] == 1

    # And when NOTHING survives, the stale-serving state is surfaced:
    # the lag gauge goes NaN while the mapped pages keep answering.
    os.remove(fmt.snapshot_path(d, 1))
    watcher.poll()
    assert server.snapshot.step == 1  # still answering from the old map
    assert np.isnan(rec.snapshot()["gauges"]["serve.snapshot_lag_steps"])


def test_watcher_journal_only_mode_needs_no_dir_scan(tmp_path):
    """checkpoint_saved events carry path/step/bytes (the watcher contract):
    a journal-only watcher (poll_dir=False) publishes from the events
    alone, and a checkpoint_fallback event rolls it backward even though
    the file is still on disk."""
    d = str(tmp_path / "ckpt")
    jpath = str(tmp_path / "journal-p0.jsonl")
    write_snapshot(d, 1, seed=1)
    write_snapshot(d, 2, seed=2)
    server = ReadServer()
    watcher = SnapshotWatcher(
        d, journal=jpath, poll_dir=False,
        on_swap=lambda snap, _d: server.swap_to(snap))
    assert watcher.poll() is None  # journal not written yet

    journal_append(jpath, [saved_event(1, fmt.snapshot_path(d, 1)),
                           saved_event(2, fmt.snapshot_path(d, 2))])
    assert watcher.poll().step == 2
    assert watcher.max_written_step == 2

    journal_append(jpath, [{"kind": "event", "event": "checkpoint_fallback",
                            "step": 2, "t": time.time()}])
    watcher.poll()
    assert server.snapshot.step == 1
    assert watcher.swaps["backward"] == 1


def test_watcher_journal_dir_created_after_start(tmp_path):
    """A --journal pointing at an --obs-dir that does not exist YET
    (server started before the trainer) must begin consuming events once
    the directory and its journal-*.jsonl appear — and keep picking up
    journals that join later (multi-process runs add them)."""
    d = str(tmp_path / "ckpt")
    obs_dir = str(tmp_path / "obs")  # not created yet
    watcher = SnapshotWatcher(d, journal=obs_dir, poll_dir=False)
    assert watcher.poll() is None

    os.makedirs(obs_dir)
    write_snapshot(d, 1, seed=1)
    journal_append(os.path.join(obs_dir, "journal-p0.jsonl"),
                   [saved_event(1, fmt.snapshot_path(d, 1))])
    assert watcher.poll().step == 1
    # A journal file that joins later is tailed too.
    write_snapshot(d, 2, seed=2)
    journal_append(os.path.join(obs_dir, "journal-p1.jsonl"),
                   [saved_event(2, fmt.snapshot_path(d, 2))])
    assert watcher.poll().step == 2


def test_journal_tail_survives_truncation_and_rotation(tmp_path):
    """The tail must survive a journal truncated or
    replaced mid-tail (the supervisor restart path does exactly this),
    and buffer a torn final line until its newline arrives."""
    path = str(tmp_path / "journal-p0.jsonl")
    tail = _JournalTail(path)
    assert tail.read_new() == []  # not created yet

    journal_append(path, [{"a": 1}, {"a": 2}])
    assert [r["a"] for r in tail.read_new()] == [1, 2]

    # Torn final line: buffered, delivered once complete.
    with open(path, "a") as f:
        f.write('{"a": 3')
    assert tail.read_new() == []
    with open(path, "a") as f:
        f.write('}\n')
    assert [r["a"] for r in tail.read_new()] == [3]

    # Truncation in place: restart from the top (caller dedupes).
    open(path, "w").close()
    journal_append(path, [{"a": 4}])
    assert [r["a"] for r in tail.read_new()] == [4]

    # Rotation: a NEW file replaces the inode under the tailer.
    tmp = str(tmp_path / "new.jsonl")
    with open(tmp, "w") as f:
        f.write(json.dumps({"a": 5}) + "\n")
    os.replace(tmp, path)
    assert [r["a"] for r in tail.read_new()] == [5]

    # Deletion mid-tail: empty reads, then a recreated file reads fresh.
    os.remove(path)
    assert tail.read_new() == []
    journal_append(path, [{"a": 6}])
    assert [r["a"] for r in tail.read_new()] == [6]


def test_watcher_dedupes_replayed_journal_after_truncation(tmp_path):
    """A truncated+rewritten journal re-delivers old checkpoint_saved
    records; the watcher must treat steps as idempotent keys — no
    re-swap, no double counting."""
    d = str(tmp_path / "ckpt")
    jpath = str(tmp_path / "journal-p0.jsonl")
    write_snapshot(d, 1, seed=1)
    server, watcher = ReadServer.over(d, journal=jpath)
    journal_append(jpath, [saved_event(1, fmt.snapshot_path(d, 1))])
    watcher.poll()
    assert server.snapshot.step == 1 and watcher.swaps["forward"] == 1

    # Supervisor restart: journal truncated, the same event replayed.
    open(jpath, "w").close()
    journal_append(jpath, [saved_event(1, fmt.snapshot_path(d, 1))])
    assert watcher.poll() is None
    assert watcher.swaps == {"forward": 1, "backward": 0}


# ---------------------------------------------------------------------------
# ReadServer: numerics, hot swap, latency accounting.
# ---------------------------------------------------------------------------

def _two_snapshots(tmp_path):
    d = str(tmp_path)
    a = write_snapshot(d, 1, seed=1,
                       ls=[np.random.default_rng(1).normal(
                           size=(8, 4)).astype(np.float32)])
    b = write_snapshot(d, 2, seed=2,
                       ls=[np.random.default_rng(2).normal(
                           size=(8, 4)).astype(np.float32)])
    sa = ServableSnapshot.open(fmt.snapshot_path(d, 1))
    sb = ServableSnapshot.open(fmt.snapshot_path(d, 2))
    return a, b, sa, sb


def test_read_server_numerics_match_numpy(tmp_path):
    a, _, sa, _ = _two_snapshots(tmp_path)
    server = ReadServer(sa)

    step, vals = server.pull("weights", [[0, 1], [2, -1]])
    assert step == 1
    w = a["table::weights"]
    np.testing.assert_array_equal(vals[0], w[[0, 1]])
    np.testing.assert_array_equal(vals[1][1], np.zeros(3, np.float32))

    ids = np.array([[0, 2, 4], [1, 3, -1]])
    vs = np.array([[1.0, 0.5, 2.0], [1.0, 1.0, 3.0]], np.float32)
    step, p = server.score_linear(ids, vs, table="weights")
    live = ids >= 0
    logit = (np.where(live, w[np.where(live, ids, 0), 0], 0.0) * vs).sum(1)
    np.testing.assert_allclose(p, 1 / (1 + np.exp(-logit)), rtol=1e-6)
    _, margin = server.score_linear(ids, vs, table="weights", link="none")
    np.testing.assert_allclose(margin, logit, rtol=1e-6)

    users = np.array([0, 5])
    step, items, scores = server.topk(users, k=4)
    ref = a["ls::0"][users] @ a["table::item_factors"].T
    np.testing.assert_array_equal(items, np.argsort(-ref, axis=1)[:, :4])
    np.testing.assert_allclose(
        scores, np.take_along_axis(ref, items, axis=1), rtol=1e-6)

    stats = server.stats()
    assert stats["requests"] == 4 and stats["step"] == 1
    assert stats["latency_p99_s"] >= stats["latency_p50_s"] >= 0


def test_topk_requires_exported_local_state(tmp_path):
    d = str(tmp_path)
    write_snapshot(d, 1, ls=[np.zeros((4, 4), np.float32)], ls_format="raw")
    server = ReadServer(ServableSnapshot.open(fmt.snapshot_path(d, 1)))
    with pytest.raises(ValueError, match="EXPORTED"):
        server.topk([0], k=2)
    with pytest.raises(ValueError, match="no leaf"):
        d2 = str(tmp_path / "b")
        write_snapshot(d2, 1)
        ReadServer(ServableSnapshot.open(
            fmt.snapshot_path(d2, 1))).topk([0], k=2)


def test_hot_swap_is_atomic_for_in_flight_requests(tmp_path):
    """An in-flight batched lookup completes against
    the snapshot it started on; the swap lands for the NEXT request."""
    a, b, sa, sb = _two_snapshots(tmp_path)
    server = ReadServer(sa)
    entered, release = threading.Event(), threading.Event()
    orig = sa.lookup

    def slow_lookup(name, ids):
        entered.set()
        assert release.wait(10)
        return orig(name, ids)

    sa.lookup = slow_lookup
    result = {}

    def request():
        result["step"], result["vals"] = server.pull("weights", [0, 1])

    t = threading.Thread(target=request)
    t.start()
    assert entered.wait(10)
    server.swap_to(sb)  # swap WHILE the request is inside the lookup
    release.set()
    t.join(10)
    assert result["step"] == 1  # answered from the snapshot it started on
    np.testing.assert_array_equal(result["vals"],
                                  a["table::weights"][[0, 1]])
    assert server.pull("weights", [0, 1])[0] == 2  # next request: new snap


def test_swap_latency_independent_of_table_size(tmp_path):
    """The swap is a pointer flip — swapping in a
    snapshot with a table ~1000x larger costs the same O(ns) reference
    rebind (mmap: no bytes move). Bounded generously to stay
    timing-robust."""
    d = str(tmp_path)
    write_snapshot(d, 1, tables={"t": np.zeros((16, 4), np.float32)})
    big = np.zeros((1 << 20, 4), np.float32)  # 16 MB
    write_snapshot(d, 2, tables={"t": big})
    small = ServableSnapshot.open(fmt.snapshot_path(d, 1))
    bigsnap = ServableSnapshot.open(fmt.snapshot_path(d, 2))
    assert isinstance(bigsnap.table("t"), np.memmap)  # mapped, not read

    server = ReadServer(small)

    def best_of(snap, reps=2000):
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            server.swap_to(snap)
            best = min(best, time.perf_counter() - t0)
        return best

    t_small, t_big = best_of(small), best_of(bigsnap)
    assert t_big < 1e-4, f"swap to 16MB-table snapshot took {t_big}s"
    assert t_big < 50 * max(t_small, 1e-7)


def test_serve_metrics_ride_the_default_registry(tmp_path):
    """Every serve.* leaf is declared in obs.default_registry: emitting
    through a schema-validating Recorder must not raise or drop."""
    d = str(tmp_path)
    write_snapshot(d, 1, ls=[np.zeros((8, 4), np.float32)])
    sink = obs.MemorySink()
    rec = obs.Recorder(sinks=[sink])
    server, watcher = ReadServer.over(d, recorder=rec)
    server.pull("weights", [0, 1, 2])
    server.topk([0], k=2)
    assert rec.counter_value("serve.requests", op="pull") == 1
    assert rec.counter_value("serve.requests", op="topk") == 1
    assert rec.counter_value("serve.rows") == 5
    assert rec.counter_value("serve.swaps", direction="forward") == 1
    snap = rec.snapshot()
    assert snap["gauges"]["serve.snapshot_step"] == 1.0
    assert snap["gauges"]["serve.snapshot_lag_steps"] == 0.0
    assert snap["gauges"]["serve.write_to_servable_s"] >= 0.0
    assert snap["histograms"]["serve.request_seconds{op=pull}"][
        "count"] == 1


# ---------------------------------------------------------------------------
# TCP transport (framed wire only; the legacy dual stack is retired).
# ---------------------------------------------------------------------------

def test_tcp_round_trip_and_error_tolerance(tmp_path):
    d = str(tmp_path)
    ref = write_snapshot(d, 1, ls=[np.random.default_rng(0).normal(
        size=(8, 4)).astype(np.float32)])
    server, _ = ReadServer.over(d)
    with TcpServe(server) as tcp, JsonlClient(tcp.host, tcp.port) as c:
        r = c.request({"op": "pull", "table": "weights", "ids": [0, 1]})
        assert r["ok"] and r["step"] == 1
        np.testing.assert_allclose(np.asarray(r["values"], np.float32),
                                   ref["table::weights"][[0, 1]])
        # The connection survives garbage and bad requests.
        assert not c.request({"op": "nope"})["ok"]
        # ...including valid JSON that is not an object.
        assert not c.request([1, 2, 3])["ok"]
        r = c.request({"op": "pull", "table": "weights", "ids": [0]})
        assert r["ok"]  # same connection still answers
        r = c.request({"op": "pull", "table": "missing", "ids": [0]})
        assert not r["ok"] and "KeyError" in r["error"]
        r = c.request({"op": "stats"})
        assert r["ok"] and r["requests"] >= 1
    # The legacy line-JSON dual stack is RETIRED: a raw line-JSON peer
    # fails the first frame's magic gate and gets a counted OP_ERR +
    # dropped connection — never a silent hang, never a line reply.
    with TcpServe(server) as tcp:
        s = socket.create_connection((tcp.host, tcp.port), timeout=5.0)
        try:
            rf = s.makefile("rb")
            s.sendall(b"this is not json\n")
            fr = wire.read_frame(rf)
            assert fr.op == wire.OP_ERR
            assert not fr.json()["ok"]
            assert rf.read(1) == b""  # connection dropped after OP_ERR
        finally:
            s.close()
        assert tcp.wire_stats()["torn_frames"] == 1


def test_tcp_nonfinite_rows_serialize_as_strict_json(tmp_path):
    # Observe-mode guards publish snapshots that still hold non-finite
    # rows; the wire must stay strict JSON (null, never NaN/Infinity —
    # json.loads accepts the Python-only tokens, so assert on the raw
    # OP_RESP payload BYTES, not a parsed dict). Hand-rolled framed
    # conversation so the assertion sees the wire text.
    d = str(tmp_path)
    w = np.ones((4, 2), np.float32)
    w[1, 0], w[2, 1] = np.nan, np.inf
    write_snapshot(d, 1, tables={"weights": w})
    server, _ = ReadServer.over(d)
    with TcpServe(server) as tcp:
        s = socket.create_connection((tcp.host, tcp.port), timeout=5.0)
        try:
            rf = s.makefile("rb")
            wire.send_frame(s, wire.encode_frame(
                wire.OP_HELLO, 0, json.dumps(
                    {"versions": list(wire.SUPPORTED_VERSIONS),
                     "session": "nonfinite-test"}).encode()), "serve")
            assert wire.read_frame(rf).op == wire.OP_HELLO_OK
            req = {"op": "pull", "table": "weights", "ids": [0, 1, 2]}
            wire.send_frame(s, wire.encode_frame(
                wire.OP_REQ, 1, json.dumps({"q": req}).encode()), "serve")
            fr = wire.read_frame(rf)
        finally:
            s.close()
        assert fr.op == wire.OP_RESP
        raw = fr.payload.decode("utf-8")
        assert "NaN" not in raw and "Infinity" not in raw
        r = json.loads(raw)
        assert r["ok"] and r["values"][1][0] is None
        assert r["values"][2][1] is None
        assert r["values"][0] == [1.0, 1.0]


def test_tcp_no_snapshot_is_retryable():
    server = ReadServer()
    with TcpServe(server) as tcp, JsonlClient(tcp.host, tcp.port) as c:
        r = c.request({"op": "pull", "table": "t", "ids": [0]})
        assert not r["ok"] and r.get("retryable")


# ---------------------------------------------------------------------------
# The serving CLIs: tools/serve.py without jax, the port's without torch.
# ---------------------------------------------------------------------------

# Each package's CLI, and the modules its process must never import.
_CLI = {"fps_tpu": (("tools", "serve.py"), ("jax",)),
        "fps_tpu_torch": (("fps_tpu_torch", "examples", "serve.py"),
                          ("torch", "jax", "fps_tpu"))}


def _cli_tool(pkg):
    return os.path.join(ROOT, *_CLI[pkg][0])


def _poisoned_cli(pkg, args, tmp_path):
    """Run ``pkg``'s serving CLI in a subprocess with its training stack
    UNIMPORTABLE (poisoned in sys.modules): the no-accelerator-runtime
    serving promise."""
    tool = _cli_tool(pkg)
    code = (
        "import sys, runpy\n"
        + "".join(f"sys.modules[{m!r}] = None\n" for m in _CLI[pkg][1])
        + f"sys.argv = ['serve.py'] + {args!r}\n"
        "try:\n"
        f"    runpy.run_path({tool!r}, run_name='__main__')\n"
        "    rc = 0\n"
        "except SystemExit as e:\n"
        "    rc = e.code\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and "
        f"m.split('.')[0] in {_CLI[pkg][1]!r}]\n"
        "assert not bad, bad\n"
        "sys.exit(rc)\n"
    )
    return subprocess.run([sys.executable, "-c", code],
                          capture_output=True, text=True, timeout=120,
                          cwd=str(tmp_path))


def test_serve_cli_once_is_jax_free(tmp_path, pkg):
    d = str(tmp_path / "ckpt")
    write_snapshot(d, 4)
    with open(fmt.snapshot_path(d, 9), "wb") as f:
        f.write(b"PK\x03\x04junk")  # must be rejected, not served
    proc = _poisoned_cli(pkg, [d, "--once"], tmp_path)
    assert proc.returncode == 0, proc.stderr
    man = json.loads(proc.stdout)
    assert man["event"] == "manifest" and man["step"] == 4
    assert man["rejected"] == 1
    assert man["tables"]["weights"]["shape"] == [32, 3]

    empty = _poisoned_cli(pkg, [str(tmp_path / "empty"), "--once"],
                          tmp_path)
    assert empty.returncode == 1
    assert json.loads(empty.stdout)["event"] == "no_snapshot"


def test_serve_cli_tcp_serves_queries(tmp_path, pkg):
    d = str(tmp_path / "ckpt")
    write_snapshot(d, 2, ls=[np.zeros((8, 4), np.float32)])
    tool = _cli_tool(pkg)
    proc = subprocess.Popen(
        [sys.executable, tool, d, "--max-polls", "40", "--poll-s", "0.1"],
        stdout=subprocess.PIPE, text=True, cwd=str(tmp_path))
    try:
        line = json.loads(proc.stdout.readline())
        assert line["event"] == "serving" and line["step"] == 2
        with JsonlClient(line["host"], line["port"]) as c:
            r = c.request({"op": "pull", "table": "weights", "ids": [0]})
            assert r["ok"] and r["step"] == 2
            r = c.request({"op": "topk", "users": [1], "k": 3})
            assert r["ok"] and len(r["items"][0]) == 3
        out, _ = proc.communicate(timeout=60)
        served = json.loads(out.strip().splitlines()[-1])
        assert served["event"] == "served" and served["requests"] == 2
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 0




# ---------------------------------------------------------------------------
# Across the packages: the same files, the same answers, bit for bit.
# ---------------------------------------------------------------------------

# A test parametrized on ``pkg`` directly overrides the autouse fixture:
# its names stay the port's, and it reaches the JAX package's through
# ``_serve_pkgs.counterpart``.
ACROSS = pytest.mark.parametrize("pkg", ["across"])
ITEM = "item_factors"


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, (what, a.dtype,
                                                       b.dtype)
    assert a.tobytes() == b.tobytes(), what


def _answers(server_cls, snap, nu, ni):
    """Every query kind over ``snap``: pull, score_linear (both links),
    topk and one multi batch, as plain arrays."""
    server = server_cls(snap)
    rng = np.random.default_rng(3)
    ids = np.concatenate([np.arange(ni), [-1, 0, ni - 1]])
    feat = rng.integers(-1, ni, size=(7, 5))
    vals = rng.normal(size=(7, 5)).astype(np.float32)
    users = np.arange(nu)
    out = {"pull": server.pull(ITEM, ids)[1],
           "topk": server.topk(users, k=5)[1:],
           "k_all": server.topk(users[:9], k=ni + 3)[1:]}
    for link in ("sigmoid", "none"):
        out[f"score_{link}"] = server.score_linear(feat, vals, table=ITEM,
                                                   link=link)[1]
    multi = server.multi([
        ("pull", {"table": ITEM, "ids": ids[:10]}),
        ("score", {"feat_ids": feat, "feat_vals": vals, "table": ITEM,
                   "link": "sigmoid"}),
        ("topk", {"users": users[:4], "k": 3, "item_table": ITEM,
                  "user_leaf": 0}),
        ("pull", {"table": ITEM, "ids": [ni + 5]})])
    assert isinstance(multi[3], IndexError)
    out["multi"] = [m[1:] for m in multi[:3]]
    return out


def _same_answers(a, b, what):
    assert sorted(a) == sorted(b)
    for k in a:
        fa, fb = a[k], b[k]
        if k == "multi":
            fa = [x for t in fa for x in t]
            fb = [x for t in fb for x in t]
        elif not isinstance(fa, (tuple, list)):
            fa, fb = [fa], [fb]
        for i, (x, y) in enumerate(zip(fa, fb)):
            _same_bits(x, y, f"{what}: {k}[{i}]")


@ACROSS
def test_both_packages_answer_the_same_over_the_same_chains(tmp_path,
                                                            devices8):
    """MF trained by the port on the CPU publishes a delta chain
    (``DeltaPolicy(full_every=3)``) through the port's ``Checkpointer``;
    the JAX package's ``Checkpointer`` publishes the same states,
    converted, into a second directory. Over both directories, both
    packages' ``ReadServer`` answer pull, score_linear (both links), topk
    (ids and scores) and multi bit for bit the same, at every step, from
    the chain resolved whole (``open_chain``) and from ``with_delta``
    applied link by link; the head equals the live table."""
    import jax

    from fps_tpu.core import checkpoint as jck
    from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
    from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
    from fps_tpu.parallel import mesh as jmesh
    from fps_tpu.utils import datasets as jdatasets
    from fps_tpu_torch import MFConfig, online_mf
    from fps_tpu_torch.convert import to_numpy
    from fps_tpu_torch.core.ingest import multi_epoch_chunks
    from fps_tpu_torch.parallel.mesh import make_ps_mesh

    NU, NI = 96, 40
    cfg = dict(num_users=NU, num_items=NI, rank=4, learning_rate=0.1)
    ttr, tst = online_mf(make_ps_mesh(4, 1, device="cpu"), MFConfig(**cfg))
    jtr, jst = jonline_mf(jmesh.make_ps_mesh(
        num_shards=4, num_data=1, devices=devices8[:4]), JMFConfig(**cfg))
    tables, local = ttr.init_state(0)
    data = jdatasets.synthetic_ratings(NU, NI, 1500, seed=0)
    chunks = list(multi_epoch_chunks(data, 1, num_workers=4, local_batch=8,
                                     steps_per_chunk=2, route_key="user",
                                     seed=5))[:5]
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tckp = checkpoint.Checkpointer(
        tdir, keep=8, delta=checkpoint.DeltaPolicy(full_every=3))
    jckp = jck.Checkpointer(jdir, keep=8, delta=jck.DeltaPolicy(full_every=3))
    for step, chunk in enumerate(chunks, 1):
        tables, local, _ = ttr.run_chunk(tables, local, chunk, step)
        exported = ttr.logic.export_local_state(local.numpy())
        tckp.save(step, tst, exported, local_state_format="exported")
        jst.tables = {ITEM: jax.device_put(to_numpy(tables[ITEM]),
                                           jst.sharding)}
        jckp.save(step, jst, exported, local_state_format="exported")
    assert tckp.delta_publishes >= 2 and tckp.full_publishes >= 2

    classes = [(ServableSnapshot, ReadServer),
               (_serve_pkgs.counterpart(ServableSnapshot),
                _serve_pkgs.counterpart(ReadServer))]
    for step in range(1, 6):
        ref = None
        for d in (tdir, jdir):
            for snap_cls, server_cls in classes:
                snap = snap_cls.open_chain(d, step)
                got = _answers(server_cls, snap, NU, NI)
                if ref is None:
                    ref = got
                else:
                    _same_answers(ref, got, f"step {step} {d} "
                                  f"{server_cls.__module__}")
        # with_delta link by link from the base full gives the same.
        base = max(s for s in range(1, step + 1)
                   if os.path.exists(fmt.snapshot_path(tdir, s)))
        for snap_cls, server_cls in classes:
            snap = snap_cls.open(fmt.snapshot_path(tdir, base))
            for s in range(base + 1, step + 1):
                snap = snap.with_delta(
                    fmt.delta_path(tdir, s, s - 1))
            _same_answers(ref, _answers(server_cls, snap, NU, NI),
                          f"step {step} with_delta {server_cls.__module__}")
    _same_bits(ref["pull"][:NI], tst.dump_model(ITEM)[1], "head = live")


@ACROSS
def test_both_packages_break_topk_ties_alike(tmp_path):
    """Items with equal rows tie on every user's score: both packages pick
    and order the same ids (``argpartition`` then ``argsort``)."""
    rng = np.random.default_rng(0)
    items = np.repeat(rng.normal(size=(5, 3)).astype(np.float32), 6, axis=0)
    users = rng.normal(size=(11, 3)).astype(np.float32)
    users[3] = 0.0  # every score 0: a tie across the whole table
    d = str(tmp_path)
    write_snapshot(d, 1, tables={ITEM: items}, ls=[users])
    got = []
    for server_cls in (ReadServer, _serve_pkgs.counterpart(ReadServer)):
        server, _ = server_cls.over(d)
        got.append([server.topk(np.arange(11), k=k)[1:]
                    for k in (1, 4, 7, 30)])
    for (ia, sa), (ib, sb) in zip(*got):
        _same_bits(ia, ib, "tied ids")
        _same_bits(sa, sb, "tied scores")
