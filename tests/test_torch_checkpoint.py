"""Checkpoints of the port (``fps_tpu_torch.core.checkpoint``) against the
JAX package's (``fps_tpu.core.checkpoint``), and the port's own oracles
from ``tests/test_checkpoint.py``, ``tests/test_async_checkpoint.py`` and
``tests/test_delta_snapshot.py``.

Across the packages: a snapshot (a full, or a delta chain) written by each
from the same state has the same file names, the same keys, the same
arrays and the same CRC tags, and each restores in the other bit for bit;
a model exported by each loads in the other. The JAX side runs on the 8
virtual CPU devices of the test process (``tests/conftest.py``), the port
on ``make_ps_mesh(S, D, device="cpu")``.

The port's own: the elastic re-split from (1, 8) to (2, 4) and (4, 2),
asserted and recorded; resume bit for bit through ``fit_stream`` and
``run_indexed``, sync and SSP, for MF, PA, logistic regression and
word2vec; the fallback past a corrupt newest snapshot and its quarantine,
the tmp and ``.corrupt`` sweeps, ``_gc`` of delta chains, compaction
stopped at every ``_compact_phase_hook`` phase; the async writer's
``save_deferred``, ``when_full`` and first-error contract; the pod fence;
a tiered run resumed with its ``fold::`` state, and restored untiered;
and a SIGKILLed process resumed in a fresh one
(``tests/_torch_kill_resume_worker.py``, spawned with finite timeouts).
"""

from __future__ import annotations

import dataclasses
import errno
import os
import subprocess
import sys
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import checkpoint as jck
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    DeviceDataset,
    DeviceEpochPlan,
    LogRegConfig,
    MFConfig,
    PAConfig,
    logistic_regression,
    online_mf,
    passive_aggressive,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import checkpoint as tck
from fps_tpu_torch.core import snapshot_format as tfmt
from fps_tpu_torch.core.ingest import multi_epoch_chunks
from fps_tpu_torch.core.resilience import SnapshotCorruptionError
from fps_tpu_torch import obs
from fps_tpu_torch.obs import events as obs_events
from fps_tpu_torch.models import word2vec as tw2v
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.testing import chaos
from fps_tpu_torch.utils import datasets as tdatasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_kill_resume_worker.py")
ITEM = "item_factors"
MF_KW = dict(num_users=96, num_items=61, rank=4, learning_rate=0.08,
             reg=0.005)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def journal():
    """A process-default recorder over a memory sink for the test: the
    checkpoint trail and metrics as a run's journal gets them."""
    sink = obs.MemorySink()
    rec = obs.Recorder(sinks=[sink])
    with obs_events.default_recorder(rec):
        yield rec, sink


def _trail(sink, since=0):
    """The kinds of the events recorded after the first ``since``
    records."""
    return [r["event"] for r in list(sink.records)[since:]
            if r["kind"] == "event"]


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


def _tmesh(D, S):
    return tmesh.make_ps_mesh(S, D, device="cpu")


def _mf_pair(D, S, **kw):
    """MF in both packages from the JAX package's initial state."""
    jtr, jst = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW), **kw)
    ttr, tst = online_mf(_tmesh(D, S), MFConfig(**MF_KW), **kw)
    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    tst.tables = dict(tt)
    return (jtr, jst, jt, jl), (ttr, tst, tt, tl)


def _mf_chunks(W, n=4, sync_every=None, seed=3, data=None):
    data = data or jdatasets.synthetic_ratings(MF_KW["num_users"],
                                               MF_KW["num_items"], 1600,
                                               rank=3, noise=0.05, seed=seed)
    return list(multi_epoch_chunks(
        data, 2, num_workers=W, local_batch=8, steps_per_chunk=4,
        route_key="user", sync_every=sync_every, seed=11))[:n]


def _phys(n, S):
    """The physical rows of ids ``[0, n)`` over ``S`` shards."""
    ids = np.arange(n)
    rps = -(-n // S)
    return (ids % S) * rps + ids // S


def _entries(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _same_bits(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape, what
    if a.dtype.kind == "f":
        a, b = a.view(f"u{a.itemsize}"), b.view(f"u{b.itemsize}")
    np.testing.assert_array_equal(a, b, what)


def _same_files(dir_a, dir_b):
    """Both directories hold the same publications, each with the same
    keys, the same arrays and the same CRC tags."""
    names = sorted(f for f in os.listdir(dir_a) if f.endswith(".npz"))
    assert names == sorted(f for f in os.listdir(dir_b)
                           if f.endswith(".npz"))
    assert names
    for f in names:
        a, b = _entries(os.path.join(dir_a, f)), _entries(
            os.path.join(dir_b, f))
        assert sorted(a) == sorted(b), f
        assert any(k.startswith(tfmt.CRC_PREFIX) for k in a)
        for k in a:
            if a[k].dtype.kind == "U":
                assert str(a[k]) == str(b[k]), (f, k)
            else:
                _same_bits(a[k], b[k], f"{f}: {k}")


# ---------------------------------------------------------------------------
# Across the packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tiered", [False, True], ids=["mf", "tier_fold"])
def test_a_snapshot_crosses_between_the_packages_bit_for_bit(
        tmp_path, devices8, tiered):
    """The same state saved by each package: the same file, key for key,
    CRC tag for CRC tag (``-0.0`` kept); each restores in the other to the
    same bits, the hot fold's ``fold::`` state included."""
    (jtr, jst, jt, jl), (ttr, tst, tt, tl) = _mf_pair(2, 4)
    if tiered:
        # A run of the JAX package's Adagrad hot fold leaves fold state;
        # both packages then save the JAX package's state.
        for tr, st in ((jtr, jst), (ttr, tst)):
            st.specs[ITEM] = dataclasses.replace(
                st.specs[ITEM], hot_tier=MF_KW["num_items"],
                dense_collectives=False)
            tr.config = dataclasses.replace(tr.config, hot_sync_every=2)
            tr.server_logic[ITEM] = dataclasses.replace(
                tr.server_logic[ITEM], hot_fold="adagrad")
        jt, jl, _ = jtr.fit_stream(jt, jl, _mf_chunks(8, n=2),
                                   jax.random.key(1))
        arrays = {k: np.asarray(v) for k, v in jt.items()
                  if k == ITEM or k.endswith("::fold")}
        tt = tables_from_jax(tst, arrays)
        tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
        tst.tables = dict(tt)
        assert any(k.endswith("::fold") for k in tt)
    # -0.0 must survive both ways.
    t0 = to_numpy(tt[ITEM]).copy()
    t0[0, 0] = -0.0
    tt = dict(tt, **tables_from_jax(tst, {ITEM: t0}))
    tst.tables = dict(tt)
    jt = dict(jt, **{ITEM: jax.device_put(t0, jst.sharding)})
    jst.tables = dict(jt)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jtr._save_checkpoint(jck.Checkpointer(str(jdir)), 3, jl)
    ttr._save_checkpoint(tck.Checkpointer(str(tdir)), 3, tl)
    _same_files(jdir, tdir)
    assert tck.SNAPSHOT_RE.fullmatch("ckpt_000000000003.npz")

    # The JAX package's file in the port, on a fresh trainer.
    ttr2, tst2 = online_mf(_tmesh(2, 4), MFConfig(**MF_KW))
    ttr2.server_logic = dict(ttr.server_logic)
    _, like = ttr2.init_state(9)
    tables, local, step = ttr2.restore_checkpoint(
        tck.Checkpointer(str(jdir)), like)
    assert step == 3
    # Logical rows (a restore zero-fills the padding rows, as the JAX
    # package's does).
    logical = t0[tst.specs[ITEM] and _phys(MF_KW["num_items"], 4)]
    _same_bits(tst2.dump_model(ITEM)[1], logical, "port restores jax")
    del tables
    _same_bits(local.numpy(), np.asarray(jl), "port restores jax: local")
    if tiered:
        _same_bits(to_numpy(tst2.tables[ITEM + "::fold"]),
                   np.asarray(jt[ITEM + "::fold"]), "fold")
    # The port's file in the JAX package.
    jtr2, _ = jonline_mf(_jmesh(2, 4), JMFConfig(**MF_KW))
    _, jlike = jtr2.init_state(jax.random.key(9))
    jtables, jlocal, step = jtr2.restore_checkpoint(
        jck.Checkpointer(str(tdir)), jlike)
    _same_bits(jtr2.store.dump_model(ITEM)[1], logical, "jax restores port")
    del jtables
    _same_bits(np.asarray(jlocal), np.asarray(jl), "jax restores port: local")


def test_a_delta_chain_crosses_between_the_packages_bit_for_bit(
        tmp_path, devices8):
    """Saves of the same states under ``DeltaPolicy(full_every=3)`` make the
    same chain in both packages (fulls and deltas, file for file, CRC for
    CRC), and each package resolves the other's chain to the same
    arrays."""
    NU, NI = 1024, 64
    cfg = dict(num_users=NU, num_items=NI, rank=4, learning_rate=0.1)
    ttr, tst = online_mf(_tmesh(1, 4), MFConfig(**cfg))
    jtr, jst = jonline_mf(_jmesh(1, 4), JMFConfig(**cfg))
    tables, local = ttr.init_state(0)
    data = jdatasets.synthetic_ratings(NU, NI, 2000, seed=0)
    chunks = list(multi_epoch_chunks(data, 1, num_workers=4, local_batch=8,
                                     steps_per_chunk=2, route_key="user",
                                     seed=5))[:5]
    pol = dict(delta=tck.DeltaPolicy(full_every=3))
    tdir, jdir = str(tmp_path / "port"), str(tmp_path / "jax")
    tckp = tck.Checkpointer(tdir, keep=8, **pol)
    jckp = jck.Checkpointer(jdir, keep=8,
                            delta=jck.DeltaPolicy(full_every=3))
    for step, chunk in enumerate(chunks, 1):
        tables, local, _ = ttr.run_chunk(tables, local, chunk, step)
        exported = ttr.logic.export_local_state(local.numpy())
        tckp.save(step, tst, exported, local_state_format="exported")
        jst.tables = {ITEM: jax.device_put(to_numpy(tables[ITEM]),
                                           jst.sharding)}
        jckp.save(step, jst, exported, local_state_format="exported")
    assert tckp.delta_publishes >= 2 and tckp.full_publishes >= 2
    assert (tckp.delta_publishes, tckp.full_publishes) == (
        jckp.delta_publishes, jckp.full_publishes)
    _same_files(tdir, jdir)
    for s in range(1, 6):
        _, tv, tl, _ = tck.Checkpointer(jdir).read_snapshot(s)
        _, jv, jl, _ = jck.Checkpointer(tdir).read_snapshot(s)
        _same_bits(tv[ITEM], jv[ITEM], f"step {s}")
        _same_bits(tl[0], jl[0], f"step {s}: local")
    _same_bits(tv[ITEM], tst.dump_model(ITEM)[1], "head = live")
    assert tfmt.verify_chain(tdir, 5)[0]


def test_export_and_load_model_cross_between_the_packages(tmp_path,
                                                          devices8):
    """``export_model`` of each package loads in the other
    (``load_saved_model`` / ``load_model``), across shard counts; a
    ``load_rows`` subset overwrites those rows only and validates its
    input."""
    (jtr, jst, jt, jl), (ttr, tst, tt, tl) = _mf_pair(1, 8)
    tck.export_model(tst, str(tmp_path / "port.npz"))
    jck.export_model(jst, str(tmp_path / "jax.npz"))
    a = tck.load_saved_model(str(tmp_path / "jax.npz"))
    b = jck.load_saved_model(str(tmp_path / "port.npz"))
    _same_bits(a[ITEM], b[ITEM], "export")
    tr4, st4 = online_mf(_tmesh(2, 4), MFConfig(**MF_KW))
    tables4, _ = tr4.init_state(7)
    tck.load_model(st4, str(tmp_path / "jax.npz"))
    _same_bits(st4.dump_model(ITEM)[1], b[ITEM], "warm start at (2, 4)")
    assert all(torch.equal(x, st4.tables[ITEM][0])
               for x in st4.tables[ITEM][4:5])  # data replica 1, shard 0
    ids = np.array([5, 0, 60])
    vals = np.arange(12, dtype=np.float32).reshape(3, 4)
    before = st4.dump_model(ITEM)[1]
    tck.load_rows(st4, ITEM, ids, vals)
    after = st4.dump_model(ITEM)[1]
    np.testing.assert_array_equal(after[ids], vals)
    keep = np.setdiff1d(np.arange(MF_KW["num_items"]), ids)
    np.testing.assert_array_equal(after[keep], before[keep])
    with pytest.raises(ValueError, match="out of range"):
        tck.load_rows(st4, ITEM, np.array([61]), vals[:1])
    with pytest.raises(ValueError, match="values shape"):
        tck.load_rows(st4, ITEM, ids, vals[:, :2])
    with pytest.raises(ValueError, match="has no table"):
        tck.load_model(st4, {}, strict=True)


@pytest.mark.parametrize("shape", [(2, 4), (4, 2)])
def test_elastic_resplit_from_1x8(tmp_path, devices8, shape, journal):
    """A (1, 8) snapshot restores onto (2, 4) and (4, 2): the re-split is
    taken explicitly (an event and a metric), asserted bit for bit, and
    the JAX package restores the same file to the same tables. A restore
    on the snapshot's own shape records no re-split."""
    ttr, tst = online_mf(_tmesh(1, 8), MFConfig(**MF_KW))
    tables, local = ttr.init_state(0)
    ck = tck.Checkpointer(str(tmp_path))
    tables, local, _ = ttr.fit_stream(tables, local, _mf_chunks(8, n=2), 1,
                                      checkpointer=ck, checkpoint_every=2)
    want_t, want_l = tst.dump_model(ITEM)[1], ttr.logic.export_local_state(
        local.numpy())
    D, S = shape
    tr2, st2 = online_mf(_tmesh(D, S), MFConfig(**MF_KW))
    _, like = tr2.init_state(5)
    rec, sink = journal
    n0 = len(sink.records)
    ck2 = tck.Checkpointer(str(tmp_path))
    t2, l2, step = tr2.restore_checkpoint(ck2, like)
    assert step == 2
    assert _trail(sink, n0) == ["checkpoint_resplit"]
    assert rec.counter_value("checkpoint.resplits") == 1
    _same_bits(st2.dump_model(ITEM)[1], want_t, "tables")
    _same_bits(tr2.logic.export_local_state(l2.numpy()), want_l, "local")
    for d in range(1, D):
        for s in range(S):
            assert torch.equal(t2[ITEM][d * S + s], t2[ITEM][s])
    jtr, jst = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW))
    _, jlike = jtr.init_state(jax.random.key(5))
    jtr.restore_checkpoint(jck.Checkpointer(str(tmp_path)), jlike)
    _same_bits(jst.dump_model(ITEM)[1], want_t, "jax")
    n1 = len(sink.records)
    ck3 = tck.Checkpointer(str(tmp_path))
    tr3 = online_mf(_tmesh(1, 8), MFConfig(**MF_KW))[0]
    tr3.init_state(5)
    tr3.restore_checkpoint(ck3, local)
    assert _trail(sink, n1) == []
    assert rec.counter_value("checkpoint.resplits") == 1


# ---------------------------------------------------------------------------
# Resume bit for bit.
# ---------------------------------------------------------------------------

def _family(name, mesh, sync_every):
    """``(trainer, store, host chunks, epoch plan)`` of one model family at
    a small size."""
    W = tmesh.num_workers_of(mesh)
    if name == "mf":
        tr, st = online_mf(mesh, MFConfig(**MF_KW), sync_every=sync_every)
        data = jdatasets.synthetic_ratings(96, 61, 1600, rank=3, seed=3)
        rk, lb = "user", 8
    elif name == "pa":
        tr, st = passive_aggressive(mesh, PAConfig(num_features=300),
                                    sync_every=sync_every)
        data = tdatasets.synthetic_sparse_classification(1200, 300, 8,
                                                         seed=3)
        data["label"] = np.where(data["label"] > 0, 1.0, -1.0).astype(
            np.float32)
        rk, lb = None, 16
    elif name == "logreg":
        tr, st = logistic_regression(
            mesh, LogRegConfig(num_features=300, learning_rate=0.5),
            sync_every=sync_every)
        data = tdatasets.synthetic_sparse_classification(1200, 300, 8,
                                                         seed=3)
        data["label"] = (data["label"] > 0).astype(np.float32)
        rk, lb = None, 16
    else:
        cfg = tw2v.W2VConfig(vocab_size=200, dim=8, window=2, negatives=2,
                             learning_rate=0.05, subsample_t=None)
        tokens = tdatasets.synthetic_corpus(200, 3000, num_topics=4, seed=2)
        uni = np.bincount(tokens, minlength=200).astype(np.float64)
        tr, st = tw2v.word2vec_block(mesh, cfg, uni, 16,
                                     sync_every=sync_every)
        ptr, pst = tw2v.word2vec(mesh, cfg, uni, sync_every=sync_every)
        plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh,
                                       num_workers=W, block_len=16, seed=3,
                                       sync_every=sync_every, mode="block")
        chunks = list(tw2v.skipgram_chunks(
            tokens, uni, cfg, num_workers=W, local_batch=32,
            steps_per_chunk=4, sync_every=sync_every, seed=3))[:4]
        return (tr, st, plan), (ptr, pst, chunks)
    plan = DeviceEpochPlan(DeviceDataset(mesh, data), num_workers=W,
                           local_batch=lb, route_key=rk, seed=5,
                           sync_every=sync_every)
    chunks = list(multi_epoch_chunks(
        data, 2, num_workers=W, local_batch=lb, steps_per_chunk=4,
        route_key=rk, sync_every=sync_every, seed=11))[:4]
    return (tr, st, plan), (tr, st, chunks)


def _state(store, tables, local):
    """The tables' logical rows (a restore zero-fills the padding rows,
    which no id reaches) and the local state's leaves."""
    from fps_tpu_torch.core.resilience import tree_flatten

    assert set(tables) == set(store.specs)
    out = {k: store.dump_model(k)[1] for k in store.specs}
    for i, leaf in enumerate(tree_flatten(local)[0]):
        out[f"ls{i}"] = leaf.numpy()
    return out


@pytest.mark.parametrize("driver", ["fit_stream", "run_indexed"])
@pytest.mark.parametrize("sync_every", [None, 2], ids=["sync", "ssp"])
@pytest.mark.parametrize("family", ["mf", "pa", "logreg", "w2v"])
def test_resume_is_bit_for_bit(tmp_path, family, sync_every, driver):
    """A run saved every chunk (epoch), stopped, restored by a fresh
    trainer from its latest snapshot and finished from ``start_step``
    (``start_epoch``) ends with the uninterrupted run's tables and local
    state, bit for bit (a (2, 2) mesh)."""
    def build():
        indexed, stream = _family(family, _tmesh(2, 2), sync_every)
        return indexed if driver == "run_indexed" else stream

    tr, st, src = build()
    t, l = tr.init_state(0)
    if driver == "run_indexed":
        want = _state(st, *tr.run_indexed(t, l, src, 1, epochs=3)[:2])
    else:
        want = _state(st, *tr.fit_stream(t, l, src, 1)[:2])
    tr, _, src = build()
    t, l = tr.init_state(0)
    ck = tck.Checkpointer(str(tmp_path), keep=2)
    if driver == "run_indexed":
        tr.run_indexed(t, l, src, 1, epochs=2, checkpointer=ck,
                       checkpoint_every=1)
    else:
        tr.fit_stream(t, l, src[:2], 1, checkpointer=ck, checkpoint_every=1)
    assert ck.steps() == [1, 2]
    tr, st, src = build()
    _, like = tr.init_state(7)
    t, l, step = tr.restore_checkpoint(tck.Checkpointer(str(tmp_path)),
                                       like)
    assert step == 2
    if driver == "run_indexed":
        got = _state(st, *tr.run_indexed(t, l, src, 1, epochs=1,
                                         start_epoch=2)[:2])
    else:
        got = _state(st, *tr.fit_stream(t, l, src[2:], 1,
                                        start_step=2)[:2])
    assert sorted(got) == sorted(want)
    for k in want:
        _same_bits(got[k], want[k], k)


# ---------------------------------------------------------------------------
# Integrity: fallback, quarantine, sweeps, chains, compaction.
# ---------------------------------------------------------------------------

def _saved(tmp_path, n=3, **kw):
    ttr, tst = online_mf(_tmesh(1, 2), MFConfig(**MF_KW))
    t, l = ttr.init_state(0)
    ck = tck.Checkpointer(str(tmp_path), keep=5, **kw)
    states = {}
    for step, chunk in enumerate(_mf_chunks(2, n=n), 1):
        t, l, _ = ttr.run_chunk(t, l, chunk, step)
        ttr._save_checkpoint(ck, step, l)
        states[step] = tst.dump_model(ITEM)[1]
    return ttr, tst, ck, states


@pytest.mark.parametrize("corruption", ["truncate", "bitflip"])
def test_a_corrupt_newest_snapshot_falls_back_in_both_packages(
        tmp_path, devices8, corruption, journal):
    """A truncated or bit-flipped newest snapshot: a pinned read raises, an
    unpinned one falls back to the step before, moves the bad file to
    ``.corrupt`` and records the fallback; the JAX package, reading a
    copy of the same directory, falls back to the same step and array."""
    _, _, ck, states = _saved(tmp_path / "a")
    bad = chaos.corrupt_latest_snapshot(str(tmp_path / "a"), mode=corruption)
    import shutil

    shutil.copytree(tmp_path / "a", tmp_path / "b")
    rec, sink = journal
    n0 = len(sink.records)
    ck = tck.Checkpointer(str(tmp_path / "a"))
    assert not ck.verify_snapshot(3) and ck.latest_valid_step() == 2
    with pytest.raises(SnapshotCorruptionError):
        ck.read_snapshot(3)
    step, values, _, fmt = ck.read_snapshot()
    assert step == 2 and fmt == "exported"
    _same_bits(values[ITEM], states[2], "fallback")
    assert os.path.exists(bad + ".corrupt") and not os.path.exists(bad)
    assert ck.steps() == [1, 2]
    assert _trail(sink, n0) == ["checkpoint_fallback"]
    assert rec.counter_value("checkpoint.fallbacks") == 1
    jstep, jvalues, _, _ = jck.Checkpointer(str(tmp_path / "b")
                                            ).read_snapshot()
    assert jstep == 2
    _same_bits(jvalues[ITEM], values[ITEM], "jax fallback")


def test_tmp_and_corrupt_sweeps(tmp_path):
    """A stale ``.tmp.npz`` (older than ``TMP_SWEEP_AGE_S``) is swept at
    construction, a young one (a live write) kept; ``.corrupt`` files are
    kept to ``CORRUPT_KEEP``, the oldest removed."""
    d = str(tmp_path)
    os.makedirs(d, exist_ok=True)
    old = os.path.join(d, "a.tmp.npz")
    young = os.path.join(d, "b.tmp.npz")
    for p in (old, young):
        open(p, "wb").write(b"PK")
    past = time.time() - tck.Checkpointer.TMP_SWEEP_AGE_S - 10
    os.utime(old, (past, past))
    for i in range(tck.Checkpointer.CORRUPT_KEEP + 2):
        p = os.path.join(d, f"ckpt_{i:012d}.npz.corrupt")
        open(p, "wb").write(b"x")
        os.utime(p, (past + i, past + i))
        os.utime(p, (time.time() - 100 + i,) * 2)
    tck.Checkpointer(d)
    assert not os.path.exists(old) and os.path.exists(young)
    corrupt = sorted(f for f in os.listdir(d) if f.endswith(".corrupt"))
    assert len(corrupt) == tck.Checkpointer.CORRUPT_KEEP
    assert corrupt[0] == "ckpt_000000000002.npz.corrupt"


def test_gc_keeps_the_chains_of_the_newest_heads_as_the_jax_package(
        tmp_path, devices8):
    """``keep=1`` with ``DeltaPolicy(full_every=3)``: after each save only
    the newest head's chain stays on disk, the same files in both
    packages."""
    NU = 1024
    cfg = dict(num_users=NU, num_items=64, rank=4, learning_rate=0.1)
    ttr, tst = online_mf(_tmesh(1, 2), MFConfig(**cfg))
    jst = jonline_mf(_jmesh(1, 2), JMFConfig(**cfg))[1]
    t, l = ttr.init_state(0)
    data = jdatasets.synthetic_ratings(NU, 64, 1000, seed=0)
    chunks = list(multi_epoch_chunks(data, 1, num_workers=2, local_batch=8,
                                     steps_per_chunk=2, route_key="user",
                                     seed=5))[:6]
    tc = tck.Checkpointer(str(tmp_path / "p"), keep=1,
                          delta=tck.DeltaPolicy(full_every=3))
    jc = jck.Checkpointer(str(tmp_path / "j"), keep=1,
                          delta=jck.DeltaPolicy(full_every=3))
    for step, chunk in enumerate(chunks, 1):
        t, l, _ = ttr.run_chunk(t, l, chunk, step)
        ls = ttr.logic.export_local_state(l.numpy())
        tc.save(step, tst, ls, local_state_format="exported")
        jst.tables = {ITEM: jax.device_put(to_numpy(t[ITEM]), jst.sharding)}
        jc.save(step, jst, ls, local_state_format="exported")
        assert sorted(os.listdir(tmp_path / "p")) == sorted(
            os.listdir(tmp_path / "j"))
    head = max(tc.steps())
    members = tfmt.chain_members(tfmt.publications(str(tmp_path / "p")),
                                 head)
    assert len(os.listdir(tmp_path / "p")) == len(members) > 1


@pytest.mark.parametrize("phase", ["precommit", "published", "swept_one"])
def test_compaction_stopped_at_every_phase_leaves_a_recoverable_chain(
        tmp_path, phase):
    """``compact()`` dies (the hook raises) at each phase: the chain still
    resolves every step to its state, and a later ``compact()`` finishes
    the fold to a full at the head with the same arrays."""
    NU = 1024
    cfg = dict(num_users=NU, num_items=64, rank=4, learning_rate=0.1)
    ttr, tst = online_mf(_tmesh(1, 2), MFConfig(**cfg))
    t, l = ttr.init_state(0)
    data = jdatasets.synthetic_ratings(NU, 64, 1000, seed=0)
    chunks = list(multi_epoch_chunks(data, 1, num_workers=2, local_batch=8,
                                     steps_per_chunk=2, route_key="user",
                                     seed=5))[:4]
    d = str(tmp_path)
    ck = tck.Checkpointer(d, keep=8, delta=tck.DeltaPolicy(full_every=8))
    want = {}
    for step, chunk in enumerate(chunks, 1):
        t, l, _ = ttr.run_chunk(t, l, chunk, step)
        ttr._save_checkpoint(ck, step, l)
        want[step] = tst.dump_model(ITEM)[1]
    assert ck.delta_publishes == 3

    class Died(Exception):
        pass

    def hook(p):
        if p == phase:
            raise Died(p)

    ck._compact_phase_hook = hook
    with pytest.raises(Died):
        ck.compact()
    fresh = tck.Checkpointer(d)
    # The head and the base resolve to their states (a delta between them
    # may have lost its base to the sweep: only the head is a restore
    # point of the chain).
    assert {1, 4} <= set(fresh.steps()) and fresh.latest_valid_step() == 4
    for step in (1, 4):
        _same_bits(fresh.read_snapshot(step)[1][ITEM], want[step],
                   f"{phase}: step {step}")
    # A later compaction folds the chain if the fold never landed.
    fresh.compact()
    assert fresh.compactions == (phase == "precommit")
    assert tfmt.publications(d)[4].kind == "full"
    _same_bits(fresh.read_snapshot(4)[1][ITEM], want[4], "compacted")


# ---------------------------------------------------------------------------
# The async writer.
# ---------------------------------------------------------------------------

def test_async_save_deferred_runs_the_capture_on_the_writer(tmp_path,
                                                             journal):
    """``save_deferred``: the capture runs on the writer thread, the
    training thread pays the enqueue (``checkpoint.dump_seconds``), the
    writer the capture (``checkpoint.capture_seconds``); ``flush`` makes
    it durable, and ``fit_stream`` with the pipeline on saves through it,
    the same bits as inline saves."""
    ttr, tst = online_mf(_tmesh(1, 2), MFConfig(**MF_KW))
    ttr.config = dataclasses.replace(ttr.config, prefetch=2)
    t, l = ttr.init_state(0)
    chunks = _mf_chunks(2, n=4)
    ack = tck.AsyncCheckpointer(str(tmp_path / "a"), keep=8)
    threads = []
    real = tck.Checkpointer._collect

    def spy(self, *a):
        threads.append(threading.current_thread().name)
        return real(self, *a)

    tck.Checkpointer._collect = spy
    try:
        t, l, _ = ttr.fit_stream(t, l, chunks, 1, checkpointer=ack,
                                 checkpoint_every=1)
    finally:
        tck.Checkpointer._collect = real
    assert any(n.startswith("fps-ckpt-writer") for n in threads)
    assert ack.steps() == [1, 2, 3, 4]
    hists = journal[0].snapshot()["histograms"]
    assert hists["checkpoint.capture_seconds"]["count"] == 4
    assert hists["checkpoint.dump_seconds"]["count"] == 4
    ttr2, _ = online_mf(_tmesh(1, 2), MFConfig(**MF_KW))
    t2, l2 = ttr2.init_state(0)
    ck = tck.Checkpointer(str(tmp_path / "s"), keep=8)
    ttr2.fit_stream(t2, l2, chunks, 1, checkpointer=ck, checkpoint_every=1)
    _same_files(tmp_path / "a", tmp_path / "s")
    ack.close()


def test_async_when_full_degrade_skips_and_first_error_surfaces(
        tmp_path, monkeypatch, journal):
    """``when_full="degrade"``: a save that finds the slot full while the
    writer is busy is skipped (``degraded_publishes``, the backlog), never
    blocking; the next landed publish drains the backlog. A fatal write
    error reaches the caller once, on its next call, the first error
    kept."""
    ttr, tst = online_mf(_tmesh(1, 1), MFConfig(**MF_KW))
    _, l = ttr.init_state(0)
    gate = threading.Event()
    real = tck._atomic_savez

    def slow(path, arrays, precommit=None):
        gate.wait(30)
        return real(path, arrays, precommit=precommit)

    monkeypatch.setattr(tck, "_atomic_savez", slow)
    ack = tck.AsyncCheckpointer(str(tmp_path / "d"), when_full="degrade")
    ls = ttr.logic.export_local_state(l.numpy())
    ack.save(1, tst, ls, local_state_format="exported")
    deadline = time.time() + 10
    while ack._queued is not None and time.time() < deadline:
        time.sleep(0.01)  # the writer has taken step 1 and waits
    ack.save(2, tst, ls, local_state_format="exported")  # queued
    t0 = time.perf_counter()
    ack.save(3, tst, ls, local_state_format="exported")  # slot full: skip
    assert time.perf_counter() - t0 < 5
    assert ack.degraded_publishes == 1 and ack._publish_backlog == 1
    gate.set()
    ack.flush()
    assert ack.steps() == [1, 2] and ack._publish_backlog == 0
    assert journal[0].counter_value("storage.degraded_publishes") == 1
    ack.close()

    fails = []

    def fatal(path, arrays, precommit=None):
        fails.append(path)
        raise OSError(errno.EACCES, "read-only", path)

    monkeypatch.setattr(tck, "_atomic_savez", fatal)
    ack = tck.AsyncCheckpointer(str(tmp_path / "e"))
    ack.save(1, tst, ls, local_state_format="exported")
    while ack._queued is not None or ack._writing:
        time.sleep(0.01)
    with pytest.raises(RuntimeError, match="background checkpoint") as e:
        ack.save(2, tst, ls, local_state_format="exported")
    assert isinstance(e.value.__cause__, OSError)
    assert e.value.__cause__.errno == errno.EACCES
    ack.flush()  # the error surfaced once
    ack.close()


def test_fence_refuses_a_stale_writer(tmp_path, monkeypatch, journal):
    """A directory fenced at epoch 5 refuses a writer of epoch 3 and one
    without an epoch (``StaleEpochError``, also from the async writer on
    the caller's next call), and takes epoch 5; the JAX package's fence
    file is the same format. ``fence_epoch_from_env`` reads
    ``FPS_TPU_POD_EPOCH``."""
    from fps_tpu.supervise import child as jchild

    ttr, tst = online_mf(_tmesh(1, 1), MFConfig(**MF_KW))
    _, l = ttr.init_state(0)
    ls = ttr.logic.export_local_state(l.numpy())
    d = str(tmp_path)
    jchild.write_fence(d, 5, 0)
    assert tck.read_fence(d) == {"min_epoch": 5, "step": 0}
    for epoch in (3, None):
        n0 = len(journal[1].records)
        ck = tck.Checkpointer(d, fence_epoch=epoch)
        with pytest.raises(tck.StaleEpochError):
            ck.save(1, tst, ls, local_state_format="exported")
        assert _trail(journal[1], n0)[0] == "checkpoint_fenced"
    assert tck.Checkpointer(d).steps() == []
    tck.Checkpointer(d, fence_epoch=5).save(1, tst, ls)
    assert tck.Checkpointer(d).steps() == [1]
    ack = tck.AsyncCheckpointer(d, fence_epoch=4)
    ack.save(2, tst, ls)
    while ack._queued is not None or ack._writing:
        time.sleep(0.01)
    with pytest.raises(RuntimeError) as e:
        ack.flush()
    assert tck._fenced(e.value)
    ack.close()
    monkeypatch.setenv("FPS_TPU_POD_EPOCH", "7")
    assert tck.fence_epoch_from_env() == 7
    monkeypatch.delenv("FPS_TPU_POD_EPOCH")
    assert tck.fence_epoch_from_env() is None


# ---------------------------------------------------------------------------
# SIGKILL and a fresh process.
# ---------------------------------------------------------------------------

def _worker(mode, ckdir, out, timeout=120):
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    p = subprocess.Popen([sys.executable, WORKER, mode, str(ckdir),
                          str(out)], env=env, cwd=ROOT,
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    try:
        log, _ = p.communicate(timeout=timeout)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    return p.returncode, log.decode(errors="replace")[-3000:]


@pytest.mark.parametrize("victim", ["victim", "victim-midwrite",
                                    "victim-async"])
def test_sigkill_and_a_fresh_process_resume_bit_for_bit(tmp_path, victim):
    """A process SIGKILLed after epoch 3's training (before its save; mid
    write, leaving a torn tmp file; or in the async writer) resumes in a
    fresh process from its latest valid snapshot, with the newest one
    truncated first when the victim died cleanly, and ends with the
    uninterrupted run's state bit for bit."""
    rc, log = _worker("straight", tmp_path / "none", tmp_path / "a.npz")
    assert rc == 0, log
    ck = tmp_path / "ck"
    rc, log = _worker(victim, ck, tmp_path / "unused.npz")
    assert rc == -9, log  # SIGKILL, nothing else
    steps = tck.Checkpointer(str(ck)).steps()
    assert steps == [1, 2], steps
    if victim == "victim":
        chaos.corrupt_latest_snapshot(str(ck), mode="truncate")
    rc, log = _worker("resume-any", ck, tmp_path / "b.npz")
    assert rc == 0, log
    a, b = _entries(tmp_path / "a.npz"), _entries(tmp_path / "b.npz")
    for k in a:
        _same_bits(b[k], a[k], k)


def test_a_tiered_run_resumes_with_its_fold_and_restores_untiered(tmp_path):
    """MF at (2, 4) with the whole item table replicated and an Adagrad
    hot fold (window 2): saved at chunk 2 and resumed by a fresh trainer,
    it equals the uninterrupted run bit for bit, ``fold::`` state
    included; the snapshot holds one canonical table a spec (no replica),
    and an untiered trainer restores the same canonical table."""
    def build(tier=True):
        tr, st = online_mf(_tmesh(2, 4), MFConfig(**MF_KW), combine="mean")
        if tier:
            st.specs[ITEM] = dataclasses.replace(
                st.specs[ITEM], hot_tier=MF_KW["num_items"],
                dense_collectives=False)
            tr.config = dataclasses.replace(tr.config, hot_sync_every=2)
            tr.server_logic[ITEM] = dataclasses.replace(
                tr.server_logic[ITEM], hot_fold="adagrad")
        return tr, st

    chunks = _mf_chunks(8, n=4)
    tr, st = build()
    t, l = tr.init_state(0)
    t, l, _ = tr.fit_stream(t, l, chunks, 1)
    want = {"t": st.dump_model(ITEM)[1], "fold": t[ITEM + "::fold"].numpy(),
            "l": tr.logic.export_local_state(l.numpy())}
    tr, st = build()
    t, l = tr.init_state(0)
    tr.fit_stream(t, l, chunks[:2], 1, checkpointer=tck.Checkpointer(
        str(tmp_path)), checkpoint_every=2)
    saved = _entries(tmp_path / "ckpt_000000000002.npz")
    assert "fold::" + ITEM in saved and not any("::hot" in k for k in saved)
    tr, st = build()
    _, like = tr.init_state(3)
    t, l, step = tr.restore_checkpoint(tck.Checkpointer(str(tmp_path)), like)
    assert step == 2 and ITEM + "::hot" not in t
    t, l, _ = tr.fit_stream(t, l, chunks[2:], 1, start_step=2)
    _same_bits(st.dump_model(ITEM)[1], want["t"], "table")
    _same_bits(t[ITEM + "::fold"].numpy(), want["fold"], "fold")
    _same_bits(tr.logic.export_local_state(l.numpy()), want["l"], "local")
    plain, pst = build(tier=False)
    _, like = plain.init_state(3)
    plain.restore_checkpoint(tck.Checkpointer(str(tmp_path)), like, step=2)
    _same_bits(pst.dump_model(ITEM)[1], saved["table::" + ITEM],
               "untiered restore")
