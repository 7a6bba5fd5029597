"""The port's megastep (``Trainer.run_megastep``, ``core/megastep.py``,
``core/autok.py``, ``tiering/tick.py``) against the port's own
``run_indexed`` and against the JAX package's megastep.

Every non-slow case of ``tests/test_megastep.py`` is held two ways:

1. against the port's per-chunk ``run_indexed`` loop from the same state,
   bit for bit: tables, local state, metrics (the megastep's
   ``cold_dropped`` leaves stripped: ``run_indexed`` never packs) and
   checkpoints;
2. against the JAX package's ``run_megastep`` from the same tables
   (``convert.py``), within ``test_run_indexed_matches_jax``'s bounds: ``n``
   equal, ``se`` within rtol 1e-5 and atol 1e-7, the tables within 1e-6 of
   O(0.1) factors, the vote counters equal and, after ticks, the same hot
   ids.

The JAX side runs on the 8 virtual CPU devices of the test process, the
port's on ``make_ps_mesh(4, 2, device="cpu")``; seed 1 on the port stands
for ``jax.random.key(1)``. Where draws enter (negative sampling) the two
packages draw differently, and the case holds ``n`` and the vote counters
only. The tick's case takes data whose epoch is whole calls and whole
dispatches (the JAX package runs the trailing segments of an epoch's last
dispatch as weight-0 phantoms and ticks after them; the port runs real
segments only). ``test_megastep_kill_scenario`` waits for the supervisor
(ROADMAP.md Queue 1 item 9c).

Also held: the helpers against their counterparts (``device_top_ids``,
``device_slot_map``, the device re-split, ``derive_chunks_per_dispatch``),
and the host reads the dispatch adds: none in the tick, one a group in the
vote.
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fps_tpu import obs as jobs
from fps_tpu import sketch as jsketch
from fps_tpu.core import autok as jautok
from fps_tpu.core import device_ingest as jdi
from fps_tpu.core import resilience as jresilience
from fps_tpu.core import store as jstore
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.tiering import MegastepTick as JMegastepTick
from fps_tpu.tiering import device_top_ids as jdevice_top_ids
from fps_tpu.utils.datasets import synthetic_ratings

from fps_tpu_torch import (
    DeviceDataset,
    DeviceEpochPlan,
    MFConfig,
    make_ps_mesh,
    obs,
    online_mf,
)
from fps_tpu_torch import sketch as sklib
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import autok, megastep, resilience
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.core.checkpoint import Checkpointer
from fps_tpu_torch.core.store import hot_key, ids_key, map_key
from fps_tpu_torch.tiering import MegastepTick, Retierer, device_top_ids
from fps_tpu_torch.tiering.retier import top_ids

NU, NI, RANK = 57, 31, 4
LOCAL_BATCH, T_CALL = 8, 4
ITEM = "item_factors"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def data():
    return synthetic_ratings(NU, NI, 1003, seed=0)


@pytest.fixture(scope="module")
def skewed_data():
    """Items concentrated on the leading head [0, 16): certifies small
    cold budgets."""
    rng = np.random.default_rng(0)
    n = 1000
    item = np.where(rng.random(n) < 0.95, rng.integers(0, 16, n),
                    rng.integers(16, NI, n)).astype(np.int32)
    return {"user": rng.integers(0, NU, n).astype(np.int32), "item": item,
            "rating": rng.normal(size=n).astype(np.float32)}


@pytest.fixture(scope="module")
def drift_data():
    """The tick case's stream: its true head is not the static [0, 16). At
    57 users, 8 workers and batches of 8 an epoch is 24 steps: 6 calls of
    4, 3 dispatches of 2."""
    rng = np.random.default_rng(0)
    n = 1200
    item = np.where(rng.random(n) < 0.9, rng.integers(15, NI, n),
                    rng.integers(0, 15, n)).astype(np.int32)
    return {"user": rng.integers(0, NU, n).astype(np.int32), "item": item,
            "rating": rng.normal(size=n).astype(np.float32)}


@pytest.fixture(scope="module")
def poisoned_data():
    rng = np.random.default_rng(1)
    n = 1003
    d = {"user": rng.integers(0, NU, n).astype(np.int32),
         "item": rng.integers(0, NI, n).astype(np.int32),
         "rating": rng.normal(size=n).astype(np.float32)}
    d["rating"][100:160] = np.nan
    return d


@pytest.fixture(scope="module")
def tmesh():
    return make_ps_mesh(4, 2, device="cpu")


@pytest.fixture(scope="module")
def jmesh8(devices8):
    return jmesh.make_ps_mesh(num_shards=4, num_data=2, devices=devices8[:8])


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's megastep runs, by case: each is run once."""
    return {}


def _tier(trainer, store, hot_tier, cold_budget, hot_sync_every):
    if hot_tier:
        store.specs[ITEM] = dataclasses.replace(
            store.specs[ITEM], hot_tier=hot_tier, cold_budget=cold_budget,
            dense_collectives=False)
        trainer.config = dataclasses.replace(trainer.config,
                                             hot_sync_every=hot_sync_every)


def _make(mesh, data, *, hot_tier=0, cold_budget=0, hot_sync_every=1,
          sync_every=None, guard=None, negative_samples=0):
    """The port's trainer, store and plan of ``tests/test_megastep.py``'s
    ``_make``."""
    cfg = MFConfig(num_users=NU, num_items=NI, rank=RANK,
                   negative_samples=negative_samples)
    trainer, store = online_mf(mesh, cfg, sync_every=sync_every,
                               max_steps_per_call=T_CALL, guard=guard)
    _tier(trainer, store, hot_tier, cold_budget, hot_sync_every)
    plan = DeviceEpochPlan(DeviceDataset(mesh, data), num_workers=8,
                           local_batch=LOCAL_BATCH, route_key="user", seed=3,
                           sync_every=sync_every)
    return trainer, store, plan


def _jmake(mesh, data, *, hot_tier=0, cold_budget=0, hot_sync_every=1,
           sync_every=None, guard=None, negative_samples=0):
    """The JAX package's, as its test makes them."""
    cfg = JMFConfig(num_users=NU, num_items=NI, rank=RANK,
                    negative_samples=negative_samples)
    trainer, store = jonline_mf(mesh, cfg, sync_every=sync_every,
                                max_steps_per_call=T_CALL, guard=guard)
    _tier(trainer, store, hot_tier, cold_budget, hot_sync_every)
    plan = jdi.DeviceEpochPlan(
        jdi.DeviceDataset(mesh, data), num_workers=8,
        local_batch=LOCAL_BATCH, route_key="user", seed=3,
        sync_every=sync_every)
    return trainer, store, plan


def _jax_state(jtr):
    tables, local = jtr.init_state(jax.random.key(0))
    return {k: np.asarray(v) for k, v in tables.items()}, np.asarray(local)


def _port_state(trainer, store, jstate):
    """The port's tables and local state converted from the JAX package's
    initial state."""
    tables = tables_from_jax(store, jstate[0])
    local = local_state_from_jax(trainer.logic, jstate[1],
                                 mesh=trainer.mesh)
    return tables, local


def _strip(tree):
    """A metrics tree without the megastep's ``cold_dropped`` leaves."""
    if not isinstance(tree, dict):
        return tree
    return {k: _strip(v) for k, v in tree.items() if k != "cold_dropped"}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _epochs(per_megastep, epochs):
    """Each epoch's metrics, the megasteps' trees joined along the step
    axis."""
    M = len(per_megastep) // epochs
    out = []
    for e in range(epochs):
        parts = [_flat(jax.tree.map(np.asarray, p)
                       if not isinstance(p, dict) else p)
                 for p in per_megastep[e * M:(e + 1) * M]]
        out.append({k: np.concatenate([p[k] for p in parts])
                    for k in parts[0]})
    return out


def _assert_same_run(a, b):
    """Two of the port's runs, ``(tables, local, per-epoch flat metrics)``,
    bit for bit."""
    ta, tb = to_numpy(a[0]), to_numpy(b[0])
    assert sorted(ta) == sorted(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)
    np.testing.assert_array_equal(to_numpy(a[1]), to_numpy(b[1]))
    assert len(a[2]) == len(b[2])
    for ma, mb in zip(a[2], b[2]):
        assert sorted(ma) == sorted(mb)
        for k in ma:
            np.testing.assert_array_equal(ma[k], mb[k], err_msg=k)


def _assert_close_to_jax(port, jax_run):
    """The port's megastep against the JAX package's: ``n`` equal, ``se``
    within rtol 1e-5 and atol 1e-7, the tables (hot tier entries
    included) within 1e-6, the local state too."""
    tt, jt = to_numpy(port[0]), jax_run[0]
    assert sorted(tt) == sorted(jt)
    for k, v in jt.items():
        if tt[k].dtype.kind == "f":
            np.testing.assert_allclose(tt[k], v, rtol=0, atol=1e-6,
                                       err_msg=k)
        else:
            np.testing.assert_array_equal(tt[k], v, err_msg=k)
    np.testing.assert_allclose(to_numpy(port[1]), jax_run[1], rtol=0,
                               atol=1e-6)
    assert len(port[2]) == len(jax_run[2])
    for pm, jm in zip(port[2], jax_run[2]):
        np.testing.assert_array_equal(pm["n"], jm["n"])
        np.testing.assert_allclose(pm["se"], jm["se"], rtol=1e-5, atol=1e-7)


VOTES = ("cold_route.vote_compact_windows",
         "cold_route.vote_overflow_windows", "megastep.windows")


def _counters(rec):
    return {k: rec.counter_value(k) for k in VOTES}


def _run_jax(jax_runs, case, jmesh8, d, *, epochs=2, K=2, tick=False, **kw):
    """The JAX package's megastep of ``case`` (from its own initial state),
    run once: ``(tables, local, per-epoch flat metrics, counters,
    initial state, trainer)``."""
    if case not in jax_runs:
        jtr, jst, jp = _jmake(jmesh8, d, **kw)
        state = _jax_state(jtr)
        rec = jobs.Recorder(sinks=[])
        jt, jl = jtr.init_state(jax.random.key(0))
        jt, jl, jm = jtr.run_megastep(
            jt, jl, jp, jax.random.key(1), epochs=epochs,
            chunks_per_dispatch=K, recorder=rec,
            tick=JMegastepTick(check_every=1, churn_threshold=-1.0)
            if tick else None)
        tables = {k: np.asarray(v) for k, v in jst.tables.items()}
        jax_runs[case] = (tables, np.asarray(jl), _epochs(jm, epochs),
                          _counters(rec), state, jtr, rec)
    return jax_runs[case]


def _run_pair(tmesh, jmesh8, jax_runs, case, d, *, epochs=2, K=2,
              jax_check=True, **kw):
    """The case on the port through ``run_indexed`` and ``run_megastep``
    from the JAX package's initial state, bit for bit; the megastep within
    the bounds of the JAX package's (``jax_check``). Returns the megastep's
    ``(trainer, store, recorder, metrics)`` and the JAX run."""
    jrun = _run_jax(jax_runs, case, jmesh8, d, epochs=epochs, K=K, **kw)
    tr1, st1, p1 = _make(tmesh, d, **kw)
    t1, l1 = _port_state(tr1, st1, jrun[4])
    t1, l1, m1 = tr1.run_indexed(t1, l1, p1, 1, epochs=epochs)
    tr2, st2, p2 = _make(tmesh, d, **kw)
    t2, l2 = _port_state(tr2, st2, jrun[4])
    rec = obs.Recorder(sinks=[])
    t2, l2, m2 = tr2.run_megastep(t2, l2, p2, 1, epochs=epochs,
                                  chunks_per_dispatch=K, recorder=rec)
    mega = _epochs([_strip(m) for m in m2], epochs)
    _assert_same_run((st1.tables, l1, [_flat(m) for m in m1]),
                     (tr2.store.tables, l2, mega))
    if jax_check:
        _assert_close_to_jax((tr2.store.tables, l2, _epochs(m2, epochs)),
                             jrun)
        assert _counters(rec) == jrun[3]
    return tr2, st2, rec, m2, jrun


# -- bit-identity with the per-chunk loop ------------------------------------

def test_megastep_matches_indexed_untiered(tmesh, jmesh8, jax_runs, data):
    _run_pair(tmesh, jmesh8, jax_runs, "untiered", data)


def test_megastep_matches_indexed_guard_mask(tmesh, jmesh8, jax_runs, data):
    _run_pair(tmesh, jmesh8, jax_runs, "guard", data, guard="mask")


def test_megastep_matches_indexed_tiered_partial(tmesh, jmesh8, jax_runs,
                                                 data):
    _run_pair(tmesh, jmesh8, jax_runs, "tiered", data, hot_tier=16,
              hot_sync_every=2)


def test_megastep_matches_indexed_ssp(tmesh, jmesh8, jax_runs, data):
    _run_pair(tmesh, jmesh8, jax_runs, "ssp", data, sync_every=2)


def test_megastep_uncertifiable_logic_stays_static(tmesh, jmesh8, jax_runs,
                                                   data):
    """Negative sampling draws ids in ``prepare``: no segment can vote, each
    takes the static routes and counts as an overflow, bit for bit with the
    per-chunk loop. The two packages draw differently, so against the JAX
    package only ``n`` and the vote counters are held."""
    _, _, rec, m2, jrun = _run_pair(
        tmesh, jmesh8, jax_runs, "uncertifiable", data, hot_tier=16,
        hot_sync_every=2, cold_budget=4, negative_samples=2, jax_check=False)
    assert rec.counter_value("cold_route.vote_compact_windows") == 0
    assert rec.counter_value("cold_route.vote_overflow_windows") > 0
    assert _counters(rec) == jrun[3]
    for pm, jm in zip(_epochs(m2, 2), jrun[2]):
        np.testing.assert_array_equal(pm["n"], jm["n"])


# -- the overflow vote --------------------------------------------------------

def test_vote_fits_runs_compacted_and_matches(tmesh, jmesh8, jax_runs,
                                              skewed_data):
    _, _, rec, m, _ = _run_pair(tmesh, jmesh8, jax_runs, "vote_fits",
                                skewed_data, hot_tier=16, hot_sync_every=2,
                                cold_budget=8)
    assert rec.counter_value("cold_route.vote_compact_windows") > 0
    dropped = sum(int(np.sum(mm["hot_tier"][ITEM].get("cold_dropped", 0)))
                  for mm in m)
    assert dropped == 0


def test_vote_fits_takes_the_compacted_lanes(tmesh, skewed_data,
                                             monkeypatch):
    """The certified segments really pack their lanes (``compact_cold`` runs
    in their pulls and pushes), the static ones do not."""
    from fps_tpu_torch.core import driver

    calls = []
    real = driver.compact_cold
    monkeypatch.setattr(driver, "compact_cold",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    tr, _, p = _make(tmesh, skewed_data, hot_tier=16, hot_sync_every=2,
                     cold_budget=8)
    t, ls = tr.init_state(0)
    rec = obs.Recorder(sinks=[])
    tr.run_megastep(t, ls, p, 1, epochs=1, chunks_per_dispatch=2,
                    recorder=rec)
    fit = rec.counter_value("cold_route.vote_compact_windows")
    assert fit > 0
    # Each worker packs once in the pull and once in the push a step.
    assert len(calls) == 2 * 8 * T_CALL * fit


def test_megastep_windows_counts_real_segments(tmesh, jmesh8, jax_runs,
                                               data):
    """K = 4 leaves a short last dispatch; ``megastep.windows`` counts its
    real segments only: every chunk call of the two epochs."""
    tr, _, rec, _, _ = _run_pair(tmesh, jmesh8, jax_runs, "windows_k4", data,
                                 K=4)
    _, _, plan = _make(tmesh, data)
    n_calls = plan.calls_per_epoch(tr._indexed_call_steps(plan))
    assert n_calls % 4 != 0  # a trimmed dispatch exists
    assert rec.counter_value("megastep.windows") == 2 * n_calls


def test_vote_totals_count_real_windows_only(tmesh, jmesh8, jax_runs,
                                             skewed_data):
    tr, _, rec, _, _ = _run_pair(tmesh, jmesh8, jax_runs, "votes_k4",
                                 skewed_data, K=4, hot_tier=16,
                                 hot_sync_every=2, cold_budget=8)
    _, _, plan = _make(tmesh, skewed_data, hot_tier=16, hot_sync_every=2,
                       cold_budget=8)
    n_calls = plan.calls_per_epoch(tr._indexed_call_steps(plan))
    assert n_calls % 4 != 0
    total = (rec.counter_value("cold_route.vote_compact_windows")
             + rec.counter_value("cold_route.vote_overflow_windows"))
    assert total == 2 * n_calls
    assert rec.counter_value("megastep.windows") == 2 * n_calls


def test_vote_overflow_falls_back_bit_identical(tmesh, jmesh8, jax_runs,
                                                skewed_data):
    _, _, rec, _, _ = _run_pair(tmesh, jmesh8, jax_runs, "overflow",
                                skewed_data, hot_tier=16, hot_sync_every=2,
                                cold_budget=1)
    assert rec.counter_value("cold_route.vote_overflow_windows") > 0


# -- checkpoints --------------------------------------------------------------

def test_megastep_checkpoint_resume_bit_identical(tmesh, jmesh8, jax_runs,
                                                  data, tmp_path):
    """A straight run saving at every megastep; a run stopped after one
    epoch, restored by a fresh trainer and resumed at ``start_megastep``:
    the same rows, replica and checkpoints; and the straight run's save
    after epoch 1 equals the per-chunk loop's. The resumed end within the
    bounds of the JAX package's megastep."""
    kw = dict(hot_tier=16, hot_sync_every=2)
    jrun = _run_jax(jax_runs, "tiered", jmesh8, data, **kw)
    tr1, st1, p1 = _make(tmesh, data, **kw)
    t1, l1 = _port_state(tr1, st1, jrun[4])
    ck1 = Checkpointer(str(tmp_path / "straight"), keep=20)
    t1, l1, _ = tr1.run_megastep(t1, l1, p1, 1, epochs=2,
                                 chunks_per_dispatch=2, checkpointer=ck1,
                                 checkpoint_every=1)
    tr2, st2, p2 = _make(tmesh, data, **kw)
    t2, l2 = _port_state(tr2, st2, jrun[4])
    ck2 = Checkpointer(str(tmp_path / "resumed"), keep=20)
    tr2.run_megastep(t2, l2, p2, 1, epochs=1, chunks_per_dispatch=2,
                     checkpointer=ck2, checkpoint_every=1)
    M = -(-p2.calls_per_epoch(T_CALL) // 2)
    assert ck2.latest_valid_step() == M
    tr3, st3, p3 = _make(tmesh, data, **kw)
    _, l3 = tr3.init_state(0)
    ck3 = Checkpointer(str(tmp_path / "resumed"), keep=20)
    t3, l3, _ = tr3.restore_checkpoint(ck3, l3)
    t3, l3, _ = tr3.run_megastep(t3, l3, p3, 1, epochs=2,
                                 chunks_per_dispatch=2, checkpointer=ck3,
                                 checkpoint_every=1, start_megastep=M)
    ids = np.arange(NI)
    np.testing.assert_array_equal(st1.lookup_host(ITEM, ids),
                                  st3.lookup_host(ITEM, ids))
    np.testing.assert_array_equal(
        tr1.store.tables[hot_key(ITEM)].numpy(),
        tr3.store.tables[hot_key(ITEM)].numpy())
    for g in range(M, 2 * M + 1):
        _, va, la, _ = ck1.read_snapshot(g)
        _, vb, lb, _ = ck3.read_snapshot(g)
        for k in va:
            np.testing.assert_array_equal(np.asarray(va[k]),
                                          np.asarray(vb[k]), err_msg=k)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    # The per-chunk loop's epoch-1 state is the straight run's step-M save.
    tr4, st4, p4 = _make(tmesh, data, **kw)
    t4, l4 = _port_state(tr4, st4, jrun[4])
    ck4 = Checkpointer(str(tmp_path / "indexed"), keep=20)
    tr4.run_indexed(t4, l4, p4, 1, epochs=1, checkpointer=ck4,
                    checkpoint_every=1)
    _, va, la, _ = ck1.read_snapshot(M)
    _, vb, lb, _ = ck4.read_snapshot(1)
    for k in va:
        np.testing.assert_array_equal(np.asarray(va[k]), np.asarray(vb[k]),
                                      err_msg=k)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)
    # The resumed end against the JAX package's straight run: logical rows
    # (a restored table's padding rows are derived anew, as is the user
    # table's), replica, users.
    np.testing.assert_allclose(st3.lookup_host(ITEM, ids),
                               jrun[5].store.lookup_host(ITEM, ids), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tr3.store.tables[hot_key(ITEM)].numpy(),
                               jrun[0][hot_key(ITEM)], rtol=0, atol=1e-6)
    users = np.arange(NU)
    rows = (users % 8) * (-(-NU // 8)) + users // 8
    np.testing.assert_allclose(l3.numpy()[rows], jrun[1][rows], rtol=0,
                               atol=1e-6)


# -- the guard and rollback a megastep at a time ------------------------------

def test_megastep_quarantine_matches_preset_skip(tmesh, jmesh8,
                                                 poisoned_data):
    """A megastep with NaN ratings in its chunks is quarantined (the state
    before it restored, its index recorded) and the run equals one that
    skips it by preset; the JAX package quarantines the same megastep, and
    the tables agree within the bound."""
    def go(rollback):
        tr, st, p = _make(tmesh, poisoned_data, guard="mask")
        t, ls = tr.init_state(0)
        tr.run_megastep(t, ls, p, 1, epochs=1, chunks_per_dispatch=2,
                        rollback=rollback)
        return st

    rb1 = resilience.RollbackPolicy()
    st1 = go(rb1)
    assert rb1.quarantined, "the poisoned megastep was not quarantined"
    rb2 = resilience.RollbackPolicy(preset=frozenset(rb1.quarantined))
    st2 = go(rb2)
    assert sorted(rb2.skipped) == sorted(rb1.quarantined)
    for k in st1.tables:
        np.testing.assert_array_equal(st1.tables[k].numpy(),
                                      st2.tables[k].numpy())
    jtr, jst, jp = _jmake(jmesh8, poisoned_data, guard="mask")
    state = _jax_state(jtr)
    jt, jl = jtr.init_state(jax.random.key(0))
    jrb = jresilience.RollbackPolicy()
    jtr.run_megastep(jt, jl, jp, jax.random.key(1), epochs=1,
                     chunks_per_dispatch=2, rollback=jrb)
    assert jrb.quarantined == rb1.quarantined
    tr3, st3, p3 = _make(tmesh, poisoned_data, guard="mask")
    t3, l3 = _port_state(tr3, st3, state)
    tr3.run_megastep(t3, l3, p3, 1, epochs=1, chunks_per_dispatch=2,
                     rollback=resilience.RollbackPolicy())
    np.testing.assert_allclose(to_numpy(st3.tables)[ITEM],
                               np.asarray(jst.tables[ITEM]), rtol=0,
                               atol=1e-6)


def test_health_by_segment_unit():
    metrics = {"health": {"t": {
        "nonfinite": np.array([0, 0, 3, 0, 0, 1, 0, 0]),
        "norm": np.array([0, 0, 0, 0, 0, 0, 0, 2]),
    }}}
    short = {"health": {"t": {"nonfinite": np.array([1, 0, 0])}}}
    for fn in (resilience.health_by_segment, jresilience.health_by_segment):
        assert fn(metrics, 2, 4) == [3, 3]
        assert fn(short, 2, 4) == [1, 0]
        assert fn({}, 3, 4) == [0, 0, 0]


# -- the tier tick ------------------------------------------------------------

def test_device_dcm_fold_matches_host():
    spec = sklib.DecayedCountMinSpec(depth=3, width=64, half_every=2)
    jspec = jsketch.DecayedCountMinSpec(depth=3, width=64, half_every=2)
    rng = np.random.default_rng(0)
    state = rng.random((3, 64)).astype(np.float32)
    window = rng.random((3, 64)).astype(np.float32)
    for tick in (0, 1, 2, 3, 4):
        host = sklib.dcm_fold(spec, state, window, tick)
        dev = sklib.dcm_fold_traced(spec, torch.from_numpy(state),
                                    torch.from_numpy(window),
                                    torch.tensor(tick, dtype=torch.int32))
        np.testing.assert_array_equal(host, dev.numpy())
        want = jax.jit(lambda s, w, t: jsketch.dcm_fold_traced(
            jspec, s, w, t))(state, window, np.int32(tick))
        np.testing.assert_array_equal(dev.numpy(), np.asarray(want))


@pytest.mark.parametrize("n,alphabet", [(200, 5), (4096, 3), (97, 1)])
def test_device_top_ids_matches_host(n, alphabet):
    """Heavy ties (a small alphabet of counts) force the id tie-break: the
    port's device ranking, its host ``top_ids`` and the JAX package's
    ``device_top_ids`` pick the same ids in the same order."""
    rng = np.random.default_rng(n)
    est = rng.integers(0, alphabet, n).astype(np.float32)
    for H in sorted({1, 7, 50, n // 2, n}):
        got = device_top_ids(torch.from_numpy(est), H).numpy()
        assert got.dtype == np.int32
        np.testing.assert_array_equal(got.astype(np.int64), top_ids(est, H))
        np.testing.assert_array_equal(got, np.asarray(jdevice_top_ids(est,
                                                                      H)))


@pytest.mark.parametrize("num_ids,H", [(10, 3), (300, 50), (31, 31)])
def test_device_slot_map_matches_hot_slot_map(num_ids, H):
    rng = np.random.default_rng(num_ids)
    gids = rng.choice(num_ids, H, replace=False).astype(np.int32)
    got = tstore.device_slot_map(num_ids, torch.from_numpy(gids))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(),
                                  tstore.hot_slot_map(num_ids, gids))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jstore.device_slot_map(num_ids, gids)))


@pytest.mark.parametrize("D,S,dim", [(2, 4, 4), (1, 8, 1), (1, 1, 3)])
def test_device_resplit_equals_rows_replica(D, S, dim):
    """The re-split from device ids (``replica_from_shard``) equals
    ``ParamStore.rows_replica`` bit for bit, ``-0.0`` kept, on every
    position (K1, or K5 on a scalar table)."""
    mesh = make_ps_mesh(S, D, device="cpu")
    store = tstore.ParamStore(mesh, [tstore.TableSpec("t", 50, dim)])
    tables = store.init(3)
    blocks = tables["t"]
    for b in blocks:
        b[::3] = -0.0
    gids = np.random.default_rng(dim).choice(50, 12, replace=False)
    want = store.rows_replica("t", gids, blocks)
    got = tstore.replica_from_shard(mesh, blocks, torch.from_numpy(
        gids.astype(np.int32)), num_shards=S)
    assert len(got) == len(want) == D * S
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == (12, dim)
        np.testing.assert_array_equal(g.numpy().view(np.uint32),
                                      w.numpy().view(np.uint32))
    np.testing.assert_array_equal(got[0].numpy(),
                                  store.lookup_host("t", gids))
    assert np.signbit(got[0].numpy()).any()


def _tick_run(tmesh, d, *, tables=None, local=None):
    tr, st, p = _make(tmesh, d, hot_tier=16, hot_sync_every=2)
    tick = MegastepTick(check_every=1, churn_threshold=-1.0)
    if tables is None:
        tables, local = tr.init_state(0)
    rec = obs.Recorder(sinks=[])
    tables, local, m = tr.run_megastep(tables, local, p, 1, epochs=2,
                                       chunks_per_dispatch=2, tick=tick,
                                       recorder=rec)
    return tr, tick, rec, local, m


def test_megastep_tick_reranks_deterministic(tmesh, jmesh8, jax_runs,
                                             drift_data):
    """A stream whose true head is not the static [0, 16) is re-ranked onto
    it by the tick; the replica stays the canonical rows of the hot ids,
    the slot map their order, the host mirrors synced, and a second run
    equals the first bit for bit. From the JAX package's state, the tick
    picks the JAX package's hot ids, and the run stays within its
    bounds."""
    tr, tick, rec, _, _ = _tick_run(tmesh, drift_data)
    gids = tr.store.tables[ids_key(ITEM)].numpy()
    assert len(set(gids.tolist()) & set(range(15, NI))) >= 14
    assert rec.counter_value("tiering.re_ranks", table=ITEM) >= 1
    np.testing.assert_array_equal(tr.store.tables[hot_key(ITEM)].numpy(),
                                  tr.store.lookup_host(ITEM, gids))
    smap = tr.store.tables[map_key(ITEM)].numpy()
    np.testing.assert_array_equal(smap[gids], np.arange(len(gids)))
    np.testing.assert_array_equal(tick.hot_ids[ITEM], gids)
    assert tick.tick > 0
    tr2, tick2, _, _, _ = _tick_run(tmesh, drift_data)
    a, b = to_numpy(tr.store.tables), to_numpy(tr2.store.tables)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    # Against the JAX package, from its state.
    jrun = _run_jax(jax_runs, "tick", jmesh8, drift_data, tick=True,
                    hot_tier=16, hot_sync_every=2)
    tr3, st3, _ = _make(tmesh, drift_data, hot_tier=16, hot_sync_every=2)
    t3, l3 = _port_state(tr3, st3, jrun[4])
    tr3, tick3, rec3, l3, m3 = _tick_run(tmesh, drift_data, tables=t3,
                                         local=l3)
    jtick = jrun[5].retierer
    np.testing.assert_array_equal(tick3.hot_ids[ITEM],
                                  jtick.hot_ids[ITEM])
    assert tick3.tick == jtick.tick
    np.testing.assert_allclose(tick3.state[ITEM], jtick.state[ITEM],
                               rtol=0, atol=0)
    assert (rec3.counter_value("tiering.re_ranks", table=ITEM)
            == jrun[6].counter_value("tiering.re_ranks", table=ITEM))
    _assert_close_to_jax((tr3.store.tables, l3, _epochs(m3, 2)), jrun)


def test_tick_at_the_epoch_end_equals_run_indexed_with_a_retierer(
        tmesh, drift_data):
    """One dispatch an epoch with its tick at the epoch's end is the host
    boundary of ``run_indexed`` with a ``Retierer`` checking every epoch:
    the same hot ids, decayed sketch, tables, replica, maps and windows,
    bit for bit (the device fold, ranking and re-split against the host's),
    the lanes of the vote against the static routes included."""
    kw = dict(hot_tier=16, hot_sync_every=2, cold_budget=8)
    tr1, st1, p1 = _make(tmesh, drift_data, **kw)
    tr1.retierer = rt = Retierer(check_every=1, churn_threshold=-1.0)
    t1, l1 = tr1.init_state(0)
    t1, l1, m1 = tr1.run_indexed(t1, l1, p1, 1, epochs=2)
    tr2, st2, p2 = _make(tmesh, drift_data, **kw)
    n_calls = p2.calls_per_epoch(T_CALL)
    tick = MegastepTick(check_every=n_calls, churn_threshold=-1.0)
    t2, l2 = tr2.init_state(0)
    rec = obs.Recorder(sinks=[])
    t2, l2, m2 = tr2.run_megastep(t2, l2, p2, 1, epochs=2,
                                  chunks_per_dispatch=n_calls, tick=tick,
                                  recorder=rec)
    assert rt.re_ranks >= 1
    assert rec.counter_value("tiering.re_ranks", table=ITEM) == rt.re_ranks
    assert rec.counter_value("cold_route.vote_compact_windows") > 0
    np.testing.assert_array_equal(tick.hot_ids[ITEM], rt.hot_ids[ITEM])
    np.testing.assert_array_equal(tick.state[ITEM], rt.state[ITEM])
    assert tick.tick == rt.tick == 2
    _assert_same_run((st1.tables, l1, [_flat(m) for m in m1]),
                     (st2.tables, l2, _epochs([_strip(m) for m in m2], 2)))


def test_tick_adds_no_host_read_and_the_vote_one_a_group(tmesh, drift_data,
                                                        monkeypatch):
    """Every call that reads a tensor back to the host (``item``,
    ``tolist``, ``numpy``, ``cpu``, ``bool``, ``int``, ``float``,
    ``index``) is counted while the tick or the vote runs: the tick makes
    none, the vote one a group, with a tick every 2 segments and the vote
    on the mapped tier's lanes."""
    reads = {"tick": 0, "vote": 0}
    inside = []
    for name in ("item", "tolist", "numpy", "cpu", "__bool__", "__int__",
                 "__float__", "__index__"):
        fn = getattr(torch.Tensor, name)

        def counted(*a, _fn=fn, **k):
            if inside:
                reads[inside[-1]] += 1
            return _fn(*a, **k)

        monkeypatch.setattr(torch.Tensor, name, counted)

    def within(kind, fn):
        def wrapped(*a, **k):
            inside.append(kind)
            try:
                return fn(*a, **k)
            finally:
                inside.pop()
        return wrapped

    groups = []
    monkeypatch.setattr(megastep, "apply_tick",
                        within("tick", megastep.apply_tick))
    vote = within("vote", megastep.group_votes)
    monkeypatch.setattr(megastep, "group_votes",
                        lambda *a, **k: groups.append(1) or vote(*a, **k))
    tr, _, p = _make(tmesh, drift_data, hot_tier=16, hot_sync_every=2,
                     cold_budget=8)
    tick = MegastepTick(check_every=2, churn_threshold=-1.0)
    t, ls = tr.init_state(0)
    rec = obs.Recorder(sinks=[])
    tr.run_megastep(t, ls, p, 1, epochs=1, chunks_per_dispatch=4, tick=tick,
                    recorder=rec)
    assert tr._mapped_tables() == {ITEM: 16}
    assert len(groups) >= 2
    assert reads == {"tick": 0, "vote": len(groups)}
    assert rec.counter_value("tiering.re_ranks", table=ITEM) >= 1
    assert rec.counter_value("cold_route.vote_compact_windows") > 0


# -- validation ---------------------------------------------------------------

@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_megastep_validations(tmesh, jmesh8, data, pkg):
    """Both packages refuse the same calls with the same exception types
    and words, and a refused tick is never left attached."""
    if pkg == "port":
        make, Tick, Host, key = (lambda **kw: _make(tmesh, data, **kw),
                                 MegastepTick, Retierer, 1)
    else:
        from fps_tpu.tiering import Retierer as JRetierer

        make, Tick, Host, key = (lambda **kw: _jmake(jmesh8, data, **kw),
                                 JMegastepTick, JRetierer,
                                 jax.random.key(1))
    tr, _, p = make()
    t, ls = tr.init_state(0 if pkg == "port" else jax.random.key(0))
    tr.config = dataclasses.replace(tr.config, push_delay=2)
    with pytest.raises(ValueError, match="push_delay"):
        tr.run_megastep(t, ls, p, key)
    tr.config = dataclasses.replace(tr.config, push_delay=0, auto_tier=True)
    with pytest.raises(ValueError, match="auto_tier"):
        tr.run_megastep(t, ls, p, key)
    tr.config = dataclasses.replace(tr.config, auto_tier=False)
    with pytest.raises(ValueError, match="chunks_per_dispatch"):
        tr.run_megastep(t, ls, p, key, chunks_per_dispatch=0)
    tr.retierer = Host()
    with pytest.raises(ValueError, match="MegastepTick"):
        tr.run_megastep(t, ls, p, key)
    tr.retierer = None
    with pytest.raises(ValueError, match="mapped tier"):
        tr.run_megastep(t, ls, p, key, tick=Tick())
    assert tr.retierer is None
    with pytest.raises(TypeError, match="MegastepTick"):
        tr.run_megastep(t, ls, p, key, tick=Host())
    assert tr.retierer is None
    tr2, _, p2 = make(hot_tier=16, hot_sync_every=2)
    t2, l2 = tr2.init_state(0 if pkg == "port" else jax.random.key(0))
    with pytest.raises(ValueError, match="multiple"):
        tr2.run_megastep(t2, l2, p2, key, chunks_per_dispatch=3,
                         tick=Tick(check_every=2))
    assert tr2.retierer is None
    with pytest.raises(ValueError, match="multiple"):
        tr2.lowered_megastep_text(p2, chunks_per_dispatch=3,
                                  tick=Tick(check_every=2))
    if pkg == "port":
        # Lowering is taken (the program auditor): a certifiable record,
        # with the tick left detached.
        from fps_tpu_torch.analysis import certify, contract_for_trainer

        text = tr2.lowered_megastep_text(p2, chunks_per_dispatch=4,
                                         tick=Tick(check_every=2))
        assert tr2.retierer is None
        tr2.retierer = Tick(check_every=2)
        assert certify(text, contract_for_trainer(
            tr2, program="megastep")).ok
        tr2.retierer = None


# -- auto-K -------------------------------------------------------------------

def test_auto_k_derivation_fixed_points():
    """The pure derivation on fixed calibration traces, both packages':
    the smallest K with h / (h + K c) <= share, rounded to the cadence,
    capped by max_k and an epoch's calls."""
    for derive in (autok.derive_chunks_per_dispatch,
                   jautok.derive_chunks_per_dispatch):
        assert derive(0.001, 0.001, target_share=0.05) == 19
        assert derive(0.001, 0.001, target_share=0.05, multiple_of=4) == 20
        assert derive(0.1, 0.001, target_share=0.05, max_k=64) == 64
        assert derive(0.1, 0.001, target_share=0.05, max_k=62,
                      multiple_of=4) == 60
        assert derive(0.0, 0.001) == 1
        assert derive(0.0, 0.001, multiple_of=4) == 4
        assert derive(0.001, 0.0, max_k=32) == 32
        assert derive(0.001, 0.001, n_calls=6) == 6
        assert derive(0.001, 0.001, n_calls=6, multiple_of=4) == 8
        with pytest.raises(ValueError, match="target_share"):
            derive(0.001, 0.001, target_share=1.5)
    assert autok.DEFAULT_TARGET_SHARE == jautok.DEFAULT_TARGET_SHARE
    assert autok.DEFAULT_MAX_K == jautok.DEFAULT_MAX_K


def test_auto_k_derivation_matches_jax_on_a_grid():
    hs = [0.0, 1e-5, 3e-4, 0.002, 0.05]
    cs = [0.0, 1e-6, 2e-4, 0.003]
    for h in hs:
        for c in cs:
            for kw in ({}, dict(multiple_of=3), dict(target_share=0.2,
                                                     max_k=10),
                       dict(n_calls=5, multiple_of=2)):
                assert (autok.derive_chunks_per_dispatch(h, c, **kw)
                        == jautok.derive_chunks_per_dispatch(h, c, **kw))


def test_auto_k_fixed_trace_bit_identical_to_flag(tmesh, jmesh8, data,
                                                  tmp_path, monkeypatch):
    """On a fixed calibration trace (h 0.2 ms, c 1 ms) ``"auto"`` picks K =
    4, as the JAX package's calibration does on the same trace, and drives
    a run bit-identical to passing K = 4: tables, every checkpoint, the
    gauges."""
    walls = iter([0.0012, 0.0022])
    monkeypatch.setattr(autok, "_measure_dispatch",
                        lambda *a, **kw: next(walls))
    K = 4
    tr1, st1, p1 = _make(tmesh, data)
    t1, l1 = tr1.init_state(0)
    ck1 = Checkpointer(str(tmp_path / "flag"), keep=20)
    tr1.run_megastep(t1, l1, p1, 1, epochs=2, chunks_per_dispatch=K,
                     checkpointer=ck1, checkpoint_every=1)
    tr2, st2, p2 = _make(tmesh, data)
    t2, l2 = tr2.init_state(0)
    ck2 = Checkpointer(str(tmp_path / "auto"), keep=20)
    rec2 = obs.Recorder(sinks=[])
    tr2.run_megastep(t2, l2, p2, 1, epochs=2, chunks_per_dispatch="auto",
                     checkpointer=ck2, checkpoint_every=1, recorder=rec2)
    assert rec2.snapshot()["gauges"]["megastep.auto_k"] == K
    assert rec2.snapshot()["gauges"]["megastep.chunks_per_dispatch"] == K
    for k in st1.tables:
        np.testing.assert_array_equal(st1.tables[k].numpy(),
                                      st2.tables[k].numpy(), err_msg=k)
    assert ck1.steps() == ck2.steps()
    for g in ck1.steps():
        _, va, la, _ = ck1.read_snapshot(g)
        _, vb, lb, _ = ck2.read_snapshot(g)
        assert sorted(va) == sorted(vb)
        for k in va:
            np.testing.assert_array_equal(np.asarray(va[k]),
                                          np.asarray(vb[k]), err_msg=k)
        for x, y in zip(la, lb):
            np.testing.assert_array_equal(x, y)
    jwalls = iter([0.0012, 0.0022])
    monkeypatch.setattr(jautok, "_measure_dispatch",
                        lambda *a, **kw: next(jwalls))
    jtr, _, jp = _jmake(jmesh8, data)
    jt, jl = jtr.init_state(jax.random.key(0))
    got = jautok.calibrate_chunks_per_dispatch(
        jtr, jt, jl, jp, jax.random.key(1), mode="sync",
        n_calls=jp.calls_per_epoch(T_CALL))
    assert got[0] == K


def test_auto_k_live_calibration_runs(tmesh, jmesh8, jax_runs, data):
    """The real calibration window runs, records the gauge and leaves the
    state alone (its dispatches run on copies): the tables still equal the
    per-chunk loop's, and the JAX package's megastep within its bounds."""
    jrun = _run_jax(jax_runs, "untiered_e1", jmesh8, data, epochs=1)
    rec = obs.Recorder(sinks=[])
    tr1, st1, p1 = _make(tmesh, data)
    t1, l1 = _port_state(tr1, st1, jrun[4])
    t1, l1, m1 = tr1.run_indexed(t1, l1, p1, 1, epochs=1)
    tr2, st2, p2 = _make(tmesh, data)
    t2, l2 = _port_state(tr2, st2, jrun[4])
    t2, l2, m2 = tr2.run_megastep(t2, l2, p2, 1, epochs=1,
                                  chunks_per_dispatch="auto", recorder=rec)
    chosen = rec.snapshot()["gauges"]["megastep.auto_k"]
    assert chosen >= 1
    for k in st1.tables:
        np.testing.assert_array_equal(st1.tables[k].numpy(),
                                      st2.tables[k].numpy(), err_msg=k)
    _assert_close_to_jax((st2.tables, l2, _epochs(m2, 1)), jrun)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_auto_k_rejects_unknown_string(tmesh, jmesh8, data, pkg):
    if pkg == "port":
        tr, _, p = _make(tmesh, data)
        t, ls = tr.init_state(0)
        key = 1
    else:
        tr, _, p = _jmake(jmesh8, data)
        t, ls = tr.init_state(jax.random.key(0))
        key = jax.random.key(1)
    with pytest.raises(ValueError, match="'auto'"):
        tr.run_megastep(t, ls, p, key, chunks_per_dispatch="fastest")


# -- the hooks ----------------------------------------------------------------

def test_pulled_ids_traced_hook_matches_jax(data):
    """The default hook is uncertifiable; MF's returns its raw item column
    as int32 (``None`` with negative samples), as the JAX package's does;
    the combinators' wrapper forwards it in neither package."""
    from fps_tpu.core import api as japi
    from fps_tpu.core import combinators as jcomb
    from fps_tpu.models import matrix_factorization as jmf
    from fps_tpu_torch.core import api as tapi
    from fps_tpu_torch.core import combinators as tcomb
    from fps_tpu_torch.models import matrix_factorization as tmf

    item = np.arange(12, dtype=np.int64).reshape(3, 4)
    assert tapi.WorkerLogic.pulled_ids_traced(None, {}) is None
    assert japi.WorkerLogic.pulled_ids_traced(None, {}) is None
    for neg in (0, 2):
        tl = tmf.MatrixFactorizationWorker(MFConfig(num_users=NU, num_items=NI, rank=RANK,
                                   negative_samples=neg), 8)
        jl = jmf.MatrixFactorizationWorker(JMFConfig(num_users=NU, num_items=NI, rank=RANK,
                                    negative_samples=neg), 8)
        got = tl.pulled_ids_traced({"item": torch.from_numpy(item)})
        want = jl.pulled_ids_traced({"item": jax.numpy.asarray(item)})
        if neg:
            assert got is None and want is None
            continue
        assert got[ITEM].dtype == torch.int32
        np.testing.assert_array_equal(got[ITEM].numpy(),
                                      np.asarray(want[ITEM]))
        tw = tcomb.scale_pushes(tl, 1.0)
        jw = jcomb.scale_pushes(jl, 1.0)
        assert tw.pulled_ids_traced({"item": torch.from_numpy(item)}) is None
        assert jw.pulled_ids_traced({"item": jax.numpy.asarray(item)}) is None
