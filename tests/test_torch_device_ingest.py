"""The PyTorch port's device-resident ingest and ``run_indexed`` against the
JAX package's, on the CPU.

``DeviceEpochPlan`` must put the same example in the same step as the JAX
plan: the chunks of ``device_epoch_chunks`` are compared array for array
(weight-0 padding rows included) for the stream-order and interleave
shuffles, with and without a route key and SSP rounds, on packable and on
2-D columns. The ``"sort"`` shuffle draws its own permutation and is held to
the coverage contract. ``Trainer.run_indexed`` is held against JAX
``run_indexed`` from the same tables (online MF, sync and SSP, with and
without ``hot_items``) and against ``fit_stream`` over
``device_epoch_chunks`` (tests/test_device_ingest.py is the oracle).
"""

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import device_ingest as jdi
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    DeviceDataset,
    DeviceEpochPlan,
    MFConfig,
    device_epoch_chunks,
    make_ps_mesh,
    online_mf,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.models.matrix_factorization import ITEM_TABLE

LOCAL_BATCH = 16


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh():
    return jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])


def _ratings(n=1003, seed=0):
    d = jdatasets.synthetic_ratings(57, 31, n, seed=seed)
    # Distinct ratings, so a missed or repeated example shows.
    d["rating"] = (np.arange(n) * 0.001).astype(np.float32)
    return d


def _sparse(n=700, seed=1):
    d = jdatasets.synthetic_sparse_classification(n, 300, 6, seed=seed)
    d["label"] = np.arange(n, dtype=np.float32)
    return d


def _chunks_pair(data, *, epochs=1, **kw):
    want = list(jdi.device_epoch_chunks(
        jdi.DeviceDataset(_jmesh(), data), epochs=epochs, **kw))
    got = list(device_epoch_chunks(
        DeviceDataset(make_ps_mesh(device="cpu"), data), epochs=epochs,
        **kw))
    return got, want


def _assert_chunks_equal(got, want):
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            w_k = np.asarray(w[k])
            g_k = g[k].numpy()
            assert g_k.dtype == w_k.dtype, k
            np.testing.assert_array_equal(g_k, w_k, err_msg=k)


@pytest.mark.parametrize("num_workers", [1, 3])
@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("route", [None, "user"])
@pytest.mark.parametrize("shuffle", [None, "interleave"])
def test_chunks_equal_jax_array_for_array(shuffle, route, sync_every,
                                          num_workers):
    got, want = _chunks_pair(
        _ratings(), epochs=2, num_workers=num_workers,
        local_batch=LOCAL_BATCH, steps_per_chunk=4, route_key=route,
        sync_every=sync_every, seed=3, shuffle=shuffle)
    _assert_chunks_equal(got, want)


@pytest.mark.parametrize("shuffle", [None, "interleave"])
@pytest.mark.parametrize("num_workers", [1, 2])
def test_sparse_chunks_equal_jax_array_for_array(shuffle, num_workers):
    """2-D columns (feat_ids, feat_vals): the JAX package gathers rows per
    step (no packed buffer), so its padding rows read clamped queue slots;
    the port reads the same."""
    data = _sparse()
    got, want = _chunks_pair(
        data, num_workers=num_workers, local_batch=64, steps_per_chunk=3,
        seed=5, shuffle=shuffle)
    assert not DeviceDataset(make_ps_mesh(device="cpu"), data).packable(
        None, num_workers)
    _assert_chunks_equal(got, want)


def test_skewed_routing_skips_the_packed_layout_as_jax_does():
    """Every example keyed to one worker: the padded queues would be W
    times the data, so the JAX package gathers per step (clamped padding
    reads) instead of relaying; so does the port's plan."""
    n = 257
    d = {"user": np.zeros(n, np.int32),
         "item": np.arange(n, dtype=np.int32) % 31,
         "rating": np.linspace(0, 1, n).astype(np.float32)}
    assert jdi.DeviceDataset(_jmesh(), d).packed("user", 4) is None
    assert not DeviceDataset(make_ps_mesh(device="cpu"), d).packable(
        "user", 4)
    got, want = _chunks_pair(d, num_workers=4, local_batch=16,
                             steps_per_chunk=4, route_key="user", seed=0)
    _assert_chunks_equal(got, want)


@pytest.mark.parametrize("kw", [
    dict(num_workers=1, local_batch=16, route_key=None, shuffle=None),
    dict(num_workers=3, local_batch=16, route_key="user",
         shuffle="interleave", sync_every=4),
    dict(num_workers=2, local_batch=100, route_key="user", shuffle="sort"),
])
def test_geometry_equals_jax(kw):
    data = _ratings()
    want = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(), data), seed=7,
                               **kw)
    got = DeviceEpochPlan(DeviceDataset(make_ps_mesh(device="cpu"), data),
                          seed=7, **kw)
    assert got.steps_per_epoch == want.steps_per_epoch
    assert got.maxq == want.maxq and got.grid_r == want.grid_r
    np.testing.assert_array_equal(got.grid_c, want.grid_c)
    np.testing.assert_array_equal(got.grid_m, want.grid_m)
    np.testing.assert_array_equal(got.counts, want.counts)
    for spc in (1, 3, 4, got.steps_per_epoch + 5):
        assert got.calls_per_epoch(spc) == want.calls_per_epoch(spc)
    q_got, c_got = got.dataset.queues(kw["route_key"], kw["num_workers"])
    q_want, c_want = want.dataset.queues(kw["route_key"], kw["num_workers"])
    np.testing.assert_array_equal(q_got.numpy(), np.asarray(q_want))
    np.testing.assert_array_equal(c_got, c_want)
    with pytest.raises(ValueError, match="steps_per_call"):
        got.calls_per_epoch(0)


@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("route", [None, "user"])
def test_sort_shuffle_covers_every_example_once(route, sync_every):
    """The ``"sort"`` shuffle (the port's own permutation): each example
    exactly once per epoch, routed to its worker, weight 0 elsewhere, and
    another order in the next epoch."""
    data, W = _ratings(), 3
    ds = DeviceDataset(make_ps_mesh(device="cpu"), data)
    plan = DeviceEpochPlan(ds, num_workers=W, local_batch=LOCAL_BATCH,
                           route_key=route, shuffle="sort", seed=3,
                           sync_every=sync_every)
    orders = []
    for epoch in (0, 1):
        seen = []
        for c in device_epoch_chunks(ds, num_workers=W,
                                     local_batch=LOCAL_BATCH,
                                     steps_per_chunk=4, plan=plan,
                                     start_epoch=epoch):
            wt = c["weight"].reshape(-1, W * LOCAL_BATCH).numpy()
            r = c["rating"].reshape(-1, W * LOCAL_BATCH).numpy()
            u = c["user"].reshape(-1, W * LOCAL_BATCH).numpy()
            mask = wt > 0
            seen.append(r[mask])
            if route:
                slot = np.broadcast_to(
                    np.arange(W * LOCAL_BATCH) // LOCAL_BATCH, u.shape)
                assert (u[mask] % W == slot[mask]).all()
            assert set(np.unique(wt)) <= {0.0, 1.0}
        seen = np.concatenate(seen)
        np.testing.assert_array_equal(np.sort(seen), np.sort(data["rating"]))
        orders.append(seen)
    assert not np.array_equal(orders[0], orders[1])
    # Deterministic in (seed, epoch), negative seeds included.
    for seed in (3, -3):
        p = DeviceEpochPlan(ds, num_workers=W, local_batch=LOCAL_BATCH,
                            shuffle="sort", seed=seed)
        assert torch.equal(p.epoch_args(1)["perm"], p.epoch_args(1)["perm"])


def test_interleave_offsets_match_jax_for_negative_seeds():
    data = _ratings()
    want = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(), data),
                               num_workers=2, local_batch=8, seed=-3)
    got = DeviceEpochPlan(DeviceDataset(make_ps_mesh(device="cpu"), data),
                          num_workers=2, local_batch=8, seed=-3)
    for epoch in (0, 1, 5):
        np.testing.assert_array_equal(
            got.epoch_args(epoch)["off_w"].numpy()[:, 0],
            np.asarray(want.epoch_args(epoch)["off_w"]))


def test_local_batch_at_is_the_chunk_slice():
    data = _ratings()
    ds = DeviceDataset(make_ps_mesh(device="cpu"), data)
    plan = DeviceEpochPlan(ds, num_workers=3, local_batch=LOCAL_BATCH,
                           route_key="user", seed=2)
    args = plan.epoch_args(0)
    chunk = plan.chunk(args, 0, plan.steps_per_epoch + 2)
    for t in (0, 5, plan.steps_per_epoch + 1):
        for w in range(3):
            batch = plan.local_batch_at(args, w, t)
            sl = slice(w * LOCAL_BATCH, (w + 1) * LOCAL_BATCH)
            for k, v in batch.items():
                assert torch.equal(v, chunk[k][t, sl]), (t, w, k)
    # Steps past the epoch are padding.
    assert not chunk["weight"][plan.steps_per_epoch:].any()


def test_explicit_plan_disagreeing_kwargs_raise():
    ds = DeviceDataset(make_ps_mesh(device="cpu"), _ratings())
    plan = DeviceEpochPlan(ds, num_workers=2, local_batch=8, seed=3,
                           route_key="user", sync_every=2)
    with pytest.raises(ValueError, match="local_batch"):
        device_epoch_chunks(ds, num_workers=2, local_batch=16,
                            steps_per_chunk=4, plan=plan)
    with pytest.raises(ValueError, match="route_key"):
        device_epoch_chunks(ds, num_workers=2, local_batch=8,
                            steps_per_chunk=4, route_key=None, plan=plan)
    with pytest.raises(ValueError, match="multiple of sync_every"):
        device_epoch_chunks(ds, num_workers=2, local_batch=8,
                            steps_per_chunk=3, plan=plan)
    with pytest.raises(ValueError, match="shuffle"):
        DeviceEpochPlan(ds, num_workers=2, local_batch=8, shuffle="random")
    with pytest.raises(ValueError, match="lengths"):
        DeviceDataset(make_ps_mesh(device="cpu"),
                      {"a": np.zeros(3), "b": np.zeros(4)})


# ---------------------------------------------------------------------------
# run_indexed
# ---------------------------------------------------------------------------

NU, NI = 57, 31
MF_KW = dict(num_users=NU, num_items=NI, rank=4, learning_rate=0.1,
             reg=0.01)


def _mf_data():
    return jdatasets.synthetic_ratings(NU, NI, 1003, rank=3, noise=0.05,
                                       seed=0)


@pytest.mark.parametrize("hot_items", [0, 8])
@pytest.mark.parametrize("sync_every", [None, 2])
def test_run_indexed_matches_jax(sync_every, hot_items):
    """Two epochs through the JAX package's ``run_indexed`` and the port's,
    from the same tables, over the same plan geometry, in calls of 6 steps
    (the JAX package pads the last call of each epoch with weight-0 steps,
    the port runs only the steps left). Per-epoch metrics and both tables
    agree to the order of float32 sums (factors are O(0.1))."""
    data = _mf_data()
    cfg = dict(MF_KW, hot_items=hot_items)
    jtrainer, _ = jonline_mf(_jmesh(), JMFConfig(**cfg),
                             sync_every=sync_every, combine="mean",
                             max_steps_per_call=6)
    ttrainer, tstore = online_mf(make_ps_mesh(device="cpu"), MFConfig(**cfg),
                                 sync_every=sync_every, combine="mean",
                                 max_steps_per_call=6)
    jtables, jlocal = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    tlocal = local_state_from_jax(ttrainer.logic, np.asarray(jlocal),
                                  device="cpu")
    plan_kw = dict(num_workers=1, local_batch=64, route_key="user", seed=7,
                   sync_every=sync_every)
    jplan = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(), data), **plan_kw)
    tplan = DeviceEpochPlan(DeviceDataset(make_ps_mesh(device="cpu"), data),
                            **plan_kw)
    assert ttrainer._indexed_call_steps(tplan) == (
        jtrainer._indexed_call_steps(jplan))
    jtables, jlocal, jm = jtrainer.run_indexed(jtables, jlocal, jplan,
                                               jax.random.key(1), epochs=2)
    ttables, tlocal, tm = ttrainer.run_indexed(ttables, tlocal, tplan, 1,
                                               epochs=2)
    assert len(tm) == len(jm) == 2
    for g, w in zip(tm, jm):
        assert g["n"].shape == (tplan.steps_per_epoch,)
        np.testing.assert_array_equal(g["n"], np.asarray(w["n"]))
        np.testing.assert_allclose(g["se"], np.asarray(w["se"]), rtol=1e-5,
                                   atol=1e-7)
    assert sum(float(m["n"].sum()) for m in tm) == 2 * len(data["rating"])
    np.testing.assert_allclose(ttables[ITEM_TABLE].numpy(),
                               np.asarray(jtables[ITEM_TABLE]), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(tlocal.numpy(), np.asarray(jlocal), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("sync_every", [None, 2])
def test_run_indexed_matches_fit_stream(sync_every):
    """The oracle's test: ``run_indexed`` trains the tables that
    ``fit_stream`` over ``device_epoch_chunks`` of the same plan trains
    (both run the same steps; the extra padding steps of either are
    weight-0 no-ops), exactly."""
    data = _mf_data()
    cfg = MFConfig(**MF_KW, hot_items=8)
    mesh = make_ps_mesh(device="cpu")
    ds = DeviceDataset(mesh, data)
    plan = DeviceEpochPlan(ds, num_workers=1, local_batch=64,
                           route_key="user", seed=7, sync_every=sync_every)
    tr1, _ = online_mf(mesh, cfg, sync_every=sync_every)
    t1, l1 = tr1.init_state(0)
    t1, l1, m1 = tr1.fit_stream(
        t1, l1, device_epoch_chunks(ds, num_workers=1, local_batch=64,
                                    steps_per_chunk=4, plan=plan,
                                    epochs=2), 1)
    tr2, _ = online_mf(mesh, cfg, sync_every=sync_every,
                       max_steps_per_call=6)
    t2, l2 = tr2.init_state(0)
    t2, l2, m2 = tr2.run_indexed(t2, l2, plan, 1, epochs=2)
    n1 = sum(float(m["n"].sum()) for m in m1)
    n2 = sum(float(m["n"].sum()) for m in m2)
    assert n1 == n2 == 2 * len(data["rating"])
    np.testing.assert_array_equal(t1[ITEM_TABLE].numpy(),
                                  t2[ITEM_TABLE].numpy())
    np.testing.assert_array_equal(l1.numpy(), l2.numpy())


def _indexed(epochs=2, **kw):
    mesh = make_ps_mesh(device="cpu")
    tr, store = online_mf(mesh, MFConfig(**MF_KW), **kw)
    tables, local = tr.init_state(0)
    plan = DeviceEpochPlan(DeviceDataset(mesh, _mf_data()), num_workers=1,
                           local_batch=32, route_key="user", seed=5,
                           sync_every=kw.get("sync_every"))
    return tr, store, tables, local, plan


def test_run_indexed_resumes_from_start_epoch():
    """Two epochs in one run equal one epoch, then one more from
    ``start_epoch=1``: shuffles and seeds derive from the epoch index."""
    tr, _, t, l, plan = _indexed()
    t_all, l_all, m_all = tr.run_indexed(t, l, plan, 3, epochs=2)
    tr, _, t, l, plan = _indexed()
    t, l, m0 = tr.run_indexed(t, l, plan, 3, epochs=1)
    t, l, m1 = tr.run_indexed(t, l, plan, 3, epochs=1, start_epoch=1)
    np.testing.assert_array_equal(t[ITEM_TABLE].numpy(),
                                  t_all[ITEM_TABLE].numpy())
    np.testing.assert_array_equal(l.numpy(), l_all.numpy())
    np.testing.assert_array_equal(m1[0]["se"], m_all[1]["se"])


def test_run_indexed_on_epoch_sees_the_live_store_and_learns():
    tr, store, t, l, plan = _indexed()
    seen = []

    def on_epoch(e, metrics):
        vals = store.lookup_host(ITEM_TABLE, np.arange(5))
        assert np.isfinite(vals).all()
        seen.append((e, float(np.sqrt(metrics["se"].sum()
                                      / metrics["n"].sum()))))

    tr.run_indexed(t, l, plan, 1, epochs=4, on_epoch=on_epoch)
    assert [e for e, _ in seen] == [0, 1, 2, 3]
    assert seen[-1][1] < seen[0][1] * 0.9, seen


def test_run_indexed_as_numpy_false_returns_device_metrics():
    tr, _, t, l, plan = _indexed(donate=False)
    host = tr.run_indexed(t, l, plan, 1, epochs=2)[2]
    dev = tr.run_indexed(t, l, plan, 1, epochs=2, as_numpy=False)[2]
    for h, d in zip(host, dev):
        assert all(isinstance(v, np.ndarray) for v in h.values())
        assert all(isinstance(v, torch.Tensor) for v in d.values())
        for k in h:
            np.testing.assert_array_equal(h[k], d[k].numpy())


@pytest.mark.parametrize("hook", ["checkpointer", "checkpoint_every",
                                  "rollback"])
def test_run_indexed_takes_durability_hooks(hook, tmp_path):
    """``run_indexed``'s checkpoint and rollback hooks are taken (they were
    refused before durability was ported): a checkpointer saves every
    ``checkpoint_every`` epochs, ``checkpoint_every`` alone saves nothing,
    and a preset-only rollback skips its epoch."""
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.core.resilience import RollbackPolicy

    tr, _, t, l, plan = _indexed()
    ck = Checkpointer(str(tmp_path))
    kw = {"checkpointer": dict(checkpointer=ck, checkpoint_every=1),
          "checkpoint_every": dict(checkpoint_every=1),
          "rollback": dict(rollback=RollbackPolicy(preset={0}))}[hook]
    _, _, m = tr.run_indexed(t, l, plan, 1, epochs=2, **kw)
    if hook == "checkpointer":
        assert ck.steps() == [1, 2] and len(m) == 2
    elif hook == "checkpoint_every":
        assert ck.steps() == [] and len(m) == 2
    else:
        assert kw["rollback"].skipped == [0] and len(m) == 1


@pytest.mark.parametrize("hook", ["recorder", "health", "watchdog"])
def test_run_indexed_takes_the_telemetry_hooks(hook):
    """``run_indexed``'s ``recorder`` / ``health`` / ``watchdog`` (refused
    until telemetry was ported) are taken: each does its part an epoch at
    a time, and the tables and metrics are those of the run without it,
    bit for bit."""
    from fps_tpu_torch import obs

    sink = obs.MemorySink()
    arg = {"recorder": obs.Recorder(sinks=[sink]),
           "health": obs.HealthMonitor(escalate_after_rows=1),
           "watchdog": obs.StepWatchdog(120.0)}[hook]
    runs = []
    for kw in ({hook: arg}, {}):
        tr, _, t, l, plan = _indexed(guard="observe")
        runs.append(tr.run_indexed(t, l, plan, 1, epochs=2, **kw))
    (ta, la, ma), (tb, lb, mb) = runs
    for k in ta:
        np.testing.assert_array_equal(ta[k].numpy(), tb[k].numpy(), k)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    for x, y in zip(ma, mb):
        np.testing.assert_array_equal(x["se"], y["se"])
    if hook == "recorder":
        assert arg.counter_value("driver.epochs") == 2
        assert [e["index"] for e in sink.events("epoch")] == [0, 1]
        assert arg.counter_value("driver.examples") == sum(
            float(np.sum(m["n"])) for m in ma)
    elif hook == "health":
        assert arg.log == [] and arg.escalated_at is None
    else:
        assert arg.stalls == []


def test_run_indexed_checks_the_plan_and_the_call_size():
    tr, _, t, l, plan = _indexed(sync_every=2)
    wrong = DeviceEpochPlan(plan.dataset, num_workers=1, local_batch=32,
                            route_key="user", seed=5)
    with pytest.raises(ValueError, match="sync_every"):
        tr.run_indexed(t, l, wrong, 1)
    T = plan.steps_per_epoch
    for cap, want in ((None, T), (T + 3, T), (5, 4), (1, 2)):
        tr, _, _, _, plan = _indexed(sync_every=2, max_steps_per_call=cap)
        if cap == 1:
            with pytest.warns(UserWarning, match="sync_every"):
                assert tr._indexed_call_steps(plan) == want
        else:
            assert tr._indexed_call_steps(plan) == want


@pytest.mark.parametrize("sync_every", [None, 2])
def test_run_indexed_runs_only_the_epochs_steps(sync_every, monkeypatch):
    """With calls that do not divide the epoch, the last call runs only
    the steps left: each epoch runs ``steps_per_epoch`` steps, no more."""
    tr, _, t, l, plan = _indexed(sync_every=sync_every, max_steps_per_call=4)
    T = plan.steps_per_epoch
    assert T % 4 and plan.calls_per_epoch(4) * 4 > T
    steps = []
    real = tr._step
    monkeypatch.setattr(tr, "_step",
                        lambda *a: steps.append(1) or real(*a))
    _, _, m = tr.run_indexed(t, l, plan, 1, epochs=2)
    assert len(steps) == 2 * T
    assert [len(e["n"]) for e in m] == [T, T]


def test_run_indexed_reads_batches_without_a_host_copy(monkeypatch):
    """The batches come from the resident columns: nothing in the run
    converts a numpy array to a tensor."""
    tr, _, t, l, plan = _indexed()
    calls = []
    real = torch.from_numpy
    monkeypatch.setattr(torch, "from_numpy",
                        lambda a: calls.append(a.shape) or real(a))
    tr.run_indexed(t, l, plan, 1, epochs=1)
    assert calls == [(1,)]  # the epoch's interleave offset, one int
