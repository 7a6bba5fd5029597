"""The adaptive tier of the port (``fps_tpu_torch.tiering``, the mapped hot
tier of ``core/store.py``, ``Trainer.retierer`` and
``TrainerConfig.auto_tier``) against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of the test process
(``tests/conftest.py``); the port's on ``make_ps_mesh(S, D, device="cpu")``,
from the same converted state, the same numpy chunks and, where a test
starts from a tracker, the same converted tracker
(``convert.retierer_from_jax``). Both packages' boundaries are driven by
hand after each ``run_chunk`` (what ``fit_stream`` does after each chunk),
so the JAX side's chunk keys and the port's chunk seeds line up.

What is held: the store's mapped primitives equal the JAX package's, out
of range ids included (the port looks every id outside ``[0, num_ids)`` up
at the sentinel, the JAX package fills with ``INT_MIN``: both cold); the
planner's plans equal field for field; the device windows equal a host
count-min of the live pulled ids bit for bit (the counts are whole
numbers); the mapped tier on the identity ranking equals the port's static
tier bit for bit, and the JAX package's mapped tier within 1e-5 of the
largest value (the JAX package's own mapped and static tiers differ in the
last bits: ``tests/test_tiering.py::test_mapped_identity_ranking_matches_
static_head`` fails on its own); forced re-ranks pick the same hot ids in
both packages, change no launch count a step, and leave the replica equal
to the canonical rows of the current hot ids bit for bit after every call.

Planner parity hands both packages ``dense_table_bytes=0``: the port's
``Retierer`` passes it (its ``dense_collectives="auto"`` keeps the gathered
route), the JAX package's passes a threshold measured on a TPU.

The sidecar: a re-ranked run checkpointed with its tracker's sidecar and
resumed by a fresh trainer and retierer equals the uninterrupted run bit
for bit (tables, replica, hot ids, decayed sketches), and the sweep keeps
every sidecar beside a checkpoint and the newest ``keep``.

Oracles of ``tests/test_tiering.py`` that wait for later items: the
``retier_kill`` chaos run of the supervisor (ROADMAP.md Queue 1 item 9),
the recorder's ``tiering.*`` counters (item 9). The lowered-program
comparisons (the mapped tier's census, the re-rank byte identity,
``lowered_plan_text``) are the program auditor's, held in
``tests/test_torch_analysis.py`` and below.
"""

from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu import sketch as jsketch
from fps_tpu.core import ingest as jingest
from fps_tpu.core import store as jstore
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.tiering import planner as jplanner
from fps_tpu.tiering import retier as jretier
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    DeviceDataset,
    DeviceEpochPlan,
    LogRegConfig,
    MFConfig,
    logistic_regression,
    online_mf,
)
from fps_tpu_torch import sketch as tsketch
from fps_tpu_torch import tiering
from fps_tpu_torch.convert import retierer_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.tiering import planner as tplanner

NF = 200  # logreg features
LR_KW = dict(num_features=NF, learning_rate=0.5)
H_LR = 64
ITEM = "item_factors"
MF_KW = dict(num_users=96, num_items=61, rank=4, learning_rate=0.08,
             reg=0.005)
H_MF = 12


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


def _tmesh(D, S):
    from fps_tpu_torch.parallel import mesh as tmesh

    return tmesh.make_ps_mesh(S, D, device="cpu")


def _assert_close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _same(a, b):
    ta, tb = to_numpy(a), to_numpy(b)
    assert sorted(ta) == sorted(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _lr_data(seed=7):
    data = jdatasets.synthetic_sparse_classification(2048, NF, 8, seed=seed,
                                                     noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def _lr_chunks(W, sync_every=None, n=6):
    return list(jingest.epoch_chunks(
        _lr_data(), num_workers=W, local_batch=16, steps_per_chunk=4,
        sync_every=sync_every, seed=3))[:n]


def _set_tier(trainer, store, name, H, E, **spec):
    if H:
        store.specs[name] = dataclasses.replace(store.specs[name],
                                                hot_tier=H, **spec)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E)


def _lr_pair(D, S, *, H=H_LR, E=3, sync_every=None, **cfg):
    jtr, jst = jlogistic_regression(_jmesh(D, S), JLogRegConfig(**LR_KW),
                                    sync_every=sync_every)
    ttr, tst = logistic_regression(_tmesh(D, S), LogRegConfig(**LR_KW),
                                   sync_every=sync_every)
    for tr, st in ((jtr, jst), (ttr, tst)):
        _set_tier(tr, st, "weights", H, E)
        tr.config = dataclasses.replace(tr.config, **cfg)
    jt, _ = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    return (jtr, jst, jt), (ttr, tst, tt)


def _zipf_items(n, seed):
    data = jdatasets.synthetic_ratings(MF_KW["num_users"], MF_KW["num_items"],
                                       n, rank=3, noise=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, MF_KW["num_items"] + 1) ** 1.1
    data["item"] = rng.choice(MF_KW["num_items"], size=n,
                              p=p / p.sum()).astype(np.int32)
    return data


def _mf_pair(D, S, *, H=H_MF, E=3, sync_every=None, **spec):
    jtr, jst = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW), combine="mean",
                          sync_every=sync_every)
    ttr, tst = online_mf(_tmesh(D, S), MFConfig(**MF_KW), combine="mean",
                         sync_every=sync_every)
    for tr, st in ((jtr, jst), (ttr, tst)):
        _set_tier(tr, st, ITEM, H, E, dense_collectives=False, **spec)
    from fps_tpu_torch.convert import local_state_from_jax

    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    return (jtr, jst, jt, jl), (ttr, tst, tt, tl)


def _mf_chunks(W, sync_every=None, n=4, seed=3):
    return list(jingest.epoch_chunks(
        _zipf_items(1600, seed), num_workers=W, local_batch=8,
        steps_per_chunk=6, route_key="user", sync_every=sync_every,
        seed=11))[:n]


def _boundary(store, tables, name, gids):
    """Every position's replica equals the canonical rows of the current
    hot ids, bit for bit."""
    reps = list(tables[tstore.hot_key(name)])
    for r in reps[1:]:
        assert torch.equal(r, reps[0])
    np.testing.assert_array_equal(reps[0].numpy(),
                                  store.lookup_host(name, gids))


def _drive(pair, chunks, jrt=None, trt=None, *, local=False, check=None):
    """Both packages through ``run_chunk`` and their retierers' boundaries,
    chunk after chunk; ``check(i, jt, tt)`` after each boundary. Returns
    the last ``(jt, tt)``."""
    (jtr, jst, jt, *jl), (ttr, tst, tt, *tl) = pair
    jl = jl[0] if local else ()
    tl = tl[0] if local else ()
    jtr.retierer, ttr.retierer = jrt, trt
    for i, chunk in enumerate(chunks):
        jt, jl, _ = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, _ = ttr.run_chunk(tt, tl, chunk, i)
        if jrt is not None:
            jt = jrt.on_boundary(jtr, dict(jt), i)
            jst.tables = dict(jt)
        if trt is not None:
            tt = trt.on_boundary(ttr, dict(tt), i)
            tst.tables = dict(tt)
        if check is not None:
            check(i, jt, tt)
    return jt, tt


def _kernel_calls(monkeypatch):
    """Counts of the kernels' plain versions called (on the card: the
    launch counters)."""
    from fps_tpu_torch.ops import kernels

    calls = {}
    for name in ("gather_rows_plain", "gather_rows_dim1_plain",
                 "scatter_add_plain", "scatter_add_dim1_plain",
                 "scatter_add_packed_plain"):
        fn = getattr(kernels, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(kernels, name, spy)
    return calls


# ---------------------------------------------------------------------------
# The store's mapped primitives.
# ---------------------------------------------------------------------------

def test_tier_keys_and_six_way_split():
    for fn in ("hot_key", "map_key", "ids_key", "sketch_key", "fold_key"):
        assert getattr(tstore, fn)("t") == getattr(jstore, fn)("t")
    tables = {"a": 1, "a::hot": 2, "a::hotmap": 3, "a::hotids": 4,
              "a::sketch": 5, "a::fold": 6, "b": 7}
    got = tstore.split_tiering(tables)
    assert got == jstore.split_tiering(tables)
    assert got[0] == {"a": 1, "b": 7}
    assert all(tstore.is_aux_key(k) == jstore.is_aux_key(k) for k in tables)


def test_hot_slot_map_matches_jax_and_refuses_bad_sets():
    gids = np.array([7, 2, 9])
    np.testing.assert_array_equal(tstore.hot_slot_map(10, gids),
                                  jstore.hot_slot_map(10, gids))
    assert tstore.hot_slot_map(10, gids).dtype == np.int32
    with pytest.raises(ValueError, match="duplicates"):
        tstore.hot_slot_map(10, np.array([1, 1]))
    with pytest.raises(ValueError, match="outside"):
        tstore.hot_slot_map(10, np.array([10]))
    with pytest.raises(ValueError, match="outside"):
        tstore.hot_slot_map(10, np.array([-1]))


@pytest.mark.parametrize("num_ids,gids", [(10, [7, 2, 9]),
                                          (300, list(range(150, 0, -3)))])
def test_lookup_hot_slots_out_of_range_ids(num_ids, gids):
    """Ids past the map: the JAX package's ``jnp.take`` fills them with
    ``INT_MIN`` (``[1, -1, -1, INT_MIN, INT_MIN, 2, -1]`` for the first
    seven ids at 10 ids), the port looks them up at the sentinel; both say
    cold."""
    m = jstore.hot_slot_map(num_ids, np.array(gids))
    rng = np.random.default_rng(num_ids)
    ids = np.concatenate([[2, -1, num_ids, num_ids + 1, num_ids + 2, 9, -5],
                          rng.integers(-3, num_ids + 40, 200)]).astype(
        np.int32)
    want = np.asarray(jstore.lookup_hot_slots(jnp.asarray(m),
                                              jnp.asarray(ids)))
    got = tstore.lookup_hot_slots(torch.from_numpy(m),
                                  torch.from_numpy(ids)).numpy()
    np.testing.assert_array_equal(got >= 0, want >= 0)
    np.testing.assert_array_equal(got[got >= 0], want[want >= 0])
    assert (got[got < 0] == -1).all()
    if num_ids == 10:
        assert want[:7].tolist()[:3] == [1, -1, -1]
        assert got[:7].tolist() == [1, -1, -1, -1, -1, 2, -1]


def test_split_hot_push_slots_matches_jax():
    rng = np.random.default_rng(0)
    m = jstore.hot_slot_map(50, rng.choice(50, 12, replace=False))
    ids = rng.integers(-1, 55, 64).astype(np.int32)
    deltas = rng.normal(0, 1, (64, 3)).astype(np.float32)
    jslots = jstore.lookup_hot_slots(jnp.asarray(m), jnp.asarray(ids))
    want = jstore.split_hot_push_slots(jnp.asarray(ids), jnp.asarray(deltas),
                                       jslots)
    tslots = tstore.lookup_hot_slots(torch.from_numpy(m),
                                     torch.from_numpy(ids))
    got = tstore.split_hot_push_slots(torch.from_numpy(ids),
                                      torch.from_numpy(deltas), tslots)
    for (gi, gd), (wi, wd) in zip(got, want):
        np.testing.assert_array_equal(gi.numpy(), np.asarray(wi))
        np.testing.assert_array_equal(gd.numpy(), np.asarray(wd))


@pytest.mark.parametrize("dim", [1, 4])
@pytest.mark.parametrize("D,S", [(1, 4), (2, 4)])
def test_reconcile_hot_mapped_matches_jax(D, S, dim):
    """One window's reconcile of a mapped head, every position with its
    own pending buffer: replicas and canonical blocks within the float32
    bound of the JAX package's (sums over positions in another order), the
    owned rows of the hot ids only."""
    from jax.sharding import PartitionSpec as P

    R, H = 50, 9
    rng = np.random.default_rng(dim)
    table = rng.normal(0, 1, (R + (-R) % S, dim)).astype(np.float32)
    gids = rng.choice(R, H, replace=False).astype(np.int32)
    rps = table.shape[0] // S
    replica = table[(gids % S) * rps + gids // S]
    bufs = rng.normal(0, 0.1, (D * S, H, dim)).astype(np.float32)
    mesh = _jmesh(D, S)

    def fn(t, rep, buf, g):
        out = jstore.reconcile_hot_mapped(
            t, rep, buf[0], g, num_shards=S,
            data_axis=jmesh.DATA_AXIS if D > 1 else None)
        return out[0], out[1][None]

    run = jax.shard_map(
        fn, mesh=mesh,
        in_specs=(P(jmesh.SHARD_AXIS, None), P(),
                  P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)), P()),
        out_specs=(P(jmesh.SHARD_AXIS, None),
                   P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS))), check_vma=False)
    jt, jrep = map(np.asarray, jax.jit(run)(
        jnp.asarray(table), jnp.asarray(replica), jnp.asarray(bufs),
        jnp.asarray(gids)))
    tm = _tmesh(D, S)
    blocks = [torch.from_numpy(np.split(table, S)[p % S].copy())
              for p in range(D * S)]
    tt, trep, fresh, _ = tstore.reconcile_hot_mapped(
        blocks, [torch.from_numpy(replica.copy()) for _ in range(D * S)],
        [torch.from_numpy(b) for b in bufs],
        [torch.from_numpy(gids) for _ in range(D * S)], num_shards=S,
        mesh=tm)
    _assert_close(torch.cat(tt[:S]).numpy(), jt, "canonical")
    for r in trep:
        assert torch.equal(r, trep[0])
        _assert_close(r.numpy(), jrep[0], "replica")
    assert not any(f.any() for f in fresh)
    # Rows of no hot id are untouched, bit for bit.
    cold = np.setdiff1d(np.arange(R), gids)
    phys = (cold % S) * rps + cold // S
    np.testing.assert_array_equal(torch.cat(tt[:S]).numpy()[phys],
                                  table[phys])


def test_rows_replica_copies_and_refuses_bad_ids():
    store = tstore.ParamStore(_tmesh(2, 4), [tstore.TableSpec("t", 37, 3)])
    tables = store.init(0)
    for p in (1, 5):  # shard 1 on both data replicas: id 2 * 4 + 1 = 9
        tables["t"][p][2, 1] = -0.0
    ids = np.array([5, 3, 36, 9, 0])
    rep = store.rows_replica("t", ids)
    assert len(rep) == 8 and all(torch.equal(r, rep[0]) for r in rep)
    want = store.lookup_host("t", ids)
    np.testing.assert_array_equal(rep[0].numpy(), want)
    assert np.signbit(rep[0].numpy()[3, 1])  # a copy keeps -0.0
    with pytest.raises(ValueError, match="subset"):
        store.rows_replica("t", np.array([37]))
    with pytest.raises(ValueError, match="subset"):
        store.rows_replica("t", np.array([], np.int64))
    with pytest.raises(ValueError, match="subset"):
        store.rows_replica("t", np.array([-1, 2]))


def test_cold_counts_with_hot_member_match_jax():
    rng = np.random.default_rng(1)
    member = np.zeros(41, bool)
    member[rng.choice(40, 10, replace=False)] = True
    ids = rng.integers(-2, 60, (3, 32)).astype(np.int32)  # some >= 40
    for kw in (dict(hot_member=member), dict(hot_head=7)):
        np.testing.assert_array_equal(
            tingest.per_worker_cold_counts(ids, 4, **kw),
            jingest.per_worker_cold_counts(ids, 4, **kw))


# ---------------------------------------------------------------------------
# The tracker's ranking and the planner.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("H", [1, 7, 64, 999, 1000, 1500])
def test_top_ids_heavy_ties_match_jax_and_a_full_sort(H):
    rng = np.random.default_rng(0)
    est = rng.integers(0, 5, 1000).astype(np.float32)
    full = np.lexsort((np.arange(len(est)), -est))[:min(H, len(est))]
    np.testing.assert_array_equal(tiering.top_ids(est, H), full)
    np.testing.assert_array_equal(tiering.top_ids(est, H),
                                  jretier.top_ids(est, H))


def _densities(pkg):
    rng = np.random.default_rng(3)
    zipf = 1.0 / np.arange(1, (1 << 16) + 1) ** 1.4
    return [
        pkg.TableDensity("full", 1024, 8, 1.0 / np.arange(1, 1025) ** 1.2),
        pkg.TableDensity("partial", 1 << 16, 16, zipf),
        pkg.TableDensity("flat", 1 << 14, 16, np.ones(1 << 14)),
        pkg.TableDensity("empty", 64, 4, np.zeros(64)),
        pkg.TableDensity("noisy", 5000, 2,
                         rng.integers(0, 9, 5000).astype(np.float64)),
    ]


@pytest.mark.parametrize("kw", [
    dict(batch_rows_per_step=256),
    dict(batch_rows_per_step=4096, replica_budget_bytes=1 << 18,
         num_workers=8),
    dict(batch_rows_per_step=1024, replica_budget_bytes=1 << 16,
         mean_combine=True, coverage_target=0.7, max_sync_every=16),
    dict(batch_rows_per_step=64, replica_budget_bytes=1 << 12,
         num_workers=4, cold_budget_margin=2.0, reconcile_frac=0.5),
], ids=["default", "tight", "mean", "small"])
def test_plan_tables_matches_jax_field_for_field(kw):
    kw = dict(kw, dense_table_bytes=0)
    want = jplanner.plan_tables(_densities(jplanner), **kw)
    got = tplanner.plan_tables(_densities(tplanner), **kw)
    assert sorted(got) == sorted(want)
    for name in want:
        assert got[name].to_json() == want[name].to_json(), name
        assert got[name].knobs() == want[name].knobs()
    assert (tplanner.global_sync_every(got)
            == jplanner.global_sync_every(want))


def test_planner_helpers_match_jax():
    counts = 1.0 / np.arange(1, 3001) ** 1.1
    for H in (0, 1, 17, 3000, 5000):
        assert (tplanner.head_coverage(counts, H)
                == jplanner.head_coverage(counts, H))
    for args in ((512, 16, 4, 0.9), (64, 1, 4, 0.0), (4096, 100, 2, 0.5)):
        for mean in (False, True):
            kw = dict(batch_rows_per_step=2048, mean_combine=mean)
            assert (tplanner.choose_sync_every(*args, **kw)
                    == jplanner.choose_sync_every(*args, **kw))
    for cov in (0.1, 0.5, 0.9, 0.99):
        for W in (1, 4, 8):
            assert (tplanner.choose_cold_budget(cov, 4096, num_workers=W)
                    == jplanner.choose_cold_budget(cov, 4096,
                                                   num_workers=W))
    assert tplanner.DEFAULT_REPLICA_BUDGET_BYTES == 64 << 20


def test_tenant_planning_matches_jax():
    dens = {"a": _densities(tplanner)[:2], "b": _densities(tplanner)[2:]}
    jdens = {"a": _densities(jplanner)[:2], "b": _densities(jplanner)[2:]}
    for budget in (1 << 16, 1 << 20, 64 << 20):
        assert (tplanner.tenant_demand_bytes(dens["a"],
                                             replica_budget_bytes=budget)
                == jplanner.tenant_demand_bytes(jdens["a"],
                                                replica_budget_bytes=budget))
    demands = {"x": 100, "y": 5000, "z": 0, "w": 2500}
    for total in (0, 1000, 4000, 10_000):
        assert (tplanner.arbitrate_replica_budget(demands, total,
                                                  weights={"y": 2.0})
                == jplanner.arbitrate_replica_budget(demands, total,
                                                     weights={"y": 2.0}))
    with pytest.raises(ValueError, match="weight"):
        tplanner.arbitrate_replica_budget({"x": 1}, 5, weights={"x": 0})
    got = tplanner.plan_tenants(dens, batch_rows_per_step=1024,
                                total_replica_budget_bytes=1 << 20,
                                dense_table_bytes=0)
    want = jplanner.plan_tenants(jdens, batch_rows_per_step=1024,
                                 total_replica_budget_bytes=1 << 20,
                                 dense_table_bytes=0)
    for t in want:
        assert got[t]["demand"] == want[t]["demand"]
        assert got[t]["granted"] == want[t]["granted"]
        assert {n: p.to_json() for n, p in got[t]["plans"].items()} == {
            n: p.to_json() for n, p in want[t]["plans"].items()}


def test_planner_validates_density():
    with pytest.raises(ValueError, match="shape"):
        tplanner.TableDensity("t", 8, 4, np.zeros(9))
    with pytest.raises(ValueError, match="negative"):
        tplanner.TableDensity("t", 2, 4, np.array([-1.0, 1.0]))


# ---------------------------------------------------------------------------
# The trainer: the mapped tier, the tracker and the re-ranks.
# ---------------------------------------------------------------------------

def test_device_window_equals_host_cm_update_and_jax():
    """The window after one chunk (never folded) equals a host count-min of
    the chunk's live pulled ids under the table's hashing, bit for bit, on
    every position, and the JAX package's window."""
    pair = _lr_pair(1, 4)
    chunks = _lr_chunks(4)[:1]
    jrt = jretier.Retierer(check_every=100)
    trt = tiering.Retierer(check_every=100)
    jt, tt = _drive(pair, chunks, jrt, trt)
    win = tt[tstore.sketch_key("weights")]
    assert all(torch.equal(w, win[0]) for w in win)
    spec = trt._table_cm("weights")
    assert spec == tsketch.CountMinSpec(**dataclasses.asdict(
        jrt._table_cm("weights")))
    ids = chunks[0]["feat_ids"].reshape(-1)
    live = np.repeat(chunks[0]["weight"].reshape(-1),
                     chunks[0]["feat_ids"].shape[-1]) > 0
    host = tsketch.cm_update(spec, tsketch.cm_init(spec), torch.from_numpy(
        np.where(live, ids, -1).astype(np.int32)))
    np.testing.assert_array_equal(win[0].numpy(), host.numpy())
    np.testing.assert_array_equal(win.numpy(),
                                  np.asarray(jt["weights::sketch"]))


@pytest.mark.parametrize("model,D,S", [("logreg", 1, 4), ("logreg", 2, 4),
                                       ("mf", 1, 8), ("mf", 2, 4)])
def test_mapped_identity_ranking_equals_static_tier(model, D, S):
    """A retierer that never checks: the mapped tier on the identity
    ranking ``[0, H)`` equals the port's static tier bit for bit (tables,
    replicas, local state, metrics), and the JAX package's mapped tier
    within the float32 bound; the replica equals the canonical rows of the
    hot ids after every call."""
    W = D * S
    mf = model == "mf"
    chunks = _mf_chunks(W) if mf else _lr_chunks(W)
    name, H = (ITEM, H_MF) if mf else ("weights", H_LR)
    make = _mf_pair if mf else _lr_pair

    def port_run(rt):
        (_, _, _, *_), (ttr, tst, tt, *tl) = make(D, S)
        ttr.retierer = rt
        tl = tl[0] if mf else ()
        metrics = []
        for i, chunk in enumerate(chunks):
            tt, tl, m = ttr.run_chunk(tt, tl, chunk, i)
            metrics.append(to_numpy(m))
        return tt, tl, metrics

    st_t, st_l, st_m = port_run(None)
    mp_t, mp_l, mp_m = port_run(tiering.Retierer(check_every=100))
    for k in st_t:
        np.testing.assert_array_equal(mp_t[k].numpy(), st_t[k].numpy(), k)
    if mf:
        np.testing.assert_array_equal(mp_l.numpy(), st_l.numpy())
    for a, b in zip(mp_m, st_m):
        assert jax.tree.structure(a) == jax.tree.structure(b)
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)
    pair = make(D, S)
    jt, tt = _drive(pair, chunks, jretier.Retierer(check_every=100),
                    tiering.Retierer(check_every=100), local=mf,
                    check=lambda i, jt, tt: _boundary(
                        pair[1][1], tt, name, np.arange(H)))
    tnp = to_numpy(tt)
    assert sorted(tnp) == sorted(jt)
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)


def _forced(D, S, *, model="logreg", sync_every=None, n=6, **spec):
    W = D * S
    mf = model == "mf"
    chunks = (_mf_chunks(W, sync_every, n=n) if mf
              else _lr_chunks(W, sync_every, n=n))
    pair = (_mf_pair if mf else _lr_pair)(D, S, sync_every=sync_every,
                                         **spec)
    jrt = jretier.Retierer(check_every=2, churn_threshold=-1.0)
    trt = tiering.Retierer(check_every=2, churn_threshold=-1.0)
    name = ITEM if mf else "weights"
    H = pair[1][0]._hot_tier_map()[name]
    seen = []

    def check(i, jt, tt):
        gids = trt.hot_ids_for(name, H)
        np.testing.assert_array_equal(gids, jrt.hot_ids_for(name, H))
        _boundary(pair[1][1], tt, name, gids)
        seen.append(gids.copy())

    jt, tt = _drive(pair, chunks, jrt, trt, local=mf, check=check)
    return jt, tt, jrt, trt, seen


@pytest.mark.parametrize("model,D,S,sync_every", [
    ("logreg", 1, 4, None), ("logreg", 2, 4, 2), ("mf", 2, 4, None),
    ("mf", 1, 8, 2)], ids=["logreg-1x4", "logreg-2x4-ssp", "mf-2x4",
                           "mf-1x8-ssp"])
def test_forced_reranks_match_jax(model, D, S, sync_every):
    """Re-ranks at every check: both packages pick the same hot ids at
    every boundary (whole-number counts, the same hashing and ranking), the
    tables stay within the float32 bound of the JAX package's, and the
    replica equals the canonical rows of the current hot ids after every
    call."""
    jt, tt, jrt, trt, seen = _forced(D, S, model=model, sync_every=sync_every)
    assert trt.re_ranks >= 1 and trt.re_ranks == jrt.re_ranks
    assert trt.checks == jrt.checks and trt.tick == jrt.tick
    assert any(not np.array_equal(s, np.arange(len(s))) for s in seen)
    tnp = to_numpy(tt)
    assert sorted(tnp) == sorted(jt)
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)
    for name, st in jrt.state.items():
        np.testing.assert_array_equal(trt.state[name], st)


def test_forced_reranks_change_no_launch_count_and_repeat_bit_for_bit(
        monkeypatch):
    """Every chunk launches the same kernels across re-ranks (no shape
    changes, so neither does any route), and two runs are the same bits."""
    runs = []
    for _ in range(2):
        (_, _, _), (ttr, tst, tt) = _lr_pair(1, 4)
        rt = ttr.retierer = tiering.Retierer(check_every=1,
                                             churn_threshold=-1.0)
        tt = ttr._attach_hot(tt)
        calls = _kernel_calls(monkeypatch)
        per_chunk, shapes, metrics = [], [], []
        for i, chunk in enumerate(_lr_chunks(4)):
            before = dict(calls)
            tt, _, m = ttr.run_chunk(tt, (), chunk, i)
            per_chunk.append({k: v - before.get(k, 0)
                              for k, v in calls.items()})
            tt = rt.on_boundary(ttr, tt, i)
            shapes.append({k: tuple(v[0].shape) for k, v in tt.items()})
            metrics.append(to_numpy(m))
        assert rt.re_ranks >= 2
        assert all(c == per_chunk[0] for c in per_chunk), per_chunk
        assert all(s == shapes[0] for s in shapes)
        runs.append((tt, metrics, rt.hot_ids["weights"].copy()))
    _same(runs[0][0], runs[1][0])
    np.testing.assert_array_equal(runs[0][2], runs[1][2])
    for a, b in zip(runs[0][1], runs[1][1]):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_plans_keep_fold_state_and_reranks_swap_only_replica_and_maps():
    """``::fold`` is never derived anew by the retierer, as in the JAX
    package: ``_install_plans`` keeps a live Adagrad state (equal to the
    JAX package's after the same run), and a re-rank swaps the replica,
    the slot map and the id array and leaves every other entry as it was
    (so a fold's state would stay with its slot; a hot fold needs the whole
    table replicated, which has no mapped tier to re-rank)."""
    (jtr, jst, jt), (ttr, tst, tt) = _lr_pair(1, 4, H=NF)
    for tr in (jtr, ttr):
        tr.server_logic["weights"] = dataclasses.replace(
            tr.server_logic["weights"], hot_fold="adagrad")
    chunks = _lr_chunks(4, n=2)
    jt, tt = _drive(((jtr, jst, jt), (ttr, tst, tt)), chunks)
    fold = tt["weights::fold"].numpy()
    assert fold.any()
    _assert_close(fold, np.asarray(jt["weights::fold"]), "fold state")
    plans = {"weights": tplanner.TierPlan(NF, 3, False, 1.0, "test")}
    rt = ttr.retierer = tiering.Retierer()
    out = rt._install_plans(ttr, dict(tt), plans, {}, what="test")
    assert "weights::fold" in out and tstore.hot_key("weights") in out
    np.testing.assert_array_equal(out["weights::fold"].numpy(), fold)
    jrt = jtr.retierer = jretier.Retierer()
    jplans = {"weights": jplanner.TierPlan(NF, 3, False, 1.0, "test")}
    jout = jrt._install_plans(jtr, dict(jt), jplans, {}, None, what="test")
    np.testing.assert_array_equal(np.asarray(jout["weights::fold"]),
                                  np.asarray(jt["weights::fold"]))
    # A re-rank swaps the replica and maps only: the rest stays as it was.
    (_, _, _), (ttr, tst, tt) = _lr_pair(1, 4)
    rt = ttr.retierer = tiering.Retierer(check_every=1,
                                         churn_threshold=-1.0)
    tt, _, _ = ttr.run_chunk(tt, (), chunks[0], 0)
    kept = {k: v for k, v in tt.items()
            if not k.endswith(("::hot", "::hotmap", "::hotids", "::sketch"))}
    tt = rt.on_boundary(ttr, dict(tt), 0)
    assert rt.re_ranks == 1
    for k, v in kept.items():
        assert tt[k] is v, k


@pytest.mark.parametrize("case", ["exact", "untiered", "one_position"])
def test_disengaged_tier_with_a_retierer_runs_the_untiered_program(
        monkeypatch, case):
    """A retierer on a tier the resolution turns off (the exact mode, no
    ``hot_tier``, one position) tracks nothing: the same kernel calls,
    tables and metrics as the untiered run, and no ``::sketch`` entry."""
    S = 1 if case == "one_position" else 4
    chunks = _lr_chunks(S, n=3)

    def run(rt):
        (_, _, _), (ttr, tst, tt) = _lr_pair(
            1, S, H=0 if case == "untiered" else H_LR,
            E=1 if case == "exact" else 3)
        if rt is None:
            _set_tier(ttr, tst, "weights", 0, 1)
        ttr.retierer = rt
        calls = _kernel_calls(monkeypatch)
        tables, _, m = ttr.fit_stream(tt, (), iter(chunks), 1)
        return tables, m, dict(calls), ttr

    base, mb, cb, _ = run(None)
    got, mg, cg, ttr = run(tiering.Retierer(check_every=1))
    assert ttr._track_specs() == {} and ttr._mapped_tables() == {}
    assert not any("::" in k for k in got)
    _same(got, base)
    assert cg == cb
    for a, b in zip(mg, mb):
        for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
            np.testing.assert_array_equal(x, y)


def test_auto_tier_plans_and_trains_as_jax_plans():
    """``TrainerConfig.auto_tier``: a warm-up chunk tracked (no tier yet),
    then the planner's plan, the same in both packages with
    ``dense_table_bytes=0`` on both sides, applied to the specs and the
    config; the tables train and stay within the float32 bound of the JAX
    package's."""
    (jtr, jst, jt), (ttr, tst, tt) = _lr_pair(1, 4, H=0, E=1,
                                              auto_tier=True)
    jtr._enter_tiering()
    ttr._enter_tiering()
    assert isinstance(ttr.retierer, tiering.Retierer)
    assert ttr.retierer.auto_plan
    jtr.retierer.plan_kwargs["dense_table_bytes"] = 0
    chunks = _lr_chunks(4)
    jt, tt = _drive(((jtr, jst, jt), (ttr, tst, tt)), chunks,
                    jtr.retierer, ttr.retierer)
    jrt, trt = jtr.retierer, ttr.retierer
    assert trt.planned and jrt.planned
    assert {n: p.to_json() for n, p in trt.plans.items()} == {
        n: p.to_json() for n, p in jrt.plans.items()}
    assert tst.specs["weights"].hot_tier == trt.plans["weights"].hot_tier
    assert ttr.config.hot_sync_every == tiering.global_sync_every(trt.plans)
    tnp = to_numpy(tt)
    assert sorted(tnp) == sorted(jt)
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)
    assert np.isfinite(tnp["weights"]).all()


def test_auto_tier_trains_through_fit_stream_with_a_partial_head():
    """``auto_tier`` through ``fit_stream`` with a replica budget that
    leaves a partial head: the plan lands after the warm-up chunk, the
    mapped tier and the tracker run, the lane is planned, and the loss
    falls."""
    (_, _, _), (ttr, tst, tt) = _lr_pair(1, 4, H=0, E=1)
    ttr.retierer = tiering.Retierer(
        auto_plan=True, check_every=1,
        plan_kwargs={"replica_budget_bytes": 96 * 4})
    chunks = _lr_chunks(4, n=6)
    tables, _, metrics = ttr.fit_stream(tt, (), iter(chunks), 1)
    rt = ttr.retierer
    plan = rt.plans["weights"]
    assert 0 < plan.hot_tier <= 96 and not plan.dense
    assert ttr._mapped_tables() == {"weights": plan.hot_tier}
    assert sorted(k for k in tables if "::" in k) == [
        "weights::hot", "weights::hotids", "weights::hotmap",
        "weights::sketch"]
    _boundary(tst, tables, "weights", rt.hot_ids_for("weights",
                                                     plan.hot_tier))
    loss = [float(m["logloss"].sum() / m["n"].sum()) for m in metrics]
    assert loss[-1] < loss[0]


def test_replan_unchanged_is_a_noop_and_a_change_resolves_once(
        monkeypatch):
    """``replan_every=1``: on a steady stream every re-plan has the same
    knobs and changes nothing (the specs and config objects themselves
    stay); a collapsed replica budget changes the plan, which is applied
    once, and the next re-plans are no-ops again."""
    (_, _, _), (ttr, tst, tt) = _lr_pair(1, 4, H=0, E=1)
    rt = ttr.retierer = tiering.Retierer(auto_plan=True, check_every=1,
                                         replan_every=1)
    installs, resolved = [], []
    real = tiering.Retierer._install_plans
    monkeypatch.setattr(tiering.Retierer, "_install_plans",
                        lambda self, *a, **k: installs.append(k["what"])
                        or real(self, *a, **k))
    real_boundary = rt.on_boundary

    def boundary(trainer, tables, i, **k):
        out = real_boundary(trainer, tables, i, **k)
        resolved.append((trainer._hot_tier_map(), trainer._mapped_tables(),
                         trainer._cold_compact_map(),
                         trainer.config.hot_sync_every))
        return out

    rt.on_boundary = boundary

    def changes():
        seen = [({}, {}, {}, 1)] + resolved
        return sum(a != b for a, b in zip(seen, seen[1:]))

    chunks = _lr_chunks(4, n=4)
    tables, _, _ = ttr.fit_stream(tt, (), iter(chunks), 1)
    assert installs == ["plan"] and changes() == 1
    assert rt.plans["weights"].hot_tier == NF  # the whole table fits
    tables, _, _ = ttr.fit_stream(tables, (), iter(chunks[:2]), 2)
    assert installs == ["plan"] and changes() == 1
    rt.plan_kwargs["replica_budget_bytes"] = 64 * 4  # 64 rows of one float
    tables, _, _ = ttr.fit_stream(tables, (), iter(chunks), 3)
    assert installs == ["plan", "replan"] and changes() == 2
    assert tst.specs["weights"].hot_tier < NF
    assert ttr._mapped_tables() == {"weights": tst.specs["weights"].hot_tier}
    assert np.isfinite(tables["weights"].numpy()).all()


def test_auto_tier_with_push_delay_raises_at_run_entry():
    (_, _, _), (ttr, tst, tt) = _lr_pair(1, 4, H=0, E=1, auto_tier=True,
                                         push_delay=2)
    with pytest.raises(ValueError, match="auto_tier and push_delay"):
        ttr.fit_stream(tt, (), iter(_lr_chunks(4, n=1)), 1)
    with pytest.raises(ValueError, match="auto_tier and push_delay"):
        ttr.run_indexed(tt, (), _lr_plan(ttr.mesh, 4), 1)


def _lr_plan(mesh, W, sync_every=None):
    return DeviceEpochPlan(DeviceDataset(mesh, _lr_data()), num_workers=W,
                           local_batch=16, seed=5, sync_every=sync_every)


@pytest.mark.parametrize("sync_every", [None, 2], ids=["sync", "ssp"])
def test_run_indexed_through_the_mapped_tier_matches_jax(sync_every):
    """``run_indexed`` with forced re-ranks after every epoch (sync: calls
    of 17 steps, windows of 3; SSP: one call of 17 rounds of 2), the same
    hot ids as the JAX package's run, the tables within the float32 bound,
    the replica the canonical rows of the current hot ids. The calls
    divide the epoch's 34 steps: the JAX package pads a shorter last call
    with weight-0 steps whose ids its tracker counts too, the port runs the
    real steps only."""
    from fps_tpu.core import device_ingest as jdi

    (jtr, jst, jt), (ttr, tst, tt) = _lr_pair(
        1, 4, sync_every=sync_every,
        max_steps_per_call=None if sync_every else 17)
    jtr.retierer = jretier.Retierer(check_every=1, churn_threshold=-1.0)
    ttr.retierer = tiering.Retierer(check_every=1, churn_threshold=-1.0)
    kw = dict(num_workers=4, local_batch=16, seed=5, sync_every=sync_every)
    jplan = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(1, 4), _lr_data()),
                                **kw)
    tplan = DeviceEpochPlan(DeviceDataset(ttr.mesh, _lr_data()), **kw)
    jt, _, jms = jtr.run_indexed(jt, (), jplan, jax.random.key(1), epochs=2)
    tt, _, tms = ttr.run_indexed(tt, (), tplan, 1, epochs=2)
    assert ttr.retierer.re_ranks == jtr.retierer.re_ranks >= 1
    gids = ttr.retierer.hot_ids_for("weights", H_LR)
    np.testing.assert_array_equal(gids,
                                  jtr.retierer.hot_ids_for("weights", H_LR))
    _boundary(tst, tt, "weights", gids)
    tnp = to_numpy(tt)
    assert sorted(tnp) == sorted(jt)
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)
    for tm, jm in zip(tms, jms):
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))


def test_mapped_lanes_certify_on_the_current_hot_set():
    """A mapped MF head with a ``cold_budget`` lane: the certifier counts
    cold ids against the retierer's hot set (``hot_member``), the lanes
    run for the chunks that fit, and the run stays within the float32
    bound of the JAX package's."""
    W = 8
    chunks = _mf_chunks(W)
    lane = max(int(jingest.per_worker_cold_counts(
        c["item"], W, hot_head=H_MF).max()) for c in chunks)
    pair = _mf_pair(2, 4, cold_budget=lane)
    trt = tiering.Retierer(check_every=2, churn_threshold=-1.0)
    jrt = jretier.Retierer(check_every=2, churn_threshold=-1.0)
    ttr = pair[1][0]
    fits = []
    real = ttr._certify_cold
    ttr._certify_cold = lambda ids: fits.append(real(ids)[0]) or real(ids)
    jt, tt = _drive(pair, chunks, jrt, trt, local=True)
    assert ttr._cold_compact_map() == {ITEM: lane}
    assert fits and any(fits)
    tnp = to_numpy(tt)
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)


# ---------------------------------------------------------------------------
# Conversion, the bench's stream and what waits for later items.
# ---------------------------------------------------------------------------

def test_tables_and_tracker_come_across_from_jax():
    """The JAX package's mapped entries (``::hotmap``, ``::hotids``,
    ``::sketch``) and its tracker (``Retierer.snapshot()``) convert into
    the port's and back; a run continued from both in both packages picks
    the same hot ids."""
    jt, _, jrt, _, _ = _forced(1, 4, n=3)
    (jtr, jst, _), (ttr, tst, _) = _lr_pair(1, 4)
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    assert sorted(tt) == sorted(jt)
    tnp = to_numpy(tt)
    for k, v in jt.items():
        np.testing.assert_array_equal(tnp[k], np.asarray(v), k)
    trt = retierer_from_jax(jrt.snapshot(), check_every=2,
                            churn_threshold=-1.0)
    assert trt.tick == jrt.tick and trt.re_ranks == jrt.re_ranks
    for k, v in jrt.hot_ids.items():
        np.testing.assert_array_equal(trt.hot_ids[k], v)
    jrt2 = jretier.Retierer(check_every=2, churn_threshold=-1.0)
    jrt2.restore_snapshot(jrt.snapshot())
    jt2 = {k: v for k, v in jt.items()}
    jt2, tt2 = _drive(((jtr, jst, jt2), (ttr, tst, tt)),
                      _lr_chunks(4, n=6)[3:], jrt2, trt)
    np.testing.assert_array_equal(trt.hot_ids_for("weights", H_LR),
                                  jrt2.hot_ids_for("weights", H_LR))
    with pytest.raises(ValueError, match="slot map"):
        tables_from_jax(tst, dict(tnp, **{"weights::hotmap": np.zeros(
            5, np.int32)}))


def test_drifting_zipf_ratings_equals_the_bench_stream():
    import bench

    from fps_tpu_torch.utils import datasets as tds

    for kw in (dict(seed=0), dict(seed=3, alpha=1.05, rotate_frac=0.25,
                                  shift=100)):
        want = bench._drifting_zipf_ratings(300, 500, 4000, **kw)
        got = tds.drifting_zipf_ratings(300, 500, 4000, **kw)
        assert sorted(got) == sorted(want)
        for k in want:
            np.testing.assert_array_equal(got[k], want[k], k)


def test_probe_chunk_and_logic_match_jax():
    from fps_tpu.tiering import probe as jprobe

    specs = {"a": tstore.TableSpec("a", 256, 8),
             "b": tstore.TableSpec("b", 40, 1)}
    got = tiering.probe_chunk(specs, num_workers=4, seed=5)
    want = jprobe.probe_chunk(specs, num_workers=4, seed=5)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    logic = tiering.ProbeLogic(specs)
    batch = {k: torch.from_numpy(v[0]) for k, v in got.items()}
    pulled = {n: torch.ones((batch[f"{n}_ids"].shape[0], s.dim))
              for n, s in specs.items()}
    out = logic.step(batch, pulled, (), None)
    assert float(out.out["n"]) == 128.0
    assert torch.equal(out.pushes["a"][1], torch.full((128, 8), -0.001))


def test_probe_trainer_runs_a_mapped_plan():
    """The probe's steps through a trainer with a planned partial head and
    a retierer: the mapped tier, the tracker, finite tables."""
    from fps_tpu_torch import ParamStore, Trainer, TrainerConfig

    mesh = _tmesh(1, 4)
    store = ParamStore(mesh, [tstore.TableSpec("t", 256, 8, hot_tier=64)])
    trainer = Trainer(mesh, store, tiering.ProbeLogic(["t"]),
                      config=TrainerConfig(hot_sync_every=2))
    trainer.retierer = tiering.Retierer(check_every=1, churn_threshold=-1.0)
    tables, _ = trainer.init_state(0)
    chunks = [tiering.probe_chunk(store.specs, num_workers=4, seed=s)
              for s in range(3)]
    tables, _, m = trainer.fit_stream(tables, (), iter(chunks), 1)
    assert trainer._mapped_tables() == {"t": 64}
    assert trainer.retierer.re_ranks >= 1
    _boundary(store, tables, "t", trainer.retierer.hot_ids_for("t", 64))
    assert np.isfinite(tables["t"].numpy()).all()


def _plan_text():
    from fps_tpu_torch.core.store import TableSpec
    from fps_tpu_torch.parallel.mesh import make_ps_mesh

    specs = {"t": TableSpec("t", 256, 8)}
    plan = tiering.TierPlan(hot_tier=64, hot_sync_every=2, dense=False,
                            coverage=0.5, reason="test")
    return tiering.lowered_plan_text(make_ps_mesh(4, device="cpu"), specs,
                                     {"t": plan}, hot_sync_every=2)


@pytest.mark.parametrize("call,item", [
    (_plan_text, "reduce_scatter"),
], ids=["lowered_plan_text"])
def test_what_waits_for_later_items_raises_naming_it(call, item):
    """What waited for a later item is taken now: ``lowered_plan_text``
    (the program auditor) records the planned program, whose census holds
    the tier's reconcile."""
    from fps_tpu_torch.analysis import certify, collective_profile

    text = call()
    assert item in {c.kind for c in collective_profile(text)}
    assert certify(text).ok


@pytest.mark.parametrize("what", ["state_dir", "restore"])
def test_sidecar_arguments_are_taken(what, tmp_path):
    """``Retierer(state_dir=)`` and ``restore`` are taken (refused before
    the sidecar was ported): without a sidecar a restore is a cold start
    (False), and a missing one too."""
    if what == "state_dir":
        rt = tiering.Retierer(state_dir=str(tmp_path), keep=2)
        assert rt.state_dir == str(tmp_path) and rt.keep == 2
        assert rt.restore(3) is False
    else:
        assert tiering.Retierer().restore(3) is False


def test_on_boundary_takes_a_recorder():
    """``Retierer.on_boundary(recorder=)`` (refused until telemetry was
    ported) is taken: a check with evidence sets the ``tiering.churn``
    gauge, as the reference's does."""
    from fps_tpu_torch import obs

    (_, _, _), (ttr, _, tt) = _lr_pair(1, 4)
    rt = ttr.retierer = tiering.Retierer(check_every=1)
    tt, _, _ = ttr.fit_stream(tt, (), iter(_lr_chunks(4)[:1]), 1)
    rec = obs.Recorder()
    rt.on_boundary(ttr, tt, 1, recorder=rec)
    assert "tiering.churn{table=weights}" in rec.snapshot()["gauges"]


@pytest.mark.parametrize("model", ["mf", "logreg"])
def test_a_resumed_rerank_run_equals_the_uninterrupted_one(tmp_path,
                                                           model):
    """A mapped run re-ranked at every check (``check_every=2``), saved
    every 2 chunks with its sidecar beside the checkpoints: a fresh trainer
    and retierer restore chunk 4's checkpoint and sidecar and finish the
    stream to the uninterrupted run's tables, replica, hot ids and decayed
    sketches, bit for bit."""
    from fps_tpu_torch.core.checkpoint import Checkpointer

    mf = model == "mf"
    name = ITEM if mf else "weights"
    chunks = _mf_chunks(4, n=6) if mf else _lr_chunks(4, n=6)

    def fresh(state_dir):
        (_, _, _, _), (tr, st, tt, tl) = _mf_pair(2, 2) if mf else (
            (None,) * 4, _lr_pair(2, 2)[1] + ((),))
        tr.retierer = tiering.Retierer(check_every=2, churn_threshold=-1.0,
                                       state_dir=state_dir)
        st.tables = dict(tt)
        return tr, st, tt, tl

    tr, st, tt, tl = fresh(None)
    tt, tl, _ = tr.fit_stream(tt, tl, chunks, 1)
    want_ids = tr.retierer.hot_ids[name].copy()
    # The canonical table's logical rows (a restore zero-fills padding).
    want = {k: st.dump_model(k)[1] if k == name else v.numpy()
            for k, v in tt.items()}
    assert tr.retierer.re_ranks >= 2
    d = str(tmp_path)
    tr, st, tt, tl = fresh(d)
    tr.fit_stream(tt, tl, chunks[:4], 1, checkpointer=Checkpointer(d),
                  checkpoint_every=2)
    assert os.path.exists(tiering.sidecar_path(d, 4))
    tr, st, tt, tl = fresh(d)
    tt, tl, step = tr.restore_checkpoint(Checkpointer(d), tl)
    assert step == 4 and tr.retierer.restore(step)
    assert not any(tstore.is_aux_key(k) and not k.endswith("::fold")
                   for k in tt)
    tt, tl, _ = tr.fit_stream(tt, tl, chunks[4:], 1, start_step=4)
    np.testing.assert_array_equal(tr.retierer.hot_ids[name], want_ids)
    got = {k: st.dump_model(k)[1] if k == name else v.numpy()
           for k, v in tt.items()}
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], k)


def test_the_sidecar_sweep_keeps_checkpointed_steps(tmp_path):
    """With ``keep=2`` the newest two sidecars stay, and so does every one
    whose step has a checkpoint beside it; a restore of a missing one is a
    cold start."""
    d = str(tmp_path)
    rt = tiering.Retierer(state_dir=d, keep=2)
    for step in (2, 4):
        open(os.path.join(d, f"ckpt_{step:012d}.npz"), "wb").close()
    for step in range(1, 7):
        rt._save_sidecar(step, {})
    kept = sorted(f for f in os.listdir(d) if f.startswith("tiering-"))
    assert kept == [os.path.basename(tiering.sidecar_path(d, s))
                    for s in (2, 4, 5, 6)]
    assert rt.restore(4) and not rt.restore(3)
