"""The static hot tier of the port (``TableSpec.hot_tier``,
``TrainerConfig.hot_sync_every``, ``ServerLogic.hot_fold``) against the JAX
package's.

The JAX side runs on the 8 virtual CPU devices of the test process
(``tests/conftest.py``); the port's on ``make_ps_mesh(S, D, device="cpu")``,
from the same converted state and the same numpy chunks. The units (the
replica pull, the push split, the buffers, the folds) match the JAX
functions bit for bit where the arithmetic is the same and within the
float32 bound elsewhere; the trainers match within 1e-5 of the largest
value, their hit counts exactly. The port's own oracles, ported from
``tests/test_hot_tier.py``: the exact mode runs the untiered program, every
call ends with the replica equal to the canonical head rows, a fully
replicated table makes no pull or push exchange (counted by a spy on
``collectives``), the resolution's policy and errors.

The tier's durability oracles of ``tests/test_hot_tier.py`` are held
elsewhere: the fold state in snapshots across the packages
(``tests/test_torch_checkpoint.py``), a tiered run resumed bit for bit
with its sidecar (``tests/test_torch_tiering.py``), rollback quarantine of
replica and table as a unit (``tests/test_torch_resilience.py``). Those
that wait for later items: the recorder's counters and the supervisor's
chaos runs (ROADMAP.md Queue 1 item 9). The lowered-program contracts (the
reconcile's reduce-scatter in the census, ReplicaConsistency, the pinned
tiered rows) are the program auditor's, held in
``tests/test_torch_analysis.py``; the launch counts and the collective spy
here test the same routes from the other side.
"""

from __future__ import annotations

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.core import api as japi
from fps_tpu.core import ingest as jingest
from fps_tpu.core import store as jstore
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    LogRegConfig,
    MFConfig,
    logistic_regression,
    online_mf,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import api as tapi
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel import mesh as tmesh

ITEM = "item_factors"
MF_KW = dict(num_users=96, num_items=61, rank=4, learning_rate=0.08,
             reg=0.005)
NF = 200  # logreg features
LR_KW = dict(num_features=NF, learning_rate=0.5)


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
    return tmesh.make_ps_mesh(S, D, device="cpu")


def _tier(trainer, store, name, *, H, E, cold_budget=0, gathered=True,
          combine=None, fold=None):
    """Set the hot tier on one table of a trainer of either package."""
    kw = {"dense_collectives": False} if gathered else {}
    store.specs[name] = dataclasses.replace(
        store.specs[name], hot_tier=H, cold_budget=cold_budget, **kw)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E)
    sl = trainer.server_logic[name]
    trainer.server_logic[name] = dataclasses.replace(
        sl, combine=combine or sl.combine, hot_fold=fold)


def _mf_pair(D, S, *, sync_every=None, combine="mean", **tier):
    jtr, jst = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW), combine=combine,
                          sync_every=sync_every)
    ttr, tst = online_mf(_tmesh(D, S), MFConfig(**MF_KW), combine=combine,
                         sync_every=sync_every)
    if tier:
        _tier(jtr, jst, ITEM, **tier)
        _tier(ttr, tst, ITEM, **tier)
    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    return (jtr, jt, jl), (ttr, tt, tl, tst)


def _zipf_items(n, seed):
    """Ratings whose item stream is Zipf-skewed, hottest ids first."""
    data = jdatasets.synthetic_ratings(MF_KW["num_users"], MF_KW["num_items"],
                                       n, rank=3, noise=0.05, seed=seed)
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, MF_KW["num_items"] + 1) ** 1.1
    data["item"] = rng.choice(MF_KW["num_items"], size=n,
                              p=p / p.sum()).astype(np.int32)
    return data


def _mf_chunks(W, sync_every=None, n=2, seed=3):
    data = _zipf_items(1600, seed)
    return list(jingest.epoch_chunks(
        data, num_workers=W, local_batch=8, steps_per_chunk=6,
        route_key="user", sync_every=sync_every, seed=11))[:n]


def _assert_close(got, want, what, tol=1e-5):
    want = np.asarray(want)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(np.asarray(got), want, rtol=0,
                               atol=tol * scale, err_msg=what)


def _replicas_equal(tables, name):
    """Every position's replica is the same bits."""
    reps = list(tables[tstore.hot_key(name)])
    for r in reps[1:]:
        assert torch.equal(r, reps[0])


def _boundary(store, tables, name):
    """The replica equals the canonical head rows, bit for bit."""
    rep = tables[tstore.hot_key(name)].numpy()
    np.testing.assert_array_equal(
        rep, store.lookup_host(name, np.arange(rep.shape[0])))
    _replicas_equal(tables, name)


def _compare(tm, jm, tt, jt, name, metric_keys):
    for k in metric_keys:
        if k == "n":
            np.testing.assert_array_equal(tm[k], np.asarray(jm[k]))
        else:
            np.testing.assert_allclose(tm[k], np.asarray(jm[k]), rtol=1e-5,
                                       atol=1e-6, err_msg=k)
    if "hot_tier" in jm:
        for key, want in jm["hot_tier"][name].items():
            got = tm["hot_tier"][name][key]
            if key == "delta_sq":
                np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                           atol=1e-9, err_msg=key)
            else:
                np.testing.assert_array_equal(got, np.asarray(want),
                                              err_msg=key)
        assert set(tm["hot_tier"][name]) == set(jm["hot_tier"][name])
    else:
        assert "hot_tier" not in tm
    tnp = to_numpy(tt)
    assert set(tnp) == set(jt), (sorted(tnp), sorted(jt))
    for k, v in jt.items():
        _assert_close(tnp[k], v, k)


def _lane(chunks, W, H):
    return int(max(jingest.per_worker_cold_counts(
        c["item"], W, hot_head=H).max() for c in chunks))


MODES = [None, 2]
SHAPES = [(1, 8), (2, 4)]


# ---------------------------------------------------------------------------
# Trainer parity: tiered MF and logreg against the JAX package.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head,compact", [
    ("full", False), ("partial", False), ("partial", True)],
    ids=["full", "partial-static", "partial-lane"])
@pytest.mark.parametrize("sync_every", MODES, ids=["sync", "ssp"])
@pytest.mark.parametrize("D,S", SHAPES)
def test_tiered_mf_matches_jax(D, S, sync_every, head, compact):
    """Tiered MF (mean combine, windows of 4 over chunks of 6 steps: a
    ragged tail each call), full or partial head, static or compacted cold
    routes (a fully replicated table has none to pack), through two
    ``run_chunk`` calls."""
    W = D * S
    chunks = _mf_chunks(W, sync_every)
    H = MF_KW["num_items"] if head == "full" else 20
    lane = _lane(chunks, W, H) if compact else 0
    (jtr, jt, jl), (ttr, tt, tl, tst) = _mf_pair(
        D, S, sync_every=sync_every, H=H, E=4, cold_budget=lane)
    assert ttr._hot_tier_map() == {ITEM: H}
    assert ttr._cold_compact_map() == ({ITEM: lane} if lane else {})
    for i, chunk in enumerate(chunks):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        _compare(to_numpy(tm), jm, tt, jt, ITEM, ("n", "se"))
        _assert_close(tl.numpy(), jl, "local state")
        _boundary(tst, tt, ITEM)


@pytest.mark.parametrize("sync_every", MODES, ids=["sync", "ssp"])
@pytest.mark.parametrize("D,S", SHAPES)
def test_tiered_mf_run_indexed_matches_jax(D, S, sync_every):
    """``run_indexed`` with a partial head: calls of 4 steps, windows of 3
    (a ragged tail a call), no lane."""
    from fps_tpu.core import device_ingest as jdi

    from fps_tpu_torch import DeviceDataset, DeviceEpochPlan

    W = D * S
    (jtr, jt, jl), (ttr, tt, tl, tst) = _mf_pair(
        D, S, sync_every=sync_every, H=24, E=3, cold_budget=4)
    for tr in (jtr, ttr):
        tr.config = dataclasses.replace(tr.config, max_steps_per_call=4)
    data = _zipf_items(640, 5)
    kw = dict(num_workers=W, local_batch=8, route_key="user", seed=7,
              sync_every=sync_every)
    jplan = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(D, S), data), **kw)
    tplan = DeviceEpochPlan(DeviceDataset(ttr.mesh, data), **kw)
    jt, jl, jms = jtr.run_indexed(jt, jl, jplan, jax.random.key(1))
    tt, tl, tms = ttr.run_indexed(tt, tl, tplan, 1)
    _compare(tms[0], jms[0], tt, jt, ITEM, ("n", "se"))
    _boundary(tst, tt, ITEM)


def _lr_data(seed=7):
    data = jdatasets.synthetic_sparse_classification(2048, NF, 8, seed=seed,
                                                     noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def _lr_pair(D, S, *, sync_every=None, **tier):
    jtr, jst = jlogistic_regression(_jmesh(D, S), JLogRegConfig(**LR_KW),
                                    sync_every=sync_every)
    ttr, tst = logistic_regression(_tmesh(D, S), LogRegConfig(**LR_KW),
                                   sync_every=sync_every)
    _tier(jtr, jst, "weights", **tier)
    _tier(ttr, tst, "weights", **tier)
    jt, _ = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    return (jtr, jt), (ttr, tt, tst)


def _lr_run(D, S, sync_every, chunks_n=3, **tier):
    W = D * S
    (jtr, jt), (ttr, tt, tst) = _lr_pair(D, S, sync_every=sync_every, **tier)
    chunks = list(jingest.epoch_chunks(
        _lr_data(), num_workers=W, local_batch=16, steps_per_chunk=4,
        sync_every=sync_every, seed=3))[:chunks_n]
    jl = tl = ()
    for i, chunk in enumerate(chunks):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        _compare(to_numpy(tm), jm, tt, jt, "weights", ("n", "logloss", "mistakes"))
        _boundary(tst, tt, "weights")
    return ttr, tt, tst


@pytest.mark.parametrize("head", ["full", "partial", "partial-lane"])
@pytest.mark.parametrize("sync_every", MODES, ids=["sync", "ssp"])
@pytest.mark.parametrize("D,S", SHAPES)
def test_tiered_logreg_matches_jax(monkeypatch, D, S, sync_every, head):
    """Tiered SSP-capable logistic regression (the additive fold on a
    scalar table: the buffer's scatter is K4's plain version, the replica's
    reads K5's) with windows of 3 over chunks of 4 steps; a partial head
    also with the lanes its chunks need (``LogisticRegressionWorker.
    pulled_ids_host`` certifies them)."""
    H = NF if head == "full" else 64
    lane = 0
    if head == "partial-lane":
        chunks = jingest.epoch_chunks(
            _lr_data(), num_workers=D * S, local_batch=16,
            steps_per_chunk=4, sync_every=sync_every, seed=3)
        lane = max(int(jingest.per_worker_cold_counts(
            c["feat_ids"].reshape(c["feat_ids"].shape[:-2] + (-1,)),
            D * S, hot_head=H).max()) for c in chunks)
    packed = []
    real = tstore.compact_cold
    monkeypatch.setattr("fps_tpu_torch.core.driver.compact_cold",
                        lambda *a, **k: packed.append(1) or real(*a, **k))
    ttr, _, _ = _lr_run(D, S, sync_every, H=H, E=3, cold_budget=lane)
    assert ttr._cold_compact_map() == ({"weights": lane} if lane else {})
    assert bool(packed) == bool(lane)  # the compacted lanes ran


@pytest.mark.parametrize("fold", ["adagrad", "adam"])
@pytest.mark.parametrize("D,S", SHAPES)
def test_hot_fold_matches_jax(D, S, fold):
    """A stateful hot fold on the fully replicated logreg table: its state
    sharded over the shard axis, within the bound of the JAX package's."""
    ttr, tt, _ = _lr_run(D, S, None, H=NF, E=3, fold=fold)
    state = tt[tstore.fold_key("weights")]
    rows, cols = tstore.hot_fold_state_shape(tapi.HotFold(kind=fold), NF, 1,
                                             S)
    assert state.numpy().shape == (rows, cols)
    assert all(b.shape == (rows // S, cols) for b in state)
    assert np.isfinite(state.numpy()).all()


@pytest.mark.parametrize("fold", ["adagrad", "adam"])
def test_hot_fold_mf_mean_matches_jax(fold):
    """The fold after the mean's normalization, on MF's item table at
    (2, 4), sync."""
    (jtr, jt, jl), (ttr, tt, tl, tst) = _mf_pair(
        2, 4, H=MF_KW["num_items"], E=3, fold=tapi.HotFold(kind=fold,
                                                            lr=0.05))
    _tier(jtr, jtr.store, ITEM, H=MF_KW["num_items"], E=3,
          fold=japi.HotFold(kind=fold, lr=0.05))
    for i, chunk in enumerate(_mf_chunks(8)):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        _compare(to_numpy(tm), jm, tt, jt, ITEM, ("n", "se"))
        _boundary(tst, tt, ITEM)


@pytest.mark.parametrize("combine", ["max", "min"])
@pytest.mark.parametrize("sync_every", MODES, ids=["sync", "ssp"])
def test_max_min_on_the_tier_match_jax(combine, sync_every):
    """The extremum combines ride the tier: the sentinel-filled buffer with
    its indicator column, a full-head pmax / pmin as the reconcile."""
    ttr, tt, tst = _lr_run(2, 4, sync_every, chunks_n=2, H=NF, E=3,
                           combine=combine)
    assert ttr._hot_tier_map() == {"weights": NF}


# ---------------------------------------------------------------------------
# Units against the JAX functions.
# ---------------------------------------------------------------------------

def _unit_inputs(seed, n=40, rows=16, dim=3):
    rng = np.random.default_rng(seed)
    ids = rng.integers(-1, rows + 6, n).astype(np.int32)
    deltas = rng.normal(0, 1, (n, dim)).astype(np.float32)
    replica = rng.normal(0, 1, (rows, dim)).astype(np.float32)
    return ids, deltas, replica


@pytest.mark.parametrize("dim", [1, 3])
def test_pull_hot_and_split_hot_push_match_jax_bit_for_bit(dim):
    ids, deltas, replica = _unit_inputs(1, dim=dim)
    H = 10
    jv, jm = jstore.pull_hot(jnp.asarray(replica), jnp.asarray(ids),
                             hot_ids=H)
    tv, tm = tstore.pull_hot(torch.from_numpy(replica), torch.from_numpy(ids),
                             hot_ids=H)
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    jc, jh = jstore.split_hot_push(jnp.asarray(ids), jnp.asarray(deltas),
                                   hot_ids=H)
    tc, th = tstore.split_hot_push(torch.from_numpy(ids),
                                   torch.from_numpy(deltas), hot_ids=H)
    for t, j in zip(tc + th, jc + jh):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))
        assert t.numpy().dtype == np.asarray(j).dtype


@pytest.mark.parametrize("budget", [4, 9, 40])
def test_compact_cold_matches_jax_bit_for_bit(budget):
    """Order-preserving packing, ``pos`` back to the batch, overflow
    dropped and counted (budget 4 overflows, 40 leaves padding)."""
    ids, deltas, _ = _unit_inputs(2)
    ids = np.where(ids < 8, -1, ids).astype(np.int32)  # hot slots masked
    j = jstore.compact_cold(jnp.asarray(ids), jnp.asarray(deltas),
                            budget=budget)
    t = tstore.compact_cold(torch.from_numpy(ids), torch.from_numpy(deltas),
                            budget=budget)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    jn = jstore.compact_cold(jnp.asarray(ids), None, budget=budget)
    tn = tstore.compact_cold(torch.from_numpy(ids), None, budget=budget)
    assert tn[1] is None and jn[1] is None
    np.testing.assert_array_equal(tn[0].numpy(), np.asarray(jn[0]))


@pytest.mark.parametrize("combine,fold", [
    ("sum", None), ("mean", None), ("max", None), ("min", None),
    ("sum", "adagrad"), ("mean", "adam")])
def test_hot_delta_init_and_accumulate_match_jax(combine, fold):
    """The fresh buffer (zeros, with the count column where counted, or
    the extremal sentinel) and two steps' accumulation into it, under
    every combine: bit-equal but for the additive scatter's order (within
    the float32 bound)."""
    ids, deltas, _ = _unit_inputs(3)
    H, dim = 10, deltas.shape[1]
    jf = japi.HotFold(kind=fold) if fold else None
    tf = tapi.HotFold(kind=fold) if fold else None
    jb = jstore.hot_delta_init(H, dim, jnp.float32, combine=combine, fold=jf)
    tb = tstore.hot_delta_init(H, dim, torch.float32, combine=combine,
                               fold=tf)
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    for step in range(2):
        i = np.roll(ids, step)
        d = np.roll(deltas, step, axis=0) * (step + 1)
        _, (hi, hd) = jstore.split_hot_push(jnp.asarray(i), jnp.asarray(d),
                                            hot_ids=H)
        jb = jstore.accumulate_hot(jb, hi, hd, combine=combine, fold=jf)
        tb = tstore.accumulate_hot(tb, torch.from_numpy(np.array(hi)),
                                   torch.from_numpy(np.array(hd)),
                                   combine=combine, fold=tf)
    if combine in ("max", "min"):
        np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    else:
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), rtol=0,
                                   atol=8 * np.finfo(np.float32).eps
                                   * np.abs(deltas).sum())
    jr = jstore._reset_delta(jb, combine)
    tr = tstore._reset_delta(tb, combine)
    np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))


@pytest.mark.parametrize("kind", ["adagrad", "adam"])
def test_apply_hot_fold_matches_jax(kind):
    """Two windows of the fold on one slice, a row untouched in each."""
    rng = np.random.default_rng(4)
    dim, rows = 3, 6
    jf, tf = japi.HotFold(kind=kind, lr=0.1), tapi.HotFold(kind=kind, lr=0.1)
    cols = tf.state_cols(dim)
    assert cols == jf.state_cols(dim)
    js = jnp.zeros((rows, cols), jnp.float32)
    ts = torch.zeros((rows, cols))
    for w in range(2):
        g = rng.normal(0, 1, (rows, dim)).astype(np.float32)
        counts = rng.integers(0, 3, rows).astype(np.float32)
        counts[w] = 0
        jstep, js = jstore.apply_hot_fold(jf, js, jnp.asarray(g),
                                          jnp.asarray(counts))
        tstep, ts = tstore.apply_hot_fold(tf, ts, torch.from_numpy(g),
                                          torch.from_numpy(counts))
        np.testing.assert_allclose(tstep.numpy(), np.asarray(jstep),
                                   rtol=2e-6, atol=1e-7)
        np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=2e-6,
                                   atol=1e-7)
        assert not tstep[w].any()
    assert tstore.hot_fold_state_shape(tf, 10, dim, 4) == \
        jstore.hot_fold_state_shape(jf, 10, dim, 4)


def test_hot_fold_spec_and_shorthand():
    with pytest.raises(ValueError, match="adagrid"):
        tapi.HotFold(kind="adagrid")
    assert tapi.as_hot_fold("adam") == tapi.HotFold(kind="adam")
    assert tapi.as_hot_fold(None) is None
    with pytest.raises(TypeError, match="hot_fold"):
        tapi.as_hot_fold(3)
    with pytest.raises(TypeError, match="hot_fold"):
        tapi.ServerLogic(hot_fold=3.0)
    with pytest.raises(ValueError, match="adagrid"):
        tapi.ServerLogic(hot_fold="adagrid")
    assert tapi.ServerLogic(hot_fold="adagrad").hot_fold == "adagrad"


def test_tier_keys_and_split():
    assert tstore.hot_key("t") == "t::hot" == jstore.hot_key("t")
    assert tstore.fold_key("t") == "t::fold" == jstore.fold_key("t")
    assert tstore.is_hot_key("t::hot") and not tstore.is_hot_key("t::fold")
    assert tstore.is_aux_key("t::fold") and not tstore.is_aux_key("t")
    assert tstore.hot_base("t::hot") == "t"
    canonical, hot, maps, gids, sketches, folds = tstore.split_tiering(
        {"a": 1, "a::hot": 2, "b": 3, "a::fold": 4})
    assert canonical == {"a": 1, "b": 3}
    assert hot == {"a": 2} and folds == {"a": 4}
    assert maps == gids == sketches == {}


# ---------------------------------------------------------------------------
# Oracles ported from tests/test_hot_tier.py.
# ---------------------------------------------------------------------------

def _lr_trainer(mesh, *, H=0, E=1, sync_every=None, **cfg):
    trainer, store = logistic_regression(mesh, LogRegConfig(**LR_KW),
                                         sync_every=sync_every)
    if H:
        store.specs["weights"] = dataclasses.replace(
            store.specs["weights"], hot_tier=H)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E,
                                         **cfg)
    return trainer, store


def _lr_chunks(W, sync_every=None, epochs=2):
    out = []
    for e in range(epochs):
        out += list(jingest.epoch_chunks(
            _lr_data(), num_workers=W, local_batch=16, steps_per_chunk=4,
            sync_every=sync_every, seed=3 + e))[:3]
    return out


def _fit(trainer, chunks, seed=1):
    tables, ls = trainer.init_state(0)
    return trainer.fit_stream(tables, ls, iter(chunks), seed)


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


def _collective_calls(monkeypatch):
    calls = {}
    for name in ("all_gather", "psum_scatter", "all_to_all", "psum",
                 "pmax", "pmin"):
        fn = getattr(collectives, name)

        def spy(*a, _fn=fn, _name=name, **k):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **k)

        monkeypatch.setattr(collectives, name, spy)
    return calls


def _same(a, b):
    ta, tb = to_numpy(a), to_numpy(b)
    if not isinstance(ta, dict):
        np.testing.assert_array_equal(ta, tb)
        return
    assert sorted(ta) == sorted(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k], tb[k], err_msg=k)


def _same_metrics(ma, mb):
    assert len(ma) == len(mb)
    for a, b in zip(ma, mb):
        la, lb = jax.tree.leaves_with_path(a), jax.tree.leaves_with_path(b)
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            np.testing.assert_array_equal(x, y, err_msg=str(path))


@pytest.mark.parametrize("case", ["exact", "one_position", "apply_fn",
                                  "callable"])
def test_tier_off_runs_the_untiered_program_logreg(monkeypatch, case):
    """``hot_sync_every = 1`` (the exact mode), a one-position mesh, and a
    fold the window cannot carry (``apply_fn`` or a callable combine,
    which warns once): the untiered program runs, the same kernel calls,
    tables and metrics bit-equal to an untiered run, no tier entry."""
    S = 1 if case == "one_position" else 4
    mesh = _tmesh(1, S)
    chunks = _lr_chunks(S, epochs=1)

    def run(H, E):
        trainer, store = _lr_trainer(mesh, H=H, E=E)
        if case in ("apply_fn", "callable"):
            trainer.server_logic["weights"] = tapi.ServerLogic(
                apply_fn=(lambda rows, d: rows + d) if case == "apply_fn"
                else None,
                combine=(lambda summed, counts: summed)
                if case == "callable" else "sum")
        calls = _kernel_calls(monkeypatch)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            tables, _, m = _fit(trainer, chunks)
        return tables, m, dict(calls), caught, trainer

    base, mb, cb, _, _ = run(0, 1)
    H, E = (64, 1) if case == "exact" else (64, 4)
    tiered, mt, ct, caught, trainer = run(H, E)
    assert trainer._hot_tier_map() == {}
    assert not any("::" in k for k in tiered)
    _same(tiered, base)
    _same_metrics(mt, mb)
    assert ct == cb
    tier_warns = [w for w in caught if "keeps the gathered" in str(w.message)]
    assert len(tier_warns) == (1 if case in ("apply_fn", "callable") else 0)


def test_exact_mode_bit_identical_mf_indexed():
    from fps_tpu_torch import DeviceDataset, DeviceEpochPlan

    mesh = _tmesh(1, 4)
    data = _zipf_items(256, 0)
    runs = []
    for H in (0, 12):
        trainer, store = online_mf(mesh, MFConfig(**MF_KW))
        if H:
            store.specs[ITEM] = dataclasses.replace(store.specs[ITEM],
                                                    hot_tier=H)
        plan = DeviceEpochPlan(DeviceDataset(mesh, data), num_workers=4,
                               local_batch=8, route_key="user")
        tables, ls = trainer.init_state(0)
        runs.append(trainer.run_indexed(tables, ls, plan, 3))
    _same(runs[0][0], runs[1][0])
    _same(runs[0][1], runs[1][1])
    _same_metrics(runs[0][2], runs[1][2])


def test_exact_mode_bit_identical_w2v():
    from fps_tpu_torch.models import word2vec as tw2v
    from fps_tpu_torch.utils.datasets import synthetic_corpus

    mesh = _tmesh(1, 4)
    tokens = synthetic_corpus(40, 1500, seed=0)
    uni = np.bincount(tokens, minlength=40).astype(np.float64)
    cfg = tw2v.W2VConfig(vocab_size=40, dim=8, window=2, negatives=2,
                         subsample_t=None)
    runs = []
    for H in (0, 10):
        trainer, store = tw2v.word2vec_block(mesh, cfg, uni, 16,
                                             max_steps_per_call=8)
        for t in ("in_embeddings", "out_embeddings"):
            store.specs[t] = dataclasses.replace(store.specs[t], hot_tier=H)
        plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=4,
                                       block_len=16, seed=0, mode="block")
        tables, ls = trainer.init_state(0)
        runs.append(trainer.run_indexed(tables, ls, plan, 4))
    _same(runs[0][0], runs[1][0])
    _same_metrics(runs[0][2], runs[1][2])


@pytest.mark.parametrize("D,S", SHAPES)
def test_tiered_sync_invariant_and_determinism(D, S):
    """Two tiered runs give the same bits; after every call the replica is
    the canonical head rows on every position, and the hit counts ride the
    out channel."""
    mesh = _tmesh(D, S)
    chunks = _lr_chunks(D * S)
    results = []
    for _ in range(2):
        trainer, store = _lr_trainer(mesh, H=64, E=3)
        tables, ls = trainer.init_state(0)
        ms = []
        for i, c in enumerate(chunks):
            tables, ls, m = trainer.run_chunk(tables, ls, c, i)
            _boundary(store, tables, "weights")
            ms.append(to_numpy(m))
        hot = ms[0]["hot_tier"]["weights"]
        assert 0 < hot["hot_rows"].sum() <= hot["pulled_rows"].sum()
        results.append((tables, ms))
    _same(results[0][0], results[1][0])
    _same_metrics(results[0][1], results[1][1])


@pytest.mark.parametrize("D,S", [(1, 4), (2, 4)])
def test_full_replication_makes_no_pull_or_push_exchange(monkeypatch, D, S):
    """``H >= num_ids``: a call's only collectives are the reconciles'
    reduce-scatter and all-gather (and the data axis's sum), one set a
    window; the untiered run exchanges every step."""
    mesh = _tmesh(D, S)
    chunks = _lr_chunks(D * S, epochs=1)
    T = chunks[0]["feat_ids"].shape[0]
    E = 3
    for H in (0, NF):
        trainer, _ = _lr_trainer(mesh, H=H, E=E)
        tables, ls = trainer.init_state(0)
        # The first call derives the replica (an all-gather); count the next.
        tables, ls, _ = trainer.run_chunk(tables, ls, chunks[0], 0)
        calls = _collective_calls(monkeypatch)
        trainer.run_chunk(tables, ls, chunks[1], 1)
        monkeypatch.undo()
        windows = -(-T // E)
        if H:
            want = {"psum_scatter": windows, "all_gather": windows}
            if D > 1:
                want["psum"] = windows
            assert calls == want
        else:
            assert calls.get("all_gather", 0) >= 2 * T


def test_tiered_ssp_reconciles_once_a_round(monkeypatch):
    """SSP: one reconcile at the end of every round, before the next
    round's snapshot; the boundary invariant after the call."""
    mesh = _tmesh(1, 4)
    s = 2
    chunks = _lr_chunks(4, sync_every=s, epochs=1)
    trainer, store = _lr_trainer(mesh, H=64, E=3, sync_every=s)
    rounds = []
    real = tstore.reconcile_hot

    def spy(*a, **k):
        rounds.append(1)
        return real(*a, **k)

    monkeypatch.setattr("fps_tpu_torch.core.driver.reconcile_hot", spy)
    tables, _, m = _fit(trainer, chunks)
    assert len(rounds) == sum(c["feat_ids"].shape[0] for c in chunks)
    assert np.isfinite(tables["weights"].numpy()).all()
    _boundary(store, tables, "weights")
    # SSP pulls read the round's snapshot, not the replica: no pull counts.
    assert set(m[0]["hot_tier"]["weights"]) == {"delta_sq"}


@pytest.mark.parametrize("T,E", [(6, 4), (8, 4), (3, 5)])
def test_mean_combine_windows_from_the_call_start(monkeypatch, T, E):
    """Sync windows of ``E`` steps counted from the call's first step, and
    one more reconcile on a ragged tail: ``ceil(T / E)`` a call."""
    mesh = _tmesh(1, 4)
    trainer, store = online_mf(mesh, MFConfig(**MF_KW), combine="mean")
    store.specs[ITEM] = dataclasses.replace(store.specs[ITEM], hot_tier=24)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E)
    chunk = next(jingest.epoch_chunks(
        _zipf_items(400, 1), num_workers=4, local_batch=8,
        steps_per_chunk=T, route_key="user"))
    n = []
    real = tstore.reconcile_hot
    monkeypatch.setattr("fps_tpu_torch.core.driver.reconcile_hot",
                        lambda *a, **k: n.append(1) or real(*a, **k))
    tables, ls = trainer.init_state(0)
    tables, ls, m = trainer.run_chunk(tables, ls, chunk, 2)
    assert len(n) == -(-T // E)
    assert np.isfinite(tables[ITEM].numpy()).all()
    _boundary(store, tables, ITEM)


def test_resolve_hot_tier_bad_values_raise():
    trainer, store = _lr_trainer(_tmesh(1, 4), E=4)
    for bad, match in (("asuto", "asuto"), (-1, "-1"), (2.5, "2.5")):
        spec = dataclasses.replace(store.specs["weights"], hot_tier=bad)
        with pytest.raises(ValueError, match=match):
            trainer._resolve_hot_tier(spec)


def test_resolve_hot_tier_policy():
    """The tier engages exactly where it can win and stay correct."""
    trainer, store = _lr_trainer(_tmesh(1, 4), H=64)
    spec = store.specs["weights"]
    assert trainer._resolve_hot_tier(spec) == 0  # E = 1: the exact mode
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=4)
    assert trainer._resolve_hot_tier(spec) == 64
    # An over-asked head clamps to the table.
    big = dataclasses.replace(spec, hot_tier=10 * NF)
    assert trainer._resolve_hot_tier(big) == NF
    # One position: nothing to save.
    tr1, st1 = _lr_trainer(_tmesh(1, 1), H=64, E=4)
    assert tr1._resolve_hot_tier(st1.specs["weights"]) == 0
    # max / min ride the tier; per-push folds keep their route.
    trainer.server_logic["weights"] = tapi.ServerLogic(combine="max")
    assert trainer._resolve_hot_tier(spec) == 64
    with pytest.warns(UserWarning, match="apply_fn"):
        trainer.server_logic["weights"] = tapi.ServerLogic(
            apply_fn=lambda rows, delta: rows + delta)
        assert trainer._resolve_hot_tier(spec) == 0
    trainer._tier_warned.clear()
    with pytest.warns(UserWarning, match="callable combine"):
        trainer.server_logic["weights"] = tapi.ServerLogic(
            combine=lambda summed, counts: summed)
        assert trainer._resolve_hot_tier(spec) == 0


def test_hot_tier_push_delay_rejected():
    trainer, _ = _lr_trainer(_tmesh(1, 4), H=64, E=4, push_delay=2)
    with pytest.raises(ValueError, match="push_delay"):
        trainer._hot_tier_map()
    tables, ls = trainer.init_state(0)
    with pytest.raises(ValueError, match="push_delay"):
        trainer.run_chunk(tables, ls, _lr_chunks(4, epochs=1)[0], 0)


def test_owner_major_head_layout_invariant():
    """Global id h lives in local row ``h // S`` of shard ``h % S``, and the
    derived replica is the canonical head rows."""
    mesh = _tmesh(2, 4)
    S, NIDS, H = 4, 10, 7

    def init(seed, ids):
        return torch.stack([ids.to(torch.float32),
                            ids.to(torch.float32) * 10.0], 1)

    store = tstore.ParamStore(mesh, [tstore.TableSpec("t", NIDS, 2,
                                                      init_fn=init,
                                                      hot_tier=H)])
    store.init(0)
    rps = tstore.rows_per_shard(NIDS, S)
    full = store.tables["t"].numpy()
    for h in range(NIDS):
        phys = (h % S) * rps + h // S
        assert phys == int(tstore.id_to_phys(h, S, rps))
        np.testing.assert_array_equal(full[phys], [h, 10.0 * h])
    rep = store.head_replica("t", H)
    assert len(rep) == 8 and rep.numpy().shape == (H, 2)
    np.testing.assert_array_equal(rep.numpy(),
                                  store.lookup_host("t", np.arange(H)))
    for r in rep[1:]:
        assert torch.equal(r, rep[0]) and r.data_ptr() != rep[0].data_ptr()
    with pytest.raises(ValueError, match="hot_rows"):
        store.head_replica("t", NIDS + 1)


def _fold_trainer(mesh, *, fold="adagrad", H=NF, E=3, combine="sum"):
    trainer, store = _lr_trainer(mesh, H=H, E=E)
    trainer.server_logic["weights"] = dataclasses.replace(
        trainer.server_logic["weights"], combine=combine, hot_fold=fold)
    return trainer, store


def test_hot_fold_validation():
    mesh = _tmesh(1, 4)
    trainer, _ = _fold_trainer(mesh, H=64)
    with pytest.raises(ValueError, match="PARTIAL head"):
        trainer._hot_tier_map()
    trainer, _ = _fold_trainer(mesh, E=1)
    with pytest.raises(ValueError, match="resolve ON"):
        trainer._hot_tier_map()
    trainer, _ = _fold_trainer(mesh, combine="max")
    with pytest.raises(ValueError, match="'sum'/'mean'"):
        trainer._hot_tier_map()
    trainer, _ = _fold_trainer(mesh)
    assert trainer._hot_tier_map() == {"weights": NF}
    assert trainer._hot_fold_map()["weights"].kind == "adagrad"


@pytest.mark.parametrize("fold", ["adagrad", "adam"])
def test_hot_fold_deterministic_sharded_and_load_bearing(fold):
    """A stateful fold's run is deterministic and keeps the boundary
    invariant; its state is sharded (slice ``s`` on every ``(d, s)``, the
    slices distinct), and it changes the trajectory against the plain
    additive fold."""
    mesh = _tmesh(2, 4)
    chunks = _lr_chunks(8)
    results = []
    for _ in range(2):
        trainer, store = _fold_trainer(mesh, fold=fold)
        tables, _, m = _fit(trainer, chunks)
        _boundary(store, tables, "weights")
        state = tables[tstore.fold_key("weights")]
        assert state.replicas == 2 and len(state) == 8
        assert torch.equal(state[0], state[4])
        assert not torch.equal(state[0], state[1])
        results.append(tables)
    _same(results[0], results[1])
    plain, _ = _lr_trainer(mesh, H=NF, E=3)
    ptables, _, _ = _fit(plain, chunks)
    assert not np.array_equal(ptables["weights"].numpy(),
                              results[0]["weights"].numpy())


def test_hot_channel_contracts():
    """The out channel must be a dict without a ``hot_tier`` key."""
    from fps_tpu_torch.core.api import StepOutput

    mesh = _tmesh(1, 4)
    trainer, _ = _lr_trainer(mesh, H=64, E=2)
    step = trainer.logic.step
    chunk = _lr_chunks(4, epochs=1)[0]
    for bad, err in (((lambda o: [o["n"]]), TypeError),
                     ((lambda o: dict(o, hot_tier=o["n"])), ValueError)):
        def patched(*a, _bad=bad, **k):
            out = step(*a, **k)
            return StepOutput(out.pushes, out.local_state, _bad(out.out))

        trainer.logic.step = patched
        tables, ls = trainer.init_state(0)
        with pytest.raises(err, match="hot_tier|hot-tier"):
            trainer.run_chunk(tables, ls, chunk, 0)


def test_convert_carries_the_tier_entries():
    """``tables_from_jax`` takes the JAX package's replica and fold state
    (``name::fold`` or a snapshot's ``fold::name``); ``to_numpy`` gives
    them back."""
    (jtr, jt), (ttr, tt, tst) = _lr_pair(2, 4, H=NF, E=3, fold="adagrad")
    chunk = _lr_chunks(8, epochs=1)[0]
    jt, _, _ = jtr.run_chunk(jt, (), chunk, jax.random.key(0))
    arrays = {k: np.asarray(v) for k, v in jt.items()}
    assert sorted(arrays) == ["weights", "weights::fold", "weights::hot"]
    got = to_numpy(tables_from_jax(tst, arrays))
    for k, v in arrays.items():
        np.testing.assert_array_equal(got[k], v)
    snap = dict(arrays)
    snap["fold::weights"] = snap.pop("weights::fold")
    got = to_numpy(tables_from_jax(tst, snap))
    np.testing.assert_array_equal(got["weights::fold"], arrays[
        "weights::fold"])
    # A tiered run continues from the JAX package's state.
    tables = tables_from_jax(tst, arrays)
    assert ttr._attach_hot(tables) is not tables
    tt2, _, _ = ttr.run_chunk(tables, (), chunk, 1)
    _boundary(tst, tt2, "weights")
    with pytest.raises(ValueError, match="not a store table"):
        tables_from_jax(tst, dict(arrays, **{"other::hot": arrays[
            "weights::hot"]}))


def test_init_state_after_a_tiered_run_derives_fresh_replicas():
    """``init_state`` gives the canonical tables only, so a run from fresh
    state derives its replica from them, not from an earlier run's (the
    JAX package's ``ParamStore.init`` keeps the old entries)."""
    trainer, store = _lr_trainer(_tmesh(1, 4), H=64, E=3)
    _fit(trainer, _lr_chunks(4, epochs=1))
    assert tstore.hot_key("weights") in store.tables
    tables, _ = trainer.init_state(0)
    assert sorted(tables) == ["weights"]
    tables = trainer._attach_hot(tables)
    _boundary(store, tables, "weights")


def _example(module, argv):
    import contextlib
    import io
    import json

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert module.main(argv) == 0
    return [json.loads(line) for line in buf.getvalue().splitlines()]


@pytest.mark.parametrize("example,argv,tables", [
    ("mf", ["--scale", "100k", "--local-batch", "256", "--hot-tier", "400",
            "--cold-budget", "200", "--ingest", "host"], ["item_factors"]),
    ("logreg_ssp", ["--num-features", "2000", "--num-examples", "8192",
                    "--local-batch", "256", "--sync-every", "2",
                    "--hot-tier", "2000", "--hot-fold", "adagrad"],
     ["weights"]),
])
def test_examples_take_the_hot_tier_flags(example, argv, tables):
    """``--hot-tier``, ``--hot-sync-every``, ``--cold-budget`` and
    ``--hot-fold`` on four shards: a ``hot_tier`` event naming the tiered
    tables, then a finished run."""
    import importlib

    module = importlib.import_module(f"fps_tpu_torch.examples.{example}")
    events = _example(module, argv + ["--device", "cpu", "--num-shards", "4",
                                      "--hot-sync-every", "4",
                                      "--epochs", "1"])
    (tier,) = [e for e in events if e["event"] == "hot_tier"]
    assert tier["tiered_tables"] == tables and not tier["exact_mode"]
    assert tier["compacted_tables"] == (tables if "--cold-budget" in argv
                                        else [])
    assert events[-1]["event"] == "done"


@pytest.mark.parametrize("argv,match", [
    (["--hot-tier", "-1"], "--hot-tier"),
    (["--hot-sync-every", "0"], "--hot-sync-every"),
    (["--cold-budget", "8"], "--cold-budget needs"),
    (["--hot-fold", "adam"], "--hot-fold needs"),
])
def test_example_hot_tier_flags_are_checked(argv, match):
    from fps_tpu_torch.examples import mf

    with pytest.raises(SystemExit, match=match):
        _example(mf, ["--scale", "100k", "--device", "cpu", "--num-shards",
                      "4"] + argv)


def test_example_auto_tier_trains():
    """``--auto-tier`` on four shards: the retierer plans after its warm-up
    chunks (the item table fits the replica budget, so the whole of it is
    replicated) and the run finishes with a ``"tiering"`` event and a test
    RMSE."""
    from fps_tpu_torch.examples import mf

    events = _example(mf, ["--scale", "100k", "--device", "cpu",
                           "--num-shards", "4", "--local-batch", "256",
                           "--steps-per-chunk", "4", "--epochs", "1",
                           "--auto-tier"])
    (tier,) = [e for e in events if e["event"] == "hot_tier"]
    assert tier["auto_tier"] and not tier["exact_mode"]
    (report,) = [e for e in events if e["event"] == "tiering"]
    assert report["planned"] and report["checks"] >= 1
    plan = report["plans"]["item_factors"]
    assert plan["hot_tier"] == 1682 and not plan["dense"]
    assert report["tiered_tables"] == ["item_factors"]
    assert events[-1]["event"] == "done"
    assert np.isfinite(events[-1]["test_rmse"])
