"""The port's mesh of several positions in one process, against the JAX
package's mesh of the same shape.

The JAX side runs on the 8 virtual CPU devices of the test process
(``tests/conftest.py``) under ``jax.shard_map``; the port's side on
``make_ps_mesh(S, D, device="cpu")``, eight positions on the one CPU
device. Inputs come from a numpy seed; state is carried across with
``fps_tpu_torch.convert``. Pulls are compared bit for bit, pushes within the
float32 bound of ``tests/test_torch_store.py`` (the mean's scaling rounds
once more on either side), and every data replica of a shard must equal the
others bit for bit. The additive push folds the gathered stream in the JAX
package's order (shard-major, data-minor), so its sums are the JAX
package's bits.
"""

import contextlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fps_tpu.core import device_ingest as jdi
from fps_tpu.core import ingest as jingest
from fps_tpu.core import store as jstore
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.models.passive_aggressive import PAConfig as JPAConfig
from fps_tpu.models.passive_aggressive import (
    passive_aggressive as jpassive_aggressive,
)
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
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel import mesh as tmesh

SHAPES = [(1, 8), (2, 4), (4, 2), (8, 1)]  # (data, shard)
EPS = np.finfo(np.float32).eps
NUM_IDS, DIM, B = 61, 3, 12  # 61 ids: padding rows at every S > 1


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


def _tmesh(D, S):
    return tmesh.make_ps_mesh(S, D, device="cpu")


def _inputs(D, S, seed):
    """A global physical table, ``W * B`` ids (duplicates across workers,
    ``-1`` and ids past the table mixed in) and their deltas."""
    rng = np.random.default_rng(seed)
    rows = tstore.padded_rows(NUM_IDS, S)
    table = rng.normal(0, 1, (rows, DIM)).astype(np.float32)
    ids = (rng.zipf(1.3, D * S * B) % (rows + 4)).astype(np.int32)
    ids[::7] = -1
    deltas = rng.normal(0, 1, (D * S * B, DIM)).astype(np.float32)
    return table, ids, deltas


def _blocks(D, S, table):
    """The port's blocks of a global table: shard ``s`` on ``(d, s)``."""
    return [torch.from_numpy(np.array(part, copy=True))
            for _ in range(D) for part in np.split(table, S)]


def _workers(x, W):
    return list(torch.chunk(torch.from_numpy(np.array(x)), W))


def _replicas(D, S, blocks):
    """The global table of each data replica; all must be the same bits."""
    out = [torch.cat(blocks[d * S:(d + 1) * S]).numpy() for d in range(D)]
    for d in range(1, D):
        np.testing.assert_array_equal(out[d], out[0])
    return out[0]


def _jax_pull(D, S, table, ids, **kw):
    run = jax.shard_map(
        lambda t, i: jstore.pull(t, i, num_shards=S, **kw), mesh=_jmesh(D, S),
        in_specs=(P(jmesh.SHARD_AXIS, None),
                  P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS))),
        out_specs=P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)), check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(table), jnp.asarray(ids)))


def _jax_push(D, S, table, ids, deltas, **kw):
    run = jax.shard_map(
        lambda t, i, d: jstore.push(
            t, i, d, num_shards=S,
            data_axis=jmesh.DATA_AXIS if D > 1 else None, **kw),
        mesh=_jmesh(D, S),
        in_specs=(P(jmesh.SHARD_AXIS, None),
                  P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)),
                  P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS), None)),
        out_specs=P(jmesh.SHARD_AXIS, None), check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(table), jnp.asarray(ids),
                                   jnp.asarray(deltas)))


def _bound(S, table, ids, deltas):
    """Twice the float32 summation bound of each physical row's pushes."""
    rows = table.shape[0]
    keep = (ids >= 0) & (ids < rows)
    phys = np.asarray(tstore.id_to_phys(ids[keep], S, rows // S))
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, phys, np.abs(deltas[keep]).astype(np.float64))
    count = np.bincount(phys, minlength=rows)[:, None] + 1.0
    return 2 * count * EPS * mag


# ---------------------------------------------------------------------------
# 1. The mesh.
# ---------------------------------------------------------------------------

def test_make_ps_mesh_shapes_axes_and_device_order():
    devs = [torch.device("cpu")] * 8
    mesh = tmesh.make_ps_mesh(num_shards=4, num_data=2, devices=devs)
    assert dict(mesh.shape) == {tmesh.DATA_AXIS: 2, tmesh.SHARD_AXIS: 4}
    assert len(mesh.devices) == 2 and all(len(r) == 4 for r in mesh.devices)
    assert mesh.device == torch.device("cpu")
    # num_shards defaults from the device count, as in the JAX package.
    assert tmesh.make_ps_mesh(num_data=2, devices=devs).shape[
        tmesh.SHARD_AXIS] == 4
    assert tmesh.make_ps_mesh(devices=devs).shape[tmesh.SHARD_AXIS] == 8
    # Row-major (data, shard): position d * S + s is the device given at
    # that index (CPU devices told apart by their index here).
    tagged = [torch.device("cpu", i) for i in range(8)]
    grid = tmesh.make_ps_mesh(4, 2, devices=tagged)
    assert grid.devices[1][2] == torch.device("cpu", 6)
    assert grid.positions == tuple(tagged) and grid.device == tagged[0]
    with pytest.raises(ValueError, match="unsupported device"):
        tmesh.make_ps_mesh(4, 2, devices=tagged[:7] + [torch.device("meta")])
    groups = collectives.groups(mesh, tmesh.SHARD_AXIS)
    assert groups == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert collectives.groups(mesh, tmesh.DATA_AXIS) == [
        [0, 4], [1, 5], [2, 6], [3, 7]]


def test_make_ps_mesh_non_divisible_and_non_covering_raise():
    devs = [torch.device("cpu")] * 8
    with pytest.raises(ValueError, match="not divisible"):
        tmesh.make_ps_mesh(num_data=3, devices=devs)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_ps_mesh(num_shards=3, num_data=2, devices=devs)
    with pytest.raises(ValueError, match="does not cover"):
        tmesh.make_ps_mesh(num_shards=16, num_data=1, devices=devs)
    with pytest.raises(ValueError, match="devices or device"):
        tmesh.make_ps_mesh(devices=devs, device="cpu")


# ---------------------------------------------------------------------------
# 2-4. Pull and push against the JAX package's, at every mesh of 8.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("D,S", SHAPES)
def test_pull_matches_jax_bit_for_bit(D, S):
    table, ids, _ = _inputs(D, S, seed=D)
    want = _jax_pull(D, S, table, ids)
    got = tstore.pull(_blocks(D, S, table), _workers(ids, D * S),
                      num_shards=S)
    assert len(got) == D * S
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)


@pytest.mark.parametrize("D,S", SHAPES)
def test_all_gather_along_dim_1_and_broadcast_match_jax(D, S):
    """``all_gather(..., dim=1)``, which the top-k merge uses for its
    candidates, against ``lax.all_gather(x, 'shard', axis=1, tiled=True)``;
    ``broadcast`` puts the home device's tensor on every position (the JAX
    package's replicated ``P()``)."""
    x = np.random.default_rng(S).normal(0, 1, (3, D * S * 2)).astype(
        np.float32)
    run = jax.shard_map(
        lambda a: jax.lax.all_gather(a, jmesh.SHARD_AXIS, axis=1, tiled=True),
        mesh=_jmesh(D, S),
        in_specs=P(None, (jmesh.DATA_AXIS, jmesh.SHARD_AXIS)),
        out_specs=P(None, (jmesh.DATA_AXIS, jmesh.SHARD_AXIS)),
        check_vma=False)
    want = np.asarray(jax.jit(run)(jnp.asarray(x)))
    mesh = _tmesh(D, S)
    got = collectives.all_gather(mesh, list(torch.chunk(
        torch.from_numpy(x), D * S, 1)), tmesh.SHARD_AXIS, dim=1)
    np.testing.assert_array_equal(torch.cat(got, 1).numpy(), want)
    home = torch.from_numpy(x)
    assert all(torch.equal(b, home) and b.device == dev for b, dev in zip(
        collectives.broadcast(mesh, home), mesh.positions))


def _callable_combine(summed, counts):
    return summed / (counts[:, None] + 1.0)


def _apply(cur, delta):
    return cur * 0.5 + delta


COMBINES = [("sum", None), ("mean", None), ("max", None), ("min", None),
            (_callable_combine, None), ("sum", _apply), ("mean", _apply)]


@pytest.mark.parametrize("combine,apply_fn", COMBINES,
                         ids=["sum", "mean", "max", "min", "callable",
                              "apply_fn", "mean_apply_fn"])
def test_push_matches_jax_at_every_mesh(combine, apply_fn):
    """Every combine and ``apply_fn``, with duplicates across workers: the
    JAX package's push within the float32 bound, the data replicas bit for
    bit, in place and not alike."""
    for D, S in SHAPES:
        table, ids, deltas = _inputs(D, S, seed=10 * D + S)
        want = _jax_push(D, S, table, ids, deltas, combine=combine,
                         apply_fn=apply_fn)
        kw = dict(num_shards=S, combine=combine, apply_fn=apply_fn)
        blocks = _blocks(D, S, table)
        got = _replicas(D, S, tstore.push(
            blocks, _workers(ids, D * S), _workers(deltas, D * S), **kw))
        bound = (_bound(S, table, ids, deltas)
                 + 4 * EPS * (np.abs(table) + np.abs(want - table)))
        assert np.all(np.abs(got - want) <= bound), (D, S)
        if apply_fn is None and combine in ("sum", "max", "min"):
            # The same stream order (shard-major, data-minor) folded the
            # same way: the same bits. A worker-order stream parts here.
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_replicas(D, S, blocks), table)
        inplace = tstore.push(blocks, _workers(ids, D * S),
                              _workers(deltas, D * S), inplace=True, **kw)
        assert all(a is b for a, b in zip(inplace, blocks))
        np.testing.assert_array_equal(_replicas(D, S, blocks), got)


@pytest.mark.parametrize("D,S", SHAPES)
def test_dense_route_matches_gathered_and_jax(D, S):
    """The dense route (``TableSpec.dense_collectives=True``) against the
    gathered route in the port, and against the JAX package's dense route
    (whose pull reads an id past the table as another row: those ids are
    left out of that comparison)."""
    table, ids, deltas = _inputs(D, S, seed=20 + D)
    W = D * S
    args = (_workers(ids, W), _workers(deltas, W))
    gathered = _replicas(D, S, tstore.push(_blocks(D, S, table), *args,
                                           num_shards=S))
    dense = _replicas(D, S, tstore.push(_blocks(D, S, table), *args,
                                        num_shards=S, dense=True))
    bound = _bound(S, table, ids, deltas)
    assert np.all(np.abs(dense - gathered) <= bound)
    np.testing.assert_array_equal(
        torch.cat(tstore.pull(_blocks(D, S, table), args[0], num_shards=S,
                              dense=True)).numpy(),
        torch.cat(tstore.pull(_blocks(D, S, table), args[0],
                              num_shards=S)).numpy())
    inside = np.where(ids < table.shape[0], ids, -1).astype(np.int32)
    want = _jax_push(D, S, table, inside, deltas, dense=True)
    got = _replicas(D, S, tstore.push(_blocks(D, S, table),
                                      _workers(inside, W), args[1],
                                      num_shards=S, dense=True))
    assert np.all(np.abs(got - want) <= bound)
    np.testing.assert_array_equal(
        torch.cat(tstore.pull(_blocks(D, S, table), _workers(inside, W),
                              num_shards=S, dense=True)).numpy(),
        _jax_pull(D, S, table, inside, dense=True))


# ---------------------------------------------------------------------------
# 5. Init; 8. convert.
# ---------------------------------------------------------------------------

def test_param_store_init_is_the_same_table_at_every_shard_count():
    spec = tstore.TableSpec("t", NUM_IDS, DIM,
                            init_fn=tstore.ranged_uniform_init(-1, 1, DIM))
    dumps = {}
    for D, S in [(1, 1), (1, 2), (1, 4), (1, 8), (2, 4)]:
        store = tstore.ParamStore(_tmesh(D, S), [spec])
        blocks = store.init(3)["t"]
        assert len(blocks) == D * S and blocks.replicas == D
        assert all(b.shape == (tstore.rows_per_shard(NUM_IDS, S), DIM)
                   for b in blocks)
        _replicas(D, S, list(blocks))
        dumps[(D, S)] = store.dump_model("t")[1]
        np.testing.assert_array_equal(store.table("t").numpy(),
                                      blocks.numpy())
    for key, vals in dumps.items():
        np.testing.assert_array_equal(vals, dumps[(1, 1)], key)


@pytest.mark.parametrize("D,S", [(1, 8), (2, 4)])
def test_convert_round_trip_is_the_identity(D, S):
    trainer, store = online_mf(_tmesh(D, S), MFConfig(num_users=50,
                                                      num_items=NUM_IDS))
    jtrainer, _ = jonline_mf(_jmesh(D, S), JMFConfig(num_users=50,
                                                     num_items=NUM_IDS))
    jtables, jlocal = jtrainer.init_state(jax.random.key(1))
    arrays = {k: np.asarray(v) for k, v in jtables.items()}
    tables = tables_from_jax(store, arrays)
    for name, blocks in tables.items():
        assert len(blocks) == D * S
        np.testing.assert_array_equal(to_numpy(tables)[name], arrays[name])
        _replicas(D, S, list(blocks))
    local = local_state_from_jax(trainer.logic, np.asarray(jlocal),
                                 mesh=trainer.mesh)
    assert len(local) == D * S
    np.testing.assert_array_equal(to_numpy(local), np.asarray(jlocal))
    store.put("item_factors",
              torch.from_numpy(np.array(arrays["item_factors"])))
    np.testing.assert_array_equal(store.tables["item_factors"].numpy(),
                                  arrays["item_factors"])


# ---------------------------------------------------------------------------
# 6-7. The models end to end.
# ---------------------------------------------------------------------------

MF_KW = dict(num_users=96, num_items=NUM_IDS, rank=4, learning_rate=0.08,
             reg=0.005)


def _mf_pair(D, S, sync_every, hot_items=0, **kw):
    jtrainer, _ = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW,
                                                     hot_items=hot_items),
                             combine="mean", sync_every=sync_every, **kw)
    ttrainer, tstore_ = online_mf(_tmesh(D, S), MFConfig(**MF_KW,
                                                         hot_items=hot_items),
                                  combine="mean", sync_every=sync_every, **kw)
    jtables, jlocal = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore_, {k: np.asarray(v)
                                        for k, v in jtables.items()})
    tlocal = local_state_from_jax(ttrainer.logic, np.asarray(jlocal),
                                  mesh=ttrainer.mesh)
    return (jtrainer, jtables, jlocal), (ttrainer, ttables, tlocal)


def _close(tm, jm, ttables, jtables, tlocal, jlocal, D, S):
    np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
    # Per-step squared error: float32 sums of B terms, and of the workers'
    # sums, in other orders.
    np.testing.assert_allclose(tm["se"], np.asarray(jm["se"]), rtol=1e-5,
                               atol=1e-7)
    for name, blocks in ttables.items():
        got = _replicas(D, S, list(blocks))
        np.testing.assert_allclose(got, np.asarray(jtables[name]), rtol=0,
                                   atol=1e-6)
    np.testing.assert_allclose(tlocal.numpy(), np.asarray(jlocal), rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("D,S", [(1, 8), (2, 4)])
def test_mf_matches_jax_on_the_mesh(D, S, sync_every):
    """Online MF (mean combine, no random draws) from the same converted
    state, through ``run_chunk`` and then ``run_indexed``: per-step metrics
    summed over the workers, the item table (every replica) and the
    workers' user factors. Factors are O(0.1); the two frameworks part by
    the order of float32 sums (measured differences about 1e-8)."""
    W = D * S
    data = jdatasets.synthetic_ratings(96, NUM_IDS, 2000, rank=3, noise=0.05,
                                       seed=3)
    (jtr, jt, jl), (ttr, tt, tl) = _mf_pair(D, S, sync_every,
                                            max_steps_per_call=4)
    chunks = jingest.epoch_chunks(data, num_workers=W, local_batch=8,
                                  steps_per_chunk=4, route_key="user",
                                  sync_every=sync_every, seed=11)
    for i, chunk in enumerate(list(chunks)[:2]):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        _close(to_numpy(tm), jm, tt, jt, tl, jl, D, S)
    plan_kw = dict(num_workers=W, local_batch=8, route_key="user", seed=7,
                   sync_every=sync_every)
    jplan = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(D, S), data),
                                **plan_kw)
    tplan = DeviceEpochPlan(DeviceDataset(ttr.mesh, data), **plan_kw)
    jt, jl, jms = jtr.run_indexed(jt, jl, jplan, jax.random.key(1))
    tt, tl, tms = ttr.run_indexed(tt, tl, tplan, 1)
    _close(tms[0], jms[0], tt, jt, tl, jl, D, S)
    assert float(np.sum(tms[0]["n"])) == len(data["rating"])


def test_mf_hot_items_match_jax_on_the_mesh():
    """``hot_items = 16`` at ``(2, 4)``: each shard's head is its first
    ``ceil(16 / 4)`` local rows, pushed through K3's plain version (the JAX
    package off a TPU folds them by its XLA scatter: the same sums in
    another order)."""
    data = jdatasets.synthetic_ratings(96, NUM_IDS, 2000, rank=3, noise=0.05,
                                       seed=4)
    (jtr, jt, jl), (ttr, tt, tl) = _mf_pair(2, 4, None, hot_items=16)
    assert ttr._hot_rows("item_factors") == 4
    chunks = jingest.epoch_chunks(data, num_workers=8, local_batch=8,
                                  steps_per_chunk=4, route_key="user",
                                  seed=11)
    for i, chunk in enumerate(list(chunks)[:2]):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        _close(to_numpy(tm), jm, tt, jt, tl, jl, 2, 4)


def _tap_pair(jlib, tlib):
    def jtap(tables, batch, local_state, t):
        return {"item_sum": jlib.sum(tables["item_factors"]),
                "user_sum": jlib.sum(local_state)}

    def ttap(tables, batch, local_state, t):
        return {"item_sum": tlib.sum(tables["item_factors"]),
                "user_sum": tlib.sum(local_state)}
    return jtap, ttap


@pytest.mark.parametrize("push_delay", [0, 2])
def test_step_tap_and_push_delay_on_the_mesh_match_jax(push_delay):
    """At ``(2, 4)``: the step tap runs on each worker's blocks and local
    state, its leaves ``(T, W)`` as the JAX package gathers them; with
    ``push_delay = 2`` every worker's pushes wait two steps in one queue,
    and the tables, local state and metrics still match."""
    import dataclasses

    data = jdatasets.synthetic_ratings(96, NUM_IDS, 2000, rank=3, noise=0.05,
                                       seed=5)
    (jtr, jt, jl), (ttr, tt, tl) = _mf_pair(2, 4, None,
                                            push_delay=push_delay)
    jtap, ttap = _tap_pair(jnp, torch)
    jtr.config = dataclasses.replace(jtr.config, step_tap=jtap)
    ttr.config = dataclasses.replace(ttr.config, step_tap=ttap)
    chunks = jingest.epoch_chunks(data, num_workers=8, local_batch=8,
                                  steps_per_chunk=4, route_key="user",
                                  seed=11)
    for i, chunk in enumerate(list(chunks)[:2]):
        jt, jl, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, chunk, i)
        tm = to_numpy(tm)
        for k in ("item_sum", "user_sum"):
            assert tm["tap"][k].shape == (4, 8)
            np.testing.assert_allclose(tm["tap"][k],
                                       np.asarray(jm["tap"][k]), rtol=1e-5,
                                       atol=1e-6)
        _close({k: v for k, v in tm.items() if k != "tap"}, jm, tt, jt, tl,
               jl, 2, 4)


def _sparse_parity(jtrainer, ttrainer, tstore_, data, *, chunks_n,
                   local_batch, sync_every=None, atol=1e-5):
    jtables, _ = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore_, {k: np.asarray(v)
                                        for k, v in jtables.items()})
    jlocal, tlocal = (), ()
    D = ttrainer.mesh.shape[tmesh.DATA_AXIS]
    S = ttrainer.num_shards
    chunks = jingest.epoch_chunks(data, num_workers=D * S,
                                  local_batch=local_batch, steps_per_chunk=2,
                                  sync_every=sync_every, seed=3)
    for i, chunk in enumerate(list(chunks)[:chunks_n]):
        jtables, jlocal, jm = jtrainer.run_chunk(jtables, jlocal, chunk,
                                                 jax.random.key(i))
        ttables, tlocal, tm = ttrainer.run_chunk(ttables, tlocal, chunk, i)
        tm = to_numpy(tm)
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
        np.testing.assert_array_equal(tm["mistakes"],
                                      np.asarray(jm["mistakes"]))
        for name, blocks in ttables.items():
            want = np.asarray(jtables[name])
            got = _replicas(D, S, list(blocks))
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=atol * scale)
    return ttables


NF, NNZ, H = 500, 10, 64


@pytest.mark.parametrize("classes", [2, 5])
def test_pa_matches_jax_at_eight_shards(classes):
    """Binary PA-I (with the head-prefix layout and its declared head,
    which no mesh of more than one position keeps) and 5-class PA-I at
    ``(1, 8)``. Both sides read exactly and fold in the same stream order;
    they part where XLA and PyTorch order a margin's sum."""
    if classes == 2:
        data = jdatasets.synthetic_sparse_classification(4096, NF, NNZ, seed=9,
                                                         noise=0.05)
        data, q = jdatasets.head_sort_slots(data, H)
        kw = dict(num_features=NF, hot_features=H, head_prefix_cols=q)
    else:
        data = jdatasets.synthetic_sparse_multiclass(4096, NF, classes, NNZ,
                                                     seed=3)
        kw = dict(num_features=NF, num_classes=classes)
    kw.update(variant="PA-I", C=1.0)
    jtrainer, _ = jpassive_aggressive(_jmesh(1, 8), JPAConfig(**kw))
    ttrainer, store = passive_aggressive(_tmesh(1, 8), PAConfig(**kw))
    batch = {k: torch.from_numpy(np.asarray(v[:64]))
             for k, v in data.items()}
    assert ttrainer._head_prefix(batch) == {}
    tables = _sparse_parity(jtrainer, ttrainer, store, data, chunks_n=3,
                            local_batch=64)
    assert np.abs(tables["weights"].numpy()).max() > 0


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_logreg_matches_jax_at_eight_shards(optimizer):
    data = jdatasets.synthetic_sparse_classification(4096, 400, 8, seed=7,
                                                     noise=0.05)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    kw = dict(num_features=400, learning_rate=0.5 if optimizer == "sgd"
              else 0.3, optimizer=optimizer)
    jtrainer, _ = jlogistic_regression(_jmesh(1, 8), JLogRegConfig(**kw),
                                       sync_every=2)
    ttrainer, store = logistic_regression(_tmesh(1, 8), LogRegConfig(**kw),
                                          sync_every=2)
    _sparse_parity(jtrainer, ttrainer, store, data, chunks_n=3,
                   local_batch=32, sync_every=2)


# ---------------------------------------------------------------------------
# The example's mesh flags.
# ---------------------------------------------------------------------------

def test_mf_example_runs_on_four_shards():
    from fps_tpu_torch.examples import mf

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mf.main(["--scale", "100k", "--device", "cpu",
                        "--num-shards", "4", "--local-batch", "512",
                        "--steps-per-chunk", "8"]) == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert events[0]["mesh"] == {"data": 1, "shard": 4}
    done = events[-1]
    assert done["event"] == "done" and 0 < done["test_rmse"] < 2.0
