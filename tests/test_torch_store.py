"""The PyTorch port's store, mesh and config against the JAX package's.

``pull``, ``pull_local`` and ``push`` (every combine, a callable combine and
``apply_fn``) run in the port on the CPU and in the JAX package under
``jax.shard_map`` on a one-device mesh, on the same numpy inputs. Both fold
duplicates in batch order, so the results are compared bit for bit.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fps_tpu.core import store as jstore
from fps_tpu.parallel import mesh as jmesh

from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.core.api import ServerLogic, StepOutput, WorkerLogic
from fps_tpu_torch.core.driver import TrainerConfig
from fps_tpu_torch.models.matrix_factorization import MFConfig, make_store
from fps_tpu_torch.parallel import mesh as tmesh


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(R, D, B, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    ids = (rng.zipf(1.4, B) % (R + 3)).astype(np.int32)  # some ids >= R
    ids[::6] = -1
    deltas = rng.normal(0, 1, (B, D)).astype(np.float32)
    return table, ids, deltas


def _on_one_device(fn, *args):
    """Run ``fn`` under shard_map on a (data=1, shard=1) JAX mesh."""
    mesh = jmesh.make_ps_mesh(num_shards=1, num_data=1,
                              devices=jax.devices()[:1])
    run = jax.shard_map(fn, mesh=mesh, in_specs=tuple(P() for _ in args),
                        out_specs=P(), check_vma=False)
    return np.asarray(jax.jit(run)(*(jnp.asarray(a) for a in args)))


def _t(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


@pytest.mark.parametrize("R,D,B", [(30, 4, 64), (200, 10, 700)])
def test_pull_matches_jax(R, D, B):
    table, ids, _ = _inputs(R, D, B, seed=B)
    want = _on_one_device(
        lambda t, i: jstore.pull(t, i, num_shards=1), table, ids)
    t, i = _t(table, ids)
    np.testing.assert_array_equal(
        tstore.pull(t, i, num_shards=1).numpy(), want)


@pytest.mark.parametrize("num_shards", [1, 3])
def test_pull_local_matches_jax(num_shards):
    table, _, _ = _inputs(40, 5, 1, seed=2)
    ids = (np.arange(60, dtype=np.int32) * 7) % 40
    ids = ids[ids % num_shards == 1 % num_shards]  # rows this worker owns
    want = np.asarray(jstore.pull_local(jnp.asarray(table), jnp.asarray(ids),
                                        num_shards=num_shards))
    t, i = _t(table, ids)
    np.testing.assert_array_equal(
        tstore.pull_local(t, i, num_shards=num_shards).numpy(), want)


def _callable_combine(summed, counts):
    return summed / (counts[:, None] + 1.0)


def _apply(cur, delta):
    return cur * 0.5 + delta


@pytest.mark.parametrize("inplace", [False, True])
@pytest.mark.parametrize("combine,apply_fn", [
    ("sum", None), ("mean", None), ("max", None), ("min", None),
    (_callable_combine, None), ("sum", _apply), ("mean", _apply),
])
def test_push_matches_jax(combine, apply_fn, inplace):
    table, ids, deltas = _inputs(50, 6, 400, seed=7)
    want = _on_one_device(
        lambda t, i, d: jstore.push(t, i, d, num_shards=1, data_axis=None,
                                    apply_fn=apply_fn, combine=combine),
        table, ids, deltas)
    t, i, d = _t(table, ids, deltas)
    got = tstore.push(t, i, d, num_shards=1, apply_fn=apply_fn,
                      combine=combine, inplace=inplace).numpy()
    if combine == "mean":
        # XLA's CPU backend fuses the mean's scaling multiply with the add
        # that follows it (one rounding); the port rounds the product and
        # the sum separately. They differ by at most one rounding of each.
        bound = 2 * np.finfo(np.float32).eps * (np.abs(table)
                                                + np.abs(want - table))
        assert np.all(np.abs(got - want) <= bound)
    else:
        np.testing.assert_array_equal(got, want)
    # inplace=True updates the caller's table; False leaves it unchanged.
    np.testing.assert_array_equal(t.numpy(), got if inplace else table)


def test_push_rejects_unknown_combine():
    t, i, d = _t(*_inputs(5, 2, 4, seed=1))
    with pytest.raises(ValueError, match="combine"):
        tstore.push(t, i, d, num_shards=1, combine="median")


def test_layout_helpers_match_jax():
    ids = np.arange(103)
    for S in (1, 2, 5):
        rps = tstore.rows_per_shard(103, S)
        assert rps == jstore.rows_per_shard(103, S)
        assert tstore.padded_rows(103, S) == jstore.padded_rows(103, S)
        phys = tstore.id_to_phys(ids, S, rps)
        np.testing.assert_array_equal(phys, jstore.id_to_phys(ids, S, rps))
        np.testing.assert_array_equal(tstore.phys_to_id(phys, S, rps), ids)
        tphys = tstore.id_to_phys(torch.from_numpy(ids), S, rps)
        np.testing.assert_array_equal(tphys.numpy(), phys)


def test_table_values_per_id_and_independent_of_shard_count():
    init = tstore.ranged_uniform_init(-0.3, 0.2, 4)
    by_shards = {}
    for S in (1, 2, 5):
        vals = tstore.make_table_values(11, 37, 4, S, init).numpy()
        rps = tstore.rows_per_shard(37, S)
        by_shards[S] = vals[tstore.id_to_phys(np.arange(37), S, rps)]
    for S in (2, 5):
        np.testing.assert_array_equal(by_shards[S], by_shards[1])
    v = by_shards[1]
    assert v.dtype == np.float32 and (v >= -0.3).all() and (v <= 0.2).all()
    assert len(np.unique(v)) == v.size  # no repeated draws
    other = tstore.make_table_values(12, 37, 4, 1, init).numpy()
    assert not np.array_equal(other, v)


def test_param_store_init_lookup_dump():
    mesh = tmesh.make_ps_mesh(device="cpu")
    spec = tstore.TableSpec("t", num_ids=9, dim=3,
                            init_fn=tstore.ranged_uniform_init(0, 1, 3))
    store = tstore.ParamStore(mesh, [spec])
    tables = store.init(5)
    (block,) = tables["t"]
    assert block.shape == (9, 3) and block.device.type == "cpu"
    # One position: the whole table is the block itself.
    assert store.table("t") is block
    ids, vals = store.dump_model("t")
    np.testing.assert_array_equal(vals, tables["t"].numpy())
    np.testing.assert_array_equal(store.lookup_host("t", np.array([4, 0])),
                                  vals[[4, 0]])
    zeros = tstore.ParamStore(mesh, [spec.zeros_init()]).init(5)["t"]
    assert not zeros.numpy().any()


@pytest.mark.parametrize("guard", ["mask"], ids=["guard"])
def test_guard_options_are_taken(guard):
    """``TrainerConfig.guard`` is taken (it was refused before the guard
    was ported), and a bad mode fails as the JAX package's does."""
    from fps_tpu_torch.core.resilience import as_guard

    assert TrainerConfig(guard=guard).guard == guard
    assert as_guard(guard).mode == guard
    with pytest.raises(ValueError, match="guard mode"):
        as_guard("drop")


def test_auto_tier_option_is_taken():
    """``TrainerConfig(auto_tier=True)`` constructs, and the store's tier
    entries of the adaptive tier have their reserved keys."""
    assert TrainerConfig(auto_tier=True).auto_tier
    for key in ("t::hotmap", "t::hotids", "t::sketch"):
        assert tstore.is_aux_key(key)
    canonical, *aux = tstore.split_tiering(
        {"t": 0, "t::hotmap": 1, "t::hotids": 2, "t::sketch": 3})
    assert canonical == {"t": 0} and aux[1:4] == [{"t": 1}, {"t": 2},
                                                 {"t": 3}]


def _hot_push_matches_jax():
    """``TableSpec(hot_ids=2)``'s push without a prefix route is the
    hot/cold split (K3's plain version for the head): the sums of the JAX
    package's push, in another order."""
    spec = tstore.TableSpec("t", 4, 2, hot_ids=2)
    table, ids, deltas = _inputs(spec.num_ids, spec.dim, 60, seed=5)
    want = _on_one_device(
        lambda t, i, d: jstore.push(t, i, d, num_shards=1, data_axis=None,
                                    hot_rows=spec.hot_ids),
        table, ids, deltas)
    t, i, d = _t(table, ids, deltas)
    got = tstore.push(t, i, d, num_shards=1, hot_rows=spec.hot_ids).numpy()
    assert np.all(np.abs(got - want) <= _bound(table, ids, deltas))


def _hot_ids_auto_constructs():
    """``hot_ids="auto"`` is a table spec; the trainer resolves it (see
    test_hot_ids_auto_resolution)."""
    assert tstore.TableSpec("t", 4, 2, hot_ids="auto").hot_ids == "auto"
    with pytest.raises(ValueError, match="hot_ids"):
        tstore.TableSpec("t", 4, 2, hot_ids=-1)


def _mf_hot_items_set_the_head():
    """``MFConfig.hot_items`` sets ``hot_ids = min(hot_items, num_items)``
    on the item table, as the JAX package's ``make_store`` does."""
    from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
    from fps_tpu.models.matrix_factorization import make_store as jmake_store

    mesh = tmesh.make_ps_mesh(device="cpu")
    jm = jmesh.make_ps_mesh(num_shards=1, num_data=1,
                            devices=jax.devices()[:1])
    for hot in (3, 6, 9):
        kw = dict(num_users=4, num_items=6, hot_items=hot)
        got = make_store(mesh, MFConfig(**kw)).specs["item_factors"]
        want = jmake_store(jm, JMFConfig(**kw)).specs["item_factors"]
        assert got.hot_ids == want.hot_ids == min(hot, 6)


@pytest.mark.parametrize("check", [_hot_push_matches_jax,
                                   _hot_ids_auto_constructs,
                                   _mf_hot_items_set_the_head],
                         ids=["hot_ids", "hot_ids_auto", "mf_hot_items"])
def test_hot_options_are_ported(check):
    check()


def _bound(table, ids, deltas):
    """Twice the float32 summation bound of each row's pushes: two sums of
    the same terms in different orders."""
    R = table.shape[0]
    keep = (ids >= 0) & (ids < R)
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids[keep], np.abs(deltas[keep]).astype(np.float64))
    count = np.bincount(ids[keep], minlength=R)[:, None] + 1.0
    return 2 * count * np.finfo(np.float32).eps * mag


@pytest.mark.parametrize("combine,apply_fn", [
    ("sum", None), ("mean", None), (_callable_combine, None),
    ("sum", _apply), ("mean", _apply)])
@pytest.mark.parametrize("hot", [8, 50, 200])
def test_hot_push_matches_jax(combine, apply_fn, hot):
    """``push`` with ``hot_rows`` (the split, or the whole table through
    K3's plain version when ``hot >= R``) against the JAX package's push on
    one device, for the additive fold and the sum-and-count scatter of the
    other folds. The mean's scaling rounds once more on either side (see
    test_push_matches_jax); the rest is the order of float32 sums."""
    table, ids, deltas = _inputs(50, 6, 400, seed=9)
    want = _on_one_device(
        lambda t, i, d: jstore.push(t, i, d, num_shards=1, data_axis=None,
                                    apply_fn=apply_fn, combine=combine,
                                    hot_rows=hot),
        table, ids, deltas)
    t, i, d = _t(table, ids, deltas)
    got = tstore.push(t, i, d, num_shards=1, apply_fn=apply_fn,
                      combine=combine, hot_rows=hot).numpy()
    eps = np.finfo(np.float32).eps
    bound = (_bound(table, ids, deltas)
             + 4 * eps * (np.abs(table) + np.abs(want - table)))
    assert np.all(np.abs(got - want) <= bound)
    if combine == "sum" and apply_fn is None:
        # The tail rows take K2's plain version: the JAX push's bits.
        np.testing.assert_array_equal(got[hot:], want[hot:])


def test_ported_defaults_construct():
    tstore.TableSpec("t", 4, 2, dense_collectives=False)
    tstore.TableSpec("t", 4, 2, dense_collectives=True)
    with pytest.raises(ValueError, match="dense_collectives"):
        tstore.TableSpec("t", 4, 2, dense_collectives="yes")
    assert tstore.TableSpec("t", 4, 1, hot_ids=2).hot_ids == 2
    with pytest.raises(ValueError, match="hot_ids"):
        tstore.TableSpec("t", 4, 1, hot_ids=-1)
    TrainerConfig(sync_every=4, donate=False, max_steps_per_call=8)
    ServerLogic(combine="mean")


def test_make_ps_mesh_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tmesh.make_ps_mesh()


@pytest.mark.parametrize("num_shards,num_data", [(2, 1), (1, 2), (4, 2)])
def test_make_ps_mesh_one_device_only(num_shards, num_data):
    """``device=`` puts every position of the mesh on that one device."""
    mesh = tmesh.make_ps_mesh(num_shards, num_data, device="cpu")
    assert dict(mesh.shape) == {tmesh.DATA_AXIS: num_data,
                                tmesh.SHARD_AXIS: num_shards}
    assert len(mesh.devices) == num_data
    assert {len(row) for row in mesh.devices} == {num_shards}
    assert set(mesh.positions) == {torch.device("cpu")}
    assert tmesh.num_workers_of(mesh) == num_shards * num_data


def test_make_ps_mesh_cpu_and_default_shape():
    mesh = tmesh.make_ps_mesh(device="cpu")
    assert mesh.device == torch.device("cpu")
    assert dict(mesh.shape) == {tmesh.DATA_AXIS: 1, tmesh.SHARD_AXIS: 1}
    assert tmesh.num_workers_of(mesh) == 1
    for n in range(1, 17):
        assert tmesh.default_mesh_shape(n) == jmesh.default_mesh_shape(n)


def test_pull_push_over_several_shards():
    """Two shards, two workers: each worker reads its ids' rows, and both
    workers' pushes land on the shard that owns each id."""
    table, ids, deltas = _inputs(6, 2, 8, seed=3)
    t, i, d = _t(table, ids, deltas)
    blocks = list(torch.chunk(t, 2))  # rows 0-2: even ids; 3-5: odd ids
    pulled = tstore.pull(blocks, [i[:4], i[4:]], num_shards=2)
    phys = tstore.id_to_phys(ids, 2, 3)
    keep = (ids >= 0) & (ids < 6)
    want = np.where(keep[:, None], table[np.where(keep, phys, 0)], 0)
    np.testing.assert_array_equal(torch.cat(pulled).numpy(), want)
    pushed = tstore.push(blocks, [i[:4], i[4:]], [d[:4], d[4:]],
                         num_shards=2)
    ref = table.astype(np.float64)
    np.add.at(ref, phys[keep], deltas[keep])
    np.testing.assert_allclose(torch.cat(pushed).numpy(), ref, rtol=0,
                               atol=1e-6)
    with pytest.raises(ValueError, match="blocks"):
        tstore.pull(blocks[:1] * 3, [i] * 3, num_shards=2)


@pytest.fixture
def pallas_backend():
    import fps_tpu.ops as jops

    prev = jops.get_backend()
    jops.set_backend("pallas")
    yield
    jops.set_backend(prev)


@pytest.mark.parametrize("inplace", [False, True])
def test_head_prefix_pull_push_match_jax(pallas_backend, inplace):
    """``pull`` / ``push`` with ``hot_rows`` and ``head_prefix`` on a scalar
    table against the JAX package's store on one device, whose head-prefix
    route runs the Pallas scalar kernels (interpret mode, bf16 hi+lo: 2^-16
    of each value, plus the float32 summation bound)."""
    R, H, B, q = 9_000, 1024, 6_000, 2048
    rng = np.random.default_rng(2)
    table = rng.normal(0, 1, (R, 1)).astype(np.float32)
    ids = np.concatenate([rng.integers(0, H, q),
                          rng.integers(-1, R, B - q)]).astype(np.int32)
    ids[:q:13] = -1
    deltas = rng.normal(0, 1, (B, 1)).astype(np.float32)
    want_pull = _on_one_device(
        lambda t, i: jstore.pull(t, i, num_shards=1, hot_rows=H,
                                 head_prefix=q), table, ids)
    want_push = _on_one_device(
        lambda t, i, d: jstore.push(t, i, d, num_shards=1, data_axis=None,
                                    hot_rows=H, head_prefix=q),
        table, ids, deltas)
    t, i, d = _t(table, ids, deltas)
    got_pull = tstore.pull(t, i, num_shards=1, hot_rows=H,
                           head_prefix=q).numpy()
    got_push = tstore.push(t, i, d, num_shards=1, hot_rows=H, head_prefix=q,
                           inplace=inplace).numpy()
    keep = ids >= 0
    np.testing.assert_array_equal(
        got_pull, np.where(keep[:, None], table[np.clip(ids, 0, None)], 0))
    assert np.all(np.abs(got_pull - want_pull)
                  <= (2.0**-16 + 1.2e-7) * np.abs(got_pull))
    ref = table.astype(np.float64)
    np.add.at(ref[:, 0], ids[keep], deltas[keep, 0])
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag[:, 0], ids[keep], np.abs(deltas[keep, 0]))
    count = np.bincount(ids[keep], minlength=R)[:, None] + 1.0
    bound = 2.0**-16 * mag + count * np.finfo(np.float32).eps * mag
    assert np.all(np.abs(got_push - ref) <= bound)
    assert np.all(np.abs(got_push - want_push) <= 2 * bound)
    np.testing.assert_array_equal(t.numpy(), got_push if inplace else table)


def test_packed_crossover_rows_are_the_measured_thresholds():
    """The H100 sweep's thresholds for the redesigned K3 against K2
    (chip_smoke.py phase 3): 16,384 rows through D = 10, 8,192 through 32,
    1,024 through 100, 512 through 200, and K2 (0) wider."""
    from fps_tpu_torch.ops import packed_crossover_rows

    for dim, want in ((1, 16_384), (10, 16_384), (11, 8_192), (32, 8_192),
                      (33, 1_024), (100, 1_024), (101, 512), (200, 512),
                      (201, 0)):
        assert packed_crossover_rows(dim) == want, dim


class _Pusher(WorkerLogic):
    """Pulls rows of table "t" and pushes a delta that depends on them (the
    JAX package's test_hot_ids_auto_trains_equivalently)."""

    def pull_ids(self, batch):
        return {"t": batch["id"].to(torch.int32)}

    def step(self, batch, pulled, local_state, gen):
        ids = torch.where(batch["weight"] > 0,
                          batch["id"].to(torch.int32), -1)
        deltas = 0.5 * batch["val"][:, None] - 0.1 * pulled["t"]
        return StepOutput(pushes={"t": (ids, deltas)},
                          local_state=local_state, out={})


def _pusher_trainer(spec):
    from fps_tpu_torch.core.driver import Trainer

    mesh = tmesh.make_ps_mesh(device="cpu")
    store = tstore.ParamStore(mesh, [spec])
    return Trainer(mesh, store, _Pusher(),
                   server_logic=ServerLogic(combine="mean"),
                   config=TrainerConfig(donate=False))


def test_hot_ids_auto_resolution():
    """``hot_ids="auto"`` on one shard: the whole table through K3 when it
    has at most ``packed_crossover_rows(dim)`` rows, K2 (0) above; an int is
    the head itself; any other string raises in the trainer (the JAX
    package's tests/test_ops.py, on one shard)."""
    from fps_tpu_torch.ops import packed_crossover_rows

    cut = packed_crossover_rows(10)
    specs = {"thin": tstore.TableSpec("thin", cut, 10, hot_ids="auto"),
             "fat": tstore.TableSpec("fat", cut + 1, 10, hot_ids="auto"),
             "head": tstore.TableSpec("head", 8 * 65536, 10, hot_ids=4096),
             "wide": tstore.TableSpec("wide", 100, 300, hot_ids="auto"),
             "bad": tstore.TableSpec("bad", 100, 4, hot_ids="Auto")}
    tr = _pusher_trainer(specs["thin"])
    tr.store.specs.update(specs)
    assert tr._hot_rows("thin") == cut
    assert tr._hot_rows("fat") == 0
    assert tr._hot_rows("head") == 4096
    assert tr._hot_rows("wide") == 0
    with pytest.raises(ValueError, match="hot_ids"):
        tr._hot_rows("bad")


def test_hot_ids_auto_trains_equivalently():
    """End to end: ``hot_ids="auto"`` on a thin table takes the whole-table
    route (K3's plain version on the CPU) and trains the table the plain
    route trains, to the order of float32 sums; the route is asserted to
    fire."""
    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.ops import kernels

    R, D, n = 512, 4, 1024
    rng = np.random.default_rng(9)
    data = {"id": rng.integers(0, R, n).astype(np.int32),
            "val": rng.normal(0, 1, n).astype(np.float32)}
    chunks = list(epoch_chunks(data, num_workers=1, local_batch=32,
                               steps_per_chunk=2, seed=1))

    def run(hot):
        tr = _pusher_trainer(tstore.TableSpec("t", R, D,
                                              hot_ids=hot).zeros_init())
        t, ls = tr.init_state(0)
        for i, c in enumerate(chunks):
            t, ls, _ = tr.run_chunk(t, ls, c, i)
        return tr, tr.store.dump_model("t")[1]

    tr, got = run("auto")
    assert tr._hot_rows("t") == R
    calls = []
    real = kernels.scatter_add_packed_plain
    try:
        kernels.scatter_add_packed_plain = (
            lambda *a: calls.append(a[3]) or real(*a))
        tr.run_chunk(tr.store.tables, (), chunks[0], 0)
    finally:
        kernels.scatter_add_packed_plain = real
    assert calls and set(calls) == {R}
    _, want = run(0)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
