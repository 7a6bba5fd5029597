"""The PyTorch port's iALS against the JAX package's, on the CPU.

Both solvers start from the same factor tables (the JAX package's, carried
across with ``fps_tpu_torch.convert``) and take the same numpy interaction
chunks made from a seed: JAX ``IALSSolver`` on a (data=1, shard=1) mesh,
the port on ``device="cpu"`` (the kernels' plain versions). Held to both:
the ``A`` and ``b`` accumulators of one accumulate pass, and the solved
factors of one half-epoch, one epoch and two, and the dense float64 oracle
of ``tests/test_ials.py``. Also here: the host metrics on the same factors,
device-resident chunks, ``prefetch`` and the example CLI; and the sharded
store, each solver on a mesh of the same shape (the JAX package's on the
test process's virtual CPU devices): half-epochs at 4 and 8 shards against
the JAX package and the dense oracle, the Gramian's sum over the shards,
``(2, 4)`` against ``(1, 8)`` (the JAX package's
``test_full_mesh_matches_shard_only_mesh``) with bit-equal data replicas,
``prefetch`` and device-resident chunks on the mesh, the example on four
shards.

Tolerances, stated: the accumulators are float32 sums of the same terms in
another order, so each lies within ``(k + 3) * eps32 * sum|terms|`` of the
float64 sum (``k`` the row's interactions; three more roundings for the
table value and the two multiplies of a term). The factors are solves of
the same float32 systems: within 1e-4 of the largest |value| of each other
(measured: about 3e-6 after two epochs).
"""

import contextlib
import io
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.models import ials as jials
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch.convert import tables_from_jax
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.models import ials as tials
from fps_tpu_torch.parallel.mesh import make_ps_mesh
from fps_tpu_torch.utils import datasets as tdatasets

EPS32 = float(np.finfo(np.float32).eps)
NU, NI, RANK = 37, 29, 5
CFG = dict(alpha=5.0, reg=0.3)


def _pair(nu=NU, ni=NI, rank=RANK, **kw):
    """A JAX solver and a port solver from the same tables."""
    kw = {**CFG, **kw}
    mesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    js = jials.IALSSolver(mesh, jials.IALSConfig(nu, ni, rank=rank, **kw))
    js.init(jax.random.key(0))
    ts = tials.IALSSolver(make_ps_mesh(device="cpu"),
                          tials.IALSConfig(nu, ni, rank=rank, **kw))
    ts.store.tables = tables_from_jax(
        ts.store, {n: np.asarray(v) for n, v in js.store.tables.items()})
    return js, ts


def _data(nu=NU, ni=NI, per_user=9, seed=1):
    return jdatasets.synthetic_implicit(nu, ni, per_user, rank=3, seed=seed)


def _chunks(data, seed=0, local_batch=16, steps=3):
    return list(jials.interaction_chunks(
        data, num_workers=1, local_batch=local_batch, steps_per_chunk=steps,
        seed=seed))


def _close(got, want):
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= 1e-4 * scale, (
        float(np.abs(got - want).max()), scale)


def _dense_half_epoch(U, V, users, items, ratings, alpha, reg, num_solve):
    """The float64 oracle of ``tests/test_ials.py`` for one half-step solving
    the ``U`` side, with its accumulators and their magnitudes."""
    k = V.shape[1]
    G = V.T @ V
    A = np.zeros((num_solve, k, k))
    b = np.zeros((num_solve, k))
    magA = np.zeros((num_solve, k, k))
    magb = np.zeros((num_solve, k))
    count = np.zeros(num_solve)
    for u, i, r in zip(users, items, ratings):
        y = V[i]
        A[u] += alpha * r * np.outer(y, y)
        b[u] += (1.0 + alpha * r) * y
        magA[u] += np.abs(alpha * r * np.outer(y, y))
        magb[u] += np.abs((1.0 + alpha * r) * y)
        count[u] += 1
    out = np.zeros((num_solve, k))
    for u in range(num_solve):
        out[u] = np.linalg.solve(G + A[u] + reg * np.eye(k), b[u])
    return out, A.reshape(num_solve, -1), b, magA.reshape(num_solve, -1), \
        magb, count


@pytest.mark.parametrize("solve", ["user", "item"])
def test_accumulate_and_half_epoch_match_jax_and_dense_oracle(solve):
    js, ts = _pair()
    data = _data()
    chunks = _chunks(data)
    U0, V0 = (x.astype(np.float64) for x in js.factors())
    if solve == "user":
        fixed, solve_col, fixed_col, n = tials.ITEM_TABLE, "user", "item", NU
        want, A64, b64, magA, magb, cnt = _dense_half_epoch(
            U0, V0, data["user"], data["item"], data["rating"],
            CFG["alpha"], CFG["reg"], NU)
    else:
        fixed, solve_col, fixed_col, n = tials.USER_TABLE, "item", "user", NI
        want, A64, b64, magA, magb, cnt = _dense_half_epoch(
            V0, U0, data["item"], data["user"], data["rating"],
            CFG["alpha"], CFG["reg"], NI)

    # The accumulate pass alone: A and b, JAX against the port.
    acc = js._accumulate_fn()
    jA = jnp.zeros((n, RANK * RANK), jnp.float32)
    jb = jnp.zeros((n, RANK), jnp.float32)
    tA = torch.zeros((n, RANK * RANK))
    tb = torch.zeros((n, RANK))
    for c in chunks:
        cols = {"solve_ids": c[solve_col], "fixed_ids": c[fixed_col],
                "rating": c["rating"], "weight": c["weight"]}
        jA, jb = acc(js.store.tables[fixed], jA, jb,
                     {k: jnp.asarray(v) for k, v in cols.items()})
        ts._accumulate(list(ts.store.tables[fixed]), [tA], [tb],
                       [{k: torch.as_tensor(v) for k, v in cols.items()}])
    for got, jgot, exact, mag in ((tA, jA, A64, magA), (tb, jb, b64, magb)):
        tol = (cnt + 3)[:, None] * EPS32 * mag
        for name, val in (("port", got.numpy()), ("jax", np.asarray(jgot))):
            excess = float((np.abs(val - exact) - tol).max())
            assert excess <= 0, (name, excess)

    # The whole half-epoch: the solved factors.
    js.half_epoch(solve, chunks)
    ts.half_epoch(solve, chunks)
    side = 0 if solve == "user" else 1
    got, jgot = ts.factors()[side], js.factors()[side]
    _close(got, jgot)
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


@pytest.mark.parametrize("epochs", [1, 2])
def test_epochs_match_jax_and_dense_oracle(epochs):
    js, ts = _pair()
    data = _data(seed=2)
    U, V = (x.astype(np.float64) for x in js.factors())
    for e in range(epochs):
        chunks = _chunks(data, seed=e)
        js.epoch(lambda: iter(chunks))
        ts.epoch(lambda: iter(chunks))
        for got, want in zip(ts.factors(), js.factors()):
            _close(got, want)
        # The dense float64 epoch: the user half, then the item half on
        # the new user factors.
        U = _dense_half_epoch(U, V, data["user"], data["item"],
                              data["rating"], CFG["alpha"], CFG["reg"],
                              NU)[0]
        V = _dense_half_epoch(V, U, data["item"], data["user"],
                              data["rating"], CFG["alpha"], CFG["reg"],
                              NI)[0]
        for got, want in zip(ts.factors(), (U, V)):
            np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)


def test_device_resident_chunks_match_jax_on_the_same_chunks():
    """``half_epoch`` takes the port's device-resident chunks as they are;
    the JAX solver gets the same chunks as numpy arrays."""
    from fps_tpu_torch.core.device_ingest import (
        DeviceDataset,
        device_epoch_chunks,
    )

    js, ts = _pair()
    data = _data(seed=3)
    ds = DeviceDataset(ts.mesh, data)
    chunks = list(device_epoch_chunks(ds, num_workers=1, local_batch=16,
                                      steps_per_chunk=3, seed=4))
    assert all(isinstance(v, torch.Tensor) for c in chunks
               for v in c.values())
    host = [{k: v.numpy() for k, v in c.items()} for c in chunks]
    ts.epoch(lambda: iter(chunks))
    js.epoch(lambda: iter(host))
    for got, want in zip(ts.factors(), js.factors()):
        _close(got, want)


def test_weighted_loss_and_recall_equal_on_the_same_factors():
    js, ts = _pair(nu=40, ni=60, rank=6)
    data = _data(nu=40, ni=60, per_user=20, seed=4)
    train, test = jdatasets.train_test_split(data, test_frac=0.2, seed=1)
    chunks = _chunks(train, local_batch=32)
    js.epoch(lambda: iter(chunks))
    # Both on exactly the JAX solver's factors.
    ts.store.tables = tables_from_jax(
        ts.store, {n: np.asarray(v) for n, v in js.store.tables.items()})
    for kw in ({}, {"sample_unobserved": 500, "seed": 3}):
        assert ts.weighted_loss(train["user"], train["item"],
                                train["rating"], **kw) == js.weighted_loss(
            train["user"], train["item"], train["rating"], **kw)
    for k, exclude in ((5, None), (10, (train["user"], train["item"]))):
        assert tials.recall_at_k(ts, test["user"], test["item"], k=k,
                                 exclude=exclude) == jials.recall_at_k(
            js, test["user"], test["item"], k=k, exclude=exclude)


def test_recall_beats_random_and_objective_decreases():
    """The port on its own (``tests/test_ials.py``'s gates): ALS takes a big
    first drop of the observed objective and ranks held-out items far above
    chance."""
    nu, ni = 40, 60
    data = tdatasets.synthetic_implicit(nu, ni, 20, rank=3, seed=4)
    train, test = tdatasets.train_test_split(data, test_frac=0.2, seed=1)
    solver = tials.IALSSolver(make_ps_mesh(device="cpu"),
                              tials.IALSConfig(nu, ni, rank=6, alpha=10.0,
                                               reg=0.5))
    solver.init(0)
    losses = [solver.weighted_loss(train["user"], train["item"],
                                   train["rating"])]
    for _ in range(4):
        solver.epoch(lambda: tials.interaction_chunks(
            train, num_workers=1, local_batch=32, steps_per_chunk=2, seed=0))
        losses.append(solver.weighted_loss(train["user"], train["item"],
                                           train["rating"]))
    assert losses[1] < 0.5 * losses[0], losses
    assert losses[-1] <= losses[1] * 1.05, losses
    recall = tials.recall_at_k(solver, test["user"], test["item"], k=10,
                               exclude=(train["user"], train["item"]))
    assert recall > 3 * 10 / ni, recall


def test_init_is_per_id_and_in_range():
    solver = tials.IALSSolver(make_ps_mesh(device="cpu"),
                              tials.IALSConfig(50, 30, rank=4,
                                               init_scale=0.05))
    tables = solver.init(7)
    for name, n in ((tials.USER_TABLE, 50), (tials.ITEM_TABLE, 30)):
        (t,) = tables[name]  # the one position's block
        assert t.shape == (n, 4) and t.dtype == torch.float32
        assert float(t.abs().max()) < 0.05
    again = tials.IALSSolver(make_ps_mesh(device="cpu"),
                             tials.IALSConfig(50, 30, rank=4,
                                              init_scale=0.05)).init(7)
    for name in tables:
        assert torch.equal(tables[name][0], again[name][0])


def test_interaction_chunks_and_data_equal_jax():
    data = tdatasets.synthetic_implicit(30, 20, 7, rank=2, seed=5)
    jdata = jdatasets.synthetic_implicit(30, 20, 7, rank=2, seed=5)
    for k in data:
        np.testing.assert_array_equal(data[k], jdata[k])
    got = list(tials.interaction_chunks(data, num_workers=1, local_batch=8,
                                        steps_per_chunk=4, seed=3))
    want = list(jials.interaction_chunks(jdata, num_workers=1, local_batch=8,
                                         steps_per_chunk=4, seed=3))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_prefetch_is_bit_identical_and_solve_checks_its_side():
    """``prefetch = 2`` runs the placement on the pipeline's worker thread:
    the same chunks accumulate in the same order, so two epochs give the
    factors of ``prefetch = 0`` bit for bit, and the JAX package's with
    ``prefetch = 2`` within its bound. A negative depth raises."""
    data = _data()
    chunks = _chunks(data)
    factors = {}
    for depth in (0, 2):
        js, ts = _pair()
        ts.prefetch = js.prefetch = depth
        for _ in range(2):
            ts.epoch(lambda: iter(chunks))
            js.epoch(lambda: iter(chunks))
        factors[depth] = ts.factors()
        for got, want in zip(ts.factors(), js.factors()):
            _close(got, want)
    for got, want in zip(factors[2], factors[0]):
        np.testing.assert_array_equal(got, want)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("fps-prefetch")]
    solver = tials.IALSSolver(make_ps_mesh(device="cpu"),
                              tials.IALSConfig(5, 4, rank=2))
    solver.init(0)
    solver.prefetch = -1
    with pytest.raises(ValueError, match="prefetch"):
        solver.half_epoch("user", [])
    solver.prefetch = 0
    with pytest.raises(ValueError, match="solve"):
        solver.half_epoch("both", [])


@pytest.mark.parametrize("ingest", ["device", "host"])
def test_example_cli(ingest):
    from fps_tpu_torch.examples import ials

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ials.main(["--device", "cpu", "--num-users", "300",
                        "--num-items", "200", "--per-user", "20",
                        "--rank", "8", "--local-batch", "512",
                        "--steps-per-chunk", "4", "--epochs", "3",
                        "--ingest", ingest])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["device"] == "cpu"
    losses = [e["weighted_loss"] for e in events if e["event"] == "epoch"]
    assert len(losses) == 3 and losses[-1] < losses[0]
    done = events[-1]
    assert done["event"] == "done"
    # Chance is 10 / 200 = 0.05.
    assert done["recall_at_10"] > 0.15, done


# ---------------------------------------------------------------------------
# The sharded store: the JAX package's mesh of the same shape.
# ---------------------------------------------------------------------------

def _mesh_pair(D, S, nu=NU, ni=NI, rank=RANK, **kw):
    """A JAX solver and a port solver on ``(D, S)`` meshes (the JAX one on
    the test process's virtual CPU devices), from the same tables."""
    kw = {**CFG, **kw}
    mesh = jmake_ps_mesh(num_shards=S, num_data=D,
                         devices=jax.devices()[:D * S])
    js = jials.IALSSolver(mesh, jials.IALSConfig(nu, ni, rank=rank, **kw))
    js.init(jax.random.key(0))
    ts = tials.IALSSolver(make_ps_mesh(S, D, device="cpu"),
                          tials.IALSConfig(nu, ni, rank=rank, **kw))
    ts.store.tables = tables_from_jax(
        ts.store, {n: np.asarray(v) for n, v in js.store.tables.items()})
    return js, ts


def _replicas_equal(solver):
    D, S = solver.num_data, solver.num_shards
    for blocks in solver.store.tables.values():
        for p in range(S, D * S):
            assert torch.equal(blocks[p], blocks[p % S])


@pytest.mark.parametrize("solve", ["user", "item"])
@pytest.mark.parametrize("S", [4, 8])
def test_half_epoch_on_shards_matches_jax_and_dense_oracle(S, solve):
    """A half-epoch at ``(1, S)``: each shard's Gramian summed over the
    shards, the chunk cut over the workers, each shard's solve of its own
    block. 37 users and 29 items leave padding rows at 4 and 8 shards; the
    padding rows of the solved blocks are zero."""
    js, ts = _mesh_pair(1, S)
    data = _data(seed=S)
    chunks = list(jials.interaction_chunks(
        data, num_workers=S, local_batch=4, steps_per_chunk=3, seed=1))
    U0, V0 = (x.astype(np.float64) for x in js.factors())
    if solve == "user":
        want = _dense_half_epoch(U0, V0, data["user"], data["item"],
                                 data["rating"], CFG["alpha"], CFG["reg"],
                                 NU)[0]
    else:
        want = _dense_half_epoch(V0, U0, data["item"], data["user"],
                                 data["rating"], CFG["alpha"], CFG["reg"],
                                 NI)[0]
    js.half_epoch(solve, chunks)
    ts.half_epoch(solve, chunks)
    side = 0 if solve == "user" else 1
    got = ts.factors()[side]
    _close(got, js.factors()[side])
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-4)
    name = tials.USER_TABLE if solve == "user" else tials.ITEM_TABLE
    blocks = ts.store.tables[name]
    assert len(blocks) == S and blocks[0].shape == (-(-want.shape[0] // S),
                                                    RANK)
    full = blocks.numpy()
    np.testing.assert_array_equal(full[np.asarray(
        tstore.phys_to_id(np.arange(len(full)), S, blocks[0].shape[0]))
        >= want.shape[0]], 0)


def test_gramian_is_the_shards_own_summed_in_shard_order():
    """Every position holds the Gramian of the whole table's valid rows,
    each the fold of the shards' own in shard order (the same bits on every
    position), within float32 rounding of the one-block Gramian."""
    _, ts = _mesh_pair(2, 4)
    blocks = list(ts.store.tables[tials.ITEM_TABLE])
    grams = ts._gram(blocks, NI)
    assert len(grams) == 8
    for g in grams[1:]:
        assert torch.equal(g, grams[0])
    full = ts.store.tables[tials.ITEM_TABLE].numpy()
    rows = full[np.asarray(tstore.phys_to_id(np.arange(len(full)), 4,
                                             blocks[0].shape[0])) < NI]
    np.testing.assert_allclose(grams[0].numpy(), rows.T @ rows, rtol=1e-5,
                               atol=1e-9)


def test_full_mesh_matches_shard_only_mesh_and_jax():
    """``tests/test_ials.py``'s ``test_full_mesh_matches_shard_only_mesh`` on
    the port: two epochs at ``(2, 4)`` (the stream over every worker, the
    pushes gathered over the data axis too) solve the factors of ``(1, 8)``
    within its tolerance, each within 1e-4 of the JAX package's at its own
    shape, and the data replicas stay bit-equal."""
    nu, ni, rank = 24, 18, 4
    data = jdatasets.synthetic_implicit(nu, ni, 9, rank=2, seed=6)
    out = {}
    for D, S in ((1, 8), (2, 4)):
        js, ts = _mesh_pair(D, S, nu, ni, rank)
        assert ts.num_workers == 8
        chunks = list(jials.interaction_chunks(
            data, num_workers=8, local_batch=4, steps_per_chunk=2, seed=0))
        for _ in range(2):
            js.epoch(lambda: iter(chunks))
            ts.epoch(lambda: iter(chunks))
        for got, want in zip(ts.factors(), js.factors()):
            _close(got, want)
        _replicas_equal(ts)
        out[D, S] = ts.factors()
    for a, b in zip(out[1, 8], out[2, 4]):
        np.testing.assert_allclose(a, b, rtol=5e-4, atol=5e-5)


def test_prefetch_on_the_mesh_is_bit_identical():
    """``prefetch = 2`` at ``(2, 4)``: the chunks are placed on the pipeline's
    thread and cut over the workers on the driver's; two epochs give the
    factors of ``prefetch = 0`` bit for bit, and the JAX package's with
    ``prefetch = 2`` within 1e-4."""
    data = _data(seed=5)
    chunks = list(jials.interaction_chunks(
        data, num_workers=8, local_batch=4, steps_per_chunk=3, seed=2))
    factors = {}
    for depth in (0, 2):
        js, ts = _mesh_pair(2, 4)
        ts.prefetch = js.prefetch = depth
        for _ in range(2):
            ts.epoch(lambda: iter(chunks))
            js.epoch(lambda: iter(chunks))
        factors[depth] = ts.factors()
        for got, want in zip(ts.factors(), js.factors()):
            _close(got, want)
    for got, want in zip(factors[2], factors[0]):
        np.testing.assert_array_equal(got, want)
    assert not [t for t in threading.enumerate()
                if t.name.startswith("fps-prefetch")]


def test_device_resident_chunks_on_the_mesh_match_jax():
    """``device_epoch_chunks`` on the mesh's home device, cut over 4
    workers by the solver; the JAX solver gets the same chunks in numpy."""
    from fps_tpu_torch.core.device_ingest import (
        DeviceDataset,
        device_epoch_chunks,
    )

    js, ts = _mesh_pair(1, 4)
    data = _data(seed=3)
    chunks = list(device_epoch_chunks(DeviceDataset(ts.mesh, data),
                                      num_workers=4, local_batch=4,
                                      steps_per_chunk=3, seed=4))
    host = [{k: v.numpy() for k, v in c.items()} for c in chunks]
    ts.epoch(lambda: iter(chunks))
    js.epoch(lambda: iter(host))
    for got, want in zip(ts.factors(), js.factors()):
        _close(got, want)


def test_example_cli_on_four_shards_keeps_one_data_replica():
    """``--num-shards 4 --num-data 2``: the example keeps ``num_data = 1``,
    as the JAX package's does, and learns as on one position."""
    from fps_tpu_torch.examples import ials

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = ials.main(["--device", "cpu", "--num-shards", "4",
                        "--num-data", "2", "--num-users", "300",
                        "--num-items", "200", "--per-user", "20",
                        "--rank", "8", "--local-batch", "128",
                        "--steps-per-chunk", "4", "--epochs", "3"])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["mesh"] == {"data": 1, "shard": 4}
    losses = [e["weighted_loss"] for e in events if e["event"] == "epoch"]
    assert losses[-1] < losses[0]
    assert events[-1]["recall_at_10"] > 0.15, events[-1]
