"""The port's sketches (``fps_tpu_torch.sketch``) against the JAX package's
``fps_tpu.sketch``, on the CPU.

The hashes are uint32 multiply-shift arithmetic in the JAX package and int64
arithmetic masked to 32 bits in the port: buckets and signs must be equal
bit for bit over negative, zero and near-2^31 ids. The updates of unit
values and 0/1 weights are sums of ±1, exact in float32 in any order, so
every update, query and merge must be equal bit for bit too; float values
are checked the same way (both packages fold an item at a time, in batch
order, on the CPU). The float updates go through the port's scatter-add of
an ``(N, 1)`` table (kernel K4's plain version here).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fps_tpu.sketch as jsk
import fps_tpu_torch.sketch as tsk
from fps_tpu_torch.ops import kernels

EDGE_IDS = np.array([-2**31, -2**31 + 1, -123456789, -5, -1, 0, 1, 2, 7,
                     65535, 65536, 123456789, 2**31 - 2, 2**31 - 1],
                    np.int32)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _ids(seed, n=3000, lo=-3, hi=700):
    rng = np.random.default_rng(seed)
    ids = rng.integers(lo, hi, n).astype(np.int32)
    ids[:len(EDGE_IDS)] = EDGE_IDS
    return ids


def _eq(got, want):
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("seed,depth,width", [
    (0, 4, 1024), (3, 5, 1000), (9, 2, 7), (17, 4, 8192), (123, 1, 1 << 20)])
def test_bucket_and_sign_bit_equal_to_jax(seed, depth, width):
    ids = np.concatenate([EDGE_IDS, _ids(seed, 2000, -2**31, 2**31 - 1)])
    a, b = jsk._hash_constants(seed, depth)
    ta, tb = tsk._constants_on(seed, depth, torch.device("cpu"))
    np.testing.assert_array_equal(ta.numpy(), a.astype(np.int64))
    t = torch.from_numpy(ids)
    _eq(tsk._bucket(t, ta, tb, width),
        jsk._bucket(jnp.asarray(ids), jnp.asarray(a), jnp.asarray(b), width))
    _eq(tsk._sign(t, ta, tb),
        jsk._sign(jnp.asarray(ids), jnp.asarray(a), jnp.asarray(b)))


def test_mul32_is_the_low_32_bits_of_the_product():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    c = rng.integers(0, 2**32, 5000, dtype=np.uint64)
    want = (x * c) & np.uint64(0xFFFFFFFF)  # uint64 wraps mod 2^64
    got = tsk._mul32(torch.from_numpy(x.astype(np.int64)),
                     torch.from_numpy(c.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("values", [False, True])
def test_count_min_update_query_merge_equal_jax(values):
    spec, jspec = tsk.CountMinSpec(4, 256, 1), jsk.CountMinSpec(4, 256, 1)
    ids1, ids2 = _ids(1), _ids(2)
    v = (np.random.default_rng(3).normal(size=ids1.shape).astype(np.float32)
         if values else None)
    t1 = tsk.cm_update(spec, tsk.cm_init(spec), torch.from_numpy(ids1),
                       None if v is None else torch.from_numpy(v))
    j1 = jsk.cm_update(jspec, jsk.cm_init(jspec), jnp.asarray(ids1),
                       None if v is None else jnp.asarray(v))
    _eq(t1, j1)
    t2 = tsk.cm_update(spec, tsk.cm_init(spec), torch.from_numpy(ids2))
    j2 = jsk.cm_update(jspec, jsk.cm_init(jspec), jnp.asarray(ids2))
    _eq(tsk.merge(t1, t2), jsk.merge(j1, j2))
    q = torch.from_numpy(ids2)
    _eq(tsk.cm_query(spec, tsk.merge(t1, t2), q),
        jsk.cm_query(jspec, jsk.merge(j1, j2), jnp.asarray(ids2)))
    if not values:
        # Count-min never underestimates a live id's count.
        live = ids2[ids2 >= 0]
        est = tsk.cm_query(spec, t2, torch.from_numpy(live)).numpy()
        true = np.array([np.sum(ids2 == i) for i in live])
        assert np.all(est >= true)


def test_decayed_count_min_equal_jax():
    spec = tsk.DecayedCountMinSpec(4, 128, 2, half_every=3)
    jspec = jsk.DecayedCountMinSpec(4, 128, 2, half_every=3)
    state, jstate = tsk.dcm_init(spec), jsk.dcm_init(jspec)
    tstate = torch.from_numpy(tsk.dcm_init(spec))
    for tick in range(8):
        ids = _ids(tick, 500)
        win = tsk.cm_update(spec.cm(), tsk.cm_init(spec.cm()),
                            torch.from_numpy(ids))
        jwin = jsk.cm_update(jspec.cm(), jsk.cm_init(jspec.cm()),
                             jnp.asarray(ids))
        _eq(win, jwin)
        state = tsk.dcm_fold(spec, state, win.numpy(), tick)
        jstate = jsk.dcm_fold(jspec, jstate, np.asarray(jwin), tick)
        tstate = tsk.dcm_fold_traced(spec, tstate, win, torch.tensor(tick))
        np.testing.assert_array_equal(state, jstate)
        np.testing.assert_array_equal(tstate.numpy(), state)
    q = _ids(99, 200)
    _eq(tsk.dcm_query(spec, state, torch.from_numpy(q)),
        jsk.dcm_query(jspec, jstate, jnp.asarray(q)))
    with pytest.raises(ValueError, match="half_every"):
        tsk.DecayedCountMinSpec(half_every=0)
    with pytest.raises(ValueError, match="tick"):
        tsk.dcm_fold(spec, state, state, -1)


@pytest.mark.parametrize("depth", [5, 4])
def test_tug_of_war_update_query_inner_equal_jax(depth):
    """Odd and even depth: the median of an even count is the mean of the
    two middle rows, as ``jnp.median`` takes it."""
    spec = tsk.TugOfWarSpec(depth, 128, 2)
    jspec = jsk.TugOfWarSpec(depth, 128, 2)
    ids1, ids2 = _ids(4), _ids(5)
    t1 = tsk.tow_update(spec, tsk.tow_init(spec), torch.from_numpy(ids1))
    j1 = jsk.tow_update(jspec, jsk.tow_init(jspec), jnp.asarray(ids1))
    _eq(t1, j1)
    t2 = tsk.tow_update(spec, tsk.tow_init(spec), torch.from_numpy(ids2))
    j2 = jsk.tow_update(jspec, jsk.tow_init(jspec), jnp.asarray(ids2))
    _eq(tsk.merge(t1, t2), jsk.merge(j1, j2))
    _eq(tsk.tow_query(spec, t1, torch.from_numpy(ids2)),
        jsk.tow_query(jspec, j1, jnp.asarray(ids2)))
    assert float(tsk.tow_inner(t1, t2)) == float(jsk.tow_inner(j1, j2))


@pytest.mark.parametrize("weights", ["unit", "zero_one", "float"])
def test_tow_update_rows_equal_jax(weights):
    spec, jspec = tsk.TugOfWarSpec(5, 64, 3), jsk.TugOfWarSpec(5, 64, 3)
    rng = np.random.default_rng(6)
    ids = _ids(7)
    rows = rng.integers(-1, 6, ids.shape).astype(np.int32)
    v = {"unit": None,
         "zero_one": rng.integers(0, 2, ids.shape).astype(np.float32),
         "float": rng.normal(size=ids.shape).astype(np.float32)}[weights]
    stack = torch.zeros((6, 5, 64))
    got = tsk.tow_update_rows(spec, stack, torch.from_numpy(rows),
                              torch.from_numpy(ids),
                              None if v is None else torch.from_numpy(v))
    want = jsk.tow_update_rows(jspec, jnp.zeros((6, 5, 64)),
                               jnp.asarray(rows), jnp.asarray(ids),
                               None if v is None else jnp.asarray(v))
    _eq(got, want)
    assert not stack.any()  # functional: the input stack is unchanged


def test_bloom_add_contains_merge_equal_jax():
    spec, jspec = tsk.BloomSpec(3, 500, 4), jsk.BloomSpec(3, 500, 4)
    a, b = _ids(8, 60), _ids(9, 60)
    ta = tsk.bloom_add(spec, tsk.bloom_init(spec), torch.from_numpy(a))
    ja = jsk.bloom_add(jspec, jsk.bloom_init(jspec), jnp.asarray(a))
    _eq(ta, ja)
    assert ta.dtype == torch.uint8
    tb = tsk.bloom_add(spec, tsk.bloom_init(spec), torch.from_numpy(b))
    jb = jsk.bloom_add(jspec, jsk.bloom_init(jspec), jnp.asarray(b))
    _eq(tsk.merge(ta, tb), jsk.merge(ja, jb))
    q = _ids(10, 400)
    _eq(tsk.bloom_contains(spec, tsk.merge(ta, tb), torch.from_numpy(q)),
        jsk.bloom_contains(jspec, jsk.merge(ja, jb), jnp.asarray(q)))
    # No false negatives for live ids.
    live = np.concatenate([a[a >= 0], b[b >= 0]])
    assert tsk.bloom_contains(spec, tsk.merge(ta, tb),
                              torch.from_numpy(live)).all()


def test_float_updates_take_the_scalar_scatter_add(monkeypatch):
    """cm_update, tow_update and tow_update_rows each make one scatter-add
    of an ``(N, 1)`` table: K4's plain version on a CPU tensor (K4 on the
    card)."""
    calls = []
    plain = kernels.scatter_add_dim1_plain

    def counted(table, ids, deltas):
        calls.append((tuple(table.shape), ids.dtype, tuple(deltas.shape)))
        return plain(table, ids, deltas)

    monkeypatch.setattr(kernels, "scatter_add_dim1_plain", counted)
    ids = torch.from_numpy(_ids(11, 100))
    cm, tow = tsk.CountMinSpec(4, 32), tsk.TugOfWarSpec(5, 16)
    tsk.cm_update(cm, tsk.cm_init(cm), ids)
    tsk.tow_update(tow, tsk.tow_init(tow), ids)
    tsk.tow_update_rows(tow, torch.zeros((3, 5, 16)),
                        torch.zeros(100, dtype=torch.int32), ids)
    assert calls == [((128, 1), torch.int32, (400, 1)),
                     ((80, 1), torch.int32, (500, 1)),
                     ((240, 1), torch.int32, (500, 1))]
