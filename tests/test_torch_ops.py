"""The PyTorch port's gather and scatter-add against the JAX package's.

On the CPU the port runs each kernel's plain PyTorch version; these tests
hold it, and the port's ``ops`` dispatch, against the JAX package's Pallas
kernels (``gather_rows_pallas`` / ``scatter_add_pallas``, the scalar-table
``gather_rows_dim1_pallas`` / ``scatter_add_dim1_pallas`` and the head's
``scatter_add_packed_pallas``, in interpret mode, as tests/test_ops.py runs
them) and against ``fps_tpu.ops`` on its XLA path, including the scalar
tables' head-prefix route and the hot/cold split. Inputs are made with numpy
from a seed and mix duplicates, ``-1`` and ``>= R`` ids. The CUDA kernels
themselves run on the card (chip_smoke.py, tests/test_torch_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import fps_tpu.ops as jops
from fps_tpu.ops.pallas_kernels import (
    gather_rows_dim1_pallas,
    gather_rows_pallas,
    scatter_add_dim1_pallas,
    scatter_add_packed_pallas,
    scatter_add_pallas,
)

import fps_tpu_torch.ops as tops
from fps_tpu_torch.ops import kernels

CASES = [(64, 8, 100), (57, 5, 40), (130, 3, 513), (300, 10, 2000),
         (300, 11, 2000)]


def _inputs(R, D, B, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    ids = (rng.zipf(1.5, B) % R).astype(np.int32)  # heavy duplication
    ids[::7] = -1
    ids[3::11] = R
    ids[5::13] = R + 5
    deltas = rng.normal(0, 1, (B, D)).astype(np.float32)
    return table, ids, deltas


def _sum_bound(table, ids, deltas):
    """Per-element bound on the distance between two float32 sums of the
    same terms in different orders: each lies within k * eps32 * (sum of
    the terms' magnitudes) of the exact sum, k = the row's pushes + 1."""
    R = table.shape[0]
    keep = (ids >= 0) & (ids < R)
    mag = np.abs(table).astype(np.float64)
    np.add.at(mag, ids[keep], np.abs(deltas[keep]).astype(np.float64))
    count = np.bincount(ids[keep], minlength=R)[:, None] + 1.0
    return 2 * count * np.finfo(np.float32).eps * mag


@pytest.mark.parametrize("R,D,B", CASES)
def test_gather_matches_jax_exactly(R, D, B):
    table, ids, _ = _inputs(R, D, B, seed=R)
    want_xla = np.asarray(jops.gather_rows(jnp.asarray(table),
                                           jnp.asarray(ids)))
    want_pallas = np.asarray(gather_rows_pallas(
        jnp.asarray(table), jnp.asarray(ids), interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for got in (kernels.gather_rows_plain(t, i).numpy(),
                tops.gather_rows(t, i).numpy(),
                tops.gather_rows(t, i, exact=True).numpy()):
        np.testing.assert_array_equal(got, want_xla)
        np.testing.assert_array_equal(got, want_pallas)


@pytest.mark.parametrize("R,D,B", CASES)
def test_scatter_add_matches_jax(R, D, B):
    table, ids, deltas = _inputs(R, D, B, seed=R + 1)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_xla = np.asarray(jops.scatter_add(jt, ji, jd))
    want_pallas = np.asarray(scatter_add_pallas(jt, ji, jd, interpret=True))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    outs = [kernels.scatter_add_plain(t.clone(), i, d).numpy(),
            tops.scatter_add_(t.clone(), i, d).numpy(),
            tops.scatter_add(t, i, d).numpy()]
    np.testing.assert_array_equal(t.numpy(), table)  # functional form
    bound = _sum_bound(table, ids, deltas)
    for got in outs:
        # XLA's CPU scatter and index_add_ both fold duplicates one by one
        # in batch order: the same additions, the same bits.
        np.testing.assert_array_equal(got, want_xla)
        # The Pallas kernel sums each row by a one-hot contraction, in
        # another order: equal within the float32 summation bound.
        assert np.all(np.abs(got - want_pallas) <= bound)


def test_scatter_add_into_zeros_with_count_column():
    """The mean combine's form: sums and counts in one scatter."""
    R, D, B = 40, 4, 300
    _, ids, deltas = _inputs(R, D, B, seed=9)
    keep = (ids >= 0) & (ids < R)
    withcnt = np.concatenate([deltas, keep[:, None].astype(np.float32)], 1)
    got = tops.scatter_add(torch.zeros(R, D + 1), torch.from_numpy(ids),
                           torch.from_numpy(withcnt)).numpy()
    want = np.asarray(jops.scatter_add(jnp.zeros((R, D + 1)),
                                       jnp.asarray(ids), jnp.asarray(withcnt)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:, D], np.bincount(ids[keep],
                                                         minlength=R))


def test_cpu_tensors_take_the_plain_version_and_count_nothing():
    table, ids, deltas = _inputs(50, 6, 80, seed=3)
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    kernels.reset_launch_counts()
    tops.gather_rows(t, i)
    tops.scatter_add(t, i, d)
    tops.scatter_add_(t.clone(), i, d)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("call", ["gather", "scatter"])
def test_cuda_wrappers_refuse_cpu_tensors(call):
    table, ids, deltas = _inputs(20, 3, 10, seed=4)
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    with pytest.raises(ValueError, match="CUDA tensors"):
        if call == "gather":
            kernels.gather_rows_cuda(t, i)
        else:
            kernels.scatter_add_cuda_(t, i, d)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("kw", [{"hot_rows": 4},
                                {"hot_rows": 4, "head_prefix": 8}])
def test_hot_routes_on_a_wide_table_match_jax(kw):
    """``hot_rows`` on a push into a table wider than one column is the
    hot/cold split (K3's plain version for the head, K2's for the tail),
    also with a prefix, which routes only scalar tables. It folds the same
    pushes as the JAX package's XLA route (which ignores ``hot_rows`` off a
    TPU), in another order: equal within the float32 summation bound. A read
    ignores ``hot_rows`` there, as the JAX package does."""
    rng = np.random.default_rng(4)
    table = rng.normal(0, 1, (10, 2)).astype(np.float32)
    ids = np.array([3, -1, 9, 3, 0, 10, 3, 5], np.int32)
    deltas = rng.normal(0, 1, (8, 2)).astype(np.float32)
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    np.testing.assert_array_equal(tops.gather_rows(t, i, **kw).numpy(),
                                  tops.gather_rows(t, i).numpy())
    want = np.asarray(jops.scatter_add(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(deltas), **kw))
    bound = _sum_bound(table, ids, deltas)
    got = tops.scatter_add(t, i, d, **kw).numpy()
    assert np.all(np.abs(got - want) <= bound)
    t2 = t.clone()
    assert tops.scatter_add_(t2, i, d, **kw) is t2
    np.testing.assert_array_equal(t2.numpy(), got)


# ---------------------------------------------------------------------------
# K3: the head scatter-add of the hot/cold split.
# ---------------------------------------------------------------------------

def _f64_oracle(table, ids, deltas):
    want = table.astype(np.float64)
    keep = (ids >= 0) & (ids < table.shape[0])
    np.add.at(want, ids[keep], deltas[keep].astype(np.float64))
    return want


@pytest.mark.parametrize("R,D,B", [(64, 8, 100), (53, 11, 513),
                                   (16, 130, 64), (512, 1, 700),
                                   (300, 200, 400)])
def test_packed_plain_matches_jax(R, D, B):
    """K3's plain version over the whole table (``hot_rows = R``) against
    ``scatter_add_packed_pallas`` in interpret mode (bf16 hi+lo, 2^-16 of
    each delta), the XLA route and a float64 sum (float32 summation bound);
    the cases of tests/test_ops.py, ids below 0 and >= R mixed in."""
    rng = np.random.default_rng(R + D)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    ids = (rng.zipf(1.5, B) % (R + 8) - 2).astype(np.int32)
    deltas = rng.normal(0, 1, (B, D)).astype(np.float32)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_pallas = np.asarray(scatter_add_packed_pallas(jt, ji, jd,
                                                       interpret=True))
    want_xla = np.asarray(jops.scatter_add(jt, ji, jd))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    got = kernels.scatter_add_packed_plain(t.clone(), i, d, R).numpy()
    bound = _sum_bound(table, ids, deltas)
    assert np.all(np.abs(got - _f64_oracle(table, ids, deltas)) <= bound)
    assert np.all(np.abs(got - want_xla) <= bound)
    assert np.all(np.abs(got - want_pallas)
                  <= _hilo_bound(table, ids, deltas))
    # A head past the table is the whole table; rows past a head stay.
    np.testing.assert_array_equal(
        kernels.scatter_add_packed_plain(t.clone(), i, d, R + 7).numpy(), got)
    H = max(1, R // 3)
    part = kernels.scatter_add_packed_plain(t.clone(), i, d, H).numpy()
    np.testing.assert_array_equal(part[H:], table[H:])
    head_ids = np.where(ids < H, ids, -1)
    assert np.all(np.abs(part - _f64_oracle(table, head_ids, deltas))
                  <= _sum_bound(table, head_ids, deltas))


@pytest.mark.parametrize("R,D,B,hot", [(64, 8, 100, 16), (130, 3, 513, 7),
                                       (57, 200, 64, 8), (300, 11, 2000, 64)])
def test_hot_cold_split_matches_jax(pallas_backend, R, D, B, hot):
    """``scatter_add`` with ``hot_rows`` against the JAX package's split
    (head through its packed kernel in interpret mode, tail through XLA,
    tests/test_ops.py runs it so): drops, duplicates and the head/tail
    boundary ids. Bounds: 2^-16 of each head delta (the reference's hi+lo)
    plus twice the float32 summation bound; against a float64 sum and the
    XLA route (``hot_rows`` ignored), the float32 summation bound."""
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    ids = (rng.zipf(1.5, B) % R).astype(np.int32)  # heavy head duplication
    ids[::9] = -1
    ids[4::13] = R
    ids[1::17] = hot - 1  # boundary: last head row
    ids[2::17] = hot      # boundary: first tail row
    deltas = rng.normal(0, 1, (B, D)).astype(np.float32)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_pallas = np.asarray(jops.scatter_add(jt, ji, jd, hot_rows=hot))
    jops.set_backend("xla")
    want_xla = np.asarray(jops.scatter_add(jt, ji, jd, hot_rows=hot))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    got = tops.scatter_add(t, i, d, hot_rows=hot).numpy()
    np.testing.assert_array_equal(t.numpy(), table)  # functional form
    bound = _sum_bound(table, ids, deltas)
    assert np.all(np.abs(got - _f64_oracle(table, ids, deltas)) <= bound)
    assert np.all(np.abs(got - want_xla) <= bound)
    head_ids = np.where(ids < hot, ids, -1)
    assert np.all(np.abs(got - want_pallas)
                  <= 2 * bound + _hilo_bound(table, head_ids, deltas))
    # The tail rows are K2's plain version alone: batch order, the bits of
    # the XLA route.
    np.testing.assert_array_equal(got[hot:], want_xla[hot:])


@pytest.mark.parametrize("hot", [96, 96 * 4])
def test_whole_table_route_matches_jax(pallas_backend, hot):
    """``hot_rows >= R``: the whole push through K3, no tail (the
    reference's whole-shard route); drops at both ends."""
    rng = np.random.default_rng(3)
    R, D, B = 96, 8, 512
    table = rng.normal(0, 0.1, (R, D)).astype(np.float32)
    ids = rng.integers(-1, R + 2, B).astype(np.int32)
    deltas = rng.normal(0, 1e-2, (B, D)).astype(np.float32)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_pallas = np.asarray(jops.scatter_add(jt, ji, jd, hot_rows=hot))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    got = tops.scatter_add(t, i, d, hot_rows=hot).numpy()
    np.testing.assert_array_equal(
        got, kernels.scatter_add_packed_plain(t.clone(), i, d, R).numpy())
    bound = _sum_bound(table, ids, deltas)
    assert np.all(np.abs(got - _f64_oracle(table, ids, deltas)) <= bound)
    assert np.all(np.abs(got - want_pallas)
                  <= 2 * bound + _hilo_bound(table, ids, deltas))


def test_hot_rows_on_a_scalar_table_take_k4_alone():
    """Without the head-prefix route a scalar table's push ignores
    ``hot_rows``: K4's plain version, the bits of the plain push."""
    table, ids, deltas = _inputs(300, 1, 2000, seed=12)
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    want = kernels.scatter_add_dim1_plain(t.clone(), i, d).numpy()
    for hot in (1, 100, 300, 1000):
        np.testing.assert_array_equal(
            tops.scatter_add(t, i, d, hot_rows=hot).numpy(), want)


def test_packed_plain_refuses_a_bad_head():
    t, i, d = torch.zeros(5, 2), torch.zeros(3, dtype=torch.int32), None
    with pytest.raises(ValueError, match="hot_rows"):
        kernels.scatter_add_packed_plain(t, i, torch.zeros(3, 2), -1)
    with pytest.raises(TypeError):
        kernels.scatter_add_packed_plain(t, i, torch.zeros(3, 2), 2.0)
    del d


@pytest.mark.parametrize("D", [3, 20])
def test_packed_plain_exact_on_a_hot_row(D):
    """K3's plain version with one head row owning most pushes, on
    sixteenths in [-1/2, 1/2] (every float32 partial sum exact): equal to
    the float64 sum and to the XLA route bit for bit."""
    B, R, H = 1 << 15, 300, 64
    rng = np.random.default_rng(D)
    table = (np.round(rng.normal(0, 1, (R, D)).clip(-2, 2) * 4) / 16
             ).astype(np.float32)
    deltas = (np.round(rng.normal(0, 1, (B, D)).clip(-2, 2) * 4) / 16
              ).astype(np.float32)
    ids = np.full(B, 7, np.int32)
    ids[::5] = rng.integers(-2, R + 2, B)[::5]
    head_ids = np.where(ids < H, ids, -1)
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    got = kernels.scatter_add_packed_plain(t.clone(), i, d, H).numpy()
    np.testing.assert_array_equal(got, _f64_oracle(table, head_ids, deltas))
    np.testing.assert_array_equal(got, np.asarray(jops.scatter_add(
        jnp.asarray(table), jnp.asarray(head_ids), jnp.asarray(deltas))))


@pytest.mark.parametrize("batch,head,dim,want", [
    (0, 2048, 11, 1), (100, 2048, 11, 1), (32_768, 2048, 11, 64),
    (1 << 20, 2048, 20, 204), (425_997, 2048, 3, 256),
    (32_768, 32_768, 100, 2), (32_768, 1 << 20, 200, 1)])
def test_packed_slices(batch, head, dim, want):
    """K3's batch slices: at least 512 ids each, at most 256, and at most
    32 MiB of partial sums."""
    got = kernels.packed_slices(batch, head, dim)
    assert got == want
    assert got == 1 or got * head * dim * 4 <= kernels.PACKED_PARTIAL_BYTES


# ---------------------------------------------------------------------------
# Scalar tables (R, 1): K4 / K5 and the head-prefix route.
# ---------------------------------------------------------------------------

DIM1_CASES = [(1, 50), (128, 300), (130, 513), (1000, 5000), (47_236, 4096)]
EPS32 = np.finfo(np.float32).eps


def _hilo_bound(table, ids, deltas=None):
    """The Pallas scalar kernels carry each value as a bf16 hi+lo pair: hi
    keeps 8 significant bits, lo the rounded rest, so a value is off by at
    most 2^-16 of itself. A gather is off by that much; a scatter by that
    much of each delta, plus the float32 summation bound."""
    if deltas is None:
        R = table.shape[0]
        keep = (ids >= 0) & (ids < R)
        vals = np.where(keep[:, None], table[np.clip(ids, 0, max(R - 1, 0))],
                        0.0)
        return (2.0**-16 + EPS32) * np.abs(vals).astype(np.float64)
    R = table.shape[0]
    keep = (ids >= 0) & (ids < R)
    dmag = np.zeros(table.shape, np.float64)
    np.add.at(dmag, ids[keep], np.abs(deltas[keep]).astype(np.float64))
    return 2.0**-16 * dmag + _sum_bound(table, ids, deltas)


@pytest.mark.parametrize("R,B", DIM1_CASES)
def test_dim1_gather_matches_jax(R, B):
    table, ids, _ = _inputs(R, 1, B, seed=R + B)
    want_xla = np.asarray(jops.gather_rows(jnp.asarray(table),
                                           jnp.asarray(ids)))
    want_pallas = np.asarray(gather_rows_dim1_pallas(
        jnp.asarray(table), jnp.asarray(ids), interpret=True))
    t, i = torch.from_numpy(table), torch.from_numpy(ids)
    for got in (kernels.gather_rows_dim1_plain(t, i).numpy(),
                tops.gather_rows(t, i).numpy()):
        np.testing.assert_array_equal(got, want_xla)
        assert np.all(np.abs(got - want_pallas)
                      <= _hilo_bound(table, ids))


@pytest.mark.parametrize("R,B", DIM1_CASES)
def test_dim1_scatter_add_matches_jax(R, B):
    table, ids, deltas = _inputs(R, 1, B, seed=R * 7 + B)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_xla = np.asarray(jops.scatter_add(jt, ji, jd))
    want_pallas = np.asarray(scatter_add_dim1_pallas(jt, ji, jd,
                                                     interpret=True))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    bound = _sum_bound(table, ids, deltas)
    for got in (kernels.scatter_add_dim1_plain(t.clone(), i, d).numpy(),
                tops.scatter_add(t, i, d).numpy()):
        # Both fold duplicates one by one in batch order: the same bits,
        # and in any case within the float32 summation bound.
        np.testing.assert_array_equal(got, want_xla)
        assert np.all(np.abs(got - want_xla) <= bound)
        assert np.all(np.abs(got - want_pallas)
                      <= _hilo_bound(table, ids, deltas))


def test_dim1_plain_versions_refuse_wide_tables():
    t, i, d = torch.zeros(5, 2), torch.zeros(3, dtype=torch.int32), None
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        kernels.gather_rows_dim1_plain(t, i)
    with pytest.raises(ValueError, match=r"\(R, 1\)"):
        kernels.scatter_add_dim1_plain(t, i, torch.zeros(3, 2))
    del d


@pytest.fixture
def pallas_backend():
    prev = jops.get_backend()
    jops.set_backend("pallas")
    yield
    jops.set_backend(prev)


@pytest.mark.parametrize("R,H,B,q", [(47_236, 2048, 12_288, 8192),
                                     (9_000, 1024, 6_000, 2048)])
def test_head_prefix_matches_jax(pallas_backend, R, H, B, q):
    """The head-prefix route against the JAX package's (tests/test_ops.py
    runs its kernels so): ids[:q] through the head view, the rest through
    the whole table; an id >= H inside the prefix reads zero and its push
    is dropped, on both sides."""
    rng = np.random.default_rng(7)
    table = rng.normal(0, 1, (R, 1)).astype(np.float32)
    head_ids = rng.integers(0, H, q).astype(np.int32)
    head_ids[::11] = -1  # dropped slots inside the guaranteed prefix
    head_ids[5::97] = H + 3  # outside the head: the drop contract
    tail_ids = rng.integers(-1, R, B - q).astype(np.int32)
    ids = np.concatenate([head_ids, tail_ids])
    deltas = rng.normal(0, 1, (B, 1)).astype(np.float32)
    assert jops._route_head_prefix(R, 1, q, H, np.float32)
    jt, ji, jd = jnp.asarray(table), jnp.asarray(ids), jnp.asarray(deltas)
    want_g = np.asarray(jops.gather_rows(jt, ji, hot_rows=H, head_prefix=q))
    want_s = np.asarray(jops.scatter_add(jt, ji, jd, hot_rows=H,
                                         head_prefix=q))
    t, i, d = (torch.from_numpy(x) for x in (table, ids, deltas))
    got_g = tops.gather_rows(t, i, hot_rows=H, head_prefix=q).numpy()
    got_s = tops.scatter_add(t, i, d, hot_rows=H, head_prefix=q).numpy()

    # The drop contract, exactly: an id >= H in the prefix reads zero and
    # its push is lost; every other read is the table's value.
    dropped = np.zeros(B, bool)
    dropped[:q] = head_ids >= H
    assert dropped.any() and not got_g[dropped].any()
    keep = (ids >= 0) & ~dropped
    want_exact = np.where(keep[:, None], table[np.clip(ids, 0, None)], 0.0)
    np.testing.assert_array_equal(got_g, want_exact)
    assert np.all(np.abs(got_g - want_g) <= _hilo_bound(table, np.where(
        keep, ids, -1)))
    push_ids = np.where(keep, ids, -1)
    ref = table.copy()
    np.add.at(ref[:, 0], push_ids[keep], deltas[keep, 0])
    bound = _hilo_bound(table, push_ids, deltas)
    assert np.all(np.abs(got_s - ref) <= bound)
    assert np.all(np.abs(got_s - want_s) <= 2 * bound)
    # In place: the same values, and the head rows live in the table itself.
    t2 = t.clone()
    assert tops.scatter_add_(t2, i, d, hot_rows=H, head_prefix=q) is t2
    np.testing.assert_array_equal(t2.numpy(), got_s)


def test_head_prefix_needs_a_head_and_a_scalar_table():
    """No route without both a declared head and a prefix; a wide table
    reads its rows plainly."""
    rng = np.random.default_rng(3)
    table = torch.from_numpy(rng.normal(0, 1, (50, 1)).astype(np.float32))
    ids = torch.tensor([40, 2, 45, -1], dtype=torch.int32)
    plain = tops.gather_rows(table, ids)
    np.testing.assert_array_equal(
        tops.gather_rows(table, ids, head_prefix=2).numpy(), plain.numpy())
    np.testing.assert_array_equal(
        tops.gather_rows(table, ids, hot_rows=10).numpy(), plain.numpy())
    # With the route, id 40 sits inside the 2-id prefix but outside H = 10.
    routed = tops.gather_rows(table, ids, hot_rows=10, head_prefix=2).numpy()
    assert routed[0, 0] == 0.0 and routed[1, 0] == plain[1, 0]
    np.testing.assert_array_equal(routed[2:], plain[2:].numpy())


def test_kernel_sources_and_build_are_in_the_package():
    from fps_tpu_torch.ops import _build

    names = sorted(p.rsplit("/", 1)[-1] for p in _build.sources())
    assert names == ["gather_rows.cu", "gather_rows_dim1.cu", "pdl.cuh",
                     "radix_sort.cu", "scatter_add.cu", "scatter_add_dim1.cu",
                     "scatter_add_packed.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        assert "atomicAdd" not in src
        if path.endswith(".cu"):
            assert "__global__" in src and 'extern "C"' in src
            assert "cudaGetLastError" in src
