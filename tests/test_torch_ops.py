"""The PyTorch port's gather and scatter-add against the JAX package's.

On the CPU the port runs each kernel's plain PyTorch version; these tests
hold it, and the port's ``ops`` dispatch, against the JAX package's Pallas
kernels (``gather_rows_pallas`` / ``scatter_add_pallas`` and the scalar-table
``gather_rows_dim1_pallas`` / ``scatter_add_dim1_pallas``, in interpret mode,
as tests/test_ops.py runs them) and against ``fps_tpu.ops`` on its XLA path,
including the scalar tables' head-prefix route. Inputs are made with numpy
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
def test_hot_routes_are_not_ported(kw):
    """The hot/cold push split (kernel K3) is the one route still to port:
    ``hot_rows`` on a push without a head-prefix route raises, also with a
    prefix on a table wider than one column, where the JAX package would
    take K3. A read ignores ``hot_rows`` there, as the JAX package does."""
    t = torch.arange(20, dtype=torch.float32).reshape(10, 2)
    i = torch.tensor([3, -1, 9], dtype=torch.int32)
    np.testing.assert_array_equal(tops.gather_rows(t, i, **kw).numpy(),
                                  tops.gather_rows(t, i).numpy())
    with pytest.raises(NotImplementedError, match="K3"):
        tops.scatter_add(t, i, torch.zeros(3, 2), **kw)
    with pytest.raises(NotImplementedError, match="K3"):
        tops.scatter_add_(t, i, torch.zeros(3, 2), **kw)


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
    assert names == ["gather_rows.cu", "gather_rows_dim1.cu",
                     "scatter_add.cu", "scatter_add_dim1.cu"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        assert "__global__" in src and 'extern "C"' in src
        assert "cudaGetLastError" in src and "atomicAdd" not in src
