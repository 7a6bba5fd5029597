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

import os
import re

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
                                   (300, 200, 400), (2453, 20, 700)])
def test_packed_plain_matches_jax(R, D, B):
    """K3's plain version over the whole table (``hot_rows = R``) against
    ``scatter_add_packed_pallas`` in interpret mode (bf16 hi+lo, 2^-16 of
    each delta), the XLA route and a float64 sum (float32 summation bound);
    the cases of tests/test_ops.py, ids below 0 and >= R mixed in, and a
    head one row past the card kernel's tile at D = 20 (two row tiles)."""
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
    (1 << 20, 2048, 20, 128), (425_997, 2048, 3, 128),
    (32_768, 32_768, 100, 1), (32_768, 1 << 20, 200, 1)])
def test_packed_slices(batch, head, dim, want):
    """K3's batch slices on 132 multiprocessors: one block a multiprocessor
    over all head tiles, at least 512 ids each, a multiple of the cluster;
    the scratch holds a partial a cluster (none with one cluster)."""
    plan = kernels.packed_plan(batch, head, dim)
    assert plan.slices == want
    assert 1 <= plan.cluster <= kernels.PACKED_MAX_CLUSTER
    assert plan.slices % plan.cluster == 0
    assert plan.groups == plan.slices // plan.cluster
    assert plan.partial_words == (plan.groups * head * dim
                                  if plan.groups > 1 else 0)


def _source_constants(source):
    """The constexpr ints of csrc/``source`` (sums, products, quotients and
    shifts of literals and earlier constants), and the source's text."""
    from fps_tpu_torch.ops import _build

    with open(os.path.join(_build.CSRC, source)) as f:
        text = f.read()
    env = {}
    for name, expr in re.findall(
            r"constexpr int (\w+) =\s*([\w\s*+/<]+);", text):
        # The source's own integer arithmetic.
        expr = " ".join(expr.split()).replace("/", "//")
        env[name] = eval(expr, {}, dict(env))
    return env, text


def _packed_source_constants():
    """The constexpr ints of csrc/scatter_add_packed.cu and its row
    strides."""
    env, text = _source_constants("scatter_add_packed.cu")
    strides = re.search(r"kStrides\[\] = \{([^}]*)\}", text)[1]
    return env, tuple(int(w) for w in strides.split(","))


def test_packed_plan_constants_match_the_source():
    env, strides = _packed_source_constants()
    assert kernels.PACKED_MAX_WIDTH == env["kMaxWidth"]
    assert kernels.PACKED_MAX_CLUSTER == env["kMaxCluster"]
    assert kernels.PACKED_MAX_SMEM == env["kMaxSmem"] == 227 * 1024
    assert kernels.PACKED_FIXED_SMEM == env["kFixedSmem"]
    assert kernels.PACKED_STRIDES == strides


# (batch, H, D, row tiles, column tiles, width): the five K3 shapes of
# chip_smoke.py (MF item head, 20-class PA head, AdaGrad head, one id owning
# 2^20 pushes, the whole 4,096 x 10 table) and the edges: a head one row past
# a tile, a head of 2,048 x 200 and 600 x 130 in column tiles, one row, a
# batch under a chunk.
PLAN_SHAPES = [
    (32_768, 2048, 11, 1, 1, 11), (1 << 20, 2048, 20, 1, 1, 20),
    (425_997, 2048, 3, 1, 1, 3), (32_768, 4096, 10, 2, 1, 10),
    (20_000, 4096, 20, 2, 1, 20), (8000, 2453, 20, 2, 1, 20),
    (8000, 2452, 20, 1, 1, 20), (5000, 2048, 200, 3, 4, 52),
    (3000, 600, 130, 1, 3, 44), (100, 1, 1, 1, 1, 1), (1000, 2048, 20, 1, 1, 20)]


@pytest.mark.parametrize("batch,head,dim,row_tiles,col_tiles,width",
                         PLAN_SHAPES)
def test_packed_plan_tiles_and_shared_memory(batch, head, dim, row_tiles,
                                             col_tiles, width):
    """Head tiles: columns in tiles of at most 64 (multiples of 4 where D
    is), rows in as few tiles as fit in 227 KB beside the staging, each row
    W floats (the least stride that holds the width) and a byte."""
    plan = kernels.packed_plan(batch, head, dim)
    assert (plan.row_tiles, plan.col_tiles, plan.width) == (
        row_tiles, col_tiles, width)
    assert plan.stride == min(w for w in kernels.PACKED_STRIDES
                              if w >= width)
    assert plan.tile_rows * plan.row_tiles >= head
    assert plan.tile_rows * (plan.row_tiles - 1) < head
    assert plan.width * (plan.col_tiles - 1) < dim <= plan.width * plan.col_tiles
    assert plan.smem_bytes == (kernels.PACKED_FIXED_SMEM
                               + 4 * plan.tile_rows * plan.stride
                               + -(-plan.tile_rows // 16) * 16)
    assert plan.smem_bytes <= kernels.PACKED_MAX_SMEM
    # One more row in the tile would not fit, where the head was cut.
    if plan.row_tiles > 1:
        assert (kernels.PACKED_FIXED_SMEM
                + 4 * (head // (plan.row_tiles - 1)) * plan.stride
                + head // (plan.row_tiles - 1)) > kernels.PACKED_MAX_SMEM


@pytest.mark.parametrize("resident,want", [(15, 120), (30, 128), (3, 24),
                                           (0, 128), (-2, 128)])
def test_packed_plan_keeps_clusters_in_one_wave(resident, want):
    """With the card's count of co-resident clusters of 8 (15 on the H100
    at the PA head's 195 KB), the slices are cut so that every cluster runs
    at once; a count below one a tile (or an error) leaves them."""
    plan = kernels.packed_plan(1 << 20, 2048, 20,
                               resident=lambda w, smem, c: resident)
    assert plan.slices == want and plan.cluster == 8
    assert plan.groups == want // 8


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


def test_dim1_plan_constants_match_the_source():
    env, _ = _source_constants("scatter_add_dim1.cu")
    assert kernels.DIM1_CHUNK == env["kTileChunk"]
    assert kernels.DIM1_BUCKET_IDS == env["kChunk"]
    assert kernels.DIM1_BUCKETED_CLUSTER <= kernels.DIM1_MAX_CLUSTER
    assert kernels.DIM1_MAX_CLUSTER == env["kMaxCluster"]
    assert kernels.DIM1_MAX_BUCKETS == env["kMaxBuckets"] <= env["kThreads"]
    assert kernels.DIM1_MAX_BUCKET_BLOCKS == env["kMaxBucketBlocks"]
    assert kernels.PACKED_MAX_SMEM == env["kMaxSmem"]
    assert kernels.DIM1_FIXED_SMEM == env["kFixedSmem"]
    assert kernels.DIM1_GROUP_ROWS == env["kGroupRows"]
    assert kernels.DIM1_TILE_ALIGN == env["kTileAlign"]
    # A warp sorts its 128 entries of a chunk: 7 bits of place in a key.
    assert env["kTileChunk"] // env["kWarps"] == 1 << env["kPosBits"] == 128


# (batch, R, row tiles, buckets): the K4 shapes of chip_smoke.py (the binary
# PA head view and tail, the SGD logistic regression, the off-path 2^20-id
# pushes) and the edges: the most rows one tile holds and one more, one row,
# an empty batch, a table past 256 tiles, the largest table.
DIM1_FIT = kernels.DIM1_MAX_TILE_ROWS
DIM1_PLAN_SHAPES = [
    (294_912, 2048, 1, 1), (753_664, 47_236, 1, 1),
    (425_997, 1_000_000, 20, 20), (1 << 20, 47_236, 1, 1),
    (5000, DIM1_FIT, 1, 1), (5000, DIM1_FIT + 1, 2, 2), (1000, 1, 1, 1),
    (0, 300, 1, 1), (200_000, 256 * DIM1_FIT + 1, 257, 129),
    (5000, 2**31 - 1, 42_474, 256)]


@pytest.mark.parametrize("batch,rows,row_tiles,buckets", DIM1_PLAN_SHAPES)
def test_dim1_plan_tiles_and_shared_memory(batch, rows, row_tiles, buckets):
    """Row tiles: as few as fit a float a row and a flag byte for each 4
    rows in 227 KB beside the staging, as even as may be, a multiple of 64
    rows; they cover [0, R); buckets of whole tiles, at most 256, and none
    past the table."""
    plan = kernels.dim1_plan(batch, rows)
    assert (plan.row_tiles, plan.buckets) == (row_tiles, buckets)
    assert plan.tile_rows % 64 == 0
    assert plan.tile_rows * plan.row_tiles >= rows
    assert plan.tile_rows * (plan.row_tiles - 1) < rows
    assert plan.tile_rows - 63 <= -(-rows // plan.row_tiles) <= plan.tile_rows
    assert plan.smem_bytes == (kernels.DIM1_FIXED_SMEM + 4 * plan.tile_rows
                               + plan.tile_rows // 4)
    assert plan.smem_bytes <= kernels.PACKED_MAX_SMEM
    # The largest tile: one more group of 64 rows would not fit.
    assert (kernels.DIM1_FIXED_SMEM + (DIM1_FIT + 64) * 17 // 4
            > kernels.PACKED_MAX_SMEM >= kernels.DIM1_FIXED_SMEM
            + DIM1_FIT * 17 // 4)
    assert plan.bucket_rows == plan.tiles_per_bucket * plan.tile_rows
    assert plan.buckets <= kernels.DIM1_MAX_BUCKETS
    assert plan.bucket_rows * plan.buckets >= rows
    assert plan.bucket_rows * (plan.buckets - 1) < rows
    if plan.row_tiles > 1:
        # One tile fewer would not fit.
        assert -(-rows // (plan.row_tiles - 1)) > DIM1_FIT


@pytest.mark.parametrize("rows", [1, 2048, 47_236, DIM1_FIT])
@pytest.mark.parametrize("batch", [1, 1023, 1025, 1 << 20])
def test_dim1_plan_one_tile_takes_no_bucket_pass(batch, rows):
    plan = kernels.dim1_plan(batch, rows)
    assert plan.row_tiles == plan.buckets == plan.tiles_per_bucket == 1
    assert plan.bucket_blocks == plan.piece_weight == 0
    assert plan.kernels == 1 + (plan.clusters > 1)
    assert kernels.dim1_work_words(batch, plan) == (
        plan.clusters * plan.tile_rows if plan.clusters > 1 else 0)


@pytest.mark.parametrize("batch,rows,blocks,cluster", [
    (1, 47_236, 1, 1), (1024, 47_236, 1, 1), (1025, 47_236, 2, 2),
    (5000, 47_236, 5, 5), (8192, 47_236, 8, 8), (9000, 47_236, 8, 8),
    (100_000, 47_236, 96, 8), (425_997, 47_236, 128, 8),
    (1 << 20, 47_236, 128, 8), (5000, 1_000_000, 4, 4),
    (9000, 1_000_000, 8, 4), (425_997, 1_000_000, 132, 4)])
def test_dim1_plan_blocks_and_clusters(batch, rows, blocks, cluster):
    """About one tile-pass block a multiprocessor, at least a chunk of
    1,024 ids each, in clusters of 8, or of 4 with a bucket pass (all of
    them, if fewer); the bucket pass at most two blocks a multiprocessor of
    at least 2,048 ids, each bucket weighing 16,384 pushes more in the
    cut."""
    plan = kernels.dim1_plan(batch, rows)
    assert (plan.clusters * plan.cluster, plan.cluster) == (blocks, cluster)
    if plan.buckets == 1:
        assert plan.bucket_blocks == plan.piece_weight == 0
        assert plan.kernels == 1 + (plan.clusters > 1)
        return
    assert plan.bucket_blocks == min(2 * kernels.H100_SMS,
                                     max(1, -(-batch // 2048)))
    assert plan.bucket_blocks <= kernels.DIM1_MAX_BUCKET_BLOCKS
    assert plan.piece_weight == kernels.DIM1_PIECE_PUSHES == 16_384
    assert plan.kernels == 3 + (plan.clusters > 1)


@pytest.mark.parametrize("resident,want", [(15, 15), (16, 16), (30, 16),
                                           (3, 3), (0, 16), (-2, 16)])
def test_dim1_plan_keeps_clusters_in_one_wave(resident, want):
    """With the card's count of co-resident clusters of 8 at a block's
    shared memory, the clusters are cut so that all run at once; a count
    of none (or an error) leaves them."""
    seen = []

    def most(smem, cluster):
        seen.append((smem, cluster))
        return resident

    plan = kernels.dim1_plan(753_664, 47_236, resident=most)
    assert plan.clusters == want and plan.cluster == 8
    assert seen == [(plan.smem_bytes, 8)]


# The K4 shapes of chip_smoke.py phase 3 and the kernels a call at each on
# 132 multiprocessors: one tile (2 kernels: tile pass, fold) or 20 (4: the
# bucket pass's count and scatter, the tile pass, the fold).
@pytest.mark.parametrize("batch,rows,kernels_a_call", [
    (294_912, 2048, 2), (753_664, 47_236, 2), (425_997, 1_000_000, 4),
    (1 << 20, 47_236, 2)])
def test_dim1_plan_kernels_a_call_at_the_smoke_shapes(batch, rows,
                                                      kernels_a_call):
    plan = kernels.dim1_plan(batch, rows)
    assert plan.kernels == kernels_a_call
    assert plan.kernels == (2 * (plan.buckets > 1) + 1
                            + (plan.clusters > 1))
    # The partials: a slot of a bucket's rows for each piece a cluster can
    # take, clusters + buckets - 1 of them.
    words = kernels.dim1_work_words(batch, plan)
    assert words >= (plan.clusters + plan.buckets - 1) * plan.bucket_rows
    assert words % 4 == 0


def test_dim1_bucket_plain_orders_by_bucket_stably():
    """The bucket pass's plain version: kept ids in bucket order, batch
    order within a bucket, each with its delta; the starts of the
    buckets."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-3, 1030, 5000).astype(np.int32)
    deltas = rng.normal(0, 1, (5000, 1)).astype(np.float32)
    got_ids, got_vals, starts = kernels.dim1_bucket_plain(
        torch.from_numpy(ids), torch.from_numpy(deltas), 1000, 100, 10)
    keep = (ids >= 0) & (ids < 1000)
    order = np.argsort(ids[keep] // 100, kind="stable")
    np.testing.assert_array_equal(got_ids.numpy(), ids[keep][order])
    np.testing.assert_array_equal(got_vals.numpy(),
                                  deltas[keep, 0][order])
    want = np.concatenate([[0], np.cumsum(np.bincount(ids[keep] // 100,
                                                      minlength=10))])
    np.testing.assert_array_equal(starts.numpy(), want)


@pytest.fixture
def pallas_backend():
    prev = jops.get_backend()
    jops.set_backend("pallas")
    yield
    jops.set_backend(prev)


@pytest.mark.parametrize("R,H,B,q", [(47_236, 2048, 12_288, 8192),
                                     (9_000, 1024, 6_000, 2048),
                                     (9_000, 1024, 6_000, 2051),
                                     (9_000, 1024, 3_001, 2_999)])
def test_head_prefix_matches_jax(pallas_backend, R, H, B, q):
    """The head-prefix route against the JAX package's (tests/test_ops.py
    runs its kernels so): ids[:q] through the head view, the rest through
    the whole table; an id >= H inside the prefix reads zero and its push
    is dropped, on both sides. The port reads in one call with a bound a
    position (K5's contract; its plain version here), the JAX package in
    two and a concatenation: prefixes that end inside a 16-byte chunk
    (q = 2,051 and 2,999) as well. (A prefix that is the whole batch leaves
    the JAX package an empty tail, which its interpreted scalar scatter
    refuses; the test below holds the port's read there to numpy.)"""
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


@pytest.mark.parametrize("R,H,B,q", [
    (500, 64, 300, 37),     # q not a multiple of 4
    (500, 64, 300, 300),    # the prefix is the whole batch
    (500, 64, 300, 1000),   # a prefix past the batch: all of it
    (50, 64, 300, 101),     # a head past the table: the table
    (500, 0, 300, 40),      # an empty head: the prefix reads zero
    (500, 64, 300, 0),      # no prefix: the plain gather
    (0, 64, 300, 40),       # an empty table
    (500, 64, 0, 10)])      # an empty batch
def test_dim1_plain_head_prefix_reads_against_a_bound_a_position(R, H, B, q):
    """K5's contract in one call: positions below min(q, B) read against
    min(H, R) rows, the rest against R; a dropped position reads +0.0."""
    rng = np.random.default_rng(R + H + B + q)
    table = rng.normal(0, 1, (R, 1)).astype(np.float32)
    ids = rng.integers(-3, max(R, H) + 5, B).astype(np.int32)
    ids[:min(q, B):5] = H  # just past the head inside the prefix
    got = kernels.gather_rows_dim1_plain(
        torch.from_numpy(table), torch.from_numpy(ids), head_rows=H,
        head_prefix=q).numpy()
    bound = np.where(np.arange(B) < q, min(H, R), R)
    keep = (ids >= 0) & (ids < bound)
    want = np.zeros((B, 1), np.float32)
    want[keep] = table[ids[keep]]
    assert got.shape == (B, 1) and got.dtype == np.float32
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    if q == 0:
        np.testing.assert_array_equal(got, kernels.gather_rows_dim1_plain(
            torch.from_numpy(table), torch.from_numpy(ids)).numpy())


def test_dim1_plain_refuses_a_negative_head():
    t, i = torch.zeros(5, 1), torch.zeros(3, dtype=torch.int32)
    for kw in ({"head_rows": -1}, {"head_prefix": -2}):
        with pytest.raises(ValueError, match="must be >= 0"):
            kernels.gather_rows_dim1_plain(t, i, **kw)


# (batch, D, ids offset, table offset) -> (width, vec, index bits, aligned
# ids, blocks): the K1 and K5 shapes of chip_smoke.py (the MF pulls, the
# 20-class PA pull, the AdaGrad pull, the SGD logistic regression and the
# fused binary PA pull), then the edges: odd and generic widths (the card
# tests' D in {2, 3, 4, 5, 10, 11, 20, 32, 33} at B in {1, 3, 4,097}),
# tables aligned to 8 and 4 bytes only, misaligned K5 ids, an output of
# 2^31 floats, an empty batch.
GATHER_PLAN_SHAPES = [
    ((32_768, 10, 0, 0), (10, 2, 32, False, 320)),
    ((1 << 20, 20, 0, 0), (20, 4, 32, False, 1056)),
    ((425_997, 2, 0, 0), (2, 2, 32, False, 833)),
    ((425_997, 1, 0, 0), (1, 1, 32, True, 417)),
    ((1 << 20, 1, 0, 0), (1, 1, 32, True, 1024)),
    ((1, 3, 0, 0), (3, 1, 32, False, 1)),
    ((4097, 11, 0, 0), (11, 1, 32, False, 45)),
    ((4097, 33, 0, 0), (0, 1, 32, False, 133)),
    ((3, 32, 0, 8), (0, 2, 32, False, 1)),
    ((3, 32, 0, 4), (0, 1, 32, False, 1)),
    ((4097, 20, 0, 8), (20, 2, 32, False, 81)),
    ((4097, 10, 0, 4), (10, 1, 32, False, 41)),
    ((4097, 4, 0, 0), (0, 4, 32, False, 17)),
    ((4097, 5, 0, 0), (0, 1, 32, False, 21)),
    ((3, 2, 0, 0), (2, 2, 32, False, 1)),
    ((1, 20, 0, 0), (20, 4, 32, False, 1)),
    ((4097, 32, 0, 12), (0, 1, 32, False, 129)),
    ((4097, 2, 0, 4), (2, 1, 32, False, 9)),
    ((4099, 1, 8, 0), (1, 1, 32, False, 5)),
    ((2**30, 2, 0, 0), (0, 1, 64, False, 1056)),
    ((4099, 1, 4, 0), (1, 1, 32, False, 5)),
    ((4099, 1, 12, 0), (1, 1, 32, False, 5)),
    ((2**31 - 1, 1, 0, 0), (1, 1, 32, True, 1056)),
    ((2**28, 8, 0, 0), (0, 1, 64, False, 1056)),
    ((2**28 - 1, 8, 0, 0), (0, 4, 32, False, 1056)),
    ((0, 10, 0, 0), (10, 2, 32, False, 1))]


@pytest.mark.parametrize("args,want", GATHER_PLAN_SHAPES)
def test_gather_plan_instance_and_grid(args, want):
    batch, dim, ids_offset, table_offset = args
    plan = kernels.gather_plan(batch, dim, ids_offset,
                               table_offset_bytes=table_offset)
    got = (plan.width, plan.vec, plan.index_bits, plan.aligned_ids,
           plan.blocks)
    assert got == want
    # A 16-byte output chunk a thread, as many blocks as the chunks need, at
    # most one wave.
    wave = kernels.H100_SMS * kernels.GATHER_BLOCKS_PER_SM
    assert plan.blocks == max(1, min(-(-batch * dim // 1024), wave))


def test_gather_plan_asks_the_card_for_resident_blocks():
    seen = []

    def resident(plan):
        seen.append(plan)
        return 3

    plan = kernels.gather_plan(1 << 20, 20, resident=resident)
    assert plan.blocks == 3 * kernels.H100_SMS
    assert seen == [plan._replace(blocks=0)]
    # Fewer chunks than a wave: the grid the chunks need.
    assert kernels.gather_plan(32_768, 10, resident=resident).blocks == 320


def test_gather_plan_constants_match_the_source():
    env, _ = _source_constants("gather.cuh")
    assert kernels.GATHER_THREADS == env["kThreads"]
    _, text = _source_constants("gather_rows.cu")
    cases = set(re.findall(r"case (\d+) \* 8 \+ (\d+):", text))
    want = {(str(w), str(v)) for w in (0,) + kernels.GATHER_WIDTHS
            for v in (4, 2, 1) if w % v == 0}
    assert cases == want


@pytest.mark.parametrize("source", ["gather_rows.cu", "gather_rows_dim1.cu"])
def test_gathers_launch_through_pdl(source):
    """Each gather launches with programmatic dependent launch (pdl.cuh's
    launch or launch_ex) and waits for the kernel before it (grid_wait)
    before its first load; no plain triple-chevron launch."""
    _, text = _source_constants(source)
    assert '#include "pdl.cuh"' in text and '#include "gather.cuh"' in text
    assert re.search(r"\blaunch(_ex)?\(kernel,", text)
    assert "<<<" not in text
    body = text[text.index("__global__"):]
    assert body.index("grid_wait();") < body.index("__ldg(")
    assert "__stcs(" in _source_constants("gather.cuh")[1]


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
    assert names == ["gather.cuh", "gather_rows.cu", "gather_rows_dim1.cu",
                     "pdl.cuh",
                     "radix_sort.cu", "scatter_add.cu", "scatter_add_dim1.cu",
                     "scatter_add_packed.cu", "warp_tree.cuh"]
    assert "arch=compute_90a,code=sm_90a" in _build.ARCH_FLAGS
    for path in _build.sources():
        with open(path) as f:
            src = f.read()
        assert "atomicAdd" not in src
        if path.endswith(".cu"):
            assert "__global__" in src and 'extern "C"' in src
            assert "cudaGetLastError" in src
