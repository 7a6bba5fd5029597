"""The port's CUDA kernels on the card, at shapes the main paths do not give.

``chip_smoke.py`` holds the kernels against their plain versions at the MF,
PA and logistic-regression shapes; these tests add the edges: odd and wide
rows, empty batches, tables of one row, every id dropped, one id owning the
whole batch, odd batch lengths against the scalar gather's 16-byte path, the
head view of a scalar table, K4's tiles, bucket pass, clusters and plans it
refuses, K3's head past one tile of shared memory, its
slices and clusters (the last cluster partly empty), batches around one
staged chunk, runs across chunks and slices, the plans it refuses, the
hot/cold split and the whole-table route, K2's radix sort against
``torch.sort`` (bit for bit) and K2 against exact sums of sixteenths, runs
across the sort's and the sum's tile edges, the gathers (K1, K5) bit for
bit at every width, on views, past 2^31 output floats, with short grids
and the fused head-prefix read, and the wrappers' and kernels' refusals;
K1 and K2 at word2vec's text8 shapes, and its draws on the card against the
CPU's; K2 at iALS's D = 256 (one id owning the push, batches off the tile),
K4 on the sketch tap's 81,920-row stack with every item dropped, the
sketches, the sketch tap and top-k ties on the card against the CPU, and the
host pipeline's side-stream placement (50 chunks with the compute stream
held, bit-equal to synchronous placement; a device-resident source whose
data the held compute stream is still writing, bit-equal to prefetch 0; a
CUDA error in the worker's copy re-raised in ``fit_stream``). Every
test here needs a CUDA device and carries the ``cuda`` marker; without a
card each one skips. On the card:

    python -m pytest tests/test_torch_cuda.py -q -m cuda
"""

import numpy as np
import pytest
import torch

import fps_tpu_torch.ops as tops
from fps_tpu_torch.ops import kernels

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU form")
    return torch.device("cuda", 0)


def _inputs(R, D, B, seed, dev):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    ids = (rng.zipf(1.3, B) % max(R, 1)).astype(np.int32)
    ids[::7] = -1
    ids[3::11] = R
    ids[5::13] = np.iinfo(np.int32).max
    deltas = rng.normal(0, 1, (B, D)).astype(np.float32)
    return (torch.from_numpy(x).to(dev) for x in (table, ids, deltas))


def _bits(x):
    """The int32 view of a float32 tensor: equal bits, so -0.0 != +0.0."""
    return x.contiguous().view(torch.int32)


def _sum_bound(table, ids, deltas):
    """Float32 sums of the same terms in any two orders lie within
    2 * k * eps32 * (sum of the terms' magnitudes) of each other, k the
    row's pushes + 1."""
    R = table.shape[0]
    keep = (ids >= 0) & (ids < R)
    kid = ids[keep].long()
    mag = table.double().abs().index_add_(0, kid, deltas[keep].double().abs())
    count = torch.zeros(R, dtype=torch.float64, device=table.device)
    count.index_add_(0, kid, torch.ones_like(kid, dtype=torch.float64))
    return 2 * (count + 1)[:, None] * np.finfo(np.float32).eps * mag


SHAPES = [(1, 1, 1), (1, 3, 50), (257, 1, 1000), (300, 10, 4096),
          (300, 11, 4096), (1000, 17, 3000), (64, 64, 777), (50, 5, 0)]


@pytest.mark.parametrize("R,D,B", SHAPES)
def test_gather_kernel_bit_equal_to_plain(dev, R, D, B):
    """K1, or K5 for a table of one column, as ``ops.gather_rows`` routes
    them (K1 refuses an (R, 1) table)."""
    table, ids, _ = _inputs(R, D, B, seed=R + D, dev=dev)
    kernel, plain = ((kernels.gather_rows_dim1_cuda,
                      kernels.gather_rows_dim1_plain) if D == 1
                     else (kernels.gather_rows_cuda,
                           kernels.gather_rows_plain))
    got = kernel(table, ids)
    assert got.shape == (B, D)
    assert torch.equal(got, plain(table, ids))


@pytest.mark.parametrize("R,D,B", SHAPES)
def test_scatter_kernel_deterministic_and_within_bound(dev, R, D, B):
    table, ids, deltas = _inputs(R, D, B, seed=R * D + 1, dev=dev)
    got = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    again = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    plain = kernels.scatter_add_plain(table.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())


def _sixteenths(x):
    """``x`` rounded to a multiple of 1/16 within [-1/2, 1/2]: float32 sums
    of up to 2^20 such terms are exact in any order."""
    return torch.round(x.clamp(-2, 2) * 4) / 16


def _exact_sum(table, ids, deltas):
    keep = (ids >= 0) & (ids < table.shape[0])
    return table.double().index_add_(0, ids[keep].long(),
                                     deltas[keep].double())


def test_scatter_one_id_owns_the_batch(dev):
    """The longest run there is, summed by the tree: on sixteenths every
    float32 partial sum is exact, so the row must equal the float64 sum bit
    for bit (a lost or doubled push shows), and the other rows stay."""
    rng = np.random.default_rng(0)
    table = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (8, 10)).astype(np.float32)))
    deltas = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (5000, 10)).astype(np.float32)))
    ids = torch.full((5000,), 3, dtype=torch.int32)
    got = kernels.scatter_add_cuda_(table.to(dev), ids.to(dev),
                                    deltas.to(dev)).cpu()
    assert torch.equal(got.double(), _exact_sum(table, ids, deltas))
    np.testing.assert_array_equal(np.delete(got.numpy(), 3, 0),
                                  np.delete(table.numpy(), 3, 0))


# (R, D, B): the paths' widths (3, 10, 11, 20) and the sweep's (32 to 200,
# several column chunks a block), batches across the sum's 128-position
# tiles and the sort's 4,096.
WIDE_SHAPES = [(500, 3, 4097), (26_744, 11, 32_768), (138_493, 10, 9000),
               (47_236, 20, 70_000), (300, 32, 2000), (300, 33, 2000),
               (300, 65, 2000), (300, 100, 3000), (300, 200, 1500)]


@pytest.mark.parametrize("R,D,B", SHAPES + WIDE_SHAPES)
def test_scatter_kernel_exact_on_sixteenths(dev, R, D, B):
    table, ids, deltas = _inputs(R, D, B, seed=R + 7 * D + B, dev=dev)
    et, ed = _sixteenths(table), _sixteenths(deltas)
    got = kernels.scatter_add_cuda_(et.clone(), ids, ed)
    assert torch.equal(got.double(), _exact_sum(et, ids, ed))


def test_scatter_runs_across_tile_edges(dev):
    """Runs that start, end or cross exactly at the sum's 128-position and
    the sort's 4,096-position tile edges (the first three end at 127, 128
    and 256, so one starts at the odd multiple 128), one run over many
    tiles, and dropped ids at both ends of the batch, which sort last."""
    lengths = [127, 1, 128, 1, 255, 1, 256, 512, 3, 253, 1024, 7, 4096,
               2048, 1]
    ids = np.concatenate([np.full(n, r, np.int32)
                          for r, n in enumerate(lengths)])
    rng = np.random.default_rng(12)
    ids = np.concatenate([np.full(5, -1, np.int32), rng.permutation(ids),
                          np.full(9, 100, np.int32)])
    table = rng.normal(0, 1, (len(lengths) + 1, 11)).astype(np.float32)
    deltas = rng.normal(0, 1, (len(ids), 11)).astype(np.float32)
    t, i, d = (torch.from_numpy(x).to(dev) for x in (table, ids, deltas))
    got = kernels.scatter_add_cuda_(t.clone(), i, d)
    plain = kernels.scatter_add_plain(t.clone(), i, d)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(t, i, d)).all())
    et, ed = _sixteenths(t), _sixteenths(d)
    assert torch.equal(kernels.scatter_add_cuda_(et.clone(), i, ed).double(),
                       _exact_sum(et, i, ed))


def _check_sort(ids, R):
    keys, perm = kernels.radix_sort_cuda(ids, R)
    want_keys, want_perm = kernels.radix_sort_plain(ids, R)
    assert keys.dtype == perm.dtype == torch.int32
    assert torch.equal(keys, want_keys)
    assert torch.equal(perm, want_perm)


@pytest.mark.parametrize("R,D,B", SHAPES + WIDE_SHAPES)
def test_radix_sort_bit_equal_to_torch_sort(dev, R, D, B):
    _, ids, _ = _inputs(R, D, B, seed=R + B, dev=dev)
    _check_sort(ids, R)


@pytest.mark.parametrize("case", ["R=1", "R=2^31-1", "every id dropped",
                                  "one id owns 2^20", "tile edges",
                                  "B=4095", "B=4097", "B=1"])
def test_radix_sort_edges_bit_equal_to_torch_sort(dev, case):
    """The off-path cases: one pass (R = 1) and four (R = 2^31 - 1), no key
    below R, one key everywhere, equal keys across the sort's 4,096-position
    tiles, and batches that are not a multiple of the tile (the sort cuts a
    batch into 1 to 16 warps' worth of 256 positions a tile)."""
    rng = np.random.default_rng(len(case))
    R = 47_236
    if case == "R=1":
        R, ids = 1, rng.integers(-1, 3, 10_000)
    elif case == "R=2^31-1":
        R = 2**31 - 1
        ids = rng.integers(-5, R, 70_000, dtype=np.int64)
        ids[::9] = R - 1
    elif case == "every id dropped":
        ids = np.where(np.arange(9000) % 2, -1, R)
    elif case == "one id owns 2^20":
        ids = np.full(1 << 20, 7)
    elif case == "tile edges":
        # 262,225 ids: the sort's largest tiles, of 4,096 positions.
        ids = np.repeat(np.arange(12), [1, 4095, 1, 4096, 8192, 3, 4093, 7,
                                        4096, 2, 1, 4094])
        ids = np.concatenate([ids + 12 * k for k in range(9)] +
                             [np.full(4096, -1)])[::-1].copy()
    else:
        ids = rng.integers(-1, R + 1, int(case[2:]))
    _check_sort(torch.from_numpy(ids.astype(np.int32)).to(dev), R)


def test_scatter_every_id_dropped_leaves_the_table(dev):
    table, _, deltas = _inputs(40, 6, 500, seed=2, dev=dev)
    ids = torch.full((500,), -1, dtype=torch.int32, device=dev)
    ids[::2] = 40
    assert torch.equal(kernels.scatter_add_cuda_(table.clone(), ids, deltas),
                       table)


def test_ops_dispatch_to_the_kernels_on_the_card(dev):
    table, ids, deltas = _inputs(100, 4, 300, seed=5, dev=dev)
    kernels.reset_launch_counts()
    got = tops.gather_rows(table, ids)
    new = tops.scatter_add(table, ids, deltas)
    tops.scatter_add_(table.clone(), ids, deltas)
    assert kernels.launch_counts() == {"gather_rows": 1, "scatter_add": 2,
                                       "gather_rows_dim1": 0,
                                       "scatter_add_dim1": 0,
                                       "scatter_add_packed": 0}
    assert got.is_cuda and new.is_cuda
    assert torch.equal(new, kernels.scatter_add_cuda_(table.clone(), ids,
                                                      deltas))


@pytest.mark.parametrize("bad", ["int64_ids", "f64_table", "strided_table",
                                 "deltas_shape", "cpu_ids"])
def test_wrappers_refuse_what_they_do_not_take(dev, bad):
    table, ids, deltas = _inputs(30, 4, 20, seed=6, dev=dev)
    if bad == "int64_ids":
        ids = ids.long()
    elif bad == "f64_table":
        table = table.double()
    elif bad == "strided_table":
        table = torch.zeros(30, 8, device=dev)[:, ::2]
    elif bad == "deltas_shape":
        deltas = deltas[:, :3].contiguous()
    else:
        ids = ids.cpu()
    kernels.reset_launch_counts()
    kernels.radix_sort_cuda.launches = 0
    with pytest.raises(ValueError):
        kernels.scatter_add_cuda_(table, ids, deltas)
    if bad != "deltas_shape":
        with pytest.raises(ValueError):
            kernels.gather_rows_cuda(table, ids)
    if bad in ("int64_ids", "cpu_ids"):
        with pytest.raises(ValueError):
            kernels.radix_sort_cuda(ids, 30)
    assert not any(kernels.launch_counts().values())
    assert kernels.radix_sort_cuda.launches == 0


# ---------------------------------------------------------------------------
# K4 / K5: the scalar-table kernels.
# ---------------------------------------------------------------------------

DIM1_SHAPES = [(1, 1), (1, 1000), (5, 0), (7, 3), (130, 5), (2048, 1023),
               (2048, 1024), (2048, 1025), (47_236, 4097), (1000, 3 * 1024),
               (47_236, 1 << 20), (1_000_000, 425_997)]


def _dim1_inputs(R, B, seed, dev):
    table, ids, deltas = _inputs(R, 1, B, seed, dev)
    return table, ids, deltas


@pytest.mark.parametrize("R,B", DIM1_SHAPES)
def test_gather_dim1_kernel_bit_equal_to_plain(dev, R, B):
    table, ids, _ = _dim1_inputs(R, B, seed=R + B, dev=dev)
    got = kernels.gather_rows_dim1_cuda(table, ids)
    assert got.shape == (B, 1)
    assert torch.equal(got, kernels.gather_rows_dim1_plain(table, ids))


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gather_dim1_misaligned_ids_take_the_scalar_path(dev, offset):
    table, ids, _ = _dim1_inputs(500, 4099, seed=offset, dev=dev)
    view = ids[offset:]  # 4-byte aligned only: no 16-byte loads
    assert torch.equal(kernels.gather_rows_dim1_cuda(table, view),
                       kernels.gather_rows_dim1_plain(table, view))


@pytest.mark.parametrize("R,B", DIM1_SHAPES)
def test_scatter_dim1_kernel_deterministic_and_within_bound(dev, R, B):
    table, ids, deltas = _dim1_inputs(R, B, seed=R * 3 + B, dev=dev)
    got = kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas)
    again = kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas)
    plain = kernels.scatter_add_dim1_plain(table.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())


@pytest.mark.parametrize("B", [1, 1023, 1024, 1025, 5000, 1 << 20])
def test_scatter_dim1_one_id_owns_the_batch(dev, B):
    """One run across every chunk, block and cluster: the cluster sums and
    the fold chain every block's part of it. The tree order is not the
    CPU's, so the bound, not bits."""
    rng = np.random.default_rng(B)
    table = torch.from_numpy(rng.normal(0, 1, (8, 1)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    ids = torch.full((B,), 3, dtype=torch.int32)
    want = kernels.scatter_add_dim1_plain(table.clone(), ids, deltas)
    got = kernels.scatter_add_dim1_cuda_(table.to(dev), ids.to(dev),
                                         deltas.to(dev)).cpu()
    bound = _sum_bound(table, ids, deltas)
    assert bool(((got.double() - want.double()).abs() <= bound).all())
    np.testing.assert_array_equal(np.delete(got.numpy(), 3, 0),
                                  np.delete(table.numpy(), 3, 0))
    exact = float(table[3, 0].double() + deltas.double().sum())
    assert abs(float(got[3, 0]) - exact) <= float(bound[3, 0])


def test_scatter_dim1_runs_across_tile_edges(dev):
    """Runs that start, end or cross exactly at 1,024-position edges (a
    chunk's), with dropped ids before and after them."""
    lengths = [1, 1023, 1, 1024, 2048, 3, 1021, 4096, 7]
    ids = np.concatenate([np.full(n, r, np.int32)
                          for r, n in enumerate(lengths)])
    ids = np.concatenate([np.full(5, -1, np.int32), ids,
                          np.full(9, 100, np.int32)])
    rng = np.random.default_rng(11)
    deltas = rng.normal(0, 1, (len(ids), 1)).astype(np.float32)
    table = rng.normal(0, 1, (len(lengths) + 1, 1)).astype(np.float32)
    t, i, d = (torch.from_numpy(x).to(dev) for x in (table, ids, deltas))
    got = kernels.scatter_add_dim1_cuda_(t.clone(), i, d)
    plain = kernels.scatter_add_dim1_plain(t.clone(), i, d)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(t, i, d)).all())


def test_scatter_dim1_every_id_dropped_leaves_the_table(dev):
    table, _, deltas = _dim1_inputs(40, 5000, seed=2, dev=dev)
    ids = torch.full((5000,), -1, dtype=torch.int32, device=dev)
    ids[::2] = 40
    assert torch.equal(
        kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas), table)
    assert not kernels.gather_rows_dim1_cuda(table, ids).any()


def test_dim1_head_view(dev):
    """The head-prefix route's calls: the read in one K5 launch with a bound
    a position; the push by K4 on ``table[:H]``, a view into the table,
    then on the whole table."""
    R, H, q, B = 9000, 1024, 3072, 8000
    rng = np.random.default_rng(5)
    table = torch.from_numpy(rng.normal(0, 1, (R, 1)).astype(np.float32))
    ids = np.concatenate([rng.integers(-1, H + 50, q),
                          rng.integers(-1, R, B - q)]).astype(np.int32)
    ids = torch.from_numpy(ids)
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    want_g = tops.gather_rows(table, ids, hot_rows=H, head_prefix=q)
    want_s = tops.scatter_add(table, ids, deltas, hot_rows=H, head_prefix=q)
    td, idd, dd = table.to(dev), ids.to(dev), deltas.to(dev)
    kernels.reset_launch_counts()
    got_g = tops.gather_rows(td, idd, hot_rows=H, head_prefix=q)
    got_s = tops.scatter_add(td, idd, dd, hot_rows=H, head_prefix=q)
    assert kernels.launch_counts() == {"gather_rows": 0, "scatter_add": 0,
                                       "gather_rows_dim1": 1,
                                       "scatter_add_dim1": 2,
                                       "scatter_add_packed": 0}
    assert torch.equal(_bits(got_g.cpu()), _bits(want_g))
    assert bool(((got_s.cpu().double() - want_s.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())


def test_ops_dispatch_scalar_tables_to_k4_k5(dev):
    table, ids, deltas = _dim1_inputs(100, 300, seed=5, dev=dev)
    kernels.reset_launch_counts()
    tops.gather_rows(table, ids)
    tops.scatter_add(table, ids, deltas)
    assert kernels.launch_counts() == {"gather_rows": 0, "scatter_add": 0,
                                       "gather_rows_dim1": 1,
                                       "scatter_add_dim1": 1,
                                       "scatter_add_packed": 0}


@pytest.mark.parametrize("bad", ["two_columns", "int64_ids", "f64_table",
                                 "strided_table", "deltas_flat", "cpu_ids"])
def test_dim1_wrappers_refuse_what_they_do_not_take(dev, bad):
    table, ids, deltas = _dim1_inputs(30, 20, seed=6, dev=dev)
    if bad == "two_columns":
        table = torch.zeros(30, 2, device=dev)
    elif bad == "int64_ids":
        ids = ids.long()
    elif bad == "f64_table":
        table = table.double()
    elif bad == "strided_table":
        table = torch.zeros(30, 2, device=dev)[:, :1]
    elif bad == "deltas_flat":
        deltas = deltas.reshape(-1)
    else:
        ids = ids.cpu()
    kernels.reset_launch_counts()
    with pytest.raises(ValueError):
        kernels.scatter_add_dim1_cuda_(table, ids, deltas)
    if bad != "deltas_flat":
        with pytest.raises(ValueError):
            kernels.gather_rows_dim1_cuda(table, ids)
    assert not any(kernels.launch_counts().values())


def _check_dim1(table, ids, deltas, plan=None):
    """K4 deterministic (two launches, the same bits), within the float32
    bound of the plain version, and on sixteenths of the same inputs equal
    to the exact float64 sum (the bound alone grows past a hot row's sum,
    so only exact sums show a lost or doubled push). ``plan``: K4's plan,
    the card's by default."""
    got = kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas,
                                         plan=plan)
    again = kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas,
                                           plan=plan)
    plain = kernels.scatter_add_dim1_plain(table.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())
    et, ed = _sixteenths(table), _sixteenths(deltas)
    exact = kernels.scatter_add_dim1_cuda_(et.clone(), ids, ed, plan=plan)
    assert torch.equal(exact.double(), _exact_sum(et, ids, ed))
    return got


DIM1_FIT = kernels.DIM1_MAX_TILE_ROWS


@pytest.mark.parametrize("R", [1, 4, 2047, DIM1_FIT, DIM1_FIT + 1,
                               2 * DIM1_FIT, 2 * DIM1_FIT + 1])
def test_scatter_dim1_table_at_a_tile_edge(dev, R):
    """Tables of one row, of the most rows one tile holds and one more (a
    bucket pass over two tiles), of two tiles and one more (three), with
    ids at both edges of every tile."""
    table, ids, deltas = _dim1_inputs(R, 70_000, seed=R, dev=dev)
    plan = kernels.card_dim1_plan(dev, 70_000, R)
    assert plan.buckets == -(-R // DIM1_FIT)
    edges = torch.tensor([0, R - 1, min(DIM1_FIT, R - 1),
                          min(DIM1_FIT - 1, R - 1)], dtype=torch.int32)
    ids[1::9] = edges.to(dev).repeat(-(-ids[1::9].numel() // 4))[
        :ids[1::9].numel()]
    _check_dim1(table, ids, deltas)


@pytest.mark.parametrize("B", [1, 31, 1023, 1025, 2047, 2049, 5003, 70_001])
@pytest.mark.parametrize("R", [2048, 3 * DIM1_FIT])
def test_scatter_dim1_batch_not_a_multiple_of_the_chunk(dev, B, R):
    """Batches around and past one chunk of the tile pass (1,024 ids) and a
    round of the bucket pass (2,048), on one tile and on a bucket pass of
    three."""
    table, ids, deltas = _dim1_inputs(R, B, seed=B + R, dev=dev)
    _check_dim1(table, ids, deltas)


def test_scatter_dim1_hot_tile_over_many_clusters(dev):
    """The logistic-regression shape: 1M rows (20 tiles), Zipf(0.9)
    features, so that tile 0 takes most pushes and its stretch is cut over
    most clusters; the cold tiles' stretches share clusters."""
    R, B = 1_000_000, 425_997
    rng = np.random.default_rng(7)
    pop = 1.0 / np.arange(1, R + 1) ** 0.9
    ids = rng.choice(R, B, p=pop / pop.sum()).astype(np.int32)
    ids[::97] = -1
    ids[13::101] = R + 3
    table = torch.from_numpy(rng.normal(0, 1, (R, 1)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    plan = kernels.card_dim1_plan(dev, B, R)
    assert plan.buckets == 20 and plan.clusters > 1
    counts = np.bincount(ids[(ids >= 0) & (ids < R)] // plan.bucket_rows)
    assert counts[0] > counts.sum() / 2
    _check_dim1(table.to(dev), torch.from_numpy(ids).to(dev), deltas.to(dev))


def _dim1_plan(B, R, cluster, clusters):
    return kernels.dim1_plan(B, R)._replace(cluster=cluster,
                                            clusters=clusters)


# (B, R, cluster, clusters): one block; one cluster of 2, 5 and 8 (the
# cluster adds straight into the table); clusters of 1 (each block's partial
# through the fold); more clusters than a small batch fills (empty ones);
# the same on a bucket pass, where a cluster holds pieces of several tiles.
@pytest.mark.parametrize("B,R,cluster,clusters", [
    (5000, 3000, 1, 1), (5000, 3000, 2, 1), (5000, 3000, 5, 1),
    (20_000, 3000, 8, 1), (20_000, 3000, 1, 7), (20_000, 3000, 8, 16),
    (17, 3000, 8, 16), (40_000, 3 * DIM1_FIT, 1, 1),
    (40_000, 3 * DIM1_FIT, 4, 3), (40_000, 3 * DIM1_FIT, 8, 16),
    (300, 3 * DIM1_FIT, 8, 16)])
def test_scatter_dim1_clusters_and_pieces(dev, B, R, cluster, clusters):
    table, ids, deltas = _dim1_inputs(R, B, seed=B + cluster, dev=dev)
    _check_dim1(table, ids, deltas, _dim1_plan(B, R, cluster, clusters))


@pytest.mark.parametrize("R", [300, 3 * DIM1_FIT])
@pytest.mark.parametrize("cluster,clusters", [(1, 1), (8, 2), (8, 16)])
def test_scatter_dim1_runs_across_chunk_block_and_cluster_edges(
        dev, R, cluster, clusters):
    """Runs of one row across the 1,024-push chunks, a warp's 128, the
    blocks' and the clusters' shares: runs of 1,023, 1, 1,024, 2, 127, 128,
    129, 2,047, 2,048, 2,049, 4,095 and 8,193 pushes, in rows of each tile,
    with dropped ids between some."""
    lengths = [1023, 1, 1024, 2, 127, 128, 129, 2047, 2048, 2049, 4095, 1,
               64, 8193, 3]
    rows = [(k * 7919) % R for k in range(len(lengths))]
    runs = [np.full(n, r, np.int32) for r, n in zip(rows, lengths)]
    runs.insert(5, np.full(37, -1, np.int32))
    runs.insert(9, np.full(11, R, np.int32))
    ids = np.concatenate(runs)
    B = ids.size
    rng = np.random.default_rng(R + clusters)
    table = torch.from_numpy(rng.normal(0, 1, (R, 1)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    _check_dim1(table.to(dev), torch.from_numpy(ids).to(dev),
                deltas.to(dev), _dim1_plan(B, R, cluster, clusters))


@pytest.mark.parametrize("R", [40, 3 * DIM1_FIT])
def test_scatter_dim1_every_id_dropped_on_every_route(dev, R):
    table, _, deltas = _dim1_inputs(R, 70_000, seed=3, dev=dev)
    ids = torch.full((70_000,), -1, dtype=torch.int32, device=dev)
    ids[::2] = R
    ids[1::4] = np.iinfo(np.int32).max
    for plan in (None, _dim1_plan(70_000, R, 8, 16),
                 _dim1_plan(70_000, R, 1, 1)):
        assert torch.equal(kernels.scatter_add_dim1_cuda_(
            table.clone(), ids, deltas, plan=plan), table)


@pytest.mark.parametrize("R", [47_236, 3 * DIM1_FIT])
def test_scatter_dim1_one_id_owns_2_20_pushes_exactly(dev, R):
    """Every push to one row, one tile or a bucket pass of three: on
    sixteenths each float32 partial sum is exact, so the row must equal the
    float64 sum bit for bit, and every other row stays."""
    B = 1 << 20
    rng = np.random.default_rng(R)
    table = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (R, 1)).astype(np.float32)))
    deltas = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (B, 1)).astype(np.float32)))
    row = R - 5
    ids = torch.full((B,), row, dtype=torch.int32)
    got = _check_dim1(table.to(dev), ids.to(dev), deltas.to(dev)).cpu()
    assert torch.equal(got[row].double(),
                       table[row].double() + deltas.double().sum(0))
    np.testing.assert_array_equal(np.delete(got.numpy(), row, 0),
                                  np.delete(table.numpy(), row, 0))


@pytest.mark.parametrize("R,H", [(9000, 1024), (3 * DIM1_FIT, 2048),
                                 (3 * DIM1_FIT, DIM1_FIT + 5)])
def test_scatter_dim1_head_view_leaves_the_rows_past_it(dev, R, H):
    """K4 on ``table[:H]``, a view into a larger table (the head-prefix
    route's first call; a view of more than one tile too): ids at and past
    H are dropped, rows >= H unchanged."""
    table, ids, deltas = _dim1_inputs(R, 100_000, seed=H, dev=dev)
    ids[2::5] = H
    ids[3::5] = H - 1
    whole = table.clone()
    got = _check_dim1(whole[:H], ids, deltas)
    kernels.scatter_add_dim1_cuda_(whole[:H], ids, deltas)
    assert torch.equal(whole[:H], got)
    assert torch.equal(whole[H:], table[H:])


@pytest.mark.parametrize("R,B", [(3 * DIM1_FIT, 70_000),
                                 (1_000_000, 425_997),
                                 (256 * DIM1_FIT + 1, 200_000),
                                 (2 * DIM1_FIT, 17)])
def test_dim1_bucket_pass_bit_equal_to_plain(dev, R, B):
    """The bucket pass alone: the kept ids and their deltas in bucket
    order, stable, and the buckets' starts, bit for bit as the plain
    version's stable sort by bucket; past 256 tiles a bucket holds two."""
    _, ids, deltas = _dim1_inputs(R, B, seed=B, dev=dev)
    plan = kernels.card_dim1_plan(dev, B, R)
    assert plan.buckets > 1
    got_ids, got_vals, starts = kernels.dim1_bucket_cuda(ids, deltas, R)
    want_ids, want_vals, want_starts = kernels.dim1_bucket_plain(
        ids, deltas, R, plan.bucket_rows, plan.buckets)
    assert torch.equal(starts, want_starts)
    n = int(starts[-1])
    assert torch.equal(got_ids[:n], want_ids)
    assert torch.equal(got_vals[:n], want_vals)


def test_scatter_dim1_past_256_tiles(dev):
    """A table of 256 tiles and one row more: buckets of two tiles, each
    tile of a bucket summed from the bucket's stretch in turn."""
    R, B = 256 * DIM1_FIT + 1, 200_000
    plan = kernels.card_dim1_plan(dev, B, R)
    assert plan.tiles_per_bucket == 2 and plan.buckets == 129
    rng = np.random.default_rng(1)
    ids = rng.integers(-1, R + 1, B).astype(np.int32)
    ids[::3] = rng.integers(0, 4 * DIM1_FIT, B)[::3]
    table = torch.zeros((R, 1), device=dev)
    table[::1000] = 1.0
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    _check_dim1(table, torch.from_numpy(ids).to(dev), deltas.to(dev))


@pytest.mark.parametrize("bad", ["cluster_9", "tile_not_64", "too_much_smem",
                                 "too_few_tiles", "no_bucket_blocks"])
def test_dim1_kernel_refuses_a_plan_it_cannot_run(dev, bad):
    table, ids, deltas = _dim1_inputs(3 * DIM1_FIT, 5000, seed=9, dev=dev)
    plan = kernels.dim1_plan(5000, 3 * DIM1_FIT)
    plan = {
        "cluster_9": plan._replace(cluster=9),
        "tile_not_64": plan._replace(tile_rows=plan.tile_rows - 2),
        "too_much_smem": plan._replace(tile_rows=plan.tile_rows + 4096),
        "too_few_tiles": plan._replace(buckets=2),
        "no_bucket_blocks": plan._replace(bucket_blocks=0),
    }[bad]
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError):
        kernels.scatter_add_dim1_cuda_(table.clone(), ids, deltas, plan=plan)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# K3: the head scatter-add of the hot/cold push split.
# ---------------------------------------------------------------------------

def _head_bound(table, ids, deltas, H):
    """The float32 summation bound over the head rows' pushes only."""
    head = (ids >= 0) & (ids < H)
    return _sum_bound(table, torch.where(head, ids, -1), deltas)


def _exact_head_sum(table, ids, deltas, H):
    head = (ids >= 0) & (ids < min(H, table.shape[0]))
    return table.double().index_add_(0, ids[head].long(),
                                     deltas[head].double())


def _check_packed(table, ids, deltas, H, plan=None):
    """Deterministic, within the float32 bound of the plain version, rows
    past the head untouched; and on sixteenths of the same inputs equal to
    the exact float64 sum (the bound alone grows past a hot row's sum).
    ``plan``: K3's plan, the card's by default."""
    got = kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, H,
                                           plan=plan)
    again = kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, H,
                                             plan=plan)
    plain = kernels.scatter_add_packed_plain(table.clone(), ids, deltas, H)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _head_bound(table, ids, deltas, H)).all())
    # Rows past the head are untouched.
    assert torch.equal(got[H:], table[H:])
    et, ed = _sixteenths(table), _sixteenths(deltas)
    exact = kernels.scatter_add_packed_cuda_(et.clone(), ids, ed, H,
                                             plan=plan)
    assert torch.equal(exact.double(), _exact_head_sum(et, ids, ed, H))
    return got


# (R, D, B, H): R = 1, an empty batch, each D from 1 to 200, and heads at
# and around 64 to 2,048 rows (the row-tile edges of K3's first design).
PACKED_SHAPES = [(1, 4, 100, 1), (50, 5, 0, 20), (300, 1, 5000, 256),
                 (2000, 1, 9000, 2048), (1000, 3, 3000, 680),
                 (1000, 3, 3000, 681), (500, 11, 4096, 183),
                 (500, 11, 4096, 184), (500, 11, 4096, 185),
                 (400, 20, 4096, 96), (400, 20, 4096, 97),
                 (300, 32, 2000, 64), (300, 100, 2000, 65),
                 (300, 200, 2000, 128), (26_744, 11, 32_768, 2048)]


@pytest.mark.parametrize("R,D,B,H", PACKED_SHAPES)
def test_packed_kernel_deterministic_and_within_bound(dev, R, D, B, H):
    table, ids, deltas = _inputs(R, D, B, seed=R + D + B, dev=dev)
    _check_packed(table, ids, deltas, H)


@pytest.mark.parametrize("D", [1, 3, 11, 20, 200])
def test_packed_whole_table(dev, D):
    """``H >= R``: every in-range id is a head id."""
    table, ids, deltas = _inputs(700, D, 6000, seed=D, dev=dev)
    got = _check_packed(table, ids, deltas, 700)
    again = _check_packed(table, ids, deltas, 10_000)
    assert torch.equal(got, again)


def test_packed_every_id_dropped_leaves_the_table(dev):
    table, _, deltas = _inputs(64, 11, 5000, seed=2, dev=dev)
    ids = torch.full((5000,), -1, dtype=torch.int32, device=dev)
    ids[::2] = 64
    ids[1::4] = 40  # outside a head of 32: the tail's, not K3's
    got = kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, 32)
    assert torch.equal(got, table)


@pytest.mark.parametrize("D", [3, 11, 20])
def test_packed_one_id_owns_2_20_pushes(dev, D):
    """Every push to one row. On sixteenths each float32 partial sum is
    exact, so the row must equal the float64 sum bit for bit: a lost or
    doubled push shows, where the worst-case bound would hide it."""
    B = 1 << 20
    rng = np.random.default_rng(D)
    table = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (2048, D)).astype(np.float32)))
    deltas = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (B, D)).astype(np.float32)))
    ids = torch.full((B,), 1000, dtype=torch.int32)
    td, idd, dd = table.to(dev), ids.to(dev), deltas.to(dev)
    got = _check_packed(td, idd, dd, 2048).cpu()
    exact = table[1000].double() + deltas.double().sum(0)
    assert torch.equal(got[1000].double(), exact)
    np.testing.assert_array_equal(np.delete(got.numpy(), 1000, 0),
                                  np.delete(table.numpy(), 1000, 0))


# (R, D, B, H): heads past one tile of shared memory. 4,096 x 20 and
# 2,753 x 20 take two row tiles (2,452 rows of 20 fit); 2,048 x 200 three
# row tiles of four column tiles; 4,096 x 32 three row tiles; 600 x 130
# three column tiles of 44, 44 and 42.
TILED_SHAPES = [(4096, 20, 20_000, 4096), (5000, 20, 8000, 2753),
                (2048, 200, 5000, 2048), (4096, 32, 30_000, 4096),
                (600, 130, 3000, 600)]


@pytest.mark.parametrize("R,D,B,H", TILED_SHAPES)
def test_packed_head_past_one_tile(dev, R, D, B, H):
    plan = kernels.packed_plan(B, H, D)
    assert plan.row_tiles * plan.col_tiles > 1
    table, ids, deltas = _inputs(R, D, B, seed=R + D, dev=dev)
    _check_packed(table, ids, deltas, H)


def _plan(B, H, D, slices, cluster):
    groups = slices // cluster
    return kernels.packed_plan(B, H, D)._replace(
        slices=slices, cluster=cluster, groups=groups,
        partial_words=groups * H * D if groups > 1 else 0)


# (B, slices, cluster): slices past the batch's end, so that the last
# cluster holds empty slices (17 ids over 16 slices of 2: slices 9-15 are
# empty), or one partly empty; clusters of 1 (each block's partial through
# global scratch), of 2 and 4, and one cluster alone (straight into the
# table).
@pytest.mark.parametrize("B,slices,cluster", [
    (17, 16, 8), (3000, 24, 8), (5000, 16, 1), (5000, 6, 2), (700, 8, 8),
    (4100, 12, 4)])
def test_packed_slices_and_clusters(dev, B, slices, cluster):
    table, ids, deltas = _inputs(300, 11, B, seed=B + slices, dev=dev)
    _check_packed(table, ids, deltas, 256, _plan(B, 256, 11, slices, cluster))


@pytest.mark.parametrize("B", [1, 31, 32, 33, 1000, 1023, 1024, 1025])
@pytest.mark.parametrize("D", [3, 20])
def test_packed_batch_around_one_chunk(dev, B, D):
    """Batches shorter than one staged chunk of 1,024 ids, and at its edge;
    the card's plan takes one slice for all of them."""
    table, ids, deltas = _inputs(2048, D, B, seed=B * D, dev=dev)
    _check_packed(table, ids, deltas, 2048)


@pytest.mark.parametrize("slices,cluster", [(1, 1), (8, 8), (16, 8)])
def test_packed_runs_across_chunk_edges(dev, slices, cluster):
    """Runs of one row across the 1,024-id chunks, the 32-push rounds of a
    warp and the slices: runs of 1,023, 1, 1,024, 2, 31, 32, 33 and 4,095
    pushes of rows owned by one warp (8 rows apart) and by others, with
    tail ids between some."""
    lengths = [1023, 1, 1024, 2, 31, 32, 33, 4095, 1, 1025, 64, 3]
    runs = [np.full(n, (8 * k) % 256 if k % 3 else k, np.int32)
            for k, n in enumerate(lengths)]
    runs.insert(5, np.full(37, 900, np.int32))  # past the head
    ids = np.concatenate(runs)
    B, D = ids.size, 11
    rng = np.random.default_rng(slices)
    table = torch.from_numpy(rng.normal(0, 1, (300, D)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 1, (B, D)).astype(np.float32))
    _check_packed(table.to(dev), torch.from_numpy(ids).to(dev),
                  deltas.to(dev), 256, _plan(B, 256, D, slices, cluster))


@pytest.mark.parametrize("bad", ["slices_not_clusters", "cluster_9",
                                 "too_much_smem", "no_scratch", "width_65"])
def test_packed_kernel_refuses_a_plan_it_cannot_run(dev, bad):
    table, ids, deltas = _inputs(300, 11, 5000, seed=9, dev=dev)
    plan = kernels.packed_plan(5000, 256, 11)
    plan = {
        "slices_not_clusters": _plan(5000, 256, 11, 12, 8),
        "cluster_9": _plan(5000, 256, 11, 18, 9),
        "too_much_smem": plan._replace(tile_rows=30_000),
        "no_scratch": _plan(5000, 256, 11, 16, 8)._replace(partial_words=0),
        "width_65": plan._replace(width=65),
    }[bad]
    kernels.reset_launch_counts()
    with pytest.raises(RuntimeError):
        kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, 256,
                                         plan=plan)
    assert not any(kernels.launch_counts().values())


@pytest.mark.parametrize("H", [1, 64, 300, 512])
def test_ops_split_dispatches_k3_and_k2(dev, H):
    """``hot_rows`` on a wide table: K3 for the head, K2 for the tail (K3
    alone when ``H >= R``), within the bound of the plain split."""
    R, D, B = 512, 11, 4096
    table, ids, deltas = _inputs(R, D, B, seed=H, dev=dev)
    ids[1::17] = H - 1  # the last head row
    ids[2::17] = H      # the first tail row (R itself at H = R: dropped)
    kernels.reset_launch_counts()
    got = tops.scatter_add(table, ids, deltas, hot_rows=H)
    assert kernels.launch_counts() == {
        "gather_rows": 0, "scatter_add": int(H < R), "gather_rows_dim1": 0,
        "scatter_add_dim1": 0, "scatter_add_packed": 1}
    want = tops.scatter_add(table.cpu(), ids.cpu(), deltas.cpu(),
                            hot_rows=H)
    assert bool(((got.cpu().double() - want.double()).abs()
                 <= _sum_bound(table, ids, deltas).cpu()).all())


def test_hot_rows_on_a_scalar_table_stay_on_k4(dev):
    """``hot_rows`` without the head-prefix route on an ``(R, 1)`` table:
    K4 alone, which already sums hot runs by a tree."""
    table, ids, deltas = _dim1_inputs(300, 5000, seed=8, dev=dev)
    kernels.reset_launch_counts()
    got = tops.scatter_add(table, ids, deltas, hot_rows=100)
    tops.scatter_add_(table.clone(), ids, deltas, hot_rows=300)
    assert kernels.launch_counts() == {"gather_rows": 0, "scatter_add": 0,
                                       "gather_rows_dim1": 0,
                                       "scatter_add_dim1": 2,
                                       "scatter_add_packed": 0}
    assert torch.equal(got, kernels.scatter_add_dim1_cuda_(
        table.clone(), ids, deltas))


@pytest.mark.parametrize("bad", ["int64_ids", "f64_table", "strided_table",
                                 "deltas_shape", "cpu_ids", "hot_rows",
                                 "float_hot_rows"])
def test_packed_wrapper_refuses_what_it_does_not_take(dev, bad):
    table, ids, deltas = _inputs(30, 4, 20, seed=6, dev=dev)
    H = 8
    if bad == "int64_ids":
        ids = ids.long()
    elif bad == "f64_table":
        table = table.double()
    elif bad == "strided_table":
        table = torch.zeros(30, 8, device=dev)[:, ::2]
    elif bad == "deltas_shape":
        deltas = deltas[:, :3].contiguous()
    elif bad == "cpu_ids":
        ids = ids.cpu()
    elif bad == "hot_rows":
        H = -1
    else:
        H = 8.0
    kernels.reset_launch_counts()
    with pytest.raises((ValueError, TypeError)):
        kernels.scatter_add_packed_cuda_(table, ids, deltas, H)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# K1 / K5: the gathers' chunks, instances, plans and head-prefix route, bit
# for bit (int32 views) against their plain versions.
# ---------------------------------------------------------------------------

I32 = np.iinfo(np.int32)


def _edge_inputs(R, D, B, seed, dev):
    """A table with some -0.0 values (their bits must be copied) and ids at
    every edge: -1, R, R - 1, 2^31 - 1 and -2^31, beside duplicates."""
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (R, D)).astype(np.float32)
    table[::5, ::3] = -0.0
    ids = rng.integers(0, max(R, 1), B).astype(np.int32)
    for k, v in enumerate((-1, R, R - 1, I32.max, I32.min)):
        ids[k::7] = v
    return (torch.from_numpy(table).to(dev), torch.from_numpy(ids).to(dev))


def _check_gather(table, ids, plan=None):
    kernel, plain = ((kernels.gather_rows_dim1_cuda,
                      kernels.gather_rows_dim1_plain) if table.shape[1] == 1
                     else (kernels.gather_rows_cuda,
                           kernels.gather_rows_plain))
    got = kernel(table, ids, plan=plan)
    want = plain(table, ids)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(_bits(got), _bits(want))
    return got


@pytest.mark.parametrize("D", [2, 3, 4, 5, 10, 11, 20, 32, 33])
@pytest.mark.parametrize("B", [1, 3, 4097])
def test_gather_bit_equal_at_every_width(dev, D, B):
    """The compiled widths (2, 3, 10, 11, 20), the run-time ones (4, 5, 32,
    33), 8-byte and 16-byte table loads, chunks across two rows and the
    ragged last chunk (B * D not a multiple of 4)."""
    table, ids = _edge_inputs(300, D, B, seed=D * 7 + B, dev=dev)
    _check_gather(table, ids)


@pytest.mark.parametrize("D", [1, 2, 10, 20, 33])
def test_gather_grid_stride(dev, D):
    """Grids of 3 blocks and of 1, so that each block strides over many
    passes, against the plan's one wave."""
    table, ids = _edge_inputs(1000, D, 50_003, seed=D, dev=dev)
    plan = kernels.card_plan_for(table, ids)
    for blocks in (3, 1, plan.blocks):
        _check_gather(table, ids, plan._replace(blocks=blocks))


@pytest.mark.parametrize("D", [1, 2, 10, 20])
def test_gather_empty_table_reads_positive_zeros(dev, D):
    table = torch.zeros((0, D), device=dev)
    ids = torch.tensor([-1, 0, 1, 5, I32.max, I32.min], dtype=torch.int32,
                       device=dev)
    got = _check_gather(table, ids)
    assert not _bits(got).any()
    if D == 1:
        got = kernels.gather_rows_dim1_cuda(table, ids, head_rows=4,
                                            head_prefix=3)
        assert got.shape == (6, 1) and not _bits(got).any()


@pytest.mark.parametrize("D", [1, 2, 10, 20])
def test_gather_views_of_a_larger_table(dev, D):
    """``table[:H]``: rows past H are outside [0, H); a view whose base is
    4-byte aligned only takes 4-byte table loads."""
    table, ids = _edge_inputs(5000, D, 10_007, seed=3 * D, dev=dev)
    ids = torch.where(ids >= 0, ids % 3000, ids)
    _check_gather(table[:1024], ids)
    flat = torch.zeros(5000 * D + 1, device=dev)
    shifted = flat[1:].view(5000, D)
    shifted.copy_(table)
    assert kernels.card_plan_for(shifted, ids).vec == 1
    _check_gather(shifted, ids)


def test_gather_past_2_31_floats(dev):
    """B * D >= 2^31 takes the 64-bit instance; the first and last rows
    are held to the plain version (the whole plain result would need
    another 9 GB)."""
    R, D, B = 500, 33, (1 << 26) + 5
    table, ids = _edge_inputs(R, D, B, seed=9, dev=dev)
    assert kernels.card_plan_for(table, ids).index_bits == 64
    assert B * D >= 2**31
    got = kernels.gather_rows_cuda(table, ids)
    for part in (slice(0, 4099), slice(B - 4099, B)):
        want = kernels.gather_rows_plain(table, ids[part])
        assert torch.equal(_bits(got[part]), _bits(want))
    del got


@pytest.mark.parametrize("offset", [1, 2, 3])
def test_gather_dim1_misaligned_ids_take_the_vector_body(dev, offset):
    """A view 4, 8 or 12 bytes past a 16-byte boundary: 4-byte id loads,
    the same 16-byte chunks and stores; prefixes ending anywhere in it."""
    table, ids = _edge_inputs(2048, 1, 50_001, seed=offset, dev=dev)
    view = ids[offset:]
    assert not kernels.card_plan_for(table, view).aligned_ids
    _check_gather(table, view)
    for q in (1, 4097, view.numel()):
        got = kernels.gather_rows_dim1_cuda(table, view, head_rows=300,
                                            head_prefix=q)
        want = kernels.gather_rows_dim1_plain(table.cpu(), view.cpu(),
                                              head_rows=300, head_prefix=q)
        assert torch.equal(_bits(got.cpu()), _bits(want))


@pytest.mark.parametrize("q", [1, 2049, 4096, 30_001, 50_000])
def test_gather_dim1_head_prefix_in_one_launch(dev, q):
    """The fused head-prefix read: q not a multiple of 4, q = B, ids >= H
    inside the prefix reading zero; one launch, the bits of the plain
    version and of the JAX package's two calls and concatenation."""
    R, H, B = 47_236, 2048, 50_000
    table, ids = _edge_inputs(R, 1, B, seed=q, dev=dev)
    ids[:q] = torch.where(ids[:q] >= 0, ids[:q] % (H + 40), ids[:q])
    ids[q // 2] = H  # just past the head, inside the prefix
    kernels.reset_launch_counts()
    got = kernels.gather_rows_dim1_cuda(table, ids, head_rows=H,
                                        head_prefix=q)
    assert kernels.launch_counts()["gather_rows_dim1"] == 1
    want = kernels.gather_rows_dim1_plain(table, ids, head_rows=H,
                                          head_prefix=q)
    assert torch.equal(_bits(got), _bits(want))
    two = torch.cat([kernels.gather_rows_plain(table[:H], ids[:q]),
                     kernels.gather_rows_plain(table, ids[q:])])
    assert torch.equal(_bits(got), _bits(two))
    past = (ids[:q] >= H)
    assert past.any() and not _bits(got[:q][past]).any()


def test_gather_rows_refuses_a_scalar_table(dev):
    """An (R, 1) table is K5's: K1's wrapper refuses it, launching nothing,
    and ``ops.gather_rows`` sends it to K5."""
    table, ids = _edge_inputs(300, 1, 1001, seed=6, dev=dev)
    kernels.reset_launch_counts()
    with pytest.raises(ValueError, match="K5"):
        kernels.gather_rows_cuda(table, ids)
    assert not any(kernels.launch_counts().values())
    got = tops.gather_rows(table, ids)
    assert kernels.launch_counts()["gather_rows_dim1"] == 1
    assert torch.equal(_bits(got), _bits(kernels.gather_rows_plain(table,
                                                                   ids)))


@pytest.mark.parametrize("bad", ["width", "vec", "blocks", "bits",
                                 "aligned_ids"])
def test_gathers_refuse_a_plan_they_cannot_run(dev, bad):
    table, ids = _edge_inputs(300, 10, 1001, seed=4, dev=dev)
    t1, ids1 = table[:, :1].contiguous(), ids[1:]
    plan = kernels.card_plan_for(table, ids)
    plan1 = kernels.card_plan_for(t1, ids1)
    fix = {"width": (plan._replace(width=11), None),
           "vec": (plan._replace(vec=4), None),
           "blocks": (plan._replace(blocks=0), plan1._replace(blocks=0)),
           "bits": (plan._replace(index_bits=16), None),
           "aligned_ids": (None, plan1._replace(aligned_ids=True))}[bad]
    kernels.reset_launch_counts()
    if fix[0] is not None:
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.gather_rows_cuda(table, ids, plan=fix[0])
    if fix[1] is not None:
        with pytest.raises(RuntimeError, match="CUDA error"):
            kernels.gather_rows_dim1_cuda(t1, ids1, head_rows=100,
                                          head_prefix=10, plan=fix[1])
    assert not any(kernels.launch_counts().values())


# word2vec at text8 width: vocab 50,000, dim 100, the block path's pulls
# (8,197 block rows; 49,182 with the negatives) and its mean pushes'
# sum-and-count scatters at D = 101, Zipf ids as synthetic_corpus draws them.
W2V_V, W2V_D = 50_000, 100
W2V_BATCHES = [8_197, 49_182]


def _w2v_ids(B, seed, dev):
    rng = np.random.default_rng(seed)
    pop = 1.0 / np.arange(1, W2V_V + 1)
    ids = rng.choice(W2V_V, B, p=pop / pop.sum()).astype(np.int32)
    ids[::97] = -1
    ids[13::101] = W2V_V + np.arange(len(ids[13::101])) % 7
    return torch.from_numpy(ids).to(dev)


@pytest.mark.parametrize("B", W2V_BATCHES)
def test_w2v_pull_bit_equal_to_plain(dev, B):
    rng = np.random.default_rng(B)
    table = torch.from_numpy(rng.normal(0, 0.05, (W2V_V, W2V_D)).astype(
        np.float32)).to(dev)
    ids = _w2v_ids(B, B + 1, dev)
    got = kernels.gather_rows_cuda(table, ids)
    assert torch.equal(_bits(got), _bits(kernels.gather_rows_plain(table,
                                                                   ids)))


@pytest.mark.parametrize("B", W2V_BATCHES)
def test_w2v_mean_push_scatter(dev, B):
    """The mean push's scatter into zeros at D = 101 (404-byte rows, the
    last column the count): deterministic, within the float32 bound of the
    plain version, and exact on sixteenths."""
    rng = np.random.default_rng(B + 2)
    ids = _w2v_ids(B, B + 3, dev)
    deltas = torch.from_numpy(rng.normal(0, 0.01, (B, W2V_D + 1)).astype(
        np.float32)).to(dev)
    deltas[:, -1] = 1.0
    acc = torch.zeros((W2V_V, W2V_D + 1), device=dev)
    got = kernels.scatter_add_cuda_(acc.clone(), ids, deltas)
    again = kernels.scatter_add_cuda_(acc.clone(), ids, deltas)
    plain = kernels.scatter_add_plain(acc.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert torch.equal(got[:, -1], plain[:, -1])  # counts: exact
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(acc, ids, deltas)).all())
    ed = _sixteenths(deltas * 32)
    assert torch.equal(kernels.scatter_add_cuda_(acc.clone(), ids,
                                                 ed).double(),
                       _exact_sum(acc, ids, ed))


def test_w2v_draws_on_the_card_equal_the_cpus(dev):
    """word2vec's draws are a hash of seeds and counters: the negatives,
    the plan's keep mask (so its compacted stream) and its half-windows are
    the same on the card as on the CPU."""
    from fps_tpu_torch.models import word2vec as tw2v
    from fps_tpu_torch.parallel.mesh import make_ps_mesh
    from fps_tpu_torch.utils.datasets import synthetic_corpus

    tokens = synthetic_corpus(2000, 50_000, seed=1)
    uni = np.bincount(tokens, minlength=2000).astype(np.float64)
    cfg = tw2v.W2VConfig(vocab_size=2000, dim=8, subsample_t=1e-3)
    worker = tw2v.Word2VecBlockWorker(cfg, uni, 1024)
    cpu = torch.device("cpu")
    for seed in (0, 12345, 2**62 + 7):
        assert torch.equal(worker._draw_negatives(seed, (1029, 5), dev).cpu(),
                           worker._draw_negatives(seed, (1029, 5), cpu))
    for mode in ("block", "pairs"):
        got = {}
        for where in (dev, cpu):
            plan = tw2v.Word2VecDevicePlan(
                tokens, uni, cfg, make_ps_mesh(device=where), num_workers=1,
                block_len=1024, seed=3, mode=mode)
            args = plan.epoch_args(1)
            got[where.type] = dict(
                plan.call_batches(args, 0, plan.steps_per_epoch),
                compacted=args["compacted"], kept=args["kept"])
        for k, v in got["cpu"].items():
            assert torch.equal(got["cuda"][k].cpu(), v), k


# ---------------------------------------------------------------------------
# iALS's normal-equation push (K2 at D = 256) and the w2v sketch tap's stack
# (K4 at 81,920 rows).
# ---------------------------------------------------------------------------

def test_ials_a_push_one_id_owns_every_push(dev):
    """K2 at iALS's D = rank^2 = 256: one solved id owns all 65,536 pushes
    of a step (its 16 column chunks a tile each sum the whole run). On
    sixteenths the row equals the float64 sum bit for bit; the rest stay."""
    rng = np.random.default_rng(21)
    R, D, B = 32_768, 256, 65_536
    table = _sixteenths(torch.from_numpy(
        rng.normal(0, 1, (R, D)).astype(np.float32)))
    deltas = _sixteenths(torch.from_numpy(
        rng.normal(0, 0.05, (B, D)).astype(np.float32)))
    ids = torch.full((B,), 12_345, dtype=torch.int32)
    got = kernels.scatter_add_cuda_(table.to(dev), ids.to(dev),
                                    deltas.to(dev)).cpu()
    assert torch.equal(got.double(), _exact_sum(table, ids, deltas))
    assert torch.equal(torch.cat([got[:12_345], got[12_346:]]),
                       torch.cat([table[:12_345], table[12_346:]]))
    again = kernels.scatter_add_cuda_(table.to(dev), ids.to(dev),
                                      deltas.to(dev)).cpu()
    assert torch.equal(got, again)


@pytest.mark.parametrize("B", [1, 127, 129, 65_536 - 1, 65_536 + 77])
def test_ials_a_push_batch_not_a_multiple_of_the_tile(dev, B):
    """K2 at D = 256 with a batch that is not a multiple of its 128-position
    sum tile (nor of the sort's 4,096): within the float32 bound of the
    plain version, exact on sixteenths, the same bits twice."""
    table, ids, deltas = _inputs(16_384, 256, B, seed=B, dev=dev)
    got = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    again = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    plain = kernels.scatter_add_plain(table.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())
    et, ed = _sixteenths(table), _sixteenths(deltas)
    exact = kernels.scatter_add_cuda_(et.clone(), ids, ed)
    assert torch.equal(exact.double(), _exact_sum(et, ids, ed))


def test_sketch_stack_push_every_item_dropped(dev):
    """K4 on the w2v sketch tap's stack, 16 probes x 5 x 1,024 = 81,920 rows
    (two row tiles, so the bucket pass runs), 409,600 items a block step,
    every one dropped (-1 and >= R): the stack is left bit for bit."""
    R, B = 16 * 5 * 1024, 409_600
    rng = np.random.default_rng(22)
    table = torch.from_numpy(rng.normal(0, 1, (R, 1)).astype(np.float32))
    ids = np.where(rng.random(B) < 0.5, -1,
                   R + rng.integers(0, 1000, B)).astype(np.int32)
    deltas = torch.from_numpy(rng.normal(0, 1, (B, 1)).astype(np.float32))
    assert kernels.card_dim1_plan(dev, B, R).buckets > 1
    got = kernels.scatter_add_dim1_cuda_(table.to(dev),
                                         torch.from_numpy(ids).to(dev),
                                         deltas.to(dev)).cpu()
    assert torch.equal(_bits(got), _bits(table))


def test_sketches_and_top_k_on_the_card_equal_the_cpus(dev):
    """The sketch hashes (int64 masked to 32 bits), the K4 stack update of
    the w2v tap (±1 sums of 0/1 weights: exact in any order) and the top-k
    order on exact ties are the same on the card as on the CPU."""
    from fps_tpu_torch import sketch as tsk
    from fps_tpu_torch.models import recommendation as trec
    from fps_tpu_torch.models import word2vec as tw2v

    rng = np.random.default_rng(23)
    cpu = torch.device("cpu")
    ids = rng.integers(-2**31, 2**31 - 1, 5000).astype(np.int32)
    spec = tsk.TugOfWarSpec(5, 1024, 3)
    for where in (dev, cpu):
        a1, b1, a2, b2 = spec.constants(where)
        t = torch.from_numpy(ids).to(where)
        got = (tsk._bucket(t, a1, b1, 1024).cpu(), tsk._sign(t, a2, b2).cpu())
        if where == cpu:
            assert torch.equal(got[0], want[0]) and torch.equal(got[1],
                                                                 want[1])
        want = got
    batch = {"center": rng.integers(0, 50, 81_920).astype(np.int32),
             "context": rng.integers(0, 50, 81_920).astype(np.int32),
             "weight": rng.integers(0, 2, 81_920).astype(np.float32)}
    tap = tw2v.cooccurrence_sketch_tap(spec, np.arange(16, dtype=np.int32))
    stacks = [tap(None, {k: torch.from_numpy(v).to(where)
                         for k, v in batch.items()}, None, 0).cpu()
              for where in (dev, cpu)]
    assert torch.equal(stacks[0], stacks[1])
    table = torch.from_numpy(np.repeat(rng.integers(-3, 4, (50, 4)), 2,
                                       0).astype(np.float32))
    q = torch.from_numpy(rng.integers(-2, 3, (7, 4)).astype(np.float32))
    ranked = []
    for where in (dev, cpu):
        s, i = trec._score_and_local_topk(table.to(where), q.to(where),
                                          shard=0, num_shards=1, num_ids=100,
                                          n=30)
        ranked.append((s.cpu(), i.cpu()))
    assert torch.equal(ranked[0][1], ranked[1][1])
    assert torch.equal(ranked[0][0], ranked[1][0])


# ---------------------------------------------------------------------------
# The host pipeline: chunks placed on the prefetcher's side stream.
# ---------------------------------------------------------------------------

def _pipeline_chunks(n_chunks=50):
    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    data = synthetic_ratings(500, 300, n_chunks * 2 * 64, seed=2)
    chunks = list(epoch_chunks(data, num_workers=1, local_batch=64,
                               steps_per_chunk=2, route_key="user", seed=1))
    assert len(chunks) == n_chunks
    return chunks


def _held_mf_stream(dev, prefetch, chunks, **fit_kw):
    """Small MF over ``chunks`` with ``prefetch``; a step tap holds the
    compute stream about 10 ms at each chunk's first step, so the card runs
    far behind the host and a chunk's memory, if it went back to the pool
    before its steps read it, would be reused by a later copy."""
    import dataclasses

    from fps_tpu_torch import MFConfig, make_ps_mesh, online_mf

    trainer, _ = online_mf(make_ps_mesh(device=dev),
                           MFConfig(num_users=500, num_items=300, rank=10,
                                    learning_rate=0.05), combine="mean")

    def hold(tables, batch, local_state, t):
        if t == 0:
            torch.cuda._sleep(20_000_000)
        return {}

    trainer.config = dataclasses.replace(
        trainer.config, prefetch=prefetch, step_tap=hold,
        metrics_drain_every=0)
    tables, local = trainer.init_state(0)
    out = trainer.fit_stream(tables, local, iter(chunks), 1, **fit_kw)
    torch.cuda.synchronize()
    return out


def _no_prefetch_threads():
    import threading

    return not any(t.name.startswith("fps-prefetch")
                   for t in threading.enumerate())


def test_side_stream_placement_with_the_compute_stream_held(dev):
    """50 chunks placed on the side stream at depth 1 while the compute
    stream is held give the tables of synchronous placement bit for bit:
    the compute stream waits on each chunk's copy event, and each chunk's
    tensors are marked as used on it (``record_stream``)."""
    chunks = _pipeline_chunks()
    want = _held_mf_stream(dev, 0, chunks)
    got = _held_mf_stream(dev, 1, chunks)
    assert _no_prefetch_threads()
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k].numpy(), want[0][k].numpy(),
                                      k)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    for g, w in zip(got[2], want[2]):
        for k in ("se", "n"):
            np.testing.assert_array_equal(g[k], w[k])


def test_cuda_error_in_the_worker_copy_reraises_in_fit_stream(dev):
    """A copy that fails on the card (here the allocation of 512 GiB on the
    card for a pinned column of one value expanded to 2^37) raises on the
    worker thread and re-raises in ``fit_stream`` at its chunk's position;
    nothing falls back."""
    chunks = _pipeline_chunks()[:3]
    column = torch.zeros((), pin_memory=True).expand(2**37)
    assert column.is_pinned()
    bad = dict(chunks[1], rating=column)
    seen = []
    with pytest.raises(RuntimeError, match="out of memory"):
        _held_mf_stream(dev, 2, [chunks[0], bad, chunks[2]],
                        on_chunk=lambda i, m: seen.append(i))
    assert seen == [0]
    assert _no_prefetch_threads()


def _device_source_stream(dev, prefetch, compute):
    """Small MF through ``fit_stream`` at ``prefetch`` over a device-resident
    source: the epoch plan's chunks (``DeviceEpochPlan.chunk``, what
    ``device_epoch_chunks`` yields; the epoch's shuffle drawn beforehand,
    so that the source's first work on the card reads the dataset). The
    dataset's columns are zeroed and made ready, then the data is copied
    back on the compute stream behind a held kernel just before the stream
    starts. The compute stream is the default stream, or one from the pool
    (``compute="pool"``), which no other stream waits for implicitly."""
    import contextlib
    import dataclasses

    from fps_tpu_torch import MFConfig, make_ps_mesh, online_mf
    from fps_tpu_torch.core.device_ingest import DeviceDataset, DeviceEpochPlan
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    with (torch.cuda.stream(torch.cuda.Stream(dev)) if compute == "pool"
          else contextlib.nullcontext()):
        mesh = make_ps_mesh(device=dev)
        trainer, _ = online_mf(mesh, MFConfig(num_users=500, num_items=300,
                                              rank=10, learning_rate=0.05),
                               combine="mean")
        trainer.config = dataclasses.replace(trainer.config,
                                             prefetch=prefetch)
        ds = DeviceDataset(mesh, synthetic_ratings(500, 300, 20 * 2 * 64,
                                                   seed=2))
        plan = DeviceEpochPlan(ds, num_workers=1, local_batch=64,
                               route_key="user", seed=1)
        args = plan.epoch_args(0)
        tables, local = trainer.init_state(0)
        saved = {k: v.clone() for k, v in ds.columns.items()}
        for v in ds.columns.values():
            v.zero_()
        torch.cuda.synchronize()
        torch.cuda._sleep(200_000_000)
        for k, v in ds.columns.items():
            v.copy_(saved[k])
        chunks = (plan.chunk(args, start, 2)
                  for start in range(0, plan.steps_per_epoch, 2))
        out = trainer.fit_stream(tables, local, chunks, 1)
        torch.cuda.synchronize()
    return out


@pytest.mark.parametrize("compute", ["default", "pool"])
def test_device_resident_source_waits_for_the_compute_stream(dev, compute):
    """A device-resident source read on the prefetcher's side stream sees
    what the compute stream wrote before the stream began, however far
    behind the card runs: tables, local state and metrics at prefetch 2
    equal those at prefetch 0 bit for bit."""
    got = _device_source_stream(dev, 2, compute)
    want = _device_source_stream(dev, 0, compute)
    assert _no_prefetch_threads()
    for k in want[0]:
        np.testing.assert_array_equal(got[0][k].numpy(), want[0][k].numpy(),
                                      k)
    np.testing.assert_array_equal(got[1].numpy(), want[1].numpy())
    assert len(got[2]) == len(want[2])
    for g, w in zip(got[2], want[2]):
        for k in ("se", "n"):
            np.testing.assert_array_equal(g[k], w[k])
