"""The port's CUDA kernels on the card, at shapes the main paths do not give.

``chip_smoke.py`` holds the kernels against their plain versions at the MF,
PA and logistic-regression shapes; these tests add the edges: odd and wide
rows, empty batches, tables of one row, every id dropped, one id owning the
whole batch, odd batch lengths against the scalar gather's 16-byte path, the
head view of a scalar table, K3's head at and around its row-tile edges, the
hot/cold split and the whole-table route, and the wrappers' refusals. Every
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
    table, ids, _ = _inputs(R, D, B, seed=R + D, dev=dev)
    got = kernels.gather_rows_cuda(table, ids)
    assert got.shape == (B, D)
    assert torch.equal(got, kernels.gather_rows_plain(table, ids))


@pytest.mark.parametrize("R,D,B", SHAPES)
def test_scatter_kernel_deterministic_and_within_bound(dev, R, D, B):
    table, ids, deltas = _inputs(R, D, B, seed=R * D + 1, dev=dev)
    got = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    again = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    plain = kernels.scatter_add_plain(table.clone(), ids, deltas)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _sum_bound(table, ids, deltas)).all())


def test_scatter_one_id_owns_the_batch(dev):
    """The longest run there is: the kernel adds it in batch order, the
    order the CPU's index_add_ folds it in, so the bits match the CPU."""
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 1, (8, 10)).astype(np.float32))
    deltas = torch.from_numpy(rng.normal(0, 1, (5000, 10)).astype(np.float32))
    ids = torch.full((5000,), 3, dtype=torch.int32)
    want = kernels.scatter_add_plain(table.clone(), ids, deltas)
    got = kernels.scatter_add_cuda_(table.to(dev), ids.to(dev),
                                    deltas.to(dev))
    assert torch.equal(got.cpu(), want)


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
    with pytest.raises(ValueError):
        kernels.scatter_add_cuda_(table, ids, deltas)
    if bad != "deltas_shape":
        with pytest.raises(ValueError):
            kernels.gather_rows_cuda(table, ids)
    assert not any(kernels.launch_counts().values())


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
    """One run across every tile: the carry pass chains all the tiles'
    partials. The tree order is not the CPU's, so the bound, not bits."""
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
    """Runs that start, end or cross exactly at the 1,024-position tile
    edges, with dropped ids at both ends of the sorted order."""
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
    """The head-prefix route's calls: the kernels on ``table[:H]``, a view
    into the table, then on the whole table."""
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
                                       "gather_rows_dim1": 2,
                                       "scatter_add_dim1": 2,
                                       "scatter_add_packed": 0}
    assert torch.equal(got_g.cpu(), want_g)
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


# ---------------------------------------------------------------------------
# K3: the head scatter-add of the hot/cold push split.
# ---------------------------------------------------------------------------

def _head_bound(table, ids, deltas, H):
    """The float32 summation bound over the head rows' pushes only."""
    head = (ids >= 0) & (ids < H)
    return _sum_bound(table, torch.where(head, ids, -1), deltas)


def _sixteenths(x):
    """``x`` rounded to a multiple of 1/16 within [-1/2, 1/2]: float32 sums
    of up to 2^20 such terms are exact in any order."""
    return torch.round(x.clamp(-2, 2) * 4) / 16


def _exact_head_sum(table, ids, deltas, H):
    head = (ids >= 0) & (ids < min(H, table.shape[0]))
    return table.double().index_add_(0, ids[head].long(),
                                     deltas[head].double())


def _check_packed(table, ids, deltas, H):
    """Deterministic, within the float32 bound of the plain version, rows
    past the head untouched; and on sixteenths of the same inputs equal to
    the exact float64 sum (the bound alone grows past a hot row's sum)."""
    got = kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, H)
    again = kernels.scatter_add_packed_cuda_(table.clone(), ids, deltas, H)
    plain = kernels.scatter_add_packed_plain(table.clone(), ids, deltas, H)
    assert torch.equal(got, again)
    assert bool(((got.double() - plain.double()).abs()
                 <= _head_bound(table, ids, deltas, H)).all())
    # Rows past the head are untouched.
    assert torch.equal(got[H:], table[H:])
    et, ed = _sixteenths(table), _sixteenths(deltas)
    exact = kernels.scatter_add_packed_cuda_(et.clone(), ids, ed, H)
    assert torch.equal(exact.double(), _exact_head_sum(et, ids, ed, H))
    return got


# (R, D, B, H): R = 1, an empty batch, each D from 1 to 200, and the head at
# the edge of a row tile (8 rows a thread; 2,048 / 680 / 184 / 96 / 64 rows a
# tile for D = 1 / 3 / 11 / 20 / >= 32).
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


@pytest.mark.parametrize("D", [3, 20])
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
