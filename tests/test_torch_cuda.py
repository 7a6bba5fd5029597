"""The port's CUDA kernels on the card, at shapes the main paths do not give.

``chip_smoke.py`` holds the kernels against their plain versions at the MF,
PA and logistic-regression shapes; these tests add the edges: odd and wide
rows, empty batches, tables of one row, every id dropped, one id owning the
whole batch, odd batch lengths against the scalar gather's 16-byte path, the
head view of a scalar table, and the wrappers' refusals. Every test here needs a CUDA device and carries the
``cuda`` marker; without a card each one skips. On the card:

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
                                       "scatter_add_dim1": 0}
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
                                       "scatter_add_dim1": 2}
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
                                       "scatter_add_dim1": 1}


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
