"""The compacted cold routes of the port (``TableSpec.cold_budget``) against
the JAX package's, and the oracles of ``tests/test_cold_route.py``.

With a partial hot head on the gathered route, a chunk that the host
certifier proves to fit (every ``(step, worker)`` slice has no more cold
ids than the lane) takes the compacted lanes: its cold ids and deltas are
packed in order into a ``cold_budget``-wide lane before the collectives.
That is exact: the tables and metrics are the static route's
(``cold_budget = 0``) bit for bit. A chunk that does not fit, that no
certification stream covers, or that already lies on the device takes the
static route. Which route a chunk took is counted by a spy on
``compact_cold`` (the JAX package's recorder counters wait for ROADMAP.md
Queue 1 item 9, and its program-size comparison by lowered HLO for item
10).
"""

from __future__ import annotations

import dataclasses

import jax
import numpy as np
import pytest
import torch

import bench
from fps_tpu.core import ingest as jingest

from fps_tpu_torch import MFConfig, online_mf
from fps_tpu_torch.convert import to_numpy
from fps_tpu_torch.core import driver as tdriver
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.utils import datasets as tdatasets

NU, NI, RANK = 48, 32, 4
H = 16  # partial head
ITEM = "item_factors"


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _make_trainer(mesh, *, cold_budget=0, combine="sum", **mf):
    trainer, store = online_mf(
        mesh, MFConfig(num_users=NU, num_items=NI, rank=RANK, **mf),
        combine=combine)
    store.specs[ITEM] = dataclasses.replace(
        store.specs[ITEM], hot_tier=H, dense_collectives=False,
        cold_budget=cold_budget)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=2)
    return trainer, store


def _data(n, *, p_cold, seed=0):
    """Ratings whose item stream is hot-heavy: cold fraction p_cold."""
    rng = np.random.default_rng(seed)
    item = np.where(rng.random(n) < p_cold,
                    rng.integers(H, NI, n),
                    rng.integers(0, H, n)).astype(np.int32)
    return {"user": rng.integers(0, NU, n).astype(np.int32),
            "item": item,
            "rating": rng.normal(0, 1, n).astype(np.float32)}


def _chunks(data, W, *, local_batch=8, spc=4, seed=5, sync_every=None):
    return list(tingest.epoch_chunks(data, num_workers=W,
                                     local_batch=local_batch,
                                     steps_per_chunk=spc, route_key="user",
                                     seed=seed, sync_every=sync_every))


def _compact_spy(monkeypatch):
    """Counts of ``compact_cold``'s calls from the driver (one a worker, a
    tiered table and a step, in the pull and again in the push)."""
    n = []
    real = tstore.compact_cold
    monkeypatch.setattr(tdriver, "compact_cold",
                        lambda *a, **k: n.append(1) or real(*a, **k))
    return n


def _fit(trainer, chunks, seed=1):
    tables, ls = trainer.init_state(0)
    return trainer.fit_stream(tables, ls, iter(chunks), seed)


def _same_run(a, b):
    """Tables, local state and every metric leaf: the same bits. A chunk on
    the compacted lanes also counts ``cold_dropped``, which the static
    route has not; it must be 0."""
    (ta, la, ma), (tb, lb, mb) = a, b
    na, nb = to_numpy(ta), to_numpy(tb)
    assert sorted(na) == sorted(nb)
    for k in na:
        np.testing.assert_array_equal(na[k], nb[k], err_msg=k)
    np.testing.assert_array_equal(la.numpy(), lb.numpy())
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        lx = dict(jax.tree.leaves_with_path(x))
        ly = dict(jax.tree.leaves_with_path(y))
        for leaves, other in ((lx, ly), (ly, lx)):
            for path in set(leaves) - set(other):
                assert path[-1].key == "cold_dropped", path
                assert not leaves[path].any()
        for path in set(lx) & set(ly):
            np.testing.assert_array_equal(lx[path], ly[path],
                                          err_msg=str(path))


def _counts(chunks, W):
    return np.concatenate([
        tingest.per_worker_cold_counts(c["item"], W, hot_head=H).reshape(-1)
        for c in chunks])


# ---------------------------------------------------------------------------
# Units: the lane packer, the host certifier, the bench's generator.
# ---------------------------------------------------------------------------

def test_compact_cold_packs_order_preserving_and_drops_overflow():
    ids = torch.tensor([-1, 5, -1, 9, 3, -1, 7], dtype=torch.int32)
    deltas = torch.arange(14, dtype=torch.float32).reshape(7, 2)
    lane_ids, lane_deltas, pos, over = tstore.compact_cold(ids, deltas,
                                                           budget=4)
    assert lane_ids.tolist() == [5, 9, 3, 7]
    np.testing.assert_array_equal(lane_deltas.numpy(),
                                  deltas.numpy()[[1, 3, 4, 6]])
    assert pos.tolist() == [-1, 0, -1, 1, 2, -1, 3]
    assert int(over) == 0
    lane_ids, none, pos, over = tstore.compact_cold(ids, None, budget=2)
    assert none is None
    assert lane_ids.tolist() == [5, 9]
    assert pos.tolist() == [-1, 0, -1, 1, -1, -1, -1]
    assert int(over) == 2 and over.dtype == torch.int32


@pytest.mark.parametrize("hot_head", [0, 8, 100])
def test_per_worker_cold_counts_match_jax(hot_head):
    rng = np.random.default_rng(hot_head)
    ids = rng.integers(-1, 40, (3, 2, 24)).astype(np.int32)
    got = tingest.per_worker_cold_counts(ids, 4, hot_head=hot_head)
    want = jingest.per_worker_cold_counts(ids, 4, hot_head=hot_head)
    np.testing.assert_array_equal(got, want)
    assert got.shape == (6, 4)
    ids = np.array([[0, 1, 9, 2, 8, 7], [9, 9, 9, -1, 0, 8]])
    np.testing.assert_array_equal(
        tingest.per_worker_cold_counts(ids, 2, hot_head=8), [[1, 1], [3, 1]])
    with pytest.raises(ValueError, match="divisible"):
        tingest.per_worker_cold_counts(ids, 4)


def test_zipf_ratings_is_the_bench_generator():
    got = tdatasets.zipf_ratings(64, 48, 500, seed=3)
    want = bench._zipf_ratings(64, 48, 500, seed=3)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
        assert got[k].dtype == want[k].dtype


# ---------------------------------------------------------------------------
# Resolution: where the compacted route engages.
# ---------------------------------------------------------------------------

def test_cold_compact_resolution_policy():
    mesh = tmesh.make_ps_mesh(4, 1, device="cpu")
    trainer, store = _make_trainer(mesh, cold_budget=4)
    assert trainer._cold_compact_map() == {ITEM: 4}
    # Full replication: no cold route to compact.
    store.specs[ITEM] = dataclasses.replace(store.specs[ITEM], hot_tier=NI)
    assert trainer._cold_compact_map() == {}
    # The dense route: table-sized collectives whatever the lane.
    store.specs[ITEM] = dataclasses.replace(store.specs[ITEM], hot_tier=H,
                                            dense_collectives=True)
    assert trainer._cold_compact_map() == {}
    # The exact mode: nothing engages.
    trainer2, _ = _make_trainer(mesh, cold_budget=4)
    trainer2.config = dataclasses.replace(trainer2.config, hot_sync_every=1)
    assert trainer2._cold_compact_map() == {}
    # The certifier: a missing stream overflows every compacted table.
    assert trainer._certify_cold(None) == (True, [])
    store.specs[ITEM] = dataclasses.replace(store.specs[ITEM],
                                            dense_collectives=False)
    assert trainer._certify_cold(None) == (False, [ITEM])
    # 4 workers of 5 ids a step: worker 0 has 4 cold ids, then 5.
    ok = {ITEM: np.array([[20, 21, 22, 23, 1] + [0] * 15])}
    assert trainer._certify_cold(ok) == (True, [])
    big = {ITEM: np.array([[20, 21, 22, 23, 24] + [0] * 15])}
    assert trainer._certify_cold(big) == (False, [ITEM])


# ---------------------------------------------------------------------------
# The exactness and fallback contracts.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("D,S", [(1, 4), (2, 4)])
def test_compacted_chunks_match_static_and_overflow_falls_back(
        monkeypatch, D, S, combine):
    """One stream, three trainers: static (``cold_budget = 0``), a lane
    every chunk fits, and a lane of 1 that every full chunk overflows. The
    fitting arm takes the compacted lanes on every chunk, the overflowing
    arm the static route, and both equal the static run bit for bit, with
    nothing dropped."""
    mesh = tmesh.make_ps_mesh(S, D, device="cpu")
    W = D * S
    chunks = _chunks(_data(W * 8 * 4 * 3, p_cold=0.2), W)
    counts = _counts(chunks, W)
    assert counts.max() > 1  # the stream has cold traffic
    runs = {}
    for label, C in (("static", 0), ("fits", int(counts.max())),
                     ("overflows", 1)):
        trainer, _ = _make_trainer(mesh, cold_budget=C, combine=combine)
        n = _compact_spy(monkeypatch)
        runs[label] = _fit(trainer, chunks)
        monkeypatch.undo()
        runs[label + "_calls"] = len(n)
    steps = sum(c["item"].shape[0] for c in chunks)
    assert runs["static_calls"] == 0
    # A pull and a push a worker and a step, on every chunk.
    assert runs["fits_calls"] == 2 * W * steps
    # Only a chunk whose every slice has at most one cold id fits a lane
    # of 1 (none here but, possibly, the zero-weight padded last chunk).
    fit1 = [int(_counts([c], W).max()) <= 1 for c in chunks]
    assert runs["overflows_calls"] == 2 * W * sum(
        c["item"].shape[0] for c, f in zip(chunks, fit1) if f)
    assert sum(fit1) <= 1
    for label in ("fits", "overflows"):
        _same_run(runs[label], runs["static"])
        dropped = [m["hot_tier"][ITEM].get("cold_dropped")
                   for m in runs[label][2]]
        assert all(d is None or not d.any() for d in dropped)
    assert all("cold_dropped" in m["hot_tier"][ITEM]
               for m in runs["fits"][2])


def test_compacted_matches_jax_within_bound():
    """The compacted program against the JAX package's at (2, 4): the same
    tables within 1e-5 of the largest value, the hit counts and
    ``cold_dropped`` exactly."""
    from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
    from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
    from fps_tpu.parallel import mesh as jmesh

    from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax

    W = 8
    chunks = _chunks(_data(W * 8 * 4 * 2, p_cold=0.2, seed=4), W)
    lane = int(_counts(chunks, W).max())
    jtr, jst = jonline_mf(jmesh.make_ps_mesh(num_shards=4, num_data=2,
                                             devices=jax.devices()[:8]),
                          JMFConfig(num_users=NU, num_items=NI, rank=RANK))
    jst.specs[ITEM] = dataclasses.replace(jst.specs[ITEM], hot_tier=H,
                                          dense_collectives=False,
                                          cold_budget=lane)
    jtr.config = dataclasses.replace(jtr.config, hot_sync_every=2)
    ttr, tst = _make_trainer(tmesh.make_ps_mesh(4, 2, device="cpu"),
                             cold_budget=lane)
    jt, jl = jtr.init_state(jax.random.key(0))
    tt = tables_from_jax(tst, {k: np.asarray(v) for k, v in jt.items()})
    tl = local_state_from_jax(ttr.logic, np.asarray(jl), mesh=ttr.mesh)
    for i, c in enumerate(chunks):
        jt, jl, jm = jtr.run_chunk(jt, jl, c, jax.random.key(i))
        tt, tl, tm = ttr.run_chunk(tt, tl, c, i)
        tm = to_numpy(tm)
        for k, v in jm["hot_tier"][ITEM].items():
            if k != "delta_sq":
                np.testing.assert_array_equal(tm["hot_tier"][ITEM][k],
                                              np.asarray(v), err_msg=k)
        got = to_numpy(tt)
        for k, v in jt.items():
            want = np.asarray(v)
            np.testing.assert_allclose(got[k], want, rtol=0,
                                       atol=1e-5 * max(1.0,
                                                       np.abs(want).max()))


def test_mixed_stream_takes_both_routes(monkeypatch):
    """A stream of fitting and overflowing chunks takes the compacted lanes
    on the first and the static route on the others, and still equals the
    all-static run bit for bit."""
    mesh = tmesh.make_ps_mesh(4, 1, device="cpu")
    W = 4
    hot = _data(W * 8 * 4, p_cold=0.0, seed=1)
    cold = _data(W * 8 * 4, p_cold=0.9, seed=2)
    data = {k: np.concatenate([hot[k], cold[k]]) for k in hot}
    # seed=None keeps the stream's order: the hot half lands (mostly) in
    # the first chunk.
    chunks = _chunks(data, W, seed=None)
    per_chunk = [int(_counts([c], W).max()) for c in chunks]
    lane = per_chunk[0]
    assert max(per_chunk[1:]) > lane
    trainer, _ = _make_trainer(mesh, cold_budget=lane)
    n = _compact_spy(monkeypatch)
    mixed = _fit(trainer, chunks)
    monkeypatch.undo()
    fits = [c <= lane for c in per_chunk]
    assert 1 <= sum(fits) < len(chunks)
    assert len(n) == 2 * W * sum(c["item"].shape[0]
                                 for c, f in zip(chunks, fits) if f)
    static, _ = _make_trainer(mesh, cold_budget=0)
    _same_run(mixed, _fit(static, chunks))


def test_uncertifiable_logic_stays_static(monkeypatch):
    """MF with negative sampling draws ids in ``prepare``: its
    ``pulled_ids_host`` is ``None``, every chunk takes the static route,
    and the run is the static run."""
    mesh = tmesh.make_ps_mesh(4, 1, device="cpu")
    trainer, _ = _make_trainer(mesh, cold_budget=8, negative_samples=1)
    assert trainer.logic.pulled_ids_host(
        {"item": np.zeros(4, np.int32)}) is None
    chunks = _chunks(_data(4 * 8 * 4, p_cold=0.1), 4)
    n = _compact_spy(monkeypatch)
    got = _fit(trainer, chunks)
    monkeypatch.undo()
    assert not n
    static, _ = _make_trainer(mesh, cold_budget=0, negative_samples=1)
    _same_run(got, _fit(static, chunks))
    assert np.isfinite(got[0][ITEM].numpy()).all()


def test_device_resident_chunk_stays_static(monkeypatch):
    """A chunk whose columns already lie on the device cannot be certified
    without a host read: it takes the static route."""
    mesh = tmesh.make_ps_mesh(4, 1, device="cpu")
    chunks = _chunks(_data(4 * 8 * 4, p_cold=0.1), 4)
    lane = int(_counts(chunks, 4).max())
    trainer, _ = _make_trainer(mesh, cold_budget=lane)
    on_device = [{k: torch.from_numpy(v) for k, v in c.items()}
                 for c in chunks]
    n = _compact_spy(monkeypatch)
    got = _fit(trainer, on_device)
    monkeypatch.undo()
    assert not n
    host, _ = _make_trainer(mesh, cold_budget=lane)
    _same_run(got, _fit(host, chunks))


@pytest.mark.parametrize("sync_every", [None, 2], ids=["sync", "ssp"])
def test_prefetch_gives_the_same_bits_and_routes(monkeypatch, sync_every):
    """With the pipeline on, the worker thread keeps each chunk's
    certification stream beside its placement, so every chunk takes the
    same route as without it, and the run is the same bits."""
    mesh = tmesh.make_ps_mesh(4, 2, device="cpu")
    W = 8
    chunks = _chunks(_data(W * 8 * 4 * 2, p_cold=0.1), W,
                     sync_every=sync_every)
    lane = int(_counts(chunks, W).max())
    runs = []
    for prefetch in (0, 2):
        trainer, _ = _make_trainer(mesh, cold_budget=lane)
        trainer.config = dataclasses.replace(trainer.config,
                                             prefetch=prefetch,
                                             sync_every=sync_every)
        n = _compact_spy(monkeypatch)
        runs.append((_fit(trainer, chunks), len(n)))
        monkeypatch.undo()
    assert runs[0][1] == runs[1][1] > 0
    _same_run(runs[0][0], runs[1][0])
