"""Rank body of ``tests/test_torch_multiprocess.py``, and the scenarios it
runs on a mesh of either kind.

Usage: python tests/_torch_mp_worker.py <rank> <world> <init_method> <dir>
                                        <bundle> [<timeout seconds>]

Joins ``world`` ranks over gloo at ``init_method`` (a ``file://`` store),
builds each scenario's 8-position mesh from its 4 CPU positions, runs the
bundle's scenarios from the initial state in ``<dir>/init.npz`` and writes
what it read back to ``<dir>/rank<rank>.npz``: every table, the local state
and the metrics (host reads are collectives, so every rank calls them and
writes them), and for the collectives its own positions' results. Imports
torch and the port only, never jax: the test process runs the same
scenario functions on one process's 8-position mesh and the JAX package's
runs, and compares.

Bundles: ``d2s4`` (the four collectives, a pull and pushes at (2, 4),
(1, 8) and (4, 2); MF at (2, 4) through ``run_indexed``, ``fit_stream``
sync and ``fit_stream`` SSP) and ``d1s8`` (at (1, 8), the shard axis across
the ranks: MF through ``run_indexed``, binary PA-I, SSP logistic regression,
the word2vec block worker, an iALS epoch, MF with the collective online
top-k tap and ``recommend_topk``); ``tiered`` (the static hot tier at
(1, 4) and (2, 4): MF with a partial head and its certified cold lanes,
sync and SSP, and logistic regression with a partial head, and with the
whole table and an Adagrad hot fold; from the port's own initial state);
``mapped`` (the adaptive tier with re-ranks at every boundary: MF's mapped
head with its cold lanes at (2, 4) through ``fit_stream``, SSP logistic
regression's at (1, 8) through ``run_indexed``; the retierer's hot ids and
counts ride the results); ``megastep`` (``run_megastep`` of MF's mapped
head with its cold lanes, the vote and a forced tick every 2 segments, at
(2, 4) and (1, 8); the tick's hot ids, counter and decayed sketch and the
vote counters ride the results); ``dies`` (rank 1 exits once the mesh is built, and rank 0's next
collective must fail within the timeout).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from fps_tpu_torch import (  # noqa: E402
    DeviceDataset,
    DeviceEpochPlan,
    LogRegConfig,
    MFConfig,
    PAConfig,
    logistic_regression,
    online_mf,
    passive_aggressive,
)
from fps_tpu_torch.convert import (  # noqa: E402
    local_state_from_jax,
    tables_from_jax,
)
from fps_tpu_torch.core import store as tstore  # noqa: E402
from fps_tpu_torch.core.ingest import epoch_chunks, multi_epoch_chunks  # noqa: E402
from fps_tpu_torch.models import ials as tials  # noqa: E402
from fps_tpu_torch.models import recommendation as trec  # noqa: E402
from fps_tpu_torch.models import word2vec as tw2v  # noqa: E402
from fps_tpu_torch.parallel import collectives  # noqa: E402
from fps_tpu_torch.parallel import mesh as tmesh  # noqa: E402
from fps_tpu_torch.utils import datasets as ds  # noqa: E402

BUNDLES = {"d2s4": ("collectives", "mf_indexed_d2s4", "mf_host_sync",
                    "mf_host_ssp"),
           "d1s8": ("mf_indexed_d1s8", "pa", "logreg", "w2v", "ials",
                    "topk"),
           "tiered": ("tiered_mf_d1s4", "tiered_mf_d2s4_ssp",
                      "tiered_lr_d1s4", "tiered_lr_d2s4_fold"),
           "mapped": ("mapped_mf_d2s4", "mapped_lr_d1s8_ssp"),
           "ckpt": ("ckpt_mf_d1s4",),
           "obs": ("obs_mf_d1s4",),
           "megastep": ("megastep_mf_d2s4", "megastep_mf_d1s8")}
# The directory a scenario that saves checkpoints writes under (the ranks
# share theirs; the one-process run has its own).
WHERE = None
COLLECTIVE_SHAPES = [(2, 4), (1, 8), (4, 2)]

# The JAX reference's recipe (tests/test_multiprocess.py).
MF_USERS, MF_ITEMS, MF_N = 57, 31, 2000
MF_CFG = dict(num_users=MF_USERS, num_items=MF_ITEMS, rank=4,
              learning_rate=0.1)
# tests/test_torch_mesh.py's sizes.
PA_NF, PA_NNZ, PA_HEAD = 500, 10, 64
LR_NF = 400
# tests/test_torch_mesh_models.py's.
V, DIM, WIN, NEG, BL = 300, 16, 3, 4, 32
W2V_CFG = dict(vocab_size=V, dim=DIM, window=WIN, negatives=NEG,
               learning_rate=0.05, subsample_t=None)
# tests/test_torch_ials.py's full-mesh case.
IALS_NU, IALS_NI, IALS_RANK = 24, 18, 4
IALS_CFG = dict(alpha=5.0, reg=0.3)
# tests/test_torch_taps.py's online top-k on the mesh.
TOPK_NU, TOPK_NI, TOPK_RANK, TOPK_K, TOPK_EVERY, TOPK_Q, TOPK_T = (
    48, 29, 4, 5, 2, 3, 4)
NUM_IDS, COLL_DIM, COLL_B = 61, 3, 12


def mf_data():
    return ds.synthetic_ratings(MF_USERS, MF_ITEMS, MF_N, seed=0)


def pa_data():
    data = ds.synthetic_sparse_classification(4096, PA_NF, PA_NNZ, seed=9,
                                              noise=0.05)
    return ds.head_sort_slots(data, PA_HEAD)


def lr_data():
    data = ds.synthetic_sparse_classification(4096, LR_NF, 8, seed=7,
                                              noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def w2v_corpus():
    tokens = ds.synthetic_corpus(V, 2400, num_topics=8, seed=2)
    return tokens, np.bincount(tokens, minlength=V).astype(np.float64)


def ials_data():
    return ds.synthetic_implicit(IALS_NU, IALS_NI, 9, rank=2, seed=6)


def topk_data(W):
    return ds.synthetic_ratings(TOPK_NU, TOPK_NI, 8 * TOPK_T * W, seed=0)


def topk_queries():
    rng = np.random.default_rng(1)
    return rng.integers(-2, 3, (9, TOPK_RANK)).astype(np.float32)


class W2VDraws:
    """Half-windows and negatives for each (epoch, step, worker), in rows
    ``(e * T + t) * W + w``, from a numpy seed (the draws of
    ``tests/test_torch_mesh_models.py``)."""

    def __init__(self, epochs, steps, workers, n_neg, seed=9):
        rng = np.random.default_rng(seed)
        rows = epochs * steps * workers
        self.steps, self.workers = steps, workers
        self.half = rng.integers(1, WIN + 1, (rows, BL)).astype(np.int32)
        self.negs = rng.integers(0, V, (rows, n_neg, NEG)).astype(np.int32)


def w2v_plan_class(draws):
    class Plan(tw2v.Word2VecDevicePlan):
        """The port's plan with the draws taken from ``draws``, keyed by
        the global worker index, for this process's workers."""

        def epoch_args(self, epoch):
            return dict(super().epoch_args(epoch), epoch=epoch)

        def _rows(self, args, base):
            row = (args["epoch"] * draws.steps * draws.workers
                   + base // self.block_len)
            return torch.clamp(row, max=len(draws.half) - 1)

        def _halves(self, args, base):
            return torch.from_numpy(draws.half)[self._rows(args, base)]

        def call_batches(self, args, start, steps):
            t = torch.arange(start, start + steps)
            base = (t[:, None] * self.num_workers
                    + torch.arange(*self._own)) * self.block_len
            negs = torch.from_numpy(draws.negs)[self._rows(args, base)]
            return dict(super().call_batches(args, start, steps),
                        negatives=negs.reshape(steps, -1, NEG))
    return Plan


class _NoDrawBlockWorker(tw2v.Word2VecBlockWorker):
    """Takes its negatives from the batch."""

    def prepare(self, batch, key):
        return batch


def w2v_steps(mesh):
    tokens, uni = w2v_corpus()
    return tw2v.Word2VecDevicePlan(
        tokens, uni, tw2v.W2VConfig(**W2V_CFG), mesh,
        num_workers=tmesh.num_workers_of(mesh), block_len=BL, seed=4,
        mode="block").steps_per_epoch


# ---------------------------------------------------------------------------
# Results.
# ---------------------------------------------------------------------------

def _flat(prefix, tree, out):
    if isinstance(tree, dict):
        for k, v in tree.items():
            _flat(f"{prefix}/{k}", v, out)
    else:
        out[prefix] = np.asarray(tree)


def metrics_of(chunks) -> dict:
    """A list of host metrics dicts joined along the step axis."""
    flat = [{} for _ in chunks]
    for f, m in zip(flat, chunks):
        _flat("", m, f)
    return {k[1:]: np.concatenate([f[k] for f in flat]) for k in flat[0]}


def _record(out, name, tables, local_state, metrics):
    """Every table, the local state and the metrics, read back to the host
    (collectives: every rank calls them)."""
    for k, v in tables.items():
        out[f"{name}/table/{k}"] = v.numpy()
    if isinstance(local_state, tmesh.Blocks):
        out[f"{name}/local"] = local_state.numpy()
    for k, v in metrics.items():
        out[f"{name}/metrics/{k}"] = v


# ---------------------------------------------------------------------------
# The scenarios: each ``fn(mesh_of, init, out)``; ``mesh_of(D, S)`` gives
# the (D, S) mesh, ``init`` the initial arrays of tests/..., ``out`` takes
# the results.
# ---------------------------------------------------------------------------

def _mf(mesh, init, key, sync_every=None, **kw):
    trainer, store = online_mf(mesh, MFConfig(**MF_CFG),
                               sync_every=sync_every, **kw)
    tables = tables_from_jax(store, {"item_factors":
                                     init[f"{key}/item_factors"]})
    local = local_state_from_jax(trainer.logic, init[f"{key}/local"],
                                 mesh=mesh)
    return trainer, store, tables, local


def _mf_indexed(mesh_of, init, out, name, D, S):
    mesh = mesh_of(D, S)
    trainer, store, tables, local = _mf(mesh, init, f"mf{D}{S}")
    plan = DeviceEpochPlan(DeviceDataset(mesh, mf_data()),
                           num_workers=D * S, local_batch=32,
                           route_key="user", seed=5)
    tables, local, metrics = trainer.run_indexed(tables, local, plan, 1,
                                                 epochs=2)
    _record(out, name, tables, local, metrics_of(metrics))


def mf_indexed_d2s4(mesh_of, init, out):
    _mf_indexed(mesh_of, init, out, "mf_indexed_d2s4", 2, 4)


def mf_indexed_d1s8(mesh_of, init, out):
    _mf_indexed(mesh_of, init, out, "mf_indexed_d1s8", 1, 8)


def _mf_host(mesh_of, init, out, name, sync_every):
    mesh = mesh_of(2, 4)
    trainer, store, tables, local = _mf(mesh, init, "mf24",
                                        sync_every=sync_every)
    chunks = multi_epoch_chunks(mf_data(), 2, num_workers=8, local_batch=32,
                                steps_per_chunk=4, route_key="user",
                                sync_every=sync_every, seed=5)
    tables, local, metrics = trainer.fit_stream(tables, local, chunks, 1)
    _record(out, name, tables, local, metrics_of(metrics))


def mf_host_sync(mesh_of, init, out):
    _mf_host(mesh_of, init, out, "mf_host_sync", None)


def mf_host_ssp(mesh_of, init, out):
    _mf_host(mesh_of, init, out, "mf_host_ssp", 2)


def _sparse(trainer, store, init, key, chunks, out, name):
    tables = tables_from_jax(store, {k: init[f"{key}/{k}"]
                                     for k in store.specs})
    local, metrics = (), []
    for i, chunk in enumerate(chunks):
        tables, local, m = trainer.run_chunk(tables, local, chunk, i)
        metrics.append({k: v.numpy() for k, v in m.items()})
    _record(out, name, tables, local, metrics_of(metrics))


def pa_kw(q):
    return dict(num_features=PA_NF, hot_features=PA_HEAD, head_prefix_cols=q,
                variant="PA-I", C=1.0)


def pa(mesh_of, init, out):
    data, q = pa_data()
    trainer, store = passive_aggressive(mesh_of(1, 8), PAConfig(**pa_kw(q)))
    chunks = list(epoch_chunks(data, num_workers=8, local_batch=64,
                               steps_per_chunk=2, seed=3))[:3]
    _sparse(trainer, store, init, "pa", chunks, out, "pa")


LR_KW = dict(num_features=LR_NF, learning_rate=0.5, optimizer="sgd")


def logreg(mesh_of, init, out):
    trainer, store = logistic_regression(mesh_of(1, 8), LogRegConfig(**LR_KW),
                                         sync_every=2)
    chunks = list(epoch_chunks(lr_data(), num_workers=8, local_batch=32,
                               steps_per_chunk=2, sync_every=2, seed=3))[:3]
    _sparse(trainer, store, init, "lr", chunks, out, "logreg")


def w2v(mesh_of, init, out):
    """The block worker, one ``run_indexed`` call of one epoch."""
    mesh = mesh_of(1, 8)
    tokens, uni = w2v_corpus()
    cfg = tw2v.W2VConfig(**W2V_CFG)
    trainer, store = tw2v._make_trainer(
        mesh, cfg, _NoDrawBlockWorker(cfg, uni, BL), sync_every=None,
        donate=True, max_steps_per_call=None)
    T = w2v_steps(mesh)
    plan = w2v_plan_class(W2VDraws(1, T, 8, BL + WIN))(
        tokens, uni, cfg, mesh, num_workers=8, block_len=BL, seed=4,
        mode="block")
    tables = tables_from_jax(store, {k: init[f"w2v/{k}"]
                                     for k in store.specs})
    tables, _, metrics = trainer.run_indexed(tables, (), plan, 1)
    _record(out, "w2v", tables, (), metrics_of(metrics))


def ials(mesh_of, init, out):
    solver = tials.IALSSolver(mesh_of(1, 8), tials.IALSConfig(
        IALS_NU, IALS_NI, rank=IALS_RANK, **IALS_CFG))
    solver.store.tables = tables_from_jax(
        solver.store, {k: init[f"ials/{k}"] for k in solver.store.specs})
    chunks = list(tials.interaction_chunks(ials_data(), num_workers=8,
                                           local_batch=4, steps_per_chunk=2,
                                           seed=0))
    solver.epoch(lambda: iter(chunks))
    users, items = solver.factors()
    out["ials/users"], out["ials/items"] = users, items


def topk(mesh_of, init, out):
    """MF (lr 0: frozen tables) with the collective online top-k tap, one
    ``run_chunk`` of 4 steps; then ``recommend_topk`` on its item table."""
    import dataclasses

    from fps_tpu_torch.models import matrix_factorization as tmf

    mesh = mesh_of(1, 8)
    W = 8
    trainer, store = tmf.online_mf(mesh, tmf.MFConfig(
        num_users=TOPK_NU, num_items=TOPK_NI, rank=TOPK_RANK,
        learning_rate=0.0, reg=0.0), donate=False)
    trainer.config = dataclasses.replace(trainer.config, step_tap=(
        trec.make_online_topk_tap(store, tmf.ITEM_TABLE, TOPK_K,
                                  every=TOPK_EVERY,
                                  query_fn=trec.mf_topk_query_fn(W, TOPK_Q))))
    tables = tables_from_jax(store, {tmf.ITEM_TABLE:
                                     init["topk/item_factors"]})
    local = local_state_from_jax(trainer.logic, init["topk/local"], mesh=mesh)
    chunk = next(epoch_chunks(topk_data(W), num_workers=W, local_batch=8,
                              steps_per_chunk=TOPK_T, route_key="user"))
    tables, local, m = trainer.run_chunk(tables, local, chunk, 1)
    metrics = {}
    _flat("", {k: (v.numpy() if isinstance(v, torch.Tensor) else
                   {a: b.numpy() for a, b in v.items()})
               for k, v in m.items()}, metrics)
    _record(out, "topk", tables, local, {k[1:]: v for k, v in
                                         metrics.items()})
    ids, scores = trec.recommend_topk(store, tmf.ITEM_TABLE, topk_queries(),
                                      TOPK_K)
    out["topk/recommend/ids"], out["topk/recommend/scores"] = ids, scores


# ---------------------------------------------------------------------------
# The collectives, a pull and pushes: each position's result.
# ---------------------------------------------------------------------------

def collective_inputs(D, S):
    """Each position's inputs, made from a seed: ``x`` (8, 3) float32 and
    ``n`` (8,) int64 per position, ``a`` (n_axis, 2) for the all_to_all of
    each axis, and the pull / push inputs of tests/test_torch_mesh.py."""
    W = D * S
    rng = np.random.default_rng(10 * D + S)
    rows = tstore.padded_rows(NUM_IDS, S)
    return {
        "x": rng.normal(0, 1, (W, 8, COLL_DIM)).astype(np.float32),
        "n": rng.integers(-5, 5, (W, 8)).astype(np.int64),
        "a_shard": rng.normal(0, 1, (W, S, 2)).astype(np.float32),
        "a_data": rng.normal(0, 1, (W, D, 2)).astype(np.float32),
        "table": rng.normal(0, 1, (rows, COLL_DIM)).astype(np.float32),
        "ids": np.where(np.arange(W * COLL_B) % 7 == 0, -1,
                        rng.zipf(1.3, W * COLL_B) % (rows + 4)).astype(
                            np.int32),
        "deltas": rng.normal(0, 1, (W * COLL_B, COLL_DIM)).astype(
            np.float32),
    }


def collectives_scenario(mesh_of, init, out):
    del init
    for D, S in COLLECTIVE_SHAPES:
        mesh = mesh_of(D, S)
        inp = collective_inputs(D, S)
        own = list(mesh.local)

        def mine(a):
            # Every process passes the global array and keeps its own
            # positions' pieces.
            return list(tmesh.host_to_sharded(
                a.reshape((D * S * a.shape[1],) + a.shape[2:]), mesh))

        x, n = mine(inp["x"]), mine(inp["n"])
        res = {"replicated": tmesh.host_to_replicated(inp["table"], mesh)}
        for axis in (tmesh.SHARD_AXIS, tmesh.DATA_AXIS):
            res[f"all_gather_{axis}"] = collectives.all_gather(mesh, x, axis)
            res[f"all_gather_dim1_{axis}"] = collectives.all_gather(
                mesh, x, axis, dim=1)
            res[f"all_gather_int_{axis}"] = collectives.all_gather(
                mesh, n, axis)
            res[f"psum_scatter_{axis}"] = collectives.psum_scatter(mesh, x,
                                                                   axis)
            res[f"all_to_all_{axis}"] = collectives.all_to_all(
                mesh, mine(inp[f"a_{axis}"]), axis)
            res[f"psum_{axis}"] = collectives.psum(mesh, x, axis)
            res[f"psum_int_{axis}"] = collectives.psum(mesh, n, axis)
        summed = collectives.sum_home_each(mesh, [x, n])
        res["sum_home"] = [summed[0]] * len(own)
        res["sum_home_int"] = [summed[1]] * len(own)
        res["gather_home"] = [torch.stack(collectives.gather_home(mesh, x))
                              ] * len(own)
        shards = np.split(inp["table"], S)
        blocks = [torch.from_numpy(np.array(shards[w % S])) for w in own]
        ids = torch.from_numpy(inp["ids"]).chunk(D * S)
        deltas = torch.from_numpy(inp["deltas"]).chunk(D * S)
        ids, deltas = [ids[w] for w in own], [deltas[w] for w in own]
        kw = dict(num_shards=S, mesh=mesh)
        res["pull"] = tstore.pull(blocks, ids, **kw)
        res["pull_dense"] = tstore.pull(blocks, ids, dense=True, **kw)
        for combine in ("sum", "mean", "max"):
            res[f"push_{combine}"] = tstore.push(blocks, ids, deltas,
                                                 combine=combine, **kw)
        res["push_dense"] = tstore.push(blocks, ids, deltas, dense=True, **kw)
        pushed = tmesh.Blocks(res["push_sum"], replicas=D, mesh=mesh)
        res["push_sum_numpy"] = [torch.from_numpy(pushed.numpy())] * len(own)
        for op, per_pos in res.items():
            for w, t in zip(own, per_pos):
                out[f"coll/{D}x{S}/{op}/{w}"] = t.numpy()


# The hot tier's scenarios: MF's item table with a partial head of 12 of 31
# items and the lane its chunks need, logreg's table with a head of 64 of
# 400 features (or all of them, with the fold).
TIER_MF_H, TIER_LR_H, TIER_E = 12, 64, 3


def _tiered_mf(mesh_of, out, name, D, S, sync_every=None):
    mesh = mesh_of(D, S)
    W = D * S
    trainer, store = online_mf(mesh, MFConfig(**MF_CFG), combine="mean",
                               sync_every=sync_every)
    chunks = list(multi_epoch_chunks(
        mf_data(), 2, num_workers=W, local_batch=32, steps_per_chunk=4,
        route_key="user", sync_every=sync_every, seed=5))
    from fps_tpu_torch.core.ingest import per_worker_cold_counts

    lane = max(int(per_worker_cold_counts(c["item"], W,
                                          hot_head=TIER_MF_H).max())
               for c in chunks)
    store.specs["item_factors"] = dataclasses.replace(
        store.specs["item_factors"], hot_tier=TIER_MF_H, cold_budget=lane,
        dense_collectives=False)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E)
    tables, local = trainer.init_state(0)
    tables, local, metrics = trainer.fit_stream(tables, local, chunks, 1)
    _record(out, name, tables, local, metrics_of(metrics))


def tiered_mf_d1s4(mesh_of, init, out):
    _tiered_mf(mesh_of, out, "tiered_mf_d1s4", 1, 4)


def tiered_mf_d2s4_ssp(mesh_of, init, out):
    _tiered_mf(mesh_of, out, "tiered_mf_d2s4_ssp", 2, 4, sync_every=2)


def _tiered_lr(mesh_of, out, name, D, S, H, fold=None):
    trainer, store = logistic_regression(mesh_of(D, S),
                                         LogRegConfig(**LR_KW))
    store.specs["weights"] = dataclasses.replace(store.specs["weights"],
                                                 hot_tier=H)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E)
    if fold:
        trainer.server_logic["weights"] = dataclasses.replace(
            trainer.server_logic["weights"], hot_fold=fold)
    chunks = list(epoch_chunks(lr_data(), num_workers=D * S, local_batch=16,
                               steps_per_chunk=4, seed=3))[:3]
    tables, _ = trainer.init_state(0)
    local, metrics = (), []
    for i, chunk in enumerate(chunks):
        tables, local, m = trainer.run_chunk(tables, local, chunk, i)
        metrics.append(_host_tree(m))
    _record(out, name, tables, local, metrics_of(metrics))


def _host_tree(m):
    if isinstance(m, dict):
        return {k: _host_tree(v) for k, v in m.items()}
    return m.numpy()


def tiered_lr_d1s4(mesh_of, init, out):
    _tiered_lr(mesh_of, out, "tiered_lr_d1s4", 1, 4, TIER_LR_H)


def tiered_lr_d2s4_fold(mesh_of, init, out):
    _tiered_lr(mesh_of, out, "tiered_lr_d2s4_fold", 2, 4, LR_NF,
               fold="adagrad")


def _retier_record(out, name, rt, table, H):
    out[f"{name}/hot_ids"] = rt.hot_ids_for(table, H)
    out[f"{name}/counts"] = np.array([rt.re_ranks, rt.checks, rt.tick])
    for k, v in rt.state.items():
        out[f"{name}/state/{k}"] = v


def mapped_mf_d2s4(mesh_of, init, out):
    """MF's mapped head (12 of 31 items, windows of 3) with the cold lane
    its chunks need under the static head, re-ranked at every chunk."""
    from fps_tpu_torch.core.ingest import per_worker_cold_counts
    from fps_tpu_torch.tiering import Retierer

    mesh = mesh_of(2, 4)
    trainer, store = online_mf(mesh, MFConfig(**MF_CFG), combine="mean")
    chunks = list(multi_epoch_chunks(
        mf_data(), 2, num_workers=8, local_batch=32, steps_per_chunk=4,
        route_key="user", seed=5))
    lane = max(int(per_worker_cold_counts(c["item"], 8,
                                          hot_head=TIER_MF_H).max())
               for c in chunks)
    store.specs["item_factors"] = dataclasses.replace(
        store.specs["item_factors"], hot_tier=TIER_MF_H, cold_budget=lane,
        dense_collectives=False)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E)
    trainer.retierer = rt = Retierer(check_every=1, churn_threshold=-1.0)
    tables, local = trainer.init_state(0)
    tables, local, metrics = trainer.fit_stream(tables, local, chunks, 1)
    _record(out, "mapped_mf_d2s4", tables, local, metrics_of(metrics))
    _retier_record(out, "mapped_mf_d2s4", rt, "item_factors", TIER_MF_H)


def mapped_lr_d1s8_ssp(mesh_of, init, out):
    """SSP logistic regression's mapped head (64 of 400 features) through
    ``run_indexed``, calls of 8 steps, re-ranked at every epoch."""
    from fps_tpu_torch.tiering import Retierer

    mesh = mesh_of(1, 8)
    trainer, store = logistic_regression(mesh, LogRegConfig(**LR_KW),
                                         sync_every=2)
    store.specs["weights"] = dataclasses.replace(store.specs["weights"],
                                                 hot_tier=TIER_LR_H)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E,
                                         max_steps_per_call=8)
    trainer.retierer = rt = Retierer(check_every=1, churn_threshold=-1.0)
    plan = DeviceEpochPlan(DeviceDataset(mesh, lr_data()), num_workers=8,
                           local_batch=16, seed=5, sync_every=2)
    tables, _ = trainer.init_state(0)
    tables, _, metrics = trainer.run_indexed(tables, (), plan, 1, epochs=2)
    _record(out, "mapped_lr_d1s8_ssp", tables, (), metrics_of(metrics))
    _retier_record(out, "mapped_lr_d1s8_ssp", rt, "weights", TIER_LR_H)


def _megastep_mf(mesh_of, out, name, D, S):
    """``run_megastep`` over 2 epochs, K = 4, MF's mapped head (12 of 31
    items, windows of 3, calls of 2 steps) with a lane of 5 (some segments
    fit, some overflow) and a ``MegastepTick`` re-ranking every 2
    segments."""
    from fps_tpu_torch import obs
    from fps_tpu_torch.tiering import MegastepTick

    mesh = mesh_of(D, S)
    trainer, store = online_mf(mesh, MFConfig(**MF_CFG), combine="mean",
                               max_steps_per_call=2)
    store.specs["item_factors"] = dataclasses.replace(
        store.specs["item_factors"], hot_tier=TIER_MF_H, cold_budget=5,
        dense_collectives=False)
    trainer.config = dataclasses.replace(trainer.config,
                                         hot_sync_every=TIER_E)
    plan = DeviceEpochPlan(DeviceDataset(mesh, mf_data()), num_workers=8,
                           local_batch=8, route_key="user", seed=5)
    tick = MegastepTick(check_every=2, churn_threshold=-1.0)
    rec = obs.Recorder(sinks=[])
    tables, local = trainer.init_state(0)
    tables, local, metrics = trainer.run_megastep(
        tables, local, plan, 1, epochs=2, chunks_per_dispatch=4, tick=tick,
        recorder=rec)
    _record(out, name, tables, local, metrics_of(metrics))
    out[f"{name}/hot_ids"] = tick.hot_ids["item_factors"]
    out[f"{name}/tick"] = np.array([tick.tick])
    out[f"{name}/state"] = tick.state["item_factors"]
    for k in ("cold_route.vote_compact_windows",
              "cold_route.vote_overflow_windows", "megastep.windows"):
        out[f"{name}/counters/{k}"] = np.float64(rec.counter_value(k))
    out[f"{name}/counters/tiering.re_ranks"] = np.float64(
        rec.counter_value("tiering.re_ranks", table="item_factors"))


def megastep_mf_d2s4(mesh_of, init, out):
    _megastep_mf(mesh_of, out, "megastep_mf_d2s4", 2, 4)


def megastep_mf_d1s8(mesh_of, init, out):
    _megastep_mf(mesh_of, out, "megastep_mf_d1s8", 1, 8)


def ckpt_mf_d1s4(mesh_of, init, out):
    """MF at (1, 4), 6 chunks of ``fit_stream``, every rank saving into
    one directory after every chunk; then a fresh trainer over the same
    processes restores step 2 and finishes the stream. Recorded as logical
    rows (a restore zero-fills the padding rows)."""
    from fps_tpu_torch.core.checkpoint import Checkpointer

    mesh = mesh_of(1, 4)
    d = os.path.join(WHERE, "ckpt")
    chunks = list(multi_epoch_chunks(mf_data(), 2, num_workers=4,
                                     local_batch=16, steps_per_chunk=4,
                                     route_key="user", seed=5))[:6]

    def logical(name, trainer, store, local, metrics):
        out[f"{name}/item_factors"] = store.dump_model("item_factors")[1]
        out[f"{name}/users"] = trainer.logic.export_local_state(
            local.numpy())
        for k, v in metrics_of(metrics).items():
            out[f"{name}/metrics/{k}"] = v

    trainer, store = online_mf(mesh, MFConfig(**MF_CFG))
    tables, local = trainer.init_state(0)
    ck = Checkpointer(d, keep=8)
    tables, local, metrics = trainer.fit_stream(
        tables, local, chunks, 1, checkpointer=ck, checkpoint_every=1)
    logical("ckpt_straight", trainer, store, local, metrics)
    out["ckpt_straight/steps"] = np.array(ck.steps())
    trainer, store = online_mf(mesh, MFConfig(**MF_CFG))
    _, like = trainer.init_state(3)
    tables, local, step = trainer.restore_checkpoint(Checkpointer(d), like,
                                                     step=2)
    tables, local, metrics = trainer.fit_stream(tables, local, chunks[2:],
                                                1, start_step=2)
    logical("ckpt_resumed", trainer, store, local, metrics)


class _ExchangeCount:
    """Counts the process group's exchanges (``torch.distributed``'s
    collective calls) while entered; on one process, none."""

    NAMES = ("all_gather", "all_to_all_single", "broadcast", "all_reduce",
             "reduce_scatter", "send", "recv", "barrier")

    def __init__(self):
        self.calls = 0

    def __enter__(self):
        import torch.distributed as dist

        self._saved = {n: getattr(dist, n) for n in self.NAMES}

        def spy(fn):
            def counted(*a, **k):
                self.calls += 1
                return fn(*a, **k)
            return counted

        for n, fn in self._saved.items():
            setattr(dist, n, spy(fn))
        return self

    def __exit__(self, *exc):
        import torch.distributed as dist

        for n, fn in self._saved.items():
            setattr(dist, n, fn)


def obs_mf_d1s4(mesh_of, init, out):
    """Guarded MF at (1, 4), 4 chunks of ``fit_stream`` with a rank's
    ``open_run`` into one directory (each rank its ``-p<rank>`` files),
    then the same run without a recorder: every counter total, the
    exchanges of each run, and both runs' tables."""
    from fps_tpu_torch import obs

    mesh = mesh_of(1, 4)
    chunks = list(multi_epoch_chunks(mf_data(), 1, num_workers=4,
                                     local_batch=16, steps_per_chunk=4,
                                     route_key="user", seed=5))[:4]
    exchanges = []
    for name, obs_dir in (("obs_mf_d1s4", os.path.join(WHERE, "obs")),
                          ("obs_mf_d1s4_off", None)):
        trainer, store = online_mf(mesh, MFConfig(**MF_CFG), guard="observe")
        tables, local = trainer.init_state(0)
        rec = (obs.open_run(obs_dir, install=False) if obs_dir is not None
               else None)
        with _ExchangeCount() as ex:
            tables, local, metrics = trainer.fit_stream(
                tables, local, chunks, 1, recorder=rec,
                on_chunk=lambda i, m: None)
        exchanges.append(ex.calls)
        _record(out, name, tables, local, metrics_of(metrics))
        if rec is not None:
            for k, v in rec.snapshot()["counters"].items():
                out[f"{name}/counters/{k}"] = np.float64(v)
            rec.close()
    out["exchanges/obs_mf_d1s4"] = np.array(exchanges)


SCENARIOS = {"collectives": collectives_scenario,
             "mf_indexed_d2s4": mf_indexed_d2s4,
             "mf_indexed_d1s8": mf_indexed_d1s8,
             "mf_host_sync": mf_host_sync, "mf_host_ssp": mf_host_ssp,
             "pa": pa, "logreg": logreg, "w2v": w2v, "ials": ials,
             "topk": topk, "tiered_mf_d1s4": tiered_mf_d1s4,
             "tiered_mf_d2s4_ssp": tiered_mf_d2s4_ssp,
             "tiered_lr_d1s4": tiered_lr_d1s4,
             "tiered_lr_d2s4_fold": tiered_lr_d2s4_fold,
             "mapped_mf_d2s4": mapped_mf_d2s4,
             "mapped_lr_d1s8_ssp": mapped_lr_d1s8_ssp,
             "ckpt_mf_d1s4": ckpt_mf_d1s4,
             "obs_mf_d1s4": obs_mf_d1s4,
             "megastep_mf_d2s4": megastep_mf_d2s4,
             "megastep_mf_d1s8": megastep_mf_d1s8}


def run_bundle(bundle: str, mesh_of, init) -> dict:
    out = {}
    for name in BUNDLES[bundle]:
        SCENARIOS[name](mesh_of, init, out)
    return out


def one_process_mesh(D, S):
    """The one-process reference's ``(D, S)`` mesh on the CPU."""
    return tmesh.make_ps_mesh(S, D, device="cpu")


def main() -> int:
    rank, world, init_method, where, bundle = (
        int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
        sys.argv[5])
    timeout_s = float(sys.argv[6]) if len(sys.argv) > 6 else 90.0
    import datetime

    torch.set_num_threads(1)
    tmesh.init_distributed(init_method, world, rank, device="cpu",
                           timeout=datetime.timedelta(seconds=timeout_s))

    def mesh_of(D, S):
        return tmesh.make_ps_mesh(S, D, devices=["cpu"] * (D * S // world))

    if bundle == "dies":
        # Rank 1 leaves once the mesh is built; rank 0's next collective
        # must fail, not hang.
        mesh = mesh_of(1, 8)
        if rank == 1:
            os._exit(3)
        collectives.gather_home(mesh, [torch.zeros(2)] * len(mesh.local))
        return 0
    global WHERE
    WHERE = where
    try:
        init = dict(np.load(os.path.join(where, "init.npz")))
        out = run_bundle(bundle, mesh_of, init)
        np.savez(os.path.join(where, f"rank{rank}.npz"), **out)
    finally:
        tmesh.shutdown_distributed()
    bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
           or m == "fps_tpu" or m.startswith("fps_tpu.")]
    assert not bad, bad
    print(f"rank {rank}: {len(out)} arrays written")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
