"""The port's mesh over two processes (``torch.distributed``, gloo on the
CPU), against the port's one process and the JAX package's.

Each bundle spawns two ranks of ``tests/_torch_mp_worker.py`` with
``subprocess.Popen``: 4 CPU positions each, an 8-position mesh between them,
a ``file://`` store in the test's directory (no TCP port is chosen), logs
and results in files, never pipes (two ranks that wait on each other in a
collective must not also wait on a full pipe). Each rank has a finite
collective timeout, the test waits on each with a timeout and kills any rank
still alive. The test process never joins a process group: it runs the same
scenario functions on one process's 8-position mesh, and the JAX package's
runs on its 8 virtual CPU devices (``tests/test_multiprocess.py``'s
``devices8``), while the ranks run.

Held, for every scenario (``_torch_mp_worker.BUNDLES``):

* **bit for bit against the port's one process** on the same mesh: every
  table, the local state and the metrics as rank 0 read them back (each a
  collective every rank called), and rank 1's reads equal rank 0's; for the
  collectives, the pull and the pushes, each position's result;
* **against the JAX package's one process**, from the same initial state
  (the JAX package's, carried across with ``fps_tpu_torch.convert``), within
  the bounds the one-process mesh tests state: the pull, and the additive
  push (every duplicate folded in the shard-major stream order), bit for
  bit; MF (``tests/test_torch_mesh.py``): ``n`` equal, each step's squared
  error within rtol 1e-5 (atol 1e-7), the item table and the user factors
  within 1e-6; binary PA and SSP logistic regression (the same file): ``n``
  and mistakes equal, the weights within 1e-5 of max(1, the largest); the
  word2vec block worker (``tests/test_torch_mesh_models.py``): ``n`` equal,
  the loss within rtol 2e-6, the tables within 2e-8; iALS
  (``tests/test_torch_ials.py``): the factors within 1e-4 of the largest;
  the online top-k tap and ``recommend_topk`` (``tests/test_torch_taps.py``):
  ids and query ids equal, scores within ``2 * rank * eps32`` of the largest
  sum of absolute products.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from fps_tpu.core import device_ingest as jdi
from fps_tpu.core import ingest as jingest
from fps_tpu.core import store as jstore
from fps_tpu.models import ials as jials
from fps_tpu.models import matrix_factorization as jmf
from fps_tpu.models import recommendation as jrec
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.models.passive_aggressive import PAConfig as JPAConfig
from fps_tpu.models.passive_aggressive import (
    passive_aggressive as jpassive_aggressive,
)
from fps_tpu.parallel import mesh as jmesh

from fps_tpu_torch.models.matrix_factorization import MFConfig, online_mf
from fps_tpu_torch.parallel import mesh as tmesh

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "_torch_mp_worker.py")
_spec = importlib.util.spec_from_file_location("_torch_mp_worker", WORKER)
mpw = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(mpw)
# fps_tpu.models exports a function of the same name as the module.
jw2v = importlib.import_module("fps_tpu.models.word2vec")

EPS32 = float(np.finfo(np.float32).eps)
RANK_TIMEOUT_S = 150


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


# ---------------------------------------------------------------------------
# The JAX package's side: initial states and runs.
# ---------------------------------------------------------------------------

def _np(tree):
    return {k: np.asarray(v) for k, v in tree.items()}


def _mf_trainer(D, S, sync_every=None):
    return jmf.online_mf(_jmesh(D, S), jmf.MFConfig(**mpw.MF_CFG),
                         sync_every=sync_every)


def _w2v_trainer():
    tokens, uni = mpw.w2v_corpus()
    cfg = jw2v.W2VConfig(**mpw.W2V_CFG)

    class Worker(jw2v.Word2VecBlockWorker):
        def prepare(self, batch, key):
            return batch
    return jw2v._make_trainer(_jmesh(1, 8), cfg, Worker(cfg, uni, mpw.BL),
                              sync_every=None, donate=True,
                              max_steps_per_call=None)


def _topk_trainer():
    import dataclasses

    trainer, store = jmf.online_mf(_jmesh(1, 8), jmf.MFConfig(
        num_users=mpw.TOPK_NU, num_items=mpw.TOPK_NI, rank=mpw.TOPK_RANK,
        learning_rate=0.0, reg=0.0), donate=False)
    trainer.config = dataclasses.replace(trainer.config, step_tap=(
        jrec.make_online_topk_tap(store, jmf.ITEM_TABLE, mpw.TOPK_K,
                                  every=mpw.TOPK_EVERY,
                                  query_fn=jrec.mf_topk_query_fn(
                                      8, mpw.TOPK_Q))))
    return trainer, store


def _jax_init(bundle):
    """The JAX package's initial state of every scenario of ``bundle``, as
    numpy arrays under the worker's keys."""
    key = jax.random.key(0)
    init = {}
    if bundle in ("tiered", "mapped", "ckpt", "obs", "megastep"):
        return init  # the scenarios start from the port's own state
    for D, S in ((2, 4),) if bundle == "d2s4" else ((1, 8),):
        tables, local = _mf_trainer(D, S)[0].init_state(key)
        init[f"mf{D}{S}/item_factors"] = np.asarray(tables["item_factors"])
        init[f"mf{D}{S}/local"] = np.asarray(local)
    if bundle == "d1s8":
        _, q = mpw.pa_data()
        tables, _ = jpassive_aggressive(_jmesh(1, 8), JPAConfig(
            **mpw.pa_kw(q)))[0].init_state(key)
        init.update({f"pa/{k}": v for k, v in _np(tables).items()})
        tables, _ = jlogistic_regression(_jmesh(1, 8), JLogRegConfig(
            **mpw.LR_KW), sync_every=2)[0].init_state(key)
        init.update({f"lr/{k}": v for k, v in _np(tables).items()})
        tables, _ = _w2v_trainer()[0].init_state(key)
        init.update({f"w2v/{k}": v for k, v in _np(tables).items()})
        solver = jials.IALSSolver(_jmesh(1, 8), jials.IALSConfig(
            mpw.IALS_NU, mpw.IALS_NI, rank=mpw.IALS_RANK, **mpw.IALS_CFG))
        solver.init(key)
        init.update({f"ials/{k}": v
                     for k, v in _np(solver.store.tables).items()})
        tables, local = _topk_trainer()[0].init_state(key)
        init["topk/item_factors"] = np.asarray(tables[jmf.ITEM_TABLE])
        init["topk/local"] = np.asarray(local)
    return init


def _metrics(chunks):
    return mpw.metrics_of([jax.tree.map(np.asarray, m) for m in chunks])


def _jax_mf(D, S, init, kind):
    sync_every = 2 if kind == "host_ssp" else None
    trainer, store = _mf_trainer(D, S, sync_every)
    mesh = trainer.mesh
    tables = {"item_factors": jax.device_put(
        init[f"mf{D}{S}/item_factors"], tables_sharding(mesh))}
    local = jax.device_put(init[f"mf{D}{S}/local"], workers_sharding(mesh))
    data = mpw.mf_data()
    if kind == "indexed":
        plan = jdi.DeviceEpochPlan(jdi.DeviceDataset(mesh, data),
                                   num_workers=D * S, local_batch=32,
                                   route_key="user", seed=5)
        tables, local, m = trainer.run_indexed(tables, local, plan,
                                               jax.random.key(1), epochs=2)
    else:
        chunks = jingest.multi_epoch_chunks(
            data, 2, num_workers=D * S, local_batch=32, steps_per_chunk=4,
            route_key="user", sync_every=sync_every, seed=5)
        tables, local, m = trainer.fit_stream(tables, local, chunks,
                                              jax.random.key(1))
    return _np(tables), np.asarray(local), _metrics(m)


def tables_sharding(mesh):
    return jax.sharding.NamedSharding(mesh, P(jmesh.SHARD_AXIS, None))


def workers_sharding(mesh):
    return jax.sharding.NamedSharding(
        mesh, P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)))


def _jax_sparse(trainer, init, key, chunks):
    mesh = trainer.mesh
    tables = {k: jax.device_put(init[f"{key}/{k}"], tables_sharding(mesh))
              for k in trainer.store.specs}
    local, ms = (), []
    for i, chunk in enumerate(chunks):
        tables, local, m = trainer.run_chunk(tables, local, chunk,
                                             jax.random.key(i))
        ms.append(m)
    return _np(tables), _metrics(ms)


def _jax_w2v_plan_class(draws):
    class Plan(jw2v.Word2VecDevicePlan):
        """The JAX package's plan with the draws taken from ``draws`` (the
        plan of ``tests/test_torch_mesh_models.py``, block mode)."""

        def epoch_args(self, epoch):
            return dict(super().epoch_args(epoch), epoch=np.int32(epoch))

        def local_batch_at(self, args, w, t):
            L, W = self.block_len, self.cfg.window
            base = (t * self.num_workers + w) * L
            row = (args["epoch"] * draws.steps + t) * draws.workers + w
            return {
                "block": jax.lax.dynamic_slice(args["compacted"], (base,),
                                               (L + W,)),
                "half": jnp.take(jnp.asarray(draws.half), row, axis=0,
                                 mode="clip"),
                "negatives": jnp.take(jnp.asarray(draws.negs), row, axis=0,
                                      mode="clip"),
                "valid_len": jnp.clip(args["kept"] - base, 0, L + W)}
    return Plan


def _jax_runs(bundle, init):
    """The JAX package's one-process run of every scenario of ``bundle``
    (none for ``tiered`` and ``mapped``: ``tests/test_torch_hot_tier.py``
    and ``tests/test_torch_tiering.py`` hold the tiers against the JAX
    package)."""
    ref = {}
    if bundle in ("tiered", "mapped", "ckpt", "obs", "megastep"):
        return ref
    if bundle == "d2s4":
        for kind in ("indexed", "host_sync", "host_ssp"):
            ref[f"mf_{kind}"] = _jax_mf(2, 4, init, kind)
        for D, S in mpw.COLLECTIVE_SHAPES:
            inp = mpw.collective_inputs(D, S)
            ref[f"pull/{D}x{S}"] = _jax_shard_map(
                D, S, lambda t, i: jstore.pull(t, i, num_shards=S),
                inp["table"], inp["ids"])
            ref[f"push/{D}x{S}"] = _jax_shard_map(
                D, S, lambda t, i, d: jstore.push(
                    t, i, d, num_shards=S,
                    data_axis=jmesh.DATA_AXIS if D > 1 else None),
                inp["table"], inp["ids"], inp["deltas"])
        return ref
    ref["mf_indexed"] = _jax_mf(1, 8, init, "indexed")
    data, q = mpw.pa_data()
    trainer, _ = jpassive_aggressive(_jmesh(1, 8), JPAConfig(**mpw.pa_kw(q)))
    ref["pa"] = _jax_sparse(trainer, init, "pa", list(jingest.epoch_chunks(
        data, num_workers=8, local_batch=64, steps_per_chunk=2, seed=3))[:3])
    trainer, _ = jlogistic_regression(_jmesh(1, 8), JLogRegConfig(
        **mpw.LR_KW), sync_every=2)
    ref["logreg"] = _jax_sparse(trainer, init, "lr", list(
        jingest.epoch_chunks(mpw.lr_data(), num_workers=8, local_batch=32,
                             steps_per_chunk=2, sync_every=2, seed=3))[:3])
    trainer, _ = _w2v_trainer()
    tokens, uni = mpw.w2v_corpus()
    T = mpw.w2v_steps(mpw.one_process_mesh(1, 8))
    plan = _jax_w2v_plan_class(mpw.W2VDraws(1, T, 8, mpw.BL + mpw.WIN))(
        tokens, uni, trainer.logic.cfg, trainer.mesh, num_workers=8,
        block_len=mpw.BL, seed=4, mode="block")
    tables = {k: jax.device_put(init[f"w2v/{k}"],
                                tables_sharding(trainer.mesh))
              for k in trainer.store.specs}
    tables, _, m = trainer.run_indexed(tables, (), plan, jax.random.key(1))
    ref["w2v"] = _np(tables), _metrics(m)
    solver = jials.IALSSolver(_jmesh(1, 8), jials.IALSConfig(
        mpw.IALS_NU, mpw.IALS_NI, rank=mpw.IALS_RANK, **mpw.IALS_CFG))
    solver.init(jax.random.key(0))
    solver.store.tables = {k: jax.device_put(
        init[f"ials/{k}"], tables_sharding(solver.mesh))
        for k in solver.store.tables}
    chunks = list(jials.interaction_chunks(mpw.ials_data(), num_workers=8,
                                           local_batch=4, steps_per_chunk=2,
                                           seed=0))
    solver.epoch(lambda: iter(chunks))
    ref["ials"] = solver.factors()
    trainer, store = _topk_trainer()
    tables = {jmf.ITEM_TABLE: jax.device_put(
        init["topk/item_factors"], tables_sharding(trainer.mesh))}
    local = jax.device_put(init["topk/local"],
                           workers_sharding(trainer.mesh))
    chunk = next(jingest.epoch_chunks(mpw.topk_data(8), num_workers=8,
                                      local_batch=8,
                                      steps_per_chunk=mpw.TOPK_T,
                                      route_key="user"))
    _, _, m = trainer.run_chunk(tables, local, chunk, jax.random.key(1))
    ids, scores = jrec.recommend_topk(store, jmf.ITEM_TABLE,
                                      mpw.topk_queries(), mpw.TOPK_K)
    ref["topk"] = (_metrics([m]), np.asarray(ids), np.asarray(scores))
    return ref


def _jax_shard_map(D, S, fn, table, *args):
    specs = (P(jmesh.SHARD_AXIS, None), P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)),
             P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS), None))[:1 + len(args)]
    out = (P((jmesh.DATA_AXIS, jmesh.SHARD_AXIS)) if len(args) == 1
           else P(jmesh.SHARD_AXIS, None))
    run = jax.shard_map(fn, mesh=_jmesh(D, S), in_specs=specs,
                        out_specs=out, check_vma=False)
    return np.asarray(jax.jit(run)(jnp.asarray(table),
                                   *map(jnp.asarray, args)))


# ---------------------------------------------------------------------------
# The ranks.
# ---------------------------------------------------------------------------

def _spawn(where, bundle, timeout_s=None):
    """Two ranks of the worker on ``bundle``, writing into ``where``."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = []
    for rank in range(2):
        with open(os.path.join(where, f"log{rank}"), "w") as log:
            args = [sys.executable, WORKER, str(rank), "2",
                    f"file://{where}/store", str(where), bundle]
            if timeout_s is not None:
                args.append(str(timeout_s))
            procs.append(subprocess.Popen(args, env=env, cwd=ROOT,
                                          stdout=log,
                                          stderr=subprocess.STDOUT))
    return procs


def _tail(where, rank):
    with open(os.path.join(where, f"log{rank}")) as f:
        return f.read()[-3000:]


def _wait(procs, where, timeout_s=RANK_TIMEOUT_S):
    """Each rank's exit code; a rank still alive after ``timeout_s`` is
    killed (as every rank is on any way out) and fails the test."""
    try:
        rcs = []
        for rank, p in enumerate(procs):
            try:
                rcs.append(p.wait(timeout=timeout_s))
            except subprocess.TimeoutExpired:
                pytest.fail(f"rank {rank} hung:\n{_tail(where, rank)}")
        return rcs
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


_RUNS = {}
_WHERES = {}


def _bundle(tmp_path_factory, bundle):
    """``(rank results, one-process results, the JAX package's runs)`` of
    ``bundle``, run once a test session."""
    if bundle not in _RUNS:
        where = tmp_path_factory.mktemp(bundle)
        init = _jax_init(bundle)
        np.savez(where / "init.npz", **init)
        procs = _spawn(where, bundle)
        _WHERES[bundle] = where
        try:
            # The one-process run saves apart from the ranks.
            mpw.WHERE = str(where / "one_process")
            one = mpw.run_bundle(bundle, mpw.one_process_mesh, init)
            ref = _jax_runs(bundle, init)
        finally:
            rcs = _wait(procs, where)
        for rank, rc in enumerate(rcs):
            assert rc == 0, f"rank {rank} exited {rc}:\n{_tail(where, rank)}"
        ranks = [dict(np.load(where / f"rank{r}.npz")) for r in range(2)]
        _RUNS[bundle] = ranks, one, ref
    return _RUNS[bundle]


@pytest.fixture(scope="module")
def run(tmp_path_factory, devices8):
    del devices8  # the JAX side's 8 CPU devices
    return lambda bundle: _bundle(tmp_path_factory, bundle)


# ---------------------------------------------------------------------------
# Two ranks against one process, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("bundle", ["d2s4", "d1s8"])
def test_two_ranks_equal_one_process_bit_for_bit(run, bundle):
    """Every array a rank read back (rank 0's; rank 1's host reads the same
    bits), and every position's collective result from the rank that holds
    it, against the same scenario on one process's 8-position mesh."""
    ranks, one, _ = run(bundle)
    checked = 0
    for key, want in one.items():
        if key.startswith("coll/"):
            w = int(key.rsplit("/", 1)[1])
            got = ranks[w // 4][key]
            assert key not in ranks[1 - w // 4], key
        else:
            got = ranks[0][key]
            np.testing.assert_array_equal(ranks[1][key], got, key)
        np.testing.assert_array_equal(got, want, key)
        checked += 1
    names = {k.split("/")[0] for k in one}
    assert names == ({"coll", "mf_indexed_d2s4", "mf_host_sync",
                      "mf_host_ssp"} if bundle == "d2s4" else
                     {"mf_indexed_d1s8", "pa", "logreg", "w2v", "ials",
                      "topk"})
    assert checked == len(one) and checked > 20


def test_tiered_two_ranks_equal_one_process_bit_for_bit(run):
    """The static hot tier over two ranks (the ``tiered`` bundle): at (1, 4)
    the shard axis crosses the ranks (the replica's derivation and the
    reconcile's reduce-scatter and all-gather), at (2, 4) the data axis (the
    reconcile's sum). Every table, replica, fold state, local state and
    metric equals one process's bit for bit, on both ranks, and each
    replica is its table's head rows."""
    ranks, one, _ = run("tiered")
    assert {k.split("/")[0] for k in one} == set(mpw.BUNDLES["tiered"])
    for key, want in one.items():
        np.testing.assert_array_equal(ranks[0][key], want, key)
        np.testing.assert_array_equal(ranks[1][key], want, key)
    for name, table, H in (("tiered_mf_d1s4", "item_factors", mpw.TIER_MF_H),
                           ("tiered_mf_d2s4_ssp", "item_factors",
                            mpw.TIER_MF_H),
                           ("tiered_lr_d1s4", "weights", mpw.TIER_LR_H),
                           ("tiered_lr_d2s4_fold", "weights", mpw.LR_NF)):
        full = one[f"{name}/table/{table}"]
        S = 4
        rps = full.shape[0] // S
        ids = np.arange(H)
        np.testing.assert_array_equal(
            one[f"{name}/table/{table}::hot"],
            full[(ids % S) * rps + ids // S], name)
    assert "tiered_lr_d2s4_fold/table/weights::fold" in one
    assert one["tiered_mf_d1s4/metrics/hot_tier/item_factors/cold_dropped"
               ].sum() == 0


def test_checkpoints_over_two_ranks_resume_as_one_process(run):
    """MF at (1, 4) over two ranks, both saving into one directory after
    every chunk (the same file written by both, atomically): every save
    lands, a resume over the two ranks from step 2 equals the
    uninterrupted run, and both equal one process's runs bit for bit; one
    process restoring the ranks' last save holds their final state."""
    from fps_tpu_torch.core.checkpoint import Checkpointer

    ranks, one, _ = run("ckpt")
    assert {k.split("/")[0] for k in one} == {"ckpt_straight",
                                              "ckpt_resumed"}
    for key, want in one.items():
        np.testing.assert_array_equal(ranks[0][key], want, key)
        np.testing.assert_array_equal(ranks[1][key], want, key)
    np.testing.assert_array_equal(one["ckpt_straight/steps"],
                                  np.arange(1, 7))
    for k in ("item_factors", "users"):
        np.testing.assert_array_equal(one[f"ckpt_resumed/{k}"],
                                      one[f"ckpt_straight/{k}"], k)
    where = str(_WHERES["ckpt"] / "ckpt")
    assert not [f for f in os.listdir(where) if f.endswith(".tmp.npz")]
    trainer, store = online_mf(tmesh.make_ps_mesh(4, 1, device="cpu"),
                               MFConfig(**mpw.MF_CFG))
    _, like = trainer.init_state(9)
    _, local, step = trainer.restore_checkpoint(Checkpointer(where), like)
    assert step == 6
    np.testing.assert_array_equal(store.dump_model("item_factors")[1],
                                  ranks[0]["ckpt_straight/item_factors"])
    np.testing.assert_array_equal(
        trainer.logic.export_local_state(local.numpy()),
        ranks[0]["ckpt_straight/users"])


def test_telemetry_over_two_ranks_counts_as_one_process(run):
    """Guarded MF at (1, 4) over two ranks, each with ``open_run`` into one
    directory: both ranks' ``-p0`` / ``-p1`` files exist, each rank's
    counter totals equal the one-process run's (the step's metrics are
    global on every rank), the tables with and without the recorder are
    the same bits, and the recorder adds no exchange."""
    ranks, one, _ = run("obs")
    counters = [k for k in one if "/counters/" in k]
    assert {k.rsplit("/", 1)[1] for k in counters} >= {
        "driver.chunks", "driver.examples", "driver.steps",
        "health.nonfinite_rows{table=item_factors}"}
    for key, want in one.items():
        if key.startswith("exchanges/"):
            continue
        np.testing.assert_array_equal(ranks[0][key], want, key)
        np.testing.assert_array_equal(ranks[1][key], want, key)
        if key.startswith("obs_mf_d1s4/table/"):
            off = key.replace("obs_mf_d1s4/", "obs_mf_d1s4_off/")
            np.testing.assert_array_equal(one[off], want, key)
    assert one["obs_mf_d1s4/counters/driver.chunks"] == 4
    for r in range(2):
        on, off = ranks[r]["exchanges/obs_mf_d1s4"]
        assert on == off > 0
    assert list(one["exchanges/obs_mf_d1s4"]) == [0, 0]
    where = str(_WHERES["obs"] / "obs")
    assert sorted(os.listdir(where)) == [
        f"{kind}-p{r}.{ext}" for kind, ext in (("events", "jsonl"),
                                               ("journal", "jsonl"),
                                               ("metrics", "prom"))
        for r in range(2)]


def test_mapped_two_ranks_equal_one_process_bit_for_bit(run):
    """The adaptive tier over two ranks (the ``mapped`` bundle), re-ranked
    at every boundary: at (2, 4) the data axis crosses the ranks, at (1, 8)
    the shard axis (the windows' merge, the re-split's all-gather, the
    reconcile's scatter of the owned rows). Every table, replica, slot
    map, id array, window, local state and metric equals one process's bit
    for bit on both ranks, and so do the retierers' hot ids, counts and
    decayed sketches; each replica is its table's rows of the hot ids."""
    ranks, one, _ = run("mapped")
    assert {k.split("/")[0] for k in one} == set(mpw.BUNDLES["mapped"])
    for key, want in one.items():
        np.testing.assert_array_equal(ranks[0][key], want, key)
        np.testing.assert_array_equal(ranks[1][key], want, key)
    for name, table, S in (("mapped_mf_d2s4", "item_factors", 4),
                           ("mapped_lr_d1s8_ssp", "weights", 8)):
        assert one[f"{name}/counts"][0] >= 1  # re-ranked
        gids = one[f"{name}/hot_ids"]
        full = one[f"{name}/table/{table}"]
        rps = full.shape[0] // S
        np.testing.assert_array_equal(one[f"{name}/table/{table}::hot"],
                                      full[(gids % S) * rps + gids // S])
        np.testing.assert_array_equal(one[f"{name}/table/{table}::hotids"],
                                      gids)
        assert f"{name}/table/{table}::sketch" in one
    assert one["mapped_mf_d2s4/metrics/hot_tier/item_factors/cold_dropped"
               ].sum() == 0


def test_megastep_two_ranks_equal_one_process_bit_for_bit(run):
    """``run_megastep`` over two ranks (the ``megastep`` bundle): the vote's
    misfit sum crosses the ranks on the data axis at (2, 4) and on the shard
    axis at (1, 8), as do the tick's re-split (its all-gather) and the
    compacted lanes' routes. Every table, replica, slot map, id array,
    window, local state and metric equals one process's bit for bit on both
    ranks, and so do the tick's hot ids, fold counter and decayed sketch
    and the vote counters; some segments fit and some overflow, and the
    tick re-ranked (``tests/test_torch_megastep.py`` holds the megastep
    against the JAX package's)."""
    ranks, one, _ = run("megastep")
    assert {k.split("/")[0] for k in one} == set(mpw.BUNDLES["megastep"])
    for key, want in one.items():
        np.testing.assert_array_equal(ranks[0][key], want, key)
        np.testing.assert_array_equal(ranks[1][key], want, key)
    for name, S in (("megastep_mf_d2s4", 4), ("megastep_mf_d1s8", 8)):
        c = f"{name}/counters/"
        assert one[c + "cold_route.vote_compact_windows"] > 0
        assert one[c + "cold_route.vote_overflow_windows"] > 0
        assert (one[c + "cold_route.vote_compact_windows"]
                + one[c + "cold_route.vote_overflow_windows"]
                == one[c + "megastep.windows"])
        assert one[c + "tiering.re_ranks"] >= 1
        gids = one[f"{name}/hot_ids"]
        full = one[f"{name}/table/item_factors"]
        rps = full.shape[0] // S
        np.testing.assert_array_equal(
            one[f"{name}/table/item_factors::hot"],
            full[(gids % S) * rps + gids // S])
        np.testing.assert_array_equal(
            one[f"{name}/table/item_factors::hotids"], gids)
        assert one[f"{name}/metrics/hot_tier/item_factors/cold_dropped"
                   ].sum() == 0


@pytest.mark.parametrize("D,S", mpw.COLLECTIVE_SHAPES)
def test_collectives_cover_every_position_and_match_their_definition(run, D,
                                                                    S):
    """The four collectives across the two ranks against their definition
    on the global inputs (an axis crossing the ranks at (1, 8) and (2, 4),
    the data axis at (4, 2)): each position's all_gather is its group's
    tensors joined, psum its group's sum in index order, psum_scatter its
    piece of that, all_to_all the group's entries for it."""
    ranks, _, _ = run("d2s4")
    inp = mpw.collective_inputs(D, S)
    x = torch.from_numpy(inp["x"])
    for axis in (tmesh.SHARD_AXIS, tmesh.DATA_AXIS):
        for w in range(D * S):
            got = ranks[w // 4]
            d, s = divmod(w, S)
            g, i = (([d * S + j for j in range(S)], s)
                    if axis == tmesh.SHARD_AXIS else
                    ([j * S + s for j in range(D)], d))
            pre = f"coll/{D}x{S}"
            np.testing.assert_array_equal(
                got[f"{pre}/all_gather_{axis}/{w}"],
                torch.cat([x[q] for q in g]).numpy())
            total = x[g[0]]
            for q in g[1:]:
                total = total + x[q]
            np.testing.assert_array_equal(got[f"{pre}/psum_{axis}/{w}"],
                                          total.numpy())
            rows = 8 // len(g)
            np.testing.assert_array_equal(
                got[f"{pre}/psum_scatter_{axis}/{w}"],
                total[i * rows:(i + 1) * rows].numpy())
            a = inp[f"a_{axis}"]
            np.testing.assert_array_equal(got[f"{pre}/all_to_all_{axis}/{w}"],
                                          np.stack([a[q][i] for q in g]))


@pytest.mark.parametrize("D,S", mpw.COLLECTIVE_SHAPES)
def test_pull_and_additive_push_across_ranks_equal_jax_bit_for_bit(run, D,
                                                                   S):
    """The gathered pull, and the additive push of duplicates across every
    worker folded in the shard-major stream order, across two ranks equal
    the JAX package's under ``shard_map`` bit for bit; every data replica of
    a shard holds the same bits."""
    ranks, _, ref = run("d2s4")
    pre = f"coll/{D}x{S}"
    pulled = np.concatenate([ranks[w // 4][f"{pre}/pull/{w}"]
                             for w in range(D * S)])
    np.testing.assert_array_equal(pulled, ref[f"pull/{D}x{S}"])
    pushed = [ranks[w // 4][f"{pre}/push_sum/{w}"] for w in range(D * S)]
    for w in range(S, D * S):
        np.testing.assert_array_equal(pushed[w], pushed[w % S])
    np.testing.assert_array_equal(np.concatenate(pushed[:S]),
                                  ref[f"push/{D}x{S}"])
    np.testing.assert_array_equal(ranks[0][f"{pre}/push_sum_numpy/0"],
                                  ref[f"push/{D}x{S}"])


# ---------------------------------------------------------------------------
# Two ranks against the JAX package's one process.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,bundle,kind", [
    ("mf_indexed_d2s4", "d2s4", "mf_indexed"),
    ("mf_host_sync", "d2s4", "mf_host_sync"),
    ("mf_host_ssp", "d2s4", "mf_host_ssp"),
    ("mf_indexed_d1s8", "d1s8", "mf_indexed")])
def test_mf_across_ranks_matches_jax(run, name, bundle, kind):
    """The reference's ``indexed``, ``host_sync``, ``host_ssp`` and
    ``indexed_shard8`` scenarios (two epochs each): the metrics of every
    step, the item table and the user factors."""
    ranks, _, ref = run(bundle)
    got = ranks[0]
    tables, local, metrics = ref[kind]
    np.testing.assert_array_equal(got[f"{name}/metrics/n"], metrics["n"])
    assert got[f"{name}/metrics/n"].sum() == 2 * mpw.MF_N
    np.testing.assert_allclose(got[f"{name}/metrics/se"], metrics["se"],
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(got[f"{name}/table/item_factors"],
                               tables["item_factors"], rtol=0, atol=1e-6)
    np.testing.assert_allclose(got[f"{name}/local"], local, rtol=0,
                               atol=1e-6)


@pytest.mark.parametrize("name", ["pa", "logreg"])
def test_pa_and_ssp_logreg_across_ranks_match_jax(run, name):
    """Binary PA-I (its head prefix, which no mesh of several positions
    keeps) and SSP logistic regression (s = 2) at (1, 8), three chunks."""
    ranks, _, ref = run("d1s8")
    got = ranks[0]
    tables, metrics = ref[name]
    for k in ("n", "mistakes"):
        np.testing.assert_array_equal(got[f"{name}/metrics/{k}"], metrics[k])
    want = tables["weights"]
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got[f"{name}/table/weights"], want, rtol=0,
                               atol=1e-5 * scale)
    assert np.abs(want).max() > 0


def test_w2v_block_worker_across_ranks_matches_jax(run):
    """One ``run_indexed`` call of an epoch at (1, 8), both sides' draws
    from one numpy seed: ``n``, each step's loss and both tables."""
    ranks, _, ref = run("d1s8")
    got = ranks[0]
    tables, metrics = ref["w2v"]
    np.testing.assert_array_equal(got["w2v/metrics/n"], metrics["n"])
    assert metrics["n"].sum() > 0
    np.testing.assert_allclose(got["w2v/metrics/loss"], metrics["loss"],
                               rtol=2e-6)
    for name, want in tables.items():
        np.testing.assert_allclose(got[f"w2v/table/{name}"], want, rtol=0,
                                   atol=2e-8)


def test_ials_epoch_across_ranks_matches_jax(run):
    """One epoch at (1, 8): each shard's Gramian folded over the shards
    across the ranks, each position's solve of its own block."""
    ranks, _, ref = run("d1s8")
    for got, want in zip((ranks[0]["ials/users"], ranks[0]["ials/items"]),
                         ref["ials"]):
        scale = float(np.abs(want).max())
        assert float(np.abs(got - want).max()) <= 1e-4 * scale


def test_online_topk_tap_and_recommend_across_ranks_match_jax(run):
    """The collective tap at (1, 8) (the queries all-gathered over the shard
    axis across the ranks, the candidates back) and ``recommend_topk`` on
    the item table."""
    ranks, _, ref = run("d1s8")
    got = ranks[0]
    metrics, ids, scores = ref["topk"]
    for key in ("topk_query", "topk_ids"):
        np.testing.assert_array_equal(got[f"topk/metrics/tap/{key}"],
                                      metrics[f"tap/{key}"])
    assert got["topk/metrics/tap/topk_ids"].shape == (
        mpw.TOPK_T, 8, mpw.TOPK_Q, mpw.TOPK_K)
    items = got["topk/table/item_factors"]
    scale = float((np.abs(got["topk/local"]) @ np.abs(items).T).max())
    bound = 2 * mpw.TOPK_RANK * EPS32 * scale
    np.testing.assert_allclose(got["topk/metrics/tap/topk_scores"],
                               metrics["tap/topk_scores"], rtol=0, atol=bound)
    np.testing.assert_array_equal(got["topk/recommend/ids"], ids)
    qscale = float((np.abs(mpw.topk_queries()) @ np.abs(items).T).max())
    np.testing.assert_allclose(got["topk/recommend/scores"], scores, rtol=0,
                               atol=2 * mpw.TOPK_RANK * EPS32 * qscale)


# ---------------------------------------------------------------------------
# The harness's own guarantees.
# ---------------------------------------------------------------------------

def test_a_rank_that_dies_fails_its_peer_instead_of_hanging(tmp_path):
    """Rank 1 exits after the mesh is built; rank 0, waiting in its next
    collective, fails within its 10 s collective timeout instead of
    hanging."""
    procs = _spawn(tmp_path, "dies", timeout_s=10)
    rcs = _wait(procs, tmp_path, timeout_s=60)
    assert rcs[1] == 3, _tail(tmp_path, 1)
    assert rcs[0] != 0, _tail(tmp_path, 0)


def test_uneven_layouts_are_refused_before_any_group_is_made():
    """Over processes each process holds whole data replicas or an equal
    part of one, so every group takes equal counts from its processes."""
    import torch.distributed as dist

    with pytest.raises(ValueError, match="whole data replicas"):
        tmesh._make_procs({tmesh.DATA_AXIS: 1, tmesh.SHARD_AXIS: 6}, 4, 2)
    with pytest.raises(ValueError, match="whole data replicas"):
        tmesh._make_procs({tmesh.DATA_AXIS: 2, tmesh.SHARD_AXIS: 4}, 6, 2)
    # This process never joined a group: the ranks are subprocesses.
    assert not dist.is_initialized()


def test_a_process_on_more_than_one_device_is_refused(monkeypatch):
    """Over processes a process holds its positions on one device (its
    tensors travel joined in one buffer, and NCCL takes one card a
    process): ``make_ps_mesh`` refuses more before any exchange."""
    import torch.distributed as dist

    monkeypatch.setattr(tmesh, "_world", lambda: 2)
    with pytest.raises(ValueError, match="on one device, not on 2"):
        tmesh.make_ps_mesh(4, 2, devices=["cpu", "cpu:1", "cpu", "cpu"])
    assert not dist.is_initialized()
