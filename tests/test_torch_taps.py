"""The port's step taps, top-k retrieval and worker combinators against the
JAX package's, on the CPU.

* ``TrainerConfig.step_tap``: the tap sees the tables after the step's push,
  the raw batch, the new local state and the step's index (in its chunk for
  ``run_chunk``, in its epoch for ``run_indexed``), sync and SSP; its
  pytree rides the metrics as ``(T, W, ...)`` leaves. JAX ``online_mf`` on a
  (data=1, shard=1) mesh and the port from the same tables and chunks give
  the same tap outputs (equal ids and step indices; table sums within
  float32 rounding). Its two errors.
* word2vec's ``cooccurrence_sketch_tap`` on pair and block batches: the
  port's stacks equal the JAX package's bit for bit (±1 sums of 0/1
  weights), per batch and accumulated over a run; the estimator tracks the
  exact co-occurrence (oracles ``tests/test_word2vec.py::
  test_cooccurrence_sketch_tap_tracks_exact`` and ``tests/test_w2v_device.py
  ::test_block_path_sketch_tap_tracks_exact``).
* ``recommend_topk`` and the online top-k tap with exact ties, exclusions
  and k larger than the candidates: ids equal the JAX package's and a
  brute-force ranking by (-score, id) (oracle ``tests/test_recommendation.py``).
  On the sharded mesh, ``(1, 8)`` and ``(2, 4)`` against the JAX package's:
  ``recommend_topk`` with ties (across shards, by position in the
  shard-major pool), exclusions and ``k`` above the pool; the collective
  online tap; the driver's contract for collective taps; the MF example's
  ``--topk`` on four shards.
* ``clip_pushes``, ``scale_pushes`` and ``tap_outputs`` (oracle
  ``tests/test_streaming.py::test_combinators``): pushes and metrics equal
  the JAX package's within float32 rounding.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.core import combinators as jcomb
from fps_tpu.core import ingest as jingest
from fps_tpu.core.device_ingest import DeviceDataset as JDeviceDataset
from fps_tpu.core.device_ingest import DeviceEpochPlan as JDeviceEpochPlan
from fps_tpu.core.driver import Trainer as JTrainer
from fps_tpu.core.store import ParamStore as JParamStore
from fps_tpu.core.store import TableSpec as JTableSpec
from fps_tpu.models import matrix_factorization as jmf
from fps_tpu.models import recommendation as jrec
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.sketch import TugOfWarSpec as JTugOfWarSpec
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import TrainerConfig, make_ps_mesh
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.core import combinators as tcomb
from fps_tpu_torch.core.api import StepOutput, WorkerLogic
from fps_tpu_torch.core.device_ingest import DeviceDataset, DeviceEpochPlan
from fps_tpu_torch.core.driver import Trainer, _to_host
from fps_tpu_torch.core.store import ParamStore, TableSpec
from fps_tpu_torch.models import matrix_factorization as tmf
from fps_tpu_torch.models import recommendation as trec
from fps_tpu_torch.models import word2vec as tw2v
from fps_tpu_torch.sketch import TugOfWarSpec

# fps_tpu.models exports a function named word2vec, which shadows the module.
jw2v = importlib.import_module("fps_tpu.models.word2vec")

NU, NI, RANK = 48, 32, 4
ITEM = tmf.ITEM_TABLE


def _jmesh():
    return jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])


def _mf_pair(lr=0.05, sync_every=None, max_steps_per_call=None,
             jtap=None, ttap=None, num_items=NI):
    """JAX and port MF trainers from the same tables, with the given taps."""
    cfg = dict(num_users=NU, num_items=num_items, rank=RANK, learning_rate=lr,
               reg=0.01 if lr else 0.0)
    jtr, jstore = jmf.online_mf(_jmesh(), jmf.MFConfig(**cfg),
                                sync_every=sync_every,
                                max_steps_per_call=max_steps_per_call)
    jtr.config = dataclasses.replace(jtr.config, step_tap=jtap)
    ttr, tstore = tmf.online_mf(make_ps_mesh(device="cpu"),
                                tmf.MFConfig(**cfg), sync_every=sync_every,
                                max_steps_per_call=max_steps_per_call)
    ttr.config = dataclasses.replace(ttr.config, step_tap=ttap)
    jtables, jlocal = jtr.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    tlocal = local_state_from_jax(ttr.logic, np.asarray(jlocal),
                                  device="cpu")
    return (jtr, jstore, jtables, jlocal), (ttr, tstore, ttables, tlocal)


def _jtap(tables, batch, local_state, t):
    return {"t": jnp.asarray(t, jnp.int32),
            "item_sum": jnp.sum(tables[ITEM]),
            "user0": batch["user"][0],
            "pair": (jnp.sum(local_state), batch["weight"][:2])}


def _ttap(tables, batch, local_state, t):
    return {"t": torch.tensor(t, dtype=torch.int32),
            "item_sum": torch.sum(tables[ITEM]),
            "user0": batch["user"][0],
            "pair": (torch.sum(local_state), batch["weight"][:2])}


def _same_taps(jm, tm, steps):
    jt, tt = jm["tap"], tm["tap"]
    assert set(jt) == set(tt) == {"t", "item_sum", "user0", "pair"}
    for k in ("t", "user0"):
        assert tt[k].shape == (steps, 1)
        np.testing.assert_array_equal(tt[k], np.asarray(jt[k]))
    assert isinstance(tt["pair"], tuple) and tt["pair"][1].shape == (
        steps, 1, 2)
    np.testing.assert_array_equal(tt["pair"][1], np.asarray(jt["pair"][1]))
    # Sums of the live tables: the same SGD steps, float32 rounding apart.
    np.testing.assert_allclose(tt["item_sum"], np.asarray(jt["item_sum"]),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tt["pair"][0], np.asarray(jt["pair"][0]),
                               rtol=0, atol=1e-5)


@pytest.mark.parametrize("sync_every", [None, 4])
def test_step_tap_in_run_chunk_matches_jax(sync_every):
    (jtr, _, jtb, jls), (ttr, _, ttb, tls) = _mf_pair(
        sync_every=sync_every, jtap=_jtap, ttap=_ttap)
    data = jdatasets.synthetic_ratings(NU, NI, 2000, seed=3)
    chunks = list(jingest.epoch_chunks(
        data, num_workers=1, local_batch=32, steps_per_chunk=8,
        route_key="user", sync_every=sync_every, seed=1))[:3]
    for i, chunk in enumerate(chunks):
        jtb, jls, jm = jtr.run_chunk(jtb, jls, chunk, jax.random.key(i))
        ttb, tls, tm = ttr.run_chunk(ttb, tls, chunk, i)
        tm = _to_host(tm)
        _same_taps(jm, tm, 8)
        # The step index restarts at 0 each chunk, rounds included.
        np.testing.assert_array_equal(tm["tap"]["t"][:, 0], np.arange(8))


@pytest.mark.parametrize("sync_every", [None, 2])
def test_step_tap_in_fit_stream_and_run_indexed_matches_jax(sync_every):
    data = jdatasets.synthetic_ratings(NU, NI, 3000, seed=4)
    # run_indexed: 3,000 ratings in steps of 256 are 12 steps an epoch, in
    # calls of 4: the tap's index counts the epoch's steps across calls.
    (jtr, _, jtb, jls), (ttr, _, ttb, tls) = _mf_pair(
        sync_every=sync_every, max_steps_per_call=4, jtap=_jtap,
        ttap=_ttap)
    jplan = JDeviceEpochPlan(JDeviceDataset(_jmesh(), data), num_workers=1,
                             local_batch=256, route_key="user", seed=2,
                             sync_every=sync_every)
    tplan = DeviceEpochPlan(DeviceDataset(make_ps_mesh(device="cpu"), data),
                            num_workers=1, local_batch=256,
                            route_key="user", seed=2, sync_every=sync_every)
    assert tplan.steps_per_epoch == jplan.steps_per_epoch == 12
    jtb, jls, jms = jtr.run_indexed(jtb, jls, jplan, jax.random.key(1),
                                    epochs=2)
    ttb, tls, tms = ttr.run_indexed(ttb, tls, tplan, 1, epochs=2)
    for jm, tm in zip(jms, tms):
        _same_taps(jm, tm, 12)
        np.testing.assert_array_equal(tm["tap"]["t"][:, 0], np.arange(12))
    # fit_stream: the host copies carry the nested tap.
    chunks = list(jingest.epoch_chunks(
        data, num_workers=1, local_batch=64, steps_per_chunk=4,
        route_key="user", sync_every=sync_every, seed=5))[:2]
    _, _, jms = jtr.fit_stream(jtb, jls, iter(chunks), jax.random.key(2))
    seen = []
    _, _, tms = ttr.fit_stream(ttb, tls, iter(chunks), 2,
                               on_chunk=lambda i, m: seen.append(m))
    for jm, tm, cm in zip(jms, tms, seen):
        _same_taps(jm, tm, 4)
        assert isinstance(cm["tap"]["pair"][1], np.ndarray)


class _TupleOut(WorkerLogic):
    def __init__(self, out):
        self.out = out

    def pull_ids(self, batch):
        return {"t": batch["id"].to(torch.int32)}

    def step(self, batch, pulled, local_state, gen):
        ids = batch["id"].to(torch.int32)
        return StepOutput({"t": (ids, torch.ones((ids.shape[0], 2)))},
                          local_state, self.out)


@pytest.mark.parametrize("out,err", [((torch.zeros(()),), TypeError),
                                     ({"tap": torch.zeros(())}, ValueError)])
def test_step_tap_errors(out, err):
    mesh = make_ps_mesh(device="cpu")
    store = ParamStore(mesh, [TableSpec("t", 8, 2)])
    trainer = Trainer(mesh, store, _TupleOut(out),
                      config=TrainerConfig(step_tap=lambda *a: {}))
    tables, local = trainer.init_state(0)
    with pytest.raises(err, match="tap|dict"):
        trainer.run_chunk(tables, local,
                          {"id": np.zeros((2, 4), np.int32)}, 0)
    # Without a tap the same worker runs.
    trainer.config = TrainerConfig()
    trainer.run_chunk(tables, local, {"id": np.zeros((2, 4), np.int32)}, 0)


# ---------------------------------------------------------------------------
# word2vec's co-occurrence sketch tap.
# ---------------------------------------------------------------------------

V2 = 80


def _w2v_corpus(n):
    tokens = jdatasets.synthetic_corpus(V2, n, num_topics=4, seed=5)
    uni = np.bincount(tokens, minlength=V2).astype(np.float64)
    return tokens, uni


def _w2v_cfg(mod):
    return mod.W2VConfig(vocab_size=V2, dim=8, window=2, negatives=2,
                         subsample_t=None)


def test_block_pair_stream_and_tap_match_jax_on_block_batches():
    tokens, uni = _w2v_corpus(6000)
    probe = np.argsort(-uni)[:6].astype(np.int32)
    jtap = jw2v.cooccurrence_sketch_tap(JTugOfWarSpec(5, 512, 7), probe)
    ttap = tw2v.cooccurrence_sketch_tap(TugOfWarSpec(5, 512, 7), probe)
    plan = tw2v.Word2VecDevicePlan(tokens, uni, _w2v_cfg(tw2v),
                                   make_ps_mesh(device="cpu"),
                                   num_workers=1, block_len=64, seed=0,
                                   mode="block")
    batches = plan.call_batches(plan.epoch_args(0), 0, plan.steps_per_epoch)
    for t in (0, 5, plan.steps_per_epoch - 1):
        tb = {k: v[t] for k, v in batches.items()}
        jb = {k: jnp.asarray(v.numpy()) for k, v in tb.items()}
        for got, want in zip(tw2v.block_pair_stream(tb),
                             jw2v.block_pair_stream(jb)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ttap(None, tb, None, t).numpy(),
                                      np.asarray(jtap(None, jb, None, t)))


def test_block_path_sketch_tap_through_run_indexed():
    """The tap rides ``run_indexed`` on the block worker: its accumulated
    stack equals the JAX package's tap summed over the same plan's batches
    bit for bit, its pair weight the worker's own pair count, and the
    estimates track the exact co-occurrence (the JAX package's gates)."""
    tokens, uni = _w2v_corpus(30_000)
    cfg = _w2v_cfg(tw2v)
    probe = np.argsort(-uni)[:6].astype(np.int32)
    spec = TugOfWarSpec(depth=5, width=512, seed=7)
    probe_t = torch.from_numpy(probe)

    def tap(tables, batch, local_state, t):
        center, ctx, w = tw2v.block_pair_stream(batch)
        exact = torch.zeros((len(probe), V2))
        for p in range(len(probe)):
            sel = center == probe_t[p]
            exact[p].index_add_(0, ctx[sel].long(), w[sel])
        return {"sketch": tw2v._sketch_pair_stream(spec, probe_t, center,
                                                   ctx, w),
                "exact": exact, "wsum": w.sum()}

    mesh = make_ps_mesh(device="cpu")
    trainer, _ = tw2v.word2vec_block(mesh, cfg, uni, 64, step_tap=tap,
                                     max_steps_per_call=64)
    tables, ls = trainer.init_state(0)
    plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                   block_len=64, seed=0, mode="block")
    tables, ls, metrics = trainer.run_indexed(tables, ls, plan, 1, epochs=1)
    (m,) = metrics
    assert m["tap"]["sketch"].shape == (plan.steps_per_epoch, 1, 6, 5, 512)
    sk = tw2v.accumulate_sketch_taps([{"tap": m["tap"]["sketch"]}])
    exact = m["tap"]["exact"].sum(axis=(0, 1)).astype(np.float64)
    assert float(m["tap"]["wsum"].sum()) == float(m["n"].sum())

    jtap = jw2v.cooccurrence_sketch_tap(JTugOfWarSpec(5, 512, 7), probe)
    batches = plan.call_batches(plan.epoch_args(0), 0, plan.steps_per_epoch)
    want = sum(np.asarray(jtap(None, {k: jnp.asarray(v[t].numpy())
                                      for k, v in batches.items()}, None, t))
               for t in range(plan.steps_per_epoch))
    np.testing.assert_array_equal(sk, want)

    est = tw2v.sketch_similarity(sk)
    np.testing.assert_array_equal(est, jw2v.sketch_similarity(want))
    truth = exact @ exact.T
    rel = np.abs(np.diag(est) - np.diag(truth)) / np.maximum(np.diag(truth),
                                                             1.0)
    assert np.median(rel) < 0.15, (np.diag(est), np.diag(truth))
    iu = np.triu_indices(len(probe), 1)
    assert np.corrcoef(est[iu], truth[iu])[0, 1] > 0.8


def test_pair_sketch_tap_through_fit_stream_matches_jax():
    """The pair worker's tap on ``skipgram_chunks`` (the same numpy chunks
    in both packages): every step's stack equal bit for bit."""
    tokens, uni = _w2v_corpus(20_000)
    probe = np.argsort(-uni)[:6].astype(np.int32)
    chunk_args = dict(num_workers=1, local_batch=512, steps_per_chunk=4,
                      seed=3)
    chunks = list(tw2v.skipgram_chunks(tokens, uni, _w2v_cfg(tw2v),
                                       **chunk_args))[:3]
    jtr, _ = jw2v.word2vec(_jmesh(), _w2v_cfg(jw2v), uni,
                           step_tap=jw2v.cooccurrence_sketch_tap(
                               JTugOfWarSpec(5, 512, 7), probe))
    ttr, _ = tw2v.word2vec(make_ps_mesh(device="cpu"), _w2v_cfg(tw2v), uni,
                           step_tap=tw2v.cooccurrence_sketch_tap(
                               TugOfWarSpec(5, 512, 7), probe))
    jtb, jls = jtr.init_state(jax.random.key(0))
    ttb, tls = ttr.init_state(0)
    _, _, jms = jtr.fit_stream(jtb, jls, iter(chunks), jax.random.key(1))
    _, _, tms = ttr.fit_stream(ttb, tls, iter(chunks), 1)
    for jm, tm in zip(jms, tms):
        assert tm["tap"].shape == (4, 1, 6, 5, 512)
        np.testing.assert_array_equal(tm["tap"], np.asarray(jm["tap"]))
    np.testing.assert_array_equal(tw2v.accumulate_sketch_taps(tms),
                                  jw2v.accumulate_sketch_taps(jms))
    with pytest.raises(ValueError, match="nothing"):
        tw2v.accumulate_sketch_taps([])


def test_example_cli_sketch_words_on_both_workers():
    import contextlib
    import io
    import json

    from fps_tpu_torch.examples import word2vec

    for extra in ([], ["--ingest", "host"]):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = word2vec.main(["--device", "cpu", "--vocab-size", "300",
                                "--num-tokens", "20000", "--dim", "8",
                                "--local-batch", "2560", "--sketch-words",
                                "4", "--steps-per-chunk", "4"] + extra)
        assert rc == 0
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        (sim,) = [e for e in events if e["event"] == "cooccurrence_similarity"]
        est = np.asarray(sim["inner_products"])
        assert est.shape == (4, 4) and np.all(np.diag(est) > 0)
        assert len(sim["probe_words"]) == 4


# ---------------------------------------------------------------------------
# Top-k retrieval.
# ---------------------------------------------------------------------------

def _topk_stores(num_ids, dim, seed):
    """JAX and port stores holding the same small-integer table (so scores
    are exact and ties are real: every row appears twice)."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-3, 4, (-(-num_ids // 2), dim)).astype(np.float32)
    logical = np.concatenate([half, half])[:num_ids]

    def jinit(key, ids):
        return jnp.take(jnp.asarray(logical), jnp.minimum(ids, num_ids - 1),
                        axis=0)

    jstore = JParamStore(_jmesh(), [JTableSpec("items", num_ids, dim,
                                               jinit)])
    jstore.init(jax.random.key(0))
    tstore = ParamStore(make_ps_mesh(device="cpu"),
                        [TableSpec("items", num_ids, dim)])
    tstore.tables = tables_from_jax(tstore, {"items": np.asarray(
        jstore.tables["items"])})
    return jstore, tstore, logical


def _brute(q, logical, k, exclude=None):
    s = q.astype(np.float64) @ logical.T.astype(np.float64)
    if exclude is not None:
        for row, ex in enumerate(exclude):
            s[row, ex[ex >= 0]] = -np.inf
    # (-score, id): a stable sort of -score keeps ids ascending in a tie.
    return np.argsort(-s, axis=1, kind="stable")[:, :k]


@pytest.mark.parametrize("num_ids,k", [(57, 5), (40, 12), (7, 10)])
def test_recommend_topk_matches_jax_and_bruteforce_with_ties(num_ids, k):
    dim, B = 3, 9
    jstore, tstore, logical = _topk_stores(num_ids, dim, seed=num_ids)
    q = np.random.default_rng(1).integers(-2, 3, (B, dim)).astype(np.float32)
    ids, scores = trec.recommend_topk(tstore, "items", q, k)
    jids, jscores = jrec.recommend_topk(jstore, "items", q, k)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(scores, np.asarray(jscores))
    real = min(k, num_ids)
    np.testing.assert_array_equal(ids[:, :real], _brute(q, logical, real))
    # k past the table: -1 ids, NEG_INF scores.
    assert (ids[:, real:] == -1).all()
    assert (scores[:, real:] == trec.NEG_INF).all()


def test_recommend_topk_with_exclusions_matches_jax():
    num_ids, dim, B, k, E = 40, 4, 6, 4, 3
    jstore, tstore, logical = _topk_stores(num_ids, dim, seed=2)
    rng = np.random.default_rng(3)
    q = rng.integers(-2, 3, (B, dim)).astype(np.float32)
    # Exclude each query's true top-E, with a -1 slot in one row.
    exclude = _brute(q, logical, E).astype(np.int32)
    exclude[0, -1] = -1
    ids, _ = trec.recommend_topk(tstore, "items", q, k, exclude=exclude)
    jids, _ = jrec.recommend_topk(jstore, "items", q, k, exclude=exclude)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(ids, _brute(q, logical, k, exclude))
    assert not any(np.isin(row, ex).any() for row, ex in zip(ids, exclude))


@pytest.mark.parametrize("num_items,k,every", [(29, 5, 2), (6, 10, 1)])
def test_online_topk_tap_matches_jax_and_bruteforce(num_items, k, every):
    """lr = 0 (frozen tables): each tapped step's ids are the brute-force
    ranking of the live item table for that step's first users; other
    steps emit -1 and NEG_INF; k past the items pads the same way."""
    (jtr, jstore, jtb, jls), (ttr, tstore, ttb, tls) = _mf_pair(
        lr=0.0, num_items=num_items)
    Q = 3
    jtr.config = dataclasses.replace(jtr.config, step_tap=(
        jrec.make_online_topk_tap(jstore, ITEM, k, every=every,
                                  query_fn=jrec.mf_topk_query_fn(1, Q))))
    ttr.config = dataclasses.replace(ttr.config, step_tap=(
        trec.make_online_topk_tap(tstore, ITEM, k, every=every,
                                  query_fn=trec.mf_topk_query_fn(1, Q))))
    data = jdatasets.synthetic_ratings(NU, num_items, 400, seed=0)
    chunk = next(jingest.epoch_chunks(data, num_workers=1, local_batch=8,
                                      steps_per_chunk=8, route_key="user"))
    jtb, jls, jm = jtr.run_chunk(jtb, jls, chunk, jax.random.key(1))
    ttb, tls, tm = ttr.run_chunk(ttb, tls, chunk, 1)
    tap = _to_host(tm)["tap"]
    assert tap["topk_ids"].shape == (8, 1, Q, k)
    for key in ("topk_query", "topk_ids"):
        np.testing.assert_array_equal(tap[key], np.asarray(jm["tap"][key]))
    items = tstore.lookup_host(ITEM, np.arange(num_items))
    real = min(k, num_items)
    for t in range(8):
        users = tap["topk_query"][t, 0]
        if t % every:
            assert (users == -1).all() and (tap["topk_ids"][t] == -1).all()
            assert (tap["topk_scores"][t] == trec.NEG_INF).all()
            continue
        valid = users >= 0
        assert valid.any()
        q = trec.mf_user_vectors(tls.numpy(), 1, users[valid])
        want = _brute(q, items, real)
        np.testing.assert_array_equal(tap["topk_ids"][t, 0][valid][:, :real],
                                      want)
        assert (tap["topk_ids"][t, 0][:, real:] == -1).all()


def test_example_cli_topk_events():
    import contextlib
    import io
    import json

    from fps_tpu_torch.examples import mf

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mf.main(["--device", "cpu", "--scale", "100k", "--local-batch",
                      "2048", "--topk", "5", "--topk-every", "4"])
    assert rc == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    online = [e for e in events if e["event"] == "topk_online"]
    assert online and all(e["step"] % 4 == 0 for e in online)
    assert all(len(row) == 5 for e in online for row in e["items"])
    after = [e for e in events if e["event"] == "topk"]
    assert len(after) == 8 and all(len(e["items"]) == 5 for e in after)
    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit):
            mf.main(["--device", "cpu", "--topk-every", "4"])


# ---------------------------------------------------------------------------
# Worker combinators.
# ---------------------------------------------------------------------------

def _comb_run(jwrap, twrap):
    cfg = dict(num_users=16, num_items=12, rank=4)
    data = jdatasets.synthetic_ratings(16, 12, 256, seed=3)
    jmesh = _jmesh()
    jstore = jmf.make_store(jmesh, jmf.MFConfig(**cfg))
    jtr = JTrainer(jmesh, jstore, jwrap(jmf.MatrixFactorizationWorker(
        jmf.MFConfig(**cfg), 1)))
    tmesh = make_ps_mesh(device="cpu")
    tstore = tmf.make_store(tmesh, tmf.MFConfig(**cfg))
    ttr = Trainer(tmesh, tstore, twrap(tmf.MatrixFactorizationWorker(
        tmf.MFConfig(**cfg), 1)))
    chunk = next(jingest.epoch_chunks(data, num_workers=1, local_batch=8,
                                      steps_per_chunk=2, route_key="user"))
    jtb, jls = jtr.init_state(jax.random.key(0))
    init = np.asarray(jtb[ITEM]).copy()
    ttb = tables_from_jax(tstore, {ITEM: np.asarray(jtb[ITEM])})
    tls = local_state_from_jax(ttr.logic, np.asarray(jls), device="cpu")
    jtb, jls, jm = jtr.run_chunk(jtb, jls, chunk, jax.random.key(1))
    ttb, tls, tm = ttr.run_chunk(ttb, tls, chunk, 1)
    return (init, np.asarray(jtb[ITEM]), {k: np.asarray(v) for k, v in
                                          jm.items()},
            ttb[ITEM].numpy(), {k: v.numpy() for k, v in tm.items()})


def test_combinators_match_jax():
    # tap_outputs adds push statistics to the metrics stream.
    _, jt, jm, tt, tm = _comb_run(jcomb.tap_outputs, tcomb.tap_outputs)
    assert "push_norm/item_factors" in tm and "push_count/item_factors" in tm
    np.testing.assert_array_equal(tm["push_count/item_factors"],
                                  jm["push_count/item_factors"])
    assert np.all(tm["push_count/item_factors"] > 0)
    np.testing.assert_allclose(tm["push_norm/item_factors"],
                               jm["push_norm/item_factors"], rtol=1e-6)
    np.testing.assert_allclose(tt, jt, rtol=0, atol=1e-7)

    # clip_pushes with a tiny max_norm shrinks the pushes, the same in both.
    _, jc, jmc, tc, tmc = _comb_run(
        lambda l: jcomb.tap_outputs(jcomb.clip_pushes(l, 1e-3)),
        lambda l: tcomb.tap_outputs(tcomb.clip_pushes(l, 1e-3)))
    np.testing.assert_allclose(tmc["push_norm/item_factors"],
                               jmc["push_norm/item_factors"], rtol=1e-6)
    assert np.sum(tmc["push_norm/item_factors"]) < np.sum(
        tm["push_norm/item_factors"])
    np.testing.assert_allclose(tc, jc, rtol=0, atol=1e-7)

    # clip_pushes limited to another table changes nothing.
    _, _, _, tn, _ = _comb_run(
        lambda l: jcomb.clip_pushes(l, 1e-3, tables=("other",)),
        lambda l: tcomb.clip_pushes(l, 1e-3, tables=("other",)))
    np.testing.assert_array_equal(tn, tt)

    # scale_pushes(0) leaves the item table at its initialization;
    # scale_pushes(0.5) equals the JAX package's.
    init, j0, _, t0, _ = _comb_run(lambda l: jcomb.scale_pushes(l, 0.0),
                                   lambda l: tcomb.scale_pushes(l, 0.0))
    np.testing.assert_array_equal(t0, init)
    np.testing.assert_array_equal(j0, init)
    _, jh, _, th, _ = _comb_run(lambda l: jcomb.scale_pushes(l, 0.5),
                                lambda l: tcomb.scale_pushes(l, 0.5))
    np.testing.assert_allclose(th, jh, rtol=0, atol=1e-7)


def test_combinators_keep_the_inner_workers_draws():
    """A wrapper hands the driver the inner worker's ``step_seeded`` (the
    word2vec workers draw from a per-step seed); a wrapped run equals the
    bare one."""
    tokens, uni = _w2v_corpus(6000)
    cfg = _w2v_cfg(tw2v)
    mesh = make_ps_mesh(device="cpu")
    runs = []
    for wrap in (lambda l: l, lambda l: tcomb.scale_pushes(l, 1.0)):
        trainer, _ = tw2v.word2vec_block(mesh, cfg, uni, 64)
        trainer.logic = wrap(trainer.logic)
        assert trainer.logic.step_seeded
        plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh,
                                       num_workers=1, block_len=64, seed=0,
                                       mode="block")
        tables, ls = trainer.init_state(0)
        tables, _, m = trainer.run_indexed(tables, ls, plan, 1)
        runs.append((tables, m))
    for name in runs[0][0]:
        np.testing.assert_array_equal(runs[0][0][name].numpy(),
                                      runs[1][0][name].numpy())
    np.testing.assert_array_equal(runs[0][1][0]["loss"], runs[1][1][0]["loss"])


# ---------------------------------------------------------------------------
# Top-k retrieval over a sharded table: the JAX package's mesh of the same
# shape.
# ---------------------------------------------------------------------------

MESHES = [(1, 8), (2, 4)]  # (data, shard)


def _jmesh_of(D, S):
    return jmake_ps_mesh(num_shards=S, num_data=D,
                         devices=jax.devices()[:D * S])


def _topk_mesh_stores(D, S, num_ids, dim, seed):
    """:func:`_topk_stores` on ``(D, S)`` meshes: the same small-integer
    table (every row twice, so ties are real), sharded."""
    rng = np.random.default_rng(seed)
    half = rng.integers(-3, 4, (-(-num_ids // 2), dim)).astype(np.float32)
    logical = np.concatenate([half, half])[:num_ids]

    def jinit(key, ids):
        return jnp.take(jnp.asarray(logical), jnp.minimum(ids, num_ids - 1),
                        axis=0)

    jstore = JParamStore(_jmesh_of(D, S), [JTableSpec("items", num_ids, dim,
                                                      jinit)])
    jstore.init(jax.random.key(0))
    tstore = ParamStore(make_ps_mesh(S, D, device="cpu"),
                        [TableSpec("items", num_ids, dim)])
    tstore.tables = tables_from_jax(tstore, {"items": np.asarray(
        jstore.tables["items"])})
    return jstore, tstore, logical


def _brute_sharded(q, logical, k, S, exclude=None):
    """The float64 ranking in the order the shard-major pool gives: by
    score, then ties by shard (``id % S``), then by row within the shard
    (``id // S``), as ``lax.top_k`` orders the JAX package's pool."""
    s = q.astype(np.float64) @ logical.T.astype(np.float64)
    if exclude is not None:
        for row, ex in enumerate(exclude):
            s[row, ex[ex >= 0]] = -np.inf
    ids = np.arange(logical.shape[0])
    return np.stack([np.lexsort((ids // S, ids % S, -r))[:k] for r in s])


@pytest.mark.parametrize("num_ids,k,E", [(57, 5, 0), (40, 4, 3), (6, 10, 0)],
                         ids=["plain", "exclusions", "k_above_pool"])
@pytest.mark.parametrize("D,S", MESHES)
def test_recommend_topk_on_the_mesh_matches_jax_with_ties(D, S, num_ids, k,
                                                          E):
    """Each shard ranks its own block, the candidates are all-gathered in
    shard order, exclusions masked, and the pool merged: ids equal the JAX
    package's, ties included (by position in the pool, not by id: ties
    across shards go to the lower shard), and the float64 ranking in that
    order; scores equal. Where ``k`` exceeds the pool (6 items on 8 or 4
    shards, 16 or 8 candidates), the slots past the real items hold
    ``NEG_INF``."""
    dim, B = 3, 9
    jstore, tstore, logical = _topk_mesh_stores(D, S, num_ids, dim,
                                                seed=num_ids + S)
    rng = np.random.default_rng(1)
    q = rng.integers(-2, 3, (B, dim)).astype(np.float32)
    exclude = None
    if E:
        exclude = _brute_sharded(q, logical, E, S).astype(np.int32)
        exclude[0, -1] = -1
    ids, scores = trec.recommend_topk(tstore, "items", q, k, exclude=exclude)
    jids, jscores = jrec.recommend_topk(jstore, "items", q, k,
                                        exclude=exclude)
    np.testing.assert_array_equal(ids, np.asarray(jids))
    np.testing.assert_array_equal(scores, np.asarray(jscores))
    real = min(k, num_ids)
    np.testing.assert_array_equal(
        ids[:, :real], _brute_sharded(q, logical, real, S, exclude))
    assert (scores[:, real:] == trec.NEG_INF).all()
    if exclude is not None:
        assert not any(np.isin(row, ex[ex >= 0]).any()
                       for row, ex in zip(ids, exclude))


def _mf_mesh_pair(D, S, num_items, k, every, Q):
    """JAX and port MF trainers on ``(D, S)`` meshes at lr 0 (frozen
    tables), from the same state, each with its package's online top-k
    tap."""
    cfg = dict(num_users=NU, num_items=num_items, rank=RANK,
               learning_rate=0.0, reg=0.0)
    W = D * S
    jtr, jstore = jmf.online_mf(_jmesh_of(D, S), jmf.MFConfig(**cfg),
                                donate=False)
    ttr, tstore = tmf.online_mf(make_ps_mesh(S, D, device="cpu"),
                                tmf.MFConfig(**cfg), donate=False)
    jtr.config = dataclasses.replace(jtr.config, step_tap=(
        jrec.make_online_topk_tap(jstore, ITEM, k, every=every,
                                  query_fn=jrec.mf_topk_query_fn(W, Q))))
    ttr.config = dataclasses.replace(ttr.config, step_tap=(
        trec.make_online_topk_tap(tstore, ITEM, k, every=every,
                                  query_fn=trec.mf_topk_query_fn(W, Q))))
    jtables, jlocal = jtr.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {n: np.asarray(v)
                                       for n, v in jtables.items()})
    tlocal = local_state_from_jax(ttr.logic, np.asarray(jlocal),
                                  mesh=ttr.mesh)
    return (jtr, jtables, jlocal), (ttr, tstore, ttables, tlocal)


@pytest.mark.parametrize("num_items,k,every", [(29, 5, 2), (6, 10, 1)])
@pytest.mark.parametrize("D,S", MESHES)
def test_online_topk_tap_on_the_mesh_matches_jax_and_bruteforce(
        D, S, num_items, k, every):
    """The collective tap on a ``(D, S)`` mesh: each worker's queries (its
    first users, its own local rows) are all-gathered over the shards, every
    shard ranks them against its own rows, and each worker merges its
    slice. Leaves ``(T, W, q, k)``; ids and query ids equal the JAX tap's;
    on tapped steps the ids of the real items are the float64 ranking of the
    live table in the pool's order, past them ``NEG_INF``; other steps emit
    -1 and ``NEG_INF``."""
    W, Q, T = D * S, 3, 4
    (jtr, jt, jl), (ttr, tstore, tt, tl) = _mf_mesh_pair(D, S, num_items, k,
                                                         every, Q)
    data = jdatasets.synthetic_ratings(NU, num_items, 8 * T * W, seed=0)
    chunk = next(jingest.epoch_chunks(data, num_workers=W, local_batch=8,
                                      steps_per_chunk=T, route_key="user"))
    _, _, jm = jtr.run_chunk(jt, jl, chunk, jax.random.key(1))
    _, tl, tm = ttr.run_chunk(tt, tl, chunk, 1)
    tap = _to_host(tm)["tap"]
    assert tap["topk_ids"].shape == (T, W, Q, k)
    for key in ("topk_query", "topk_ids"):
        np.testing.assert_array_equal(tap[key], np.asarray(jm["tap"][key]))
    items = tstore.lookup_host(ITEM, np.arange(num_items))
    # Scores: float32 dot products of RANK terms in another order, each
    # within RANK * eps32 * sum|terms| of the exact one.
    scale = float((np.abs(tl.numpy()) @ np.abs(items).T).max())
    np.testing.assert_allclose(tap["topk_scores"],
                               np.asarray(jm["tap"]["topk_scores"]), rtol=0,
                               atol=2 * RANK * np.finfo(np.float32).eps
                               * scale)
    real = min(k, num_items)
    checked = 0
    for t in range(T):
        users = tap["topk_query"][t]
        if t % every:
            assert (users == -1).all() and (tap["topk_ids"][t] == -1).all()
            assert (tap["topk_scores"][t] == trec.NEG_INF).all()
            continue
        for w in range(W):
            valid = users[w] >= 0
            q = trec.mf_user_vectors(tl.numpy(), W, users[w][valid])
            np.testing.assert_array_equal(
                tap["topk_ids"][t, w][valid][:, :real],
                _brute_sharded(q, items, real, S))
            assert (tap["topk_scores"][t, w][:, real:] == trec.NEG_INF).all()
            checked += int(valid.sum())
    assert checked > 0


def test_collective_tap_sees_every_position_once_a_step():
    """A tap with ``collective = True`` is called once a step with every
    position's blocks and every worker's batch and local state, and returns
    one output a worker; a per-worker tap beside it is called ``W`` times a
    step with its worker's blocks."""
    calls = []

    def ctap(tables, batches, local_states, t):
        calls.append(("collective", t, len(tables[ITEM]), len(batches),
                      len(local_states)))
        return [{"w": torch.tensor(w), "rows": blk.shape[0]
                 and torch.tensor(blk.shape[0])}
                for w, blk in enumerate(tables[ITEM])]

    ctap.collective = True

    def wtap(tables, batch, local_state, t):
        calls.append(("worker", t, tables[ITEM].shape[0]))
        return {"w": torch.tensor(0)}

    for tap, expect in ((ctap, "collective"), (wtap, "worker")):
        calls.clear()
        ttr, _ = tmf.online_mf(make_ps_mesh(4, 2, device="cpu"),
                               tmf.MFConfig(num_users=NU, num_items=NI,
                                            rank=RANK))
        ttr.config = dataclasses.replace(ttr.config, step_tap=tap)
        tables, local = ttr.init_state(0)
        data = jdatasets.synthetic_ratings(NU, NI, 8 * 2 * 8, seed=0)
        chunk = next(jingest.epoch_chunks(data, num_workers=8, local_batch=8,
                                          steps_per_chunk=2,
                                          route_key="user"))
        _, _, m = ttr.run_chunk(tables, local, chunk, 0)
        assert m["tap"]["w"].shape == (2, 8)
        if expect == "collective":
            assert calls == [("collective", t, 8, 8, 8) for t in range(2)]
            np.testing.assert_array_equal(m["tap"]["w"].numpy(),
                                          np.tile(np.arange(8), (2, 1)))
            assert (m["tap"]["rows"].numpy() == NI // 4).all()
        else:
            assert calls == [("worker", t, NI // 4) for t in range(2)
                             for _ in range(8)]


def test_mf_example_topk_on_four_shards():
    import contextlib
    import io
    import json

    from fps_tpu_torch.examples import mf

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mf.main(["--device", "cpu", "--scale", "100k", "--num-shards",
                      "4", "--local-batch", "512", "--topk", "5",
                      "--topk-every", "4"])
    assert rc == 0
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert events[0]["mesh"] == {"data": 1, "shard": 4}
    online = [e for e in events if e["event"] == "topk_online"]
    assert online and all(e["step"] % 4 == 0 for e in online)
    # Two queries a worker, four workers.
    assert all(len(e["users"]) == 8 for e in online)
    assert all(len(row) == 5 and min(row) >= 0 for e in online
               for row in e["items"])
    after = [e for e in events if e["event"] == "topk"]
    assert len(after) == 8 and all(len(e["items"]) == 5 for e in after)
