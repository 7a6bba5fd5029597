"""word2vec over the port's sharded mesh, against the JAX package's mesh of
the same shape.

The JAX side runs on the 8 virtual CPU devices of the test process
(``tests/conftest.py``); the port's on ``make_ps_mesh(S, D, device="cpu")``.
Both start from the same tables (``fps_tpu_torch.convert``) and take the
same draws: the two packages draw their negatives and half-windows from
different generators, so, as in ``tests/test_torch_word2vec.py``, test-only
subclasses of each side's plan and worker take both from numpy arrays made
from a seed, here one set a worker and step (and ``subsample_t=None``, so
that the compaction keeps every token on both sides).

Held: ``Word2VecDevicePlan``'s batches at ``W`` workers against the JAX
plan's ``local_batch_at`` bit for bit; ``run_indexed`` with the block and the
pair worker at ``(1, 8)`` sync and ``(2, 4)`` SSP, and ``hot_words`` at
``(2, 4)``; ``fit_stream`` over host ``skipgram_chunks``; the co-occurrence
sketch tap at ``(2, 4)``; the example at four shards.

Tolerances, stated: the tables within 2e-8 of the JAX package's (the
one-position bound of ``tests/test_torch_word2vec.py``: rows are
O(0.03-0.3), and the mean pushes fold the
gathered stream in the JAX package's order, so the two part only where the
frameworks order a dot product); every data replica of a shard equal to the
others bit for bit; ``n`` equal; each step's loss within 2e-6 of it (a
float32 sum in another order); the sketch tap's sums bit for bit (sums of
0/1 weights with signs are exact in any order).
"""

import contextlib
import importlib
import io
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.parallel import mesh as jmesh
from fps_tpu.sketch import TugOfWarSpec as JTugOfWarSpec

from fps_tpu_torch.convert import tables_from_jax
from fps_tpu_torch.models import word2vec as tw2v
from fps_tpu_torch.parallel import mesh as tmesh
from fps_tpu_torch.sketch import TugOfWarSpec
from fps_tpu_torch.utils import datasets as tdatasets

# fps_tpu.models exports a function of the same name as the module.
jw2v = importlib.import_module("fps_tpu.models.word2vec")

V, DIM, WIN, NEG, BL = 300, 16, 3, 4, 32
CFG_KW = dict(vocab_size=V, dim=DIM, window=WIN, negatives=NEG,
              learning_rate=0.05, subsample_t=None)


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


def _tmesh(D, S):
    return tmesh.make_ps_mesh(S, D, device="cpu")


def _corpus(n, seed=2, vocab=V):
    tokens = tdatasets.synthetic_corpus(vocab, n, num_topics=8, seed=seed)
    return tokens, np.bincount(tokens, minlength=vocab).astype(np.float64)


def _replicas(D, S, blocks):
    """The global table of each data replica; all must be the same bits."""
    out = [torch.cat(list(blocks)[d * S:(d + 1) * S]).numpy()
           for d in range(D)]
    for d in range(1, D):
        np.testing.assert_array_equal(out[d], out[0])
    return out[0]


# ---------------------------------------------------------------------------
# The plan's batches at W workers.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["block", "pairs"])
@pytest.mark.parametrize("W", [2, 8])
def test_plan_cuts_each_worker_its_own_block(W, mode):
    """Worker ``w``'s step ``t`` reads the block at compacted position ``(t *
    W + w) * L``, as the JAX plan's ``local_batch_at`` does: the blocks and
    valid lengths (block mode) or the pair ids (pairs mode, whose weights
    depend on the half-windows: held on the port's own draws) equal the
    JAX plan's bit for bit; the driver's cut of ``call_batches`` is
    ``local_batch_at``; the half-windows are keyed by compacted position, so
    they do not depend on ``W``."""
    tokens, uni = _corpus(3000)
    kw = dict(block_len=BL, seed=4, mode=mode)
    tcfg, jcfg = tw2v.W2VConfig(**CFG_KW), jw2v.W2VConfig(**CFG_KW)
    tplan = tw2v.Word2VecDevicePlan(tokens, uni, tcfg, _tmesh(1, W),
                                    num_workers=W, **kw)
    jplan = jw2v.Word2VecDevicePlan(tokens, uni, jcfg, _jmesh(1, 1),
                                    num_workers=W, **kw)
    one = tw2v.Word2VecDevicePlan(tokens, uni, tcfg, _tmesh(1, 1),
                                  num_workers=1, **kw)
    T = tplan.steps_per_epoch
    assert (T, tplan._buf_len) == (jplan.steps_per_epoch, jplan._buf_len)
    assert T > 2
    targs, jargs = tplan.epoch_args(0), jplan.epoch_args(0)
    np.testing.assert_array_equal(targs["compacted"].numpy(),
                                  np.asarray(jargs["compacted"]))
    calls = tplan.call_batches(targs, 0, T)
    ones = one.call_batches(one.epoch_args(0), 0, T * W)
    cut = {k: torch.tensor_split(v, W, 1) for k, v in calls.items()}
    for t in (0, 1, T - 1):
        for w in range(W):
            got = tplan.local_batch_at(targs, w, t)
            want = jplan.local_batch_at(jargs, w, t)
            for k, v in got.items():
                np.testing.assert_array_equal(
                    v.numpy(), cut[k][w][t].reshape(v.shape).numpy())
                if k in ("block", "valid_len", "center", "context"):
                    np.testing.assert_array_equal(v.numpy(),
                                                  np.asarray(want[k]))
            # The same block at one worker is step t * W + w.
            np.testing.assert_array_equal(
                got["half" if mode == "block" else "weight"].numpy(),
                ones["half" if mode == "block" else "weight"][t * W + w]
                .numpy())
    with pytest.raises(ValueError, match="worker"):
        tplan.local_batch_at(targs, W, 0)


# ---------------------------------------------------------------------------
# run_indexed, both packages from the same tables and the same draws.
# ---------------------------------------------------------------------------

class _Draws:
    """Half-windows and negatives for each (epoch, step, worker), in rows
    ``(e * T + t) * W + w``: ``half (E * T * W, L)``, ``negs (E * T * W, n,
    K)``."""

    def __init__(self, epochs, steps, workers, n_neg, seed=9):
        rng = np.random.default_rng(seed)
        rows = epochs * steps * workers
        self.steps, self.workers = steps, workers
        self.half = rng.integers(1, WIN + 1, (rows, BL)).astype(np.int32)
        self.negs = rng.integers(0, V, (rows, n_neg, NEG)).astype(np.int32)


def _jax_plan_class(draws):
    class Plan(jw2v.Word2VecDevicePlan):
        """The JAX package's plan with the draws taken from ``draws``."""

        def epoch_args(self, epoch):
            return dict(super().epoch_args(epoch), epoch=np.int32(epoch))

        def local_batch_at(self, args, w, t):
            L, W = self.block_len, self.cfg.window
            base = (t * self.num_workers + w) * L
            block = jax.lax.dynamic_slice(args["compacted"], (base,),
                                          (L + W,))
            row = (args["epoch"] * draws.steps + t) * draws.workers + w
            half = jnp.take(jnp.asarray(draws.half), row, axis=0, mode="clip")
            negs = jnp.take(jnp.asarray(draws.negs), row, axis=0, mode="clip")
            if self.mode == "block":
                return {"block": block, "half": half, "negatives": negs,
                        "valid_len": jnp.clip(args["kept"] - base, 0, L + W)}
            pos = jnp.arange(L, dtype=jnp.int32)
            centers, contexts, valids = [], [], []
            for d in range(1, W + 1):
                c = block[:L]
                x = jax.lax.dynamic_slice(block, (d,), (L,))
                ok = (half >= d) & (base + pos + d < args["kept"])
                centers += [c, x]
                contexts += [x, c]
                valids += [ok, ok]
            return {"center": jnp.concatenate(centers),
                    "context": jnp.concatenate(contexts),
                    "weight": jnp.concatenate(valids).astype(jnp.float32),
                    "negatives": negs}
    return Plan


def _port_plan_class(draws):
    class Plan(tw2v.Word2VecDevicePlan):
        """The port's plan with the draws taken from ``draws``."""

        def epoch_args(self, epoch):
            return dict(super().epoch_args(epoch), epoch=epoch)

        def _rows(self, args, base):
            # base // L is t * W + w.
            row = (args["epoch"] * draws.steps * draws.workers
                   + base // self.block_len)
            return torch.clamp(row, max=len(draws.half) - 1)

        def _halves(self, args, base):
            return torch.from_numpy(draws.half)[self._rows(args, base)]

        def call_batches(self, args, start, steps):
            t = torch.arange(start, start + steps)
            base = (t[:, None] * self.num_workers
                    + torch.arange(self.num_workers)) * self.block_len
            negs = torch.from_numpy(draws.negs)[self._rows(args, base)]
            return dict(super().call_batches(args, start, steps),
                        negatives=negs.reshape(steps, -1, NEG))
    return Plan


def _no_draw(worker_cls):
    class Worker(worker_cls):
        """Takes its negatives from the batch."""

        def prepare(self, batch, key):
            return batch
    return Worker


def _workers(mode, cfg_j, cfg_t, uni):
    if mode == "block":
        return (_no_draw(jw2v.Word2VecBlockWorker)(cfg_j, uni, BL),
                _no_draw(tw2v.Word2VecBlockWorker)(cfg_t, uni, BL))
    return (_no_draw(jw2v.Word2VecWorker)(cfg_j, uni),
            _no_draw(tw2v.Word2VecWorker)(cfg_t, uni))


def _trainers(D, S, mode, sync_every, hot_words=0, max_steps_per_call=None):
    tokens, uni = _corpus(2400)
    cfg_kw = dict(CFG_KW, hot_words=hot_words)
    jcfg, tcfg = jw2v.W2VConfig(**cfg_kw), tw2v.W2VConfig(**cfg_kw)
    jworker, tworker = _workers(mode, jcfg, tcfg, uni)
    kw = dict(sync_every=sync_every, donate=True,
              max_steps_per_call=max_steps_per_call)
    jtrainer, _ = jw2v._make_trainer(_jmesh(D, S), jcfg, jworker, **kw)
    ttrainer, tstore = tw2v._make_trainer(_tmesh(D, S), tcfg, tworker, **kw)
    jtables, _ = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    return (tokens, uni, jcfg, tcfg), (jtrainer, jtables), (ttrainer, ttables)


def _same_tables(D, S, ttables, jtables, atol):
    for name in (tw2v.IN_TABLE, tw2v.OUT_TABLE):
        np.testing.assert_allclose(_replicas(D, S, ttables[name]),
                                   np.asarray(jtables[name]), rtol=0,
                                   atol=atol)


def _run_indexed_parity(D, S, mode, sync_every, hot_words=0, epochs=2):
    W = D * S
    (tokens, uni, jcfg, tcfg), (jtr, jt), (ttr, tt) = _trainers(
        D, S, mode, sync_every, hot_words, max_steps_per_call=4)
    plan_kw = dict(num_workers=W, block_len=BL, seed=4,
                   sync_every=sync_every, mode=mode)
    T = tw2v.Word2VecDevicePlan(tokens, uni, tcfg, ttr.mesh,
                                **plan_kw).steps_per_epoch
    assert T >= 10  # 2,400 tokens, 8 blocks of 32 a step
    n_neg = (BL + WIN) if mode == "block" else 2 * WIN * BL
    draws = _Draws(epochs, T, W, n_neg)
    jplan = _jax_plan_class(draws)(tokens, uni, jcfg, jtr.mesh, **plan_kw)
    tplan = _port_plan_class(draws)(tokens, uni, tcfg, ttr.mesh, **plan_kw)
    assert jplan.steps_per_epoch == T
    for e in range(epochs):
        jt, _, jm = jtr.run_indexed(jt, (), jplan, jax.random.key(1),
                                    start_epoch=e)
        tt, _, tm = ttr.run_indexed(tt, (), tplan, 1, start_epoch=e)
        np.testing.assert_array_equal(tm[0]["n"], np.asarray(jm[0]["n"]))
        assert tm[0]["n"].sum() > 0
        np.testing.assert_allclose(tm[0]["loss"], np.asarray(jm[0]["loss"]),
                                   rtol=2e-6)
        _same_tables(D, S, tt, jt, atol=2e-8)
    return tt


@pytest.mark.parametrize("mode", ["block", "pairs"])
@pytest.mark.parametrize("D,S,sync_every", [(1, 8, None), (2, 4, 4)])
def test_run_indexed_matches_jax_on_the_mesh(D, S, sync_every, mode):
    """Both workers over ``Word2VecDevicePlan`` at ``(1, 8)`` sync and
    ``(2, 4)`` SSP (s = 4), two epochs in calls of 4 steps: the tables
    (every replica), each step's ``n`` and loss."""
    tables = _run_indexed_parity(D, S, mode, sync_every)
    assert np.abs(tables[tw2v.OUT_TABLE].numpy()).max() > 0


@pytest.mark.parametrize("mode", ["block", "pairs"])
def test_hot_words_match_jax_on_the_mesh(mode):
    """``hot_words = 64`` at ``(2, 4)``: each shard's head is its first 16
    local rows, both tables' pushes take the hot/cold split (the port: K3's
    plain version for the head, K2's for the tail; the JAX package off a
    TPU: its XLA scatter), as the JAX package resolves them."""
    tables = _run_indexed_parity(2, 4, mode, 4, hot_words=64, epochs=1)
    assert tables[tw2v.IN_TABLE][0].shape == (V // 4, DIM)


@pytest.mark.parametrize("D,S,sync_every", [(1, 8, None), (2, 4, 4)])
def test_fit_stream_on_host_pair_chunks_matches_jax(D, S, sync_every):
    """The pair worker over host ``skipgram_chunks`` (the same numpy chunks,
    a negatives column added from a seed) through ``fit_stream``: the
    driver cuts each worker its columns on both sides."""
    W = D * S
    (tokens, uni, jcfg, tcfg), (jtr, jt), (ttr, tt) = _trainers(
        D, S, "pairs", sync_every)
    rng = np.random.default_rng(3)
    chunks = []
    for c in list(tw2v.skipgram_chunks(tokens, uni, tcfg, num_workers=W,
                                       local_batch=32, steps_per_chunk=4,
                                       sync_every=sync_every, seed=1))[:3]:
        negs = rng.integers(0, V, c["center"].shape + (NEG,))
        chunks.append(dict(c, negatives=negs.astype(np.int32)))
    _, _, jms = jtr.fit_stream(jt, (), iter(chunks), jax.random.key(1))
    tt, _, tms = ttr.fit_stream(tt, (), iter(chunks), 1)
    jt = jtr.store.tables
    for jm, tm in zip(jms, tms):
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
        np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                   rtol=2e-6)
    _same_tables(D, S, tt, jt, atol=2e-8)


# ---------------------------------------------------------------------------
# The co-occurrence sketch tap at (2, 4).
# ---------------------------------------------------------------------------

V2 = 80


def _sketch_inputs():
    tokens = tdatasets.synthetic_corpus(V2, 20_000, num_topics=4, seed=5)
    uni = np.bincount(tokens, minlength=V2).astype(np.float64)
    probe = np.argsort(-uni)[:6].astype(np.int32)
    return tokens, uni, probe


def _sketch_cfg(mod):
    return mod.W2VConfig(vocab_size=V2, dim=8, window=2, negatives=2,
                         subsample_t=None)


def test_block_sketch_tap_through_run_indexed_at_2x4():
    """The tap runs once a worker on the block worker at ``(2, 4)``: its
    leaves are ``(T, 8, P, depth, width)``, and their sum over steps and
    workers (:func:`accumulate_sketch_taps`) equals the JAX package's tap
    summed over every worker's batch of the same plan, bit for bit."""
    tokens, uni, probe = _sketch_inputs()
    cfg = _sketch_cfg(tw2v)
    mesh = _tmesh(2, 4)
    trainer, _ = tw2v.word2vec_block(
        mesh, cfg, uni, 64, max_steps_per_call=64,
        step_tap=tw2v.cooccurrence_sketch_tap(TugOfWarSpec(5, 512, 7),
                                              probe))
    tables, ls = trainer.init_state(0)
    plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=8,
                                   block_len=64, seed=0, mode="block")
    T = plan.steps_per_epoch
    _, _, (m,) = trainer.run_indexed(tables, ls, plan, 1)
    assert m["tap"].shape == (T, 8, 6, 5, 512)
    got = tw2v.accumulate_sketch_taps([m])
    jtap = jw2v.cooccurrence_sketch_tap(JTugOfWarSpec(5, 512, 7), probe)
    args = plan.epoch_args(0)
    want = sum(np.asarray(jtap(None, {k: jnp.asarray(v.numpy())
                                      for k, v in plan.local_batch_at(
                                          args, w, t).items()}, None, t))
               for t in range(T) for w in range(8))
    np.testing.assert_array_equal(got, want)
    # Each worker's stack is its own: worker 0's alone is not the sum.
    assert not np.array_equal(m["tap"][:, 0].sum(0), got)


def test_pair_sketch_tap_through_fit_stream_matches_jax_at_2x4():
    """The pair worker's tap over ``skipgram_chunks`` at ``(2, 4)`` in both
    packages: every step's stack of every worker equal bit for bit, and so
    the accumulated sketches and their similarities."""
    tokens, uni, probe = _sketch_inputs()
    chunk_args = dict(num_workers=8, local_batch=64, steps_per_chunk=4,
                      seed=3)
    chunks = list(tw2v.skipgram_chunks(tokens, uni, _sketch_cfg(tw2v),
                                       **chunk_args))[:3]
    jtr, _ = jw2v.word2vec(_jmesh(2, 4), _sketch_cfg(jw2v), uni,
                           step_tap=jw2v.cooccurrence_sketch_tap(
                               JTugOfWarSpec(5, 512, 7), probe))
    ttr, _ = tw2v.word2vec(_tmesh(2, 4), _sketch_cfg(tw2v), uni,
                           step_tap=tw2v.cooccurrence_sketch_tap(
                               TugOfWarSpec(5, 512, 7), probe))
    jtb, jls = jtr.init_state(jax.random.key(0))
    ttb, tls = ttr.init_state(0)
    _, _, jms = jtr.fit_stream(jtb, jls, iter(chunks), jax.random.key(1))
    _, _, tms = ttr.fit_stream(ttb, tls, iter(chunks), 1)
    for jm, tm in zip(jms, tms):
        assert tm["tap"].shape == (4, 8, 6, 5, 512)
        np.testing.assert_array_equal(tm["tap"], np.asarray(jm["tap"]))
    sk = tw2v.accumulate_sketch_taps(tms)
    np.testing.assert_array_equal(sk, jw2v.accumulate_sketch_taps(jms))
    np.testing.assert_array_equal(tw2v.sketch_similarity(sk),
                                  jw2v.sketch_similarity(sk))


# ---------------------------------------------------------------------------
# Learning on the mesh, and the example.
# ---------------------------------------------------------------------------

def test_loss_falls_at_2x4_ssp_with_the_ports_own_draws():
    """``tests/test_word2vec.py``'s SSP gate on the port's own draws (each
    worker its own ``step_seeded`` stream): the block worker at ``(2, 4)``,
    s = 4, the loss a pair falls over an epoch and the data replicas stay
    bit-equal."""
    tokens, uni = _corpus(60_000, seed=0)
    cfg = tw2v.W2VConfig(**CFG_KW)
    mesh = _tmesh(2, 4)
    trainer, _ = tw2v.word2vec_block(mesh, cfg, uni, 256, sync_every=4)
    tables, ls = trainer.init_state(0)
    plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=8,
                                   block_len=256, seed=0, sync_every=4,
                                   mode="block")
    tables, _, (m,) = trainer.run_indexed(tables, ls, plan, 1)
    k = len(m["loss"]) // 4
    early = m["loss"][:k].sum() / m["n"][:k].sum()
    late = m["loss"][-k:].sum() / m["n"][-k:].sum()
    assert late < early, (early, late)
    for name in tables:
        _replicas(2, 4, tables[name])


@pytest.mark.parametrize("ingest,mode", [("device", "block"),
                                         ("host", "pairs")])
def test_example_runs_on_four_shards(ingest, mode):
    from fps_tpu_torch.examples import word2vec

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = word2vec.main([
            "--device", "cpu", "--num-shards", "4", "--vocab-size", "300",
            "--num-tokens", "40000", "--dim", "16", "--window", "3",
            "--negatives", "4", "--learning-rate", "0.05", "--local-batch",
            "768", "--epochs", "2", "--ingest", ingest, "--mode", mode])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["mesh"] == {"data": 1, "shard": 4}
    chunks = [e for e in events if e["event"] == "chunk"]
    assert chunks[-1]["sgns_loss"] < chunks[0]["sgns_loss"]
    assert sum(e["event"] == "neighbors" for e in events) == 4
