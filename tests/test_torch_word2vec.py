"""The PyTorch port's word2vec SGNS slice against the JAX package's, on the CPU.

Parity: the corpus loaders, the subsampling and alias tables bit for bit;
each worker's step on the same pulled rows, batch and negatives; and
``run_indexed`` over a ``Word2VecDevicePlan`` in both modes, sync and SSP,
from the same tables (``tables_from_jax``), on the JAX package's default
backend and under its Pallas kernels in interpret mode. The two packages
draw their negatives and half-windows from different generators, so these
runs use test-only subclasses of each side's plan and worker that take both
from numpy arrays made from a seed (and ``subsample_t=None``, so that the
compaction keeps every token on both sides).

Contracts of the port's own draws (the JAX package's
``tests/test_w2v_device.py`` and ``tests/test_word2vec.py``): the alias
sampler's distribution, window semantics and pair counts, subsampling,
``steps_per_epoch``, ``skipgram_chunks``, the options that raise, and the
partner-recovery quality gate. That the card draws what the CPU draws is
held by ``tests/test_torch_cuda.py`` and ``chip_smoke.py`` phase 5.
"""

import contextlib
import importlib
import io
import json
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

import fps_tpu.ops as jops
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch.convert import tables_from_jax, to_numpy
from fps_tpu_torch.core import rng as trng
from fps_tpu_torch.models import word2vec as tw2v
from fps_tpu_torch.parallel.mesh import make_ps_mesh
from fps_tpu_torch.utils import datasets as tdatasets

# fps_tpu.models exports a function of the same name as the module.
jw2v = importlib.import_module("fps_tpu.models.word2vec")

V, DIM, WIN, NEG, BL = 300, 16, 3, 4, 64
CFG_KW = dict(vocab_size=V, dim=DIM, window=WIN, negatives=NEG,
              learning_rate=0.05, subsample_t=None)


@pytest.fixture
def pallas_backend():
    prev = jops.get_backend()
    jops.set_backend("pallas")
    yield
    jops.set_backend(prev)


def _jmesh():
    return jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])


def _corpus(n, seed=0, vocab=V):
    tokens = tdatasets.synthetic_corpus(vocab, n, num_topics=8, seed=seed)
    return tokens, np.bincount(tokens, minlength=vocab).astype(np.float64)


# ---------------------------------------------------------------------------
# Numpy pieces, bit for bit.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,n,seed", [(300, 5000, 0), (50_000, 20_000, 3)])
def test_corpus_loaders_bit_equal(vocab, n, seed):
    np.testing.assert_array_equal(
        tdatasets.synthetic_corpus(vocab, n, seed=seed),
        jdatasets.synthetic_corpus(vocab, n, seed=seed))
    got = tdatasets.load_text8(None, vocab, n, seed=seed)
    want = jdatasets.load_text8(None, vocab, n, seed=seed)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]
    np.testing.assert_array_equal(got[2], want[2])


def test_load_text8_reads_a_file_as_the_jax_package_does(tmp_path):
    path = tmp_path / "text8"
    rng = np.random.default_rng(1)
    words = [f"w{int(i)}" for i in rng.zipf(1.5, 3000) % 400]
    path.write_text(" ".join(words))
    for n in (None, 1000):
        got = tdatasets.load_text8(str(path), 100, n)
        want = jdatasets.load_text8(str(path), 100, n)
        np.testing.assert_array_equal(got[0], want[0])
        np.testing.assert_array_equal(got[2], want[2])


@pytest.mark.parametrize("subsample_t", [None, 1e-4, 1e-2])
def test_keep_probs_and_alias_tables_bit_equal(subsample_t):
    _, uni = _corpus(20_000)
    tcfg = tw2v.W2VConfig(vocab_size=V, subsample_t=subsample_t)
    jcfg = jw2v.W2VConfig(vocab_size=V, subsample_t=subsample_t)
    np.testing.assert_array_equal(tw2v._keep_probs(tcfg, uni),
                                  jw2v._keep_probs(jcfg, uni))
    p = uni ** 0.75 / (uni ** 0.75).sum()
    for got, want in zip(tw2v._build_alias(p), jw2v._build_alias(p)):
        np.testing.assert_array_equal(got, want)


# ---------------------------------------------------------------------------
# One worker step, the same inputs on both sides.
# ---------------------------------------------------------------------------

def _compare_step(tworker, jworker, batch, pulled):
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in batch.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    got = tworker.step(tb, {k: torch.from_numpy(v) for k, v in pulled.items()},
                       (), 0)
    want = jworker.step(jb, {k: jnp.asarray(v) for k, v in pulled.items()},
                        (), jax.random.key(0))
    for name in (tw2v.IN_TABLE, tw2v.OUT_TABLE):
        gid, gd = (to_numpy(x) for x in got.pushes[name])
        wid, wd = (np.asarray(x) for x in want.pushes[name])
        np.testing.assert_array_equal(gid, wid)
        # Deltas are O(lr * |row| * count) <= 1e-2 here; the two frameworks
        # order each dot product and sum differently (a few float32
        # roundings): measured <= 1.5e-8.
        np.testing.assert_allclose(gd, wd, rtol=0, atol=5e-8)
    np.testing.assert_array_equal(to_numpy(got.out["n"]),
                                  np.asarray(want.out["n"]))
    # The loss is a float32 sum of thousands of terms in another order
    # (measured: 1.3e-7 of it).
    np.testing.assert_allclose(to_numpy(got.out["loss"]),
                               np.asarray(want.out["loss"]), rtol=1e-6)


def test_pair_worker_step_matches_jax():
    rng = np.random.default_rng(5)
    _, uni = _corpus(5000)
    B = 512
    batch = {"center": rng.integers(0, V, B).astype(np.int32),
             "context": rng.integers(0, V, B).astype(np.int32),
             "weight": (rng.random(B) < 0.8).astype(np.float32),
             "negatives": rng.integers(0, V, (B, NEG)).astype(np.int32)}
    pulled = {tw2v.IN_TABLE: rng.normal(0, 0.3, (B, DIM)).astype(np.float32),
              tw2v.OUT_TABLE: rng.normal(0, 0.3, (B * (1 + NEG), DIM))
              .astype(np.float32)}
    _compare_step(tw2v.Word2VecWorker(tw2v.W2VConfig(**CFG_KW), uni),
                  jw2v.Word2VecWorker(jw2v.W2VConfig(**CFG_KW), uni),
                  batch, pulled)


@pytest.mark.parametrize("group,valid_len", [(1, BL + WIN), (1, 40), (8, 70)])
def test_block_worker_step_matches_jax(group, valid_len):
    rng = np.random.default_rng(group + valid_len)
    _, uni = _corpus(5000)
    kw = dict(CFG_KW, neg_group_size=group)
    tworker = tw2v.Word2VecBlockWorker(tw2v.W2VConfig(**kw), uni, BL)
    jworker = jw2v.Word2VecBlockWorker(jw2v.W2VConfig(**kw), uni, BL)
    NG = tworker.num_groups
    assert NG == jworker.num_groups
    LW = BL + WIN
    batch = {"block": rng.integers(0, V, LW).astype(np.int32),
             "half": rng.integers(1, WIN + 1, BL).astype(np.int32),
             "valid_len": np.int32(valid_len),
             "negatives": rng.integers(0, V, (NG, NEG)).astype(np.int32)}
    pulled = {tw2v.IN_TABLE: rng.normal(0, 0.3, (LW, DIM)).astype(np.float32),
              tw2v.OUT_TABLE: rng.normal(0, 0.3, (LW + NG * NEG, DIM))
              .astype(np.float32)}
    _compare_step(tworker, jworker, batch, pulled)


# ---------------------------------------------------------------------------
# run_indexed, both packages from the same tables and the same draws.
# ---------------------------------------------------------------------------

class _Draws:
    """Half-windows ``(E * T, L)`` and negatives ``(E * T, n, K)`` for
    epoch ``e``'s step ``t`` at row ``e * T + t``, from a seed."""

    def __init__(self, epochs, steps, n_neg, seed=9):
        rng = np.random.default_rng(seed)
        self.steps = steps
        self.half = rng.integers(1, WIN + 1, (epochs * steps, BL)).astype(
            np.int32)
        self.negs = rng.integers(0, V, (epochs * steps, n_neg, NEG)).astype(
            np.int32)


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
            row = args["epoch"] * draws.steps + t
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

        def _rows(self, args, start, steps):
            e = args["epoch"] * draws.steps
            return slice(e + start, e + start + steps)

        def _halves(self, args, base):
            # base: (steps, 1), the one worker's block starts.
            t = int(base[0, 0]) // self.block_len
            return torch.from_numpy(
                draws.half[self._rows(args, t, len(base))])[:, None]

        def call_batches(self, args, start, steps):
            return dict(super().call_batches(args, start, steps),
                        negatives=torch.from_numpy(
                            draws.negs[self._rows(args, start, steps)]))
    return Plan


def _no_draw(worker_cls):
    class Worker(worker_cls):
        """Takes its negatives from the batch."""

        def prepare(self, batch, key):
            return batch
    return Worker


def _run_parity(mode, sync_every, atol, hot_words=0, epochs=2):
    tokens, uni = _corpus(1000, seed=2)
    cfg_kw = dict(CFG_KW, hot_words=hot_words)
    jcfg, tcfg = jw2v.W2VConfig(**cfg_kw), tw2v.W2VConfig(**cfg_kw)
    jmesh, tmesh = _jmesh(), make_ps_mesh(device="cpu")
    plan_kw = dict(num_workers=1, block_len=BL, seed=4,
                   sync_every=sync_every, mode=mode)
    probe = tw2v.Word2VecDevicePlan(tokens, uni, tcfg, tmesh, **plan_kw)
    T = probe.steps_per_epoch
    n_neg = (BL + WIN) if mode == "block" else 2 * WIN * BL
    draws = _Draws(epochs, T, n_neg)
    jplan = _jax_plan_class(draws)(tokens, uni, jcfg, jmesh, **plan_kw)
    tplan = _port_plan_class(draws)(tokens, uni, tcfg, tmesh, **plan_kw)
    assert jplan.steps_per_epoch == T == 16
    if mode == "block":
        jworker = _no_draw(jw2v.Word2VecBlockWorker)(jcfg, uni, BL)
        tworker = _no_draw(tw2v.Word2VecBlockWorker)(tcfg, uni, BL)
    else:
        jworker = _no_draw(jw2v.Word2VecWorker)(jcfg, uni)
        tworker = _no_draw(tw2v.Word2VecWorker)(tcfg, uni)
    # Calls of 8 steps: two a 16-step epoch.
    kw = dict(sync_every=sync_every, donate=True, max_steps_per_call=8)
    jtrainer, _ = jw2v._make_trainer(jmesh, jcfg, jworker, **kw)
    ttrainer, tstore = tw2v._make_trainer(tmesh, tcfg, tworker, **kw)
    jtables, jls = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    for e in range(epochs):
        jtables, jls, jm = jtrainer.run_indexed(
            jtables, jls, jplan, jax.random.key(1), start_epoch=e)
        ttables, _, tm = ttrainer.run_indexed(ttables, (), tplan, 1,
                                              start_epoch=e)
        np.testing.assert_array_equal(tm[0]["n"], np.asarray(jm[0]["n"]))
        assert tm[0]["n"].sum() > 0
        # Each step's loss, a float32 sum in another order: measured 4.7e-7
        # of it at most.
        np.testing.assert_allclose(tm[0]["loss"], np.asarray(jm[0]["loss"]),
                                   rtol=2e-6)
        for name in (tw2v.IN_TABLE, tw2v.OUT_TABLE):
            np.testing.assert_allclose(ttables[name].numpy(),
                                       np.asarray(jtables[name]),
                                       rtol=0, atol=atol)
    return ttables


@pytest.mark.parametrize("sync_every", [None, 4])
@pytest.mark.parametrize("mode", ["block", "pairs"])
def test_run_indexed_matches_jax(mode, sync_every):
    # Rows are O(0.03-0.3); each step's mean push moves a row by up to
    # lr * |row|. Measured differences after two epochs: <= 3.7e-9.
    _run_parity(mode, sync_every, atol=2e-8)


@pytest.mark.parametrize("mode", ["block", "pairs"])
def test_run_indexed_matches_jax_pallas_backend(pallas_backend, mode):
    # The JAX side's pulls and pushes run its Pallas kernels in interpret
    # mode: the pushes sum duplicates by a one-hot contraction, another
    # order again. Measured: <= 3.7e-9.
    _run_parity(mode, None, atol=2e-8, epochs=1)


@pytest.mark.parametrize("mode", ["block", "pairs"])
def test_hot_words_match_jax(mode):
    """``hot_words = 64``: both tables' pushes take the hot/cold split (the
    port: K3's plain version for the head, K2's for the tail; the JAX
    package off a TPU: its XLA scatter). Measured: <= 3.7e-9."""
    _run_parity(mode, 4, atol=2e-8, hot_words=64, epochs=1)


def test_hot_words_match_jax_pallas_backend(pallas_backend):
    # The JAX side's head runs its packed kernel in interpret mode (bf16
    # hi+lo, about 2^-16 of each delta). Measured: <= 1.9e-8.
    _run_parity("block", None, atol=1e-7, hot_words=64, epochs=1)


def test_tables_from_jax_carries_both_w2v_tables():
    jtrainer, _ = jw2v.word2vec(_jmesh(), jw2v.W2VConfig(**CFG_KW),
                                _corpus(2000)[1])
    ttrainer, tstore = tw2v.word2vec(make_ps_mesh(device="cpu"),
                                     tw2v.W2VConfig(**CFG_KW),
                                     _corpus(2000)[1])
    jtables, _ = jtrainer.init_state(jax.random.key(3))
    got = tables_from_jax(tstore, {k: np.asarray(v)
                                   for k, v in jtables.items()})
    assert set(got) == {tw2v.IN_TABLE, tw2v.OUT_TABLE}
    for name, blocks in got.items():
        (t,) = blocks  # the one position's block
        assert t.shape == (V, DIM) and t.dtype == torch.float32
        np.testing.assert_array_equal(t.numpy(), np.asarray(jtables[name]))
    assert not got[tw2v.OUT_TABLE].numpy().any()
    with pytest.raises(ValueError, match="shape"):
        tables_from_jax(tstore, {tw2v.IN_TABLE: np.zeros((V, DIM + 1),
                                                         np.float32),
                                 tw2v.OUT_TABLE: np.zeros((V, DIM),
                                                          np.float32)})
    # The port's own init: IN uniform in [-0.5/dim, 0.5/dim), OUT zeros.
    tables, _ = ttrainer.init_state(3)
    (tin,), (tout,) = tables[tw2v.IN_TABLE], tables[tw2v.OUT_TABLE]
    assert float(tin.abs().max()) <= 0.5 / DIM
    assert float(tin.std()) > 0.1 / DIM
    assert not tout.any()


# ---------------------------------------------------------------------------
# The port's own draws and plan (tests/test_w2v_device.py, test_word2vec.py).
# ---------------------------------------------------------------------------

def test_alias_sampler_matches_unigram_power():
    """Chi-square of 400,000 draws against ``unigram^0.75`` at a fixed
    seed (and the exact mass check of the alias tables)."""
    rng = np.random.default_rng(0)
    counts = rng.zipf(1.4, 50).astype(np.float64) + 1
    worker = tw2v.Word2VecWorker(
        tw2v.W2VConfig(vocab_size=50, negatives=NEG), counts)
    prob, alias = (t.numpy() for t in worker._alias_host)
    p = counts ** 0.75 / (counts ** 0.75).sum()
    mass = prob.astype(np.float64)
    for j in range(50):
        mass[alias[j]] += 1.0 - float(prob[j])
    np.testing.assert_allclose(mass / 50, p, atol=1e-6)  # float32 prob
    draws = worker._draw_negatives(11, (100_000, NEG),
                                   torch.device("cpu")).numpy()
    assert draws.dtype == np.int32 and draws.shape == (100_000, NEG)
    seen = np.bincount(draws.reshape(-1), minlength=50)
    chi2 = float((((seen - p * draws.size) ** 2) / (p * draws.size)).sum())
    assert chi2 < stats.chi2.ppf(0.999, 49), chi2
    # Another step's seed gives other draws; the same seed the same.
    again = worker._draw_negatives(11, (100_000, NEG), torch.device("cpu"))
    other = worker._draw_negatives(12, (100_000, NEG), torch.device("cpu"))
    np.testing.assert_array_equal(again.numpy(), draws)
    assert (other.numpy() != draws).mean() > 0.5


def _plan(tokens, uni, cfg, mode="pairs", block_len=16, seed=0, **kw):
    return tw2v.Word2VecDevicePlan(tokens, uni, cfg,
                                   make_ps_mesh(device="cpu"), num_workers=1,
                                   block_len=block_len, seed=seed, mode=mode,
                                   **kw)


def _stream():
    tokens = np.arange(1000, dtype=np.int32) % 97  # distinct-ish stream
    return tokens, np.bincount(tokens, minlength=97).astype(np.float64)


def test_device_pairs_match_host_window_semantics():
    """Every valid pair lies within the window of the (unsubsampled)
    stream; the count is about ``2 * E[half] * n``."""
    tokens, uni = _stream()
    cfg = tw2v.W2VConfig(vocab_size=97, window=3, negatives=2,
                         subsample_t=None)
    plan = _plan(tokens, uni, cfg)
    args = plan.epoch_args(0)
    b = plan.call_batches(args, 0, plan.steps_per_epoch)
    wt = b["weight"].numpy()
    c = b["center"].numpy()[wt > 0].astype(int)
    x = b["context"].numpy()[wt > 0].astype(int)
    d = (x - c) % 97
    assert ((d <= cfg.window) | (d >= 97 - cfg.window)).all()
    assert 2500 < wt.sum() < 5500, wt.sum()
    # Each ordered adjacency appears in both orientations.
    assert sorted(zip(c, x)) == sorted(zip(x, c))
    # local_batch_at is the call's step t.
    one = plan.local_batch_at(args, 0, 5)
    for k in b:
        np.testing.assert_array_equal(one[k].numpy(), b[k][5].numpy())


def test_block_worker_pair_accounting():
    """Block mode counts exactly the pairs the pair mode emits (same
    blocks, same half-window draws)."""
    tokens, uni = _stream()
    cfg = tw2v.W2VConfig(vocab_size=97, window=3, negatives=2,
                         subsample_t=None, neg_group_size=8)
    counts = {}
    for mode in ("pairs", "block"):
        plan = _plan(tokens, uni, cfg, mode=mode)
        b = plan.call_batches(plan.epoch_args(0), 0, plan.steps_per_epoch)
        if mode == "pairs":
            counts[mode] = float(b["weight"].sum())
            continue
        half = b["half"].numpy().astype(int)
        vlen = b["valid_len"].numpy()
        L = half.shape[1]
        counts[mode] = sum(
            2.0 * ((half >= d) & (np.arange(L) + d < vlen[:, None])).sum()
            for d in range(1, cfg.window + 1))
    assert counts["pairs"] == counts["block"] > 0, counts
    # The block worker's own count, "n", is the same.
    trainer, _ = tw2v.word2vec_block(make_ps_mesh(device="cpu"), cfg, uni, 16)
    tables, ls = trainer.init_state(0)
    _, _, m = trainer.run_indexed(
        tables, ls, _plan(tokens, uni, cfg, mode="block"), 1)
    assert float(m[0]["n"].sum()) == counts["block"]


def test_subsampling_compacts_the_kept_tokens():
    """Subsampling drops tokens before windows apply: the compacted stream
    is the stream at the kept mask (each position's uniform from the
    epoch's seed against ``keep_p``), and fewer steps and pairs result."""
    tokens, uni = _corpus(30_000)
    cfg_all = tw2v.W2VConfig(vocab_size=V, window=3, subsample_t=None)
    cfg_sub = tw2v.W2VConfig(vocab_size=V, window=3, subsample_t=1e-3)
    p_all = _plan(tokens, uni, cfg_all, block_len=64)
    p_sub = _plan(tokens, uni, cfg_sub, block_len=64)
    assert p_sub.steps_per_epoch < p_all.steps_per_epoch
    args = p_sub.epoch_args(2)
    u = trng.uniform_by_counter(trng.fold_seed(trng.fold_seed(0, 2), 0),
                                torch.arange(len(tokens))).numpy()
    kept = tokens[u < tw2v._keep_probs(cfg_sub, uni).astype(np.float32)[
        tokens]]
    assert int(args["kept"]) == len(kept) < 0.8 * len(tokens)
    np.testing.assert_array_equal(args["compacted"][:len(kept)].numpy(), kept)
    assert not args["compacted"][len(kept):].any()
    pairs = {}
    for name, plan in (("all", p_all), ("sub", p_sub)):
        b = plan.call_batches(plan.epoch_args(2), 0, plan.steps_per_epoch)
        pairs[name] = float(b["weight"].sum())
    assert pairs["sub"] < 0.8 * pairs["all"], pairs
    # Half-windows are drawn in [1, window], each value about as often.
    p_blk = _plan(tokens, uni, cfg_all, mode="block", block_len=64)
    half = p_blk.call_batches(p_blk.epoch_args(0), 0, 10)["half"].numpy()
    assert half.min() == 1 and half.max() == 3
    assert np.abs(np.bincount(half.reshape(-1))[1:] / half.size - 1 / 3).max(
    ) < 0.02


@pytest.mark.parametrize("n,block_len,sync_every,subsample_t", [
    (1000, 16, None, None), (30_000, 64, None, 1e-3), (30_000, 64, 4, 1e-4),
    (5000, 8192, None, 1e-4), (65_536, 1024, 3, None)])
def test_steps_per_epoch_match_jax(n, block_len, sync_every, subsample_t):
    tokens, uni = _corpus(n)
    kw = dict(vocab_size=V, window=5, subsample_t=subsample_t)
    jplan = jw2v.Word2VecDevicePlan(
        tokens, uni, jw2v.W2VConfig(**kw), _jmesh(), num_workers=1,
        block_len=block_len, sync_every=sync_every, mode="block")
    tplan = _plan(tokens, uni, tw2v.W2VConfig(**kw), mode="block",
                  block_len=block_len, sync_every=sync_every)
    assert tplan.steps_per_epoch == jplan.steps_per_epoch
    assert tplan._buf_len == jplan._buf_len
    assert tplan.local_batch == jplan.local_batch


def test_plan_draws_depend_on_seed_and_epoch_only():
    tokens, uni = _corpus(20_000)
    cfg = tw2v.W2VConfig(vocab_size=V, window=5, subsample_t=1e-3)

    def batch(seed, epoch):
        plan = _plan(tokens, uni, cfg, mode="block", block_len=256, seed=seed)
        return plan.call_batches(plan.epoch_args(epoch), 0, 4)

    a, b = batch(0, 1), batch(0, 1)
    for k in a:
        np.testing.assert_array_equal(a[k].numpy(), b[k].numpy())
    assert not torch.equal(batch(0, 2)["block"], a["block"])
    assert not torch.equal(batch(1, 1)["half"], a["half"])


def test_plan_refuses_what_the_port_does_not_run():
    tokens, uni = _stream()
    cfg = tw2v.W2VConfig(vocab_size=97, subsample_t=None)
    with pytest.raises(ValueError, match="mode"):
        _plan(tokens, uni, cfg, mode="triples")
    # Several workers: sized and cut as the JAX package's plan (worker 1's
    # first block starts at compacted position L).
    plan = tw2v.Word2VecDevicePlan(tokens, uni, cfg,
                                   make_ps_mesh(2, device="cpu"),
                                   num_workers=2, block_len=16, mode="block")
    jplan = jw2v.Word2VecDevicePlan(
        tokens, uni, jw2v.W2VConfig(vocab_size=97, subsample_t=None),
        _jmesh(), num_workers=2, block_len=16, mode="block")
    assert (plan.steps_per_epoch, plan._buf_len) == (jplan.steps_per_epoch,
                                                     jplan._buf_len)
    got = plan.local_batch_at(plan.epoch_args(0), 1, 0)
    want = jplan.local_batch_at(jplan.epoch_args(0), 1, 0)
    for k in ("block", "valid_len"):
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))
    np.testing.assert_array_equal(got["block"].numpy()[:16], tokens[16:32])


def test_skipgram_chunks_match_jax_and_keep_static_shapes():
    tokens, uni = _corpus(5000, seed=1, vocab=50)
    for sync_every, sub in ((None, None), (2, 1e-2)):
        kw = dict(vocab_size=50, window=2, subsample_t=sub)
        args = dict(num_workers=4, local_batch=8, steps_per_chunk=4,
                    sync_every=sync_every, seed=3, segment_tokens=1500)
        got = list(tw2v.skipgram_chunks(tokens, uni, tw2v.W2VConfig(**kw),
                                        **args))
        want = list(jw2v.skipgram_chunks(tokens, uni, jw2v.W2VConfig(**kw),
                                         use_native=False, **args))
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            assert set(g) == {"center", "context", "weight"}
            for k in g:
                np.testing.assert_array_equal(g[k], w[k])
        assert len({c["center"].shape for c in got}) == 1
    total_w = sum(
        c["weight"].sum() for c in tw2v.skipgram_chunks(
            tokens, uni, tw2v.W2VConfig(vocab_size=50, window=2,
                                        subsample_t=None),
            num_workers=4, local_batch=8, steps_per_chunk=4))
    assert total_w > 2 * 0.9 * len(tokens)
    with pytest.raises(NotImplementedError, match="bench"):
        next(tw2v.skipgram_chunks(tokens, uni, tw2v.W2VConfig(vocab_size=50),
                                  num_workers=1, local_batch=8,
                                  steps_per_chunk=4, use_native=True))
    with pytest.raises(ValueError, match="vocab"):
        next(tw2v.skipgram_chunks(tokens, uni[:10],
                                  tw2v.W2VConfig(vocab_size=10),
                                  num_workers=1, local_batch=8,
                                  steps_per_chunk=4))


def test_hot_words_literal_validated():
    mesh = make_ps_mesh(device="cpu")
    with pytest.raises(ValueError, match="hot_words"):
        tw2v.make_store(mesh, tw2v.W2VConfig(vocab_size=64, dim=8,
                                             hot_words="Auto"))
    store = tw2v.make_store(mesh, tw2v.W2VConfig(vocab_size=64, dim=8,
                                                 hot_words=1000))
    assert {s.hot_ids for s in store.specs.values()} == {64}
    store = tw2v.make_store(mesh, tw2v.W2VConfig(vocab_size=64, dim=8,
                                                 hot_words="auto"))
    assert {s.hot_ids for s in store.specs.values()} == {"auto"}


@pytest.mark.parametrize("option,slice_", [(dict(guard="mask"), "slice E")])
@pytest.mark.parametrize("factory", ["word2vec", "word2vec_block"])
def test_unported_options_raise_naming_their_slice(option, slice_, factory):
    _, uni = _corpus(2000)
    cfg = tw2v.W2VConfig(vocab_size=V, dim=8, subsample_t=None)
    args = (cfg, uni) if factory == "word2vec" else (cfg, uni, 64)
    with pytest.raises(NotImplementedError, match=slice_):
        getattr(tw2v, factory)(make_ps_mesh(device="cpu"), *args, **option)


@pytest.mark.parametrize("factory", ["word2vec", "word2vec_block"])
def test_push_delay_16_warns_as_the_jax_factory_does(factory):
    """``push_delay >= 16`` warns (the JAX package's guardrail from its
    staleness sweep), with the downscaled learning rate named; below 16 it
    is quiet, and the delay reaches the trainer's config."""
    _, uni = _corpus(2000)
    cfg = tw2v.W2VConfig(vocab_size=V, dim=8, subsample_t=None,
                         learning_rate=0.01)
    args = (cfg, uni) if factory == "word2vec" else (cfg, uni, 64)
    mesh = make_ps_mesh(device="cpu")
    with pytest.warns(UserWarning, match="push_delay=16 and downscaled"):
        trainer, _ = getattr(tw2v, factory)(mesh, *args, push_delay=16)
    assert trainer.config.push_delay == 16
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        trainer, _ = getattr(tw2v, factory)(mesh, *args, push_delay=15)
    assert trainer.config.push_delay == 15


def test_loss_falls_on_the_host_pair_stream_sync_and_ssp():
    """``skipgram_chunks`` through ``fit_stream`` (``tests/test_word2vec.py``
    for the JAX package): the loss falls, both tables move."""
    tokens, uni = _corpus(60_000)
    cfg = tw2v.W2VConfig(**CFG_KW)
    for sync_every, epochs, factor in ((None, 2, 0.8), (4, 1, 1.0)):
        trainer, store = tw2v.word2vec(make_ps_mesh(device="cpu"), cfg, uni,
                                       sync_every=sync_every)
        tables, ls = trainer.init_state(0)
        ms = []
        for e in range(epochs):
            chunks = tw2v.skipgram_chunks(
                tokens, uni, cfg, num_workers=1, local_batch=512,
                steps_per_chunk=8, sync_every=sync_every, seed=e)
            tables, ls, m = trainer.fit_stream(tables, ls, chunks, e)
            ms += m
        loss = np.concatenate([m["loss"] for m in ms])
        n = np.concatenate([m["n"] for m in ms])
        k = len(loss) // 5
        early, late = loss[:k].sum() / n[:k].sum(), loss[-k:].sum() / n[
            -k:].sum()
        assert late < early * factor, (early, late)
    ids = np.arange(V)
    assert float(np.abs(store.lookup_host(tw2v.OUT_TABLE, ids)).max()) > 0.01
    assert float(np.linalg.norm(store.lookup_host(tw2v.IN_TABLE, ids),
                                axis=1).max()) > 0.1


def test_block_worker_embedding_quality_parity():
    """The JAX package's quality gate (``tests/test_w2v_device.py:170``) on
    the port: on a planted-synonym corpus (word w and w + V/2 are used
    interchangeably), nearest-neighbour partner recovery after 8 epochs is
    at least 0.5 for both workers (chance 0.017), and the block worker
    trails the pair worker by at most 0.1. The JAX test runs 8 workers of
    64-token blocks; the port's one worker takes a block of 512 tokens, the
    same tokens a step. Measured: block 0.783, pairs 0.833."""
    V2 = 150
    VV = 2 * V2
    rng = np.random.default_rng(7)
    base = tdatasets.synthetic_corpus(V2, 80_000, num_topics=8, seed=0)
    tokens = np.where(rng.random(len(base)) < 0.5, base, base + V2).astype(
        np.int32)
    uni = np.bincount(tokens, minlength=VV).astype(np.float64)
    cfg = tw2v.W2VConfig(vocab_size=VV, dim=16, window=3, negatives=4,
                         learning_rate=0.05, subsample_t=None)
    mesh = make_ps_mesh(device="cpu")

    def recovery(mode):
        trainer, store = (tw2v.word2vec_block(mesh, cfg, uni, 512)
                          if mode == "block" else tw2v.word2vec(mesh, cfg,
                                                                uni))
        tables, ls = trainer.init_state(0)
        plan = _plan(tokens, uni, cfg, mode=mode, block_len=512)
        trainer.run_indexed(tables, ls, plan, 1, epochs=8)
        probes = np.argsort(-uni[:V2])[:60]
        ids, _ = tw2v.nearest_neighbors(store, probes, k=5)
        partner = probes + V2
        return float(np.mean([partner[i] in ids[i]
                              for i in range(len(probes))]))

    rec_block = recovery("block")
    rec_pairs = recovery("pairs")
    assert rec_pairs >= 0.5, rec_pairs
    assert rec_block >= 0.5, rec_block
    assert rec_block >= rec_pairs - 0.1, (rec_block, rec_pairs)


# ---------------------------------------------------------------------------
# The example CLI.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ingest,mode", [("device", "block"),
                                         ("device", "pairs"),
                                         ("host", "pairs")])
def test_example_cli_runs_on_cpu(ingest, mode):
    from fps_tpu_torch.examples import word2vec

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = word2vec.main([
            "--device", "cpu", "--vocab-size", "300", "--num-tokens",
            "40000", "--dim", "16", "--window", "3", "--negatives", "4",
            "--learning-rate", "0.05", "--local-batch", "3072",
            "--epochs", "3", "--ingest", ingest, "--mode", mode])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["device"] == "cpu"
    chunks = [e for e in events if e["event"] == "chunk"]
    assert len(chunks) >= 3
    assert chunks[-1]["sgns_loss"] < chunks[0]["sgns_loss"] < 4 * np.log(2) + 1
    done = [e for e in events if e["event"] == "done"]
    assert len(done) == 1 and done[0]["words_per_sec"] > 0
    assert done[0]["pairs_per_sec"] > 0
    assert sum(e["event"] == "neighbors" for e in events) == 4


def test_example_cli_refuses_what_is_not_ported():
    from fps_tpu_torch.examples import word2vec

    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit):
            word2vec.main(["--device", "cpu", "--ingest", "host",
                           "--mode", "block"])
