"""The port's native host library (``fps_tpu_torch.native``) against the JAX
package's (``fps_tpu.native``), on the same inputs.

``tests/test_native.py`` is the oracle: its parser formats, its skip-gram
semantics and its baselines' data run through both libraries, and every
output is equal (the baselines' quality outputs; their seconds are wall
times). The pair generator's stream through ``skipgram_chunks`` equals the
JAX package's chunk for chunk, bit for bit; the loaders' native and Python
branches agree; the library is built into the port's own git-ignored
``fps_tpu_torch/native/_build/``, at first use, never at import.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from fps_tpu import native as jnative
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import native as tnative
from fps_tpu_torch.utils import datasets as tdatasets

# fps_tpu.models exports a function of the module's name, which shadows it.
jw2v = importlib.import_module("fps_tpu.models.word2vec")
tw2v = importlib.import_module("fps_tpu_torch.models.word2vec")

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def libs():
    assert tnative.available(), "g++ expected in this environment"
    assert jnative.available(), "g++ expected in this environment"
    return tnative, jnative


def _equal(a, b):
    """Equal outputs: same structure, arrays equal in dtype and bits."""
    if a is None or b is None:
        assert a is None and b is None
        return
    if isinstance(a, tuple):
        assert isinstance(b, tuple) and len(a) == len(b)
        for x, y in zip(a, b):
            _equal(x, y)
        return
    if isinstance(a, np.ndarray):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
        return
    assert a == b


def test_builds_into_its_own_cache_at_first_use_only(libs):
    """The library lives under the port's ``_build/`` keyed by the source's
    hash, never the JAX package's ``_fps_native.so``; importing the module
    builds nothing and imports neither jax nor the JAX package."""
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(
        ROOT, "fps_tpu_torch", "native", "_build")
    assert os.path.exists(path)
    assert os.path.basename(path).startswith("libfps_native-")
    assert not path.endswith("_fps_native.so")
    code = ("import sys, os\n"
            "sys.modules['jax'] = None\n"
            "import fps_tpu_torch.native as n\n"
            "assert n._lib is None and not n._tried\n"
            "assert n.CRITEO_NNZ == 39\n"
            "assert not any(m == 'fps_tpu' or m.startswith('fps_tpu.')\n"
            "               for m in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


RATING_FILES = {
    "ml100k": "1\t10\t3\t881250949\n2\t20\t5\t891717742\n3\t30\t1\t878887116\n",
    "ml20m_csv": ("userId,movieId,rating,timestamp\n1,2,3.5,1112486027\n"
                  "7,8,4.0,1112484676\n"),
    "commented": ("".join(f"# preamble {k}\n" for k in range(10))
                  + "1\t2\t3\n# interlude\n4\t5\t2\n"),
    "crlf": "userId,movieId,rating\r\n1,2,3.5\r\n\r\n4,5,2.0\r\n\r\n",
}
BAD_RATING_FILES = {
    "garbage": "1\t2\t3\n4\tgarbage\n5\t6\t1\n",
    "quoted": '"userId","movieId","rating"\n' + "".join(
        f'"{k}","{k + 1}","3.5"\n' for k in range(20)),
    "midfile": "1\t2\t3\noops line\n5\t6\t1\n",
}


@pytest.mark.parametrize("name", sorted(RATING_FILES))
def test_parse_ratings_equal(libs, tmp_path, name):
    p = tmp_path / "r.data"
    p.write_bytes(RATING_FILES[name].encode())
    got, want = tnative.parse_ratings(str(p)), jnative.parse_ratings(str(p))
    assert want is not None and len(want[0]) >= 2
    _equal(got, want)


@pytest.mark.parametrize("name", sorted(BAD_RATING_FILES))
def test_parse_ratings_malformed_raises_in_both(libs, tmp_path, name):
    p = tmp_path / "bad.data"
    p.write_text(BAD_RATING_FILES[name])
    for lib in libs:
        with pytest.raises(ValueError, match="malformed"):
            lib.parse_ratings(str(p))
    assert tnative.parse_ratings(str(tmp_path / "missing")) is None


def test_parse_ratings_matches_loadtxt_and_reference(libs, tmp_path):
    rng = np.random.default_rng(0)
    n = 5000
    rows = np.stack([rng.integers(1, 944, n), rng.integers(1, 1683, n),
                     rng.integers(1, 6, n), rng.integers(0, 10**9, n)],
                    axis=1)
    p = tmp_path / "big.data"
    np.savetxt(p, rows, fmt="%d", delimiter="\t")
    got = tnative.parse_ratings(str(p))
    _equal(got, jnative.parse_ratings(str(p)))
    np.testing.assert_array_equal(got[0], rows[:, 0])
    np.testing.assert_array_equal(got[1], rows[:, 1])


def _svmlight_file(tmp_path, n=300, seed=1):
    rng = np.random.default_rng(seed)
    lines = ["# a comment"]
    for _ in range(n):
        k = int(rng.integers(0, 12))
        ids = np.sort(rng.choice(np.arange(1, 5000), k, replace=False))
        feats = " ".join(f"{i}:{v:.5g}" for i, v in
                         zip(ids, rng.normal(0, 2, k)))
        lines.append(f"{rng.choice(['+1', '-1', '0'])} {feats}".rstrip())
    p = tmp_path / "data.svm"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


def _criteo_file(tmp_path, n=200, seed=2):
    rng = np.random.default_rng(seed)
    lines = []
    for _ in range(n):
        nums = [("" if rng.random() < 0.2 else str(int(rng.integers(-3, 900))))
                for _ in range(13)]
        cats = [("" if rng.random() < 0.1 else
                 f"{int(rng.integers(0, 1 << 32)):08x}") for _ in range(26)]
        lines.append("\t".join([str(int(rng.integers(0, 2)))] + nums + cats))
    p = tmp_path / "day.tsv"
    p.write_text("\n".join(lines) + "\n")
    return str(p)


@pytest.mark.parametrize("nnz_cap", [None, 4])
def test_parse_svmlight_equal(libs, tmp_path, nnz_cap):
    path = _svmlight_file(tmp_path)
    got = tnative.parse_svmlight(path, nnz_cap)
    want = jnative.parse_svmlight(path, nnz_cap)
    assert want is not None and len(want[0]) == 300
    _equal(got, want)
    if nnz_cap:
        assert got[3] > 0  # rows truncated and counted
    bad = tmp_path / "bad.svm"
    bad.write_text("+1 3:1.0\n-1 x:2\n")
    for lib in libs:
        with pytest.raises(ValueError, match="malformed"):
            lib.parse_svmlight(str(bad))


@pytest.mark.parametrize("num_features", [1 << 20, 64])
def test_parse_criteo_equal(libs, tmp_path, num_features):
    path = _criteo_file(tmp_path)
    got = tnative.parse_criteo(path, num_features)
    want = jnative.parse_criteo(path, num_features)
    assert want is not None and want[1].shape == (200, 39)
    _equal(got, want)
    with pytest.raises(ValueError, match="exceed 13"):
        tnative.parse_criteo(path, 13)


@pytest.mark.parametrize("use_native", [None, True, False])
def test_loaders_agree_with_reference_on_each_branch(libs, tmp_path,
                                                     use_native):
    """``load_svmlight`` / ``load_criteo`` / ``load_sparse`` on each branch
    give the JAX package's arrays, and the native and Python branches give
    the same."""
    svm, tsv = _svmlight_file(tmp_path), _criteo_file(tmp_path)
    for fn, path, kw in (("load_svmlight", svm, {}),
                         ("load_svmlight", svm, {"nnz_cap": 5}),
                         ("load_criteo", tsv, {"num_features": 4096}),
                         ("load_sparse", svm, {}),
                         ("load_sparse", tsv, {"num_features": 4096})):
        def load(pkg, native_arg):
            # nnz_cap=5 truncates over-long rows: both packages warn.
            ctx = (pytest.warns(UserWarning, match="nnz_cap")
                   if kw.get("nnz_cap") else contextlib.nullcontext())
            with ctx:
                return getattr(pkg, fn)(path, use_native=native_arg, **kw)

        (got, nf), (want, jnf) = (load(tdatasets, use_native),
                                  load(jdatasets, use_native))
        python, _ = load(tdatasets, False)
        assert nf == jnf
        for k in want:
            _equal(got[k], want[k])
            _equal(got[k], python[k])


def test_use_native_true_raises_without_the_library(monkeypatch, tmp_path):
    svm = _svmlight_file(tmp_path, n=5)
    monkeypatch.setattr(tnative, "available", lambda: False)
    for call in (lambda: tdatasets.load_svmlight(svm, use_native=True),
                 lambda: tdatasets.load_criteo(svm, use_native=True),
                 lambda: tdatasets.load_sparse(svm, use_native=True)):
        with pytest.raises(RuntimeError, match="unavailable"):
            call()
    # The default falls back to the Python parser.
    data, _ = tdatasets.load_svmlight(svm)
    assert data["feat_ids"].shape[0] == 5


def test_load_movielens_uses_native_and_matches_reference(libs, tmp_path,
                                                          monkeypatch):
    p = tmp_path / "u.data"
    p.write_text("1\t1\t5\t0\n2\t2\t3\t0\n943\t1682\t1\t0\n")
    calls = []
    real = tnative.parse_ratings
    monkeypatch.setattr(tnative, "parse_ratings",
                        lambda *a, **k: calls.append(a) or real(*a, **k))
    data, nu, ni = tdatasets.load_movielens(str(p))
    assert calls and (nu, ni) == (943, 1682)
    jdata, jnu, jni = jdatasets.load_movielens(str(p))
    assert (jnu, jni) == (nu, ni)
    for k in jdata:
        _equal(data[k], jdata[k])
    np.testing.assert_array_equal(data["user"], [0, 1, 942])
    # Without the library: the numpy branch, the same ids.
    monkeypatch.setattr(tnative, "parse_ratings", lambda *a, **k: None)
    fallback, _, _ = tdatasets.load_movielens(str(p))
    for k in ("user", "item"):
        np.testing.assert_array_equal(fallback[k], data[k])
    np.testing.assert_array_equal(fallback["rating"], data["rating"])


@pytest.mark.parametrize("window,seed,subsample", [(1, 0, False),
                                                   (5, 42, False),
                                                   (2, 7, True)])
def test_skipgram_pairs_equal(libs, window, seed, subsample):
    rng = np.random.default_rng(1)
    tokens = rng.integers(0, 50, 2000).astype(np.int32)
    keep_p = (np.linspace(0.05, 1.0, 50).astype(np.float32) if subsample
              else None)
    got = tnative.skipgram_pairs(tokens, window, seed, keep_p=keep_p)
    _equal(got, jnative.skipgram_pairs(tokens, window, seed, keep_p=keep_p))
    if window == 1:
        c, x = tnative.skipgram_pairs(np.array([4, 7, 2, 9], np.int32), 1, 0)
        np.testing.assert_array_equal(c, [4, 7, 7, 2, 2, 9])
        np.testing.assert_array_equal(x, [7, 4, 2, 7, 9, 2])


@pytest.mark.parametrize("sync_every,subsample_t", [(None, 1e-3), (2, None)])
def test_skipgram_chunks_native_stream_equals_reference(libs, sync_every,
                                                        subsample_t):
    """Several segments, a tail chunk padded with weight 0: the port's
    native stream is the JAX package's, chunk for chunk, bit for bit."""
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, 100, 30_000).astype(np.int32)
    uni = np.bincount(tokens, minlength=100).astype(np.float64)
    args = dict(num_workers=4, local_batch=64, steps_per_chunk=4,
                sync_every=sync_every, seed=3, segment_tokens=7000,
                use_native=True)
    got = list(tw2v.skipgram_chunks(
        tokens, uni, tw2v.W2VConfig(vocab_size=100, window=3,
                                    subsample_t=subsample_t), **args))
    want = list(jw2v.skipgram_chunks(
        tokens, uni, jw2v.W2VConfig(vocab_size=100, window=3,
                                    subsample_t=subsample_t), **args))
    assert len(got) == len(want) > 10
    assert float(want[-1]["weight"].min()) == 0.0  # the padded tail
    for g, w in zip(got, want):
        assert set(g) == set(w)
        for k in g:
            _equal(g[k], w[k])


def test_skipgram_chunks_native_failure_mid_stream_raises(libs, monkeypatch):
    tokens = np.arange(100, dtype=np.int32) % 10
    uni = np.bincount(tokens, minlength=10).astype(np.float64)
    monkeypatch.setattr(tnative, "skipgram_pairs", lambda *a, **k: None)
    with pytest.raises(RuntimeError, match="mid-stream"):
        next(tw2v.skipgram_chunks(tokens, uni, tw2v.W2VConfig(vocab_size=10),
                                  num_workers=1, local_batch=8,
                                  steps_per_chunk=2, use_native=True))


def _mf_data():
    rng = np.random.default_rng(0)
    nu, ni, rank, n = 300, 200, 4, 20000
    P = rng.normal(0, 0.5, (nu, rank))
    Q = rng.normal(0, 0.5, (ni, rank))
    u = rng.integers(0, nu, n).astype(np.int32)
    i = rng.integers(0, ni, n).astype(np.int32)
    r = (np.sum(P[u] * Q[i], 1) + 0.05 * rng.normal(size=n)).astype(
        np.float32)
    return u, i, r, nu, ni, rank


def _sparse(seed, nf, nnz, n):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, nf, (n, nnz)).astype(np.int32)
    vals = rng.normal(0, 1, (n, nnz)).astype(np.float32)
    return rng, ids, vals


@pytest.mark.parametrize("ps_mode", [True, False])
def test_baseline_mf_equal(libs, ps_mode):
    u, i, r, nu, ni, rank = _mf_data()
    got = tnative.baseline_mf(u, i, r, nu, ni, rank=rank, lr=0.1, epochs=4,
                              ps_mode=ps_mode)
    want = jnative.baseline_mf(u, i, r, nu, ni, rank=rank, lr=0.1, epochs=4,
                               ps_mode=ps_mode)
    assert got[1] == want[1]  # per-epoch MSEs
    assert got[1][-1] < 0.5 * got[1][0]  # it learns
    assert len(got[0]) == 4 and all(s > 0 for s in got[0])


@pytest.mark.parametrize("ps_mode", [True, False])
def test_baseline_w2v_equal(libs, ps_mode):
    rng = np.random.default_rng(1)
    V, n = 500, 30000
    c = rng.integers(0, V, n).astype(np.int32)
    x = ((c + rng.integers(1, 4, n)) % V).astype(np.int32)
    uni = np.bincount(c, minlength=V).astype(np.float64) + 1
    got = tnative.baseline_w2v(c, x, uni, dim=16, negatives=3,
                               ps_mode=ps_mode)
    want = jnative.baseline_w2v(c, x, uni, dim=16, negatives=3,
                                ps_mode=ps_mode)
    assert got[1] == want[1] and got[1] < 0.6931
    assert got[0] > 0


@pytest.mark.parametrize("ps_mode", [True, False])
def test_baseline_logreg_equal(libs, ps_mode):
    rng, ids, vals = _sparse(2, 5000, 8, 40000)
    w_true = rng.normal(0, 1, 5000)
    y = ((vals * w_true[ids]).sum(1) > 0).astype(np.float32)
    got = tnative.baseline_logreg(ids, vals, y, 5000, ps_mode=ps_mode)
    want = jnative.baseline_logreg(ids, vals, y, 5000, ps_mode=ps_mode)
    assert got[1] == want[1] and got[1] < 0.6


@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
def test_baseline_pa_equal(libs, variant):
    rng, ids, vals = _sparse(4, 3000, 8, 30000)
    w_true = rng.normal(0, 1, 3000)
    y = np.where((vals * w_true[ids]).sum(1) > 0, 1.0, -1.0).astype(
        np.float32)
    got = tnative.baseline_pa(ids, vals, y, 3000, variant=variant)
    want = jnative.baseline_pa(ids, vals, y, 3000, variant=variant)
    assert got[1:] == want[1:]  # mean hinge, mistake fraction
    assert got[2] < 0.35


@pytest.mark.parametrize("ps_mode", [True, False])
def test_baseline_pa_mc_equal(libs, ps_mode):
    rng, ids, vals = _sparse(5, 3000, 8, 30000)
    w_true = rng.normal(0, 1, (3000, 6))
    scores = np.einsum("bn,bnc->bc", vals, w_true[ids])
    y = np.argmax(scores, axis=-1).astype(np.int32)
    got = tnative.baseline_pa_mc(ids, vals, y, 3000, 6, ps_mode=ps_mode)
    want = jnative.baseline_pa_mc(ids, vals, y, 3000, 6, ps_mode=ps_mode)
    assert got[1:] == want[1:]
    assert got[2] < 1.0 - 1.0 / 6 - 0.2


def test_baseline_pa_mc_data_bugs_raise(libs, monkeypatch):
    """Data bugs raise ``ValueError`` as in the JAX package; ``None`` is
    kept for environment failures (no library), where bad data still
    raises."""
    ids = np.zeros((4, 2), np.int32)
    vals = np.ones((4, 2), np.float32)
    y = np.array([0, 1, 2, 3], np.int32)
    assert tnative.PA_MC_MAX_CLASSES == jnative.PA_MC_MAX_CLASSES
    for lib in libs:
        with pytest.raises(ValueError, match="num_classes"):
            lib.baseline_pa_mc(ids, vals, y, 10, 2)
        with pytest.raises(ValueError, match="num_classes"):
            lib.baseline_pa_mc(ids, vals, y, 10, lib.PA_MC_MAX_CLASSES + 1)
        with pytest.raises(ValueError, match="labels"):
            lib.baseline_pa_mc(ids, vals, np.array([0, 1, 2, 4], np.int32),
                               10, 4)
        with pytest.raises(ValueError, match="labels"):
            lib.baseline_pa_mc(ids, vals, np.array([-1, 1, 2, 3], np.int32),
                               10, 4)
    assert tnative.baseline_pa_mc(ids, vals, y, 10, 4)[1:] == \
        jnative.baseline_pa_mc(ids, vals, y, 10, 4)[1:]
    monkeypatch.setattr(tnative, "_load", lambda: None)
    assert tnative.baseline_pa_mc(ids, vals, y, 10, 4) is None
    assert tnative.skipgram_pairs(np.arange(4, dtype=np.int32), 1, 0) is None
    with pytest.raises(ValueError, match="labels"):
        tnative.baseline_pa_mc(ids, vals, np.array([9, 9, 9, 9], np.int32),
                               10, 4)
