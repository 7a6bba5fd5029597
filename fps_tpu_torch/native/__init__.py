"""Native (C++) host library: file parsers, the skip-gram pair generator
and the sequential baselines, built at first use, numpy fallback.

Port of ``fps_tpu/native``, with the same API and the same arithmetic: its
source, ``src/fps_native.cc``, is the port's own copy of the JAX package's.
The card runs the training path; the *host* side of ingest (file parsing,
skip-gram pair generation) is plain CPU work, and the sequential baselines
are plain CPU loops. The source is compiled with ``g++ -O3 -shared -fPIC``
the first time a function here is called, never at import, into
``_build/libfps_native-<hash>.so`` (git-ignored; ``<hash>`` of the source
and the flags, as ``fps_tpu_torch/ops/_build.py`` keys the kernels), and
bound via ctypes. The library is written to a temporary name and renamed,
so processes building at once (test workers, supervised children) never
load a half-written file. If no compiler is available, every function
returns ``None`` and callers use the numpy implementations.

API:

* :func:`available` — True if the shared library could be built/loaded;
  :func:`choose` resolves a caller's ``use_native`` against it.
* :func:`parse_ratings` — single-pass scanner for MovieLens-style rating
  files (tab/comma/space separated, headers skipped, int or decimal
  ratings); unlike a fixed-dtype ``loadtxt`` call it handles both the
  ML-100K tab format and the ML-20M csv-with-header format.
* :func:`parse_svmlight`, :func:`parse_criteo` — the sparse loaders'
  scanners (``fps_tpu_torch.utils.datasets``).
* :func:`skipgram_pairs` — subsampled dynamic-window skip-gram pairs for a
  token segment (word2vec ingest), deterministic per seed.
* :func:`baseline_mf`, :func:`baseline_w2v`, :func:`baseline_logreg`,
  :func:`baseline_pa`, :func:`baseline_pa_mc` — measured sequential
  per-record loops, the reference parameter server's shape.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_DIR, "src", "fps_native.cc")
BUILD_DIR = os.path.join(_DIR, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
BUILD_TIMEOUT_S = 120

_lock = threading.Lock()
_lib = None
_tried = False


def library_path() -> str:
    """Where the library of this source and these flags lives."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(_SRC, "rb") as f:
        h.update(f.read())
    return os.path.join(BUILD_DIR, f"libfps_native-{h.hexdigest()[:16]}.so")


def _build(path: str) -> bool:
    # Compile to a unique temporary name, then rename: a concurrent process
    # must never dlopen a half-written library (the failure would be cached
    # for its lifetime).
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so.tmp", dir=BUILD_DIR)
        os.close(fd)
    except OSError:
        return False
    try:
        subprocess.run(["g++", *CXX_FLAGS, "-o", tmp, _SRC], check=True,
                       capture_output=True, timeout=BUILD_TIMEOUT_S)
        os.replace(tmp, path)
        return True
    except (OSError, subprocess.SubprocessError):
        return False
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def _load():
    global _lib, _tried
    with _lock:
        if _lib is not None or _tried:
            return _lib
        _tried = True
        path = library_path()
        if not os.path.exists(path) and not _build(path):
            return None
        try:
            lib = ctypes.CDLL(path)
        except OSError:
            return None
        lib.fps_count_lines.restype = ctypes.c_long
        lib.fps_count_lines.argtypes = [ctypes.c_char_p]
        lib.fps_parse_ratings.restype = ctypes.c_long
        lib.fps_parse_ratings.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fps_skipgram_pairs.restype = ctypes.c_long
        lib.fps_skipgram_pairs.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.c_int,
            ctypes.c_uint64,
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
        ]
        lib.fps_svmlight_dims.restype = ctypes.c_long
        lib.fps_svmlight_dims.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fps_parse_svmlight.restype = ctypes.c_long
        lib.fps_parse_svmlight.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fps_parse_criteo.restype = ctypes.c_long
        lib.fps_parse_criteo.argtypes = [
            ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long,
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_long),
        ]
        lib.fps_baseline_mf.restype = ctypes.c_double
        lib.fps_baseline_mf.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_int, ctypes.c_float, ctypes.c_float,
            ctypes.c_uint64, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fps_baseline_w2v.restype = ctypes.c_double
        lib.fps_baseline_w2v.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long,
            ctypes.POINTER(ctypes.c_double),
            ctypes.c_long, ctypes.c_int, ctypes.c_int,
            ctypes.c_float, ctypes.c_uint64, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fps_baseline_pa.restype = ctypes.c_double
        lib.fps_baseline_pa.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fps_baseline_pa_mc.restype = ctypes.c_double
        lib.fps_baseline_pa_mc.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_int32),
            ctypes.c_long, ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.c_int, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_double),
        ]
        lib.fps_baseline_logreg.restype = ctypes.c_double
        lib.fps_baseline_logreg.argtypes = [
            ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_float),
            ctypes.c_long, ctypes.c_long, ctypes.c_long,
            ctypes.c_float, ctypes.c_int,
            ctypes.POINTER(ctypes.c_double),
        ]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def choose(use_native: bool | None) -> bool:
    """A caller's ``use_native`` resolved: ``None`` takes the library when
    it builds, ``True`` requires it (``RuntimeError`` without it),
    ``False`` declines it."""
    if use_native is None:
        return available()
    if use_native and not available():
        raise RuntimeError(
            "use_native=True but fps_tpu_torch.native is unavailable")
    return bool(use_native)


def _ptr(arr: np.ndarray, ctype):
    return arr.ctypes.data_as(ctypes.POINTER(ctype))


def parse_ratings(path: str, max_rows: int | None = None):
    """Parse a ratings file into ``(users, items, ratings)`` int32/float32.

    Returns ``None`` if the native library is unavailable (caller falls back
    to numpy) or the file cannot be read. Raises ``ValueError`` if any
    data-looking line fails to parse — a corrupted file must not silently
    yield a truncated dataset. Ids are returned verbatim (1-based in
    MovieLens files; the caller re-indexes).
    """
    lib = _load()
    if lib is None:
        return None
    if max_rows is None:
        # Upper bound: line count, native single pass (the parse pass that
        # follows then reads a page-cache-warm file).
        max_rows = lib.fps_count_lines(path.encode())
        if max_rows < 0:
            return None
        max_rows = max(int(max_rows), 1)
    users = np.empty(max_rows, np.int32)
    items = np.empty(max_rows, np.int32)
    ratings = np.empty(max_rows, np.float32)
    malformed = ctypes.c_long(0)
    n = lib.fps_parse_ratings(
        path.encode(),
        _ptr(users, ctypes.c_int32),
        _ptr(items, ctypes.c_int32),
        _ptr(ratings, ctypes.c_float),
        max_rows,
        ctypes.byref(malformed),
    )
    if n < 0:
        return None
    if malformed.value:
        raise ValueError(
            f"{path}: {malformed.value} malformed data line(s) — refusing "
            "to return a silently-truncated dataset"
        )
    return users[:n], items[:n], ratings[:n]


def parse_svmlight(path: str, nnz_cap: int | None = None):
    """Parse an svmlight/RCV1 file into padded dense batch arrays.

    Returns ``(labels (N,) f32, ids (N, nnz) i32, vals (N, nnz) f32,
    truncated)`` with pad slots id 0 / value 0 (inactive by the models'
    ``x != 0`` convention), or ``None`` if the native library is
    unavailable. ``nnz_cap`` pads/truncates each row (default: the file's
    max row length); truncated rows keep their FIRST ``nnz_cap`` features
    and are counted in ``truncated``. Raises ``ValueError`` on malformed
    data lines — a corrupted file must not silently shrink. Feature ids
    are verbatim (svmlight is conventionally 1-based; callers re-index).
    """
    lib = _load()
    if lib is None:
        return None
    max_nnz = ctypes.c_long(0)
    rows = lib.fps_svmlight_dims(path.encode(), ctypes.byref(max_nnz))
    if rows < 0:
        return None
    rows = max(int(rows), 1)
    nnz = int(nnz_cap) if nnz_cap else max(int(max_nnz.value), 1)
    labels = np.zeros(rows, np.float32)
    ids = np.zeros((rows, nnz), np.int32)
    vals = np.zeros((rows, nnz), np.float32)
    truncated = ctypes.c_long(0)
    malformed = ctypes.c_long(0)
    n = lib.fps_parse_svmlight(
        path.encode(),
        _ptr(labels, ctypes.c_float),
        _ptr(ids, ctypes.c_int32),
        _ptr(vals, ctypes.c_float),
        rows,
        nnz,
        ctypes.byref(truncated),
        ctypes.byref(malformed),
    )
    if n < 0:
        return None
    if malformed.value:
        raise ValueError(
            f"{path}: {malformed.value} malformed svmlight line(s) — "
            "refusing to return a silently-truncated dataset"
        )
    return labels[:n], ids[:n], vals[:n], int(truncated.value)


CRITEO_NUM_COLS = 13
CRITEO_CAT_COLS = 26
CRITEO_NNZ = CRITEO_NUM_COLS + CRITEO_CAT_COLS


def parse_criteo(path: str, num_features: int):
    """Parse a Criteo click-log TSV into padded dense batch arrays.

    Returns ``(labels (N,) f32 in {0,1}, ids (N, 39) i32, vals (N, 39)
    f32)`` or ``None`` if the native library is unavailable. Numeric column
    j with value x >= 0 becomes id j / value log1p(x); categorical column j
    becomes id ``13 + hash(j, token) % (num_features - 13)`` / value 1.0
    (FNV-1a + splitmix64 — the numpy fallback in utils.datasets matches it
    bit-for-bit). Missing fields stay inactive. Raises ``ValueError`` on
    malformed lines.
    """
    if num_features <= CRITEO_NUM_COLS:
        raise ValueError("num_features must exceed 13 (the numeric columns)")
    lib = _load()
    if lib is None:
        return None
    rows = lib.fps_count_lines(path.encode())
    if rows < 0:
        return None
    rows = max(int(rows), 1)
    labels = np.zeros(rows, np.float32)
    ids = np.zeros((rows, CRITEO_NNZ), np.int32)
    vals = np.zeros((rows, CRITEO_NNZ), np.float32)
    malformed = ctypes.c_long(0)
    n = lib.fps_parse_criteo(
        path.encode(),
        _ptr(labels, ctypes.c_float),
        _ptr(ids, ctypes.c_int32),
        _ptr(vals, ctypes.c_float),
        rows,
        num_features,
        ctypes.byref(malformed),
    )
    if n < 0:
        return None
    if malformed.value:
        raise ValueError(
            f"{path}: {malformed.value} malformed Criteo line(s) — "
            "refusing to return a silently-truncated dataset"
        )
    return labels[:n], ids[:n], vals[:n]


def skipgram_pairs(
    tokens: np.ndarray,
    window: int,
    seed: int,
    keep_p: np.ndarray | None = None,
):
    """Generate (centers, contexts) for one token segment.

    Subsampling keeps position ``t`` with probability ``keep_p[token[t]]``;
    each kept position draws a half-width in ``1..window`` and emits both
    pair directions (matching the numpy implementation in
    ``fps_tpu_torch/models/word2vec.py``). Deterministic per seed. Returns
    ``None`` when the native library is unavailable.
    """
    lib = _load()
    if lib is None:
        return None
    tokens = np.ascontiguousarray(tokens, np.int32)
    n = len(tokens)
    cap = 2 * window * max(n, 1)
    centers = np.empty(cap, np.int32)
    contexts = np.empty(cap, np.int32)
    if keep_p is not None:
        keep_p = np.ascontiguousarray(keep_p, np.float32)
        vocab = len(keep_p)
        kp_ptr = _ptr(keep_p, ctypes.c_float)
    else:
        vocab = 0
        kp_ptr = ctypes.POINTER(ctypes.c_float)()
    m = lib.fps_skipgram_pairs(
        _ptr(tokens, ctypes.c_int32),
        n,
        window,
        seed & 0xFFFFFFFFFFFFFFFF,
        kp_ptr,
        vocab,
        _ptr(centers, ctypes.c_int32),
        _ptr(contexts, ctypes.c_int32),
        cap,
    )
    if m < 0:
        return None
    return centers[:m], contexts[:m]


def baseline_mf(users, items, ratings, num_users, num_items, *, rank,
                lr=0.05, reg=0.01, seed=0, epochs=1, ps_mode=True):
    """MEASURED sequential per-record MF baseline (bench.py's reference
    stand-in — see the C++ docstring for the generosity argument).

    Runs ``epochs`` passes of per-record SGD over the ratings and returns
    ``(per_epoch_seconds, per_epoch_mse)`` (lists of length ``epochs``), or
    ``None`` if the native library is unavailable. ``ps_mode=True`` forces
    every pull/push through the message ring (the reference's operator-hop
    structure); ``False`` measures the idealized fused loop."""
    lib = _load()
    if lib is None:
        return None
    users = np.ascontiguousarray(users, np.int32)
    items = np.ascontiguousarray(items, np.int32)
    ratings = np.ascontiguousarray(ratings, np.float32)
    n = len(users)
    secs = np.zeros(epochs, np.float64)
    mses = np.zeros(epochs, np.float64)
    total = lib.fps_baseline_mf(
        _ptr(users, ctypes.c_int32), _ptr(items, ctypes.c_int32),
        _ptr(ratings, ctypes.c_float), n, int(num_users), int(num_items),
        int(rank), float(lr), float(reg), seed & 0xFFFFFFFFFFFFFFFF,
        int(epochs), 1 if ps_mode else 0,
        _ptr(secs, ctypes.c_double), _ptr(mses, ctypes.c_double),
    )
    if total < 0:
        return None
    return secs.tolist(), mses.tolist()


def baseline_w2v(centers, contexts, uni, *, dim, negatives=5, lr=0.025,
                 seed=0, ps_mode=True):
    """MEASURED sequential per-pair SGNS baseline. One pass over the given
    pairs; negatives drawn from the unigram^0.75 cdf. Returns
    ``(seconds, mean_loss)`` or ``None`` if unavailable."""
    lib = _load()
    if lib is None:
        return None
    centers = np.ascontiguousarray(centers, np.int32)
    contexts = np.ascontiguousarray(contexts, np.int32)
    p = np.asarray(uni, np.float64) ** 0.75
    cdf = np.cumsum(p / p.sum())
    loss = ctypes.c_double(0.0)
    secs = lib.fps_baseline_w2v(
        _ptr(centers, ctypes.c_int32), _ptr(contexts, ctypes.c_int32),
        len(centers), _ptr(cdf, ctypes.c_double), len(cdf), int(dim),
        int(negatives), float(lr), seed & 0xFFFFFFFFFFFFFFFF,
        1 if ps_mode else 0, ctypes.byref(loss),
    )
    if secs < 0:
        return None
    return float(secs), float(loss.value)


def baseline_logreg(feat_ids, feat_vals, labels, num_features, *, lr=0.1,
                    ps_mode=True):
    """MEASURED sequential per-example sparse-logreg baseline (per-feature
    pull/push fan-out, the reference's shape). One pass; returns
    ``(seconds, mean_logloss)`` or ``None`` if unavailable."""
    lib = _load()
    if lib is None:
        return None
    feat_ids = np.ascontiguousarray(feat_ids, np.int32)
    feat_vals = np.ascontiguousarray(feat_vals, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    n, nnz = feat_ids.shape
    loss = ctypes.c_double(0.0)
    secs = lib.fps_baseline_logreg(
        _ptr(feat_ids, ctypes.c_int32), _ptr(feat_vals, ctypes.c_float),
        _ptr(labels, ctypes.c_float), n, nnz, int(num_features), float(lr),
        1 if ps_mode else 0, ctypes.byref(loss),
    )
    if secs < 0:
        return None
    return float(secs), float(loss.value)


def baseline_pa(feat_ids, feat_vals, labels, num_features, *, C=1.0,
                variant="PA-I", ps_mode=True):
    """MEASURED sequential per-example passive-aggressive baseline
    (per-feature pull/push fan-out, the reference's shape; labels in
    {-1,+1}). One pass; returns ``(seconds, mean_hinge, mistake_frac)``
    or ``None`` if unavailable."""
    lib = _load()
    if lib is None:
        return None
    var = {"PA": 0, "PA-I": 1, "PA-II": 2}[variant]
    feat_ids = np.ascontiguousarray(feat_ids, np.int32)
    feat_vals = np.ascontiguousarray(feat_vals, np.float32)
    labels = np.ascontiguousarray(labels, np.float32)
    n, nnz = feat_ids.shape
    hinge = ctypes.c_double(0.0)
    mist = ctypes.c_double(0.0)
    secs = lib.fps_baseline_pa(
        _ptr(feat_ids, ctypes.c_int32), _ptr(feat_vals, ctypes.c_float),
        _ptr(labels, ctypes.c_float), n, nnz, int(num_features), float(C),
        var, 1 if ps_mode else 0, ctypes.byref(hinge), ctypes.byref(mist),
    )
    if secs < 0:
        return None
    return float(secs), float(hinge.value), float(mist.value)


# The native multiclass PA kernel's class-row message rides a fixed slot
# (id + kMaxClasses floats) — mirror of fps_native.cc's kMaxClasses.
PA_MC_MAX_CLASSES = 120


def baseline_pa_mc(feat_ids, feat_vals, labels, num_features, num_classes,
                   *, C=1.0, variant="PA-I", ps_mode=True):
    """MEASURED sequential per-example MULTICLASS passive-aggressive
    baseline (per-feature pull/push fan-out of ``num_classes``-float class
    rows; labels are class indices). One pass; returns
    ``(seconds, mean_hinge, mistake_frac)`` or ``None`` **only** for
    environment failures (library unavailable / allocation failure).

    Data bugs raise ``ValueError`` here on the Python side —
    ``num_classes`` outside ``[3, PA_MC_MAX_CLASSES]`` or labels outside
    ``[0, num_classes)`` must surface to the bench caller, not silently
    drop the baseline the way an environment failure does."""
    var = {"PA": 0, "PA-I": 1, "PA-II": 2}[variant]
    feat_ids = np.ascontiguousarray(feat_ids, np.int32)
    feat_vals = np.ascontiguousarray(feat_vals, np.float32)
    labels = np.ascontiguousarray(labels, np.int32)
    if not 3 <= int(num_classes) <= PA_MC_MAX_CLASSES:
        raise ValueError(
            f"num_classes={num_classes} outside the multiclass kernel's "
            f"[3, {PA_MC_MAX_CLASSES}] range (binary PA is baseline_pa)"
        )
    if labels.size and (labels.min() < 0 or labels.max() >= num_classes):
        raise ValueError(
            f"labels outside [0, {num_classes}): min={labels.min()}, "
            f"max={labels.max()} — a data bug, not a baseline failure"
        )
    lib = _load()
    if lib is None:
        return None
    n, nnz = feat_ids.shape
    hinge = ctypes.c_double(0.0)
    mist = ctypes.c_double(0.0)
    secs = lib.fps_baseline_pa_mc(
        _ptr(feat_ids, ctypes.c_int32), _ptr(feat_vals, ctypes.c_float),
        _ptr(labels, ctypes.c_int32), n, nnz, int(num_features),
        int(num_classes), float(C), var, 1 if ps_mode else 0,
        ctypes.byref(hinge), ctypes.byref(mist),
    )
    if secs < 0:
        return None
    return float(secs), float(hinge.value), float(mist.value)
