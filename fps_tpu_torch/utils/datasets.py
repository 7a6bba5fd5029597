"""Datasets for the port: synthetic generators, loaders, split.

A copy of ``fps_tpu/utils/datasets.py`` for the ported workloads:
MovieLens-style ratings (``synthetic_ratings``, ``load_movielens``, and
the unbounded ``streaming_rating_batches``; ``zipf_ratings``, the hot-tier
bench's Zipf-skewed item stream from ``bench.py``, and
``drifting_zipf_ratings``, its adaptive-tier bench's stream whose hot items
move), implicit feedback for iALS
(``synthetic_implicit``), sparse
classification for passive-aggressive and logistic regression
(``synthetic_sparse_classification``, ``synthetic_sparse_multiclass``,
``head_sort_slots``), the svmlight / Criteo loaders (``load_svmlight``,
``load_criteo``, ``sniff_sparse_format``, ``load_sparse``), the text8-style
token stream for word2vec (``synthetic_corpus``, ``load_text8``) and
``train_test_split``. The loaders take the port's C++ scanners
(:mod:`fps_tpu_torch.native`) when they build, as the JAX package's do, and
keep its pure-Python parsers as the fallback. The same seed gives the same
arrays as the JAX package's functions.
"""

from __future__ import annotations

import os
import re

import numpy as np

# Importing the native module builds nothing: the library is built at the
# first call that needs it. The Criteo schema (13 numeric columns, then 26
# categorical ones) is its scanner's.
from fps_tpu_torch import native
from fps_tpu_torch.native import (  # noqa: F401
    CRITEO_CAT_COLS,
    CRITEO_NNZ,
    CRITEO_NUM_COLS,
)


def synthetic_ratings(
    num_users: int,
    num_items: int,
    num_ratings: int,
    *,
    rank: int = 6,
    noise: float = 0.1,
    seed: int = 0,
    dtype=np.float32,
):
    """Ratings with planted low-rank structure: r = <p_u, q_i> + noise.

    Popularity is Zipfian over items (like MovieLens) so the scatter-add path
    sees realistic hot-id skew.
    """
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank))
    q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank))
    users = rng.integers(0, num_users, num_ratings)
    item_pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_pop /= item_pop.sum()
    items = rng.choice(num_items, num_ratings, p=item_pop)
    ratings = np.sum(p[users] * q[items], axis=-1) + rng.normal(
        0, noise, num_ratings
    )
    return {
        "user": users.astype(np.int32),
        "item": items.astype(np.int32),
        "rating": ratings.astype(dtype),
    }



def zipf_ratings(num_users, num_items, n, *, alpha=1.05, rank=3, seed=0):
    """Planted low-rank ratings whose item stream is Zipf(``alpha``)-skewed
    with frequency-ranked ids (hottest first, the head convention of the
    hot tier): a copy of ``bench.py``'s ``_zipf_ratings``, the same arrays
    from the same seed."""
    rng = np.random.default_rng(seed)
    p = 1.0 / np.arange(1, num_items + 1) ** alpha
    p /= p.sum()
    user = rng.integers(0, num_users, n).astype(np.int32)
    item = rng.choice(num_items, size=n, p=p).astype(np.int32)
    uf = rng.normal(0, 1.0 / rank ** 0.5, (num_users, rank))
    vf = rng.normal(0, 1.0 / rank ** 0.5, (num_items, rank))
    rating = ((uf[user] * vf[item]).sum(1)
              + rng.normal(0, 0.1, n)).astype(np.float32)
    return {"user": user, "item": item, "rating": rating}


def drifting_zipf_ratings(num_users, num_items, n, *, alpha=1.2, rank=3,
                          rotate_frac=0.5, shift=None, seed=0):
    """Planted low-rank ratings whose item popularity ranking rotates
    within the stream: the first ``rotate_frac`` of the examples draw items
    with Zipf rank = id (hottest first, the static tier's head), the rest
    with rank = ``(id - shift) mod num_items`` (default ``shift``: half the
    items), so the hot head moves to the ids around ``shift``. The stream's
    order is its time: chunk it with ``seed=None``. A copy of ``bench.py``'s
    ``_drifting_zipf_ratings``, the same arrays from the same seed."""
    rng = np.random.default_rng(seed)
    shift = num_items // 2 if shift is None else shift
    p = 1.0 / np.arange(1, num_items + 1) ** alpha
    p /= p.sum()
    n1 = int(n * rotate_frac)
    user = rng.integers(0, num_users, n).astype(np.int32)
    item1 = rng.choice(num_items, size=n1, p=p).astype(np.int32)
    item2 = ((rng.choice(num_items, size=n - n1, p=p) + shift)
             % num_items).astype(np.int32)
    item = np.concatenate([item1, item2])
    uf = rng.normal(0, 1.0 / rank ** 0.5, (num_users, rank))
    vf = rng.normal(0, 1.0 / rank ** 0.5, (num_items, rank))
    rating = ((uf[user] * vf[item]).sum(1)
              + rng.normal(0, 0.1, n)).astype(np.float32)
    return {"user": user, "item": item, "rating": rating}


def load_movielens(path: str | None = None, scale: str = "100k"):
    """Load MovieLens ``u.data``-format ratings (whitespace-separated
    ``user item rating ...`` rows, ids from 1) if ``path`` exists, else
    synthesize.

    Returns (data dict, num_users, num_items). Synthetic sizes follow the
    named scale: 100k -> (943, 1682, 100_000) like ML-100K;
    20m -> (138_493, 26_744, 20_000_263) like ML-20M.
    """
    if path and os.path.exists(path):
        parsed = native.parse_ratings(path)
        if parsed is not None:
            users, items, ratings = parsed
            users = users - 1
            items = items - 1
        else:  # no compiler on this host: numpy fallback
            raw = np.loadtxt(path, dtype=np.int64)
            users = raw[:, 0].astype(np.int32) - 1
            items = raw[:, 1].astype(np.int32) - 1
            ratings = raw[:, 2].astype(np.float32)
        data = {"user": users, "item": items, "rating": ratings}
        return data, int(users.max()) + 1, int(items.max()) + 1
    sizes = {
        "100k": (943, 1682, 100_000),
        "1m": (6040, 3706, 1_000_209),
        "20m": (138_493, 26_744, 20_000_263),
    }
    nu, ni, nr = sizes[scale]
    return synthetic_ratings(nu, ni, nr), nu, ni


def synthetic_implicit(
    num_users: int,
    num_items: int,
    interactions_per_user: int,
    *,
    rank: int = 4,
    seed: int = 0,
):
    """Implicit-feedback interactions with planted low-rank preference.

    Each user interacts with items sampled by softmax of a latent affinity,
    with a count-like positive "rating" (confidence signal, like play counts).
    Returns a dict with ``user``, ``item``, ``rating`` columns — the iALS
    (MovieLens-20M implicit) workload shape.
    """
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1.0, (num_users, rank))
    q = rng.normal(0, 1.0, (num_items, rank))
    users = np.repeat(np.arange(num_users), interactions_per_user)
    # Blocked over users: the dense (U, I) softmax would be O(U*I) memory
    # (4+ GB at ML-20M-class sizes); per-block cdf + vectorized inverse-cdf
    # sampling keeps it bounded and fast at any scale.
    block = max(1, min(num_users, (1 << 25) // max(num_items, 1)))
    item_blocks = []
    pf, qf = p.astype(np.float32), q.astype(np.float32)
    for lo in range(0, num_users, block):
        b = min(lo + block, num_users) - lo
        logits = pf[lo:lo + b] @ qf.T  # (b, I) — f32: sampling noise
        probs = np.exp(logits - logits.max(axis=1, keepdims=True))
        cdf = np.cumsum(probs, axis=1)  # dwarfs f32 cdf rounding
        cdf /= cdf[:, -1:]
        draws = rng.random((b, interactions_per_user))
        # Row-wise inverse cdf in ONE flat searchsorted: shift each row's
        # cdf (and its draws) by the row index so rows occupy disjoint
        # strictly-increasing value ranges, then map flat positions back.
        # The shift must happen in f64 — at row offsets in the tens of
        # thousands an f32 sum has ~2^-7 ulp, coarser than the cdf steps.
        offs = np.arange(b, dtype=np.float64)[:, None]
        flat = np.searchsorted((cdf.astype(np.float64) + offs).ravel(),
                               (draws + offs).ravel())
        rows = np.repeat(np.arange(b, dtype=np.int64), interactions_per_user)
        item_blocks.append(np.clip(flat - rows * num_items, 0,
                                   num_items - 1))
    items = np.concatenate(item_blocks)
    rating = rng.poisson(2.0, len(users)).astype(np.float32) + 1.0
    return {
        "user": users.astype(np.int32),
        "item": items.astype(np.int32),
        "rating": rating,
    }


def train_test_split(data: dict, test_frac: float = 0.1, seed: int = 1):
    n = len(next(iter(data.values())))
    rng = np.random.default_rng(seed)
    order = rng.permutation(n)
    cut = int(n * (1 - test_frac))
    tr, te = order[:cut], order[cut:]
    return (
        {k: v[tr] for k, v in data.items()},
        {k: v[te] for k, v in data.items()},
    )


# ---------------------------------------------------------------------------
# Zipfian token stream (text8-style) for word2vec.
# ---------------------------------------------------------------------------

def synthetic_corpus(
    vocab_size: int,
    num_tokens: int,
    *,
    num_topics: int = 16,
    seed: int = 0,
):
    """Token stream with Zipfian unigram frequencies and topical locality
    (nearby tokens share a topic), so skip-gram has real signal to learn."""
    rng = np.random.default_rng(seed)
    # Zipf over the vocab.
    freq = 1.0 / np.arange(1, vocab_size + 1) ** 1.0
    freq /= freq.sum()
    # Each topic reweights a random slice of the vocab.
    topic_boost = rng.gamma(0.3, 1.0, (num_topics, vocab_size))
    topic_dist = freq * topic_boost
    topic_dist /= topic_dist.sum(axis=1, keepdims=True)
    # Markov chain over topics with sticky self-transitions.
    tokens = np.empty(num_tokens, dtype=np.int32)
    seg = 64
    topic = 0
    for start in range(0, num_tokens, seg):
        if rng.random() < 0.3:
            topic = rng.integers(num_topics)
        end = min(start + seg, num_tokens)
        tokens[start:end] = rng.choice(
            vocab_size, end - start, p=topic_dist[topic]
        )
    return tokens


def load_text8(path: str | None = None, vocab_size: int = 50_000,
               num_tokens: int | None = 2_000_000, seed: int = 0):
    """Load and tokenize text8 if present, else synthesize a Zipfian stream.

    ``num_tokens`` sizes the synthetic stream and truncates a real file's
    token stream (``None`` = use the whole file). Returns
    (tokens int32 array, vocab_size, unigram_counts).
    """
    if path and os.path.exists(path):
        with open(path) as f:
            words = f.read().split()
        if num_tokens is not None:
            words = words[:num_tokens]
        from collections import Counter

        counts = Counter(words)
        vocab = [w for w, _ in counts.most_common(vocab_size - 1)]
        w2i = {w: i + 1 for i, w in enumerate(vocab)}  # 0 = UNK
        tokens = np.fromiter((w2i.get(w, 0) for w in words), np.int32,
                             len(words))
        uni = np.bincount(tokens, minlength=vocab_size).astype(np.float64)
        return tokens, vocab_size, uni
    tokens = synthetic_corpus(vocab_size, num_tokens or 2_000_000, seed=seed)
    uni = np.bincount(tokens, minlength=vocab_size).astype(np.float64)
    return tokens, vocab_size, uni


# ---------------------------------------------------------------------------
# Sparse classification: RCV1 / Criteo shapes.
# ---------------------------------------------------------------------------

_MASK64 = (1 << 64) - 1


def _criteo_hash(col: int, token: bytes) -> int:
    """FNV-1a 64 + splitmix64 finalizer: bit for bit the native scanner's
    ``hash_bytes`` (``fps_tpu_torch/native/src/fps_native.cc``, the JAX
    package's too), so that both branches and both packages hash a Criteo
    file to the same ids."""
    h = (1469598103934665603 ^ col) & _MASK64
    for b in token:
        h = ((h ^ b) * 1099511628211) & _MASK64
    z = (h + 0x9E3779B97F4A7C15) & _MASK64
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK64
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK64
    return z ^ (z >> 31)


_SVM_NUM = re.compile(rb"^[+-]?(\d+(\.\d*)?|\.\d+)([eE][+-]?\d+)?$")
_SVM_IDX = re.compile(rb"^\d+$")


def _parse_svmlight_py(path: str, nnz_cap: int | None):
    """Pure-python svmlight parse, with the JAX package's conventions:
    malformed data lines raise; rows longer than nnz_cap keep their first
    nnz_cap features (count returned as ``truncated``). Tokens are
    validated against the exact grammar of the native scanner
    (``_SVM_NUM``/``_SVM_IDX``) BEFORE float()/int(), which are more
    permissive ("1_0", "inf", "+5" as an index)."""
    rows = []
    malformed = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.split(b"#", 1)[0].strip()
            if not line:
                continue
            parts = line.split()
            try:
                if not _SVM_NUM.match(parts[0]):
                    raise ValueError
                label = float(parts[0])
                feats = []
                for tok in parts[1:]:
                    idx, val = tok.split(b":", 1)
                    if not _SVM_IDX.match(idx) or not _SVM_NUM.match(val):
                        raise ValueError
                    feats.append((int(idx), float(val)))
            except (ValueError, IndexError):
                malformed += 1
                continue
            rows.append((label, feats))
    if malformed:
        raise ValueError(
            f"{path}: {malformed} malformed svmlight line(s) — refusing "
            "to return a silently-truncated dataset"
        )
    n = len(rows)
    max_nnz = max((len(f) for _, f in rows), default=0)
    nnz = int(nnz_cap) if nnz_cap else max(max_nnz, 1)
    labels = np.zeros(n, np.float32)
    ids = np.zeros((n, nnz), np.int32)
    vals = np.zeros((n, nnz), np.float32)
    truncated = 0
    for r, (label, feats) in enumerate(rows):
        labels[r] = label
        truncated += max(0, len(feats) - nnz)
        for k, (idx, val) in enumerate(feats[:nnz]):
            ids[r, k] = idx
            vals[r, k] = val
    return labels, ids, vals, truncated


def load_svmlight(path: str, *, num_features: int | None = None,
                  nnz_cap: int | None = None, use_native: bool | None = None):
    """Load an svmlight/RCV1 file into the framework's sparse batch shape.

    Returns ``(data, num_features)`` where data has ``feat_ids (N, nnz)``,
    ``feat_vals (N, nnz)``, ``label (N,)`` in {-1, +1} (svmlight labels
    mapped by sign; 0 maps to -1). Pad slots are id 0 / value 0 — inactive
    under the models' ``x != 0`` convention. Ids are kept verbatim
    (1-based in RCV1), so ``num_features`` defaults to ``max_id + 1``.
    ``use_native=None`` prefers the C++ scanner when available.
    """
    parsed = (native.parse_svmlight(path, nnz_cap)
              if native.choose(use_native) else None)
    if parsed is None:
        parsed = _parse_svmlight_py(path, nnz_cap)
    labels, ids, vals, truncated = parsed
    if truncated:
        import warnings

        warnings.warn(
            f"{path}: nnz_cap={nnz_cap} dropped {truncated} feature "
            "value(s) from over-long rows",
            stacklevel=2,
        )
    max_id = int(ids.max()) if len(ids) else 0
    if num_features is not None and max_id >= num_features:
        raise ValueError(
            f"{path}: feature id {max_id} >= num_features={num_features} — "
            "oversized ids would silently index past the parameter table"
        )
    nf = num_features or max_id + 1
    data = {
        "feat_ids": ids,
        "feat_vals": vals,
        "label": np.where(labels > 0, 1.0, -1.0).astype(np.float32),
    }
    return data, nf


def _parse_criteo_py(path: str, num_features: int):
    """Pure-python Criteo TSV parse, with the conventions of the native
    scanner, including the categorical hash and the
    FIXED-SLOT layout: numeric column j always sits at batch slot j (id j, value 0 =
    inactive when missing), categoricals append from slot 13. The fixed
    head is what lets ``LogRegConfig.dense_features`` pull/push the
    numeric weights densely instead of via per-example scatter rows."""
    cat_space = num_features - CRITEO_NUM_COLS
    labels, ids_rows, vals_rows = [], [], []
    malformed = 0
    with open(path, "rb") as f:
        for raw in f:
            line = raw.rstrip(b"\r\n")
            if not line:
                continue
            fields = line.split(b"\t")
            ok = len(fields) == 1 + CRITEO_NNZ and fields[0] in (b"0", b"1")
            row_ids = np.zeros(CRITEO_NNZ, np.int32)
            row_vals = np.zeros(CRITEO_NNZ, np.float32)
            row_ids[:CRITEO_NUM_COLS] = np.arange(CRITEO_NUM_COLS)
            nnz = CRITEO_NUM_COLS  # cat slots start after the fixed head
            if ok:
                for j, tok in enumerate(fields[1 : 1 + CRITEO_NUM_COLS]):
                    if not tok:
                        continue
                    # The strict grammar of the native parse_signed:
                    # float() alone would admit "1_0"/"inf"/"nan".
                    if not _SVM_NUM.match(tok):
                        ok = False
                        break
                    v = float(tok)
                    if v >= 0:
                        row_vals[j] = np.log1p(v)
            if ok:
                for j, tok in enumerate(fields[1 + CRITEO_NUM_COLS:],
                                        start=CRITEO_NUM_COLS):
                    if not tok:
                        continue
                    h = _criteo_hash(j, tok)
                    row_ids[nnz] = CRITEO_NUM_COLS + (h % cat_space)
                    row_vals[nnz] = 1.0
                    nnz += 1
            if not ok:
                malformed += 1
                continue
            labels.append(float(fields[0]))
            ids_rows.append(row_ids)
            vals_rows.append(row_vals)
    if malformed:
        raise ValueError(
            f"{path}: {malformed} malformed Criteo line(s) — refusing to "
            "return a silently-truncated dataset"
        )
    n = len(labels)
    return (
        np.asarray(labels, np.float32),
        np.stack(ids_rows) if n else np.zeros((0, CRITEO_NNZ), np.int32),
        np.stack(vals_rows) if n else np.zeros((0, CRITEO_NNZ), np.float32),
    )


def load_criteo(path: str, *, num_features: int = 1 << 20,
                use_native: bool | None = None):
    """Load a Criteo click-log TSV (label + 13 numeric + 26 categorical).

    Returns ``(data, num_features)`` with ``feat_ids (N, 39)``,
    ``feat_vals (N, 39)``, ``label (N,)`` in {-1, +1} (clicks +1). Numeric
    column j: id j, value log1p(x), negatives/missing inactive; categorical
    column j: id ``13 + hash(j, token) % (num_features - 13)``, value 1.
    """
    if num_features <= CRITEO_NUM_COLS:
        raise ValueError("num_features must exceed 13 (the numeric columns)")
    parsed = (native.parse_criteo(path, num_features)
              if native.choose(use_native) else None)
    if parsed is None:
        parsed = _parse_criteo_py(path, num_features)
    labels, ids, vals = parsed
    data = {
        "feat_ids": ids,
        "feat_vals": vals,
        "label": np.where(labels > 0, 1.0, -1.0).astype(np.float32),
    }
    return data, num_features


def sniff_sparse_format(path: str) -> str:
    """Best-effort format detection: ``"svmlight"`` (idx:val tokens) or
    ``"criteo"`` (>= 39 tab-separated fields)."""
    with open(path, "rb") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith(b"#"):
                continue
            if line.count(b"\t") >= CRITEO_NNZ:
                return "criteo"
            if b":" in line:
                return "svmlight"
            break
    raise ValueError(f"{path}: cannot determine sparse dataset format")


def load_sparse(path: str, *, fmt: str = "auto",
                num_features: int | None = None,
                nnz_cap: int | None = None,
                use_native: bool | None = None):
    """Dispatch to :func:`load_svmlight` / :func:`load_criteo` by format.

    Returns ``(data, num_features)`` in the framework's sparse batch shape
    (labels in {-1, +1}; logreg callers map to {0, 1}).
    """
    if fmt == "auto":
        fmt = sniff_sparse_format(path)
    if fmt == "svmlight":
        return load_svmlight(path, num_features=num_features,
                             nnz_cap=nnz_cap, use_native=use_native)
    if fmt == "criteo":
        return load_criteo(path, num_features=num_features or (1 << 20),
                           use_native=use_native)
    raise ValueError(f"unknown sparse dataset format {fmt!r}")

def synthetic_sparse_classification(
    num_examples: int,
    num_features: int,
    nnz_per_example: int,
    *,
    seed: int = 0,
    noise: float = 0.1,
    dense_features: int = 0,
):
    """Linearly separable-ish sparse examples with Zipfian feature frequency.

    ``dense_features=d`` mirrors the Criteo TSV loader's FIXED-SLOT layout:
    batch slot ``j < d`` always carries feature id ``j`` (a dense numeric
    column, present in ~every example; occasionally value 0 = missing),
    and the remaining ``nnz - d`` slots draw Zipfian ids from ``[d, NF)``
    — the shape `LogRegConfig.dense_features` exploits. Default 0 keeps
    the fully-random layout.

    Returns dict with ``feat_ids (N, nnz)``, ``feat_vals (N, nnz)``,
    ``label (N,)`` in {-1, +1}.
    """
    if not 0 <= dense_features <= min(nnz_per_example, num_features):
        raise ValueError(f"dense_features={dense_features} out of range")
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, num_features)
    d = dense_features
    tail_nnz = nnz_per_example - d
    tail_nf = num_features - d
    feat_pop = 1.0 / np.arange(1, tail_nf + 1) ** 0.9
    feat_pop /= feat_pop.sum()
    tail_ids = d + rng.choice(tail_nf, (num_examples, tail_nnz), p=feat_pop)
    head_ids = np.broadcast_to(np.arange(d, dtype=np.int64),
                               (num_examples, d))
    ids = np.concatenate([head_ids, tail_ids], axis=1)
    vals = rng.normal(0, 1, (num_examples, nnz_per_example)).astype(np.float32)
    if d:
        # ~5% missing numerics (value 0 = inactive), like real Criteo rows.
        vals[:, :d] = np.where(rng.random((num_examples, d)) < 0.05, 0.0,
                               vals[:, :d])
    margin = np.sum(w_true[ids] * vals, axis=-1) / np.sqrt(nnz_per_example)
    flip = rng.random(num_examples) < noise
    label = np.where((margin > 0) ^ flip, 1.0, -1.0).astype(np.float32)
    return {
        "feat_ids": ids.astype(np.int32),
        "feat_vals": vals,
        "label": label,
    }


def head_sort_slots(data: dict, head_features: int):
    """Reorder each example's nnz slots so frequency-head ids come first.

    For frequency-ranked feature spaces (the shipped loaders and synthetic
    generators put the hottest ids lowest), stable-partitioning every
    example's slots into (ids < head_features) then (ids >= head_features)
    makes the first ``q = min_examples(head_count)`` slot COLUMNS carry
    head ids in EVERY example — a static guarantee the sparse workers turn
    into ``ops.gather_rows``/``scatter_add`` ``head_prefix`` routing
    (head-only kernels whose cost scales with the head's row tiles, not
    the table's). Measured at ~15% of the end-to-end PA headline
    (BASELINE.md round-5 section). Slot order within an example is
    semantically irrelevant (the models sum over slots), so this is a
    pure relayout.

    Returns ``(data2, q)`` — data with ``feat_ids``/``feat_vals`` columns
    reordered per example (other columns untouched), and the guaranteed
    head-prefix column count (0 if any example has no head feature).
    """
    ids = np.asarray(data["feat_ids"])
    vals = np.asarray(data["feat_vals"])
    is_tail = ids >= head_features
    order = np.argsort(is_tail, axis=1, kind="stable")
    out = dict(data)
    out["feat_ids"] = np.take_along_axis(ids, order, axis=1)
    out["feat_vals"] = np.take_along_axis(vals, order, axis=1)
    q = int((~is_tail).sum(axis=1).min())
    return out, q


def synthetic_sparse_multiclass(
    num_examples: int,
    num_features: int,
    num_classes: int,
    nnz_per_example: int,
    *,
    seed: int = 0,
    noise: float = 0.05,
):
    """Sparse multiclass examples: label = argmax_c <w_c, x> with label noise."""
    rng = np.random.default_rng(seed)
    w_true = rng.normal(0, 1, (num_features, num_classes))
    feat_pop = 1.0 / np.arange(1, num_features + 1) ** 0.9
    feat_pop /= feat_pop.sum()
    ids = rng.choice(num_features, (num_examples, nnz_per_example), p=feat_pop)
    vals = rng.normal(0, 1, (num_examples, nnz_per_example)).astype(np.float32)
    scores = np.einsum("bn,bnc->bc", vals, w_true[ids])
    label = np.argmax(scores, axis=-1)
    flip = rng.random(num_examples) < noise
    label = np.where(flip, rng.integers(0, num_classes, num_examples), label)
    return {
        "feat_ids": ids.astype(np.int32),
        "feat_vals": vals,
        "label": label.astype(np.int32),
    }


def streaming_rating_batches(
    num_users: int,
    num_items: int,
    *,
    rank: int = 6,
    noise: float = 0.05,
    seed: int = 0,
    batch: int = 4096,
    max_records: int | None = None,
):
    """Unbounded-style generator of rating batches from one planted model.

    The streaming analog of :func:`synthetic_ratings` — same planted
    low-rank structure and Zipfian item popularity, yielded as an endless
    (or ``max_records``-bounded) sequence of columnar batches for
    :func:`fps_tpu_torch.core.ingest.stream_chunks`.
    """
    rng = np.random.default_rng(seed)
    p = rng.normal(0, 1.0 / np.sqrt(rank), (num_users, rank))
    q = rng.normal(0, 1.0 / np.sqrt(rank), (num_items, rank))
    item_pop = 1.0 / np.arange(1, num_items + 1) ** 0.8
    item_pop /= item_pop.sum()
    produced = 0
    while max_records is None or produced < max_records:
        n = batch if max_records is None else min(batch, max_records - produced)
        users = rng.integers(0, num_users, n)
        items = rng.choice(num_items, n, p=item_pop)
        ratings = (np.sum(p[users] * q[items], -1)
                   + rng.normal(0, noise, n)).astype(np.float32)
        produced += n
        yield {"user": users.astype(np.int32),
               "item": items.astype(np.int32),
               "rating": ratings}
