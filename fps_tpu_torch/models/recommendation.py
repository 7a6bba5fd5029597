"""Top-k recommendation over a factor table of the port's store.

Port of ``fps_tpu/models/recommendation.py`` (the reference's online-MF
"...AndTopK" variant, which emits the current top-k items of the users it
trains): :func:`build_topk_fn` / :func:`recommend_topk` rank a table's rows
for given query vectors, :func:`make_online_topk_tap` does so inside the
training loop as a ``TrainerConfig.step_tap``, and :func:`mf_user_vectors`
reads MF's worker-local user factors.

The JAX package scores each shard's rows (``(B, dim) @ (rps, dim)^T``),
takes a local top-``(k + E)`` (``E`` the exclusion capacity, so exclusions
never eat into the true top-k), gathers the candidates over the shards,
masks the excluded ids and merges with a final top-k. The port keeps the
same two stages on one position of the mesh (the gather is then the
identity; a sharded item table is ROADMAP.md Queue 1 item 4c),
with the scores from ``torch.matmul`` (the JAX package computes them outside
any Pallas kernel too).

Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` promises no
order among equal values. Both stages here rank by ``(-score, index)``: a
stable descending sort, so the ids equal the JAX package's, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

from fps_tpu_torch.core.store import ParamStore, phys_to_id, pull_local
from fps_tpu_torch.parallel.mesh import SHARDED_STORE_ITEM, num_workers_of

Tensor = torch.Tensor

NEG_INF = float(np.float32(-3.0e38))


def _one_position(store: ParamStore, fn: str) -> None:
    if num_workers_of(store.mesh) != 1:
        raise NotImplementedError(
            f"{fn} on a {dict(store.mesh.shape)} mesh: the port ranks a "
            f"table on one position; several are {SHARDED_STORE_ITEM}")


def _topk_rows(scores: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """The ``n`` best of each row, best first, equal values by lower column
    (``lax.top_k``'s order): ``(values, columns)``."""
    vals, cols = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :n], cols[:, :n]


def _score_and_local_topk(local: Tensor, queries: Tensor, *, num_shards: int,
                          num_ids: int, n: int) -> tuple[Tensor, Tensor]:
    """Score ``queries`` against the table's rows, mask padding rows and take
    the top ``n`` with their logical ids."""
    rps = local.shape[0]
    phys = torch.arange(rps, dtype=torch.int32, device=local.device)
    ids = phys_to_id(phys, num_shards, rps)
    scores = queries.to(torch.float32) @ local.to(torch.float32).T
    scores = torch.where((ids < num_ids)[None, :], scores,
                         torch.tensor(NEG_INF, device=local.device))
    top_s, top_i = _topk_rows(scores, min(n, rps))
    return top_s, ids[top_i]


def _merge_topk(scores: Tensor, ids: Tensor, k: int) -> tuple[Tensor, Tensor]:
    """Top ``k`` of the ``(B, C)`` candidate pool, padded out to ``(B, k)``
    with ``-1`` ids and ``NEG_INF`` scores where the pool is smaller."""
    k_eff = min(k, scores.shape[1])
    out_s, out_j = _topk_rows(scores, k_eff)
    out_i = torch.gather(ids, 1, out_j)
    if k_eff < k:
        pad = (0, k - k_eff)
        out_s = torch.nn.functional.pad(out_s, pad, value=NEG_INF)
        out_i = torch.nn.functional.pad(out_i, pad, value=-1)
    return out_i.to(torch.int32), out_s


def build_topk_fn(store: ParamStore, table: str, k: int,
                  exclude_capacity: int = 0):
    """``fn(tables, queries, exclude) -> (ids, scores)``: top-k ranking of
    ``table``'s rows.

    ``queries`` are ``(B, dim)`` float vectors on the store's device,
    ``exclude`` ``(B, exclude_capacity)`` int ids to mask (``-1`` for unused
    slots; ignored when ``exclude_capacity`` is 0). Returns ``ids (B, k)``
    int32 and ``scores (B, k)``, best first.
    """
    _one_position(store, "build_topk_fn")
    spec = store.specs[table]
    num_shards = store.num_shards
    cand = k + exclude_capacity

    def fn(tables, queries, exclude):
        top_s, top_ids = _score_and_local_topk(
            tables[table], queries, num_shards=num_shards,
            num_ids=spec.num_ids, n=cand)
        if exclude_capacity:
            hit = torch.any(top_ids[:, :, None] == exclude[:, None, :], dim=-1)
            top_s = torch.where(hit, torch.tensor(NEG_INF,
                                                  device=top_s.device), top_s)
        return _merge_topk(top_s, top_ids, k)

    return fn


def recommend_topk(store: ParamStore, table: str, queries: np.ndarray, k: int,
                   *, exclude: np.ndarray | None = None
                   ) -> tuple[np.ndarray, np.ndarray]:
    """Rank ``table``'s rows for ``queries`` (host ``(B, dim)``) on the
    store's live tables; ``exclude`` an optional ``(B, E)`` int array of ids
    to mask per query (``-1`` unused). Returns ``(ids, scores)`` as numpy
    arrays."""
    B = len(queries)
    E = 0 if exclude is None else int(np.asarray(exclude).shape[1])
    device = store.mesh.device
    fn = build_topk_fn(store, table, k, exclude_capacity=E)
    q = torch.as_tensor(np.asarray(queries)).to(device)
    ex = torch.as_tensor(np.asarray(
        exclude if exclude is not None else np.full((B, 1), -1),
        np.int32)).to(device)
    ids, scores = fn({table: store.table(table)}, q, ex)
    return ids.cpu().numpy(), scores.cpu().numpy()


def make_online_topk_tap(store: ParamStore, table: str, k: int, *,
                         every: int, query_fn):
    """A ``TrainerConfig.step_tap`` emitting top-k inside the training loop.

    Every ``every`` steps (``t % every == 0``) the worker ranks
    ``query_fn``'s queries against the live table; the results ride the
    metrics under ``"tap"`` (leaves ``(T, W, q)`` and ``(T, W, q, k)``).
    Other steps emit ``-1`` ids and query ids and ``NEG_INF`` scores, and
    rank nothing.

    ``query_fn(batch, local_state) -> (query_ids (q,), queries (q, dim))``,
    e.g. the first q users of the batch with their local factor rows
    (:func:`mf_topk_query_fn`).
    """
    _one_position(store, "make_online_topk_tap")
    num_shards = store.num_shards
    num_ids = store.specs[table].num_ids

    def tap(tables, batch, local_state, t):
        qids, queries = query_fn(batch, local_state)
        q = queries.shape[0]
        dev = queries.device
        if t % every == 0:
            top_s, top_ids = _score_and_local_topk(
                tables[table], queries, num_shards=num_shards,
                num_ids=num_ids, n=k)
            ids, scores = _merge_topk(top_s, top_ids, k)
            qids = qids.to(torch.int32)
        else:
            ids = torch.full((q, k), -1, dtype=torch.int32, device=dev)
            scores = torch.full((q, k), NEG_INF, dtype=torch.float32,
                                device=dev)
            qids = torch.full((q,), -1, dtype=torch.int32, device=dev)
        return {"topk_query": qids, "topk_ids": ids, "topk_scores": scores}

    return tap


def mf_topk_query_fn(num_workers: int, num_queries: int):
    """Query fn for MF: the first ``num_queries`` users of the batch with
    their worker-local factor rows.

    Padding rows (``weight == 0``) emit query id ``-1``: a padded slot's
    user belongs to another worker's routing domain, so its local row would
    be another user's; consumers skip ``-1`` queries."""

    def query_fn(batch, local_state):
        users = batch["user"][:num_queries].to(torch.int32)
        valid = batch["weight"][:num_queries] > 0
        qids = torch.where(valid, users, -1)
        qvecs = pull_local(local_state, users, num_shards=num_workers)
        return qids, qvecs

    return query_fn


def mf_user_vectors(
    user_factors_global: np.ndarray, num_workers: int, users: np.ndarray
) -> np.ndarray:
    """Extract user factor rows from MF's worker-sharded local state.

    MF keeps user vectors worker-local in owner-major cyclic layout
    (``fps_tpu_torch.models.matrix_factorization``); this resolves logical
    user ids to their physical rows, for use as top-k ``queries``.
    """
    table = np.asarray(user_factors_global)
    rps = table.shape[0] // num_workers
    users = np.asarray(users)
    return table[(users % num_workers) * rps + users // num_workers]
