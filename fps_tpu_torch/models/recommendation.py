"""Top-k recommendation over a factor table of the port's store.

Port of ``fps_tpu/models/recommendation.py`` (the reference's online-MF
"...AndTopK" variant, which emits the current top-k items of the users it
trains): :func:`build_topk_fn` / :func:`recommend_topk` rank a table's rows
for given query vectors, :func:`make_online_topk_tap` does so inside the
training loop as a ``TrainerConfig.step_tap``, and :func:`mf_user_vectors`
reads MF's worker-local user factors.

Each shard scores the queries against its own rows (``(B, dim) @ (rps,
dim)^T``) and takes a local top-``(k + E)`` (``E`` the exclusion capacity,
so exclusions never eat into the true top-k) with the rows' logical ids;
the candidates are all-gathered over the shard axis, in shard order, the
excluded ids masked, and a final top-k merges them, as in the JAX package.
The table never moves: only queries and candidates cross positions, through
:mod:`fps_tpu_torch.parallel.collectives`. The scores come from
``torch.matmul`` (the JAX package computes them outside any Pallas kernel
too).

Ties: ``lax.top_k`` puts the lower index first; ``torch.topk`` promises no
order among equal values. Both stages here rank by ``(-score, index)``: a
stable descending sort, so a shard's candidates tie by physical row and the
merge ties by position in the shard-major pool, as the JAX package's do,
and the ids equal its ids, ties included.
"""

from __future__ import annotations

import numpy as np
import torch

from fps_tpu_torch.core.store import ParamStore, phys_to_id, pull_local
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import SHARD_AXIS

Tensor = torch.Tensor

NEG_INF = float(np.float32(-3.0e38))


def _topk_rows(scores: Tensor, n: int) -> tuple[Tensor, Tensor]:
    """The ``n`` best of each row, best first, equal values by lower column
    (``lax.top_k``'s order): ``(values, columns)``."""
    vals, cols = torch.sort(scores, dim=1, descending=True, stable=True)
    return vals[:, :n], cols[:, :n]


def _score_and_local_topk(local: Tensor, queries: Tensor, *, shard: int,
                          num_shards: int, num_ids: int,
                          n: int) -> tuple[Tensor, Tensor]:
    """Score ``queries`` against shard ``shard``'s rows, mask padding rows
    and take the top ``n`` with their logical ids."""
    rps = local.shape[0]
    phys = shard * rps + torch.arange(rps, dtype=torch.int32,
                                      device=local.device)
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

    ``tables[table]`` is the table's blocks, one a mesh position;
    ``queries`` are ``(B, dim)`` float vectors
    and ``exclude`` ``(B, exclude_capacity)`` int ids to mask (``-1`` for
    unused slots; ignored when ``exclude_capacity`` is 0), both on the
    mesh's home device and replicated to every position (the JAX package's
    ``P()``). Every position scores its block; the shard axis all-gathers
    the candidates; the process's first position's pool is merged (every
    position's holds the same). Returns ``ids (B, k)`` int32 and ``scores (B, k)``, best first,
    on the home device.
    """
    mesh = store.mesh
    spec = store.specs[table]
    S = store.num_shards
    cand = k + exclude_capacity

    def fn(tables, queries, exclude):
        cands = [_score_and_local_topk(blk, q, shard=p % S, num_shards=S,
                                       num_ids=spec.num_ids, n=cand)
                 for p, blk, q in zip(mesh.local, tables[table],
                                      collectives.broadcast(mesh, queries))]
        # (B, S * n): the shards' candidates side by side, in shard order.
        top_s = collectives.all_gather(mesh, [c[0] for c in cands],
                                       SHARD_AXIS, dim=1)[0]
        top_ids = collectives.all_gather(mesh, [c[1] for c in cands],
                                         SHARD_AXIS, dim=1)[0]
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
    arrays. Over several processes a collective: every process calls it
    with the same queries and gets the result."""
    B = len(queries)
    E = 0 if exclude is None else int(np.asarray(exclude).shape[1])
    device = store.mesh.device
    fn = build_topk_fn(store, table, k, exclude_capacity=E)
    q = torch.as_tensor(np.asarray(queries)).to(device)
    ex = torch.as_tensor(np.asarray(
        exclude if exclude is not None else np.full((B, 1), -1),
        np.int32)).to(device)
    ids, scores = fn(store.tables, q, ex)
    return ids.cpu().numpy(), scores.cpu().numpy()


def _topk_local_queries(mesh, blocks, queries, *, num_shards: int,
                        num_ids: int, k: int) -> list[tuple[Tensor, Tensor]]:
    """Each worker's top-``k`` for its own ``(q, dim)`` queries (one a
    position): the shard axis all-gathers the queries, every shard scores
    all of its data replica's against its own rows, the candidates are
    all-gathered back, and each worker merges the slice that belongs to its
    queries, ``(q, S * n)`` in shard order. The table never moves."""
    S = num_shards
    q = queries[0].shape[0]
    every = collectives.all_gather(mesh, queries, SHARD_AXIS)  # (S * q, dim)
    cands = [_score_and_local_topk(blk, qs, shard=p % S, num_shards=S,
                                   num_ids=num_ids, n=k)
             for p, blk, qs in zip(mesh.local, blocks, every)]
    out = []
    for p, all_s, all_i in zip(mesh.local, *(
            collectives.all_gather(mesh, [c[j][None] for c in cands],
                                   SHARD_AXIS) for j in (0, 1))):
        # (S, S * q, n): shard j's candidates for every query of the group;
        # this worker's are rows [s * q, (s + 1) * q) of each.
        s = p % S
        mine_s, mine_i = (x[:, s * q:(s + 1) * q].transpose(0, 1).reshape(
            q, -1) for x in (all_s, all_i))
        out.append(_merge_topk(mine_s, mine_i, k))
    return out


def make_online_topk_tap(store: ParamStore, table: str, k: int, *,
                         every: int, query_fn):
    """A ``TrainerConfig.step_tap`` emitting top-k inside the training loop.

    Every ``every`` steps (``t % every == 0``) each worker ranks
    ``query_fn``'s queries against the live table; the results ride the
    metrics under ``"tap"`` (leaves ``(T, W, q)`` and ``(T, W, q, k)``).
    Other steps emit ``-1`` ids and query ids and ``NEG_INF`` scores, and
    rank nothing.

    The tap is collective (``tap.collective``): the driver calls it once a
    step with every position's blocks and every worker's batch and local
    state, and the shards score each other's workers' queries
    (:func:`_topk_local_queries`), as the JAX package's tap does through its
    all-gathers over the shard axis.

    ``query_fn(batch, local_state) -> (query_ids (q,), queries (q, dim))``,
    e.g. the first q users of the batch with their local factor rows
    (:func:`mf_topk_query_fn`).
    """
    mesh = store.mesh
    num_shards = store.num_shards
    num_ids = store.specs[table].num_ids

    def tap(tables, batches, local_states, t):
        asked = [query_fn(b, s) for b, s in zip(batches, local_states)]
        if t % every == 0:
            ranked = _topk_local_queries(
                mesh, tables[table], [qv for _, qv in asked],
                num_shards=num_shards, num_ids=num_ids, k=k)
            return [{"topk_query": qids.to(torch.int32), "topk_ids": ids,
                     "topk_scores": scores}
                    for (qids, _), (ids, scores) in zip(asked, ranked)]
        out = []
        for _, queries in asked:
            q, dev = queries.shape[0], queries.device
            out.append({
                "topk_query": torch.full((q,), -1, dtype=torch.int32,
                                         device=dev),
                "topk_ids": torch.full((q, k), -1, dtype=torch.int32,
                                       device=dev),
                "topk_scores": torch.full((q, k), NEG_INF,
                                          dtype=torch.float32, device=dev)})
        return out

    tap.collective = True
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
