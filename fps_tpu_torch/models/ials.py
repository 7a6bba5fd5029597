"""Implicit-feedback iALS (Hu, Koren, Volinsky 2008) on the port.

Port of ``fps_tpu/models/ials.py``. An observed interaction ``(u, i, r)``
has confidence ``c = 1 + alpha * r`` and preference 1; every unobserved pair
has confidence 1 and preference 0. Each half-epoch fixes one side and
solves, for every id of the other side,

    (G + alpha * sum_i r_ui * y_i y_i^T + reg * I) x_u = sum_i (1 + alpha * r_ui) y_i

with ``G = Y^T Y`` the Gramian over every row of the fixed side. Three
parts, as in the JAX package, each on every position of the mesh:

1. **Gramian**: each shard's ``Y_s^T Y_s`` over its block's valid rows
   (``torch.matmul``; the JAX package computes it outside any Pallas kernel
   too), summed over the shard axis in shard order
   (:func:`fps_tpu_torch.parallel.collectives.psum`): every position holds
   ``G``, and the table never moves.
2. **Accumulate**: a Python loop over a chunk's steps, the chunk's ``(T,
   B)`` columns cut over every worker (both mesh axes): the collective
   :func:`~fps_tpu_torch.core.store.pull` of the fixed side's rows (kernel
   K1 on the card, once a shard), the ``alpha * r * y y^T`` and ``(1 +
   alpha * r) * y`` blocks, and two collective
   :func:`~fps_tpu_torch.core.store.push` calls into the ``A`` and ``b``
   accumulator tables keyed by the solved side's id (``combine="sum"``, in
   place: kernel K2, at ``D = rank * rank`` and ``D = rank``, once a
   position). The pushes gather over the data axis too, so each data
   replica's accumulators fold every worker's contributions once. Weight-0
   padding pushes id ``-1``. The normal equations are one more table of the
   parameter server, laid out as the factor table they solve.
3. **Solve**: each position solves its own block, one batched
   ``torch.linalg.solve`` (LU, as ``jnp.linalg.solve``) of ``G + A + reg *
   I``; padding rows are zeroed, and the solved blocks are the store's new
   table.

``IALSSolver.prefetch > 0`` assembles and places a half-epoch's chunks that
many chunks ahead on a worker thread
(:class:`~fps_tpu_torch.core.prefetch.ChunkPrefetcher`), as the JAX package
does; the accumulate order, and so the solve, is the same either way.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, Iterator

import numpy as np
import torch

from fps_tpu_torch.analysis import record as _record
from fps_tpu_torch.core.prefetch import (
    ChunkPrefetcher,
    place_columns,
    placed_batches,
)
from fps_tpu_torch.core.store import (
    ParamStore,
    TableSpec,
    phys_to_id,
    pull,
    push,
    ranged_uniform_init,
    rows_per_shard,
)
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    SHARD_AXIS,
    Blocks,
    PSMesh,
    num_workers_of,
)

Tensor = torch.Tensor

USER_TABLE = "user_factors"
ITEM_TABLE = "item_factors"

@dataclasses.dataclass
class IALSConfig:
    num_users: int
    num_items: int
    rank: int = 16
    alpha: float = 40.0
    reg: float = 0.1
    init_scale: float = 0.01
    dtype: torch.dtype = torch.float32


class IALSSolver:
    """Alternating normal-equation solver for implicit feedback.

    Usage::

        solver = IALSSolver(mesh, IALSConfig(nu, ni, rank=16))
        solver.init(0)
        for _ in range(epochs):
            solver.epoch(lambda: interaction_chunks(...))
        users, items = solver.factors()
    """

    def __init__(self, mesh: PSMesh, cfg: IALSConfig):
        self.mesh = mesh
        self.device = mesh.device
        self.cfg = cfg
        self.num_shards = mesh.shape[SHARD_AXIS]
        self.num_data = mesh.shape[DATA_AXIS]
        # Workers are every position: the interaction stream splits over
        # both mesh axes.
        self.num_workers = num_workers_of(mesh)
        init = ranged_uniform_init(-cfg.init_scale, cfg.init_scale, cfg.rank,
                                   cfg.dtype)
        self.store = ParamStore(mesh, [
            TableSpec(USER_TABLE, cfg.num_users, cfg.rank, init, cfg.dtype),
            TableSpec(ITEM_TABLE, cfg.num_items, cfg.rank, init, cfg.dtype),
        ])
        # Depth of half_epoch's overlapped host pipeline (0: synchronous).
        self.prefetch = 0

    # -- state --------------------------------------------------------------

    def init(self, seed: int) -> dict[str, Tensor]:
        """Both factor tables from ``seed`` (the store's per-id hash)."""
        return self.store.init(seed)

    def factors(self) -> tuple[np.ndarray, np.ndarray]:
        return (self.store.dump_model(USER_TABLE)[1],
                self.store.dump_model(ITEM_TABLE)[1])

    # -- the three parts ----------------------------------------------------

    def _valid(self, num_ids: int, rps: int, shard: int,
               device: torch.device) -> Tensor:
        """``(rps,)`` bool: each row of shard ``shard``'s block holds a real
        id (the JAX package's ``_valid_mask``)."""
        phys = shard * rps + torch.arange(rps, device=device)
        return phys_to_id(phys, self.num_shards, rps) < num_ids

    def _gram(self, fixed, num_ids: int) -> list[Tensor]:
        """The ``(k, k)`` Gramian of the fixed table's valid rows on every
        position (``fixed``: the table's blocks, one a position): each
        shard's own, summed over the shard axis."""
        parts = []
        for p, blk in zip(self.mesh.local, fixed):
            valid = self._valid(num_ids, blk.shape[0], p % self.num_shards,
                                blk.device)
            rows = torch.where(valid[:, None], blk,
                               torch.zeros((), dtype=blk.dtype,
                                           device=blk.device))
            parts.append(rows.T @ rows)
        return collectives.psum(self.mesh, parts, SHARD_AXIS)

    def _accumulate(self, fixed, A, b, chunk) -> None:
        """Fold one chunk's ``(T, B)`` interactions into ``A`` and ``b`` in
        place, one step (a pull and two pushes) at a time.

        ``fixed``, ``A`` and ``b`` are blocks, one a position, and ``chunk``
        each worker's columns (:meth:`half_epoch` cuts them)."""
        cfg = self.cfg
        k = cfg.rank
        S, mesh = self.num_shards, self.mesh
        for t in range(chunk[0]["solve_ids"].shape[0]):
            _record.mark_step()
            fixed_ids = [c["fixed_ids"][t].to(torch.int32) for c in chunk]
            ys = pull(fixed, fixed_ids, num_shards=S, mesh=mesh)
            ids, outers, vecs = [], [], []
            for c, y in zip(chunk, ys):
                r = c["rating"][t].to(cfg.dtype)
                w = c["weight"][t].to(cfg.dtype)
                cr = cfg.alpha * r * w  # confidence minus 1, masked
                outer = cr[:, None, None] * y[:, :, None] * y[:, None, :]
                outers.append(outer.reshape(-1, k * k))
                vecs.append(((1.0 + cfg.alpha * r) * w)[:, None] * y)
                ids.append(torch.where(
                    w > 0, c["solve_ids"][t].to(torch.int32), -1))
            push(A, ids, outers, num_shards=S, inplace=True, mesh=mesh)
            push(b, ids, vecs, num_shards=S, inplace=True, mesh=mesh)

    def _solve(self, gram, A, b, num_ids: int) -> list[Tensor]:
        """The solved ``(rps, k)`` block of each position (its Gramian and
        accumulator blocks in); padding rows zero."""
        cfg = self.cfg
        k = cfg.rank
        out = []
        for p, g, a, v in zip(self.mesh.local, gram, A, b):
            lhs = g[None] + a.reshape(-1, k, k)
            lhs = lhs + cfg.reg * torch.eye(k, dtype=cfg.dtype,
                                            device=a.device)[None]
            x = torch.linalg.solve(lhs, v[:, :, None])[:, :, 0]
            valid = self._valid(num_ids, x.shape[0], p % self.num_shards,
                                x.device)
            out.append(torch.where(valid[:, None], x,
                                   torch.zeros((), dtype=x.dtype,
                                               device=x.device)).to(cfg.dtype))
        return out

    # -- half-epoch ----------------------------------------------------------

    def half_epoch(self, solve: str, chunks: Iterable[dict]) -> None:
        """One ALS half-step: solve the ``"user"`` or ``"item"`` factors.

        ``chunks`` yield dicts of ``(T, B)`` columns ``user``, ``item``,
        ``rating`` and ``weight``: host arrays (as
        :func:`fps_tpu_torch.core.ingest.epoch_chunks` makes them), which
        are copied over, or tensors already on the mesh's home device (as
        :func:`fps_tpu_torch.core.device_ingest.device_epoch_chunks` makes
        them), which are used as they are, with no host round trip. ``B``
        is the global batch, a multiple of ``num_workers`` (every position
        of the mesh), worker ``w`` taking columns ``[w * B / W, (w + 1) *
        B / W)``. Over several processes every process passes the same
        chunks and places its own workers' columns.
        """
        cfg = self.cfg
        if solve == "user":
            solve_name, fixed_name = USER_TABLE, ITEM_TABLE
            solve_col, fixed_col = "user", "item"
            solve_n, fixed_n = cfg.num_users, cfg.num_items
        elif solve == "item":
            solve_name, fixed_name = ITEM_TABLE, USER_TABLE
            solve_col, fixed_col = "item", "user"
            solve_n, fixed_n = cfg.num_items, cfg.num_users
        else:
            raise ValueError(f"solve must be 'user' or 'item', got {solve!r}")
        if self.prefetch < 0:
            raise ValueError(
                f"IALSSolver.prefetch must be >= 0, got {self.prefetch}")

        mesh = self.mesh
        fixed = list(self.store.tables[fixed_name])
        gram = self._gram(fixed, fixed_n)
        rps = rows_per_shard(solve_n, self.num_shards)
        A = [torch.zeros((rps, cfg.rank * cfg.rank), dtype=cfg.dtype,
                         device=dev) for dev in mesh.positions]
        b = [torch.zeros((rps, cfg.rank), dtype=cfg.dtype, device=dev)
             for dev in mesh.positions]

        def place(chunk):
            return place_columns(collectives.own_columns(mesh, {
                "solve_ids": chunk[solve_col],
                "fixed_ids": chunk[fixed_col],
                "rating": chunk["rating"],
                "weight": chunk["weight"],
            }, 1), self.device)

        pf = (ChunkPrefetcher(chunks, place, depth=self.prefetch,
                              device=self.device) if self.prefetch else None)
        try:
            for placed in pf if pf is not None else map(place, chunks):
                # Worker w takes columns [w * B, (w + 1) * B) of the (T,
                # W * B) chunk, on its device (the JAX package's P(None,
                # ('data', 'shard'))); the process placed its own workers'.
                cols = {k: collectives.scatter_local(mesh, v, 1)
                        for k, v in placed_batches(placed,
                                                   self.device).items()}
                self._accumulate(fixed, A, b, [
                    {k: v[i] for k, v in cols.items()}
                    for i in range(len(mesh.local))])
        finally:
            if pf is not None:
                pf.close()
        self.store.tables[solve_name] = Blocks(
            self._solve(gram, A, b, solve_n), replicas=self.num_data,
            mesh=mesh)

    def epoch(self, make_chunks) -> None:
        """One full ALS epoch. ``make_chunks()`` returns a fresh chunk
        iterator (it is consumed twice: once a half-epoch)."""
        self.half_epoch("user", make_chunks())
        self.half_epoch("item", make_chunks())

    # -- evaluation ----------------------------------------------------------

    def weighted_loss(self, users: np.ndarray, items: np.ndarray,
                      ratings: np.ndarray, sample_unobserved: int = 0,
                      seed: int = 0) -> float:
        """Host-side iALS objective estimate: the observed confidence-weighted
        term ``sum c * (1 - x.y)^2`` plus the exact regularizer
        ``reg * (sum ||x_u||^2 + sum ||y_i||^2)`` (+ optionally a Monte-Carlo
        estimate of the unobserved ``(0 - x.y)^2`` term: the sampled mean
        scaled by ``num_users * num_items``, pairs drawn uniformly with
        replacement)."""
        cfg = self.cfg
        U, V = self.factors()
        xy = np.sum(U[users] * V[items], axis=-1)
        c = 1.0 + cfg.alpha * ratings
        loss = float(np.sum(c * (1.0 - xy) ** 2))
        loss += cfg.reg * float(np.sum(U * U) + np.sum(V * V))
        if sample_unobserved:
            rng = np.random.default_rng(seed)
            su = rng.integers(0, cfg.num_users, sample_unobserved)
            si = rng.integers(0, cfg.num_items, sample_unobserved)
            mean_sq = float(np.mean(np.sum(U[su] * V[si], axis=-1) ** 2))
            loss += mean_sq * cfg.num_users * cfg.num_items
        return loss


def interaction_chunks(data: dict, *, num_workers: int, local_batch: int,
                       steps_per_chunk: int,
                       seed: int | None = 0) -> Iterator[dict]:
    """Fixed-shape ``(T, B)`` interaction chunks for the accumulate pass:
    :func:`fps_tpu_torch.core.ingest.epoch_chunks` with round-robin
    placement (iALS has no worker-local state to route for)."""
    from fps_tpu_torch.core.ingest import epoch_chunks

    return epoch_chunks(data, num_workers=num_workers,
                        local_batch=local_batch,
                        steps_per_chunk=steps_per_chunk, seed=seed)


def recall_at_k(solver: IALSSolver, heldout_user: np.ndarray,
                heldout_item: np.ndarray, *, k: int = 10,
                exclude: tuple[np.ndarray, np.ndarray] | None = None) -> float:
    """Fraction of held-out ``(user, item)`` pairs ranked in the user's
    top-k, on the host.

    ``exclude = (train_users, train_items)`` masks each evaluated user's
    training items out of the ranking, but never the held-out item itself.
    """
    U, V = solver.factors()
    scores = U[heldout_user] @ V.T  # (H, num_items)
    if exclude is not None:
        tu, ti = exclude
        order = np.argsort(tu, kind="stable")
        tu_s, ti_s = np.asarray(tu)[order], np.asarray(ti)[order]
        starts = np.searchsorted(tu_s, np.arange(solver.cfg.num_users))
        ends = np.searchsorted(tu_s, np.arange(solver.cfg.num_users), "right")
        for row, u in enumerate(heldout_user):
            held = scores[row, heldout_item[row]]
            scores[row, ti_s[starts[u]:ends[u]]] = -np.inf
            scores[row, heldout_item[row]] = held
    ranks = np.argsort(-scores, axis=1)[:, :k]
    return float(np.mean(np.any(ranks == heldout_item[:, None], axis=1)))
