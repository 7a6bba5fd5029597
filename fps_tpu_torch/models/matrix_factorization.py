"""Online matrix factorization (SGD): the reference's flagship algorithm.

Port of ``fps_tpu/models/matrix_factorization.py``. Item factor vectors are
the parameter-server table, pulled and pushed by item id; user factor vectors
are worker-local state (the stream is routed by user, so each worker owns its
users' rows). Per batch: pull the items' vectors, gather the users' vectors,
one dense SGD step on the ``(B, rank)`` blocks, add the user deltas into the
local table and push the item deltas. Duplicate users or items in a batch
accumulate into the same row.

Both the user update and the item push go through the port's scatter-add, so
on the card they run on its deterministic kernel, not on ``index_add_``'s
float atomics. Negative samples are drawn from the step's
``torch.Generator``: the same layout as in the JAX package, not the same
numbers.
"""

from __future__ import annotations

import dataclasses
from typing import Mapping

import numpy as np
import torch

from fps_tpu_torch import ops
from fps_tpu_torch.core.api import StepOutput, WorkerLogic
from fps_tpu_torch.core.store import (
    ParamStore,
    TableSpec,
    make_table_values,
    pull_local,
    ranged_uniform_init,
)
from fps_tpu_torch.parallel.mesh import Blocks

Tensor = torch.Tensor

ITEM_TABLE = "item_factors"


@dataclasses.dataclass
class MFConfig:
    num_users: int
    num_items: int
    rank: int = 10
    learning_rate: float = 0.05
    reg: float = 0.01
    init_min: float = -0.1
    init_max: float = 0.1
    # Item ids [0, hot_items) are write-hot (the NuPS-style hot/cold push
    # split): the item push takes the head through kernel K3 and the tail
    # through K2. Ids must be frequency-ranked (the generators and loaders
    # rank them so). 0 disables.
    hot_items: int = 0
    # Negative sampling of unrated items: each rating also samples this many
    # uniform random items, pseudo-rated ``negative_target`` with weight
    # ``negative_weight``, in the same SGD step. 0 disables.
    negative_samples: int = 0
    negative_target: float = 0.0
    negative_weight: float = 1.0
    dtype: torch.dtype = torch.float32


class MatrixFactorizationWorker(WorkerLogic):
    """Worker logic: local user factors, pulled item factors, SGD updates."""

    def __init__(self, config: MFConfig, num_workers: int):
        self.cfg = config
        self.num_workers = num_workers

    # local_state = the worker-sharded user factor table (owner-major cyclic
    # over num_workers, like a PS table but never communicated).
    def init_local_state(self, seed: int, num_workers: int, device):
        cfg = self.cfg
        return make_table_values(
            seed, cfg.num_users, cfg.rank, num_workers,
            ranged_uniform_init(cfg.init_min, cfg.init_max, cfg.rank,
                                cfg.dtype),
            cfg.dtype, device)

    def export_local_state(self, local_state):
        """User factors in logical user order (padding stripped)."""
        from fps_tpu_torch.models.recommendation import mf_user_vectors

        return mf_user_vectors(_host(local_state), self.num_workers,
                               np.arange(self.cfg.num_users))

    def import_local_state(self, leaves, num_workers):
        (logical,) = leaves
        nu, rank = self.cfg.num_users, self.cfg.rank
        if logical.shape != (nu, rank):
            raise ValueError(
                f"checkpointed user factors shape {logical.shape} != "
                f"({nu}, {rank})")
        rps = -(-nu // num_workers)
        table = np.zeros((rps * num_workers, rank), logical.dtype)
        u = np.arange(nu)
        table[(u % num_workers) * rps + u // num_workers] = logical
        return table

    def prepare(self, batch, gen):
        n = self.cfg.negative_samples
        if not n:
            return batch
        items = batch["item"].to(torch.int32)
        negs = torch.randint(0, self.cfg.num_items, (items.shape[0], n),
                             generator=gen, device=items.device,
                             dtype=torch.int32)
        # One (B, 1+n) matrix, [positive, negatives], read by both pull_ids
        # and step, so their orders cannot drift apart.
        return dict(batch, all_items=torch.cat([items[:, None], negs], 1))

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        if self.cfg.negative_samples:
            return {ITEM_TABLE: batch["all_items"].reshape(-1)}
        return {ITEM_TABLE: batch["item"].to(torch.int32)}

    def pulled_ids_host(self, chunk):
        """The cold routes' certification stream (``TableSpec.cold_budget``):
        the raw item column covers every id a step pulls and pushes (pushes
        mask padding to ``-1``, so certifying on the pulls is conservative).
        With negative sampling the ids are drawn on the device in
        :meth:`prepare`, so the chunks cannot be certified."""
        if self.cfg.negative_samples:
            return None
        return {ITEM_TABLE: chunk["item"]}

    def pulled_ids_traced(self, batch):
        """The megastep's device certification stream: the contract of
        :meth:`pulled_ids_host`, from one worker's raw batch on the device.
        Negative sampling draws ids in :meth:`prepare`, so those runs stay
        uncertifiable."""
        if self.cfg.negative_samples:
            return None
        return {ITEM_TABLE: batch["item"].to(torch.int32)}

    def touched_local_rows(self, batch):
        """The local user rows :meth:`step` scatters into (``-1`` for
        padding examples); the user table is the only leaf."""
        u = batch["user"].to(torch.int32)
        live = batch["weight"].to(torch.float32) > 0
        return (torch.where(live, u // self.num_workers, -1),)

    def step(self, batch, pulled, local_state, gen) -> StepOutput:
        cfg = self.cfg
        n = cfg.negative_samples
        user_factors = local_state
        u = batch["user"].to(torch.int32)
        w = batch["weight"].to(cfg.dtype)
        r = batch["rating"].to(cfg.dtype)
        B = u.shape[0]
        if n:
            # Column 0 is the real rating; columns 1.. the sampled items.
            q = pulled[ITEM_TABLE].reshape(B, 1 + n, -1)
            items = batch["all_items"]
            targets = torch.cat(
                [r[:, None], torch.full((B, n), cfg.negative_target,
                                        dtype=cfg.dtype, device=r.device)], 1)
            wts = torch.cat(
                [w[:, None], w[:, None] * torch.full(
                    (B, n), cfg.negative_weight, dtype=cfg.dtype,
                    device=w.device)], 1)
        else:
            q = pulled[ITEM_TABLE][:, None, :]  # (B, 1, rank)
            items = batch["item"].to(torch.int32)[:, None]
            targets = r[:, None]
            wts = w[:, None]

        uidx = u // self.num_workers  # local row (ingest routes u % W == me)
        p = pull_local(user_factors, u, num_shards=self.num_workers)

        pred = torch.einsum("bd,bkd->bk", p, q)  # (B, 1+n)
        err = (targets - pred) * wts
        lr = cfg.learning_rate
        # Reference SGDUpdater: d_p = lr*(err*q - reg*p), d_q = lr*(err*p - reg*q).
        dp = lr * (torch.einsum("bk,bkd->bd", err, q)
                   - cfg.reg * w[:, None] * p)
        dq = lr * (err[:, :, None] * p[:, None, :]
                   - cfg.reg * wts[:, :, None] * q)

        user_factors = ops.scatter_add(user_factors, uidx,
                                       dp.to(cfg.dtype).contiguous())

        out = {
            # Train RMSE tracks the real ratings only (column 0).
            "se": torch.sum(err[:, 0] * err[:, 0]).to(torch.float32),
            "n": torch.sum(w).to(torch.float32),
        }
        # Padding rows push id -1 so the store drops them outright.
        push_ids = torch.where(wts > 0, items, -1)
        pushes = {ITEM_TABLE: (push_ids.reshape(-1),
                               dq.reshape(B * (1 + n), -1))}
        return StepOutput(pushes=pushes, local_state=user_factors, out=out)


def make_store(mesh, cfg: MFConfig) -> ParamStore:
    spec = TableSpec(
        name=ITEM_TABLE,
        num_ids=cfg.num_items,
        dim=cfg.rank,
        init_fn=ranged_uniform_init(cfg.init_min, cfg.init_max, cfg.rank,
                                    cfg.dtype),
        dtype=cfg.dtype,
        hot_ids=min(cfg.hot_items, cfg.num_items),
    )
    return ParamStore(mesh, [spec])


def online_mf(mesh, cfg: MFConfig, *, sync_every: int | None = None,
              push_delay: int = 0, donate: bool = True,
              max_steps_per_call: int | None = None,
              combine="sum", guard=None):
    """Construct (trainer, store) for online MF: the analog of
    ``PSOnlineMatrixFactorization.psOnlineMF(...)``.

    ``combine``: how duplicate item ids of one batch merge: ``"sum"`` (the
    reference's per-message fold) or ``"mean"`` (one averaged step per
    touched item per batch, stable at large batches). ``push_delay`` is
    ``TrainerConfig``'s (delayed pushes); ``guard`` its push-delta guard
    (``"mask"`` drops poison updates in the step, ``"observe"`` only
    counts them)."""
    from fps_tpu_torch.core.api import ServerLogic
    from fps_tpu_torch.core.driver import Trainer, TrainerConfig
    from fps_tpu_torch.parallel.mesh import num_workers_of

    store = make_store(mesh, cfg)
    worker = MatrixFactorizationWorker(cfg, num_workers_of(mesh))
    trainer = Trainer(
        mesh, store, worker,
        server_logic=ServerLogic(combine=combine),
        config=TrainerConfig(sync_every=sync_every, push_delay=push_delay,
                             donate=donate,
                             max_steps_per_call=max_steps_per_call,
                             guard=guard),
    )
    return trainer, store


def predict_host(store: ParamStore, user_factors_global, num_workers: int,
                 users: np.ndarray, items: np.ndarray) -> np.ndarray:
    """Host-side predictions from the live tables (for eval / RMSE)."""
    user_factors_global = _host(user_factors_global)
    rps = rows_per_shard_global(user_factors_global, num_workers)
    phys = (users % num_workers) * rps + users // num_workers
    p = np.asarray(user_factors_global)[phys]
    q = store.lookup_host(ITEM_TABLE, items)
    return np.sum(p * q, axis=-1)


def _host(x) -> np.ndarray:
    """The global array of a tensor, :class:`Blocks` (the trainer's local
    state) or host array, on the host."""
    if isinstance(x, Blocks):
        return x.numpy()
    if isinstance(x, Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def rows_per_shard_global(table, num_shards: int) -> int:
    return table.shape[0] // num_shards


def rmse(pred: np.ndarray, truth: np.ndarray) -> float:
    return float(np.sqrt(np.mean((pred - truth) ** 2)))
