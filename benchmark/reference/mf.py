"""Plain reference of online matrix factorization over an epoch plan.

What a step of the program should do, written from the algorithm and not
from the program: the epoch's interleaved order over the rating stream
(routed by user to the one worker), then for each step's ratings one SGD
step on the pulled user and item rows, the user rows summed, the item rows
moved by the mean of their deltas. Imports nothing of the program.
"""

from __future__ import annotations

import torch

from benchmark.reference import common
from benchmark.reference.rng import epoch_offset_rng

# The plan's shuffle: a randomized block transpose over a grid of at most
# 2**12 rows, offset per epoch by a host draw keyed with this tag.
_GRID_ROWS_LOG2_MAX = 12
_OFFSET_TAG = 0x0FF5E7


def interleave_grid(n: int) -> tuple[int, int]:
    """``(rows, columns)`` of one worker's interleave grid over ``n``."""
    r = 1 << max(0, min(_GRID_ROWS_LOG2_MAX, max(n, 1).bit_length() // 2))
    return r, max(-(-n // r), 1)


def steps_per_epoch(n: int, local_batch: int) -> int:
    r, _ = interleave_grid(n)
    return max(1, -(-(n + r) // local_batch))


def step_rows(n: int, local_batch: int, seed: int, epoch: int, step: int,
              device) -> tuple[torch.Tensor, torch.Tensor]:
    """``(rows, valid)`` of a step's batch, in batch order: the example each
    position reads and whether it is a real example (else weight 0)."""
    r, c = interleave_grid(n)
    m = r * c
    off = int(epoch_offset_rng(_OFFSET_TAG, seed, epoch).integers(
        0, max(n, 1))) % m
    pos = step * local_batch + torch.arange(local_batch, dtype=torch.int64,
                                            device=device)
    q = (pos % r) * c + pos // r + off
    q = torch.where(q >= m, q - m, q)
    valid = (pos < m) & (q < n)
    return torch.where(valid, q, 0), valid


def batch(data, cfg, cell, seed: int, epoch: int, step: int,
          fault: str | None = None) -> dict:
    """The step's real ratings (``user``, ``item``, ``rating``), in batch
    order; ``fault="half"`` leaves out the second half of the batch."""
    B = cell["local_batch"]
    rows, valid = step_rows(cfg["num_ratings"], B, seed, epoch, step,
                            data["user"].device)
    if fault == "half":
        valid = valid & (torch.arange(B, device=valid.device) < B // 2)
    rows = rows[valid]
    return {k: data[k][rows] for k in ("user", "item", "rating")}


def sgd_step(users: torch.Tensor, items: torch.Tensor, b: dict, cfg,
             precision: str) -> tuple[float, float]:
    """One step in place on the user and item tables; returns the squared
    error's sum and the count of ratings."""
    dt = common.dtype_of(precision)
    u = b["user"].to(torch.int64)
    i = b["item"].to(torch.int64)
    p, q = users[u], items[i]
    r = b["rating"].to(dt)
    lr, reg = cfg["learning_rate"], cfg["reg"]
    err = r - common.dots(p, q[:, None, :])[:, 0]
    dp = lr * (err[:, None] * q - reg * p)
    dq = lr * (err[:, None] * p - reg * q)
    common.sum_fold(users, u, dp)
    common.mean_fold(items, i, dq)
    return float((err.float() ** 2).sum()), float(len(u))


def follow(data, cfg, cell, weights0: dict, seed: int, steps: int,
           precision: str = "fp32", fault: str | None = None) -> dict:
    """The first ``steps`` steps of epoch 0 from ``weights0``: each step's
    loss (mean squared error) and each leaf after every step (float32)."""
    dt = common.dtype_of(precision)
    tables = {k: v.to(dt).clone() for k, v in weights0.items()}
    losses, states = [], []
    with common.matmul_precision(precision):
        for t in range(steps):
            b = batch(data, cfg, cell, seed, 0, t, fault)
            se, n = sgd_step(tables["user"], tables["item"], b, cfg,
                             precision)
            losses.append(se / max(n, 1.0))
            states.append({k: v.float().clone() for k, v in tables.items()})
    return {"losses": losses, "states": states}


def work(data, cfg, cell, seed: int, epoch: int, steps: int) -> dict:
    """The least work of steps ``[0, steps)`` of ``epoch``, summed: bytes
    of the item pulls and pushes, and of each whole step (its ratings read,
    its unique user and item rows read and written once), and its FLOPs
    (a prediction and two rank-wide updates a rating)."""
    D = cfg["rank"]
    f = 4  # float32 and int32
    out = dict(pull_bytes=0, push_bytes=0, step_bytes=0, step_flops=0,
               steps=steps)
    for t in range(steps):
        b = batch(data, cfg, cell, seed, epoch, t)
        n = len(b["item"])
        ui = int(torch.unique(b["item"]).numel())
        uu = int(torch.unique(b["user"]).numel())
        # Pull: ids read, unique rows read, pulled rows written.
        out["pull_bytes"] += n * f + ui * D * f + n * D * f
        # Push: ids and deltas read, unique rows read and written.
        out["push_bytes"] += n * f + n * D * f + 2 * ui * D * f
        out["step_bytes"] += 3 * n * f + 2 * (ui + uu) * D * f
        out["step_flops"] += 6 * D * n
    return out
