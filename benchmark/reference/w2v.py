"""Plain reference of word2vec SGNS over the device epoch plan.

Written from the algorithm (Mikolov et al. 2013, word2vec.c's skip-gram
with negative sampling): each epoch keeps token ``i`` with probability
``min(1, sqrt(t / f))`` and compacts the kept stream; each step takes a
block of ``L`` kept tokens plus ``window`` of lookahead and draws a
half-window ``in [1, window]`` a position; a pair ``(i, i + d)`` is trained
in both orientations when ``d`` is within ``i``'s half-window and ``i + d``
is in the stream. Negatives come from ``unigram ** 0.75`` by Vose's alias
method. Both tables move by the mean of each touched row's deltas.

The pair form trains every pair against its own ``K`` negatives. The block
form scores a position's negatives once, shared by a group of positions,
weighted by the position's count of pairs (its instances), and divides each
position's deltas by that count, so a row's mean step is the pair form's.

The draws (keep mask, half-windows, negatives) are the counter hashes of
:mod:`benchmark.reference.rng` under the seeds the program documents.
Imports nothing of the program.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference import common
from benchmark.reference.rng import (
    counter_bits,
    fold_seed,
    randint_by_counter,
    uniform_by_counter,
)


def keep_probs(cfg, counts: np.ndarray) -> np.ndarray:
    """Per-word keep probability ``min(1, sqrt(t / f))`` (float64)."""
    counts = np.asarray(counts, np.float64)
    freq = counts / max(1.0, counts.sum())
    return np.minimum(1.0, np.sqrt(cfg["subsample_t"]
                                   / np.maximum(freq, 1e-12)))


def alias_table(cfg, counts: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose's alias tables ``(prob, alias)`` over ``counts ** power``."""
    p = np.asarray(counts, np.float64) ** cfg["neg_power"]
    p /= p.sum()
    V = len(p)
    prob = np.zeros(V)
    alias = np.zeros(V, np.int64)
    scaled = p * V
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = scaled[g] - (1.0 - scaled[s])
        (small if scaled[g] < 1.0 else large).append(g)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


class Corpus:
    """The reference's view of the token stream and its draws."""

    def __init__(self, data, cfg, cell, plan_seed: int):
        self.cfg, self.cell = cfg, cell
        self.tokens = data["tokens"]
        self.device = self.tokens.device
        counts = data["counts_host"]
        tokens_host = data["tokens_host"]
        kp = keep_probs(cfg, counts)
        self.keep_p = torch.from_numpy(kp.astype(np.float32)).to(self.device)
        prob, alias = alias_table(cfg, counts)
        self.prob = torch.from_numpy(prob.astype(np.float32)).to(self.device)
        self.alias = torch.from_numpy(alias).to(self.device)
        L, W = cell["block_len"], cfg["window"]
        n = len(tokens_host)
        expected = float(kp[tokens_host].sum())
        bound = min(int(expected + 8.0 * np.sqrt(expected + 1.0) + 1024), n)
        self.steps_per_epoch = max(1, -(-bound // L))
        self.buf_len = self.steps_per_epoch * L + W
        self.plan_seed = plan_seed
        self._epoch = None

    def epoch(self, e: int):
        """The kept stream of epoch ``e`` (``buf_len`` tokens), its count
        and the half-windows' seed."""
        if self._epoch is None or self._epoch[0] != e:
            key = fold_seed(self.plan_seed, e)
            n = self.tokens.shape[0]
            where = torch.arange(n, device=self.device)
            keep = (uniform_by_counter(fold_seed(key, 0), where)
                    < self.keep_p[self.tokens.to(torch.int64)])
            kept = self.tokens[keep][:self.buf_len]
            stream = torch.zeros(self.buf_len, dtype=torch.int64,
                                 device=self.device)
            stream[:len(kept)] = kept.to(torch.int64)
            self._epoch = (e, stream, len(kept), fold_seed(key, 1))
        return self._epoch[1:]

    def block(self, e: int, step: int) -> dict:
        """Step ``step``'s block: ``tokens (L + W)``, ``half (L)`` and the
        count of its positions in the stream."""
        stream, kept, half_seed = self.epoch(e)
        L, W = self.cell["block_len"], self.cfg["window"]
        base = step * L
        idx = torch.clamp(base + torch.arange(L + W, device=self.device),
                          max=self.buf_len - 1)
        half = randint_by_counter(
            half_seed, base + torch.arange(L, device=self.device), 1, W + 1)
        return {"tokens": stream[idx], "half": half,
                "valid_len": max(0, min(kept - base, L + W))}

    def negatives(self, step_seed: int, count: int) -> torch.Tensor:
        """``count`` negatives of a step, in draw order (int64)."""
        bits = counter_bits(step_seed, torch.arange(
            2 * count, device=self.device)).view(count, 2)
        j = (bits[:, 0] * self.prob.shape[0]) >> 32
        u = (bits[:, 1] >> 8).to(torch.float32) * (1.0 / (1 << 24))
        return torch.where(u < self.prob[j], j, self.alias[j])


def pairs(blk: dict, window: int) -> tuple[torch.Tensor, ...]:
    """The block's candidate pairs ``(center, context, live)``: for each
    ``d`` in ``1..window`` the centers ``i`` then ``i + d``."""
    toks, half, vlen = blk["tokens"], blk["half"], blk["valid_len"]
    L = half.shape[0]
    pos = torch.arange(L, device=toks.device)
    centers, contexts, live = [], [], []
    for d in range(1, window + 1):
        ok = (half >= d) & (pos + d < vlen)
        c, x = toks[:L], toks[d:L + d]
        centers += [c, x]
        contexts += [x, c]
        live += [ok, ok]
    return torch.cat(centers), torch.cat(contexts), torch.cat(live)


def pair_step(IN, OUT, blk, negs, cfg, precision: str,
              keep: torch.Tensor | None = None) -> tuple[float, float]:
    """One pair-form step in place; ``negs (P, K)``; ``keep`` masks pairs
    out. Returns the loss's sum and the count of live pairs."""
    dt = common.dtype_of(precision)
    center, context, live = pairs(blk, cfg["window"])
    if keep is not None:
        live = live & keep
    center, context, negs = center[live], context[live], negs[live]
    lr = cfg["learning_rate"]
    v = IN[center]
    out_ids = torch.cat([context[:, None], negs], 1)
    u = OUT[out_ids]
    logits = common.dots(v, u)
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    g = torch.sigmoid(logits) - labels
    dv = -lr * torch.bmm(g[:, None, :], u)[:, 0]
    du = (-lr * g)[:, :, None] * v[:, None, :]
    loss = -(F.logsigmoid(logits[:, 0].float())
             + F.logsigmoid(-logits[:, 1:].float()).sum(1))
    common.mean_fold(IN, center, dv.to(dt))
    common.mean_fold(OUT, out_ids.reshape(-1),
                     du.reshape(-1, IN.shape[1]).to(dt))
    return float(loss.sum()), float(live.sum())


def block_step(IN, OUT, blk, negs, cfg, cell, precision: str,
               keep: torch.Tensor | None = None) -> tuple[float, float]:
    """One block-form step in place; ``negs (groups, K)``; ``keep`` masks
    positions out as centers and contexts. Returns the loss's sum and the
    count of pair instances."""
    dt = common.dtype_of(precision)
    toks, half, vlen = blk["tokens"], blk["half"], blk["valid_len"]
    L, W, K = half.shape[0], cfg["window"], cfg["negatives"]
    G = cell.get("neg_group_size", 1)
    LW = L + W
    dev = toks.device
    lr = cfg["learning_rate"]
    pos = torch.arange(L, device=dev)
    # Every live adjacency (i, i + d), as index pairs into the block.
    left, right = [], []
    for d in range(1, W + 1):
        ok = (half >= d) & (pos + d < vlen)
        if keep is not None:
            ok = ok & keep[:L] & keep[d:L + d]
        left.append(pos[ok])
        right.append(pos[ok] + d)
    a, b = torch.cat(left), torch.cat(right)
    # Both orientations: centers a then b, contexts b then a.
    cen, ctx = torch.cat([a, b]), torch.cat([b, a])
    v, u = IN[toks], OUT[toks]
    inst = torch.zeros(LW, dtype=dt, device=dev).index_add_(
        0, cen, torch.ones_like(cen, dtype=dt))
    lp = common.dots(v[cen], u[ctx][:, None, :])[:, 0]
    gp = torch.sigmoid(lp) - 1.0
    dv = torch.zeros_like(v).index_add_(0, cen, -lr * gp[:, None] * u[ctx])
    du = torch.zeros_like(u).index_add_(0, ctx, -lr * gp[:, None] * v[cen])
    loss = float(F.softplus(-lp.float()).sum())
    # Negatives: position j scores its group's K rows once, weighted by its
    # instances.
    grp = torch.arange(LW, device=dev) // G
    nrows = negs[grp]  # (LW, K)
    un = OUT[nrows]  # (LW, K, D)
    ln = common.dots(v, un)  # (LW, K)
    sn = torch.sigmoid(ln) * inst[:, None]
    dv += -lr * torch.bmm(sn[:, None, :], un)[:, 0]
    loss += float((F.softplus(ln.float()) * inst[:, None].float()).sum())
    dneg = torch.zeros((negs.shape[0], K, v.shape[1]), dtype=dt,
                       device=dev).index_add_(
        0, grp, -lr * sn[:, :, None] * v[:, None, :])
    ginst = torch.zeros(negs.shape[0], dtype=dt, device=dev).index_add_(
        0, grp, inst)
    dv = dv / torch.clamp(inst, min=1.0)[:, None]
    du = du / torch.clamp(inst, min=1.0)[:, None]
    dneg = dneg / torch.clamp(ginst, min=1.0)[:, None, None]
    rows = torch.where(inst > 0, toks, -1)
    nids = torch.where(ginst[:, None] > 0, negs, -1).reshape(-1)
    common.mean_fold(IN, rows, dv)
    common.mean_fold(OUT, torch.cat([rows, nids]),
                     torch.cat([du, dneg.reshape(-1, v.shape[1])]))
    return loss, float(inst.sum())


def step(corpus: Corpus, IN, OUT, e: int, t: int, step_seed: int,
         precision: str, fault: str | None = None) -> tuple[float, float]:
    """Step ``t`` of epoch ``e`` in the cell's form; ``fault="half"``
    leaves out the second half of the step's batch."""
    cfg, cell = corpus.cfg, corpus.cell
    blk = corpus.block(e, t)
    K = cfg["negatives"]
    if cell["mode"] == "pairs":
        P = 2 * cfg["window"] * cell["block_len"]
        negs = corpus.negatives(step_seed, P * K).view(P, K)
        keep = None
        if fault == "half":
            keep = torch.arange(P, device=corpus.device) < P // 2
        return pair_step(IN, OUT, blk, negs, cfg, precision, keep)
    LW = cell["block_len"] + cfg["window"]
    groups = -(-LW // cell.get("neg_group_size", 1))
    negs = corpus.negatives(step_seed, groups * K).view(groups, K)
    keep = None
    if fault == "half":
        keep = torch.arange(LW, device=corpus.device) < LW // 2
    return block_step(IN, OUT, blk, negs, cfg, cell, precision, keep)


def follow(corpus: Corpus, weights0: dict, step_seeds: list[int],
           precision: str = "fp32", fault: str | None = None) -> dict:
    """The first ``len(step_seeds)`` steps of epoch 0 from ``weights0``:
    each step's loss a pair and each leaf after every step (float32)."""
    dt = common.dtype_of(precision)
    tables = {k: v.to(dt).clone() for k, v in weights0.items()}
    losses, states = [], []
    with common.matmul_precision(precision):
        for t, s in enumerate(step_seeds):
            loss, n = step(corpus, tables["in"], tables["out"], 0, t, s,
                           precision, fault)
            losses.append(loss / max(n, 1.0))
            states.append({k: v.float().clone() for k, v in tables.items()})
    return {"losses": losses, "states": states}


def work(corpus: Corpus, e: int, step_seeds: list[int]) -> dict:
    """The least work of steps ``[0, len(step_seeds))`` of epoch ``e``,
    summed: bytes of the pulls and pushes of both tables, and of each
    whole step (its raw block read, its unique rows of both tables read
    and written once), and its FLOPs (a dot product and two row updates
    for each pair and for each scored negative)."""
    cfg, cell = corpus.cfg, corpus.cell
    D, K, W = cfg["dim"], cfg["negatives"], cfg["window"]
    L = cell["block_len"]
    f = 4
    out = dict(pull_bytes=0, push_bytes=0, step_bytes=0, step_flops=0,
               steps=len(step_seeds))

    def moved(ids: torch.Tensor, rows: int) -> tuple[int, int]:
        n = int(ids.numel())
        # ids and values of a pull or a push, unique rows once.
        return n * f + n * D * f, rows * D * f

    for t, s in enumerate(step_seeds):
        blk = corpus.block(e, t)
        if cell["mode"] == "pairs":
            P = 2 * W * L
            center, context, live = pairs(blk, W)
            negs = corpus.negatives(s, P * K).view(P, K)[live]
            in_ids = center[live]
            out_ids = torch.cat([context[live][:, None], negs], 1)
            in_pull = in_push = in_ids
            out_pull = out_push = out_ids
            npairs = int(live.sum())
            flops = 6 * D * (1 + K) * npairs
        else:
            LW = L + W
            G = cell.get("neg_group_size", 1)
            groups = -(-LW // G)
            negs = corpus.negatives(s, groups * K).view(groups, K)
            toks, half, vlen = blk["tokens"], blk["half"], blk["valid_len"]
            pos = torch.arange(L, device=toks.device)
            inst = torch.zeros(LW, dtype=torch.int64, device=toks.device)
            for d in range(1, W + 1):
                ok = ((half >= d) & (pos + d < vlen)).to(torch.int64)
                inst[:L] += ok
                inst[d:L + d] += ok
            ginst = torch.zeros(groups, dtype=torch.int64,
                                device=toks.device).index_add_(
                0, torch.arange(LW, device=toks.device) // G, inst)
            in_pull = toks
            out_pull = torch.cat([toks, negs.reshape(-1)])
            in_push = toks[inst > 0]
            out_push = torch.cat([in_push, negs[ginst > 0].reshape(-1)])
            npairs = int(inst.sum())
            flops = 6 * D * npairs + 6 * D * K * int((inst > 0).sum())
        u_in = int(torch.unique(in_pull).numel())
        u_out = int(torch.unique(out_pull).numel())
        for ids, rows in ((in_pull, u_in), (out_pull, u_out)):
            io, r = moved(ids, rows)
            out["pull_bytes"] += io + r
        for ids in (in_push, out_push):
            io, r = moved(ids, int(torch.unique(ids).numel()))
            out["push_bytes"] += io + 2 * r
        out["step_bytes"] += (L + W) * f + 2 * (u_in + u_out) * D * f
        out["step_flops"] += flops
    return out
