"""word2vec skip-gram with negative sampling (SGNS) on the port.

Port of ``fps_tpu/models/word2vec.py``: two embedding tables (``IN`` for
centers, ``OUT`` for contexts and negatives), each pushed under the store's
per-id mean combine; negatives drawn by Vose's alias method over
``unigram^0.75``; frequent words subsampled (Mikolov et al. 2013).

* :class:`Word2VecWorker` trains ``(center, context, weight)`` pairs: one
  pull of the centers, one of the contexts and their negatives.
* :class:`Word2VecBlockWorker` trains a raw token block: one pull and one
  push of each block position's rows a table, the pairs assembled by slices
  of those rows, negatives shared by a position's instances.
* :class:`Word2VecDevicePlan` keeps the token stream on the device and
  builds each step's batch there (subsampling, compaction, half-windows),
  for ``Trainer.run_indexed``; :func:`skipgram_chunks` builds pair chunks
  in numpy for ``Trainer.fit_stream``.

Draws. The JAX package draws from ``jax.random`` keys folded with the step.
The port's workers are ``step_seeded``: each step's negatives, and the
plan's keep mask and half-windows, come from a stateless hash of a seed and
a counter (:func:`fps_tpu_torch.core.rng.counter_bits`), so the same seeds
give the same draws on the CPU and the card. They are not the JAX package's
bits; the parity tests hand both packages the same draws.

The co-occurrence sketch tap (:func:`cooccurrence_sketch_tap`, a
``TrainerConfig.step_tap``) sketches each probe word's context distribution
from the very batches the worker trains on, on both workers' batches; its
per-step stack update is one scatter-add (kernel K4 on the card). Not
ported here: the native pair generator, which waits for the port's bench
(ROADMAP.md Queue 1 item 1).
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import Iterator, Mapping

import numpy as np
import torch
import torch.nn.functional as F

from fps_tpu_torch.core.api import MEAN_COMBINE, StepOutput, WorkerLogic
from fps_tpu_torch.core.driver import Trainer, TrainerConfig
from fps_tpu_torch.core.rng import (
    counter_bits,
    fold_seed,
    randint_by_counter,
    uniform_by_counter,
)
from fps_tpu_torch.core.store import ParamStore, TableSpec, ranged_uniform_init
from fps_tpu_torch.parallel.mesh import PSMesh

Tensor = torch.Tensor

IN_TABLE = "in_embeddings"
OUT_TABLE = "out_embeddings"


def _keep_probs(cfg: W2VConfig, unigram_counts: np.ndarray) -> np.ndarray:
    """Per-token keep probability min(1, sqrt(t/f)) — word2vec's frequent-word
    subsampling; ones when ``cfg.subsample_t`` is None. Single source of
    truth for the host ingest and device-plan paths."""
    counts = np.asarray(unigram_counts, np.float64)
    freq = counts / max(1.0, counts.sum())
    if cfg.subsample_t is None:
        return np.ones_like(freq)
    return np.minimum(1.0, np.sqrt(cfg.subsample_t / np.maximum(freq, 1e-12)))


def _build_alias(p: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Vose alias tables for a discrete distribution ``p`` (sums to 1).

    Returns (prob, alias): draw ``j ~ U{0..V-1}``, ``u ~ U[0,1)``; the
    sample is ``j`` if ``u < prob[j]`` else ``alias[j]``.
    """
    V = len(p)
    prob = np.zeros(V)
    alias = np.zeros(V, np.int64)
    scaled = np.asarray(p, np.float64) * V
    small = [i for i in range(V) if scaled[i] < 1.0]
    large = [i for i in range(V) if scaled[i] >= 1.0]
    while small and large:
        s = small.pop()
        l = large.pop()
        prob[s] = scaled[s]
        alias[s] = l
        scaled[l] = scaled[l] - (1.0 - scaled[s])
        (small if scaled[l] < 1.0 else large).append(l)
    for i in large + small:
        prob[i] = 1.0
    return prob, alias


@dataclasses.dataclass
class W2VConfig:
    """The JAX package's ``W2VConfig``, with a torch ``dtype``.

    ``hot_words``: word ids ``[0, hot_words)`` are the write-hot head of
    both tables (loaders rank the vocabulary by frequency), whose pushes
    take the hot/cold split (K3 for the head); ``"auto"`` as
    ``TableSpec.hot_ids``. ``neg_group_size`` (block worker only): block
    positions share one set of K negatives a group of this many.
    """

    vocab_size: int
    dim: int = 100
    window: int = 5  # dynamic window: actual half-width ~ U{1..window}
    negatives: int = 5
    learning_rate: float = 0.025
    subsample_t: float | None = 1e-4  # None disables frequent-word subsampling
    neg_power: float = 0.75
    hot_words: int | str = 0
    neg_group_size: int = 1
    dtype: torch.dtype = torch.float32


class _AliasNegativeSampler:
    """Vose alias tables over ``unigram^neg_power``: a draw is ``j ~
    U{0..V-1}`` and ``u ~ U[0, 1)`` from the step's seed, then ``where(u <
    prob[j], j, alias[j])``: two gathers and a compare on the device."""

    step_seeded = True

    def _init_alias(self, cfg: W2VConfig, unigram_counts: np.ndarray):
        p = np.asarray(unigram_counts, np.float64) ** cfg.neg_power
        p /= p.sum()
        prob, alias = _build_alias(p)
        self._alias_host = (torch.from_numpy(prob.astype(np.float32)),
                            torch.from_numpy(alias.astype(np.int64)))
        self._alias_dev: dict[torch.device, tuple[Tensor, Tensor]] = {}

    def _alias_on(self, device: torch.device) -> tuple[Tensor, Tensor]:
        if device not in self._alias_dev:
            self._alias_dev[device] = tuple(t.to(device)
                                            for t in self._alias_host)
        return self._alias_dev[device]

    def _draw_negatives(self, seed: int, shape: tuple[int, ...],
                        device: torch.device) -> Tensor:
        """``shape`` int32 negatives from the step's ``seed``: the same
        draws on every device."""
        n = int(np.prod(shape))
        # One hash over 2n counters: even ones pick j, odd ones give u.
        bits = counter_bits(seed, torch.arange(2 * n, device=device)).view(
            n, 2)
        j = (bits[:, 0] * self.cfg.vocab_size) >> 32
        u = (bits[:, 1] >> 8).to(torch.float32) * (1.0 / (1 << 24))
        prob, alias = self._alias_on(device)
        return torch.where(u < prob[j], j, alias[j]).to(
            torch.int32).view(shape)


def _out_ids(batch) -> Tensor:
    """``(B, 1+K)``: each pair's context, then its negatives."""
    return torch.cat([batch["context"].to(torch.int32)[:, None],
                      batch["negatives"]], 1)


class Word2VecWorker(_AliasNegativeSampler, WorkerLogic):
    """SGNS worker. Batch columns: ``center (B,)``, ``context (B,)``,
    ``weight (B,)``. ``prepare`` adds ``negatives (B, K)``."""

    def __init__(self, cfg: W2VConfig, unigram_counts: np.ndarray):
        self.cfg = cfg
        self._init_alias(cfg, unigram_counts)

    def prepare(self, batch, seed: int):
        center = batch["center"]
        negs = self._draw_negatives(
            seed, (center.shape[0], self.cfg.negatives), center.device)
        return dict(batch, negatives=negs)

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        return {IN_TABLE: batch["center"].to(torch.int32),
                OUT_TABLE: _out_ids(batch).reshape(-1)}

    def step(self, batch, pulled, local_state, seed) -> StepOutput:
        cfg = self.cfg
        B = batch["center"].shape[0]
        K = cfg.negatives
        w = batch["weight"].to(cfg.dtype)  # (B,)
        v = pulled[IN_TABLE]  # (B, dim) center vectors
        u = pulled[OUT_TABLE].reshape(B, 1 + K, -1)  # ctx ++ negs

        # Slot 0 is the positive, the rest negatives.
        logits = torch.einsum("bd,bkd->bk", v, u)  # (B, 1+K)
        labels = torch.zeros((B, 1 + K), dtype=cfg.dtype, device=v.device)
        labels[:, 0] = 1.0
        # dL/dlogit for L = -log σ(x_pos) - Σ log σ(-x_neg):
        g = (torch.sigmoid(logits) - labels) * w[:, None]  # (B, 1+K)
        lr = cfg.learning_rate
        dv = -lr * torch.einsum("bk,bkd->bd", g, u)  # (B, dim)
        du = (-lr * g)[:, :, None] * v[:, None, :]  # (B, 1+K, dim)
        # SGNS loss (for monitoring): -logσ(pos) - Σ logσ(-neg).
        loss = -(F.logsigmoid(logits[:, 0])
                 + F.logsigmoid(-logits[:, 1:]).sum(1))

        live = w > 0
        center_ids = torch.where(live, batch["center"].to(torch.int32), -1)
        out_ids = torch.where(live[:, None], _out_ids(batch), -1)
        out = {"loss": (loss * w).sum().to(torch.float32),
               "n": w.sum().to(torch.float32)}
        pushes = {
            IN_TABLE: (center_ids, dv),
            OUT_TABLE: (out_ids.reshape(-1), du.reshape(B * (1 + K), -1)),
        }
        return StepOutput(pushes=pushes, local_state=local_state, out=out)


class Word2VecBlockWorker(_AliasNegativeSampler, WorkerLogic):
    """SGNS at token-block granularity: the rows of every block position
    are pulled once a table and pushed once, and the pairs are assembled
    from them by slices.

    For each offset ``d`` in ``1..window``, position ``i`` and ``i + d``
    form a pair in both orientations when ``half[i] >= d`` and ``i + d <
    valid_len``; their gradients accumulate by in-place adds on slices of
    two preallocated ``(L + W, dim)`` tensors. Negatives are drawn once a
    group of ``neg_group_size`` positions (``num_groups`` sets of K), and a
    position scores them once, weighted by its instance count. Each
    position's deltas are then divided by its instance count (and each
    negative's by its group's), so the store's per-id mean takes the pair
    worker's step sizes; rows with no instance push id ``-1``.

    Batch columns (from ``Word2VecDevicePlan(mode="block")``): ``block
    (L+W,)`` tokens, ``half (L,)`` half-windows, ``valid_len ()`` the count
    of in-stream positions. ``prepare`` adds ``negatives (num_groups, K)``.
    """

    def __init__(self, cfg: W2VConfig, unigram_counts: np.ndarray,
                 block_len: int):
        if cfg.neg_group_size <= 0:
            raise ValueError("neg_group_size must be positive in block mode")
        self.cfg = cfg
        self.block_len = block_len
        self.num_groups = -(-(block_len + cfg.window) // cfg.neg_group_size)
        self._init_alias(cfg, unigram_counts)

    def prepare(self, batch, seed: int):
        negs = self._draw_negatives(
            seed, (self.num_groups, self.cfg.negatives),
            batch["block"].device)
        return dict(batch, negatives=negs)

    def pull_ids(self, batch) -> Mapping[str, Tensor]:
        block = batch["block"].to(torch.int32)
        return {IN_TABLE: block,
                OUT_TABLE: torch.cat([block, batch["negatives"].reshape(-1)])}

    def step(self, batch, pulled, local_state, seed) -> StepOutput:
        cfg = self.cfg
        L, W, K, G = (self.block_len, cfg.window, cfg.negatives,
                      cfg.neg_group_size)
        LW = L + W
        lr = cfg.learning_rate
        half = batch["half"]  # (L,)
        vlen = batch["valid_len"]  # ()
        v = pulled[IN_TABLE]  # (LW, dim) center rows
        uo = pulled[OUT_TABLE][:LW]  # (LW, dim) context rows
        D = v.shape[1]
        negs_u = pulled[OUT_TABLE][LW:].reshape(self.num_groups, K, D)
        dev = v.device
        pos = torch.arange(L, device=dev)

        dv = torch.zeros_like(v)
        du = torch.zeros_like(uo)
        inst = torch.zeros((LW,), dtype=cfg.dtype, device=dev)
        # Per-position loss, summed once after the loop.
        loss_pos = torch.zeros((L,), dtype=torch.float32, device=dev)
        for d in range(1, W + 1):
            c, x = v[:L], v[d:L + d]
            uc, ux = uo[:L], uo[d:L + d]
            wk = ((half >= d) & (pos + d < vlen)).to(cfg.dtype)  # (L,)
            # Both orientations of each ordered adjacency (i, i+d), like the
            # pair path: centers i and i+d, contexts swapped.
            l1 = (c * ux).sum(-1)  # center=i, context=i+d
            l2 = (x * uc).sum(-1)  # center=i+d, context=i
            g1 = (torch.sigmoid(l1) - 1.0) * wk * -lr
            g2 = (torch.sigmoid(l2) - 1.0) * wk * -lr
            dv[:L].addcmul_(g1[:, None], ux)
            du[d:L + d].addcmul_(g1[:, None], c)
            dv[d:L + d].addcmul_(g2[:, None], uc)
            du[:L].addcmul_(g2[:, None], x)
            inst[:L] += wk
            inst[d:L + d] += wk
            loss_pos += (F.softplus(-l1) + F.softplus(-l2)) * wk
        # Each weighted adjacency adds one center instance at each end, so
        # the instance counts sum to the pair count (both orientations).
        npairs = inst.sum()

        # Group-shared negatives: every pair whose center sits in group g
        # scores the same K rows, so per (position, negative) the gradient
        # is the single-pair gradient times the position's instance count.
        pad = self.num_groups * G - LW
        vp = F.pad(v, (0, 0, 0, pad)).view(self.num_groups, G, D)
        instp = F.pad(inst, (0, pad)).view(self.num_groups, G)
        ln = torch.einsum("gid,gkd->gik", vp, negs_u)  # (NG, G, K)
        sn = torch.sigmoid(ln) * instp[:, :, None]
        dv_neg = -lr * torch.einsum("gik,gkd->gid", sn, negs_u)
        du_neg = -lr * torch.einsum("gik,gid->gkd", sn, vp)
        dv += dv_neg.view(-1, D)[:LW]
        loss = loss_pos.sum() + (F.softplus(ln) * instp[:, :, None]).sum()

        # Per-instance means (see the class docstring).
        ginst = instp.sum(1)  # (NG,) instances a group
        inv = 1.0 / torch.clamp(inst, min=1.0)
        dv *= inv[:, None]
        du *= inv[:, None]
        du_neg = du_neg / torch.clamp(ginst, min=1.0)[:, None, None]

        block = batch["block"].to(torch.int32)
        row_ids = torch.where(inst > 0, block, -1)
        neg_ids = torch.where(ginst[:, None] > 0, batch["negatives"],
                              -1).reshape(-1)
        out = {"loss": loss.to(torch.float32),
               "n": npairs.to(torch.float32)}
        pushes = {
            IN_TABLE: (row_ids, dv),
            OUT_TABLE: (torch.cat([row_ids, neg_ids]),
                        torch.cat([du, du_neg.reshape(-1, D)])),
        }
        return StepOutput(pushes=pushes, local_state=local_state, out=out)


def make_store(mesh: PSMesh, cfg: W2VConfig) -> ParamStore:
    """The IN table from ``ranged_uniform_init(-0.5/dim, 0.5/dim)``, the OUT
    table from zeros; both with ``hot_ids = hot_words``."""
    half = 0.5 / cfg.dim
    hot = cfg.hot_words
    if isinstance(hot, str):
        if hot != "auto":
            raise ValueError(
                f"hot_words={hot!r} — expected an int or the literal 'auto'")
    else:
        hot = min(hot, cfg.vocab_size)
    in_spec = TableSpec(
        name=IN_TABLE, num_ids=cfg.vocab_size, dim=cfg.dim,
        init_fn=ranged_uniform_init(-half, half, cfg.dim, cfg.dtype),
        dtype=cfg.dtype, hot_ids=hot)
    out_spec = TableSpec(
        name=OUT_TABLE, num_ids=cfg.vocab_size, dim=cfg.dim, dtype=cfg.dtype,
        hot_ids=hot).zeros_init()
    return ParamStore(mesh, [in_spec, out_spec])


def _make_trainer(mesh, cfg: W2VConfig, worker, *, sync_every, donate,
                  max_steps_per_call, push_delay=0, step_tap=None,
                  guard=None):
    if push_delay >= 16:
        # The JAX package's measured guardrail (docs/STALENESS.md, finding
        # #5): its staleness sweep held SGNS partner recovery at 0.675-0.700
        # through s = 64 stale reads at full lr, but delayed writes with the
        # lr-downscale recipe collapsed it (0.125 at s = d = 16, 0.050 at
        # s = d = 64; chance 0.017), by under-training, not divergence.
        downscaled = cfg.learning_rate < W2VConfig.learning_rate
        warnings.warn(
            f"word2vec with push_delay={push_delay}"
            + (f" and downscaled learning_rate={cfg.learning_rate} "
               f"(< default {W2VConfig.learning_rate})" if downscaled
               else "")
            + ": the measured staleness sweep (docs/STALENESS.md finding "
            "#5) collapsed SGNS quality in this regime (partner recovery "
            "0.70 -> 0.125 at delay 16 with the lr-downscale recipe). "
            "Prefer bounding READS (sync_every) at full lr and keeping "
            "push_delay small or zero.",
            UserWarning, stacklevel=3)
    # TrainerConfig raises on guard, naming the item that ports it; it is
    # built first so that nothing else is.
    config = TrainerConfig(sync_every=sync_every, donate=donate,
                           max_steps_per_call=max_steps_per_call,
                           push_delay=push_delay, step_tap=step_tap,
                           guard=guard)
    store = make_store(mesh, cfg)
    # Per-id mean combine: with Zipfian word frequencies a hot id appears
    # many times a batch; averaging gives each touched row one stable step.
    return Trainer(mesh, store, worker, server_logic=MEAN_COMBINE,
                   config=config), store


def word2vec(mesh: PSMesh, cfg: W2VConfig, unigram_counts: np.ndarray, *,
             sync_every: int | None = None, donate: bool = True,
             max_steps_per_call: int | None = None, push_delay: int = 0,
             step_tap=None, guard=None):
    """``(trainer, store)`` with the pair worker. ``sync_every`` selects SSP
    as in :func:`fps_tpu_torch.models.matrix_factorization.online_mf`;
    ``step_tap`` and ``push_delay`` are ``TrainerConfig``'s (e.g.
    :func:`cooccurrence_sketch_tap`; ``push_delay >= 16`` warns, as in the
    JAX package); ``guard`` raises ``NotImplementedError`` (not ported
    yet)."""
    return _make_trainer(
        mesh, cfg, Word2VecWorker(cfg, unigram_counts),
        sync_every=sync_every, donate=donate,
        max_steps_per_call=max_steps_per_call, push_delay=push_delay,
        step_tap=step_tap, guard=guard)


def word2vec_block(mesh: PSMesh, cfg: W2VConfig, unigram_counts: np.ndarray,
                   block_len: int, *, sync_every: int | None = None,
                   donate: bool = True,
                   max_steps_per_call: int | None = None,
                   push_delay: int = 0, step_tap=None, guard=None):
    """``(trainer, store)`` with the block worker; pair it with a
    ``Word2VecDevicePlan(..., block_len=block_len, mode="block")``."""
    return _make_trainer(
        mesh, cfg, Word2VecBlockWorker(cfg, unigram_counts, block_len),
        sync_every=sync_every, donate=donate,
        max_steps_per_call=max_steps_per_call, push_delay=push_delay,
        step_tap=step_tap, guard=guard)


# ---------------------------------------------------------------------------
# Host-side streaming skip-gram pair generation (the ingest source).
# ---------------------------------------------------------------------------

def skipgram_chunks(
    tokens: np.ndarray,
    unigram_counts: np.ndarray,
    cfg: W2VConfig,
    *,
    num_workers: int,
    local_batch: int,
    steps_per_chunk: int,
    sync_every: int | None = None,
    seed: int = 0,
    segment_tokens: int = 1 << 20,
    use_native: bool | None = None,
) -> Iterator[dict]:
    """Stream ``(center, context, weight)`` chunks over one pass of
    ``tokens``, segment by segment, with frequent-word subsampling and a
    dynamic window: the JAX package's numpy path, the same chunks for the
    same seed. ``use_native=True`` (its C++ pair generator) raises
    ``NotImplementedError``: the port has none yet."""
    if use_native:
        raise NotImplementedError(
            "skipgram_chunks(use_native=True): the native pair generator is "
            "not ported yet (ROADMAP.md Queue 1 item 1, the port bench)")
    rng = np.random.default_rng(seed)
    n = len(tokens)
    if n and int(np.max(tokens)) >= len(unigram_counts):
        raise ValueError(
            f"token id {int(np.max(tokens))} >= vocab "
            f"{len(unigram_counts)} (unigram_counts too small)")
    keep_p = _keep_probs(cfg, unigram_counts)

    B = num_workers * local_batch
    stride = steps_per_chunk * B
    if sync_every is not None and steps_per_chunk % sync_every:
        raise ValueError("steps_per_chunk must be a multiple of sync_every")

    buf_c: list[np.ndarray] = []
    buf_x: list[np.ndarray] = []
    buffered = 0

    def emit(c, x, wgt):
        chunk = {
            "center": c.reshape(steps_per_chunk, B),
            "context": x.reshape(steps_per_chunk, B),
            "weight": wgt.reshape(steps_per_chunk, B).astype(np.float32),
        }
        if sync_every is not None:
            chunk = {k: v.reshape(-1, sync_every, B)
                     for k, v in chunk.items()}
        return chunk

    # Segments are disjoint: cross-boundary pairs (at most window per
    # ~million-token segment) are dropped rather than double-counted.
    for start in range(0, n, segment_tokens):
        seg = tokens[start:start + segment_tokens]
        # Subsample frequent words (drop positions entirely, like word2vec).
        keep = rng.random(len(seg)) < keep_p[seg]
        seg = seg[keep]
        if len(seg) < 2:
            continue
        m = len(seg)
        half = rng.integers(1, cfg.window + 1, m)  # dynamic window
        for d in range(1, cfg.window + 1):
            ok = (half >= d)[:m - d]
            c = seg[:m - d][ok]
            x = seg[d:][ok]
            # Both directions: (center, context) and (context, center).
            buf_c.append(np.concatenate([c, x]))
            buf_x.append(np.concatenate([x, c]))
            buffered += 2 * len(c)

        while buffered >= stride:
            cs = np.concatenate(buf_c)
            xs = np.concatenate(buf_x)
            take_c, rest_c = cs[:stride], cs[stride:]
            take_x, rest_x = xs[:stride], xs[stride:]
            buf_c, buf_x = [rest_c], [rest_x]
            buffered = len(rest_c)
            yield emit(take_c, take_x, np.ones(stride))

    if buffered:
        cs = np.concatenate(buf_c)[:stride]
        xs = np.concatenate(buf_x)[:stride]
        pad = stride - len(cs)
        wgt = np.concatenate([np.ones(len(cs)), np.zeros(pad)])
        cs = np.concatenate([cs, np.zeros(pad, cs.dtype)])
        xs = np.concatenate([xs, np.zeros(pad, xs.dtype)])
        yield emit(cs, xs, wgt)


def nearest_neighbors(store: ParamStore, word_ids: np.ndarray, k: int = 5,
                      center: bool = True):
    """Host-side cosine nearest neighbours in the IN table.

    ``center=True`` removes the common mean vector first: SGNS embeddings
    share a large component, which dominates raw cosine.
    """
    ids = np.arange(store.specs[IN_TABLE].num_ids)
    emb = store.lookup_host(IN_TABLE, ids)
    if center:
        emb = emb - emb.mean(axis=0)
    emb = emb / np.maximum(np.linalg.norm(emb, axis=1, keepdims=True), 1e-9)
    q = emb[word_ids]
    sims = q @ emb.T
    order = np.argsort(-sims, axis=1)
    return order[:, 1:k + 1], np.take_along_axis(sims, order, 1)[:, 1:k + 1]


# ---------------------------------------------------------------------------
# Streaming co-occurrence similarity by tug-of-war sketches (a step_tap).
# ---------------------------------------------------------------------------

def _sketch_pair_stream(spec, probe: Tensor, center: Tensor, ctx: Tensor,
                        w: Tensor) -> Tensor:
    """Route each ``(center, context, weight)`` pair to its probe's row and
    add its tug-of-war contribution: one ``(B, P)`` compare and one
    scatter-add into the flattened ``(P, depth, width)`` stack."""
    from fps_tpu_torch.sketch import tow_update_rows

    stack = torch.zeros((int(probe.shape[0]), spec.depth, spec.width),
                        dtype=torch.float32, device=center.device)
    return tow_update_rows(spec, stack, _probe_rows(probe, center), ctx, w)


def _probe_rows(probe: Tensor, center: Tensor) -> Tensor:
    """Each pair's probe row: the index of its center in ``probe``, or -1."""
    eq = center[:, None] == probe[None, :]  # (B, P)
    return torch.where(eq.any(dim=1), torch.argmax(eq.to(torch.int32), dim=1),
                       -1)


def block_pair_stream(batch) -> tuple[Tensor, Tensor, Tensor]:
    """The exact ``(center, context, weight)`` pair stream of one block
    batch (``block (L+W,)``, ``half (L,)``, ``valid_len ()``), the pairs
    :class:`Word2VecBlockWorker` trains on: for each offset ``d`` in
    ``[1, W]`` and position ``i < L``, weight ``(half[i] >= d) & (i + d <
    valid_len)`` on both orientations of ``(i, i + d)``. ``W`` is
    ``len(block) - len(half)``. Ids only: ``2 * W * L`` of each."""
    block = batch["block"].to(torch.int32)
    half = batch["half"].to(torch.int32)
    vlen = batch["valid_len"].to(torch.int32)
    L = half.shape[0]
    W = block.shape[0] - L
    pos = torch.arange(L, dtype=torch.int32, device=block.device)
    centers, ctxs, ws = [], [], []
    for d in range(1, W + 1):
        wk = ((half >= d) & (pos + d < vlen)).to(torch.float32)
        lo, hi = block[:L], block[d:L + d]
        centers += [lo, hi]
        ctxs += [hi, lo]
        ws += [wk, wk]
    return torch.cat(centers), torch.cat(ctxs), torch.cat(ws)


def cooccurrence_sketch_tap(spec, probe_ids):
    """A ``step_tap`` emitting each step's tug-of-war sketch of each probe
    word's context frequencies: row ``p`` of a ``(P, depth, width)`` stack
    sketches ``{context: weight}`` of the step's pairs whose center is
    ``probe_ids[p]``. Sketches add, so the stream's sketch is the sum of the
    emitted stacks over steps and workers (:func:`accumulate_sketch_taps`);
    padding pairs carry weight 0.

    Reads both batch schemas: pair batches (``center`` / ``context`` /
    ``weight``) directly, block batches through :func:`block_pair_stream`.
    """
    probe_np = np.asarray(probe_ids, np.int32)
    probes: dict[torch.device, Tensor] = {}

    def tap(tables, batch, local_state, t):
        del tables, local_state, t
        if "block" in batch:
            center, ctx, w = block_pair_stream(batch)
        else:
            center = batch["center"].to(torch.int32)
            ctx = batch["context"].to(torch.int32)
            w = batch["weight"].to(torch.float32)
        probe = probes.get(center.device)
        if probe is None:
            probe = probes[center.device] = torch.from_numpy(probe_np).to(
                center.device)
        return _sketch_pair_stream(spec, probe, center, ctx, w)

    return tap


def accumulate_sketch_taps(metrics) -> np.ndarray:
    """Sum the ``tap`` entries of ``fit_stream`` / ``run_indexed`` metrics
    (leaves ``(steps, W, P, depth, width)``) into the stream's ``(P, depth,
    width)`` co-occurrence sketch stack, on the host."""
    total = None
    for m in metrics:
        tap = m["tap"]
        if isinstance(tap, Tensor):
            tap = tap.detach().cpu().numpy()
        part = np.asarray(tap).sum(axis=(0, 1))
        total = part if total is None else total + part
    if total is None:
        raise ValueError("no metrics chunks: nothing was trained")
    return total


def sketch_similarity(sketches: np.ndarray) -> np.ndarray:
    """``(P, P)`` unbiased co-occurrence inner-product estimates among the
    probe words (the median over rows of the tug-of-war estimator), on the
    host."""
    s = np.asarray(sketches)
    return np.median(np.einsum("pdw,qdw->pqd", s, s), axis=-1)


# ---------------------------------------------------------------------------
# Device-resident SGNS epochs: pair generation on the device.
# ---------------------------------------------------------------------------

class Word2VecDevicePlan:
    """Epoch plan that builds skip-gram batches on the device for
    ``Trainer.run_indexed``.

    The token stream is copied to the device once. Each epoch
    (:meth:`epoch_args`):

    1. **subsamples and compacts** the stream on the device: a uniform draw
       a token against ``keep_p[token]``, a ``cumsum`` of the kept mask,
       and a scatter of the kept tokens into ``buf_len + 1`` slots, the last
       of which takes any overflow and is cut off;
    2. each call's steps (:meth:`call_batches`) take blocks of ``block_len``
       compacted tokens (plus ``window`` of lookahead), draw a half-window
       in ``[1, window]`` a position, and emit either the raw ``(block,
       half, valid_len)`` columns (``mode="block"``, for
       :class:`Word2VecBlockWorker`) or the ``2 * window * block_len``
       candidate pairs with validity weights (``mode="pairs"``).

    The epoch is sized, as in the JAX package, from the expected kept count
    ``sum(keep_p[tokens])`` plus slack; kept tokens past the buffer are
    dropped. The keep mask is keyed by position in the stream and the
    half-windows by position in the compacted stream, each from its own
    fold of the epoch's seed (:func:`fps_tpu_torch.core.rng.counter_bits`),
    so both devices draw the same.
    """

    def __init__(self, dataset_tokens: np.ndarray, unigram_counts: np.ndarray,
                 cfg: W2VConfig, mesh: PSMesh, *, num_workers: int,
                 block_len: int = 8192, seed: int = 0,
                 sync_every: int | None = None, mode: str = "pairs"):
        if mode not in ("pairs", "block"):
            raise ValueError(f"unknown mode {mode!r}")
        self.cfg = cfg
        self.mode = mode
        self.num_workers = num_workers
        self.block_len = block_len
        self.local_batch = 2 * cfg.window * block_len  # pairs per step
        self.seed = seed
        self.sync_every = sync_every
        self.num_tokens = int(len(dataset_tokens))
        self.device = mesh.device

        tokens = np.asarray(dataset_tokens, np.int32)
        keep_p = _keep_probs(cfg, unigram_counts)
        self._tokens = torch.from_numpy(tokens).to(self.device)
        self._keep_p = torch.from_numpy(keep_p.astype(np.float32)).to(
            self.device)

        expected_kept = float(keep_p[tokens].sum())
        bound = int(expected_kept + 8.0 * np.sqrt(expected_kept + 1.0) + 1024)
        bound = min(bound, self.num_tokens)
        per_worker = -(-bound // (block_len * num_workers))
        steps = max(1, per_worker)
        if sync_every:
            steps = -(-steps // sync_every) * sync_every
        self.steps_per_epoch = steps
        # Compacted buffer: every block slice (+ window lookahead) in range.
        self._buf_len = steps * block_len * num_workers + cfg.window
        self._span = torch.arange(block_len + cfg.window, device=self.device)

    def epoch_args(self, epoch: int) -> dict:
        """The epoch's compacted stream (``buf_len`` tokens, zeros past the
        kept ones), its kept count (a 0-d device tensor, at most
        ``buf_len``) and the seed of its half-windows."""
        ekey = fold_seed(self.seed, epoch)
        buf_len = self._buf_len
        toks = self._tokens
        where = torch.arange(self.num_tokens, device=self.device)
        keep = (uniform_by_counter(fold_seed(ekey, 0), where)
                < self._keep_p[toks])
        dest = torch.cumsum(keep, 0) - 1
        kept = keep.sum()
        dest = torch.where(keep & (dest < buf_len), dest, buf_len)
        compacted = torch.zeros(buf_len + 1, dtype=torch.int32,
                                device=self.device)
        compacted.scatter_(0, dest, toks)
        return {"compacted": compacted[:buf_len],
                "kept": torch.clamp(kept, max=buf_len),
                "half_seed": fold_seed(ekey, 1)}

    def _halves(self, args: dict, base: Tensor) -> Tensor:
        """``base.shape + (block_len,)`` int32 half-windows in ``[1,
        window]`` for the blocks starting at compacted positions ``base``."""
        pos = base[..., None] + self._span[:self.block_len]
        return randint_by_counter(args["half_seed"], pos, 1,
                                  self.cfg.window + 1).to(torch.int32)

    def call_batches(self, args: dict, start: int,
                     steps: int) -> dict[str, Tensor]:
        """The batches of steps ``[start, start + steps)``, each column a
        tensor with a leading step axis, the ``W`` workers' columns side by
        side (``Trainer`` cuts them; :meth:`local_batch_at` takes one).
        Worker ``w``'s step ``t`` reads the block at compacted position
        ``(t * W + w) * L``, as in the JAX package. Block mode: ``block
        (steps, W * (L+W))``, ``half (steps, W * L)`` and ``valid_len``
        (``(steps,)`` for one worker, ``(steps, W)`` for several). Pairs
        mode: ``center``, ``context`` and ``weight``, each ``(steps, W * 2 *
        window * L)``, a worker's ``2 * window * L`` pairs being, for each
        ``d`` in ``1..window``, the centers ``i`` then ``i + d``, contexts
        swapped."""
        L, W = self.block_len, self.cfg.window
        nw = self.num_workers
        t = torch.arange(start, start + steps, device=self.device)
        w = torch.arange(nw, device=self.device)
        base = (t[:, None] * nw + w) * L  # (steps, nw)
        # Steps past the epoch read clamped slots at weight 0.
        idx = torch.clamp(base[..., None] + self._span, max=self._buf_len - 1)
        block = args["compacted"][idx]  # (steps, nw, L+W)
        half = self._halves(args, base)  # (steps, nw, L)
        if self.mode == "block":
            vlen = torch.clamp(args["kept"] - base, 0, L + W)
            return {"block": block.reshape(steps, -1),
                    "half": half.reshape(steps, -1),
                    "valid_len": vlen[:, 0] if nw == 1 else vlen}
        room = args["kept"] - base[..., None] - self._span[:L]  # kept - pos
        centers, contexts, valids = [], [], []
        for d in range(1, W + 1):
            c, x = block[..., :L], block[..., d:L + d]
            ok = (half >= d) & (room > d)
            centers += [c, x]
            contexts += [x, c]
            valids += [ok, ok]
        return {"center": torch.cat(centers, -1).reshape(steps, -1),
                "context": torch.cat(contexts, -1).reshape(steps, -1),
                "weight": torch.cat(valids, -1).to(torch.float32).reshape(
                    steps, -1)}

    def local_batch_at(self, args: dict, w: int, t: int) -> dict[str, Tensor]:
        """Worker ``w``'s step-``t`` batch (the JAX package's accessor)."""
        if not 0 <= w < self.num_workers:
            raise ValueError(f"worker {w} of a {self.num_workers}-worker "
                             "plan")
        return {k: v[0].reshape(self.num_workers, -1)[w].reshape(
                    () if k == "valid_len" else -1)
                for k, v in self.call_batches(args, t, 1).items()}
