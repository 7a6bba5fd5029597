#!/usr/bin/env python3
"""Smoke test of the PyTorch port (``fps_tpu_torch``) on one NVIDIA GPU.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``fps_tpu_torch/ops/csrc`` and then,
on the card, raising on the first failure:

1. prints the torch and CUDA versions and the card's name and power limit;
2. builds the kernels and prints the build time;
3. holds each kernel against its plain PyTorch version at the shapes its
   paths give it, with -1 and >= R ids mixed in: the gathers (K1, K5) must
   be bit-equal (as int32 views), K5 at binary PA as the one call of the
   head-prefix route (the head view and the tail alone beside it, off the
   path), each timed beside ``index_select`` and ``Tensor.copy_`` of its
   output's size, and K1 at the 20-class PA pull also over a synchronised
   loop of 100 calls, a call of which its held time must cover; the
   scatter-adds (K2, K4) must lie within the float32
   summation bound of a float64 sum, equal the exact float64 sum bit for
   bit on inputs rounded to sixteenths, and give the same bits on two
   launches; K2's hand-written radix sort must equal ``torch.sort(keys,
   stable=True)`` bit for bit, in keys and positions, at every K2 shape and
   at its off-path edges (R = 1, R = 2^31 - 1, every id dropped, one id
   owning 2^20 ids, runs across its tile edges, a batch that is not a
   multiple of the tile). K1 / K2 at the MF step (ML-20M widths, B =
   32,768, Zipf(0.8) items and uniform users as ``synthetic_ratings``
   draws them), the 20-class PA step (47,236 x 20, 2^20 ids) and the
   AdaGrad logistic-regression step
   (1M x 2 pull, 1M x 3 push); K5 / K4 at the binary PA step (the head view
   47,236[:2,048] with the head-sorted prefix, then the tail) and the
   logistic-regression step (1M x 1, 13 + 16,384 x 26 ids), plus K4 at 2^20
   ids: the whole PA push, uniform ids, and one id owning every push. K3,
   the head scatter-add of the hot/cold split, the same way at the head
   shapes of its paths (H = 2,048: the MF item push's count-column
   scatter, the 20-class PA push, the AdaGrad push), with one id owning
   every push and on the whole-table route, rows past the head unchanged,
   timed beside the same slices unclustered; at the three path shapes the
   split as the store calls it (``ops.scatter_add_`` with ``hot_rows``)
   against K2 alone over the whole push; then the crossover sweep behind
   ``packed_crossover_rows``: K3 over the whole table against K2 with its
   sort, B = 32,768 Zipf(0.8) ids, D in {10, 32, 100, 200}, R from 512 to
   32,768. K1 / K2 at word2vec's text8 width (vocab 50,000, dim 100): the
   block path's pulls of 8,197 and 49,182 ids and its mean pushes' count-
   column scatters at D = 101, then, off the main path, the pairs path's
   81,920 and 491,520 ids, each from the paths' own first step (Zipf ids
   of the corpus, the worker's negatives). K1 / K2 at iALS's step as
   ``bench.py run_ials`` makes it (32,768 users, 16,384 Zipf-skewed items,
   rank 16, B = 65,536, the path's first step): the fixed side's pulls at
   D = 16 in both halves and the ``A`` (D = 256) and ``b`` (D = 16) pushes
   keyed by users and by items. K4 at the word2vec sketch tap's stack (16
   probes x 5 x 1,024 = 81,920 rows, two row tiles, the 409,600 items of
   the block path's first step). K4's bucket pass by row tile,
   where its plan has one (the 1M-row logistic-regression table), must
   equal its plain version (a stable sort by bucket) bit for bit. Times
   are CUDA-event medians of 30 (the crossover sweep: 10) with the card held busy, beside the bound (least bytes /
   3.35 TB/s), the library call's time and, for K2 and K4, their sort's
   time (K2: its radix sort; K4: its bucket pass, none where the table is
   one tile; ``torch.sort``'s beside both);
4. drives each path at full width, every launch counter at 0 just before it
   and read just after: online MF at ML-20M size (2 epochs sync, 2 SSP);
   binary PA-I at the RCV1 shape with the head prefix (K5 once and K4
   twice a step, no K1 / K2); 20-class PA-I (K1 / K2 only); SSP logistic
   regression at the Criteo shape with SGD and the dense head (K5 and K4
   once a step),
   then a smaller AdaGrad run (K1 / K2 only). Then the hot/cold split
   through device-resident ingest and ``run_indexed``: MF at ML-20M size
   with ``hot_items = 2048`` (2 epochs sync, 2 SSP; K1 2, K2 2 and K3 1 a
   step), 20-class PA-I and AdaGrad logistic regression with
   ``hot_features = 2048`` (K1, K2 and K3 once a step each), and one traced
   run_indexed epoch of the MF configuration for the device's busy share.
   Before them, word2vec SGNS as ``bench.py run_w2v`` trains it, on a 2M-
   token text8-size corpus: the block worker through
   ``Word2VecDevicePlan`` and ``run_indexed``, 2 epochs sync, then 1 SSP
   epoch (s = 4), K1 2 and K2 2 a step, words/s and steady ms a step; the
   pair worker, two ``run_chunk`` calls of 8 steps (81,920 pairs a step),
   K1 2 and K2 2 a step; after them, one traced w2v epoch for its busy
   share. Then the w2v block worker with ``cooccurrence_sketch_tap`` of the
   16 most frequent words, one ``run_indexed`` call of an epoch (K1 2, K2 2,
   K4 1 a step; the similarity matrix finite with a positive diagonal);
   iALS as ``bench.py run_ials`` trains it, a warm-up epoch on throwaway
   state and then epochs until recall@20 on the first 2,000 held-out pairs
   reaches 0.35, at most 8 (K1 1, K2 2 a step; the recall curve, seconds an
   epoch, interactions/s, time to the target, the parts of a half-epoch
   timed apart and one traced epoch); and MF at ML-20M width with the
   online top-k tap (k 10, every 4th step, one call of 17 steps; K1 3 and
   K2 2 a step), whose ids on every tapped step must equal a float64
   brute-force ranking of that step's live item table. Each must learn:
   MF's train RMSE falls; over the last chunk PA's mistake rate lies below
   0.5 (20 classes: 0.95) and the logistic log loss below 0.693; word2vec's
   last real step's loss a pair lies below its first and below (1 + K) log
   2 = 4.159;
5. runs small MF, head-prefix PA and SSP logistic-regression jobs, and
   run_indexed jobs of MF with ``hot_items``, 20-class PA with
   ``hot_features`` and word2vec (block sync, pairs SSP), on the card and
   on the CPU from the same tables and seeds, and compares the tables
   (within 1e-5 of their largest value); a small iALS job (factors within
   1e-4 of the largest value) and the w2v block worker with the sketch tap
   (tap sums bit for bit); then traces 10 K2 calls at each of its path shapes
   (``torch.profiler``) for the device time and launches of each kernel K2
   launches, which must be 3 a sort pass plus 2, 10 calls of the sort
   alone at each sort edge, 3 kernels a pass, 10 K3 calls at each K3
   shape, its slice pass once a call and its fold pass once more where the
   plan has more than one cluster, 10 K4 calls at each K4 shape, whose
   kernels a call (the bucket pass's count and scatter where the plan has
   buckets, the tile pass, the fold where it has more than one cluster)
   must be what ``dim1_plan`` counts, and 10 K1 and K5 calls at each of
   their path shapes, one kernel a call;
6. drives the host pipeline and delayed pushes at full width, every launch
   counter at 0 just before each run and read just after: the prefetch A/B
   of ``bench.py host_pipeline_ab`` (the same chunk stream, an ``islice``
   of ``epoch_chunks`` assembled in the stream, through ``fit_stream`` at
   prefetch 0, 2, 2, 0 from fresh state: MF as ``run_mf``'s host arm, B
   32,768, 12 chunks of 8 steps; SSP logistic regression as
   ``run_logreg``'s, B 4,096, rounds of 8; iALS at ``run_ials`` width with
   ``IALSSolver.prefetch`` over 2 epochs of host chunks), whose tables,
   local state, metrics (iALS: factors and recall@20) and launch counts
   must be equal across the arms, with no prefetch thread left after any
   arm; each arm's wall, time to its first chunk, steady ms a step (CUDA
   events at each chunk's start), the driver thread's host-serial seconds
   (assembly and placement, or the queue wait) and the worker's seconds
   (through the prefetcher's duck-typed timer), the overlap ratio and the
   speedup; then ``push_delay`` 1 and 4 against 0 with a pusher independent
   of its pulls into a 26,744 x 10 table (K1, K2) and the 1M x 1 table (K5,
   K4), which must end equal to delay 0 within the float32 summation bound
   (bit-equal reported) with the same launches; MF at ML-20M size with
   ``push_delay = 4`` at lr 0.05, sync and SSP (s = 4), 2 epochs, timed
   beside the same job at ``push_delay = 0`` in turns 0, 4, 4, 0, whose
   RMSE must fall with K1 2 and K2 2 a step and equal launches at 0 and
   4; and a small MF job with
   ``push_delay = 2`` and ``prefetch = 2``, card against CPU within 1e-5
   of the largest value. It runs after phase 5;
7. drives the sharded mesh on the one card, every launch counter at 0
   just before each run and read just after: MF at ML-20M width (the data
   of ``load_movielens(None, "20m")``, phase 4's rank, its global batch of
   32,768 split over the workers) through ``run_indexed``, one epoch sync
   and one SSP (s = 4), on a (1, 1), a (1, 4) and a (2, 2) mesh whose
   positions are all ``cuda:0``, whose RMSE must fall with K1 2 and K2 2
   a position a step and whose data replicas must be bit-equal; binary
   PA-I at (1, 4), K5 and K4 once a position a step, mistakes below 0.5;
   the word2vec block worker at phase 4's width on its corpus, a block of
   8,192 tokens a worker a step, through ``Word2VecDevicePlan(num_workers=
   W)`` and ``run_indexed``: one sync epoch at (1, 4) after two warm-up
   epochs, then one SSP epoch (s = 4) at (2, 2) from where it ended, K1 2
   and K2 2 a position a step, the loss falling as phase 4's and the (2, 2)
   replicas bit-equal; iALS at phase 4's width at (1, 4), phase 4's chunks
   cut over the workers, epochs until recall@20 reaches 0.35 (at most 8),
   K1 1 and K2 2 a position a half-step; MF with the online top-k tap at
   (1, 4) (phase 4's settings, the batch split over the workers, K1 3 and
   K2 2 a position a step), every worker's ids on every tapped step equal
   to a float64 brute force of that step's live table in the merge's pool
   order; ``recommend_topk`` of 64 users over the resulting 4 shards of
   the ML-20M item table, ids equal to the brute force;
   the dense against the gathered push of one MF item push at 4 shards,
   within the float32 summation bound; small MF, word2vec (with the sketch
   tap), iALS and top-k jobs on both meshes, card against CPU (MF and
   word2vec tables within 1e-5 of the largest value, iALS factors within
   1e-4, sketch sums and top-k ids and scores equal). It prints each run's
   ms a step and launches a step. The positions share one card, so these
   times measure the single controller's launches, not scaling;
8. prints one JSON line describing every ported kernel, then, as the last
   line, ``{"ok": true, "device": {...}}``.

It imports neither jax nor the JAX package. Without CUDA it exits non-zero
and prints no result.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory rate (NVIDIA data sheet)
EPS32 = float(np.finfo(np.float32).eps)
# About 1 ms of the card's clock: longer than the host takes to enqueue any
# one call timed here, so that call's kernels queue up behind the hold.
HOLD_CYCLES = 2_000_000
# About 10 ms: longer than the host takes to enqueue 100 gather calls.
LOOP_HOLD_CYCLES = 20_000_000

ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS = 138_493, 26_744, 20_000_263
RANK = 10
BATCH = 32_768

# The JAX package's bench settings (bench.py run_pa / run_logreg); only the
# number of examples and epochs is cut.
PA_NF, PA_NNZ, PA_NEX, PA_HEAD = 47_236, 64, 800_000, 2048
PA_MC_NEX, PA_MC_CLASSES = 200_000, 20
LR_NF, LR_NNZ, LR_DENSE, LR_NEX = 1_000_000, 39, 13, 1_000_000
LR_ADAGRAD_NEX = 262_144
SPARSE_BATCH = 16_384
HOT = 2048  # the write-hot head of the split paths (bench.py's head size)
# The sharded mesh's (data, shard) shapes, every position on the one card.
MESH_SHAPES = ((1, 4), (2, 2))

# word2vec as bench.py run_w2v trains it (text8 width: vocab 50,000, dim
# 100, window 5, 5 negatives, lr 0.025, subsample 1e-4, blocks of 8,192
# tokens, mean combine on both tables); only the corpus is cut, from the
# bench's 17M tokens to 2M.
W2V_VOCAB, W2V_DIM, W2V_TOKENS, W2V_BLOCK = 50_000, 100, 2_000_000, 8192
W2V_PAIR_STEPS = 8  # the pairs-mode call
# The w2v example's --sketch-words: a tug-of-war sketch (depth 5, width
# 1,024) of the 16 most frequent words' contexts, a stack of 81,920 rows.
SKETCH_PROBES, SKETCH_DEPTH, SKETCH_WIDTH = 16, 5, 1024

# iALS as bench.py run_ials trains it (synthetic_implicit with a rank-8
# planted model, rank 16, alpha 40, reg 0.1, local batch 65,536 in chunks of
# 4 steps; recall@20 on the first 2,000 held-out pairs to 0.35, at most 8
# epochs); nothing is cut.
IALS_USERS, IALS_ITEMS, IALS_PER_USER = 32_768, 16_384, 64
IALS_RANK, IALS_BATCH, IALS_STEPS = 16, 65_536, 4
IALS_TARGET, IALS_MAX_EPOCHS, IALS_EVAL = 0.35, 8, 2000

# MF with the online top-k tap: k 10 for the first 2 users of every 4th
# step, one run_chunk call of 17 steps (the last one tapped).
TOPK_K, TOPK_EVERY, TOPK_QUERIES, TOPK_STEPS = 10, 4, 2, 17

# The margin each traced window keeps at its edges (profiled): host seconds
# after it opens and before it closes, and the cycles of a spin kernel
# (about 1 ms on an H100) ahead of the traced calls.
PROFILE_PAD_S, PROFILE_SPIN_CYCLES = 0.01, 2_000_000

# The host pipeline's A/B as bench.py host_pipeline_ab runs it: 12 chunks
# of 8 steps (an SSP round of 8 a chunk for logistic regression), prefetch
# depth 2 against 0, in turns: off, on, on, off.
AB_CHUNKS, AB_STEPS, AB_ORDER = 12, 8, (0, 2, 2, 0)
# MF with push_delay 4 is timed beside push_delay 0 in the same turns.
AB_ORDER_DELAY = (0, 4, 4, 0)


def log(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def mix_dropped(ids: np.ndarray, num_rows: int) -> np.ndarray:
    """Some -1 padding and some out-of-range ids, as a push carries them."""
    ids = np.array(ids, dtype=np.int32)
    ids[::97] = -1
    ids[13::101] = num_rows + (np.arange(len(ids[13::101])) % 7)
    return ids


def path_ids(rng, num_rows: int, batch: int, zipf: bool) -> np.ndarray:
    """Ids over ``num_rows`` as ``synthetic_ratings`` draws them: Zipf(0.8)
    for items, uniform for users; with some -1 padding and some
    out-of-range ids mixed in."""
    if zipf:
        pop = 1.0 / np.arange(1, num_rows + 1) ** 0.8
        ids = rng.choice(num_rows, batch, p=pop / pop.sum())
    else:
        ids = rng.integers(0, num_rows, batch)
    return mix_dropped(ids, num_rows)


def time_ms(torch, fn, *, setup=None, hold: bool = True, reps: int = 30,
            warmup: int = 5):
    """Median milliseconds of ``fn(setup())`` over ``reps`` runs, each
    between its own pair of CUDA events, after ``warmup`` runs.

    ``hold=True`` times the device's work: before each run the card is kept
    busy (``torch.cuda._sleep``) while the host enqueues the start event,
    ``fn`` and the end event, so the host's launch overhead falls outside
    the events (a function that synchronises inside, as the plain
    scatter-add's boolean mask does, still pays for its wait).
    ``hold=False`` times one call on an idle card, host overhead included:
    what the training loop pays per call when the host is the bottleneck.
    """
    times = []
    for i in range(warmup + reps):
        arg = setup() if setup is not None else None
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if hold:
            torch.cuda._sleep(HOLD_CYCLES)
        start.record()
        fn(arg)
        end.record()
        if i >= warmup:
            times.append((start, end))
        if not hold:
            torch.cuda.synchronize()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in times]))


def check_gather(torch, kernels, label, kernel, plain, table, ids, path, *,
                 head=None, loop=False, collect=None):
    """Hold a gather kernel against its plain version (bit-equal, as int32
    views: -0.0 and +0.0 differ) and time it, its plain version,
    ``index_select`` (with the head-prefix route, ``head = (H, q)``: of the
    head view and the rest, and their concatenation) and ``Tensor.copy_``
    of an output of the same size (the card's rate for writing it; a
    yardstick only), and record the kernel's plan. ``loop`` also times a
    synchronised loop of 100 calls, the card held while the host enqueues
    them, whose time a call the held time must cover (programmatic
    dependent launch must not let the end event pass the kernel).
    ``collect`` (a list) gathers the call for :func:`gather_breakdown`."""
    num_rows, dim = table.shape
    B = ids.shape[0]
    kw = {} if head is None else {"head_rows": head[0],
                                  "head_prefix": head[1]}

    def call(_=None):
        return kernel(table, ids, **kw)

    got = call()
    want = plain(table, ids, **kw)
    torch.cuda.synchronize()
    if not torch.equal(got.view(torch.int32), want.view(torch.int32)):
        raise AssertionError(f"{label}: kernel differs from plain version")
    bound = torch.full_like(ids, num_rows)
    if head is not None:
        bound[:head[1]] = min(head[0], num_rows)
    valid = (ids >= 0) & (ids < bound)
    safe = torch.where(valid, ids, 0)
    uniq = int(torch.unique(ids[valid]).numel())
    if head is None:
        def library(_):
            return table.index_select(0, safe)
    else:
        q = head[1]

        def library(_):
            return torch.cat([table[:head[0]].index_select(0, safe[:q]),
                              table.index_select(0, safe[q:])])
    src = torch.zeros((B, dim), device=table.device)
    dst = torch.empty_like(src)
    # Least bytes: the ids read, each distinct touched row read once, the
    # output written.
    nbytes = B * 4 + uniq * dim * 4 + B * dim * 4
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "head": head, "unique_rows": uniq,
        "max_abs_err": float((got - want).abs().max()) if B else 0.0,
        "ms": time_ms(torch, call),
        "call_ms": time_ms(torch, call, hold=False),
        "plain_ms": time_ms(torch, lambda _: plain(table, ids, **kw)),
        "library_ms": time_ms(torch, library),
        "copy_ms": time_ms(torch, lambda _: dst.copy_(src)),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    case["plan"] = kernels.card_plan_for(table, ids)._asdict()
    if loop:
        call()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        # Held too, for as long as the host takes to enqueue the 100 calls,
        # so that the loop times the card's work and not the host's.
        torch.cuda._sleep(LOOP_HOLD_CYCLES)
        start.record()
        for _ in range(100):
            call()
        end.record()
        torch.cuda.synchronize()
        case["loop_ms"] = start.elapsed_time(end) / 100
        if not case["ms"] >= 0.9 * case["loop_ms"]:
            raise AssertionError(
                f"{label}: held time {case['ms']} ms does not cover a call "
                f"of a synchronised loop of 100 ({case['loop_ms']} ms)")
    log(f"{label}: bit-equal to plain; " + json.dumps(case))
    if collect is not None:
        collect.append((label, call))
    return case


def gather_breakdown(torch, inputs):
    """Traced, at each K1 and K5 shape of the paths: the device µs and
    launches a call of each kernel, which must be the gather's one kernel
    (``gather_rows_kernel``, ``gather_dim1_kernel``). Run last, after every
    timed phase."""
    out = {}
    for label, call in inputs:
        us, launched = profiled(torch, call)
        want = "gather_dim1_kernel" if label.startswith("K5") else (
            "gather_rows_kernel")
        if launched != {want: 1}:
            raise AssertionError(f"{label}: traced launches a call "
                                 f"{launched}, expected {{{want!r}: 1}}")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": 1}
        log(f"gather breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def check_sum_bound(torch, label, table, kid, kd, got, want):
    """Hold a scatter-add's kernel result ``got`` and plain result ``want``
    against the float64 sum of ``table`` and the pushes ``kd`` to rows
    ``kid``; return that sum and each row's push count."""
    ref = table.double().index_add_(0, kid, kd.double())
    # Tolerance: a float32 sum of k terms in any order lies within
    # k * eps32 * (sum of the terms' magnitudes) of the exact sum; k is the
    # row's push count plus one (the table value).
    mag = table.double().abs().index_add_(0, kid, kd.double().abs())
    count = torch.zeros(table.shape[0], dtype=torch.float64,
                        device=table.device)
    count.index_add_(0, kid, torch.ones_like(kid, dtype=torch.float64))
    tol = (count + 1)[:, None] * EPS32 * mag
    for which, val in (("kernel", got), ("plain", want)):
        excess = float((((val.double() - ref).abs()) - tol).max())
        if excess > 0:
            raise AssertionError(
                f"{label}: {which} outside the float32 bound of the float64 "
                f"sum by {excess}")
    return ref, count


def check_scatter(torch, label, kernel, plain, table, ids, deltas, path,
                  kernels=None, collect=None, sort_fn=None):
    """Hold a scatter-add kernel against its plain version and a float64 sum
    (within the float32 summation bound; the same bits on two launches), and
    on sixteenths of the same inputs against the exact float64 sum, bit for
    bit; time it, its sort, its plain version, ``index_add_`` and
    ``torch.sort``. With ``kernels`` (K2) the sort is K2's hand-written
    radix sort, first held bit for bit to ``torch.sort(keys, stable=True)``;
    without (K4), ``sort_fn`` (its bucket pass), or no sort where it is
    None. ``collect`` (a list) gathers the inputs for :func:`k2_breakdown`
    and :func:`k4_breakdown`."""
    num_rows, dim = table.shape
    B = ids.shape[0]
    got = kernel(table.clone(), ids, deltas)
    again = kernel(table.clone(), ids, deltas)
    want = plain(table.clone(), ids, deltas)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches gave different bits")
    keep = (ids >= 0) & (ids < num_rows)
    kid, kd = ids[keep], deltas[keep]
    ref, count = check_sum_bound(torch, label, table, kid, kd, got, want)
    et, ed = sixteenths(torch, table), sixteenths(torch, deltas)
    exact = et.double().index_add_(0, kid, ed[keep].double())
    for which, fn in (("kernel", kernel), ("plain", plain)):
        if not torch.equal(fn(et.clone(), ids, ed).double(), exact):
            raise AssertionError(
                f"{label}: {which} differs from the exact sum of sixteenths")
    if kernels is not None:
        check_sort(torch, kernels, label, ids, num_rows)
        sort_fn = (lambda _: kernels.radix_sort_cuda(ids, num_rows))
    uniq = int(torch.unique(kid).numel())
    # Least bytes: the ids, the deltas of in-range ids read, and each
    # touched row read and written once.
    nbytes = B * 4 + kid.numel() * dim * 4 + 2 * uniq * dim * 4
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "unique_rows": uniq, "max_run": int(count.max()),
        "max_abs_err": float((got - want).abs().max()),
        "max_err_vs_f64": float((got.double() - ref).abs().max()),
        "ms": time_ms(torch, lambda t: kernel(t, ids, deltas),
                      setup=table.clone),
        "call_ms": time_ms(torch, lambda t: kernel(t, ids, deltas),
                           setup=table.clone, hold=False),
        # The sort alone, a part of "ms"; torch.sort's time beside it.
        "sort_ms": time_ms(torch, sort_fn) if sort_fn is not None else None,
        "torch_sort_ms": time_ms(torch,
                                 lambda _: torch.sort(ids, stable=True)),
        "plain_ms": time_ms(torch, lambda t: plain(t, ids, deltas),
                            setup=table.clone),
        "library_ms": time_ms(torch, lambda t: t.index_add_(0, kid, kd),
                              setup=table.clone),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    log(f"{label}: deterministic, within the float32 bound and exact on "
        "sixteenths (kernel and plain); " + json.dumps(case))
    if collect is not None:
        collect.append((label, table, ids, deltas))
    return case


def profiled(torch, fn, calls=10):
    """Device µs and launches a call of each kernel of K2 and its sort
    (``radix_*``, ``rows_*``), of K3 (``packed_*``), of K4 (``dim1_*``) and
    of K1 and K5 (``gather_*``) over ``calls`` calls
    of ``fn``, from ``torch.profiler``: ``({name: µs}, {name:
    launches})``."""
    from torch.profiler import ProfilerActivity, profile, schedule

    fn()
    torch.cuda.synchronize()
    # A warm-up window of ``calls`` calls first, its events discarded: the
    # tracer can miss the kernels that run just after it starts, which
    # would read as a call that launched fewer. Each window also keeps its
    # traced kernels clear of its edges: the host waits PROFILE_PAD_S after
    # the window opens, a spin kernel (not traced by name) runs first on the
    # card, and the host waits again after the card is done, before the
    # window closes.
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1,
                                   repeat=1)) as prof:
        for _ in range(2):
            time.sleep(PROFILE_PAD_S)
            torch.cuda._sleep(PROFILE_SPIN_CYCLES)
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
            prof.step()
    us, count = {}, {}
    for ev in prof.key_averages():
        name = re.search(r"\b(radix_\w+|rows_\w+|packed_\w+|dim1_\w+|"
                         r"gather_\w+)", ev.key)
        if not name:
            continue
        us[name[1]] = us.get(name[1], 0.0) + (
            getattr(ev, "device_time_total", 0)
            or getattr(ev, "cuda_time_total", 0)) / calls
        count[name[1]] = count.get(name[1], 0) + ev.count
    if any(n % calls for n in count.values()):
        raise AssertionError(f"kernel launches {count} over {calls} calls "
                             "are not the same each call")
    return us, {k: n // calls for k, n in count.items()}


def traced_launches(torch, kernels, num_rows, fn, plus, label):
    """The kernels ``fn`` launches a call, traced: the sort's passes are
    its count kernel's launches; there must be as many as
    ``radix_sort_passes(num_rows)`` and 3 kernels a pass plus ``plus``."""
    us, launched = profiled(torch, fn)
    passes = launched.get("radix_count", 0)
    total = sum(launched.values())
    if (passes != kernels.radix_sort_passes(num_rows)
            or total != 3 * passes + plus):
        raise AssertionError(
            f"{label}: traced launches a call {launched}, expected "
            f"{kernels.radix_sort_passes(num_rows)} passes of 3 kernels "
            f"plus {plus}")
    return {"device_us": us, "launches": launched, "kernels_per_call": total,
            "sort_passes": passes}


def k2_breakdown(torch, kernels, inputs, sort_inputs):
    """Traced, at each K2 shape: the device µs and launches a call of each
    kernel K2 launches (the sort's count, scan and scatter; the sum's tile
    and carry passes), which must be 3 a sort pass plus 2; at each sort
    edge, the sort's own, 3 a pass. Run last, after every timed phase."""
    out = {}
    for label, table, ids, deltas in inputs:
        work = table.clone()
        out[label] = traced_launches(
            torch, kernels, table.shape[0],
            lambda: kernels.scatter_add_cuda_(work, ids, deltas), 2, label)
        log(f"K2 breakdown, {label}, a call: " + json.dumps(out[label]))
    sorts = {}
    for label, ids, num_rows in sort_inputs:
        sorts[label] = traced_launches(
            torch, kernels, num_rows,
            lambda: kernels.radix_sort_cuda(ids, num_rows), 0, label)
        log(f"K2 sort, {label}, a call: " + json.dumps(sorts[label]))
    return out, sorts


def k3_breakdown(torch, kernels, inputs):
    """Traced, at each K3 shape: the device µs and launches a call of each
    kernel K3 launches. The slice pass runs once a call and the fold pass
    once more where the plan has more than one cluster a tile. Run last,
    after every timed phase."""
    out = {}
    for label, table, ids, deltas, H in inputs:
        work = table.clone()
        us, launched = profiled(
            torch, lambda: kernels.scatter_add_packed_cuda_(work, ids,
                                                            deltas, H))
        plan = kernels.card_packed_plan(ids.device, ids.numel(), H,
                                         table.shape[1])
        want = {"packed_slice_pass": 1}
        if plan.groups > 1:
            want["packed_fold_pass"] = 1
        if launched != want:
            raise AssertionError(f"{label}: traced K3 launches a call "
                                 f"{launched}, expected {want}")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": sum(launched.values())}
        log(f"K3 breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def k4_breakdown(torch, kernels, inputs):
    """Traced, at each K4 shape: the device µs and launches a call of each
    kernel K4 launches, which must be what its plan counts: the bucket
    pass's count and scatter where the plan has more than one bucket, the
    tile pass, and the fold where it has more than one cluster. Run last,
    after every timed phase."""
    out = {}
    for label, table, ids, deltas in inputs:
        work = table.clone()
        us, launched = profiled(
            torch, lambda: kernels.scatter_add_dim1_cuda_(work, ids, deltas))
        plan = kernels.card_dim1_plan(ids.device, ids.numel(),
                                      table.shape[0])
        want = {"dim1_tile_pass": 1}
        if plan.buckets > 1:
            want.update(dim1_bucket_count=1, dim1_bucket_scatter=1)
        if plan.clusters > 1:
            want["dim1_fold_pass"] = 1
        if launched != want or sum(launched.values()) != plan.kernels:
            raise AssertionError(f"{label}: traced K4 launches a call "
                                 f"{launched}, expected {want} "
                                 f"({plan.kernels} kernels, dim1_plan)")
        out[label] = {"device_us": us, "launches": launched,
                      "kernels_per_call": plan.kernels}
        log(f"K4 breakdown, {label}, a call: " + json.dumps(out[label]))
    return out


def check_bucket(torch, kernels, label, ids, deltas, num_rows, plan):
    """Hold K4's bucket pass alone to its plain version (a stable sort of
    the kept ids by bucket): ids, deltas and starts bit for bit."""
    got_ids, got_vals, starts = kernels.dim1_bucket_cuda(ids, deltas,
                                                         num_rows)
    want = kernels.dim1_bucket_plain(ids, deltas, num_rows,
                                     plan.bucket_rows, plan.buckets)
    n = int(starts[-1])
    if not (torch.equal(starts, want[2]) and
            torch.equal(got_ids[:n], want[0]) and
            torch.equal(got_vals[:n], want[1])):
        raise AssertionError(f"{label}: K4's bucket pass differs from its "
                             "plain version")


def check_sort(torch, kernels, label, ids, num_rows):
    """Hold K2's radix sort to ``torch.sort(keys, stable=True)`` (keys
    and int32 positions, bit for bit)."""
    keys, perm = kernels.radix_sort_cuda(ids, num_rows)
    want_keys, want_perm = kernels.radix_sort_plain(ids, num_rows)
    torch.cuda.synchronize()
    if not (torch.equal(keys, want_keys) and torch.equal(perm, want_perm)):
        raise AssertionError(f"{label}: the radix sort differs from "
                             "torch.sort(keys, stable=True)")


def sort_edges(torch, kernels, dev):
    """K2's sort off the paths, each bit-equal to ``torch.sort``: one pass
    (R = 1) and four (R = 2^31 - 1), every id dropped, one id owning 2^20
    ids, equal keys across the sort's 4,096-position tiles, and batches that
    are not a multiple of the tile. Returns each case with its time, and
    the inputs for :func:`k2_breakdown`."""
    rng = np.random.default_rng(4)
    tile_runs = np.repeat(np.arange(12), [1, 4095, 1, 4096, 8192, 3, 4093,
                                          7, 4096, 2, 1, 4094])
    cases = [
        ("R = 1", 1, rng.integers(-1, 3, BATCH)),
        ("R = 2^31 - 1", 2**31 - 1, rng.integers(-5, 2**31 - 1, BATCH)),
        ("every id dropped", PA_NF, np.where(np.arange(BATCH) % 2, -1,
                                             PA_NF)),
        ("one id owns 2^20", PA_NF, np.full(SPARSE_BATCH * PA_NNZ, 7)),
        # 262,225 ids: tiles of 4,096 positions, the largest.
        ("runs across tile edges", PA_NF, np.concatenate(
            [tile_runs + 12 * k for k in range(9)] + [np.full(4096, -1)])
         [::-1]),
        ("B = 32,767 (not a multiple of the tile)", ML20M_ITEMS,
         rng.integers(-1, ML20M_ITEMS + 1, BATCH - 1)),
    ]
    out, inputs = [], []
    for label, num_rows, ids in cases:
        ids = torch.from_numpy(np.ascontiguousarray(ids, np.int32)).to(dev)
        check_sort(torch, kernels, label, ids, num_rows)
        case = {"shape": label, "R": num_rows, "B": int(ids.numel()),
                "sort_ms": time_ms(torch, lambda _: kernels.radix_sort_cuda(
                    ids, num_rows)),
                "torch_sort_ms": time_ms(torch, lambda _: torch.sort(
                    ids, stable=True))}
        log(f"K2 sort, {label}: bit-equal to torch.sort; " + json.dumps(case))
        out.append(case)
        inputs.append((label, ids, num_rows))
    return out, inputs


def sixteenths(torch, x):
    """``x`` rounded to a multiple of 1/16 within [-1/2, 1/2]. Float32 sums
    of up to 2^20 such terms stay below 2^24 sixteenths, so every partial
    sum is exact and any order of adding gives the float64 sum."""
    return torch.round(x.clamp(-2, 2) * 4) / 16


def check_packed(torch, label, kernels, table, ids, deltas, hot_rows, path,
                 reps=30, collect=None):
    """Hold K3 against its plain version and a float64 sum over the head
    rows (within the float32 summation bound; the same bits on two
    launches; rows past the head unchanged), and on sixteenths of the same
    inputs against the exact float64 sum, bit for bit: the worst-case bound
    grows with a row's push count past the row's own sum, so only the exact
    sums catch a lost or doubled push to a hot row. Time K3, K3 with the
    same slices unclustered (each block's partial through global scratch,
    the design before the cluster reduction), its plain version and
    ``index_add_`` of the head pushes into ``table[:H]``. ``collect`` (a
    list) gathers the inputs for :func:`k3_breakdown`."""
    kernel = kernels.scatter_add_packed_cuda_
    plain = kernels.scatter_add_packed_plain
    num_rows, dim = table.shape
    H = min(hot_rows, num_rows)
    B = ids.shape[0]
    got = kernel(table.clone(), ids, deltas, H)
    again = kernel(table.clone(), ids, deltas, H)
    want = plain(table.clone(), ids, deltas, H)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        raise AssertionError(f"{label}: two launches gave different bits")
    if not torch.equal(got[H:], table[H:]):
        raise AssertionError(f"{label}: rows past the head changed")
    keep = (ids >= 0) & (ids < H)
    kid, kd = ids[keep], deltas[keep]
    ref, count = check_sum_bound(torch, label, table, kid, kd, got, want)
    et, ed = sixteenths(torch, table), sixteenths(torch, deltas)
    exact = et.double().index_add_(0, kid, ed[keep].double())
    for which, fn in (("kernel", kernel), ("plain", plain)):
        if not torch.equal(fn(et.clone(), ids, ed, H).double(), exact):
            raise AssertionError(
                f"{label}: {which} differs from the exact sum of sixteenths")
    uniq = int(torch.unique(kid).numel())
    # Least bytes: every id read, the head pushes' deltas read, each
    # touched head row read and written once.
    nbytes = B * 4 + kid.numel() * dim * 4 + 2 * uniq * dim * 4
    head = table[:H]
    plan = kernels.card_packed_plan(ids.device, B, H, dim)
    flat = plan._replace(cluster=1, groups=plan.slices,
                         partial_words=plan.slices * H * dim)
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim, "B": B,
        "H": H, "head_pushes": int(kid.numel()), "unique_rows": uniq,
        "max_run": int(count.max()) if num_rows else 0,
        "plan": plan._asdict(),
        "max_abs_err": float((got - want).abs().max()),
        "max_err_vs_f64": float((got.double() - ref).abs().max()),
        "ms": time_ms(torch, lambda t: kernel(t, ids, deltas, H),
                      setup=table.clone, reps=reps),
        "call_ms": time_ms(torch, lambda t: kernel(t, ids, deltas, H),
                           setup=table.clone, hold=False, reps=reps),
        "unclustered_ms": time_ms(
            torch, lambda t: kernel(t, ids, deltas, H, plan=flat),
            setup=table.clone, reps=reps),
        "plain_ms": time_ms(torch, lambda t: plain(t, ids, deltas, H),
                            setup=table.clone, reps=reps),
        "library_ms": time_ms(torch, lambda t: t.index_add_(0, kid, kd),
                              setup=head.clone, reps=reps),
        "bytes": nbytes, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }
    log(f"{label}: deterministic, within the float32 bound and exact on "
        "sixteenths (kernel and plain); " + json.dumps(case))
    if collect is not None:
        collect.append((label, table, ids, deltas, H))
    return case


def split_end_to_end(torch, kernels, ops, label, table, ids, deltas, path):
    """The hot/cold split as the store calls it, ``ops.scatter_add_`` with
    ``hot_rows = 2,048`` (K3 for the head, the ``torch.where`` rewrite, K2
    for the tail), against K2 alone over the whole push: both within the
    float32 summation bound of the float64 sum, both timed."""
    num_rows, dim = table.shape
    got = ops.scatter_add_(table.clone(), ids, deltas, hot_rows=HOT)
    want = kernels.scatter_add_cuda_(table.clone(), ids, deltas)
    torch.cuda.synchronize()
    keep = (ids >= 0) & (ids < num_rows)
    check_sum_bound(torch, label, table, ids[keep], deltas[keep], got, want)
    case = {
        "shape": label, "path": path, "R": num_rows, "D": dim,
        "B": ids.shape[0], "hot_rows": HOT,
        "split_ms": time_ms(torch, lambda t: ops.scatter_add_(
            t, ids, deltas, hot_rows=HOT), setup=table.clone),
        "k2_ms": time_ms(torch, lambda t: kernels.scatter_add_cuda_(
            t, ids, deltas), setup=table.clone),
    }
    log(f"{label}: the split and K2 alone within the float32 bound; "
        + json.dumps(case))
    return case


def crossover_sweep(torch, kernels, dev):
    """K3 over the whole table (``hot_rows = R``) against K2 with its sort,
    at the JAX package's sweep shape (B = 32,768 Zipf(0.8) ids); the
    largest R at which K3 is not slower, for each D, is what
    ``fps_tpu_torch.ops.packed_crossover_rows`` returns."""
    rng = np.random.default_rng(1)
    rows = []
    for dim in (10, 32, 100, 200):
        for num_rows in (512, 1024, 2048, 4096, 8192, 16384, 32768):
            pop = 1.0 / np.arange(1, num_rows + 1) ** 0.8
            ids = torch.from_numpy(rng.choice(
                num_rows, BATCH, p=pop / pop.sum()).astype(np.int32)).to(dev)
            table = torch.from_numpy(rng.normal(
                0, 1, (num_rows, dim)).astype(np.float32)).to(dev)
            deltas = torch.from_numpy(rng.normal(
                0, 1, (BATCH, dim)).astype(np.float32)).to(dev)
            k3 = time_ms(torch, lambda t: kernels.scatter_add_packed_cuda_(
                t, ids, deltas, num_rows), setup=table.clone, reps=10,
                warmup=2)
            k2 = time_ms(torch, lambda t: kernels.scatter_add_cuda_(
                t, ids, deltas), setup=table.clone, reps=10, warmup=2)
            rows.append({"D": dim, "R": num_rows, "k3_ms": k3, "k2_ms": k2})
            log(f"crossover D={dim} R={num_rows}: K3 {k3:.4f} ms, K2 (with "
                f"sort) {k2:.4f} ms")
    wins = {}
    for dim in (10, 32, 100, 200):
        ok = [r["R"] for r in rows if r["D"] == dim and r["k3_ms"] <= r["k2_ms"]]
        wins[dim] = max(ok) if ok else 0
    log(f"crossover: K3 not slower than K2 through R = {json.dumps(wins)}")
    return {"rows": rows, "k3_wins_through_R": wins}


def check_k4(torch, kernels, dev, label, view, ids, dl, path, collect):
    """K4 at one shape, with its plan and, where the plan has one, its
    bucket pass held to its plain version and timed alone."""
    R = view.shape[0]
    plan = kernels.card_dim1_plan(dev, ids.numel(), R)
    bucket = None
    if plan.buckets > 1:
        check_bucket(torch, kernels, label, ids, dl, R, plan)
        bucket = (lambda _: kernels.dim1_bucket_cuda(ids, dl, R))
    case = check_scatter(torch, label, kernels.scatter_add_dim1_cuda_,
                         kernels.scatter_add_dim1_plain, view, ids, dl, path,
                         collect=collect, sort_fn=bucket)
    case["plan"] = plan._asdict()
    return case


def kernel_phase(torch, kernels, pa_data, pa_q, mc_data, lr_data, dev):
    """Phase 3: every kernel against its plain version at its paths'
    shapes. Returns ``{kernel name: [case, ...]}``."""
    import fps_tpu_torch.ops as ops

    rng = np.random.default_rng(0)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    def table(rows, dim):
        return t(rng.normal(0, 1, (rows, dim)).astype(np.float32))

    def deltas(n, dim):
        return t(rng.normal(0, 1, (n, dim)).astype(np.float32))

    g1, s2 = kernels.gather_rows_cuda, kernels.scatter_add_cuda_
    g1p, s2p = kernels.gather_rows_plain, kernels.scatter_add_plain
    g5, g5p = kernels.gather_rows_dim1_cuda, kernels.gather_rows_dim1_plain
    cases = {"gather_rows": [], "scatter_add": [], "gather_rows_dim1": [],
             "scatter_add_dim1": [], "scatter_add_packed": [], "split": []}
    k2_inputs = cases["k2_inputs"] = []
    k3_inputs = cases["k3_inputs"] = []
    k4_inputs = cases["k4_inputs"] = []
    gather_inputs = cases["gather_inputs"] = []

    def k4_case(label, view, ids, dl, path):
        return check_k4(torch, kernels, dev, label, view, ids, dl, path,
                        k4_inputs)

    # K1 / K2 at the MF step: the item pull and push (mean's count column),
    # the user factors' gather and update; the "sum" combine's push is off
    # the smoke's path.
    for name, rows, zipf in (("items", ML20M_ITEMS, True),
                             ("users", ML20M_USERS, False)):
        cases["gather_rows"].append(check_gather(
            torch, kernels, f"K1 MF {name}", g1, g1p, table(rows, RANK),
            t(path_ids(rng, rows, BATCH, zipf)), "mf",
            collect=gather_inputs))
    for name, rows, dim, zipf, path in (
            ("items_mean_count_column", ML20M_ITEMS, RANK + 1, True, "mf"),
            ("users", ML20M_USERS, RANK, False, "mf"),
            ("items_sum", ML20M_ITEMS, RANK, True, "off_path")):
        cases["scatter_add"].append(check_scatter(
            torch, f"K2 MF {name}", s2, s2p, table(rows, dim),
            t(path_ids(rng, rows, BATCH, zipf)), deltas(BATCH, dim), path,
            kernels, k2_inputs))

    # The MF item push with hot_items = 2,048: the count-column scatter into
    # zeros, the head through K3, the tail through K2 (head ids -1).
    item_ids = t(path_ids(rng, ML20M_ITEMS, BATCH, True))
    item_deltas = deltas(BATCH, RANK + 1)
    acc = torch.zeros((ML20M_ITEMS, RANK + 1), device=dev)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 MF item head", kernels, acc, item_ids, item_deltas, HOT,
        "mf_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split MF item push", acc, item_ids,
        item_deltas, "mf_hot"))
    tail_ids = torch.where((item_ids >= 0) & (item_ids < HOT), -1, item_ids)
    cases["scatter_add"].append(check_scatter(
        torch, "K2 MF item tail", s2, s2p, acc, tail_ids, item_deltas,
        "mf_hot", kernels, k2_inputs))

    # K1 / K2 at the 20-class PA step: 2^20 Zipf(0.9) ids into (NF, 20).
    mc_ids = t(mix_dropped(mc_data["feat_ids"][:SPARSE_BATCH].reshape(-1),
                           PA_NF))
    cases["gather_rows"].append(check_gather(
        torch, kernels, "K1 PA multiclass", g1, g1p,
        table(PA_NF, PA_MC_CLASSES), mc_ids, "pa_multiclass", loop=True,
        collect=gather_inputs))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 PA multiclass", s2, s2p, table(PA_NF, PA_MC_CLASSES),
        mc_ids, deltas(mc_ids.numel(), PA_MC_CLASSES), "pa_multiclass",
        kernels, k2_inputs))
    mc_deltas = deltas(mc_ids.numel(), PA_MC_CLASSES)
    mc_table = table(PA_NF, PA_MC_CLASSES)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 PA multiclass head", kernels, mc_table, mc_ids, mc_deltas,
        HOT, "pa_multiclass_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split PA multiclass push", mc_table, mc_ids,
        mc_deltas, "pa_multiclass_hot"))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 PA multiclass tail", s2, s2p, table(PA_NF, PA_MC_CLASSES),
        torch.where((mc_ids >= 0) & (mc_ids < HOT), -1, mc_ids), mc_deltas,
        "pa_multiclass_hot", kernels, k2_inputs))
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 one id owns 2^20 pushes", kernels,
        table(PA_NF, PA_MC_CLASSES), torch.full_like(mc_ids, 7), mc_deltas,
        HOT, "off_path", collect=k3_inputs))

    # The logistic-regression step's ids: the dense head, then the tail.
    lr_ids = mix_dropped(np.concatenate([
        np.arange(LR_DENSE), lr_data["feat_ids"][:SPARSE_BATCH, LR_DENSE:]
        .reshape(-1)]), LR_NF)
    lr_ids = t(lr_ids)
    # K1 / K2 at the AdaGrad step: (NF, 2) pull, (NF, 3) push of [g, g^2,
    # count] into zeros.
    cases["gather_rows"].append(check_gather(
        torch, kernels, "K1 logreg adagrad", g1, g1p, table(LR_NF, 2),
        lr_ids, "logreg_adagrad", collect=gather_inputs))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 logreg adagrad", s2, s2p,
        torch.zeros((LR_NF, 3), device=dev), lr_ids,
        deltas(lr_ids.numel(), 3), "logreg_adagrad", kernels, k2_inputs))
    lr_deltas = deltas(lr_ids.numel(), 3)
    lr_zeros = torch.zeros((LR_NF, 3), device=dev)
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 logreg adagrad head", kernels, lr_zeros, lr_ids,
        lr_deltas, HOT, "logreg_adagrad_hot", collect=k3_inputs))
    cases["split"].append(split_end_to_end(
        torch, kernels, ops, "split logreg adagrad push", lr_zeros, lr_ids,
        lr_deltas, "logreg_adagrad_hot"))
    cases["scatter_add"].append(check_scatter(
        torch, "K2 logreg adagrad tail", s2, s2p,
        torch.zeros((LR_NF, 3), device=dev),
        torch.where((lr_ids >= 0) & (lr_ids < HOT), -1, lr_ids), lr_deltas,
        "logreg_adagrad_hot", kernels, k2_inputs))
    # The whole-table route (hot_rows >= R), as hot_ids="auto" takes it.
    cases["scatter_add_packed"].append(check_packed(
        torch, "K3 whole table 4,096 x 10", kernels, table(4096, RANK),
        t(path_ids(rng, 4096, BATCH, True)), deltas(BATCH, RANK), 4096,
        "off_path", collect=k3_inputs))

    # K5 / K4 at the binary PA step: nnz-major ids of one head-sorted batch,
    # the first q * B read against the head table[:H] and pushed through the
    # head view, the rest against and through the whole table. The read is
    # one K5 call (the path's shape); the head view and the tail alone are
    # timed beside it off the path.
    ids = pa_data["feat_ids"][:SPARSE_BATCH].T.reshape(-1)
    split = pa_q * SPARSE_BATCH
    pa_table = table(PA_NF, 1)
    parts = {"head view": (pa_table[:PA_HEAD],
                           t(mix_dropped(ids[:split], PA_HEAD))),
             "tail": (pa_table, t(mix_dropped(ids[split:], PA_NF)))}
    cases["gather_rows_dim1"].append(check_gather(
        torch, kernels, "K5 PA head prefix, one call", g5, g5p, pa_table,
        torch.cat([parts["head view"][1], parts["tail"][1]]), "pa_binary",
        head=(PA_HEAD, split), collect=gather_inputs))
    for name, (view, part) in parts.items():
        cases["gather_rows_dim1"].append(check_gather(
            torch, kernels, f"K5 PA {name} alone", g5, g5p, view, part,
            "off_path"))
        cases["scatter_add_dim1"].append(k4_case(
            f"K4 PA {name}", view, part, deltas(part.numel(), 1),
            "pa_binary"))
    lr_table = table(LR_NF, 1)
    cases["gather_rows_dim1"].append(check_gather(
        torch, kernels, "K5 logreg", g5, g5p, lr_table, lr_ids, "logreg_sgd",
        collect=gather_inputs))
    cases["scatter_add_dim1"].append(k4_case(
        "K4 logreg", lr_table, lr_ids, deltas(lr_ids.numel(), 1),
        "logreg_sgd"))
    # K4 at 2^20 ids off the path: the whole PA push in one call, uniform
    # ids, and one id owning every push (its run cut over every block and
    # cluster).
    n = SPARSE_BATCH * PA_NNZ
    for name, all_ids in (
            ("whole push 2^20", mix_dropped(ids, PA_NF)),
            ("uniform 2^20", rng.integers(0, PA_NF, n)),
            ("one id owns 2^20", np.full(n, 7))):
        cases["scatter_add_dim1"].append(k4_case(
            f"K4 PA {name}", table(PA_NF, 1), t(all_ids.astype(np.int32)),
            deltas(n, 1), "off_path"))
    return cases


def check_launches(label, launched, per_step, steps):
    for name, count in launched.items():
        want = per_step.get(name, 0) * steps
        if count != want:
            raise AssertionError(
                f"{label}: {name} launched {count} times, expected {want} "
                f"({per_step.get(name, 0)} per step x {steps} steps)")


def check_finite(torch, label, tables, local_state):
    from fps_tpu_torch.parallel.mesh import Blocks

    leaves = dict(tables)
    if isinstance(local_state, (Blocks, torch.Tensor)):
        leaves["local_state"] = local_state
    for name, tb in leaves.items():
        for block in blocks_of(torch, tb):
            if not bool(torch.isfinite(block).all()):
                raise AssertionError(f"{label}: {name} has non-finite "
                                     "values")


def blocks_of(torch, x):
    """The tensors of a table or local-state leaf: a ``Blocks``' blocks, or
    the tensor itself."""
    return [x] if isinstance(x, torch.Tensor) else list(x)


def on_device(torch, x, device):
    """A copy of tables or local state (``Blocks``, tensors, dicts of them)
    with every block on ``device``."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, dict):
        return {k: on_device(torch, v, device) for k, v in x.items()}
    if isinstance(x, Blocks):
        return Blocks([b.to(device, copy=True) for b in x],
                      replicas=x.replicas)
    if isinstance(x, torch.Tensor):
        return x.to(device, copy=True)
    return x


def on_host(torch, x):
    """The global arrays of tables or local state as CPU tensors."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, dict):
        return {k: on_host(torch, v) for k, v in x.items()}
    if isinstance(x, Blocks):
        return torch.from_numpy(x.numpy())
    return x.cpu()


def run_path(torch, kernels, label, trainer, chunks, per_step, quality,
             card):
    """Train over ``chunks`` (prebuilt on the host) from fresh tables, the
    launch counters at 0 just before and read just after; check the counts
    (``per_step`` launches of each kernel a step), finite tables and
    ``quality(metrics)``; return a summary."""
    tables, local_state = trainer.init_state(0)
    steps = sum(int(np.prod(c["weight"].shape[:-1])) for c in chunks)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.fit_stream(
        tables, local_state, chunks, 1,
        on_chunk=lambda i, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, per_step, steps)
    check_finite(torch, label, tables, local_state)
    checks = quality(metrics)
    n = float(sum(m["n"].sum() for m in metrics))
    per_chunk = np.diff([t0] + stamps)
    steady = per_chunk[1:] if len(per_chunk) > 1 else per_chunk
    steps_per_chunk = steps // len(chunks)
    summary = {
        "path": label, "chunks": len(chunks), "steps": steps,
        "examples": n, "seconds": elapsed, "examples_per_s": n / elapsed,
        "ms_per_step": elapsed / steps * 1e3,
        "steady_ms_per_step": float(np.median(steady)) / steps_per_chunk
        * 1e3,
        "chunk_seconds": per_chunk.tolist(), "launches": launched,
        "launches_per_step": {k: v / steps for k, v in launched.items()
                              if v},
        "mesh": dict(trainer.mesh.shape), "quality": checks, "card": card,
    }
    log(f"path {label}: " + json.dumps(summary))
    return summary


def run_indexed_path(torch, fps, kernels, label, trainer, data, route_key,
                     local_batch, epochs, per_step, quality, card,
                     chunk_steps, state_check=None):
    """Train ``epochs`` epochs through device-resident ingest and
    ``run_indexed`` from fresh tables, the launch counters at 0 just before
    the run and read just after (the dataset's upload is set-up, before
    them); check the counts (``per_step`` launches of each kernel for every
    step of every epoch), finite
    tables and ``quality`` over the metrics cut into pieces of
    ``chunk_steps`` steps (``None``: one piece an epoch), and
    ``state_check(tables, local_state)`` where given; return a summary.
    Every position of the trainer's mesh is a worker of ``local_batch``
    examples a step."""
    mesh = trainer.mesh
    t0 = time.perf_counter()
    dataset = fps.DeviceDataset(mesh, data)
    plan = fps.DeviceEpochPlan(
        dataset, num_workers=fps.num_workers_of(mesh),
        local_batch=local_batch, route_key=route_key,
        seed=0, sync_every=trainer.config.sync_every)
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    steps_per_call = trainer._indexed_call_steps(plan)
    steps_run = epochs * plan.steps_per_epoch
    tables, local_state = trainer.init_state(0)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=epochs,
        on_epoch=lambda e, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, per_step, steps_run)
    check_finite(torch, label, tables, local_state)
    state = (state_check(tables, local_state) if state_check is not None
             else None)
    pieces = [{k: v[i:i + (chunk_steps or len(m["n"]))] for k, v in m.items()}
              for m in metrics
              for i in range(0, len(m["n"]), chunk_steps or len(m["n"]))]
    checks = quality(pieces)
    n = float(sum(m["n"].sum() for m in metrics))
    per_epoch = np.diff([t0] + stamps)
    steps_per_epoch_run = steps_run // epochs
    summary = {
        "path": label, "epochs": epochs,
        "steps_per_epoch": plan.steps_per_epoch,
        "steps_per_call": steps_per_call, "steps_run": steps_run,
        "examples": n, "upload_seconds": upload_s, "seconds": elapsed,
        "examples_per_s": n / elapsed, "ms_per_step": elapsed / steps_run
        * 1e3,
        "steady_ms_per_step": float(per_epoch[-1]) / steps_per_epoch_run
        * 1e3,
        "epoch_seconds": per_epoch.tolist(), "launches": launched,
        "launches_per_step": {k: v / steps_run for k, v in launched.items()
                              if v},
        "mesh": dict(mesh.shape), "quality": checks, "card": card,
    }
    if state is not None:
        summary["state"] = state
    log(f"path {label}: " + json.dumps(summary))
    return summary


def traced_epoch(torch, label, trainer, plan, card):
    """Device busy share of a ``run_indexed`` step: a warm-up and an
    untraced epoch, timed, then a traced one (``torch.profiler``,
    summarised by ``fps_tpu_torch.utils.trace_summary``: each kernel's
    device time a step) against the untraced step. The trace goes to a
    temporary directory and is deleted."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    tables, local_state = trainer.init_state(0)
    times = []
    for e in range(2):  # warm-up, then the untraced epoch that is timed
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables, local_state, _ = trainer.run_indexed(
            tables, local_state, plan, 1, start_epoch=e)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    untraced_ms = times[-1] / plan.steps_per_epoch * 1e3
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path))
        with prof:
            for e in (2, 3):
                tables, local_state, _ = trainer.run_indexed(
                    tables, local_state, plan, 1, start_epoch=e)
                torch.cuda.synchronize()
                prof.step()
        summary = trace_summary.summarize(trace_summary.load(path),
                                          plan.steps_per_epoch, top=30)
    busy = summary["device_busy_ms_per_step"]
    out = {"path": label, "steps": plan.steps_per_epoch,
           "untraced_ms_per_step": untraced_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / untraced_ms,
           "device_launches_per_step": summary["device_launches_per_step"],
           "traced_host_ms_per_step": summary["traced_host_ms_per_step"],
           "kernels": summary["kernels"], "card": card}
    log(f"traced epoch, {label}: " + json.dumps(out))
    return out


def traced_mf_epoch(torch, fps, mf_data, card):
    """:func:`traced_epoch` of the MF run_indexed step with hot_items: 64
    steps over the first 63 x 32,768 ratings."""
    mesh = fps.make_ps_mesh()
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01, hot_items=HOT)
    trainer, _ = fps.online_mf(mesh, cfg, combine="mean")
    part = {k: v[:63 * BATCH] for k, v in mf_data.items()}
    plan = fps.DeviceEpochPlan(fps.DeviceDataset(mesh, part), num_workers=1,
                               local_batch=BATCH, route_key="user", seed=0)
    return traced_epoch(torch, "MF sync, hot_items, run_indexed (traced "
                        "epoch)", trainer, plan, card)


def falling_rmse(metrics):
    rmses = [float(np.sqrt(m["se"].sum() / max(1.0, m["n"].sum())))
             for m in metrics]
    if not all(np.isfinite(rmses)) or not rmses[-1] < rmses[0]:
        raise AssertionError(f"train RMSE per chunk {rmses} is not finite "
                             "and falling")
    return {"train_rmse_per_chunk": rmses}


def below(key, limit):
    """``key`` per example over the last chunk (the end of the last epoch)
    must lie below ``limit``; chance is 0.5 for a binary mistake rate, 0.95
    for 20 classes, log 2 = 0.693 for the log loss."""
    def check(metrics):
        per_chunk = [float(m[key].sum() / max(1.0, m["n"].sum()))
                     for m in metrics]
        if not np.isfinite(per_chunk).all() or not per_chunk[-1] < limit:
            raise AssertionError(f"{key} per example by chunk {per_chunk}: "
                                 f"the last is not below {limit}")
        return {f"{key}_per_example_by_chunk": per_chunk, "limit": limit}
    return check


def paths_phase(torch, fps, kernels, pa_data, pa_q, mc_data, lr_data, card):
    """Phase 4: every path at full width, counters reset before each."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks
    from fps_tpu_torch.utils.datasets import synthetic_ratings

    mesh = fps.make_ps_mesh()
    runs = []
    data = synthetic_ratings(ML20M_USERS, ML20M_ITEMS, ML20M_RATINGS, seed=0)
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.1, reg=0.01)
        trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                   combine="mean")
        t0 = time.perf_counter()
        chunks = list(multi_epoch_chunks(
            data, 2, num_workers=1, local_batch=BATCH, steps_per_chunk=64,
            route_key="user", sync_every=sync_every, seed=0))
        ingest_s = time.perf_counter() - t0
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        runs.append(dict(run_path(
            torch, kernels, f"MF {mode}", trainer, chunks,
            {"gather_rows": 2, "scatter_add": 2}, falling_rmse, card),
            host_ingest_s=ingest_s))
        del chunks

    def sparse(data, epochs, spc, sync_every=None):
        return list(multi_epoch_chunks(
            data, epochs, num_workers=1, local_batch=SPARSE_BATCH,
            steps_per_chunk=spc, sync_every=sync_every, seed=1))

    # Binary PA-I with the head prefix (bench.py run_pa on one device).
    # 800,000 examples make 49 steps an epoch: 7 chunks of 7 steps.
    cfg = fps.PAConfig(num_features=PA_NF, variant="PA-I", C=1.0,
                       hot_features=PA_HEAD, head_prefix_cols=pa_q)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I binary, head prefix", trainer,
        sparse(pa_data, 2, 7), {"gather_rows_dim1": 1,
                                "scatter_add_dim1": 2},
        below("mistakes", 0.5), card))
    # 20-class PA-I: 200,000 examples, 13 steps an epoch.
    cfg = fps.PAConfig(num_features=PA_NF, num_classes=PA_MC_CLASSES,
                       variant="PA-I", C=1.0)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I 20 classes", trainer, sparse(mc_data, 2, 13),
        {"gather_rows": 1, "scatter_add": 1}, below("mistakes", 0.95), card))
    # SSP logistic regression, SGD with the dense head (bench.py
    # run_logreg): 1,000,000 examples make 62 steps an epoch, padded to 64.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.1,
                           dense_features=LR_DENSE)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    runs.append(run_path(
        torch, kernels, "logreg SSP SGD, dense head", trainer,
        sparse(lr_data, 2, 16, sync_every=8),
        {"gather_rows_dim1": 1, "scatter_add_dim1": 1},
        below("logloss", 0.693), card))
    # A smaller AdaGrad run: 16 steps an epoch. AdaGrad's first steps on a
    # feature that every example carries are about lr * sqrt(B) times the
    # mean-to-rms ratio of its per-example gradients (the accumulator sums
    # per-example squares), so at B = 16,384 the SGD run's lr 0.1
    # overshoots (log loss 1.84, then 1.19 over two epochs on the card);
    # lr 0.01 takes steps of about 0.1 there.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.01,
                           dense_features=LR_DENSE, optimizer="adagrad")
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    small = {k: v[:LR_ADAGRAD_NEX] for k, v in lr_data.items()}
    runs.append(run_path(
        torch, kernels, "logreg SSP AdaGrad, dense head", trainer,
        sparse(small, 2, 16, sync_every=8),
        {"gather_rows": 1, "scatter_add": 1}, below("logloss", 0.693), card))

    # The hot/cold split through device-resident ingest and run_indexed.
    # MF as bench.py run_mf trains it, with hot_items = 2,048: calls of 64
    # steps (the last call of each epoch padded with weight-0 steps).
    split = {"gather_rows": 2, "scatter_add": 2, "scatter_add_packed": 1}
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.1, reg=0.01,
                           hot_items=HOT)
        trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                   combine="mean", max_steps_per_call=64)
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        runs.append(run_indexed_path(
            torch, fps, kernels, f"MF {mode}, hot_items, run_indexed",
            trainer, data, "user", BATCH, 2, split, falling_rmse, card, 64))
    runs.append(mf_topk_path(torch, fps, kernels, data, card)[0])
    mf_data = data
    del data
    # 20-class PA-I with hot_features = 2,048 (the multiclass table takes
    # the split: K3 for the head, K2 for the tail).
    cfg = fps.PAConfig(num_features=PA_NF, num_classes=PA_MC_CLASSES,
                       variant="PA-I", C=1.0, hot_features=HOT)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_indexed_path(
        torch, fps, kernels, "PA-I 20 classes, hot_features, run_indexed",
        trainer, mc_data, None, SPARSE_BATCH, 2,
        {"gather_rows": 1, "scatter_add": 1, "scatter_add_packed": 1},
        below("mistakes", 0.95), card, None))
    # AdaGrad logistic regression with hot_features = 2,048: the apply_fn
    # push's (NF, 3) sum-and-count scatter takes the split.
    cfg = fps.LogRegConfig(num_features=LR_NF, learning_rate=0.01,
                           dense_features=LR_DENSE, optimizer="adagrad",
                           hot_features=HOT)
    trainer, _ = fps.logistic_regression(mesh, cfg, sync_every=8)
    runs.append(run_indexed_path(
        torch, fps, kernels, "logreg SSP AdaGrad, hot_features, run_indexed",
        trainer, small, None, SPARSE_BATCH, 2,
        {"gather_rows": 1, "scatter_add": 1, "scatter_add_packed": 1},
        below("logloss", 0.693), card, None))
    # Last, so that the profiler cannot slow the timed paths.
    traced = traced_mf_epoch(torch, fps, mf_data, card)
    return runs, traced, mf_data


def card_vs_cpu(torch, fps):
    """Small MF, head-prefix PA and SSP logistic-regression jobs on the card
    and on the CPU, from the same tables; return the largest table
    difference of each, relative to max(1, the table's largest value)."""
    from fps_tpu_torch.core.ingest import epoch_chunks, multi_epoch_chunks
    from fps_tpu_torch.utils import datasets as ds

    mf_data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    mf_cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                          learning_rate=0.1, reg=0.01)
    pa_data, q = ds.head_sort_slots(
        ds.synthetic_sparse_classification(8192, 2000, 16, seed=6,
                                           noise=0.05), 128)
    lr_data = ds.synthetic_sparse_classification(8192, 5000, 16, seed=7,
                                                 noise=0.05,
                                                 dense_features=3)
    lr_data["label"] = (lr_data["label"] > 0).astype(np.float32)
    jobs = {
        "MF sync": (lambda m: fps.online_mf(m, mf_cfg, combine="mean"),
                    lambda: epoch_chunks(mf_data, num_workers=1,
                                         local_batch=512, steps_per_chunk=8,
                                         route_key="user", seed=3)),
        "MF SSP": (lambda m: fps.online_mf(m, mf_cfg, sync_every=4,
                                           combine="mean"),
                   lambda: epoch_chunks(mf_data, num_workers=1,
                                        local_batch=512, steps_per_chunk=8,
                                        route_key="user", sync_every=4,
                                        seed=3)),
        "PA-I head prefix": (
            lambda m: fps.passive_aggressive(m, fps.PAConfig(
                num_features=2000, hot_features=128, head_prefix_cols=q)),
            lambda: multi_epoch_chunks(pa_data, 2, num_workers=1,
                                       local_batch=512, steps_per_chunk=8,
                                       seed=3)),
        "logreg SSP": (
            lambda m: fps.logistic_regression(m, fps.LogRegConfig(
                num_features=5000, learning_rate=0.1, dense_features=3),
                sync_every=4),
            lambda: multi_epoch_chunks(lr_data, 2, num_workers=1,
                                       local_batch=512, steps_per_chunk=8,
                                       sync_every=4, seed=3)),
    }
    # The hot/cold split through run_indexed: MF with hot_items (the item
    # push's count-column scatter on K3 + K2) and 20-class PA with
    # hot_features, each over a dataset resident on its device.
    mc_data = ds.synthetic_sparse_multiclass(4096, 2000, 20, 16, seed=8)

    def indexed(data, route_key, local_batch, sync_every=None):
        def run(trainer, tables, local):
            plan = fps.DeviceEpochPlan(
                fps.DeviceDataset(trainer.mesh, data), num_workers=1,
                local_batch=local_batch, route_key=route_key, seed=3,
                sync_every=sync_every)
            return trainer.run_indexed(tables, local, plan, 2, epochs=2)
        return run

    jobs.update(w2v_card_vs_cpu_jobs(fps))
    hot_mf = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                          learning_rate=0.1, reg=0.01, hot_items=64)
    jobs.update({
        "MF hot_items, run_indexed": (
            lambda m: fps.online_mf(m, hot_mf, combine="mean",
                                    max_steps_per_call=8),
            indexed(mf_data, "user", 512)),
        "MF hot_items SSP, run_indexed": (
            lambda m: fps.online_mf(m, hot_mf, sync_every=4, combine="mean"),
            indexed(mf_data, "user", 512, 4)),
        "PA-I 20 classes hot_features, run_indexed": (
            lambda m: fps.passive_aggressive(m, fps.PAConfig(
                num_features=2000, num_classes=20, hot_features=128)),
            indexed(mc_data, None, 256)),
    })
    worst = {}
    for job, (build, chunks) in jobs.items():
        runs = {}
        tables0 = local0 = None
        for device in ("cpu", "cuda"):
            mesh = fps.make_ps_mesh(device=device)
            trainer, _ = build(mesh)
            if tables0 is None:
                tables0, local0 = trainer.init_state(7)
            # Copies: the trainer updates its tables in place (donate).
            tables = on_device(torch, tables0, mesh.device)
            local = on_device(torch, local0, mesh.device)
            if job.endswith("run_indexed"):
                tables, local, _ = chunks(trainer, tables, local)
            else:
                tables, local, _ = trainer.fit_stream(tables, local,
                                                      chunks(), 2)
            leaves = on_host(torch, tables)
            if local0 != ():
                leaves["local_state"] = on_host(torch, local)
            runs[device] = leaves
        worst[job] = 0.0
        for name, want in runs["cpu"].items():
            diff = float((want - runs["cuda"][name]).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[job] = max(worst[job], diff / scale)
            log(f"card vs CPU, {job}, {name}: max abs diff {diff:.3e} "
                f"(largest value {scale:.3e})")
    return worst


# ---------------------------------------------------------------------------
# word2vec SGNS at text8 width (K1 and K2 at D = 100 and 101).
# ---------------------------------------------------------------------------

def w2v_config(fps):
    return fps.W2VConfig(vocab_size=W2V_VOCAB, dim=W2V_DIM)


def w2v_first_step_ids(torch, fps, tokens, uni):
    """The ids of each w2v path's first step, as the trainer makes them on
    the card: the block plan's first block (8,197 tokens) and, with the
    block worker's negatives, the OUT pull (49,182); the pairs plan's
    first step's 81,920 centers and 491,520 contexts and negatives."""
    from fps_tpu_torch.models import word2vec as w2v

    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    out = {}
    for mode, worker in (
            ("block", w2v.Word2VecBlockWorker(cfg, uni, W2V_BLOCK)),
            ("pairs", w2v.Word2VecWorker(cfg, uni))):
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=W2V_BLOCK, seed=1, mode=mode)
        batch = {k: v[0] for k, v in plan.call_batches(
            plan.epoch_args(0), 0, 1).items()}
        ids = worker.pull_ids(worker.prepare(batch, 0))
        out[mode] = {name: i.cpu().numpy() for name, i in ids.items()}
    return out


def w2v_kernel_cases(torch, kernels, cases, ids_by_mode, dev):
    """Phase 3 at the w2v shapes: K1 pulls of the (50,000, 100) tables and
    K2 mean pushes (the sum-and-count scatter, D = 101, into zeros) at the
    block path's 8,197 and 49,182 ids and, off the main path, the pairs
    path's 81,920 and 491,520; Zipf ids from the corpus, with -1 and >= R
    ids mixed in. Appends to ``cases`` and its collected inputs."""
    from fps_tpu_torch.models.word2vec import IN_TABLE, OUT_TABLE

    rng = np.random.default_rng(9)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    for mode, path in (("block", "w2v_block"), ("pairs", "w2v_pairs")):
        for name, label in ((IN_TABLE, "IN"), (OUT_TABLE, "OUT")):
            ids = t(mix_dropped(ids_by_mode[mode][name], W2V_VOCAB))
            B = ids.numel()
            table = t(rng.normal(0, 0.05, (W2V_VOCAB, W2V_DIM)).astype(
                np.float32))
            cases["gather_rows"].append(check_gather(
                torch, kernels, f"K1 w2v {mode} {label} pull, {B} ids",
                kernels.gather_rows_cuda, kernels.gather_rows_plain, table,
                ids, path, collect=cases["gather_inputs"]))
            deltas = rng.normal(0, 0.01, (B, W2V_DIM + 1)).astype(np.float32)
            deltas[:, -1] = 1.0  # the count column
            cases["scatter_add"].append(check_scatter(
                torch, f"K2 w2v {mode} {label} mean push, {B} ids",
                kernels.scatter_add_cuda_, kernels.scatter_add_plain,
                torch.zeros((W2V_VOCAB, W2V_DIM + 1), device=dev), ids,
                t(deltas), path, kernels, cases["k2_inputs"]))


def first_last_real_step(metrics):
    """Loss a pair at the first and the last step with pairs, over the
    run's epochs (bench.py ``first_last_real_step``)."""
    loss = np.concatenate([m["loss"] for m in metrics])
    n = np.concatenate([m["n"] for m in metrics])
    real = np.flatnonzero(n > 0)
    return float(loss[real[0]] / n[real[0]]), float(loss[real[-1]] /
                                                    n[real[-1]])


def w2v_learns(negatives):
    """The last real step's loss a pair lies below the first step's and
    below the initial ``(1 + K) log 2`` (4.159 at K = 5)."""
    limit = (1 + negatives) * float(np.log(2.0))

    def check(metrics):
        first, last = first_last_real_step(metrics)
        if not (np.isfinite([first, last]).all() and last < first
                and last < limit):
            raise AssertionError(f"w2v loss a pair {first} -> {last}: not "
                                 f"falling below {limit}")
        return {"loss_per_pair_first_step": first,
                "loss_per_pair_last_step": last, "limit": limit}
    return check


def w2v_paths(torch, fps, kernels, tokens, uni, card):
    """Phase 4, word2vec at text8 width through its entry points: the block
    worker through ``Word2VecDevicePlan(mode="block")`` and ``run_indexed``
    (calls of up to 256 steps, as the bench), 2 epochs sync from fresh
    tables, then 1 SSP epoch (s = 4) from where they ended (as the bench
    times an epoch after a warm-up one: SGNS from a zero OUT table moves
    the loss a pair by about 1e-6 in its first epoch of this corpus, a few
    float32 roundings of the loss's sum); then the pair worker, two
    ``run_chunk`` calls of 8 steps of the pairs plan from fresh tables, the
    second timed. Counters at 0 just before each run, read just after: K1 2
    and K2 2 a step."""
    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    per_step = {"gather_rows": 2, "scatter_add": 2}
    runs = []
    state = None
    for sync_every, epochs in ((None, 2), (4, 1)):
        trainer, _ = fps.word2vec_block(mesh, cfg, uni, W2V_BLOCK,
                                        sync_every=sync_every,
                                        max_steps_per_call=256)
        t0 = time.perf_counter()
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=W2V_BLOCK, seed=1,
                                      sync_every=sync_every, mode="block")
        torch.cuda.synchronize()
        upload_s = time.perf_counter() - t0
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        summary, state = run_w2v(
            torch, kernels, f"w2v block {mode}, run_indexed", trainer, plan,
            epochs, per_step, len(tokens), card, state)
        runs.append(dict(summary, upload_seconds=upload_s))
    # The pair worker: one call of 8 steps (81,920 pairs a step).
    trainer, _ = fps.word2vec(mesh, cfg, uni)
    plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                  block_len=W2V_BLOCK, seed=1, mode="pairs")
    chunk = plan.call_batches(plan.epoch_args(0), 0, W2V_PAIR_STEPS)
    tables, local_state = trainer.init_state(0)
    times = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for rep in range(2):  # the second call is the steady one
        t0 = time.perf_counter()
        tables, local_state, m = trainer.run_chunk(tables, local_state,
                                                   chunk, rep)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    launched = kernels.launch_counts()
    check_launches("w2v pairs, run_chunk", launched, per_step,
                   2 * W2V_PAIR_STEPS)
    check_finite(torch, "w2v pairs, run_chunk", tables, local_state)
    m = {k: v.cpu().numpy() for k, v in m.items()}
    pairs = float(m["n"].sum())
    summary = {
        "path": "w2v pairs, run_chunk", "calls": 2,
        "steps_per_call": W2V_PAIR_STEPS, "pairs_per_call": pairs,
        "call_seconds": times,
        "steady_ms_per_step": times[-1] / W2V_PAIR_STEPS * 1e3,
        "pairs_per_s": pairs / times[-1],
        "loss_per_pair": float(m["loss"].sum()) / max(pairs, 1.0),
        "launches": launched, "card": card}
    if not np.isfinite(summary["loss_per_pair"]):
        raise AssertionError("w2v pairs: the loss is not finite")
    log("path w2v pairs, run_chunk: " + json.dumps(summary))
    runs.append(summary)
    return runs


def run_w2v(torch, kernels, label, trainer, plan, epochs, per_step,
            num_tokens, card, state=None):
    """``epochs`` epochs of ``plan`` through ``run_indexed`` from
    ``state`` (``(tables, local_state)``; ``None``: fresh tables), the
    launch counters at 0 just before and read just after; checks the
    counts, finite tables and a falling loss; returns a summary with words/s
    (corpus tokens an epoch over the time) and steady ms a step (the last
    epoch), and the state it ended in."""
    tables, local_state = state or trainer.init_state(0)
    stamps = []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=epochs,
        on_epoch=lambda e, m: stamps.append(time.perf_counter()))
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    steps_run = epochs * plan.steps_per_epoch
    check_launches(label, launched, per_step, steps_run)
    check_finite(torch, label, tables, local_state)
    checks = w2v_learns(trainer.logic.cfg.negatives)(metrics)
    pairs = float(sum(m["n"].sum() for m in metrics))
    per_epoch = np.diff([t0] + stamps)
    summary = {
        "path": label, "epochs": epochs,
        "steps_per_epoch": plan.steps_per_epoch,
        "steps_per_call": trainer._indexed_call_steps(plan),
        "steps_run": steps_run, "tokens_per_epoch": num_tokens,
        "pairs": pairs, "seconds": elapsed,
        "words_per_s": epochs * num_tokens / elapsed,
        "pairs_per_s": pairs / elapsed,
        "ms_per_step": elapsed / steps_run * 1e3,
        "steady_ms_per_step": float(per_epoch[-1]) / plan.steps_per_epoch
        * 1e3,
        "steady_words_per_s": num_tokens / float(per_epoch[-1]),
        "epoch_seconds": per_epoch.tolist(), "launches": launched,
        "quality": checks, "from_fresh_tables": state is None, "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary, (tables, local_state)


def traced_w2v_epoch(torch, fps, tokens, uni, card):
    """:func:`traced_epoch` of the w2v block step over the corpus's first
    300,000 tokens (21 steps); its kernels include the mean pushes'
    accumulator fills and adds."""
    mesh = fps.make_ps_mesh()
    trainer, _ = fps.word2vec_block(mesh, w2v_config(fps), uni, W2V_BLOCK,
                                    max_steps_per_call=256)
    plan = fps.Word2VecDevicePlan(tokens[:300_000], uni, w2v_config(fps),
                                  mesh, num_workers=1, block_len=W2V_BLOCK,
                                  seed=1, mode="block")
    return traced_epoch(torch, "w2v block sync, run_indexed (traced epoch)",
                        trainer, plan, card)


def w2v_card_vs_cpu_jobs(fps):
    """Small w2v jobs for :func:`card_vs_cpu`: the block worker (sync) and
    the pair worker (SSP, s = 4) through ``run_indexed``, 2 epochs each, on
    a 2,000-word corpus of 60,000 tokens, dim 32, blocks of 1,024; lr 0.1,
    so that the IN table's largest value triples and OUT's grows from 0 to
    about 0.02 over the run (the CPU's reading)."""
    from fps_tpu_torch.utils.datasets import load_text8

    tokens, vocab, uni = load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)

    def indexed(mode, sync_every):
        def run(trainer, tables, local):
            plan = fps.Word2VecDevicePlan(
                tokens, uni, cfg, trainer.mesh, num_workers=1,
                block_len=1024, seed=5, sync_every=sync_every, mode=mode)
            return trainer.run_indexed(tables, local, plan, 6, epochs=2)
        return run

    return {
        "w2v block, run_indexed": (
            lambda m: fps.word2vec_block(m, cfg, uni, 1024,
                                         max_steps_per_call=16),
            indexed("block", None)),
        "w2v pairs SSP, run_indexed": (
            lambda m: fps.word2vec(m, cfg, uni, sync_every=4),
            indexed("pairs", 4)),
    }

# ---------------------------------------------------------------------------
# iALS at the bench's width (K1 at D = 16, K2 at D = 256 and 16), the w2v
# co-occurrence sketch tap (K4 on its 81,920-row stack) and MF's online
# top-k tap.
# ---------------------------------------------------------------------------

def ials_data(ds):
    """bench.py run_ials's data and chunks: ``(train, test, chunks)``, the
    chunks of ``interaction_chunks(seed=0)``, the same every epoch (the
    bench makes them anew each epoch from the same seed)."""
    from fps_tpu_torch.models.ials import interaction_chunks

    data = ds.synthetic_implicit(IALS_USERS, IALS_ITEMS, IALS_PER_USER,
                                 rank=8, seed=0)
    train, test = ds.train_test_split(data, test_frac=0.1, seed=1)
    chunks = list(interaction_chunks(train, num_workers=1,
                                     local_batch=IALS_BATCH,
                                     steps_per_chunk=IALS_STEPS, seed=0))
    return train, test, chunks


def ials_kernel_cases(torch, kernels, cases, chunks, dev):
    """Phase 3 at the iALS step's shapes, from the path's first step: K1's
    pull of the fixed side (items, 16,384 x 16, in the user half; users,
    32,768 x 16, in the item half), B = 65,536, and K2's pushes of the
    solved side's ``A`` (D = 256) and ``b`` (D = 16) accumulators, into
    zeros, keyed by users (uniform) or items (Zipf-skewed); -1 and >= R ids
    mixed in."""
    rng = np.random.default_rng(10)

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    step = {k: v[0] for k, v in chunks[0].items()}
    live = step["weight"] > 0
    sides = {"user": (IALS_USERS, step["user"]),
             "item": (IALS_ITEMS, step["item"])}
    for solve, fixed in (("user", "item"), ("item", "user")):
        rows, ids = sides[fixed]
        table = t(rng.normal(0, 0.3, (rows, IALS_RANK)).astype(np.float32))
        cases["gather_rows"].append(check_gather(
            torch, kernels, f"K1 iALS {solve} half pull, {rows} x "
            f"{IALS_RANK}", kernels.gather_rows_cuda,
            kernels.gather_rows_plain, table, t(mix_dropped(ids, rows)),
            "ials", collect=cases["gather_inputs"]))
        rows, ids = sides[solve]
        ids = t(mix_dropped(np.where(live, ids, -1), rows))
        for name, dim in (("A", IALS_RANK * IALS_RANK), ("b", IALS_RANK)):
            cases["scatter_add"].append(check_scatter(
                torch, f"K2 iALS {solve} half {name} push, D = {dim}",
                kernels.scatter_add_cuda_, kernels.scatter_add_plain,
                torch.zeros((rows, dim), device=dev), ids,
                t(rng.normal(0, 1, (IALS_BATCH, dim)).astype(np.float32)),
                "ials", kernels, cases["k2_inputs"]))


def sketch_spec():
    from fps_tpu_torch.sketch import TugOfWarSpec

    return TugOfWarSpec(depth=SKETCH_DEPTH, width=SKETCH_WIDTH, seed=0)


def sketch_kernel_case(torch, fps, kernels, cases, tokens, uni, dev):
    """Phase 3 at the sketch tap's stack update: K4 into the (16 x 5 x 1,024,
    1) stack (two row tiles: its bucket pass runs), the 409,600 items of the
    w2v block path's first step (the flat bucket of each of its 81,920 pairs
    in each of 5 hash rows, signed 0/1 weights), -1 and >= R ids mixed
    in."""
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.sketch import tow_rows_items

    mesh = fps.make_ps_mesh()
    plan = fps.Word2VecDevicePlan(tokens, uni, w2v_config(fps), mesh,
                                  num_workers=1, block_len=W2V_BLOCK, seed=1,
                                  mode="block")
    batch = {k: v[0] for k, v in plan.call_batches(plan.epoch_args(0), 0,
                                                   1).items()}
    center, ctx, w = w2v.block_pair_stream(batch)
    probe = torch.from_numpy(np.argsort(-uni)[:SKETCH_PROBES].astype(
        np.int32)).to(dev)
    R = SKETCH_PROBES * SKETCH_DEPTH * SKETCH_WIDTH
    flat, vals = tow_rows_items(sketch_spec(), SKETCH_PROBES,
                                w2v._probe_rows(probe, center), ctx, w)
    ids = torch.from_numpy(mix_dropped(flat.reshape(-1).cpu().numpy(),
                                       R)).to(dev)
    cases["scatter_add_dim1"].append(check_k4(
        torch, kernels, dev, f"K4 w2v sketch tap stack {R} x 1, "
        f"{ids.numel()} items", torch.zeros((R, 1), device=dev), ids,
        vals.reshape(-1, 1).contiguous(), "w2v_sketch_tap",
        cases["k4_inputs"]))


def ials_to_target(torch, kernels, label, solver, dev_chunks, train, test,
                   card):
    """A warm-up epoch on throwaway state, then epochs from fresh factors
    until recall@20 on the first 2,000 held-out pairs reaches 0.35 (at most
    8), the launch counters at 0 just before them and read just after: K1
    once and K2 twice a position a half-step (each shard's pull of the
    fixed side; each position's ``A`` and ``b`` pushes). Returns ``(summary,
    epoch)``, ``epoch()`` running one more epoch of the chunks."""
    from fps_tpu_torch.models.ials import recall_at_k

    P = len(solver.mesh.positions)
    half_steps = sum(c["weight"].shape[0] for c in dev_chunks)

    def epoch():
        solver.epoch(lambda: iter(dev_chunks))

    solver.init(99)
    epoch()  # warm-up on throwaway state, as the bench
    solver.init(0)
    epoch_s, recalls = [], []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    for _ in range(IALS_MAX_EPOCHS):
        t0 = time.perf_counter()
        epoch()
        torch.cuda.synchronize()
        epoch_s.append(time.perf_counter() - t0)
        recalls.append(recall_at_k(
            solver, test["user"][:IALS_EVAL], test["item"][:IALS_EVAL], k=20,
            exclude=(train["user"], train["item"])))
        if recalls[-1] >= IALS_TARGET:
            break
    launched = kernels.launch_counts()
    steps = 2 * half_steps * len(epoch_s)
    check_launches(label, launched, {"gather_rows": P, "scatter_add": 2 * P},
                   steps)
    check_finite(torch, label, solver.store.tables, None)
    if not recalls[-1] >= IALS_TARGET:
        raise AssertionError(f"{label}: recall@20 by epoch {recalls}: "
                             f"{IALS_TARGET} not reached in "
                             f"{IALS_MAX_EPOCHS} epochs")
    n = len(train["user"])
    summary = {
        "path": label, "epochs": len(epoch_s),
        "steps_per_epoch": 2 * half_steps, "interactions": n,
        "epoch_seconds": epoch_s, "recall_at_20_by_epoch": recalls,
        "target": IALS_TARGET, "seconds_to_target": sum(epoch_s),
        "interactions_per_s": [n / e for e in epoch_s],
        "ms_per_step": sum(epoch_s) / steps * 1e3,
        "steady_ms_per_step": epoch_s[-1] / (2 * half_steps) * 1e3,
        "launches": launched,
        "launches_per_step": {k: v / steps for k, v in launched.items()
                              if v},
        "mesh": dict(solver.mesh.shape), "card": card}
    return summary, epoch


def ials_path(torch, fps, kernels, train, test, chunks, card):
    """Phase 4, iALS as bench.py run_ials trains it: the chunks uploaded
    once (set-up), then :func:`ials_to_target` on one position (K1 1 and K2
    2 a step). Then, on the trained state, the parts of a half-epoch timed
    apart (CUDA events, the card held: the Gramian, one accumulate step,
    the solve; one step's host time too) and one traced epoch for the
    device's busy share."""
    from fps_tpu_torch.models.ials import ITEM_TABLE

    mesh = fps.make_ps_mesh()
    solver = fps.IALSSolver(mesh, fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))
    t0 = time.perf_counter()
    dev_chunks = [{k: torch.from_numpy(v).to(mesh.device)
                   for k, v in c.items()} for c in chunks]
    torch.cuda.synchronize()
    upload_s = time.perf_counter() - t0
    summary, epoch = ials_to_target(torch, kernels, "iALS, bench.py run_ials",
                                    solver, dev_chunks, train, test, card)

    # The parts of the user half on the trained state (one position: one
    # block each).
    fixed = list(solver.store.tables[ITEM_TABLE])
    gram = solver._gram(fixed, IALS_ITEMS)
    A = [torch.zeros((IALS_USERS, IALS_RANK * IALS_RANK), device=mesh.device)]
    b = [torch.zeros((IALS_USERS, IALS_RANK), device=mesh.device)]
    c0 = dev_chunks[0]
    step = [{"solve_ids": c0["user"][:1], "fixed_ids": c0["item"][:1],
             "rating": c0["rating"][:1], "weight": c0["weight"][:1]}]
    parts = {
        "gram_ms": time_ms(torch, lambda _: solver._gram(fixed, IALS_ITEMS)),
        "step_ms": time_ms(torch, lambda _: solver._accumulate(fixed, A, b,
                                                               step)),
        "step_call_ms": time_ms(torch, lambda _: solver._accumulate(
            fixed, A, b, step), hold=False),
        "solve_ms": time_ms(torch, lambda _: solver._solve(gram, A, b,
                                                           IALS_USERS)),
    }
    summary = dict(summary, upload_seconds=upload_s, parts_held=parts)
    log("path iALS: " + json.dumps(summary))
    traced = traced_ials_epoch(torch, solver, epoch,
                               summary["steps_per_epoch"],
                               summary["epoch_seconds"][-1], card)
    return summary, traced


def traced_ials_epoch(torch, solver, epoch, steps, untraced_s, card):
    """One iALS epoch under ``torch.profiler`` (after a warm-up one): the
    device's busy time a step against the untraced epoch's step."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof = profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
            schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(path))
        with prof:
            for _ in range(2):
                epoch()
                torch.cuda.synchronize()
                prof.step()
        summary = trace_summary.summarize(trace_summary.load(path), steps,
                                          top=20)
    untraced_ms = untraced_s / steps * 1e3
    busy = summary["device_busy_ms_per_step"]
    out = {"path": "iALS (traced epoch)", "steps": steps,
           "untraced_ms_per_step": untraced_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / untraced_ms,
           "device_launches_per_step": summary["device_launches_per_step"],
           "traced_host_ms_per_step": summary["traced_host_ms_per_step"],
           "kernels": summary["kernels"], "card": card}
    log("traced epoch, iALS: " + json.dumps(out))
    return out


def w2v_sketch_path(torch, fps, kernels, tokens, uni, card):
    """Phase 4, the w2v block worker with ``cooccurrence_sketch_tap`` of the
    16 most frequent words (the example's ``--sketch-words 16``), one
    ``run_indexed`` call of an epoch of the phase's corpus from fresh
    tables, the launch counters at 0 just before and read just after: K1 2,
    K2 2 and K4 1 a step. The similarity matrix must be finite with a
    positive diagonal."""
    from fps_tpu_torch.models import word2vec as w2v

    mesh = fps.make_ps_mesh()
    cfg = w2v_config(fps)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    trainer, _ = fps.word2vec_block(
        mesh, cfg, uni, W2V_BLOCK, max_steps_per_call=256,
        step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
    plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                  block_len=W2V_BLOCK, seed=1, mode="block")
    if trainer._indexed_call_steps(plan) != plan.steps_per_epoch:
        raise AssertionError("the sketch path's epoch is not one call")
    tables, local_state = trainer.init_state(0)
    label = "w2v block sync, sketch tap, run_indexed"
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, metrics = trainer.run_indexed(
        tables, local_state, plan, 1, epochs=1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, {"gather_rows": 2, "scatter_add": 2,
                                     "scatter_add_dim1": 1},
                   plan.steps_per_epoch)
    check_finite(torch, label, tables, local_state)
    sims = w2v.sketch_similarity(w2v.accumulate_sketch_taps(metrics))
    if not (np.isfinite(sims).all() and (np.diag(sims) > 0).all()):
        raise AssertionError(f"{label}: similarity {sims} is not finite with "
                             "a positive diagonal")
    summary = {
        "path": label, "steps": plan.steps_per_epoch, "seconds": elapsed,
        "ms_per_step": elapsed / plan.steps_per_epoch * 1e3,
        "words_per_s": len(tokens) / elapsed,
        "probe_words": probe.tolist(),
        "similarity_diagonal": np.diag(sims).tolist(),
        "launches": launched, "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary


def pool_order_topk(scores, k, S):
    """The float64 ranking in the order of the top-k merge's shard-major
    pool: by score, ties by shard (``id % S``), then by row within the
    shard (``id // S``); on one shard, by (-score, id)."""
    ids = np.arange(scores.shape[1])
    return np.stack([np.lexsort((ids // S, ids % S, -r))[:k]
                     for r in scores])


def logical_rows(blocks, S):
    """A table's logical rows (``num_ids`` rows, padding dropped: the
    caller slices) from replica 0's ``S`` blocks, on the host, float64."""
    from fps_tpu_torch.core.store import id_to_phys

    full = np.concatenate([b.cpu().numpy() for b in blocks[:S]]).astype(
        np.float64)
    rps = full.shape[0] // S
    return full[np.asarray(id_to_phys(np.arange(full.shape[0]), S, rps))]


def mf_topk_path(torch, fps, kernels, data, card, mesh=None):
    """MF at ML-20M width with ``make_online_topk_tap`` (k 10, the first 2
    users of every 4th step, every worker): one ``run_chunk`` of 17 steps
    from fresh tables on ``mesh`` (default: one position; phase 4), the
    global batch of 32,768 split over the workers, the launch counters at 0
    just before and read just after (K1 3 a position a step: the item pull,
    the user rows, the tap's query rows; K2 2). On every tapped step each
    worker's ids must equal a float64 brute-force ranking, in the merge's
    pool order (:func:`pool_order_topk`), of that step's live item table
    (copied by a checking collective tap around the port's) for its users;
    the other steps emit -1. Then the same chunk again with the port's tap
    alone, timed (steady ms a step). Returns ``(summary, store,
    local_state)``."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.models import recommendation as rec

    mesh = mesh or fps.make_ps_mesh()
    W, S = fps.num_workers_of(mesh), mesh.shape["shard"]
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01)
    trainer, store = fps.online_mf(mesh, cfg, combine="mean")
    topk = rec.make_online_topk_tap(store, "item_factors", TOPK_K,
                                    every=TOPK_EVERY,
                                    query_fn=rec.mf_topk_query_fn(
                                        W, TOPK_QUERIES))
    seen = {}

    def tap(tables, batches, local_states, t):
        if t % TOPK_EVERY == 0:
            seen[t] = ([b.clone() for b in tables["item_factors"]],
                       torch.cat(list(local_states)).clone())
        return topk(tables, batches, local_states, t)

    tap.collective = True
    trainer.config = dataclasses.replace(trainer.config, step_tap=tap)
    chunk = next(epoch_chunks(data, num_workers=W, local_batch=BATCH // W,
                              steps_per_chunk=TOPK_STEPS, route_key="user",
                              seed=0))
    tables, local_state = trainer.init_state(0)
    label = "MF sync, online top-k tap, run_chunk" + (
        f", mesh {mesh.shape['data']}x{S}" if W > 1 else "")
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    tables, local_state, m = trainer.run_chunk(tables, local_state, chunk, 1)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    launched = kernels.launch_counts()
    check_launches(label, launched, {"gather_rows": 3 * W,
                                     "scatter_add": 2 * W}, TOPK_STEPS)
    check_finite(torch, label, tables, local_state)
    ids = m["tap"]["topk_ids"].cpu().numpy()  # (T, W, q, k)
    users = m["tap"]["topk_query"].cpu().numpy()  # (T, W, q)
    scores = m["tap"]["topk_scores"].cpu().numpy()
    checked = 0
    for t in range(TOPK_STEPS):
        if t not in seen:
            if not ((ids[t] == -1).all() and (users[t] == -1).all()):
                raise AssertionError(f"{label}: step {t} is not tapped but "
                                     "emitted ids")
            continue
        item_blocks, user_rows = seen[t]
        items = logical_rows(item_blocks, S)[:ML20M_ITEMS]
        user_rows = user_rows.cpu().numpy().astype(np.float64)
        for w in range(W):
            valid = users[t, w] >= 0
            q = rec.mf_user_vectors(user_rows, W, users[t, w][valid])
            want = pool_order_topk(q @ items.T, TOPK_K, S)
            if not valid.any() or not np.array_equal(ids[t, w][valid],
                                                      want):
                raise AssertionError(f"{label}: step {t} worker {w} ids "
                                     f"{ids[t, w]} != brute force {want}")
            if not (np.diff(scores[t, w][valid], axis=1) <= 0).all():
                raise AssertionError(f"{label}: step {t} scores not "
                                     "descending")
            checked += int(valid.sum())
    trainer.config = dataclasses.replace(trainer.config, step_tap=topk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tables, local_state, _ = trainer.run_chunk(tables, local_state, chunk, 2)
    torch.cuda.synchronize()
    steady = time.perf_counter() - t0
    summary = {"path": label, "steps": TOPK_STEPS,
               "checked_call_seconds": elapsed,
               "ms_per_step": elapsed / TOPK_STEPS * 1e3,
               "steady_ms_per_step": steady / TOPK_STEPS * 1e3,
               "tapped_steps": sorted(seen), "k": TOPK_K,
               "queries_per_step": TOPK_QUERIES * W,
               "queries_checked": checked, "launches": launched,
               "launches_per_step": {k: v / TOPK_STEPS
                                     for k, v in launched.items() if v},
               "mesh": dict(mesh.shape), "card": card}
    log(f"path {label}: " + json.dumps(summary))
    return summary, store, local_state


def taps_card_vs_cpu(torch, fps):
    """Phase 5 for this slice: a small iALS job (2,000 users, 1,000 items,
    rank 16, 2 epochs) and the w2v block worker with the sketch tap (the
    small corpus of :func:`w2v_card_vs_cpu_jobs`, 2 epochs), each on the
    card and on the CPU from the same tables and seeds. iALS's factors must
    lie within 1e-4 of the largest |value| (the same float32 systems; the
    sums and solves in another order); the tap sums must be equal bit for
    bit (±1 sums of 0/1 weights are exact in any order, and the plan's
    draws are the same on both) and the w2v tables within 1e-5."""
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.models.ials import interaction_chunks
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_implicit(2000, 1000, 20, rank=4, seed=0)
    chunks = list(interaction_chunks(data, num_workers=1, local_batch=4096,
                                     steps_per_chunk=4, seed=0))
    factors, tables0 = {}, None
    for device in ("cpu", "cuda"):
        solver = fps.IALSSolver(fps.make_ps_mesh(device=device),
                                fps.IALSConfig(2000, 1000, rank=IALS_RANK))
        if tables0 is None:
            tables0 = dict(solver.init(7))
        solver.store.tables = on_device(torch, tables0, solver.device)
        for _ in range(2):
            solver.epoch(lambda: iter(chunks))
        factors[device] = solver.factors()
    ials = max(float(np.abs(c - g).max() / np.abs(c).max())
               for c, g in zip(factors["cpu"], factors["cuda"]))
    if not ials <= 1e-4:
        raise AssertionError(f"card vs CPU, iALS: factors differ by {ials} "
                             "of their largest value > 1e-4")
    tokens, vocab, uni = ds.load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    runs, tables0 = {}, None
    for device in ("cpu", "cuda"):
        mesh = fps.make_ps_mesh(device=device)
        trainer, _ = fps.word2vec_block(
            mesh, cfg, uni, 1024, max_steps_per_call=16,
            step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
        if tables0 is None:
            tables0, local0 = trainer.init_state(7)
        tables = on_device(torch, tables0, mesh.device)
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=1,
                                      block_len=1024, seed=5, mode="block")
        tables, _, metrics = trainer.run_indexed(tables, local0, plan, 6,
                                                 epochs=2)
        runs[device] = (on_host(torch, tables),
                        w2v.accumulate_sketch_taps(metrics))
    if not np.array_equal(runs["cpu"][1], runs["cuda"][1]):
        raise AssertionError("card vs CPU, w2v sketch tap: the tap sums "
                             "differ")
    w2v_diff = max(float((runs["cpu"][0][k] - runs["cuda"][0][k]).abs().max())
                   / max(1.0, float(runs["cpu"][0][k].abs().max()))
                   for k in runs["cpu"][0])
    if not w2v_diff <= 1e-5:
        raise AssertionError(f"card vs CPU, w2v with the sketch tap: tables "
                             f"differ by {w2v_diff} > 1e-5")
    out = {"ials_factors": ials, "w2v_sketch_tap_tables": w2v_diff,
           "w2v_sketch_tap_sums_bit_equal": True,
           "w2v_sketch_tap_sum_abs": float(np.abs(runs["cpu"][1]).sum())}
    log("card vs CPU, iALS and the sketch tap: " + json.dumps(out))
    return out


# ---------------------------------------------------------------------------
# The host pipeline (prefetch) and delayed pushes (push_delay).
# ---------------------------------------------------------------------------

class HostProbe:
    """Host seconds by part (``assemble``, ``place``, ``wait``), apart for
    the driver thread and the pipeline's worker; ``add`` is the duck-typed
    timer the prefetcher reports its worker's seconds a chunk to."""

    def __init__(self):
        import threading

        self.lock = threading.Lock()
        self.s = {}

    def part(self, name, seconds):
        import threading

        who = ("driver" if threading.current_thread()
               is threading.main_thread() else "worker")
        with self.lock:
            key = f"{who}_{name}"
            self.s[key] = self.s.get(key, 0.0) + seconds

    def add(self, name, seconds):  # the prefetcher's timer
        with self.lock:
            key = f"timer_{name}"
            self.s[key] = self.s.get(key, 0.0) + seconds

    def host_serial(self):
        """The driver thread's seconds getting each next chunk onto the
        card: assembly plus placement when it does them, the queue wait
        when the pipeline does."""
        return sum(self.s.get(f"driver_{k}", 0.0)
                   for k in ("assemble", "place", "wait"))


def timed_source(chunks, probe):
    """``chunks``, each ``next`` timed as assembly on its thread."""
    it = iter(chunks)
    end = object()
    while True:
        t0 = time.perf_counter()
        item = next(it, end)
        probe.part("assemble", time.perf_counter() - t0)
        if item is end:
            return
        yield item


def probed(probe):
    """A context in which the driver's and the iALS solver's placement and
    prefetcher are timed into ``probe``: placement by thread, the driver
    thread's waits on the pipeline, and the worker's seconds through the
    prefetcher's ``timer``."""
    import contextlib

    from fps_tpu_torch.core import driver, prefetch
    from fps_tpu_torch.models import ials

    base_pf, base_place = prefetch.ChunkPrefetcher, prefetch.place_columns

    class TimedPrefetcher(base_pf):
        def __init__(self, *args, **kw):
            super().__init__(*args, timer=probe, **kw)

        def __next__(self):
            t0 = time.perf_counter()
            try:
                return super().__next__()
            finally:
                probe.part("wait", time.perf_counter() - t0)

    def timed_place(columns, device):
        t0 = time.perf_counter()
        out = base_place(columns, device)
        probe.part("place", time.perf_counter() - t0)
        return out

    @contextlib.contextmanager
    def ctx():
        mods = (driver, ials)
        try:
            for m in mods:
                m.ChunkPrefetcher = TimedPrefetcher
                m.place_columns = timed_place
            yield
        finally:
            for m in mods:
                m.ChunkPrefetcher, m.place_columns = base_pf, base_place

    return ctx()


def prefetch_threads():
    import threading

    return [t.name for t in threading.enumerate()
            if t.name.startswith("fps-prefetch")]


def chunk_marks(torch, obj, method, marks):
    """Record a CUDA event on the compute stream, and the host's clock, as
    each call of ``obj.method`` (one a chunk) begins; the intervals between
    the events are the pipeline's pace on the card's clock."""
    fn = getattr(obj, method)

    def marked(*args, **kw):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((ev, time.perf_counter()))
        return fn(*args, **kw)

    setattr(obj, method, marked)


def steady_ms(marks, steps_per_chunk):
    """Median ms between chunk starts after the first, a step."""
    gaps = [a.elapsed_time(b)
            for (a, _), (b, _) in zip(marks[1:-1], marks[2:])]
    return float(np.median(gaps)) / steps_per_chunk if gaps else None


def ab_arm(torch, kernels, label, depth, run, steps_per_chunk, card):
    """One arm of the A/B: ``run(depth, probe, marks)`` trains and returns
    a function that gives its state (run after the clock stops); the
    counters at 0 just before it and read just after."""
    probe, marks = HostProbe(), []
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    t0 = time.perf_counter()
    with probed(probe):
        state = run(depth, probe, marks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = kernels.launch_counts()
    state = state()
    left = prefetch_threads()
    if left:
        raise AssertionError(f"{label}, prefetch {depth}: threads {left} "
                             "alive after the run")
    serial = probe.host_serial()
    first = marks[0][1] - t0 if marks else None
    out = {"path": f"{label}, prefetch {depth}", "prefetch": depth,
           "chunks": len(marks), "wall_s": wall,
           "to_first_chunk_s": first, "after_first_chunk_s": wall - first,
           "steady_ms_per_step": steady_ms(marks, steps_per_chunk),
           "host_serial_s": serial, "host_serial_share": serial / wall,
           "worker_s": probe.s.get("timer_prefetch", 0.0),
           "host_s_by_part": dict(probe.s), "launches": launched,
           "card": card}
    return out, state


def same_state(torch, label, a, b):
    """Tables, local state and metrics of two arms, bit for bit."""
    (ta, la, ma), (tb, lb, mb) = a, b
    for k in ta:
        if not torch.equal(on_host(torch, ta[k]), on_host(torch, tb[k])):
            raise AssertionError(f"{label}: table {k} differs between arms")
    if (la is not None and la != ()
            and not torch.equal(on_host(torch, la), on_host(torch, lb))):
        raise AssertionError(f"{label}: local state differs between arms")
    for x, y in zip(ma, mb):
        for k in x:
            if not np.array_equal(x[k], y[k]):
                raise AssertionError(f"{label}: metric {k} differs")
    if len(ma) != len(mb):
        raise AssertionError(f"{label}: {len(ma)} and {len(mb)} chunks")


def host_ab(torch, kernels, label, make_trainer, make_chunks, card):
    """bench.py host_pipeline_ab on the port: the same chunk stream (an
    ``islice`` of ``epoch_chunks``, assembled inside the stream) through
    ``fit_stream`` at prefetch 0, then 2, each from fresh state after a
    warm-up of 2 chunks; the arms' tables, local state, metrics and launch
    counts must be equal."""
    import dataclasses
    from itertools import islice

    trainer = make_trainer()
    base = trainer.config
    tables, local = trainer.init_state(7)
    trainer.fit_stream(tables, local, islice(make_chunks(), 2), 8)

    def run(depth, probe, marks):
        trainer.config = dataclasses.replace(base, prefetch=depth)
        trainer.__dict__.pop("run_chunk", None)
        chunk_marks(torch, trainer, "run_chunk", marks)
        tables, local = trainer.init_state(0)
        out = trainer.fit_stream(
            tables, local, timed_source(islice(make_chunks(), AB_CHUNKS),
                                        probe), 1)
        return lambda: out

    arms = [ab_arm(torch, kernels, label, d, run, AB_STEPS, card)
            for d in AB_ORDER]
    trainer.config = base
    return finish_ab(torch, label, arms)


def finish_ab(torch, label, arms):
    """The gates and the summary of the arms, run in ``AB_ORDER``: every
    arm's state and launches equal the first arm's; the overlap ratio and
    the speedup from the summed host-serial seconds and walls of the two
    prefetch-0 and the two prefetch-2 arms (each pair also apart)."""
    (first, a) = arms[0]
    for arm, b in arms[1:]:
        same_state(torch, f"{label}, prefetch {arm['prefetch']}", a, b)
        if arm["launches"] != first["launches"]:
            raise AssertionError(f"{label}: launches {first['launches']} "
                                 f"and {arm['launches']} differ")
    off = [arm for arm, _ in arms if arm["prefetch"] == 0]
    on = [arm for arm, _ in arms if arm["prefetch"] != 0]

    def ratios(off, on):
        serial_off = sum(a["host_serial_s"] for a in off)
        serial_on = sum(a["host_serial_s"] for a in on)
        return {"overlap_ratio": (1.0 - serial_on / serial_off
                                  if serial_off > 0 else None),
                "speedup": (sum(a["wall_s"] for a in off)
                            / sum(a["wall_s"] for a in on)),
                "speedup_after_first_chunk": (
                    sum(a["after_first_chunk_s"] for a in off)
                    / sum(a["after_first_chunk_s"] for a in on))}

    out = dict({"path": label, "arms": [arm for arm, _ in arms],
                "by_pair": [ratios([f], [n]) for f, n in zip(off, on)]},
               **ratios(off, on))
    log(f"host pipeline A/B, {label}: " + json.dumps(out))
    return out


def ials_ab(torch, fps, kernels, train, test, card):
    """The iALS arm: ``IALSSolver.prefetch`` 0, then 2, over host chunks
    (``interaction_chunks``, assembled inside the stream), 2 epochs from the
    same factors after a warm-up epoch; factors bit-equal, recall@20 and
    launch counts equal."""
    from fps_tpu_torch.models.ials import interaction_chunks, recall_at_k

    solver = fps.IALSSolver(fps.make_ps_mesh(), fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))

    def chunks(probe=None):
        c = interaction_chunks(train, num_workers=1, local_batch=IALS_BATCH,
                               steps_per_chunk=IALS_STEPS, seed=0)
        return c if probe is None else timed_source(c, probe)

    solver.init(99)
    solver.epoch(chunks)

    def run(depth, probe, marks):
        solver.prefetch = depth
        solver.__dict__.pop("_accumulate", None)
        chunk_marks(torch, solver, "_accumulate", marks)
        solver.init(0)
        for _ in range(2):
            solver.epoch(lambda: chunks(probe))

        def state():
            recall = recall_at_k(solver, test["user"][:IALS_EVAL],
                                 test["item"][:IALS_EVAL], k=20,
                                 exclude=(train["user"], train["item"]))
            users, items = solver.factors()
            return ({"users": torch.from_numpy(users),
                     "items": torch.from_numpy(items)}, None,
                    [{"recall_at_20": np.array([recall])}])
        return state

    arms = [ab_arm(torch, kernels, "iALS host chunks", d, run, IALS_STEPS,
                   card) for d in AB_ORDER]
    solver.prefetch = 0
    return finish_ab(torch, "iALS host chunks", arms)


def constant_pusher(torch):
    """A worker that pushes ``val`` to ``id`` (``(B, k)`` ids, ``(B, k, D)``
    values): pushes that do not depend on the pulls, so every delivery
    schedule that lands each push once ends with the same table."""
    from fps_tpu_torch.core.api import StepOutput, WorkerLogic

    class ConstantPusher(WorkerLogic):
        def pull_ids(self, batch):
            return {"t": batch["id"].reshape(-1).to(torch.int32)}

        def step(self, batch, pulled, local_state, gen):
            ids = batch["id"].reshape(-1).to(torch.int32)
            vals = batch["val"].reshape(ids.shape[0], -1)
            return StepOutput(pushes={"t": (ids, vals)},
                              local_state=local_state, out={"n": vals.sum()})

    return ConstantPusher()


def delivered_once(torch, fps, kernels, mf_data, lr_data, card):
    """``push_delay`` 1 and 4 against 0 with the constant pusher: a wide
    table (26,744 x 10, B 32,768 Zipf item ids: K1 and K2) and an ``(R, 1)``
    table (1M rows, 16,384 x 39 ids: K5 and K4), 16 steps each; each table
    must end equal to the delay-0 one, within the float32 summation bound
    (bit-equal expected: the same scatter-adds in the same order), and each
    run launch what the delay-0 run launches."""
    from fps_tpu_torch.core.driver import Trainer, TrainerConfig
    from fps_tpu_torch.core.ingest import epoch_chunks

    rng = np.random.default_rng(3)
    n_mf = 16 * BATCH
    cases = {
        "wide K2": (ML20M_ITEMS, RANK, BATCH, {
            "id": mf_data["item"][:n_mf, None],
            "val": rng.normal(0, 1, (n_mf, 1, RANK)).astype(np.float32)}),
        "(R, 1) K4": (LR_NF, 1, SPARSE_BATCH, {
            "id": lr_data["feat_ids"][:16 * SPARSE_BATCH],
            "val": lr_data["feat_vals"][:16 * SPARSE_BATCH, :, None]}),
    }
    out = {}
    mesh = fps.make_ps_mesh()
    for label, (rows, dim, batch, data) in cases.items():
        chunks = list(epoch_chunks(data, num_workers=1, local_batch=batch,
                                   steps_per_chunk=8, seed=1))
        res = {}
        for d in (0, 1, 4):
            store = fps.ParamStore(mesh, [fps.TableSpec("t", rows,
                                                        dim).zeros_init()])
            trainer = Trainer(mesh, store, constant_pusher(torch),
                              config=TrainerConfig(push_delay=d))
            tables, local = trainer.init_state(0)
            torch.cuda.synchronize()
            kernels.reset_launch_counts()
            tables, _, _ = trainer.fit_stream(tables, local, chunks, 1)
            torch.cuda.synchronize()
            res[d] = (tables["t"][0].clone(), kernels.launch_counts())
        base, launched = res[0]
        # Float32 sums of the same terms in any order lie within 2 k eps32
        # sum|terms| of each other, k the row's pushes + 1.
        ids = torch.from_numpy(np.concatenate(
            [c["id"].reshape(-1) for c in chunks])).to(base.device).long()
        vals = torch.from_numpy(np.concatenate(
            [c["val"].reshape(-1, dim) for c in chunks])).to(base.device)
        keep = (ids >= 0) & (ids < rows)
        mag = torch.zeros((rows, dim), dtype=torch.float64,
                          device=base.device).index_add_(
            0, ids[keep], vals[keep].double().abs())
        cnt = torch.zeros(rows, dtype=torch.float64,
                          device=base.device).index_add_(
            0, ids[keep], torch.ones_like(ids[keep], dtype=torch.float64))
        bound = 2 * (cnt + 1)[:, None] * EPS32 * mag
        entry = {"steps": 16, "pushes_per_step": batch * (
            data["id"].shape[1]), "launches_delay_0": launched}
        for d in (1, 4):
            got, got_launched = res[d]
            if got_launched != launched:
                raise AssertionError(
                    f"push_delay {d}, {label}: launches {got_launched}, at "
                    f"delay 0 {launched}")
            diff = (got.double() - base.double()).abs()
            if not bool((diff <= bound).all()):
                raise AssertionError(
                    f"push_delay {d}, {label}: differs from delay 0 past "
                    "the float32 summation bound")
            entry[f"delay_{d}"] = {"bit_equal": bool(torch.equal(got, base)),
                                   "max_abs_diff": float(diff.max())}
        out[label] = entry
    log("push_delay delivered once: " + json.dumps(out))
    return out


def push_delay_learns(torch, fps, kernels, mf_data, runs, card):
    """MF at ML-20M width with ``push_delay = 4`` at half phase 4's learning
    rate (tests/test_staleness.py's recipe), sync and SSP (s = 4), 2 epochs
    of prebuilt host chunks as phase 4's MF, timed beside the same job at
    ``push_delay = 0`` in turns (0, 4, 4, 0) at this position: every run's
    RMSE falls and its tables stay finite, a step launches what phase 4's MF
    step launches (K1 2, K2 2), and the runs at 4 launch what those at 0
    do. Each mode's summary gives the ms a step at 4 over that at 0, by
    pair and over both, and that at 0 over phase 4's (this phase runs after
    phase 5's traces). Returns ``(runs, summaries)``."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    mesh = fps.make_ps_mesh()
    runs_out, out = [], []
    for sync_every in (None, 4):
        cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                           rank=RANK, learning_rate=0.05, reg=0.01)
        chunks = list(multi_epoch_chunks(
            mf_data, 2, num_workers=1, local_batch=BATCH, steps_per_chunk=64,
            route_key="user", sync_every=sync_every, seed=0))
        mode = ("sync" if sync_every is None
                else f"ssp(sync_every={sync_every})")
        turns = []
        for d in AB_ORDER_DELAY:
            trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                       combine="mean", push_delay=d)
            turns.append(run_path(
                torch, kernels, f"MF {mode}, push_delay {d}", trainer,
                chunks, {"gather_rows": 2, "scatter_add": 2}, falling_rmse,
                card))
        at = {d: [t for t, dd in zip(turns, AB_ORDER_DELAY) if dd == d]
              for d in (0, 4)}
        for t in at[4]:
            if t["launches"] != at[0][0]["launches"]:
                raise AssertionError(
                    f"MF {mode}: launches at push_delay 4 {t['launches']}, "
                    f"at 0 {at[0][0]['launches']}")

        def ms(ts):
            return float(np.mean([t["steady_ms_per_step"] for t in ts]))

        phase4 = next(r for r in runs if r["path"] == f"MF {mode}")
        summary = {
            "path": f"MF {mode}, push_delay 4 against 0",
            "order": list(AB_ORDER_DELAY),
            "delay_4_over_0": ms(at[4]) / ms(at[0]),
            "delay_4_over_0_by_pair": [
                a["steady_ms_per_step"] / b["steady_ms_per_step"]
                for a, b in zip(at[4], at[0])],
            "phase4_steady_ms_per_step": phase4["steady_ms_per_step"],
            "delay_0_over_phase4": ms(at[0])
            / phase4["steady_ms_per_step"],
            "card": card}
        log("push_delay 4 beside 0: " + json.dumps(summary))
        runs_out += turns
        out.append(summary)
        del chunks
    return runs_out, out


def pipeline_card_vs_cpu(torch, fps):
    """A small MF job with ``push_delay = 2`` and ``prefetch = 2`` on the
    card and on the CPU from the same tables: the largest difference of
    its tables and local state, relative to max(1, the largest value)."""
    import dataclasses

    from fps_tpu_torch.core.ingest import epoch_chunks
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                       learning_rate=0.1, reg=0.01)
    runs, tables0, local0 = {}, None, None
    for device in ("cpu", "cuda"):
        trainer, _ = fps.online_mf(fps.make_ps_mesh(device=device), cfg,
                                   combine="mean", push_delay=2)
        trainer.config = dataclasses.replace(trainer.config, prefetch=2)
        if tables0 is None:
            tables0, local0 = trainer.init_state(7)
        tables = on_device(torch, tables0, trainer.device)
        local = on_device(torch, local0, trainer.device)
        tables, local, _ = trainer.fit_stream(
            tables, local, epoch_chunks(data, num_workers=1, local_batch=512,
                                        steps_per_chunk=8, route_key="user",
                                        seed=3), 2)
        runs[device] = dict(on_host(torch, tables),
                            local_state=on_host(torch, local))
    worst = 0.0
    for name, want in runs["cpu"].items():
        diff = float((want - runs["cuda"][name]).abs().max())
        worst = max(worst, diff / max(1.0, float(want.abs().max())))
    if not worst <= 1e-5:
        raise AssertionError(f"card vs CPU, MF push_delay 2 prefetch 2: "
                             f"{worst} of the largest value > 1e-5")
    log(f"card vs CPU, MF push_delay 2, prefetch 2: {worst:.3e} of the "
        "largest value")
    return worst


def pipeline_phase(torch, fps, kernels, mf_data, lr_data, ials_train,
                   ials_test, runs, card):
    """The host pipeline and delayed pushes, at full width: (a) the
    prefetch A/B on the MF (bench.py run_mf's), SSP logistic-regression
    (run_logreg's) and iALS arms; (b) push_delay delivered once on K2 and
    K4 tables, and MF with push_delay 4 learning; (c) the card against the
    CPU with push_delay 2 and prefetch 2."""
    from fps_tpu_torch.core.ingest import epoch_chunks

    mesh = fps.make_ps_mesh()
    ab = [
        host_ab(torch, kernels, "MF, bench.py run_mf host arm",
                lambda: fps.online_mf(mesh, fps.MFConfig(
                    num_users=ML20M_USERS, num_items=ML20M_ITEMS, rank=RANK,
                    learning_rate=0.1, reg=0.01), combine="mean")[0],
                lambda: epoch_chunks(mf_data, num_workers=1,
                                     local_batch=BATCH,
                                     steps_per_chunk=AB_STEPS,
                                     route_key="user", seed=5), card),
        host_ab(torch, kernels, "logreg SSP, bench.py run_logreg host arm",
                lambda: fps.logistic_regression(mesh, fps.LogRegConfig(
                    num_features=LR_NF, learning_rate=0.1,
                    dense_features=LR_DENSE), sync_every=8)[0],
                lambda: epoch_chunks(lr_data, num_workers=1, local_batch=4096,
                                     steps_per_chunk=AB_STEPS, sync_every=8,
                                     seed=5), card),
        ials_ab(torch, fps, kernels, ials_train, ials_test, card),
    ]
    once = delivered_once(torch, fps, kernels, mf_data, lr_data, card)
    delay_runs, learns = push_delay_learns(torch, fps, kernels, mf_data, runs,
                                           card)
    worst = pipeline_card_vs_cpu(torch, fps)
    return {"prefetch_ab": ab, "push_delay_delivered_once": once,
            "push_delay_learns": learns, "push_delay_runs": delay_runs,
            "card_vs_cpu": worst}


# ---------------------------------------------------------------------------
# The sharded mesh: meshes of several positions, all on the one card.
# ---------------------------------------------------------------------------

def replicas_equal(torch, mesh):
    """``state_check``: every data replica of each table's shard equals
    replica 0's bit for bit."""
    D, S = mesh.shape["data"], mesh.shape["shard"]

    def check(tables, local_state):
        for name, blocks in tables.items():
            for p in range(S, D * S):
                if not torch.equal(blocks[p], blocks[p % S]):
                    raise AssertionError(
                        f"mesh {D}x{S}: table {name}, position {p} differs "
                        f"from replica 0 of shard {p % S}")
        return {"replicas": D, "replicas_bit_equal": True}
    return check


def mesh_card_vs_cpu(torch, fps, shapes):
    """Small MF jobs (sync and SSP, run_indexed) on each mesh, on the card
    and on the CPU from the same state; the largest difference of the
    tables and the local state, relative to max(1, the largest value)."""
    from fps_tpu_torch.utils import datasets as ds

    data = ds.synthetic_ratings(300, 200, 20_000, seed=5)
    cfg = fps.MFConfig(num_users=300, num_items=200, rank=RANK,
                       learning_rate=0.1, reg=0.01)
    worst = {}
    for D, S in shapes:
        for sync_every in (None, 4):
            runs, tables0, local0 = {}, None, None
            for device in ("cpu", "cuda:0"):
                mesh = fps.make_ps_mesh(S, D, device=device)
                trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                           combine="mean")
                if tables0 is None:
                    tables0, local0 = trainer.init_state(7)
                plan = fps.DeviceEpochPlan(
                    fps.DeviceDataset(mesh, data), num_workers=D * S,
                    local_batch=512 // (D * S), route_key="user", seed=3,
                    sync_every=sync_every)
                tables, local, _ = trainer.run_indexed(
                    on_device(torch, tables0, mesh.device),
                    on_device(torch, local0, mesh.device), plan, 2,
                    epochs=2)
                runs[device] = dict(on_host(torch, tables),
                                    local_state=on_host(torch, local))
            job = f"MF {'sync' if sync_every is None else 'SSP'} {D}x{S}"
            worst[job] = max(
                float((want - runs["cuda:0"][k]).abs().max())
                / max(1.0, float(want.abs().max()))
                for k, want in runs["cpu"].items())
    log("card vs CPU on the mesh: " + json.dumps(worst))
    for job, diff in worst.items():
        if not diff <= 1e-5:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 "value > 1e-5")
    return worst


def dense_vs_gathered(torch, fps, kernels, card):
    """The dense and the gathered push of one MF item push (B = 32,768
    Zipf(0.8) ids over 4 workers) into the ML-20M item table on a (1, 4)
    mesh of the card: within the float32 summation bound of a float64 sum
    of each other, K2 once a position on either route; each route's time
    (CUDA events, median of 10, host launches included)."""
    from fps_tpu_torch.core import store as st

    D, S, W = 1, 4, 4
    mesh = fps.make_ps_mesh(S, D, device="cuda:0")
    store = fps.ParamStore(mesh, [fps.TableSpec("t", ML20M_ITEMS, RANK)])
    blocks = list(store.init(0)["t"])
    rng = np.random.default_rng(11)
    ids = path_ids(rng, ML20M_ITEMS, BATCH, True)
    ids[::97] = -1
    dev = mesh.device
    tid = torch.from_numpy(ids).to(dev)
    dl = torch.from_numpy(rng.normal(0, 1e-2, (BATCH, RANK)).astype(
        np.float32)).to(dev)
    wid, wdl = list(torch.chunk(tid, W)), list(torch.chunk(dl, W))
    out, times = {}, {}
    for dense in (False, True):
        torch.cuda.synchronize()
        kernels.reset_launch_counts()
        got = st.push(blocks, wid, wdl, num_shards=S, dense=dense)
        torch.cuda.synchronize()
        launched = kernels.launch_counts()
        if launched["scatter_add"] != W or sum(launched.values()) != W:
            raise AssertionError(f"dense={dense}: launches {launched}, "
                                 f"expected K2 {W}")
        out[dense] = torch.cat(got)
        times[dense] = time_ms(torch, lambda _: st.push(
            blocks, wid, wdl, num_shards=S, dense=dense), hold=False,
            reps=10, warmup=2)
    table = torch.cat(blocks).double()
    rps = blocks[0].shape[0]
    keep = (tid >= 0) & (tid < S * rps)
    phys = st.id_to_phys(tid[keep].long(), S, rps)
    mag = table.abs().index_add_(0, phys, dl[keep].double().abs())
    count = torch.zeros(table.shape[0], dtype=torch.float64,
                        device=dev).index_add_(
        0, phys, torch.ones_like(phys, dtype=torch.float64))
    bound = 2 * (count + 1)[:, None] * EPS32 * mag
    diff = (out[True].double() - out[False].double()).abs()
    if not bool((diff <= bound).all()):
        raise AssertionError("dense vs gathered push: beyond the float32 "
                             f"bound by {float((diff - bound).max())}")
    res = {"shape": f"{ML20M_ITEMS}x{RANK}, B {BATCH}, mesh 1x4",
           "max_abs_diff": float(diff.max()),
           "bit_equal": bool(torch.equal(out[True], out[False])),
           "gathered_ms": times[False], "dense_ms": times[True],
           "card": card}
    log("dense vs gathered push: " + json.dumps(res))
    return res


def mesh_phase(torch, fps, kernels, mf_data, pa_data, pa_q, w2v_tokens,
               w2v_uni, ials_train, ials_test, ials_chunks, card):
    """The sharded mesh on the one card, every launch counter at 0 just
    before each run and read just after: MF at ML-20M width
    (``load_movielens(None, "20m")``'s data, phase 4's rank, the global
    batch of phase 4 split over the workers) through ``run_indexed``, one
    epoch sync and one SSP (s = 4), on a (1, 1), a (1, 4) and a (2, 2)
    mesh whose positions are all ``cuda:0`` (K1 2 and K2 2 a position a
    step: the shard's gather and the worker's user gather, the shard's
    count-column scatter and the worker's user scatter), the data replicas
    bit-equal; binary PA-I at (1, 4) (K5 and K4 once a position a step: no
    mesh of more than one position keeps the head prefix); word2vec at
    (1, 4) and (2, 2) (:func:`w2v_mesh_runs`), iALS at (1, 4)
    (:func:`ials_mesh_run`), MF with the online top-k tap at (1, 4) and
    ``recommend_topk`` over its item table; the dense against the gathered
    push at 4 shards; and small jobs of every family on both meshes, card
    against CPU. The positions share one card: the times measure what the
    single controller's launches cost, not scaling."""
    from fps_tpu_torch.core.ingest import multi_epoch_chunks

    runs = []
    for D, S in ((1, 1),) + MESH_SHAPES:
        W = D * S
        mesh = fps.make_ps_mesh(S, D, device="cuda:0")
        for sync_every in (None, 4):
            cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                               rank=RANK, learning_rate=0.1, reg=0.01)
            trainer, _ = fps.online_mf(mesh, cfg, sync_every=sync_every,
                                       combine="mean", max_steps_per_call=64)
            mode = ("sync" if sync_every is None
                    else f"ssp(sync_every={sync_every})")
            runs.append(run_indexed_path(
                torch, fps, kernels, f"MF {mode}, mesh {D}x{S}, run_indexed",
                trainer, mf_data, "user", BATCH // W, 1,
                {"gather_rows": 2 * W, "scatter_add": 2 * W}, falling_rmse,
                card, 64, state_check=replicas_equal(torch, mesh)))
    mesh = fps.make_ps_mesh(4, 1, device="cuda:0")
    cfg = fps.PAConfig(num_features=PA_NF, variant="PA-I", C=1.0,
                       hot_features=PA_HEAD, head_prefix_cols=pa_q)
    trainer, _ = fps.passive_aggressive(mesh, cfg)
    runs.append(run_path(
        torch, kernels, "PA-I binary, mesh 1x4", trainer,
        list(multi_epoch_chunks(pa_data, 2, num_workers=4,
                                local_batch=SPARSE_BATCH // 4,
                                steps_per_chunk=7, seed=1)),
        {"gather_rows_dim1": 4, "scatter_add_dim1": 4},
        below("mistakes", 0.5), card))
    runs += w2v_mesh_runs(torch, fps, kernels, w2v_tokens, w2v_uni, card)
    runs.append(ials_mesh_run(torch, fps, kernels, ials_train, ials_test,
                              ials_chunks, card))
    topk, store, local_state = mf_topk_path(
        torch, fps, kernels, mf_data, card,
        mesh=fps.make_ps_mesh(4, 1, device="cuda:0"))
    runs.append(topk)
    recommend = recommend_topk_check(torch, fps, kernels, store, local_state,
                                     card)
    dense = dense_vs_gathered(torch, fps, kernels, card)
    worst = dict(mesh_card_vs_cpu(torch, fps, MESH_SHAPES),
                 **mesh_models_card_vs_cpu(torch, fps, MESH_SHAPES))
    steps = {r["path"]: {"ms_per_step": r["ms_per_step"],
                         "steady_ms_per_step": r["steady_ms_per_step"],
                         "launches_per_step": r["launches_per_step"]}
             for r in runs}
    for path, entry in steps.items():
        log(f"mesh phase, {path}: {entry['steady_ms_per_step']:.3f} ms a "
            f"step (steady), launches a step {entry['launches_per_step']} "
            f"({card})")
    return {"runs": runs, "per_step": steps, "dense_vs_gathered": dense,
            "recommend_topk": recommend, "card_vs_cpu": worst, "card": card}


def reshard(torch, src, dst):
    """``dst``'s tables set to ``src``'s (their logical rows, through the
    host): the owner-major layout depends on the shard count."""
    from fps_tpu_torch.core.store import id_to_phys, padded_rows

    for name, spec in dst.specs.items():
        S = dst.num_shards
        full = np.zeros((padded_rows(spec.num_ids, S), spec.dim), np.float32)
        ids = np.arange(spec.num_ids)
        full[np.asarray(id_to_phys(ids, S, full.shape[0] // S))] = \
            src.lookup_host(name, ids)
        dst.put(name, torch.from_numpy(full).to(dst.mesh.device))
    return dict(dst.tables)


def w2v_mesh_runs(torch, fps, kernels, tokens, uni, card):
    """Phase 7, word2vec's block worker at phase 4's text8 width on the
    phase's corpus, through ``Word2VecDevicePlan(num_workers=W)`` and
    ``run_indexed``, every worker a block of 8,192 tokens a step: at (1, 4)
    two warm-up epochs from fresh tables (SGNS from a zero OUT table moves
    the loss a pair by about 1e-5 an epoch at first, phase 4's reading),
    then one sync epoch; at (2, 2) one
    SSP epoch (s = 4) from where (1, 4) ended (the tables laid out again for
    two shards). Counters at 0 just before each counted epoch, read just
    after: K1 2 and K2 2 a position a step; the loss falls as
    :func:`w2v_learns` requires, the (2, 2) data replicas bit-equal."""
    cfg = w2v_config(fps)
    runs, src = [], None
    for (D, S), sync_every in (((1, 4), None), ((2, 2), 4)):
        W = D * S
        mesh = fps.make_ps_mesh(S, D, device="cuda:0")
        trainer, store = fps.word2vec_block(mesh, cfg, uni, W2V_BLOCK,
                                            sync_every=sync_every,
                                            max_steps_per_call=256)
        plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh, num_workers=W,
                                      block_len=W2V_BLOCK, seed=1,
                                      sync_every=sync_every, mode="block")
        if src is None:
            tables, local = trainer.init_state(0)
            tables, local, _ = trainer.run_indexed(tables, local, plan, 0,
                                                   start_epoch=1, epochs=2)
            state = (tables, local)
        else:
            state = (reshard(torch, src, store), ())
        mode = "sync" if sync_every is None else f"ssp(sync_every={sync_every})"
        summary, (tables, local) = run_w2v(
            torch, kernels, f"w2v block {mode}, mesh {D}x{S}, run_indexed",
            trainer, plan, 1, {"gather_rows": 2 * W, "scatter_add": 2 * W},
            len(tokens), card, state)
        summary = dict(summary, mesh=dict(mesh.shape),
                       state=replicas_equal(torch, mesh)(tables, local),
                       launches_per_step={
                           k: v / summary["steps_run"]
                           for k, v in summary["launches"].items() if v})
        runs.append(summary)
        src = store
    return runs


def ials_mesh_run(torch, fps, kernels, train, test, chunks, card):
    """Phase 7, iALS at bench.py run_ials's width on a (1, 4) mesh: phase
    4's chunks (a global batch of 65,536 a step), each step's columns cut
    over the 4 workers, :func:`ials_to_target` (K1 1 and K2 2 a position a
    half-step)."""
    mesh = fps.make_ps_mesh(4, 1, device="cuda:0")
    solver = fps.IALSSolver(mesh, fps.IALSConfig(
        num_users=IALS_USERS, num_items=IALS_ITEMS, rank=IALS_RANK,
        alpha=40.0, reg=0.1))
    dev_chunks = [{k: torch.from_numpy(v).to(mesh.device)
                   for k, v in c.items()} for c in chunks]
    summary, _ = ials_to_target(torch, kernels, "iALS, bench.py run_ials, "
                                "mesh 1x4", solver, dev_chunks, train, test,
                                card)
    log("path iALS, mesh 1x4: " + json.dumps(summary))
    return summary


def recommend_topk_check(torch, fps, kernels, store, local_state, card):
    """``recommend_topk`` for the first 64 users' factors against the
    store's item table (4 shards of ML-20M's after the top-k path's MF):
    ids equal to the float64 brute force in the merge's pool order; the
    call's time (host clock around it, synchronised), median of 10."""
    from fps_tpu_torch.models import recommendation as rec

    W, S = fps.num_workers_of(store.mesh), store.num_shards
    users = np.arange(64)
    q = rec.mf_user_vectors(local_state.numpy(), W, users)
    items = logical_rows(list(store.tables["item_factors"]), S)[:ML20M_ITEMS]
    want = pool_order_topk(q.astype(np.float64) @ items.T, TOPK_K, S)
    torch.cuda.synchronize()
    kernels.reset_launch_counts()
    times = []
    for _ in range(10):
        t0 = time.perf_counter()
        ids, scores = rec.recommend_topk(store, "item_factors", q, TOPK_K)
        times.append(time.perf_counter() - t0)
    if not np.array_equal(ids, want):
        raise AssertionError(f"recommend_topk at {S} shards: ids != brute "
                             "force")
    out = {"path": f"recommend_topk, {len(users)} queries, {S} shards",
           "queries": len(users), "k": TOPK_K, "ids_equal_brute_force": True,
           "call_ms": float(np.median(times)) * 1e3,
           "launches": kernels.launch_counts(),
           "mesh": dict(store.mesh.shape), "card": card}
    log("recommend_topk on the mesh: " + json.dumps(out))
    return out


def mesh_models_card_vs_cpu(torch, fps, shapes):
    """Small jobs on each mesh, on the card and on the CPU from the same
    state: the w2v block worker with the sketch tap (:func:`w2v_card_vs_cpu_
    jobs`'s corpus, blocks of 256 a worker, 2 epochs; tables within 1e-5 of
    their largest value, tap sums bit for bit), iALS (2,000 users, 1,000
    items, rank 16, 2 epochs; factors within 1e-4) and ``recommend_topk``
    over a small-integer table (exact scores: ids and scores equal)."""
    from fps_tpu_torch.models import recommendation as rec
    from fps_tpu_torch.models import word2vec as w2v
    from fps_tpu_torch.models.ials import interaction_chunks
    from fps_tpu_torch.utils import datasets as ds

    tokens, vocab, uni = ds.load_text8(None, 2000, 60_000, seed=4)
    cfg = fps.W2VConfig(vocab_size=vocab, dim=32, subsample_t=1e-3,
                        learning_rate=0.1)
    probe = np.argsort(-uni)[:SKETCH_PROBES].astype(np.int32)
    idata = ds.synthetic_implicit(2000, 1000, 20, rank=4, seed=0)
    rng = np.random.default_rng(2)
    items = rng.integers(-3, 4, (1000, 8)).astype(np.float32)
    queries = rng.integers(-2, 3, (64, 8)).astype(np.float32)
    worst = {}
    for D, S in shapes:
        W = D * S
        out = {}
        for device in ("cpu", "cuda:0"):
            mesh = fps.make_ps_mesh(S, D, device=device)
            trainer, _ = fps.word2vec_block(
                mesh, cfg, uni, 256, max_steps_per_call=16,
                step_tap=w2v.cooccurrence_sketch_tap(sketch_spec(), probe))
            tables, local = trainer.init_state(7)
            plan = fps.Word2VecDevicePlan(tokens, uni, cfg, mesh,
                                          num_workers=W, block_len=256,
                                          seed=5, mode="block")
            tables, _, metrics = trainer.run_indexed(tables, local, plan, 6,
                                                     epochs=2)
            solver = fps.IALSSolver(mesh, fps.IALSConfig(2000, 1000,
                                                         rank=IALS_RANK))
            solver.init(7)
            chunks = list(interaction_chunks(idata, num_workers=W,
                                             local_batch=4096 // W,
                                             steps_per_chunk=4, seed=0))
            for _ in range(2):
                solver.epoch(lambda: iter(chunks))
            store = fps.ParamStore(mesh, [fps.TableSpec("items", 1000, 8)])
            store.put("items", torch.from_numpy(np.concatenate(
                [items[s::S] for s in range(S)])).to(mesh.device))
            out[device] = (on_host(torch, tables),
                           w2v.accumulate_sketch_taps(metrics),
                           solver.factors(),
                           rec.recommend_topk(store, "items", queries, 10))
        cpu, card = out["cpu"], out["cuda:0"]
        job = f"{D}x{S}"
        worst[f"w2v block, sketch tap {job}"] = max(
            float((cpu[0][k] - card[0][k]).abs().max())
            / max(1.0, float(cpu[0][k].abs().max())) for k in cpu[0])
        if not np.array_equal(cpu[1], card[1]):
            raise AssertionError(f"card vs CPU, w2v sketch tap {job}: the "
                                 "tap sums differ")
        worst[f"iALS {job}"] = max(
            float(np.abs(c - g).max() / np.abs(c).max())
            for c, g in zip(cpu[2], card[2]))
        for c, g in zip(cpu[3], card[3]):
            if not np.array_equal(c, g):
                raise AssertionError(f"card vs CPU, recommend_topk {job}: "
                                     "ids or scores differ")
    log("card vs CPU, word2vec, iALS and top-k on the mesh: "
        + json.dumps(worst))
    for job, diff in worst.items():
        tol = 1e-4 if job.startswith("iALS") else 1e-5
        if not diff <= tol:
            raise AssertionError(f"card vs CPU, {job}: {diff} of the largest "
                                 f"value > {tol}")
    return dict(worst, w2v_sketch_tap_sums_bit_equal=True,
                recommend_topk_equal=True)


def path_sums(cases, path, copy=False):
    """A kernel's times summed over its shapes on one path (a step's)."""
    own = [c for c in cases if c["path"] == path]
    keys = ["ms", "call_ms", "plain_ms", "library_ms", "bound_ms"]
    out = {k: sum(c[k] for c in own) for k in keys + (["copy_ms"] if copy
                                                      else [])}
    if not copy:
        out["sort_ms"] = sum(c["sort_ms"] for c in own)
        out["torch_sort_ms"] = sum(c["torch_sort_ms"] for c in own)
    out["shapes"] = [c["shape"] for c in own]
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this test runs on the "
              "card only", file=sys.stderr)
        return 2
    try:
        import fps_tpu_torch as fps
        from fps_tpu_torch.ops import _build, kernels
        from fps_tpu_torch.utils import datasets as ds
    except ImportError as e:
        print(f"chip_smoke: run from a checkout of the repository ({e})",
              file=sys.stderr)
        return 2
    # Full float32 matmuls (the default, stated): TF32 would change the
    # models' dot products and the card-vs-CPU comparison with them.
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    # 1. Environment.
    card = nvidia_smi_line()
    log(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}")
    log(card)

    # 2. Build.
    t0 = time.perf_counter()
    _build.library()
    log(f"built {os.path.relpath(_build.build_info['path'], ROOT)} from "
        f"{[os.path.relpath(s, ROOT) for s in _build.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s (nvcc "
        f"{_build.build_info['seconds']:.2f} s, cached: "
        f"{_build.build_info['cached']})")
    for line in _build.build_info.get("log", "").splitlines():
        if "registers" in line or "==" in line:
            log("  " + line.strip())

    # The sparse workloads' data, as bench.py makes it (seeds 3, 5, 0).
    t0 = time.perf_counter()
    pa_data = ds.synthetic_sparse_classification(PA_NEX, PA_NF, PA_NNZ,
                                                 seed=3, noise=0.05)
    pa_data["label"] = np.where(pa_data["label"] > 0, 1.0,
                                -1.0).astype(np.float32)
    pa_data, pa_q = ds.head_sort_slots(pa_data, PA_HEAD)
    mc_data = ds.synthetic_sparse_multiclass(PA_MC_NEX, PA_NF, PA_MC_CLASSES,
                                             PA_NNZ, seed=5)
    lr_data = ds.synthetic_sparse_classification(
        LR_NEX, LR_NF, LR_NNZ, seed=0, noise=0.05, dense_features=LR_DENSE)
    lr_data["label"] = (lr_data["label"] > 0).astype(np.float32)
    log(f"sparse data made in {time.perf_counter() - t0:.1f} s; PA head "
        f"prefix q = {pa_q} columns of {PA_NNZ}")
    # word2vec's corpus, as bench.py run_w2v makes it (load_text8 with no
    # file: the synthetic Zipfian stream), cut to 2M tokens.
    t0 = time.perf_counter()
    w2v_tokens, _, w2v_uni = ds.load_text8(None, W2V_VOCAB, W2V_TOKENS)
    log(f"text8-size corpus ({W2V_TOKENS} tokens, vocab {W2V_VOCAB}) made "
        f"in {time.perf_counter() - t0:.1f} s")
    # iALS's interactions and chunks, as bench.py run_ials makes them.
    t0 = time.perf_counter()
    ials_train, ials_test, ials_chunks = ials_data(ds)
    log(f"iALS data ({len(ials_train['user'])} training interactions, "
        f"{len(ials_chunks)} chunks) made in {time.perf_counter() - t0:.1f} s")

    # 3. Kernels against their plain versions at the paths' shapes.
    cases = kernel_phase(torch, kernels, pa_data, pa_q, mc_data, lr_data,
                         dev)
    w2v_kernel_cases(torch, kernels, cases,
                     w2v_first_step_ids(torch, fps, w2v_tokens, w2v_uni),
                     dev)
    ials_kernel_cases(torch, kernels, cases, ials_chunks, dev)
    sketch_kernel_case(torch, fps, kernels, cases, w2v_tokens, w2v_uni, dev)
    k2_inputs = cases.pop("k2_inputs")
    k3_inputs = cases.pop("k3_inputs")
    k4_inputs = cases.pop("k4_inputs")
    gather_inputs = cases.pop("gather_inputs")
    split = cases.pop("split")
    sort_cases, sort_inputs = sort_edges(torch, kernels, dev)

    sweep = crossover_sweep(torch, kernels, dev)

    # 4. The paths at full width, counters at 0 just before each.
    w2v_runs = w2v_paths(torch, fps, kernels, w2v_tokens, w2v_uni, card)
    w2v_runs.append(w2v_sketch_path(torch, fps, kernels, w2v_tokens, w2v_uni,
                                    card))
    ials_run, traced_ials = ials_path(torch, fps, kernels, ials_train,
                                      ials_test, ials_chunks, card)
    w2v_runs.append(ials_run)
    runs, traced, mf_data = paths_phase(torch, fps, kernels, pa_data, pa_q,
                                        mc_data, lr_data, card)
    runs += w2v_runs
    traced_w2v = traced_w2v_epoch(torch, fps, w2v_tokens, w2v_uni, card)


    # 5. The card against the CPU.
    worst = card_vs_cpu(torch, fps)
    taps_worst = taps_card_vs_cpu(torch, fps)
    breakdown, sort_traced = k2_breakdown(torch, kernels, k2_inputs,
                                          sort_inputs)
    k3_traced = k3_breakdown(torch, kernels, k3_inputs)
    k4_traced = k4_breakdown(torch, kernels, k4_inputs)
    gather_traced = gather_breakdown(torch, gather_inputs)
    del k2_inputs, sort_inputs, k3_inputs, k4_inputs, gather_inputs

    # 6. The host pipeline and delayed pushes, counters at 0 before each.
    # It runs after phase 5's traces: its times compare runs made inside
    # it, in turns, never with a phase that ran before the profiler.
    pipeline = pipeline_phase(torch, fps, kernels, mf_data, lr_data,
                              ials_train, ials_test, runs, card)

    # 7. The sharded mesh, counters at 0 before each run.
    mesh = mesh_phase(torch, fps, kernels, mf_data, pa_data, pa_q,
                      w2v_tokens, w2v_uni, ials_train, ials_test, ials_chunks,
                      card)
    del mf_data, ials_chunks
    runs += [dict(arm, path=f"{arm['path']}, arm {i}")
             for ab in pipeline["prefetch_ab"]
             for i, arm in enumerate(ab["arms"])]
    runs += pipeline.pop("push_delay_runs")
    runs += mesh["runs"]
    launches = {name: sum(r["launches"][name] for r in runs)
                for name in kernels.WRAPPERS}
    log(f"launch counters over the paths: {launches}")
    for case in sort_cases:
        case["sort_passes"] = sort_traced[case["shape"]]["sort_passes"]
    # Both devices read exactly. The CPU folds each row's pushes one by one
    # in batch order (index_add_); on the card K2 sums each row's pushes in
    # a fixed tree order (a scan within tiles of sorted positions, then
    # across the tiles) and adds the sum into the row once, and K3 and K4
    # sum each row's pushes in a fixed tree a batch of 1,024, the batches in
    # order within a block's share, then across a cluster's blocks and the
    # clusters in order. So a row's sum differs from the CPU's by a few
    # float32 roundings of its terms each push. The card and the CPU also order dot products and row
    # sums differently (about one rounding each). PA's and the logistic
    # loss's steps are continuous in the weights, and so are SGNS's (whose
    # draws, a hash of seeds and counters, are the same on both devices),
    # so these differences stay
    # near a few ulps of the largest value over the ~30 steps of each job
    # (about 1e-6 relative); 1e-5 of the largest value leaves a margin and
    # still catches a wrong row or a dropped push (a push moves a weight by
    # 1e-4 to 1e-2 of its size here).
    tol = 1e-5
    for job, diff in worst.items():
        if not diff <= tol:
            raise AssertionError(f"card vs CPU, {job}: tables differ by "
                                 f"{diff} of their largest value > {tol}")
    log(f"card vs CPU: tables agree within {tol} of their largest value "
        f"({json.dumps(worst)})")

    # 8. Summary lines. Each entry's times are per step of its first path
    # (K1 / K2: one MF step; K5 / K4: one binary PA step, head and tail;
    # K3: one MF step with hot_items, the item head); every shape is listed
    # under per_shape with the path it belongs to.
    def entry(name, source, replaces, first_path):
        own = [c for c in cases[name] if c["path"] == first_path]
        return {
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[name],
            "launches_by_path": {r["path"]: r["launches"][name]
                                 for r in runs},
            "max_abs_err": max(c["max_abs_err"] for c in cases[name]),
            "ms": sum(c["ms"] for c in own),
            "call_ms": sum(c["call_ms"] for c in own),
            "plain_ms": sum(c["plain_ms"] for c in own),
            "bound_ms": sum(c["bound_ms"] for c in own),
            "bound_by": "bytes",
            "library_ms": sum(c["library_ms"] for c in own),
            "per_step_of": first_path,
            "per_shape": cases[name],
        }

    src = "fps_tpu_torch/ops/csrc/"
    pallas = "fps_tpu/ops/pallas_kernels.py"
    def gather_entry(name, source, replaces, first_path):
        traced = {label: b for label, b in gather_traced.items()
                  if label.startswith("K1" if name == "gather_rows" else "K5")}
        return dict(entry(name, source, replaces, first_path),
                    copy_ms=sum(c["copy_ms"] for c in cases[name]
                                if c["path"] == first_path),
                    traced_by_shape=traced)

    # K1's and K2's times a step of the w2v paths (the block path's two
    # pulls or pushes; the pairs path's, off the main path) and of the iALS
    # path (a pull and two pushes of each half's step, summed over both
    # halves: two steps' worth).
    w2v_steps = {k: {p: path_sums(cases[k], p, copy=k == "gather_rows")
                     for p in ("w2v_block", "w2v_pairs")}
                 for k in ("gather_rows", "scatter_add")}
    ials_steps = {k: path_sums(cases[k], "ials", copy=k == "gather_rows")
                  for k in ("gather_rows", "scatter_add")}
    line = {"kernels": [
        dict(gather_entry("gather_rows", src + "gather_rows.cu",
                          pallas + ":513", "mf"),
             w2v_per_step=w2v_steps["gather_rows"],
             ials_two_half_steps=ials_steps["gather_rows"]),
        dict(entry("scatter_add", src + "scatter_add.cu", pallas + ":112",
                   "mf"), w2v_per_step=w2v_steps["scatter_add"],
             ials_two_half_steps=ials_steps["scatter_add"],
             sort={"source": src + "radix_sort.cu",
                   "passes_by_shape": {label: b["sort_passes"]
                                       for label, b in breakdown.items()},
                   "ms": sum(c["sort_ms"] for c in cases["scatter_add"]
                             if c["path"] == "mf"),
                   "torch_sort_ms": sum(
                       c["torch_sort_ms"] for c in cases["scatter_add"]
                       if c["path"] == "mf"),
                   "off_path": sort_cases},
             traced_by_shape=breakdown),
        gather_entry("gather_rows_dim1", src + "gather_rows_dim1.cu",
                     pallas + ":429", "pa_binary"),
        dict(entry("scatter_add_dim1", src + "scatter_add_dim1.cu",
                   pallas + ":338", "pa_binary"),
             bucket_pass={
                 "ms_by_shape": {c["shape"]: c["sort_ms"]
                                 for c in cases["scatter_add_dim1"]},
                 "torch_sort_ms_by_shape": {
                     c["shape"]: c["torch_sort_ms"]
                     for c in cases["scatter_add_dim1"]}},
             sketch_tap_per_step=path_sums(cases["scatter_add_dim1"],
                                           "w2v_sketch_tap"),
             traced_by_shape=k4_traced),
        dict(entry("scatter_add_packed", src + "scatter_add_packed.cu",
                   pallas + ":178", "mf_hot"),
             traced_by_shape=k3_traced, split_end_to_end=split,
             crossover_sweep=sweep),
    ], "paths": runs, "traced_mf_run_indexed": traced,
        "traced_w2v_run_indexed": traced_w2v,
        "traced_ials_epoch": traced_ials, "card_vs_cpu": worst,
        "host_pipeline_and_push_delay": pipeline,
        "card_vs_cpu_ials_and_sketch_tap": taps_worst,
        "sharded_mesh": {k: v for k, v in mesh.items() if k != "runs"},
        "pa_head_prefix_cols": pa_q,
        "seconds": time.perf_counter() - t_start, "card": card}
    log(card)
    log(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
