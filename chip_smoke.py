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
   32,768. K4's bucket pass by row tile,
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
   Each must learn: MF's train RMSE falls; over the last chunk PA's mistake
   rate lies below 0.5 (20 classes: 0.95) and the logistic log loss below
   0.693;
5. runs small MF, head-prefix PA and SSP logistic-regression jobs, and
   run_indexed jobs of MF with ``hot_items`` and 20-class PA with
   ``hot_features``, on the card and on the CPU from the same tables and
   compares the tables; then traces 10 K2 calls at each of its path shapes
   (``torch.profiler``) for the device time and launches of each kernel K2
   launches, which must be 3 a sort pass plus 2, 10 calls of the sort
   alone at each sort edge, 3 kernels a pass, 10 K3 calls at each K3
   shape, its slice pass once a call and its fold pass once more where the
   plan has more than one cluster, 10 K4 calls at each K4 shape, whose
   kernels a call (the bucket pass's count and scatter where the plan has
   buckets, the tile pass, the fold where it has more than one cluster)
   must be what ``dim1_plan`` counts, and 10 K1 and K5 calls at each of
   their path shapes, one kernel a call;
6. prints one JSON line describing every ported kernel, then, as the last
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
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
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
    g5, s4 = kernels.gather_rows_dim1_cuda, kernels.scatter_add_dim1_cuda_
    g5p, s4p = kernels.gather_rows_dim1_plain, kernels.scatter_add_dim1_plain
    cases = {"gather_rows": [], "scatter_add": [], "gather_rows_dim1": [],
             "scatter_add_dim1": [], "scatter_add_packed": [], "split": []}
    k2_inputs = cases["k2_inputs"] = []
    k3_inputs = cases["k3_inputs"] = []
    k4_inputs = cases["k4_inputs"] = []
    gather_inputs = cases["gather_inputs"] = []

    def k4_case(label, view, ids, dl, path):
        """K4 at one shape, with its plan and, where the plan has one, its
        bucket pass held to its plain version and timed alone."""
        R = view.shape[0]
        plan = kernels.card_dim1_plan(dev, ids.numel(), R)
        bucket = None
        if plan.buckets > 1:
            check_bucket(torch, kernels, label, ids, dl, R, plan)
            bucket = (lambda _: kernels.dim1_bucket_cuda(ids, dl, R))
        case = check_scatter(torch, label, s4, s4p, view, ids, dl, path,
                             collect=k4_inputs, sort_fn=bucket)
        case["plan"] = plan._asdict()
        return case

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
    for name, count in launched.items():
        want = per_step.get(name, 0) * steps
        if count != want:
            raise AssertionError(
                f"{label}: {name} launched {count} times, expected {want} "
                f"({per_step.get(name, 0)} per step x {steps} steps)")
    leaves = dict(tables)
    if isinstance(local_state, torch.Tensor):
        leaves["local_state"] = local_state
    for name, tb in leaves.items():
        if not bool(torch.isfinite(tb).all()):
            raise AssertionError(f"{label}: {name} has non-finite values")
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
        "quality": checks, "card": card,
    }
    log(f"path {label}: " + json.dumps(summary))
    return summary


def run_indexed_path(torch, fps, kernels, label, trainer, data, route_key,
                     local_batch, epochs, per_step, quality, card,
                     chunk_steps):
    """Train ``epochs`` epochs through device-resident ingest and
    ``run_indexed`` from fresh tables, the launch counters at 0 just before
    the run and read just after (the dataset's upload is set-up, before
    them); check the counts (``per_step`` launches of each kernel for every
    step of every epoch), finite
    tables and ``quality`` over the metrics cut into pieces of
    ``chunk_steps`` steps (``None``: one piece an epoch); return a
    summary."""
    mesh = trainer.mesh
    t0 = time.perf_counter()
    dataset = fps.DeviceDataset(mesh, data)
    plan = fps.DeviceEpochPlan(
        dataset, num_workers=1, local_batch=local_batch, route_key=route_key,
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
    for name, count in launched.items():
        want = per_step.get(name, 0) * steps_run
        if count != want:
            raise AssertionError(
                f"{label}: {name} launched {count} times, expected {want} "
                f"({per_step.get(name, 0)} per step x {steps_run} steps)")
    leaves = dict(tables)
    if isinstance(local_state, torch.Tensor):
        leaves["local_state"] = local_state
    for name, tb in leaves.items():
        if not bool(torch.isfinite(tb).all()):
            raise AssertionError(f"{label}: {name} has non-finite values")
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
        "quality": checks, "card": card,
    }
    log(f"path {label}: " + json.dumps(summary))
    return summary


def traced_mf_epoch(torch, fps, mf_data, card):
    """Device busy share of the MF run_indexed step with hot_items: one
    untraced and one traced epoch of 64 steps over the first 63 x 32,768
    ratings (``torch.profiler``, summarised by
    ``fps_tpu_torch.utils.trace_summary``), against the untraced step of the
    same epoch. The trace goes to a temporary directory and is deleted."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    mesh = fps.make_ps_mesh()
    cfg = fps.MFConfig(num_users=ML20M_USERS, num_items=ML20M_ITEMS,
                       rank=RANK, learning_rate=0.1, reg=0.01, hot_items=HOT)
    trainer, _ = fps.online_mf(mesh, cfg, combine="mean")
    part = {k: v[:63 * BATCH] for k, v in mf_data.items()}
    plan = fps.DeviceEpochPlan(fps.DeviceDataset(mesh, part), num_workers=1,
                               local_batch=BATCH, route_key="user", seed=0)
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
                                          plan.steps_per_epoch)
    busy = summary["device_busy_ms_per_step"]
    out = {"path": "MF sync, hot_items, run_indexed (traced epoch)",
           "steps": plan.steps_per_epoch, "untraced_ms_per_step": untraced_ms,
           "device_busy_ms_per_step": busy,
           "device_busy_share": busy / untraced_ms,
           "device_launches_per_step": summary["device_launches_per_step"],
           "kernels": summary["kernels"], "card": card}
    log("traced MF run_indexed epoch: " + json.dumps(out))
    return out


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
    return runs, traced


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
            tables = {k: v.to(mesh.device, copy=True)
                      for k, v in tables0.items()}
            local = (local0.to(mesh.device, copy=True)
                     if isinstance(local0, torch.Tensor) else local0)
            if job.endswith("run_indexed"):
                tables, local, _ = chunks(trainer, tables, local)
            else:
                tables, local, _ = trainer.fit_stream(tables, local,
                                                      chunks(), 2)
            leaves = {k: v.cpu() for k, v in tables.items()}
            if isinstance(local, torch.Tensor):
                leaves["local_state"] = local.cpu()
            runs[device] = leaves
        worst[job] = 0.0
        for name, want in runs["cpu"].items():
            diff = float((want - runs["cuda"][name]).abs().max())
            scale = max(1.0, float(want.abs().max()))
            worst[job] = max(worst[job], diff / scale)
            log(f"card vs CPU, {job}, {name}: max abs diff {diff:.3e} "
                f"(largest value {scale:.3e})")
    return worst


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

    # 3. Kernels against their plain versions at the paths' shapes.
    cases = kernel_phase(torch, kernels, pa_data, pa_q, mc_data, lr_data,
                         dev)
    k2_inputs = cases.pop("k2_inputs")
    k3_inputs = cases.pop("k3_inputs")
    k4_inputs = cases.pop("k4_inputs")
    gather_inputs = cases.pop("gather_inputs")
    split = cases.pop("split")
    sort_cases, sort_inputs = sort_edges(torch, kernels, dev)

    sweep = crossover_sweep(torch, kernels, dev)

    # 4. The paths at full width, counters at 0 just before each.
    runs, traced = paths_phase(torch, fps, kernels, pa_data, pa_q, mc_data,
                               lr_data, card)
    launches = {name: sum(r["launches"][name] for r in runs)
                for name in kernels.WRAPPERS}
    log(f"launch counters over the paths: {launches}")

    # 5. The card against the CPU.
    worst = card_vs_cpu(torch, fps)
    breakdown, sort_traced = k2_breakdown(torch, kernels, k2_inputs,
                                          sort_inputs)
    k3_traced = k3_breakdown(torch, kernels, k3_inputs)
    k4_traced = k4_breakdown(torch, kernels, k4_inputs)
    gather_traced = gather_breakdown(torch, gather_inputs)
    del k2_inputs, sort_inputs, k3_inputs, k4_inputs, gather_inputs
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
    # loss's steps are continuous in the weights, so these differences stay
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

    # 6. Summary lines. Each entry's times are per step of its first path
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

    line = {"kernels": [
        gather_entry("gather_rows", src + "gather_rows.cu", pallas + ":513",
                     "mf"),
        dict(entry("scatter_add", src + "scatter_add.cu", pallas + ":112",
                   "mf"),
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
             traced_by_shape=k4_traced),
        dict(entry("scatter_add_packed", src + "scatter_add_packed.cu",
                   pallas + ":178", "mf_hot"),
             traced_by_shape=k3_traced, split_end_to_end=split,
             crossover_sweep=sweep),
    ], "paths": runs, "traced_mf_run_indexed": traced, "card_vs_cpu": worst,
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
