"""Chunks a megastep dispatch: ``chunks_per_dispatch="auto"``.

Port of ``fps_tpu/core/autok.py``. A megastep amortises a dispatch's host
overhead (the Python calls around the segments, the vote's host read, the
bookkeeping) over its K chunk segments: a dispatch of K chunks takes about
``h + K * c`` seconds, ``h`` the overhead a dispatch and ``c`` a chunk's
time. The host-serial share of a dispatch is modelled as

    share(K) = h / (h + K * c)

and the smallest K that brings it under a target share ``s`` is

    K >= h * (1 - s) / (s * c)

A short calibration window measures ``h`` and ``c``: a dispatch of one
cadence block and one of two blocks (the tick's ``check_every`` segments,
1 without a tick), each the median of a few timed calls after an untimed
one; the difference is ``c`` a block, the extrapolated intercept ``h``.
The chosen K is a multiple of the cadence, and the run it drives equals
the run given that K (the calibration dispatches run on :func:`tree_copy`
copies: the tables update in place, so the live state must not be handed
over). ``DEFAULT_TARGET_SHARE`` and ``DEFAULT_MAX_K`` are policy, not
measurements; the ``h``, ``c`` and K measured on the card are in PERF.md.

A resumed run (``start_megastep > 0``) passes the K it first chose: megastep
indices count dispatches of K chunks.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

__all__ = [
    "derive_chunks_per_dispatch",
    "calibrate_chunks_per_dispatch",
]

#: Modelled host-serial share a chosen K must clear.
DEFAULT_TARGET_SHARE = 0.05

#: Upper bound on the chosen K.
DEFAULT_MAX_K = 64

#: Timed calls a calibration point (median taken; the first call of each
#: point is untimed).
DEFAULT_SAMPLES = 3


def derive_chunks_per_dispatch(overhead_s: float, per_chunk_s: float, *,
                               target_share: float = DEFAULT_TARGET_SHARE,
                               max_k: int = DEFAULT_MAX_K,
                               multiple_of: int = 1,
                               n_calls: int | None = None) -> int:
    """Smallest K with modelled host-serial share <= ``target_share``.

    Pure: the measured half of auto-K feeds it, and the fixed-trace tests
    pin it. ``multiple_of`` (the tick's cadence) is honoured by rounding
    up; ``max_k`` is rounded down to the cadence (never below one block).
    ``n_calls`` (chunk calls an epoch) caps K at one epoch's work, rounded
    up to the cadence.
    """
    if multiple_of < 1:
        raise ValueError(f"multiple_of must be >= 1, got {multiple_of}")
    if not (0.0 < target_share < 1.0):
        raise ValueError(
            f"target_share must be in (0, 1), got {target_share}")
    if max_k < 1:
        raise ValueError(f"max_k must be >= 1, got {max_k}")
    cap = max((max_k // multiple_of) * multiple_of, multiple_of)
    if n_calls is not None and n_calls >= 1:
        cap = min(cap, -(-n_calls // multiple_of) * multiple_of)
    h = max(float(overhead_s), 0.0)
    c = float(per_chunk_s)
    if h <= 0.0:
        return multiple_of  # no measurable overhead: smallest legal K
    if c <= 0.0:
        return cap  # dispatch-bound: no K clears the share; take the cap
    k_needed = math.ceil(h * (1.0 - target_share) / (target_share * c))
    blocks = max(1, -(-k_needed // multiple_of))
    return min(blocks * multiple_of, cap)


def _measure_dispatch(trainer, fn, tables, local_state, iargs, seed,
                      tick_ops, samples: int,
                      clock=time.perf_counter) -> float:
    """Median wall seconds of ``samples`` calls of the dispatch ``fn`` on
    copies of the state (the tables update in place), after one untimed
    call; on the card the device is drained before and after each timed
    call. Module-level, so the fixed-trace tests can replace the
    measurement and keep the derivation and the dispatches."""
    from fps_tpu_torch.core.resilience import tree_copy

    cuda = trainer.device.type == "cuda"

    def once():
        a = (tree_copy(tables), tree_copy(local_state), tree_copy(tick_ops))
        if cuda:
            torch.cuda.synchronize(trainer.device)
        t0 = clock()
        fn(a[0], a[1], iargs, seed, a[2])
        if cuda:
            torch.cuda.synchronize(trainer.device)
        return clock() - t0

    once()  # first touch (and the kernels' build), untimed
    return statistics.median([once() for _ in range(max(1, samples))])


def calibrate_chunks_per_dispatch(trainer, tables, local_state, plan,
                                  seed: int, *, lanes=None, tick=None,
                                  n_calls: int | None = None,
                                  target_share: float =
                                  DEFAULT_TARGET_SHARE,
                                  max_k: int = DEFAULT_MAX_K,
                                  samples: int = DEFAULT_SAMPLES):
    """Measure ``(h, c)`` and derive K. Returns ``(K, overhead_s,
    per_chunk_s)``.

    Times dispatches of one and two cadence blocks from epoch 0's first
    chunk: ``wall(B blocks) = h + B * block * c`` gives ``c = (wall2 -
    wall1) / block`` and ``h = 2 * wall1 - wall2``, noise clamped (``h >=
    0``, ``c`` above a small floor, so a noisy fast run takes the cap).
    ``lanes``: the vote's lanes, as the run dispatches them.
    """
    from fps_tpu_torch.core.megastep import dispatch
    from fps_tpu_torch.core.rng import fold_seed

    block = int(tick.check_every) if tick is not None else 1
    iargs = plan.epoch_args(0)
    tick_ops = tick.tick_ops(trainer) if tick is not None else None
    walls = []
    for blocks in (1, 2):
        K = blocks * block

        def fn(t, ls, args, s, ops_, _K=K):
            return dispatch(trainer, t, ls, plan, args, s, 0, _K,
                            lanes=lanes, tick=tick, tick_ops=ops_)

        walls.append(_measure_dispatch(trainer, fn, tables, local_state,
                                       iargs, fold_seed(seed, 0), tick_ops,
                                       samples))
    wall1, wall2 = walls
    per_chunk_s = max((wall2 - wall1) / block, 1e-9)
    overhead_s = max(2.0 * wall1 - wall2, 0.0)
    k = derive_chunks_per_dispatch(overhead_s, per_chunk_s,
                                   target_share=target_share,
                                   max_k=max_k, multiple_of=block,
                                   n_calls=n_calls)
    return k, overhead_s, per_chunk_s
