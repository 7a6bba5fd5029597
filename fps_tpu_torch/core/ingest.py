"""Host-side streaming ingest: fixed-shape chunks of examples, in numpy.

A copy of ``per_worker_cold_counts``, ``_to_ssp_shape``, ``epoch_chunks``,
``multi_epoch_chunks`` and ``stream_chunks`` from ``fps_tpu/core/ingest.py``, kept in the port so that it
never imports the JAX package (whose ``__init__`` imports jax). The chunks are
the same, array for array, as the JAX package's; the trainer moves each one
to the device once.

* **routing**: optionally place each example on the worker that owns its
  route key (``route_key % num_workers == worker_index``), preserving the
  reference's worker-local-state locality trick;
* **static shapes**: every chunk has identical shape; short queues are
  padded with zero-weight examples (the ``weight`` field);
* **epochs vs one-pass**: the reference is one-pass streaming; wrapping the
  iterator for multiple epochs gives the multi-epoch mode the benchmarks
  need.
"""

from __future__ import annotations

from typing import Iterator, Mapping

import numpy as np


def per_worker_cold_counts(ids: np.ndarray, num_workers: int, *,
                           hot_head: int = 0,
                           hot_member: np.ndarray | None = None
                           ) -> np.ndarray:
    """Cold-id counts of one chunk's id column, a ``(steps, num_workers)``
    int array: the host half of the compacted cold route's certification
    (``TableSpec.cold_budget``).

    ``ids``' last axis is the global batch (worker-major, ``W *
    local_batch``), its leading axes the chunk's step dims. An id is cold
    when it is ``>= hot_head`` (the static frequency-ranked head), or, with
    ``hot_member`` (a boolean array of ``num_ids + 1`` entries: the mapped
    tier's hot set, the last entry a ``False`` sentinel), when it is not a
    member; an id past the array clamps onto the sentinel. Negative ids
    never count (the ``-1`` padding), every other id counts, as the
    device's compaction sees it. The certifier compares the maximum with
    the lane's budget."""
    a = np.asarray(ids)
    B = a.shape[-1]
    if B % num_workers:
        raise ValueError(
            f"batch dim {B} not divisible by num_workers={num_workers}")
    per_worker = a.reshape(-1, num_workers, B // num_workers)
    if hot_member is not None:
        member = np.asarray(hot_member, bool)
        cold = (per_worker >= 0) & ~member[
            np.clip(per_worker, 0, len(member) - 1)]
    else:
        cold = per_worker >= hot_head
    return cold.sum(axis=-1)


def _to_ssp_shape(chunk: dict, sync_every: int) -> dict:
    """Reshape (T, B, ...) chunk leaves to (T//s, s, B, ...) for the SSP driver."""
    return {
        k: v.reshape((-1, sync_every) + v.shape[1:]) for k, v in chunk.items()
    }


def epoch_chunks(
    data: Mapping[str, np.ndarray],
    *,
    num_workers: int,
    local_batch: int,
    steps_per_chunk: int,
    route_key: str | None = None,
    sync_every: int | None = None,
    seed: int | None = 0,
    drop_remainder: bool = False,
) -> Iterator[dict]:
    """Yield fixed-shape chunks covering one (shuffled) pass over ``data``.

    Args:
      data: columnar examples — dict of equal-length 1-D/2-D arrays.
      num_workers: total worker devices (mesh data*shard).
      local_batch: examples per worker per step.
      steps_per_chunk: microbatch steps stacked per chunk (one
        ``run_chunk`` call). For SSP mode this must be a multiple of
        ``sync_every``.
      route_key: name of an integer column; examples are routed to worker
        ``value % num_workers``. ``None`` routes round-robin.
      sync_every: if set, chunks are shaped ``(R, sync_every, B, ...)`` for
        the SSP driver instead of ``(T, B, ...)``.
      seed: shuffle seed (None = no shuffle, stream order preserved, which
        matches the reference's online one-pass semantics).
      drop_remainder: drop the final partial chunk instead of padding it.

    Yields:
      dict with the columns of ``data`` plus ``weight`` (1.0 real, 0.0 pad),
      each shaped ``(T, B, ...)`` or ``(R, s, B, ...)``; the batch dim ``B``
      is ordered worker-major (worker 0's rows first), matching the
      worker split of the batch.
    """
    n = len(next(iter(data.values())))
    for k, v in data.items():
        if len(v) != n:
            raise ValueError(f"column {k!r} length {len(v)} != {n}")
    # Materialize every column ONCE — the per-chunk loop below used to
    # re-run np.asarray on each column for every chunk, a full-array copy
    # per chunk whenever the caller passed lists/memmaps.
    arrays = {k: np.asarray(v) for k, v in data.items()}

    order = np.arange(n)
    if seed is not None:
        np.random.default_rng(seed).shuffle(order)

    if route_key is not None:
        keys = arrays[route_key][order]
        queues = [order[keys % num_workers == w] for w in range(num_workers)]
    else:
        queues = [order[w::num_workers] for w in range(num_workers)]

    steps_total = max(-(-len(q) // local_batch) for q in queues)
    if sync_every is not None:
        if steps_per_chunk % sync_every:
            raise ValueError("steps_per_chunk must be a multiple of sync_every")
        steps_total = -(-steps_total // sync_every) * sync_every
    if drop_remainder:
        steps_total = (steps_total // steps_per_chunk) * steps_per_chunk
    else:
        steps_total = -(-steps_total // steps_per_chunk) * steps_per_chunk
    if steps_total == 0:
        return

    # Pad every queue to steps_total*local_batch with sentinel -1.
    full = steps_total * local_batch
    idx = np.full((num_workers, full), -1, dtype=np.int64)
    for w, q in enumerate(queues):
        idx[w, : min(len(q), full)] = q[:full]
    # (steps_total, num_workers, local_batch) -> (steps_total, B)
    idx = idx.reshape(num_workers, steps_total, local_batch).transpose(1, 0, 2)
    idx = idx.reshape(steps_total, num_workers * local_batch)

    weight = (idx >= 0).astype(np.float32)
    safe = np.maximum(idx, 0)

    for start in range(0, steps_total, steps_per_chunk):
        sl = slice(start, start + steps_per_chunk)
        chunk = {k: a[safe[sl]] for k, a in arrays.items()}
        chunk["weight"] = weight[sl]
        if sync_every is not None:
            chunk = _to_ssp_shape(chunk, sync_every)
        yield chunk


def multi_epoch_chunks(data, epochs: int, *, seed: int | None = 0, **kw):
    """Repeat :func:`epoch_chunks` for several epochs with distinct shuffles."""
    for e in range(epochs):
        eseed = None if seed is None else seed + e
        yield from epoch_chunks(data, seed=eseed, **kw)


def stream_chunks(
    source,
    *,
    num_workers: int,
    local_batch: int,
    steps_per_chunk: int,
    route_key: str | None = None,
    sync_every: int | None = None,
) -> Iterator[dict]:
    """Fixed-shape chunks from an **unbounded** stream of example batches.

    The reference consumes an unbounded ``DataStream[T]`` — training runs as
    long as the source produces records, and terminates via the
    ``iterationWaitTime`` timeout when the stream dries up. This is the
    analog for a chunked loop: ``source`` is any iterator yielding columnar
    dicts (arbitrary, varying lengths — e.g. a socket reader, file tailer,
    or Kafka-style consumer poll loop), and chunks are emitted as soon as
    enough examples have buffered; when the source is exhausted, the
    remainder is flushed with zero-weight padding.

    Routing matches :func:`epoch_chunks`: ``route_key`` pins each example to
    worker ``value % num_workers`` (worker-local-state locality); ``None``
    spreads round-robin. Under keyed routing a skewed stream makes some
    workers run ahead — short queues are padded per chunk (weight 0), which
    is exactly the reference's behavior of workers idling while others have
    records in flight.
    """
    if sync_every is not None and steps_per_chunk % sync_every:
        raise ValueError("steps_per_chunk must be a multiple of sync_every")
    capacity = steps_per_chunk * local_batch  # per worker
    queues: list[dict[str, list]] | None = None
    counts = [0] * num_workers
    columns: dict[str, tuple] = {}  # name -> (trailing shape, dtype)
    rr = 0  # round-robin cursor

    def emit():
        out = {}
        for k, (trail, dtype) in columns.items():
            per_worker = []
            for w in range(num_workers):
                col = (
                    np.concatenate(queues[w][k])
                    if queues[w][k]
                    else np.zeros((0,) + trail, dtype)
                )
                take, rest = col[:capacity], col[capacity:]
                queues[w][k] = [rest] if len(rest) else []
                pad = capacity - len(take)
                if pad:
                    take = np.concatenate(
                        [take, np.zeros((pad,) + trail, dtype)]
                    )
                per_worker.append(
                    take.reshape((steps_per_chunk, local_batch) + trail)
                )
            # (steps, num_workers*local_batch, ...), worker-major per step.
            out[k] = np.stack(per_worker, axis=1).reshape(
                (steps_per_chunk, num_workers * local_batch) + trail
            )
        weights = []
        for w in range(num_workers):
            n = min(counts[w], capacity)
            wcol = np.zeros(capacity, np.float32)
            wcol[:n] = 1.0
            counts[w] -= n
            weights.append(wcol.reshape(steps_per_chunk, local_batch))
        out["weight"] = np.stack(weights, axis=1).reshape(steps_per_chunk, -1)
        if sync_every is not None:
            out = _to_ssp_shape(out, sync_every)
        return out

    for batch in source:
        if "weight" in batch:
            raise ValueError(
                "'weight' is reserved: stream_chunks emits it as the "
                "real-vs-padding mask; carry importance weights in a "
                "differently-named column"
            )
        if queues is None:
            columns = {
                k: (np.asarray(v).shape[1:], np.asarray(v).dtype)
                for k, v in batch.items()
            }
            queues = [{k: [] for k in columns} for _ in range(num_workers)]
        if set(batch.keys()) != set(columns.keys()):
            raise ValueError(
                f"batch columns {sorted(batch)} != first batch's schema "
                f"{sorted(columns)} — the schema is pinned by the first batch"
            )
        n = len(next(iter(batch.values())))
        arrs = {}
        for k, (trail, dtype) in columns.items():
            # Pin every batch to the first batch's dtype/shape so each chunk
            # has the same shapes and dtypes (the static-shape contract).
            a = np.asarray(batch[k]).astype(dtype, copy=False)
            if len(a) != n or a.shape[1:] != trail:
                raise ValueError(
                    f"column {k!r} shape {a.shape} inconsistent with "
                    f"batch length {n} / trailing shape {trail}"
                )
            arrs[k] = a
        if route_key is not None:
            dest = arrs[route_key] % num_workers
        else:
            dest = (np.arange(n) + rr) % num_workers
            rr = (rr + n) % num_workers
        for w in range(num_workers):
            sel = dest == w
            m = int(sel.sum())
            if not m:
                continue
            for k in columns:
                queues[w][k].append(arrs[k][sel])
            counts[w] += m
        while max(counts) >= capacity:
            yield emit()
    if queues is not None and any(counts):
        yield emit()
