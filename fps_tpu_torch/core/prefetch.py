"""Overlapped host pipeline: background chunk prefetch and placement.

Port of ``fps_tpu/core/prefetch.py``. The driver's host loop is serial
without it: assemble the next chunk (numpy fancy indexing in
:mod:`fps_tpu_torch.core.ingest`), copy it to the device, enqueue its steps,
repeat. :class:`ChunkPrefetcher` moves assembly and placement onto one
worker thread that runs up to ``depth`` chunks ahead, and hands the driver
chunks already on the device (wrapped in :class:`PlacedChunk`, so
``Trainer.run_chunk`` skips its own placement) in the order the source
yielded them. Placement is the same function either way
(:func:`place_columns`), so prefetch on and off give the same device inputs
and the same tables, bit for bit.

On a CUDA device the worker places each chunk asynchronously: it copies the
host arrays into pinned memory (``Tensor.pin_memory``, from the caching host
allocator, which keeps a block until the copies that read it are done),
issues ``non_blocking`` copies on a side stream that the prefetcher owns and
records a CUDA event after them. The consumer makes its own stream wait on
that event, with no host synchronisation, and marks each tensor as used on
its stream (:func:`placed_batches`), so the caching allocator does not hand a
chunk's memory to a later copy while a step still reads it. On the CPU,
placement is the plain ``.to("cpu")``.

Contracts:

* **deterministic order**: one worker thread, FIFO buffer.
* **bounded depth**: at most ``depth`` placed chunks are buffered (plus the
  one being assembled); the worker blocks while the buffer is full.
* **errors re-raise on the caller**: an exception in the source iterator or
  in placement is delivered at its position: every chunk assembled before it
  is yielded first, then the original exception object is raised from
  ``__next__`` on the consuming thread. Nothing falls back to a synchronous
  placement.
* **no thread leaks**: :meth:`ChunkPrefetcher.close` wakes a blocked worker
  and joins it; ``Trainer.fit_stream`` and ``IALSSolver.half_epoch`` close
  the pipeline in a ``finally`` on every exit path. The thread is a daemon
  as a last resort, so a worker wedged in the source cannot hang interpreter
  exit.

Telemetry (optional, duck-typed): ``timer.add("prefetch", seconds)`` gets the
worker's assembly and placement seconds a chunk; ``recorder.set(
"prefetch.queue_depth", n)``, ``recorder.inc("prefetch.chunks")`` and
``recorder.inc("prefetch.depth_adjustments")`` the buffer's gauge and
counters.
"""

from __future__ import annotations

import collections
import logging
import os
import threading
import time
from typing import Callable, Iterable, Mapping

import torch

_log = logging.getLogger("fps_tpu_torch.prefetch")

# Worker-to-consumer end-of-stream marker (never buffered, never yielded).
_END = object()

#: Adaptive depth: consumed chunks per adaptation window, and the
#: queue-empty stall count within one window that triggers a raise.
ADAPT_WINDOW = 8
ADAPT_STALLS = 2

#: A depth raise must keep the whole buffer under this share of the
#: currently available host memory.
ADAPT_MEM_SHARE = 0.25


def _available_host_bytes() -> int | None:
    """Available (not merely free) host memory, or ``None`` when the
    platform cannot say; ``None`` means the memory veto abstains."""
    try:
        return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
    except (ValueError, OSError, AttributeError):
        return None


def _chunk_nbytes(item) -> int:
    """Byte estimate of one buffered chunk (device tensors count too: a
    placed chunk's device footprint tracks its host footprint, and an
    overestimate only makes the veto stricter)."""
    if isinstance(item, PlacedChunk):
        return _chunk_nbytes(item.batches) + _chunk_nbytes(item.host_ids)
    if isinstance(item, dict):
        return sum(_chunk_nbytes(v) for v in item.values())
    if isinstance(item, (list, tuple)):
        return sum(_chunk_nbytes(v) for v in item)
    try:
        return int(getattr(item, "nbytes", 0) or 0)
    except TypeError:
        return 0


class PlacedChunk:
    """A chunk already placed on the device.

    ``Trainer.run_chunk`` unwraps it and skips its placement: the wrapper
    exists so that an uploaded chunk is never taken for a host chunk and
    placed again. ``ready`` is the CUDA event recorded after the chunk's
    copies (``None`` off the card): a consumer waits on it before reading
    ``batches``, through :func:`placed_batches`.

    ``host_ids`` optionally carries the raw host id columns that the
    compacted cold routes' certifier reads
    (``WorkerLogic.pulled_ids_host``): the pipeline's worker thread computes
    them beside the placement, and ``Trainer.run_chunk`` certifies the chunk
    against them at dispatch. References to the source chunk's columns, not
    copies.
    """

    __slots__ = ("batches", "ready", "host_ids")

    def __init__(self, batches, ready=None, host_ids=None):
        self.batches = batches
        self.ready = ready
        self.host_ids = host_ids


def place_columns(columns: Mapping, device: torch.device) -> PlacedChunk:
    """Place a chunk's columns (host arrays or tensors) on ``device``.

    Off the card each column is ``torch.as_tensor(v).to(device)``. On a CUDA
    device a host column is copied into pinned memory and then to the
    device with ``non_blocking=True`` on the current stream (the
    prefetcher's side stream on its worker thread, the compute stream
    otherwise), and a CUDA event recorded after the copies rides the result.
    A column already on the device is used as it is. The values are the same
    bits either way."""
    if device.type != "cuda":
        return PlacedChunk({k: torch.as_tensor(v).to(device)
                            for k, v in columns.items()})
    out = {}
    for k, v in columns.items():
        t = torch.as_tensor(v)
        out[k] = (t.pin_memory().to(device, non_blocking=True)
                  if t.device.type == "cpu" else t.to(device))
    ready = torch.cuda.Event()
    ready.record(torch.cuda.current_stream(device))
    return PlacedChunk(out, ready=ready)


def placed_batches(chunk: PlacedChunk, device: torch.device) -> dict:
    """The placed chunk's columns, safe to read on the current stream: that
    stream waits for the chunk's copies (``wait_event``, no host
    synchronisation), and each column is marked as used on it
    (``record_stream``), so its memory is not reused before the work queued
    there has read it."""
    if chunk.ready is not None:
        stream = torch.cuda.current_stream(device)
        stream.wait_event(chunk.ready)
        for t in chunk.batches.values():
            t.record_stream(stream)
    return chunk.batches


class ChunkPrefetcher:
    """Bounded-depth background prefetch and placement over a chunk
    iterator.

    Args:
      chunks: any iterable of chunks (host dicts or chunks already on the
        device: both flow through unchanged).
      place_fn: optional placement (e.g. the driver's ``_place_chunk``),
        run on the worker thread; yielded items are then
        :class:`PlacedChunk`. ``None`` overlaps assembly only.
      depth: max chunks buffered ahead (>= 1; the starting depth when
        ``max_depth`` is set).
      max_depth: adaptive depth: when the consumer keeps draining the buffer
        empty (>= ``ADAPT_STALLS`` queue-empty stalls within a window of
        ``ADAPT_WINDOW`` consumed chunks) the depth rises one chunk at a
        time up to this bound, provided the grown buffer stays under
        ``ADAPT_MEM_SHARE`` of available host memory. ``None`` keeps the
        depth fixed. Depth never adapts downward.
      mem_probe: available-host-bytes callable for the memory veto
        (returning ``None`` abstains; default reads ``SC_AVPHYS_PAGES``).
      recorder: optional, duck-typed: ``.set(name, value)`` and
        ``.inc(name)`` for the ``prefetch.queue_depth`` gauge and the
        ``prefetch.chunks`` / ``prefetch.depth_adjustments`` counters.
      timer: optional, duck-typed: ``.add("prefetch", seconds)`` with the
        worker's assembly and placement seconds of each chunk (called from
        the worker thread).
      start_index: stream index of the first chunk (``fit_stream``'s
        ``start_step``); keys ``skip_place``.
      skip_place: stream indices whose chunks are yielded unplaced.
      name: the worker thread's name.
      device: the device ``place_fn`` places on. For a CUDA device the
        worker thread sets it as its current device and runs the source and
        ``place_fn`` on a side stream that the prefetcher owns (created on
        the worker thread). That stream first waits for the work queued on
        the creating thread's current stream when the prefetcher was made,
        so a source that reads device tensors (a device-resident dataset
        and its epoch plan) sees them written.

    Iterate it like the source; call :meth:`close` (or use it as a context
    manager) on every exit path.
    """

    def __init__(self, chunks: Iterable, place_fn: Callable | None = None, *,
                 depth: int = 2, max_depth: int | None = None,
                 mem_probe: Callable | None = None, recorder=None,
                 timer=None, start_index: int = 0,
                 skip_place=frozenset(), name: str = "fps-prefetch",
                 device: torch.device | None = None):
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        if max_depth is not None and max_depth < depth:
            raise ValueError(
                f"prefetch max_depth={max_depth} must be >= depth={depth}")
        self.depth = depth
        self.max_depth = max_depth
        self._mem_probe = (mem_probe if mem_probe is not None
                           else _available_host_bytes)
        self._stalls = 0
        self._consumed = 0
        self._it = iter(chunks)
        self._place = place_fn
        self._index = start_index
        self._skip_place = frozenset(skip_place)
        self._rec = recorder
        self._timer = timer
        self._device = device
        self._made = None
        if device is not None and torch.device(device).type == "cuda":
            self._made = torch.cuda.Event()
            self._made.record(torch.cuda.current_stream(device))
        self._cv = threading.Condition()
        self._buf: collections.deque = collections.deque()
        self._done = False
        self._stop = False
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._worker, name=name,
                                        daemon=True)
        self._thread.start()

    # -- worker side ------------------------------------------------------

    def _gauge(self, depth: int) -> None:
        # Outside self._cv: a recorder may do file I/O, which must not
        # serialise the producer/consumer handoff.
        if self._rec is not None:
            self._rec.set("prefetch.queue_depth", float(depth))

    def _worker(self) -> None:
        try:
            if self._made is not None:
                # A new thread starts on the default device and stream.
                torch.cuda.set_device(self._device)
                side = torch.cuda.Stream(self._device)
                side.wait_event(self._made)
                with torch.cuda.stream(side):
                    self._loop()
            else:
                self._loop()
        except BaseException as e:  # noqa: BLE001 - re-raised on consumer
            with self._cv:
                self._error = e
                self._done = True
                self._cv.notify_all()

    def _loop(self) -> None:
        while True:
            with self._cv:
                while len(self._buf) >= self.depth and not self._stop:
                    self._cv.wait()
                if self._stop:
                    return
            t0 = time.perf_counter()
            item = next(self._it, _END)
            if (item is not _END and self._place is not None
                    and self._index not in self._skip_place):
                placed = self._place(item)
                # A place_fn may return a PlacedChunk itself (the driver's
                # does, with its CUDA event); wrap bare batches only.
                item = (placed if isinstance(placed, PlacedChunk)
                        else PlacedChunk(placed))
            self._index += 1
            dt = time.perf_counter() - t0
            if item is not _END:
                if self._timer is not None:
                    self._timer.add("prefetch", dt)
                if self._rec is not None:
                    self._rec.inc("prefetch.chunks")
            with self._cv:
                if self._stop:
                    return
                if item is _END:
                    self._done = True
                else:
                    self._buf.append(item)
                    depth = len(self._buf)
                self._cv.notify_all()
            if item is _END:
                return
            self._gauge(depth)

    # -- consumer side ----------------------------------------------------

    def __iter__(self):
        return self

    def __next__(self):
        raised = False
        with self._cv:
            if not self._buf and not self._done:
                # The device is about to idle waiting on the host pipeline:
                # the signal adaptive depth sizes from.
                self._stalls += 1
            while not self._buf and not self._done:
                self._cv.wait()
            if self._buf:
                item = self._buf.popleft()
                depth = len(self._buf)
                self._cv.notify_all()  # free a slot for the worker
            elif self._error is not None:
                err, self._error = self._error, None
                # The original exception object (traceback included)
                # crosses threads; the stream is dead past this point.
                raise err
            else:
                raise StopIteration
            self._consumed += 1
            if self._consumed >= ADAPT_WINDOW:
                raised = self._maybe_raise_depth_locked(item)
                self._stalls = 0
                self._consumed = 0
        self._gauge(depth)
        if raised and self._rec is not None:
            self._rec.inc("prefetch.depth_adjustments")
        return item

    def _maybe_raise_depth_locked(self, item) -> bool:
        """One-chunk depth raise at a window boundary (cv held): justified
        by stalls, vetoed by memory."""
        if self.max_depth is None or self.depth >= self.max_depth:
            return False
        if self._stalls < ADAPT_STALLS:
            return False
        nbytes = _chunk_nbytes(item)
        avail = self._mem_probe()
        if (avail is not None and nbytes > 0
                and (self.depth + 1) * nbytes > ADAPT_MEM_SHARE * avail):
            return False
        self.depth += 1
        self._cv.notify_all()  # the worker may now run further ahead
        return True

    def close(self, timeout: float = 10.0) -> None:
        """Stop the worker and join it (idempotent).

        Buffered chunks are dropped. A worker blocked on the full buffer is
        woken; one blocked inside the source (a wedged ``next``) cannot be
        preempted from Python: after ``timeout`` seconds it is left as a
        daemon to die with the process (logged)."""
        with self._cv:
            self._stop = True
            self._buf.clear()
            self._cv.notify_all()
        self._thread.join(timeout=timeout)
        if self._thread.is_alive():
            _log.warning(
                "prefetch worker did not exit within %.1fs (source blocked "
                "in next()?); leaving the daemon thread behind", timeout)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
