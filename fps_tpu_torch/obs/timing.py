"""Phase timers, throughput accounting, and device tracing.

Port of ``fps_tpu/obs/timing.py``: the host-side clocks the chunked driver
makes natural, plus a device trace:

* :class:`PhaseTimer` — splits each chunk's host wall-clock into named
  segments (``ingest`` / ``place`` / ``dispatch`` / ``host_sync`` /
  ``checkpoint`` / ``callback``), so a regression is attributable to a
  phase instead of a single opaque number. Pull, compute and push are
  separate launches on the card; the driver names them on the DEVICE
  timeline with ``torch.profiler.record_function`` ranges (``fps.pull`` /
  ``fps.compute`` / ``fps.push`` …), opened only while a profiler runs.
* :class:`Throughput` — per-chunk wall-clock + examples/sec accounting
  for ``Trainer.fit_stream(on_chunk=...)``.
* :func:`trace` — context manager writing a Chrome trace (open it in
  Perfetto) of the host and the card: ``torch.profiler`` with CPU and
  CUDA activities.

(:mod:`fps_tpu_torch.utils.profiling` re-exports ``trace`` and
``Throughput``, as the reference's compat shim does.)
"""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np

# Phase names the driver emits, in pipeline order. PhaseTimer accepts any
# name (custom loops may add their own); these are the declared ones.
DRIVER_PHASES = (
    "prefetch",    # background pipeline: chunk assembly + placement on
                   # the worker thread (fps_tpu.core.prefetch) — OVERLAPS
                   # the phases below, it is not part of their serial sum
    "ingest",      # pulling the next chunk from the host iterator (with
                   # the pipeline on: waiting on the prefetch buffer)
    "place",       # host->device transfer (place_columns)
    "dispatch",    # the chunk's steps: kernel launches + collectives
    "host_sync",   # blocked fetching metrics back to host
    "checkpoint",  # snapshot save on the training thread
    "callback",    # user on_chunk / on_epoch hooks
    "reconcile",   # two-tier re-split at run entry (hot replica derive)
    "megastep",    # K-chunk dispatch of Trainer.run_megastep: the
                   # megastep driver's analog of "dispatch" (its segments'
                   # launches and the vote's host read)
)


class PhaseTimer:
    """Named wall-clock segments, accumulated per chunk and per run.

    Feed it a :class:`~fps_tpu_torch.obs.registry.Recorder` and every closed
    phase lands one ``driver.phase_seconds{phase=...}`` histogram sample;
    the per-chunk dict from :meth:`chunk_summary` rides the journal's
    chunk/epoch events. Launches are asynchronous on the card, so
    ``dispatch`` measures the host's launching (and any synchronisation
    the step itself makes, such as the cold lanes' certifier), and the
    device compute surfaces in ``host_sync`` wherever the host loop
    actually blocks — honest host-side attribution, not a guess at device
    internals. The timer makes no device call and adds no
    synchronisation.
    """

    def __init__(self, recorder=None):
        self.recorder = recorder
        self._chunk: dict[str, float] = {}
        # The prefetch worker thread folds its segments in via add()
        # while the driver thread closes phases and takes summaries.
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def phase(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.add(name, time.perf_counter() - t0)

    def add(self, name: str, seconds: float) -> None:
        """Fold an externally-measured segment into the current chunk —
        how the background prefetch worker reports its assemble+place
        time (``prefetch``) without a context manager spanning threads.
        A segment landing exactly at a chunk boundary may attribute to
        either side of it; overlapped phases are inherently concurrent
        with the driver's, so the ambiguity is real, not an artifact."""
        with self._lock:
            self._chunk[name] = self._chunk.get(name, 0.0) + seconds
        if self.recorder is not None:
            self.recorder.observe("driver.phase_seconds", seconds, phase=name)

    def chunk_summary(self, *, reset: bool = True) -> dict[str, float]:
        """Seconds per phase since the last reset (one chunk's breakdown).
        Whole-run totals live where every consumer already reads them:
        ``Recorder.phase_totals()`` over the ``driver.phase_seconds``
        histogram — the timer keeps no duplicate run-level state."""
        with self._lock:
            out = {k: round(v, 6) for k, v in self._chunk.items()}
            if reset:
                self._chunk = {}
        return out


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a host+card profile into ``log_dir/trace.json`` (a Chrome
    trace; open it in Perfetto). Usable around any training region::

        with obs.trace("/tmp/trace"):
            trainer.run_chunk(...)

    Runs ``torch.profiler`` with CPU activities, and CUDA activities where
    a card is visible; the driver's ``fps.*`` ranges name the step's pulls
    and pushes inside it. Yields the profiler."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    prof = profile(activities=acts)
    prof.__enter__()
    try:
        yield prof
    finally:
        prof.__exit__(None, None, None)
        prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


class Throughput:
    """Callable chunk hook accumulating wall-clock and example counts.

    ``count_key`` names the metrics leaf holding per-step example counts
    (every shipped model emits ``"n"``). The first chunk is recorded
    separately (``first_s``) since it includes compilation.

    Timing origin: :meth:`start` marks the stream start explicitly; when
    it was never called, the first observation measures from CONSTRUCTION
    time. (It used to fall back to "now", which recorded a zero-width
    first chunk and understated compile time — the hook is conventionally
    built immediately before ``fit_stream``, so construction time is the
    honest origin; any setup between the two is attributed to the first
    chunk, which already absorbs one-time costs by design. Call
    ``start()`` right before the run when that setup is expensive, and
    before any *second* stream reusing this hook, or the inter-run gap
    lands in ``steady_s``.)
    """

    def __init__(self, count_key: str = "n"):
        self.count_key = count_key
        self.chunks = 0
        self.first_s: float | None = None
        self._first_examples = 0.0
        self.steady_s = 0.0
        self._steady_examples = 0.0
        self._last: float | None = None
        self._created = time.perf_counter()

    def start(self) -> None:
        """Mark the stream start (see the class docstring for when the
        implicit construction-time origin is not what you want)."""
        self._last = time.perf_counter()

    def __call__(self, step: int, metrics) -> None:
        now = time.perf_counter()
        if self._last is None:
            # No explicit start(): the stream began, as far as this hook
            # can know, when the hook was constructed.
            self._last = self._created
        dt = now - self._last
        self._last = now
        count = (
            float(np.sum(metrics[self.count_key]))
            if self.count_key in metrics
            else 0.0
        )
        if self.first_s is None:
            self.first_s = dt
            self._first_examples = count
        else:
            self.steady_s += dt
            self._steady_examples += count
        self.chunks += 1

    @property
    def examples(self) -> float:
        return self._first_examples + self._steady_examples

    @property
    def examples_per_sec(self) -> float:
        """Steady-state throughput (excludes the compile-laden first chunk)."""
        return self._steady_examples / self.steady_s if self.steady_s else 0.0

    def summary(self) -> dict:
        return {
            "chunks": self.chunks,
            "examples": self.examples,
            "first_chunk_s": round(self.first_s or 0.0, 4),
            "steady_s": round(self.steady_s, 4),
            "examples_per_sec": round(self.examples_per_sec, 1),
        }
