"""Health alerting: threshold the guard's health channel, watch for stalls.

Port of ``fps_tpu/obs/health.py``. The resilience layer
(``fps_tpu_torch/core/resilience.py``) counts poisoned
push rows onto the metrics stream; this module acts on the counts:

* :class:`HealthMonitor` — host-side policy the driver consults after
  every chunk/epoch whose metrics were synced: escalate the guard from
  ``observe`` to ``mask`` once the cumulative poisoned-row count crosses
  ``escalate_after_rows``, and abort the run (the driver raises
  :class:`~fps_tpu_torch.core.resilience.PoisonedStreamError`) once
  ``abort_after_chunks`` distinct chunks reported poison. Escalation is
  the production posture: run cheap (observe = byte-identical stream)
  until the stream proves dirty, then pay for masking.
* :class:`StepWatchdog` — arms a deadline around each blocking
  chunk/epoch region; if the region overruns (a hung peer process
  stalls every collective forever), the
  watchdog records the stall, emits a ``stall`` event, and fires the
  user's ``on_stall`` callback from the timer thread (which may page,
  dump stacks, or ``os._exit`` for a supervisor restart — the training
  thread itself is presumed wedged, so a callback is the only lever).

Both are pure host-side policy objects: no torch imports, no device call.
The watchdog's timer thread runs the telemetry and the user's
``on_stall`` only: it makes no CUDA call (the training thread may be the
one blocked in the driver).
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time

_log = logging.getLogger("fps_tpu_torch.obs")

# Decisions HealthMonitor.update can return (the driver acts on them).
HEALTH_OK = "ok"
HEALTH_ESCALATE = "escalate"
HEALTH_ABORT = "abort"


@dataclasses.dataclass
class HealthMonitor:
    """Thresholds over the cumulative health-channel totals.

    ``escalate_after_rows``: once this many poisoned rows (nonfinite +
    norm tiers, summed over the run) have been seen, request guard
    escalation observe → mask. ``None`` disables the tier. Fires at most
    once (:attr:`escalated_at` records where).

    ``abort_after_chunks``: once this many distinct chunks/epochs have
    reported poison, request an abort — a stream that keeps producing
    poison is an ingest bug, not a transient. ``None`` disables.

    Requires ``TrainerConfig.guard`` (either mode) — without a guard
    there is no health channel to threshold; the driver validates this.
    """

    escalate_after_rows: int | None = None
    abort_after_chunks: int | None = None
    # Cumulative state (mutated by update()).
    poison_rows: int = 0
    poisoned_chunks: int = 0
    escalated_at: int | None = None
    aborted_at: int | None = None
    # (index, rows) per poisoned chunk — the digest's evidence trail.
    log: list = dataclasses.field(default_factory=list)

    def __post_init__(self):
        for name in ("escalate_after_rows", "abort_after_chunks"):
            v = getattr(self, name)
            if v is not None and v < 1:
                raise ValueError(f"{name} must be >= 1 or None, got {v}")

    def update(self, index: int, poison_rows: int) -> str:
        """Fold one chunk/epoch's poisoned-row total; returns the decision
        (``"ok"`` / ``"escalate"`` / ``"abort"``). The driver applies it —
        this object never touches trainer state itself."""
        if poison_rows > 0:
            self.poison_rows += int(poison_rows)
            self.poisoned_chunks += 1
            self.log.append((int(index), int(poison_rows)))
        if (self.abort_after_chunks is not None
                and self.poisoned_chunks >= self.abort_after_chunks):
            self.aborted_at = int(index)
            return HEALTH_ABORT
        if (self.escalate_after_rows is not None
                and self.escalated_at is None
                and self.poison_rows >= self.escalate_after_rows):
            self.escalated_at = int(index)
            return HEALTH_ESCALATE
        return HEALTH_OK


class StepWatchdog:
    """Deadline watchdog over the driver's blocking chunk/epoch regions.

    ``with watchdog.watch("chunk", i):`` arms a one-shot timer; if the
    body has not finished after ``deadline_s`` the timer thread records a
    stall (:attr:`stalls`), emits a ``stall`` event + ``watchdog.stalls``
    counter on the recorder, logs, and calls ``on_stall(info)``. The body
    is NOT interrupted — Python cannot safely preempt a thread blocked in
    a collective; the callback is the escalation point (page, dump
    host stacks, ``os._exit`` under a supervisor). A region that
    eventually completes after flagging emits a ``stall_recovered`` event
    with the real elapsed time, distinguishing a slow straggler from a
    true hang in the digest.

    A callback exception is logged and swallowed: the watchdog must never
    take down a run that was actually healthy.
    """

    def __init__(self, deadline_s: float, on_stall=None, recorder=None):
        if not deadline_s > 0:
            raise ValueError(f"deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.on_stall = on_stall
        self.recorder = recorder
        self.stalls: list[dict] = []
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def watch(self, what: str, index: int):
        info = {"what": what, "index": int(index),
                "deadline_s": self.deadline_s}
        # The same dict instance is appended to stalls and later stamped
        # with elapsed_s — no stalls[-1] indexing, so a concurrent second
        # watch() can never mis-attribute the recovery.
        entry = dict(info)
        fired = threading.Event()

        def _fire():
            with self._lock:
                self.stalls.append(entry)
            fired.set()  # AFTER the append: the recovery path keys on it
            _log.warning(
                "%s %d exceeded the %.1fs watchdog deadline — stalled "
                "dispatch or hung peer", what, index, self.deadline_s,
            )
            rec = self.recorder
            if rec is not None:
                try:
                    rec.inc("watchdog.stalls")
                    rec.event("stall", **info)
                    rec.flush()  # the process may be about to die; persist
                except Exception:  # noqa: BLE001 - on_stall MUST still run
                    _log.exception("watchdog telemetry failed; continuing "
                                   "to the on_stall escalation")
            if self.on_stall is not None:
                try:
                    self.on_stall(dict(info))
                except Exception:  # noqa: BLE001 - must not kill the run
                    _log.exception("watchdog on_stall callback raised")

        t0 = time.perf_counter()
        timer = threading.Timer(self.deadline_s, _fire)
        timer.daemon = True
        timer.start()
        ok = False
        try:
            yield
            ok = True
        finally:
            timer.cancel()
            # A body finishing right at the deadline can race a _fire
            # already past cancel(): join the timer thread (bounded — the
            # stall path is log + event + callback) so fired reflects
            # reality before we decide whether this was a recovery.
            timer.join(timeout=5.0)
            if fired.is_set():
                elapsed = time.perf_counter() - t0
                entry["elapsed_s"] = round(elapsed, 3)
                # Recovery is claimed only on a CLEAN exit — a region
                # that stalls and then raises died, and the digest must
                # not point the operator away from that.
                if ok and self.recorder is not None:
                    self.recorder.event("stall_recovered", **info,
                                        elapsed_s=round(elapsed, 3))
