"""A step-fenced fleet of ReadServers over one snapshot directory.

ONE ``ReadServer`` is a throughput ceiling and a single point of
failure for the serving half Parameter Box (PAPERS.md) treats as the
product. This module grows it into N readers with **consistent step
fencing**: the write side's fencing (the pod epochs of a supervised run)
keeps stale trainers from publishing; this is the READ side's twin,
keeping stale readers from answering.

The fence protocol (all files live under ``<ckpt_dir>/fleet/``, shared
by every reader over the same filesystem the snapshots ride):

* each reader continuously verifies candidates with its own
  :class:`~fps_tpu_torch.serve.watcher.SnapshotWatcher` and records the newest
  step it could serve in its READINESS slot (``ready_<id>.json``,
  atomic-rename JSON like everything here);
* any reader may ADVANCE the shared fence (``serve_fence.json``) to the
  highest step at least ``quorum`` readers are ready on — forward-
  monotone within a fencing epoch, last-writer-wins races are harmless
  because every write is a step at/behind quorum readiness and readers
  clamp to the max ``(epoch, step)`` they have ever observed;
* readers swap their servers to EXACTLY the fence step — never ahead of
  it (a reader ahead would supersede every fence-step answer in flight),
  never behind it (a reader killed and restarted mid-swap re-reads the
  fence at boot and refuses to serve anything older — the
  restart-never-regresses contract the chaos scenario pins);
* BACKWARD swaps stay coordinated: when the trainer quarantines the
  fence step (``*.corrupt``), the reader that observes it rolls the
  fence back to the newest survivor with an incremented fence EPOCH —
  readers accept a lower step only under a higher epoch, so a delayed
  stale fence write can never drag the fleet backward by accident.

Freshness rides the same machinery as the single-reader plane:
``serve.fence_step`` is the fleet-wide published step; delta publishes
hot-swap INCREMENTALLY (``ServableSnapshot.with_delta``: touched rows
overlaid on the still-mapped base); and each reader admits a WARM-ROW
cache from the hot-tier frequency ranking (the adaptive tier's sidecar
``hot::`` ids, or any explicit id set) so hot lookups come from resident
buffers instead of faulting mapped pages.

Torch-free (stdlib + numpy), like the rest of ``fps_tpu_torch.serve``.
``Tracer`` comes from the submodule ``fps_tpu_torch.obs.trace`` (stdlib
only), imported by its full name: the package attribute
``fps_tpu_torch.obs.trace`` is the profiler's context manager.
"""

from __future__ import annotations

import json
import logging
import os
import tempfile
import threading
import time

import numpy as np

from fps_tpu_torch.core import retry as _retry
from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.obs.trace import Tracer
from fps_tpu_torch.serve.snapshot import ServableSnapshot, SnapshotRejected
from fps_tpu_torch.serve.server import ReadServer
from fps_tpu_torch.serve.watcher import SnapshotWatcher, _emit_event, \
    _emit_metric

__all__ = ["StepFence", "FleetReader", "ServingFleet", "ReadAutoscaler",
           "tiering_hot_ids", "scan_heartbeats", "liveness_check"]

FLEET_DIR = "fleet"
FENCE_NAME = "serve_fence.json"

# Liveness defaults: beacons ride the fleet dir (atomic-rename JSON like
# everything here) at HEARTBEAT_INTERVAL_S; a reader whose newest beacon
# is older than DEFAULT_LIVENESS_TIMEOUT_S is classified reader_wedged —
# an INCIDENT the supervisor restarts, never a silent 0 q/s.
HEARTBEAT_INTERVAL_S = 1.0
DEFAULT_LIVENESS_TIMEOUT_S = 5.0


def _atomic_write_json(path: str, obj: dict) -> None:
    # Deliberately a local twin of the reference supervisor's helpers
    # (fps_tpu/supervise/), which load BY FILE PATH with zero package
    # imports, so the fence files are written the same way by both.
    _retry.fault_check("write", path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.json")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f)
            f.flush()
            _retry.fault_check("fsync", path)
            os.fsync(f.fileno())
        _retry.fault_check("replace", path)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _read_json(path: str) -> dict | None:
    try:
        path = _retry.read_path(path)  # stale read-after-rename seam
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


class StepFence:
    """The shared fleet fence + this reader's readiness slot.

    The fence value is a ``(epoch, step)`` pair ordered
    lexicographically: higher epoch wins outright (a coordinated
    rollback), otherwise higher step wins (normal forward motion). Each
    reader clamps to the maximum pair it has ever OBSERVED, so a
    last-writer-wins race between two advancing readers (both writing
    quorum-backed values) can never move any observer backward within an
    epoch.
    """

    def __init__(self, ckpt_dir: str, reader_id: str):
        self.dir = os.path.join(ckpt_dir, FLEET_DIR)
        self.reader_id = str(reader_id)
        os.makedirs(self.dir, exist_ok=True)
        self._seen = (0, -1)  # max (epoch, step) ever observed
        self._last_ready: int | None = None  # skip unchanged rewrites
        # Transient fence-I/O failures (storage brownout): every write
        # here is re-attempted by the next poll tick anyway, so a
        # failed one is counted and SKIPPED — degraded liveness, never
        # a crashed poller or a split-brain (reads clamp to the max
        # observed pair regardless of what lands on disk when).
        self.io_errors = 0

    @property
    def fence_path(self) -> str:
        return os.path.join(self.dir, FENCE_NAME)

    def _ready_path(self, reader_id: str) -> str:
        return os.path.join(self.dir, f"ready_{reader_id}.json")

    # -- observation -------------------------------------------------------

    def read(self) -> tuple[int, int] | None:
        """Current effective fence as ``(epoch, step)`` (clamped to the
        max ever observed), or None before the first advance. A FILE
        regressed below this reader's max (a racing advance's
        last-writer-wins clobbering a rollback's epoch bump) is
        REPAIRED back up — anti-entropy, so peers that never observed
        the higher pair converge instead of serving past it."""
        rec = _read_json(self.fence_path)
        pair = None
        if rec is not None:
            try:
                pair = (int(rec["epoch"]), int(rec["step"]))
            except (KeyError, TypeError, ValueError):
                pair = None
        if pair is not None and pair > self._seen:
            self._seen = pair
        elif (pair is not None and pair < self._seen
                and self._seen[1] >= 0):
            try:
                _atomic_write_json(self.fence_path,
                                   {"epoch": self._seen[0],
                                    "step": self._seen[1],
                                    "by": self.reader_id,
                                    "repair": True})
            except OSError:
                self.io_errors += 1  # anti-entropy retried next read
        return self._seen if self._seen[1] >= 0 else None

    # -- participation -----------------------------------------------------

    def ready(self, step: int) -> None:
        """Record the newest step THIS reader has verified locally.
        Idempotent per step: an unchanged readiness is not rewritten —
        the poll loop calls this every tick, and ~20 fsync'd renames per
        second per reader against a (possibly networked) shared
        filesystem would be pure churn."""
        if self._last_ready == int(step):
            return
        try:
            _atomic_write_json(self._ready_path(self.reader_id),
                               {"reader": self.reader_id,
                                "step": int(step), "t": time.time()})
        except OSError:
            self.io_errors += 1
            return  # _last_ready stays unset: retried next tick
        self._last_ready = int(step)

    def ready_steps(self) -> dict[str, int]:
        out: dict[str, int] = {}
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return out
        for f in names:
            if not (f.startswith("ready_") and f.endswith(".json")):
                continue
            rec = _read_json(os.path.join(self.dir, f))
            if rec is None:
                continue
            try:
                out[str(rec["reader"])] = int(rec["step"])
            except (KeyError, TypeError, ValueError):
                continue
        return out

    def advance(self, quorum: int, *, max_step: int | None = None
                ) -> tuple[int, int] | None:
        """Advance the fence to the highest step at least ``quorum``
        readers are ready on (forward-monotone within the current
        epoch); returns the effective fence either way. ``max_step``
        caps the target at the ADVANCING reader's own verified step —
        after a coordinated rollback, peers' not-yet-refreshed readiness
        slots (still naming the quarantined step) must not be able to
        drag the fence forward past what this reader just verified."""
        cur = self.read()
        steps = sorted(self.ready_steps().values(), reverse=True)
        if len(steps) >= max(1, quorum):
            target = steps[max(0, quorum - 1)]
            if max_step is not None:
                target = min(target, int(max_step))
            epoch = cur[0] if cur is not None else 0
            if cur is None or target > cur[1]:
                try:
                    _atomic_write_json(self.fence_path,
                                       {"epoch": int(epoch),
                                        "step": int(target),
                                        "by": self.reader_id})
                    self._seen = max(self._seen, (epoch, target))
                except OSError:
                    self.io_errors += 1  # fence unchanged; next tick
        return self.read()

    def rollback(self, step: int) -> tuple[int, int]:
        """Coordinated BACKWARD fence move (served step quarantined):
        bump the epoch so every reader accepts the lower step as a
        deliberate rollback, never as a stale write."""
        cur = self.read()
        epoch = (cur[0] if cur is not None else 0) + 1
        try:
            _atomic_write_json(self.fence_path,
                               {"epoch": int(epoch), "step": int(step),
                                "by": self.reader_id, "rollback": True})
        except OSError:
            # Count and adopt the bumped pair LOCALLY anyway: this
            # reader must stop serving the dead step now; the on-disk
            # fence converges via read()'s anti-entropy repair (the
            # rollback is re-asserted every poll regardless).
            self.io_errors += 1
        self._seen = (epoch, int(step))
        return self._seen


def tiering_hot_ids(ckpt_dir: str, table: str | None = None) -> dict:
    """Warm-cache admission from the adaptive tier's frequency ranking:
    the newest ``tiering-*.npz`` sidecar's ``hot::<table>`` id arrays
    (``fps_tpu_torch.tiering.Retierer`` writes them beside the checkpoints).
    Returns ``{table: ids}`` (optionally filtered to one table); empty
    when no sidecar exists — warm caching simply stays off."""
    import re

    sidecar_re = re.compile(r"tiering-(\d+)\.npz")
    newest, newest_step = None, -1
    try:
        names = os.listdir(ckpt_dir)
    except FileNotFoundError:
        return {}
    for f in names:
        m = sidecar_re.fullmatch(f)
        if m and int(m.group(1)) > newest_step:
            newest, newest_step = os.path.join(ckpt_dir, f), int(m.group(1))
    if newest is None:
        return {}
    out: dict[str, np.ndarray] = {}
    try:
        with np.load(newest) as z:
            for k in z.files:
                if k.startswith("hot::"):
                    name = k[len("hot::"):]
                    if table is None or name == table:
                        out[name] = np.asarray(z[k], np.int64)
    except (OSError, *fmt.IO_ERRORS):
        return {}
    return out


class FleetReader:
    """One member of the serving fleet: a ReadServer whose hot-swaps are
    gated on the shared step fence.

    ``poll()`` drives everything: candidate discovery/verification (the
    embedded :class:`SnapshotWatcher` — including delta chains and
    quarantine tracking), readiness publication, fence advancement, and
    the actual server swap to the fence step. Construction re-reads the
    fence FIRST: a reader restarted mid-swap never answers a step older
    than the fleet's published fence.

    ``shadow=True`` gates the reader on the tenant's shadow-serving
    promotion record (:class:`~fps_tpu_torch.serve.shadow.ShadowGate`):
    readiness and fence advancement are capped at the newest APPROVED
    step, so a publication the scorer held (or has not judged yet) is
    invisible to the fleet — it keeps serving the old approved step.
    Lost freshness, never wrong answers (docs/STALENESS.md).
    """

    def __init__(self, ckpt_dir: str, reader_id: str, *, quorum: int = 1,
                 journal: str | None = None, recorder=None,
                 warm_from=None, verify: bool = True,
                 heartbeat_interval_s: float = HEARTBEAT_INTERVAL_S,
                 shadow: bool = False):
        self.ckpt_dir = ckpt_dir
        self.reader_id = str(reader_id)
        self.quorum = int(quorum)
        if shadow:
            from fps_tpu_torch.serve.shadow import ShadowGate
            self.shadow_gate = ShadowGate(ckpt_dir)
        else:
            self.shadow_gate = None
        self.recorder = recorder
        self.verify = verify
        # warm_from: None | {table: ids} | "tiering" (sidecar ranking).
        self.warm_from = warm_from
        self.server = ReadServer(recorder=recorder)
        self.fence = StepFence(ckpt_dir, reader_id)
        self._candidate: ServableSnapshot | None = None
        self._rollback_due = False
        self.fence_swaps = 0
        self.poll_errors = 0  # transient poll failures (loop survives)
        self.served_steps: list[int] = []  # trail for the chaos harness
        # Liveness beacon state: throttled (one fsync'd rename per
        # interval, not per poll tick — the same churn argument as
        # StepFence.ready), best-effort (a storage fault skips one
        # beacon, counted, and the next interval retries — a brownout
        # must not impersonate a wedged reader any longer than it
        # actually lasts).
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self._last_hb = 0.0
        self.hb_errors = 0
        self.polls = 0
        self.born = time.time()  # boot-grace anchor for liveness
        self.watcher = SnapshotWatcher(
            ckpt_dir, journal=journal, recorder=recorder,
            on_swap=self._on_candidate, verify=verify)
        # Boot protocol: observe the existing fence before serving
        # anything — the restart-never-regresses half of the contract.
        self.fence.read()

    # -- candidate tracking (watcher callback) -----------------------------

    def _on_candidate(self, snap: ServableSnapshot, direction: str):
        self._candidate = snap
        if direction == "backward":
            # The watcher only ever swaps backward past a quarantine /
            # vanish of the served candidate: propose a coordinated
            # fence rollback instead of silently diverging.
            self._rollback_due = True

    def _fence_step_dead(self, step: int) -> bool:
        """True when the fence names a step this reader can PROVE is no
        longer servable: quarantined — its own ``*.corrupt`` marker or
        one on a chain link. Persistent on-disk evidence only: "absent
        from my last scan" is NOT proof (a reader whose scan is one
        poll stale would spuriously epoch-bump a fence its peers just
        legitimately advanced — a backward fleet swap off a live step).
        A step swept with no marker at all simply holds the fence until
        newer publications advance it: lost liveness, never
        split-brain."""
        w = self.watcher
        return step in w._quarantined or w._chain_quarantined(step)

    # -- the poll ----------------------------------------------------------

    def poll(self) -> int | None:
        """One pass: verify candidates, publish readiness, advance (or
        roll back) the fence, swap the server to the fence step. Returns
        the served step (None while nothing servable). Transient
        filesystem errors degrade (served state unchanged, counted in
        ``poll_errors`` / ``storage.poll_errors{plane=fleet}``) —
        a storage brownout must never freeze or crash a reader."""
        self.polls += 1
        try:
            served = self._poll_once()
        except OSError as e:
            self.poll_errors += 1
            _emit_metric(self.recorder, "inc", "storage.poll_errors", 1,
                         plane="fleet")
            logging.getLogger("fps_tpu_torch.serve.fleet").warning(
                "fleet reader %s poll degraded (serving last-good): %r",
                self.reader_id, e)
            snap = self.server._snap
            served = None if snap is None else snap.step
        # Beacon AFTER the poll body, degraded or not: liveness means
        # "this reader's loop is turning", not "storage is healthy" —
        # a reader surviving a brownout is alive, a SIGSTOPped or
        # deadlocked one is not, and only the latter must trip the
        # reader_wedged classification.
        self._beat(served)
        return served

    # -- liveness beacon ----------------------------------------------------

    @property
    def heartbeat_path(self) -> str:
        return os.path.join(self.fence.dir,
                            f"heartbeat_{self.reader_id}.json")

    def _beat(self, served) -> None:
        now = time.time()
        if now - self._last_hb < self.heartbeat_interval_s:
            return
        beat = {"reader": self.reader_id, "t": now,
                "step": None if served is None else int(served),
                "requests": int(self.server.requests),
                "polls": int(self.polls)}
        try:
            _atomic_write_json(self.heartbeat_path, beat)
        except OSError:
            self.hb_errors += 1  # best-effort: next interval retries
            return
        self._last_hb = now
        # The beacon rides the obs journal too, so a journal-only
        # post-mortem (obs_report) can reconstruct per-reader liveness
        # without the fleet dir.
        _emit_event(self.recorder, "serve.reader_heartbeat",
                    reader=self.reader_id, step=beat["step"],
                    requests=beat["requests"])

    def _poll_once(self) -> int | None:
        self.watcher.poll()
        cand = self._candidate
        # Shadow gating: readiness AND fence advancement are capped at
        # the approved step. While nothing is approved a gated reader
        # neither declares readiness nor advances — stale readiness
        # slots (a gate enabled over an existing fleet dir) must not be
        # able to drag the fence past the scorer.
        ready = None if cand is None else cand.step
        advance_cap = ready
        if self.shadow_gate is not None:
            approved = self.shadow_gate.approved_step()
            if approved is None:
                ready = advance_cap = None
            else:
                advance_cap = (approved if ready is None
                               else min(ready, approved))
                ready = None if ready is None else min(ready, approved)
        if ready is not None:
            self.fence.ready(ready)
        cur = self.fence.read()
        # Coordinated rollback, EVIDENCE-based and re-assertable: when
        # the fence names a step this reader's watcher has proven
        # quarantined/unresolvable (persistent on-disk evidence — not a
        # one-shot flag), bump the epoch down to the surviving
        # candidate. Re-checked every poll, so a racing advance that
        # clobbers the rollback write gets rolled back again until the
        # fleet converges.
        if (cand is not None and cur is not None
                and cand.step < cur[1]
                and (self._rollback_due
                     or self._fence_step_dead(cur[1]))):
            cur = self.fence.rollback(cand.step)
        self._rollback_due = False
        if self.shadow_gate is None or advance_cap is not None:
            cur = self.fence.advance(self.quorum, max_step=advance_cap)
        self._apply_fence(cur)
        snap = self.server._snap
        return None if snap is None else snap.step

    def _apply_fence(self, fence: tuple[int, int] | None) -> None:
        if fence is None:
            return
        _epoch, step = fence
        # Gauge every poll, not just on swaps: the fleet fence-lag SLO
        # (obs_report --fleet) compares the LAST sample per window
        # against the newest published step — a fence STALLED behind
        # failing readiness writes must keep reporting its (stale)
        # step, or the lag rollup goes blind in exactly the windows
        # the SLO exists for.
        _emit_metric(self.recorder, "set", "serve.fence_step",
                     float(step))
        snap = self.server._snap
        if snap is not None and snap.step == step:
            return
        cand = self._candidate
        nxt = None
        if cand is not None and cand.step == step:
            nxt = cand
        else:
            # The fence names a step this reader hasn't verified as its
            # newest candidate (it is behind, ahead, or freshly booted):
            # open that exact step from the shared dir — chains welcome.
            try:
                nxt = ServableSnapshot.open_chain(self.ckpt_dir, step,
                                                  verify=self.verify)
            except (FileNotFoundError, SnapshotRejected):
                if snap is not None and snap.step > step:
                    # The fence moved BACKWARD (coordinated quarantine
                    # rollback) and the lower step isn't openable yet:
                    # answering from the old higher step would serve the
                    # quarantined state the fence just rolled past.
                    # Refuse (NoSnapshotError to clients) until a poll
                    # can open the fence step — behind is lag, ahead is
                    # split-brain.
                    self.server.swap_to(None)
                return  # otherwise hold the current (older) snapshot
        if self.warm_from is not None:
            ids = (tiering_hot_ids(self.ckpt_dir)
                   if self.warm_from == "tiering" else self.warm_from)
            if ids:
                nxt = nxt.warmed(ids)
        self.server.swap_to(nxt)
        self.fence_swaps += 1
        self.served_steps.append(int(step))

    def stats(self) -> dict:
        snap = self.server._snap
        return {
            "reader": self.reader_id,
            "step": None if snap is None else snap.step,
            "fence": self.fence.read(),
            "fence_swaps": self.fence_swaps,
            "chain_len": None if snap is None else snap.chain_len,
            "warm_rows": 0 if snap is None else snap.warm_rows,
            **self.server.stats(),
        }


class ServingFleet:
    """N fence-coordinated readers over one snapshot dir (the bench and
    chaos harness topology; production runs one FleetReader per serving
    process over a shared filesystem).

    ``quorum`` defaults to a majority of the fleet — the fence advances
    once most readers verified a step, and laggards converge to it.
    Membership is DYNAMIC: :meth:`add_reader` / :meth:`remove_reader`
    grow and shrink a running fleet (the autoscaler's levers); a
    default (majority) quorum re-derives on every membership change,
    an explicit quorum stays pinned until :meth:`set_quorum`."""

    def __init__(self, ckpt_dir: str, n_readers: int = 3, *,
                 quorum: int | None = None, journal: str | None = None,
                 recorder=None, warm_from=None, verify: bool = True,
                 shadow: bool = False):
        if n_readers < 1:
            raise ValueError(f"n_readers must be >= 1, got {n_readers}")
        self.ckpt_dir = ckpt_dir
        self.recorder = recorder
        # Reader construction kwargs, kept so add_reader() builds
        # members identical to the ctor's.
        self._reader_kw = {"journal": journal, "recorder": recorder,
                           "warm_from": warm_from, "verify": verify,
                           "shadow": shadow}
        self._auto_quorum = quorum is None
        self.quorum = (n_readers // 2 + 1) if quorum is None else quorum
        self.readers = [
            FleetReader(ckpt_dir, f"r{i}", quorum=self.quorum,
                        **self._reader_kw)
            for i in range(n_readers)
        ]
        self._next_id = n_readers
        self._retired: set[str] = set()
        self._admin_lock = threading.RLock()
        self._threads: list[threading.Thread] = []
        self._started = False
        self._stop = threading.Event()
        self._interval_s = 0.05

    def poll(self) -> None:
        for r in list(self.readers):
            r.poll()

    def start(self, interval_s: float = 0.05) -> None:
        """One polling thread per reader (the fleet topology in one
        process). ``stop()`` joins them."""
        with self._admin_lock:
            self._stop.clear()
            self._started = True
            self._interval_s = interval_s
            self._threads = [
                threading.Thread(target=self._loop, args=(r,),
                                 daemon=True,
                                 name=f"fps-fleet-{r.reader_id}")
                for r in self.readers
            ]
            for t in self._threads:
                t.start()

    def _loop(self, reader) -> None:
        # A method (not a start() closure) so check_liveness can spawn
        # a REPLACEMENT thread for a wedged reader through the same
        # code path.
        log = logging.getLogger("fps_tpu_torch.serve.fleet")
        while not (self._stop.is_set()
                   or reader.reader_id in self._retired):
            try:
                reader.poll()
            except Exception:  # noqa: BLE001 — the loop must live
                # A transient shared-filesystem error (ENOSPC/NFS
                # hiccup in the fence/readiness writes) must not
                # silently kill the poller and freeze this reader on
                # a stale snapshot while its peers move on — log,
                # count, retry next tick.
                reader.poll_errors += 1
                log.exception("fleet reader %s poll failed "
                              "(retrying)", reader.reader_id)
            self._stop.wait(self._interval_s)

    def stop(self, timeout: float = 10.0) -> None:
        self._stop.set()
        with self._admin_lock:
            threads, self._threads = self._threads, []
            self._started = False
        for t in threads:
            t.join(timeout=timeout)

    # -- dynamic membership (the autoscaler's levers) -----------------------

    def set_quorum(self, quorum: int) -> None:
        """Pin an explicit fence quorum on every current member (future
        members inherit it). Auto-majority derivation stops."""
        if quorum < 1:
            raise ValueError(f"quorum must be >= 1, got {quorum}")
        with self._admin_lock:
            self._auto_quorum = False
            self.quorum = int(quorum)
            for r in self.readers:
                r.quorum = self.quorum

    def _requorum(self) -> None:
        # Default quorum follows the membership: a majority of the
        # CURRENT fleet. An explicitly pinned quorum is clamped to the
        # fleet size so a shrink can never make the fence unreachable.
        if self._auto_quorum:
            self.quorum = len(self.readers) // 2 + 1
        else:
            self.quorum = min(self.quorum, len(self.readers))
        for r in self.readers:
            r.quorum = self.quorum

    def add_reader(self, reader_id: str | None = None) -> FleetReader:
        """Spawn one more fence-coordinated reader (and its polling
        thread, when the fleet is running). Its boot protocol re-reads
        the shared fence first, so a scale-up never regresses the
        served step."""
        with self._admin_lock:
            rid = (f"r{self._next_id}" if reader_id is None
                   else str(reader_id))
            self._next_id += 1
            self._retired.discard(rid)
            reader = FleetReader(self.ckpt_dir, rid, quorum=self.quorum,
                                 **self._reader_kw)
            self.readers.append(reader)
            self._requorum()
            if self._started:
                t = threading.Thread(
                    target=self._loop, args=(reader,), daemon=True,
                    name=f"fps-fleet-{reader.reader_id}")
                self._threads.append(t)
                t.start()
            _emit_event(self.recorder, "reader_added", reader=rid,
                        fleet_size=len(self.readers),
                        quorum=self.quorum)
            return reader

    def remove_reader(self, reader_id: str,
                      timeout: float = 5.0) -> bool:
        """Retire one reader: stop its polling thread, drop it from the
        fleet, and delete its readiness/heartbeat slots so the fence
        quorum and the liveness scan stop counting a ghost. The LAST
        reader is never removable — an empty fleet serves nothing."""
        with self._admin_lock:
            idx = next((i for i, r in enumerate(self.readers)
                        if r.reader_id == reader_id), None)
            if idx is None or len(self.readers) <= 1:
                return False
            reader = self.readers.pop(idx)
            self._retired.add(reader.reader_id)
            thread = self._threads.pop(idx) if self._threads else None
            self._requorum()
        if thread is not None:
            thread.join(timeout=timeout)
        # Ghost-slot cleanup is best-effort: a storage hiccup leaves a
        # stale slot the next liveness scan flags — loud, not wrong.
        for path in (reader.fence._ready_path(reader.reader_id),
                     reader.heartbeat_path):
            try:
                os.remove(path)
            except OSError:
                pass
        _emit_event(self.recorder, "reader_removed",
                    reader=reader.reader_id,
                    fleet_size=len(self.readers), quorum=self.quorum)
        return True

    def stats(self) -> list[dict]:
        return [r.stats() for r in self.readers]

    def check_liveness(self, *,
                       timeout_s: float = DEFAULT_LIVENESS_TIMEOUT_S,
                       recorder=None, now=None) -> dict:
        """One liveness pass over this fleet's beacons:
        ``{"ages": {reader: age_s}, "wedged": [...], "restarted":
        [...]}``. Wedged readers whose polling THREAD has died are
        restarted in place (a replacement thread over the same
        FleetReader — its boot protocol re-reads the fence, so the
        restart never regresses). A thread that is still alive but
        silent (stuck in a blocked syscall) cannot be safely doubled
        up in-process: it is reported as the ``reader_wedged``
        incident and left to the process supervisor, exactly like a
        SIGSTOPped reader process."""
        ckpt_dir = self.readers[0].ckpt_dir
        rec = recorder if recorder is not None else (
            self.readers[0].recorder)
        report = liveness_check(
            ckpt_dir, timeout_s=timeout_s, recorder=rec, now=now,
            expected=[r.reader_id for r in self.readers])
        # Boot grace: a reader added moments ago (the autoscaler's
        # scale-up) has not had a beacon interval yet — classifying it
        # wedged would make every scale-up instantly "fail". Younger
        # than the timeout and beaconless is booting, not wedged.
        wall = time.time() if now is None else now
        born = {r.reader_id: r.born for r in self.readers}
        report["wedged"] = [
            rid for rid in report["wedged"]
            if not (report["ages"].get(rid) is None
                    and wall - born.get(rid, 0.0) < timeout_s)]
        restarted = []
        with self._admin_lock:
            if self._threads and report["wedged"]:
                by_id = {r.reader_id: i
                         for i, r in enumerate(self.readers)}
                for reader_id in report["wedged"]:
                    i = by_id.get(reader_id)
                    if i is None or self._threads[i].is_alive():
                        continue
                    reader = self.readers[i]
                    t = threading.Thread(
                        target=self._loop, args=(reader,), daemon=True,
                        name=f"fps-fleet-{reader.reader_id}")
                    self._threads[i] = t
                    t.start()
                    restarted.append(reader_id)
                    _emit_event(rec, "reader_restarted",
                                reader=reader_id)
        report["restarted"] = restarted
        return report


class ReadAutoscaler:
    """Closed-loop sizing for a :class:`ServingFleet`, keyed to the two
    signals that actually mean "capacity" on the read plane:

    * **latency-SLO burn** — the worst per-reader p99 over the retained
      request window against ``latency_slo_s``. Burning latency while
      the fence is FRESH means the readers are compute-bound: spawn one
      more (up to ``max_readers``).
    * **fence lag** — newest published step minus the fence step.
      Burning latency while the fence is STALE means the bottleneck is
      publish/verify/quorum, which another reader cannot fix (and whose
      fence votes would slow): hold instead of thrash.

    Wedged readers (liveness beacons gone silent) are handled first and
    exempt from the cooldown: dead polling threads are restarted in
    place by :meth:`ServingFleet.check_liveness`; a thread that is
    alive-but-silent is REPLACED — a fresh reader joins (re-reading the
    fence at boot, so no regression), then the wedged one is retired so
    quorum stops waiting on a ghost.

    Every :meth:`evaluate` is journaled as a trace SPAN (the same
    causal-tree machinery as pod restart decisions —
    ``fps_tpu_torch.obs.trace``) with the decision and its evidence as
    attributes, plus an ``autoscale_decision`` event and the
    ``serve.fleet_size`` / ``serve.autoscale_actions`` metrics; the
    in-memory :attr:`decisions` trail serves tests and the bench."""

    def __init__(self, fleet: ServingFleet, *, min_readers: int = 1,
                 max_readers: int = 8, latency_slo_s: float = 0.050,
                 fence_lag_slo_steps: float = 8.0,
                 scale_down_fraction: float = 0.25,
                 cooldown_s: float = 5.0,
                 liveness_timeout_s: float = DEFAULT_LIVENESS_TIMEOUT_S,
                 recorder=None):
        if not 1 <= min_readers <= max_readers:
            raise ValueError(
                f"need 1 <= min_readers <= max_readers, got "
                f"[{min_readers}, {max_readers}]")
        self.fleet = fleet
        self.min_readers = int(min_readers)
        self.max_readers = int(max_readers)
        self.latency_slo_s = float(latency_slo_s)
        self.fence_lag_slo_steps = float(fence_lag_slo_steps)
        self.scale_down_fraction = float(scale_down_fraction)
        self.cooldown_s = float(cooldown_s)
        self.liveness_timeout_s = float(liveness_timeout_s)
        self.recorder = (recorder if recorder is not None
                         else fleet.recorder)
        self._tracer = Tracer(self.recorder)
        self._last_scale_mono: float | None = None
        self.decisions: list[dict] = []

    # -- signals ------------------------------------------------------------

    def worst_p99_s(self) -> float | None:
        """Worst per-reader p99 latency over the retained window (None
        until any reader has served requests)."""
        p99s = []
        for r in list(self.fleet.readers):
            lat = r.server.latency_s()
            if lat is not None:
                p99s.append(lat["p99"])
        return max(p99s) if p99s else None

    def fence_lag_steps(self, newest_step: int | None = None
                        ) -> float | None:
        """Newest published step minus the effective fence step.
        ``newest_step`` overrides discovery (the bench/chaos harness
        knows exactly what it published); otherwise the newest
        readiness slot stands in — some reader VERIFIED that step, so
        the fence trailing it is real lag."""
        readers = list(self.fleet.readers)
        if not readers:
            return None
        fence = readers[0].fence.read()
        if newest_step is None:
            steps = readers[0].fence.ready_steps().values()
            newest_step = max(steps, default=None)
        if newest_step is None or fence is None:
            return None
        return float(int(newest_step) - fence[1])

    # -- the control loop body ----------------------------------------------

    def evaluate(self, *, newest_step: int | None = None,
                 now: float | None = None) -> dict:
        """One sizing pass: liveness repair first, then at most ONE
        scale action (cooldown-gated). Returns the decision record
        (also appended to :attr:`decisions` and journaled)."""
        t0 = time.time()
        mono = time.monotonic() if now is None else float(now)
        report = self.fleet.check_liveness(
            timeout_s=self.liveness_timeout_s, recorder=self.recorder)
        replaced = []
        for rid in report["wedged"]:
            if rid in report["restarted"]:
                continue
            # Alive-but-silent thread: replace, never double up on the
            # same FleetReader (check_liveness's contract). Join first,
            # retire after — the fleet never dips below size.
            if len(self.fleet.readers) < self.max_readers + 1:
                fresh = self.fleet.add_reader()
                if self.fleet.remove_reader(rid, timeout=0.5):
                    replaced.append({"wedged": rid,
                                     "replacement": fresh.reader_id})
                    _emit_event(self.recorder, "reader_replaced",
                                wedged=rid,
                                replacement=fresh.reader_id)
        p99 = self.worst_p99_s()
        lag = self.fence_lag_steps(newest_step)
        size = len(self.fleet.readers)
        lag_ok = lag is None or lag <= self.fence_lag_slo_steps
        cooled = (self._last_scale_mono is None
                  or mono - self._last_scale_mono >= self.cooldown_s)
        action, reason, target = "hold", "within slo", None
        if replaced:
            action = "replace"
            reason = f"replaced wedged reader(s): " \
                     f"{[r['wedged'] for r in replaced]}"
        elif (p99 is not None and p99 > self.latency_slo_s
                and not lag_ok):
            reason = (f"latency burn (p99 {p99:.4f}s) but fence lag "
                      f"{lag:.0f} steps over slo — publish-bound, "
                      "another reader won't help")
        elif (p99 is not None and p99 > self.latency_slo_s
                and size < self.max_readers and cooled):
            action, reason = "scale_up", (
                f"p99 {p99:.4f}s over slo {self.latency_slo_s:.4f}s "
                f"with fresh fence")
            target = self.fleet.add_reader().reader_id
            self._last_scale_mono = mono
        elif (p99 is not None and size > self.min_readers and cooled
                and p99 < self.scale_down_fraction * self.latency_slo_s):
            victim = self.fleet.readers[-1].reader_id
            if self.fleet.remove_reader(victim):
                action, reason, target = "scale_down", (
                    f"p99 {p99:.4f}s under "
                    f"{self.scale_down_fraction:.0%} of slo"), victim
                self._last_scale_mono = mono
        decision = {
            "t": t0, "action": action, "reason": reason,
            "target": target, "replaced": replaced,
            "fleet_size": len(self.fleet.readers),
            "quorum": self.fleet.quorum,
            "worst_p99_s": p99, "fence_lag_steps": lag,
            "wedged": report["wedged"],
            "restarted": report["restarted"],
        }
        self.decisions.append(decision)
        # Journal the decision as a causal span + event + gauges: the
        # autoscaler's choices must be post-mortem-able from the obs
        # journal alone, exactly like pod restart decisions.
        self._tracer.emit("autoscale_evaluate", t0, time.time(),
                          action=action, reason=reason, target=target,
                          fleet_size=decision["fleet_size"],
                          worst_p99_s=p99, fence_lag_steps=lag)
        _emit_event(self.recorder, "autoscale_decision", **{
            k: v for k, v in decision.items() if k != "t"})
        _emit_metric(self.recorder, "set", "serve.fleet_size",
                     float(decision["fleet_size"]))
        if action != "hold":
            _emit_metric(self.recorder, "inc",
                         "serve.autoscale_actions", 1, action=action)
        return decision


def scan_heartbeats(ckpt_dir: str, *, now=None) -> dict:
    """Read every ``heartbeat_<id>.json`` beacon under
    ``<ckpt_dir>/fleet/``: ``{reader: {"t", "step", "requests",
    "polls", "age_s"}}``. File-based on purpose — the monitor side
    (supervisor, bench, chaos harness) runs in a DIFFERENT process
    than the readers it is judging, and a SIGSTOPped reader cannot
    lie through a file it can no longer write."""
    now = time.time() if now is None else now
    out: dict[str, dict] = {}
    fleet_dir = os.path.join(ckpt_dir, FLEET_DIR)
    try:
        names = os.listdir(fleet_dir)
    except FileNotFoundError:
        return out
    for f in names:
        if not (f.startswith("heartbeat_") and f.endswith(".json")):
            continue
        rec = _read_json(os.path.join(fleet_dir, f))
        if rec is None:
            continue
        try:
            reader = str(rec["reader"])
            t = float(rec["t"])
        except (KeyError, TypeError, ValueError):
            continue
        out[reader] = {"t": t, "step": rec.get("step"),
                       "requests": rec.get("requests"),
                       "polls": rec.get("polls"),
                       "age_s": max(0.0, now - t)}
    return out


def liveness_check(ckpt_dir: str, *,
                   timeout_s: float = DEFAULT_LIVENESS_TIMEOUT_S,
                   recorder=None, now=None,
                   expected=None) -> dict:
    """Classify fleet liveness from the beacons: a reader whose newest
    beacon is older than ``timeout_s`` — or, with ``expected`` ids
    given, one that never wrote a beacon at all — is WEDGED. Each pass
    gauges ``serve.reader_heartbeat_age_s`` per reader (the staleness
    SLO input) and journals one ``reader_wedged`` incident per wedged
    reader; returns ``{"ages": {reader: age_s}, "wedged": [ids]}``.
    A wedged reader is an INCIDENT the supervisor acts on, never a
    silent zero in a bench average."""
    beats = scan_heartbeats(ckpt_dir, now=now)
    ages = {r: b["age_s"] for r, b in beats.items()}
    wedged = sorted(r for r, age in ages.items() if age > timeout_s)
    for missing in sorted(set(expected or ()) - set(ages)):
        ages[missing] = None
        wedged.append(missing)
    for reader, age in sorted(ages.items()):
        if age is not None:
            _emit_metric(recorder, "set",
                         "serve.reader_heartbeat_age_s", float(age),
                         reader=reader)
    for reader in wedged:
        _emit_event(recorder, "reader_wedged", reader=reader,
                    age_s=ages.get(reader), timeout_s=timeout_s)
    return {"ages": ages, "wedged": wedged}
