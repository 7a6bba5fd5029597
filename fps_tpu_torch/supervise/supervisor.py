"""External run supervisor: deadline abort, retry with backoff, quarantine.

Port of ``fps_tpu/supervise/supervisor.py``. ``StepWatchdog`` can flag a
stalled chunk, but Python cannot preempt a thread wedged in a collective
or a CUDA call: the training process has no lever left. The deadline
ABORT therefore lives one level up, in a separate OS process that:

* launches the training run as a child (its own session and process
  group);
* tails a **heartbeat file** (:mod:`fps_tpu_torch.supervise.child`) and
  any watched journal files as the liveness signal;
* on a stalled signal or an exhausted wall-clock budget, aborts the child
  with **SIGTERM, a grace period, then SIGKILL** against the whole process
  group: SIGKILL is the only signal a group wedged in a collective (or
  SIGSTOP'd outright) cannot ignore, and only it frees a stopped child's
  CUDA context. The killed attempt is reaped before the next is spawned;
* restarts the child with **exponential backoff** under a bounded retry
  budget: the child finds ``latest_valid_step`` in its checkpoint
  directory and resumes;
* **quarantines deterministic poison**: when consecutive attempts die at
  the same progress index, that index is recorded in a state file next to
  the checkpoint directory and exported to the next attempt
  (``RollbackPolicy(preset=...)`` skips it), so a poison batch that
  crashes the worker cannot crash-loop the run.

Stdlib-only: the supervisor runs beside a job that owns the card without
importing torch. ``fps_tpu_torch/examples/supervise.py`` loads this module
by file path for that reason. The state file, journal, digest and env
contract are the reference's, so ``tools/obs_report.py`` folds this
supervisor's journal and either package's supervisor drives either
package's child. Every decision is journaled (JSONL, one fsync'd line an
event).
"""

from __future__ import annotations

import dataclasses
import glob as _glob
import hashlib
import json
import os
import signal
import subprocess
import tempfile
import time

STATE_FILENAME = "supervisor_state.json"
HEARTBEAT_FILENAME = "heartbeat.json"
JOURNAL_FILENAME = "journal-supervisor.jsonl"

# Child env contract, MIRRORED from fps_tpu_torch/supervise/child.py (which
# the training child imports), because this module loads by file path with
# no package import (the package's __init__ imports torch).
# tests/test_torch_supervise.py asserts they match.
HEARTBEAT_ENV = "FPS_TPU_HEARTBEAT"
STATE_ENV = "FPS_TPU_SUPERVISOR_STATE"
ATTEMPT_ENV = "FPS_TPU_ATTEMPT"

# Causal-tracing contract, mirrored from fps_tpu_torch/obs/trace.py and
# fps_tpu_torch/supervise/child.py (the same loadable-by-path reason). The supervisor stamps
# trace_id/span_id/parent_id on its attempt_start/attempt_end journal
# events and hands each child its attempt's span id, so the child's run
# journal links under the attempt and tools/trace_export.py can render
# the whole supervised run as one span tree.
TRACE_ID_ENV = "FPS_TPU_TRACE_ID"
PARENT_SPAN_ENV = "FPS_TPU_PARENT_SPAN"


def _mint_id(bits: int = 64) -> str:
    """A fresh random hex id (uuid4-backed, stdlib-only)."""
    import uuid

    return uuid.uuid4().hex[: bits // 4]

# Heartbeat schema this supervisor understands — mirrored from child.py
# (same loadable-by-path reason as the env contract above). Beats wearing
# any other version are rejected loudly, never misparsed.
HEARTBEAT_VERSION = 2

# supervisor_state.json schema. Version-less files are the v1 layout
# (every field this loader defaults); a FUTURE version means a newer
# supervisor owns this state dir and silently reinterpreting its file
# could un-quarantine poison — refuse loudly instead.
STATE_SCHEMA_VERSION = 2

# The quarantine list is append-only evidence; a long pod run hitting a
# drifting poison source could otherwise grow it without bound (and the
# state file with it, rewritten every attempt). Oldest entries evict
# first — they describe chunks the run has long replayed past.
QUARANTINE_CAP = 256


@dataclasses.dataclass(frozen=True)
class SupervisorConfig:
    """Deadline/retry policy knobs.

    ``stall_timeout_s`` is the liveness deadline BETWEEN progress signals
    (heartbeat mtime change or watched-file growth); ``startup_grace_s``
    replaces it for the FIRST signal of each attempt, because a cold
    start pays the interpreter, the torch import, CUDA initialisation and
    the kernels' library load before the first chunk can beat (None: use
    ``stall_timeout_s``).
    ``wall_deadline_s`` bounds the whole supervised run across attempts
    and backoffs (None: unbounded). ``max_restarts`` is the retry budget
    — the first launch is free, every relaunch spends one.
    ``quarantine_after`` consecutive failures at the same progress index
    quarantine that index (persisted, exported to later attempts).
    """

    stall_timeout_s: float = 120.0
    startup_grace_s: float | None = None
    wall_deadline_s: float | None = None
    max_restarts: int = 3
    backoff_base_s: float = 1.0
    backoff_factor: float = 2.0
    backoff_max_s: float = 60.0
    # Bounded jitter fraction applied by RunSupervisor.backoff_s on top
    # of the exponential schedule: each backoff lands in
    # [base, base * (1 + jitter)], deterministically derived from the
    # supervisor's state_dir — N hosts of a pod restarting after a
    # coordinated abort then hit the shared filesystem desynchronized
    # instead of in lockstep, while any ONE host's schedule stays exactly
    # reproducible across reruns.
    backoff_jitter: float = 0.25
    term_grace_s: float = 5.0
    poll_interval_s: float = 0.25
    quarantine_after: int = 2

    def __post_init__(self):
        if not self.stall_timeout_s > 0:
            raise ValueError(
                f"stall_timeout_s must be > 0, got {self.stall_timeout_s}")
        if self.max_restarts < 0:
            raise ValueError(
                f"max_restarts must be >= 0, got {self.max_restarts}")
        if self.quarantine_after < 1:
            raise ValueError(
                f"quarantine_after must be >= 1, got {self.quarantine_after}")
        if not 0 <= self.backoff_jitter <= 1:
            raise ValueError(
                f"backoff_jitter must be in [0, 1], got {self.backoff_jitter}")

    def backoff_s(self, restart: int) -> float:
        """Deterministic exponential backoff before relaunch ``restart``
        (0-based): base * factor**restart, capped. Jitter-free — the
        per-host jittered schedule is :meth:`RunSupervisor.backoff_s`."""
        return min(self.backoff_max_s,
                   self.backoff_base_s * self.backoff_factor ** restart)


def _atomic_write_json(path: str, obj: dict) -> None:
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump(obj, f, indent=1)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


class RunSupervisor:
    """Supervise one training command to completion or exhaustion.

    Args:
      cmd: argv of the training child — identical every attempt; the
        child derives per-attempt behavior from its checkpoint dir
        (``latest_valid_step`` resume) and the exported env contract
        (:mod:`fps_tpu_torch.supervise.child`).
      state_dir: where the supervisor persists its state file, heartbeat,
        journal, and per-attempt child logs — conventionally the
        checkpoint dir itself or a sibling, so quarantine decisions live
        (and survive) next to the snapshots they protect.
      config: the :class:`SupervisorConfig` policy.
      watch: extra glob patterns whose matched files' growth also counts
        as liveness (point one at ``<obs-dir>/journal-p*.jsonl`` and the
        run journal's per-boundary flushes become the signal, heartbeat
        or no heartbeat).
      env: extra environment for the child (merged over os.environ; the
        heartbeat/state/attempt contract vars are always set on top).
      cwd: child working directory.
    """

    def __init__(self, cmd: list[str], *, state_dir: str,
                 config: SupervisorConfig | None = None,
                 watch: tuple[str, ...] = (),
                 env: dict | None = None, cwd: str | None = None,
                 host: str | None = None):
        self.cmd = list(cmd)
        self.config = config or SupervisorConfig()
        self.state_dir = state_dir
        os.makedirs(state_dir, exist_ok=True)
        self.state_path = os.path.join(state_dir, STATE_FILENAME)
        self.heartbeat_path = os.path.join(state_dir, HEARTBEAT_FILENAME)
        self.journal_path = os.path.join(state_dir, JOURNAL_FILENAME)
        self.watch = tuple(watch)
        self.env = dict(env or {})
        self.cwd = cwd
        # Pod member identity: when set, only beats carrying this host
        # (or none) count — a beat from another pod member's child that
        # lands in this file by misconfiguration is rejected loudly.
        self.host = host
        # (mtime) of beats already reported bad — one loud event per
        # distinct rejected beat, not one per poll.
        self._rejected_beats: set = set()
        # Causal tracing: inherit the trace from the environment (a pod
        # member re-inherits the pod's trace via the control record) or
        # mint a fresh one; the supervisor's own run is a span under the
        # inherited parent, and every attempt is a span under that.
        self.trace_id = os.environ.get(TRACE_ID_ENV) or _mint_id(128)
        self.trace_parent = os.environ.get(PARENT_SPAN_ENV) or None
        self.run_span = _mint_id()
        self._attempt_span = None  # minted per attempt, pre-spawn
        self.state = self._load_state()

    def backoff_s(self, restart: int) -> float:
        """The per-host jittered backoff schedule: the config's
        exponential base stretched by a bounded factor in
        ``[1, 1 + backoff_jitter]`` derived deterministically from
        ``(state_dir, restart)``. Same state_dir ⇒ the exact same
        schedule on every rerun (replayable chaos tests); different
        state_dirs (= different pod members) ⇒ desynchronized restarts
        after a pod-wide abort."""
        base = self.config.backoff_s(restart)
        if not self.config.backoff_jitter:
            return base
        seed = f"{os.path.abspath(self.state_dir)}:{restart}".encode()
        u = int.from_bytes(hashlib.sha256(seed).digest()[:8], "big")
        u /= float(1 << 64)  # [0, 1)
        return base * (1.0 + self.config.backoff_jitter * u)

    # -- persisted state ---------------------------------------------------

    def _load_state(self) -> dict:
        try:
            with open(self.state_path, encoding="utf-8") as f:
                state = json.load(f)
        except (OSError, json.JSONDecodeError):
            state = {}
        # Migration guard: version-less files are the v1 layout, loadable
        # by defaulting every newer field (below). A FUTURE schema means a
        # newer supervisor owns this dir — reinterpreting its fields here
        # could silently drop quarantine evidence, so refuse loudly.
        found = int(state.get("schema", 1))
        if found > STATE_SCHEMA_VERSION:
            raise ValueError(
                f"{self.state_path} has schema v{found}, this supervisor "
                f"understands <= v{STATE_SCHEMA_VERSION} — refusing to "
                "reinterpret a newer supervisor's state"
            )
        state["schema"] = STATE_SCHEMA_VERSION
        state.setdefault("restarts", 0)
        state.setdefault("quarantined", [])
        state.setdefault("attempts", [])
        state.setdefault("heartbeat_rejected", 0)
        return state

    def _save_state(self) -> None:
        _atomic_write_json(self.state_path, self.state)

    def _cap_quarantine(self) -> None:
        """Bound the quarantine list at :data:`QUARANTINE_CAP`, evicting
        OLDEST-first (append order): ancient entries describe chunks the
        run replayed past long ago, while the newest entries are the ones
        protecting the current resume window."""
        q = self.state["quarantined"]
        if len(q) <= QUARANTINE_CAP:
            return
        evicted, self.state["quarantined"] = q[:-QUARANTINE_CAP], q[-QUARANTINE_CAP:]
        self._event("quarantine_evicted", evicted=evicted,
                    cap=QUARANTINE_CAP)

    def _event(self, etype: str, **fields) -> None:
        rec = {"kind": "event", "t": time.time(), "event": etype, **fields}
        with open(self.journal_path, "a", encoding="utf-8") as f:
            f.write(json.dumps(rec) + "\n")
            f.flush()
            os.fsync(f.fileno())

    # -- liveness ----------------------------------------------------------

    def _read_heartbeat(self):
        """(mtime, index, phase) of the heartbeat file, or three Nones.

        ``phase`` is the optional sub-chunk boundary the child last
        crossed (the drivers beat ``prefetch``/``ingest``/``dispatch``
        between chunk boundaries) — it sharpens where an attempt died
        without changing the index-keyed quarantine logic.

        Schema hardening: a beat wearing an unknown ``version``, or a
        ``host`` other than this supervisor's (a cross-host collision in
        a shared pod dir), is REJECTED — one loud ``heartbeat_rejected``
        journal event + persisted counter per distinct beat — and never
        counts as liveness or progress."""
        try:
            mtime = os.path.getmtime(self.heartbeat_path)
            with open(self.heartbeat_path, encoding="utf-8") as f:
                rec = json.load(f)
        except (OSError, json.JSONDecodeError):
            return None, None, None
        reason = None
        version = rec.get("version") if isinstance(rec, dict) else None
        if not isinstance(rec, dict) or version != HEARTBEAT_VERSION:
            reason = f"unknown heartbeat version {version!r}"
        elif self.host is not None and rec.get("host") not in (None,
                                                               self.host):
            reason = (f"beat from host {rec.get('host')!r}, "
                      f"this supervisor is {self.host!r}")
        if reason is not None:
            if mtime not in self._rejected_beats:
                if len(self._rejected_beats) > 512:
                    self._rejected_beats.clear()  # bound the dedupe memory
                self._rejected_beats.add(mtime)
                self.state["heartbeat_rejected"] = (
                    int(self.state.get("heartbeat_rejected", 0)) + 1)
                self._save_state()
                self._event("heartbeat_rejected", reason=reason,
                            path=self.heartbeat_path,
                            beat={k: rec.get(k) for k in
                                  ("version", "host", "index", "pid")}
                            if isinstance(rec, dict) else None)
            return None, None, None
        return mtime, rec.get("index"), rec.get("phase")

    def _watch_fingerprint(self):
        """Size+mtime fingerprint over the watched globs — any change in
        the run's journal/event files counts as life."""
        fp = []
        for pattern in self.watch:
            for path in sorted(_glob.glob(pattern)):
                try:
                    st = os.stat(path)
                    fp.append((path, st.st_size, st.st_mtime))
                except OSError:
                    continue
        return tuple(fp)

    # -- child control -----------------------------------------------------

    def _child_env(self, attempt: int) -> dict:
        """Environment for one attempt — subclass hook (the pod member
        adds the pod membership contract on top)."""
        env = dict(os.environ)
        env.update(self.env)
        env[HEARTBEAT_ENV] = self.heartbeat_path
        env[STATE_ENV] = self.state_path
        env[ATTEMPT_ENV] = str(attempt)
        # The child's spans parent under THIS attempt's span.
        env[TRACE_ID_ENV] = self.trace_id
        env[PARENT_SPAN_ENV] = self._attempt_span or self.run_span
        return env

    def _child_cmd(self) -> list[str]:
        """argv for one attempt — subclass hook (the pod member
        substitutes its host name into path templates)."""
        return list(self.cmd)

    def _spawn(self, attempt: int, log_path: str) -> subprocess.Popen:
        logf = open(log_path, "ab")
        try:
            # Own session => own process group: the TERM/KILL escalation
            # reaches every thread/grandchild, not just the leader.
            return subprocess.Popen(
                self._child_cmd(), env=self._child_env(attempt),
                cwd=self.cwd, stdout=logf,
                stderr=subprocess.STDOUT, start_new_session=True,
            )
        finally:
            logf.close()  # the child holds its own fd now

    def _signal_group(self, proc: subprocess.Popen, sig: int) -> None:
        try:
            os.killpg(proc.pid, sig)
        except (ProcessLookupError, PermissionError):
            pass

    def _abort(self, proc: subprocess.Popen, reason: str,
               attempt: int, stall_kind: str | None = None) -> int:
        """TERM → grace → KILL escalation against the child's group.

        SIGTERM gives a healthy-but-slow child its atexit/flush; a child
        wedged in a collective — or SIGSTOP'd, which *queues* SIGTERM
        until continued — only dies to the SIGKILL. ``stall_kind``
        classifies a stall abort (see :meth:`_stall_kind`) and rides the
        journal event so ``tools/obs_report.py`` can count source stalls
        separately. Returns the reaped returncode."""
        fields = {}
        if stall_kind is not None:
            fields["stall_kind"] = stall_kind
        self._event("deadline_abort", attempt=attempt, reason=reason,
                    pid=proc.pid, term_grace_s=self.config.term_grace_s,
                    **fields)
        self._signal_group(proc, signal.SIGTERM)
        deadline = time.monotonic() + self.config.term_grace_s
        while proc.poll() is None and time.monotonic() < deadline:
            time.sleep(min(0.05, self.config.poll_interval_s))
        if proc.poll() is None:
            self._signal_group(proc, signal.SIGKILL)
        proc.wait()
        return proc.returncode

    @staticmethod
    def _stall_kind(last_phase) -> str:
        """Classify a stall abort by the child's last sub-phase beat.

        A heartbeat frozen in the ``prefetch`` phase means the driver
        was healthy and WAITING on the ingest source (the prefetch
        worker / chunk iterator) when progress stopped — a wedged
        SOURCE, not a wedged driver. Keeping the two apart matters for
        response: a source stall points at the data pipeline (filesystem,
        generator, upstream service) while a driver stall points at the
        device/collective path. Neither kind quarantines (stalls are
        environmental, never poison evidence — see
        :meth:`_maybe_quarantine`)."""
        return "source_stall" if last_phase == "prefetch" else "driver_stall"

    # -- one attempt -------------------------------------------------------

    def _run_attempt(self, attempt: int, run_deadline: float | None) -> dict:
        """Launch + babysit one attempt. Returns the attempt record:
        ``{"attempt", "rc", "aborted": None|"stall"|"wall_deadline",
        "last_index", "runtime_s", "log"}``."""
        cfg = self.config
        log_path = os.path.join(self.state_dir, f"attempt-{attempt}.log")
        # A stale heartbeat from the previous attempt must not count as
        # this attempt's first signal.
        try:
            os.remove(self.heartbeat_path)
        except OSError:
            pass
        t0 = time.monotonic()
        self._attempt_span = _mint_id()
        proc = self._spawn(attempt, log_path)
        self._event("attempt_start", attempt=attempt, pid=proc.pid,
                    cmd=self.cmd,
                    trace_id=self.trace_id, span_id=self._attempt_span,
                    parent_id=self.run_span,
                    quarantined=list(self.state["quarantined"]))
        last_signal = t0
        deadline_s = (cfg.startup_grace_s if cfg.startup_grace_s is not None
                      else cfg.stall_timeout_s)
        hb_mtime, last_index, last_phase = self._read_heartbeat()
        watch_fp = self._watch_fingerprint()
        aborted = None
        stall_kind = None
        first_signal_seen = False
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            now = time.monotonic()
            new_mtime, idx, phase = self._read_heartbeat()
            new_fp = self._watch_fingerprint()
            if new_mtime != hb_mtime or new_fp != watch_fp:
                # Index on ANY fresh signal (it is monotone, and coarse
                # filesystem mtimes can hide a fresh beat behind an
                # unchanged mtime); phase only on a definitely-fresh
                # beat, taken verbatim, None included — a boundary beat
                # with no phase field must CLEAR a stale sub-phase, or a
                # later death in e.g. a chunk callback would be
                # attributed to the previous beat's 'dispatch'.
                if idx is not None:
                    last_index = idx
                if new_mtime != hb_mtime:
                    last_phase = phase
                hb_mtime, watch_fp = new_mtime, new_fp
                last_signal = now
                deadline_s = cfg.stall_timeout_s  # startup grace spent
                if not first_signal_seen:
                    # The attempt's FIRST liveness signal — the moment a
                    # restarted child demonstrably dispatches again.
                    # recovery_times() pairs this with the previous
                    # attempt_end to measure time_to_recovered_s
                    # (kill -> first post-restart dispatch), the MTTR
                    # figure the chaos sweep digests record.
                    first_signal_seen = True
                    self._event("attempt_first_signal", attempt=attempt,
                                t_rel_s=round(now - t0, 3),
                                trace_id=self.trace_id,
                                span_id=self._attempt_span,
                                parent_id=self.run_span)
            if run_deadline is not None and now >= run_deadline:
                rc = self._abort(proc, "wall_deadline", attempt)
                aborted = "wall_deadline"
                break
            if now - last_signal > deadline_s:
                stall_kind = self._stall_kind(last_phase)
                rc = self._abort(proc, "stall", attempt,
                                 stall_kind=stall_kind)
                aborted = "stall"
                break
            time.sleep(cfg.poll_interval_s)
        # Catch a final beat that landed between the last poll and exit.
        final_mtime, idx, phase = self._read_heartbeat()
        if idx is not None:
            last_index = idx
        if final_mtime != hb_mtime:
            last_phase = phase  # fresh beat: take its phase, None included
        record = {
            "attempt": attempt,
            "rc": rc,
            "aborted": aborted,
            "last_index": last_index,
            # The sub-chunk boundary the child last crossed (prefetch /
            # ingest / dispatch) — a death BETWEEN chunk boundaries now
            # attributes to the right sub-phase in the persisted state.
            "last_phase": last_phase,
            # Stall aborts only: "source_stall" when the last beat was
            # the driver WAITING ON THE SOURCE (prefetch phase) — the
            # wedged-ingest incident the ROADMAP item called out as
            # indistinguishable from a wedged driver; "driver_stall"
            # otherwise.
            "stall_kind": stall_kind,
            "runtime_s": round(time.monotonic() - t0, 3),
            "log": log_path,
        }
        self._event("attempt_end", trace_id=self.trace_id,
                    span_id=self._attempt_span, parent_id=self.run_span,
                    **record)
        return record

    # -- the supervision loop ----------------------------------------------

    def run(self) -> dict:
        """Supervise to completion. Returns the digest dict (also what
        the CLI prints): success, attempts, restarts,
        deadline aborts, quarantined indices, give-up reason."""
        cfg = self.config
        t0 = time.monotonic()
        run_deadline = (t0 + cfg.wall_deadline_s
                        if cfg.wall_deadline_s is not None else None)
        self._event("supervisor_start", cmd=self.cmd,
                    state_path=self.state_path,
                    trace_id=self.trace_id, span_id=self.run_span,
                    parent_id=self.trace_parent,
                    config=dataclasses.asdict(cfg))
        attempt = len(self.state["attempts"])
        restarts_this_run = 0
        reason = None
        success = False
        while True:
            record = self._run_attempt(attempt, run_deadline)
            self.state["attempts"].append(record)
            self._save_state()
            if record["rc"] == 0 and record["aborted"] is None:
                # rc alone is not success: a SIGTERM-trapping child may
                # exit 0 from its graceful-shutdown handler after a
                # deadline abort — that run is still incomplete.
                success = True
                break
            self._maybe_quarantine(record)
            if record["aborted"] == "wall_deadline":
                reason = "wall_deadline"
                break
            if restarts_this_run >= cfg.max_restarts:
                reason = "retry_budget_exhausted"
                self._event("supervisor_give_up", attempts=attempt + 1,
                            restarts=restarts_this_run, reason=reason)
                break
            backoff = self.backoff_s(restarts_this_run)
            if run_deadline is not None and (
                    time.monotonic() + backoff >= run_deadline):
                reason = "wall_deadline"
                break
            self._event("supervisor_restart", attempt=attempt + 1,
                        backoff_s=backoff,
                        restarts=restarts_this_run + 1)
            time.sleep(backoff)
            restarts_this_run += 1
            self.state["restarts"] = int(self.state["restarts"]) + 1
            self._save_state()
            attempt += 1
        attempts = self.state["attempts"]
        digest = {
            "success": success,
            "reason": reason,
            "attempts": len(attempts),
            "restarts": int(self.state["restarts"]),
            "deadline_aborts": sum(
                1 for a in attempts if a.get("aborted") == "stall"),
            "source_stalls": sum(
                1 for a in attempts
                if a.get("stall_kind") == "source_stall"),
            "wall_deadline_hit": any(
                a.get("aborted") == "wall_deadline" for a in attempts),
            "quarantined": list(self.state["quarantined"]),
            "heartbeat_rejected": int(
                self.state.get("heartbeat_rejected", 0)),
            "last_index": attempts[-1].get("last_index") if attempts else None,
            "wall_s": round(time.monotonic() - t0, 3),
            # Restart-to-first-signal seconds per recovery (the chaos
            # digest's restart-cost evidence: the child's start-up,
            # torch import, CUDA init and kernel load, on every restart).
            "restart_to_first_signal_s": [
                round(v, 3)
                for v in recovery_times(self.journal_path)],
            "state_path": self.state_path,
            "journal_path": self.journal_path,
        }
        self._event("supervised_run_end", trace_id=self.trace_id,
                    span_id=self.run_span, **{
                        k: v for k, v in digest.items()
                        if k != "journal_path"})
        return digest

    def _maybe_quarantine(self, record: dict) -> None:
        """Two (``quarantine_after``) consecutive CRASH failures at the
        same progress index mark that index poisoned: persist it and
        export it to the next attempt (the child's RollbackPolicy preset
        skips it). Index None (died before any beat) never quarantines —
        there is nothing addressable to skip. Deadline-ABORTED attempts
        are not evidence either: a shared-filesystem hiccup stalling the
        same chunk twice is environmental, and quarantining it would
        silently drop healthy training data (the failure model scopes
        quarantine to deterministic poison that CRASHES the worker)."""
        idx = record.get("last_index")
        if idx is None or record.get("aborted") is not None:
            return
        # Only the CONSECUTIVE trailing crash failures count: the
        # persisted attempt history spans supervisor invocations, and two
        # transient deaths at the same index with a fully successful run
        # between them are coincidence, not determinism — a success
        # resets the evidence (an interleaved stall-abort neither counts
        # nor resets).
        tail = []
        for a in reversed(self.state["attempts"]):
            if a.get("rc") == 0 and a.get("aborted") is None:
                break
            if a.get("aborted") is None:
                tail.append(a)
        tail = tail[:self.config.quarantine_after]
        if (len(tail) >= self.config.quarantine_after
                and all(a.get("last_index") == idx for a in tail)
                and idx not in self.state["quarantined"]):
            self.state["quarantined"].append(int(idx))
            self._cap_quarantine()
            self._save_state()
            self._event("chunk_quarantined", index=int(idx),
                        after_attempts=len(tail),
                        phase=record.get("last_phase"))


def recovery_times(journal_path: str) -> list[float]:
    """``time_to_recovered_s`` per restart from one supervisor journal:
    for every attempt k+1 that produced a first liveness signal, the
    wall-clock seconds from attempt k's ``attempt_end`` (the kill /
    crash) to attempt k+1's ``attempt_first_signal`` (the first
    post-restart dispatch). The list is one entry per RECOVERED restart
    — an attempt that died before signaling contributes nothing (its
    successor's recovery measures from the newest prior end anyway).

    Stdlib-only and journal-only: the chaos sweep and ``obs_report``
    both call this against ``journal-supervisor.jsonl`` after the fact.
    """
    ends: dict[int, float] = {}
    firsts: dict[int, float] = {}
    try:
        with open(journal_path, encoding="utf-8") as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except json.JSONDecodeError:
                    continue  # torn tail write
                if rec.get("kind") != "event":
                    continue
                ev, attempt = rec.get("event"), rec.get("attempt")
                if attempt is None or "t" not in rec:
                    continue
                if ev == "attempt_end":
                    ends[int(attempt)] = float(rec["t"])
                elif ev == "attempt_first_signal":
                    firsts.setdefault(int(attempt), float(rec["t"]))
    except OSError:
        return []
    out = []
    for attempt, t_first in sorted(firsts.items()):
        prior = [t for a, t in ends.items()
                 if a < attempt and t <= t_first]
        if prior:
            out.append(round(t_first - max(prior), 3))
    return out
