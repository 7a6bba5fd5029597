"""Pod-level coordination: one failure domain for a multi-host run.

Port of ``fps_tpu/supervise/pod.py``. The per-host
:class:`~fps_tpu_torch.supervise.supervisor.RunSupervisor` gives a single
host deadline abort, retry and quarantine; a multi-host run supervised
that way dies by N separate timers and can restart from N different
``latest_valid_step`` values. This module makes the POD the failure domain:

* **Leader election over the shared checkpoint filesystem**: a lease
  file (:class:`Lease`) renewed by heartbeat and written only by atomic
  rename; any member can seize an expired lease, and every seizure (and
  every coordinated restart) bumps a monotone **fencing epoch**, so a
  deposed leader's decisions, and its orphaned child's checkpoint
  publishes (``fps_tpu_torch.core.checkpoint`` refuses to publish behind
  a fence), never leak into the new attempt.
* **Pod-wide deadline abort**: any member's wedge, crash or
  disappearance becomes ONE leader decision; every member then runs the
  same SIGTERM, grace, SIGKILL escalation against its own child.
* **Coordinated restart**: the leader computes the COMMON restart point
  (the least of the plan members' newest verified snapshots, verified
  with stdlib ``zipfile`` CRCs, so this process imports neither numpy nor
  torch) and commands every member to resume from it, with the new epoch
  stamped into the control record, the fences and
  ``supervisor_state.json``.
* **Pod-consistent quarantine**: crash evidence from every member folds
  into one pod-level quarantine list (size-capped, oldest evicted first),
  broadcast to every child through the supervised-child env contract, so
  no host re-dispatches a chunk another host proved poisonous.
* **Elastic membership**: a member whose failures exhaust its budget is
  EVICTED; the leader re-plans the run at W-1 hosts and the survivors
  restart from the canonical checkpoint (legal because snapshots do not
  depend on the mesh's shape: ``Trainer.restore_checkpoint`` re-splits
  them). A returning member is re-admitted at the next boundary: the
  leader copies it the newest canonical snapshot and restarts the pod at
  W.

Stdlib-only, like the supervisor: the port's CLI
(``fps_tpu_torch/examples/supervise.py``) loads it without torch. The file
names, ``SNAPSHOT_RE``, :data:`POD_STATE_SCHEMA_VERSION` and the journal's
event names are the reference's letter for letter, so either package's
pod reads the other's pod directory. All cross-member state lives there:

```
pod_dir/
  pod_lease.json        leader lease (atomic-rename, fencing epoch)
  pod_control.json      current leader command (epoch-ordered)
  pod_state.json        pod-level persisted state (quarantine, plan, ...)
  journal-pod.jsonl     pod decision journal (tools/obs_report.py folds it)
  members/<host>.json   per-member status beacons
  <host>/               member state dir == that member's child ckpt dir
```
"""

from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import time
import zipfile

# Sibling modules (child.py: the env and fence contract; supervisor.py:
# the RunSupervisor base; core/retry.py: the storage fault seam). In
# package context they are already in sys.modules under the port's names
# (fps_tpu_torch.supervise.__init__ imports them before pod), and reusing
# them keeps ONE class identity (StaleEpochError, RunSupervisor) and one
# fault injector. Loaded by file path, the siblings load the same way:
# never a package import, which would bring torch into an agent that
# stays a few-MB pure-Python process.
import sys as _sys


def _load_sibling(name: str, *parts: str):
    import importlib.util as _ilu

    path = os.path.join(
        os.path.dirname(os.path.abspath(__file__)), *parts, name + ".py")
    spec = _ilu.spec_from_file_location("_fps_torch_pod_" + name, path)
    mod = _ilu.module_from_spec(spec)
    _sys.modules[spec.name] = mod  # pre-registered for 3.10 dataclasses
    spec.loader.exec_module(mod)
    return mod


_child = (_sys.modules.get("fps_tpu_torch.supervise.child")
          or _load_sibling("child"))
_sup = (_sys.modules.get("fps_tpu_torch.supervise.supervisor")
        or _load_sibling("supervisor"))
_retry = (_sys.modules.get("fps_tpu_torch.core.retry")
          or _load_sibling("retry", os.pardir, "core"))

LEASE_FILENAME = "pod_lease.json"
CONTROL_FILENAME = "pod_control.json"
POD_STATE_FILENAME = "pod_state.json"
POD_JOURNAL_FILENAME = "journal-pod.jsonl"
MEMBERS_DIRNAME = "members"

POD_STATE_SCHEMA_VERSION = 1

# Snapshot filename contract, MIRRORED from
# fps_tpu_torch/core/snapshot_format.py (which needs numpy; this module
# stays stdlib-only). tests/test_torch_pod.py asserts they match.
SNAPSHOT_RE = re.compile(r"ckpt_(\d{12})\.npz")


def _atomic_write_json(path: str, obj: dict) -> None:
    # The hostile-filesystem seam (fps_tpu_torch.core.retry.fault_check): the
    # deterministic injector may fail or slow this write — lease
    # renewals, control records, fences, member beacons all cross here.
    # All three sub-ops are exposed, matching the sibling write seams
    # (_atomic_savez, serve/fleet, the retier sidecar), so a schedule
    # written in the documented ('write'|'fsync'|'replace') vocabulary
    # targets the pod plane too instead of matching nothing.
    _retry.fault_check("write", path)
    _retry.fault_check("fsync", path)
    _retry.fault_check("replace", path)
    _sup._atomic_write_json(path, obj)


# Full-content CRC verification is capped: the scan runs inside the
# member's single-threaded poll loop (which also renews the lease), and
# reading a multi-GB snapshot end-to-end there could stall renewal past
# the lease TTL — a spurious seizure on every large publish. Beyond the
# cap only the zip structure (central directory) is checked, which still
# catches truncation/torn publishes; the child's restore runs the full
# per-array ``meta::crc`` pass either way and falls back on mismatch.
FULL_VERIFY_MAX_BYTES = 64 * 1024 * 1024


def latest_valid_snapshot_step(directory: str, _cache: dict | None = None
                               ) -> int | None:
    """Newest snapshot step under ``directory`` whose zip passes the
    stdlib verification the coordinator can afford: full member CRC-32s
    (``zipfile.testzip``, covering truncation AND bit rot) up to
    :data:`FULL_VERIFY_MAX_BYTES`, structural central-directory checks
    beyond. ``_cache`` (optional ``{path: (mtime_ns, size, ok)}``) skips
    re-reading files already verified at the same identity."""
    best = None
    try:
        _retry.fault_check("listdir", directory)
        names = os.listdir(directory)
    except OSError:
        return None
    for f in sorted(names, reverse=True):
        m = SNAPSHOT_RE.fullmatch(f)
        if not m:
            continue
        step = int(m.group(1))
        if best is not None and step <= best:
            continue
        path = os.path.join(directory, f)
        try:
            st = os.stat(path)
            ident = (st.st_mtime_ns, st.st_size)
        except OSError:
            continue
        if _cache is not None and _cache.get(path, (None,))[:2] == ident:
            ok = _cache[path][2]
        else:
            try:
                with zipfile.ZipFile(path) as z:
                    if st.st_size <= FULL_VERIFY_MAX_BYTES:
                        ok = z.testzip() is None
                    else:
                        ok = bool(z.namelist())  # structure only
            except (OSError, zipfile.BadZipFile):
                ok = False
            if _cache is not None:
                _cache[path] = (*ident, ok)
        if ok:
            best = step
    return best


class Lease:
    """Leader lease over a shared filesystem, with a fencing epoch.

    The lease file holds ``{host, nonce, epoch, t, ttl}`` and is only
    ever written by atomic rename. The holder renews by rewriting with a
    fresh ``t``; anyone observing ``now - t > ttl`` may SEIZE by writing
    itself in with ``epoch + 1``. Because rename is last-writer-wins,
    acquisition is two-phase across ticks: :meth:`tick` writes a claim,
    and only the claimant that still reads itself back on the NEXT tick
    holds the lease — racing claimants settle on the single rename
    winner. The epoch is the pod's fencing token: it only ever grows
    (seizure and every coordinated restart bump it), so a deposed
    holder's stale decisions are ordered out by every consumer.
    """

    def __init__(self, path: str, host: str, ttl_s: float,
                 clock=time.time):
        self.path = path
        self.host = host
        self.ttl_s = float(ttl_s)
        self.clock = clock
        # Uniqueness, not secrecy: distinguishes two agents that (mis)use
        # one host name, and a restarted agent from its previous life.
        self.nonce = f"{os.getpid()}-{int(clock() * 1e6)}"
        self._claimed = False
        # Highest epoch ever OBSERVED: a lease record below it is a
        # deposed holder's resumed stale rename (frozen mid-renewal,
        # woke after a seizure) — treated as expired and re-seized above
        # the max, so the fencing epoch stays monotone for every
        # observer even across that race.
        self._max_epoch = 0
        # Slow-lease step-down state (hostile-filesystem survival): a
        # holder whose renewal cannot LAND before TTL/2 relinquishes —
        # ``_lapsed`` stops further renewals so the record expires on
        # schedule and a follower seizes with a monotone epoch bump,
        # instead of a slow filesystem silently carrying a leader past
        # its own TTL. ``stepdowns``/``renew_failures`` are evidence
        # counters for the slow_lease_near_ttl chaos scenario.
        self._lapsed = False
        self.stepdowns = 0
        self.renew_failures = 0
        # Consecutive slow renewals (landed, but slower than TTL/2).
        # ONE is tolerated — an isolated fsync latency spike on a
        # loaded box must not depose a healthy leader and churn the
        # pod through seizures; two in a row mean the filesystem is
        # persistently slow and holding on risks blowing the TTL.
        self._slow_strikes = 0

    def read(self) -> dict | None:
        try:
            with open(self.path, encoding="utf-8") as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, json.JSONDecodeError):
            return None

    def _is_mine(self, rec: dict | None) -> bool:
        return bool(rec) and rec.get("host") == self.host \
            and rec.get("nonce") == self.nonce

    def expired(self, rec: dict | None) -> bool:
        if not rec:
            return True
        try:
            return self.clock() - float(rec["t"]) > float(
                rec.get("ttl", self.ttl_s))
        except (KeyError, TypeError, ValueError):
            return True

    def _write(self, epoch: int) -> None:
        _atomic_write_json(self.path, {
            "host": self.host, "nonce": self.nonce, "epoch": int(epoch),
            "t": self.clock(), "ttl": self.ttl_s,
        })

    def tick(self) -> tuple[bool, dict | None, bool]:
        """One election step. Returns ``(held, lease_record, seized)``
        where ``seized`` is True on the tick a claim is CONFIRMED (the
        caller journals the takeover)."""
        rec = self.read()
        try:
            rec_epoch = int(rec["epoch"]) if rec else 0
        except (KeyError, TypeError, ValueError):
            rec_epoch = 0
        regressed = rec is not None and rec_epoch < self._max_epoch
        self._max_epoch = max(self._max_epoch, rec_epoch)
        mine = self._is_mine(rec)
        if mine and not regressed and not self._lapsed:
            confirmed = self._claimed
            self._claimed = False
            renew_failed = False
            if self.clock() - float(rec["t"]) > self.ttl_s / 3.0:
                t0 = self.clock()
                try:
                    self._write(rec_epoch)
                    write_s = self.clock() - t0
                    rec = self.read() or rec
                except OSError:
                    # Renewal write failed (ENOSPC/EIO brownout): the
                    # on-disk record keeps its old t; the step-down
                    # check below decides whether we can carry on.
                    renew_failed = True
                    self.renew_failures += 1
                else:
                    if write_s > self.ttl_s / 2.0:
                        self._slow_strikes += 1
                    else:
                        self._slow_strikes = 0
            # Slow-lease step-down: relinquish when renewals cannot
            # LAND within TTL/2 — two CONSECUTIVE slow writes (the
            # WRITE's own measured duration, so a scheduler hiccup
            # between ticks never deposes a leader, and one isolated
            # fsync spike is tolerated), a failing write stream whose
            # record has aged past TTL/2, or a record that is no
            # longer ours. Followers seize only after the full TTL, so
            # a stepping-down leader is always out before any
            # successor exists — clean handover, never two writers.
            # The record is then left to expire (no further renewals:
            # a slow-landing renewal stream must not extend a hold we
            # gave up).
            try:
                age = self.clock() - float((rec or {}).get("t", 0) or 0)
            except (TypeError, ValueError):
                age = float("inf")
            if (not self._is_mine(rec)
                    or self._slow_strikes >= 2
                    or (renew_failed and age > self.ttl_s / 2.0)):
                self._lapsed = True
                self._slow_strikes = 0
                self.stepdowns += 1
                return False, rec, False
            return True, rec, confirmed
        self._claimed = False
        if (mine and self._lapsed and not regressed
                and not self.expired(rec)):
            # Our own relinquished record, still unexpired: wait it out
            # like any other observer (re-entry only via the ordinary
            # expired-seize path, with its epoch bump).
            return False, rec, False
        if regressed or self.expired(rec):
            # Seize strictly ABOVE everything ever observed — a
            # regressed record's writer may believe it leads at its old
            # epoch, and only a higher epoch orders it out.
            epoch = max(rec_epoch, self._max_epoch) + 1
            try:
                self._write(epoch)
            except OSError:
                return False, rec, False  # brownout: retry next tick
            self._max_epoch = epoch
            self._claimed = True  # confirm (or lose) next tick
            self._lapsed = False
            self._slow_strikes = 0
        return False, rec, False

    def advance_epoch(self, epoch: int) -> None:
        """Holder-only: rewrite the lease at a new (higher) epoch — the
        coordinated-restart fencing bump."""
        self._max_epoch = max(self._max_epoch, int(epoch))
        self._write(int(epoch))


@dataclasses.dataclass(frozen=True)
class PodConfig:
    """Pod policy knobs, on top of a per-member ``SupervisorConfig``.

    ``pod_size`` members form the pod (the leader waits for all of them
    to register before the first launch). ``lease_ttl_s`` bounds how long
    a dead leader blocks the pod; ``member_timeout_s`` is how stale a
    member's status beacon may go before the leader treats that HOST as
    unreachable (its agent can no longer kill its child — the restart
    that follows is what the fencing epoch protects). ``max_restarts``
    is the pod-wide coordinated-restart budget. With ``elastic`` on, a
    member whose consecutive failures reach ``evict_after`` is evicted
    (the pod re-plans at W−1) and may be re-admitted up to
    ``readmit_budget`` times once it reports ready again
    (``rejoin_delay_s`` after eviction)."""

    pod_size: int = 1
    elastic: bool = False
    lease_ttl_s: float = 5.0
    member_timeout_s: float = 10.0
    max_restarts: int = 8
    evict_after: int = 2
    readmit_budget: int = 2
    rejoin_delay_s: float = 0.5
    startup_deadline_s: float = 600.0
    member: object | None = None  # SupervisorConfig (None: defaults)

    def __post_init__(self):
        if self.pod_size < 1:
            raise ValueError(f"pod_size must be >= 1, got {self.pod_size}")
        if self.lease_ttl_s <= 0 or self.member_timeout_s <= 0:
            raise ValueError("lease_ttl_s and member_timeout_s must be > 0")
        if self.evict_after < 1:
            raise ValueError(
                f"evict_after must be >= 1, got {self.evict_after}")


class PodMember(_sup.RunSupervisor):
    """One host's pod agent: member duties always, leader duties while
    holding the lease.

    Layered on :class:`RunSupervisor` for the per-host mechanics (child
    spawn into its own process group, heartbeat tailing with schema
    hardening, the SIGTERM → grace → SIGKILL escalation, jittered
    backoff, journaling) — but every RESTART/ABORT/QUARANTINE decision
    is the pod leader's, consumed through ``pod_control.json``. The
    member's own ``state_dir`` (``pod_dir/<host>``) doubles as its
    child's checkpoint dir, so fences and snapshot scans need no extra
    configuration.
    """

    def __init__(self, cmd: list[str], *, pod_dir: str, host: str,
                 config: PodConfig | None = None,
                 watch: tuple[str, ...] = (), env: dict | None = None,
                 cwd: str | None = None):
        self.pod_config = config or PodConfig()
        member_cfg = self.pod_config.member or _sup.SupervisorConfig()
        if not host or "/" in host or host != host.strip():
            raise ValueError(f"invalid pod host name {host!r}")
        super().__init__(cmd, state_dir=os.path.join(pod_dir, host),
                         config=member_cfg, watch=watch, env=env, cwd=cwd,
                         host=host)
        self.pod_dir = pod_dir
        self.ckpt_dir = self.state_dir  # convention: snapshots land here
        self.members_dir = os.path.join(pod_dir, MEMBERS_DIRNAME)
        os.makedirs(self.members_dir, exist_ok=True)
        self.member_path = os.path.join(self.members_dir, f"{host}.json")
        self.control_path = os.path.join(pod_dir, CONTROL_FILENAME)
        self.pod_state_path = os.path.join(pod_dir, POD_STATE_FILENAME)
        self.pod_journal_path = os.path.join(pod_dir, POD_JOURNAL_FILENAME)
        self.lease = Lease(os.path.join(pod_dir, LEASE_FILENAME), host,
                           self.pod_config.lease_ttl_s)
        self.is_leader = False
        self.leader_terms = 0
        self.pod_state: dict | None = None  # loaded on leadership
        self._snap_cache: dict = {}
        # Child/attempt trackers (the non-blocking analog of
        # RunSupervisor._run_attempt's loop locals).
        self._child = None
        self._attempt = -1
        self._status = "idle"  # idle|running|done|failed|evicted|ready
        self._status_kind = None  # crash|stall|None
        self._rc = None
        self._executed_epoch = 0
        self._pod_ctx: dict | None = None  # current control's env values
        self._spawn_at: float | None = None
        self._ready_at: float | None = None
        self._t0 = None
        self._hb_mtime = None
        self._watch_fp = ()
        self._last_signal = None
        self._deadline_s = None
        self._respawns = 0
        # Transient shared-filesystem failures this agent degraded
        # through (failed beacons/journal lines, retried leader ticks).
        self.io_errors = 0

    # -- journaling --------------------------------------------------------

    def _pod_event(self, etype: str, **fields) -> None:
        """Pod-journal append (O_APPEND single line: safe under the brief
        dual-writer window a lease handover allows). Every record carries
        the pod trace id (when known) so the trace exporter can
        hang the whole pod narrative under one tree."""
        trace = (self.pod_state or {}).get("trace_id") or self.trace_id
        rec = {"kind": "event", "t": time.time(), "event": etype,
               "host": self.host, "trace_id": trace, **fields}
        try:
            with open(self.pod_journal_path, "a", encoding="utf-8") as f:
                f.write(json.dumps(rec) + "\n")
                f.flush()
                os.fsync(f.fileno())
        except OSError:
            # Journal evidence is best-effort under a storage brownout:
            # losing a line must never take the coordinator down with it.
            self.io_errors += 1

    # -- pod state (leader-persisted) --------------------------------------

    def _load_pod_state(self) -> dict:
        try:
            with open(self.pod_state_path, encoding="utf-8") as f:
                st = json.load(f)
        except (OSError, json.JSONDecodeError):
            st = {}
        found = int(st.get("schema", POD_STATE_SCHEMA_VERSION))
        if found > POD_STATE_SCHEMA_VERSION:
            raise ValueError(
                f"{self.pod_state_path} has schema v{found}, this "
                f"coordinator understands <= v{POD_STATE_SCHEMA_VERSION}")
        st["schema"] = POD_STATE_SCHEMA_VERSION
        st.setdefault("epoch", 0)
        st.setdefault("roster", [])
        st.setdefault("plan", [])
        st.setdefault("restarts", 0)
        st.setdefault("readmissions", 0)
        st.setdefault("attempts", [])
        st.setdefault("quarantined", [])
        st.setdefault("evicted", [])
        st.setdefault("failures", {})
        st.setdefault("readmits", {})
        st.setdefault("crash_streaks", {})
        st.setdefault("handled", {})
        st.setdefault("last_control", None)
        # Causal tracing (fps_tpu_torch/obs/trace.py): one trace per pod run,
        # minted by the first leader; the root span is the pod_start and
        # every decision span hangs under it. Persisted so a seizing
        # leader continues the SAME trace instead of forking a new one.
        st.setdefault("trace_id", None)
        st.setdefault("root_span", None)
        return st

    def _save_pod_state(self) -> None:
        _atomic_write_json(self.pod_state_path, self.pod_state)

    # -- member beacon -----------------------------------------------------

    def _write_member(self) -> None:
        _atomic_write_json(self.member_path, {
            "schema": 1,
            "host": self.host,
            "pid": os.getpid(),
            "child_pid": self._child.pid if self._child is not None
            else None,
            "t": time.time(),
            "epoch": self._executed_epoch,
            "status": self._status,
            "kind": self._status_kind,
            "attempt": self._attempt,
            "rc": self._rc,
            "last_index": getattr(self, "_last_index", None),
            "last_phase": getattr(self, "_last_phase", None),
            "latest_step": latest_valid_snapshot_step(
                self.ckpt_dir, self._snap_cache),
            "leader": self.is_leader,
        })

    def _read_members(self) -> dict[str, dict]:
        out = {}
        try:
            names = os.listdir(self.members_dir)
        except OSError:
            return out
        for f in names:
            if not f.endswith(".json"):
                continue
            try:
                with open(os.path.join(self.members_dir, f),
                          encoding="utf-8") as fh:
                    rec = json.load(fh)
            except (OSError, json.JSONDecodeError):
                continue
            if isinstance(rec, dict) and rec.get("host"):
                out[rec["host"]] = rec
        return out

    # -- child control (member side) ---------------------------------------

    def _child_cmd(self) -> list[str]:
        """``{host}`` in any argv element expands to this member's host
        name — one command template serves every member of the pod."""
        return [a.replace("{host}", self.host) for a in self.cmd]

    def _child_env(self, attempt: int) -> dict:
        env = super()._child_env(attempt)
        # Quarantine broadcast: the child reads its carried quarantine
        # set from STATE_ENV — pointed at the POD state file, so a chunk
        # any member proved poisonous is skipped by every member.
        env[_sup.STATE_ENV] = self.pod_state_path
        ctx = self._pod_ctx or {}
        env[_child.POD_HOST_ENV] = self.host
        env[_child.POD_EPOCH_ENV] = str(ctx.get("epoch", 0))
        env[_child.POD_WORLD_ENV] = str(ctx.get("world", 0))
        env[_child.POD_STEP_ENV] = str(ctx.get("step", 0))
        return env

    def _spawn_child(self, now: float) -> None:
        self._attempt += 1
        try:
            os.remove(self.heartbeat_path)  # stale beats must not count
        except OSError:
            pass
        log_path = os.path.join(self.state_dir,
                                f"attempt-{self._attempt}.log")
        self._attempt_span = _sup._mint_id()
        self._child = self._spawn(self._attempt, log_path)
        self._status, self._status_kind, self._rc = "running", None, None
        self._last_index = None
        self._last_phase = None
        self._t0 = now
        self._hb_mtime, self._watch_fp = None, self._watch_fingerprint()
        self._last_signal = now
        cfg = self.config
        self._deadline_s = (cfg.startup_grace_s
                            if cfg.startup_grace_s is not None
                            else cfg.stall_timeout_s)
        self._event("attempt_start", attempt=self._attempt,
                    pid=self._child.pid, cmd=self._child_cmd(),
                    pod_epoch=(self._pod_ctx or {}).get("epoch"),
                    trace_id=self.trace_id, span_id=self._attempt_span,
                    parent_id=(self._pod_ctx or {}).get("span")
                    or self.run_span,
                    quarantined=(self._pod_ctx or {}).get("quarantined",
                                                          []))

    def _finish_attempt(self, record_extra: dict) -> None:
        record = {
            "attempt": self._attempt,
            "rc": self._rc,
            "last_index": getattr(self, "_last_index", None),
            "last_phase": getattr(self, "_last_phase", None),
            "pod_epoch": (self._pod_ctx or {}).get("epoch"),
            "runtime_s": round(time.time() - (self._t0 or time.time()), 3),
            **record_extra,
        }
        self.state["attempts"].append(record)
        self._save_state()
        self._event("attempt_end", trace_id=self.trace_id,
                    span_id=self._attempt_span,
                    parent_id=(self._pod_ctx or {}).get("span")
                    or self.run_span,
                    **record)

    def _babysit(self, now: float) -> None:
        """Non-blocking slice of RunSupervisor._run_attempt: liveness off
        the (hardened) heartbeat + watched files; exits recorded; stalls
        REPORTED (status=failed/stall) rather than locally aborted — the
        abort is the leader's pod-wide decision."""
        if self._child is None or self._status != "running":
            return
        rc = self._child.poll()
        new_mtime, idx, phase = self._read_heartbeat()
        new_fp = self._watch_fingerprint()
        if new_mtime != self._hb_mtime or new_fp != self._watch_fp:
            if idx is not None:
                self._last_index = idx
            if new_mtime != self._hb_mtime:
                self._last_phase = phase
            self._hb_mtime, self._watch_fp = new_mtime, new_fp
            self._last_signal = now
            self._deadline_s = self.config.stall_timeout_s
        if rc is not None:
            self._rc = rc
            self._child = None
            self._status = "done" if rc == 0 else "failed"
            self._status_kind = None if rc == 0 else "crash"
            self._finish_attempt({"aborted": None})
            return
        if now - self._last_signal > self._deadline_s:
            # Report the wedge; keep the child for the coordinated abort.
            self._status = "failed"
            self._status_kind = "stall"
            stall_kind = self._stall_kind(
                getattr(self, "_last_phase", None))
            self._event("member_stall_detected", attempt=self._attempt,
                        stall_kind=stall_kind,
                        last_index=getattr(self, "_last_index", None))
            self._finish_attempt({"aborted": "stall",
                                  "stall_kind": stall_kind})

    def _abort_child(self, reason: str) -> None:
        if self._child is not None:
            self._rc = self._abort(self._child, reason, self._attempt)
            self._child = None
        self._status_kind = None

    # -- control consumption (member side) ---------------------------------

    def _consume_control(self, now: float) -> str | None:
        """Execute a control record newer than the last one executed.
        Returns a terminal action (``shutdown``/``give_up``) or None."""
        ctl = self._read_control()
        if not ctl or int(ctl.get("epoch", 0)) <= self._executed_epoch:
            return None
        self._executed_epoch = int(ctl["epoch"])
        action = ctl.get("action")
        # The coordinated SIGTERM -> grace -> SIGKILL: every member kills
        # its OWN child at the leader's single decision.
        self._abort_child(f"pod_{action}")
        if action in ("shutdown", "give_up"):
            return action
        members = list(ctl.get("members", ()))
        # Join the pod's trace: attempts spawned for this control parent
        # under the leader's decision span.
        if ctl.get("trace_id"):
            self.trace_id = ctl["trace_id"]
        self._pod_ctx = {
            "epoch": self._executed_epoch,
            "world": int(ctl.get("world", len(members))),
            "step": int(ctl.get("step", 0)),
            "quarantined": list(ctl.get("quarantined", ())),
            "span": ctl.get("span_id"),
        }
        if self.host in members:
            if self._respawns == 0:
                self._spawn_at = now  # first launch: no backoff
            else:
                # Jittered, state_dir-seeded backoff: pod members fan out
                # over [base, base*(1+jitter)] instead of stampeding the
                # shared filesystem in lockstep after a pod abort.
                self._spawn_at = now + self.backoff_s(
                    min(self._respawns - 1, 16))
            self._respawns += 1
            self._status, self._status_kind = "restarting", None
        else:
            self._status, self._status_kind = "evicted", None
            self._spawn_at = None
            self._ready_at = now + self.pod_config.rejoin_delay_s
        return None

    def _read_control(self) -> dict | None:
        try:
            with open(self.control_path, encoding="utf-8") as f:
                rec = json.load(f)
            return rec if isinstance(rec, dict) else None
        except (OSError, json.JSONDecodeError):
            return None

    # -- leader duties ------------------------------------------------------

    def _leader_tick(self, now: float) -> None:
        st = self.pod_state
        cfg = self.pod_config
        reports = self._read_members()
        epoch = int(st["epoch"])

        # Control self-healing: a deposed leader's stale rename can
        # clobber pod_control.json after ours; rewrite until the file
        # matches the current decision.
        last = st.get("last_control")
        if last is not None:
            ctl = self._read_control()
            if ctl != last and int(last.get("epoch", 0)) >= int(
                    (ctl or {}).get("epoch", 0)):
                _atomic_write_json(self.control_path, last)

        # Roster formation: wait for pod_size registrations.
        if not st["plan"]:
            if len(reports) >= cfg.pod_size:
                roster = sorted(reports)[: cfg.pod_size]
                st["roster"] = list(roster)
                st["plan"] = list(roster)
                if not st.get("trace_id"):
                    st["trace_id"] = _sup._mint_id(128)
                    st["root_span"] = _sup._mint_id()
                self.trace_id = st["trace_id"]
                self._pod_event("pod_start", roster=roster,
                                pod_size=cfg.pod_size,
                                elastic=cfg.elastic,
                                span_id=st["root_span"])
                self._decide_restart(now, reason="start", failed=[],
                                     spend_budget=False)
            return

    # fall through to steady-state decisions
        plan = list(st["plan"])

        # Reset per-member failure evidence on success.
        for h in plan:
            r = reports.get(h)
            if r and int(r.get("epoch", -1)) == epoch \
                    and r.get("status") == "done":
                st["failures"].pop(h, None)
                st["crash_streaks"].pop(h, None)

        # Completion: every plan member done at the current epoch.
        if plan and all(
            (r := reports.get(h)) is not None
            and int(r.get("epoch", -1)) == epoch
            and r.get("status") == "done"
            for h in plan
        ):
            self._decide_terminal(now, "shutdown", reason="complete")
            return

        # Failure sweep. Reachable failures count once per (epoch,
        # attempt); CONTINUED unreachability re-fires every
        # member_timeout_s — a permanently dead host must keep accruing
        # failures so an elastic pod reaches its eviction budget (one
        # frozen incident would stick it at 1 forever), while the pacing
        # keeps a brief partition from burning the restart budget in a
        # single poll tick.
        failures = []

        def _fresh_incident(h, incident, refire_after=None):
            prev = st["handled"].get(h)
            if not isinstance(prev, dict):  # absent (or a pre-fix string)
                prev = None
            if prev is not None and prev.get("incident") == incident and (
                    refire_after is None
                    or now - float(prev.get("t", 0)) < refire_after):
                return False
            st["handled"][h] = {"incident": incident, "t": now}
            return True

        for h in plan:
            r = reports.get(h)
            if r is None or now - float(r.get("t", 0)) > cfg.member_timeout_s:
                if _fresh_incident(h, f"stale:{(r or {}).get('t', 0)}",
                                   refire_after=cfg.member_timeout_s):
                    failures.append({"host": h, "kind": "unreachable",
                                     "last_index": (r or {}).get(
                                         "last_index")})
                continue
            if int(r.get("epoch", -1)) == epoch \
                    and r.get("status") == "failed":
                if _fresh_incident(h, f"e{epoch}:a{r.get('attempt')}"):
                    failures.append({"host": h,
                                     "kind": r.get("kind") or "crash",
                                     "last_index": r.get("last_index")})

        if failures:
            self._handle_failures(now, failures)
            return

        # Readmission: an evicted member reporting ready again rejoins at
        # the next boundary — which this decision IS.
        if cfg.elastic and st["evicted"]:
            for h in list(st["evicted"]):
                r = reports.get(h)
                if (r and r.get("status") == "ready"
                        and now - float(r.get("t", 0)) <= cfg.member_timeout_s
                        and int(st["readmits"].get(h, 0)) < cfg.readmit_budget):
                    self._readmit(now, h)
                    return

    def _handle_failures(self, now: float, failures: list[dict]) -> None:
        st = self.pod_state
        cfg = self.pod_config
        epoch = int(st["epoch"])
        for f in failures:
            self._pod_event("member_failed", failed_host=f["host"],
                            fail_kind=f["kind"],
                            last_index=f.get("last_index"), epoch=epoch)
            st["failures"][f["host"]] = int(
                st["failures"].get(f["host"], 0)) + 1
            # Pod-consistent quarantine: crash evidence only (stalls and
            # disappearances are environmental — same rule as the
            # single-host supervisor), consecutive same-index.
            if f["kind"] == "crash" and f.get("last_index") is not None:
                k = int(f["last_index"])
                streak = st["crash_streaks"].get(f["host"])
                if streak and int(streak.get("index", -1)) == k:
                    streak["count"] = int(streak["count"]) + 1
                else:
                    streak = {"index": k, "count": 1}
                st["crash_streaks"][f["host"]] = streak
                if (streak["count"] >= self.config.quarantine_after
                        and k not in st["quarantined"]):
                    st["quarantined"].append(k)
                    if len(st["quarantined"]) > _sup.QUARANTINE_CAP:
                        evicted = st["quarantined"][:-_sup.QUARANTINE_CAP]
                        st["quarantined"] = st["quarantined"][
                            -_sup.QUARANTINE_CAP:]
                        self._pod_event("pod_quarantine_evicted",
                                        evicted=evicted)
                    self._pod_event("pod_quarantine", index=k,
                                    evidence_host=f["host"],
                                    count=streak["count"])
        # Elastic eviction: failures past the per-member budget re-plan
        # the pod at W-1.
        if cfg.elastic:
            for f in failures:
                h = f["host"]
                if (h in st["plan"]
                        and int(st["failures"].get(h, 0)) >= cfg.evict_after):
                    st["plan"].remove(h)
                    if h not in st["evicted"]:
                        st["evicted"].append(h)
                    self._pod_event("member_evicted", evicted_host=h,
                                    failures=int(st["failures"][h]),
                                    world=len(st["plan"]))
        if not st["plan"]:
            self._decide_terminal(now, "give_up", reason="no_members_left")
            return
        if int(st["restarts"]) >= cfg.max_restarts:
            self._decide_terminal(now, "give_up",
                                  reason="retry_budget_exhausted")
            return
        st["restarts"] = int(st["restarts"]) + 1
        self._decide_restart(
            now, reason="failure",
            failed=[f["host"] for f in failures], spend_budget=True)

    def _common_step(self) -> int:
        """The pod-wide restart point: min over plan members' newest
        VERIFIED snapshots (0 when any member has none) — all hosts
        resume from one step, never from N different ones."""
        steps = []
        for h in self.pod_state["plan"]:
            s = latest_valid_snapshot_step(
                os.path.join(self.pod_dir, h), self._snap_cache)
            steps.append(0 if s is None else int(s))
        return min(steps) if steps else 0

    def _fence_all(self, epoch: int, step: int,
                   parent_id: str | None = None) -> None:
        """Drop the fencing epoch into EVERY roster member's checkpoint
        dir (evicted and unreachable hosts included — their orphaned
        children are exactly the writers the fence must stop). A fence
        only ever RISES: a deposed leader resuming mid-decision must not
        be able to lower the bar back to its own stale epoch."""
        for h in self.pod_state["roster"]:
            d = os.path.join(self.pod_dir, h)
            have = _child.read_fence(d) or {}
            try:
                floor = int(have.get("min_epoch", 0))
            except (TypeError, ValueError):
                floor = 0
            _child.write_fence(d, max(int(epoch), floor), step)
        self._pod_event("fence_written", min_epoch=epoch, step=step,
                        span_id=_sup._mint_id(), parent_id=parent_id,
                        hosts=list(self.pod_state["roster"]))

    def _still_leader(self) -> bool:
        """Re-verify the lease immediately before a decision lands: a
        member SIGSTOPped while leading resumes exactly where it froze,
        and this check shrinks the stale-decision window from a whole
        poll tick to a few syscalls (the fencing epoch and control
        healing cover the residual race)."""
        if self.lease._is_mine(self.lease.read()):
            return True
        self._pod_event("decision_abandoned", reason="lease_lost")
        self.is_leader = False
        self.pod_state = None
        return False

    def _decide_restart(self, now: float, *, reason: str,
                        failed: list[str], spend_budget: bool) -> None:
        if not self._still_leader():
            return
        st = self.pod_state
        new_epoch = int(st["epoch"]) + 1
        st["epoch"] = new_epoch
        self.lease.advance_epoch(new_epoch)
        step = self._common_step()
        # The decision's span id: rides the control record to every
        # member, whose attempt spans parent under it — ONE coordinated
        # restart = one span tree across all hosts in the exported trace.
        decision_span = _sup._mint_id()
        # Fences BEFORE the control record: by the time any member (or
        # straggler child) can see the new attempt, stale publishes are
        # already refused.
        self._fence_all(new_epoch, step, parent_id=decision_span)
        control = {
            "schema": 1,
            "action": "run",
            "epoch": new_epoch,
            "step": step,
            "members": list(st["plan"]),
            "world": len(st["plan"]),
            "quarantined": list(st["quarantined"]),
            "reason": reason,
            "trace_id": st.get("trace_id"),
            "span_id": decision_span,
            "t": time.time(),
        }
        st["attempts"].append({
            "epoch": new_epoch, "reason": reason, "failed": failed,
            "step": step, "world": len(st["plan"]), "t": time.time(),
        })
        st["last_control"] = control
        self._save_pod_state()
        _atomic_write_json(self.control_path, control)
        self._pod_event("pod_restart" if spend_budget else "pod_launch",
                        epoch=new_epoch, step=step,
                        world=len(st["plan"]), members=list(st["plan"]),
                        failed=failed, reason=reason,
                        restarts=int(st["restarts"]),
                        span_id=decision_span,
                        parent_id=st.get("root_span"),
                        quarantined=list(st["quarantined"]))

    def _readmit(self, now: float, host: str) -> None:
        """Scale back UP: sync the returning member the newest canonical
        snapshot (shared-filesystem copy from this leader's own dir — the
        elastic re-split source) and restart the pod at W+1. A FAILED
        sync defers the readmission (retried next tick, paced by the
        member timeout): admitting an unsynced member would drag the
        common restart step — and the whole pod — back to its stale
        frontier."""
        st = self.pod_state
        synced = self._sync_member(host)
        if synced is None and self._common_step() > 0:
            if now - getattr(self, "_last_readmit_defer", 0.0) \
                    > self.pod_config.member_timeout_s:
                self._last_readmit_defer = now
                self._pod_event("readmit_deferred", deferred_host=host,
                                reason="sync_failed")
            return
        st["evicted"].remove(host)
        st["plan"] = sorted(set(st["plan"]) | {host})
        st["failures"][host] = 0
        st["crash_streaks"].pop(host, None)
        st["readmits"][host] = int(st["readmits"].get(host, 0)) + 1
        st["readmissions"] = int(st["readmissions"]) + 1
        self._pod_event("member_readmitted", readmitted_host=host,
                        synced_step=synced, world=len(st["plan"]))
        self._decide_restart(now, reason="readmit", failed=[],
                             spend_budget=False)

    def _sync_member(self, host: str) -> int | None:
        """Copy a canonical snapshot into ``host``'s dir (tmp + atomic
        rename), so the returning member restores the pod's canonical
        state instead of rolling the whole pod back to its own stale
        trail. Source: the PLAN member at the pod's common frontier (the
        one whose newest verified snapshot is the pod minimum) — after
        the copy, the commanded common step exists in every member's dir,
        the leader's own (possibly evicted-stale) dir included."""
        src_host, src_step = None, None
        for h in self.pod_state["plan"]:
            s = latest_valid_snapshot_step(
                os.path.join(self.pod_dir, h), self._snap_cache)
            if s is not None and (src_step is None or s < src_step):
                src_host, src_step = h, s
        if src_step is None:
            return None
        name = f"ckpt_{src_step:012d}.npz"
        src = os.path.join(self.pod_dir, src_host, name)
        dst_dir = os.path.join(self.pod_dir, host)
        os.makedirs(dst_dir, exist_ok=True)
        dst = os.path.join(dst_dir, name)
        tmp = dst + ".sync.tmp"
        try:
            shutil.copyfile(src, tmp)
            os.replace(tmp, dst)
        except OSError:
            return None
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass
        self._pod_event("member_synced", synced_host=host, step=src_step)
        return src_step

    def _decide_terminal(self, now: float, action: str, *,
                         reason: str) -> None:
        if not self._still_leader():
            return
        st = self.pod_state
        new_epoch = int(st["epoch"]) + 1
        st["epoch"] = new_epoch
        self.lease.advance_epoch(new_epoch)
        if action == "give_up":
            # Terminal fence: nothing may publish after the pod gives up.
            self._fence_all(new_epoch, self._common_step())
        control = {"schema": 1, "action": action, "epoch": new_epoch,
                   "reason": reason, "t": time.time()}
        st["last_control"] = control
        self._save_pod_state()
        _atomic_write_json(self.control_path, control)
        self._pod_event(f"pod_{action}", epoch=new_epoch, reason=reason,
                        restarts=int(st["restarts"]),
                        span_id=_sup._mint_id(),
                        parent_id=st.get("root_span"),
                        quarantined=list(st["quarantined"]),
                        evicted=list(st["evicted"]))

    # -- the member loop ----------------------------------------------------

    def run(self) -> dict:
        """Run this member to pod completion (or give-up). Returns the
        member digest; ``success`` is True only when the POD shut down
        cleanly (every plan member finished)."""
        cfg = self.pod_config
        t0 = time.time()
        wall = self.config.wall_deadline_s
        deadline = t0 + wall if wall is not None else None
        startup_deadline = t0 + cfg.startup_deadline_s
        # Same span contract as RunSupervisor's supervisor_start: the
        # member's own run span must EXIST in the journal, or attempts
        # that fall back to it (no control span yet) dangle in the
        # exported tree.
        self._event("pod_member_start", pod_dir=self.pod_dir,
                    pod_size=cfg.pod_size, elastic=cfg.elastic,
                    trace_id=self.trace_id, span_id=self.run_span,
                    parent_id=self.trace_parent)
        try:
            self._write_member()
        except OSError:
            self.io_errors += 1
        terminal = None
        try:
            while terminal is None:
                now = time.time()
                held, lease_rec, seized = self.lease.tick()
                if held and not self.is_leader:
                    self.leader_terms += 1
                    self.pod_state = self._load_pod_state()
                    # Leadership (initial or seized) syncs the pod epoch
                    # to the lease's fencing epoch.
                    lease_epoch = int((lease_rec or {}).get("epoch", 0))
                    self.pod_state["epoch"] = max(
                        int(self.pod_state["epoch"]), lease_epoch)
                    self._save_pod_state()
                    # A seizing leader continues the pod's ONE trace.
                    if self.pod_state.get("trace_id"):
                        self.trace_id = self.pod_state["trace_id"]
                    # epoch 1 is the pod's very first acquisition; any
                    # higher claimed epoch means a previous holder was
                    # deposed — that is a seizure.
                    self._pod_event(
                        "lease_seized" if seized and lease_epoch > 1
                        else "lease_acquired",
                        epoch=int(self.pod_state["epoch"]),
                        span_id=_sup._mint_id(),
                        parent_id=self.pod_state.get("root_span"),
                        term=self.leader_terms)
                elif not held and self.is_leader:
                    self._pod_event("lease_lost",
                                    holder=(lease_rec or {}).get("host"))
                    self.pod_state = None
                self.is_leader = held

                if self.is_leader:
                    try:
                        if deadline is not None and now >= deadline:
                            self._decide_terminal(now, "give_up",
                                                  reason="wall_deadline")
                        elif (not self.pod_state["plan"]
                              and now >= startup_deadline):
                            self._decide_terminal(
                                now, "give_up",
                                reason="startup_deadline")
                        else:
                            self._leader_tick(now)
                    except OSError as e:
                        # Transient shared-filesystem failure mid-
                        # decision: every leader write is either
                        # idempotent (fences, beacons) or self-healing
                        # (pod_control rewrites from last_control each
                        # tick), so the safe move is to log, count, and
                        # retry the whole tick — never to crash the
                        # agent and orphan its child.
                        self.io_errors += 1
                        self._pod_event("leader_io_error",
                                        error=repr(e))

                terminal = self._consume_control(now)
                if terminal is None:
                    if (self._status == "restarting"
                            and self._spawn_at is not None
                            and now >= self._spawn_at):
                        self._spawn_at = None
                        self._spawn_child(now)
                    self._babysit(now)
                    if (self._status == "evicted"
                            and self._ready_at is not None
                            and now >= self._ready_at):
                        self._status = "ready"
                try:
                    self._write_member()
                except OSError:
                    # A failed beacon is one stale liveness sample — the
                    # leader's pacing tolerates it; retried next tick.
                    self.io_errors += 1
                if terminal is None:
                    # Non-leader failsafe: a member must not outlive the
                    # pod wall deadline even if no leader ever emerges.
                    if deadline is not None and now >= deadline + max(
                            cfg.lease_ttl_s * 4, 10.0):
                        terminal = "give_up"
                        break
                    time.sleep(self.config.poll_interval_s)
        finally:
            self._abort_child("pod_member_exit")
            try:
                self._write_member()
            except OSError:
                pass  # exiting anyway; the beacon just goes stale
        success = terminal == "shutdown"
        pod = self._load_pod_state()
        digest = {
            "success": success,
            "host": self.host,
            "action": terminal,
            "attempts": self._attempt + 1,
            "leader_terms": self.leader_terms,
            "epoch": int(pod.get("epoch", 0)),
            "pod": {
                "restarts": int(pod.get("restarts", 0)),
                "readmissions": int(pod.get("readmissions", 0)),
                "quarantined": list(pod.get("quarantined", ())),
                "evicted": list(pod.get("evicted", ())),
                "plan": list(pod.get("plan", ())),
                "world": len(pod.get("plan", ())),
            },
            "heartbeat_rejected": int(
                self.state.get("heartbeat_rejected", 0)),
            "wall_s": round(time.time() - t0, 3),
            "state_path": self.state_path,
            "pod_state_path": self.pod_state_path,
        }
        self._event("pod_member_end", trace_id=self.trace_id,
                    span_id=self.run_span, **{
                        k: v for k, v in digest.items()
                        if k not in ("state_path", "pod_state_path")})
        return digest
