"""SnapshotWatcher: turn a training run's publish trail into servable state.

The training plane already defines the publication contract:

* the async double-buffered checkpointer publishes snapshots only via
  atomic rename — a published ``ckpt_*.npz`` is never torn;
* ``checkpoint_saved`` journal events mark TRUE durability points and
  carry the snapshot's ``path``, ``step`` and byte size (so the watcher
  needs no directory re-stat on the hot path);
* a corrupt snapshot is quarantined by the trainer's restore path
  (renamed ``*.corrupt``) and announced by a ``checkpoint_fallback``
  event — from the read path's point of view, the run's history just
  rolled BACKWARD past that step.

:class:`SnapshotWatcher` consumes that trail — tailing the obs journal
(:class:`_JournalTail`, which survives truncation and file replacement:
the supervisor restart path rewrites journals underneath a live tailer)
and/or polling the checkpoint directory — CRC-verifies every new
candidate (:meth:`ServableSnapshot.open`), and publishes the newest
verified snapshot through ``on_swap``. DELTA publications
(``DeltaPolicy`` chains) are candidates too: a delta serves only when
its whole chain verifies (a chain through a ``*.corrupt`` base never
resolves), and when the served snapshot is on the candidate's chain the
swap is INCREMENTAL — touched rows overlaid on the still-mapped base
(:meth:`ServableSnapshot.with_delta`), O(touched rows) per link. Swaps are monotone FORWARD except
for exactly one cause: when the currently served step is quarantined (or
its file vanishes with nothing newer), the watcher swaps BACKWARD to the
newest surviving verified snapshot — readers must never keep answering
from state the trainer has rolled back past.

Freshness accounting (through ``fps_tpu_torch.obs``): ``serve.snapshot_step`` /
``serve.snapshot_lag_steps`` gauges (served step vs newest step the
trainer has *written*), ``serve.write_to_servable_s`` (durability →
servable wall-clock lag — the end-to-end freshness SLO),
``serve.swaps{direction=forward|backward}`` and
``serve.rejected_snapshots`` counters.

Torch-free; single-threaded by design (call :meth:`poll` from one thread —
the server side is the concurrent part).
"""

from __future__ import annotations

import json
import logging
import os
import time

from fps_tpu_torch.core import retry as _retry
from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.serve.snapshot import ServableSnapshot, SnapshotRejected

__all__ = ["SnapshotWatcher", "_JournalTail"]

_log = logging.getLogger("fps_tpu_torch.serve.watcher")


def _emit_metric(recorder, kind: str, name: str, value, **labels) -> None:
    """Metric through an explicit recorder, else the process default
    (``fps_tpu_torch.obs.events``) — same degrade-don't-crash contract."""
    if recorder is not None:
        getattr(recorder, kind)(name, value, **labels)
        return
    from fps_tpu_torch.obs import events

    events.record_metric(kind, name, value, **labels)


def _emit_event(recorder, etype: str, **fields) -> None:
    """Journal event through an explicit recorder, else the process
    default — same contract as :func:`_emit_metric`."""
    if recorder is not None:
        recorder.event(etype, **fields)
        return
    from fps_tpu_torch.obs import events

    events.emit(etype, **fields)


class _JournalTail:
    """Incremental reader of one JSONL journal that survives the file
    being truncated, replaced (rotation / supervisor restart), or not
    existing yet.

    ``read_new()`` returns the complete records appended since the last
    call. Detection: a shrunken file or a changed inode resets the tail
    to offset 0 and re-reads from the top — the caller deduplicates
    (snapshot steps are idempotent keys), which is the right division of
    labor because only the caller knows what "already seen" means. A
    torn final line (live writer mid-append) is buffered until its
    newline arrives.
    """

    def __init__(self, path: str):
        self.path = path
        self._offset = 0
        self._ino: int | None = None
        self._buf = b""

    def read_new(self) -> list[dict]:
        try:
            st = os.stat(self.path)
        except FileNotFoundError:
            self._offset, self._ino, self._buf = 0, None, b""
            return []
        if self._ino is not None and (st.st_ino != self._ino
                                      or st.st_size < self._offset):
            # Rotated (new inode) or truncated in place: start over.
            self._offset, self._buf = 0, b""
        self._ino = st.st_ino
        try:
            with open(self.path, "rb") as f:
                f.seek(self._offset)
                data = f.read()
        except OSError:
            return []
        self._offset += len(data)
        self._buf += data
        out = []
        while True:
            nl = self._buf.find(b"\n")
            if nl < 0:
                break
            line, self._buf = self._buf[:nl], self._buf[nl + 1:]
            line = line.strip()
            if not line:
                continue
            try:
                out.append(json.loads(line))
            except (json.JSONDecodeError, UnicodeDecodeError):
                continue  # torn mid-record at a truncation boundary
        return out


class SnapshotWatcher:
    """Maintain "the newest verified snapshot of ``ckpt_dir``".

    ``journal``: path to an obs journal file (``journal-p0.jsonl``) or a
    directory containing ``journal-*.jsonl`` — tailed for
    ``checkpoint_saved`` / ``checkpoint_fallback`` events. ``poll_dir``
    additionally (or, with no journal, exclusively) lists the directory —
    the journal is an optimization, never the only source of truth, so a
    run without telemetry still serves.

    ``on_swap(snapshot, direction)`` fires on every publish
    (``direction`` is ``"forward"`` or ``"backward"``); wire it to
    :meth:`ReadServer.swap_to`. The callback runs on the polling thread.
    """

    def __init__(self, ckpt_dir: str, *, journal: str | None = None,
                 poll_dir: bool = True, on_swap=None, recorder=None,
                 verify: bool = True):
        if journal is None and not poll_dir:
            raise ValueError("need a journal to tail or poll_dir=True — "
                             "a watcher with no source can never publish")
        self.ckpt_dir = ckpt_dir
        self.on_swap = on_swap
        self.recorder = recorder
        self.verify = verify
        self.current: ServableSnapshot | None = None
        self.poll_dir = poll_dir
        self._tails = []
        self._journal = journal
        if journal is not None:
            self._tails = [_JournalTail(p) for p in _journal_paths(journal)]
        # step -> (path, saved_wall_time) from checkpoint_saved events.
        self._saved_events: dict[int, tuple[str, float]] = {}
        self._quarantined: set[int] = set()
        # Newest step the trainer has WRITTEN (saved events ∪ dir scan) —
        # the freshness reference for serve.snapshot_lag_steps.
        self.max_written_step: int | None = None
        # step -> (st_ino, st_mtime_ns) of a file that failed
        # verification; re-checked only when the file changes (an atomic
        # re-publish of the same step gets a fresh verdict, a known-torn
        # file is not re-read every poll).
        self._rejected: dict[int, tuple] = {}
        # First-rejection holding pen: a verdict is pinned into
        # _rejected only when the SAME (step, identity) fails twice —
        # on a hostile filesystem one failing open can be a stale read
        # of pre-rename content while the durable bytes are fine, and
        # pinning on that would blind the reader to a valid publish
        # forever (the identity keys the REAL file, not what was read).
        self._reject_pending: set = set()
        # Live publication index from the last dir scan ({step:
        # Publication}) — empty in journal-only mode (chain resolution
        # then re-scans inside open_chain).
        self._pubs: dict = {}
        # Chain failures are re-CHECKED every poll (transient by
        # nature) but COUNTED once per (step, head file identity) — a
        # lingering broken chain head must not inflate
        # serve.rejected_snapshots at poll frequency.
        self._chain_rejected_seen: set = set()
        self.swaps = {"forward": 0, "backward": 0}
        self.rejected = 0
        # Storage-brownout degradation: polls that died on a transient
        # filesystem error (EIO on a listdir, a flaky open) are COUNTED
        # and the reader keeps serving last-good mapped state — a
        # misbehaving shared filesystem must never freeze or crash the
        # read plane (docs/resilience.md "Hostile filesystem").
        self.poll_errors = 0
        # Durability → servable wall-clock lag of the LAST publish (the
        # end-to-end freshness SLO sample; also a serve.* gauge).
        self.write_to_servable_s: float | None = None

    # -- sources -----------------------------------------------------------

    def _drain_journal(self) -> None:
        if self._journal is not None:
            # The journal file/dir may be created after the watcher
            # starts (trainer still booting), and a directory grows new
            # journal-*.jsonl members as processes join: re-glob every
            # drain. Existing tails keep their offsets; a tail that
            # turns out to BE the directory (the arg named a dir that
            # did not exist yet at construction) is dropped for its
            # members.
            self._tails = [t for t in self._tails
                           if not os.path.isdir(t.path)]
            known = {t.path for t in self._tails}
            self._tails += [
                _JournalTail(p) for p in _journal_paths(self._journal)
                if p not in known and not os.path.isdir(p)]
        for tail in self._tails:
            for rec in tail.read_new():
                if rec.get("kind") != "event":
                    continue
                et = rec.get("event")
                if et == "checkpoint_saved" and "step" in rec:
                    step = int(rec["step"])
                    path = rec.get("path") or fmt.snapshot_path(
                        self.ckpt_dir, step)
                    self._saved_events[step] = (
                        path, float(rec.get("t") or 0.0))
                    # A save AFTER a fallback at the same step is the
                    # rollback-replay path re-publishing it: the fresh
                    # file supersedes the quarantine verdict (the CRC
                    # gate still decides whether it serves).
                    self._quarantined.discard(step)
                    self._see_step(step)
                elif et == "checkpoint_enqueued" and "step" in rec:
                    self._see_step(int(rec["step"]))
                elif et == "checkpoint_fallback" and "step" in rec:
                    self._quarantined.add(int(rec["step"]))

    def _see_step(self, step: int) -> None:
        if self.max_written_step is None or step > self.max_written_step:
            self.max_written_step = step

    def _scan_dir(self) -> list[int]:
        try:
            _retry.fault_check("listdir", self.ckpt_dir)
            names = os.listdir(self.ckpt_dir)
        except FileNotFoundError:
            names = []
        # Full snapshots AND delta links are candidates — a delta step
        # serves by resolving its chain (fps_tpu_torch.core.snapshot_format).
        self._pubs = fmt.publications(self.ckpt_dir)
        steps = sorted(self._pubs)
        live = set(steps)
        for s in steps:
            self._see_step(s)
        # A *.corrupt sibling is the trainer's quarantine verdict — the
        # on-disk form of a checkpoint_fallback event (poll-only mode
        # must see rollbacks too). A LIVE file at the same step
        # supersedes it: the rollback-replay path re-publishes the step
        # it quarantined, and the fresh snapshot must be servable (the
        # CRC gate still decides — a lingering corrupt live file just
        # lands in the per-inode rejection cache). Quarantined DELTA
        # links count too: any candidate whose chain would pass through
        # one is ineligible until re-published.
        for f in names:
            if f.endswith(".corrupt"):
                base = f[: -len(".corrupt")]
                m = fmt.SNAPSHOT_RE.fullmatch(base)
                dm = fmt.DELTA_RE.fullmatch(base)
                s = int(m.group(1)) if m else (
                    int(dm.group(1)) if dm else None)
                if s is not None and s not in live:
                    self._quarantined.add(s)
        self._quarantined -= live
        return steps

    def _chain_quarantined(self, step: int) -> bool:
        """True when ``step``'s back-chain passes through a quarantined
        step — a reader must never resolve a chain through a
        ``*.corrupt`` base, even when the head file itself is intact."""
        pub = self._pubs.get(step)
        seen = set()
        while pub is not None and pub.kind == "delta":
            if pub.base in self._quarantined:
                return True
            if pub.base in seen:
                return True  # cyclic garbage: never servable
            seen.add(pub.base)
            pub = self._pubs.get(pub.base)
        return False

    # -- the poll ----------------------------------------------------------

    def poll(self) -> ServableSnapshot | None:
        """One pass over all sources; publishes (and returns) a new
        snapshot when one is due, else returns None. Never raises on
        torn/corrupt candidates — they are counted and skipped — and
        never raises on a TRANSIENT filesystem error either (storage
        brownout: EIO/ENOSPC/stale-mount hiccups on the scan or an
        open): the poll degrades to last-good served state, counts
        ``poll_errors`` / ``storage.poll_errors{plane=watcher}``, and
        retries next tick."""
        try:
            return self._poll_once()
        except OSError as e:
            self.poll_errors += 1
            _emit_metric(self.recorder, "inc", "storage.poll_errors", 1,
                         plane="watcher")
            _log.warning("snapshot watcher poll degraded (serving "
                         "last-good, retrying next poll): %r", e)
            return None

    def _poll_once(self) -> ServableSnapshot | None:
        self._drain_journal()
        listed = self._scan_dir() if self.poll_dir else []
        candidates = set(listed) | set(self._saved_events)
        candidates -= self._quarantined
        cur = self.current
        cur_id = _file_id(cur.path) if cur is not None else None
        # Alive = the step is still eligible AND the file on disk is the
        # very inode we mapped (src_id None = hand-built snapshot:
        # degrade to existence). A mismatch is a re-publish.
        cur_alive = (cur is not None and cur.step in candidates
                     and cur_id is not None
                     and (cur.src_id is None or cur_id == cur.src_id))
        swapped = None
        for step in sorted(candidates, reverse=True):
            if cur is not None and step == cur.step:
                if cur_alive:
                    break  # already serving the newest eligible step
                # The served FILE is gone or is no longer the mapped
                # inode: vanished (deleted without a *.corrupt rename,
                # its step lingering in the journal's saved events) or
                # atomically REPLACED (the rollback-replay path
                # re-publishes the very step it quarantined). Try the
                # step fresh — a verified re-publish swaps in place; a
                # torn or missing one falls through to older survivors
                # (a backward swap, exactly like a quarantine).
                snap = self._try_open(step)
                if snap is None:
                    continue
                self._publish(snap, "forward")
                swapped = snap
                break
            # No step < cur.step is ever reached while cur is alive:
            # cur.step is in candidates then, so the descending loop
            # breaks at the step == cur.step branch first — backward
            # swaps happen only past a quarantine/vanish/replace.
            snap = self._try_open(step)
            if snap is None:
                continue
            direction = ("backward" if cur is not None
                         and snap.step < cur.step else "forward")
            self._publish(snap, direction)
            swapped = snap
            break
        if swapped is None and cur is not None and not cur_alive:
            # Served step quarantined/vanished and no candidate verified:
            # keep answering from the mapped (still-valid) pages — the
            # alternative is serving nothing — but surface it. Fires
            # whether the rest of the directory is empty or all torn.
            _emit_metric(self.recorder, "set",
                         "serve.snapshot_lag_steps", float("nan"))
        return swapped

    def _try_open(self, step: int) -> ServableSnapshot | None:
        pub = self._pubs.get(step)
        if step in self._saved_events:
            path = self._saved_events[step][0]
        elif pub is not None:
            path = pub.path
        else:
            path = fmt.snapshot_path(self.ckpt_dir, step)
        delta_m = fmt.DELTA_RE.fullmatch(os.path.basename(path))
        file_id = _file_id(path)
        if file_id is None:
            # Swept/renamed between the candidate scan and this open:
            # gone, retry next poll — never a rejection verdict.
            return None
        if self._rejected.get(step) == file_id:
            return None  # known-bad file; only a re-publish re-checks
        if delta_m is not None and self._chain_quarantined(step):
            # The head file may be pristine, but its chain passes
            # through a *.corrupt base: state past the quarantine is
            # unrecoverable — never resolve through it. Not cached: a
            # re-publish of the base lifts the verdict.
            return None
        try:
            if delta_m is None:
                return ServableSnapshot.open(path, step=step,
                                             verify=self.verify)
            base = int(delta_m.group(2))
            cur = self.current
            if (cur is not None and cur.step == base
                    and step not in self._quarantined
                    and self._cur_matches_disk(cur)):
                # Delta-aware INCREMENTAL hot-swap: the served snapshot
                # is the delta's base — apply the touched rows to the
                # mapped view instead of re-opening the world.
                return cur.with_delta(path, verify=self.verify)
            inc = self._catch_up(cur, step)
            if inc is not None:
                return inc
            return ServableSnapshot.open_chain(self.ckpt_dir, step,
                                               verify=self.verify)
        except FileNotFoundError:
            # The poll-loop race, mid-open this time: a candidate swept
            # between stat and open is skipped, not raised and not
            # counted as a rejection (regression-tested).
            return None
        except (SnapshotRejected, ValueError):
            if delta_m is None:
                self.rejected += 1
                _emit_metric(self.recorder, "inc",
                             "serve.rejected_snapshots", 1)
                # Keyed by (inode, mtime) like every identity check here
                # — mtime alone can collide with an atomic re-publish
                # landing in the same clock tick, pinning a now-valid
                # step as bad. Only SINGLE-file verdicts are cached (a
                # full's content is immutable at that identity), and
                # only once CONFIRMED by a second failing read — one
                # verdict can be a transient stale read of pre-rename
                # content, not evidence about the durable bytes.
                key = (step, file_id)
                if key in self._reject_pending:
                    self._reject_pending.discard(key)
                    self._rejected[step] = file_id
                else:
                    if len(self._reject_pending) > 1024:
                        self._reject_pending.clear()  # bounded memory
                    self._reject_pending.add(key)
                return None
            # A CHAIN failure is not cached — the head file may be
            # pristine while a link was mid-sweep/compaction/quarantine
            # when we walked it; the verdict can lift without the head
            # changing, so eligibility is re-checked next poll (chains
            # are bounded by DeltaPolicy.full_every, the retry is
            # cheap). It is COUNTED once per head identity, though: a
            # lingering broken head polled at 20 Hz must not turn the
            # rejected counter into a poll counter.
            key = (step, file_id)
            if key not in self._chain_rejected_seen:
                if len(self._chain_rejected_seen) > 1024:
                    self._chain_rejected_seen.clear()  # bounded memory
                self._chain_rejected_seen.add(key)
                self.rejected += 1
                _emit_metric(self.recorder, "inc",
                             "serve.rejected_snapshots", 1)
            return None

    def _cur_matches_disk(self, cur) -> bool:
        """The incremental paths extend the served snapshot's IN-MEMORY
        state — legal only while the on-disk publication at that step is
        still the very file (inode+mtime) the snapshot mapped. After a
        quarantine → rollback-replay re-publish, the step number matches
        but the CONTENT may not: overlaying a new delta on the old maps
        would serve rows that exist in no publication. The full-snapshot
        path's ``cur_alive`` check; applied to chain extension."""
        if cur is None or cur.src_id is None:
            return False
        pub = self._pubs.get(cur.step)
        if pub is None or pub.path != cur.path:
            return False
        return _file_id(pub.path) == cur.src_id

    def _catch_up(self, cur, step: int) -> ServableSnapshot | None:
        """Multi-delta incremental catch-up: when the candidate's chain
        passes THROUGH the served step, extend the served snapshot
        link by link (each link verifies just its own delta) instead of
        re-opening and re-CRCing the whole chain from the base full —
        the reader that missed a few polls pays O(missed deltas), not
        O(table). None = not applicable (fall back to open_chain);
        raises like :meth:`ServableSnapshot.with_delta` on bad links."""
        if cur is None or not self._cur_matches_disk(cur):
            return None
        pubs = self._pubs or fmt.publications(self.ckpt_dir)
        try:
            members = fmt.chain_members(pubs, step)
        except fmt.ChainError:
            return None
        idx = next((i for i, p in enumerate(members)
                    if p.step == cur.step), None)
        if idx is None:
            return None
        tail = members[idx + 1:]
        if not tail or any(p.kind != "delta"
                           or p.step in self._quarantined for p in tail):
            return None
        snap = cur
        for link in tail:
            snap = snap.with_delta(link.path, verify=self.verify)
        return snap

    def _publish(self, snap: ServableSnapshot, direction: str) -> None:
        self.current = snap
        self.swaps[direction] += 1
        now = time.time()
        saved = self._saved_events.get(snap.step)
        if saved is not None and saved[1] > 0:
            write_wall = saved[1]
        else:
            try:
                write_wall = os.stat(snap.path).st_mtime
            except OSError:
                write_wall = now
        _emit_metric(self.recorder, "inc", "serve.swaps", 1,
                     direction=direction)
        _emit_metric(self.recorder, "set", "serve.snapshot_step",
                     float(snap.step))
        if self.max_written_step is not None:
            _emit_metric(self.recorder, "set", "serve.snapshot_lag_steps",
                         float(self.max_written_step - snap.step))
        self.write_to_servable_s = max(0.0, now - write_wall)
        _emit_metric(self.recorder, "set", "serve.write_to_servable_s",
                     self.write_to_servable_s)
        # Journal event beside the counters: the swap becomes a span in
        # the exported causal trace (tools/trace_export.py) — serve-side
        # hot-swaps link into the same tree as the publish that fed them.
        _emit_event(self.recorder, "serve_swap", step=int(snap.step),
                    direction=direction,
                    write_to_servable_s=round(self.write_to_servable_s,
                                              4))
        if self.on_swap is not None:
            self.on_swap(snap, direction)

    def run(self, *, interval_s: float = 0.2, stop=None,
            max_polls: int | None = None) -> None:
        """Poll loop: every ``interval_s`` until ``stop`` (a
        ``threading.Event``) is set or ``max_polls`` polls ran."""
        n = 0
        while (stop is None or not stop.is_set()) and (
                max_polls is None or n < max_polls):
            self.poll()
            n += 1
            if stop is not None:
                stop.wait(interval_s)
            else:
                time.sleep(interval_s)


def _file_id(path: str):
    """(st_ino, st_mtime_ns) identity of ``path`` (None when gone) —
    compared against :attr:`ServableSnapshot.src_id` so a re-publish of
    the served step is detected, not just a vanished file."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_mtime_ns)


def _journal_paths(journal: str) -> list[str]:
    """A journal argument is a file path or a directory holding
    ``journal-*.jsonl`` (the ``--obs-dir`` layout)."""
    if os.path.isdir(journal):
        return sorted(
            os.path.join(journal, f) for f in os.listdir(journal)
            if f.startswith("journal-") and f.endswith(".jsonl"))
    return [journal]
