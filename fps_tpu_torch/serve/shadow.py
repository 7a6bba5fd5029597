"""Shadow serving: score old-vs-new snapshots before the fleet swaps.

A multi-tenant fleet cannot let "newest verified snapshot" be the whole
promotion story — a tenant's training regression (bad shard, poisoned
chunk that slipped the guards, a bug in a new workload revision) would
hot-swap straight into its serving path. This module adds the promotion
gate:

* :class:`ShadowScorer` — the write-side judge. It watches the tenant's
  snapshot dir with its own verifying
  :class:`~fps_tpu_torch.serve.watcher.SnapshotWatcher`, and for every fresh
  candidate scores the CURRENTLY APPROVED snapshot and the candidate
  side by side with a caller-supplied ``score_fn(snapshot) -> float``
  (higher is better; e.g. accuracy on a held-out probe set). The
  candidate is promoted iff ``new >= old + min_delta``; otherwise the
  decision is HELD and re-judged only when a newer candidate appears.
* :class:`ShadowGate` — the read-side contract: an atomic-rename JSON
  (``<ckpt_dir>/fleet/shadow_gate.json``, next to the step fence) naming
  the newest APPROVED step. A gated
  :class:`~fps_tpu_torch.serve.fleet.FleetReader` caps its readiness (and
  fence advance) at the approved step, so an unapproved publication is
  simply invisible to the fleet.

Staleness contract (docs/STALENESS.md): a held promotion means the fleet
keeps answering from the old approved snapshot — LOST FRESHNESS, never
wrong answers. The gate can only hold the fence back, never push it past
what quorum verification allows.

Torch-free (stdlib + numpy) like the rest of ``fps_tpu_torch.serve``.
"""

from __future__ import annotations

import os
import time

from fps_tpu_torch.serve.snapshot import ServableSnapshot, SnapshotRejected
from fps_tpu_torch.serve.watcher import SnapshotWatcher, _emit_event, \
    _emit_metric

__all__ = ["ShadowGate", "ShadowScorer", "GATE_NAME"]

GATE_NAME = "shadow_gate.json"
# Default promotion bar: the candidate may be this much WORSE than the
# approved snapshot and still promote — freshness is worth a little
# noise, a real regression is not.
DEFAULT_MIN_DELTA = -0.02


class ShadowGate:
    """The approved-step record one tenant's scorer and readers share."""

    def __init__(self, ckpt_dir: str):
        # Late import breaks the fleet<->shadow import cycle (fleet
        # imports ShadowGate for its gated readers).
        from fps_tpu_torch.serve import fleet as _fleet
        self._fleet = _fleet
        self.dir = os.path.join(ckpt_dir, _fleet.FLEET_DIR)
        self.path = os.path.join(self.dir, GATE_NAME)

    def read_record(self) -> dict | None:
        rec = self._fleet._read_json(self.path)
        if not isinstance(rec, dict) or "approved_step" not in rec:
            return None
        return rec

    def approved_step(self) -> int | None:
        """Newest approved step; None while nothing is approved (a gated
        fleet serves nothing until the scorer's first promotion)."""
        rec = self.read_record()
        return None if rec is None else int(rec["approved_step"])

    def approve(self, step: int, *, score_new=None, score_old=None) -> dict:
        """Promote ``step`` (forward-monotone; stale approvals no-op)."""
        cur = self.approved_step()
        if cur is not None and step <= cur:
            return self.read_record()
        rec = {"approved_step": int(step), "t": time.time(),
               "score_new": score_new, "score_old": score_old}
        os.makedirs(self.dir, exist_ok=True)
        self._fleet._atomic_write_json(self.path, rec)
        return rec


class ShadowScorer:
    """Judge every fresh candidate against the approved snapshot.

    Args:
      ckpt_dir: the tenant's snapshot dir (the gate file lands in its
        ``fleet/`` subdir).
      score_fn: ``score_fn(ServableSnapshot) -> float``, higher better.
      min_delta: promotion bar — promote iff
        ``score(new) >= score(old) + min_delta``.
      recorder: obs recorder for ``serve.shadow_*`` metrics/events.
      verify: full-verify candidates before judging (as the readers do).
    """

    def __init__(self, ckpt_dir: str, score_fn, *,
                 min_delta: float = DEFAULT_MIN_DELTA,
                 journal: str | None = None, recorder=None,
                 verify: bool = True):
        self.ckpt_dir = ckpt_dir
        self.score_fn = score_fn
        self.min_delta = float(min_delta)
        self.recorder = recorder
        self.verify = verify
        self.gate = ShadowGate(ckpt_dir)
        self.promotions = 0
        self.holds = 0
        self._candidate: ServableSnapshot | None = None
        self._held_step: int | None = None  # judged-and-held; re-judge
        #                                     only a NEWER candidate
        self.watcher = SnapshotWatcher(
            ckpt_dir, journal=journal, recorder=recorder,
            on_swap=self._on_candidate, verify=verify)

    def _on_candidate(self, snap: ServableSnapshot, _direction: str):
        self._candidate = snap

    def _open_approved(self, step: int) -> ServableSnapshot | None:
        try:
            return ServableSnapshot.open_chain(self.ckpt_dir, step,
                                               verify=self.verify)
        except (FileNotFoundError, SnapshotRejected):
            return None

    def poll(self) -> dict | None:
        """One judging pass. Returns the decision record when a fresh
        candidate was judged (``decision: promoted | held``), else None.
        """
        self.watcher.poll()
        cand = self._candidate
        if cand is None:
            return None
        approved = self.gate.approved_step()
        if approved is not None and cand.step <= approved:
            return None
        if self._held_step is not None and cand.step <= self._held_step:
            return None  # already judged and held; wait for newer
        score_new = float(self.score_fn(cand))
        score_old = None
        if approved is not None:
            old = self._open_approved(approved)
            # An approved snapshot that is no longer openable (pruned,
            # quarantined) cannot hold the gate: judge unconditionally.
            score_old = None if old is None else float(self.score_fn(old))
        promoted = (score_old is None
                    or score_new >= score_old + self.min_delta)
        rec = {"step": int(cand.step), "prev_approved": approved,
               "score_new": score_new, "score_old": score_old,
               "decision": "promoted" if promoted else "held"}
        if promoted:
            self.gate.approve(cand.step, score_new=score_new,
                              score_old=score_old)
            self.promotions += 1
            self._held_step = None
            _emit_metric(self.recorder, "inc", "serve.shadow_promotions", 1)
            _emit_event(self.recorder, "serve.shadow_promoted", **rec)
        else:
            self.holds += 1
            self._held_step = int(cand.step)
            _emit_metric(self.recorder, "inc", "serve.shadow_held", 1)
            _emit_event(self.recorder, "serve.shadow_held", **rec)
        return rec
