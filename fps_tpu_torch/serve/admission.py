"""Admission control for the serve wire: cost-weighted, latency-adaptive.

A plain in-flight semaphore as the shed gate — every request cost
"1", so sixty-four cheap single-row pulls and sixty-four dense top-k
matmuls both fill the house, and the limit has no opinion about
whether the server is actually keeping its latency promise. This
module's gate is an :class:`AdmissionController`:

* **per-op cost weights** — a request is admitted against a COST
  budget, not a slot count: a ``topk`` (whole-item-table matmul) weighs
  ~8x a ``pull`` gather; a batched ``multi`` frame weighs the SUM of
  its members, so one frame carrying 500 lookups is charged like 500
  lookups (batching amortizes framing overhead, never admission).
* **latency-target AIMD** — with a ``target_latency_s`` set, the
  effective cost limit tracks the latency the server actually delivers:
  each completed request's latency feeds an EWMA; over-target
  completions shrink the limit multiplicatively, under-target
  completions regrow it additively (to at most the configured ceiling).
  In-flight cost IS the queue-depth signal — shedding starts exactly
  when queued work would push the p99 past its target, not at an
  arbitrary connection count.
* **lost work, never lost correctness** — a shed is the same retryable
  ``BUSY`` frame it always was (``net.shed_requests``, the shed-rate
  SLO in ``fps_tpu_torch.obs.fleet``); the client backs off and resends
  (``docs/STALENESS.md``).

The autoscaler (:class:`fps_tpu_torch.serve.fleet.ReadAutoscaler`) reads
:meth:`stats` — sustained shedding or a collapsed limit factor on one
reader is exactly the latency-SLO-burn signal that spawns another.

Stdlib-only and lock-disciplined: one mutex, held for arithmetic only.
"""

from __future__ import annotations

import threading

__all__ = ["AdmissionController", "DEFAULT_COST_WEIGHTS"]

# Relative op costs, calibrated from the serve bench's per-op latency
# ratios (a topk pays a whole-item-table matmul; score is a gather plus
# a reduction; stats touches no table).
DEFAULT_COST_WEIGHTS = {
    "pull": 1.0,
    "score": 2.0,
    "topk": 8.0,
    "stats": 0.25,
}
_UNKNOWN_OP_COST = 1.0


class AdmissionController:
    """Cost-budget admission with an AIMD latency governor.

    ``max_cost`` is the ceiling on concurrently-executing cost (the
    semaphore generalization: ``max_cost=N`` with unit weights is the
    old ``max_inflight=N``). ``target_latency_s=None`` disables the
    governor — the limit stays pinned at ``max_cost``.

    thread-safety: all state behind one lock; ``try_admit``/``release``
    are O(1).
    """

    def __init__(self, *, max_cost: float = 64.0,
                 target_latency_s: float | None = None,
                 weights: dict | None = None,
                 min_limit_fraction: float = 0.125,
                 decrease: float = 0.9, increase: float = 0.02,
                 ewma_alpha: float = 0.2):
        if max_cost <= 0:
            raise ValueError(f"max_cost must be > 0, got {max_cost}")
        self.max_cost = float(max_cost)
        self.target_latency_s = (None if target_latency_s is None
                                 else float(target_latency_s))
        self.weights = dict(DEFAULT_COST_WEIGHTS if weights is None
                            else weights)
        self._min_fraction = float(min_limit_fraction)
        self._decrease = float(decrease)
        self._increase = float(increase)
        self._alpha = float(ewma_alpha)
        self._lock = threading.Lock()
        self._inflight_cost = 0.0
        self._factor = 1.0  # AIMD multiplier on max_cost
        self._lat_ewma: float | None = None
        self.admitted = 0
        self.rejected = 0

    # -- cost model ---------------------------------------------------------

    def cost_of(self, req) -> float:
        """Cost of one decoded request dict. A ``multi`` frame costs the
        sum of its members — admission charges WORK, not frames."""
        if not isinstance(req, dict):
            return _UNKNOWN_OP_COST
        op = req.get("op")
        if op == "multi":
            reqs = req.get("reqs")
            if not isinstance(reqs, list):
                return _UNKNOWN_OP_COST
            return sum(self.cost_of(r) for r in reqs) or _UNKNOWN_OP_COST
        return float(self.weights.get(op, _UNKNOWN_OP_COST))

    # -- admit / release ----------------------------------------------------

    def limit(self) -> float:
        """Current effective cost limit (AIMD-governed)."""
        with self._lock:
            return self.max_cost * self._factor

    def try_admit(self, cost: float) -> bool:
        """Admit ``cost`` units of work, or refuse (the caller sheds
        with BUSY). An idle server always admits — one request larger
        than the whole budget must degrade to serial execution, never
        starve forever."""
        cost = float(cost)
        with self._lock:
            limit = self.max_cost * self._factor
            if (self._inflight_cost > 0
                    and self._inflight_cost + cost > limit):
                self.rejected += 1
                return False
            self._inflight_cost += cost
            self.admitted += 1
            return True

    def release(self, cost: float, latency_s: float | None = None) -> None:
        """Return ``cost`` to the budget; feed the request's measured
        latency to the AIMD governor."""
        with self._lock:
            self._inflight_cost = max(0.0, self._inflight_cost - cost)
            if latency_s is None or self.target_latency_s is None:
                return
            self._lat_ewma = (latency_s if self._lat_ewma is None
                              else (1 - self._alpha) * self._lat_ewma
                              + self._alpha * latency_s)
            if self._lat_ewma > self.target_latency_s:
                # Multiplicative decrease: the server is missing its
                # latency target — admit less until it recovers.
                self._factor = max(self._min_fraction,
                                   self._factor * self._decrease)
            else:
                self._factor = min(1.0, self._factor + self._increase)

    # -- signals ------------------------------------------------------------

    def inflight_cost(self) -> float:
        with self._lock:
            return self._inflight_cost

    def stats(self) -> dict:
        with self._lock:
            return {
                "max_cost": self.max_cost,
                "limit": self.max_cost * self._factor,
                "limit_factor": self._factor,
                "inflight_cost": self._inflight_cost,
                "admitted": self.admitted,
                "rejected": self.rejected,
                "latency_ewma_s": self._lat_ewma,
                "target_latency_s": self.target_latency_s,
            }
