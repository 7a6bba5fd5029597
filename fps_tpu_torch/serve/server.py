"""ReadServer: answer pull-by-id and model-head queries over snapshots.

The serving half of the parameter-server abstraction (Parameter Box,
PAPERS.md): batched reads against *published* parameter state. One
:class:`ReadServer` holds a reference to the current
:class:`~fps_tpu_torch.serve.snapshot.ServableSnapshot` and answers

* ``pull(table, ids)``            — batched row lookup (the PS wire op);
* ``score_linear(ids, vals)``     — sparse linear scores: logreg
  probability / PA margin over a weight table (column 0 is the weight
  for every optimizer, matching ``predict_proba_host``);
* ``topk(users, k)``              — MF user×item dot-product top-k over
  the item table and the snapshot's EXPORTED user factors;
* ``stats()``                     — step, request/latency digest, swap
  and freshness counters.

**Hot-swap contract.** :meth:`swap_to` is a single attribute rebind — a
pointer flip whose latency is independent of table size (no data moves;
the snapshot was mapped when it was opened). Every request reads
``self._snap`` exactly ONCE and runs entirely against that object, so an
in-flight batched lookup completes on the snapshot it started on while
later requests see the new one; old maps stay valid until their last
reference drops (rename-only publication — see ``serve/snapshot.py``).
No locks on the read path.

Latency: every request is timed into a bounded reservoir (plus a
``serve.request_seconds`` histogram and ``serve.requests`` /
``serve.rows`` counters through ``fps_tpu_torch.obs``); :meth:`latency_s`
reports p50/p99 — the numbers ``bench.py serve`` publishes. With a
recorder attached, that is three metric records PER REQUEST (a JSONL
sink writes three lines each) — the price of exact sample-level
quantiles in the obs digest. High-qps paths that only need the local
digest pass ``recorder=None`` (as ``bench.py serve`` does) and read
the reservoir through :meth:`stats`.

thread-safety: the swap is a single reference assignment (atomic under
the GIL) and requests bind it once; the latency reservoir and the
request/row totals update under their own locks (post-lookup accounting
only — the data path itself stays lock-free). Many request threads + one
watcher thread is the intended topology.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from fps_tpu_torch.serve.snapshot import ServableSnapshot, materialize
from fps_tpu_torch.serve.watcher import SnapshotWatcher, _emit_metric

__all__ = ["ReadServer", "NoSnapshotError", "CoalesceConfig"]


class NoSnapshotError(RuntimeError):
    """No servable snapshot has been published yet."""


class CoalesceConfig:
    """Tuning for the request coalescer (:class:`_Coalescer`).

    * ``max_batch`` — most requests merged into one gather batch;
    * ``max_delay_s`` — how long a LEADER may hold a non-full batch
      open waiting for more arrivals. Only applied while another batch
      is already executing (the server is busy, so waiting is free
      concurrency, not added idle latency): **an idle server never
      adds latency** — the first request on a quiet server executes
      immediately, alone (``docs/STALENESS.md``).
    * ``max_queue`` — bound on queued-not-yet-batched requests; a
      request arriving over the bound executes SOLO instead of queueing
      (bounded memory, never unbounded latency — admission control in
      ``serve/net.py`` sheds before this bound matters in practice).
    """

    __slots__ = ("max_batch", "max_delay_s", "max_queue")

    def __init__(self, max_batch: int = 256, max_delay_s: float = 0.0,
                 max_queue: int = 2048):
        if max_batch < 1:
            raise ValueError(f"max_batch must be >= 1, got {max_batch}")
        self.max_batch = int(max_batch)
        self.max_delay_s = float(max_delay_s)
        self.max_queue = int(max_queue)


class _Pending:
    """One queued call awaiting its batch: ``(kind, payload)`` in,
    result or exception out, an Event for the waiting handler thread."""

    __slots__ = ("kind", "payload", "t0", "result", "error", "event")

    def __init__(self, kind: str, payload: dict, t0: float):
        self.kind = kind
        self.payload = payload
        self.t0 = t0
        self.result = None
        self.error: BaseException | None = None
        self.event = threading.Event()


class _Coalescer:
    """Bounded request-combining queue: concurrently-queued pull/score/
    topk calls merge into ONE batch executed against ONE snapshot
    binding (so every member answers from the same generation), one
    fancy-index gather per table (``ReadServer._run_batch``).

    Combiner pattern: the first submitter with no active leader becomes
    the LEADER, drains the queue in ``max_batch`` slices, executes each
    slice, and wakes the waiters; everyone else parks on an Event. The
    leader keeps draining until the queue is empty (so overflow slices
    are never orphaned), then returns its own result. Per-request
    latency is measured from SUBMIT, so the coalescing delay is visible
    in the p99 the bench reports — bounded added latency, never hidden.
    """

    def __init__(self, server: "ReadServer", cfg: CoalesceConfig):
        self._server = server
        self.cfg = cfg
        self._lock = threading.Lock()
        self._pending: list[_Pending] = []
        self._leader_active = False
        self._executing = False

    def submit(self, kind: str, payload: dict, t0: float):
        entry = _Pending(kind, payload, t0)
        with self._lock:
            if len(self._pending) >= self.cfg.max_queue:
                solo = True  # over the bound: execute alone, don't queue
            else:
                solo = False
                self._pending.append(entry)
                lead = not self._leader_active
                if lead:
                    self._leader_active = True
                busy = self._executing
        if solo:
            return self._server._run_solo(kind, payload, t0)
        if not lead:
            # ~60s is far beyond any legitimate batch execution; a
            # timeout here means the leader died un-catchably.
            if not entry.event.wait(timeout=60.0):
                raise RuntimeError(
                    "coalesced request abandoned: batch leader never "
                    "completed")
            if entry.error is not None:
                raise entry.error
            return entry.result
        return self._lead(entry, busy)

    def _lead(self, own: _Pending, busy: bool):
        cfg = self.cfg
        if busy and cfg.max_delay_s > 0:
            # Another batch is mid-flight: hold the door open briefly so
            # the queue fills — the knob trades a BOUNDED latency add
            # for a bigger amortized gather. Never taken when idle.
            deadline = time.perf_counter() + cfg.max_delay_s
            while time.perf_counter() < deadline:
                with self._lock:
                    if len(self._pending) >= cfg.max_batch:
                        break
                time.sleep(min(cfg.max_delay_s / 8, 0.001))
        try:
            while True:
                with self._lock:
                    if not self._pending:
                        self._leader_active = False
                        break
                    batch = self._pending[:cfg.max_batch]
                    del self._pending[:cfg.max_batch]
                    self._executing = True
                try:
                    self._server._execute_entries(batch)
                finally:
                    with self._lock:
                        self._executing = False
        except BaseException as e:
            # The leader must never park waiters forever: fail anything
            # still queued, release leadership, then surface.
            with self._lock:
                orphans = self._pending
                self._pending = []
                self._leader_active = False
                self._executing = False
            for o in orphans:
                o.error = e
                o.event.set()
            if own.error is None and not own.event.is_set():
                own.error = e
                own.event.set()
            raise
        if own.error is not None:
            raise own.error
        return own.result

    def depth(self) -> int:
        with self._lock:
            return len(self._pending)


class _LatencyReservoir:
    """Bounded ring of request latencies with exact quantiles over the
    retained window (the last ``capacity`` requests)."""

    def __init__(self, capacity: int = 8192):
        self.capacity = capacity
        self._buf = np.zeros(capacity, np.float64)
        self._n = 0
        self._lock = threading.Lock()

    def add(self, seconds: float) -> None:
        with self._lock:
            self._buf[self._n % self.capacity] = seconds
            self._n += 1

    def quantiles(self, qs=(0.5, 0.99)) -> dict[str, float] | None:
        with self._lock:
            n = min(self._n, self.capacity)
            if not n:
                return None
            window = np.sort(self._buf[:n].copy())
        return {f"p{int(q * 100)}": float(
            window[min(n - 1, int(q * (n - 1) + 0.5))]) for q in qs}

    @property
    def count(self) -> int:
        return self._n


class ReadServer:
    """Model-agnostic read server over a (possibly live) run directory.

    Construct around an initial snapshot, or with none and let a
    :class:`SnapshotWatcher` publish into :meth:`swap_to`.
    :meth:`ReadServer.over` builds the common pairing in one call.
    """

    def __init__(self, snapshot: ServableSnapshot | None = None, *,
                 recorder=None, coalesce: CoalesceConfig | None = None):
        self._snap = snapshot
        self.recorder = recorder
        self.latency = _LatencyReservoir()
        # Request/row totals mutate from every handler thread; the lock
        # keeps them exact so stats() agrees with the obs counters
        # (whose Recorder locks internally).
        self._count_lock = threading.Lock()
        self.requests = 0
        self.rows_served = 0
        # Batching accounting (the coalescer and multi() both feed it).
        self.batches = 0
        self.batched_requests = 0
        self._coalescer = (None if coalesce is None
                           else _Coalescer(self, coalesce))

    @classmethod
    def over(cls, ckpt_dir: str, *, journal: str | None = None,
             recorder=None, verify: bool = True
             ) -> tuple["ReadServer", SnapshotWatcher]:
        """``(server, watcher)`` wired together over ``ckpt_dir``; call
        ``watcher.poll()`` (or run it on a thread) to publish."""
        server = cls(recorder=recorder)
        watcher = SnapshotWatcher(
            ckpt_dir, journal=journal, recorder=recorder,
            on_swap=lambda snap, _direction: server.swap_to(snap),
            verify=verify)
        watcher.poll()
        return server, watcher

    # -- publication -------------------------------------------------------

    def swap_to(self, snapshot: ServableSnapshot | None) -> None:
        """Atomic hot swap: one reference rebind, no data movement — safe
        to call (from the watcher thread) while requests are in flight;
        each request keeps the snapshot it bound at entry. ``None``
        un-publishes: later requests refuse with NoSnapshotError (the
        fleet's quarantine-rollback path uses this rather than answer
        ahead of a rolled-back fence)."""
        self._snap = snapshot

    @property
    def snapshot(self) -> ServableSnapshot:
        snap = self._snap
        if snap is None:
            raise NoSnapshotError(
                "no servable snapshot published yet — has the trainer "
                "saved (and the watcher polled) at least once?")
        return snap

    # -- request plumbing --------------------------------------------------

    def _done(self, op: str, t0: float, rows: int) -> None:
        dt = time.perf_counter() - t0
        self.latency.add(dt)
        with self._count_lock:
            self.requests += 1
            self.rows_served += rows
        _emit_metric(self.recorder, "inc", "serve.requests", 1, op=op)
        _emit_metric(self.recorder, "inc", "serve.rows", max(rows, 0))
        _emit_metric(self.recorder, "observe", "serve.request_seconds", dt,
                     op=op)

    # -- query surface -----------------------------------------------------

    def pull(self, table: str, ids) -> tuple[int, np.ndarray]:
        """Batched pull-by-id. Returns ``(step, values)`` — the step tags
        which publish answered, so a client can reason about freshness."""
        t0 = time.perf_counter()
        if self._coalescer is not None:
            return self._coalescer.submit(
                "pull", {"table": table, "ids": ids}, t0)
        snap = self.snapshot  # bound ONCE: in-flight work survives swaps
        out = snap.lookup(table, ids)
        self._done("pull", t0, int(np.asarray(ids).size))
        return snap.step, out

    def score_linear(self, feat_ids, feat_vals, *, table: str = "weights",
                     link: str = "sigmoid") -> tuple[int, np.ndarray]:
        """Sparse linear model scores (logreg ``link="sigmoid"``, PA /
        raw margin ``link="none"``) — the serving twin of
        ``predict_proba_host``: column 0 of the pulled rows is the
        weight for every optimizer, padding ids contribute 0."""
        t0 = time.perf_counter()
        if self._coalescer is not None:
            return self._coalescer.submit(
                "score", {"feat_ids": feat_ids, "feat_vals": feat_vals,
                          "table": table, "link": link}, t0)
        snap = self.snapshot
        step, out, rows = self._score_impl(snap, feat_ids, feat_vals,
                                           table, link)
        self._done("score", t0, rows)
        return step, out

    def _score_impl(self, snap, feat_ids, feat_vals, table, link,
                    rows=None):
        """Core score compute. ``rows`` (pre-gathered weight rows for
        the flattened ids, from a batch's merged gather) skips the solo
        lookup — values are bit-identical either way."""
        feat_ids = np.asarray(feat_ids, np.int64)
        feat_vals = np.asarray(feat_vals)
        if rows is None:
            rows = snap.lookup(table, feat_ids.reshape(-1))
        w = rows[:, 0].reshape(feat_ids.shape)
        logit = np.sum(w * feat_vals, axis=-1)
        out = 1.0 / (1.0 + np.exp(-logit)) if link == "sigmoid" else logit
        return snap.step, out, int(feat_ids.size)

    def topk(self, users, k: int = 10, *, item_table: str = "item_factors",
             user_leaf: int = 0) -> tuple[int, np.ndarray, np.ndarray]:
        """MF recommendation head: top-``k`` items per user by dot
        product of the snapshot's exported user factors (``ls::<leaf>``,
        logical user order — the Trainer checkpoint path's form) against
        the item table. Returns ``(step, item_ids (U, k), scores (U, k))``.
        """
        t0 = time.perf_counter()
        if self._coalescer is not None:
            return self._coalescer.submit(
                "topk", {"users": users, "k": k,
                         "item_table": item_table,
                         "user_leaf": user_leaf}, t0)
        snap = self.snapshot
        step, items, scores, rows = self._topk_impl(
            snap, users, k, item_table, user_leaf)
        self._done("topk", t0, rows)
        return step, items, scores

    @staticmethod
    def _topk_validate(snap, users, k, item_table, user_leaf):
        """Shared topk argument gate (solo and batched paths): returns
        ``(users int64, factors)`` or raises exactly like the solo
        path always has."""
        if k < 1:
            # argpartition on k<=0 returns arbitrary columns claiming
            # ok — loud refusal, like negative user ids and raw ls.
            raise ValueError(f"k must be >= 1, got {k}")
        if snap.local_state_format != "exported":
            raise ValueError(
                "topk needs user factors in the EXPORTED (logical-order) "
                f"local-state form; snapshot step {snap.step} stores "
                f"{snap.local_state_format!r} — checkpoint through the "
                "Trainer path")
        if user_leaf >= len(snap.local_state):
            raise ValueError(
                f"snapshot step {snap.step} has {len(snap.local_state)} "
                f"local-state leaves, no leaf {user_leaf}")
        users = np.asarray(users, np.int64)
        factors = snap.local_state[user_leaf]
        if users.size and (int(users.min(initial=0)) < 0
                           or int(users.max(initial=-1))
                           >= factors.shape[0]):
            # No negative-index wraparound: serving user NU-1's items for
            # user -1 would be silently wrong data, not an error.
            raise IndexError(
                f"user ids must be in [0, {factors.shape[0]}); got "
                f"[{int(users.min())}, {int(users.max())}]")
        return users, factors

    def _topk_impl(self, snap, users, k, item_table, user_leaf):
        users, factors = self._topk_validate(snap, users, k, item_table,
                                             user_leaf)
        p = factors[users]  # (U, rank)
        # materialize(): the ONE sanctioned whole-table densification —
        # a no-op for plain maps, the cached dense form for DeltaView
        # overlays (fps_tpu_torch/serve/snapshot.py's one densify seam).
        q = materialize(snap.table(item_table))  # (I, rank)
        scores = p @ q.T  # (U, I) — q stays the mapped pages
        items, out = self._topk_select(scores, k)
        return snap.step, items, out, int(users.size) * items.shape[-1]

    @staticmethod
    def _topk_select(scores, k):
        """Row-wise top-k selection — argpartition + exact ordering of
        the head. Row-independent, so selecting over a BATCH of stacked
        user blocks is bit-identical to per-block selection."""
        k = min(k, scores.shape[1])
        top = np.argpartition(-scores, k - 1, axis=1)[:, :k]
        order = np.argsort(
            -np.take_along_axis(scores, top, axis=1), axis=1)
        items = np.take_along_axis(top, order, axis=1)
        return items, np.take_along_axis(scores, items, axis=1)

    # -- batched execution (the coalescer and multi() core) ----------------

    def multi(self, calls) -> list:
        """Execute ``calls`` — a list of ``(kind, payload)`` with kind in
        ``pull|score|topk|stats`` and payload the op's keyword dict — as ONE
        batch bound to ONE snapshot: every sub-request answers from the
        same generation, and same-table lookups merge into one
        fancy-index gather (:meth:`_run_batch`). Returns a result list
        aligned with ``calls``; a failed sub-call's slot holds its
        EXCEPTION (callers map it per-item — siblings are unaffected).
        Raises :class:`NoSnapshotError` only when nothing is published
        at all."""
        t0 = time.perf_counter()
        snap = self.snapshot
        results, rows = self._run_batch(snap, list(calls))
        self._note_batch(len(results))
        for (kind, _payload), r, rw in zip(calls, results, rows):
            if not isinstance(r, BaseException):
                self._done(kind, t0, rw)
        return results

    def _run_solo(self, kind: str, payload: dict, t0: float):
        """Un-coalesced execution of one parsed call (the coalescer's
        bounded-queue overflow path)."""
        snap = self.snapshot
        results, rows = self._run_batch(snap, [(kind, payload)])
        if isinstance(results[0], BaseException):
            raise results[0]
        self._done(kind, t0, rows[0])
        return results[0]

    def _execute_entries(self, entries) -> None:
        """Run one coalesced batch and wake every waiter. NEVER raises:
        a batch-wide failure (no snapshot, internal error) lands on each
        entry's ``error`` slot instead — a parked handler thread must
        always wake."""
        try:
            snap = self.snapshot
            results, rows = self._run_batch(
                snap, [(en.kind, en.payload) for en in entries])
        except BaseException as e:  # noqa: BLE001 — waiters must wake
            for en in entries:
                en.error = e
                en.event.set()
            return
        self._note_batch(len(entries))
        for en, r, rw in zip(entries, results, rows):
            if isinstance(r, BaseException):
                en.error = r
            else:
                en.result = r
                self._done(en.kind, en.t0, rw)
            en.event.set()

    def _note_batch(self, n: int) -> None:
        with self._count_lock:
            self.batches += 1
            self.batched_requests += n
        _emit_metric(self.recorder, "inc", "serve.batches", 1)
        _emit_metric(self.recorder, "observe", "serve.batch_size",
                     float(n))

    def _run_batch(self, snap, calls):
        """The merged-gather executor: validate every call, group
        same-table pull/score id sets into ONE concatenated fancy-index
        gather each, group same-(table, leaf, k) topk user sets into
        ONE stacked matmul + row-wise selection each, then split results
        back per call. Per-call results are bit-identical to the solo
        paths (same lookup contract, same row-independent selection);
        per-call FAILURES (bad ids, unknown tables) are validated before
        any group executes, so one bad request never poisons its batch.

        Returns ``(results, rows)`` aligned with ``calls`` — each result
        an op tuple or the exception that call would have raised solo.
        """
        n = len(calls)
        results: list = [None] * n
        rows_count = [0] * n
        gathers: dict = {}   # table -> [parsed entry]
        matmuls: dict = {}   # (item_table, leaf, k) -> [(i, users)]
        for i, (kind, payload) in enumerate(calls):
            try:
                if kind == "pull":
                    table = payload["table"]
                    ids = snap.check_ids(table, payload["ids"])
                    gathers.setdefault(table, []).append(
                        ("pull", i, ids))
                elif kind == "score":
                    table = payload.get("table", "weights")
                    feat_ids = snap.check_ids(table, payload["feat_ids"])
                    feat_vals = np.asarray(payload["feat_vals"])
                    gathers.setdefault(table, []).append(
                        ("score", i, feat_ids, feat_vals,
                         payload.get("link", "sigmoid")))
                elif kind == "topk":
                    k = int(payload.get("k", 10))
                    item_table = payload.get("item_table", "item_factors")
                    leaf = int(payload.get("user_leaf", 0))
                    users, _factors = self._topk_validate(
                        snap, payload["users"], k, item_table, leaf)
                    if users.ndim != 1:
                        raise ValueError(
                            f"topk users must be 1-D, got shape "
                            f"{users.shape}")
                    matmuls.setdefault((item_table, leaf, k), []).append(
                        (i, users))
                elif kind == "stats":
                    # No table work: answer inline so a mixed multi
                    # frame can carry health probes for free.
                    results[i] = self.stats()
                else:
                    raise ValueError(f"unknown op {kind!r}")
            except Exception as e:  # noqa: BLE001 — per-call verdicts
                results[i] = e
        for table, entries in gathers.items():
            flats = [e[2].reshape(-1) for e in entries]
            offsets = np.cumsum([0] + [f.size for f in flats])
            cat = flats[0] if len(flats) == 1 else np.concatenate(flats)
            rows = snap.lookup(table, cat)  # ONE gather for the group
            for j, e in enumerate(entries):
                seg = rows[offsets[j]:offsets[j + 1]]
                if e[0] == "pull":
                    _, i, ids = e
                    results[i] = (snap.step,
                                  seg.reshape(ids.shape + rows.shape[1:]))
                    rows_count[i] = int(ids.size)
                else:
                    _, i, feat_ids, feat_vals, link = e
                    try:
                        step, out, rc = self._score_impl(
                            snap, feat_ids, feat_vals, table, link,
                            rows=seg)
                        results[i] = (step, out)
                        rows_count[i] = rc
                    except Exception as err:  # noqa: BLE001
                        results[i] = err
        for (item_table, leaf, k), entries in matmuls.items():
            factors = snap.local_state[leaf]
            flats = [u for _i, u in entries]
            offsets = np.cumsum([0] + [u.size for u in flats])
            cat = flats[0] if len(flats) == 1 else np.concatenate(flats)
            p = factors[cat]
            q = materialize(snap.table(item_table))
            scores = p @ q.T  # ONE stacked matmul for the group
            items, sc = self._topk_select(scores, k)
            for j, (i, users) in enumerate(entries):
                results[i] = (snap.step, items[offsets[j]:offsets[j + 1]],
                              sc[offsets[j]:offsets[j + 1]])
                rows_count[i] = int(users.size) * items.shape[-1]
        return results, rows_count

    # -- digest ------------------------------------------------------------

    def latency_s(self) -> dict[str, float] | None:
        """``{"p50": s, "p99": s}`` over the retained request window."""
        return self.latency.quantiles()

    def stats(self) -> dict:
        snap = self._snap
        lat = self.latency_s() or {}
        return {
            "step": None if snap is None else snap.step,
            "tables": sorted(snap.tables) if snap is not None else [],
            "requests": self.requests,
            "rows_served": self.rows_served,
            "latency_p50_s": lat.get("p50"),
            "latency_p99_s": lat.get("p99"),
        }
