"""Online re-ranking of the hot set: the host half of the adaptive tier.

Port of ``fps_tpu/tiering/retier.py``. The trainer tracks each tracked
table's pulled ids on the device: a count-min window
(:func:`fps_tpu_torch.sketch.cm_update`, kernel K4 on the card) a position,
updated every step and summed over the mesh at the end of every call into
the table's ``sketch_key(name)`` entry. At chunk and epoch boundaries a
:class:`Retierer`

* **folds** the windows, every ``check_every`` boundaries, into a decayed
  count-min on the host (:func:`fps_tpu_torch.sketch.dcm_fold`: halved on a
  schedule, so a drifting stream forgets its old head) and resets them;
* **re-ranks** each mapped table: the sketched top ``H`` against the
  current hot set; past the churn threshold the set is replaced. The
  replica is derived anew from the canonical table
  (:meth:`~fps_tpu_torch.core.store.ParamStore.rows_replica`, valid at
  every boundary, since every call ends in a reconcile) and the slot map
  and id array are swapped. Their shapes do not change, so neither does
  any launch a step;
* **plans** (``auto_plan``): after ``warmup_checks`` folds of the tracked
  but untiered run, :func:`~fps_tpu_torch.tiering.planner.plan_tables`
  sets each table's ``hot_tier``, ``dense_collectives`` and
  ``cold_budget`` and the trainer's ``hot_sync_every``, and the trainer
  resolves its tier anew; ``replan_every`` plans again, and a plan with
  the same knobs changes nothing.

The **sidecar** (``state_dir``): at every boundary the tracker's state
(the decayed sketches, the hot sets, the unfolded windows, the clock and
the plans) is written to ``tiering-{step:08d}.npz`` beside the
checkpoints, in the JAX package's format; :meth:`Retierer.restore` loads
the one of a restored checkpoint's step, so a resumed run re-ranks as the
uninterrupted one does. With a recorder (``on_boundary(recorder=...)``,
which the drivers pass) every re-rank and plan lands the reference's
``tiering.*`` counters and ``tiering_rerank`` / ``tiering_plan`` events; the
sidecar's retries and skips go to the process-default recorder
(``storage.retries{plane=sidecar}``, ``storage.sidecar_skips``).

Over several processes every process runs the same boundaries in the same
order: reading the windows (``Blocks.numpy``) and deriving a replica are
collectives, and the fold and the ranking are deterministic numpy, so
every process reaches the same re-rank.
"""

from __future__ import annotations

import dataclasses
import json
import logging
import os
import threading
from typing import Mapping

import numpy as np
import torch

from fps_tpu_torch import sketch as sklib
from fps_tpu_torch.core.store import (
    FOLD_KEY_SUFFIX,
    _stable_hash,
    hot_key,
    hot_slot_map,
    ids_key,
    is_aux_key,
    map_key,
    sketch_key,
)
from fps_tpu_torch.tiering.planner import (
    TableDensity,
    global_sync_every,
    plan_tables,
)

_log = logging.getLogger("fps_tpu_torch.tiering")

# The JAX package's dense threshold (its ops.DENSE_TABLE_BYTES) was
# measured on a TPU's interconnect, and the port's dense_collectives="auto"
# keeps the gathered route: the planner puts no table on the dense route
# unless plan_kwargs asks.
DENSE_TABLE_BYTES = 0

SIDECAR_FMT = "tiering-{:08d}.npz"


def sidecar_path(state_dir: str, step: int) -> str:
    return os.path.join(state_dir, SIDECAR_FMT.format(step))


def top_ids(est: np.ndarray, H: int) -> np.ndarray:
    """The top ``H`` ids of an estimate vector, by count descending and id
    ascending on ties: a full ``lexsort`` ranking's, through
    ``argpartition`` and a sort of the candidates only. Every id tied at
    the ``H``-th count is a candidate, so the cut never depends on the
    partition's order."""
    n = len(est)
    if H >= n:
        cand = np.arange(n)
    else:
        part = np.argpartition(-est, H - 1)[:H]
        thresh = est[part].min()
        cand = np.flatnonzero(est >= thresh)
    order = cand[np.lexsort((cand, -est[cand]))]
    return order[:H].astype(np.int64)


class Retierer:
    """The hot-set manager of one trainer, driven at its boundaries.

    Attach with ``trainer.retierer = Retierer(...)`` before the first call,
    or set ``TrainerConfig.auto_tier`` and the trainer attaches
    :meth:`auto_for` as a run begins.

    Args:
      tables: the tables to track and manage (default: every store table).
      spec: the decayed count-min of every tracked table (each table's hash
        seed derives from its name).
      check_every: the fold and re-rank cadence, in boundaries.
      churn_threshold: re-rank when ``|top-H \\ current| / H`` exceeds it;
        ``< 0`` re-ranks at every check.
      auto_plan: run :func:`plan_tables` after ``warmup_checks`` folds and
        apply it.
      warmup_checks: folds of evidence before the plan.
      replan_every: plan again every this many folds after the first plan
        (0: once a run).
      state_dir: write the sidecar here at every boundary (``keep`` newest
        kept, and every one beside a checkpoint); ``None``: no sidecar.
      batch_rows_hint: pulled rows a step, for the planner's reconcile cost.
      plan_kwargs: :func:`plan_tables` keywords over the defaults
        (``dense_table_bytes`` is :data:`DENSE_TABLE_BYTES` unless given).
    """

    def __init__(self, tables=None, *,
                 spec: sklib.DecayedCountMinSpec | None = None,
                 check_every: int = 4,
                 churn_threshold: float = 0.25,
                 auto_plan: bool = False,
                 warmup_checks: int = 1,
                 replan_every: int = 0,
                 state_dir: str | None = None,
                 keep: int = 3,
                 batch_rows_hint: int = 1024,
                 plan_kwargs: Mapping | None = None):
        if check_every < 1:
            raise ValueError(f"check_every must be >= 1, got {check_every}")
        if replan_every < 0:
            raise ValueError(
                f"replan_every must be >= 0, got {replan_every}")
        self.tables = None if tables is None else frozenset(tables)
        self.spec = spec or sklib.DecayedCountMinSpec(depth=4, width=2048)
        self.check_every = check_every
        self.churn_threshold = churn_threshold
        self.auto_plan = auto_plan
        self.warmup_checks = warmup_checks
        self.replan_every = replan_every
        self.state_dir = state_dir
        self.keep = keep
        self.batch_rows_hint = batch_rows_hint
        self.plan_kwargs = dict(plan_kwargs or {})
        # The tracker's state.
        self.state: dict[str, np.ndarray] = {}   # decayed host sketches
        self.hot_ids: dict[str, np.ndarray] = {}
        self.tick = 0          # folds so far: the decay schedule's clock
        self.planned = False
        self.plans = None
        # Windows to seed the ::sketch entries with (restore_snapshot's).
        self._restored_windows: dict[str, np.ndarray] = {}
        # The run's counts.
        self.re_ranks = 0
        self.checks = 0
        self.last_churn: dict[str, float] = {}
        self._sc_lock = threading.Lock()
        self._sc_pending = None
        self._sc_thread = None

    @classmethod
    def auto_for(cls, trainer) -> "Retierer":
        """``TrainerConfig.auto_tier``'s default: track every table, plan
        after one fold, re-rank at the default cadence."""
        return cls(auto_plan=True)

    # -- what the trainer's resolution reads ---------------------------------

    def manages(self, name: str) -> bool:
        return self.tables is None or name in self.tables

    def _table_cm(self, name: str) -> sklib.CountMinSpec:
        """``name``'s hashing: the device's window updates and the host's
        queries both use it. The seed derives from the name (the JAX
        package's ``_stable_hash``), so both packages, every process and
        every restart hash alike."""
        return sklib.CountMinSpec(
            depth=self.spec.depth, width=self.spec.width,
            seed=(self.spec.seed + _stable_hash(name)) % (2 ** 31))

    def track_specs(self, specs: Mapping) -> dict[str, sklib.CountMinSpec]:
        """``{table: CountMinSpec}`` of every managed table: the trainer's
        ``_track_specs`` keeps the mapped ones (every managed one during
        an ``auto_plan`` warm-up)."""
        return {name: self._table_cm(name) for name in sorted(specs)
                if self.manages(name)}

    def hot_ids_for(self, name: str, H: int) -> np.ndarray:
        """``name``'s current hot set of ``H`` ids, hottest first: the
        static head ``[0, H)`` until a re-rank or a plan replaces it (a
        stored set of another size, from an older plan, resets to it)."""
        cur = self.hot_ids.get(name)
        if cur is None or len(cur) != H:
            cur = np.arange(H, dtype=np.int64)
            self.hot_ids[name] = cur
        return cur

    def device_window(self, name: str) -> np.ndarray | None:
        """A window to seed ``name``'s ``::sketch`` entry with (``None``:
        zeros)."""
        return self._restored_windows.get(name)

    def snapshot(self) -> dict:
        """A copy of the tracker's state (for a rollback with the tables)."""
        return {
            "state": {k: v.copy() for k, v in self.state.items()},
            "hot_ids": {k: v.copy() for k, v in self.hot_ids.items()},
            "tick": self.tick,
            "planned": self.planned,
            "plans": self.plans,
            "restored_windows": dict(self._restored_windows),
            "re_ranks": self.re_ranks,
            "checks": self.checks,
        }

    def restore_snapshot(self, snap: Mapping) -> None:
        """Inverse of :meth:`snapshot`; also takes the JAX package's
        ``Retierer.snapshot()`` (numpy arrays and plans,
        :func:`fps_tpu_torch.convert.retierer_from_jax`)."""
        self.state = {k: np.array(v, np.float32)
                      for k, v in snap["state"].items()}
        self.hot_ids = {k: np.array(v, np.int64)
                        for k, v in snap["hot_ids"].items()}
        self.tick = int(snap["tick"])
        self.planned = bool(snap["planned"])
        self.plans = snap["plans"]
        self._restored_windows = {k: np.array(v, np.float32) for k, v in
                                  snap["restored_windows"].items()}
        self.re_ranks = int(snap["re_ranks"])
        self.checks = int(snap["checks"])

    def on_run_entry(self, trainer) -> None:
        """Run-entry hook: a plan already made is applied to the trainer's
        specs and config again, so the run resolves the tier it had.
        Idempotent."""
        if self.planned and self.plans:
            self._apply_plans_to(trainer)

    # -- the boundary ---------------------------------------------------------

    def on_boundary(self, trainer, tables: dict, index: int, *,
                    recorder=None) -> dict:
        """The fold, re-rank and plan after chunk or epoch ``index``.
        Changes and returns the tables dict (tier entries only: the
        canonical tables are never touched here). ``recorder``: an
        :class:`fps_tpu_torch.obs.Recorder` for the ``tiering.*`` counters
        and the ``tiering_rerank`` / ``tiering_plan`` events."""
        check = (index + 1) % self.check_every == 0
        if not check and self.state_dir is None:
            return tables
        # Every tracked window on the host (a collective over several
        # processes): folded at a check, kept in the sidecar otherwise.
        windows: dict[str, np.ndarray] = {}
        for name in sorted(trainer._track_specs()):
            k = sketch_key(name)
            if k in tables:
                windows[name] = tables[k].numpy()
        if check:
            self.checks += 1
            for name in sorted(windows):
                st = self.state.get(name)
                if st is None:
                    st = sklib.dcm_init(self.spec)
                self.state[name] = sklib.dcm_fold(self.spec, st,
                                                  windows[name], self.tick)
                tables[sketch_key(name)] = trainer._replicated(
                    np.zeros_like(windows[name]))
                windows[name] = np.zeros_like(windows[name])
                # Folded now: a later derivation of the entry starts from
                # 0.
                self._restored_windows.pop(name, None)
            self.tick += 1
            if self.auto_plan and not self.planned and (
                    self.tick >= self.warmup_checks):
                tables = self._apply_plan(trainer, tables, recorder)
            elif (self.auto_plan and self.planned and self.replan_every
                    and self.tick % self.replan_every == 0):
                tables = self._replan(trainer, tables, recorder)
            tables = self._maybe_rerank(trainer, tables, recorder)
        if self.state_dir is not None:
            self._save_sidecar(index + 1, windows)
        return tables

    # -- re-rank and re-split -------------------------------------------------

    def _estimated_counts(self, name: str, num_ids: int) -> np.ndarray | None:
        st = self.state.get(name)
        if st is None or float(st.sum()) <= 0:
            return None
        probe = torch.arange(num_ids, dtype=torch.int32)
        # The table's hashing (the decayed spec only schedules halvings):
        # the windows were built with it.
        return sklib.cm_query(self._table_cm(name), torch.from_numpy(
            np.asarray(st, np.float32)), probe).numpy()

    def _maybe_rerank(self, trainer, tables: dict, recorder=None) -> dict:
        mapped = trainer._mapped_tables()
        for name in sorted(mapped):
            H = mapped[name]
            spec = trainer.store.specs[name]
            est = self._estimated_counts(name, spec.num_ids)
            if est is None:
                continue
            cand = top_ids(est, H)
            cur = set(self.hot_ids_for(name, H).tolist())
            promoted = [g for g in cand.tolist() if g not in cur]
            churn = len(promoted) / H
            self.last_churn[name] = churn
            if recorder is not None:
                recorder.set("tiering.churn", churn, table=name)
            if churn <= self.churn_threshold or not promoted:
                continue
            demoted = sorted(cur - set(cand.tolist()))
            self.hot_ids[name] = cand
            # The re-split: the replica from the canonical table, the maps
            # as fresh data, every shape as it was.
            tables[hot_key(name)] = trainer.store.rows_replica(
                name, cand, tables[name])
            tables[ids_key(name)] = trainer._replicated(cand.astype(np.int32))
            tables[map_key(name)] = trainer._replicated(
                hot_slot_map(spec.num_ids, cand))
            self.re_ranks += 1
            _log.info("tiering: re-ranked %r at check %d (churn %.3f, %d "
                      "promoted / %d demoted of H=%d)", name, self.checks,
                      churn, len(promoted), len(demoted), H)
            if recorder is not None:
                recorder.inc("tiering.re_ranks", table=name)
                recorder.inc("tiering.promoted_rows", len(promoted),
                             table=name)
                recorder.inc("tiering.demoted_rows", len(demoted),
                             table=name)
                recorder.event("tiering_rerank", table=name,
                               churn=round(churn, 4),
                               promoted=len(promoted),
                               demoted=len(demoted), head=H)
        return tables

    # -- plans ----------------------------------------------------------------

    def _compute_plans(self, trainer):
        """The planner over the current decayed densities: ``(plans,
        estimates by table)``, nothing changed."""
        store = trainer.store
        densities, est_by_name = [], {}
        for name in sorted(store.specs):
            if not self.manages(name):
                continue
            spec = store.specs[name]
            est = self._estimated_counts(name, spec.num_ids)
            if est is not None:
                est_by_name[name] = est
            else:
                est = np.zeros(spec.num_ids)
            densities.append(TableDensity(
                name, spec.num_ids, spec.dim, est,
                itemsize=torch.empty((), dtype=spec.dtype).element_size()))
        kwargs = dict(batch_rows_per_step=self.batch_rows_hint,
                      dense_table_bytes=DENSE_TABLE_BYTES,
                      num_shards=trainer.num_shards,
                      num_workers=trainer.num_workers)
        kwargs.update(self.plan_kwargs)
        return plan_tables(densities, **kwargs), est_by_name

    def _install_plans(self, trainer, tables, plans, est_by_name,
                       recorder=None, *, what: str) -> dict:
        """Adopt ``plans``: seed each partial head's ranking, set the specs
        and config, and derive the tier entries anew under the new
        resolution. ``::fold`` entries are kept: a fold's state is not a
        copy of the canonical table, and the trainer keeps it where its
        shape still fits."""
        store = trainer.store
        for name in sorted(plans):
            plan, spec = plans[name], store.specs[name]
            est = est_by_name.get(name)
            if 0 < plan.hot_tier < spec.num_ids and est is not None:
                self.hot_ids[name] = top_ids(est, plan.hot_tier)
        self.planned = True
        self.plans = plans
        E = self._apply_plans_to(trainer)
        _log.info("tiering: %s applied at check %d: %s, hot_sync_every=%d",
                  what, self.checks,
                  {n: (p.hot_tier, p.hot_sync_every, p.dense, p.cold_budget)
                   for n, p in sorted(plans.items())}, E)
        if recorder is not None:
            recorder.event(
                "tiering_plan", hot_sync_every=E, what=what,
                plan={n: p.to_json() for n, p in sorted(plans.items())})
        tables = {k: v for k, v in tables.items()
                  if not is_aux_key(k) or k.endswith(FOLD_KEY_SUFFIX)}
        return trainer._attach_hot(tables)

    def _apply_plan(self, trainer, tables: dict, recorder=None) -> dict:
        plans, est_by_name = self._compute_plans(trainer)
        return self._install_plans(trainer, tables, plans, est_by_name,
                                   recorder, what="plan")

    def _replan(self, trainer, tables: dict, recorder=None) -> dict:
        """A periodic plan: the same knobs change nothing (the specs,
        config and tier entries stay); other knobs are applied."""
        plans, est_by_name = self._compute_plans(trainer)
        old = self.plans or {}
        unchanged = set(plans) == set(old) and all(
            plans[n].knobs() == old[n].knobs() for n in plans)
        if recorder is not None:
            recorder.inc("tiering.replans",
                         changed="false" if unchanged else "true")
        if unchanged:
            self.plans = plans  # the fresh evidence
            return tables
        _log.info("tiering: the re-plan at check %d changed the knobs",
                  self.checks)
        return self._install_plans(trainer, tables, plans, est_by_name,
                                   recorder, what="replan")

    def _apply_plans_to(self, trainer) -> int:
        """Set the trainer's specs and config to ``self.plans``
        (idempotent). Returns the global ``hot_sync_every``."""
        store = trainer.store
        for name in sorted(self.plans):
            plan = self.plans[name]
            spec = store.specs.get(name)
            if spec is None:
                continue
            store.specs[name] = dataclasses.replace(
                spec, hot_tier=plan.hot_tier, dense_collectives=plan.dense,
                cold_budget=plan.cold_budget)
        E = global_sync_every(self.plans)
        trainer.config = dataclasses.replace(trainer.config,
                                             hot_sync_every=E)
        return E

    # -- the sidecar ----------------------------------------------------------

    def _save_sidecar(self, step: int, windows: dict) -> None:
        """Write boundary ``step``'s sidecar: one attempt inline; a
        transient failure hands the write to a background retrier (its
        backoff never sleeps on the training thread), and a failure past
        the retry budget is skipped (the sidecar is advisory: without it a
        resume only starts the tracker cold)."""
        from fps_tpu_torch.core import retry as _retry

        os.makedirs(self.state_dir, exist_ok=True)
        path = sidecar_path(self.state_dir, step)
        arrays = {"meta": np.frombuffer(json.dumps({
            "version": 1, "tick": self.tick, "step": step,
            "planned": self.planned,
            "plans": ({n: p.to_json() for n, p in sorted(
                self.plans.items())} if self.plans else None),
        }).encode(), dtype=np.uint8)}
        for name in sorted(self.state):
            arrays[f"state::{name}"] = self.state[name]
        for name in sorted(self.hot_ids):
            arrays[f"hot::{name}"] = self.hot_ids[name]
        for name in sorted(windows):
            arrays[f"window::{name}"] = windows[name]
        try:
            self._write_sidecar_file(path, arrays)
        except OSError as e:
            if _retry.classify_error(e) != "retryable":
                raise
            self._obs_metric("inc", "storage.retries", 1, plane="sidecar")
            self._sidecar_retry_bg(step, path, arrays)
            return
        self._sweep_sidecars()

    def _sidecar_retry_bg(self, step: int, path: str, arrays: dict) -> None:
        """Hand a failed sidecar write to the background retrier (one
        slot, the newest wins: an older pending sidecar displaced by a
        newer one counts as a skip)."""
        with self._sc_lock:
            if self._sc_pending is not None:
                _log.warning("tiering: sidecar for step %d displaced by "
                             "step %d before its background retry ran — "
                             "skipped", self._sc_pending[0], step)
                self._obs_metric("inc", "storage.sidecar_skips", 1)
            self._sc_pending = (step, path, arrays)
            t = self._sc_thread
            if t is None or not t.is_alive():
                t = threading.Thread(target=self._sidecar_retry_loop,
                                     name="sidecar-retrier", daemon=True)
                self._sc_thread = t
                t.start()

    def _sidecar_retry_loop(self) -> None:
        from fps_tpu_torch.core import retry as _retry

        while True:
            with self._sc_lock:
                item, self._sc_pending = self._sc_pending, None
            if item is None:
                return
            step, path, arrays = item

            try:
                _retry.call_with_retry(
                    lambda: self._write_sidecar_file(path, arrays),
                    policy=dataclasses.replace(
                        _retry.DEFAULT_PUBLISH_RETRY, seed=path),
                    op="sidecar",
                    on_retry=lambda a, e, d: self._obs_metric(
                        "inc", "storage.retries", 1, plane="sidecar"))
            except OSError as e:
                _log.warning("tiering: sidecar write for step %d DEGRADED "
                             "(skipped after retries): %r — a resume past "
                             "this boundary cold-starts the tracker", step,
                             e)
                self._obs_metric("inc", "storage.sidecar_skips", 1)
                continue
            try:
                self._sweep_sidecars()
            except OSError:
                pass

    def sidecar_flush(self, timeout: float | None = None) -> None:
        """Block until a background sidecar retry has drained (for tests
        and shutdown; training never calls it)."""
        t = self._sc_thread
        if t is not None and t.is_alive():
            t.join(timeout)

    @staticmethod
    def _obs_metric(kind: str, name: str, value, **labels) -> None:
        from fps_tpu_torch.obs import events

        events.record_metric(kind, name, value, **labels)

    @staticmethod
    def _write_sidecar_file(path: str, arrays: dict) -> None:
        """The write through the storage seams (path class ``sidecar``)."""
        from fps_tpu_torch.core import retry as _retry

        _retry.fault_check("write", path)
        tmp = path + ".tmp.npz"
        try:
            with open(tmp, "wb") as f:
                np.savez(f, **arrays)
                f.flush()
                _retry.fault_check("fsync", path)
                os.fsync(f.fileno())
            _retry.fault_check("replace", path)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                try:
                    os.remove(tmp)
                except OSError:
                    pass

    def _sweep_sidecars(self) -> None:
        """Keep every sidecar whose step has a published snapshot beside
        it (a resume restores the one of ``latest_valid_step``, which may
        be older than the last boundaries), and the newest ``keep``."""
        from fps_tpu_torch.core import snapshot_format as fmt

        ckpt_steps = set()
        for f in os.listdir(self.state_dir):
            m = fmt.SNAPSHOT_RE.fullmatch(f)
            if m:
                ckpt_steps.add(int(m.group(1)))
        kept = sorted(
            f for f in os.listdir(self.state_dir)
            if f.startswith("tiering-") and f.endswith(".npz")
            and not f.endswith(".tmp.npz"))
        for f in kept[:-self.keep] if self.keep else kept:
            try:
                step = int(f[len("tiering-"):-len(".npz")])
            except ValueError:
                continue
            if step in ckpt_steps:
                continue
            try:
                os.remove(os.path.join(self.state_dir, f))
            except OSError:
                pass

    def restore(self, step: int) -> bool:
        """Load the sidecar of boundary ``step`` (the restored checkpoint's
        step). True on an exact match; False (a cold tracker, with a
        warning) when it is missing: training stays correct, only the
        re-rank decisions start from scratch. Reads the JAX package's
        sidecars too."""
        if self.state_dir is None:
            return False
        path = sidecar_path(self.state_dir, step)
        if not os.path.exists(path):
            if step:
                _log.warning(
                    "tiering: no sidecar for step %d under %s — tracker "
                    "restarts cold (re-rank decisions may differ from the "
                    "uninterrupted run)", step, self.state_dir)
            return False
        from fps_tpu_torch.tiering.planner import TierPlan

        with np.load(path) as z:
            meta = json.loads(bytes(z["meta"]).decode())
            self.tick = int(meta["tick"])
            self.planned = bool(meta.get("planned", False))
            self.plans = ({n: TierPlan(**p) for n, p in
                           meta["plans"].items()}
                          if meta.get("plans") else None)
            self.state = {}
            self.hot_ids = {}
            self._restored_windows = {}
            for k in z.files:
                if k.startswith("state::"):
                    self.state[k[len("state::"):]] = z[k].copy()
                elif k.startswith("hot::"):
                    self.hot_ids[k[len("hot::"):]] = z[k].copy()
                elif k.startswith("window::"):
                    self._restored_windows[k[len("window::"):]] = (
                        z[k].copy())
        return True
