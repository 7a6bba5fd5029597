"""Model export, warm start and periodic checkpoints.

Port of ``fps_tpu/core/checkpoint.py``, with the same on-disk contract
(:mod:`fps_tpu_torch.core.snapshot_format`): a snapshot written by either
package restores in the other, its arrays and CRC tags equal.

* **export**: :func:`export_model` writes every table as a logical
  ``(num_ids, dim)`` array (id order, padding rows stripped) to one
  ``.npz``;
* **warm start**: :func:`load_model` / :func:`load_rows` overwrite table
  rows from a saved model (a whole table or any id subset), each row
  placed on its owner's positions;
* **periodic snapshots**: :class:`Checkpointer` saves the tables and the
  worker-local state every N chunks or epochs and restores them. Tables
  are saved in logical id order, so a snapshot taken on one mesh restores
  on any other (the elastic re-split, asserted bit for bit).

:class:`AsyncCheckpointer` is the double-buffered variant: the
device-to-host capture runs on the training thread (:meth:`save`) or on
the writer thread behind boundary copies (:meth:`save_deferred`), the
serialize, fsync and rename on a background writer, and ``flush()`` is
the durability barrier.

Every save, fallback, re-split, compaction and degraded publish goes to
the run journal and the metrics through the process-default recorder
(:mod:`fps_tpu_torch.obs.events`; a no-op when none is installed), under
the reference's names. The pod fence (``pod_fence.json``) is part of the
directory's contract and is honoured here; the fence's helpers and its
:class:`StaleEpochError` are the supervisor's
(:mod:`fps_tpu_torch.supervise.child`), re-exported here.
"""

from __future__ import annotations

import dataclasses
import errno as _errno_mod
import json
import logging
import os
import tempfile
import threading
import time
from typing import Any, Mapping

import numpy as np
import torch

from fps_tpu_torch.core import retry as _retry
from fps_tpu_torch.core import snapshot_format
from fps_tpu_torch.core.resilience import (
    SnapshotCorruptionError,
    array_crc32,
    tree_flatten,
    tree_unflatten,
)
from fps_tpu_torch.core.store import (
    FOLD_KEY_SUFFIX,
    ParamStore,
    hot_key,
    id_to_phys,
    is_aux_key,
    is_hot_key,
    rows_per_shard,
)
# The pod fence (``pod_fence.json``, read before every publish) and its
# error: one definition, the supervisor's, so the class a publish raises is
# the class a pod coordinator catches.
from fps_tpu_torch.supervise.child import (  # noqa: F401
    FENCE_FILENAME,
    POD_EPOCH_ENV,
    StaleEpochError,
    fence_allows,
    read_fence,
    write_fence,
)

Pytree = Any

_log = logging.getLogger("fps_tpu_torch.checkpoint")


def _obs_event(etype: str, **fields) -> None:
    """Persistence events onto the process-default recorder
    (:mod:`fps_tpu_torch.obs.events`): the run journal's checkpoint trail,
    a no-op when no recorder is installed."""
    from fps_tpu_torch.obs import events

    events.emit(etype, **fields)


def _obs_metric(kind: str, name: str, value: float, **labels) -> None:
    from fps_tpu_torch.obs import events

    events.record_metric(kind, name, value, **labels)


def _fenced(e: BaseException) -> bool:
    """Whether a fence refusal is anywhere in ``e``'s cause chain."""
    cause = e
    while cause is not None:
        if isinstance(cause, StaleEpochError):
            return True
        cause = cause.__cause__
    return False


# The on-disk contract (filename regex, npz key layout, per-array
# ``meta::crc`` integrity tags, the torn-file error set) lives in the
# :mod:`fps_tpu_torch.core.snapshot_format` so the serving plane and
# the chaos injectors can share it without importing this module; the
# names are re-exported here.
_SEP = snapshot_format.SEP  # npz key separator: kind::name
SNAPSHOT_RE = snapshot_format.SNAPSHOT_RE
SNAPSHOT_FMT = snapshot_format.SNAPSHOT_FMT
_CRC_PREFIX = snapshot_format.CRC_PREFIX
_IO_ERRORS = snapshot_format.IO_ERRORS


def _keys(z):
    """Key collection of an open npz OR a plain {key: array} dict (the
    verified-read path materializes entries before using these helpers)."""
    return z.files if hasattr(z, "files") else z


def _ls_leaves(z) -> list:
    """Local-state leaves from an npz/dict (touches only ls:: keys)."""
    leaves = []
    i = 0
    while f"ls{_SEP}{i}" in _keys(z):
        leaves.append(z[f"ls{_SEP}{i}"])
        i += 1
    return leaves


def _ls_format(z) -> str:
    key = f"meta{_SEP}ls_format"
    return str(z[key]) if key in _keys(z) else "raw"


# ---------------------------------------------------------------------------
# Model export (the reference's close()-time (id, param) stream).
# ---------------------------------------------------------------------------

def _table_arrays(store: ParamStore) -> dict[str, np.ndarray]:
    """All tables as npz entries, logical id order, padding stripped.

    Spec-driven by design: under two-tier hot storage the live tables
    dict also carries replicated hot-head entries (``hot_key(name)``,
    never in ``store.specs``) — a snapshot stays ONE canonical table per
    spec. The drivers flush-reconcile every compiled call, so at any
    save boundary the sharded table already folds all hot pushes;
    restore re-splits via ``Trainer._attach_hot``. A checkpoint written
    under the tier is therefore byte-compatible with (and restorable
    by) an untiered run of the same state.
    """
    assert not any(is_hot_key(name) for name in store.specs), (
        "hot-replica entries must never be registered as specs — the "
        "canonical sharded table is the only serialized form"
    )
    return {
        f"table{_SEP}{name}": store.dump_model(name)[1] for name in store.specs
    }


def export_model(store: ParamStore, path: str) -> None:
    """Write all tables, logical id order, padding stripped, to ``path``.npz."""
    _atomic_savez(path, _table_arrays(store))


def load_saved_model(path: str) -> dict[str, np.ndarray]:
    """Read a model saved by :func:`export_model` → ``{table: (n, dim)}``."""
    with np.load(path) as z:
        return {
            k.split(_SEP, 1)[1]: z[k] for k in z.files if k.startswith(f"table{_SEP}")
        }


# ---------------------------------------------------------------------------
# Warm start (transformWithModelLoad parity).
# ---------------------------------------------------------------------------

def load_rows(
    store: ParamStore, name: str, ids: np.ndarray, values: np.ndarray
) -> None:
    """Overwrite rows ``ids`` of table ``name`` with ``values``.

    The sharded-array equivalent of streaming ``(paramId, value)`` records
    into the servers: each row lands on its owning shard (owner-major cyclic
    layout), rows not mentioned keep their current (initialized or trained)
    values. Call after ``store.init(key)``.
    """
    if name not in store.tables:
        raise ValueError(f"table {name!r} not initialized; call store.init first")
    spec = store.specs[name]
    ids = np.asarray(ids, np.int64)
    values = np.asarray(values)
    if ids.ndim != 1 or len(ids) != len(values):
        raise ValueError("ids must be 1-D and match values length")
    if values.shape != (len(ids), spec.dim):
        raise ValueError(
            f"values shape {values.shape} != ({len(ids)}, {spec.dim}) "
            f"for table {name!r}"
        )
    if len(ids) and (ids.min() < 0 or ids.max() >= spec.num_ids):
        raise ValueError(f"ids out of range for table {name!r} ({spec.num_ids})")
    rps = rows_per_shard(spec.num_ids, store.num_shards)
    phys = np.asarray(id_to_phys(ids, store.num_shards, rps))
    dtype = torch.empty((), dtype=spec.dtype).numpy().dtype
    # Host-side row overwrite, then placed on the positions. Loads are
    # rare, host-bandwidth-bound events.
    if len(ids) == spec.num_ids and len(np.unique(ids)) == spec.num_ids:
        # Full overwrite: every real row is supplied, so skip downloading
        # the about-to-be-discarded table; padding rows (never addressed by
        # any valid id) are zero-filled.
        host = np.zeros((rps * store.num_shards, spec.dim), dtype)
        host[phys] = values.astype(dtype)
    else:
        # A collective over several processes (every process calls it).
        host = store.tables[name].numpy().astype(dtype, copy=True)
        host[phys] = values.astype(dtype)
    # Each process places its own positions' shards only.
    store.put(name, torch.from_numpy(host))
    # A live hot replica of this table is now stale: drop it; the next
    # run entry re-splits from the rewritten canonical table.
    store.tables.pop(hot_key(name), None)


def load_model(
    store: ParamStore,
    model: Mapping[str, np.ndarray] | str,
    *,
    strict: bool = False,
) -> None:
    """Warm-start all tables of ``store`` from a saved model.

    ``model`` is a path produced by :func:`export_model` or a dict
    ``{table_name: (num_ids, dim) array}``. Tables absent from the model keep
    their fresh initialization (``strict=True`` raises instead).
    """
    if isinstance(model, str):
        model = load_saved_model(model)
    for name, spec in store.specs.items():
        if name not in model:
            if strict:
                raise ValueError(f"model has no table {name!r}")
            continue
        values = np.asarray(model[name])
        if values.shape != (spec.num_ids, spec.dim):
            raise ValueError(
                f"table {name!r}: saved shape {values.shape} != "
                f"({spec.num_ids}, {spec.dim})"
            )
        load_rows(store, name, np.arange(spec.num_ids), values)


# ---------------------------------------------------------------------------
# Delta publications: crash-safe incremental snapshot chains.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DeltaPolicy:
    """Knobs for delta-snapshot chains (``Checkpointer(delta=...)``).

    With a policy attached, a save whose state can be described as a
    row-sparse diff against the previous publication writes a DELTA
    (``delta_{step}_{base}.npz``: per-key touched-row ids + values, each
    entry CRC-tagged like a full's, carrying ``meta::base_step`` and the
    fencing epoch) instead of rewriting whole tables — publish bytes and
    write→servable lag become O(touched rows), not O(table).

    * ``full_every`` — hard chain-length bound: at most ``full_every-1``
      consecutive deltas before the writer publishes a fresh full
      (bounds recovery-walk depth and blast radius; ``<= 1`` disables
      deltas entirely).
    * ``compact_every`` — LSM-style compaction trigger: when the live
      on-disk chain carries at least this many deltas, the next publish
      folds the chain into a fresh full at the chain head (on the
      AsyncCheckpointer this runs on the background writer thread) and
      sweeps the folded links. ``0`` = compaction only via an explicit
      :meth:`Checkpointer.compact` call.

    Touched-row sourcing: per-table supersets handed to ``save(...,
    touched_rows=...)`` (the drivers accumulate them from the
    traffic stream, ``WorkerLogic.pulled_ids_host``) make the diff
    O(touched); tables without a supplied set fall back to an exact
    vectorized row compare against the retained base (O(table) compute,
    still O(changed) bytes). Worker-local state (``ls::``) and hot-fold
    state (``fold::``) always use the exact compare. Either way a delta
    restores bit-identically to the full it stands in for.
    """

    full_every: int = 8
    compact_every: int = 0


class OrphanDeltaError(RuntimeError):
    """A planned delta's base publication never landed (its write
    failed or was degraded): publishing the delta would leave a broken
    chain head on disk, so the writer refuses it. Under the async
    writer's degraded mode this skips like any other degraded publish —
    the chain plan resets and the next save publishes a full."""


class TouchedRowsTracker:
    """Accumulates per-table touched-row id supersets between
    publications (driver-side source for ``save(touched_rows=...)``).

    Append-only log of per-chunk observations; :meth:`capture` unions
    the current prefix WITHOUT consuming it (a deferred/overlapped save
    may be re-captured after a quarantine recompute), and
    :meth:`commit` drops the prefix once its publication was actually
    accepted. ``observe(None)`` (an uncertifiable chunk) poisons every
    table in the prefix — those tables publish via the exact-diff
    fallback instead.
    """

    def __init__(self, tables):
        self.tables = tuple(sorted(tables))
        self._log: list = []  # per-chunk: dict[name -> ids] | None

    def observe(self, ids_by_table) -> None:
        if ids_by_table is None:
            self._log.append(None)
            return
        self._log.append({
            name: np.unique(np.asarray(ids, np.int64).reshape(-1))
            for name, ids in ids_by_table.items()})

    def capture(self) -> tuple[dict, int]:
        """``(touched_rows, marker)`` over the current prefix — tables
        unseen by every observation (or covered by an uncertifiable
        chunk) map to ``None`` (exact-diff fallback)."""
        marker = len(self._log)
        prefix = self._log[:marker]
        unknown = any(obs is None for obs in prefix)
        out = {}
        for name in self.tables:
            if unknown or any(name not in obs for obs in prefix):
                out[name] = None
                continue
            parts = [obs[name] for obs in prefix]
            out[name] = (np.unique(np.concatenate(parts)) if parts
                         else np.zeros(0, np.int64))
        return out, marker

    def commit(self, marker: int) -> None:
        del self._log[:marker]


# ---------------------------------------------------------------------------
# Periodic checkpointing (tables + worker-local state + step counter).
# ---------------------------------------------------------------------------

class Checkpointer:
    """Snapshot/restore the full training state under a directory.

    Layout: ``{dir}/ckpt_{step:012d}.npz`` holding every table (logical
    order) plus the flattened ``local_state`` pytree. ``keep`` bounds how
    many snapshots are retained.

    Restore re-lays-out *tables* onto the current mesh, so a checkpoint taken
    on one shard count resumes on another (the reference could not even
    save). Worker-local state saved through the Trainer path is stored in
    the logic's worker-count-independent export form (e.g. MF user factors
    in logical user order) — ``Trainer.restore_checkpoint`` re-lays it out
    for any worker count when the logic implements ``import_local_state``;
    the raw :meth:`restore` keeps the same-worker-count contract.

    Integrity: every array is saved with a ``meta::crc::<key>`` CRC-32
    tag, verified by :meth:`read_snapshot` (so by both restore paths).
    When the latest snapshot turns out truncated/bit-flipped, an
    auto-resolved restore (``step=None``) logs, renames the bad file to
    ``*.corrupt``, and falls back to the previous surviving snapshot —
    ``keep >= 2`` is therefore a real redundancy contract, not just a
    disk-usage knob. Pinning an explicit ``step=`` raises
    :class:`~fps_tpu_torch.core.resilience.SnapshotCorruptionError` instead.
    Construction sweeps stale ``*.tmp.npz`` files (leftovers of a save
    that died mid-write before its atomic rename) — but only ones older
    than :attr:`TMP_SWEEP_AGE_S`, so a concurrent writer's in-flight tmp
    file is never deleted from under it.

    Delta chains (``delta=DeltaPolicy(...)``): saves publish
    row-sparse DELTAS against the previous publication when that is
    smaller — publish bytes become O(touched rows) — with recovery
    walking full→delta chains (a torn/CRC-failing/epoch-stale link
    truncates back to the last verified one, and quarantining a full
    quarantines every delta chained on it) and :meth:`compact` folding
    chains back into fulls LSM-style under the same atomic-rename +
    fence-precommit discipline. ``docs/resilience.md`` has the failure
    model; ``docs/serving.md`` the read-side contract.
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 fence_epoch: int | None = None,
                 delta: DeltaPolicy | None = None,
                 retry: _retry.RetryPolicy | None = None):
        if keep < 1:
            raise ValueError(f"keep must be >= 1, got {keep}")
        self.dir = directory
        self.keep = keep
        # Hostile-filesystem survival (fps_tpu_torch.core.retry): every publish
        # retries transient I/O errors (ENOSPC/EIO/ETIMEDOUT/...) under a
        # bounded, deterministically-jittered backoff before failing —
        # seeded per directory so co-located writers desynchronize.
        # RetryPolicy(retries=0) disables retries entirely.
        self.retry_policy = (retry if retry is not None
                             else dataclasses.replace(
                                 _retry.DEFAULT_PUBLISH_RETRY,
                                 seed=directory))
        # Degraded-mode accounting (the AsyncCheckpointer skips a
        # publish after retries instead of crashing training; the sync
        # base class raises, so these stay 0 here).
        self.degraded_publishes = 0
        self._publish_backlog = 0
        # Pod fencing epoch: checked against the
        # directory's ``pod_fence.json`` immediately before every
        # publish. ``None`` = this writer predates/ignores the pod
        # contract — it may publish into an UNfenced dir, but a fenced
        # dir refuses it too (a stale pre-abort child must never leak a
        # checkpoint into the pod's new attempt). Children read their
        # epoch from the pod env contract: ``fence_epoch_from_env()``.
        self.fence_epoch = fence_epoch
        # Delta-snapshot chains (DeltaPolicy): _chain_base retains the
        # last publication's full-form host arrays (one snapshot's worth
        # of host memory — the same order the async writer's queue slot
        # already costs) so a save can be planned as a row-sparse diff;
        # _chain_head/_chain_len track the live chain. All three are
        # advisory plan state: the ON-DISK chain is the source of truth
        # and a restart re-derives them from read_snapshot.
        self.delta_policy = delta
        self._chain_base: dict | None = None
        self._chain_head: int | None = None
        self._chain_len = 0
        # Publication accounting (bench / chaos evidence; the writer
        # thread is the single mutator under the async subclass).
        self.full_publishes = 0
        self.delta_publishes = 0
        self.compactions = 0
        self.publish_bytes_total = 0
        self.delta_bytes_total = 0
        # Test seam for the compaction chaos scenarios: called with a
        # phase name ("precommit" — after the new full's fsync, before
        # its publishing rename; "published" — after the rename, before
        # the sweep; "swept_one" — after the first folded link is
        # removed). A chaos victim SIGKILLs itself here to pin the
        # recovery contract at every phase. None in production.
        self._compact_phase_hook = None
        os.makedirs(directory, exist_ok=True)
        self._sweep_tmp()
        self._sweep_corrupt()

    # A tmp file younger than this is treated as a LIVE write in progress
    # (another process mid-_atomic_savez) and left alone; older ones are
    # crash leftovers. Far above any realistic serialize+fsync time.
    TMP_SWEEP_AGE_S = 3600.0

    # Quarantined ``*.corrupt`` files are forensic evidence, not live
    # state — bound them (age + count, mirroring the tmp sweep) so a
    # long-lived training dir with recurring disk faults doesn't
    # accumulate dead snapshots forever: at most CORRUPT_KEEP files, none
    # older than CORRUPT_SWEEP_AGE_S.
    CORRUPT_KEEP = 4
    CORRUPT_SWEEP_AGE_S = 7 * 24 * 3600.0

    def _sweep_corrupt(self) -> None:
        """Bound the ``*.corrupt`` quarantine: drop files older than
        :attr:`CORRUPT_SWEEP_AGE_S`, and everything beyond the newest
        :attr:`CORRUPT_KEEP` even when young (a fast corruption loop must
        not fill the disk). Runs at construction and after each
        quarantine."""
        entries = []
        for f in os.listdir(self.dir):
            if not f.endswith(".corrupt"):
                continue
            path = os.path.join(self.dir, f)
            try:
                entries.append((os.path.getmtime(path), path))
            except OSError:
                continue
        entries.sort(reverse=True)  # newest first
        now = time.time()
        for rank, (mtime, path) in enumerate(entries):
            if rank < self.CORRUPT_KEEP and now - mtime < self.CORRUPT_SWEEP_AGE_S:
                continue
            try:
                _log.warning("sweeping quarantined snapshot %s",
                             os.path.basename(path))
                os.remove(path)
            except OSError:
                pass

    def _sweep_tmp(self) -> None:
        """Remove partial ``.tmp.npz`` files left by a crash mid-save.

        ``_atomic_savez`` names tmp files uniquely (mkstemp) and publishes
        only via ``os.replace``, so anything still wearing the tmp suffix
        was never a live snapshot — but it may be a CONCURRENT writer's
        in-flight file (a monitoring process constructing a Checkpointer
        on a live training dir), so only files older than
        :attr:`TMP_SWEEP_AGE_S` are swept."""
        now = time.time()
        for f in os.listdir(self.dir):
            if not f.endswith(".tmp.npz"):
                continue
            path = os.path.join(self.dir, f)
            try:
                if now - os.path.getmtime(path) < self.TMP_SWEEP_AGE_S:
                    continue
                _log.warning("sweeping stale checkpoint tmp file %s", f)
                os.remove(path)
            except OSError:
                pass

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, SNAPSHOT_FMT.format(step=step))

    def _collect(self, store: ParamStore, local_state: Pytree,
                 local_state_format: str) -> dict[str, np.ndarray]:
        """Snapshot-point capture: every table + local-state leaf as HOST
        arrays (the device→host dump, with its collectives in
        multi-controller runs) — the part of a save that must happen
        synchronously at the training step it describes. Serialization
        (:meth:`_write`) can then run later/elsewhere."""
        arrays = _table_arrays(store)
        # Hot-fold optimizer state (ServerLogic.hot_fold): separate
        # ``fold::`` entries, never part of the canonical table bytes —
        # an untiered (or older) reader skips the kind, a resuming
        # tiered trainer restores it for bit-identical replay.
        for key in sorted(store.tables):
            if not key.endswith(FOLD_KEY_SUFFIX):
                continue
            name = key[: -len(FOLD_KEY_SUFFIX)]
            # The shard axis's slices in order: a collective over
            # several processes.
            arrays[snapshot_format.FOLD_PREFIX + name] = _host_array(
                store.tables[key])
        # jax.tree.flatten's order (tree_flatten), so the ls:: leaves are
        # the same in both packages; over several processes a
        # worker-sharded leaf is gathered (a collective: every process
        # calls save).
        leaves, treedef = tree_flatten(local_state)
        for i, leaf in enumerate(leaves):
            arrays[f"ls{_SEP}{i}"] = _host_array(leaf)
        arrays[f"meta{_SEP}ls_format"] = np.array(local_state_format)
        # Mesh-shape stamp: restore onto a DIFFERENT shape takes (and
        # asserts) the explicit elastic re-split path — the invariant the
        # pod's W±1 re-planning stands on.
        arrays[snapshot_format.MESH_SHAPE_KEY] = np.array(json.dumps(
            {k: int(v) for k, v in store.mesh.shape.items()},
            sort_keys=True))
        if self.fence_epoch is not None:
            # Forensic epoch stamp: pod chaos scenarios scan these to
            # prove no stale-epoch publish ever landed behind a fence.
            arrays[snapshot_format.POD_EPOCH_KEY] = np.int64(
                self.fence_epoch)
        del treedef  # structure is supplied by local_state_like at restore
        return arrays

    def _check_fence(self, step: int) -> None:
        """Refuse to publish behind a pod fence. Read FRESH on every
        write (never cached): the fence appears asynchronously, dropped
        by the pod leader into this directory when a newer attempt is
        commanded — from that point this writer is a zombie of an aborted
        attempt and must fail loudly, not land a stale snapshot."""
        ok, min_epoch = fence_allows(self.dir, self.fence_epoch)
        if ok:
            return
        _obs_event("checkpoint_fenced", step=int(step),
                   epoch=self.fence_epoch, min_epoch=min_epoch,
                   dir=self.dir)
        _obs_metric("inc", "checkpoint.fenced_publishes", 1)
        raise StaleEpochError(
            f"checkpoint step {step} refused: writer epoch "
            f"{self.fence_epoch} is behind the pod fence (min_epoch "
            f"{min_epoch}) in {self.dir} — this process belongs to an "
            "attempt the pod has aborted and restarted past"
        )

    def _write(self, step: int, arrays: dict[str, np.ndarray], *,
               base: int | None = None) -> str:
        """Serialize half of a save: CRC tags, atomic fsync'd write,
        telemetry, retention GC. Runs on the caller's thread here; the
        AsyncCheckpointer runs it on its writer thread. ``base`` is not
        None for a DELTA publication (``arrays`` already holds the
        sparse entries from :meth:`_plan_publication`)."""
        self._check_fence(step)
        if base is not None and base not in self._pubs():
            # The async writer may reach this delta AFTER its base's
            # write failed (the plan ran on the caller thread while the
            # base was still in flight): publishing it would leave a
            # broken chain head on disk. Refuse — the caller sees the
            # error (and the base's original failure) on its next
            # save/flush, and the chain plan resets to a full.
            raise OrphanDeltaError(
                f"refusing orphan delta step {step}: base publication "
                f"{base} never landed under {self.dir}")
        arrays = dict(arrays)
        for k in list(arrays):
            arrays[_CRC_PREFIX + k] = np.uint32(array_crc32(arrays[k]))
        path = (self._path(step) if base is None
                else snapshot_format.delta_path(self.dir, step, base))
        t0 = time.perf_counter()
        # The fence is re-checked as the PRE-COMMIT hook, after the slow
        # serialize+fsync and immediately before the publishing rename —
        # a fence that lands while a big table is serializing still wins.
        # Every link of a delta chain re-reads it the same way: a stale
        # zombie can no more extend a chain than publish a full.
        self._savez_with_retry(path, arrays,
                               precommit=lambda: self._check_fence(step))
        secs = time.perf_counter() - t0
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = -1
        # "publication", not "kind": the record envelope already uses
        # the "kind" key for event-vs-metric.
        _obs_event("checkpoint_saved", step=int(step), path=path,
                   seconds=round(secs, 4), bytes=nbytes,
                   publication="full" if base is None else "delta",
                   **({} if base is None else {"base": int(base)}))
        _obs_metric("inc", "checkpoint.saves", 1)
        _obs_metric("observe", "checkpoint.save_seconds", secs)
        if nbytes >= 0:
            if base is None:
                # FULLS only: this gauge is the payload-proportionality
                # reference checkpoint.delta_bytes is compared against —
                # letting a small delta overwrite it would make the
                # obs_report ratio meaningless.
                _obs_metric("set", "checkpoint.bytes", nbytes)
            self.publish_bytes_total += nbytes
        if base is None:
            self.full_publishes += 1
        else:
            self.delta_publishes += 1
            if nbytes >= 0:
                self.delta_bytes_total += nbytes
                _obs_metric("inc", "checkpoint.delta_bytes", nbytes)
            _obs_metric("inc", "checkpoint.delta_publishes", 1)
        self._gc()
        self._maybe_auto_compact()
        return path

    def _savez_with_retry(self, path: str, arrays, *, precommit=None
                          ) -> None:
        """``_atomic_savez`` under this writer's :class:`RetryPolicy`:
        transient I/O failures (errno-classified by
        ``fps_tpu_torch.core.retry``) retry with bounded deterministic
        backoff; a fence refusal in ``precommit`` is fatal and raises
        through immediately (a zombie must never keep hammering the
        directory). Each retry leaves no partial state: a failed
        attempt's tmp file is removed by ``_atomic_savez`` itself."""

        def on_retry(attempt, err, delay):
            _log.warning(
                "transient I/O failure publishing %s (attempt %d, "
                "retrying in %.3fs): %r", os.path.basename(path),
                attempt + 1, delay, err)
            _obs_metric("inc", "storage.retries", 1, plane="checkpoint")

        _retry.call_with_retry(
            lambda: _atomic_savez(path, arrays, precommit=precommit),
            policy=self.retry_policy, op="publish", on_retry=on_retry)

    def save(self, step: int, store: ParamStore, local_state: Pytree = None,
             *, local_state_format: str = "raw",
             touched_rows: Mapping | None = None) -> str:
        """``local_state_format`` tags how the local-state leaves are laid
        out: ``"raw"`` (device layout, restorable via :meth:`restore` at
        the same worker count) or ``"exported"`` (the worker logic's
        worker-count-independent form, written by the Trainer path and
        restorable only via ``Trainer.restore_checkpoint``). The tag makes
        a mismatched restore fail loudly instead of silently permuting
        state when shapes happen to coincide.

        ``touched_rows`` (delta chains only): per-table id SUPERSETS of
        the rows touched since the last publication (``None`` entries /
        a ``None`` dict fall back to the exact row compare). Ignored
        without a :class:`DeltaPolicy`."""
        arrays = self._collect_timed(store, local_state, local_state_format)
        step, base, payload = self._plan_publication(
            int(step), arrays, touched_rows)
        try:
            return self._write(step, payload, base=base)
        except BaseException:
            # The planned chain state described a publication that never
            # landed — a later delta must not chain onto it.
            self._chain_reset()
            raise

    # -- delta-chain planning (caller thread, serial) ----------------------

    def _chain_reset(self) -> None:
        self._chain_base = None
        self._chain_head = None
        self._chain_len = 0

    def _plan_publication(self, step: int, arrays: dict,
                          touched_rows: Mapping | None
                          ) -> tuple[int, int | None, dict]:
        """Decide full vs delta for one save: returns ``(step, base,
        payload)`` (``base is None`` = full, payload = the entries to
        serialize) and advances the in-memory chain plan. Exactness
        rule: a delta is only planned when EVERY entry of the new state
        is either bit-carried from the retained base or explicitly in
        the payload — anything surprising (no policy, no base, key/shape
        drift, non-monotone step, chain at its length bound, delta not
        actually smaller) publishes a full."""
        policy = self.delta_policy
        if policy is None or policy.full_every <= 1:
            return step, None, arrays
        # The retained base must OWN its memory: a zero-copy view of a
        # device buffer the next step donates away would silently rot
        # the diff baseline (the async writer makes the same copy for
        # its queue slot; here it protects the sync path too).
        arrays = dict(arrays)
        for k, v in arrays.items():
            if isinstance(v, np.ndarray) and not v.flags["OWNDATA"]:
                arrays[k] = np.array(v, copy=True)
        base_ok = (self._chain_base is not None
                   and self._chain_head is not None
                   and step > self._chain_head
                   and self._chain_len + 1 < policy.full_every)
        payload = (self._delta_entries(arrays, touched_rows)
                   if base_ok else None)
        if payload is not None:
            full_bytes = sum(getattr(v, "nbytes", 0)
                             for v in arrays.values())
            delta_bytes = sum(getattr(v, "nbytes", 0)
                              for v in payload.values())
            if delta_bytes >= full_bytes:
                payload = None  # no savings: a full is strictly better
        if payload is None:
            self._chain_base = dict(arrays)
            self._chain_head = step
            self._chain_len = 0
            return step, None, arrays
        base = self._chain_head
        payload[snapshot_format.BASE_STEP_KEY] = np.int64(base)
        # Advance the retained base to the state this delta describes
        # (overlay by reference: the arrays are fresh host buffers).
        new_base = dict(self._chain_base)
        for k, v in arrays.items():
            new_base[k] = v
        self._chain_base = new_base
        self._chain_head = step
        self._chain_len += 1
        return step, base, payload

    def _delta_entries(self, arrays: dict, touched_rows: Mapping | None
                       ) -> dict | None:
        """Row-sparse diff of ``arrays`` against the retained chain base:
        ``dids::K``/``drows::K`` pairs for row-sparse keys, plain-key
        full replacements for everything else that changed, nothing for
        bit-identical entries. ``None`` when the structural contract
        broke (key set / shape / dtype drift on a row-sparse kind)."""
        base = self._chain_base
        fmt = snapshot_format
        sparse_kinds = (f"table{_SEP}", fmt.FOLD_PREFIX, f"ls{_SEP}")
        out: dict[str, np.ndarray] = {}
        for k, v in arrays.items():
            if k.startswith(f"meta{_SEP}"):
                # Meta tags ride every link in full (tiny, and the
                # chain verifier needs each delta's OWN fencing epoch —
                # an omitted-because-unchanged epoch would blind the
                # read-side staleness check).
                out[k] = v
                continue
            bv = base.get(k)
            row_sparse = (k.startswith(sparse_kinds)
                          and getattr(v, "ndim", 0) >= 2)
            if bv is None:
                if row_sparse:
                    return None  # a new table/leaf appeared: full
                out[k] = v
                continue
            same_layout = (getattr(bv, "shape", None) == v.shape
                           and getattr(bv, "dtype", None) == v.dtype)
            if not same_layout:
                if row_sparse:
                    return None
                out[k] = v
                continue
            if not row_sparse:
                if not np.array_equal(bv, v):
                    out[k] = v
                continue
            ids = None
            if touched_rows is not None and k.startswith(f"table{_SEP}"):
                ids = touched_rows.get(k.split(_SEP, 1)[1])
            if ids is not None:
                # Tracker-sourced superset: O(touched) work, no compare.
                ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
                ids = ids[(ids >= 0) & (ids < len(v))]
            else:
                # Exact vectorized row compare against the base.
                tail = tuple(range(1, v.ndim))
                neq = (v != bv)
                ids = np.flatnonzero(np.any(neq, axis=tail)
                                     if tail else neq)
            out[fmt.DELTA_IDS_PREFIX + k] = np.asarray(ids, np.int64)
            out[fmt.DELTA_ROWS_PREFIX + k] = np.ascontiguousarray(v[ids])
        # Row-sparse keys present in the base but dropped from the new
        # state (a model-definition change): structural — publish full.
        for k in base:
            if (k.startswith(sparse_kinds) and k not in arrays
                    and not k.startswith(_CRC_PREFIX)):
                return None
        return out

    def _capture_timed(self, store, local_state, local_state_format):
        """:meth:`_collect` plus the ``checkpoint.capture_seconds``
        metric — the device→host capture cost wherever it runs (caller
        thread here; the AsyncCheckpointer's deferred path runs it on
        the writer thread, where it overlaps device compute instead of
        stalling dispatch)."""
        t0 = time.perf_counter()
        arrays = self._collect(store, local_state, local_state_format)
        _obs_metric("observe", "checkpoint.capture_seconds",
                    time.perf_counter() - t0)
        return arrays

    def _collect_timed(self, store, local_state, local_state_format):
        """:meth:`_capture_timed` plus the ``checkpoint.dump_seconds``
        metric — what a save costs the TRAINING thread. On this inline
        path the two series coincide (the caller pays the capture); a
        deferred capture records dump_seconds around the enqueue only,
        so the split attributes any residual stall."""
        t0 = time.perf_counter()
        arrays = self._capture_timed(store, local_state, local_state_format)
        _obs_metric("observe", "checkpoint.dump_seconds",
                    time.perf_counter() - t0)
        return arrays

    def flush(self) -> None:
        """Durability barrier — every accepted :meth:`save` is on disk
        when this returns. The synchronous base class already is; the
        :class:`AsyncCheckpointer` override waits for its writer."""

    def close(self) -> None:
        """Release writer resources (no-op here; see
        :class:`AsyncCheckpointer`). Safe to call twice."""

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def steps(self) -> list[int]:
        """Published steps, ascending — every publication counts: fulls
        AND delta links (a delta step restores via its chain)."""
        return sorted(self._pubs())

    def _pubs(self) -> dict:
        """Live publication index ({step: Publication}) — re-scanned per
        call; the directory is the source of truth (concurrent writers,
        compaction, quarantine all mutate it)."""
        return snapshot_format.publications(self.dir)

    def latest_step(self) -> int | None:
        steps = self.steps()
        return steps[-1] if steps else None

    def _resolve_step(self, step: int | None) -> int:
        if step is None:
            step = self.latest_step()
            if step is None:
                raise FileNotFoundError(f"no checkpoints under {self.dir}")
        return step

    def _read_entries(self, step: int, path: str, verify: bool) -> dict:
        """Load every non-CRC entry of ONE publication file, verifying
        each against its ``meta::crc`` tag. Raises
        :class:`SnapshotCorruptionError` carrying ``.step`` (the failing
        link — chain reads truncate back to the last verified one)."""
        try:
            path = _retry.read_path(path)  # stale read-after-rename seam
            with np.load(path) as z:
                entries = {k: z[k] for k in z.files
                           if not k.startswith(_CRC_PREFIX)}
                if verify:
                    for k, v in entries.items():
                        ck = _CRC_PREFIX + k
                        if ck in z.files and int(z[ck]) != array_crc32(v):
                            err = SnapshotCorruptionError(
                                f"snapshot step {step}: checksum mismatch "
                                f"on entry {k!r}"
                            )
                            err.step = step
                            raise err
        except (SnapshotCorruptionError, FileNotFoundError):
            # A missing file is "no such checkpoint", not disk corruption —
            # a pinned-but-gc'd step must keep raising FileNotFoundError.
            raise
        except _IO_ERRORS as e:
            err = SnapshotCorruptionError(
                f"snapshot step {step} unreadable: {e!r}"
            )
            err.step = step
            raise err from e
        return entries

    def _resolve_entries(self, step: int, verify: bool) -> dict:
        """Full-form entries of publication ``step`` — a full reads one
        file; a delta walks its chain (every link verified) and overlays
        base→head. A broken/stale/corrupt link raises
        :class:`SnapshotCorruptionError` with ``.step`` naming the LINK,
        so the auto-resolve fallback quarantines exactly the failing
        suffix and truncates the chain back to the last verified one."""
        pubs = self._pubs()
        pub = pubs.get(step)
        if pub is None:
            # Historical contract: a never-published step reads as "no
            # such checkpoint" from the single-file open.
            return self._read_entries(step, self._path(step), verify)
        if pub.kind == "full":
            return self._read_entries(step, pub.path, verify)
        try:
            members = snapshot_format.chain_members(pubs, step)
        except snapshot_format.ChainError as e:
            err = SnapshotCorruptionError(str(e))
            err.step = e.step if e.step is not None else step
            raise err from e
        ok, reason, failing = snapshot_format._check_chain_meta(members)
        if not ok:
            err = SnapshotCorruptionError(
                f"delta chain for step {step} refused: {reason}")
            err.step = failing if failing is not None else step
            raise err
        entries = self._read_entries(members[0].step, members[0].path,
                                     verify)
        for link in members[1:]:
            delta = self._read_entries(link.step, link.path, verify)
            try:
                entries = snapshot_format.apply_delta_entries(
                    entries, delta)
            except snapshot_format.ChainError as e:
                err = SnapshotCorruptionError(
                    f"delta step {link.step} does not apply: {e}")
                err.step = link.step
                raise err from e
        entries.pop(snapshot_format.BASE_STEP_KEY, None)
        return entries

    def _read_verified(self, step: int, verify: bool, *,
                       anchor: bool = False) -> tuple[dict, list, str]:
        """Load EVERY entry of one publication (chain-resolved for
        deltas), checking each against its ``meta::crc`` tag; any read
        error, checksum mismatch, or broken chain raises
        :class:`SnapshotCorruptionError`. Pre-integrity snapshots (no crc
        tags) still get the structural checks — an unreadable zip fails
        either way.

        ``anchor=True`` (the RESTORE path only — ``read_snapshot``)
        re-anchors the delta chain plan on the resolved state so the
        next save may chain from it. Verification reads
        (``verify_snapshot`` / ``latest_valid_step``) must NOT anchor:
        resetting the plan's length on every monitoring probe would
        defeat the ``full_every`` chain-depth bound."""
        entries = self._resolve_entries(step, verify)
        if anchor and self.delta_policy is not None:
            self._chain_base = dict(entries)
            self._chain_head = step
            # Plan length = the resolved publication's ACTUAL on-disk
            # chain depth, so full_every bounds total recovery-walk
            # depth across restarts, not just deltas-since-restore.
            try:
                self._chain_len = sum(
                    1 for p in snapshot_format.chain_members(
                        self._pubs(), step) if p.kind == "delta")
            except snapshot_format.ChainError:
                self._chain_len = 0
        tables = {
            k.split(_SEP, 1)[1]: v
            for k, v in entries.items()
            if k.startswith(f"table{_SEP}")
        }
        # Hot-fold state rides the same values dict under its full
        # ``fold::<name>`` key (table names never contain the separator,
        # so the kinds cannot collide); load_tables re-installs it. The
        # mesh-shape stamp rides along the same way so load_tables can
        # detect (and assert) an elastic re-split restore.
        tables.update({
            k: v for k, v in entries.items()
            if k.startswith(snapshot_format.FOLD_PREFIX)
        })
        if snapshot_format.MESH_SHAPE_KEY in entries:
            tables[snapshot_format.MESH_SHAPE_KEY] = entries[
                snapshot_format.MESH_SHAPE_KEY]
        return tables, _ls_leaves(entries), _ls_format(entries)

    def _quarantine(self, step: int, err: Exception) -> None:
        """Take a corrupt publication out of the rotation (rename to
        ``*.corrupt`` — preserved for forensics, invisible to
        :meth:`steps`) — AND every delta chained on it, transitively: a
        descendant's state is defined in terms of the quarantined link,
        so no reader may ever resolve a chain through it."""
        pubs = self._pubs()
        pub = pubs.get(step)
        path = pub.path if pub is not None else self._path(step)
        _log.warning(
            "discarding corrupt snapshot step %d (%s); falling back to the "
            "previous surviving snapshot", step, err,
        )
        _obs_event("checkpoint_fallback", step=int(step), path=path,
                   error=repr(err))
        _obs_metric("inc", "checkpoint.fallbacks", 1)
        bad = {step}
        doomed = [path]
        # Transitive descendants: any delta whose back-chain passes
        # through a quarantined step.
        changed = True
        while changed:
            changed = False
            for s, p in pubs.items():
                if s not in bad and p.kind == "delta" and p.base in bad:
                    bad.add(s)
                    doomed.append(p.path)
                    changed = True
        for i, p in enumerate(doomed):
            if i:  # the failing link was already logged/evented above
                _log.warning(
                    "quarantining %s: chained on corrupt step %d",
                    os.path.basename(p), step)
                _obs_event("checkpoint_fallback", path=p,
                           step=int(step), chained=True,
                           error="chained on quarantined step")
            try:
                os.replace(p, p + ".corrupt")
                # Age from NOW: the rename preserves the snapshot's
                # original mtime, and an old-enough snapshot would
                # otherwise be deleted by the very sweep below — the
                # sweep's age bound is about time-in-quarantine, not
                # snapshot age.
                os.utime(p + ".corrupt")
            except OSError:
                pass
        self._sweep_corrupt()  # keep the quarantine bounded (age + count)

    def read_snapshot(
        self, step: int | None = None, *, verify: bool = True
    ) -> tuple[int, dict, list, str]:
        """ONE-open read of a snapshot: ``(step, {table: values},
        local_state_leaves, local_state_format)``. The other accessors and
        both restore paths are built on this so a restore parses the .npz
        exactly once.

        Integrity contract: every entry is CRC-verified (``verify=False``
        opts out). With ``step=None`` a corrupt snapshot is quarantined
        and the read falls back to the previous surviving one; with an
        explicit ``step`` corruption raises
        :class:`SnapshotCorruptionError` (the caller pinned that exact
        snapshot, silently answering with another would lie)."""
        explicit = step is not None
        step = self._resolve_step(step)
        tried: set[int] = set()
        reread: set[int] = set()
        while True:
            try:
                tables, leaves, fmt = self._read_verified(step, verify,
                                                          anchor=True)
                return step, tables, leaves, fmt
            except FileNotFoundError:
                if explicit:
                    raise
                # Transient ENOENT / sweep race: a listed file is gone
                # or invisible on THIS read (stale mount, a compaction
                # sweep between list and open). Retry the step once —
                # the stale-mount case recovers — then fall back to
                # older survivors WITHOUT quarantining: there is
                # nothing on disk to quarantine, and the brownout
                # contract says a read hiccup must not crash a restore
                # that has intact older snapshots.
                if step not in reread:
                    reread.add(step)
                    continue
                tried.add(step)
                candidates = [s for s in self.steps() if s not in tried]
                if not candidates:
                    raise
                step = candidates[-1]
            except SnapshotCorruptionError as err:
                if explicit:
                    raise
                bad = getattr(err, "step", step)
                # Transient-read guard (hostile filesystems): a stale
                # or flaky read can make durable, VALID bytes look
                # corrupt for one open — quarantining on that verdict
                # would destroy landed state over a read hiccup. Before
                # quarantining, re-verify the failing link on a fresh
                # read, once: clean ⇒ retry the resolve; still bad ⇒
                # real corruption, quarantine as before.
                if bad not in reread:
                    reread.add(bad)
                    pub = self._pubs().get(bad)
                    p = pub.path if pub is not None else self._path(bad)
                    ok, _ = snapshot_format.verify_snapshot_file(p)
                    if ok:
                        continue
                tried.add(step)  # terminates even if quarantine can't
                # Quarantine the FAILING link (a mid-chain delta names
                # itself via err.step) plus everything chained on it —
                # the fallback then lands on the last verified link.
                self._quarantine(bad, err)
                candidates = [s for s in self.steps() if s not in tried]
                if not candidates:
                    raise FileNotFoundError(
                        f"no intact checkpoints under {self.dir} (latest "
                        f"was corrupt: {err})"
                    ) from err
                step = candidates[-1]

    def verify_snapshot(self, step: int | None = None) -> bool:
        """Full integrity pass over one snapshot (default: latest) without
        loading it into a store: ``True`` iff every entry reads back and
        matches its recorded checksum."""
        try:
            self._read_verified(self._resolve_step(step), True)
            return True
        except (SnapshotCorruptionError, FileNotFoundError):
            return False

    def latest_valid_step(self) -> int | None:
        """Newest step whose snapshot passes :meth:`verify_snapshot`
        (scanning newest→oldest); ``None`` when none does. Read-only —
        corrupt files are left in place (restore quarantines them)."""
        for s in reversed(self.steps()):
            if self.verify_snapshot(s):
                return s
        return None

    def load_tables(self, store: ParamStore, step: int, values_by_name: dict
                    ) -> dict:
        """Validate and load pre-read table arrays (from
        :meth:`read_snapshot`) into ``store`` — public because
        ``Trainer.restore_checkpoint`` builds on it.

        Elastic re-split: when the snapshot's recorded mesh shape differs
        from the store's current mesh, this restore IS the re-split path
        the pod's W±1 re-planning depends on — tables are stored in
        logical id order, so ``load_rows`` re-lays every row onto the new
        owner-major layout. The path is taken explicitly (event + metric)
        and ASSERTED: each re-split table must round-trip bit-identically
        back to the snapshot's logical bytes."""
        saved_shape = None
        raw = values_by_name.get(snapshot_format.MESH_SHAPE_KEY)
        if raw is not None:
            try:
                saved_shape = json.loads(str(raw))
            except (TypeError, ValueError):
                saved_shape = None
        cur_shape = {k: int(v) for k, v in store.mesh.shape.items()}
        resplit = bool(saved_shape) and saved_shape != cur_shape
        if resplit:
            _log.info("checkpoint step %d: mesh-shape re-split %s -> %s",
                      step, saved_shape, cur_shape)
            _obs_event("checkpoint_resplit", step=int(step),
                       from_shape=saved_shape, to_shape=cur_shape)
            _obs_metric("inc", "checkpoint.resplits", 1)
        for name, spec in store.specs.items():
            if name not in values_by_name:
                raise ValueError(
                    f"checkpoint step {step} has no table {name!r} — "
                    "was it taken with an older model definition?"
                )
            values = values_by_name[name]
            if values.shape != (spec.num_ids, spec.dim):
                raise ValueError(
                    f"checkpoint table {name!r} shape {values.shape} != "
                    f"store spec ({spec.num_ids}, {spec.dim})"
                )
            load_rows(store, name, np.arange(len(values)), values)
        # Any live tiering aux entries (hot replicas, adaptive slot maps,
        # tracker sketches) are projections of — or windows over — the
        # state just overwritten: stale now. Drop them all so the
        # run-entry re-split (Trainer._attach_hot) derives fresh entries
        # from the restored canonical tables (and the restored tracker
        # state) instead of silently serving pre-restore values.
        for key in [k for k in store.tables if is_aux_key(k)]:
            del store.tables[key]
        # Hot-fold optimizer state is the one aux kind that is NOT a
        # projection of the canonical table — re-install the snapshot's
        # ``fold::`` arrays (sharded like the tables; _attach_hot keeps
        # them when the resolution still matches, drops them otherwise).
        for key in sorted(values_by_name):
            if not key.startswith(snapshot_format.FOLD_PREFIX):
                continue
            name = key[len(snapshot_format.FOLD_PREFIX):]
            if name not in store.specs:
                continue
            arr = np.array(values_by_name[key], np.float32)
            store.put(name + FOLD_KEY_SUFFIX, torch.from_numpy(arr))
        if resplit:
            # The explicit re-split assertion: every table, re-laid-out
            # onto the new mesh, dumps back to EXACTLY the snapshot's
            # logical bytes. Runs only on shape-changed restores (rare,
            # boundary events), so the extra dump is off the common path.
            for name in store.specs:
                got = store.dump_model(name)[1]
                want = np.asarray(values_by_name[name], got.dtype)
                if not np.array_equal(got, want):
                    raise AssertionError(
                        f"elastic re-split restore of table {name!r} is "
                        f"not bit-identical across mesh shapes "
                        f"{saved_shape} -> {cur_shape} at step {step} — "
                        "the flush-reconcile canonical-snapshot "
                        "invariant is broken"
                    )
        return dict(store.tables)

    def restore_tables(
        self, store: ParamStore, *, step: int | None = None
    ) -> tuple[dict, int]:
        """Load a snapshot's tables into ``store`` (sharded on its current
        mesh — any shard count). Returns ``(tables, step)``."""
        step, values, _, _ = self.read_snapshot(step)
        return self.load_tables(store, step, values), step

    def raw_local_state(self, step: int | None = None) -> list[np.ndarray]:
        """The snapshot's local-state leaves as saved (flattened order).

        Rides :meth:`read_snapshot`, so it shares the integrity contract —
        CRC verification and, for ``step=None``, fallback past a corrupt
        newest snapshot (at the price of reading the whole file)."""
        return self.read_snapshot(step)[2]

    def local_state_format(self, step: int | None = None) -> str:
        """``"raw"`` or ``"exported"`` (pre-tag snapshots read as raw).

        Rides :meth:`read_snapshot` — same integrity/fallback contract as
        :meth:`raw_local_state`."""
        return self.read_snapshot(step)[3]

    def restore(
        self,
        store: ParamStore,
        local_state_like: Pytree = None,
        *,
        step: int | None = None,
    ) -> tuple[dict, Pytree, int]:
        """Load a snapshot into ``store`` (sharded on its current mesh).

        ``local_state_like`` supplies the pytree structure and shardings to
        restore worker-local state into (pass the output of
        ``Trainer.init_state``; pass ``None`` if there is none). Local
        state is restored RAW — same worker count as the save; for
        worker-count-elastic restores of logics that support it, use
        ``Trainer.restore_checkpoint``.

        Returns ``(tables, local_state, step)``.
        """
        step, values, ls_leaves, fmt = self.read_snapshot(step)
        self.load_tables(store, step, values)
        if ls_leaves and fmt == "exported":
            raise ValueError(
                f"checkpoint step {step} stores local state in the worker "
                "logic's EXPORTED form (written by the Trainer path); "
                "restore it with Trainer.restore_checkpoint, not the raw "
                "Checkpointer.restore"
            )
        like_leaves, treedef = tree_flatten(local_state_like)
        if len(like_leaves) != len(ls_leaves):
            raise ValueError(
                f"checkpoint step {step} has {len(ls_leaves)} local-state "
                f"leaves, local_state_like has {len(like_leaves)} — "
                "was save() called without local_state?"
            )
        placed = [place_like(store.mesh, saved, like)
                  for saved, like in zip(ls_leaves, like_leaves)]
        local_state = tree_unflatten(treedef, placed)
        return dict(store.tables), local_state, step

    def _gc(self) -> None:
        """Retention by PATH protection: the newest ``keep`` publication
        heads plus every link their back-chains reference survive;
        everything else (superseded fulls, folded/orphaned deltas, the
        shadowed delta a compaction's full replaced) is removed. For a
        fulls-only directory this is exactly the legacy newest-``keep``
        rule. A head whose chain is BROKEN (base swept mid-crash) is
        unrestorable and therefore unprotected."""
        pubs = self._pubs()
        heads = sorted(pubs)[max(0, len(pubs) - self.keep):]
        protected: set[str] = set()
        for h in heads:
            try:
                members = snapshot_format.chain_members(pubs, h)
            except snapshot_format.ChainError:
                continue
            protected.update(p.path for p in members)
        try:
            names = os.listdir(self.dir)
        except FileNotFoundError:
            return
        for f in names:
            if not (SNAPSHOT_RE.fullmatch(f)
                    or snapshot_format.DELTA_RE.fullmatch(f)):
                continue
            path = os.path.join(self.dir, f)
            if path in protected:
                continue
            try:
                os.remove(path)
            except OSError:
                pass

    # -- LSM-style chain compaction ----------------------------------------

    def _maybe_auto_compact(self) -> None:
        """Fold the live chain when it carries >= ``compact_every``
        deltas (DeltaPolicy). Runs where :meth:`_write` runs — the
        background writer thread under :class:`AsyncCheckpointer`, so a
        training loop never blocks on compaction."""
        policy = self.delta_policy
        if policy is None or policy.compact_every <= 0:
            return
        pubs = self._pubs()
        if not pubs:
            return
        head = max(pubs)
        if pubs[head].kind != "delta":
            return
        try:
            members = snapshot_format.chain_members(pubs, head)
        except snapshot_format.ChainError:
            return
        if sum(1 for p in members if p.kind == "delta") >= \
                policy.compact_every:
            try:
                self.compact()
            except Exception as e:
                # A fence refusal is the zombie-writer signal and must
                # propagate (the publish path treats it as fatal); any
                # other compaction failure is a deferred optimization —
                # the chain is still fully recoverable, so the SAVE that
                # triggered us must not be poisoned.
                if _fenced(e):
                    raise
                # ENOSPC/EIO mid-fold (after the publish retry budget):
                # the fold aborts, the chain stays fully recoverable,
                # and the next publish re-triggers compaction — lost
                # optimization, never lost state (the enospc_compaction
                # chaos scenario pins this).
                _log.warning("background chain compaction failed "
                             "(chain left as-is, retried at the next "
                             "publish): %r", e)
                _obs_event("compaction_aborted", error=repr(e),
                           dir=self.dir)
                _obs_metric("inc", "storage.compaction_aborts", 1)

    def compact(self) -> str | None:
        """Fold the newest chain into a fresh FULL at its head step —
        the LSM compaction of the delta chain. Same discipline as every
        publish: serialize to a tmp file, fsync, re-read the pod fence
        as the pre-commit hook, atomic rename; then sweep the folded
        links. A SIGKILL at ANY point leaves a recoverable chain:

        * before the rename — at most a ``*.tmp.npz`` leftover, the
          chain untouched;
        * after the rename, before/mid sweep — the full and (some of)
          the folded links coexist; publication resolution prefers the
          full at the shared head step, every newer delta's ``base``
          resolves to it bit-identically (the fold IS the chain's
          resolved state), and the next GC/compaction finishes the
          sweep.

        Returns the new full's path, or None when the newest publication
        is already a full (nothing to fold). Verification failures
        surface as the usual corruption errors — compaction never folds
        an unverified link."""
        pubs = self._pubs()
        if not pubs:
            return None
        head = max(pubs)
        if pubs[head].kind != "delta":
            return None
        members = snapshot_format.chain_members(pubs, head)
        entries = self._resolve_entries(head, True)
        hook = self._compact_phase_hook

        def precommit():
            self._check_fence(head)
            if hook is not None:
                hook("precommit")

        arrays = dict(entries)
        for k in list(arrays):
            arrays[_CRC_PREFIX + k] = np.uint32(array_crc32(arrays[k]))
        path = self._path(head)
        t0 = time.perf_counter()
        self._savez_with_retry(path, arrays, precommit=precommit)
        if hook is not None:
            hook("published")
        secs = time.perf_counter() - t0
        try:
            nbytes = os.path.getsize(path)
        except OSError:
            nbytes = -1
        self.compactions += 1
        if nbytes >= 0:
            # A compaction is a real publish (an O(table) full hits the
            # disk): it must ride the same payload accounting the bench
            # ratios and the obs_report delta-vs-full comparison read.
            self.publish_bytes_total += nbytes
            _obs_metric("set", "checkpoint.bytes", nbytes)
        _obs_event("checkpoint_compacted", step=int(head), path=path,
                   folded=len(members), seconds=round(secs, 4),
                   bytes=nbytes)
        _obs_metric("inc", "checkpoint.compactions", 1)
        # Sweep the folded DELTA links (the head's delta file is now
        # shadowed by the full; the others are folded into it). The base
        # full is deliberately left to normal retention — it remains a
        # valid standalone restore point, so ``keep >= 2`` stays a real
        # redundancy contract across compactions. Read-side safety is
        # the inode contract: a reader mid-open keeps its maps.
        swept = False
        for pub in members:
            if pub.kind != "delta" or pub.path == path:
                continue
            try:
                os.remove(pub.path)
            except OSError:
                continue
            if hook is not None and not swept:
                swept = True
                hook("swept_one")
        self._gc()
        # The fold stands in for a fresh full: credit the folded deltas
        # back to the chain-length plan so the publisher keeps emitting
        # deltas instead of hitting its full_every bound against an
        # already-compacted chain (under the async writer the caller may
        # have planned newer, unfolded links meanwhile — those stay
        # counted). Advisory plan state, like the rest of the chain
        # plan: a lost race costs one early full, never correctness.
        folded = sum(1 for p in members if p.kind == "delta")
        self._chain_len = max(0, self._chain_len - folded)
        return path


class AsyncCheckpointer(Checkpointer):
    """Double-buffered background snapshot writer.

    :meth:`save` captures the snapshot point synchronously (device→host
    dump of tables + local state — the part that must see the training
    state as of ``step``) and returns; a single writer thread then does
    the expensive half — CRC tags, serialize, fsync, atomic rename — off
    the training thread. This shrinks both the per-save step-time hiccup
    (the training loop no longer blocks on serialize+fsync) and the crash
    window (the loop reaches its next step sooner).

    Contracts:

    * **double-buffered, at-most-one in-flight write** — one snapshot may
      be queued while one is being written; a third :meth:`save` blocks
      until the writer frees the slot, bounding host memory at two
      snapshots.
    * **publication is still atomic** — the writer goes through the same
      ``_atomic_savez`` tmp+fsync+rename, so a SIGKILL mid-background-
      write leaves at most a ``*.tmp.npz`` leftover, never a torn
      published snapshot, and ``latest_valid_step`` stays monotone.
    * **flush() is the durability barrier** — returns once every accepted
      save is renamed into place (the drivers call it at end of run); a
      background write failure is re-raised, once, from the next
      ``save``/``flush``/``close`` on the caller's thread.
    * **journal truth** — ``save`` emits ``checkpoint_enqueued``; the
      writer emits ``checkpoint_saved`` only after the rename, so the
      run journal's ``checkpoint_saved`` records remain TRUE durability
      points for the supervisor and ``tools/obs_report.py``.
    * the read side (:meth:`read_snapshot` and everything over it)
      flushes first, so an in-process restore always sees the newest
      accepted save. :meth:`steps` itself does NOT flush — the writer's
      own retention GC runs on the writer thread and must not deadlock.
    * **deferred capture** (:meth:`save_deferred`) — the device→host
      dump itself can move onto the writer thread behind on-device
      boundary copies: the training thread pays one enqueue
      (``checkpoint.dump_seconds``), the writer pays the capture
      (``checkpoint.capture_seconds``) overlapped with device compute.
      Delta planning rides along (queue order = save order = chain
      order), and a crash mid-capture publishes nothing — at most the
      last boundary's save is lost, exactly the inline crash window
      plus one boundary (docs/STALENESS.md).
    * **non-blocking degraded enqueue** (``when_full="degrade"``) — a
      save arriving while the slot is full (writer wedged in brownout
      retries) is skipped as a degraded publish: backlog + staleness
      SLO carry the cost, dispatch never stalls. Default stays
      ``"block"`` (lossless back-pressure).
    """

    def __init__(self, directory: str, *, keep: int = 3,
                 fence_epoch: int | None = None,
                 delta: DeltaPolicy | None = None,
                 retry: _retry.RetryPolicy | None = None,
                 degrade: bool = True,
                 when_full: str = "block"):
        super().__init__(directory, keep=keep, fence_epoch=fence_epoch,
                         delta=delta, retry=retry)
        if when_full not in ("block", "degrade"):
            raise ValueError(
                f"when_full must be 'block' or 'degrade', got {when_full!r}")
        self._cv = threading.Condition()
        # One queue slot: ("host", step, base_step_or_None, payload) for a
        # caller-captured save, or ("deferred", step, collect, touched)
        # for a writer-side capture (save_deferred).
        self._queued: tuple | None = None
        # Deferred items enqueued but not yet chain-planned by the
        # writer: an inline save() must not plan past them (chain order
        # is save order).
        self._unplanned = 0
        self._writing = False
        self._error: BaseException | None = None
        self._closed = False
        # Degraded-mode storage (hostile-filesystem survival): with
        # ``degrade`` on, a publish that still fails TRANSIENTLY after
        # the retry budget is SKIPPED — checkpoint.publish_backlog
        # rises, storage.degraded_publishes counts, the staleness SLO
        # burns — instead of crashing training on its next save().
        # Fatal errors (EACCES/EROFS, fence refusals, corruption) keep
        # the first-error retention contract and re-raise on the caller.
        self.degrade = bool(degrade)
        # ``when_full="degrade"``: a save arriving while the queue slot
        # is still full (the writer wedged in a brownout's retry
        # backoff) is SKIPPED as a degraded publish instead of blocking
        # the training thread — one enqueue attempt, nothing more. The
        # default keeps the historical lossless back-pressure.
        self.when_full = when_full
        self._degraded_chain = False
        self._writer = threading.Thread(
            target=self._writer_loop,
            name=f"fps-ckpt-writer:{os.path.basename(directory)}",
            daemon=True,  # flush()/close() are the orderly exits; a
        )  # crashed main thread must not hang the interpreter on join
        self._writer.start()

    # -- caller side ------------------------------------------------------

    def save(self, step: int, store: ParamStore, local_state: Pytree = None,
             *, local_state_format: str = "raw",
             touched_rows: Mapping | None = None,
             when_full: str | None = None) -> str:
        arrays = self._collect_timed(store, local_state, local_state_format)
        with self._cv:
            self._raise_pending_error()
            # An inline save must not plan past a deferred item the
            # writer hasn't planned yet — chain order is save order.
            while self._unplanned and not self._closed:
                self._cv.wait()
                self._raise_pending_error()
            if self._degraded_chain:
                # A degraded (skipped) publication may be the head the
                # planner would diff against: force the next
                # publication to a FULL so no delta ever chains onto a
                # publish that never landed.
                self._chain_reset()
                self._degraded_chain = False
        # Delta planning happens HERE, serially on the caller's thread —
        # chain order is save order, and planning against the retained
        # base must see publications in that order. The enqueued payload
        # for a delta is O(touched rows): the queue slot shrinks with
        # the publish.
        step, base, payload = self._plan_publication(
            int(step), arrays, touched_rows)
        # The writer consumes these arrays on another thread while the
        # training loop runs on: every entry must OWN its memory. Dump
        # paths normally produce fresh arrays (fancy indexing), but e.g.
        # a CPU tensor's .numpy() is a zero-copy view of memory that the
        # next step updates in place.
        payload = dict(payload)
        for k, v in payload.items():
            if isinstance(v, np.ndarray) and not v.flags["OWNDATA"]:
                payload[k] = np.array(v, copy=True)
        path = (self._path(step) if base is None
                else snapshot_format.delta_path(self.dir, step, base))
        if not self._enqueue(("host", int(step), base, payload),
                             int(step), path, when_full):
            # Skipped (degraded enqueue): the planned chain state
            # described a publication that will never land.
            with self._cv:
                self._chain_reset()
        return path

    def save_deferred(self, step: int, collect, *,
                      touched_rows: Mapping | None = None,
                      when_full: str | None = None) -> str:
        """Enqueue a save whose device→host capture runs on the WRITER
        thread: ``collect()`` must return the host arrays dict a
        :meth:`_collect` call would (the driver builds it over on-device
        boundary copies, so the state it describes is frozen however
        late the writer runs it). The training thread pays one enqueue —
        capture, CRC, serialize, fsync, and any brownout's retry backoff
        all happen behind it. Delta planning moves to the writer too
        (the single serial consumer: queue order = save order = chain
        order). Requires fully-addressable state — the multi-controller
        dump's ``replicate_to_mesh`` is a collective and must stay on
        the training thread (the caller gates on this).

        Returns the nominal full-snapshot path; the writer may publish
        a delta instead (the chain plan runs after capture)."""
        t0 = time.perf_counter()
        path = self._path(int(step))
        self._enqueue(("deferred", int(step), collect, touched_rows),
                      int(step), path, when_full)
        _obs_metric("observe", "checkpoint.dump_seconds",
                    time.perf_counter() - t0)
        return path

    def _enqueue(self, item, step: int, path: str,
                 when_full: str | None) -> bool:
        """Place one save in the queue slot. Returns True when enqueued;
        False when the slot stayed full and ``when_full='degrade'``
        turned the save into a SKIP (degraded-publish accounting — the
        training thread never waits on a wedged writer)."""
        mode = self.when_full if when_full is None else when_full
        deferred = item[0] == "deferred"
        with self._cv:
            self._raise_pending_error()
            if (mode == "degrade" and self._queued is not None
                    and not self._closed):
                self.degraded_publishes += 1
                self._publish_backlog += 1
                self._degraded_chain = True
                backlog = self._publish_backlog
            else:
                backlog = None
                while self._queued is not None and not self._closed:
                    self._cv.wait()
                    self._raise_pending_error()
                if self._closed:
                    raise RuntimeError(
                        f"AsyncCheckpointer for {self.dir} is closed")
                self._queued = item
                if deferred:
                    self._unplanned += 1
                # Emitted while still HOLDING the cv (the writer can't
                # pop the slot until we release), so the journal's
                # enqueued → saved ordering holds even for an
                # instantaneous write. No lock cycle: the writer takes
                # the recorder lock only from _write, never while
                # waiting on this cv.
                _obs_event("checkpoint_enqueued", step=step, path=path,
                           **({"capture": "writer"} if deferred else {}))
                _obs_metric("inc", "checkpoint.enqueues", 1)
                self._cv.notify_all()
        if backlog is not None:
            _log.warning(
                "checkpoint publish step %d DEGRADED (writer busy; "
                "backlog %d)", step, backlog)
            _obs_event("checkpoint_degraded", step=step, backlog=backlog,
                       error="writer busy (queue slot full)")
            _obs_metric("inc", "storage.degraded_publishes", 1)
            _obs_metric("set", "checkpoint.publish_backlog", backlog)
            return False
        return True

    def flush(self) -> None:
        with self._cv:
            while self._queued is not None or self._writing:
                self._cv.wait()
            self._raise_pending_error()

    def close(self) -> None:
        try:
            self.flush()
        finally:
            with self._cv:
                self._closed = True
                self._cv.notify_all()
            self._writer.join(timeout=60.0)

    def _raise_pending_error(self) -> None:
        # Called under self._cv.
        if self._error is not None:
            err, self._error = self._error, None
            # The failed write may have been a planned chain link: later
            # deltas must not chain onto a publication that never landed.
            self._chain_reset()
            raise RuntimeError(
                f"background checkpoint write failed under {self.dir}"
            ) from err

    # -- read side (must observe accepted saves) --------------------------

    def read_snapshot(self, step: int | None = None, *, verify: bool = True):
        self.flush()
        return super().read_snapshot(step, verify=verify)

    def verify_snapshot(self, step: int | None = None) -> bool:
        self.flush()
        return super().verify_snapshot(step)

    def latest_valid_step(self) -> int | None:
        self.flush()
        return super().latest_valid_step()

    # -- writer thread ----------------------------------------------------

    def _degradable(self, e: BaseException) -> bool:
        """True when a failed publish may be SKIPPED (degraded) rather
        than surfaced as a caller error: transient storage errors after
        the retry budget, and the orphan-delta refusal that follows a
        degraded base. A fence refusal anywhere in the cause chain is
        never degradable — a zombie of an aborted pod attempt must die
        loudly, not quietly skip publishes forever."""
        if _fenced(e):
            return False
        if isinstance(e, OrphanDeltaError):
            return True
        if isinstance(e, OSError) and e.errno == _errno_mod.ENOENT:
            # ENOENT is retry-worthy (a just-renamed file can be
            # transiently invisible on a caching mount) but NOT
            # degrade-worthy: persisting past the whole retry budget
            # means the checkpoint DIRECTORY is gone — silently
            # skipping every publish would end the run "successfully"
            # with zero durable state. Fail loudly instead.
            return False
        return _retry.classify_error(e) == "retryable"

    def _writer_loop(self) -> None:
        while True:
            with self._cv:
                while self._queued is None and not self._closed:
                    self._cv.wait()
                if self._queued is None:  # closed and drained
                    return
                item = self._queued
                self._queued = None
                self._writing = True
                self._cv.notify_all()  # free the queue slot for save()
            arrays = None
            try:
                if item[0] == "deferred":
                    _, step, collect, touched_rows = item
                    try:
                        t0 = time.perf_counter()
                        arrays = _run_capture(collect)
                        _obs_metric("observe", "checkpoint.capture_seconds",
                                    time.perf_counter() - t0)
                        with self._cv:
                            if self._degraded_chain:
                                self._chain_reset()
                                self._degraded_chain = False
                        step, base, arrays = self._plan_publication(
                            step, arrays, touched_rows)
                    finally:
                        # Planned (or failed trying): an inline save()
                        # waiting to plan may proceed. On failure the
                        # chain resets below/with the surfaced error.
                        with self._cv:
                            self._unplanned -= 1
                            self._cv.notify_all()
                else:
                    _, step, base, arrays = item
                self._write(step, arrays, base=base)
                if self._publish_backlog:
                    # Recovery: a landed publish is a FULL description
                    # of its step (or a delta whose chain landed), so
                    # the whole backlog of skipped recency drains here.
                    with self._cv:
                        self._publish_backlog = 0
                    _obs_metric("set", "checkpoint.publish_backlog", 0)
                    _obs_event("checkpoint_backlog_drained",
                               step=int(step))
            except BaseException as e:  # noqa: BLE001 - re-raised on caller
                if self.degrade and self._degradable(e):
                    # Degraded-mode storage: SKIP the publish instead of
                    # poisoning the caller — training keeps running on
                    # last-good durable state, the backlog gauge and the
                    # storage-staleness SLO carry the cost (lost
                    # recency, never corruption or a crash).
                    with self._cv:
                        self.degraded_publishes += 1
                        self._publish_backlog += 1
                        self._degraded_chain = True
                        backlog = self._publish_backlog
                    _log.warning(
                        "checkpoint publish step %d DEGRADED (skipped "
                        "after retries; backlog %d): %r", step, backlog,
                        e)
                    _obs_event("checkpoint_degraded", step=int(step),
                               backlog=backlog, error=repr(e))
                    _obs_metric("inc", "storage.degraded_publishes", 1)
                    _obs_metric("set", "checkpoint.publish_backlog",
                                backlog)
                else:
                    with self._cv:
                        if self._error is None:
                            self._error = e
                        else:
                            # Keep the FIRST failure (the root cause): a
                            # derived refusal — e.g. the orphan-delta
                            # guard firing because the base's write just
                            # failed — must not mask the original error.
                            _log.warning(
                                "suppressing follow-on checkpoint write "
                                "error (first failure pending): %r", e)
            finally:
                # Drop the buffers (and a deferred item's on-device
                # boundary copies) before blocking on the cv.
                del arrays, item
                with self._cv:
                    self._writing = False
                    self._cv.notify_all()


def fence_epoch_from_env() -> int | None:
    """The pod fencing epoch of this process (``FPS_TPU_POD_EPOCH``, read
    as the reference's ``pod_env`` reads it), or None when not running
    under a pod: pass as ``Checkpointer(..., fence_epoch=...)`` so a pod
    child's publishes honour the fence."""
    v = os.environ.get(POD_EPOCH_ENV)
    try:
        return int(v) if v not in (None, "") else None
    except ValueError:
        return None


def _host_array(x) -> np.ndarray:
    """A leaf of the saved state as a host array that owns its memory:
    :class:`~fps_tpu_torch.parallel.mesh.Blocks` through ``numpy()`` (the
    global array; a collective over several processes), a tensor through
    the host, an array as it is."""
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(x, Blocks):
        return np.array(x.numpy(), copy=True)
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy().copy()
    return np.asarray(x)


def place_like(mesh, saved: np.ndarray, like):
    """A saved local-state leaf placed as ``like`` is: a worker-sharded
    :class:`~fps_tpu_torch.parallel.mesh.Blocks` (cut into the workers'
    equal pieces on axis 0, this process's kept), a tensor on ``like``'s
    device, or the array as it is. A copy: nothing shares memory with
    ``saved``."""
    from fps_tpu_torch.parallel import collectives
    from fps_tpu_torch.parallel.mesh import Blocks

    if isinstance(like, Blocks):
        t = torch.from_numpy(np.array(saved, copy=True)).to(like[0].dtype)
        return Blocks(collectives.scatter_workers(mesh, t), mesh=mesh)
    if isinstance(like, torch.Tensor):
        return torch.from_numpy(np.array(saved, copy=True)).to(
            device=like.device, dtype=like.dtype)
    return saved


def _run_capture(collect):
    """Writer-thread capture seam: runs a deferred save's ``collect()``
    (the device→host dump over on-device boundary copies). Module-level
    — like ``_atomic_savez`` — so the chaos harness can monkeypatch a
    SIGKILL into the middle of a background capture and prove the
    resume contract holds for the deferred delta chain too."""
    return collect()


# ---------------------------------------------------------------------------
# Atomic file helpers (a torn write must not corrupt the latest snapshot).
# ---------------------------------------------------------------------------

def _atomic_savez(path: str, arrays: Mapping[str, np.ndarray],
                  precommit=None) -> None:
    """Serialize + fsync + atomic rename: after this returns, ``path``
    either holds the complete snapshot or (on a crash anywhere inside)
    its previous content — never a torn file. The fsync BEFORE the rename
    is what makes the rename a real durability point (a power loss after
    an unfsync'd rename can publish an empty file); the directory fsync
    after makes the rename itself survive. ``precommit`` (optional) runs
    after the fsync and immediately before the publishing rename; if it
    raises, nothing is published (the pod fence hook).

    Fault seams (``fps_tpu_torch.core.retry.fault_check``): the deterministic
    injector may fail/slow the serialize, the fsync, or the rename —
    and a ``"torn"`` rename directive publishes a truncated prefix at
    the destination before failing, the hostile-rename case the CRC
    gates downstream must catch. A failed attempt always removes its
    tmp file, so retries start clean."""
    _retry.fault_check("write", path)
    d = os.path.dirname(os.path.abspath(path)) or "."
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp.npz")
    try:
        with os.fdopen(fd, "wb") as f:
            np.savez(f, **arrays)
            f.flush()
            _retry.fault_check("fsync", path)
            os.fsync(f.fileno())
        if precommit is not None:
            precommit()
        if _retry.fault_check("replace", path) == "torn":
            with open(tmp, "rb") as src, open(path, "wb") as dst:
                dst.write(src.read(max(1, os.path.getsize(tmp) // 3)))
            raise OSError(_errno_mod.EIO,
                          "injected torn rename (truncated publish)",
                          path)
        os.replace(tmp, path)
        try:
            dfd = os.open(d, os.O_RDONLY)
            try:
                os.fsync(dfd)
            finally:
                os.close(dfd)
        except OSError:
            pass  # best-effort: not every filesystem supports dir fsync
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


