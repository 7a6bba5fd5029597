"""One published snapshot, opened for reading: verify, map, look up.

:class:`ServableSnapshot` is the read-path's unit of publication — one
``ckpt_*.npz`` file that has passed the full CRC integrity pass
(:func:`fps_tpu_torch.core.snapshot_format.verify_snapshot_file`) and whose
array entries are mapped read-only into this process
(:func:`~fps_tpu_torch.core.snapshot_format.map_snapshot_arrays`): ``np.memmap``
views straight onto the member bytes, no decompression, no copy, no
resident memory until rows are touched. Opening a multi-GB snapshot costs
header parsing plus one CRC pass; *swapping* a server to an already-open
snapshot is a pointer flip whose cost is independent of table size.

Lifetime: the maps address the published file's INODE. The checkpoint
writer only ever publishes via atomic rename (a fresh inode per save), so
a mapped snapshot can never change underneath a reader; retention GC or a
``*.corrupt`` quarantine merely unlinks the NAME — in-flight reads on the
old map stay valid until the last reference drops. That property is what
makes the serving hot-swap safe without any reader/writer locking.

The port's copy of ``fps_tpu/serve/snapshot.py``. Stdlib + numpy only
(no torch): a serving process needs no accelerator runtime. Import
through the real package or a stub root (``fps_tpu_torch/examples/
serve.py``) — nothing here touches the training plane.
"""

from __future__ import annotations

import os
import time

import numpy as np

from fps_tpu_torch.core import snapshot_format as fmt

__all__ = ["ServableSnapshot", "SnapshotRejected", "DeltaView",
           "materialize"]


class SnapshotRejected(RuntimeError):
    """A snapshot failed integrity verification and was not opened.

    Raised by :meth:`ServableSnapshot.open` — the serving analog of the
    training plane's ``SnapshotCorruptionError``, separate so the serving
    tier never needs the torch-laden resilience module."""


class DeltaView:
    """A read-only row-overlay view: ``base`` (typically a zero-copy
    snapshot map) patched at ``ids`` (sorted, unique) with ``rows``.

    The delta-aware incremental hot-swap's data structure: applying a
    delta to a served table costs O(touched rows) of memory and leaves
    the multi-GB base mapped exactly as it was — no re-open, no copy.
    Lookups fancy-index like an ndarray (``view[ids]``), and
    ``np.asarray(view)`` materializes the patched table for whole-table
    consumers (MF top-k). The warm-row cache reuses the same structure
    with ``rows`` equal to the base's values: hot lookups then come from
    a resident contiguous buffer instead of faulting mapped pages.

    Immutable after construction; thread-safe like the plain maps.
    """

    __slots__ = ("base", "ids", "rows", "_dense")

    def __init__(self, base, ids, rows):
        ids = np.asarray(ids, np.int64)
        rows = np.asarray(rows)
        if ids.ndim != 1 or len(ids) != len(rows):
            raise ValueError("ids must be 1-D and match rows")
        if len(ids) and (np.any(np.diff(ids) <= 0) or ids[0] < 0
                         or ids[-1] >= base.shape[0]):
            raise ValueError("ids must be sorted, unique, in range")
        self.base = base
        self.ids = ids
        self.rows = rows
        self._dense = None  # lazy whole-table materialization (cached)

    @property
    def shape(self):
        return self.base.shape

    @property
    def dtype(self):
        return self.base.dtype

    @property
    def ndim(self):
        return self.base.ndim

    def __len__(self):
        return len(self.base)

    def __getitem__(self, idx):
        idx = np.asarray(idx)
        scalar = idx.ndim == 0
        if scalar:
            idx = idx.reshape(1)
        out = np.asarray(self.base[idx])
        if len(self.ids):
            pos = np.searchsorted(self.ids, idx)
            pos_c = np.minimum(pos, len(self.ids) - 1)
            hit = self.ids[pos_c] == idx
            if np.any(hit):
                out = np.array(out, copy=True)
                out[hit] = self.rows[pos_c[hit]]
        return out[0] if scalar else out

    def __array__(self, dtype=None, copy=None):
        # Cached: whole-table consumers (MF top-k scores every request
        # against np.asarray(table)) must not pay an O(table) copy per
        # request once a delta/warm overlay is installed. One overlay is
        # immutable, so the materialization is too; a racing double
        # compute is benign (last write wins, identical bytes).
        if self._dense is None:
            mat = np.array(self.base, copy=True)
            if len(self.ids):
                mat[self.ids] = self.rows
            mat.setflags(write=False)
            self._dense = mat
        mat = self._dense
        return mat.astype(dtype) if dtype is not None else mat

    @property
    def overlay_rows(self) -> int:
        return int(len(self.ids))


def materialize(table):
    """The ONE sanctioned whole-table densification seam (the
    reference's lint allowlists exactly this and
    :meth:`DeltaView.__array__`).

    Plain ndarray/memmap tables return AS-IS — zero copy, zero
    allocation; whole-table consumers (MF top-k's matmul) read the
    mapped pages directly. :class:`DeltaView` overlays return their
    CACHED dense form (one O(table) copy per overlay lifetime, amortized
    across every request that binds the snapshot). Hot-path serve code
    must route whole-table access through here instead of
    ``np.asarray``/``np.array``/``.copy()`` — the static guard that
    keeps zero-copy zero-copy."""
    if isinstance(table, DeltaView):
        return table.__array__()
    return table


def _merge_overlay(base_ids, base_rows, ids, rows):
    """Fold one more delta's (ids, rows) onto an existing overlay —
    later wins on collisions. All inputs sorted-unique; output too."""
    if not len(base_ids):
        return ids, rows
    if not len(ids):
        return base_ids, base_rows
    keep = ~np.isin(base_ids, ids)
    merged_ids = np.concatenate([base_ids[keep], ids])
    merged_rows = np.concatenate([base_rows[keep], rows])
    order = np.argsort(merged_ids, kind="stable")
    return merged_ids[order], merged_rows[order]


def _overlay(value, ids, rows):
    """Patch ``value`` (ndarray map or DeltaView) at ``ids`` → DeltaView
    over the ORIGINAL base (chained overlays fold flat, never stack)."""
    ids = np.asarray(ids, np.int64)
    if isinstance(value, DeltaView):
        mids, mrows = _merge_overlay(value.ids, value.rows, ids, rows)
        return DeltaView(value.base, mids, mrows)
    return DeltaView(value, ids, rows)


class ServableSnapshot:
    """A CRC-verified, read-only-mapped snapshot.

    Construct via :meth:`open` (which verifies first — a torn or
    bit-rotted file raises :class:`SnapshotRejected` before anything is
    mapped). Tables are exposed in LOGICAL id order, padding stripped —
    exactly as the checkpoint writer serializes them — so a served row
    lookup is a plain axis-0 index, with no owner-major physical mapping
    and no dependence on the training mesh shape.

    Thread-safety: instances are immutable after ``open`` (plain reads of
    read-only maps); any number of request threads may share one.
    """

    def __init__(self, step: int, path: str, tables: dict,
                 local_state: list, local_state_format: str, *,
                 verify_seconds: float = 0.0, src_id=None,
                 chain_len: int = 1, warm_rows: int = 0,
                 pod_epoch: int | None = None):
        self.step = int(step)
        self.path = path
        self.tables = tables  # {name: (num_ids, dim) read-only array}
        self.local_state = local_state  # exported ls:: leaves, in order
        self.local_state_format = local_state_format
        self.verify_seconds = verify_seconds
        # (st_ino, st_mtime_ns) of the mapped file — the identity the
        # watcher compares so an atomic re-publish of the SAME step
        # (quarantine → rollback replay) is seen as a new snapshot.
        self.src_id = src_id
        # Delta-chain provenance: how many publications (full + deltas)
        # describe this state, and how many warm-cache rows were
        # admitted (DeltaView overlays with base-equal values).
        self.chain_len = chain_len
        self.warm_rows = warm_rows
        # The writer's fencing epoch (meta::pod_epoch, pod runs only) —
        # the incremental swap refuses a delta carrying an OLDER epoch
        # than the snapshot it extends (a stale zombie's publish).
        self.pod_epoch = pod_epoch

    @classmethod
    def open(cls, path: str, *, step: int | None = None,
             verify: bool = True) -> "ServableSnapshot":
        """Verify ``path`` then map it. ``step`` defaults to the value
        parsed from the filename; ``verify=False`` skips the CRC pass
        (only for callers that just verified the same inode)."""
        if step is None:
            m = fmt.SNAPSHOT_RE.fullmatch(os.path.basename(path))
            if not m:
                raise ValueError(
                    f"{path!r} does not match the snapshot naming contract "
                    f"({fmt.SNAPSHOT_RE.pattern})")
            step = int(m.group(1))
        t0 = time.perf_counter()
        if verify:
            ok, reason = fmt.verify_snapshot_file(path)
            if not ok:
                if reason == fmt.NO_SUCH_FILE:
                    # The candidate vanished between the caller's scan
                    # and this open (retention sweep / quarantine rename
                    # racing the poll loop): "gone, retry next poll" —
                    # never a corruption verdict.
                    raise FileNotFoundError(path)
                raise SnapshotRejected(
                    f"snapshot step {step} at {path}: {reason}")
        verify_s = time.perf_counter() - t0
        try:
            st = os.stat(path)
            arrays = fmt.map_snapshot_arrays(path)
            ls_format, pod_epoch = _meta_tags(path)
        except FileNotFoundError:
            raise
        except fmt.IO_ERRORS as e:
            # verify→map is not atomic against a concurrent quarantine
            # rename; surface the race as a rejection, not a crash.
            raise SnapshotRejected(
                f"snapshot step {step} at {path}: vanished or unreadable "
                f"between verify and map ({e!r})") from e
        tables = {k[len(fmt.TABLE_PREFIX):]: v for k, v in arrays.items()
                  if k.startswith(fmt.TABLE_PREFIX)}
        ls: list = []
        while fmt.LS_PREFIX + str(len(ls)) in arrays:
            ls.append(arrays[fmt.LS_PREFIX + str(len(ls))])
        return cls(step, path, tables, ls, ls_format,
                   verify_seconds=verify_s,
                   src_id=(st.st_ino, st.st_mtime_ns),
                   pod_epoch=pod_epoch)

    # -- delta chains ------------------------------------------------------

    @classmethod
    def open_chain(cls, directory: str, step: int, *,
                   verify: bool = True) -> "ServableSnapshot":
        """Open publication ``step`` resolving its delta chain: the base
        FULL is zero-copy mapped exactly like :meth:`open`, every delta
        link (O(touched rows) by construction) is loaded into memory and
        folded into :class:`DeltaView` overlays. The whole chain is
        CRC/link/epoch-verified first — a chain through a torn, missing,
        or ``*.corrupt``-quarantined base refuses with
        :class:`SnapshotRejected` (or :class:`FileNotFoundError` when
        the head itself vanished mid-poll)."""
        pubs = fmt.publications(directory)
        pub = pubs.get(step)
        if pub is None:
            raise FileNotFoundError(fmt.snapshot_path(directory, step))
        if verify:
            ok, reason, failing = fmt.verify_chain(directory, step,
                                                   pubs=pubs)
            if not ok:
                if (failing == step and reason is not None
                        and reason.endswith(fmt.NO_SUCH_FILE)):
                    # The HEAD itself vanished between the caller's scan
                    # and the verify pass (retention sweep racing the
                    # poll): gone, not corrupt.
                    raise FileNotFoundError(pub.path)
                raise SnapshotRejected(
                    f"chain for step {step} under {directory}: {reason}")
        try:
            members = fmt.chain_members(pubs, step)
        except fmt.ChainError as e:
            # verify=False callers reach here with a broken chain (a
            # swept/missing base): a rejection, never an escaped
            # ChainError — poll loops are documented not to raise.
            raise SnapshotRejected(
                f"chain for step {step} under {directory}: {e}") from e
        t0 = time.perf_counter()
        snap = cls.open(members[0].path, step=members[0].step,
                        verify=False)  # chain verify above covered it
        for link in members[1:]:
            snap = snap.with_delta(link.path, verify=False)
        snap.verify_seconds = time.perf_counter() - t0
        return snap

    def with_delta(self, delta_file: str, *,
                   verify: bool = True) -> "ServableSnapshot":
        """The INCREMENTAL hot-swap: a new snapshot describing
        ``delta_file``'s step by patching this snapshot's (still-mapped)
        tables with the delta's touched rows — the world is not
        re-opened, re-verified, or copied; cost is O(touched rows).

        The delta must chain from exactly this snapshot's step
        (``meta::base_step``); anything else refuses loudly."""
        t0 = time.perf_counter()
        if verify:
            ok, reason = fmt.verify_snapshot_file(delta_file)
            if not ok:
                if reason == fmt.NO_SUCH_FILE:
                    raise FileNotFoundError(delta_file)
                raise SnapshotRejected(f"delta {delta_file}: {reason}")
        try:
            delta = fmt.read_delta_arrays(delta_file)
        except FileNotFoundError:
            raise
        except fmt.IO_ERRORS as e:
            raise SnapshotRejected(
                f"delta {delta_file}: vanished or unreadable between "
                f"verify and read ({e!r})") from e
        base_step = delta.get(fmt.BASE_STEP_KEY)
        if base_step is None or int(base_step) != self.step:
            raise SnapshotRejected(
                f"delta {delta_file} chains from step "
                f"{None if base_step is None else int(base_step)}, not "
                f"the served step {self.step}")
        epoch = delta.get(fmt.POD_EPOCH_KEY)
        epoch = None if epoch is None else int(epoch)
        if (epoch is not None and self.pod_epoch is not None
                and epoch < self.pod_epoch):
            # The read-side half of the pod fence: an epoch-stale delta
            # is a zombie writer's publish — never extend through it.
            raise SnapshotRejected(
                f"delta {delta_file}: fencing epoch {epoch} is behind "
                f"the served snapshot's epoch {self.pod_epoch}")
        m = fmt.DELTA_RE.fullmatch(os.path.basename(delta_file))
        if not m:
            raise SnapshotRejected(
                f"{delta_file!r} does not match the delta naming "
                f"contract ({fmt.DELTA_RE.pattern})")
        step = int(m.group(1))
        tables = dict(self.tables)
        ls = list(self.local_state)
        ls_format = self.local_state_format
        for k, v in delta.items():
            if (k.startswith(fmt.DELTA_IDS_PREFIX)
                    or k == fmt.BASE_STEP_KEY):
                continue
            if k.startswith(fmt.DELTA_ROWS_PREFIX):
                key = k[len(fmt.DELTA_ROWS_PREFIX):]
                ids = delta[fmt.DELTA_IDS_PREFIX + key]
                if key.startswith(fmt.TABLE_PREFIX):
                    name = key[len(fmt.TABLE_PREFIX):]
                    if name not in tables:
                        raise SnapshotRejected(
                            f"delta {delta_file} patches unknown table "
                            f"{name!r}")
                    tables[name] = _overlay(tables[name], ids, v)
                elif key.startswith(fmt.LS_PREFIX):
                    i = int(key[len(fmt.LS_PREFIX):])
                    if i >= len(ls):
                        raise SnapshotRejected(
                            f"delta {delta_file} patches unknown "
                            f"local-state leaf {i}")
                    ls[i] = _overlay(ls[i], ids, v)
                # fold:: state is training-plane-only — not served.
            elif k.startswith(fmt.TABLE_PREFIX):
                tables[k[len(fmt.TABLE_PREFIX):]] = v  # full replacement
            elif k.startswith(fmt.LS_PREFIX):
                i = int(k[len(fmt.LS_PREFIX):])
                while len(ls) <= i:
                    ls.append(None)
                ls[i] = v
            elif k == "meta" + fmt.SEP + "ls_format":
                ls_format = str(v)
        snap = ServableSnapshot(
            step, delta_file, tables, ls, ls_format,
            verify_seconds=time.perf_counter() - t0,
            src_id=_stat_id(delta_file), chain_len=self.chain_len + 1,
            warm_rows=self.warm_rows,
            pod_epoch=self.pod_epoch if epoch is None else epoch)
        return snap

    def warmed(self, ids_by_table: dict) -> "ServableSnapshot":
        """Warm-row cache admission: materialize the given rows (the
        hot-tier frequency ranking's head) into resident overlay buffers
        so hot lookups stop faulting mapped pages. Values are the
        snapshot's own — semantics are bit-identical, only residency
        changes. Unknown tables / out-of-range ids are clipped silently
        (the ranking may predate a re-shape)."""
        tables = dict(self.tables)
        warm = self.warm_rows
        for name, ids in ids_by_table.items():
            cur = tables.get(name)
            if cur is None:
                continue
            ids = np.unique(np.asarray(ids, np.int64).reshape(-1))
            ids = ids[(ids >= 0) & (ids < cur.shape[0])]
            if not len(ids):
                continue
            rows = np.ascontiguousarray(cur[ids])
            tables[name] = _overlay(cur, ids, rows)
            warm += int(len(ids))
        snap = ServableSnapshot(
            self.step, self.path, tables, list(self.local_state),
            self.local_state_format, verify_seconds=self.verify_seconds,
            src_id=self.src_id, chain_len=self.chain_len, warm_rows=warm,
            pod_epoch=self.pod_epoch)
        return snap

    # -- lookups -----------------------------------------------------------

    def table(self, name: str) -> np.ndarray:
        try:
            return self.tables[name]
        except KeyError:
            raise KeyError(
                f"snapshot step {self.step} has no table {name!r} "
                f"(tables: {sorted(self.tables)})") from None

    def check_ids(self, name: str, ids) -> np.ndarray:
        """Validate ``ids`` against table ``name`` — same parse and
        errors as :meth:`lookup`, WITHOUT the gather. The batched
        request path pre-validates every sub-request through here so a
        bad one fails alone instead of poisoning its merged gather.
        Returns the ids as int64."""
        t = self.table(name)
        ids = np.asarray(ids, np.int64)
        if ids.size and ids.max(initial=-1) >= t.shape[0]:
            raise IndexError(
                f"table {name!r}: id {int(ids.max())} out of range "
                f"({t.shape[0]} rows)")
        if ids.size and ids.min(initial=0) < -1:
            # Only -1 is the padding sentinel; any other negative is a
            # client bug that must not silently read as a zero row.
            raise IndexError(
                f"table {name!r}: id {int(ids.min())} below the -1 "
                f"padding sentinel")
        return ids

    def lookup(self, name: str, ids) -> np.ndarray:
        """Batched pull-by-id: rows ``ids`` of table ``name`` (logical id
        order). Padding ids (``-1``) read as zero rows, matching the
        training plane's dropped-row contract; out-of-range ids — above
        the table or below the ``-1`` sentinel — raise."""
        t = self.table(name)
        ids = self.check_ids(name, ids)
        live = ids >= 0
        out = t[np.where(live, ids, 0)]
        if not live.all():
            out = np.where(live[..., None] if out.ndim > ids.ndim
                           else live, out, 0).astype(t.dtype, copy=False)
        return out

    def manifest(self) -> dict:
        """Shape/dtype summary (no data touched) — the publish manifest
        the CLI and the obs digest surface."""
        return {
            "step": self.step,
            "path": self.path,
            "tables": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                       for k, v in sorted(self.tables.items())},
            "local_state": [{"shape": list(v.shape), "dtype": str(v.dtype)}
                            for v in self.local_state],
            "local_state_format": self.local_state_format,
        }


def _stat_id(path: str):
    """(st_ino, st_mtime_ns) or None — the watcher's identity tuple."""
    try:
        st = os.stat(path)
    except OSError:
        return None
    return (st.st_ino, st.st_mtime_ns)


def _meta_tags(path: str) -> tuple[str, int | None]:
    """``(ls_format, pod_epoch)`` meta tags of a snapshot (``"raw"`` /
    ``None`` when absent) — one numpy lazy-member read (only these
    entries' bytes)."""
    key = "meta" + fmt.SEP + "ls_format"
    with np.load(path) as z:
        ls_format = str(z[key]) if key in z.files else "raw"
        epoch = (int(z[fmt.POD_EPOCH_KEY])
                 if fmt.POD_EPOCH_KEY in z.files else None)
    return ls_format, epoch
