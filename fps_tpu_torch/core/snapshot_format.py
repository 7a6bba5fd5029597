"""The on-disk snapshot contract — naming, integrity, zero-copy reads.

The port's copy of ``fps_tpu/core/snapshot_format.py`` (stdlib + numpy),
byte for byte the same contract: the same file names, the same key names,
the same CRC-32 over the same C-order bytes and the same chain rules, so a
snapshot written by either package restores in the other. It owns
everything the consumers must agree on about a published ``ckpt_*.npz``
snapshot:

* the **training plane** (:mod:`fps_tpu_torch.core.checkpoint`) writes
  snapshots and restores them (it re-exports the names below);
* the **chaos injectors** (:mod:`fps_tpu_torch.testing.chaos`) corrupt
  them by the same filename contract;
* the **serving plane** (:mod:`fps_tpu_torch.serve`), a process that must
  discover, CRC-verify and map snapshots without the training stack.

Integrity is the checkpoint layer's scheme verbatim: every array entry
``k`` carries a ``meta::crc::k`` CRC-32 tag written at save time;
:func:`verify_snapshot_file` checks every entry the way
``Checkpointer._read_verified`` does (structural read errors and
checksum mismatches both fail), but reports ``(ok, reason)`` instead of
raising the checkpoint layer's ``SnapshotCorruptionError``.

Zero-copy reads: ``np.savez`` writes an UNCOMPRESSED zip of ``.npy``
members, so each array's bytes sit contiguously at a knowable file
offset. :func:`map_snapshot_arrays` parses the zip's local headers plus
each member's npy header and returns read-only ``np.memmap`` views — a
multi-GB table "loads" in microseconds and costs no resident memory
until rows are touched. This is what makes a serving hot-swap a pointer
flip whose latency is independent of table size.
"""

from __future__ import annotations

import os
import re
import struct
import zipfile
import zlib

import numpy as np

from fps_tpu_torch.core import retry as _retry

__all__ = [
    "SNAPSHOT_RE", "SNAPSHOT_FMT", "SEP", "TABLE_PREFIX", "LS_PREFIX",
    "FOLD_PREFIX", "MESH_SHAPE_KEY", "POD_EPOCH_KEY",
    "CRC_PREFIX", "IO_ERRORS", "array_crc32", "snapshot_path",
    "snapshot_steps", "verify_snapshot_file", "latest_valid_snapshot",
    "map_snapshot_arrays",
    # Delta-snapshot chains: chain discovery,
    # verification, and resolution shared by the checkpoint layer, the
    # serving plane, and the chaos harness.
    "DELTA_RE", "DELTA_FMT", "BASE_STEP_KEY", "DELTA_IDS_PREFIX",
    "DELTA_ROWS_PREFIX", "NO_SUCH_FILE", "ChainError", "Publication",
    "delta_path", "publications", "chain_members", "read_pub_meta",
    "verify_chain", "latest_valid_chain", "read_delta_arrays",
    "apply_delta_entries", "resolve_chain_entries",
]

# Snapshot filename contract — the single source of truth (the
# checkpoint layer and the chaos injectors import these from here or via
# fps_tpu_torch.core.checkpoint's re-export).
SNAPSHOT_RE = re.compile(r"ckpt_(\d{12})\.npz")
SNAPSHOT_FMT = "ckpt_{step:012d}.npz"
# Delta publication filename contract: ``delta_{step}_{base}.npz`` — the
# base step rides the NAME so chain walking is a pure directory listing
# (no file opens); the authoritative link is the CRC-tagged
# ``meta::base_step`` entry inside, cross-checked by every reader.
DELTA_RE = re.compile(r"delta_(\d{12})_(\d{12})\.npz")
DELTA_FMT = "delta_{step:012d}_{base:012d}.npz"

# npz key layout: kind::name. ``table::<name>`` entries hold each table
# in LOGICAL id order with padding rows stripped (``(num_ids, dim)``) —
# a served row lookup is therefore a plain axis-0 index, no owner-major
# physical mapping needed. ``ls::<i>`` entries are the flattened
# worker-local-state leaves (the Trainer path writes them in the logic's
# worker-count-independent EXPORT form, e.g. MF user factors in logical
# user order — exactly what a serving user-side lookup wants).
SEP = "::"
TABLE_PREFIX = f"table{SEP}"
LS_PREFIX = f"ls{SEP}"
# ``fold::<name>`` entries hold a table's hot-fold optimizer state
# (Adagrad/Adam server state, ``ServerLogic.hot_fold``) in reduce-scatter
# slice order — NEVER part of the canonical ``table::`` bytes, so a
# snapshot stays restorable by untiered/older readers (which simply skip
# the kind, as the default ``map_snapshot_arrays`` filter does).
FOLD_PREFIX = f"fold{SEP}"
CRC_PREFIX = f"meta{SEP}crc{SEP}"
# ``meta::mesh_shape`` records the (data, shard) mesh shape the snapshot
# was taken on (a JSON object) — restore detects a mesh-shape change and
# takes (and asserts) the explicit elastic re-split path. Pre-existing
# snapshots simply lack the tag.
MESH_SHAPE_KEY = f"meta{SEP}mesh_shape"
# ``meta::pod_epoch`` stamps the pod fencing epoch of the writer (pod
# runs only): forensic evidence that no epoch-stale publish ever landed
# behind a fence.
POD_EPOCH_KEY = f"meta{SEP}pod_epoch"
# Delta entry layout: a delta publication carries, for each row-sparse
# full-form key ``K`` (``table::name`` / ``ls::i`` / ``fold::name``), the
# pair ``dids::K`` (sorted int64 row ids) and ``drows::K`` (the touched
# rows' values). A key appearing under its PLAIN name inside a delta is a
# full replacement (shape/dtype changed, or a non-row-sparse leaf); a key
# absent entirely is carried unchanged from the base. ``meta::base_step``
# names the publication this delta chains from.
BASE_STEP_KEY = f"meta{SEP}base_step"
DELTA_IDS_PREFIX = f"dids{SEP}"
DELTA_ROWS_PREFIX = f"drows{SEP}"
# verify_snapshot_file's reason string for a vanished candidate — the
# poll-loop race (swept/renamed between stat and open) must be treated
# as "gone, retry next poll", never as corruption.
NO_SUCH_FILE = "no such file"


class ChainError(Exception):
    """A delta chain cannot be resolved (missing/broken/stale link).

    ``step`` names the FAILING link — everything chained past it is
    unrecoverable; everything before it is the surviving prefix."""

    def __init__(self, msg: str, *, step: int | None = None):
        super().__init__(msg)
        self.step = step

# Everything a torn/corrupted .npz throws on open or member read (zip
# magic, central directory, member CRC, npy header parsing, ...).
# Deliberately NOT OSError: transient environment failures (EMFILE,
# EACCES, a flaky NFS mount) must surface as what they are, not be
# classified as corruption.
IO_ERRORS = (
    EOFError,
    KeyError,
    IndexError,
    ValueError,
    struct.error,
    zipfile.BadZipFile,
    zipfile.LargeZipFile,
    zlib.error,
)


# Hostile-filesystem read seam: the deterministic injector may fail a
# read (transient ENOENT / EIO raise here) or redirect it to the
# PRE-rename content of the path — the stale read-after-rename of a
# caching network filesystem. Identity (and zero-cost) with no injector
# installed. One shared helper (fps_tpu_torch.core.retry.read_path) so the
# checkpoint / snapshot-format / fleet read sites cannot drift.
_stale_read_seam = _retry.read_path


def array_crc32(arr) -> int:
    """CRC-32 of an array's raw bytes (dtype+shape-independent payload
    checksum; shapes/dtypes are validated by the restore paths' spec
    checks). Zero-copy: crc32 consumes the array's buffer directly."""
    a = np.asarray(arr)
    if not a.flags.c_contiguous:
        a = np.ascontiguousarray(a)
    return zlib.crc32(a)


def snapshot_path(directory: str, step: int) -> str:
    return os.path.join(directory, SNAPSHOT_FMT.format(step=step))


def snapshot_steps(directory: str) -> list[int]:
    """Published snapshot steps under ``directory``, ascending. Missing
    directory reads as empty (a watcher may start before the trainer's
    first save)."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return []
    out = []
    for f in names:
        m = SNAPSHOT_RE.fullmatch(f)
        if m:
            out.append(int(m.group(1)))
    return sorted(out)


def delta_path(directory: str, step: int, base: int) -> str:
    return os.path.join(directory, DELTA_FMT.format(step=step, base=base))


class Publication:
    """One discovered publication: a full snapshot or a delta link."""

    __slots__ = ("step", "kind", "base", "path")

    def __init__(self, step: int, kind: str, base: int | None, path: str):
        self.step = step
        self.kind = kind  # "full" | "delta"
        self.base = base  # delta only: the step it chains from
        self.path = path

    def __repr__(self):  # pragma: no cover - debugging aid
        return (f"Publication(step={self.step}, kind={self.kind!r}, "
                f"base={self.base}, path={self.path!r})")


def publications(directory: str) -> dict:
    """``{step: Publication}`` for every live publication under
    ``directory``. A full and a delta at the SAME step (the window while
    a background compaction's sweep hasn't finished) resolve to the full
    — the compactor's fold is bit-exact, so the two describe identical
    state and the standalone file wins. Missing directory reads empty."""
    try:
        names = os.listdir(directory)
    except FileNotFoundError:
        return {}
    out: dict[int, Publication] = {}
    for f in names:
        m = DELTA_RE.fullmatch(f)
        if m:
            step = int(m.group(1))
            if step not in out:  # full-wins handled below (fulls override)
                out[step] = Publication(step, "delta", int(m.group(2)),
                                        os.path.join(directory, f))
    for f in names:
        m = SNAPSHOT_RE.fullmatch(f)
        if m:
            step = int(m.group(1))
            out[step] = Publication(step, "full", None,
                                    os.path.join(directory, f))
    return out


def chain_members(pubs: dict, step: int) -> list:
    """The back-chain of publication ``step`` as a base-FIRST list
    ``[full, delta, ..., head]``. Raises :class:`ChainError` (naming the
    failing link) when a base is missing — a quarantined (``*.corrupt``)
    base is simply absent from ``pubs``, so a chain through it is broken
    by construction."""
    head = pubs.get(step)
    if head is None:
        raise ChainError(f"no publication at step {step}", step=step)
    members = [head]
    seen = {step}
    cur = head
    while cur.kind == "delta":
        nxt = pubs.get(cur.base)
        if nxt is None:
            raise ChainError(
                f"delta step {cur.step} chains from step {cur.base}, "
                "which has no live publication (swept, quarantined, or "
                "never landed)", step=cur.step)
        if nxt.step in seen or nxt.step >= cur.step:
            raise ChainError(
                f"delta step {cur.step} has a non-monotone base "
                f"{cur.base}", step=cur.step)
        seen.add(nxt.step)
        members.append(nxt)
        cur = nxt
    members.reverse()
    return members


def read_pub_meta(path: str) -> dict:
    """``{"base_step": int|None, "pod_epoch": int|None}`` of one
    publication, via numpy's lazy member access (only these entries'
    bytes are read). Structural failures surface as the usual torn-file
    errors — callers verifying chains treat them as a failing link."""
    out = {"base_step": None, "pod_epoch": None}
    path = _stale_read_seam(path)
    with np.load(path) as z:
        if BASE_STEP_KEY in z.files:
            out["base_step"] = int(z[BASE_STEP_KEY])
        if POD_EPOCH_KEY in z.files:
            out["pod_epoch"] = int(z[POD_EPOCH_KEY])
    return out


def _check_chain_meta(members: list) -> tuple[bool, str | None, int | None]:
    """Cross-check each link's CRC-tagged ``meta::base_step`` against the
    filename chain and enforce fencing-epoch MONOTONICITY base→head: a
    delta carrying an epoch OLDER than an earlier link's is a stale
    zombie's publish that must truncate the chain there (the read-side
    half of the pod fence). Returns ``(ok, reason, failing_step)``."""
    max_epoch = None
    prev_step = None
    for pub in members:
        try:
            meta = read_pub_meta(pub.path)
        except FileNotFoundError:
            return False, NO_SUCH_FILE, pub.step
        except IO_ERRORS as e:
            return False, f"unreadable: {e!r}", pub.step
        if pub.kind == "delta":
            if meta["base_step"] is None or meta["base_step"] != pub.base:
                return (False,
                        f"delta step {pub.step}: meta::base_step "
                        f"{meta['base_step']} != filename base {pub.base}",
                        pub.step)
            if prev_step is not None and pub.base != prev_step:
                return (False,
                        f"delta step {pub.step} chains from {pub.base}, "
                        f"not the previous link {prev_step}", pub.step)
        epoch = meta["pod_epoch"]
        if epoch is not None:
            if max_epoch is not None and epoch < max_epoch:
                return (False,
                        f"step {pub.step}: fencing epoch {epoch} is "
                        f"behind an earlier link's epoch {max_epoch} — "
                        "stale-zombie publish", pub.step)
            max_epoch = epoch if max_epoch is None else max(max_epoch,
                                                            epoch)
        prev_step = pub.step
    return True, None, None


def verify_chain(directory: str, step: int, *, pubs: dict | None = None
                 ) -> tuple[bool, str | None, int | None]:
    """Full integrity pass over the whole chain ending at ``step``:
    every link exists, CRC-verifies, cross-links correctly, and carries
    a monotone fencing epoch. Returns ``(ok, reason, failing_step)`` —
    read-only and exception-free, like :func:`verify_snapshot_file`."""
    if pubs is None:
        pubs = publications(directory)
    try:
        members = chain_members(pubs, step)
    except ChainError as e:
        return False, str(e), e.step
    for pub in members:
        ok, reason = verify_snapshot_file(pub.path)
        if not ok:
            return False, f"step {pub.step}: {reason}", pub.step
    return _check_chain_meta(members)


def latest_valid_chain(directory: str) -> tuple[int, list] | None:
    """Newest ``(step, chain_members)`` whose whole chain passes
    :func:`verify_chain`, scanning newest→oldest; ``None`` when none
    does. The chain-aware twin of :func:`latest_valid_snapshot` — a
    torn/CRC-failing/epoch-stale link truncates eligibility back to the
    last verified prefix (its own head steps are still candidates)."""
    pubs = publications(directory)
    for step in sorted(pubs, reverse=True):
        ok, _, _ = verify_chain(directory, step, pubs=pubs)
        if ok:
            return step, chain_members(pubs, step)
    return None


def read_delta_arrays(path: str) -> dict:
    """All non-CRC entries of one delta publication, materialized (a
    delta is O(touched rows) by construction — mapping buys nothing)."""
    path = _stale_read_seam(path)
    with np.load(path) as z:
        return {k: z[k] for k in z.files if not k.startswith(CRC_PREFIX)}


def apply_delta_entries(entries: dict, delta: dict) -> dict:
    """Overlay one delta's entries onto a full-form ``entries`` dict
    (``{key: array}`` in the full snapshot's key layout). Sparse pairs
    patch rows copy-on-write; plain keys replace; ``meta::base_step``
    never propagates (the result is full-form state, not a link)."""
    out = dict(entries)
    for k, v in delta.items():
        if k.startswith(DELTA_IDS_PREFIX) or k == BASE_STEP_KEY:
            continue
        if k.startswith(DELTA_ROWS_PREFIX):
            key = k[len(DELTA_ROWS_PREFIX):]
            ids = np.asarray(delta[DELTA_IDS_PREFIX + key], np.int64)
            if key not in out:
                raise ChainError(
                    f"delta patches {key!r}, absent from the base")
            arr = np.array(out[key], copy=True)
            if len(ids) and (ids.min() < 0 or ids.max() >= len(arr)):
                raise ChainError(
                    f"delta row ids out of range for {key!r}")
            arr[ids] = v
            out[key] = arr
        else:
            out[k] = v
    return out


def resolve_chain_entries(members: list) -> dict:
    """Materialize the full-form state described by a chain (base-first
    :class:`Publication` list): load the full, then fold every delta in
    order. Integrity is the caller's job (:func:`verify_chain` first)."""
    base = members[0]
    with np.load(base.path) as z:
        entries = {k: z[k] for k in z.files if not k.startswith(CRC_PREFIX)}
    for pub in members[1:]:
        entries = apply_delta_entries(entries, read_delta_arrays(pub.path))
    entries.pop(BASE_STEP_KEY, None)
    return entries


def verify_snapshot_file(path: str) -> tuple[bool, str | None]:
    """Full integrity pass over one snapshot file: ``(True, None)`` iff
    every entry reads back and matches its ``meta::crc`` tag; otherwise
    ``(False, reason)``. Pre-integrity snapshots (no crc tags) still get
    the structural checks — an unreadable zip fails either way.

    Read-only and exception-free on corruption (unlike the checkpoint
    layer's restore path, which quarantines): a serving process must be
    able to reject a bad publish without mutating the training plane's
    directory.
    """
    try:
        path = _stale_read_seam(path)
        with np.load(path) as z:
            for k in z.files:
                if k.startswith(CRC_PREFIX):
                    continue
                v = z[k]
                ck = CRC_PREFIX + k
                if ck in z.files and int(z[ck]) != array_crc32(v):
                    return False, f"checksum mismatch on entry {k!r}"
    except FileNotFoundError:
        return False, NO_SUCH_FILE
    except IO_ERRORS as e:
        return False, f"unreadable: {e!r}"
    return True, None


def latest_valid_snapshot(directory: str) -> tuple[int, str] | None:
    """Newest ``(step, path)`` whose snapshot passes
    :func:`verify_snapshot_file`, scanning newest→oldest; ``None`` when
    none does. Read-only (corrupt files are left in place — the training
    plane's restore path owns quarantine)."""
    for step in reversed(snapshot_steps(directory)):
        path = snapshot_path(directory, step)
        ok, _ = verify_snapshot_file(path)
        if ok:
            return step, path
    return None


# ---------------------------------------------------------------------------
# Zero-copy member mapping.
# ---------------------------------------------------------------------------

def _member_data_offset(f, zinfo) -> int:
    """File offset of ``zinfo``'s raw data: past the LOCAL header, whose
    name/extra lengths can differ from the central directory's (zip64
    padding), so the local record must be parsed, not assumed."""
    f.seek(zinfo.header_offset)
    hdr = f.read(30)
    if len(hdr) != 30 or hdr[:4] != b"PK\x03\x04":
        raise ValueError(
            f"member {zinfo.filename!r}: bad local file header")
    nlen, elen = struct.unpack("<HH", hdr[26:30])
    return zinfo.header_offset + 30 + nlen + elen


def _read_npy_header(f):
    """``(dtype, shape, fortran_order, data_offset_from_current)`` of the
    npy stream at ``f``'s current position (format versions 1/2/3)."""
    fmt = np.lib.format
    version = fmt.read_magic(f)
    if version == (1, 0):
        shape, fortran, dtype = fmt.read_array_header_1_0(f)
    elif version == (2, 0):
        shape, fortran, dtype = fmt.read_array_header_2_0(f)
    else:  # a future 3.x header parses like 2.0 (utf-8 header text)
        shape, fortran, dtype = fmt.read_array_header_2_0(f)
    return dtype, shape, fortran


def map_snapshot_arrays(path: str, *, keys=None) -> dict[str, np.ndarray]:
    """Read-only zero-copy views of a snapshot's array entries.

    Returns ``{key: array}`` where each array is an ``np.memmap``
    (``mode="r"``) straight onto the member's bytes inside the ``.npz``
    — no decompression (``np.savez`` stores uncompressed), no copy, no
    resident memory until rows are touched. ``keys`` optionally
    restricts which entries are mapped (default: every ``table::`` and
    ``ls::`` entry; ``meta::*`` tags are never mapped — they are read by
    :func:`verify_snapshot_file`).

    The maps stay valid as long as the FILE CONTENT at ``path``'s inode
    survives; the checkpoint writer only ever publishes via atomic
    rename (a new inode), so a mapped snapshot can never change under a
    reader — deletion unlinks the name but the mapping keeps the pages.
    Integrity is the caller's job (``verify_snapshot_file`` first): a
    torn file fails verification before anything is mapped.

    Raises ``ValueError`` for members this scheme cannot map (compressed
    members, object dtypes, pickled entries) — none of which the
    checkpoint writer produces.
    """
    out: dict[str, np.ndarray] = {}
    path = _stale_read_seam(path)
    with zipfile.ZipFile(path) as zf, open(path, "rb") as f:
        for zinfo in zf.infolist():
            name = zinfo.filename
            key = name[:-4] if name.endswith(".npy") else name
            if keys is not None:
                if key not in keys:
                    continue
            elif not (key.startswith(TABLE_PREFIX)
                      or key.startswith(LS_PREFIX)):
                continue
            if zinfo.compress_type != zipfile.ZIP_STORED:
                raise ValueError(
                    f"member {name!r} is compressed — zero-copy mapping "
                    "needs np.savez (stored), not savez_compressed")
            data_off = _member_data_offset(f, zinfo)
            f.seek(data_off)
            dtype, shape, fortran = _read_npy_header(f)
            if dtype.hasobject:
                raise ValueError(
                    f"member {name!r} holds object dtype — not mappable")
            out[key] = np.memmap(
                path, dtype=dtype, mode="r", offset=f.tell(), shape=shape,
                order="F" if fortran else "C",
            )
    return out
