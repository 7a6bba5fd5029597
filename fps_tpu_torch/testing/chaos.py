"""Deterministic fault injection for the port's resilience tests.

Port of the jax-free injectors of ``fps_tpu/testing/chaos.py``, composed by
the port's resilience and checkpoint tests and by the supervised scenarios
(:mod:`fps_tpu_torch.testing.supervised_demo`):

* **poison batches**: NaN, Inf or huge values planted into chosen rows of
  a chunk stream's columns, exercising the step guard
  (:class:`fps_tpu_torch.core.resilience.GuardConfig`);
* **snapshot corruption**: truncation and bit flips of checkpoint files on
  disk, exercising the verified read and its fallback
  (:mod:`fps_tpu_torch.core.checkpoint`);
* **process death**: SIGKILL helpers: die at an epoch or chunk boundary,
  inside the prefetch worker's assembly of a chunk, or mid-write leaving a
  partial ``.tmp.npz`` behind;
* **wedges**: freeze the whole process (SIGSTOP) or the host loop (sleep
  forever) after a chunk trains, the stalls only the supervisor's
  deadline abort (:mod:`fps_tpu_torch.supervise`) clears.

Every injector is deterministic: corruption sites come from a seeded
``np.random.default_rng``, never from wall-clock or os entropy, so a
failing chaos test replays bit for bit.
"""

from __future__ import annotations

import os
import signal
import tempfile
from typing import Iterable, Iterator, Mapping, Sequence

import numpy as np

POISON_KINDS = ("nan", "inf", "-inf", "huge")


def _poison_value(kind: str, dtype) -> np.ndarray:
    if kind == "nan":
        v = np.nan
    elif kind == "inf":
        v = np.inf
    elif kind == "-inf":
        v = -np.inf
    elif kind == "huge":
        # Finite but norm-exploded: trips the guard's norm tier, not the
        # non-finite tier.
        v = np.finfo(np.dtype(dtype)).max / 4
    else:
        raise ValueError(f"unknown poison kind {kind!r} ({POISON_KINDS})")
    return np.asarray(v, dtype)


def poison_rows(
    array: np.ndarray, rows: Sequence[int], kind: str = "nan"
) -> np.ndarray:
    """Copy of ``array`` with ``rows`` (indices along axis 0) overwritten
    by the poison value."""
    out = np.array(array, copy=True)
    out[np.asarray(rows, np.int64)] = _poison_value(kind, out.dtype)
    return out


def poison_chunks(
    chunks: Iterable[Mapping[str, np.ndarray]],
    *,
    chunk_index: int,
    column: str,
    kind: str = "nan",
    frac: float = 0.25,
    seed: int = 0,
) -> Iterator[dict]:
    """Wrap a chunk stream, poisoning ``frac`` of ``column``'s entries in
    chunk ``chunk_index`` (deterministic sites from ``seed``). Chunk
    leaves keep their ``(T, B, ...)`` layout; poison lands on a seeded
    choice of flat positions of the column, so both sync and SSP chunk
    shapes work unchanged."""
    rng = np.random.default_rng(seed)
    for i, chunk in enumerate(chunks):
        if i != chunk_index:
            yield dict(chunk)
            continue
        out = dict(chunk)
        col = np.array(out[column], copy=True)
        flat = col.reshape(-1)
        n = max(1, int(frac * flat.size))
        sites = rng.choice(flat.size, size=n, replace=False)
        flat[sites] = _poison_value(kind, flat.dtype)
        out[column] = col
        yield out


# ---------------------------------------------------------------------------
# Snapshot corruption (on-disk).
# ---------------------------------------------------------------------------

def truncate_file(path: str, *, keep_frac: float = 0.5) -> str:
    """Truncate ``path`` to ``keep_frac`` of its size (a torn write /
    partial copy). Returns ``path``."""
    size = os.path.getsize(path)
    keep = max(0, int(size * keep_frac))
    with open(path, "r+b") as f:
        f.truncate(keep)
    return path


def bitflip_file(
    path: str,
    *,
    nflips: int = 16,
    seed: int = 0,
    lo_frac: float = 0.2,
    hi_frac: float = 0.95,
) -> str:
    """Flip ``nflips`` seeded-random bits of ``path`` within the byte
    window ``[lo_frac, hi_frac)`` of the file (the payload region of an
    ``.npz`` — away from the leading zip local header so the corruption
    models silent bit rot in array data, not an unopenable file; the
    integrity layer must catch both either way). Returns ``path``."""
    size = os.path.getsize(path)
    lo, hi = int(size * lo_frac), max(int(size * hi_frac), int(size * lo_frac) + 1)
    rng = np.random.default_rng(seed)
    with open(path, "r+b") as f:
        for _ in range(nflips):
            off = int(rng.integers(lo, hi))
            bit = int(rng.integers(0, 8))
            f.seek(off)
            b = f.read(1)[0]
            f.seek(off)
            f.write(bytes([b ^ (1 << bit)]))
    return path


def snapshot_paths(ckpt_dir: str) -> list[str]:
    """Snapshot files under ``ckpt_dir``, oldest to newest: the naming
    contract comes from the port's on-disk format module."""
    from fps_tpu_torch.core.snapshot_format import SNAPSHOT_RE

    out = []
    for f in os.listdir(ckpt_dir):
        if SNAPSHOT_RE.fullmatch(f):
            out.append(os.path.join(ckpt_dir, f))
    return sorted(out)


def corrupt_latest_snapshot(
    ckpt_dir: str, mode: str = "truncate", **kwargs
) -> str:
    """Corrupt the NEWEST snapshot under ``ckpt_dir`` (``mode`` is
    ``"truncate"`` or ``"bitflip"``; kwargs forward to the injector).
    Returns the corrupted path."""
    paths = snapshot_paths(ckpt_dir)
    if not paths:
        raise FileNotFoundError(f"no snapshots under {ckpt_dir}")
    target = paths[-1]
    if mode == "truncate":
        return truncate_file(target, **kwargs)
    if mode == "bitflip":
        return bitflip_file(target, **kwargs)
    raise ValueError(f"unknown corruption mode {mode!r}")


# ---------------------------------------------------------------------------
# Process-death injectors (subprocess scenarios).
# ---------------------------------------------------------------------------

def sigkill_self() -> None:
    """Die NOW, with no atexit/flush — the crash the kill-resume contract
    is about."""
    os.kill(os.getpid(), signal.SIGKILL)


def kill_at_epoch(epoch: int):
    """``on_epoch``/``on_chunk`` callback that SIGKILLs the process after
    index ``epoch`` finishes training but before its checkpoint lands."""

    def cb(e, _metrics):
        if e == epoch:
            sigkill_self()

    return cb


def kill_at_chunk(index: int, *, marker: str | None = None,
                  before=None):
    """``on_chunk``/``on_epoch`` callback that SIGKILLs (no flush) after
    chunk ``index`` finishes training but before its checkpoint lands —
    the marker-gated variant of
    :func:`kill_at_epoch` (once-only across restarted attempts). ``before`` runs just before dying (e.g. an
    async checkpointer ``flush()`` when the scenario's lost-work bound
    requires prior snapshots durable)."""

    def cb(i, _metrics):
        if i != index:
            return
        if marker is not None:
            if os.path.exists(marker):
                return
            open(marker, "w").close()
        if before is not None:
            before()
        sigkill_self()

    return cb


def sigstop_self() -> None:
    """Freeze NOW: every thread stops and the heartbeat with it, but the
    process does not die, and a SIGTERM only queues until a SIGCONT that
    never comes. A card held by the process stays held. The wedge only
    the supervisor's SIGKILL escalation clears."""
    os.kill(os.getpid(), signal.SIGSTOP)


def sleep_forever() -> None:
    """Wedge the calling thread without stopping the process: the Python
    loop stops launching while signal handlers stay live (the quietly hung
    host loop; a SIGTERM still kills this one)."""
    import time

    while True:
        time.sleep(3600)


def wedge_at_chunk(index: int, mode: str = "sigstop", *,
                   marker: str | None = None):
    """``on_chunk`` / ``on_epoch`` callback that wedges the process after
    chunk ``index`` trains but BEFORE its checkpoint lands, the supervisor
    scenario's counterpart of :func:`kill_at_epoch`.

    ``mode``: ``"sigstop"`` (freeze the whole process) or ``"sleep"``
    (wedge the host loop). ``marker``: a file path making the wedge once
    only: the callback touches it before wedging, and a restarted attempt
    that finds it proceeds (no wall clock or entropy involved)."""
    if mode not in ("sigstop", "sleep"):
        raise ValueError(f"unknown wedge mode {mode!r}")

    def cb(i, _metrics):
        if i != index:
            return
        if marker is not None:
            if os.path.exists(marker):
                return
            open(marker, "w").close()
        sigstop_self() if mode == "sigstop" else sleep_forever()

    return cb


def kill_in_prefetch(chunks: Iterable, index: int, *,
                     marker: str | None = None) -> Iterator:
    """Re-yield ``chunks`` but die (SIGKILL, no flush) right before chunk
    ``index`` is handed on: under the overlapped host pipeline
    (:mod:`fps_tpu_torch.core.prefetch`) that is inside the worker
    thread's assembly, typically chunks ahead of the one the driver is
    launching. ``marker`` makes the kill once only across supervised
    attempts (touched before dying)."""
    for i, c in enumerate(chunks):
        if i == index:
            if marker is None or not os.path.exists(marker):
                if marker is not None:
                    open(marker, "w").close()
                sigkill_self()
        yield c

def partial_write_then_kill(directory: str, nbytes: int = 4096) -> None:
    """Simulate dying MID-checkpoint-write: leave a partial ``.tmp.npz``
    (zip magic + junk) in ``directory`` — exactly what a crashed
    ``_atomic_savez`` leaves before its ``os.replace`` — then SIGKILL.

    The recovery contract under test: a fresh ``Checkpointer`` sweeps the
    stale tmp file and restore falls back to the newest intact snapshot.
    """
    fd, _tmp = tempfile.mkstemp(dir=directory, suffix=".tmp.npz")
    try:
        os.write(fd, b"PK\x03\x04" + b"\xde\xad" * (max(nbytes - 4, 0) // 2))
        os.fsync(fd)
    finally:
        os.close(fd)
    sigkill_self()
