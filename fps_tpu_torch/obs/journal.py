"""Per-process run journal: the narrative record of one training run.

Port of ``fps_tpu/obs/journal.py``.

A JSONL file holding only the run's EVENTS — run start/end (run id,
config digest, process/mesh identity), chunk and epoch boundaries,
checkpoint saves and fallback-restores, rollback/quarantine decisions,
guard escalations, watchdog stalls. Metrics samples stay in the event
log (``JsonlSink``); the journal is the small file a human (or
``tools/obs_report.py``) reads first to understand what a run did.

Over several processes every process writes its own journal (``journal-p<K>.jsonl``)
and stamps records with ``run_id`` + ``process``; the report tool joins
them. There is no cross-process coordination here — telemetry must not
add collectives.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import uuid

from fps_tpu_torch.obs.sinks import JsonlSink, Sink, _json_default


def new_run_id() -> str:
    """Sortable-by-start-time, collision-free across hosts."""
    return time.strftime("%Y%m%d-%H%M%S") + "-" + uuid.uuid4().hex[:8]


def config_digest(config) -> str:
    """Stable short digest of an arbitrary config mapping/object — the
    journal's answer to "were these two runs the same experiment?".
    Non-JSON values degrade to ``repr`` (callables, dtypes, meshes), so
    the digest is stable for a fixed config but not across refactors that
    change reprs — fine for its job of grouping runs, not proving them."""
    try:
        blob = json.dumps(config, sort_keys=True, default=_json_default)
    except TypeError:
        blob = repr(config)
    return hashlib.sha256(blob.encode("utf-8")).hexdigest()[:16]


def process_index() -> int:
    """This process's rank when a default ``torch.distributed`` process
    group is initialised, else 0. Never initialises a group itself; a
    process that has not imported torch (a pure-host tool) pays no import."""
    import sys

    dist = sys.modules.get("torch.distributed")
    try:
        if dist is not None and dist.is_available() and dist.is_initialized():
            return int(dist.get_rank())
    except Exception:  # noqa: BLE001 - any backend failure => solo
        pass
    return 0


class RunJournal(Sink):
    """Sink keeping only ``kind == "event"`` records, plus run_start /
    run_end bracketing. Attach it to a Recorder next to the full JSONL
    sink; both files then share one emission path and one clock."""

    def __init__(self, path: str, *, run_id: str, meta: dict | None = None):
        self.run_id = run_id
        self._inner = JsonlSink(path, flush_every=1)  # journal = durable
        self.path = path
        self._closed = False
        self._inner.write({
            "kind": "event", "t": time.time(), "event": "run_start",
            "run_id": run_id, "pid": os.getpid(), **(meta or {}),
        })

    def write(self, record: dict) -> None:
        if record.get("kind") == "event":
            self._inner.write(record)

    def flush(self) -> None:
        self._inner.flush()

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        self._inner.write({
            "kind": "event", "t": time.time(), "event": "run_end",
            "run_id": self.run_id,
        })
        self._inner.close()
