"""Child-process side of a supervised run: heartbeat and carried quarantine.

Port of ``fps_tpu/supervise/child.py``. A training process launched by
:class:`fps_tpu_torch.supervise.RunSupervisor` finds its contract in
environment variables:

* :data:`HEARTBEAT_ENV`: path of the heartbeat file this process touches
  at every progress boundary (the supervisor's liveness signal; a stalled
  heartbeat is what triggers the deadline abort);
* :data:`STATE_ENV`: path of the supervisor's persisted state file,
  holding the chunk or epoch indices quarantined by PREVIOUS attempts
  (:func:`quarantined_from_env` feeds them into
  ``RollbackPolicy(preset=...)``, so a deterministic poison batch cannot
  crash-loop the run);
* :data:`ATTEMPT_ENV`: zero-based attempt number, for logging.

The names, the beat's fields and :data:`HEARTBEAT_VERSION` are the
reference's letter for letter, so either package's supervisor supervises
either package's child.

The pod fence (:data:`FENCE_FILENAME`, :class:`StaleEpochError`,
:func:`read_fence`, :func:`write_fence`, :func:`fence_allows`) lives here
as in the reference: ``fps_tpu_torch.core.checkpoint`` imports it, so the
class a publish raises is the class a pod coordinator
(:mod:`fps_tpu_torch.supervise.pod`) catches, and :func:`pod_env` reads the
contract that coordinator sets.

Everything here is stdlib-only and loads by file path with torch
unimportable: the port's supervisor CLI
(``fps_tpu_torch/examples/supervise.py``) loads it that way and never
brings a CUDA runtime into the supervising process; training children
import it normally.
"""

from __future__ import annotations

import json
import os
import tempfile
import time

HEARTBEAT_ENV = "FPS_TPU_HEARTBEAT"
STATE_ENV = "FPS_TPU_SUPERVISOR_STATE"
ATTEMPT_ENV = "FPS_TPU_ATTEMPT"

# Pod membership contract (set by fps_tpu_torch/supervise/pod.py when the
# child runs under a pod coordinator; all absent in plain supervised
# runs): the member host this child belongs to, the fencing epoch of the
# pod attempt that spawned it, the pod world size, and the pod-commanded
# common restart step.
POD_HOST_ENV = "FPS_TPU_POD_HOST"
POD_EPOCH_ENV = "FPS_TPU_POD_EPOCH"
POD_WORLD_ENV = "FPS_TPU_POD_WORLD"
POD_STEP_ENV = "FPS_TPU_POD_STEP"

# Causal-tracing contract (the same names as fps_tpu_torch/obs/trace.py,
# mirrored because this module loads without the package): the trace id
# of the run this child belongs to, and the span id of the supervisor
# attempt that spawned it.
TRACE_ID_ENV = "FPS_TPU_TRACE_ID"
PARENT_SPAN_ENV = "FPS_TPU_PARENT_SPAN"

# Heartbeat schema version, written into every beat. The supervisor
# rejects beats of an unknown version (or a foreign ``host``) loudly
# instead of misparsing them.
HEARTBEAT_VERSION = 2

# Fence file a pod leader drops into a member's checkpoint directory
# before commanding a new attempt: a writer whose epoch is below
# ``min_epoch`` must refuse to publish (fps_tpu_torch.core.checkpoint
# checks it before every atomic rename).
FENCE_FILENAME = "pod_fence.json"


def trace_from_env() -> dict:
    """The tracing contract from the environment: ``{"trace_id",
    "parent_id"}``, Nones when untraced."""
    return {
        "trace_id": os.environ.get(TRACE_ID_ENV) or None,
        "parent_id": os.environ.get(PARENT_SPAN_ENV) or None,
    }


class StaleEpochError(RuntimeError):
    """A checkpoint publish was refused because the writer's fencing
    epoch predates the pod fence: the writer belongs to an attempt the
    pod has already aborted and restarted past."""


def read_fence(directory: str) -> dict | None:
    """The pod fence in ``directory`` (``{"min_epoch": E, "step": S}``),
    or ``None`` when the directory is unfenced or the fence is torn (an
    unreadable fence must not brick an unsupervised run)."""
    try:
        with open(os.path.join(directory, FENCE_FILENAME),
                  encoding="utf-8") as f:
            rec = json.load(f)
        return rec if isinstance(rec, dict) else None
    except (OSError, json.JSONDecodeError):
        return None


def write_fence(directory: str, min_epoch: int, step: int) -> None:
    """Publish the fence atomically (tmp + rename, same directory)."""
    os.makedirs(directory, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=directory, suffix=".fence.tmp")
    try:
        with os.fdopen(fd, "w", encoding="utf-8") as f:
            json.dump({"min_epoch": int(min_epoch), "step": int(step)}, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, os.path.join(directory, FENCE_FILENAME))
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def fence_allows(directory: str, epoch: int | None) -> tuple[bool, int]:
    """``(allowed, min_epoch)`` for a writer of fencing epoch ``epoch``:
    an unfenced directory allows everyone; a fenced one refuses a writer
    without an epoch (one that predates the pod contract)."""
    fence = read_fence(directory)
    if fence is None:
        return True, 0
    try:
        min_epoch = int(fence.get("min_epoch", 0))
    except (TypeError, ValueError):
        return True, 0
    if epoch is None:
        return False, min_epoch
    return int(epoch) >= min_epoch, min_epoch


def pod_env() -> dict:
    """The pod contract from the environment: ``{"host", "epoch",
    "world", "step"}``, Nones outside a pod."""

    def _int(name):
        v = os.environ.get(name)
        try:
            return int(v) if v not in (None, "") else None
        except ValueError:
            return None

    return {
        "host": os.environ.get(POD_HOST_ENV) or None,
        "epoch": _int(POD_EPOCH_ENV),
        "world": _int(POD_WORLD_ENV),
        "step": _int(POD_STEP_ENV),
    }


class Heartbeat:
    """Progress beacon: one small JSON object, atomically replaced.

    The supervisor keys liveness off the file's mtime and reads ``index``
    to localise where an attempt died (consecutive deaths at the same
    index quarantine it). The replace is tmp + rename in the same
    directory, so the supervisor never reads a torn beat.

    Extra keyword fields ride the beat verbatim; the drivers beat with a
    ``phase`` (``prefetch`` / ``ingest`` / ``dispatch``) between chunk
    boundaries, so the supervisor's attempt records name the sub-phase a
    death happened in (``last_phase`` in ``supervisor_state.json``).
    """

    def __init__(self, path: str):
        self.path = path
        d = os.path.dirname(os.path.abspath(path))
        os.makedirs(d, exist_ok=True)
        self._dir = d

    def beat(self, index: int | None = None, **fields) -> None:
        rec = {
            "version": HEARTBEAT_VERSION,
            "t": time.time(),
            "pid": os.getpid(),
            # The pod member this beat belongs to (None outside pods).
            "host": os.environ.get(POD_HOST_ENV) or None,
            "index": index,
        }
        rec.update(fields)
        fd, tmp = tempfile.mkstemp(dir=self._dir, suffix=".hb.tmp")
        try:
            with os.fdopen(fd, "w", encoding="utf-8") as f:
                json.dump(rec, f)
            os.replace(tmp, self.path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)

    def on_chunk(self, inner=None):
        """An ``on_chunk`` / ``on_epoch`` callback that beats and then
        forwards to ``inner`` when given. It beats ``i + 1``, the index
        about to be attempted, so a death inside the next chunk
        attributes to that chunk on every attempt."""

        def cb(i, metrics):
            self.beat(index=int(i) + 1)
            if inner is not None:
                inner(i, metrics)

        return cb


class HeartbeatSink:
    """Recorder sink that beats on ``run_start`` / ``chunk`` / ``epoch``
    events.

    Duck-typed against :class:`fps_tpu_torch.obs.sinks.Sink` (write /
    flush / close), so this module loads without the obs package. Attach
    it to the run's Recorder and every chunk or epoch journal event is
    also a liveness signal. The drivers find the beacon through the
    sink's ``heartbeat`` attribute and beat their sub-phases on it.

    The beat carries the index ABOUT TO BE ATTEMPTED (chunk event ``i``
    beats ``i + 1``): the supervisor quarantines the index a crashing
    child was last working on, and a crash inside chunk ``i`` must
    attribute to ``i``.
    """

    def __init__(self, heartbeat: Heartbeat):
        self.heartbeat = heartbeat

    def write(self, record: dict) -> None:
        if record.get("kind") != "event":
            return
        if record.get("event") in ("run_start", "chunk", "epoch"):
            idx = record.get("index")
            self.heartbeat.beat(index=None if idx is None else int(idx) + 1)

    def flush(self) -> None:
        pass

    def close(self) -> None:
        pass


def from_env() -> Heartbeat | None:
    """The supervisor-provided heartbeat, or ``None`` when unsupervised."""
    path = os.environ.get(HEARTBEAT_ENV)
    return Heartbeat(path) if path else None


def attempt_from_env() -> int:
    try:
        return int(os.environ.get(ATTEMPT_ENV, "0"))
    except ValueError:
        return 0


def read_state(path: str) -> dict:
    """The supervisor's persisted state (``{}`` when absent or unreadable:
    a child must start rather than crash on a torn state file)."""
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def quarantined_from_env() -> frozenset[int]:
    """Chunk or epoch indices quarantined by previous attempts (empty when
    unsupervised): feed into ``RollbackPolicy(preset=...)``."""
    path = os.environ.get(STATE_ENV)
    if not path:
        return frozenset()
    state = read_state(path)
    try:
        return frozenset(int(i) for i in state.get("quarantined", ()))
    except (TypeError, ValueError):
        return frozenset()
