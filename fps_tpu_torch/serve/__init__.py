"""fps_tpu_torch.serve — the read path: publish snapshots to query traffic.

The port's copy of ``fps_tpu/serve/``: the same classes, the same wire,
the same fence and gate files, over the same snapshot files (the port's
``Checkpointer`` writes the JAX package's format), so a reader or client
of either package serves or queries the other's.

The serving half of the parameter-server abstraction (Parameter Box,
PAPERS.md): everything up to here trains; this subsystem answers. A
:class:`SnapshotWatcher` turns the training plane's publish trail
(atomic-rename ``ckpt_*.npz`` snapshots + ``checkpoint_saved`` journal
events) into a stream of CRC-verified, read-only-mmapped
:class:`ServableSnapshot` publications; a :class:`ReadServer` answers
batched pull-by-id and model-head queries (MF top-k, logreg/PA scoring)
against the current one, hot-swapping to each newer snapshot by a single
reference flip — in-flight requests finish on the snapshot they started
on, and the swap cost is independent of table size. ``docs/serving.md``
is the architecture note; the freshness SLO ("write→servable" lag) and
swap/rollback semantics live there.

Delta publications (``DeltaPolicy`` chains on the write side) hot-swap
INCREMENTALLY — ``ServableSnapshot.with_delta`` overlays the touched
rows on the still-mapped base (:class:`DeltaView`) instead of re-opening
the world — and the single reader grows into a step-fenced FLEET
(:mod:`fps_tpu_torch.serve.fleet`): N readers over one snapshot dir whose
swaps are coordinated by a shared fence no reader ever answers behind.

torch-free by construction (stdlib + numpy; the on-disk contract comes
from :mod:`fps_tpu_torch.core.snapshot_format`, telemetry from
:mod:`fps_tpu_torch.obs.events` / ``sinks`` / ``trace``, none of which
import torch): ``fps_tpu_torch/examples/serve.py`` runs this whole plane
beside a training job that owns the card, or on a host with no CUDA
runtime.
"""

from fps_tpu_torch.serve.admission import AdmissionController
from fps_tpu_torch.serve.fleet import (
    FleetReader,
    ReadAutoscaler,
    ServingFleet,
    StepFence,
    liveness_check,
    scan_heartbeats,
    tiering_hot_ids,
)
from fps_tpu_torch.serve.net import JsonlClient, TcpServe, handle_request
from fps_tpu_torch.serve.server import CoalesceConfig, NoSnapshotError, ReadServer
from fps_tpu_torch.serve.shadow import ShadowGate, ShadowScorer
from fps_tpu_torch.serve.snapshot import (
    DeltaView,
    ServableSnapshot,
    SnapshotRejected,
    materialize,
)
from fps_tpu_torch.serve.watcher import SnapshotWatcher
from fps_tpu_torch.serve.wire import (
    ProtocolVersionError,
    ServerBusyError,
    TornFrameError,
    WireClient,
    WireError,
)

__all__ = [
    "AdmissionController",
    "CoalesceConfig",
    "DeltaView",
    "FleetReader",
    "JsonlClient",
    "NoSnapshotError",
    "ProtocolVersionError",
    "ReadAutoscaler",
    "ReadServer",
    "ServableSnapshot",
    "ServerBusyError",
    "ServingFleet",
    "ShadowGate",
    "ShadowScorer",
    "SnapshotRejected",
    "SnapshotWatcher",
    "StepFence",
    "TcpServe",
    "TornFrameError",
    "WireClient",
    "WireError",
    "handle_request",
    "liveness_check",
    "materialize",
    "scan_heartbeats",
    "tiering_hot_ids",
]
