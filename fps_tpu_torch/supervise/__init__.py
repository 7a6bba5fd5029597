"""fps_tpu_torch.supervise: external run supervision (the deadline-abort
layer). Port of ``fps_tpu/supervise/``.

Two halves of one contract, and the pod above them:

* :mod:`fps_tpu_torch.supervise.supervisor`, the parent side:
  :class:`RunSupervisor` launches a training command, tails its heartbeat
  (and any watched journal files) for liveness, deadline-aborts a wedged
  child (SIGTERM, then SIGKILL to the process group), restarts it with
  exponential backoff under a retry budget, and quarantines
  deterministically poisoned chunk or epoch indices across restarts
  (persisted next to the checkpoint directory). Stdlib-only;
  ``fps_tpu_torch/examples/supervise.py`` is its CLI.
* :mod:`fps_tpu_torch.supervise.child`, the child side:
  :class:`Heartbeat` (and :class:`HeartbeatSink` for the obs Recorder)
  and the env contract through which a supervised process finds its
  heartbeat path, attempt number and carried quarantine set; also the pod
  fence a checkpoint publish honours (:class:`StaleEpochError`).
* :mod:`fps_tpu_torch.supervise.pod`, the pod coordinator:
  :class:`PodMember` runs one host's member of a pod (leader election
  over a :class:`Lease` with a fencing epoch, coordinated restarts from
  a common step, a pod-wide quarantine, elastic membership) under a
  :class:`PodConfig`.

The three modules are stdlib-only and load by file path; importing this
package imports ``fps_tpu_torch`` (and torch) first, so a supervising
process loads them by path instead.
"""

from fps_tpu_torch.supervise.child import (
    ATTEMPT_ENV,
    FENCE_FILENAME,
    HEARTBEAT_ENV,
    HEARTBEAT_VERSION,
    POD_EPOCH_ENV,
    POD_HOST_ENV,
    POD_STEP_ENV,
    POD_WORLD_ENV,
    STATE_ENV,
    Heartbeat,
    HeartbeatSink,
    StaleEpochError,
    attempt_from_env,
    fence_allows,
    from_env,
    pod_env,
    quarantined_from_env,
    read_fence,
    write_fence,
)
from fps_tpu_torch.supervise.supervisor import (
    RunSupervisor,
    SupervisorConfig,
)

# pod.py finds its siblings in sys.modules under these names (it also
# loads by bare file path, without the package), so child, supervisor and
# the stdlib-only core/retry.py are imported before it: the package keeps
# ONE StaleEpochError, one RunSupervisor and the one fault seam that
# testing/faultfs.py installs its injector into.
from fps_tpu_torch.core import retry as _retry  # noqa: F401
from fps_tpu_torch.supervise.pod import (
    Lease,
    PodConfig,
    PodMember,
)

__all__ = [
    "RunSupervisor",
    "SupervisorConfig",
    "PodConfig",
    "PodMember",
    "Lease",
    "Heartbeat",
    "HeartbeatSink",
    "StaleEpochError",
    "from_env",
    "attempt_from_env",
    "quarantined_from_env",
    "pod_env",
    "read_fence",
    "write_fence",
    "fence_allows",
    "HEARTBEAT_ENV",
    "HEARTBEAT_VERSION",
    "STATE_ENV",
    "ATTEMPT_ENV",
    "POD_HOST_ENV",
    "POD_EPOCH_ENV",
    "POD_WORLD_ENV",
    "POD_STEP_ENV",
    "FENCE_FILENAME",
]
