"""Adaptive tiering: online re-ranking of the hot set and the planner of
the tier's knobs.

Port of ``fps_tpu/tiering``. A static hot tier (``TableSpec.hot_tier``) is
the leading ids, fixed when the spec is written; a stream whose hot set
drifts leaves it serving little. Here the tier is managed as the run goes:

* **tracking**: each tracked table's pulled ids go into a count-min
  window on every position each step (kernel K4 on the card), summed over
  the mesh once a call, and folded on the host into a decayed count-min
  that forgets an old head;
* **re-rank and re-split** (:class:`Retierer`): at chunk and epoch
  boundaries the sketched top ``H`` replaces the hot set; the replica and
  its slot map and id array are swapped, every shape as it was;
* **planning** (:func:`plan_tables`): each table's ``hot_tier``,
  ``hot_sync_every``, dense route and ``cold_budget`` from its sketched
  density (``TrainerConfig.auto_tier``).

* **the sidecar** (``Retierer(state_dir=...)``, :func:`sidecar_path`):
  the tracker's state beside the checkpoints, restored with them
  (:meth:`Retierer.restore`).

* **the megastep's tick** (:class:`MegastepTick`, :func:`device_top_ids`):
  the same boundary on the device, every ``check_every`` chunk segments of
  ``Trainer.run_megastep``, with no host read.

* **the probe** (:class:`ProbeLogic`, :func:`probe_chunk`,
  :func:`lowered_plan_text`): a plan's data plane without a model, and
  the record of its per-chunk program for the program auditor
  (:mod:`fps_tpu_torch.analysis`).
"""

from fps_tpu_torch.tiering.planner import (
    DEFAULT_REPLICA_BUDGET_BYTES,
    TableDensity,
    TierPlan,
    arbitrate_replica_budget,
    choose_cold_budget,
    choose_sync_every,
    global_sync_every,
    head_coverage,
    plan_tables,
    plan_tenants,
    tenant_demand_bytes,
)
from fps_tpu_torch.tiering.probe import ProbeLogic, lowered_plan_text, probe_chunk
from fps_tpu_torch.tiering.retier import Retierer, sidecar_path, top_ids
from fps_tpu_torch.tiering.tick import MegastepTick, device_top_ids

__all__ = [
    "DEFAULT_REPLICA_BUDGET_BYTES", "TableDensity", "TierPlan",
    "arbitrate_replica_budget", "choose_cold_budget", "choose_sync_every",
    "global_sync_every", "head_coverage", "plan_tables", "plan_tenants",
    "tenant_demand_bytes", "Retierer", "sidecar_path", "top_ids", "ProbeLogic",
    "probe_chunk", "lowered_plan_text", "MegastepTick", "device_top_ids",
]
