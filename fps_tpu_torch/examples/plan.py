"""Print an auto-tiering plan and its predicted collective-byte budget.

Port of ``tools/plan.py``, the command line of
:mod:`fps_tpu_torch.tiering.planner`, with the same flags, defaults and
JSON keys: given per-table geometries and an id-density estimate — a
synthetic Zipf profile (``--alpha``) or measured counts from an ``.npz``
(``--counts``, arrays keyed by table name) — run :func:`plan_tables` and
print the per-table decision rows (``hot_tier`` / ``hot_sync_every`` /
dense route, with the planner's reason strings).

Unless ``--no-lower``, the tool then records the plan's program: the probe
workload (:mod:`fps_tpu_torch.tiering.probe`) over the planned table specs
on the single-controller mesh of the reference's shape,
``default_mesh_shape(8)`` = ``(2, 4)``, and
``fps_tpu_torch.analysis.collective_profile`` over the record of the
per-chunk program the driver would run: the predicted budget is a measured
program, not a cost model. The untiered baseline is profiled alongside.
The mesh's positions are on the card unless ``--device`` names another
device (``--device cpu``); the reference re-executes itself into an
8-device CPU environment, the port needs none. ``--no-lower`` imports no
torch.

Usage:
  python -m fps_tpu_torch.examples.plan --table item_factors:4096:16 \\
      --table users:100000:16 [--alpha 1.2 | --counts COUNTS.npz] \\
      [--batch-rows 1024] [--coverage 0.9] [--replica-budget-mb 64] \\
      [--max-sync-every 8] [--shards 8] [--no-lower] [--json]
      [--device cpu]
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__" and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

# The reference's lowering mesh: default_mesh_shape over 8 devices.
LOWER_DEVICES = 8


def _parse_table(s: str):
    parts = s.split(":")
    if len(parts) != 3:
        raise argparse.ArgumentTypeError(
            f"--table wants name:num_ids:dim, got {s!r}")
    return parts[0], int(parts[1]), int(parts[2])


def _build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(
        description="auto-tiering planner CLI (fps_tpu_torch.tiering)")
    ap.add_argument("--table", action="append", required=True,
                    type=_parse_table, metavar="NAME:NUM_IDS:DIM",
                    help="one parameter table's geometry (repeatable)")
    ap.add_argument("--alpha", type=float, default=1.2,
                    help="synthetic Zipf skew for the density estimate "
                         "(ignored with --counts)")
    ap.add_argument("--counts", default=None, metavar="NPZ",
                    help="measured per-id counts, one array per table "
                         "name (overrides --alpha)")
    ap.add_argument("--batch-rows", type=int, default=1024,
                    help="pulled rows per step per table (the planner's "
                         "traffic unit)")
    ap.add_argument("--coverage", type=float, default=0.9,
                    help="traffic fraction a partial head must cover")
    ap.add_argument("--replica-budget-mb", type=float, default=64.0,
                    help="per-device replica memory budget per table")
    ap.add_argument("--max-sync-every", type=int, default=8,
                    help="reconcile-cadence ceiling (staleness bound)")
    ap.add_argument("--shards", type=int, default=8)
    ap.add_argument("--workers", type=int, default=8,
                    help="total worker devices (sizes the per-worker "
                         "compacted cold lane, planner.choose_cold_budget)")
    ap.add_argument("--no-lower", action="store_true",
                    help="plan only — skip recording the probe program "
                         "(no torch needed)")
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output only")
    ap.add_argument("--device", default=None,
                    help="where the lowering mesh's positions live "
                         "(default: the card, cuda:0; 'cpu' for the "
                         "tests)")
    return ap


def _planner():
    """The planner module, loaded on its own (it imports numpy only), so
    that planning never imports torch through the package roots."""
    mod = sys.modules.get("fps_tpu_torch.tiering.planner")
    if mod is not None:
        return mod
    path = os.path.join(_ROOT, "fps_tpu_torch", "tiering", "planner.py")
    spec = importlib.util.spec_from_file_location("_fps_torch_planner", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # dataclasses look their module up
    spec.loader.exec_module(mod)
    return mod


def lower(tables, plans, hot_sync_every: int, device: str) -> dict:
    """The ``predicted`` and ``untiered_baseline`` budgets of ``plans``
    over ``tables`` (``[(name, num_ids, dim)]``) and the mesh's shape,
    recorded on ``device``."""
    from fps_tpu_torch.analysis import collective_profile
    from fps_tpu_torch.core.store import TableSpec
    from fps_tpu_torch.parallel.mesh import default_mesh_shape, make_ps_mesh
    from fps_tpu_torch.tiering.probe import lowered_plan_text

    nd, ns = default_mesh_shape(LOWER_DEVICES)
    mesh = make_ps_mesh(num_shards=ns, num_data=nd, device=device)
    specs = {name: TableSpec(name, num_ids, dim)
             for name, num_ids, dim in tables}

    def profile(plans_arg, E):
        text = lowered_plan_text(mesh, specs, plans_arg, hot_sync_every=E)
        prof = collective_profile(text)
        return {"collectives": len(prof),
                "bytes": sum(c.payload_bytes for c in prof)}

    return {"predicted": profile(plans, hot_sync_every),
            "untiered_baseline": profile({}, 1),
            "mesh": dict(mesh.shape)}


def main(argv=None) -> int:
    args = _build_parser().parse_args(argv)

    import numpy as np

    planner = _planner()
    counts_by_name = {}
    if args.counts:
        with np.load(args.counts) as z:
            counts_by_name = {k: z[k].copy() for k in z.files}
    densities = []
    for name, num_ids, dim in args.table:
        if name in counts_by_name:
            c = np.asarray(counts_by_name[name], np.float64)
            if c.shape != (num_ids,):
                raise SystemExit(
                    f"--counts[{name}] shape {c.shape} != ({num_ids},)")
        else:
            c = 1.0 / np.arange(1, num_ids + 1) ** args.alpha
        densities.append(planner.TableDensity(name, num_ids, dim, c))
    plans = planner.plan_tables(
        densities,
        batch_rows_per_step=args.batch_rows,
        replica_budget_bytes=int(args.replica_budget_mb * (1 << 20)),
        coverage_target=args.coverage,
        max_sync_every=args.max_sync_every,
        num_shards=args.shards,
        num_workers=args.workers,
    )

    out = {"plan": {n: p.to_json() for n, p in sorted(plans.items())},
           "hot_sync_every": planner.global_sync_every(plans)}
    if not args.json:
        for name, p in sorted(plans.items()):
            print(f"{name}: hot_tier={p.hot_tier} "
                  f"hot_sync_every={p.hot_sync_every} dense={p.dense} "
                  f"cold_budget={p.cold_budget} "
                  f"coverage={p.coverage:.3f}\n    [{p.reason}]",
                  file=sys.stderr)

    if not args.no_lower:
        import torch

        device = args.device
        if device is None:
            if not torch.cuda.is_available():
                print("plan: CUDA is not available and no --device was "
                      "given; lowering runs on the card (or pass "
                      "--no-lower)", file=sys.stderr)
                return 2
            device = "cuda:0"
        out.update(lower(args.table, plans, out["hot_sync_every"], device))
        if not args.json:
            print(f"predicted per-chunk collective budget: "
                  f"{out['predicted']['collectives']} collectives, "
                  f"{out['predicted']['bytes']} bytes "
                  f"(untiered baseline: "
                  f"{out['untiered_baseline']['collectives']} / "
                  f"{out['untiered_baseline']['bytes']})",
                  file=sys.stderr)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
