"""Chaos sweep: run the fault-injector matrix end to end and print a
one-line survival digest (compact JSON).

Port of ``tools/chaos_sweep.py``: the same 34 scenarios in the same order,
the same flags (``--only``, ``--list``, ``--timeout-s``,
``--recovery-slo-s``, ``--shard``), the same time-to-recovered SLO gates
and the same digest keys, over the port's harness:

* the seven in-process scenarios (``nan_mask``, ``inf_mask``,
  ``huge_norm_mask``, ``observe_rollback``, ``ckpt_truncate``,
  ``ckpt_bitflip``, ``tmp_sweep``) train the tiny logistic regression of
  :mod:`fps_tpu_torch.testing.workloads` on an 8-position mesh ``(1, 8)``
  and inject through :mod:`fps_tpu_torch.testing.chaos`;
* every other scenario is the function of the same name in
  :mod:`fps_tpu_torch.testing.supervised_demo` or
  :mod:`fps_tpu_torch.testing.tenant_demo`, run in a fresh temporary
  directory with the sweep's device (its training children run there).

It runs on the card unless ``--device`` names another device (``--device
cpu`` on the CPU, as the tests do; the card's 8 positions share it); with
no CUDA and no ``--device`` it exits non-zero. The digest adds one key to
the reference's, ``device``: the device the scenarios ran on.

The program certificate rides the full sweep and any shard that builds the
harness: :func:`fps_tpu_torch.analysis.certify` over the record of the
clean run's per-chunk program (``Trainer.lowered_chunk_text``), pinned to
the port's own census of the logistic-regression route (the ``logreg`` row
of ``fps_tpu_torch/examples/audit_programs.py``'s ``BUDGETS``, counts
exact). A change of the program's collectives fails the sweep even when
every scenario survives.

``--timeout-s`` bounds each scenario by SIGALRM: a blocked subprocess wait
unwinds, but a CUDA call blocking in C is interrupted only at its next
bytecode, so the in-process scenarios stay small.

Run:
  python -m fps_tpu_torch.examples.chaos_sweep [--device cpu] [--list]
      [--only nan_mask,pod_*] [--shard K/N] [--timeout-s S]
      [--recovery-slo-s S]
"""

from __future__ import annotations

import glob
import json
import os
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if __name__ == "__main__" and _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)


# -- time-to-recovered SLOs ------------------------------------------------
# Seconds from the fault landing to the injected plane demonstrably
# recovered (the scenarios' own ``time_to_recovered_s`` measurement).
# A scenario that RECOVERS but recovers late is a failure: surviving a
# brownout by spending three minutes down is an outage with extra
# steps. The default is deliberately generous — CPU CI pays compiles
# and subprocess spawns a TPU pod never would — and per-scenario
# overrides loosen it further where recovery legitimately includes
# multi-child restarts or whole-tenant replays. ``--recovery-slo-s``
# rescales the default without touching the override ratios.
RECOVERY_SLO_DEFAULT_S = 60.0
RECOVERY_SLO_OVERRIDES_S = {
    # Pod-coordinated restarts: leader re-election + every member
    # replaying from the common verified step (N children, N compiles).
    "pod_kill_one_host": 120.0,
    "pod_partition_coordinator": 120.0,
    # Tenant scenarios restart/replay a whole tenant namespace (its own
    # supervisor, checkpoints, and serving reader) beside a healthy one.
    "tenant_enospc_brownout": 120.0,
    "tenant_reader_wedge": 120.0,
}


def recovery_slo_for(name: str, default_s: float | None = None) -> float:
    base = (RECOVERY_SLO_DEFAULT_S if default_s is None
            else float(default_s))
    scale = base / RECOVERY_SLO_DEFAULT_S
    return RECOVERY_SLO_OVERRIDES_S.get(name, RECOVERY_SLO_DEFAULT_S) * scale


# The subprocess scenarios, in the reference's order after the seven
# in-process ones: (name, module under fps_tpu_torch.testing, function).
_SUBPROCESS = (
    ("supervised", "supervised_demo", "run_supervised_scenario"),
    ("prefetch_kill", "supervised_demo", "run_prefetch_kill_scenario"),
    ("hot_tier_kill", "supervised_demo", "run_hot_tier_kill_scenario"),
    ("retier_kill", "supervised_demo", "run_retier_kill_scenario"),
    ("megastep_kill", "supervised_demo", "run_megastep_kill_scenario"),
    ("reconcile_shard_kill", "supervised_demo",
     "run_reconcile_shard_kill_scenario"),
    ("serve_while_train", "supervised_demo",
     "run_serve_while_train_scenario"),
    # Delta-snapshot chains and the step-fenced serving fleet.
    ("delta_chain_kill", "supervised_demo", "run_delta_chain_kill_scenario"),
    ("fleet_fence", "supervised_demo", "run_fleet_fence_scenario"),
    # Pods (fps_tpu_torch.supervise.pod): N member agents over one shared
    # pod dir, one failure domain.
    ("pod_kill_one_host", "supervised_demo",
     "run_pod_kill_one_host_scenario"),
    ("pod_partition_coordinator", "supervised_demo",
     "run_pod_partition_coordinator_scenario"),
    ("pod_flapping_member", "supervised_demo",
     "run_pod_flapping_member_scenario"),
    ("pod_elastic_resize", "supervised_demo",
     "run_pod_elastic_resize_scenario"),
    # A hostile filesystem (testing/faultfs.py, core/retry.py): training,
    # compaction, the fleet and the pod lease degrade, never crash or
    # wedge, and recover bit-identically.
    ("storage_brownout", "supervised_demo", "run_storage_brownout_scenario"),
    ("storage_blackout_recover", "supervised_demo",
     "run_storage_blackout_recover_scenario"),
    ("enospc_compaction", "supervised_demo",
     "run_enospc_compaction_scenario"),
    ("slow_lease_near_ttl", "supervised_demo",
     "run_slow_lease_near_ttl_scenario"),
    # A hostile network (serve/wire.py, testing/faultnet.py): no torn frame
    # decoded, reconnects deduped, deadlines bound every request.
    ("net_torn_frames", "supervised_demo", "run_net_torn_frames_scenario"),
    ("net_reconnect_storm", "supervised_demo",
     "run_net_reconnect_storm_scenario"),
    ("net_slow_peer", "supervised_demo", "run_net_slow_peer_scenario"),
    ("net_partition_reader", "supervised_demo",
     "run_net_partition_reader_scenario"),
    # The batched read plane: multi-lookup frames, admission, autoscaling.
    ("serve_batch_storm", "supervised_demo", "run_serve_batch_storm_scenario"),
    ("autoscale_reader_churn", "supervised_demo",
     "run_autoscale_reader_churn_scenario"),
    # Multi-tenant blast radius (fps_tpu_torch.tenancy): every tenant not
    # injected finishes bit-identical to its solo run, audit clean.
    ("tenant_poison_isolation", "tenant_demo",
     "run_tenant_poison_isolation_scenario"),
    ("tenant_enospc_brownout", "tenant_demo",
     "run_tenant_enospc_brownout_scenario"),
    ("tenant_reader_wedge", "tenant_demo", "run_tenant_reader_wedge_scenario"),
    ("tenant_noisy_neighbor", "tenant_demo",
     "run_tenant_noisy_neighbor_scenario"),
)

# Scenarios that need the shared in-process logreg harness (mesh, chunk
# stream, clean-run accuracy); everything else runs pure subprocesses.
_NEEDS_HARNESS = ("nan_mask", "inf_mask", "huge_norm_mask",
                  "observe_rollback", "ckpt_truncate", "ckpt_bitflip",
                  "tmp_sweep")

# The harness mesh: the reference's 8 CPU devices, 8 positions here on
# either device.
HARNESS_MESH = (1, 8)


def _finite(store):
    import numpy as np

    from fps_tpu_torch.testing.workloads import weights

    return bool(np.all(np.isfinite(weights(store))))


def program_certificate(trainer, chunks) -> dict:
    """Certify the per-chunk program the sweep's scenarios run and return
    the certificate JSON for the digest: a change of collective structure
    (an extra exchange, a lost route, a host read) shows up next to the
    survival booleans, even when every scenario survives. The collective
    counts are pinned exactly to the ``logreg`` row of the audit's
    ``BUDGETS`` (counts, not bytes: payload scales with the harness)."""
    import dataclasses

    from fps_tpu_torch.analysis import certify, contract_for_trainer
    from fps_tpu_torch.examples.audit_programs import BUDGETS

    row = BUDGETS["logreg"]
    contract = dataclasses.replace(
        contract_for_trainer(trainer, "sync"),
        max_collectives=row["max_collectives"],
        per_kind_max=dict(row["per_kind_max"]),
        exact_collectives=True,
    )
    text = trainer.lowered_chunk_text(chunks[0], "sync")
    return certify(text, contract, program="chaos/logreg").to_json()


def _health_totals(metrics, tables=("weights",)):
    """Per-table health-counter totals over a run's metrics list — the
    digest's evidence that the guard actually saw the poison."""
    from fps_tpu_torch.testing.workloads import health_sum

    return {
        t: {kind: health_sum(metrics, t, kind)
            for kind in ("nonfinite", "norm", "masked")}
        for t in tables
    }


def poison_scenario(mesh, chunks, test, acc_clean, kind):
    from fps_tpu_torch.core.resilience import GuardConfig
    from fps_tpu_torch.testing import chaos
    from fps_tpu_torch.testing.workloads import accuracy, health_sum, run_logreg

    poisoned = list(chaos.poison_chunks(iter(chunks), chunk_index=1,
                                        column="feat_vals", kind=kind,
                                        frac=0.5, seed=1))
    guard = (GuardConfig(mode="mask", norm_limit=100.0)
             if kind == "huge" else GuardConfig(mode="mask"))
    _, store, m = run_logreg(mesh, poisoned, guard=guard)
    tier = "norm" if kind == "huge" else "nonfinite"
    ok = (_finite(store) and health_sum(m, "weights", tier) > 0
          and abs(accuracy(store, test) - acc_clean) < 0.05)
    return ok, {"health": _health_totals(m)}


def rollback_scenario(mesh, chunks):
    from fps_tpu_torch.core.resilience import RollbackPolicy
    from fps_tpu_torch.testing import chaos
    from fps_tpu_torch.testing.workloads import run_logreg

    poisoned = list(chaos.poison_chunks(iter(chunks), chunk_index=1,
                                        column="feat_vals", kind="nan",
                                        frac=0.5, seed=1))
    policy = RollbackPolicy()
    _, store, m = run_logreg(mesh, poisoned, guard="observe",
                             rollback=policy)
    ok = _finite(store) and policy.quarantined == [1]
    # Quarantined chunks contribute no metrics entry, so the health totals
    # here cover only the SURVIVING chunks (expected all-zero under
    # observe+rollback — the poison was dropped whole).
    return ok, {"health": _health_totals(m),
                "quarantined": list(policy.quarantined),
                "rollback_budget": policy.max_rollbacks}


def ckpt_scenario(tmpdir, mesh, chunks, mode):
    import numpy as np

    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.models.logistic_regression import (
        LogRegConfig,
        logistic_regression,
    )
    from fps_tpu_torch.testing import chaos
    from fps_tpu_torch.testing.workloads import NF, weights

    cfg = LogRegConfig(num_features=NF, learning_rate=0.5)
    trainer, store = logistic_regression(mesh, cfg)
    tables, ls = trainer.init_state(0)
    ckpt = Checkpointer(tmpdir, keep=2)
    for i, c in enumerate(chunks[:2]):
        tables, ls, _ = trainer.run_chunk(tables, ls, c, i)
        ckpt.save(i + 1, store, None)
    want = weights(store).copy()
    if mode == "tmp_sweep":
        import time

        torn = os.path.join(tmpdir, "torn.tmp.npz")
        with open(torn, "wb") as f:
            f.write(b"PK\x03\x04x")
        past = time.time() - 2 * Checkpointer.TMP_SWEEP_AGE_S
        os.utime(torn, (past, past))  # crash leftover, not a live writer
        ckpt2 = Checkpointer(tmpdir, keep=2)
        _, step = ckpt2.restore_tables(store)
        return (step == 2 and not glob.glob(tmpdir + "/*.tmp.npz")
                and np.array_equal(weights(store), want))
    chaos.corrupt_latest_snapshot(tmpdir, mode)
    ok = Checkpointer(tmpdir, keep=2).latest_valid_step() == 1
    _, step = ckpt.restore_tables(store)
    return ok and step == 1 and _finite(store)


def _subprocess_scenario(fn_name, module, device):
    """A scenario that lives in a testing module and runs whole child
    processes: imported lazily, run in a fresh temporary directory, handed
    the sweep's device where it trains (the serving and lease scenarios
    take none)."""
    import tempfile

    def run(_harness):
        import importlib
        import inspect

        demo = importlib.import_module(f"fps_tpu_torch.testing.{module}")
        fn = getattr(demo, fn_name)
        kw = ({"device": device}
              if "device" in inspect.signature(fn).parameters else {})
        with tempfile.TemporaryDirectory() as d:
            return fn(d, **kw)

    return run


def _harness_scenarios(device: str | None = None):
    """Scenario registry: name -> callable(harness) -> (ok, detail|None).
    The in-process scenarios share one lazily-built logreg harness; the
    subprocess ones need none of it."""
    import tempfile

    def ckpt(mode):
        def run(h):
            with tempfile.TemporaryDirectory() as d:
                return ckpt_scenario(d, h["mesh"], h["chunks"], mode), None

        return run

    def poison(kind):
        return lambda h: poison_scenario(h["mesh"], h["chunks"], h["test"],
                                         h["acc_clean"], kind)

    scenarios = {
        "nan_mask": poison("nan"),
        "inf_mask": poison("inf"),
        "huge_norm_mask": poison("huge"),
        "observe_rollback": lambda h: rollback_scenario(h["mesh"],
                                                        h["chunks"]),
        "ckpt_truncate": ckpt("truncate"),
        "ckpt_bitflip": ckpt("bitflip"),
        "tmp_sweep": ckpt("tmp_sweep"),
    }
    for name, module, fn_name in _SUBPROCESS:
        scenarios[name] = _subprocess_scenario(fn_name, module, device)
    return scenarios


def build_harness(device: str):
    """The shared in-process harness on ``device``: the mesh, the held-out
    split, the chunk stream and the clean run's trainer and accuracy."""
    from fps_tpu_torch.parallel.mesh import make_ps_mesh, num_workers_of
    from fps_tpu_torch.testing.workloads import (
        accuracy,
        logreg_chunks,
        logreg_data,
        run_logreg,
    )

    mesh = make_ps_mesh(num_shards=HARNESS_MESH[1],
                        num_data=HARNESS_MESH[0], device=device)
    train, test = logreg_data()
    chunks = logreg_chunks(train, num_workers_of(mesh), epochs=2)
    trainer_clean, store_clean, _ = run_logreg(mesh, chunks)
    return {"mesh": mesh, "test": test, "chunks": chunks,
            "acc_clean": accuracy(store_clean, test),
            "trainer": trainer_clean}


class _ScenarioTimeout(BaseException):
    """A scenario overran --timeout-s (raised from the SIGALRM handler
    so even a blocked subprocess wait unwinds). BaseException — the
    KeyboardInterrupt pattern — so a scenario's own broad `except
    Exception` recovery paths cannot swallow the timeout and leave the
    sweep unbounded with a disarmed timer."""


def _run_bounded(fn, harness, timeout_s: float):
    """Run one scenario under a wall-clock bound. SIGALRM (not a
    thread) so a scenario wedged inside a blocking syscall — the exact
    failure mode the flag exists for — is interrupted; 0 disables.
    Children a timed-out scenario leaks are the price of failing
    loudly instead of hanging CI."""
    if timeout_s <= 0:
        return fn(harness)
    import signal

    def on_alarm(_sig, _frame):
        raise _ScenarioTimeout()

    old = signal.signal(signal.SIGALRM, on_alarm)
    signal.setitimer(signal.ITIMER_REAL, timeout_s)
    try:
        return fn(harness)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0.0)
        signal.signal(signal.SIGALRM, old)


def _select(ap, scenarios, only, shard):
    """The names ``--only`` and ``--shard`` pick, in ``--list`` order."""
    import fnmatch

    selected = [s for arg in only for s in arg.split(",") if s]
    # Each --only entry may be an exact name or an fnmatch glob
    # (e.g. 'tenant_*', 'pod_*') — a pattern matching nothing is a
    # typo and fails loudly, same as an unknown exact name.
    unknown = sorted(pat for pat in selected
                     if not fnmatch.filter(scenarios, pat))
    if unknown:
        ap.error(f"unknown scenario(s)/pattern(s) {unknown}; "
                 f"known: {sorted(scenarios)}")
    names = [n for n in scenarios
             if not selected
             or any(fnmatch.fnmatch(n, pat) for pat in selected)]
    if shard:
        try:
            k, n_shards = (int(x) for x in shard.split("/"))
        except ValueError:
            ap.error(f"--shard wants K/N (e.g. 2/4), got {shard!r}")
        if not 1 <= k <= n_shards:
            ap.error(f"--shard K must be in [1, N], got {shard!r}")
        names = [nm for i, nm in enumerate(names)
                 if i % n_shards == k - 1]
    return selected, names


def _enforce_slo(detail, results, recovery_slo_s):
    """Time-to-recovered SLO: a scenario whose measured recovery latency
    overruns its bound fails even though it recovered — late recovery is
    an outage with extra steps. Returns ``(enforced, breaches)`` and
    flips each breaching scenario in ``results`` to failed."""
    slo_enforced = recovery_slo_s is None or recovery_slo_s > 0
    slo_breaches = {}
    if slo_enforced:
        for n, d in detail.items():
            t = (d.get("time_to_recovered_s")
                 if isinstance(d, dict) else None)
            if t is None:
                continue
            bound = recovery_slo_for(n, recovery_slo_s)
            if float(t) > bound:
                slo_breaches[n] = {"time_to_recovered_s": float(t),
                                   "slo_s": bound}
                results[n] = False
                print(f"chaos_sweep: scenario {n} recovered in "
                      f"{float(t):.1f}s, over its {bound:.1f}s SLO",
                      file=sys.stderr, flush=True)
    return slo_enforced, slo_breaches


def main(argv=None):
    import argparse

    ap = argparse.ArgumentParser(
        description="fps_tpu_torch chaos sweep: run the fault-injector "
                    "matrix and print a one-line survival digest")
    names_known = list(_harness_scenarios())
    ap.add_argument("--only", action="append", default=[],
                    metavar="SCENARIO[,SCENARIO...]",
                    help="run only these scenarios (repeatable / "
                         "comma-separated; fnmatch globs like "
                         "'tenant_*' work) — lets CI shard the sweep; "
                         f"known: {', '.join(names_known)}")
    ap.add_argument("--list", action="store_true",
                    help="print registered scenario names (one per "
                         "line) and exit — CI shards build their "
                         "--only sets from this instead of hardcoding")
    ap.add_argument("--timeout-s", type=float, default=0.0,
                    help="per-scenario wall-clock bound (0 = none): a "
                         "wedged scenario fails LOUDLY under its own "
                         "name instead of hanging the whole sweep "
                         "(SIGALRM-interrupted, so even a blocked "
                         "subprocess wait is bounded)")
    ap.add_argument("--recovery-slo-s", type=float, default=None,
                    metavar="S",
                    help="rescale the time-to-recovered SLO default "
                         f"(normally {RECOVERY_SLO_DEFAULT_S:.0f}s; "
                         "per-scenario overrides scale with it; 0 "
                         "disables SLO enforcement): a scenario that "
                         "recovers but recovers LATE fails the sweep "
                         "under its own name")
    ap.add_argument("--shard", default=None, metavar="K/N",
                    help="run shard K of N (1-based) over the --list "
                         "order, after --only filtering — CI splits "
                         "the sweep across jobs without hardcoding "
                         "scenario names")
    ap.add_argument("--device", default=None,
                    help="where the harness and the scenarios' children "
                         "train (default: the card, cuda:0; 'cpu' for "
                         "the tests)")
    args = ap.parse_args(argv)
    if args.list:
        for name in names_known:
            print(name)
        return 0
    selected, names = _select(ap, names_known, args.only, args.shard)

    import torch

    if args.device is None:
        if not torch.cuda.is_available():
            print("chaos_sweep: CUDA is not available and no --device was "
                  "given; the sweep runs on the card", file=sys.stderr)
            return 2
        args.device = "cuda:0"
    device = str(torch.device(args.device))
    if device.startswith("cuda"):
        from fps_tpu_torch.ops import _build

        torch.backends.cuda.matmul.allow_tf32 = False
        # Built once here, before any child starts: the children only load
        # it (a child killed inside nvcc would leave temporary objects).
        _build.library()
    scenarios = _harness_scenarios(device)

    harness = None
    certificate = None
    if any(n in _NEEDS_HARNESS for n in names) or (not selected
                                                   and not args.shard):
        harness = build_harness(device)
        # The certificate rides the full sweep (and any shard that
        # builds the harness anyway): a collective-structure regression
        # fails the sweep even when every scenario survives.
        certificate = program_certificate(harness["trainer"],
                                          harness["chunks"])

    results = {}
    detail = {}
    for name in names:
        try:
            out = _run_bounded(scenarios[name], harness, args.timeout_s)
        except _ScenarioTimeout:
            # The loud-failure contract: the wedged scenario is NAMED
            # in the digest and on stderr; the sweep moves on.
            print(f"chaos_sweep: scenario {name} timed out after "
                  f"{args.timeout_s}s", file=sys.stderr, flush=True)
            results[name] = False
            detail[name] = {"error": "timeout",
                            "timeout_s": args.timeout_s}
            continue
        ok, d = out if isinstance(out, tuple) else (out, None)
        results[name] = bool(ok)
        if d is not None:
            detail[name] = d

    # Enforced here (not inside the scenarios) so the bounds stay in one
    # place and obs_report can read breaches off the digest.
    slo_enforced, slo_breaches = _enforce_slo(detail, results,
                                              args.recovery_slo_s)
    failed = sorted(n for n, ok in results.items() if not ok)
    cert_ok = certificate is None or certificate["ok"]
    recovering = [n for n, d in detail.items()
                  if isinstance(d, dict) and "time_to_recovered_s" in d]
    digest = {
        "chaos_sweep": results,
        "survived": sum(results.values()),
        "total": len(results),
        # The names CI wants on a red run — also printed to stderr.
        "failed": failed,
        # Per-scenario evidence: per-table health-counter totals and the
        # rollback/quarantine record.
        "detail": detail,
        # The recorded program's contract certificate
        # (fps_tpu_torch.analysis).
        "program_certificate": certificate,
        # Fleet rollup + SLO burn over the pod scenario's member obs dirs
        # (computed inside the scenario before its tempdir is collected).
        "fleet": (detail.get("pod_kill_one_host") or {}).get("fleet"),
        # Per-scenario recovery latency and the multi-tenant scenarios'
        # post-run namespace-audit verdicts.
        "time_to_recovered_s": {n: detail[n].get("time_to_recovered_s")
                                for n in recovering},
        # The SLO verdicts next to the measurements: the bound every
        # recovering scenario was held to and the ones that overran it
        # (breaches also flip the scenario into `failed`).
        "recovery_slo": {
            "default_s": (args.recovery_slo_s
                          if slo_enforced and args.recovery_slo_s
                          else RECOVERY_SLO_DEFAULT_S),
            "enforced": slo_enforced,
            "bounds_s": {
                n: recovery_slo_for(
                    n, args.recovery_slo_s if slo_enforced else None)
                for n in recovering},
            "breaches": slo_breaches,
        },
        "namespace_audit": {
            n: d.get("namespace_audit")
            for n, d in detail.items()
            if isinstance(d, dict) and "namespace_audit" in d},
        "clean_test_acc": (round(harness["acc_clean"], 4)
                           if harness else None),
        # The port's key: the device the harness and the children ran on.
        "device": device,
    }
    if harness:
        digest["mesh"] = dict(harness["mesh"].shape)
    print(json.dumps(digest), flush=True)
    if failed or not cert_ok:
        blame = list(failed) + ([] if cert_ok else ["program_certificate"])
        print(f"chaos_sweep: FAILED scenarios: {', '.join(blame)}",
              file=sys.stderr, flush=True)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
