"""Multi-tenant blast-radius scenarios: the tenancy plane's proof.

Port of ``fps_tpu/testing/tenant_demo.py``. Every scenario runs M model
instances on one fleet through :class:`fps_tpu_torch.tenancy.TenantManager`
(or, for the in-process serving leg, two
:class:`~fps_tpu_torch.tenancy.paths.TenantPaths` namespaces side by
side), injects a fault into EXACTLY ONE tenant, and then proves the blast
radius held:

* every non-injected tenant finishes **bit-identical to its solo run**
  (the same workload run alone, no neighbours);
* :func:`fps_tpu_torch.tenancy.audit.audit_namespaces` finds ZERO files
  outside the declared tenant namespaces;
* where the injected tenant recovers through supervisor restarts, its
  ``time_to_recovered_s`` comes from its OWN supervisor journal
  (:func:`fps_tpu_torch.supervise.supervisor.recovery_times`).

The workload is :mod:`fps_tpu_torch.testing.supervised_demo`'s tiny
logistic-regression child. Each ``run_*_scenario(tmpdir, ...)`` returns
``(ok, detail)``; the children run on ``device`` (default: the card) and
``demo_args`` widen their workload (the card's run passes
``--num-features 1000000``). The manager and the supervisors it drives
run in a process of their own with torch and jax unimportable
(:mod:`fps_tpu_torch.tenancy` is stdlib-only and loads by path); the
calling process only reads the tenants' namespaces.
"""

from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys

from fps_tpu_torch.testing import supervised_demo as sd

_ROOT = sd._ROOT

# Tenant names used by every scenario: ``a`` is ALWAYS the injected
# tenant, ``b`` the innocent neighbour whose bit identity is the verdict.
TENANT_INJECTED = "a"
TENANT_NEIGHBOR = "b"
SCENARIO_TENANT_CRASH_AT = 3
# ENOSPC brownout schedule for tenant a's snapshot plane: occurrences
# 2..9 of (snapshot, write) fail, long enough to exhaust the retry budget
# (4 attempts a publish) at least once, short enough to recover.
SCENARIO_TENANT_ENOSPC_START = 2
SCENARIO_TENANT_ENOSPC_COUNT = 8
# Noisy-neighbour planner profile: a feature table big enough that the
# demo's --hot-tier row counts derived from the plan are meaningful.
SCENARIO_TENANT_NN_NF = 4096
SCENARIO_TENANT_NN_DIM = 4
SCENARIO_TENANT_NN_BUDGET = 48 * 1024


# The manager's process: loads fps_tpu_torch/tenancy/manager.py by path
# with torch and jax unimportable, runs the job file's specs and prints
# the digests.
_MANAGER_SRC = """\
import importlib.util, json, sys
sys.modules["torch"] = None
sys.modules["jax"] = None
spec = importlib.util.spec_from_file_location("_fps_torch_tenant_manager",
                                              sys.argv[1])
mod = importlib.util.module_from_spec(spec)
sys.modules[spec.name] = mod
spec.loader.exec_module(mod)
with open(sys.argv[2], encoding="utf-8") as f:
    job = json.load(f)
mgr = mod.TenantManager(job["root"],
                        [mod.TenantSpec(**s) for s in job["specs"]],
                        config=mod._sup.SupervisorConfig(**job["config"]),
                        base_env=job["base_env"])
print(json.dumps(mgr.run()), flush=True)
"""
MANAGER = os.path.join(_ROOT, "fps_tpu_torch", "tenancy", "manager.py")


def run_manager(mgr, *, timeout: float) -> dict:
    """``mgr.run()`` in a process of its own, torch and jax unimportable:
    ``{name: digest}``. At ``timeout`` the manager and every attempt its
    supervisors started are killed, and each digest records the
    failure."""
    job = os.path.join(os.path.dirname(os.path.abspath(mgr.root)),
                       os.path.basename(mgr.root) + "_job.json")
    os.makedirs(os.path.dirname(job), exist_ok=True)
    with open(job, "w", encoding="utf-8") as f:
        json.dump({"root": mgr.root, "base_env": mgr.base_env,
                   "config": dataclasses.asdict(mgr.config),
                   "specs": [dataclasses.asdict(s)
                             for s in mgr.specs.values()]}, f)
    proc = subprocess.Popen([sys.executable, "-c", _MANAGER_SRC, MANAGER,
                             job], env=mgr.base_env, cwd=_ROOT,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        for tp in mgr.paths.values():
            sd.kill_attempts(tp.state_dir)
        return {n: {"success": False, "error": "manager timed out"}
                for n in mgr.specs}
    try:
        return json.loads(out.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return {n: {"success": False, "error": "no manager digest",
                    "tail": (out + err)[-2000:]} for n in mgr.specs}


def _demo_cmd(*extra, device=None, demo_args=()):
    """The per-tenant child argv template: the standard scenario workload
    with the namespace placeholders the TenantManager resolves."""
    return tuple(sd.demo_cmd(*sd.SCENARIO_DEMO_ARGS, *demo_args,
                             "--ckpt-dir", "{ckpt}", "--out", "{out}",
                             "--obs-dir", "{obs}", *extra, device=device))


def _start_solo(tmpdir: str, tag: str, *extra, device=None, demo_args=()):
    """Start the bit-identity reference in the background: the same
    workload run ALONE, outside any tenant namespace, beside the tenants
    (it shares nothing with them but the device)."""
    return sd._start_straight(
        tmpdir, sd.demo_cmd(*sd.SCENARIO_DEMO_ARGS, *demo_args, *extra,
                            device=device),
        f"solo_{tag}", env=sd._env(device))


def _manager(root: str, specs, *, device=None, stall_timeout_s=60.0,
             startup_grace_s=300.0):
    from fps_tpu_torch.supervise.supervisor import SupervisorConfig
    from fps_tpu_torch.tenancy import TenantManager

    return TenantManager(
        root, specs,
        config=SupervisorConfig(
            stall_timeout_s=stall_timeout_s, startup_grace_s=startup_grace_s,
            term_grace_s=2.0, backoff_base_s=0.2, max_restarts=2,
            poll_interval_s=0.2),
        base_env=sd._env(device))


def _tenant_out_meta(mgr, name: str) -> dict:
    return sd._read_json(mgr.paths[name].out_path + ".meta.json")


def _children(mgr, name: str) -> dict:
    """A tenant's attempts' ``demo_start`` lines and its final meta."""
    return {"attempt_starts": sd.attempt_starts(mgr.paths[name].state_dir),
            "meta": _tenant_out_meta(mgr, name)}


def _recovery(journal_path: str) -> dict:
    """Recovery-time evidence from a tenant's OWN supervisor journal;
    ``time_to_recovered_s`` is the slowest recovery."""
    from fps_tpu_torch.supervise.supervisor import recovery_times

    times = recovery_times(journal_path)
    return {"count": len(times),
            "times_s": [round(t, 3) for t in times],
            "time_to_recovered_s": (round(max(times), 3)
                                    if times else None)}


def _audit(root: str) -> dict:
    from fps_tpu_torch.tenancy import audit_namespaces

    return audit_namespaces(root, [TENANT_INJECTED, TENANT_NEIGHBOR])


def run_tenant_poison_isolation_scenario(tmpdir: str, *,
                                         timeout: float = 600,
                                         device: str | None = None,
                                         demo_args=(),
                                         stall_timeout_s: float = 60.0,
                                         startup_grace_s: float = 300.0):
    """Tenant ``a``'s child crashes at the same chunk on every attempt
    (the poison-batch flap) while tenant ``b`` trains the identical
    workload beside it. The contract:

    * ``a``'s OWN supervisor converges: crash, crash, quarantine the chunk,
      and the third attempt completes skipping it (2 restarts, the index
      in ``a``'s digest and out-meta);
    * ``b`` is UNTOUCHED: no restart, nothing quarantined, and its final
      weights BIT-IDENTICAL to its solo run;
    * both fencing epochs stay at their seeded value 1;
    * the namespace audit finds no cross-tenant write;
    * ``a``'s recovery times come from ``a``'s own journal.
    """
    from fps_tpu_torch.tenancy import TenantSpec

    solo = _start_solo(tmpdir, TENANT_NEIGHBOR, device=device,
                       demo_args=demo_args)
    root = os.path.join(tmpdir, "pod")
    kw = dict(device=device, demo_args=demo_args)
    mgr = _manager(root, [
        TenantSpec(TENANT_INJECTED,
                   _demo_cmd("--crash-at", str(SCENARIO_TENANT_CRASH_AT),
                             **kw)),
        TenantSpec(TENANT_NEIGHBOR, _demo_cmd(**kw)),
    ], device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    digests = run_manager(mgr, timeout=timeout)
    solo_out, solo_meta, err = sd._finish_straight(solo, timeout)
    if err is not None:
        return False, err
    da = digests[TENANT_INJECTED]
    db = digests[TENANT_NEIGHBOR]
    meta_a = _tenant_out_meta(mgr, TENANT_INJECTED)
    recovery = _recovery(mgr.journal_path(TENANT_INJECTED))
    neighbor_recovery = _recovery(mgr.journal_path(TENANT_NEIGHBOR))
    audit = _audit(root)
    bit_identical = sd._weights_equal(
        solo_out, mgr.paths[TENANT_NEIGHBOR].out_path)
    detail = {
        "injected": {k: da.get(k) for k in
                     ("success", "attempts", "restarts", "quarantined")},
        "injected_skipped": meta_a.get("skipped"),
        "neighbor": {k: db.get(k) for k in
                     ("success", "attempts", "restarts", "quarantined")},
        "neighbor_bit_identical": bit_identical,
        "fence_epochs": {n: mgr.fence_epoch(n)
                         for n in (TENANT_INJECTED, TENANT_NEIGHBOR)},
        "recovery": recovery,
        "time_to_recovered_s": recovery["time_to_recovered_s"],
        "namespace_audit": audit,
        "children": {n: _children(mgr, n)
                     for n in (TENANT_INJECTED, TENANT_NEIGHBOR)},
        "solo_launches": solo_meta.get("launches"),
    }
    ok = (bool(da.get("success")) and da.get("restarts") == 2
          and da.get("quarantined") == [SCENARIO_TENANT_CRASH_AT]
          and meta_a.get("skipped") == [SCENARIO_TENANT_CRASH_AT]
          and bool(db.get("success")) and db.get("restarts") == 0
          and db.get("quarantined") == []
          and neighbor_recovery["count"] == 0
          and detail["fence_epochs"] == {TENANT_INJECTED: 1,
                                         TENANT_NEIGHBOR: 1}
          and recovery["count"] >= 1
          and all(t > 0 for t in recovery["times_s"])
          and audit["clean"]
          and bit_identical)
    return ok, detail


def run_tenant_enospc_brownout_scenario(tmpdir: str, *,
                                        timeout: float = 600,
                                        device: str | None = None,
                                        demo_args=(),
                                        stall_timeout_s: float = 60.0,
                                        startup_grace_s: float = 300.0):
    """ENOSPC brownout CONFINED to one tenant's namespace: tenant ``a``
    carries a deterministic faultfs schedule in its spec env (the ONLY
    injection channel the manager offers) failing a run of its snapshot
    writes with ENOSPC past the retry budget; tenant ``b`` runs fault-free
    beside it. The contract:

    * ``a`` SURVIVES WITHOUT A RESTART: at least one of its publishes
      degrades (``storage.degraded_publishes`` in ``a``'s OWN telemetry)
      and its final weights still equal the fault-free solo run's;
    * ``b`` sees NONE of it: no degraded publish, no restart, weights
      bit-identical to solo;
    * the namespace audit is clean.
    """
    from fps_tpu_torch.obs import fleet as obs_fleet
    from fps_tpu_torch.tenancy import TenantSpec
    from fps_tpu_torch.testing.faultfs import FAULTFS_ENV, FaultFS, FaultRule

    solo = _start_solo(tmpdir, TENANT_NEIGHBOR, device=device,
                       demo_args=demo_args)
    schedule = FaultFS([FaultRule(
        "snapshot", "write", "errno", errno_name="ENOSPC",
        start=SCENARIO_TENANT_ENOSPC_START,
        count=SCENARIO_TENANT_ENOSPC_COUNT)], seed=0)
    root = os.path.join(tmpdir, "pod")
    kw = dict(device=device, demo_args=demo_args)
    mgr = _manager(root, [
        TenantSpec(TENANT_INJECTED, _demo_cmd(**kw),
                   env={FAULTFS_ENV: schedule.to_spec()}),
        TenantSpec(TENANT_NEIGHBOR, _demo_cmd(**kw)),
    ], device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    digests = run_manager(mgr, timeout=timeout)
    solo_out, _, err = sd._finish_straight(solo, timeout)
    if err is not None:
        return False, err
    da = digests[TENANT_INJECTED]
    db = digests[TENANT_NEIGHBOR]

    def _degraded(name):
        roll = obs_fleet.rollup([mgr.paths[name].obs_dir])
        return int(roll.get("totals", {}).get("degraded_publishes", 0))

    degraded_a = _degraded(TENANT_INJECTED)
    degraded_b = _degraded(TENANT_NEIGHBOR)
    audit = _audit(root)
    bit_a = sd._weights_equal(solo_out, mgr.paths[TENANT_INJECTED].out_path)
    bit_b = sd._weights_equal(solo_out, mgr.paths[TENANT_NEIGHBOR].out_path)
    detail = {
        "injected": {k: da.get(k) for k in
                     ("success", "restarts", "quarantined")},
        "neighbor": {k: db.get(k) for k in
                     ("success", "restarts", "quarantined")},
        "degraded_publishes": {TENANT_INJECTED: degraded_a,
                               TENANT_NEIGHBOR: degraded_b},
        "injected_bit_identical": bit_a,
        "neighbor_bit_identical": bit_b,
        "namespace_audit": audit,
        "time_to_recovered_s": None,  # survived in place: no restart
    }
    ok = (bool(da.get("success")) and da.get("restarts") == 0
          and da.get("quarantined") == []
          and bool(db.get("success")) and db.get("restarts") == 0
          and degraded_a >= 1 and degraded_b == 0
          and bit_a and bit_b
          and audit["clean"])
    return ok, detail


def run_tenant_reader_wedge_scenario(tmpdir: str, *, timeout: float = 600,
                                     device: str | None = None):
    """One tenant's WEDGED serving reader restarts without touching its
    neighbour's fences: two tenant namespaces each carry their own
    single-reader fleet (a heartbeating reader child a namespace, torch
    free); tenant ``a``'s reader is SIGSTOPped mid-run, detected wedged
    through ``a``'s OWN liveness beacons, killed and relaunched, and the
    whole episode must be invisible from ``b``'s namespace:

    * ``a``'s wedge is detected within the liveness timeout, and during the
      whole detection window ``b``'s reader never reports wedged;
    * the restarted ``a`` reader catches up to ``a``'s newest publication
      (``time_to_recovered_s``: SIGSTOP to caught up);
    * ``b``'s serve fence file is BYTE-IDENTICAL before and after the
      episode, and ``b``'s later training and serving converge;
    * both tenants' final weights are bit-identical to the clean
      (reader-free) run of the same workload; the audit is clean.

    Training runs in this process on ``device`` (the storage scenarios'
    harness)."""
    import signal
    import time as _time

    import numpy as np

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.serve import liveness_check, scan_heartbeats
    from fps_tpu_torch.serve.fleet import FENCE_NAME
    from fps_tpu_torch.tenancy import TenantPaths
    from fps_tpu_torch.testing.workloads import weights

    LIVENESS = 1.5
    _mesh, chunks, make_trainer = sd._storage_harness(device)

    # Clean arm (no readers, no tenancy): the bit-identity reference.
    trainer, store, tables, ls = make_trainer()
    trainer.fit_stream(tables, ls, iter(chunks), 1)
    want_w = weights(store).copy()

    root = os.path.join(tmpdir, "pod")
    tpa = TenantPaths(root, TENANT_INJECTED).ensure()
    tpb = TenantPaths(root, TENANT_NEIGHBOR).ensure()
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    serve_cli = os.path.join(_ROOT, "fps_tpu_torch", "examples", "serve.py")

    def _reader(ckpt_dir, rid):
        return subprocess.Popen(
            [sys.executable, "-c", sd._READER_LOOP_SRC, ckpt_dir, rid,
             serve_cli], env=env, cwd=_ROOT, stdout=subprocess.DEVNULL,
            stderr=subprocess.DEVNULL)

    def _fence_bytes(ckpt_dir):
        # Raw bytes on purpose: the claim is "this FILE never changed".
        try:
            with open(os.path.join(ckpt_dir, "fleet", FENCE_NAME),  # noqa: FPS006
                      "rb") as f:
                return f.read()
        except OSError:
            return None

    ra = _reader(tpa.ckpt_dir, "ra")
    rb = _reader(tpb.ckpt_dir, "rb")
    try:
        # Both readers must be demonstrably LIVE before any fault lands.
        dl = _time.monotonic() + 60.0
        while _time.monotonic() < dl:
            if (scan_heartbeats(tpa.ckpt_dir).get("ra")
                    and scan_heartbeats(tpb.ckpt_dir).get("rb")):
                break
            _time.sleep(0.05)
        else:
            return False, {"error": "readers never came up"}

        # Train tenant a; SIGSTOP its reader mid-run.
        stopped_at = [None]
        live_before = [None]

        def on_chunk(step, _metrics):
            if step != 4 or stopped_at[0] is not None:
                return
            live_before[0] = liveness_check(
                tpa.ckpt_dir, timeout_s=LIVENESS, expected=["ra"])
            os.kill(ra.pid, signal.SIGSTOP)
            stopped_at[0] = _time.monotonic()

        trainer, store, tables, ls = make_trainer()
        cka = AsyncCheckpointer(tpa.ckpt_dir, keep=len(chunks) + 2)
        tables, ls, _ = trainer.fit_stream(
            tables, ls, iter(chunks), 1, checkpointer=cka,
            checkpoint_every=1, on_chunk=on_chunk)
        cka.flush()
        final_a = cka.latest_valid_step()
        cka.close()
        got_a = weights(store).copy()
        if stopped_at[0] is None:
            return False, {"error": "reader a was never SIGSTOPped"}
        b_fence_before = _fence_bytes(tpb.ckpt_dir)

        # a's wedge becomes an incident in a's OWN beacons; b's reader must
        # never read as wedged while we watch.
        wedged_at = None
        neighbor_false_positives = []
        dl = _time.monotonic() + min(timeout, 60.0)
        while _time.monotonic() < dl:
            live_b = liveness_check(tpb.ckpt_dir, timeout_s=LIVENESS,
                                    expected=["rb"])
            if live_b["wedged"]:
                neighbor_false_positives.append(live_b)
            live_a = liveness_check(tpa.ckpt_dir, timeout_s=LIVENESS,
                                    expected=["ra"])
            if "ra" in live_a["wedged"]:
                wedged_at = _time.monotonic()
                break
            _time.sleep(0.05)
        if wedged_at is None:
            return False, {"error": "reader_wedged never fired for a",
                           "heartbeats": scan_heartbeats(tpa.ckpt_dir)}
        detect_s = wedged_at - stopped_at[0]

        # Restart a's reader: kill the wedged child, relaunch the same id,
        # the remedy confined to a's namespace.
        ra.kill()
        ra.wait(timeout=10)
        ra = _reader(tpa.ckpt_dir, "ra")
        recovered_at = None
        dl = _time.monotonic() + min(timeout, 60.0)
        while _time.monotonic() < dl:
            live_a = liveness_check(tpa.ckpt_dir, timeout_s=LIVENESS,
                                    expected=["ra"])
            hb = scan_heartbeats(tpa.ckpt_dir).get("ra")
            if ("ra" not in live_a["wedged"] and hb is not None
                    and hb.get("step") == final_a):
                recovered_at = _time.monotonic()
                break
            _time.sleep(0.05)
        if recovered_at is None:
            return False, {"error": "restarted reader a never caught up",
                           "heartbeats": scan_heartbeats(tpa.ckpt_dir)}
        ttr = recovered_at - stopped_at[0]
        b_fence_after = _fence_bytes(tpb.ckpt_dir)

        # b's life goes on: train it now; its reader converges on its own
        # publications.
        trainer, store, tables, ls = make_trainer()
        ckb = AsyncCheckpointer(tpb.ckpt_dir, keep=len(chunks) + 2)
        tables, ls, _ = trainer.fit_stream(
            tables, ls, iter(chunks), 1, checkpointer=ckb,
            checkpoint_every=1)
        ckb.flush()
        final_b = ckb.latest_valid_step()
        ckb.close()
        got_b = weights(store).copy()
        b_caught_up = False
        dl = _time.monotonic() + min(timeout, 60.0)
        while _time.monotonic() < dl:
            hb = scan_heartbeats(tpb.ckpt_dir).get("rb")
            if hb is not None and hb.get("step") == final_b:
                b_caught_up = True
                break
            _time.sleep(0.05)
    finally:
        for child in (ra, rb):
            child.kill()
            child.wait(timeout=10)

    audit = _audit(root)
    detail = {
        "live_before_stop": live_before[0],
        "wedge_detect_s": round(detect_s, 3),
        "time_to_recovered_s": round(ttr, 3),
        "neighbor_false_positives": neighbor_false_positives,
        "neighbor_fence_unchanged": b_fence_before == b_fence_after,
        "neighbor_caught_up": b_caught_up,
        "weights_bit_identical": {
            TENANT_INJECTED: bool(np.array_equal(got_a, want_w)),
            TENANT_NEIGHBOR: bool(np.array_equal(got_b, want_w)),
        },
        "namespace_audit": audit,
    }
    ok = (live_before[0] is not None
          and live_before[0]["wedged"] == []      # no false positive
          and detect_s < 30.0
          and not neighbor_false_positives
          and detail["neighbor_fence_unchanged"]
          and b_caught_up
          and all(detail["weights_bit_identical"].values())
          and audit["clean"])
    return ok, detail


def run_tenant_noisy_neighbor_scenario(tmpdir: str, *,
                                       timeout: float = 600,
                                       device: str | None = None,
                                       stall_timeout_s: float = 60.0,
                                       startup_grace_s: float = 300.0):
    """Noisy-neighbour hot-tier pressure degrades ONLY the over-weight
    tenant. Two legs:

    * **arbitration** (planner arithmetic): tenant ``a``'s flat, huge
      access profile demands more replica budget than its fair share;
      ``b``'s concentrated profile demands far less.
      :func:`~fps_tpu_torch.tiering.planner.plan_tenants` must grant ``b``
      its FULL demand (``b``'s knobs identical to its solo, whole-budget
      plan) while ``a`` is granted less than its demand and lands on a
      smaller hot tier than it would solo;
    * **training** (real children under the manager): both tenants train
      with the knobs the arbitration chose (the demo's ``--hot-tier``,
      ``--hot-sync-every`` and ``--cold-budget``; on the CPU over the
      eight positions the hot tier needs). ``b``'s knobs are its solo
      knobs by construction, so its final weights must be bit-identical
      to its solo run at those knobs; ``a`` (squeezed but functional)
      must finish cleanly. Namespace audit clean.
    """
    import numpy as np

    from fps_tpu_torch.tenancy import TenantSpec
    from fps_tpu_torch.tiering.planner import (
        TableDensity,
        plan_tables,
        plan_tenants,
    )

    nf, dim = SCENARIO_TENANT_NN_NF, SCENARIO_TENANT_NN_DIM
    counts_a = np.full(nf, 5.0)                  # flat: wants ~all rows
    counts_b = np.zeros(nf)
    counts_b[:64] = 1000.0                       # concentrated head
    dens_a = [TableDensity("weights", nf, dim, counts_a)]
    dens_b = [TableDensity("weights", nf, dim, counts_b)]
    total = SCENARIO_TENANT_NN_BUDGET
    # dense_table_bytes=1024 keeps the table out of the replicate-dense
    # fast path, so the coverage-head arbitration is exercised.
    plan_kw = dict(batch_rows_per_step=256, dense_table_bytes=1024)

    solo_a = plan_tables(dens_a, replica_budget_bytes=total,
                         **plan_kw)["weights"]
    solo_b = plan_tables(dens_b, replica_budget_bytes=total,
                         **plan_kw)["weights"]
    multi = plan_tenants(
        {TENANT_INJECTED: dens_a, TENANT_NEIGHBOR: dens_b},
        weights={TENANT_INJECTED: 1.0, TENANT_NEIGHBOR: 1.0},
        total_replica_budget_bytes=total, **plan_kw)
    ma, mb = multi[TENANT_INJECTED], multi[TENANT_NEIGHBOR]
    plan_a, plan_b = ma["plans"]["weights"], mb["plans"]["weights"]
    arbitration_ok = (
        plan_b.knobs() == solo_b.knobs()
        and mb["granted"] == mb["demand"]
        and ma["granted"] < ma["demand"]
        and 0 < plan_a.hot_tier < solo_a.hot_tier)
    arbitration = {
        "demand": {TENANT_INJECTED: ma["demand"],
                   TENANT_NEIGHBOR: mb["demand"]},
        "granted": {TENANT_INJECTED: ma["granted"],
                    TENANT_NEIGHBOR: mb["granted"]},
        "hot_rows": {TENANT_INJECTED: [solo_a.hot_tier, plan_a.hot_tier],
                     TENANT_NEIGHBOR: [solo_b.hot_tier, plan_b.hot_tier]},
    }
    if not arbitration_ok:
        return False, {"error": "arbitration leg failed",
                       "arbitration": arbitration}

    # Training leg: the arbitrated knobs drive real children. b's solo arm
    # runs at the knobs the arbitration granted it (its solo plan), so
    # bit identity is the isolation claim, not luck.
    def _tier_args(plan):
        return ("--num-features", str(nf),
                "--hot-tier", str(plan.hot_tier),
                "--hot-sync-every", str(plan.hot_sync_every),
                "--cold-budget", str(plan.cold_budget),
                *sd._tier_args(device))

    tier_a, tier_b = _tier_args(plan_a), _tier_args(plan_b)
    solo = _start_solo(tmpdir, TENANT_NEIGHBOR, *tier_b, device=device)
    root = os.path.join(tmpdir, "pod")
    mgr = _manager(root, [
        TenantSpec(TENANT_INJECTED, _demo_cmd(*tier_a, device=device),
                   weight=1.0),
        TenantSpec(TENANT_NEIGHBOR, _demo_cmd(*tier_b, device=device),
                   weight=1.0),
    ], device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    digests = run_manager(mgr, timeout=timeout)
    solo_out, _, err = sd._finish_straight(solo, timeout)
    if err is not None:
        return False, err
    da = digests[TENANT_INJECTED]
    db = digests[TENANT_NEIGHBOR]
    audit = _audit(root)
    bit_b = sd._weights_equal(solo_out, mgr.paths[TENANT_NEIGHBOR].out_path)
    detail = {
        "arbitration": arbitration,
        "injected": {k: da.get(k) for k in ("success", "restarts")},
        "neighbor": {k: db.get(k) for k in ("success", "restarts")},
        "neighbor_bit_identical": bit_b,
        "namespace_audit": audit,
        "time_to_recovered_s": None,  # degradation, not an outage
    }
    ok = (arbitration_ok
          and bool(da.get("success")) and da.get("restarts") == 0
          and bool(db.get("success")) and db.get("restarts") == 0
          and bit_b
          and audit["clean"])
    return ok, detail
