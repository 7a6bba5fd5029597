"""The port's tenancy plane (fps_tpu_torch.tenancy and the per-tenant
rollups of fps_tpu_torch/obs/fleet.py) against tests/test_tenancy.py and
against the JAX package's.

Each case of tests/test_tenancy.py has its counterpart here, at tier-1
speed: TenantSpec / TenantPaths / validate_tenant_name / list_tenants /
audit_namespaces; the TenantManager over the torch-free stub child
(``tests/_torch_supervised_stub.py``): manifests, seeded fences,
placeholders, env scoping, concurrent runs, a poisoned tenant quarantined
beside an untouched neighbour; per-tenant fencing epochs and serve-plane
fence trajectories that never order across namespaces; the replica-budget
arbitration (``plan_tenants`` / ``arbitrate_replica_budget``); and the
fleet's tenant rollups. Then the two packages side by side: the tenancy
constants are equal, the modules load by path with torch and jax
unimportable, and a tenants root written by either package's
TenantManager gives equal ``tenant_fleet_digest``s under both packages,
times aside.
"""

from __future__ import annotations

import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import torch

from fps_tpu_torch.obs import fleet as obs_fleet
from fps_tpu_torch.serve.fleet import StepFence
from fps_tpu_torch.supervise import supervisor as sup
from fps_tpu_torch.supervise.supervisor import SupervisorConfig
from fps_tpu_torch.tenancy import (
    CKPT_DIRNAME,
    MANIFEST_FILENAME,
    MANIFEST_SCHEMA_VERSION,
    OBS_DIRNAME,
    STATE_DIRNAME,
    TENANT_ENV,
    TENANTS_DIRNAME,
    TenantManager,
    TenantPaths,
    TenantSpec,
    audit_namespaces,
    list_tenants,
    tenants_root,
    validate_tenant_name,
)
from fps_tpu_torch.tiering.planner import (
    TableDensity,
    arbitrate_replica_budget,
    plan_tables,
    plan_tenants,
)

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STUB = os.path.join(_ROOT, "tests", "_torch_supervised_stub.py")

_FAST = dict(stall_timeout_s=30.0, startup_grace_s=60.0,
             poll_interval_s=0.02, backoff_base_s=0.05, backoff_max_s=0.2,
             term_grace_s=1.0)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _stub_spec(name, *extra, spec_cls=TenantSpec, **kw):
    """A TenantSpec running the stub inside its own ckpt namespace
    ({ckpt} doubles as the stub's --dir: heartbeats, fence checks,
    snapshots and result.json all land there)."""
    cmd = (sys.executable, _STUB, "--dir", "{ckpt}",
           "--chunks", "6", "--chunk-s", "0.02", *extra)
    return spec_cls(name=name, cmd=cmd, **kw)


# ---------------------------------------------------------------------------
# TenantSpec validation


def test_spec_rejects_empty_cmd():
    with pytest.raises(ValueError):
        TenantSpec(name="a", cmd=())


def test_spec_rejects_nonpositive_weight():
    for w in (0, -1, -0.5):
        with pytest.raises(ValueError):
            TenantSpec(name="a", cmd=("true",), weight=w)


def test_spec_rejects_illegal_name():
    for name in ("", "Caps", "has space", "../escape", "a/b", "a" * 65):
        with pytest.raises(ValueError):
            TenantSpec(name=name, cmd=("true",))


def test_spec_coerces_sequences_to_tuples():
    spec = TenantSpec(name="a", cmd=["x", "y"], watch=["w"])
    assert spec.cmd == ("x", "y")
    assert spec.watch == ("w",)


# ---------------------------------------------------------------------------
# TenantPaths / validate_tenant_name / list_tenants


def test_tenant_paths_layout(tmp_path):
    root = str(tmp_path)
    tp = TenantPaths(root, "m1")
    assert tp.tenant_dir == os.path.join(tenants_root(root), "m1")
    assert tp.manifest_path == os.path.join(tp.tenant_dir, MANIFEST_FILENAME)
    assert tp.ckpt_dir == os.path.join(tp.tenant_dir, CKPT_DIRNAME)
    assert tp.obs_dir == os.path.join(tp.tenant_dir, OBS_DIRNAME)
    assert tp.state_dir == os.path.join(tp.tenant_dir, STATE_DIRNAME)
    assert not os.path.isdir(tp.tenant_dir)
    tp.ensure()
    tp.ensure()  # idempotent
    for d in (tp.ckpt_dir, tp.obs_dir, tp.state_dir):
        assert os.path.isdir(d)


def test_tenant_paths_owns(tmp_path):
    root = str(tmp_path)
    a, b = TenantPaths(root, "a"), TenantPaths(root, "b")
    assert a.owns(os.path.join(a.ckpt_dir, "snap.npz"))
    assert a.owns(a.manifest_path)
    assert not a.owns(os.path.join(b.state_dir, "journal.jsonl"))
    assert not a.owns(os.path.join(root, "loose.txt"))
    # Prefix tricks must not leak across namespaces.
    assert not a.owns(os.path.join(tenants_root(root), "a-evil", "x"))


def test_validate_tenant_name():
    assert validate_tenant_name("ok-name_9") == "ok-name_9"
    for bad in ("", "Caps", "..", "a/b", "-lead", "a" * 65):
        with pytest.raises(ValueError):
            validate_tenant_name(bad)


def test_list_tenants(tmp_path):
    root = str(tmp_path)
    assert list_tenants(root) == []
    for name in ("beta", "alpha"):
        TenantPaths(root, name).ensure()
    # Non-tenant clutter under tenants/ is ignored.
    os.makedirs(os.path.join(tenants_root(root), "NOT-A-TENANT!"),
                exist_ok=True)
    assert list_tenants(root) == ["alpha", "beta"]


# ---------------------------------------------------------------------------
# audit_namespaces


def test_audit_clean(tmp_path):
    root = str(tmp_path)
    for name in ("a", "b"):
        tp = TenantPaths(root, name).ensure()
        with open(os.path.join(tp.ckpt_dir, "snap.npz"), "w") as f:
            f.write("x")
    audit = audit_namespaces(root, ["a", "b"])
    assert audit["clean"] is True
    assert audit["violations"] == []
    assert audit["per_tenant"]["a"] >= 1
    assert audit["per_tenant"]["b"] >= 1


def test_audit_flags_cross_namespace_files(tmp_path):
    root = str(tmp_path)
    TenantPaths(root, "a").ensure()
    # 1) a file owned by no tenant at the root,
    with open(os.path.join(root, "loose.txt"), "w") as f:
        f.write("x")
    # 2) a file directly under tenants/ (between namespaces),
    with open(os.path.join(tenants_root(root), "stray.json"), "w") as f:
        f.write("{}")
    # 3) a whole namespace nobody declared.
    tp_ghost = TenantPaths(root, "ghost").ensure()
    with open(os.path.join(tp_ghost.ckpt_dir, "snap.npz"), "w") as f:
        f.write("x")
    audit = audit_namespaces(root, ["a"])
    assert audit["clean"] is False
    assert len(audit["violations"]) == 3


# ---------------------------------------------------------------------------
# TenantManager machinery (stub children)


def test_manager_rejects_duplicate_names(tmp_path):
    specs = [_stub_spec("a"), _stub_spec("a")]
    with pytest.raises(ValueError):
        TenantManager(str(tmp_path), specs)


def test_manager_prepare_manifests_and_fences(tmp_path):
    root = str(tmp_path)
    mgr = TenantManager(root, [
        _stub_spec("a", weight=2.0, seed=7, slo={"x": {"target": 0.5}}),
        _stub_spec("b"),
    ])
    mgr.prepare()
    with open(mgr.paths["a"].manifest_path, encoding="utf-8") as f:
        manifest = json.load(f)
    assert manifest["schema"] == MANIFEST_SCHEMA_VERSION
    assert manifest["name"] == "a"
    assert manifest["weight"] == 2.0
    assert manifest["seed"] == 7
    assert manifest["slo"] == {"x": {"target": 0.5}}
    assert mgr.fence_epoch("a") == 1
    assert mgr.fence_epoch("b") == 1
    # prepare() is idempotent and never regresses a fence.
    mgr.bump_fence("a")
    mgr.prepare()
    assert mgr.fence_epoch("a") == 2


def test_manager_resolves_placeholders_and_scopes_env(tmp_path):
    root = str(tmp_path)
    spec_a = TenantSpec(
        name="a",
        cmd=("prog", "{ckpt}", "{obs}", "{state}", "{out}", "{name}",
             "{root}"),
        env={"ONLY_A": "1"}, watch=("{state}/w.json",))
    spec_b = TenantSpec(name="b", cmd=("prog",))
    mgr = TenantManager(root, [spec_a, spec_b],
                        base_env={"SHARED": "yes"})
    mgr.prepare()
    sa, sb = mgr.supervisor("a"), mgr.supervisor("b")
    tp = mgr.paths["a"]
    assert sa.cmd == ["prog", tp.ckpt_dir, tp.obs_dir, tp.state_dir,
                      tp.out_path, "a", tp.root]
    assert sa.state_dir == tp.state_dir
    assert sa.env[TENANT_ENV] == "a"
    assert sb.env[TENANT_ENV] == "b"
    assert sa.env["SHARED"] == sb.env["SHARED"] == "yes"
    # Per-spec env never leaks into a neighbour's child.
    assert sa.env["ONLY_A"] == "1"
    assert "ONLY_A" not in sb.env
    # Watch paths resolve into the tenant's own namespace.
    assert list(sa.watch) == [os.path.join(tp.state_dir, "w.json")]
    # The per-tenant fencing epoch rides the child env.
    assert sa.env["FPS_TPU_POD_EPOCH"] == "1"


def test_manager_runs_tenants_concurrently(tmp_path):
    root = str(tmp_path)
    mgr = TenantManager(
        root, [_stub_spec("a"), _stub_spec("b")],
        config=SupervisorConfig(max_restarts=1, **_FAST))
    digests = mgr.run()
    assert sorted(digests) == ["a", "b"]
    for name in ("a", "b"):
        assert digests[name]["success"] is True
        assert digests[name]["restarts"] == 0
        result = os.path.join(mgr.paths[name].ckpt_dir, "result.json")
        with open(result, encoding="utf-8") as f:
            assert json.load(f)["done"] == 6
        assert os.path.isfile(mgr.journal_path(name))
    audit = audit_namespaces(root, ["a", "b"])
    assert audit["clean"] is True, audit["violations"]


def test_manager_poison_quarantined_neighbor_untouched(tmp_path):
    """Tier-1 version of the tenant poison-isolation scenario: tenant a
    crashes at chunk 3 until quarantined; b finishes with no restart and
    the shared root stays cleanly partitioned."""
    root = str(tmp_path)
    mgr = TenantManager(
        root, [_stub_spec("a", "--crash-at", "3"), _stub_spec("b")],
        config=SupervisorConfig(max_restarts=3, quarantine_after=2,
                                **_FAST))
    digests = mgr.run()
    assert digests["a"]["success"] is True
    assert digests["a"]["restarts"] == 2
    assert digests["a"]["quarantined"] == [3]
    assert digests["b"]["success"] is True
    assert digests["b"]["restarts"] == 0
    # b's journal shows no recovery: the blast never reached it.
    assert sup.recovery_times(mgr.journal_path("b")) == []
    assert audit_namespaces(root, ["a", "b"])["clean"] is True


# ---------------------------------------------------------------------------
# Fencing-epoch isolation + property-style interleavings


def test_bump_fence_isolated(tmp_path):
    mgr = TenantManager(str(tmp_path),
                        [_stub_spec("a"), _stub_spec("b")])
    mgr.prepare()
    assert mgr.bump_fence("a") == 2
    assert mgr.bump_fence("a") == 3
    assert mgr.fence_epoch("b") == 1


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pod_fence_epochs_never_order_across_tenants(tmp_path, seed):
    """An arbitrary interleaving of bump_fence calls across tenants leaves
    each tenant's epoch equal to 1 + its OWN bump count."""
    names = ["a", "b", "c"]
    mgr = TenantManager(str(tmp_path), [_stub_spec(n) for n in names])
    mgr.prepare()
    rng = random.Random(seed)
    bumps = {n: 0 for n in names}
    for _ in range(30):
        n = rng.choice(names)
        got = mgr.bump_fence(n)
        bumps[n] += 1
        assert got == 1 + bumps[n]
    for n in names:
        assert mgr.fence_epoch(n) == 1 + bumps[n]


def _fence_ops(rng, n_ops):
    """A random but replayable StepFence op sequence: mostly forward
    advances, occasional epoch-bumping rollbacks."""
    ops, step = [], 0
    for _ in range(n_ops):
        if step > 0 and rng.random() < 0.3:
            step = rng.randrange(step)
            ops.append(("rollback", step))
        else:
            step += rng.randrange(1, 4)
            ops.append(("advance", step))
    return ops


def _apply_fence_op(fence, op, step):
    if op == "advance":
        fence.ready(step)
        return fence.advance(quorum=1, max_step=step)
    return fence.rollback(step)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_step_fence_trajectories_independent_across_tenants(tmp_path,
                                                            seed):
    """Interleaving serve-fence advances and rollbacks across tenant
    namespaces gives every tenant the (epoch, step) trajectory of a solo
    replay of only ITS ops."""
    root = os.path.join(str(tmp_path), "shared")
    names = ["a", "b", "c"]
    ops = {n: _fence_ops(random.Random(seed * 101 + i), 12)
           for i, n in enumerate(names)}
    deck = [n for n in names for _ in ops[n]]
    random.Random(seed).shuffle(deck)
    fences = {n: StepFence(TenantPaths(root, n).ensure().ckpt_dir,
                           reader_id="r0") for n in names}
    cursor = {n: 0 for n in names}
    interleaved = {n: [] for n in names}
    for n in deck:
        op, step = ops[n][cursor[n]]
        cursor[n] += 1
        interleaved[n].append(_apply_fence_op(fences[n], op, step))
    for n in names:
        solo_dir = os.path.join(str(tmp_path), f"solo_{n}")
        solo = StepFence(solo_dir, reader_id="r0")
        solo_traj = [_apply_fence_op(solo, op, step)
                     for op, step in ops[n]]
        assert interleaved[n] == solo_traj, (
            f"tenant {n!r} fence trajectory diverged under interleaving")
    assert audit_namespaces(root, names)["clean"] is True


# ---------------------------------------------------------------------------
# Replica-budget arbitration


def test_arbitrate_under_demander_kept_whole():
    granted = arbitrate_replica_budget({"a": 10, "b": 1000}, 100)
    assert granted == {"a": 10, "b": 90}


def test_arbitrate_weighted_split_when_all_hungry():
    granted = arbitrate_replica_budget({"a": 1000, "b": 1000}, 90,
                                       weights={"a": 2.0, "b": 1.0})
    assert granted == {"a": 60, "b": 30}


def test_arbitrate_largest_remainder_deterministic():
    granted = arbitrate_replica_budget({"a": 100, "b": 100}, 101)
    assert granted == {"a": 51, "b": 50}


def test_arbitrate_work_conserving_and_bounded():
    demands = {"a": 7, "b": 0, "c": 400, "d": 55}
    total = 300
    granted = arbitrate_replica_budget(demands, total)
    assert sum(granted.values()) == min(total, sum(demands.values()))
    for n in demands:
        assert 0 <= granted[n] <= demands[n]
    assert granted["b"] == 0


def test_arbitrate_rejects_bad_inputs():
    with pytest.raises(ValueError):
        arbitrate_replica_budget({"a": 1}, -1)
    with pytest.raises(ValueError):
        arbitrate_replica_budget({"a": 1}, 10, weights={"a": 0})


def test_plan_tenants_noisy_neighbor_knob_isolation():
    """The arbitration leg of the noisy-neighbour scenario: a flat-density
    tenant demanding the whole budget cannot move a concentrated
    neighbour's knobs off its solo plan; only its own hot tier shrinks."""
    nf, dim = 4096, 4
    dens_a = [TableDensity("weights", nf, dim, np.full(nf, 5.0))]
    counts_b = np.zeros(nf)
    counts_b[:64] = 1000.0
    dens_b = [TableDensity("weights", nf, dim, counts_b)]
    total = 48 * 1024
    plan_kw = dict(batch_rows_per_step=256, dense_table_bytes=1024)

    res = plan_tenants({"a": dens_a, "b": dens_b},
                       weights={"a": 1.0, "b": 1.0},
                       total_replica_budget_bytes=total, **plan_kw)
    solo_a = plan_tables(dens_a, replica_budget_bytes=total,
                         **plan_kw)["weights"]
    solo_b = plan_tables(dens_b, replica_budget_bytes=total,
                         **plan_kw)["weights"]
    assert res["b"]["granted"] == res["b"]["demand"]
    assert res["b"]["plans"]["weights"].knobs() == solo_b.knobs()
    assert res["a"]["granted"] < res["a"]["demand"]
    assert res["a"]["granted"] == total - res["b"]["granted"]
    shared_hot = res["a"]["plans"]["weights"].hot_tier
    assert 0 < shared_hot < solo_a.hot_tier
    assert res["a"]["granted"] + res["b"]["granted"] <= total


# ---------------------------------------------------------------------------
# obs/fleet.py tenant rollups (stdlib mirror of the tenancy layout)


def test_fleet_constants_mirror_tenancy_paths():
    """obs/fleet.py loads by path without the package, so it re-declares
    the tenancy layout; this pin is the test its comment promises."""
    assert obs_fleet.TENANTS_DIRNAME == TENANTS_DIRNAME
    assert obs_fleet.TENANT_MANIFEST_FILENAME == MANIFEST_FILENAME
    assert obs_fleet.TENANT_OBS_DIRNAME == OBS_DIRNAME
    assert obs_fleet.TENANT_STATE_DIRNAME == STATE_DIRNAME
    assert obs_fleet.SUPERVISOR_JOURNAL_FILENAME == sup.JOURNAL_FILENAME


def _write_manifest(tp, manifest):
    with open(tp.manifest_path, "w", encoding="utf-8") as f:
        json.dump(manifest, f)


def test_discover_tenants(tmp_path):
    root = str(tmp_path)
    assert obs_fleet.discover_tenants(root) == {}
    tp_a = TenantPaths(root, "a").ensure()
    _write_manifest(tp_a, {"name": "a", "weight": 2.0})
    tp_b = TenantPaths(root, "b").ensure()
    with open(tp_b.manifest_path, "w", encoding="utf-8") as f:
        f.write('{"torn')  # torn manifest: the tenant still reports
    TenantPaths(root, "c").ensure()  # no manifest at all: skipped
    found = obs_fleet.discover_tenants(root)
    assert sorted(found) == ["a", "b"]
    assert found["a"]["manifest"]["weight"] == 2.0
    assert found["a"]["obs_dir"] == tp_a.obs_dir
    assert found["a"]["state_dir"] == tp_a.state_dir
    assert found["b"]["manifest"] == {}


def test_apply_slo_overrides():
    slos = obs_fleet.DEFAULT_SLOS
    name = slos[0].name
    out = obs_fleet.apply_slo_overrides(slos, {name: {"target": 123.5}})
    assert out[0].target == 123.5
    assert out[0].objective == slos[0].objective
    assert out[1:] == tuple(slos[1:])
    # Unknown names and malformed values keep the defaults.
    assert obs_fleet.apply_slo_overrides(slos, {"nope": {"target": 1}}) \
        == tuple(slos)
    out = obs_fleet.apply_slo_overrides(slos, {name: {"target": "zzz"}})
    assert out[0].target == slos[0].target
    assert obs_fleet.apply_slo_overrides(slos, None) == tuple(slos)


def test_tenant_fleet_digest(tmp_path):
    root = str(tmp_path)
    slo_name = obs_fleet.DEFAULT_SLOS[0].name
    tp = TenantPaths(root, "a").ensure()
    _write_manifest(tp, {"name": "a", "weight": 2.5,
                         "slo": {slo_name: {"target": 9.0}}})
    # A minimal supervisor journal: attempt 1 died at t=10, attempt 2
    # first signalled at t=11.5: one recovery of 1.5 s.
    journal = os.path.join(tp.state_dir, sup.JOURNAL_FILENAME)
    with open(journal, "w", encoding="utf-8") as f:
        for rec in ({"kind": "event", "event": "attempt_end",
                     "attempt": 1, "t": 10.0},
                    {"kind": "event", "event": "attempt_first_signal",
                     "attempt": 2, "t": 11.5}):
            f.write(json.dumps(rec) + "\n")
    TenantPaths(root, "b").ensure()
    _write_manifest(TenantPaths(root, "b"), {"name": "b"})

    digest = obs_fleet.tenant_fleet_digest(root)
    assert sorted(digest["tenants"]) == ["a", "b"]
    a = digest["tenants"]["a"]
    assert a["weight"] == 2.5
    assert a["slo_overrides"] == [slo_name]
    assert a["recovery"]["count"] == 1
    assert a["recovery"]["times_s"] == [1.5]
    assert a["recovery"]["max_s"] == 1.5
    # The per-tenant SLO override reached the burn evaluation.
    assert a["slo"][slo_name]["target"] == 9.0
    b = digest["tenants"]["b"]
    assert b["weight"] == 1.0
    assert b["recovery"]["count"] == 0


# ---------------------------------------------------------------------------
# The two packages side by side.


def test_tenancy_constants_equal_the_references():
    import fps_tpu.obs.fleet as jfleet
    import fps_tpu.tenancy as jten

    import fps_tpu_torch.tenancy as ten

    for name in ("TENANT_ENV", "MANIFEST_SCHEMA_VERSION", "TENANTS_DIRNAME",
                 "MANIFEST_FILENAME", "CKPT_DIRNAME", "OBS_DIRNAME",
                 "STATE_DIRNAME", "OUT_FILENAME"):
        assert getattr(ten, name) == getattr(jten, name), name
    for name in ("TENANTS_DIRNAME", "TENANT_MANIFEST_FILENAME",
                 "TENANT_OBS_DIRNAME", "TENANT_STATE_DIRNAME",
                 "SUPERVISOR_JOURNAL_FILENAME"):
        assert getattr(obs_fleet, name) == getattr(jfleet, name), name
    assert set(obs_fleet.__all__) == set(jfleet.__all__)
    assert sorted(n for n in dir(ten) if not n.startswith("_")) == sorted(
        n for n in dir(jten) if not n.startswith("_"))


def test_tenancy_loads_by_path_without_torch_or_jax(tmp_path):
    """A control-plane process: manager.py (and through it paths.py and
    the supervise siblings), audit.py and obs/fleet.py load by file path
    with torch and jax unimportable, and a manager runs a stub tenant."""
    code = f"""
import importlib.util, json, sys
sys.modules["torch"] = None
sys.modules["jax"] = None
def load(name, path):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod
root = {_ROOT!r}
mgr = load("_m", root + "/fps_tpu_torch/tenancy/manager.py")
audit = load("_a", root + "/fps_tpu_torch/tenancy/audit.py")
fleet = load("_f", root + "/fps_tpu_torch/obs/fleet.py")
spec = mgr.TenantSpec("a", cmd=({sys.executable!r}, {_STUB!r}, "--dir",
                                 "{{ckpt}}", "--chunks", "3"))
d = mgr.TenantManager({str(tmp_path)!r}, [spec]).run()
assert d["a"]["success"], d
assert audit.audit_namespaces({str(tmp_path)!r}, ["a"])["clean"]
assert list(fleet.tenant_fleet_digest({str(tmp_path)!r})["tenants"]) == ["a"]
bad = [m for m in sys.modules if sys.modules[m] is not None and (
    m in ("torch", "jax", "numpy")
    or m.startswith(("torch.", "jax.", "numpy.", "fps_tpu.")))]
assert not bad, bad
"""
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=_ROOT)
    assert r.returncode == 0, r.stderr[-2000:]


def _fleet_view(digest):
    """A tenants digest without its times (window edges and rates)."""
    return {name: {"weight": t["weight"],
                   "slo_overrides": t["slo_overrides"],
                   "recovery_count": t["recovery"]["count"],
                   "hosts": t["rollup"]["hosts"],
                   "restarts": sum(w["restarts"]
                                   for w in t["rollup"]["windows"]),
                   "slo_targets": {k: v["target"]
                                   for k, v in t["slo"].items()}}
            for name, t in digest["tenants"].items()}


def _write_root(writer, root):
    """A tenants root written by ``writer``'s TenantManager: the stub as
    each tenant's child, tenant a poisoned at chunk 3 with an SLO
    override, b clean."""
    import fps_tpu.supervise.supervisor as jsup
    import fps_tpu.tenancy as jten

    import fps_tpu_torch.tenancy as ten

    pkg, sup_mod = {"ref": (jten, jsup), "port": (ten, sup)}[writer]
    slo_name = obs_fleet.DEFAULT_SLOS[0].name
    mgr = pkg.TenantManager(
        root, [_stub_spec("a", "--crash-at", "3", "--await-first-signal",
                          "{state}", spec_cls=pkg.TenantSpec,
                          weight=2.0, slo={slo_name: {"target": 7.0}}),
               _stub_spec("b", spec_cls=pkg.TenantSpec)],
        config=sup_mod.SupervisorConfig(max_restarts=3, **_FAST))
    digests = mgr.run()
    assert digests["a"]["quarantined"] == [3] and digests["b"]["success"]


def test_tenant_fleet_digests_agree_across_packages(tmp_path):
    """A tenants root written by either package's TenantManager gives
    equal ``tenant_fleet_digest``s under both packages, and the two roots
    equal digests times aside."""
    import fps_tpu.obs.fleet as jfleet

    views = {}
    for writer in ("ref", "port"):
        root = str(tmp_path / writer)
        _write_root(writer, root)
        got = obs_fleet.tenant_fleet_digest(root)
        assert got == jfleet.tenant_fleet_digest(root)
        assert sorted(got["tenants"]) == ["a", "b"]
        assert got["tenants"]["a"]["recovery"]["count"] >= 1
        views[writer] = _fleet_view(got)
    assert views["port"] == views["ref"]
    slo_name = obs_fleet.DEFAULT_SLOS[0].name
    assert views["port"]["a"]["slo_targets"][slo_name] == 7.0
