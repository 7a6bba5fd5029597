"""The port's pod coordinator (fps_tpu_torch/supervise/pod.py and the CLI
fps_tpu_torch/examples/supervise.py in pod mode) against tests/test_pod.py.

Each tier-1 case of tests/test_pod.py has its counterpart here, at stub
speed: N member agents (the port's CLI, one subprocess each, run with
torch and jax unimportable) over one shared pod dir, each supervising a
torch-free stub child (``tests/_torch_supervised_stub.py``) that beats,
publishes zip "snapshots" shaped like real checkpoints, honours the
pod-commanded common restart step and refuses to publish behind a pod
fence. Then the module's own contract: it loads by path with torch and jax
unimportable, mirrors the snapshot name pattern, and shares one
``RunSupervisor``, one ``StaleEpochError`` and one fault seam with the
package. The real-torch scenarios are in tests/test_torch_pod_scenarios.py
and tests/test_torch_pod_partition.py; the two packages' CLIs side by side
in tests/test_torch_pod_parity.py.
"""

import json
import os
import signal
import subprocess
import sys
import time
import zipfile

import pytest
import torch

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_STUB = os.path.join(_ROOT, "tests", "_torch_supervised_stub.py")
_CLI = os.path.join(_ROOT, "fps_tpu_torch", "examples", "supervise.py")
# Runs a script by path with torch and jax unimportable.
_NO_TORCH = ("import runpy, sys; sys.modules['torch'] = None; "
             "sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")

HOSTS = ("h0", "h1", "h2")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def member_cmd(cli, stub, pod_dir, host, pod_size, *flags, child=()):
    """One pod member over the stub, the reference's test flags."""
    return [
        sys.executable, "-c", _NO_TORCH, cli, "--pod-dir", str(pod_dir),
        "--pod-host", host, "--pod-size", str(pod_size),
        "--stall-timeout-s", "1.2", "--startup-grace-s", "15",
        "--term-grace-s", "0.4", "--backoff-base-s", "0.1",
        "--backoff-max-s", "0.5", "--max-restarts", "6",
        "--poll-s", "0.1", "--lease-ttl-s", "1.0",
        "--member-timeout-s", "3.0", *flags,
        "--", sys.executable, stub,
        "--dir", os.path.join(str(pod_dir), "{host}"), *child,
    ]


def launch(pod_dir, *flags, hosts=HOSTS, child=(), cli=_CLI, stub=_STUB):
    return {
        h: subprocess.Popen(
            member_cmd(cli, stub, pod_dir, h, len(hosts), *flags,
                       child=child),
            cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for h in hosts
    }


def collect(procs, timeout=120):
    out = {}
    deadline = time.monotonic() + timeout
    for h, p in procs.items():
        try:
            stdout, _ = p.communicate(
                timeout=max(5, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
        digest = None
        try:
            digest = json.loads(stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            pass
        out[h] = (p.returncode, digest, stdout[-1500:])
    return out


def _result(pod_dir, host):
    with open(os.path.join(str(pod_dir), host, "result.json"),
              encoding="utf-8") as f:
        return json.load(f)


def read_json(path):
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return None


def pod_events(pod_dir):
    with open(os.path.join(str(pod_dir), "journal-pod.jsonl"),
              encoding="utf-8") as f:
        return [json.loads(line) for line in f]


def clear_fault_at_world2(pod_dir, fixed, timeout=60):
    """The elastic test's hand: create ``fixed`` the moment the eviction
    lands (the control's world drops to 2). Returns whether it saw it."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        ctl = read_json(os.path.join(str(pod_dir), "pod_control.json"))
        if ctl and ctl.get("action") == "run" and ctl.get("world") == 2:
            open(fixed, "w").close()
            return True
        time.sleep(0.05)
    return False


# ---------------------------------------------------------------------------
# End-to-end member protocol (subprocess, stub children).
# ---------------------------------------------------------------------------

def test_pod_clean_run_elects_one_leader(tmp_path):
    """A fault-free pod: every member succeeds, exactly one leader term is
    ever held, zero restarts, and every stub finishes all chunks."""
    res = collect(launch(tmp_path / "pod",
                         child=("--chunks", "6", "--chunk-s", "0.05")))
    assert all(rc == 0 and d["success"] for rc, d, _ in res.values()), res
    assert sum(d["leader_terms"] for _, d, _ in res.values()) == 1
    assert all(d["pod"]["restarts"] == 0 for _, d, _ in res.values())
    for h in HOSTS:
        assert _result(tmp_path / "pod", h)["done"] == 6


def test_pod_wedged_member_one_coordinated_abort(tmp_path):
    """One member's child SIGSTOPs mid-run: the stall becomes ONE pod-wide
    decision; every member digest shows the same single coordinated
    restart, nothing is quarantined, and the pod journal narrates the
    abort (member_failed -> fence_written -> pod_restart)."""
    res = collect(launch(
        tmp_path / "pod",
        child=("--chunks", "6", "--chunk-s", "0.05", "--wedge-at", "3",
               "--wedge-mode", "sigstop", "--misbehave-host", "h1")))
    assert all(rc == 0 and d["success"] for rc, d, _ in res.values()), res
    assert all(d["pod"]["restarts"] == 1 for _, d, _ in res.values())
    assert all(d["pod"]["quarantined"] == [] for _, d, _ in res.values())
    events = [e["event"] for e in pod_events(tmp_path / "pod")]
    for expected in ("pod_start", "member_failed", "fence_written",
                     "pod_restart", "pod_shutdown"):
        assert expected in events, events


def test_pod_quarantine_broadcast(tmp_path):
    """A chunk that crashes ONE member on every attempt is quarantined
    POD-WIDE after two coordinated restarts: every member's stub, the
    never-crashing ones included, skips it."""
    res = collect(launch(
        tmp_path / "pod",
        child=("--chunks", "8", "--chunk-s", "0.05", "--crash-at", "5",
               "--misbehave-host", "h1")))
    assert all(rc == 0 and d["success"] for rc, d, _ in res.values()), res
    assert all(d["pod"]["quarantined"] == [5] for _, d, _ in res.values())
    assert all(d["pod"]["restarts"] == 2 for _, d, _ in res.values())
    for h in HOSTS:
        assert 5 not in _result(tmp_path / "pod", h)["ran"], h
    # The broadcast rides the pod state file through the child env
    # contract (STATE_ENV -> pod_state.json).
    state = read_json(tmp_path / "pod" / "pod_state.json")
    assert state["quarantined"] == [5]


def test_pod_elastic_eviction_and_readmission(tmp_path):
    """Elastic membership at stub speed: one member's child dies at
    startup (index-less, never quarantinable) until evicted at W-1; the
    fault then clears, the member reports ready, and the leader re-admits
    it (snapshot sync + restart at W). Every member finishes."""
    fixed = tmp_path / "fixed"
    procs = launch(
        tmp_path / "pod", "--elastic", "--evict-after", "2",
        "--rejoin-delay-s", "0.5",
        child=("--chunks", "10", "--chunk-s", "0.15",
               "--crash-until-file", str(fixed),
               "--misbehave-host", "h2"))
    saw_world2 = clear_fault_at_world2(tmp_path / "pod", fixed)
    res = collect(procs)
    assert saw_world2, [r[2] for r in res.values()]
    assert all(rc == 0 and d["success"] for rc, d, _ in res.values()), res
    assert all(d["pod"]["readmissions"] == 1 for _, d, _ in res.values())
    assert all(d["pod"]["world"] == 3 for _, d, _ in res.values())
    assert all(d["pod"]["evicted"] == [] for _, d, _ in res.values())
    for h in HOSTS:
        assert _result(tmp_path / "pod", h)["done"] == 10
    events = [e["event"] for e in pod_events(tmp_path / "pod")]
    for expected in ("member_evicted", "member_readmitted"):
        assert expected in events, events


def test_pod_partition_seizure_and_fencing(tmp_path):
    """The lease holder's member agent is SIGSTOPped: a follower seizes
    the lease (epoch bump), fences every member dir and restarts the pod,
    and the stale leader's ORPHANED stub child is refused by the fence at
    its next publish (exit 9, 'stale epoch' in its log). On SIGCONT the
    deposed leader rejoins and the pod completes."""
    procs = launch(tmp_path / "pod", "--lease-ttl-s", "0.6",
                   "--member-timeout-s", "1.2",
                   child=("--chunks", "40", "--chunk-s", "0.25"))
    lease_path = tmp_path / "pod" / "pod_lease.json"
    deadline = time.monotonic() + 60
    leader = None
    try:
        while time.monotonic() < deadline:
            lease = read_json(lease_path)
            holder = (lease or {}).get("host")
            mem = (read_json(tmp_path / "pod" / "members"
                             / f"{holder}.json") if holder else None)
            # Freeze only once the leader's CHILD exists and has
            # published: otherwise there is no orphan to fence.
            if mem and mem.get("child_pid") \
                    and (mem.get("latest_step") or 0) >= 1:
                leader = holder
                os.kill(procs[leader].pid, signal.SIGSTOP)
                break
            time.sleep(0.05)
        assert leader is not None, "no leader emerged"
        seized_by = None
        while time.monotonic() < deadline:
            lease = read_json(lease_path)
            if lease and lease.get("host") != leader:
                seized_by = lease["host"]
                break
            time.sleep(0.05)
        assert seized_by is not None, "lease never seized"
        # The fence lands with the post-partition restart; the orphan
        # (still publishing every 0.25 s) must hit it.
        time.sleep(3.0)
    finally:
        if leader is not None:
            try:
                os.kill(procs[leader].pid, signal.SIGCONT)
            except ProcessLookupError:
                pass
    res = collect(procs)
    assert all(rc == 0 and d["success"] for rc, d, _ in res.values()), res
    assert res[seized_by][1]["leader_terms"] >= 1
    logs = ""
    ldir = tmp_path / "pod" / leader
    for f in os.listdir(ldir):
        if f.startswith("attempt-") and f.endswith(".log"):
            logs += open(ldir / f, encoding="utf-8",
                         errors="replace").read()
    assert "stale epoch" in logs, logs[-800:]
    # Epoch monotonicity across the seizure: the final epoch exceeds 2
    # (initial acquire + launch) because the seizure bumped it.
    assert all(d["epoch"] >= 4 for _, d, _ in res.values())


def test_pod_give_up_exhausts_budget(tmp_path):
    """An unrecoverable member (wedges every attempt, quarantine cannot
    help) burns the pod restart budget: the leader gives up, every member
    exits nonzero with action give_up."""
    res = collect(launch(
        tmp_path / "pod", "--max-restarts", "1",
        child=("--chunks", "6", "--chunk-s", "0.05", "--wedge-at", "2",
               "--wedge-always", "--misbehave-host", "h1")))
    assert all(rc == 1 and not d["success"]
               for rc, d, _ in res.values()), res
    assert all(d["action"] == "give_up" for _, d, _ in res.values())


def test_a_pod_of_one_over_the_cli(tmp_path):
    """The smallest pod: one member leads itself, launches its child once
    and shuts the pod down; its digest names the member's state dir
    POD_DIR/HOST."""
    res = collect(launch(tmp_path / "pod", hosts=("h0",),
                         child=("--chunks", "4", "--chunk-s", "0.02")))
    rc, digest, tail = res["h0"]
    assert rc == 0 and digest["success"], tail
    assert digest["leader_terms"] == 1 and digest["pod"]["world"] == 1
    assert digest["state_path"] == str(
        tmp_path / "pod" / "h0" / "supervisor_state.json")
    assert _result(tmp_path / "pod", "h0")["done"] == 4


# ---------------------------------------------------------------------------
# Library pieces (no subprocess but the loaders).
# ---------------------------------------------------------------------------

def test_snapshot_re_mirrors_format():
    """pod.py mirrors the snapshot filename pattern (it stays stdlib-only
    and cannot import snapshot_format, which needs numpy)."""
    from fps_tpu_torch.core import snapshot_format
    from fps_tpu_torch.supervise import pod

    assert pod.SNAPSHOT_RE.pattern == snapshot_format.SNAPSHOT_RE.pattern


def test_pod_module_loads_without_torch_or_jax():
    """Loaded by file path in a bare interpreter with torch and jax
    unimportable, pod.py imports neither package, nor numpy: its siblings
    (child, supervisor, core/retry) load by path too."""
    code = (
        "import importlib.util, sys\n"
        "sys.modules['torch'] = None\n"
        "sys.modules['jax'] = None\n"
        f"path = {os.path.join(_ROOT, 'fps_tpu_torch', 'supervise', 'pod.py')!r}\n"
        "spec = importlib.util.spec_from_file_location('_pod', path)\n"
        "mod = importlib.util.module_from_spec(spec)\n"
        "sys.modules[spec.name] = mod\n"
        "spec.loader.exec_module(mod)\n"
        "mod.PodConfig(pod_size=2)\n"
        "assert mod._sup.RunSupervisor is mod.PodMember.__mro__[1]\n"
        "bad = [m for m in sys.modules if sys.modules[m] is not None and ("
        "m in ('jax', 'numpy', 'torch') or m.startswith(('jax.', 'numpy.',"
        " 'torch.', 'fps_tpu.', 'fps_tpu_torch')))]\n"
        "assert not bad, bad\n"
    )
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=60)
    assert r.returncode == 0, r.stderr[-2000:]


def test_one_supervisor_one_stale_epoch_error_one_fault_seam():
    """The package imports child, supervisor and core/retry before pod, so
    pod.py reuses them: one RunSupervisor class, the StaleEpochError the
    checkpoint layer raises, and the retry module faultfs installs into."""
    import fps_tpu_torch.core.checkpoint as checkpoint
    import fps_tpu_torch.core.retry as retry
    import fps_tpu_torch.supervise.supervisor as supervisor
    from fps_tpu_torch.supervise import PodMember, pod

    assert pod._sup is supervisor
    assert pod._child.StaleEpochError is checkpoint.StaleEpochError
    assert pod._retry is retry
    assert issubclass(PodMember, supervisor.RunSupervisor)


def test_lease_acquire_renew_seize(tmp_path):
    """Lease mechanics with a controlled clock: two-tick acquisition,
    renewal keeps the holder, an expired lease is seized with an epoch
    bump, and the deposed holder observes the loss."""
    from fps_tpu_torch.supervise.pod import Lease

    now = [100.0]
    a = Lease(str(tmp_path / "lease.json"), "a", 2.0, clock=lambda: now[0])
    b = Lease(str(tmp_path / "lease.json"), "b", 2.0, clock=lambda: now[0])

    held, _, _ = a.tick()  # claim
    assert not held
    held, rec, seized = a.tick()  # confirm
    assert held and rec["epoch"] == 1 and not b.tick()[0]

    now[0] += 1.0  # fresh enough: b cannot seize, a renews
    assert not b.tick()[0]
    assert a.tick()[0]

    now[0] += 10.0  # expired: b claims...
    held, _, _ = b.tick()
    assert not held
    held, rec, seized = b.tick()  # ...and confirms with a bumped epoch
    assert held and seized and rec["epoch"] == 2
    assert not a.tick()[0]  # the deposed holder steps down


def test_lease_claim_race_single_winner(tmp_path):
    """Two simultaneous claims settle on the single rename winner."""
    from fps_tpu_torch.supervise.pod import Lease

    now = [10.0]
    a = Lease(str(tmp_path / "l.json"), "a", 2.0, clock=lambda: now[0])
    b = Lease(str(tmp_path / "l.json"), "b", 2.0, clock=lambda: now[0])
    a.tick()  # a claims
    b._write(1)  # b's racing claim rename lands after a's
    b._claimed = True
    assert not a.tick()[0]  # a reads b's record: claim lost
    held, rec, seized = b.tick()
    assert held and rec["host"] == "b"


def test_fence_helpers(tmp_path):
    from fps_tpu_torch.supervise.child import (
        fence_allows,
        read_fence,
        write_fence,
    )

    d = str(tmp_path)
    assert read_fence(d) is None
    assert fence_allows(d, None) == (True, 0)  # unfenced: everyone may
    write_fence(d, 4, 17)
    assert read_fence(d) == {"min_epoch": 4, "step": 17}
    assert fence_allows(d, 5) == (True, 4)
    assert fence_allows(d, 4) == (True, 4)
    assert fence_allows(d, 3) == (False, 4)
    assert fence_allows(d, None) == (False, 4)  # epoch-less writer


def test_latest_valid_snapshot_step_stdlib_verify(tmp_path):
    """The coordinator's stdlib-only snapshot verification: zip CRCs catch
    truncation, non-snapshot names are ignored, and the newest INTACT step
    wins."""
    from fps_tpu_torch.supervise.pod import latest_valid_snapshot_step

    d = str(tmp_path)
    assert latest_valid_snapshot_step(d) is None
    for step in (3, 5):
        with zipfile.ZipFile(
                os.path.join(d, f"ckpt_{step:012d}.npz"), "w") as z:
            z.writestr("x", b"payload" * 64)
    open(os.path.join(d, "not_a_ckpt.npz"), "wb").write(b"junk")
    assert latest_valid_snapshot_step(d) == 5
    p5 = os.path.join(d, "ckpt_%012d.npz" % 5)
    with open(p5, "r+b") as f:
        f.truncate(os.path.getsize(p5) // 2)
    cache = {}
    assert latest_valid_snapshot_step(d, cache) == 3
    assert latest_valid_snapshot_step(d, cache) == 3  # cached verdicts


def test_latest_valid_snapshot_step_reads_the_ports_checkpoints(tmp_path):
    """The stdlib scan accepts what the port's Checkpointer publishes (a
    numpy .npz is a zip) and skips a torn one."""
    from fps_tpu_torch import TableSpec, make_ps_mesh
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.core.store import ParamStore
    from fps_tpu_torch.supervise.pod import latest_valid_snapshot_step

    store = ParamStore(make_ps_mesh(device="cpu"),
                       [TableSpec("w", num_ids=64, dim=2)])
    store.init(0)
    d = str(tmp_path / "ck")
    ck = Checkpointer(d, keep=5)
    for step in (1, 2):
        ck.save(step, store, None)
    assert latest_valid_snapshot_step(d) == 2
    p2 = os.path.join(d, "ckpt_%012d.npz" % 2)
    with open(p2, "r+b") as f:
        f.truncate(os.path.getsize(p2) - 40)
    assert latest_valid_snapshot_step(d) == 1


def test_pod_config_validation():
    from fps_tpu_torch.supervise import PodConfig

    with pytest.raises(ValueError):
        PodConfig(pod_size=0)
    with pytest.raises(ValueError):
        PodConfig(lease_ttl_s=0)
    with pytest.raises(ValueError):
        PodConfig(evict_after=0)


def test_pod_member_rejects_bad_host(tmp_path):
    from fps_tpu_torch.supervise import PodMember

    with pytest.raises(ValueError):
        PodMember(["true"], pod_dir=str(tmp_path), host="a/b")
    with pytest.raises(ValueError):
        PodMember(["true"], pod_dir=str(tmp_path), host="")


def test_pod_state_future_schema_refused(tmp_path):
    from fps_tpu_torch.supervise import PodMember

    m = PodMember(["true"], pod_dir=str(tmp_path), host="h0")
    with open(m.pod_state_path, "w", encoding="utf-8") as f:
        json.dump({"schema": 99}, f)
    with pytest.raises(ValueError):
        m._load_pod_state()


def test_child_cmd_host_template(tmp_path):
    from fps_tpu_torch.supervise import PodMember

    m = PodMember(["run", "--dir", "{host}-work", "--plain"],
                  pod_dir=str(tmp_path), host="h7")
    assert m._child_cmd() == ["run", "--dir", "h7-work", "--plain"]


def test_child_env_carries_pod_contract(tmp_path):
    from fps_tpu_torch.supervise import PodMember, child

    m = PodMember(["true"], pod_dir=str(tmp_path), host="h1")
    m._pod_ctx = {"epoch": 4, "world": 3, "step": 7}
    env = m._child_env(2)
    assert env[child.POD_HOST_ENV] == "h1"
    assert env[child.POD_EPOCH_ENV] == "4"
    assert env[child.POD_WORLD_ENV] == "3"
    assert env[child.POD_STEP_ENV] == "7"
    # Quarantine broadcast: the child's carried set comes from the POD
    # state file, not the member's own.
    assert env[child.STATE_ENV] == m.pod_state_path
    assert env[child.ATTEMPT_ENV] == "2"


def test_pod_env_parsing(monkeypatch):
    from fps_tpu_torch.supervise import child

    for var in (child.POD_HOST_ENV, child.POD_EPOCH_ENV,
                child.POD_WORLD_ENV, child.POD_STEP_ENV):
        monkeypatch.delenv(var, raising=False)
    assert child.pod_env() == {"host": None, "epoch": None, "world": None,
                               "step": None}
    monkeypatch.setenv(child.POD_HOST_ENV, "h2")
    monkeypatch.setenv(child.POD_EPOCH_ENV, "5")
    monkeypatch.setenv(child.POD_WORLD_ENV, "3")
    monkeypatch.setenv(child.POD_STEP_ENV, "9")
    assert child.pod_env() == {"host": "h2", "epoch": 5, "world": 3,
                               "step": 9}


@pytest.mark.parametrize("flags", [["--pod-dir", "P"], ["--pod-host", "h0"],
                                   []])
def test_cli_pod_flag_validation(tmp_path, flags):
    """--pod-dir and --pod-host travel together; --state-dir stays
    required outside pod mode. Both are usage errors (exit 2)."""
    flags = [str(tmp_path) if f == "P" else f for f in flags]
    r = subprocess.run(
        [sys.executable, "-c", _NO_TORCH, _CLI, *flags, "--", "true"],
        capture_output=True, text=True, timeout=60, cwd=_ROOT)
    assert r.returncode == 2, (flags, r.stderr)
    assert "usage:" in r.stderr


# ---------------------------------------------------------------------------
# Review-hardening regressions.
# ---------------------------------------------------------------------------

def test_dead_host_keeps_accruing_failures_until_evicted(tmp_path):
    """A PERMANENTLY unreachable host re-fires its staleness incident
    every member_timeout (it must reach the elastic eviction budget),
    while the pacing stops a single partition from burning the restart
    budget within one poll tick."""
    from fps_tpu_torch.supervise import PodConfig, PodMember, SupervisorConfig
    from fps_tpu_torch.supervise.pod import _atomic_write_json

    cfg = PodConfig(pod_size=2, elastic=True, evict_after=2,
                    member_timeout_s=0.4,
                    member=SupervisorConfig(backoff_base_s=0.05))
    m = PodMember(["true"], pod_dir=str(tmp_path), host="h0", config=cfg)
    assert not m.lease.tick()[0] and m.lease.tick()[0]  # claim + confirm
    m.is_leader = True
    m.pod_state = m._load_pod_state()
    m.pod_state["epoch"] = 1
    m.pod_state["roster"] = m.pod_state["plan"] = ["h0", "h1"]

    def fresh_self(status="running"):
        _atomic_write_json(os.path.join(m.members_dir, "h0.json"),
                           {"host": "h0", "t": time.time(),
                            "epoch": int(m.pod_state["epoch"]),
                            "status": status})

    # h1 never writes a beacon: unreachable from the start.
    fresh_self()
    now = time.time()
    m._leader_tick(now)
    assert m.pod_state["failures"].get("h1") == 1
    # Same tick window: the incident is deduped, no double count.
    m._leader_tick(now + 0.1)
    assert m.pod_state["failures"].get("h1") == 1
    # Past the pacing window: still unreachable, counts again, evicted.
    fresh_self()
    m._leader_tick(now + 1.0)
    assert m.pod_state["failures"].get("h1") == 2
    assert m.pod_state["evicted"] == ["h1"]
    assert m.pod_state["plan"] == ["h0"]


def test_lease_epoch_regression_reseized(tmp_path):
    """A deposed leader frozen mid-renewal can rename a STALE (lower-epoch)
    record over the successor's lease; observers treat the regression as
    expiry and re-seize strictly ABOVE every epoch ever seen."""
    from fps_tpu_torch.supervise.pod import Lease

    now = [100.0]
    a = Lease(str(tmp_path / "l.json"), "a", 2.0, clock=lambda: now[0])
    b = Lease(str(tmp_path / "l.json"), "b", 2.0, clock=lambda: now[0])
    a.tick(), a.tick()  # a holds at epoch 1
    now[0] += 10.0
    b.tick(), b.tick()  # expired: b seizes at epoch 2
    assert b.tick()[0]
    # a's frozen renewal resumes: last writer wins, epoch 1 reinstalled.
    a._write(1)
    held, rec, _ = b.tick()
    assert not held  # b saw the regression and re-claimed...
    held, rec, seized = b.tick()
    assert held and seized and rec["epoch"] == 3  # ...strictly above max


def test_readmit_deferred_when_sync_fails(tmp_path):
    """A failed catch-up sync DEFERS readmission: admitting an unsynced
    member would roll the whole pod back to its stale frontier."""
    from fps_tpu_torch.supervise import PodConfig, PodMember

    cfg = PodConfig(pod_size=2, elastic=True)
    m = PodMember(["true"], pod_dir=str(tmp_path), host="h0", config=cfg)
    assert not m.lease.tick()[0] and m.lease.tick()[0]
    m.pod_state = m._load_pod_state()
    m.pod_state["epoch"] = 3
    m.pod_state["roster"] = ["h0", "h1"]
    m.pod_state["plan"] = ["h0"]
    m.pod_state["evicted"] = ["h1"]
    # The pod HAS canonical progress (a valid snapshot at step 4)...
    with zipfile.ZipFile(
            os.path.join(str(tmp_path), "h0", "ckpt_%012d.npz" % 4),
            "w") as z:
        z.writestr("x", b"y" * 64)
    # ...but the copy into h1 fails.
    m._sync_member = lambda host: None
    m._readmit(time.time(), "h1")
    assert m.pod_state["evicted"] == ["h1"]  # still out
    assert m.pod_state["plan"] == ["h0"]
    assert m.pod_state["readmissions"] == 0
    events = [e["event"] for e in pod_events(tmp_path)]
    assert "readmit_deferred" in events


def test_oversize_snapshot_structural_verify_only(tmp_path, monkeypatch):
    """Past FULL_VERIFY_MAX_BYTES the scan checks zip STRUCTURE only;
    under it, member CRCs still catch bit rot."""
    from fps_tpu_torch.supervise import pod

    d = str(tmp_path)
    p = os.path.join(d, "ckpt_%012d.npz" % 7)
    with zipfile.ZipFile(p, "w") as z:
        z.writestr("x", b"payload" * 64)
    with open(p, "r+b") as f:
        f.seek(os.path.getsize(p) // 2)
        byte = f.read(1)[0]
        f.seek(-1, os.SEEK_CUR)
        f.write(bytes([byte ^ 0xFF]))
    assert pod.latest_valid_snapshot_step(d) is None  # full CRC: caught
    monkeypatch.setattr(pod, "FULL_VERIFY_MAX_BYTES", 8)
    assert pod.latest_valid_snapshot_step(d) == 7  # structural only


def test_sync_member_copies_the_frontier_snapshot(tmp_path):
    """The readmission's copy: the plan member at the pod's common
    frontier is the source, the copy lands by tmp + rename, and the
    returning member's dir then holds that step."""
    from fps_tpu_torch.supervise import PodConfig, PodMember
    from fps_tpu_torch.supervise.pod import latest_valid_snapshot_step

    m = PodMember(["true"], pod_dir=str(tmp_path), host="h0",
                  config=PodConfig(pod_size=3, elastic=True))
    m.pod_state = m._load_pod_state()
    m.pod_state["plan"] = ["h0", "h1"]
    for host, steps in (("h0", (4, 6)), ("h1", (4, 5))):
        os.makedirs(tmp_path / host, exist_ok=True)
        for step in steps:
            with zipfile.ZipFile(tmp_path / host / f"ckpt_{step:012d}.npz",
                                 "w") as z:
                z.writestr("x", f"{host}{step}".encode() * 16)
    assert m._sync_member("h2") == 5
    assert latest_valid_snapshot_step(str(tmp_path / "h2")) == 5
    with zipfile.ZipFile(tmp_path / "h2" / f"ckpt_{5:012d}.npz") as z:
        assert z.read("x") == b"h15" * 16
    assert not [f for f in os.listdir(tmp_path / "h2")
                if f.endswith(".tmp")]
