"""Tiny supervised training child, and the supervised scenarios over it.

Port of ``fps_tpu/testing/supervised_demo.py``.
``python -m fps_tpu_torch.testing.supervised_demo --ckpt-dir D --out W.npz``
trains the standard tiny logistic regression
(:mod:`fps_tpu_torch.testing.workloads`) under the supervised-child
contract:

* resumes from ``latest_valid_step`` in ``--ckpt-dir`` (a fresh process,
  the kill-and-resume contract), saving every chunk through an
  :class:`~fps_tpu_torch.core.checkpoint.AsyncCheckpointer`;
* beats the supervisor's heartbeat (:mod:`fps_tpu_torch.supervise.child`)
  at every chunk boundary, and through a heartbeat-only recorder the
  drivers beat their sub-phases;
* preloads the supervisor-carried quarantine into
  ``RollbackPolicy(preset=...)`` (a ``"quarantine_carried"`` line);
* misbehaves on demand: ``--wedge-at K`` (SIGSTOP or sleep forever after
  chunk K trains, before its checkpoint lands), ``--crash-at K`` (exit 3
  at chunk K until quarantined), ``--kill-at K`` (SIGKILL after chunk K
  trains) and ``--kill-prefetch-at K`` (SIGKILL in the prefetch worker's
  assembly of chunk K). Once only, through a marker file next to the
  checkpoints, unless ``--always``.

It runs on the card unless ``--device`` names another device (the tests:
``--device cpu``); with no CUDA and no ``--device`` it exits non-zero. Its
``--out`` meta JSON (``W.npz.meta.json``) records the device, the step it
restored, the memory free on the card at its start and the kernels'
launch counts.

Deterministic end to end: a supervised run that is wedged, killed or
crashed must end on the straight run's final weights bit for bit. Each
``run_*_scenario(tmpdir, ...)`` drives one such story through the port's
supervisor CLI (``fps_tpu_torch/examples/supervise.py``, run with torch
unimportable; the ``run_pod_*`` scenarios run three of them in pod mode,
one member a host, over one pod dir) and returns ``(ok, detail)``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CLI = os.path.join(_ROOT, "fps_tpu_torch", "examples", "supervise.py")

# The supervisor runs with torch (and jax) unimportable: a supervisor that
# reaches for either fails its scenario.
_NO_TORCH = ("import runpy, sys; sys.modules['torch'] = None; "
             "sys.modules['jax'] = None; sys.argv = sys.argv[1:]; "
             "runpy.run_path(sys.argv[0], run_name='__main__')")

# Shared by the straight and supervised runs of every scenario: bit
# identity only means something when both children run the same workload.
SCENARIO_DEMO_ARGS = ("--examples", "8000", "--epochs", "2")
SCENARIO_WEDGE_AT = 3
# Mid-prefetch SIGKILL: pipeline depth and the chunk whose background
# assembly the child dies in.
SCENARIO_PREFETCH_DEPTH = 2
SCENARIO_PREFETCH_KILL_AT = 4
# Hot-tier kill: the two-tier storage config and the chunk boundary the
# child dies at (its reconcile ran, its checkpoint never landed). The hot
# tier engages on a mesh of more than one position: the reference's eight
# CPU devices are eight positions here.
SCENARIO_TIER_SHARDS = 8
SCENARIO_HOT_TIER = 64
SCENARIO_HOT_SYNC = 3
SCENARIO_HOT_KILL_AT = 3
# Retier kill: the adaptive tier (mapped hot set, forced re-rank every
# check); check_every=2 puts checks at boundaries 1, 3, 5...; the kill at
# chunk 3 fires before boundary 3's re-rank, so the restart restores the
# step-3 snapshot and tracker sidecar and replays chunk 3.
SCENARIO_RETIER_EVERY = 2
SCENARIO_RETIER_KILL_AT = 3
# Sharded-reconcile kill: the whole table replicated with an Adagrad hot
# fold, its per-row state sharded and saved as fold:: arrays.
SCENARIO_FOLD_TIER = 400  # >= NF: full replication (hot_fold needs it)
SCENARIO_FOLD_SYNC = 3
SCENARIO_FOLD_KILL_AT = 3
# Megastep: K chunk segments a dispatch over device ingest; the kill lands
# after megastep SCENARIO_MEGASTEP_KILL_AT trains, before its checkpoint.
MEGASTEP_T_CALL = 4          # steps a chunk segment
SCENARIO_MEGASTEP_K = 2
SCENARIO_MEGASTEP_KILL_AT = 3
# Deterministic crash: chunk SCENARIO_CRASH_AT crashes every attempt until
# the supervisor quarantines it.
SCENARIO_CRASH_AT = 2
# Delta-chain kill: a big feature table so each chunk touches a small
# fraction of rows (deltas engage), a chain bound high enough that the run
# is one full plus deltas, and a SIGKILL after chunk SCENARIO_DELTA_KILL_AT.
SCENARIO_DELTA_NF = 65536
SCENARIO_DELTA_BASE_ARGS = ("--examples", "8000", "--epochs", "2",
                            "--num-features", str(SCENARIO_DELTA_NF),
                            "--keep", "30")
SCENARIO_DELTA_ARGS = SCENARIO_DELTA_BASE_ARGS + (
    "--delta-full-every", "100")
SCENARIO_DELTA_KILL_AT = 3
SCENARIO_SERVE_KILL_AT = 3
# Fleet fence: N readers under quorum-2 fencing over the same
# delta-publishing child; one reader is killed and restarted mid-run.
SCENARIO_FLEET_READERS = 3


def _ttr_from_digest(digest) -> float | None:
    """Slowest ``restart_to_first_signal_s`` of a supervisor digest: the
    scenario's ``time_to_recovered_s`` (``None`` when nothing restarted)."""
    rts = digest.get("restart_to_first_signal_s") or []
    return round(max(rts), 3) if rts else None


def _env(device: str | None) -> dict:
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT + (os.pathsep + env["PYTHONPATH"]
                                 if env.get("PYTHONPATH") else "")
    if device == "cpu":
        # One intra-op thread: the children of a test run beside others.
        env["OMP_NUM_THREADS"] = "1"
    return env


def demo_cmd(*args, device: str | None = None) -> list[str]:
    """argv of the demo child (``--device`` appended when given)."""
    cmd = [sys.executable, "-m", "fps_tpu_torch.testing.supervised_demo",
           *args]
    return cmd + ["--device", device] if device else cmd


def supervise_cmd(state_dir: str, *, stall_timeout_s: float = 60.0,
                  startup_grace_s: float = 300.0,
                  max_restarts: int = 2) -> list[str]:
    """argv of the port's supervisor CLI, run by path with torch and jax
    unimportable (the scenarios' policy flags)."""
    return [sys.executable, "-c", _NO_TORCH, CLI, "--state-dir", state_dir,
            "--stall-timeout-s", str(stall_timeout_s),
            "--startup-grace-s", str(startup_grace_s),
            "--term-grace-s", "2", "--backoff-base-s", "0.2",
            "--max-restarts", str(max_restarts), "--poll-s", "0.2", "--"]


def kill_attempts(state_dir: str) -> None:
    """SIGKILL the process group of every attempt the supervisor journal
    under ``state_dir`` started (its children run in their own sessions,
    so killing the supervisor alone would leave them)."""
    import signal

    try:
        with open(os.path.join(state_dir, "journal-supervisor.jsonl"),
                  encoding="utf-8") as f:
            pids = [json.loads(line).get("pid") for line in f
                    if '"attempt_start"' in line]
    except (OSError, json.JSONDecodeError):
        return
    for pid in pids:
        try:
            os.killpg(int(pid), signal.SIGKILL)
        except (ProcessLookupError, PermissionError, TypeError, ValueError):
            pass


def run_supervisor(argv, state_dir: str, *, env, timeout: float):
    """Run a supervisor to its end: ``(returncode, digest or None,
    output)``. At ``timeout`` the supervisor and every attempt it started
    are killed and the returncode is ``None``."""
    proc = subprocess.Popen(argv, env=env, cwd=_ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True)
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        out, err = proc.communicate()
        kill_attempts(state_dir)
        return None, None, out + err
    try:
        digest = json.loads(out.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        digest = None
    return proc.returncode, digest, out + err


def _read_json(path: str) -> dict:
    try:
        with open(path, encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError):
        return {}


def _weights_equal(a: str, b: str) -> bool:
    import numpy as np

    if not (os.path.exists(a) and os.path.exists(b)):
        return False
    with np.load(a) as za, np.load(b) as zb:
        wa, wb = za["weights"], zb["weights"]
        return (wa.dtype == wb.dtype and wa.shape == wb.shape
                and np.array_equal(wa.view(np.uint8), wb.view(np.uint8)))


def attempt_starts(state_dir: str) -> list[dict]:
    """The ``demo_start`` line of every attempt's log under ``state_dir``,
    in attempt order (``{}`` for an attempt that died before it)."""
    out = []
    for path in sorted(glob.glob(os.path.join(state_dir, "attempt-*.log")),
                       key=lambda p: int(p.rsplit("-", 1)[1][:-4])):
        rec = {}
        with open(path, encoding="utf-8", errors="replace") as f:
            for line in f:
                if line.startswith('{"event": "demo_start"'):
                    rec = json.loads(line)
                    break
        out.append(rec)
    return out


def _start_straight(tmpdir: str, demo: list, name: str, *, env,
                    extra_env=None):
    """Start one unsupervised run of ``demo`` in the background; the
    handle goes to :func:`_finish_straight`."""
    d = os.path.join(tmpdir, name)
    out = os.path.join(tmpdir, name + ".npz")
    os.makedirs(tmpdir, exist_ok=True)
    proc = subprocess.Popen(demo + ["--ckpt-dir", d, "--out", out],
                            env={**env, **(extra_env or {})}, cwd=_ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, out, name


def _finish_straight(run, timeout: float):
    """Wait for a started straight run: ``(out path, meta, error)``. At
    ``timeout`` it is killed and reported failed."""
    proc, out, name = run
    try:
        stdout, _ = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, _ = proc.communicate()
    if proc.returncode != 0:
        return out, {}, {"error": f"straight run ({name}) failed",
                         "tail": stdout[-2000:]}
    return out, _read_json(out + ".meta.json"), None


def _straight(tmpdir: str, demo: list, name: str, *, env, timeout: float,
              extra_env=None):
    """One unsupervised run of ``demo``: ``(out path, meta, error)``."""
    return _finish_straight(_start_straight(tmpdir, demo, name, env=env,
                                            extra_env=extra_env), timeout)


def _supervised_pair(tmpdir: str, demo: list, misbehave: list, *,
                     timeout: float, device: str | None,
                     stall_timeout_s: float, startup_grace_s: float,
                     max_restarts: int = 2, straight_env=None):
    """A straight run of ``demo`` (with ``straight_env`` over the
    environment) and a supervised one with ``misbehave`` appended:
    ``(ctx, error)``; ``ctx`` holds the digest, both metas, the
    bit-identity verdict and the ``*.corrupt`` files."""
    env = _env(device)
    straight_out, straight_meta, err = _straight(
        tmpdir, demo, "straight", env=env, timeout=timeout,
        extra_env=straight_env)
    if err is not None:
        return None, err
    sup_dir = os.path.join(tmpdir, "sup")
    sup_out = os.path.join(tmpdir, "sup.npz")
    rc, digest, tail = run_supervisor(
        supervise_cmd(sup_dir, stall_timeout_s=stall_timeout_s,
                      startup_grace_s=startup_grace_s,
                      max_restarts=max_restarts)
        + demo + ["--ckpt-dir", sup_dir, "--out", sup_out, *misbehave],
        sup_dir, env=env, timeout=timeout)
    if digest is None:
        return None, {"error": "no supervisor digest", "rc": rc,
                      "tail": tail[-2000:]}
    return {
        "rc": rc, "digest": digest, "sup_dir": sup_dir,
        "meta": _read_json(sup_out + ".meta.json"),
        "straight_meta": straight_meta,
        "bit_identical": _weights_equal(straight_out, sup_out),
        "corrupt_files": sorted(os.path.basename(p) for p in
                                glob.glob(sup_dir + "/*.corrupt")),
        "starts": attempt_starts(sup_dir),
    }, None


def _detail(ctx, **extra) -> dict:
    digest = ctx["digest"]
    return {
        "time_to_recovered_s": _ttr_from_digest(digest),
        "supervisor": {k: digest.get(k) for k in
                       ("success", "attempts", "restarts",
                        "deadline_aborts", "quarantined")},
        "restored_step": ctx["meta"].get("restored_step"),
        "bit_identical": ctx["bit_identical"],
        "corrupt_files": ctx["corrupt_files"],
        "device": ctx["meta"].get("device"),
        "launches": ctx["meta"].get("launches"),
        "straight_launches": ctx["straight_meta"].get("launches"),
        "attempt_starts": ctx["starts"],
        **extra,
    }


def _killed_once(ctx) -> bool:
    """The gates of a single SIGKILL: success after exactly one restart,
    no deadline abort (a death, not a stall), nothing quarantined (one
    crash at one index is no evidence), no corrupt file, bit identity."""
    d = ctx["digest"]
    return bool(ctx["rc"] == 0 and d.get("success")
                and d.get("restarts") == 1
                and d.get("deadline_aborts") == 0
                and d.get("quarantined") == []
                and not ctx["corrupt_files"]
                and ctx["bit_identical"])


def run_supervised_scenario(tmpdir: str, *, timeout: float = 600,
                            device: str | None = None, demo_args=(),
                            wedge_mode: str = "sigstop",
                            stall_timeout_s: float = 10.0,
                            startup_grace_s: float = 300.0):
    """THE supervisor survival scenario: wedge a training child mid-run
    (SIGSTOP, or ``wedge_mode="sleep"``); the supervisor must deadline-abort
    it (SIGTERM, then SIGKILL), restart it with backoff, resume from
    ``latest_valid_step`` (exactly one chunk replayed), select no corrupt
    snapshot, and reproduce the straight run's final weights bit for bit.
    ``demo_args`` widen the workload (the card's run passes
    ``--num-features 1000000``)."""
    demo = demo_cmd(*SCENARIO_DEMO_ARGS, *demo_args, device=device)
    ctx, err = _supervised_pair(
        tmpdir, demo, ["--wedge-at", str(SCENARIO_WEDGE_AT),
                       "--wedge-mode", wedge_mode],
        timeout=timeout, device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    if err is not None:
        return False, err
    d = ctx["digest"]
    detail = _detail(ctx)
    ok = bool(ctx["rc"] == 0 and d.get("success")
              and d.get("deadline_aborts") == 1
              and d.get("restarts") == 1
              # The wedge fires after chunk SCENARIO_WEDGE_AT trains (the
              # async writer flushed first), before its checkpoint lands:
              # one chunk lost and replayed.
              and ctx["meta"].get("restored_step") == SCENARIO_WEDGE_AT
              and not ctx["corrupt_files"]
              and ctx["bit_identical"])
    return ok, detail


def run_crash_quarantine_scenario(tmpdir: str, *, timeout: float = 600,
                                  device: str | None = None, demo_args=(),
                                  startup_grace_s: float = 300.0):
    """A deterministic poison crash (``--crash-at`` with ``--always``):
    the child exits 3 at the same chunk on every attempt until the
    supervisor quarantines it (two consecutive deaths at one index); the
    third attempt skips it through the carried preset
    (``"quarantine_carried"`` in its log) and must end bit-equal to a
    straight run given the same quarantine through the env contract."""
    from fps_tpu_torch.supervise.child import STATE_ENV

    preset = os.path.join(tmpdir, "preset_state.json")
    with open(preset, "w", encoding="utf-8") as f:
        json.dump({"quarantined": [SCENARIO_CRASH_AT]}, f)
    ctx, err = _supervised_pair(
        tmpdir, demo_cmd(*SCENARIO_DEMO_ARGS, *demo_args, device=device),
        ["--crash-at", str(SCENARIO_CRASH_AT), "--always"],
        timeout=timeout, device=device, stall_timeout_s=60.0,
        startup_grace_s=startup_grace_s, max_restarts=3,
        straight_env={STATE_ENV: preset})
    if err is not None:
        return False, err
    attempts = _read_json(os.path.join(
        ctx["sup_dir"], "supervisor_state.json")).get("attempts", [])
    codes = [a.get("rc") for a in attempts]
    with open(os.path.join(ctx["sup_dir"], f"attempt-{len(codes) - 1}.log"),
              encoding="utf-8", errors="replace") as f:
        carried = '"event": "quarantine_carried"' in f.read()
    detail = _detail(ctx, attempt_codes=codes, quarantine_carried=carried,
                     skipped=ctx["meta"].get("skipped"))
    digest = ctx["digest"]
    ok = bool(ctx["rc"] == 0 and digest.get("success")
              and digest.get("quarantined") == [SCENARIO_CRASH_AT]
              and digest.get("restarts") == 2
              and codes == [3, 3, 0]
              and carried
              and ctx["meta"].get("skipped") == [SCENARIO_CRASH_AT]
              and not ctx["corrupt_files"]
              and ctx["bit_identical"])
    return ok, detail


def run_prefetch_kill_scenario(tmpdir: str, *, timeout: float = 600,
                               device: str | None = None):
    """SIGKILL mid-PREFETCH: the child runs the overlapped host pipeline
    (``--prefetch 2``) and dies while the background worker assembles
    chunk ``SCENARIO_PREFETCH_KILL_AT`` (once), between chunk boundaries.
    The resumed attempt must finish bit-equal to a straight prefetch run;
    the killed attempt's record names one of the driver's sub-phases."""
    demo = demo_cmd(*SCENARIO_DEMO_ARGS, "--prefetch",
                    str(SCENARIO_PREFETCH_DEPTH), device=device)
    ctx, err = _supervised_pair(
        tmpdir, demo, ["--kill-prefetch-at", str(SCENARIO_PREFETCH_KILL_AT)],
        timeout=timeout, device=device, stall_timeout_s=60.0,
        startup_grace_s=300.0)
    if err is not None:
        return False, err
    attempts = _read_json(os.path.join(ctx["sup_dir"],
                                       "supervisor_state.json")).get(
        "attempts", [])
    killed_phase = attempts[0].get("last_phase") if attempts else None
    detail = _detail(ctx, killed_attempt_phase=killed_phase)
    ok = (_killed_once(ctx)
          # Which sub-phase is timing-dependent (the worker dies while the
          # driver is at its own boundary), but it is one of the driver's.
          and killed_phase in ("prefetch", "ingest", "dispatch"))
    return ok, detail


def _kill_at_scenario(tmpdir, demo_extra, kill_at, *, timeout, device,
                      demo_args=(), startup_grace_s=300.0):
    demo = demo_cmd(*SCENARIO_DEMO_ARGS, *demo_args, *demo_extra,
                    device=device)
    return _supervised_pair(tmpdir, demo, ["--kill-at", str(kill_at)],
                            timeout=timeout, device=device,
                            stall_timeout_s=60.0,
                            startup_grace_s=startup_grace_s)


def _tier_args(device):
    """The hot tier needs several positions: on a named device (the CPU,
    or ``cuda:0`` from the chaos sweep), the reference's eight devices as
    eight positions on it."""
    return (("--num-shards", str(SCENARIO_TIER_SHARDS))
            if device is not None else ())


def run_hot_tier_kill_scenario(tmpdir: str, *, timeout: float = 600,
                               device: str | None = None):
    """SIGKILL between hot-tier reconciles: two-tier storage on
    (``--hot-tier`` / ``--hot-sync-every``), the child dies at a chunk
    boundary before its checkpoint lands; the restart restores the last
    snapshot (one canonical table with every hot push folded in),
    re-splits the replica from it and replays bit-equal to a straight
    tiered run."""
    ctx, err = _kill_at_scenario(
        tmpdir, (*_tier_args(device), "--hot-tier", str(SCENARIO_HOT_TIER),
                 "--hot-sync-every", str(SCENARIO_HOT_SYNC)),
        SCENARIO_HOT_KILL_AT, timeout=timeout, device=device)
    if err is not None:
        return False, err
    ok = (_killed_once(ctx)
          and ctx["meta"].get("restored_step") == SCENARIO_HOT_KILL_AT)
    return ok, _detail(ctx)


def run_megastep_kill_scenario(tmpdir: str, *, timeout: float = 600,
                               device: str | None = None, demo_args=(),
                               startup_grace_s: float = 300.0):
    """SIGKILL mid-megastep: the child trains through ``run_megastep``
    (``--megastep K``, checkpoints at megastep boundaries) and dies after
    megastep ``SCENARIO_MEGASTEP_KILL_AT`` trains, before its checkpoint
    lands. The restart resumes at that megastep and must end bit-equal to
    a straight megastep run."""
    ctx, err = _kill_at_scenario(
        tmpdir, ("--megastep", str(SCENARIO_MEGASTEP_K)),
        SCENARIO_MEGASTEP_KILL_AT, timeout=timeout, device=device,
        demo_args=demo_args, startup_grace_s=startup_grace_s)
    if err is not None:
        return False, err
    ok = (_killed_once(ctx)
          and ctx["meta"].get("restored_step") == SCENARIO_MEGASTEP_KILL_AT)
    return ok, _detail(ctx)


def run_reconcile_shard_kill_scenario(tmpdir: str, *, timeout: float = 600,
                                      device: str | None = None):
    """SIGKILL between a sharded reconcile window and the next checkpoint,
    with an Adagrad hot fold (``--hot-fold adagrad``: per-row state sharded
    over the shard axis, saved as ``fold::`` arrays). The restart must
    restore the tables AND the fold state and replay bit-equal; a fold
    restarted from zeros would diverge."""
    import numpy as np

    ctx, err = _kill_at_scenario(
        tmpdir, (*_tier_args(device), "--hot-tier", str(SCENARIO_FOLD_TIER),
                 "--hot-sync-every", str(SCENARIO_FOLD_SYNC),
                 "--hot-fold", "adagrad"),
        SCENARIO_FOLD_KILL_AT, timeout=timeout, device=device)
    if err is not None:
        return False, err
    fold_persisted = False
    snaps = sorted(glob.glob(os.path.join(ctx["sup_dir"], "ckpt_*.npz")))
    if snaps:
        with np.load(snaps[-1]) as z:
            fold_persisted = any(k.startswith("fold::") for k in z.files)
    ok = (_killed_once(ctx)
          and ctx["meta"].get("restored_step") == SCENARIO_FOLD_KILL_AT
          and fold_persisted)
    return ok, _detail(ctx, fold_persisted=fold_persisted)


def run_retier_kill_scenario(tmpdir: str, *, timeout: float = 600,
                             device: str | None = None):
    """SIGKILL between a hot-set re-rank and the next checkpoint, with the
    adaptive tier on (``--retier-every``: mapped hot set, forced re-rank
    every check, tracker sidecars beside the checkpoints). The restart
    restores the snapshot and the matching sidecar, re-derives the replica
    and slot map, and replays bit-equal: its re-rank decisions are the
    straight run's."""
    ctx, err = _kill_at_scenario(
        tmpdir, (*_tier_args(device), "--hot-tier", str(SCENARIO_HOT_TIER),
                 "--hot-sync-every", str(SCENARIO_HOT_SYNC),
                 "--retier-every", str(SCENARIO_RETIER_EVERY)),
        SCENARIO_RETIER_KILL_AT, timeout=timeout, device=device)
    if err is not None:
        return False, err
    meta, straight_meta = ctx["meta"], ctx["straight_meta"]
    detail = _detail(ctx, sidecar_restored=meta.get("tiering_restored"),
                     re_ranks=[straight_meta.get("re_ranks"),
                               meta.get("re_ranks")])
    ok = (_killed_once(ctx)
          and meta.get("restored_step") == SCENARIO_RETIER_KILL_AT
          # The restart really restored the step-3 sidecar: without it the
          # bit identity would be luck.
          and meta.get("tiering_restored") is True
          # The straight run re-ranked at least once (forced cadence).
          and (straight_meta.get("re_ranks") or 0) >= 1)
    return ok, detail


def run_serve_while_train_scenario(tmpdir: str, *, timeout: float = 600,
                                   device: str | None = None):
    """Serve-while-train survival (:mod:`fps_tpu_torch.serve`): a
    ReadServer polls a supervised child's checkpoint directory the whole
    run while the child is SIGKILLed after chunk
    ``SCENARIO_SERVE_KILL_AT`` and a torn full-named snapshot candidate is
    planted mid-run. Readers never see a torn or CRC-failing table, the
    served step only moves forward (kill and restart included), the run
    ends on the newest valid snapshot's bytes, and quarantining the served
    snapshot swaps the reader BACKWARD to the survivor."""
    import time as _time

    import numpy as np

    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.serve import ReadServer, SnapshotWatcher

    env = _env(device)
    sup_dir = os.path.join(tmpdir, "sup")
    sup_out = os.path.join(tmpdir, "sup.npz")
    os.makedirs(sup_dir, exist_ok=True)
    proc = subprocess.Popen(
        supervise_cmd(sup_dir)
        + demo_cmd(*SCENARIO_DEMO_ARGS, device=device)
        + ["--ckpt-dir", sup_dir, "--out", sup_out,
           "--kill-at", str(SCENARIO_SERVE_KILL_AT)],
        env=env, cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    server = ReadServer()
    swap_trail: list[tuple[str, int]] = []

    def on_swap(snap, direction):
        server.swap_to(snap)
        swap_trail.append((direction, snap.step))

    watcher = SnapshotWatcher(sup_dir, on_swap=on_swap)
    violations: list[str] = []
    served_steps: list[int] = []
    torn_planted = None
    deadline = _time.monotonic() + timeout
    try:
        while proc.poll() is None and _time.monotonic() < deadline:
            watcher.poll()
            snap = server._snap
            if snap is not None:
                step, rows = server.pull("weights", np.arange(
                    snap.tables["weights"].shape[0]))
                if not np.all(np.isfinite(rows)):
                    violations.append(
                        f"non-finite rows served at step {step}")
                if served_steps and step < served_steps[-1]:
                    violations.append(
                        "served step went backward without a quarantine: "
                        f"{served_steps[-1]} -> {step}")
                served_steps.append(step)
                if torn_planted is None:
                    # A partial write that reached a published name, newer
                    # than everything real: the watcher must refuse it,
                    # and the restarted child's restore quarantines it.
                    torn_planted = fmt.snapshot_path(sup_dir, snap.step + 50)
                    with open(torn_planted, "wb") as f:
                        f.write(b"PK\x03\x04" + b"\xde\xad" * 512)
            _time.sleep(0.05)
        stdout, stderr = proc.communicate(
            timeout=max(5.0, deadline - _time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        kill_attempts(sup_dir)
        return False, {"error": "supervised run timed out"}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
            kill_attempts(sup_dir)
    try:
        digest = json.loads(stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return False, {"error": "no supervisor digest",
                       "tail": (stdout + stderr)[-2000:]}

    # The reader ends on the newest valid snapshot with exactly its bytes.
    watcher.poll()
    final = fmt.latest_valid_snapshot(sup_dir)
    final_consistent = False
    if final is not None and server._snap is not None:
        want = fmt.map_snapshot_arrays(final[1])["table::weights"]
        _, got = server.pull("weights", np.arange(want.shape[0]))
        final_consistent = bool(server._snap.step == final[0]
                                and np.array_equal(got, want))
    # Rollback leg: quarantine the served snapshot as the trainer does
    # (the *.corrupt rename); the reader must swap backward.
    backward_ok = False
    if server._snap is not None:
        quarantined_step = server._snap.step
        path = fmt.snapshot_path(sup_dir, quarantined_step)
        os.replace(path, path + ".corrupt")
        watcher.poll()
        snap = server._snap
        backward_ok = bool(snap is not None
                           and snap.step < quarantined_step
                           and swap_trail[-1][0] == "backward"
                           and np.all(np.isfinite(
                               server.pull("weights", [0, 1])[1])))
    detail = {
        "time_to_recovered_s": _ttr_from_digest(digest),
        "supervisor": {k: digest.get(k) for k in
                       ("success", "attempts", "restarts",
                        "deadline_aborts", "quarantined")},
        "polls_served": len(served_steps),
        "served_step_span": ([served_steps[0], served_steps[-1]]
                             if served_steps else None),
        "swap_trail": swap_trail,
        "rejected_snapshots": watcher.rejected,
        "violations": violations,
        "final_consistent": final_consistent,
        "backward_swap_ok": backward_ok,
    }
    ok = bool(proc.returncode == 0 and digest.get("success")
              and digest.get("restarts") == 1
              and not violations
              and len(served_steps) > 0
              and watcher.rejected >= 1
              and final_consistent
              and backward_ok)
    return ok, detail


def _compaction_victim(ckpt_dir: str, phase: str) -> None:
    """Subprocess body of the compaction kill: build a real delta chain,
    record its resolved state as ``expected.npz``, then SIGKILL itself at
    the named compaction phase (``precommit`` / ``published`` /
    ``swept_one``, the Checkpointer's chaos seam). The parent checks the
    recovery with ``snapshot_format`` alone."""
    import numpy as np

    from fps_tpu_torch.core.checkpoint import (
        Checkpointer,
        DeltaPolicy,
        load_rows,
    )
    from fps_tpu_torch.core.store import ParamStore, TableSpec
    from fps_tpu_torch.parallel.mesh import make_ps_mesh
    from fps_tpu_torch.testing import chaos

    mesh = make_ps_mesh(device="cpu")
    store = ParamStore(mesh, [TableSpec("w", num_ids=1024, dim=8)])
    store.init(0)
    ck = Checkpointer(ckpt_dir, keep=30, delta=DeltaPolicy(full_every=50))
    ck.save(1, store, None)
    rng = np.random.default_rng(7)
    for step in range(2, 6):
        ids = np.unique(rng.integers(0, 1024, 16))
        rows = store.lookup_host("w", ids)
        load_rows(store, "w", ids, rows + float(step))
        ck.save(step, store, None, touched_rows={"w": ids})
    np.savez(os.path.join(ckpt_dir, "expected.npz"),
             w=store.lookup_host("w", np.arange(1024)))
    if phase != "none":
        ck._compact_phase_hook = (
            lambda p: chaos.sigkill_self() if p == phase else None)
    ck.compact()


def run_delta_chain_kill_scenario(tmpdir: str, *, timeout: float = 600,
                                  device: str | None = None):
    """Delta-snapshot chains are crash-safe, in two legs:

    * **mid-chain publish kill**: a supervised child publishing one full
      and per-chunk deltas is SIGKILLed after chunk
      ``SCENARIO_DELTA_KILL_AT`` trains; the restart walks the chain to its
      last verified link (``restored_step == kill_at``), replays one
      chunk, and ends bit-equal to a straight delta run, itself bit-equal
      to a straight FULL-snapshot run;
    * **compaction kill, every phase**: a victim folding a real chain is
      SIGKILLed at each compaction phase; after every crash the directory
      still resolves to the same state, and a rerun compaction completes
      and keeps it.
    """
    import numpy as np

    from fps_tpu_torch.core import snapshot_format as fmt

    env = _env(device)
    demo = demo_cmd(*SCENARIO_DELTA_ARGS, device=device)
    detail: dict = {}
    base_out, _, err = _straight(
        tmpdir, demo_cmd(*SCENARIO_DELTA_BASE_ARGS, device=device), "base",
        env=env, timeout=timeout)
    if err is not None:
        return False, err
    ctx, err = _supervised_pair(
        tmpdir, demo, ["--kill-at", str(SCENARIO_DELTA_KILL_AT)],
        timeout=timeout, device=device, stall_timeout_s=60.0,
        startup_grace_s=300.0)
    if err is not None:
        return False, err
    straight_meta, meta = ctx["straight_meta"], ctx["meta"]
    delta_vs_full = _weights_equal(base_out,
                                   os.path.join(tmpdir, "straight.npz"))
    detail["delta_publishes"] = straight_meta.get("delta_publishes")
    detail["delta_encoding_bit_identical"] = delta_vs_full
    detail["supervised"] = {
        "restarts": ctx["digest"].get("restarts"),
        "restored_step": meta.get("restored_step"),
        "delta_publishes": meta.get("delta_publishes"),
        "bit_identical": ctx["bit_identical"],
        "time_to_recovered_s": _ttr_from_digest(ctx["digest"]),
    }
    sup_ok = bool(ctx["rc"] == 0 and ctx["digest"].get("success")
                  and ctx["digest"].get("restarts") == 1
                  and meta.get("restored_step") == SCENARIO_DELTA_KILL_AT
                  and (straight_meta.get("delta_publishes") or 0) >= 2
                  and (meta.get("delta_publishes") or 0) >= 1
                  and delta_vs_full and ctx["bit_identical"])

    # Every phase of the fold must leave a recoverable directory that
    # keeps the state.
    cpu_env = _env("cpu")
    phases = {}
    for phase in ("precommit", "published", "swept_one"):
        d = os.path.join(tmpdir, f"compact_{phase}")
        victim = subprocess.run(
            [sys.executable, "-c",
             "from fps_tpu_torch.testing.supervised_demo import "
             f"_compaction_victim; _compaction_victim({d!r}, {phase!r})"],
            env=cpu_env, cwd=_ROOT, capture_output=True, text=True,
            timeout=timeout)
        killed = victim.returncode == -9
        ok_state = False
        want = None
        if os.path.exists(os.path.join(d, "expected.npz")):
            with np.load(os.path.join(d, "expected.npz")) as z:
                want = z["w"]
        resolved = fmt.latest_valid_chain(d)
        if resolved is not None and want is not None:
            entries = fmt.resolve_chain_entries(resolved[1])
            ok_state = (resolved[0] == 5
                        and np.array_equal(entries["table::w"], want))
        rerun = subprocess.run(
            [sys.executable, "-c",
             "from fps_tpu_torch.core.checkpoint import Checkpointer, "
             "DeltaPolicy; Checkpointer("
             f"{d!r}, keep=30, delta=DeltaPolicy()).compact()"],
            env=cpu_env, cwd=_ROOT, capture_output=True, text=True,
            timeout=timeout)
        ok_rerun = False
        resolved2 = fmt.latest_valid_chain(d)
        if rerun.returncode == 0 and resolved2 is not None and (
                want is not None):
            entries2 = fmt.resolve_chain_entries(resolved2[1])
            ok_rerun = (resolved2[0] == 5
                        and resolved2[1][-1].kind == "full"
                        and np.array_equal(entries2["table::w"], want))
        phases[phase] = {"killed": killed, "recovered": ok_state,
                         "rerun_compacts": ok_rerun}
    detail["compaction"] = phases
    compact_ok = all(v["killed"] and v["recovered"] and v["rerun_compacts"]
                     for v in phases.values())
    return sup_ok and compact_ok, detail


def run_fleet_fence_scenario(tmpdir: str, *, timeout: float = 600,
                             device: str | None = None):
    """A step-fenced serving fleet under churn: ``SCENARIO_FLEET_READERS``
    fence-coordinated readers poll a supervised delta-publishing child's
    directory while the child is SIGKILLed and restarted, and ONE reader
    is itself dropped and restarted mid-run. The fence only moves forward,
    no reader serves a step older than the fence it saw at its own swap,
    the restarted reader's first step is at or past the fence at its
    construction, and the fleet converges on the newest publication,
    byte-identical to the resolved chain."""
    import time as _time

    import numpy as np

    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.serve import FleetReader, ServingFleet

    env = _env(device)
    sup_dir = os.path.join(tmpdir, "sup")
    sup_out = os.path.join(tmpdir, "sup.npz")
    os.makedirs(sup_dir, exist_ok=True)
    proc = subprocess.Popen(
        supervise_cmd(sup_dir)
        + demo_cmd(*SCENARIO_DELTA_ARGS, device=device)
        + ["--ckpt-dir", sup_dir, "--out", sup_out,
           "--kill-at", str(SCENARIO_DELTA_KILL_AT)],
        env=env, cwd=_ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    fleet = ServingFleet(sup_dir, SCENARIO_FLEET_READERS, quorum=2)
    violations: list[str] = []
    fence_trail: list[tuple[int, int]] = []
    restarted_first: list[tuple[int, int | None]] = []
    reader_killed = False
    deadline = _time.monotonic() + timeout
    polls = 0
    try:
        while proc.poll() is None and _time.monotonic() < deadline:
            fleet.poll()
            polls += 1
            fence = fleet.readers[0].fence.read()
            if fence is not None:
                if fence_trail and fence < fence_trail[-1]:
                    violations.append(
                        f"fence went backward: {fence_trail[-1]} -> {fence}")
                if not fence_trail or fence != fence_trail[-1]:
                    fence_trail.append(fence)
            for r in fleet.readers:
                if r.server._snap is None:
                    continue
                step, rows = r.server.pull("weights", np.arange(64))
                if not np.all(np.isfinite(rows)):
                    violations.append(
                        f"{r.reader_id}: non-finite rows at step {step}")
            if (not reader_killed and fence_trail
                    and fence_trail[-1][1] >= 2):
                # Drop reader r1 (a SIGKILL from its own point of view) and
                # restart it: a new FleetReader that must read the fence
                # BEFORE serving anything.
                reader_killed = True
                fence_at_boot = fleet.readers[1].fence.read()
                fleet.readers[1] = FleetReader(sup_dir, "r1", quorum=2)
                nr = fleet.readers[1]
                nr.poll()
                first = (None if nr.server._snap is None
                         else nr.server._snap.step)
                restarted_first.append((fence_at_boot[1], first))
                if first is not None and first < fence_at_boot[1]:
                    violations.append(
                        f"restarted reader served {first} below the boot "
                        f"fence {fence_at_boot[1]}")
            _time.sleep(0.05)
        stdout, stderr = proc.communicate(
            timeout=max(5.0, deadline - _time.monotonic()))
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.communicate()
        kill_attempts(sup_dir)
        return False, {"error": "supervised run timed out"}
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.communicate()
            kill_attempts(sup_dir)
    try:
        digest = json.loads(stdout.strip().splitlines()[-1])
    except (json.JSONDecodeError, IndexError):
        return False, {"error": "no supervisor digest",
                       "tail": (stdout + stderr)[-2000:]}

    for _ in range(6):
        fleet.poll()
    final = fmt.latest_valid_chain(sup_dir)
    converged = False
    if final is not None:
        want = fmt.resolve_chain_entries(final[1])["table::weights"]
        converged = True
        for r in fleet.readers:
            snap = r.server._snap
            if snap is None or snap.step != final[0]:
                converged = False
                break
            _, got = r.server.pull("weights", np.arange(want.shape[0]))
            if not np.array_equal(got, want):
                converged = False
                break
    monotone = all(all(b >= a for a, b in zip(r.served_steps,
                                              r.served_steps[1:]))
                   for r in fleet.readers)
    chain_served = max((r.server._snap.chain_len for r in fleet.readers
                        if r.server._snap is not None), default=0)
    detail = {
        "time_to_recovered_s": _ttr_from_digest(digest),
        "supervisor": {k: digest.get(k) for k in ("success", "restarts")},
        "polls": polls,
        "fence_trail": fence_trail[-8:],
        "restarted_reader": restarted_first,
        "served_monotone": monotone,
        "max_chain_len_served": chain_served,
        "violations": violations,
        "converged": converged,
    }
    ok = bool(proc.returncode == 0 and digest.get("success")
              and digest.get("restarts") == 1
              and reader_killed and not violations and monotone
              and len(fence_trail) >= 2
              and chain_served >= 2
              and converged)
    return ok, detail



# ---------------------------------------------------------------------------
# Pod scenarios: N member agents (the port's CLI in pod mode) over one
# shared pod dir, each supervising its own replica of the demo child: the
# single-machine stand-in for N symmetric hosts of one job.
# ---------------------------------------------------------------------------

SCENARIO_POD_HOSTS = ("h0", "h1", "h2")
SCENARIO_POD_KILL_AT = 3
SCENARIO_POD_CRASH_AT = 5
# The partition scenario needs the children still RUNNING when the
# post-seizure fence lands (a few seconds after the leader freezes), so
# the stale leader's orphan demonstrably hits the fence: every chunk
# boundary of the pod's children sleeps. The straight run leaves the
# sleep out (it changes no number).
SCENARIO_PARTITION_ARGS = ("--examples", "8000", "--epochs", "6")
SCENARIO_PARTITION_PACE = ("--chunk-sleep-s", "0.3")
SCENARIO_ELASTIC_ARGS = ("--examples", "20000", "--epochs", "4")
# The flapping member's quarantine changes the trajectory, so every member
# must restore the commanded common step itself; a sibling that runs more
# than ``--keep`` chunks past it before the leader's decision has lost that
# snapshot and resumes from its own newest one. The port's children train
# a chunk in milliseconds, so the pod's children pace each chunk boundary
# (a start skew of up to 20 chunks, 4 s, stays inside the window); the
# straight run leaves the sleep out.
SCENARIO_FLAP_PACE = ("--chunk-sleep-s", "0.2")
TRACE_EXPORT = os.path.join(_ROOT, "fps_tpu_torch", "examples",
                            "trace_export.py")


def _load_trace_export():
    """``fps_tpu_torch/examples/trace_export.py`` by file path."""
    import importlib.util

    spec = importlib.util.spec_from_file_location("_fps_torch_trace_export",
                                                  TRACE_EXPORT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _export_pod_trace(pod_dir: str):
    """The pod scenarios' trace evidence: the pod dir's merged
    Chrome/Perfetto trace (written next to the journals) and a summary of
    the coordinated-restart span trees, one entry a ``pod_restart``
    decision, with the hosts of its attempt children and whether every
    child carries the decision's fencing epoch."""
    te = _load_trace_export()
    spans = te.collect_spans([pod_dir])
    doc = te.export_chrome(spans)
    out_path = os.path.join(pod_dir, "pod_trace.json")
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(doc, f, default=str)
    summary = []
    for tree in te.coordinated_restart_trees(spans):
        children = tree["children"]
        attempts = [c for c in children if c["cat"] == "attempt"]
        epoch = tree["epoch"]
        summary.append({
            "epoch": epoch,
            "children": len(children),
            "attempt_hosts": sorted({c.get("host") for c in attempts}),
            # Attempts carry the epoch as pod_epoch, the fence write as
            # min_epoch.
            "children_carry_epoch": all(
                (c["attrs"].get("pod_epoch") if c["cat"] == "attempt"
                 else c["attrs"].get("min_epoch")) == epoch
                for c in children) if children else False,
        })
    return {"trace_path": out_path, "trace_events": len(doc["traceEvents"]),
            "spans": len(spans), "restart_trees": summary}


def _pod_fleet_digest(pod_dir: str, hosts):
    """Fleet rollup and SLO burn over the member dirs (each holds its
    child's ``--obs-dir`` telemetry beside its snapshots) and the pod dir
    (``journal-pod.jsonl``'s restarts)."""
    from fps_tpu_torch.obs import fleet

    digest = fleet.fleet_digest(
        [pod_dir] + [os.path.join(pod_dir, h) for h in hosts])
    roll = digest["rollup"]
    return {"hosts": roll["hosts"], "window_s": roll["window_s"],
            "windows": len(roll["windows"]), "totals": roll["totals"],
            "slo": digest["slo"]}


def pod_member_cmd(pod_dir: str, host: str, pod_size: int, child_args, *,
                   device: str | None = None, pod_flags=(), member_flags=(),
                   stall_timeout_s: float = 20.0,
                   startup_grace_s: float = 300.0) -> list[str]:
    """argv of one pod member: the port's CLI in pod mode, run by path with
    torch and jax unimportable, over the demo child, whose checkpoints,
    telemetry and output land in ``POD_DIR/HOST``. ``member_flags`` come
    last, so they override the defaults (argparse keeps the last)."""
    member_dir = os.path.join(pod_dir, "{host}")
    return [
        sys.executable, "-c", _NO_TORCH, CLI,
        "--pod-dir", pod_dir, "--pod-host", host,
        "--pod-size", str(pod_size), *pod_flags,
        "--stall-timeout-s", str(stall_timeout_s),
        "--startup-grace-s", str(startup_grace_s),
        "--term-grace-s", "2", "--backoff-base-s", "0.2",
        "--backoff-max-s", "2", "--max-restarts", "6",
        "--poll-s", "0.15", "--lease-ttl-s", "1.5",
        "--member-timeout-s", "4", *member_flags, "--",
        *demo_cmd(*child_args, "--keep", "20", "--ckpt-dir", member_dir,
                  "--obs-dir", member_dir,
                  "--out", os.path.join(member_dir, "out.npz"),
                  device=device),
    ]


def _launch_pod(pod_dir: str, child_args, *, device, hosts=SCENARIO_POD_HOSTS,
                pod_flags=(), member_flags=(), stall_timeout_s=20.0,
                startup_grace_s=300.0, pod_size=None):
    """Start one member process a host; returns ``{host: Popen}``."""
    os.makedirs(pod_dir, exist_ok=True)
    env = _env(device)
    return {h: subprocess.Popen(
        pod_member_cmd(pod_dir, h, pod_size or len(hosts), child_args,
                       device=device, pod_flags=pod_flags,
                       member_flags=member_flags,
                       stall_timeout_s=stall_timeout_s,
                       startup_grace_s=startup_grace_s),
        env=env, cwd=_ROOT, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for h in hosts}


def _collect_pod(procs: dict, pod_dir: str, timeout: float) -> dict:
    """Wait for every member: ``{host: {"rc", "digest", "tail"}}``. A
    member still running at ``timeout`` is killed with every attempt its
    journal started (``rc`` None)."""
    import time as _time

    out = {}
    deadline = _time.monotonic() + timeout
    for h, p in procs.items():
        try:
            stdout, _ = p.communicate(
                timeout=max(5.0, deadline - _time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            stdout, _ = p.communicate()
            kill_attempts(os.path.join(pod_dir, h))
            out[h] = {"rc": None, "digest": None, "tail": stdout[-1200:]}
            continue
        try:
            digest = json.loads(stdout.strip().splitlines()[-1])
        except (json.JSONDecodeError, IndexError):
            digest = None
        out[h] = {"rc": p.returncode, "digest": digest,
                  "tail": stdout[-1200:]}
    return out


def _kill_pod(procs: dict, pod_dir: str) -> None:
    """Kill every member still running and every attempt it started."""
    for h, p in procs.items():
        if p.poll() is None:
            p.kill()
            p.communicate()
        kill_attempts(os.path.join(pod_dir, h))


def _abandon(procs: dict, pod_dir: str, straight) -> None:
    """Stop a pod scenario's members, their attempts and its straight run
    on a way out before the pod ends."""
    _kill_pod(procs, pod_dir)
    straight[0].kill()
    straight[0].communicate()


def _start_pod_straight(tmpdir: str, child_args, *, device,
                        preset_quarantine=None):
    """Start the pod's unsupervised twin in the background (it runs beside
    the pod: it shares nothing with it but the card). With
    ``preset_quarantine`` it carries that quarantine through the
    supervised-child env contract (the straight twin of a pod run that
    quarantined those chunks)."""
    from fps_tpu_torch.supervise.child import STATE_ENV

    extra = None
    if preset_quarantine:
        state = os.path.join(tmpdir, "straight_state.json")
        with open(state, "w", encoding="utf-8") as f:
            json.dump({"quarantined": sorted(preset_quarantine)}, f)
        extra = {STATE_ENV: state}
    return _start_straight(tmpdir, demo_cmd(*child_args, device=device),
                           "straight", env=_env(device), extra_env=extra)


def _pod_dirs_clean(pod_dir: str, hosts) -> list[str]:
    """``*.corrupt`` files and TORN published snapshots across the member
    dirs; must be empty. (``*.tmp.npz`` leftovers of a child SIGKILLed
    mid-write were never published, and the checkpointer sweeps them.)"""
    import zipfile

    bad = [p for h in hosts
           for p in glob.glob(os.path.join(pod_dir, h, "*.corrupt"))]
    for h in hosts:
        for p in glob.glob(os.path.join(pod_dir, h, "ckpt_*.npz")):
            try:
                with zipfile.ZipFile(p) as z:
                    if z.testzip() is None:
                        continue
            except (OSError, zipfile.BadZipFile):
                pass
            bad.append(p + ":torn")
    return sorted(os.path.relpath(p, pod_dir) for p in bad)


def _stale_publishes(pod_dir: str, hosts) -> list[str]:
    """Snapshots written AFTER their dir's fence yet stamped with an epoch
    below it: the publishes the fence exists to prevent. Must be empty."""
    import numpy as np

    bad = []
    for h in hosts:
        d = os.path.join(pod_dir, h)
        fence_path = os.path.join(d, "pod_fence.json")
        try:
            with open(fence_path, encoding="utf-8") as f:
                fence = json.load(f)
            fence_mtime = os.stat(fence_path).st_mtime_ns
            min_epoch = int(fence["min_epoch"])
        except (OSError, KeyError, ValueError, json.JSONDecodeError):
            continue
        for p in sorted(glob.glob(os.path.join(d, "ckpt_*.npz"))):
            try:
                if os.stat(p).st_mtime_ns <= fence_mtime:
                    continue
                with np.load(p) as z:
                    epoch = (int(z["meta::pod_epoch"])
                             if "meta::pod_epoch" in z.files else None)
            except (OSError, ValueError):
                continue
            if epoch is not None and epoch < min_epoch:
                bad.append(f"{h}/{os.path.basename(p)}:epoch{epoch}"
                           f"<fence{min_epoch}")
    return bad


def _pod_bit_identity(pod_dir: str, hosts, straight_out: str):
    """``(all identical, per-host verdict)`` of the members' outputs
    against the straight run's, byte for byte."""
    detail = {h: _weights_equal(os.path.join(pod_dir, h, "out.npz"),
                                straight_out) for h in hosts}
    return all(detail.values()), detail


def _pod_children(pod_dir: str, hosts) -> dict:
    """Each member's attempts' ``demo_start`` lines and its final meta
    (device, free card memory at each start, launch counts)."""
    return {h: {"attempt_starts": attempt_starts(os.path.join(pod_dir, h)),
                "meta": _read_json(os.path.join(pod_dir, h,
                                                "out.npz.meta.json"))}
            for h in hosts}


def _pod_detail(res, pod_dir, hosts, straight_out, straight_meta, keys,
                **extra):
    """``(bit identical, detail)``: the gates' evidence every pod scenario
    shares."""
    digests = {h: r["digest"] for h, r in res.items()}
    bit_identical, bit_detail = _pod_bit_identity(pod_dir, hosts,
                                                  straight_out)
    return bit_identical, {
        "digests": {h: {k: d.get(k) for k in keys}
                    for h, d in digests.items()},
        "bit_identical": bit_detail,
        "debris": _pod_dirs_clean(pod_dir, hosts),
        "stale_publishes": _stale_publishes(pod_dir, hosts),
        "children": _pod_children(pod_dir, hosts),
        "straight_launches": straight_meta.get("launches"),
        "lease_seizures": _pod_events(pod_dir, "lease_seized"),
        **extra,
    }


def _pod_events(pod_dir: str, name: str) -> int:
    """How many ``name`` events the pod journal holds."""
    return sum(1 for r in _jsonl(os.path.join(pod_dir, "journal-pod.jsonl"))
               if r.get("event") == name)


def _missing_digest(res):
    if any(r["digest"] is None for r in res.values()):
        return {"error": "missing member digest",
                "tails": {h: r["tail"] for h, r in res.items()}}
    return None


def run_pod_kill_one_host_scenario(tmpdir: str, *, timeout: float = 600,
                                   device: str | None = None, demo_args=(),
                                   stall_timeout_s: float = 20.0,
                                   startup_grace_s: float = 300.0):
    """ONE member's child is SIGKILLed mid-run (``--kill-at`` on h1): the
    leader must make ONE pod-wide decision, a coordinated abort of every
    member's child and the restart of all three from the COMMON
    ``latest_valid_step``, after which every member finishes bit-identical
    to an uninterrupted run. One death quarantines nothing and evicts
    nobody; the restart exports as ONE span tree whose attempt children,
    one a host, all carry its fencing epoch."""
    args = (*SCENARIO_DEMO_ARGS, *demo_args)
    straight = _start_pod_straight(tmpdir, args, device=device)
    pod_dir = os.path.join(tmpdir, "pod")
    procs = _launch_pod(
        pod_dir, (*args, "--kill-at", str(SCENARIO_POD_KILL_AT),
                  "--misbehave-host", "h1"),
        device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    try:
        res = _collect_pod(procs, pod_dir, timeout)
    finally:
        straight_out, straight_meta, err = _finish_straight(straight,
                                                            timeout)
    if err is not None:
        return False, err
    missing = _missing_digest(res)
    if missing is not None:
        return False, missing
    digests = {h: r["digest"] for h, r in res.items()}
    trace = _export_pod_trace(pod_dir)
    trees = trace["restart_trees"]
    trace_ok = (len(trees) == 1
                and trees[0]["attempt_hosts"] == sorted(SCENARIO_POD_HOSTS)
                and trees[0]["children_carry_epoch"]
                and trace["trace_events"] > 0)
    bit_identical, detail = _pod_detail(
        res, pod_dir, SCENARIO_POD_HOSTS, straight_out, straight_meta,
        ("success", "attempts", "epoch", "pod"),
        kill_fired=os.path.exists(os.path.join(pod_dir, "h1",
                                               "kill_at.done")),
        trace=trace, fleet=_pod_fleet_digest(pod_dir, SCENARIO_POD_HOSTS),
        time_to_recovered_s=_pod_recovery(pod_dir, SCENARIO_POD_HOSTS))
    ok = (all(r["rc"] == 0 and r["digest"]["success"]
              for r in res.values())
          # One pod-wide decision, not per-host timers.
          and all(d["pod"]["restarts"] == 1 for d in digests.values())
          and all(d["pod"]["quarantined"] == [] for d in digests.values())
          and all(d["pod"]["evicted"] == [] for d in digests.values())
          and detail["kill_fired"]
          and trace_ok
          and not detail["debris"] and not detail["stale_publishes"]
          and bit_identical)
    return ok, detail


def _jsonl(path: str) -> list[dict]:
    try:
        with open(path, encoding="utf-8") as f:
            return [json.loads(line) for line in f if line.strip()]
    except (OSError, json.JSONDecodeError):
        return []


def _pod_recovery(pod_dir: str, hosts):
    """Seconds from the pod's first failure (the earliest failed attempt's
    end in a member's supervisor journal, or the leader's first
    ``member_failed``) to the moment every member's last attempt finished
    its first chunk (the ``chunk`` events of the children's run journals
    beside the snapshots); ``None`` when nothing failed. PodMember journals
    no first signal, so ``recovery_times`` has nothing to pair here."""
    fails = [r["t"] for r in _jsonl(os.path.join(pod_dir,
                                                 "journal-pod.jsonl"))
             if r.get("event") == "member_failed"]
    firsts = []
    for h in hosts:
        fails += [r["t"] for r in _jsonl(os.path.join(
            pod_dir, h, "journal-supervisor.jsonl"))
            if r.get("event") == "attempt_end" and r.get("rc")]
        events = [r for path in sorted(glob.glob(os.path.join(
            pod_dir, h, "journal-p*.jsonl"))) for r in _jsonl(path)
            if r.get("kind") == "event"]
        starts = [r["t"] for r in events if r.get("event") == "run_start"]
        chunks = [r["t"] for r in events if r.get("event") == "chunk"
                  and starts and r["t"] >= starts[-1]]
        firsts.append(min(chunks) if chunks else None)
    if not fails or None in firsts:
        return None
    return round(max(firsts) - min(fails), 3)


def run_pod_partition_coordinator_scenario(tmpdir: str, *,
                                           timeout: float = 600,
                                           device: str | None = None,
                                           demo_args=(),
                                           stall_timeout_s: float = 20.0,
                                           startup_grace_s: float = 300.0):
    """The LEASE HOLDER's member agent is SIGSTOPped mid-run (a partitioned
    coordinator host: its child keeps training, orphaned). A follower must
    seize the expired lease (fencing epoch bump), treat the unreachable
    member as failed, fence every member dir and command a coordinated
    restart, and the stale leader's orphan child must be REFUSED by the
    fence at its next publish. On SIGCONT the deposed leader rejoins as a
    follower and the pod completes bit-identical to an uninterrupted
    run."""
    import signal as _signal
    import time as _time

    args = (*SCENARIO_PARTITION_ARGS, *demo_args)
    straight = _start_pod_straight(tmpdir, args, device=device)
    pod_dir = os.path.join(tmpdir, "pod")
    # Tighter unreachable-member detection: the fence must land while the
    # frozen leader's orphan is still mid-run.
    procs = _launch_pod(pod_dir, (*args, *SCENARIO_PARTITION_PACE),
                        device=device, member_flags=("--member-timeout-s",
                                                     "3"),
                        stall_timeout_s=stall_timeout_s,
                        startup_grace_s=startup_grace_s)
    lease_path = os.path.join(pod_dir, "pod_lease.json")
    deadline = _time.monotonic() + timeout
    leader = seized_by = stopped_pid = None
    try:
        # Wait for a leader and its first published snapshot (the run is
        # really underway), then freeze the leader's member agent.
        while _time.monotonic() < deadline:
            lease = _read_json(lease_path)
            if lease.get("host"):
                mem = _read_json(os.path.join(pod_dir, "members",
                                              lease["host"] + ".json"))
                if (mem.get("latest_step") or 0) >= 1:
                    leader = lease["host"]
                    stopped_pid = procs[leader].pid
                    os.kill(stopped_pid, _signal.SIGSTOP)
                    break
            _time.sleep(0.1)
        if leader is None:
            _abandon(procs, pod_dir, straight)
            return False, {"error": "no leader emerged"}
        # Wait for the seizure (the lease's holder changes).
        while _time.monotonic() < deadline:
            lease = _read_json(lease_path)
            if lease.get("host") not in (None, leader):
                seized_by = lease["host"]
                break
            _time.sleep(0.1)
        # Time for the new leader to fence and restart, and for the orphan
        # to run into the fence; then release the old leader.
        _time.sleep(6.0)
    except BaseException:
        _abandon(procs, pod_dir, straight)
        raise
    finally:
        if stopped_pid is not None:
            try:
                os.kill(stopped_pid, _signal.SIGCONT)
            except ProcessLookupError:
                pass
    res = _collect_pod(procs, pod_dir,
                       max(10.0, deadline - _time.monotonic()))
    straight_out, straight_meta, err = _finish_straight(straight, timeout)
    if err is not None:
        return False, err
    missing = _missing_digest(res)
    if missing is not None:
        return False, dict(missing, leader=leader)
    digests = {h: r["digest"] for h, r in res.items()}
    # The orphan's epitaph: its attempt log shows the fence's refusal.
    fenced_logs = []
    for p in glob.glob(os.path.join(pod_dir, leader, "attempt-*.log")):
        with open(p, encoding="utf-8", errors="replace") as f:
            if "StaleEpochError" in f.read():
                fenced_logs.append(os.path.basename(p))
    trace = _export_pod_trace(pod_dir)
    trees = trace["restart_trees"]
    # The FINAL coordinated restart (the new leader's post-seizure
    # decision) exports as exactly one tree gathering the whole pod; a
    # paced unreachable-member incident may spend a second restart while
    # the old leader is frozen, each its own well-formed tree.
    final = [t for t in trees
             if t["epoch"] == max(x["epoch"] for x in trees)]
    trace_ok = (len(trees) >= 1 and len(final) == 1
                and final[0]["attempt_hosts"] == sorted(SCENARIO_POD_HOSTS)
                and all(t["children_carry_epoch"] for t in trees
                        if t["children"])
                and trace["trace_events"] > 0)
    bit_identical, detail = _pod_detail(
        res, pod_dir, SCENARIO_POD_HOSTS, straight_out, straight_meta,
        ("success", "leader_terms", "epoch", "pod"),
        stopped_leader=leader, seized_by=seized_by,
        fenced_logs=sorted(fenced_logs), trace=trace,
        time_to_recovered_s=_pod_recovery(pod_dir, SCENARIO_POD_HOSTS))
    ok = (all(r["rc"] == 0 and r["digest"]["success"]
              for r in res.values())
          and seized_by is not None and seized_by != leader
          and digests[seized_by]["leader_terms"] >= 1
          and bool(fenced_logs)
          and trace_ok
          and all(d["pod"]["quarantined"] == [] for d in digests.values())
          and not detail["debris"] and not detail["stale_publishes"]
          and bit_identical)
    return ok, detail


def run_pod_flapping_member_scenario(tmpdir: str, *, timeout: float = 600,
                                     device: str | None = None,
                                     demo_args=(),
                                     stall_timeout_s: float = 20.0,
                                     startup_grace_s: float = 300.0):
    """One member's child crashes at the same chunk on every attempt (a
    flapping member). The pod converges in two coordinated restarts:
    crash, crash, then the leader quarantines that chunk POD-WIDE and the
    third attempt completes with EVERY member skipping it. Bit-identity
    target: a straight run carrying the same quarantine preset."""
    args = (*SCENARIO_DEMO_ARGS, *demo_args)
    straight = _start_pod_straight(tmpdir, args, device=device,
                                   preset_quarantine={SCENARIO_POD_CRASH_AT})
    pod_dir = os.path.join(tmpdir, "pod")
    procs = _launch_pod(
        pod_dir, (*args, *SCENARIO_FLAP_PACE,
                  "--crash-at", str(SCENARIO_POD_CRASH_AT),
                  "--misbehave-host", "h1"),
        device=device, stall_timeout_s=stall_timeout_s,
        startup_grace_s=startup_grace_s)
    try:
        res = _collect_pod(procs, pod_dir, timeout)
    finally:
        straight_out, straight_meta, err = _finish_straight(straight,
                                                            timeout)
    if err is not None:
        return False, err
    missing = _missing_digest(res)
    if missing is not None:
        return False, missing
    digests = {h: r["digest"] for h, r in res.items()}
    # The broadcast, observed at the CHILDREN: every member's final meta
    # shows the chunk skipped, the never-crashing members' included.
    skipped = {h: _read_json(os.path.join(pod_dir, h, "out.npz.meta.json"))
               .get("skipped") for h in SCENARIO_POD_HOSTS}
    bit_identical, detail = _pod_detail(
        res, pod_dir, SCENARIO_POD_HOSTS, straight_out, straight_meta,
        ("success", "attempts", "pod"), skipped=skipped,
        time_to_recovered_s=_pod_recovery(pod_dir, SCENARIO_POD_HOSTS))
    ok = (all(r["rc"] == 0 and r["digest"]["success"]
              for r in res.values())
          and all(d["pod"]["quarantined"] == [SCENARIO_POD_CRASH_AT]
                  for d in digests.values())
          and all(d["pod"]["restarts"] == 2 for d in digests.values())
          and all(d["pod"]["evicted"] == [] for d in digests.values())
          and all(skipped[h] == [SCENARIO_POD_CRASH_AT]
                  for h in SCENARIO_POD_HOSTS)
          and not detail["debris"] and not detail["stale_publishes"]
          and bit_identical)
    return ok, detail


def run_pod_elastic_resize_scenario(tmpdir: str, *, timeout: float = 600,
                                    device: str | None = None, demo_args=(),
                                    stall_timeout_s: float = 20.0,
                                    startup_grace_s: float = 300.0):
    """The elastic W -> W-1 -> W path: a whole non-leader HOST dies (its
    member agent AND its child SIGKILLed) once the pod has made progress.
    The leader, past that member's budget (``--evict-after 1``: one
    disappearance of a dead host), re-plans at W-1 and the survivors
    continue. The host then RETURNS (its member agent relaunched); the
    leader copies it the newest canonical snapshot and restarts the pod at
    W. Every member, the returned one included, must finish bit-identical
    to a straight run, with no torn or epoch-stale snapshot published."""
    import signal as _signal
    import time as _time

    args = (*SCENARIO_ELASTIC_ARGS, *demo_args)
    straight = _start_pod_straight(tmpdir, args, device=device)
    pod_dir = os.path.join(tmpdir, "pod")
    pod_flags = ("--elastic", "--evict-after", "1", "--rejoin-delay-s",
                 "0.3")
    launch = dict(device=device, pod_flags=pod_flags,
                  stall_timeout_s=stall_timeout_s,
                  startup_grace_s=startup_grace_s,
                  pod_size=len(SCENARIO_POD_HOSTS))
    procs = _launch_pod(pod_dir, args, **launch)
    deadline = _time.monotonic() + timeout
    try:
        victim = None
        t_kill = t_world2 = None
        # Kill a NON-leader host once it has published (the catch-up after its
        # return is measured against its snapshots).
        while _time.monotonic() < deadline and victim is None:
            leader = _read_json(os.path.join(pod_dir, "pod_lease.json")).get(
                "host")
            if leader in SCENARIO_POD_HOSTS:
                for h in SCENARIO_POD_HOSTS:
                    if h == leader:
                        continue
                    mem = _read_json(os.path.join(pod_dir, "members",
                                                  h + ".json"))
                    if (mem.get("latest_step") or 0) >= 2:
                        victim = h
                        for pid in (mem.get("child_pid"), procs[h].pid):
                            if pid:
                                try:
                                    os.killpg(pid, _signal.SIGKILL)
                                except OSError:
                                    try:
                                        os.kill(pid, _signal.SIGKILL)
                                    except OSError:
                                        pass
                        t_kill = _time.monotonic()
                        break
            _time.sleep(0.1)
        if victim is None:
            _abandon(procs, pod_dir, straight)
            return False, {"error": "no victim reached step 2 in time"}
        # Wait for the eviction (the control's world drops to 2), then RETURN
        # the host: relaunch its member agent with the same command.
        saw_evicted_world = None
        while _time.monotonic() < deadline:
            ctl = _read_json(os.path.join(pod_dir, "pod_control.json"))
            if ctl.get("action") == "run" and ctl.get("world") == 2:
                saw_evicted_world = 2
                t_world2 = _time.monotonic()
                break
            if ctl.get("action") in ("shutdown", "give_up"):
                break
            _time.sleep(0.1)
        if saw_evicted_world == 2:
            procs[victim].wait()  # reap the killed agent
            procs[victim] = _launch_pod(pod_dir, args, hosts=(victim,),
                                        **launch)[victim]
    except BaseException:
        _abandon(procs, pod_dir, straight)
        raise
    res = _collect_pod(procs, pod_dir,
                       max(10.0, deadline - _time.monotonic()))
    straight_out, straight_meta, err = _finish_straight(straight, timeout)
    if err is not None:
        return False, err
    missing = _missing_digest(res)
    if missing is not None:
        return False, dict(missing, victim=victim)
    digests = {h: r["digest"] for h, r in res.items()}
    victim_meta = _read_json(os.path.join(pod_dir, victim,
                                          "out.npz.meta.json"))
    bit_identical, detail = _pod_detail(
        res, pod_dir, SCENARIO_POD_HOSTS, straight_out, straight_meta,
        ("success", "attempts", "pod"), victim=victim,
        evicted_world_observed=saw_evicted_world,
        kill_to_eviction_s=(round(t_world2 - t_kill, 3)
                            if t_world2 is not None else None),
        victim_restored_step=victim_meta.get("restored_step"),
        time_to_recovered_s=_pod_recovery(pod_dir, SCENARIO_POD_HOSTS))
    ok = (all(r["rc"] == 0 and r["digest"]["success"]
              for r in res.values())
          and saw_evicted_world == 2
          # The full cycle: one eviction (W -> W-1), one readmission
          # (W-1 -> W), ending with all three back in the plan.
          and all(d["pod"]["readmissions"] == 1 for d in digests.values())
          and all(d["pod"]["world"] == 3 for d in digests.values())
          and all(d["pod"]["evicted"] == [] for d in digests.values())
          and all(d["pod"]["quarantined"] == [] for d in digests.values())
          # The returned host resumed from the copied canonical snapshot:
          # caught up, not cold-started.
          and (victim_meta.get("restored_step") or 0) >= 2
          and not detail["debris"] and not detail["stale_publishes"]
          and bit_identical)
    return ok, detail


# ---------------------------------------------------------------------------
# Storage scenarios: in process, under the port's faultfs (no supervisor).
# ---------------------------------------------------------------------------

def _storage_harness(device: str | None = None):
    """The tiny logistic regression shared by the storage scenarios:
    ``(mesh, chunks, make_trainer)``, the same workload in both arms.
    Sized for exactly 12 chunks (6 an epoch) at any mesh width, so the
    deterministic fault schedules land on the same publishes."""
    import numpy as np

    from fps_tpu_torch.core.ingest import multi_epoch_chunks
    from fps_tpu_torch.models.logistic_regression import (
        LogRegConfig,
        logistic_regression,
    )
    from fps_tpu_torch.parallel.mesh import make_ps_mesh, num_workers_of
    from fps_tpu_torch.testing.workloads import NF, NNZ
    from fps_tpu_torch.utils.datasets import synthetic_sparse_classification

    mesh = make_ps_mesh(device=device)
    W = num_workers_of(mesh)
    n = W * 32 * 8 * 6  # exactly 6 chunks an epoch at any mesh width
    data = synthetic_sparse_classification(n, NF, NNZ, seed=7, noise=0.05)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    chunks = list(multi_epoch_chunks(data, 2, num_workers=W, local_batch=32,
                                     steps_per_chunk=8, seed=3))

    def make_trainer():
        cfg = LogRegConfig(num_features=NF, learning_rate=0.5)
        trainer, store = logistic_regression(mesh, cfg)
        tables, ls = trainer.init_state(0)
        return trainer, store, tables, ls

    return mesh, chunks, make_trainer


def run_storage_brownout_scenario(tmpdir: str, *, timeout: float = 600,
                                  device: str | None = None):
    """Storage BROWNOUT under live training and a serving fleet: a mixed
    deterministic fault schedule (transient EIO writes, slow fsyncs, EIO /
    stale / ENOENT reads, one torn rename, flaky directory scans) hits the
    snapshot plane mid-run, then recovers. Training never crashes and ends
    bit-equal to the fault-free run; at least one publish degrades and the
    backlog drains to 0, the final snapshot bit-equal to the clean state;
    the 2-reader quorum fleet serves last-good throughout (the fence only
    moves forward, no reader serves past it) and converges after
    recovery; the read plane's degradation is visible (``poll_errors``)."""
    import numpy as np

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.serve import ServingFleet
    from fps_tpu_torch.testing import faultfs
    from fps_tpu_torch.testing.faultfs import FaultRule
    from fps_tpu_torch.testing.workloads import weights

    _mesh, chunks, make_trainer = _storage_harness(device)
    trainer, store, tables, ls = make_trainer()
    trainer.fit_stream(tables, ls, iter(chunks), 1)
    want_w = weights(store).copy()

    n_chunks = len(chunks)
    rules = [
        # One publish's whole retry budget fails (degrade); the next fails
        # twice then lands.
        FaultRule("snapshot", "write", "errno", errno_name="EIO",
                  start=2, count=6),
        # A torn rename: a truncated file lands at the destination and the
        # CRC gates reject it until the retry overwrites it.
        FaultRule("snapshot", "replace", "torn", start=8, count=1),
        FaultRule("snapshot", "fsync", "delay", delay_s=0.01,
                  start=0, count=None, every=4),
        # Read-plane hostility against the fleet's watchers.
        FaultRule("snapshot", "read", "errno", errno_name="EIO",
                  start=4, count=3),
        FaultRule("snapshot", "read", "stale", start=12, count=2),
        FaultRule("snapshot", "listdir", "errno", errno_name="EIO",
                  start=6, count=3),
    ]
    d = os.path.join(tmpdir, "brownout")
    trainer, store, tables, ls = make_trainer()
    fs = faultfs.install(rules, seed=0)
    violations: list[str] = []
    fence_trail: list[tuple[int, int]] = []
    try:
        ck = AsyncCheckpointer(d, keep=n_chunks + 2)
        fleet = ServingFleet(d, 2, quorum=2)

        def on_chunk(step, _metrics):
            fleet.poll()
            fence = fleet.readers[0].fence.read()
            if fence is not None:
                if fence_trail and fence < fence_trail[-1]:
                    violations.append(f"fence went backward: "
                                      f"{fence_trail[-1]} -> {fence}")
                if not fence_trail or fence != fence_trail[-1]:
                    fence_trail.append(fence)
            for r in fleet.readers:
                snap = r.server._snap
                if (snap is not None and fence is not None
                        and snap.step > fence[1]):
                    violations.append(f"{r.reader_id} served {snap.step} "
                                      f"ahead of fence {fence[1]}")

        tables, ls, _ = trainer.fit_stream(
            tables, ls, iter(chunks), 1, checkpointer=ck,
            checkpoint_every=1, on_chunk=on_chunk)
        ck.flush()
        degraded = ck.degraded_publishes
        backlog = ck._publish_backlog
        # The rules are exhausted by now (bounded counts); the fleet must
        # converge on the newest valid step.
        fs.quiesce()
        for _ in range(12):
            fleet.poll()
        final_step = ck.latest_valid_step()
        _, snap_tables, _, _ = ck.read_snapshot(final_step)
        converged = all(r.server._snap is not None
                        and r.server._snap.step == final_step
                        for r in fleet.readers)
        poll_errors = (sum(r.poll_errors for r in fleet.readers)
                       + sum(r.watcher.poll_errors for r in fleet.readers))
        served_monotone = all(
            all(b >= a for a, b in zip(r.served_steps, r.served_steps[1:]))
            for r in fleet.readers)
        ck.close()
    finally:
        faultfs.uninstall()
    got_w = weights(store)
    detail = {
        "chunks": n_chunks,
        "degraded_publishes": degraded,
        "backlog_after_flush": backlog,
        "injected": {f"{k[0]}/{k[1]}/{k[2]}": v
                     for k, v in fs.injected_counts().items()},
        "rejected_candidates": sum(r.watcher.rejected
                                   for r in fleet.readers),
        "poll_errors": poll_errors,
        "fence_trail": fence_trail[-6:],
        "violations": violations,
        "converged": converged,
        "final_step": final_step,
        "weights_bit_identical": bool(np.array_equal(got_w, want_w)),
        "snapshot_bit_identical": bool(np.array_equal(
            np.asarray(snap_tables["weights"]), want_w)),
    }
    ok = (not violations and converged and served_monotone
          and degraded >= 1 and backlog == 0
          and poll_errors > 0
          and final_step == n_chunks
          and detail["weights_bit_identical"]
          and detail["snapshot_bit_identical"]
          and len(fence_trail) >= 2)
    return ok, detail


def run_storage_blackout_recover_scenario(tmpdir: str, *,
                                          timeout: float = 600,
                                          device: str | None = None):
    """A total storage BLACKOUT mid-run: every snapshot write fails for a
    window covering three consecutive publishes' full retry budgets, then
    storage recovers. Training survives with a bounded publish backlog
    (exactly the blacked-out publishes, drained at the first landed one),
    ends bit-equal to the fault-free run, and leaves a directory whose
    newest snapshot holds the clean run's state, and resumes from it."""
    import numpy as np

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.testing import faultfs
    from fps_tpu_torch.testing.faultfs import FaultRule
    from fps_tpu_torch.testing.workloads import weights

    _mesh, chunks, make_trainer = _storage_harness(device)
    n_chunks = len(chunks)
    d_clean = os.path.join(tmpdir, "clean")
    trainer, store, tables, ls = make_trainer()
    ck = AsyncCheckpointer(d_clean, keep=n_chunks + 2)
    trainer.fit_stream(tables, ls, iter(chunks), 1, checkpointer=ck,
                       checkpoint_every=1)
    ck.close()
    want_w = weights(store).copy()
    _, clean_snap, _, _ = AsyncCheckpointer(
        d_clean, keep=n_chunks + 2).read_snapshot(n_chunks)

    # Publishes 3, 4, 5 each exhaust their 4-attempt budget (write ops
    # 2..13), then the filesystem recovers.
    D = 3
    rules = [FaultRule("snapshot", "write", "errno", errno_name="EIO",
                       start=2, count=4 * D)]
    d_fault = os.path.join(tmpdir, "blackout")
    trainer, store, tables, ls = make_trainer()
    fs = faultfs.install(rules, seed=0)
    try:
        ck = AsyncCheckpointer(d_fault, keep=n_chunks + 2)
        tables, ls, _ = trainer.fit_stream(tables, ls, iter(chunks), 1,
                                           checkpointer=ck,
                                           checkpoint_every=1)
        ck.flush()
        degraded = ck.degraded_publishes
        backlog = ck._publish_backlog
        final_step = ck.latest_valid_step()
        _, fault_snap, _, _ = ck.read_snapshot(final_step)
        ck.close()
    finally:
        faultfs.uninstall()
    got_w = weights(store)

    # The recovered directory is a real restart point.
    trainer2, store2, _t2, l2 = make_trainer()
    ck2 = AsyncCheckpointer(d_fault, keep=n_chunks + 2)
    _t, _l, step = trainer2.restore_checkpoint(ck2, l2)
    ck2.close()
    resumed_w = weights(store2)
    detail = {
        "chunks": n_chunks,
        "degraded_publishes": degraded,
        "backlog_after_flush": backlog,
        "injected": {f"{k[0]}/{k[1]}/{k[2]}": v
                     for k, v in fs.injected_counts().items()},
        "final_step": final_step,
        "restored_step": step,
        "weights_bit_identical": bool(np.array_equal(got_w, want_w)),
        "snapshot_bit_identical": bool(np.array_equal(
            np.asarray(fault_snap["weights"]),
            np.asarray(clean_snap["weights"]))),
        "resume_bit_identical": bool(np.array_equal(resumed_w, got_w)),
    }
    ok = (degraded == D and backlog == 0
          and final_step == n_chunks and step == n_chunks
          and detail["weights_bit_identical"]
          and detail["snapshot_bit_identical"]
          and detail["resume_bit_identical"])
    return ok, detail


def run_enospc_compaction_scenario(tmpdir: str, *, timeout: float = 600,
                                   device: str | None = None):
    """ENOSPC mid-compaction: the fold's full-snapshot write fails through
    its whole retry budget. The fold aborts without touching the chain
    (every link still resolves), ``storage.compaction_aborts`` counts it,
    and after recovery the next publish re-triggers the compaction, which
    completes and keeps the state bit for bit."""
    import numpy as np

    from fps_tpu_torch import obs
    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.core.checkpoint import (
        Checkpointer,
        DeltaPolicy,
        load_rows,
    )
    from fps_tpu_torch.testing import faultfs
    from fps_tpu_torch.testing.faultfs import FaultRule

    _mesh, _chunks, make_trainer = _storage_harness(device)
    trainer, store, tables, ls = make_trainer()
    rec = obs.Recorder(sinks=[])
    obs.events.set_default_recorder(rec)
    d = os.path.join(tmpdir, "enospc")
    # Writes by op index: save 1 full (0), saves 2 and 3 deltas (1, 2), the
    # auto-compaction (compact_every=2) at ops 3..6, all ENOSPC: abort;
    # save 4's delta is op 7 and its compaction at op 8 succeeds. Each save
    # changes a handful of rows, so the publications are row-sparse.
    rules = [FaultRule("snapshot", "write", "errno", errno_name="ENOSPC",
                       start=3, count=4)]
    fs = faultfs.install(rules, seed=0)
    spec = store.specs["weights"]
    rng = np.random.default_rng(0)
    kinds_mid, aborted, mid_ok = {}, False, False
    try:
        ck = Checkpointer(d, keep=20,
                          delta=DeltaPolicy(full_every=10, compact_every=2))
        state_at = {}
        for i in range(4):
            ids = np.arange(i * 4, i * 4 + 4) % spec.num_ids
            load_rows(store, "weights", ids,
                      rng.normal(size=(len(ids), spec.dim))
                      .astype(np.float32))
            ck.save(i + 1, store, None)
            state_at[i + 1] = store.dump_model("weights")[1].copy()
            if i + 1 == 3:
                # The fold at step 3 just aborted: the chain is intact.
                kinds_mid = {s: p.kind
                             for s, p in fmt.publications(d).items()}
                aborted = ck.compactions == 0
                resolved_mid = fmt.latest_valid_chain(d)
                mid_ok = (resolved_mid is not None
                          and resolved_mid[0] == 3)
    finally:
        faultfs.uninstall()
        obs.events.set_default_recorder(None)
    aborts = int(rec.counter_value("storage.compaction_aborts"))
    pubs = fmt.publications(d)
    resolved = fmt.latest_valid_chain(d)
    head_ok = (resolved is not None and resolved[0] == 4
               and resolved[1][-1].kind == "full")
    state_ok = False
    if resolved is not None:
        entries = fmt.resolve_chain_entries(resolved[1])
        state_ok = bool(np.array_equal(
            np.asarray(entries["table::weights"]), state_at[4]))
    detail = {
        "kinds_mid_abort": {str(k): v for k, v in sorted(kinds_mid.items())},
        "mid_abort_resolvable": mid_ok,
        "compaction_aborts_counted": aborts,
        "compactions_completed": ck.compactions,
        "injected": {f"{k[0]}/{k[1]}/{k[2]}": v
                     for k, v in fs.injected_counts().items()},
        "final_kinds": {str(s): p.kind for s, p in sorted(pubs.items())},
        "head_is_compacted_full": head_ok,
        "state_bit_exact": state_ok,
    }
    ok = (aborted and mid_ok and aborts >= 1
          and ck.compactions >= 1 and head_ok and state_ok)
    return ok, detail

def run_slow_lease_near_ttl_scenario(tmpdir: str, *, timeout: float = 600):
    """A live leader's lease renewals hit injected slow writes (1.2 s
    against a 2 s TTL, two consecutive renewals; one isolated spike is
    tolerated by design): the holder must STEP DOWN before its own record
    expires, stop renewing so the record lapses on schedule, and a
    follower must seize with a strictly higher fencing epoch, after which
    the deposed leader stays out. In process, on the port's ``faultfs``
    (the injector reaches the lease through ``fps_tpu_torch.core.retry``,
    the one fault seam the pod module shares with the package); no
    child, so no device."""
    import time as _time

    from fps_tpu_torch.supervise.pod import Lease
    from fps_tpu_torch.testing import faultfs
    from fps_tpu_torch.testing.faultfs import FaultRule

    TTL = 2.0
    path = os.path.join(tmpdir, "pod_lease.json")
    A = Lease(path, "hA", TTL)
    B = Lease(path, "hB", TTL)
    A.tick()  # claim
    held, rec, _ = A.tick()  # confirm
    if not held:
        return False, {"error": "A never acquired the lease"}
    epoch_a = int(rec["epoch"])
    # Lease writes so far: A's claim (op 0). The next renewals (ops 1..2)
    # are slowed past TTL/2.
    fs = faultfs.install([FaultRule("lease", "replace", "delay",
                                    delay_s=0.6 * TTL, start=1, count=2)])
    try:
        stepped_at = None
        last_landed_t = float(rec["t"])
        deadline = _time.monotonic() + min(timeout, 30.0)
        while _time.monotonic() < deadline:
            held, rec, _ = A.tick()
            if held:
                last_landed_t = float(rec["t"])
            else:
                # The step-down tick's own (slow-landed) renewal is the
                # freshest landed record: expiry runs from ITS timestamp.
                if rec and rec.get("host") == "hA":
                    last_landed_t = float(rec["t"])
                stepped_at = _time.time()
                break
            _time.sleep(0.05)
        if stepped_at is None:
            return False, {"error": "A never stepped down",
                           "injected": {"/".join(k): v for k, v in
                                        fs.injected_counts().items()}}
        before_expiry = stepped_at < last_landed_t + TTL
        # B seizes after the record lapses, with a monotone epoch bump.
        seized_epoch = seized_at = None
        deadline = _time.monotonic() + min(timeout, 30.0)
        while _time.monotonic() < deadline:
            held_b, rec_b, _ = B.tick()
            if held_b:
                seized_epoch = int(rec_b["epoch"])
                seized_at = _time.time()
                break
            _time.sleep(0.05)
        if seized_epoch is None:
            return False, {"error": "B never seized the lease"}
        # The deposed leader stays out while B renews, and its stale epoch
        # never regresses the record for any observer.
        stays_out = True
        regress = False
        for _ in range(6):
            held_a, _, _ = A.tick()
            stays_out = stays_out and not held_a
            B.tick()
            cur = B.read() or {}
            if int(cur.get("epoch", seized_epoch)) < seized_epoch:
                regress = True
            _time.sleep(0.05)
    finally:
        faultfs.uninstall()
    detail = {
        "ttl_s": TTL,
        "leader_epoch": epoch_a,
        "stepdowns": A.stepdowns,
        "renew_failures": A.renew_failures,
        "stepped_down_before_expiry": before_expiry,
        "stepdown_to_seizure_s": round(seized_at - stepped_at, 3),
        "seized_epoch": seized_epoch,
        "epoch_monotone": seized_epoch > epoch_a and not regress,
        "deposed_stays_out": stays_out,
    }
    ok = (A.stepdowns >= 1 and before_expiry
          and seized_epoch > epoch_a and not regress and stays_out
          and seized_at > stepped_at)
    return ok, detail


# ---------------------------------------------------------------------------
# Network scenarios: the wire plane under the port's faultnet, in process
# (the partitioned reader is a torch-free child).
# ---------------------------------------------------------------------------

def _wire_harness():
    """One fixed snapshot behind a fresh ReadServer + the deterministic
    request sequence the net scenarios replay: returns
    ``(make_server, requests)``. Same snapshot and sequence every call,
    so the clean run's responses are the bit-identity reference."""
    import numpy as np

    from fps_tpu_torch.serve import ReadServer, ServableSnapshot

    rng = np.random.default_rng(3)
    tables = {"weights": rng.normal(size=(256, 8)).astype(np.float32)}
    reqs = [{"op": "pull", "table": "weights",
             "ids": rng.integers(0, 256, 16).tolist()}
            for _ in range(60)]

    def make_server():
        server = ReadServer()
        server.swap_to(ServableSnapshot(11, "net-scenario", tables, [],
                                        "none"))
        return server

    return make_server, reqs


def _fired_by_stream(trail):
    """Project an evidence trail onto per-(class, op) sublists: the
    within-stream order is deterministic even when two streams' lock
    acquisitions interleave differently across runs."""
    out: dict[tuple, list] = {}
    for cls, op, n, fault in trail:
        out.setdefault((cls, op), []).append((n, fault))
    return out


def run_net_torn_frames_scenario(tmpdir: str, *, timeout: float = 600):
    """Torn frames never decode (``fps_tpu_torch.serve.wire``): a
    deterministic ``faultnet`` schedule cuts the client's sends
    mid-frame (and resets one outright) against a live framed server.
    The contract:

    * the server counts every torn frame and drops the connection —
      a truncated frame is NEVER decoded into a request (bit-identity
      of every response against the fault-free run is the witness);
    * the client classifies the failures as retryable, reconnects with
      backoff, and completes the whole sequence inside its budgets;
    * the schedule is REPLAYABLE: a second run with the same seed
      fires the same faults at the same per-stream operation counts
      and produces the same responses.
    """
    from fps_tpu_torch.serve import TcpServe, WireClient
    from fps_tpu_torch.testing import faultnet
    from fps_tpu_torch.testing.faultnet import NetFaultRule

    make_server, reqs = _wire_harness()

    # Clean reference.
    with TcpServe(make_server()) as tcp:
        with WireClient(tcp.host, tcp.port) as wc:
            want = [wc.request(r) for r in reqs]

    rules = [
        # Mid-frame cuts on the client's sends: the server's framing
        # gates must reject every one. start=2 keeps the constructor
        # handshake clean (the ctor connects once, without retry).
        NetFaultRule("client", "send", "cut", cut_bytes=5, start=2,
                     count=None, every=9),
        NetFaultRule("client", "send", "reset", start=30, count=1),
    ]

    def faulted_run():
        net = faultnet.install(rules, seed=0)
        try:
            with TcpServe(make_server()) as tcp:
                wc = WireClient(tcp.host, tcp.port,
                                peer_class="client")
                got = [wc.request(r) for r in reqs]
                wc.close()
                return (got, net.trail(),
                        {"retries": wc.retries,
                         "reconnects": wc.reconnects},
                        tcp.wire_stats())
        finally:
            faultnet.uninstall()

    got1, trail1, client1, stats1 = faulted_run()
    got2, trail2, _client2, stats2 = faulted_run()

    cuts = sum(1 for _, _, _, f in trail1 if f == "cut")
    detail = {
        "requests": len(reqs),
        "injected": {f"{cls}/{op}": len(v)
                     for (cls, op), v in
                     _fired_by_stream(trail1).items()},
        "client": client1,
        "server_torn_frames": stats1["torn_frames"],
        "responses_bit_identical": bool(got1 == want),
        "replay_deterministic": bool(
            _fired_by_stream(trail1) == _fired_by_stream(trail2)
            and got1 == got2
            and stats1["torn_frames"] == stats2["torn_frames"]),
    }
    ok = (detail["responses_bit_identical"]
          and detail["replay_deterministic"]
          and cuts >= 3
          # Every cut the server saw was counted, none decoded.
          and stats1["torn_frames"] >= cuts
          and client1["reconnects"] >= cuts
          and client1["retries"] >= cuts)
    return ok, detail


def run_net_reconnect_storm_scenario(tmpdir: str, *,
                                     timeout: float = 600):
    """Reconnects dedupe in-flight requests (the replay cache's chaos
    invariant): the server's RESPONSE sends are cut mid-frame and the
    client's first reconnect attempts are refused outright. The
    contract:

    * every logical request EXECUTES exactly once — resends after a
      reconnect are answered from the (session, req_id) replay cache
      (``server.requests`` equals the request count; ``dedup_replays``
      is the positive witness);
    * the refused-connect storm backs off and recovers under the same
      session (responses bit-identical to the fault-free run);
    * the schedule replays deterministically.
    """
    from fps_tpu_torch.serve import TcpServe, WireClient
    from fps_tpu_torch.testing import faultnet
    from fps_tpu_torch.testing.faultnet import NetFaultRule

    make_server, reqs = _wire_harness()

    with TcpServe(make_server()) as tcp:
        with WireClient(tcp.host, tcp.port) as wc:
            want = [wc.request(r) for r in reqs]

    rules = [
        # Cut the server's data sends (start=2 spares the constructor
        # HELLO_OK): the executed response dies on the wire, the client
        # resends, the replay cache answers. count is the WINDOW width
        # ([start, start+count)), so every=5 in a 25-op window fires 5
        # cuts.
        NetFaultRule("serve", "send", "cut", cut_bytes=4, start=2,
                     count=25, every=5),
        # And the first two reconnect attempts are REFUSED: the storm
        # must back off, not busy-loop.
        NetFaultRule("client", "connect", "refuse", start=1, count=2),
    ]

    def faulted_run():
        net = faultnet.install(rules, seed=0)
        try:
            server = make_server()
            with TcpServe(server) as tcp:
                wc = WireClient(tcp.host, tcp.port,
                                peer_class="client")
                got = [wc.request(r) for r in reqs]
                wc.close()
                return (got, net.trail(),
                        {"retries": wc.retries,
                         "reconnects": wc.reconnects},
                        tcp.wire_stats(), server.requests)
        finally:
            faultnet.uninstall()

    got1, trail1, client1, stats1, executed1 = faulted_run()
    got2, trail2, _c2, stats2, executed2 = faulted_run()

    cuts = sum(1 for _, _, _, f in trail1 if f == "cut")
    refused = sum(1 for _, _, _, f in trail1 if f == "refuse")
    detail = {
        "requests": len(reqs),
        "response_cuts": cuts,
        "refused_connects": refused,
        "client": client1,
        "dedup_replays": stats1["dedup_replays"],
        "executed_requests": executed1,
        "responses_bit_identical": bool(got1 == want),
        "replay_deterministic": bool(
            _fired_by_stream(trail1) == _fired_by_stream(trail2)
            and got1 == got2 and executed1 == executed2),
    }
    ok = (detail["responses_bit_identical"]
          and detail["replay_deterministic"]
          and cuts >= 3 and refused == 2
          # THE invariant: zero duplicate-applied requests.
          and executed1 == len(reqs)
          and stats1["dedup_replays"] >= 1
          and client1["reconnects"] >= 1)
    return ok, detail


def run_net_slow_peer_scenario(tmpdir: str, *, timeout: float = 600):
    """Slow peers and dead deadlines (``docs/STALENESS.md``): the
    client's sends are byte-trickled and the server's sends delayed —
    a slow peer must cost LATENCY, never integrity (zero torn frames,
    responses bit-identical). A second client then faces a total
    one-way partition (every recv times out) under a small deadline
    budget: the request must fail FAST with ``TimeoutError`` — the
    deadline is a budget, not a suggestion — while the server's
    replay cache keeps the retried sends idempotent.
    """
    import time as _time

    from fps_tpu_torch.serve import TcpServe, WireClient
    from fps_tpu_torch.testing import faultnet
    from fps_tpu_torch.testing.faultnet import NetFaultRule

    make_server, reqs = _wire_harness()

    with TcpServe(make_server()) as tcp:
        with WireClient(tcp.host, tcp.port) as wc:
            want = [wc.request(r) for r in reqs]

    rules = [
        NetFaultRule("client", "send", "trickle", chunk=7,
                     delay_s=0.001, start=1, count=None, every=3),
        NetFaultRule("serve", "send", "delay", delay_s=0.001,
                     start=0, count=None, every=4),
        # The partitioned client: every recv AFTER its constructor
        # handshake times out — a one-way partition (our bytes leave,
        # theirs never arrive).
        NetFaultRule("deadline", "recv", "partition", start=1,
                     count=None),
    ]
    net = faultnet.install(rules, seed=0)
    try:
        server = make_server()
        with TcpServe(server) as tcp:
            wc = WireClient(tcp.host, tcp.port, peer_class="client")
            got = [wc.request(r) for r in reqs]
            wc.close()

            pc = WireClient(tcp.host, tcp.port, peer_class="deadline")
            t0 = _time.monotonic()
            deadline_error = None
            try:
                pc.request(reqs[0], deadline_s=0.5)
            except TimeoutError as e:
                deadline_error = repr(e)
            elapsed = _time.monotonic() - t0
            pc.close()
            stats = tcp.wire_stats()
            executed = server.requests
        trail = net.trail()
    finally:
        faultnet.uninstall()

    trickles = sum(1 for _, _, _, f in trail if f == "trickle")
    partitions = sum(1 for _, _, _, f in trail if f == "partition")
    detail = {
        "requests": len(reqs),
        "trickled_sends": trickles,
        "partitioned_recvs": partitions,
        "torn_frames": stats["torn_frames"],
        "responses_bit_identical": bool(got == want),
        "deadline_error": deadline_error,
        "deadline_elapsed_s": round(elapsed, 3),
        "client_deadline_exceeded": pc.deadline_exceeded,
        "executed_requests": executed,
    }
    ok = (detail["responses_bit_identical"]
          and trickles >= 10
          # Slow is slow, not torn: every trickled frame arrived whole.
          and stats["torn_frames"] == 0
          and deadline_error is not None
          and partitions >= 1
          and pc.deadline_exceeded >= 1
          # The budget BOUND the journey (0.5s budget, generous slack
          # for backoff rounding — nowhere near a socket timeout).
          and elapsed < 5.0
          # Idempotence held for the partitioned client's resends: at
          # most ONE execution beyond the measured sequence.
          and executed <= len(reqs) + 1)
    return ok, detail


# The SIGSTOPped-reader child: a quorum-1 FleetReader polling one
# snapshot dir, beating its liveness beacon fast (0.1s) so the scenario
# detects the wedge in seconds. Run via ``python -c`` and loaded through
# the serving CLI's stubbed package roots: no torch, so it starts fast.
_READER_LOOP_SRC = """\
import importlib.util, sys, time
spec = importlib.util.spec_from_file_location("_serve_cli", sys.argv[3])
cli = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cli)
r = cli.load_serve().FleetReader(sys.argv[1], sys.argv[2], quorum=1,
                                 heartbeat_interval_s=0.1)
while True:
    r.poll()
    time.sleep(0.05)
"""


def run_net_partition_reader_scenario(tmpdir: str, *,
                                      timeout: float = 600,
                                      device: str | None = None):
    """A partitioned (SIGSTOPped) reader becomes a ``reader_wedged``
    incident, never a silent zero (the liveness leg): a
    reader child polls + beats against a live training run's snapshot
    dir; mid-run the child is SIGSTOPped — its beacon freezes while its
    process, from the filesystem's point of view, simply goes silent.
    The contract:

    * before the stop, the reader is LIVE (beacon fresh, no wedge —
      no false positives);
    * within the liveness timeout of the stop, ``liveness_check``
      reports the reader wedged (the incident a supervisor restarts
      on);
    * training is UNAFFECTED: final weights bit-identical to the
      fault-free run (a dead reader costs serving capacity, never
      training state);
    * after SIGCONT (the partition heals) the reader recovers: beats
      fresh again and catches up to the newest publication.
    """
    import signal
    import subprocess as sp
    import time as _time

    import numpy as np

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer
    from fps_tpu_torch.serve import liveness_check, scan_heartbeats
    from fps_tpu_torch.testing.workloads import weights

    _mesh, chunks, make_trainer = _storage_harness(device)

    # Clean arm: the bit-identity reference.
    trainer, store, tables, ls = make_trainer()
    trainer.fit_stream(tables, ls, iter(chunks), 1)
    want_w = weights(store).copy()

    LIVENESS = 1.5
    d = os.path.join(tmpdir, "net_partition")
    os.makedirs(d, exist_ok=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = _ROOT
    serve_cli = os.path.join(_ROOT, "fps_tpu_torch", "examples", "serve.py")
    child = sp.Popen([sys.executable, "-c", _READER_LOOP_SRC, d, "r0",
                      serve_cli],
                     env=env, cwd=_ROOT, stdout=sp.DEVNULL,
                     stderr=sp.DEVNULL)
    stopped_at = [None]
    live_before = [None]
    try:
        trainer, store, tables, ls = make_trainer()
        ck = AsyncCheckpointer(d, keep=len(chunks) + 2)

        def on_chunk(step, _metrics):
            if step != 4 or stopped_at[0] is not None:
                return
            # Never SIGSTOP a reader that hasn't come up — that would
            # test a start timeout, not a wedge.
            dl = _time.monotonic() + 60.0
            while not scan_heartbeats(d) and _time.monotonic() < dl:
                _time.sleep(0.05)
            live_before[0] = liveness_check(d, timeout_s=LIVENESS,
                                            expected=["r0"])
            os.kill(child.pid, signal.SIGSTOP)
            stopped_at[0] = _time.monotonic()

        tables, ls, _ = trainer.fit_stream(
            tables, ls, iter(chunks), 1,
            checkpointer=ck, checkpoint_every=1, on_chunk=on_chunk)
        ck.flush()
        final_step = ck.latest_valid_step()
        ck.close()
        got_w = weights(store)
        if stopped_at[0] is None:
            return False, {"error": "reader was never SIGSTOPped"}

        # The wedge becomes an incident within the liveness timeout.
        wedged_at = None
        dl = _time.monotonic() + min(timeout, 60.0)
        while _time.monotonic() < dl:
            live = liveness_check(d, timeout_s=LIVENESS,
                                  expected=["r0"])
            if "r0" in live["wedged"]:
                wedged_at = _time.monotonic()
                break
            _time.sleep(0.05)
        if wedged_at is None:
            return False, {"error": "reader_wedged never fired",
                           "heartbeats": scan_heartbeats(d)}
        detect_s = wedged_at - stopped_at[0]

        # SIGCONT: the partition heals; the reader must beat fresh
        # again and converge on the newest publication.
        os.kill(child.pid, signal.SIGCONT)
        recovered = caught_up = False
        dl = _time.monotonic() + min(timeout, 60.0)
        while _time.monotonic() < dl:
            live = liveness_check(d, timeout_s=LIVENESS,
                                  expected=["r0"])
            hb = scan_heartbeats(d).get("r0")
            if "r0" not in live["wedged"] and hb is not None:
                recovered = True
                if hb.get("step") == final_step:
                    caught_up = True
                    break
            _time.sleep(0.05)
    finally:
        child.kill()
        child.wait(timeout=10)

    detail = {
        "chunks": len(chunks),
        "final_step": final_step,
        "live_before_stop": live_before[0],
        "wedge_detect_s": round(detect_s, 3),
        "liveness_timeout_s": LIVENESS,
        "recovered": recovered,
        "caught_up_to_final_step": caught_up,
        "weights_bit_identical": bool(np.array_equal(got_w, want_w)),
    }
    ok = (live_before[0] is not None
          and live_before[0]["wedged"] == []      # no false positive
          and detect_s < 30.0
          and recovered and caught_up
          and detail["weights_bit_identical"])
    return ok, detail


# ---------------------------------------------------------------------------
# Batched read-plane scenarios: the multi-lookup wire op and the
# autoscaled serving fleet under the same hostile-network / reader-churn
# treatment as everything above. Deterministic explicit
# multi batches (never the racing coalescer) so bit-identity assertions
# stay exact.
# ---------------------------------------------------------------------------

def run_serve_batch_storm_scenario(tmpdir: str, *, timeout: float = 600):
    """Batched multi frames under a wire-fault storm (the coalesced read
    path meets the hostile network): the 60-request
    harness sequence rides in 5 ``multi`` frames whose sends are cut on
    BOTH directions. The contract:

    * a torn multi frame is NEVER partially applied — the server
      executes exactly ``len(reqs)`` sub-requests across the whole
      storm (resent frames dedupe through the replay cache as ONE
      unit, ``dedup_replays`` the positive witness);
    * batched responses are bit-identical to the fault-free batched
      run, which is itself bit-identical to the fault-free UNBATCHED
      run (batching changes framing, never answers) — and the
      zero-copy binary encoding returns the same numbers as JSON;
    * an admission-wedged server sheds the whole batch with a
      retryable BUSY inside the deadline budget, and the identical
      batch succeeds bit-identically once capacity returns;
    * the fault schedule replays deterministically.
    """
    import time as _time

    import numpy as np

    from fps_tpu_torch.serve import ServerBusyError, TcpServe, WireClient
    from fps_tpu_torch.serve.wire import CAP_BIN, CAP_MULTI
    from fps_tpu_torch.testing import faultnet
    from fps_tpu_torch.testing.faultnet import NetFaultRule

    make_server, reqs = _wire_harness()
    batches = [reqs[i:i + 12] for i in range(0, len(reqs), 12)]

    # Clean references: solo, batched-JSON, batched-binary — all three
    # must agree bitwise before any fault is injected.
    with TcpServe(make_server()) as tcp:
        with WireClient(tcp.host, tcp.port) as wc:
            want_solo = [wc.request(r) for r in reqs]
            want = [wc.multi(b) for b in batches]
        with WireClient(tcp.host, tcp.port,
                        caps=(CAP_MULTI, CAP_BIN)) as wb:
            bin_granted = CAP_BIN in wb.caps
            got_bin = [wb.multi(b) for b in batches]
        clean_stats = tcp.wire_stats()
    flat = [r for batch in want for r in batch]
    flat_bin = [r for batch in got_bin for r in batch]
    bin_matches_json = bin_granted and all(
        b["ok"] and b["step"] == j["step"]
        and np.array_equal(np.asarray(j["values"], np.float32),
                           np.asarray(b["values"]))
        for j, b in zip(flat, flat_bin))

    rules = [
        # Cut the client's multi sends (start=2 spares the ctor HELLO):
        # every torn frame must be rejected whole, resent whole, and
        # applied once.
        NetFaultRule("client", "send", "cut", cut_bytes=9, start=2,
                     count=None, every=3),
        # And cut the server's response sends inside an early window:
        # the executed batch's response dies on the wire, the resend is
        # answered from the replay cache as one unit.
        NetFaultRule("serve", "send", "cut", cut_bytes=4, start=3,
                     count=8, every=4),
    ]

    def faulted_run():
        net = faultnet.install(rules, seed=0)
        try:
            server = make_server()
            with TcpServe(server) as tcp:
                wc = WireClient(tcp.host, tcp.port,
                                peer_class="client")
                got = [wc.multi(b) for b in batches]
                wc.close()
                return (got, net.trail(),
                        {"retries": wc.retries,
                         "reconnects": wc.reconnects},
                        tcp.wire_stats(), server.requests)
        finally:
            faultnet.uninstall()

    got1, trail1, client1, stats1, executed1 = faulted_run()
    got2, trail2, _c2, stats2, executed2 = faulted_run()
    client_cuts = len([1 for (cls, _op), v in
                       _fired_by_stream(trail1).items()
                       if cls == "client" for _ in v])

    # BUSY leg on a clean network: wedge the admission budget, the
    # whole batch sheds retryably inside its deadline; release, and the
    # identical batch answers bit-identically.
    with TcpServe(make_server()) as tcp:
        with WireClient(tcp.host, tcp.port) as wc:
            assert tcp.admission.try_admit(tcp.admission.max_cost)
            shed_error = None
            t0 = _time.monotonic()
            try:
                wc.multi(batches[0], deadline_s=0.4)
            except ServerBusyError as e:
                shed_error = repr(e)
            shed_elapsed = _time.monotonic() - t0
            tcp.admission.release(tcp.admission.max_cost)
            after_release = wc.multi(batches[0])
            shed_stats = tcp.wire_stats()

    detail = {
        "requests": len(reqs),
        "batches": len(batches),
        "injected": {f"{cls}/{op}": len(v)
                     for (cls, op), v in
                     _fired_by_stream(trail1).items()},
        "client": client1,
        "server_torn_frames": stats1["torn_frames"],
        "multi_frames": stats1["multi_frames"],
        "dedup_replays": stats1["dedup_replays"],
        "executed_subrequests": executed1,
        "clean_multi_frames": clean_stats["multi_frames"],
        "bin_responses_clean": clean_stats["bin_responses"],
        "batched_equals_unbatched": bool(flat == want_solo),
        "bin_matches_json": bool(bin_matches_json),
        "responses_bit_identical": bool(got1 == want),
        "replay_deterministic": bool(
            _fired_by_stream(trail1) == _fired_by_stream(trail2)
            and got1 == got2 and executed1 == executed2),
        "shed_error": shed_error,
        "shed_elapsed_s": round(shed_elapsed, 3),
        "shed_requests": shed_stats["shed_requests"],
        "after_release_bit_identical": bool(after_release == want[0]),
    }
    ok = (detail["batched_equals_unbatched"]
          and detail["bin_matches_json"]
          and detail["responses_bit_identical"]
          and detail["replay_deterministic"]
          and client_cuts >= 3
          and stats1["torn_frames"] >= 1
          # THE invariant: a torn multi frame is never partially
          # applied and a resent one never double-applied.
          and executed1 == len(reqs)
          and stats1["dedup_replays"] >= 1
          and stats1["multi_frames"] >= len(batches)
          and clean_stats["bin_responses"] >= 1
          and shed_error is not None
          and shed_stats["shed_requests"] >= 1
          and shed_elapsed < 5.0
          and detail["after_release_bit_identical"])
    return ok, detail


def run_autoscale_reader_churn_scenario(tmpdir: str, *,
                                        timeout: float = 600):
    """The autoscaler survives reader churn with a monotone fence (the
    capacity leg): a 2-reader fleet over a real snapshot dir
    scales to ``max_readers`` under latency burn, absorbs a publish
    train, REPLACES an alive-but-silent wedged reader without ever
    dipping below size, and scales back down to ``min_readers`` when
    the burn ends. The contract:

    * every scale decision is journaled with its evidence
      (``decisions`` trail: scale_up, replace, scale_down all fire);
    * the shared step fence NEVER regresses across the whole churn
      (sampled continuously) and lands on the last published step;
    * the wedged reader's replacement catches up to the fence and
      answers bit-identically to the published table — capacity
      changes reframe the fleet, never the answers;
    * the fleet never shrinks below ``min_readers`` and quorum follows
      membership (majority of the current fleet).
    """
    import threading as _threading
    import time as _time

    import numpy as np

    from fps_tpu_torch.core import snapshot_format as fmt
    from fps_tpu_torch.serve import ReadAutoscaler, ServingFleet

    rng = np.random.default_rng(7)
    steps = 5
    tables = [rng.normal(size=(64, 4)).astype(np.float32)
              for _ in range(steps)]
    d = os.path.join(tmpdir, "autoscale_churn")
    os.makedirs(d, exist_ok=True)

    def publish(step):
        arrays = {"table::w": tables[step - 1],
                  "meta::ls_format": np.array("exported")}
        for k in list(arrays):
            arrays["meta::crc::" + k] = np.uint32(
                fmt.array_crc32(arrays[k]))
        np.savez(fmt.snapshot_path(d, step), **arrays)

    def wait_for(pred, budget):
        dl = _time.monotonic() + min(timeout, budget)
        while _time.monotonic() < dl:
            if pred():
                return True
            _time.sleep(0.02)
        return pred()

    publish(1)
    fleet = ServingFleet(d, 2)  # auto-quorum: majority of the fleet
    scaler = ReadAutoscaler(
        fleet, min_readers=2, max_readers=4,
        latency_slo_s=1e-6,      # any real request burns the SLO
        fence_lag_slo_steps=64.0, cooldown_s=0.0,
        liveness_timeout_s=2.5)
    ids = list(range(0, 64, 5))
    fence_trail: list[tuple[int, int]] = []
    stop_sampler = _threading.Event()

    def sample_fence():
        fence = fleet.readers[0].fence
        while not stop_sampler.is_set():
            f = fence.read()
            if f is not None:
                fence_trail.append(f)
            _time.sleep(0.005)

    sampler = _threading.Thread(target=sample_fence, daemon=True)
    fleet.start(interval_s=0.02)
    sampler.start()
    try:
        if not wait_for(lambda: all(
                r.stats()["step"] == 1 for r in fleet.readers), 60.0):
            return False, {"error": "initial fleet never converged",
                           "stats": fleet.stats()}

        # Latency burn: real pulls through every reader's server put a
        # real p99 over the (microscopic) SLO; the fence is fresh, so
        # the scaler must add capacity up to max_readers.
        from fps_tpu_torch.serve import NoSnapshotError
        sizes = []
        for _ in range(8):
            for r in list(fleet.readers):
                for _i in range(5):
                    try:
                        r.server.pull("w", ids)
                    except NoSnapshotError:
                        break  # still booting: no latency sample yet
            decision = scaler.evaluate(newest_step=1)
            sizes.append(decision["fleet_size"])
            if decision["fleet_size"] >= 4:
                break
        scaled_up = len(fleet.readers) == 4 and fleet.quorum == 3

        # Publish train: the grown fleet's fence must walk 2..5
        # monotonically (the sampler is watching for any regression).
        for step in range(2, steps + 1):
            publish(step)
        if not wait_for(lambda: all(
                r.stats()["step"] == steps for r in fleet.readers),
                60.0):
            return False, {"error": "fleet never reached the last "
                                    "publish", "stats": fleet.stats()}

        # Wedge one reader alive-but-silent: its polling thread keeps
        # cycling but the beacon freezes — the scaler must REPLACE it
        # (join a fresh reader first, retire the ghost after).
        victim = fleet.readers[1].reader_id
        fleet.readers[1].poll = lambda: None  # instance-attr shadow
        replaced = None

        def try_replace():
            nonlocal replaced
            decision = scaler.evaluate(newest_step=steps)
            if decision["action"] == "replace":
                replaced = decision
            return replaced is not None

        if not wait_for(try_replace, 30.0):
            return False, {"error": "wedged reader never replaced",
                           "decisions": scaler.decisions[-3:]}
        replacement = replaced["replaced"][0]["replacement"]
        if not wait_for(lambda: all(
                r.stats()["step"] == steps for r in fleet.readers),
                60.0):
            return False, {"error": "replacement never caught up",
                           "stats": fleet.stats()}
        # Membership right after the replace (scale-down below may
        # legitimately retire the newest reader — the replacement).
        post_replace_ids = [r.reader_id for r in fleet.readers]

        # The burn ends: with the SLO now generous, the scaler retires
        # readers one per pass down to min_readers, then holds.
        scaler.latency_slo_s = 1e6
        down_actions = []
        for _ in range(4):
            down_actions.append(scaler.evaluate(newest_step=steps))
        final_actions = [dec["action"] for dec in down_actions]

        # Bit-identity: every surviving reader answers the last
        # published table exactly.
        answers_exact = all(
            np.array_equal(r.server.pull("w", ids)[1],
                           tables[-1][np.asarray(ids)])
            for r in fleet.readers)
        final_size = len(fleet.readers)
        final_quorum = fleet.quorum
    finally:
        stop_sampler.set()
        sampler.join(timeout=5)
        fleet.stop()

    fence_steps = [s for _e, s in fence_trail]
    fence_monotone = all(a <= b for a, b in
                         zip(fence_steps, fence_steps[1:]))
    actions = [dec["action"] for dec in scaler.decisions]
    detail = {
        "published_steps": steps,
        "scale_up_sizes": sizes,
        "scaled_to_max": scaled_up,
        "replaced": replaced["replaced"] if replaced else None,
        "replacement_in_fleet": replacement in post_replace_ids,
        "victim_gone": victim not in post_replace_ids,
        "down_actions": final_actions,
        "final_size": final_size,
        "final_quorum": final_quorum,
        "fence_samples": len(fence_trail),
        "fence_monotone": fence_monotone,
        "fence_final_step": fence_steps[-1] if fence_steps else None,
        "answers_bit_identical": bool(answers_exact),
        "actions_seen": sorted(set(actions)),
    }
    ok = (scaled_up
          and replaced is not None
          and detail["replacement_in_fleet"]
          and detail["victim_gone"]
          and final_actions.count("scale_down") == 2
          and final_size == 2 and final_quorum == 2
          and final_actions[-1] == "hold"   # never below min_readers
          and fence_monotone
          and detail["fence_final_step"] == steps
          and answers_exact
          and {"scale_up", "replace", "scale_down"} <= set(actions))
    return ok, detail


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="supervised tiny-logreg child (fps_tpu_torch.supervise "
                    "demo)")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--out", required=True,
                    help="final weights .npz (written on success)")
    ap.add_argument("--epochs", type=int, default=2)
    ap.add_argument("--examples", type=int, default=2000)
    ap.add_argument("--wedge-at", type=int, default=None,
                    help="wedge after this chunk trains, before its "
                         "checkpoint lands (once, via marker file)")
    ap.add_argument("--wedge-mode", default="sigstop",
                    choices=["sigstop", "sleep"])
    ap.add_argument("--crash-at", type=int, default=None,
                    help="exit(3) at this chunk on every attempt not "
                         "carrying it in the quarantine set")
    ap.add_argument("--always", action="store_true",
                    help="misbehave on every attempt (no marker)")
    ap.add_argument("--sync-checkpointer", action="store_true",
                    help="use the blocking Checkpointer instead of the "
                         "async writer")
    ap.add_argument("--prefetch", type=int, default=0,
                    help="overlapped host pipeline depth "
                         "(TrainerConfig.prefetch)")
    ap.add_argument("--kill-prefetch-at", type=int, default=None,
                    help="SIGKILL while the prefetch worker assembles "
                         "this (global) chunk index; once, via marker "
                         "file, unless --always")
    ap.add_argument("--kill-at", type=int, default=None,
                    help="SIGKILL after this chunk trains (async writer "
                         "flushed first), before its checkpoint lands; "
                         "once, via marker file, unless --always")
    ap.add_argument("--megastep", type=int, default=0,
                    help="megastep mode (Trainer.run_megastep): train "
                         "through the device-ingest path with this many "
                         "chunk segments a dispatch; checkpoints land at "
                         "megastep boundaries and --kill-at counts "
                         "megasteps")
    ap.add_argument("--hot-tier", type=int, default=0,
                    help="two-tier storage: replicate the leading H ids "
                         "(TableSpec.hot_tier)")
    ap.add_argument("--hot-sync-every", type=int, default=1,
                    help="hot-tier reconcile cadence in steps "
                         "(TrainerConfig.hot_sync_every)")
    ap.add_argument("--retier-every", type=int, default=0,
                    help="adaptive tiering (fps_tpu_torch.tiering): attach "
                         "a Retierer checking every N chunk boundaries "
                         "with FORCED re-ranks (churn threshold -1) and "
                         "tracker sidecars beside the checkpoints; combine "
                         "with --hot-tier/--hot-sync-every")
    ap.add_argument("--cold-budget", type=int, default=0,
                    help="payload-proportional cold routing "
                         "(TableSpec.cold_budget; needs a partial "
                         "--hot-tier)")
    ap.add_argument("--hot-fold", default=None,
                    choices=["adagrad", "adam"],
                    help="stateful hot-tier server optimizer "
                         "(ServerLogic.hot_fold; needs a fully replicated "
                         "--hot-tier and --hot-sync-every > 1); its sharded "
                         "state rides checkpoints as fold:: arrays")
    ap.add_argument("--chunk-sleep-s", type=float, default=0.0,
                    help="sleep this long at every chunk boundary (paces "
                         "the run; no effect on the math)")
    ap.add_argument("--keep", type=int, default=3,
                    help="snapshot retention (Checkpointer keep)")
    ap.add_argument("--misbehave-host", default=None,
                    help="apply the wedge/crash/kill flags only when "
                         "running as this pod member (FPS_TPU_POD_HOST)")
    ap.add_argument("--crash-until-file", default=None,
                    help="exit(3) at startup (before any beat) until this "
                         "file exists")
    ap.add_argument("--obs-dir", default=None,
                    help="open full on-disk telemetry here "
                         "(fps_tpu_torch.obs.open_run), with the causal-"
                         "trace context inherited from the supervisor's "
                         "env contract")
    ap.add_argument("--num-features", type=int, default=0,
                    help="the feature table's size (0 = the standard tiny "
                         "NF); the delta-chain scenarios raise it so a "
                         "chunk touches a small fraction of the rows, the "
                         "card's run to 1,000,000")
    ap.add_argument("--delta-full-every", type=int, default=0,
                    help="delta-snapshot chains (DeltaPolicy.full_every "
                         "> 1): publish row-sparse deltas between fulls")
    ap.add_argument("--delta-compact-every", type=int, default=0,
                    help="DeltaPolicy.compact_every: background chain "
                         "compaction once the live chain carries this "
                         "many deltas")
    ap.add_argument("--device", default=None,
                    help="put every position on this torch device (the "
                         "tests: cpu); default: the visible CUDA devices, "
                         "and without CUDA the child exits non-zero")
    ap.add_argument("--num-shards", type=int, default=None,
                    help="positions of the shard axis (default: one a "
                         "visible CUDA device, or one on --device); the hot "
                         "tier needs more than one")
    args = ap.parse_args(argv)

    from fps_tpu_torch.supervise import child

    hb = child.from_env()
    preset = child.quarantined_from_env()
    attempt = child.attempt_from_env()
    pod = child.pod_env()

    # Pod-member misbehaviour gating: one shared command template, and
    # only the named member misbehaves.
    misbehave = (args.misbehave_host is None
                 or pod["host"] == args.misbehave_host)
    if not misbehave:
        args.wedge_at = args.crash_at = args.kill_at = None
        args.kill_prefetch_at = args.crash_until_file = None
    if (args.crash_until_file is not None
            and not os.path.exists(args.crash_until_file)):
        # Dies before any beat or torch import: an index-less crash.
        print(json.dumps({"event": "demo_crash_until_file",
                          "file": args.crash_until_file}), flush=True)
        return 3

    import numpy as np
    import torch

    if args.device is None and not torch.cuda.is_available():
        print("supervised_demo: CUDA is not available and no --device was "
              "given; this child trains on the card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False

    from fps_tpu_torch.core.checkpoint import AsyncCheckpointer, Checkpointer
    from fps_tpu_torch.core.resilience import RollbackPolicy
    from fps_tpu_torch.examples.common import apply_hot_tier
    from fps_tpu_torch.models.logistic_regression import (
        LogRegConfig,
        logistic_regression,
    )
    from fps_tpu_torch.ops import _build, kernels
    from fps_tpu_torch.parallel.mesh import make_ps_mesh, num_workers_of
    from fps_tpu_torch.testing import chaos
    from fps_tpu_torch.testing.workloads import (
        NF,
        logreg_chunks,
        logreg_data,
        weights,
    )

    mesh = make_ps_mesh(num_shards=args.num_shards, device=args.device)
    device = mesh.device
    start_info = {"device": str(device)}
    if device.type == "cuda":
        # The library is built by whoever launched this child: here it is
        # only loaded (a child killed inside nvcc would leave tmp objects).
        _build.library()
        free, total = torch.cuda.mem_get_info(device)
        start_info.update(build_cached=bool(_build.build_info.get("cached")),
                          mem_free_bytes=int(free), mem_total_bytes=int(total))
    kernels.reset_launch_counts()

    # A heartbeat-only recorder makes the DRIVER's sub-phase beats flow;
    # with --obs-dir the full on-disk recorder opens instead and the
    # heartbeat sink rides it.
    rec = None
    if args.obs_dir:
        import fps_tpu_torch.obs as obs

        rec = obs.open_run(
            args.obs_dir,
            config={"examples": args.examples, "epochs": args.epochs},
            meta={k: v for k, v in
                  (("host", pod["host"]), ("workload", "supervised_demo"),
                   ("attempt", attempt)) if v is not None})
        if hb is not None:
            rec.sinks.append(child.HeartbeatSink(hb))
    elif hb is not None:
        from fps_tpu_torch.obs import Recorder

        rec = Recorder(sinks=[child.HeartbeatSink(hb)])

    W = num_workers_of(mesh)
    nf = args.num_features or NF
    # The same planted workload at any table size (same seeds, so straight
    # and supervised runs stay comparable).
    train, _ = logreg_data(args.examples, nf)
    chunks = logreg_chunks(train, W, epochs=args.epochs)

    cfg = LogRegConfig(num_features=nf, learning_rate=0.5)
    trainer, store = logistic_regression(mesh, cfg)
    if args.prefetch:
        import dataclasses

        trainer.config = dataclasses.replace(trainer.config,
                                             prefetch=args.prefetch)
    args.auto_tier = False  # apply_hot_tier reads the examples' flag set
    apply_hot_tier(args, trainer, store)
    if args.retier_every:
        from fps_tpu_torch.tiering import Retierer

        # Forced-cadence adaptive mode, its tracker state saved beside
        # the checkpoints so a restart replays the same re-rank decisions.
        trainer.retierer = Retierer(check_every=args.retier_every,
                                    churn_threshold=-1.0,
                                    state_dir=args.ckpt_dir)
    tables, ls = trainer.init_state(0)

    ckpt_cls = Checkpointer if args.sync_checkpointer else AsyncCheckpointer
    delta_policy = None
    if args.delta_full_every > 1:
        from fps_tpu_torch.core.checkpoint import DeltaPolicy

        delta_policy = DeltaPolicy(full_every=args.delta_full_every,
                                   compact_every=args.delta_compact_every)
    # Under a pod, publishes carry (and are fenced by) the attempt's epoch.
    ckpt = ckpt_cls(args.ckpt_dir, keep=args.keep, fence_epoch=pod["epoch"],
                    delta=delta_policy)
    if pod["step"] is not None:
        # The pod-commanded common restart step: exactly, else the newest
        # verified snapshot at or below it, else whatever this member has.
        commanded = pod["step"]
        if commanded and ckpt.verify_snapshot(commanded):
            start = commanded
        else:
            below = [s for s in ckpt.steps()
                     if s <= commanded and ckpt.verify_snapshot(s)]
            start = below[-1] if below else (ckpt.latest_valid_step() or 0)
        if start:
            tables, ls, start = trainer.restore_checkpoint(ckpt, ls,
                                                           step=start)
    else:
        start = ckpt.latest_valid_step() or 0
        if start:
            # Auto-resolve: a corrupt newest snapshot is quarantined and
            # the restore falls back.
            tables, ls, start = trainer.restore_checkpoint(ckpt, ls)
    tiering_restored = None
    if start and trainer.retierer is not None:
        tiering_restored = trainer.retierer.restore(start)
    if hb is not None:
        # Beat before work: name the chunk about to be attempted, so a
        # crash inside the first (resumed) chunk attributes to it.
        hb.beat(index=start, attempt=attempt)
    meta = {"attempt": attempt, "restored_step": start,
            "quarantined": sorted(preset), "total_chunks": len(chunks),
            "pod": pod, **start_info}
    print(json.dumps({"event": "demo_start", **meta}), flush=True)
    if preset:
        print(json.dumps({"event": "quarantine_carried",
                          "indices": sorted(preset)}), flush=True)

    marker = os.path.join(args.ckpt_dir, "misbehave.done")
    wedge = None
    if args.wedge_at is not None:
        wedge = chaos.wedge_at_chunk(args.wedge_at, args.wedge_mode,
                                     marker=None if args.always else marker)
    killer = None
    if args.kill_at is not None:
        # Flushed first, so at most one chunk is lost under the async
        # writer.
        killer = chaos.kill_at_chunk(
            args.kill_at,
            marker=None if args.always else os.path.join(
                args.ckpt_dir, "kill_at.done"),
            before=ckpt.flush)

    def on_chunk(i, metrics):
        if args.chunk_sleep_s:
            import time as _time

            _time.sleep(args.chunk_sleep_s)
        if (args.crash_at is not None and i == args.crash_at
                and i not in preset
                and (args.always or not os.path.exists(marker))):
            # A poison batch crashing the worker at chunk i, before i + 1
            # is beaten: i is the attempt's last index, the quarantine's
            # evidence. It recurs until quarantined.
            print(json.dumps({"event": "demo_crash", "index": int(i)}),
                  flush=True)
            os._exit(3)
        if wedge is not None and i == args.wedge_at:
            # The one-chunk-lost bound needs the earlier snapshots durable
            # before the freeze: a stopped writer never finishes.
            ckpt.flush()
        if wedge is not None:
            wedge(i, metrics)
        if killer is not None:
            killer(i, metrics)
        if hb is not None:
            hb.beat(index=int(i) + 1, attempt=attempt)

    rollback = RollbackPolicy(preset=preset) if preset else None
    if args.megastep:
        # The same workload through device ingest, K chunk segments a
        # dispatch, checkpoints at megastep boundaries; --kill-at fires in
        # on_megastep, after megastep i trains, before its checkpoint.
        import dataclasses

        from fps_tpu_torch.core.device_ingest import (
            DeviceDataset,
            DeviceEpochPlan,
        )

        trainer.config = dataclasses.replace(
            trainer.config, max_steps_per_call=MEGASTEP_T_CALL)
        plan = DeviceEpochPlan(DeviceDataset(mesh, train), num_workers=W,
                               local_batch=32, seed=3)
        tables, ls, _ = trainer.run_megastep(
            tables, ls, plan, 1, epochs=args.epochs,
            chunks_per_dispatch=args.megastep, checkpointer=ckpt,
            checkpoint_every=1, start_megastep=start, on_megastep=on_chunk,
            rollback=rollback, recorder=rec)
        meta["megastep"] = args.megastep
    else:
        stream = chunks[start:]
        if (args.kill_prefetch_at is not None
                and args.kill_prefetch_at >= start):
            # Die while the worker assembles this chunk (its index in the
            # resumed stream).
            stream = chaos.kill_in_prefetch(
                iter(stream), args.kill_prefetch_at - start,
                marker=None if args.always else os.path.join(
                    args.ckpt_dir, "prefetch_kill.done"))
        tables, ls, _ = trainer.fit_stream(
            tables, ls, stream, 1, checkpointer=ckpt, checkpoint_every=1,
            start_step=start, on_chunk=on_chunk, rollback=rollback,
            recorder=rec)
    ckpt.close()
    if args.obs_dir and rec is not None:
        rec.close()  # run_end and the final flush
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    np.savez(args.out, weights=weights(store, nf))
    meta.update(finished=True,
                skipped=sorted(rollback.skipped) if rollback else [],
                tiering_restored=tiering_restored,
                delta_publishes=ckpt.delta_publishes,
                full_publishes=ckpt.full_publishes,
                compactions=ckpt.compactions,
                re_ranks=(trainer.retierer.re_ranks
                          if trainer.retierer is not None else None),
                launches=kernels.launch_counts())
    with open(args.out + ".meta.json", "w", encoding="utf-8") as f:
        json.dump(meta, f)
    print(json.dumps({"event": "demo_done", **meta}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
