"""Supervise a training command: deadline abort, retry with backoff,
quarantine. Without torch.

The port's counterpart of ``tools/supervise.py``, over
:class:`fps_tpu_torch.supervise.RunSupervisor`: run a training child under
an external supervisor that aborts it when its heartbeat (or a watched
journal) stalls (SIGTERM, then SIGKILL to the process group), restarts it
with exponential backoff from ``latest_valid_step``, and quarantines chunk
or epoch indices that kill consecutive attempts (persisted in
``supervisor_state.json`` under ``--state-dir`` and exported to the child
through ``FPS_TPU_SUPERVISOR_STATE``).

The child signals progress either through the heartbeat contract (every
example of the port beats when ``FPS_TPU_HEARTBEAT`` is set or
``--heartbeat`` is given: ``fps_tpu_torch.examples.common`` attaches a
``HeartbeatSink`` to its recorder, and the drivers beat their sub-phases
on it), or by writing an obs run journal named with ``--watch``
(``--watch 'OBSDIR/journal-p*.jsonl'``).

Usage, by path (``python -m`` would import the package root, and torch
with it):

  python3 fps_tpu_torch/examples/supervise.py --state-dir CKPT_DIR \\
      [policy flags] -- CMD...

Pod mode (``fps_tpu_torch/supervise/pod.py``, one failure domain for a
multi-host run): one such process a host, all sharing ``--pod-dir``:

  python3 fps_tpu_torch/examples/supervise.py --pod-dir POD --pod-host h0 \\
      --pod-size 3 [--elastic] [policy flags] -- CMD...

The members elect a leader over an atomic-rename lease; every abort,
restart and quarantine becomes one pod-wide, epoch-fenced decision (a
coordinated restart from the COMMON ``latest_valid_step``; the quarantine
merged and broadcast). ``{host}`` in CMD expands to the member's host
name; the member's state dir (and, by convention, its child's checkpoint
dir) is ``POD_DIR/HOST``.

It prints the one-line JSON digest (attempts, restarts, deadline aborts,
quarantined indices, success) and exits 0 only when the child succeeded.

Neither torch nor jax is imported: ``supervise/child.py``,
``supervise/supervisor.py`` and ``supervise/pod.py`` are loaded under
package names whose roots are stubbed, so the ``__init__`` of
``fps_tpu_torch`` (which imports torch) never runs and this process never
touches the card, even when the child owns it.
"""

from __future__ import annotations

import argparse
import importlib
import json
import os
import sys
import types

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
_STUBS = (("fps_tpu_torch", ()), ("fps_tpu_torch.supervise", ("supervise",)))


def load_supervise_module(name: str):
    """``fps_tpu_torch.supervise.<name>`` without running the ``__init__``
    of ``fps_tpu_torch`` or ``fps_tpu_torch.supervise``: when the package
    root is not imported yet, both names are stubbed as bare packages whose
    ``__path__`` points at the real directories, and the module is then
    imported normally (``child.py``, ``supervisor.py`` and ``pod.py`` are
    stdlib-only)."""
    if "fps_tpu_torch" not in sys.modules:
        for pkg, sub in _STUBS:
            stub = types.ModuleType(pkg)
            stub.__path__ = [os.path.join(_ROOT, "fps_tpu_torch", *sub)]
            sys.modules[pkg] = stub
    return importlib.import_module(f"fps_tpu_torch.supervise.{name}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Run a training command under the fps_tpu_torch "
                    "deadline-abort supervisor (no torch in this process)",
        usage="%(prog)s [flags] -- CMD [ARG...]",
    )
    ap.add_argument("--state-dir", default=None,
                    help="directory for supervisor_state.json, the "
                         "heartbeat, the supervisor journal and the "
                         "attempts' logs (conventionally the checkpoint "
                         "directory: the quarantine lives next to the "
                         "snapshots it protects). Required unless running "
                         "in pod mode, where the member's state dir is "
                         "POD_DIR/HOST")
    ap.add_argument("--stall-timeout-s", type=float, default=120.0,
                    help="liveness deadline between progress signals")
    ap.add_argument("--startup-grace-s", type=float, default=None,
                    help="deadline for the FIRST signal of each attempt "
                         "(the interpreter, the torch import, CUDA "
                         "initialisation and the kernels' load; default: "
                         "--stall-timeout-s)")
    ap.add_argument("--wall-deadline-s", type=float, default=None,
                    help="whole-run budget across attempts and backoffs")
    ap.add_argument("--max-restarts", type=int, default=3,
                    help="retry budget (the first launch is free)")
    ap.add_argument("--backoff-base-s", type=float, default=1.0)
    ap.add_argument("--backoff-factor", type=float, default=2.0)
    ap.add_argument("--backoff-max-s", type=float, default=60.0)
    ap.add_argument("--term-grace-s", type=float, default=5.0,
                    help="seconds between SIGTERM and SIGKILL on abort")
    ap.add_argument("--poll-s", type=float, default=0.25)
    ap.add_argument("--quarantine-after", type=int, default=2,
                    help="consecutive same-index failures before that "
                         "chunk or epoch index is quarantined")
    ap.add_argument("--watch", action="append", default=[],
                    metavar="GLOB",
                    help="file glob whose growth also counts as liveness "
                         "(repeatable; e.g. 'OBSDIR/journal-p*.jsonl')")
    pod = ap.add_argument_group(
        "pod coordination (fps_tpu_torch.supervise.pod)",
        "run this process as ONE member of a pod: all members share "
        "--pod-dir (a shared filesystem), elect a leader over an "
        "atomic-rename lease, and every abort/restart/quarantine becomes "
        "one pod-wide decision. '{host}' in the child command expands to "
        "--pod-host; the member's state dir (and, by convention, its "
        "child's checkpoint dir) is POD_DIR/HOST.")
    pod.add_argument("--pod-dir", default=None,
                     help="shared pod directory (lease, control, pod "
                          "state, per-member subdirs); enables pod mode "
                          "together with --pod-host")
    pod.add_argument("--pod-host", default=None,
                     help="this member's unique host name within the pod")
    pod.add_argument("--pod-size", type=int, default=1,
                     help="number of members forming the pod (the leader "
                          "waits for all of them before the first launch)")
    pod.add_argument("--elastic", action="store_true",
                     help="elastic membership: evict a member whose "
                          "failures exhaust --evict-after (the pod "
                          "re-plans at W-1) and re-admit it when it "
                          "returns")
    pod.add_argument("--lease-ttl-s", type=float, default=5.0,
                     help="leader lease expiry; any member may seize an "
                          "expired lease (fencing epoch bump)")
    pod.add_argument("--member-timeout-s", type=float, default=10.0,
                     help="member-beacon staleness before the leader "
                          "treats that host as unreachable")
    pod.add_argument("--evict-after", type=int, default=2,
                     help="consecutive member failures before eviction "
                          "(elastic pods)")
    pod.add_argument("--readmit-budget", type=int, default=2,
                     help="re-admissions allowed per evicted host")
    pod.add_argument("--rejoin-delay-s", type=float, default=0.5,
                     help="cooldown before an evicted member reports "
                          "ready again")
    ap.add_argument("--compilation-cache-dir", default=None,
                    help="exported to every attempt as "
                         "JAX_COMPILATION_CACHE_DIR, as the reference does. "
                         "A child of the port compiles nothing at run time "
                         "(its kernels load from the hash-keyed "
                         "ops/_build/), so it only matters to a child of "
                         "the JAX package")
    ap.add_argument("--pretty", action="store_true",
                    help="indent the digest JSON")
    # Split at the first literal "--" before parsing, so a mistyped
    # supervisor flag is a usage error, not part of the child's argv.
    argv = list(sys.argv[1:] if argv is None else argv)
    if "--" in argv:
        cut = argv.index("--")
        argv, cmd = argv[:cut], argv[cut + 1:]
    else:
        cmd = []
    args = ap.parse_args(argv)
    if not cmd:
        ap.error("no child command given (append it after --)")
    if bool(args.pod_dir) != bool(args.pod_host):
        ap.error("--pod-dir and --pod-host must be given together")
    if not args.pod_dir and not args.state_dir:
        ap.error("--state-dir is required outside pod mode")

    extra_env = {}
    if args.compilation_cache_dir:
        cache_dir = os.path.abspath(args.compilation_cache_dir)
        os.makedirs(cache_dir, exist_ok=True)
        extra_env["JAX_COMPILATION_CACHE_DIR"] = cache_dir

    load_supervise_module("child")
    sup_mod = load_supervise_module("supervisor")
    config = sup_mod.SupervisorConfig(
        stall_timeout_s=args.stall_timeout_s,
        startup_grace_s=args.startup_grace_s,
        wall_deadline_s=args.wall_deadline_s,
        max_restarts=args.max_restarts,
        backoff_base_s=args.backoff_base_s,
        backoff_factor=args.backoff_factor,
        backoff_max_s=args.backoff_max_s,
        term_grace_s=args.term_grace_s,
        poll_interval_s=args.poll_s,
        quarantine_after=args.quarantine_after,
    )
    if args.pod_dir:
        pod_mod = load_supervise_module("pod")
        pod_config = pod_mod.PodConfig(
            pod_size=args.pod_size,
            elastic=args.elastic,
            lease_ttl_s=args.lease_ttl_s,
            member_timeout_s=args.member_timeout_s,
            max_restarts=args.max_restarts,
            evict_after=args.evict_after,
            readmit_budget=args.readmit_budget,
            rejoin_delay_s=args.rejoin_delay_s,
            member=config,
        )
        member = pod_mod.PodMember(
            cmd, pod_dir=args.pod_dir, host=args.pod_host,
            config=pod_config, watch=tuple(args.watch), env=extra_env,
        )
        digest = member.run()
    else:
        supervisor = sup_mod.RunSupervisor(
            cmd, state_dir=args.state_dir, config=config,
            watch=tuple(args.watch), env=extra_env,
        )
        digest = supervisor.run()
    print(json.dumps(digest, indent=2 if args.pretty else None), flush=True)
    return 0 if digest["success"] else 1


if __name__ == "__main__":
    sys.exit(main())
