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

It prints the one-line JSON digest (attempts, restarts, deadline aborts,
quarantined indices, success) and exits 0 only when the child succeeded.

Neither torch nor jax is imported: ``supervise/child.py`` and
``supervise/supervisor.py`` are loaded by file path under package names
whose roots are stubbed, so the ``__init__`` of ``fps_tpu_torch`` (which
imports torch) never runs and this process never touches the card, even
when the child owns it. The pod flags (``--pod-dir`` and the rest) exit
naming ROADMAP.md item 9d.
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

# The reference CLI's pod flags, with their defaults: the pod coordinator
# is ROADMAP.md item 9d.
_POD_FLAGS = (("--pod-dir", None), ("--pod-host", None), ("--pod-size", 1),
              ("--elastic", False), ("--lease-ttl-s", 5.0),
              ("--member-timeout-s", 10.0), ("--evict-after", 2),
              ("--readmit-budget", 2), ("--rejoin-delay-s", 0.5))


def load_supervise_module(name: str):
    """``fps_tpu_torch.supervise.<name>`` without running the ``__init__``
    of ``fps_tpu_torch`` or ``fps_tpu_torch.supervise``: when the package
    root is not imported yet, both names are stubbed as bare packages whose
    ``__path__`` points at the real directories, and the module is then
    imported normally (``child.py`` and ``supervisor.py`` are
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
                         "snapshots it protects)")
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
        "pod coordination",
        "the reference's pod flags; the pod coordinator is ROADMAP.md "
        "item 9d, and each exits naming it")
    for flag, default in _POD_FLAGS:
        if isinstance(default, bool):
            pod.add_argument(flag, action="store_true",
                             help="not ported yet (item 9d)")
        else:
            pod.add_argument(flag, type=type(default) if default is not None
                             else str, default=default,
                             help="not ported yet (item 9d)")
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
    for flag, default in _POD_FLAGS:
        if getattr(args, flag[2:].replace("-", "_")) != default:
            raise SystemExit(f"{flag} is not ported yet (the pod "
                             "coordinator, ROADMAP.md Queue 1 item 9d)")
    if not cmd:
        ap.error("no child command given (append it after --)")
    if not args.state_dir:
        ap.error("--state-dir is required")

    extra_env = {}
    if args.compilation_cache_dir:
        cache_dir = os.path.abspath(args.compilation_cache_dir)
        os.makedirs(cache_dir, exist_ok=True)
        extra_env["JAX_COMPILATION_CACHE_DIR"] = cache_dir

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
    supervisor = sup_mod.RunSupervisor(
        cmd, state_dir=args.state_dir, config=config,
        watch=tuple(args.watch), env=extra_env,
    )
    digest = supervisor.run()
    print(json.dumps(digest, indent=2 if args.pretty else None), flush=True)
    return 0 if digest["success"] else 1


if __name__ == "__main__":
    sys.exit(main())
