"""Torch-free training stand-in for the port's supervisor tests
(``tests/test_torch_supervise.py``): the port's copy of
``tests/_supervised_stub.py``, loading the port's ``supervise/child.py``.

Simulates the supervised-child contract at ~100x real speed: beats the
supervisor heartbeat per "chunk", persists its progress ("checkpoint")
after each chunk, resumes from it on restart, honors the carried
quarantine set, and can misbehave on demand:

* ``--wedge-at K``  — on the FIRST attempt only (marker file), stop
  beating at chunk K and sleep forever: the deadline-abort path.
* ``--wedge-mode sigstop`` — same, but SIGSTOP the whole process instead
  (the queued-SIGTERM case: only the supervisor's SIGKILL escalation can
  clear it).
* ``--crash-at K`` — exit(3) at chunk K on EVERY attempt whose quarantine
  set does not contain K: the deterministic-poison crash loop the
  supervisor must break by quarantining K.
* ``--crash-until-file F`` — exit(3) at startup (before any beat) until
  ``F`` exists: the flapping member the elastic pod must EVICT and, once
  the operator clears the fault (touches F), re-admit.
* ``--misbehave-host H`` — only misbehave when this process runs as pod
  member ``H`` (``FPS_TPU_POD_HOST``): one shared pod command template
  can then poison exactly one member.
* ``--await-first-signal DIR`` — before a ``--crash-at`` crash, wait (at
  most 30 s) until the supervisor's journal in ``DIR``
  (``journal-supervisor.jsonl``; a tenant's ``{state}``) records this
  attempt's ``attempt_first_signal``. The stub beats and crashes within
  milliseconds, which a supervisor polling every 20 ms can miss under
  load; with the flag every crashing attempt is seen before it dies, so
  each attempt counts in the recovery times of either package's journal.

Pod contract (the reference's ``fps_tpu/supervise/pod.py``): besides ``progress.json``
the stub publishes tiny zip "snapshots" named like real checkpoints
(``ckpt_%012d.npz`` — zipfile members carry CRCs, so the stdlib-only pod
coordinator verifies them exactly like real npz snapshots), resumes from
the pod-commanded common step (``FPS_TPU_POD_STEP``), and refuses to
publish behind a pod fence (``pod_fence.json`` vs ``FPS_TPU_POD_EPOCH``)
— exiting 9 with a ``stale epoch`` marker, the stub-speed analog of
``fps_tpu_torch.core.checkpoint``'s ``StaleEpochError``.

Usage: python _torch_supervised_stub.py --dir D --chunks N [flags]
Writes ``result.json`` ({"done": N, "ran": [...]}) into --dir on success.

Loads fps_tpu_torch/supervise/child.py by file path (no package import,
so no torch), as the port's supervisor CLI loads the parent side.
"""

import argparse
import importlib.util
import json
import os
import signal
import sys
import time
import zipfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AWAIT_FIRST_SIGNAL_S = 30.0


def _load_child_module():
    path = os.path.join(_ROOT, "fps_tpu_torch", "supervise", "child.py")
    spec = importlib.util.spec_from_file_location("_fps_torch_child", path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod  # 3.10 needs the registration pre-exec
    spec.loader.exec_module(mod)
    return mod


def _publish_snapshot(child, directory: str, step: int, epoch,
                      keep: int = 3) -> None:
    """Checkpoint-shaped publish: fence check, tmp write, atomic rename,
    keep-N retention — the control-plane surface of a real save."""
    ok, min_epoch = child.fence_allows(directory, epoch)
    if not ok:
        print(f"stub: stale epoch {epoch} < fence {min_epoch}, "
              "refusing to publish", flush=True)
        sys.exit(9)
    name = f"ckpt_{step:012d}.npz"
    tmp = os.path.join(directory, name + ".stub.tmp")
    with zipfile.ZipFile(tmp, "w") as z:
        z.writestr("progress.json",
                   json.dumps({"step": step, "epoch": epoch}))
    os.replace(tmp, os.path.join(directory, name))
    steps = sorted(
        int(f[5:17]) for f in os.listdir(directory)
        if f.startswith("ckpt_") and f.endswith(".npz") and len(f) == 21
    )
    for s in steps[:-keep]:
        try:
            os.remove(os.path.join(directory, f"ckpt_{s:012d}.npz"))
        except OSError:
            pass


def _await_first_signal(state_dir: str, attempt: int) -> bool:
    """Wait until ``state_dir``'s supervisor journal records attempt
    ``attempt``'s ``attempt_first_signal``; False after
    :data:`AWAIT_FIRST_SIGNAL_S` without it."""
    path = os.path.join(state_dir, "journal-supervisor.jsonl")
    deadline = time.monotonic() + AWAIT_FIRST_SIGNAL_S
    while time.monotonic() < deadline:
        try:
            with open(path, encoding="utf-8") as f:
                for line in f:
                    try:
                        rec = json.loads(line)
                    except json.JSONDecodeError:
                        continue  # a torn tail write
                    if (rec.get("event") == "attempt_first_signal"
                            and rec.get("attempt") == attempt):
                        return True
        except OSError:
            pass
        time.sleep(0.01)
    return False


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dir", required=True)
    ap.add_argument("--chunks", type=int, default=8)
    ap.add_argument("--chunk-s", type=float, default=0.05)
    ap.add_argument("--wedge-at", type=int, default=None)
    ap.add_argument("--wedge-mode", default="sleep",
                    choices=["sleep", "sigstop"])
    ap.add_argument("--wedge-always", action="store_true",
                    help="wedge on EVERY attempt (no marker) — the "
                         "unrecoverable-hang case for wall-deadline tests")
    ap.add_argument("--trap-term", action="store_true",
                    help="install a SIGTERM handler that exits 0 (a "
                         "graceful-shutdown child): an ABORTED attempt "
                         "ending rc=0 must still not count as success")
    ap.add_argument("--crash-at", type=int, default=None)
    ap.add_argument("--crash-until-file", default=None,
                    help="exit(3) at startup until this file exists")
    ap.add_argument("--misbehave-host", default=None,
                    help="apply wedge/crash flags only when running as "
                         "this pod member")
    ap.add_argument("--await-first-signal", default=None, metavar="DIR",
                    help="before a --crash-at crash, wait until the "
                         "supervisor journal in DIR records this attempt's "
                         "first signal")
    args = ap.parse_args()

    if args.trap_term:
        signal.signal(signal.SIGTERM, lambda *_: sys.exit(0))

    child = _load_child_module()
    hb = child.from_env()
    quarantined = child.quarantined_from_env()
    pod = child.pod_env()
    os.makedirs(args.dir, exist_ok=True)
    progress_path = os.path.join(args.dir, "progress.json")
    marker = os.path.join(args.dir, "wedge.done")

    misbehave = (args.misbehave_host is None
                 or pod["host"] == args.misbehave_host)
    if (misbehave and args.crash_until_file is not None
            and not os.path.exists(args.crash_until_file)):
        print("stub: crash-until-file fault active, dying at startup",
              flush=True)
        return 3

    start = 0
    if pod["step"] is not None:
        # Pod-commanded common restart step: every member resumes HERE,
        # not from its own (possibly different) local progress.
        start = pod["step"]
    else:
        try:
            with open(progress_path, encoding="utf-8") as f:
                start = int(json.load(f)["next"])
        except (OSError, ValueError, KeyError, json.JSONDecodeError):
            pass

    ran = []
    for i in range(start, args.chunks):
        if hb is not None:
            hb.beat(index=i, attempt=child.attempt_from_env())
        if i in quarantined:
            continue  # carried quarantine: consume the index, skip the work
        if misbehave and args.crash_at is not None and i == args.crash_at:
            if args.await_first_signal is not None:
                seen = _await_first_signal(args.await_first_signal,
                                           child.attempt_from_env())
                print(f"stub: first signal seen: {seen}", flush=True)
            print(f"stub: deterministic crash at chunk {i}", flush=True)
            return 3
        if misbehave and args.wedge_at is not None and i == args.wedge_at \
                and (args.wedge_always or not os.path.exists(marker)):
            open(marker, "w").close()  # wedge once; the restart proceeds
            print(f"stub: wedging ({args.wedge_mode}) at chunk {i}",
                  flush=True)
            if args.wedge_mode == "sigstop":
                os.kill(os.getpid(), signal.SIGSTOP)
            while True:  # sleep-forever wedge (also post-SIGCONT fallthrough)
                time.sleep(3600)
        time.sleep(args.chunk_s)
        ran.append(i)
        with open(progress_path, "w", encoding="utf-8") as f:
            json.dump({"next": i + 1}, f)  # the stub's "checkpoint"
        _publish_snapshot(child, args.dir, i + 1, pod["epoch"])

    with open(os.path.join(args.dir, "result.json"), "w",
              encoding="utf-8") as f:
        json.dump({"done": args.chunks, "ran": ran,
                   "attempt": child.attempt_from_env(),
                   "pod": pod}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
