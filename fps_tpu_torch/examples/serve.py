"""Serve a training run's snapshots to query traffic, without torch.

The port's counterpart of ``tools/serve.py``, over
:mod:`fps_tpu_torch.serve`: point it at a run's ``--checkpoint-dir`` and it
discovers, CRC-verifies and maps the newest snapshot (``SnapshotWatcher``),
answers pull-by-id / scoring / top-k queries over the framed TCP wire
(``TcpServe``), and hot-swaps to every newer snapshot the trainer
publishes, BACKWARD too when the trainer quarantines the served one.
``--journal OBS_DIR`` tails the run's obs journal, so new publishes are
picked up from ``checkpoint_saved`` events.

Modes:

* default: serve until interrupted; print one ``{"event": "serving", ...}``
  JSON line with the bound host and port, then poll every ``--poll-s``
  seconds;
* ``--once``: poll once, print the served manifest (or an error), exit;
* ``--query JSON``: client mode: send one request to ``--host`` /
  ``--port``, print the response. No server is started.

Neither torch nor jax is imported: the package roots ``fps_tpu_torch``,
``fps_tpu_torch.core``, ``fps_tpu_torch.obs`` and ``fps_tpu_torch.testing``
are stubbed as bare packages whose ``__path__`` points at the real
directories, so their ``__init__`` (which imports torch) never runs, and the
serving process stays a numpy reader beside a training job that owns the
card, or on a host with no CUDA runtime. Run it by path (``python -m``
would import the package root first):

  python fps_tpu_torch/examples/serve.py CKPT_DIR [--journal OBS_DIR] [--port N]
  python fps_tpu_torch/examples/serve.py CKPT_DIR --once
  python fps_tpu_torch/examples/serve.py --query '{"op": "stats"}' --port N
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
_STUBS = (("fps_tpu_torch", ()), ("fps_tpu_torch.core", ("core",)),
          ("fps_tpu_torch.obs", ("obs",)),
          ("fps_tpu_torch.testing", ("testing",)))


def load_serve():
    """Import ``fps_tpu_torch.serve`` without executing the ``__init__``
    of ``fps_tpu_torch``, ``.core``, ``.obs`` or ``.testing``: stub those
    packages (names not yet imported only), then import the subpackage
    normally. Serving, ``core.retry``, ``core.snapshot_format``,
    ``obs.events``, ``obs.sinks``, ``obs.trace`` and
    ``testing.faultnet`` are stdlib + numpy."""
    for name, sub in _STUBS:
        if name not in sys.modules:
            stub = types.ModuleType(name)
            stub.__path__ = [os.path.join(_ROOT, "fps_tpu_torch", *sub)]
            sys.modules[name] = stub
    return importlib.import_module("fps_tpu_torch.serve")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="Serve an fps_tpu_torch run's snapshots over TCP "
                    "(fps_tpu_torch.serve; no torch)")
    ap.add_argument("ckpt_dir", nargs="?", default=None,
                    help="the run's --checkpoint-dir (required unless "
                         "--query)")
    ap.add_argument("--journal", default=None, metavar="PATH",
                    help="obs journal file or --obs-dir directory to tail "
                         "for checkpoint_saved events (the directory poll "
                         "stays on as the source of truth)")
    ap.add_argument("--host", default="127.0.0.1")
    ap.add_argument("--port", type=int, default=0,
                    help="TCP port (0 = ephemeral; the bound port is "
                         "printed in the 'serving' line)")
    ap.add_argument("--poll-s", type=float, default=0.5,
                    help="snapshot discovery poll interval")
    ap.add_argument("--max-polls", type=int, default=None,
                    help="stop after this many polls (default: run until "
                         "interrupted)")
    ap.add_argument("--once", action="store_true",
                    help="poll once, print the served manifest, exit "
                         "(no TCP)")
    ap.add_argument("--query", default=None, metavar="JSON",
                    help="client mode: send one request to --host/--port "
                         "and print the response")
    args = ap.parse_args(argv)

    if args.query is not None:
        if not args.port:
            ap.error("--query needs --port")
        serve = load_serve()
        with serve.JsonlClient(args.host, args.port) as client:
            print(json.dumps(client.request(json.loads(args.query))))
        return 0

    if args.ckpt_dir is None:
        ap.error("ckpt_dir is required (or use --query)")
    serve = load_serve()
    server, watcher = serve.ReadServer.over(args.ckpt_dir,
                                            journal=args.journal)
    if args.once:
        if watcher.current is None:
            print(json.dumps({"event": "no_snapshot",
                              "ckpt_dir": args.ckpt_dir,
                              "rejected": watcher.rejected}))
            return 1
        print(json.dumps({"event": "manifest",
                          **watcher.current.manifest(),
                          "rejected": watcher.rejected}))
        return 0

    with serve.TcpServe(server, host=args.host, port=args.port) as tcp:
        print(json.dumps({
            "event": "serving", "host": tcp.host, "port": tcp.port,
            "ckpt_dir": os.path.abspath(args.ckpt_dir),
            "step": None if watcher.current is None
            else watcher.current.step,
        }), flush=True)
        try:
            watcher.run(interval_s=args.poll_s, max_polls=args.max_polls)
        except KeyboardInterrupt:
            pass
    stats = server.stats()
    stats.update(swaps=dict(watcher.swaps), rejected=watcher.rejected,
                 write_to_servable_s=watcher.write_to_servable_s)
    print(json.dumps({"event": "served", **stats}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
