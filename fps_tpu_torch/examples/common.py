"""What the port's example jobs share: the JSON event stream, the common
flags, the chunk source behind ``--ingest``, and the ``--profile`` trace of
one chunk.

``--ingest device`` (the default, as in the JAX package) keeps the dataset
on the device and builds each chunk there
(:mod:`fps_tpu_torch.core.device_ingest`); ``--ingest host`` builds every
chunk in numpy and copies it over (the unbounded-stream shape).

``--prefetch N`` assembles and places chunks N ahead on a worker thread
(``TrainerConfig.prefetch``; ``IALSSolver.prefetch`` in the iALS example).

``--num-shards`` / ``--num-data`` shape the mesh as in the JAX package's
examples: by default over every visible CUDA device, or with every position
on ``--device`` (``--device cpu --num-shards 4``: four shards on the CPU).

``--profile DIR`` traces one chunk (the third, past warm-up) with
``torch.profiler`` on the card, writes ``DIR/trace.json`` and emits a
``"profile"`` event: the device's busy time, launches and kernels per step
(:mod:`fps_tpu_torch.utils.trace_summary`).
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import sys


def emit(record: dict) -> None:
    """One JSON line per event: the reference's WOut metrics stream."""
    json.dump(record, sys.stdout)
    sys.stdout.write("\n")
    sys.stdout.flush()


def base_parser(description: str) -> argparse.ArgumentParser:
    """The flags every example takes."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--num-shards", type=int, default=None,
                    help="parameter-shard axis size (reference: "
                         "psParallelism); default: all positions")
    ap.add_argument("--num-data", type=int, default=1,
                    help="replicated data-parallel axis size")
    ap.add_argument("--epochs", type=int, default=1)
    ap.add_argument("--local-batch", type=int, default=256,
                    help="examples per worker per step")
    ap.add_argument("--steps-per-chunk", type=int, default=16)
    ap.add_argument("--sync-every", type=int, default=None,
                    help="SSP staleness bound s (default: synchronous)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None,
                    help="put every position of the mesh on this torch "
                         "device (default: one position a visible CUDA "
                         "device)")
    ap.add_argument("--profile", default=None, metavar="DIR",
                    help="trace the third chunk with torch.profiler into DIR")
    ap.add_argument("--ingest", default="device", choices=["device", "host"],
                    help="'device' keeps the dataset resident on the device "
                         "and builds chunks there; 'host' builds every chunk "
                         "in numpy and copies it over (the unbounded-stream "
                         "shape)")
    ap.add_argument("--prefetch", type=int, default=0, metavar="N",
                    help="overlapped host pipeline depth "
                         "(fps_tpu_torch.core.prefetch): chunk assembly and "
                         "placement run up to N chunks ahead on a worker "
                         "thread; 0 = synchronous host loop. The tables are "
                         "the same bits either way")
    return ap


def make_mesh(args):
    """The ``(data, shard)`` mesh of ``--num-shards`` / ``--num-data``: over
    every visible CUDA device, or every position on ``--device``."""
    from fps_tpu_torch.parallel.mesh import make_ps_mesh

    return make_ps_mesh(num_shards=args.num_shards, num_data=args.num_data,
                        device=args.device)


def apply_host_pipeline(args, trainer):
    """Fold ``--prefetch`` into the trainer's config (host-side only: the
    steps are the same)."""
    if args.prefetch < 0:
        raise SystemExit(f"--prefetch must be >= 0, got {args.prefetch}")
    if args.prefetch:
        trainer.config = dataclasses.replace(trainer.config,
                                             prefetch=args.prefetch)
    return trainer


def make_epoch_source(args, mesh, data, *, route_key=None):
    """Restartable chunk source honouring ``--ingest`` and the batching
    flags: ``source(start_epoch=0, epochs=1) -> chunk iterator``. The device
    path builds the dataset and the epoch plan once."""
    from fps_tpu_torch.parallel.mesh import num_workers_of

    W = num_workers_of(mesh)
    if args.ingest == "device":
        from fps_tpu_torch.core.device_ingest import (
            DeviceDataset,
            DeviceEpochPlan,
            device_epoch_chunks,
        )

        ds = DeviceDataset(mesh, data)
        plan = DeviceEpochPlan(
            ds, num_workers=W, local_batch=args.local_batch,
            route_key=route_key, sync_every=args.sync_every, seed=args.seed)

        def source(start_epoch=0, epochs=1):
            return device_epoch_chunks(
                ds, num_workers=W, local_batch=args.local_batch,
                steps_per_chunk=args.steps_per_chunk, route_key=route_key,
                sync_every=args.sync_every, seed=args.seed,
                start_epoch=start_epoch, epochs=epochs, plan=plan)
    else:
        from fps_tpu_torch.core.ingest import epoch_chunks

        def source(start_epoch=0, epochs=1):
            def it():
                for e in range(start_epoch, start_epoch + epochs):
                    yield from epoch_chunks(
                        data, num_workers=W, local_batch=args.local_batch,
                        steps_per_chunk=args.steps_per_chunk,
                        route_key=route_key, sync_every=args.sync_every,
                        seed=None if args.seed is None else args.seed + e)

            return it()

    return source


def make_chunks(args, mesh, data, *, route_key=None):
    """Chunk iterator over ``--epochs`` passes (the one-shot form of
    :func:`make_epoch_source`)."""
    return make_epoch_source(args, mesh, data, route_key=route_key)(
        0, args.epochs)


def profiler(args, device):
    """``(context, step)``: the ``torch.profiler`` context for ``--profile``
    (a null context without it), and the function to call after each chunk.
    Chunk 0 runs untraced, chunk 1 warms the profiler up, chunk 2 is traced
    and summarised in a ``"profile"`` event."""
    if not args.profile:
        return contextlib.nullcontext(), lambda: None
    from torch.profiler import ProfilerActivity, profile, schedule

    from fps_tpu_torch.utils import trace_summary

    if device.type != "cuda":
        raise SystemExit("--profile traces the card; it needs a CUDA device")
    os.makedirs(args.profile, exist_ok=True)
    path = os.path.join(args.profile, "trace.json")

    def traced(p):
        p.export_chrome_trace(path)
        emit({"event": "profile", "trace": path,
              **trace_summary.summarize(trace_summary.load(path),
                                        args.steps_per_chunk)})

    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                   schedule=schedule(wait=1, warmup=1, active=1, repeat=1),
                   on_trace_ready=traced)
    return prof, prof.step
