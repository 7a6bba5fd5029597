"""What the port's example jobs share: the JSON event stream, the common
flags, the chunk source behind ``--ingest``, and the ``--profile`` trace of
one chunk.

``--ingest device`` (the default, as in the JAX package) keeps the dataset
on the device and builds each chunk there
(:mod:`fps_tpu_torch.core.device_ingest`); ``--ingest host`` builds every
chunk in numpy and copies it over (the unbounded-stream shape).

``--prefetch N`` assembles and places chunks N ahead on a worker thread
(``TrainerConfig.prefetch``; ``IALSSolver.prefetch`` in the iALS example).

``--hot-tier H``, ``--hot-sync-every E``, ``--cold-budget C`` and
``--hot-fold KIND`` set the static hot tier on every table of the job
(:func:`apply_hot_tier`, which emits a ``"hot_tier"`` event);
``--auto-tier`` sets ``TrainerConfig.auto_tier`` (adaptive tiering: the
tracker, the planner and the re-ranks of :mod:`fps_tpu_torch.tiering`).

Durability (:mod:`fps_tpu_torch.core.checkpoint`,
:mod:`fps_tpu_torch.core.resilience`): ``--checkpoint-dir`` with
``--checkpoint-every N`` saves every N chunks (epochs for ``run_indexed``)
and at the end (``--checkpoint-async``: the background writer);
``--export PATH`` writes the final model, ``--warm-start PATH`` loads one
before training; ``--guard observe|mask`` (with ``--guard-norm-limit`` and
``--guard-local``) screens every push, and ``--rollback-budget K``
quarantines up to K poisoned chunks.

Telemetry (:mod:`fps_tpu_torch.obs`): ``--obs-dir DIR`` writes the run's
JSONL event log, run journal and Prometheus exposition under ``DIR``
(:func:`attach_obs`; render them with ``tools/obs_report.py DIR``), and
``--obs-watchdog-s S`` flags any chunk whose launches and read take longer
than ``S`` seconds (:func:`make_watchdog`).

Supervision (:mod:`fps_tpu_torch.supervise`): under the supervisor
(``fps_tpu_torch/examples/supervise.py``, which sets ``FPS_TPU_HEARTBEAT``)
or with ``--heartbeat PATH``, a ``HeartbeatSink`` rides the run's recorder
(a heartbeat-only recorder without ``--obs-dir``), so every chunk and epoch
event beats and the drivers beat their sub-phases; the quarantine the
supervisor carries (``FPS_TPU_SUPERVISOR_STATE``) is preloaded into the
``RollbackPolicy`` (:func:`make_rollback`, a ``"quarantine_carried"``
event).

Serving (:mod:`fps_tpu_torch.serve`): ``--serve-port PORT`` (with
``--checkpoint-dir`` and ``--checkpoint-every``) answers pull / score /
top-k queries over the framed TCP wire while the job trains, from the
snapshots it publishes (:func:`maybe_serve`; ``0`` binds an ephemeral
port, named in the ``"serving"`` event).

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
    ap.add_argument("--hot-tier", type=int, default=0, metavar="H",
                    help="the static hot tier (TableSpec.hot_tier): "
                         "replicate the leading H ids of every table on "
                         "every position; hot reads need no collective, hot "
                         "pushes reconcile every --hot-sync-every steps. Ids "
                         "must be frequency-ranked. Engages on meshes of "
                         "more than one position with --hot-sync-every > 1 "
                         "and a sum/mean/max/min fold; otherwise the "
                         "untiered program runs")
    ap.add_argument("--hot-sync-every", type=int, default=1, metavar="E",
                    help="the hot tier's reconcile window in steps "
                         "(TrainerConfig.hot_sync_every); 1 (default) is "
                         "the exact mode, bit-equal to the untiered run")
    ap.add_argument("--cold-budget", type=int, default=0, metavar="C",
                    help="with a partial hot head on the gathered route, "
                         "pack each worker's cold ids of a step into a lane "
                         "of C (TableSpec.cold_budget) for the chunks the "
                         "host certifies; the others take the static "
                         "route, the same bits; 0 = static cold routes")
    ap.add_argument("--hot-fold", default=None, choices=["adagrad", "adam"],
                    help="a stateful server optimizer on the hot tier "
                         "(ServerLogic.hot_fold), its state sharded over "
                         "the shard axis; needs --hot-tier >= num_ids and "
                         "--hot-sync-every > 1")
    ap.add_argument("--auto-tier", action="store_true",
                    help="adaptive tiering (TrainerConfig.auto_tier): "
                         "track the pulled ids on the device (count-min "
                         "windows, summed over the mesh), plan each "
                         "table's hot_tier, hot_sync_every and cold_budget "
                         "from the sketched densities after a warm-up, and "
                         "re-rank a partial head's hot set as the traffic "
                         "drifts")
    ap.add_argument("--export", default=None,
                    help="write the final model to this .npz")
    ap.add_argument("--checkpoint-dir", default=None)
    ap.add_argument("--checkpoint-every", type=int, default=0,
                    help="save every N chunks (requires --checkpoint-dir)")
    ap.add_argument("--checkpoint-async", action="store_true",
                    help="the background checkpoint writer "
                         "(fps_tpu_torch.core.checkpoint.AsyncCheckpointer): "
                         "save() returns before serialize and fsync; the "
                         "end of the run flushes it")
    ap.add_argument("--warm-start", default=None,
                    help="initialize the tables from a saved model .npz "
                         "(reference: transformWithModelLoad)")
    ap.add_argument("--guard", default=None, choices=["observe", "mask"],
                    help="the push-delta guard (fps_tpu_torch.core."
                         "resilience): 'mask' drops non-finite or "
                         "norm-exploded update rows in the step, 'observe' "
                         "only counts them under the metrics' 'health'; "
                         "default off")
    ap.add_argument("--guard-norm-limit", type=float, default=None,
                    help="a push row's L2 norm ceiling (requires --guard)")
    ap.add_argument("--guard-local", action="store_true",
                    help="screen the worker-local state's update too (MF's "
                         "user factors; requires --guard)")
    ap.add_argument("--rollback-budget", type=int, default=None,
                    help="quarantine poisoned chunks through a "
                         "RollbackPolicy with this budget (requires "
                         "--guard)")
    ap.add_argument("--heartbeat", default=None, metavar="PATH",
                    help="supervised-run progress beacon "
                         "(fps_tpu_torch.supervise.child.Heartbeat): beat "
                         "this file at every chunk or epoch boundary and "
                         "the drivers' sub-phases (default: the "
                         "supervisor's FPS_TPU_HEARTBEAT, when set)")
    ap.add_argument("--serve-port", type=int, default=None, metavar="PORT",
                    help="serve the published snapshots over TCP on PORT "
                         "while training (fps_tpu_torch.serve; requires "
                         "--checkpoint-dir and --checkpoint-every; 0 = "
                         "an ephemeral port)")
    ap.add_argument("--obs-dir", default=None, metavar="DIR",
                    help="telemetry output (fps_tpu_torch.obs): JSONL event "
                         "log, per-process run journal, and Prometheus text "
                         "exposition under DIR; render with "
                         "tools/obs_report.py")
    ap.add_argument("--obs-watchdog-s", type=float, default=None,
                    help="flag any chunk whose launches and metrics read "
                         "exceed this many seconds (a stalled step or a "
                         "hung peer); forces a per-chunk metrics read")
    return ap


def _make_heartbeat(args):
    """``--heartbeat`` or the supervisor's ``FPS_TPU_HEARTBEAT`` as a
    Heartbeat, or ``None`` when the run is unsupervised."""
    from fps_tpu_torch.supervise import child

    path = getattr(args, "heartbeat", None)
    return child.Heartbeat(path) if path else child.from_env()


def attach_obs(args, trainer=None, *, workload: str | None = None):
    """``--obs-dir`` and the heartbeat contract as an installed recorder
    (or ``None``): the standard on-disk telemetry set
    (:func:`fps_tpu_torch.obs.open_run`), the journal's config digest over
    the CLI args, installed as the process-default recorder (checkpoint and
    rollback events flow without plumbing) and attached to ``trainer`` when
    given. :func:`finish` closes it.

    When the run is supervised (``--heartbeat`` or ``FPS_TPU_HEARTBEAT``)
    a ``HeartbeatSink`` rides the recorder, so every chunk and epoch event
    is also the supervisor's liveness signal; with no ``--obs-dir`` a
    heartbeat-only recorder is returned instead. Either way the training
    is the same."""
    hb = _make_heartbeat(args)
    if getattr(args, "obs_dir", None) is None:
        if getattr(args, "obs_watchdog_s", None) is not None:
            raise SystemExit("--obs-watchdog-s requires --obs-dir")
        if hb is None:
            return None
        from fps_tpu_torch.obs import Recorder
        from fps_tpu_torch.supervise import child

        rec = Recorder(sinks=[child.HeartbeatSink(hb)])
        if trainer is not None:
            trainer.recorder = rec
        return rec
    from fps_tpu_torch import obs

    rec = obs.open_run(args.obs_dir, config=vars(args),
                       meta={"workload": workload} if workload else None)
    if hb is not None:
        from fps_tpu_torch.supervise import child

        rec.sinks.append(child.HeartbeatSink(hb))
    if trainer is not None:
        trainer.recorder = rec
    emit({"event": "obs", "dir": args.obs_dir, "run_id": rec.run_id})
    return rec


def maybe_serve(args, recorder=None):
    """``--serve-port`` as a serve-while-train context manager.

    Inside the ``with`` block a background thread polls
    ``--checkpoint-dir`` (and the ``--obs-dir`` journal, when set: the
    ``checkpoint_saved`` events carry path, step and bytes) and hot-swaps
    every new verified snapshot into a TCP ``ReadServer``; exit stops the
    watcher, closes the socket, publishes the end-of-run snapshot and
    emits the serve stats. A null context when the flag is off, so call
    sites wrap the training region unconditionally.
    """
    if getattr(args, "serve_port", None) is None:
        return contextlib.nullcontext()
    if not (args.checkpoint_dir and args.checkpoint_every > 0):
        raise SystemExit("--serve-port requires --checkpoint-dir and "
                         "--checkpoint-every (serving reads published "
                         "snapshots)")
    import threading

    from fps_tpu_torch.serve import ReadServer, TcpServe

    server, watcher = ReadServer.over(
        args.checkpoint_dir, journal=getattr(args, "obs_dir", None),
        recorder=recorder)
    tcp = TcpServe(server, port=args.serve_port).start()
    stop = threading.Event()
    thread = threading.Thread(
        target=watcher.run, kwargs={"interval_s": 0.5, "stop": stop},
        name="fps-serve-watcher", daemon=True)
    thread.start()
    emit({"event": "serving", "host": tcp.host, "port": tcp.port,
          "ckpt_dir": args.checkpoint_dir})

    @contextlib.contextmanager
    def running():
        try:
            yield server
        finally:
            stop.set()
            thread.join(timeout=10.0)
            tcp.close()
            if not thread.is_alive():
                # Final swap: the end-of-run flush's snapshot. Skipped if
                # the watcher thread outlived the join (a multi-GB verify
                # can): poll() is single-threaded by contract.
                watcher.poll()
            stats = server.stats()
            stats.update(swaps=dict(watcher.swaps),
                         rejected=watcher.rejected,
                         write_to_servable_s=watcher.write_to_servable_s)
            emit({"event": "served", **stats})

    return running()


def make_watchdog(args, recorder):
    """``--obs-watchdog-s`` as a StepWatchdog bound to the run's
    recorder."""
    if getattr(args, "obs_watchdog_s", None) is None:
        return None
    from fps_tpu_torch.obs import StepWatchdog

    return StepWatchdog(args.obs_watchdog_s, recorder=recorder)


def make_guard(args):
    """The ``--guard`` flags as a ``TrainerConfig.guard`` value."""
    if args.guard is None:
        if args.guard_norm_limit is not None:
            raise SystemExit("--guard-norm-limit requires --guard")
        if args.guard_local:
            raise SystemExit("--guard-local requires --guard")
        return None
    from fps_tpu_torch.core.resilience import GuardConfig

    return GuardConfig(mode=args.guard, norm_limit=args.guard_norm_limit,
                       local=args.guard_local)


def make_rollback(args):
    """``--rollback-budget`` and the supervisor-carried quarantine as a
    RollbackPolicy (or ``None``). The preset alone (no budget, no guard) is
    legal: a supervised restart honours the quarantine even when no
    health-based rollback was asked for."""
    from fps_tpu_torch.core.resilience import RollbackPolicy
    from fps_tpu_torch.supervise import child

    preset = child.quarantined_from_env()
    budget = args.rollback_budget
    if budget is None and not preset:
        return None
    if budget is not None and args.guard is None:
        raise SystemExit("--rollback-budget requires --guard")
    policy = RollbackPolicy(preset=preset)
    if budget is not None:
        policy.max_rollbacks = budget
    if preset:
        emit({"event": "quarantine_carried", "indices": sorted(preset)})
    return policy


def maybe_checkpointer(args):
    if args.checkpoint_dir and args.checkpoint_every > 0:
        from fps_tpu_torch.core.checkpoint import (
            AsyncCheckpointer,
            Checkpointer,
        )

        cls = AsyncCheckpointer if args.checkpoint_async else Checkpointer
        return cls(args.checkpoint_dir)
    if args.checkpoint_async:
        raise SystemExit("--checkpoint-async requires --checkpoint-dir "
                         "and --checkpoint-every")
    return None


def durability(args) -> dict:
    """``fit_stream`` / ``run_indexed``'s checkpoint and rollback
    arguments from the flags."""
    return dict(checkpointer=maybe_checkpointer(args),
                checkpoint_every=args.checkpoint_every,
                rollback=make_rollback(args))


def maybe_warm_start(args, store, tables):
    """Apply ``--warm-start`` after the state is made; returns the tables
    to train from (the store's, overwritten)."""
    if not args.warm_start:
        return tables
    from fps_tpu_torch.core.checkpoint import load_model

    load_model(store, args.warm_start)
    emit({"event": "warm_start", "path": args.warm_start})
    return dict(store.tables)


def finish(args, store, recorder=None) -> None:
    """``--export`` at the end of the run, and the ``--obs-dir`` recorder
    closed (the journal's ``run_end`` and the final flush)."""
    if args.export:
        from fps_tpu_torch.core.checkpoint import export_model

        export_model(store, args.export)
        emit({"event": "export", "path": args.export})
    if recorder is not None:
        recorder.close()


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


def apply_hot_tier(args, trainer, store=None):
    """Fold ``--hot-tier`` / ``--hot-sync-every`` / ``--cold-budget`` /
    ``--hot-fold`` / ``--auto-tier`` into the trainer's table specs, server
    logic and config, before its first call, and emit a ``"hot_tier"``
    event naming the tables the tier resolves on for. ``trainer=None`` (the
    iALS example, which has no pull and push trainer) reports the flags as
    ignored."""
    H, E = args.hot_tier, args.hot_sync_every
    cold, fold, auto = args.cold_budget, args.hot_fold, args.auto_tier
    if E < 1:
        raise SystemExit(f"--hot-sync-every must be >= 1, got {E}")
    if H < 0:
        raise SystemExit(f"--hot-tier must be >= 0, got {H}")
    if cold < 0:
        raise SystemExit(f"--cold-budget must be >= 0, got {cold}")
    if cold and not (H or auto):
        raise SystemExit("--cold-budget needs a hot tier: pass --hot-tier H "
                         "(a partial head) or --auto-tier")
    if fold and not H:
        raise SystemExit("--hot-fold needs --hot-tier (the whole table: H >= "
                         "num_ids) and --hot-sync-every > 1")
    if not H and E == 1 and not auto:
        return trainer
    if trainer is None:
        emit({"event": "hot_tier_ignored",
              "reason": "this workload has no pull/push trainer (iALS "
                        "half-epoch solves)"})
        return None
    store = store or trainer.store
    if H:
        for name, spec in store.specs.items():
            store.specs[name] = dataclasses.replace(
                spec, hot_tier=min(H, spec.num_ids), cold_budget=cold)
    if fold:
        for name, sl in trainer.server_logic.items():
            trainer.server_logic[name] = dataclasses.replace(sl,
                                                             hot_fold=fold)
    trainer.config = dataclasses.replace(trainer.config, hot_sync_every=E,
                                         auto_tier=auto)
    tiered = sorted(trainer._hot_tier_map())  # also checks push_delay
    emit({"event": "hot_tier", "hot_tier": H, "hot_sync_every": E,
          "auto_tier": auto, "tiered_tables": tiered,
          "cold_budget": cold, "hot_fold": fold,
          "compacted_tables": sorted(trainer._cold_compact_map()),
          "exact_mode": (E == 1 or not tiered) and not auto})
    return trainer


def report_tiering(trainer) -> None:
    """With a retierer (``--auto-tier``), emit a ``"tiering"`` event: its
    checks, re-ranks and the plan it landed."""
    rt = trainer.retierer
    if rt is None:
        return
    emit({"event": "tiering", "checks": rt.checks, "re_ranks": rt.re_ranks,
          "planned": rt.planned,
          "plans": ({n: p.to_json() for n, p in sorted(rt.plans.items())}
                    if rt.plans else None),
          "tiered_tables": sorted(trainer._hot_tier_map()),
          "hot_sync_every": trainer.config.hot_sync_every})


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
