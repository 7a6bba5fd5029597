"""The megastep: K chunk segments of a device plan in one Python dispatch.

Port of ``fps_tpu/core/megastep.py``. The JAX package's megastep runs K
chunk segments under one ``lax.scan`` in one compiled program, with donated
buffers, and does at the segments' boundaries what the host loop did
between calls. The port has no compiled program: a megastep is K
:meth:`~fps_tpu_torch.core.driver.Trainer._run_steps` calls in one Python
dispatch, each exactly the call :meth:`Trainer.run_indexed
<fps_tpu_torch.core.driver.Trainer.run_indexed>` makes for the same chunk
(the same batches, the seed ``fold_seed(fold_seed(seed, e), c)`` and the
same first step), with nothing read back to the host between them but the
vote below. So a megastep run equals the per-chunk ``run_indexed`` loop bit
for bit, tables, metrics and checkpoints, by construction. Capturing it
in a CUDA graph is later work (ROADMAP.md Queue 1 item 2).

What the host loop did between calls happens in the dispatch, on the
device:

* **reconciles** and **sketch merges**: every segment is a whole
  ``_run_steps`` call, which ends with the flush reconcile and merges its
  windows into ``::sketch``;
* **tier ticks** (:class:`~fps_tpu_torch.tiering.MegastepTick`): every
  ``check_every`` segments the merged window folds into a decayed
  count-min on the device, the head re-ranks (count descending, id
  ascending) and the replica, slot map and id array are derived anew from
  the canonical table, with no host read (:func:`apply_tick`);
* **the overflow vote**: the segments' batches are built on the device, so
  there is no host id stream to certify the compacted cold routes
  (``TableSpec.cold_budget``) against. Before a group of segments runs
  (``check_every`` segments, or the whole dispatch without a tick), each
  worker counts every step's cold ids of each compacted table from the raw
  batches (``WorkerLogic.pulled_ids_traced``), the misfits are summed over
  every position in the fixed order of :mod:`fps_tpu_torch.parallel.
  collectives` (over processes a collective) and that one small tensor is
  read on the host: one host read a group. A segment that fits takes the
  compacted routes, any other the static routes, which give the same bits.

Checkpoints land every ``checkpoint_every`` megasteps under the global
megastep index (``start_megastep`` resumes there); a poisoned megastep is
quarantined under a rollback policy, the tick's state restored with the
tables.

The epoch's last dispatch runs its real segments only (as ``run_indexed``
runs no padding steps): the JAX package runs its trailing segments as
weight-0 phantoms and ticks after them. Here a tick group with at least one
real segment ticks at its end, and a group with none does not run.
"""

from __future__ import annotations

import torch

from fps_tpu_torch import sketch as sklib
from fps_tpu_torch.core import resilience
from fps_tpu_torch.core.resilience import tree_copy
from fps_tpu_torch.core.rng import fold_seed
from fps_tpu_torch.core.store import (
    device_slot_map,
    hot_key,
    ids_key,
    lookup_hot_slots,
    map_key,
    replica_from_shard,
    sketch_key,
)
from fps_tpu_torch.obs.timing import PhaseTimer
from fps_tpu_torch.parallel import collectives
from fps_tpu_torch.parallel.mesh import DATA_AXIS, SHARD_AXIS, Blocks


def vote_certifiable_tables(trainer, plan) -> frozenset:
    """The compacted tables the vote can certify: the logic's
    :meth:`~fps_tpu_torch.core.api.WorkerLogic.pulled_ids_traced` stream
    must cover each of them. The hook is probed on a real batch (the first
    worker's first step of epoch 0); a stream that misses a compacted table
    certifies none, and every segment takes the static routes, as the host
    certifier reports every compacted table of an uncertifiable chunk."""
    compact = trainer._cold_compact_map()
    if not compact:
        return frozenset()
    batches = plan.call_batches(plan.epoch_args(0), 0, 1)
    batch = {k: v[0] for k, v in trainer._worker_batches(batches)[0].items()}
    ids = trainer.logic.pulled_ids_traced(batch)
    if ids is None or not set(compact) <= set(ids):
        return frozenset()
    return frozenset(compact)


def group_votes(trainer, tables, batches, steps: list[int],
                lanes: dict) -> list:
    """The vote of one group of segments: whether each segment (``steps``
    its step counts, the group's ``batches`` cut in that order) fits its
    lanes on every worker, as a list of bools. A worker's step fits when
    each compacted table has no more cold ids than its lane (padding counts
    as the compaction sees it: an id of a mapped table is cold when it is
    ``>= 0`` and outside the slot map, of a static head when it is ``>=
    H``). The misfits are summed over every position (shard axis, then
    data axis) and read once on the host. ``tables``: the live tables (a
    mapped table's slot maps)."""
    tier = trainer._hot_tier_map()
    mapped = trainer._mapped_tables()
    n = len(steps)
    T = max(steps)
    total = sum(steps)
    misfits = []
    for w, b in enumerate(trainer._worker_batches(batches)):
        ids = trainer.logic.pulled_ids_traced(b)
        fit = None
        for name in sorted(lanes):
            t = ids[name].reshape(total, -1).to(torch.int32)
            if name in mapped:
                slot = lookup_hot_slots(tables[map_key(name)][w],
                                        t.reshape(-1)).reshape(t.shape)
                cold = (t >= 0) & (slot < 0)
            else:
                cold = t >= tier[name]
            ok = torch.sum(cold, 1, dtype=torch.int32) <= lanes[name]
            fit = ok if fit is None else fit & ok
        if total < n * T:
            # Only the epoch's last segment is short: its missing steps fit.
            fit = torch.cat([fit, torch.ones(n * T - total, dtype=torch.bool,
                                              device=fit.device)])
        misfits.append((~fit.reshape(n, T).all(1)).to(torch.int32))
    mesh = trainer.mesh
    bad = collectives.psum(mesh, collectives.psum(mesh, misfits, SHARD_AXIS),
                           DATA_AXIS)
    return [not b for b in bad[0].tolist()]  # the group's one host read


def _pad_cold_dropped(metrics, lanes, steps: int):
    """A static segment's metrics with a zero ``cold_dropped`` leaf under
    each compacted table, so every segment's tree has one structure."""
    ht = dict(metrics[resilience.HOT_TIER_KEY])
    for name in sorted(lanes):
        entry = dict(ht[name])
        like = entry["delta_sq"]
        entry["cold_dropped"] = torch.zeros((steps,), dtype=torch.int32,
                                            device=like.device)
        ht[name] = entry
    return dict(metrics, **{resilience.HOT_TIER_KEY: ht})


def apply_tick(trainer, tick, tables, tick_ops):
    """The tier tick at a group's end, every step on the device: for each
    tracked table, fold its merged window (``::sketch``) into the decayed
    count-min (:func:`~fps_tpu_torch.sketch.dcm_fold_traced`), zero the
    window, estimate every id (:func:`~fps_tpu_torch.sketch.cm_query`),
    rank the candidates (:func:`~fps_tpu_torch.tiering.tick.
    device_top_ids`), and select the new hot set with a ``where``: the
    candidates when the churn exceeds the threshold and something was
    promoted (the host ``Retierer``'s rule), else the current set. The id
    array, slot map and replica are derived anew on every position (the
    replica a copy of the canonical rows, valid since every segment ended
    in a reconcile). Returns ``(tables, tick_ops, extras)``; ``extras``
    holds each table's churn and re-rank flag as device tensors."""
    from fps_tpu_torch.tiering.tick import device_top_ids

    mesh = trainer.mesh
    mapped = trainer._mapped_tables()
    tables = dict(tables)
    dcm = dict(tick_ops["dcm"])
    tct = tick_ops["tick"]
    extras = {}
    for name in sorted(trainer._track_specs()):
        num_ids = trainer.store.specs[name].num_ids
        H = mapped[name]
        win = tables[sketch_key(name)]
        st = sklib.dcm_fold_traced(tick.spec, dcm[name],
                                   win[0].to(tct.device), tct)
        dcm[name] = st
        tables[sketch_key(name)] = Blocks(
            [torch.zeros_like(x) for x in win], replicas=win.replicas,
            mesh=mesh)
        est = sklib.cm_query(tick._table_cm(name), st, torch.arange(
            num_ids, dtype=torch.int32, device=st.device))
        cand = device_top_ids(est, H)
        cur = lookup_hot_slots(tables[map_key(name)][0].to(cand.device),
                               cand)
        promoted = H - torch.sum(cur >= 0, dtype=torch.int32)
        churn = promoted.to(torch.float32) / H
        swap = (churn > tick.churn_threshold) & (promoted > 0)
        sel = torch.where(swap, cand,
                          tables[ids_key(name)][0].to(cand.device))
        reps = len(mesh.slot)
        tables[ids_key(name)] = Blocks(
            [sel.to(dev, copy=True) for dev in mesh.positions],
            replicas=reps, mesh=mesh)
        tables[map_key(name)] = Blocks(
            [device_slot_map(num_ids, g) for g in tables[ids_key(name)]],
            replicas=reps, mesh=mesh)
        tables[hot_key(name)] = replica_from_shard(
            mesh, tables[name], sel, num_shards=trainer.num_shards)
        extras[name] = {"churn": churn, "re_ranked": swap.to(torch.int32)}
    return tables, {"dcm": dcm, "tick": tct + 1}, extras


def dispatch(trainer, tables, local_state, plan, iargs, seed: int,
             start_ci: int, K: int, *, lanes: dict | None, tick=None,
             tick_ops=None):
    """One megastep: the real chunk segments ``[start_ci, start_ci + K)`` of
    an epoch (``iargs = plan.epoch_args(e)``, ``seed`` the epoch's
    ``fold_seed(seed, e)``), in groups of ``tick.check_every`` segments
    (the whole dispatch without a tick). ``lanes``: the compacted tables'
    lanes when the vote runs (``None``: every segment static). Each group's
    batches are built once; with ``lanes`` the group votes first; each
    segment is ``run_indexed``'s call of its chunk; with ``tick`` the group
    ends with :func:`apply_tick`. Returns ``(tables, local_state, metrics,
    aux)``: the segments' metrics joined along the step axis, ``aux`` the
    votes (host bools, one a segment; empty without ``lanes``), the tick's
    operands for the next dispatch and its extras, one dict a group."""
    from fps_tpu_torch.core.driver import _tree_stack

    T = plan.steps_per_epoch
    T_call = trainer._indexed_call_steps(plan)
    end_ci = min(start_ci + K, -(-T // T_call))
    group = tick.check_every if tick is not None else K
    parts, votes, extras = [], [], []
    for g0 in range(start_ci, end_ci, group):
        segs = range(g0, min(g0 + group, end_ci))
        steps = [min(T_call, T - ci * T_call) for ci in segs]
        batches = plan.call_batches(iargs, g0 * T_call, sum(steps))
        fits = None
        if lanes:
            fits = group_votes(trainer, tables, batches, steps, lanes)
            votes.extend(fits)
        at = 0
        for j, ci in enumerate(segs):
            seg = {k: v[at:at + steps[j]] for k, v in batches.items()}
            at += steps[j]
            fit = fits is not None and fits[j]
            tables, local_state, metrics = trainer._run_steps(
                tables, local_state, seg, steps[j], fold_seed(seed, ci),
                ci * T_call, compact=lanes if fit else None)
            if lanes and not fit:
                metrics = _pad_cold_dropped(metrics, lanes, steps[j])
            parts.append(metrics)
        if tick is not None:
            tables, tick_ops, ext = apply_tick(trainer, tick, tables,
                                               tick_ops)
            extras.append(ext)
    return (tables, local_state, _tree_stack(parts, torch.cat),
            {"votes": votes, "tick": tick_ops, "extras": extras})


def _validate(trainer, plan, chunks_per_dispatch, tick, rollback, health):
    """The reference's checks, in its order. Returns ``(K or None, auto)``;
    attaches ``tick`` as the trainer's retierer (restored on a refusal)."""
    cfg = trainer.config
    auto_k = isinstance(chunks_per_dispatch, str)
    if auto_k:
        if chunks_per_dispatch != "auto":
            raise ValueError(
                f"chunks_per_dispatch must be an int >= 1 or 'auto', "
                f"got {chunks_per_dispatch!r}")
        K = None  # the calibration window picks it
    else:
        K = int(chunks_per_dispatch)
        if K < 1:
            raise ValueError(
                f"chunks_per_dispatch must be >= 1, got "
                f"{chunks_per_dispatch}")
    if cfg.push_delay:
        raise ValueError(
            "run_megastep does not support push_delay: the pushes in flight "
            "would need a flush at every segment that re-orders their "
            "delivery against the ticks; use fit_stream / run_indexed for "
            "delayed pushes")
    if cfg.auto_tier:
        raise ValueError(
            "run_megastep does not support auto_tier: the planner's re-plan "
            "has no boundary inside a dispatch; plan first, then attach a "
            "MegastepTick for the re-ranks")
    trainer._check_rollback(rollback)
    trainer._check_health(health)
    if (cfg.sync_every or None) != (plan.sync_every or None):
        raise ValueError("plan.sync_every must match TrainerConfig")
    if tick is not None:
        from fps_tpu_torch.tiering.tick import MegastepTick

        if not isinstance(tick, MegastepTick):
            raise TypeError(
                f"tick must be a fps_tpu_torch.tiering.MegastepTick, got "
                f"{type(tick).__name__}")
        if trainer.retierer is not None and trainer.retierer is not tick:
            raise ValueError(
                "trainer already has a retierer attached: run_megastep "
                "runs the tier's boundaries through its own MegastepTick")
        if not auto_k and K % tick.check_every:
            raise ValueError(
                f"chunks_per_dispatch={K} must be a multiple of "
                f"tick.check_every={tick.check_every}, so every tick lands "
                "on a group's end")
        # Attach, then check: the mapped tier resolves only with the tick
        # attached, and a refused call must not leave it attached.
        prev = trainer.retierer
        trainer.retierer = tick
        if not trainer._mapped_tables():
            trainer.retierer = prev
            raise ValueError(
                "MegastepTick attached but no table resolves onto the "
                "mapped tier (it needs a partial hot_tier, hot_sync_every "
                "> 1 and a mesh of more than one position)")
    elif trainer.retierer is not None:
        raise ValueError(
            "run_megastep runs the tier's boundaries in the dispatch: "
            "attach a fps_tpu_torch.tiering.MegastepTick (tick=...), not a "
            "host Retierer")
    return K, auto_k


def run_megastep(trainer, tables, local_state, plan, seed: int, *,
                 epochs: int = 1, chunks_per_dispatch=4, on_megastep=None,
                 checkpointer=None, checkpoint_every: int = 0,
                 start_megastep: int = 0, as_numpy: bool = True,
                 rollback=None, recorder=None, health=None, watchdog=None,
                 tick=None):
    """``epochs`` passes of ``plan`` in megasteps of ``chunks_per_dispatch``
    chunk segments (:meth:`Trainer.run_megastep
    <fps_tpu_torch.core.driver.Trainer.run_megastep>`): the same tables,
    metrics and checkpoints as the per-chunk ``run_indexed`` loop, bit for
    bit. Megastep ``g`` is dispatch ``g % M`` of epoch ``g // M``, ``M =
    ceil(calls an epoch / K)``.

    ``chunks_per_dispatch="auto"``: the calibration window
    (:mod:`fps_tpu_torch.core.autok`) times one- and two-block dispatches
    on copies of the state and picks the smallest K whose modelled
    host-serial share clears the target, a multiple of the tick's cadence
    (the ``megastep.auto_k`` gauge). A resumed run passes the chosen K.

    Checkpoints every ``checkpoint_every`` megasteps, as step ``g + 1``,
    and at the end; ``rollback`` / ``health`` / ``watchdog`` judge a
    megastep at a time (a quarantine restores the state and the tick's
    from before it; the poisoned segments ride the journal's event,
    :func:`~fps_tpu_torch.core.resilience.health_by_segment`). ``tick`` (a
    :class:`~fps_tpu_torch.tiering.MegastepTick`) ticks every
    ``tick.check_every`` segments; K must be a multiple of it. Its host
    mirrors are read back at checkpoints and at the end.

    Returns ``(tables, local_state, metrics)``, one metrics tree a
    megastep, of its real steps.
    """
    from fps_tpu_torch.core.driver import (
        _beat,
        _find_heartbeat,
        _phase,
        _to_host,
        _watch,
    )

    K, auto_k = _validate(trainer, plan, chunks_per_dispatch, tick,
                          rollback, health)
    cfg = trainer.config
    rec = recorder if recorder is not None else trainer.recorder
    timer = PhaseTimer(rec) if rec is not None else None
    hb = _find_heartbeat(rec)
    quarantine = (rollback if rollback is not None
                  and resilience.as_guard(cfg.guard) is not None else None)
    sync_each = (quarantine is not None or health is not None
                 or watchdog is not None)
    T_call = trainer._indexed_call_steps(plan)
    n_calls = -(-plan.steps_per_epoch // T_call)
    trainer._enter_tiering()
    tables = trainer._attach_hot(tables, timer)
    compact_cfg = trainer._cold_compact_map()
    lanes = None
    if compact_cfg and vote_certifiable_tables(trainer, plan):
        lanes = dict(compact_cfg)
    if auto_k:
        from fps_tpu_torch.core.autok import calibrate_chunks_per_dispatch

        K, overhead_s, per_chunk_s = calibrate_chunks_per_dispatch(
            trainer, tables, local_state, plan, seed, lanes=lanes, tick=tick,
            n_calls=n_calls)
        if rec is not None:
            rec.set("megastep.auto_k", K)
            rec.event("megastep_auto_k", chosen_k=K,
                      overhead_s=round(overhead_s, 6),
                      per_chunk_s=round(per_chunk_s, 6))
    M = -(-n_calls // K)
    # What shapes the dispatch beside the trainer's program key (the JAX
    # package's: the tick's spec, cadence, threshold and tables).
    tick_key = (None if tick is None else
                (tick.spec, tick.check_every, tick.churn_threshold,
                 tuple(sorted(tick.tables)) if tick.tables else None))
    if rec is not None:
        rec.set("megastep.chunks_per_dispatch", K)
    all_metrics = []
    votes_seen = []   # (votes or None, real segments) a dispatch
    ticks_seen = []   # the surviving dispatches' tick extras
    saved_at = None
    tick_dev = None   # the tick's device operands between dispatches
    iargs, cur_epoch = None, None
    end = epochs * M

    def tick_host_sync():
        if tick is not None and tick_dev is not None:
            tick.absorb(trainer, tick_dev, tables)

    def fold_votes():
        if rec is None or not compact_cfg:
            return
        for votes, real in votes_seen:
            if votes is None:
                # Uncertifiable: every real segment took the static routes,
                # one AND-ed verdict a window (unlabeled).
                rec.inc("cold_route.vote_overflow_windows", real)
                continue
            ok = sum(votes)
            if ok:
                rec.inc("cold_route.vote_compact_windows", ok)
            if ok < len(votes):
                rec.inc("cold_route.vote_overflow_windows", len(votes) - ok)
        votes_seen.clear()

    def fold_ticks():
        if rec is None:
            return
        for extras in ticks_seen:  # one dict a group of a dispatch
            for name in sorted(extras[0]):
                rr = int(torch.stack([x[name]["re_ranked"]
                                      for x in extras]).sum())
                if rr:
                    rec.inc("tiering.re_ranks", rr, table=name)
                rec.set("tiering.churn", float(extras[-1][name]["churn"]),
                        table=name)
        ticks_seen.clear()

    try:
        for g in range(start_megastep, end):
            e, m = divmod(g, M)
            if rollback is not None and g in rollback.preset:
                rollback.skip(g)
                if rec is not None:
                    rec.inc("rollback.preset_skipped")
                    rec.flush()
                continue
            if cur_epoch != e:
                with _phase(timer, "ingest"):
                    iargs = plan.epoch_args(e)
                cur_epoch = e
            if quarantine is not None:
                last_good = (tree_copy(tables), tree_copy(local_state))
                tick_good = tree_copy(tick_dev)
            tick_ops = None
            if tick is not None:
                tick_ops = (tick_dev if tick_dev is not None
                            else tick.tick_ops(trainer))
            real_segs = min(K, n_calls - m * K)
            _beat(hb, g, "dispatch")
            restored = None
            with _watch(watchdog, "megastep", g):
                with _phase(timer, "megastep"):
                    tables, local_state, metrics, aux = trainer._audited_call(
                        "megastep", (plan, K, tuple(sorted(
                            compact_cfg.items())), tick_key),
                        "megastep/" + trainer._mode(), tables,
                        lambda: dispatch(
                            trainer, tables, local_state, plan, iargs,
                            fold_seed(seed, e), m * K, K, lanes=lanes,
                            tick=tick, tick_ops=tick_ops))
                if quarantine is not None:
                    with _phase(timer, "host_sync"):
                        metrics, restored = trainer._maybe_quarantine(
                            quarantine, last_good, metrics, g, "megastep")
                elif sync_each:
                    with _phase(timer, "host_sync"):
                        metrics = _to_host(metrics)
            if tick is not None:
                tick_dev = aux["tick"]
            if compact_cfg:
                # Counted at dispatch, a later-quarantined megastep's too,
                # as the host certifier counts before adjudication.
                votes_seen.append((aux["votes"] if lanes else None,
                                   real_segs))
            ev = {"index": g} if rec is not None else None
            poison = 0
            if sync_each and (rec is not None or health is not None):
                poison = trainer._fold_metrics_accounting(rec, metrics, ev)
            if rec is not None:
                rec.inc("megastep.windows", real_segs)
                if restored is not None:
                    rec.inc("rollback.quarantined")
                    ev["quarantined"] = True
                    seg = resilience.health_by_segment(metrics, K, T_call)
                    ev["poisoned_chunks_in_graph"] = [
                        m * K + i for i, p in enumerate(seg) if p]
            trainer._apply_health_decision(health, rec, g, poison,
                                           "megastep")
            if restored is not None:
                if rec is not None:
                    rec.event("megastep", phases=timer.chunk_summary(), **ev)
                    rec.flush()
                tables, local_state = restored
                if tick is not None:
                    tick_dev = tick_good
                continue
            if tick is not None and aux["extras"]:
                # A quarantined megastep's re-ranks rolled back with it.
                ticks_seen.append(aux["extras"])
            all_metrics.append(metrics)
            trainer.store.tables = dict(tables)
            if on_megastep is not None:
                with _phase(timer, "host_sync"):
                    host = _to_host(metrics)
                if rec is not None and not sync_each:
                    trainer._fold_metrics_accounting(rec, host, ev)
                all_metrics[-1] = host
                with _phase(timer, "callback"):
                    on_megastep(g, host)
            if (checkpointer is not None and checkpoint_every > 0
                    and (g + 1) % checkpoint_every == 0):
                with _phase(timer, "checkpoint"):
                    tick_host_sync()
                    trainer._save_checkpoint(checkpointer, g + 1,
                                             local_state)
                    if tick is not None and tick.state_dir is not None:
                        tick.save_boundary(g + 1, tables)
                saved_at = g + 1
            if rec is not None:
                rec.event("megastep", phases=timer.chunk_summary(), **ev)
                rec.flush()
        trainer.store.tables = dict(tables)
        tick_host_sync()
        if (checkpointer is not None and end > start_megastep
                and saved_at != end):
            with _phase(timer, "checkpoint"):
                trainer._save_checkpoint(checkpointer, end, local_state,
                                         final=True)
                if tick is not None and tick.state_dir is not None:
                    tick.save_boundary(end, tables)
    finally:
        fold_votes()
        fold_ticks()
        if checkpointer is not None:
            with _phase(timer, "checkpoint"):
                checkpointer.flush()
    if on_megastep is None and as_numpy:
        with _phase(timer, "host_sync"):
            all_metrics = [_to_host(mt) for mt in all_metrics]
        if rec is not None and not sync_each:
            for mt in all_metrics:
                trainer._fold_metrics_accounting(rec, mt)
    if rec is not None:
        rec.flush()
    return tables, local_state, all_metrics
