"""The port's drivers under telemetry against the JAX package's.

MF (mean combine) and SSP-capable logistic regression start from the same
state, carried across with ``fps_tpu_torch.convert``, and both packages
take the same numpy chunks at (1, 8) and (2, 4), sync and SSP, through
``fit_stream`` and ``run_indexed``, each with a recorder over a memory
sink and a guard in observe mode. Then:

* every counter's total is equal (``driver.*``, ``health.*``);
* the journal's event kinds come in the same order, with the same
  indices, example counts and poison fields;
* the phase keys are the same set;
* the port's tables and metrics with the recorder equal those without
  it, bit for bit.

Beside the matrix, oracles of ``tests/test_obs.py``: a poisoned stream
under ``guard="observe"`` and a ``HealthMonitor`` escalates to mask at the
chunk the JAX package's run escalates at (with ``health_lag`` 0 and 1),
with the same ``guard_escalated`` event and counters; a second monitor
aborts with ``PoisonedStreamError`` where the reference's does; a clean
watchdog run records no stall; the prefetcher's and the checkpointer's
counters equal the reference's; a monitor needs a guard.
"""

from __future__ import annotations

import inspect

import jax
import numpy as np
import pytest
import torch

from fps_tpu import obs as jobs
from fps_tpu.core import device_ingest as jdi
from fps_tpu.core import ingest as jingest
from fps_tpu.core.resilience import PoisonedStreamError as JPoisoned
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel import mesh as jmesh
from fps_tpu.testing import chaos as jchaos
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    DeviceDataset,
    DeviceEpochPlan,
    LogRegConfig,
    MFConfig,
    logistic_regression,
    obs as tobs,
    online_mf,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.core.resilience import GuardConfig, PoisonedStreamError
from fps_tpu_torch.parallel import mesh as tmesh

MF_KW = dict(num_users=96, num_items=61, rank=4, learning_rate=0.08,
             reg=0.005)
NF = 200
LR_KW = dict(num_features=NF, learning_rate=0.5)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh(D, S):
    return jmesh.make_ps_mesh(num_shards=S, num_data=D,
                              devices=jax.devices()[:D * S])


def _data(family):
    if family == "mf":
        return jdatasets.synthetic_ratings(
            MF_KW["num_users"], MF_KW["num_items"], 1600, rank=3, noise=0.05,
            seed=3)
    data = jdatasets.synthetic_sparse_classification(1024, NF, 8, seed=7,
                                                     noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def _pair(family, D, S, sync_every, guard="observe"):
    """The JAX package's trainer and the port's, from the same state."""
    if family == "mf":
        kw = dict(combine="mean", sync_every=sync_every, guard=guard)
        jtr, _ = jonline_mf(_jmesh(D, S), JMFConfig(**MF_KW), **kw)
        ttr, tst = online_mf(tmesh.make_ps_mesh(S, D, device="cpu"),
                             MFConfig(**MF_KW), **kw)
    else:
        kw = dict(sync_every=sync_every, guard=guard)
        jtr, _ = jlogistic_regression(_jmesh(D, S), JLogRegConfig(**LR_KW),
                                      **kw)
        ttr, tst = logistic_regression(tmesh.make_ps_mesh(S, D, device="cpu"),
                                       LogRegConfig(**LR_KW), **kw)
    jt, jl = jtr.init_state(jax.random.key(0))
    host_t = {k: np.asarray(v) for k, v in jt.items()}
    host_l = np.asarray(jl) if family == "mf" else None

    def fresh():
        """The port's copy of the JAX package's initial state, anew."""
        tl = (() if host_l is None else local_state_from_jax(
            ttr.logic, host_l, mesh=ttr.mesh))
        return tables_from_jax(tst, host_t), tl

    ttr.fresh = fresh
    return (jtr, jt, jl), (ttr,) + fresh()


def _chunks(family, W, sync_every, n=3):
    route = "user" if family == "mf" else None
    return list(jingest.epoch_chunks(
        _data(family), num_workers=W, local_batch=8, steps_per_chunk=4,
        route_key=route, sync_every=sync_every, seed=11))[:n]


def _plans(family, jtr, ttr, W, sync_every):
    route = "user" if family == "mf" else None
    data = _data(family)
    kw = dict(num_workers=W, local_batch=16, route_key=route, seed=5,
              sync_every=sync_every)
    return (jdi.DeviceEpochPlan(jdi.DeviceDataset(jtr.mesh, data), **kw),
            DeviceEpochPlan(DeviceDataset(ttr.mesh, data), **kw))


def _recorders():
    js, ts = jobs.MemorySink(), tobs.MemorySink()
    return (jobs.Recorder(sinks=[js]), js), (tobs.Recorder(sinks=[ts]), ts)


def _journal(sink):
    """Each event's kind, index, example count and poison fields."""
    keep = ("event", "index", "examples", "poison_rows", "quarantined",
            "what")
    return [{k: e[k] for k in keep if k in e} for e in sink.events()]


def _same_state(a, b):
    (ta, la, ma), (tb, lb, mb) = a, b
    assert sorted(ta) == sorted(tb)
    for k in ta:
        np.testing.assert_array_equal(ta[k].numpy(), tb[k].numpy(), k)
    if la != ():
        np.testing.assert_array_equal(la.numpy(), lb.numpy())
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert sorted(x) == sorted(y)
        for k in x:
            if not isinstance(x[k], dict):
                np.testing.assert_array_equal(x[k], y[k], k)


@pytest.mark.parametrize("driver", ["fit_stream", "run_indexed"])
@pytest.mark.parametrize("sync_every", [None, 2], ids=["sync", "ssp"])
@pytest.mark.parametrize("shape", [(1, 8), (2, 4)], ids=["1x8", "2x4"])
@pytest.mark.parametrize("family", ["mf", "logreg"])
def test_telemetry_matches_the_jax_package(family, shape, sync_every,
                                           driver):
    D, S = shape
    W = D * S
    (jtr, jt, jl), (ttr, tt, tl) = _pair(family, D, S, sync_every)
    (jr, js), (tr, ts) = _recorders()
    runs = []
    if driver == "fit_stream":
        chunks = _chunks(family, W, sync_every)
        jtr.fit_stream(jt, jl, iter(chunks), jax.random.key(1), recorder=jr,
                       on_chunk=lambda i, m: None)
        for rec in (tr, None):
            t0, l0 = ttr.fresh()
            runs.append(ttr.fit_stream(t0, l0, iter(chunks), 1,
                                       recorder=rec,
                                       on_chunk=lambda i, m: None))
    else:
        jplan, tplan = _plans(family, jtr, ttr, W, sync_every)
        jtr.run_indexed(jt, jl, jplan, jax.random.key(1), epochs=2,
                        recorder=jr)
        for rec in (tr, None):
            t0, l0 = ttr.fresh()
            runs.append(ttr.run_indexed(t0, l0, tplan, 1, epochs=2,
                                        recorder=rec))
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    assert tr.counter_value("driver.examples") > 0
    assert _journal(ts) == _journal(js)
    assert set(tr.phase_totals()) == set(jr.phase_totals())
    _same_state(*runs)


def _poisoned(W, idx, n=5, kind="huge"):
    data = _data("logreg")
    out = iter(list(jingest.epoch_chunks(
        data, num_workers=W, local_batch=8, steps_per_chunk=4,
        seed=11))[:n])
    for i in sorted(idx):
        out = jchaos.poison_chunks(out, chunk_index=i, column="feat_vals",
                                   kind=kind, frac=0.5, seed=1)
    return list(out)


@pytest.mark.parametrize("lag", [0, 1])
def test_health_monitor_escalates_where_the_reference_does(lag):
    """A stream with NaN features at chunks 1 and 3 under
    ``guard="observe"``, a ``HealthMonitor(escalate_after_rows=1)`` and a
    rollback policy (the production posture): both packages escalate to
    mask at chunk 1, journal one ``guard_escalated``, quarantine chunks 1
    and 3 and count the same rows (at ``health_lag=1`` the read and the
    escalation land one chunk later, in both)."""
    guard = dict(mode="observe", norm_limit=100.0)
    (jtr, jt, _), (ttr, tt, _) = _pair(
        "logreg", 1, 4, None, guard=None)
    import dataclasses

    from fps_tpu.core.resilience import GuardConfig as JGuardConfig

    jtr.config = dataclasses.replace(jtr.config, guard=JGuardConfig(**guard),
                                     health_lag=lag)
    ttr.config = dataclasses.replace(ttr.config, guard=GuardConfig(**guard),
                                     health_lag=lag)
    from fps_tpu.core.resilience import RollbackPolicy as JRollbackPolicy
    from fps_tpu_torch.core.resilience import RollbackPolicy

    chunks = _poisoned(4, (1, 3), kind="nan")
    (jr, js), (tr, ts) = _recorders()
    jm, tm = jobs.HealthMonitor(escalate_after_rows=1), \
        tobs.HealthMonitor(escalate_after_rows=1)
    jp, tp = JRollbackPolicy(max_rollbacks=4), RollbackPolicy(max_rollbacks=4)
    jtr.fit_stream(jt, (), iter(chunks), jax.random.key(1), recorder=jr,
                   health=jm, rollback=jp)
    t, _, _ = ttr.fit_stream(tt, (), iter(chunks), 1, recorder=tr,
                             health=tm, rollback=tp)
    assert tp.quarantined == jp.quarantined == [1, 3]
    assert tm.escalated_at == jm.escalated_at == 1
    assert (tm.log, tm.poison_rows) == (jm.log, jm.poison_rows)
    assert ttr.config.guard.mode == "mask"
    assert _journal(ts) == _journal(js)
    esc = ts.events("guard_escalated")
    assert len(esc) == 1 and esc[0]["index"] == 1
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    assert tr.counter_value("health.nonfinite_rows", table="weights") > 0
    assert tr.counter_value("health.masked_rows", table="weights") > 0
    assert tr.counter_value("rollback.quarantined") == 2
    assert np.isfinite(t["weights"].numpy()).all()


def test_health_monitor_abort_raises_where_the_reference_does():
    (jtr, jt, _), (ttr, tt, _) = _pair("logreg", 1, 4, None, guard="mask")
    chunks = _poisoned(4, (0, 1, 2), n=3, kind="nan")
    (jr, js), (tr, ts) = _recorders()
    jm = jobs.HealthMonitor(abort_after_chunks=2)
    tm = tobs.HealthMonitor(abort_after_chunks=2)
    with pytest.raises(JPoisoned, match="health monitor abort"):
        jtr.fit_stream(jt, (), iter(chunks), jax.random.key(1),
                       recorder=jr, health=jm)
    with pytest.raises(PoisonedStreamError, match="health monitor abort"):
        ttr.fit_stream(tt, (), iter(chunks), 1, recorder=tr, health=tm)
    assert tm.aborted_at == jm.aborted_at == 1
    assert _journal(ts) == _journal(js)
    assert ts.events("health_abort")


def test_health_monitor_and_watchdog_checks():
    (_, _, _), (ttr, tt, _) = _pair("logreg", 1, 4, None, guard=None)
    with pytest.raises(ValueError, match="health channel"):
        ttr.fit_stream(tt, (), iter([]), 1, health=tobs.HealthMonitor())
    with pytest.raises(TypeError, match="HealthMonitor"):
        ttr.fit_stream(tt, (), iter([]), 1, health=object())
    wd = tobs.StepWatchdog(120.0)
    ttr.fit_stream(tt, (), iter(_chunks("logreg", 4, None, n=2)), 1,
                   watchdog=wd)
    assert wd.stalls == []


def test_prefetch_and_checkpoint_counters_match(tmp_path):
    """With the pipeline two chunks ahead and a checkpointer every two
    chunks: the prefetcher's and the checkpointer's counters and the
    journal's checkpoint trail equal the reference's, and the phase keys
    hold ``prefetch`` and ``checkpoint``."""
    import dataclasses

    from fps_tpu.core.checkpoint import Checkpointer as JCheckpointer
    from fps_tpu.obs import events as jevents
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.obs import events as tevents

    (jtr, jt, jl), (ttr, tt, tl) = _pair("mf", 2, 4, None)
    for tr in (jtr, ttr):
        tr.config = dataclasses.replace(tr.config, prefetch=2)
    chunks = _chunks("mf", 8, None, n=5)
    (jr, js), (tr, ts) = _recorders()
    with jevents.default_recorder(jr):
        jtr.fit_stream(jt, jl, iter(chunks), jax.random.key(1),
                       recorder=jr, checkpointer=JCheckpointer(
                           str(tmp_path / "j")), checkpoint_every=2)
    with tevents.default_recorder(tr):
        ttr.fit_stream(tt, tl, iter(chunks), 1, recorder=tr,
                       checkpointer=Checkpointer(str(tmp_path / "t")),
                       checkpoint_every=2)
    assert tr.snapshot()["counters"] == jr.snapshot()["counters"]
    assert tr.counter_value("prefetch.chunks") == 5
    assert tr.counter_value("checkpoint.saves") == 3
    assert [e["event"] for e in ts.events()] == [
        e["event"] for e in js.events()]
    assert [e.get("step") for e in ts.events("checkpoint_saved")] == [
        2, 4, 5]
    assert {"prefetch", "checkpoint", "ingest", "place", "dispatch",
            "host_sync"} <= set(tr.phase_totals())
    assert set(tr.phase_totals()) == set(jr.phase_totals())


def _params(fn, defaults=True):
    return [(n.replace("key", "seed"), p.kind,
             p.default if defaults else None)
            for n, p in inspect.signature(fn).parameters.items()]


@pytest.mark.parametrize("where", ["Trainer.__init__", "Trainer.run_indexed",
                                   "Retierer.on_boundary"])
def test_telemetry_signatures_equal_the_reference(where):
    """``Trainer(..., config, recorder, audit)``, ``run_indexed``'s
    ``recorder`` / ``health`` / ``watchdog`` and
    ``Retierer.on_boundary(recorder=)`` take the reference's parameters in
    its order (``key`` is ``seed``; ``Trainer``'s ``server_logic`` default
    is each package's own ``ServerLogic()``)."""
    from fps_tpu.core import driver as jdriver
    from fps_tpu.tiering import retier as jretier
    from fps_tpu_torch.core import driver as tdriver
    from fps_tpu_torch.tiering import retier as tretier

    cls, method = where.split(".")
    mods = {"Trainer": (tdriver, jdriver), "Retierer": (tretier, jretier)}
    t, j = (getattr(getattr(m, cls), method) for m in mods[cls])
    keep = where != "Trainer.__init__"
    assert _params(t, keep) == _params(j, keep)
