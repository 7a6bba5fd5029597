"""The port's overlapped host pipeline and the driver's reference signatures,
on the CPU.

* ``ChunkPrefetcher``: the JAX package's scenarios (``tests/test_prefetch.py``)
  run against both ``fps_tpu.core.prefetch`` and
  ``fps_tpu_torch.core.prefetch``, each one test parametrised by module:
  order, ``place_fn`` on the worker thread, the error at its position,
  ``close`` mid-stream, bad depths, the queue bound, adaptive raises on
  stalls, the memory veto, fixed depth.
* ``fit_stream`` with ``prefetch`` on and off gives the same tables and
  metrics bit for bit (MF, binary PA with the head prefix, logistic
  regression; sync and SSP), and the port at ``prefetch = 2`` agrees with
  the JAX package at ``prefetch = 2`` within the MF parity bounds of
  ``tests/test_torch_mf.py``. Every exit path joins the worker.
* ``metrics_drain_every``, ``start_step`` and ``health_lag``; the reference's
  ``TrainerConfig`` fields and ``fit_stream`` / ``run_chunk`` parameters, in
  its order; every knob still unported raises naming its ROADMAP.md item.
* The examples' ``--prefetch`` and the MF example's ``--negative-samples``.

Every wait on a thread is bounded (``join(timeout=...)``), so a bug fails a
test instead of hanging the run.
"""

import contextlib
import dataclasses
import importlib
import inspect
import io
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import driver as jdriver
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import (
    LogRegConfig,
    MFConfig,
    PAConfig,
    TrainerConfig,
    logistic_regression,
    make_ps_mesh,
    online_mf,
    passive_aggressive,
)
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.core import driver as tdriver
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.core.prefetch import PlacedChunk
from fps_tpu_torch.models.matrix_factorization import ITEM_TABLE

MODULES = ["fps_tpu.core.prefetch", "fps_tpu_torch.core.prefetch"]
JOIN_S = 20.0  # bound on every wait for a thread


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class _Rec:
    """Duck-typed recorder and timer: the gauges, counters and phase
    seconds the prefetcher reports (``.set``, ``.inc``, ``.add``)."""

    def __init__(self):
        self.lock = threading.Lock()
        self.gauges, self.counters, self.phases = {}, {}, {}

    def set(self, name, value):
        with self.lock:
            self.gauges[name] = value

    def inc(self, name, n=1):
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    def add(self, name, seconds):
        with self.lock:
            self.phases[name] = self.phases.get(name, 0.0) + seconds


def _no_prefetch_threads():
    return not any(t.name.startswith("fps-prefetch")
                   for t in threading.enumerate())


def _drain(pf, limit=None):
    """``list(pf)`` (or its first ``limit`` items) on a helper thread,
    joined with a timeout; an exception from the pipeline comes back as
    the second value."""
    out, err = [], []

    def run():
        try:
            for item in pf:
                out.append(item)
                if limit is not None and len(out) == limit:
                    return
        except BaseException as e:  # noqa: BLE001 - handed to the test
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "the pipeline hung"
    return out, (err[0] if err else None)


def _mod(name):
    return importlib.import_module(name)


# ---------------------------------------------------------------------------
# ChunkPrefetcher: the reference's scenarios, on both modules.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_preserves_order_and_completes(module):
    pf = _mod(module).ChunkPrefetcher(
        iter([{"x": np.full(4, i)} for i in range(17)]), depth=3)
    got, err = _drain(pf)
    pf.close()
    assert err is None and len(got) == 17
    assert [int(c["x"][0]) for c in got] == list(range(17))
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_place_fn_wraps_and_runs_on_worker(module):
    mod = _mod(module)
    names = []

    def place(chunk):
        names.append(threading.current_thread().name)
        return {k: v + 1 for k, v in chunk.items()}

    with mod.ChunkPrefetcher(iter([{"x": np.arange(3)}] * 4), place,
                             depth=2) as pf:
        got, err = _drain(pf)
    assert err is None and len(got) == 4
    assert all(isinstance(c, mod.PlacedChunk) for c in got)
    np.testing.assert_array_equal(got[0].batches["x"], np.arange(3) + 1)
    assert set(names) == {"fps-prefetch"}
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
@pytest.mark.parametrize("start", [0, 5])
def test_prefetcher_skip_place_is_keyed_by_stream_index(module, start):
    """Chunks whose stream index (``start_index`` plus the position) is in
    ``skip_place`` come out as the source yielded them, unplaced; the
    others come out placed, all in order."""
    mod = _mod(module)
    placed = []

    def place(chunk):
        placed.append(int(chunk["x"][0]))
        return {k: v + 100 for k, v in chunk.items()}

    skip = {start + 1, start + 4}
    with mod.ChunkPrefetcher(iter([{"x": np.full(2, i)} for i in range(6)]),
                             place, depth=2, start_index=start,
                             skip_place=skip) as pf:
        got, err = _drain(pf)
    assert err is None and len(got) == 6
    assert placed == [0, 2, 3, 5]
    for i, c in enumerate(got):
        if start + i in skip:
            assert not isinstance(c, mod.PlacedChunk)
            np.testing.assert_array_equal(c["x"], np.full(2, i))
        else:
            assert isinstance(c, mod.PlacedChunk)
            np.testing.assert_array_equal(c.batches["x"], np.full(2, i + 100))
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_error_propagates_at_position(module):
    boom = ValueError("poisoned source")

    def source():
        yield {"x": 0}
        yield {"x": 1}
        raise boom

    pf = _mod(module).ChunkPrefetcher(source(), depth=2)
    got, err = _drain(pf)
    pf.close()
    assert [c["x"] for c in got] == [0, 1]
    assert err is boom  # the original object, after every earlier chunk
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_close_midstream_joins_thread(module):
    def endless():
        i = 0
        while True:
            yield {"x": i}
            i += 1

    pf = _mod(module).ChunkPrefetcher(endless(), depth=2)
    got, err = _drain(pf, limit=1)
    assert err is None and got[0]["x"] == 0
    pf.close()
    assert _no_prefetch_threads()
    pf.close()  # idempotent


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_rejects_bad_depths(module):
    mod = _mod(module)
    with pytest.raises(ValueError, match="depth"):
        mod.ChunkPrefetcher(iter([]), depth=0)
    with pytest.raises(ValueError, match="max_depth"):
        mod.ChunkPrefetcher(iter([]), depth=3, max_depth=2)
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_depth_bounds_queue(module):
    """A consumer that never reads: the worker stalls at ``depth``."""
    rec = _Rec()
    pf = _mod(module).ChunkPrefetcher(iter([{"x": i} for i in range(100)]),
                                      depth=2, recorder=rec, timer=rec)
    deadline = time.time() + JOIN_S
    while (rec.gauges.get("prefetch.queue_depth", 0) < 2
           and time.time() < deadline):
        time.sleep(0.01)
    pf.close()
    assert rec.gauges["prefetch.queue_depth"] == 2
    # depth chunks buffered, at most one in flight when close() hit.
    assert 2 <= rec.counters["prefetch.chunks"] <= 3
    assert rec.phases["prefetch"] >= 0.0
    assert _no_prefetch_threads()


def _slow_source(n, make):
    for i in range(n):
        time.sleep(0.002)
        yield make(i)


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_adaptive_depth_raises_on_stalls(module):
    rec = _Rec()
    pf = _mod(module).ChunkPrefetcher(
        _slow_source(40, lambda i: {"x": np.full(4, i)}), depth=2,
        max_depth=4, mem_probe=lambda: 1 << 40, recorder=rec)
    got, err = _drain(pf)
    pf.close()
    assert err is None and len(got) == 40
    assert pf.depth == 4
    assert rec.counters["prefetch.depth_adjustments"] == 2
    assert _no_prefetch_threads()


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_adaptive_depth_memory_veto(module):
    rec = _Rec()
    pf = _mod(module).ChunkPrefetcher(
        _slow_source(24, lambda i: {"x": np.zeros(1024, np.float32)}),
        depth=2, max_depth=8, mem_probe=lambda: 1024, recorder=rec)
    got, err = _drain(pf)
    pf.close()
    assert err is None and len(got) == 24
    assert pf.depth == 2
    assert rec.counters.get("prefetch.depth_adjustments", 0) == 0


@pytest.mark.parametrize("module", MODULES)
def test_prefetcher_fixed_depth_without_max(module):
    rec = _Rec()
    pf = _mod(module).ChunkPrefetcher(
        _slow_source(24, lambda i: {"x": np.full(4, i)}), depth=2,
        recorder=rec)
    got, err = _drain(pf)
    pf.close()
    assert err is None and len(got) == 24
    assert pf.depth == 2
    assert rec.counters.get("prefetch.depth_adjustments", 0) == 0


def test_port_placement_is_the_plain_copy_off_the_card():
    """On the CPU, placement is ``torch.as_tensor(v).to("cpu")``: the same
    bits, no CUDA event, and ``run_chunk`` takes the placed chunk as is."""
    trainer, _ = online_mf(make_ps_mesh(device="cpu"),
                           MFConfig(num_users=20, num_items=10, rank=2))
    chunk = {"user": np.arange(6, dtype=np.int32).reshape(2, 3),
             "rating": np.linspace(0, 1, 6, dtype=np.float32).reshape(2, 3)}
    placed = trainer._place_chunk(chunk)
    assert isinstance(placed, PlacedChunk) and placed.ready is None
    for k, v in chunk.items():
        assert placed.batches[k].device.type == "cpu"
        np.testing.assert_array_equal(placed.batches[k].numpy(), v)


# ---------------------------------------------------------------------------
# fit_stream: prefetch on and off.
# ---------------------------------------------------------------------------

NU, NI, NR, RANK = 60, 40, 1500, 4
MF_KW = dict(num_users=NU, num_items=NI, rank=RANK, learning_rate=0.08,
             reg=0.005)


def _mf_chunks(sync_every, epochs=2, local_batch=32, **kw):
    data = jdatasets.synthetic_ratings(NU, NI, NR, rank=3, noise=0.05, seed=3)
    return list(tingest.multi_epoch_chunks(
        data, epochs, num_workers=1, local_batch=local_batch,
        steps_per_chunk=8, route_key="user", sync_every=sync_every, seed=11,
        **kw))


def _run(build, chunks, seed=1, **cfg):
    trainer, store = build()
    trainer.config = dataclasses.replace(trainer.config, **cfg)
    tables, local = trainer.init_state(0)
    tables, local, metrics = trainer.fit_stream(tables, local, iter(chunks),
                                                seed)
    assert _no_prefetch_threads()
    return tables, local, metrics


def _assert_bit_equal(a, b):
    (ta, la, ma), (tb, lb, mb) = a, b
    assert ta.keys() == tb.keys()
    for k in ta:
        np.testing.assert_array_equal(ta[k].numpy(), tb[k].numpy(), k)
    if la != ():
        np.testing.assert_array_equal(la.numpy(), lb.numpy())
    assert len(ma) == len(mb)
    for x, y in zip(ma, mb):
        assert x.keys() == y.keys()
        for k in x:
            np.testing.assert_array_equal(x[k], y[k])


def _pa_job():
    data = jdatasets.synthetic_sparse_classification(1024, 300, 8, seed=9,
                                                     noise=0.05)
    data, q = jdatasets.head_sort_slots(data, 32)
    cfg = PAConfig(num_features=300, variant="PA-I", C=1.0, hot_features=32,
                   head_prefix_cols=q)
    return data, cfg


def _lr_data(sync_every):
    data = jdatasets.synthetic_sparse_classification(
        1024, 400, 8, seed=7, noise=0.05, dense_features=3)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    return list(tingest.multi_epoch_chunks(
        data, 2, num_workers=1, local_batch=64, steps_per_chunk=4,
        sync_every=sync_every, seed=3))


@pytest.mark.parametrize("job", ["mf", "mf_negatives", "pa_head_prefix",
                                 "logreg", "logreg_adagrad"])
@pytest.mark.parametrize("sync_every", [None, 4])
def test_fit_stream_prefetch_bit_identical(job, sync_every):
    mesh = make_ps_mesh(device="cpu")
    if job.startswith("mf"):
        extra = (dict(negative_samples=2, negative_weight=0.3)
                 if job == "mf_negatives" else {})
        chunks = _mf_chunks(sync_every)

        def build():
            return online_mf(mesh, MFConfig(**MF_KW, **extra),
                             sync_every=sync_every)
    elif job == "pa_head_prefix":
        data, cfg = _pa_job()
        chunks = list(tingest.multi_epoch_chunks(
            data, 2, num_workers=1, local_batch=128, steps_per_chunk=4,
            sync_every=sync_every, seed=3))

        def build():
            return passive_aggressive(mesh, cfg, sync_every=sync_every)
    else:
        opt = "adagrad" if job == "logreg_adagrad" else "sgd"
        chunks = _lr_data(sync_every)

        def build():
            return logistic_regression(
                mesh, LogRegConfig(num_features=400, learning_rate=0.1,
                                   dense_features=3, optimizer=opt),
                sync_every=sync_every)
    off = _run(build, chunks)
    for depth, depth_max in ((2, 0), (1, 6)):
        _assert_bit_equal(off, _run(build, chunks, prefetch=depth,
                                    prefetch_max=depth_max))


@pytest.mark.parametrize("sync_every", [None, 4])
def test_fit_stream_prefetch_matches_jax_prefetch(sync_every):
    """Port and JAX package both at ``prefetch = 2``, from the same tables
    over the same chunks: the bounds of ``tests/test_torch_mf.py``."""
    chunks = _mf_chunks(sync_every, epochs=1)[:4]
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    jtr, _ = jonline_mf(jmesh, JMFConfig(**MF_KW), sync_every=sync_every)
    jtr.config = dataclasses.replace(jtr.config, prefetch=2)
    ttr, tstore = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW),
                            sync_every=sync_every)
    ttr.config = dataclasses.replace(ttr.config, prefetch=2)
    jtb, jls = jtr.init_state(jax.random.key(0))
    ttb = tables_from_jax(tstore, {k: np.asarray(v) for k, v in jtb.items()})
    tls = local_state_from_jax(ttr.logic, np.asarray(jls), device="cpu")
    jtb, jls, jm = jtr.fit_stream(jtb, jls, iter(chunks), jax.random.key(1))
    ttb, tls, tm = ttr.fit_stream(ttb, tls, iter(chunks), 1)
    assert _no_prefetch_threads()
    assert len(tm) == len(jm) == 4
    for g, w in zip(tm, jm):
        np.testing.assert_array_equal(g["n"], np.asarray(w["n"]))
        np.testing.assert_allclose(g["se"], np.asarray(w["se"]), rtol=1e-5)
    np.testing.assert_allclose(ttb[ITEM_TABLE].numpy(),
                               np.asarray(jtb[ITEM_TABLE]), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=0,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# fit_stream: exit paths join the worker.
# ---------------------------------------------------------------------------

def _fit_on_thread(fn):
    """Run ``fn`` on a helper thread, joined with a timeout; return the
    exception it raised."""
    err = []

    def run():
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 - handed to the test
            err.append(e)

    t = threading.Thread(target=run, daemon=True)
    t.start()
    t.join(JOIN_S)
    assert not t.is_alive(), "fit_stream hung"
    return err[0] if err else None


@pytest.mark.parametrize("prefetch", [0, 2])
def test_raising_source_and_on_chunk_reraise_and_join(prefetch):
    chunks = _mf_chunks(None, epochs=1)
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    trainer.config = dataclasses.replace(trainer.config, prefetch=prefetch)
    tables, local = trainer.init_state(0)
    torn = OSError("stream tore")

    def source():
        yield chunks[0]
        yield chunks[1]
        raise torn

    seen = []
    err = _fit_on_thread(lambda: trainer.fit_stream(
        tables, local, source(), 1, on_chunk=lambda i, m: seen.append(i)))
    assert err is torn and seen == [0, 1]
    assert _no_prefetch_threads()

    def boom(i, metrics):
        if i == 1:
            raise RuntimeError("early stop")

    err = _fit_on_thread(lambda: trainer.fit_stream(
        tables, local, iter(chunks), 1, on_chunk=boom))
    assert isinstance(err, RuntimeError) and "early stop" in str(err)
    assert _no_prefetch_threads()


# ---------------------------------------------------------------------------
# The two ported knobs: metrics_drain_every and start_step.
# ---------------------------------------------------------------------------

def test_metrics_drain_every_knob(monkeypatch):
    """Every cadence trains the same bits and ends with host metrics; the
    drain moves metrics to the host every ``metrics_drain_every`` chunks
    (after the reference's ``tests/test_prefetch.py:416``)."""
    chunks = _mf_chunks(None, epochs=2)
    assert len(chunks) >= 9
    mesh = make_ps_mesh(device="cpu")
    calls = []
    to_host = tdriver._to_host

    def counting(m):
        calls.append(isinstance(m["n"], torch.Tensor))
        return to_host(m)

    monkeypatch.setattr(tdriver, "_to_host", counting)
    results = {}
    for de in (8, 2, 0):
        calls.clear()
        out = _run(lambda: online_mf(mesh, MFConfig(**MF_KW)), chunks,
                   metrics_drain_every=de)
        assert all(isinstance(v, np.ndarray) for m in out[2]
                   for v in m.values())
        # Device metrics converted mid-stream: the drains' chunks.
        drained = (len(chunks) // de) * de if de else 0
        assert sum(calls[:drained]) == drained
        assert sum(calls) == len(chunks)
        results[de] = out
    _assert_bit_equal(results[8], results[2])
    _assert_bit_equal(results[8], results[0])
    with pytest.raises(ValueError, match="metrics_drain_every"):
        _run(lambda: online_mf(mesh, MFConfig(**MF_KW)), chunks,
             metrics_drain_every=-1)


@pytest.mark.parametrize("prefetch", [0, 2])
def test_start_step_resumes_the_seed_stream(prefetch):
    """Chunk ``j`` draws from ``fold_seed(seed, j)``: chunks 0-3 in one
    stream equal chunks 0-1 and then chunks 2-3 with ``start_step = 2``,
    for MF with negatives (which draw), and ``on_chunk`` sees ``j``."""
    chunks = _mf_chunks(None, epochs=1)[:4]
    mesh = make_ps_mesh(device="cpu")
    cfg = MFConfig(**MF_KW, negative_samples=2, negative_weight=0.3)

    def trainer():
        tr, _ = online_mf(mesh, cfg)
        tr.config = dataclasses.replace(tr.config, prefetch=prefetch)
        return tr

    tr = trainer()
    tables, local = tr.init_state(0)
    seen = []
    want = tr.fit_stream(tables, local, iter(chunks), 5,
                         on_chunk=lambda j, m: seen.append(j))
    assert seen == [0, 1, 2, 3]
    tr = trainer()
    tables, local = tr.init_state(0)
    tables, local, m01 = tr.fit_stream(tables, local, iter(chunks[:2]), 5)
    seen.clear()
    tables, local, m23 = tr.fit_stream(tables, local, iter(chunks[2:]), 5,
                                       start_step=2,
                                       on_chunk=lambda j, m: seen.append(j))
    assert seen == [2, 3]
    _assert_bit_equal(want, (tables, local, m01 + m23))
    # The seeds follow the index: chunks 0-1 run as chunks 2-3 draw
    # other negatives than as chunks 0-1.
    tr = trainer()
    tables, local = tr.init_state(0)
    tables, _, _ = tr.fit_stream(tables, local, iter(chunks[:2]), 5,
                                 start_step=2)
    tr = trainer()
    first, local = tr.init_state(0)
    first, _, _ = tr.fit_stream(first, local, iter(chunks[:2]), 5)
    assert not np.array_equal(tables[ITEM_TABLE].numpy(),
                              first[ITEM_TABLE].numpy())


# ---------------------------------------------------------------------------
# The reference's signatures; the knobs still unported.
# ---------------------------------------------------------------------------

def test_trainer_config_has_the_reference_fields_in_order():
    want = [(f.name, f.default) for f in dataclasses.fields(
        jdriver.TrainerConfig)]
    got = [(f.name, f.default) for f in dataclasses.fields(TrainerConfig)]
    assert got == want


@pytest.mark.parametrize("method", ["fit_stream", "run_chunk"])
def test_driver_methods_have_the_reference_parameters_in_order(method):
    def params(cls):
        return [(n.replace("key", "seed"), p.kind, p.default)
                for n, p in inspect.signature(
                    getattr(cls, method)).parameters.items()]

    assert params(tdriver.Trainer) == params(jdriver.Trainer)


@pytest.mark.parametrize("guard", ["observe"], ids=["guard"])
def test_guard_config_values_are_taken(guard):
    """``TrainerConfig.guard`` is taken (it was refused before the guard
    was ported): a trainer resolves the mode to a ``GuardConfig`` and its
    run counts the guard's rows under ``"health"``."""
    from fps_tpu_torch.core.resilience import GuardConfig, as_guard

    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW),
                           guard=guard)
    assert as_guard(trainer.config.guard) == GuardConfig(mode=guard)
    tables, local = trainer.init_state(0)
    _, _, m = trainer.fit_stream(tables, local,
                                 _mf_chunks(None, epochs=1)[:1], 1)
    assert set(m[0]["health"]["item_factors"]) == {"nonfinite", "norm",
                                                   "masked"}
    assert int(np.sum(m[0]["health"]["item_factors"]["nonfinite"])) == 0


def test_auto_tier_attaches_a_retierer_as_a_stream_begins():
    """``TrainerConfig(auto_tier=True)`` is taken: ``fit_stream`` attaches
    the default retierer as it begins, which tracks the pulled ids during
    its warm-up (a one-position mesh has no tier to plan for)."""
    from fps_tpu_torch.tiering import Retierer

    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    trainer.config = dataclasses.replace(trainer.config, auto_tier=True)
    tables, local = trainer.init_state(0)
    tables, local, _ = trainer.fit_stream(tables, local,
                                          _mf_chunks(None, epochs=1)[:2], 1)
    assert isinstance(trainer.retierer, Retierer)
    assert trainer.retierer.auto_plan and not trainer.retierer.planned
    assert "item_factors::sketch" in tables
    assert tables["item_factors::sketch"].numpy().sum() > 0


@pytest.mark.parametrize("hook", ["checkpointer", "checkpoint_every",
                                  "rollback"])
def test_fit_stream_takes_durability_arguments(hook, tmp_path):
    """``fit_stream``'s checkpoint and rollback arguments are taken (they
    were refused before durability was ported): a checkpointer saves
    every ``checkpoint_every`` chunks and at the end, ``checkpoint_every``
    alone saves nothing, and a preset-only rollback skips its chunk."""
    from fps_tpu_torch.core.checkpoint import Checkpointer
    from fps_tpu_torch.core.resilience import RollbackPolicy

    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    tables, local = trainer.init_state(0)
    chunks = _mf_chunks(None, epochs=1)[:3]
    ck = Checkpointer(str(tmp_path))
    kw = {"checkpointer": dict(checkpointer=ck, checkpoint_every=2),
          "checkpoint_every": dict(checkpoint_every=2),
          "rollback": dict(rollback=RollbackPolicy(preset={1}))}[hook]
    _, _, m = trainer.fit_stream(tables, local, chunks, 1, **kw)
    if hook == "checkpointer":
        assert ck.steps() == [2, 3] and len(m) == 3
    elif hook == "checkpoint_every":
        assert ck.steps() == [] and len(m) == 3
    else:
        assert kw["rollback"].skipped == [1] and len(m) == 2


@pytest.mark.parametrize("call,hook", [
    ("fit_stream", "recorder"),
    ("fit_stream", "health"),
    ("fit_stream", "watchdog"),
    ("run_chunk", "timer"),
    ("run_chunk", "recorder"),
])
def test_telemetry_arguments_are_taken(call, hook):
    """The reference's telemetry arguments (refused until telemetry was
    ported) are taken, each does its part on a guarded MF chunk, and the
    tables and metrics are those of the same call without it, bit for
    bit."""
    from fps_tpu_torch import obs

    def run(**kw):
        trainer, _ = online_mf(make_ps_mesh(device="cpu"),
                               MFConfig(**MF_KW), guard="observe")
        tables, local = trainer.init_state(0)
        chunk = _mf_chunks(None, epochs=1)[0]
        if call == "fit_stream":
            t, l, ms = trainer.fit_stream(tables, local, [chunk], 1, **kw)
        else:
            t, l, m = trainer.run_chunk(tables, local, chunk, 1, **kw)
            ms = [{k: v if isinstance(v, dict) else v.numpy()
                   for k, v in m.items()}]
        # The guard's "health" counters nest; the flat leaves are compared.
        return t, l, [{k: v for k, v in m.items() if not isinstance(v, dict)}
                      for m in ms]

    sink = obs.MemorySink()
    arg = {"recorder": obs.Recorder(sinks=[sink]),
           "health": obs.HealthMonitor(escalate_after_rows=1),
           "watchdog": obs.StepWatchdog(120.0),
           "timer": obs.PhaseTimer()}[hook]
    got = run(**{hook: arg})
    _assert_bit_equal(got, run())
    if call == "fit_stream" and hook == "recorder":
        assert arg.counter_value("driver.chunks") == 1
        assert [e["index"] for e in sink.events("chunk")] == [0]
    elif hook == "health":
        assert arg.log == [] and arg.escalated_at is None
    elif hook == "watchdog":
        assert arg.stalls == []
    elif hook == "timer":
        assert {"place", "dispatch"} <= set(arg.chunk_summary())
    else:  # run_chunk's recorder: cold-lane counters only, none here
        assert arg.snapshot()["counters"] == {}


def test_prefetch_and_health_lag_values():
    """``health_lag`` 0 and 1 run the same loop where nothing reads every
    chunk's metrics (no rollback, health monitor or watchdog); 2 raises,
    as a negative ``prefetch`` does, where the reference raises them (in
    ``fit_stream``)."""
    chunks = _mf_chunks(None, epochs=1)[:3]
    mesh = make_ps_mesh(device="cpu")

    def build():
        return online_mf(mesh, MFConfig(**MF_KW))

    _assert_bit_equal(_run(build, chunks), _run(build, chunks, health_lag=1))
    for cfg, match in ((dict(health_lag=2), "health_lag"),
                       (dict(prefetch=-1), "prefetch")):
        with pytest.raises(ValueError, match=match):
            _run(build, chunks, **cfg)
    with pytest.raises(ValueError, match="push_delay"):
        TrainerConfig(push_delay=-1)


# ---------------------------------------------------------------------------
# The examples.
# ---------------------------------------------------------------------------

def _cli(module, argv):
    mod = importlib.import_module(f"fps_tpu_torch.examples.{module}")
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert mod.main(argv) == 0
    assert _no_prefetch_threads()
    return [json.loads(line) for line in buf.getvalue().splitlines()]


def _done(events):
    done = dict(events[-1])
    assert done.pop("event") == "done"
    done.pop("seconds")
    return done


@pytest.mark.parametrize("ingest", ["host", "device"])
def test_mf_example_prefetch_gives_the_same_done_event(ingest):
    argv = ["--device", "cpu", "--scale", "100k", "--epochs", "1",
            "--local-batch", "2048", "--steps-per-chunk", "4",
            "--ingest", ingest]
    want = _done(_cli("mf", argv))
    got = _done(_cli("mf", argv + ["--prefetch", "2"]))
    assert got == want


def test_ials_example_prefetch_gives_the_same_done_event():
    argv = ["--device", "cpu", "--num-users", "300", "--num-items", "200",
            "--per-user", "20", "--rank", "8", "--local-batch", "512",
            "--steps-per-chunk", "4", "--epochs", "2", "--ingest", "host"]
    want = _done(_cli("ials", argv))
    got = _done(_cli("ials", argv + ["--prefetch", "2"]))
    assert got == want


def test_mf_example_negative_samples():
    events = _cli("mf", ["--device", "cpu", "--scale", "100k", "--epochs",
                         "1", "--local-batch", "2048", "--steps-per-chunk",
                         "4", "--negative-samples", "2",
                         "--negative-weight", "0.3"])
    done = events[-1]
    assert done["event"] == "done" and np.isfinite(done["test_rmse"])
    plain = _cli("mf", ["--device", "cpu", "--scale", "100k", "--epochs",
                        "1", "--local-batch", "2048", "--steps-per-chunk",
                        "4"])[-1]
    # Negatives pull predictions toward 0: another model than without them.
    assert done["test_rmse"] != plain["test_rmse"]
