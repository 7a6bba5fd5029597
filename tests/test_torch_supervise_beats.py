"""The port's drivers beat the supervisor's heartbeat as the JAX package's
do, on the CPU.

With a ``HeartbeatSink`` on the run's recorder, ``fit_stream`` beats
before each chunk's wait on its source (``prefetch`` with the overlapped
pipeline, ``ingest`` without) and at each dispatch, ``run_indexed`` at
each epoch's dispatch and ``run_megastep`` at each megastep's; the sink
beats the index about to be attempted after each ``chunk`` / ``epoch``
event. The supervisor's quarantine keys on the last indexed beat, so the
whole ``(index, phase)`` sequence must be the reference driver's on the
same data: an extra or a missing beat changes which index it quarantines.
The beat is host-only: the kernel calls (their plain versions here,
counted) and the tables are the same with and without a beacon.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import device_ingest as jdi
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.obs import Recorder as JRecorder
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.supervise.child import HeartbeatSink as JHeartbeatSink

from fps_tpu_torch import LogRegConfig, logistic_regression, make_ps_mesh
from fps_tpu_torch.core import device_ingest as tdi
from fps_tpu_torch.obs import Recorder
from fps_tpu_torch.ops import kernels
from fps_tpu_torch.supervise.child import HeartbeatSink
from fps_tpu_torch.testing import workloads

NF = workloads.NF


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Beacon:
    """A heartbeat that records ``(index, phase)`` instead of writing."""

    def __init__(self):
        self.beats = []

    def beat(self, index=None, **fields):
        self.beats.append((index, fields.get("phase")))


def _data():
    train, _ = workloads.logreg_data(2000)
    return train


def _jax_run(kind, train):
    mesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    trainer, _ = jlogistic_regression(
        mesh, JLogRegConfig(num_features=NF, learning_rate=0.5))
    beacon = Beacon()
    rec = JRecorder(sinks=[JHeartbeatSink(beacon)])
    tables, ls = trainer.init_state(jax.random.key(0))
    key = jax.random.key(1)
    if kind.startswith("fit_stream"):
        trainer.config = dataclasses.replace(
            trainer.config, prefetch=int(kind[-1]))
        trainer.fit_stream(tables, ls,
                           iter(workloads.logreg_chunks(train, 1, epochs=2)),
                           key, recorder=rec)
        return beacon.beats
    plan = jdi.DeviceEpochPlan(jdi.DeviceDataset(mesh, train),
                               num_workers=1, local_batch=32, seed=3)
    if kind == "run_indexed":
        trainer.run_indexed(tables, ls, plan, key, epochs=2, recorder=rec)
    else:
        trainer.config = dataclasses.replace(trainer.config,
                                             max_steps_per_call=4)
        trainer.run_megastep(tables, ls, plan, key, epochs=2,
                             chunks_per_dispatch=2, recorder=rec)
    return beacon.beats


def _port_run(kind, train, *, beacon=True):
    """The port's run of ``kind`` with a heartbeat sink (or a recorder with
    no sink): ``(beats, tables, kernel calls)``."""
    mesh = make_ps_mesh(device="cpu")
    trainer, store = logistic_regression(
        mesh, LogRegConfig(num_features=NF, learning_rate=0.5))
    b = Beacon()
    rec = Recorder(sinks=[HeartbeatSink(b)] if beacon else [])
    tables, ls = trainer.init_state(0)
    if kind.startswith("fit_stream"):
        trainer.config = dataclasses.replace(
            trainer.config, prefetch=int(kind[-1]))
        tables, ls, _ = trainer.fit_stream(
            tables, ls, iter(workloads.logreg_chunks(train, 1, epochs=2)), 1,
            recorder=rec)
    else:
        plan = tdi.DeviceEpochPlan(tdi.DeviceDataset(mesh, train),
                                   num_workers=1, local_batch=32, seed=3)
        if kind == "run_indexed":
            tables, ls, _ = trainer.run_indexed(tables, ls, plan, 1,
                                                epochs=2, recorder=rec)
        else:
            trainer.config = dataclasses.replace(trainer.config,
                                                 max_steps_per_call=4)
            tables, ls, _ = trainer.run_megastep(
                tables, ls, plan, 1, epochs=2, chunks_per_dispatch=2,
                recorder=rec)
    return b.beats, workloads.weights(store)


_KINDS = ["fit_stream_p0", "fit_stream_p2", "run_indexed", "run_megastep"]


@pytest.mark.parametrize("kind", _KINDS)
def test_beats_match_the_reference_driver(kind):
    train = _data()
    want = _jax_run(kind, train)
    got, _ = _port_run(kind, train)
    assert got == want
    # The sequence really carries the drivers' sub-phases.
    phases = {p for _, p in got}
    assert "dispatch" in phases
    if kind.startswith("fit_stream"):
        assert ("prefetch" if kind.endswith("2") else "ingest") in phases


@pytest.mark.parametrize("kind", _KINDS)
def test_a_beacon_changes_no_kernel_call_and_no_table(kind, monkeypatch):
    """Every pull and push goes through the kernels' wrappers, which count
    their launches on the card; on the CPU their plain versions run, so
    those are counted here. A beacon must change neither the calls nor the
    tables' bits."""
    calls = {}
    names = ("gather_rows_plain", "gather_rows_dim1_plain",
             "scatter_add_plain", "scatter_add_dim1_plain",
             "scatter_add_packed_plain")
    for name in names:
        fn = getattr(kernels, name)

        def counted(*a, _fn=fn, _name=name, **kw):
            calls[_name] = calls.get(_name, 0) + 1
            return _fn(*a, **kw)

        monkeypatch.setattr(kernels, name, counted)
    train = _data()
    beats, on = _port_run(kind, train, beacon=True)
    with_beacon = dict(calls)
    calls.clear()
    none, off = _port_run(kind, train, beacon=False)
    assert beats and not none
    assert with_beacon == calls
    assert with_beacon["gather_rows_dim1_plain"] > 0
    assert with_beacon["scatter_add_dim1_plain"] > 0
    np.testing.assert_array_equal(on.view(np.uint32), off.view(np.uint32))
