"""``TrainerConfig.push_delay`` on the port against the JAX package's, on the
CPU (``tests/test_staleness.py`` is the oracle).

* Delivery: a pusher whose pushes do not depend on its pulls ends with the
  tables of ``push_delay = 0`` whatever the delay, sync and SSP: every push
  lands exactly once. On the port the same scatter-adds run in the same
  order, so the tables are equal bit for bit; against the JAX package (its
  ring buffer on a (data=1, shard=1) mesh) within the oracle's 1e-5.
* The models: MF and AdaGrad logistic regression at ``push_delay = 2``, sync
  and SSP, through ``fit_stream`` and ``run_indexed``, from the same tables
  as the JAX package, within the bounds of ``tests/test_torch_mf.py`` and
  ``tests/test_torch_logreg.py``. AdaGrad's fold runs ``apply_fn``, so it
  shows that the port's skipping of the ring's cold slots (ids ``-1``) is
  exact. ``step_tap`` sees the tables after each step's delivery, as the
  JAX package's does.
* The oracle's staleness sweep on the port: every configuration learns.
"""

import dataclasses
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fps_tpu.core import api as japi
from fps_tpu.core import device_ingest as jdi
from fps_tpu.core import driver as jdriver
from fps_tpu.core import ingest as jingest
from fps_tpu.core import store as jstore
from fps_tpu.models import matrix_factorization as jmf
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import make_ps_mesh
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax
from fps_tpu_torch.core import api as tapi
from fps_tpu_torch.core import driver as tdriver
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.core import store as tstore
from fps_tpu_torch.core.device_ingest import DeviceDataset, DeviceEpochPlan
from fps_tpu_torch.models import logistic_regression as tlr
from fps_tpu_torch.models import matrix_factorization as tmf
from fps_tpu_torch.utils import datasets as tdatasets

# fps_tpu.models exports a function of the module's name, which shadows it.
jlr = importlib.import_module("fps_tpu.models.logistic_regression")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jmesh():
    return jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])


class _JConstantPusher(japi.WorkerLogic):
    """Pushes delta = batch value to id = batch id: independent of the
    pulls, so any delivery schedule that delivers each push once ends with
    the same tables."""

    def pull_ids(self, batch):
        return {"t": batch["id"].astype(jnp.int32)}

    def step(self, batch, pulled, local_state, key):
        ids = jnp.where(batch["weight"] > 0, batch["id"].astype(jnp.int32),
                        -1)
        out = {"n": jnp.sum(batch["weight"]).astype(jnp.float32)}
        return japi.StepOutput(
            pushes={"t": (ids, batch["val"][:, None].astype(jnp.float32))},
            local_state=local_state, out=out)


class _TConstantPusher(tapi.WorkerLogic):
    def pull_ids(self, batch):
        return {"t": batch["id"].to(torch.int32)}

    def step(self, batch, pulled, local_state, gen):
        ids = torch.where(batch["weight"] > 0, batch["id"].to(torch.int32),
                          -1)
        out = {"n": torch.sum(batch["weight"]).to(torch.float32)}
        return tapi.StepOutput(
            pushes={"t": (ids, batch["val"][:, None].to(torch.float32))},
            local_state=local_state, out=out)


@pytest.mark.parametrize("sync_every", [None, 2])
@pytest.mark.parametrize("delay", [1, 3, 8])
def test_push_delay_delivers_exactly_once(sync_every, delay):
    rng = np.random.default_rng(0)
    n = 1000
    data = {"id": rng.integers(0, 37, n).astype(np.int32),
            "val": rng.normal(0, 1, n).astype(np.float32)}

    def chunks():
        return jingest.multi_epoch_chunks(
            data, 2, num_workers=1, local_batch=16, steps_per_chunk=4,
            sync_every=sync_every, seed=3)

    def port(d):
        store = tstore.ParamStore(make_ps_mesh(device="cpu"),
                                  [tstore.TableSpec("t", 37, 1).zeros_init()])
        trainer = tdriver.Trainer(
            store.mesh, store, _TConstantPusher(),
            config=tdriver.TrainerConfig(sync_every=sync_every, push_delay=d,
                                         donate=False))
        tables, ls = trainer.init_state(0)
        trainer.fit_stream(tables, ls, chunks(), 1)
        return store.dump_model("t")[1]

    def jax_run(d):
        mesh = _jmesh()
        store = jstore.ParamStore(mesh,
                                  [jstore.TableSpec("t", 37, 1).zeros_init()])
        trainer = jdriver.Trainer(
            mesh, store, _JConstantPusher(),
            config=jdriver.TrainerConfig(sync_every=sync_every,
                                         push_delay=d, donate=False))
        tables, ls = trainer.init_state(jax.random.key(0))
        trainer.fit_stream(tables, ls, chunks(), jax.random.key(1))
        return store.dump_model("t")[1]

    base = port(0)
    got = port(delay)
    assert np.abs(base).max() > 1.0
    # The same scatter-adds in the same order, only later: the same bits.
    np.testing.assert_array_equal(got, base)
    np.testing.assert_allclose(got, jax_run(delay), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# The models at push_delay = 2, against the JAX package.
# ---------------------------------------------------------------------------

NU, NI, RANK, NF = 57, 31, 4, 300
MF_KW = dict(num_users=NU, num_items=NI, rank=RANK, learning_rate=0.08,
             reg=0.005)
LR_KW = dict(num_features=NF, learning_rate=0.3, optimizer="adagrad")


def _model_pair(model, sync_every, push_delay, **kw):
    """JAX and port trainers of ``model`` from the same tables."""
    if model == "mf":
        jtr, _ = jmf.online_mf(_jmesh(), jmf.MFConfig(**MF_KW),
                               sync_every=sync_every, push_delay=push_delay,
                               **kw)
        ttr, ts = tmf.online_mf(make_ps_mesh(device="cpu"),
                                tmf.MFConfig(**MF_KW), sync_every=sync_every,
                                push_delay=push_delay, **kw)
    else:
        jtr, _ = jlr.logistic_regression(
            _jmesh(), jlr.LogRegConfig(**LR_KW), sync_every=sync_every,
            push_delay=push_delay, **kw)
        ttr, ts = tlr.logistic_regression(
            make_ps_mesh(device="cpu"), tlr.LogRegConfig(**LR_KW),
            sync_every=sync_every, push_delay=push_delay, **kw)
    jtb, jls = jtr.init_state(jax.random.key(0))
    ttb = tables_from_jax(ts, {k: np.asarray(v) for k, v in jtb.items()})
    tls = (local_state_from_jax(ttr.logic, np.asarray(jls), device="cpu")
           if model == "mf" else ())
    return (jtr, jtb, jls), (ttr, ttb, tls)


def _model_data(model):
    if model == "mf":
        return jdatasets.synthetic_ratings(NU, NI, 1003, rank=3, noise=0.05,
                                           seed=0), "user"
    data = jdatasets.synthetic_sparse_classification(1024, NF, 8, seed=7,
                                                     noise=0.05)
    return dict(data, label=(data["label"] > 0).astype(np.float32)), None


def _close_tables(ttb, jtb, model):
    # MF factors are O(0.1): the SGD steps part by float32 rounding, about
    # 1e-8 after these chunks (tests/test_torch_mf.py's 1e-6). Logistic
    # weights are O(0.1-1): 1e-5 (tests/test_torch_logreg.py).
    atol = 1e-6 if model == "mf" else 1e-5
    for k, v in jtb.items():
        np.testing.assert_allclose(ttb[k].numpy(), np.asarray(v), rtol=0,
                                   atol=atol)


@pytest.mark.parametrize("route", ["fit_stream", "run_indexed"])
@pytest.mark.parametrize("sync_every", [None, 4])
@pytest.mark.parametrize("model", ["mf", "adagrad"])
def test_push_delay_models_match_jax(model, sync_every, route):
    data, route_key = _model_data(model)
    outs = {}
    for d in (0, 2):
        (jtr, jtb, jls), (ttr, ttb, tls) = _model_pair(model, sync_every,
                                                       d)
        if route == "fit_stream":
            chunks = list(jingest.multi_epoch_chunks(
                data, 2, num_workers=1, local_batch=64, steps_per_chunk=8,
                route_key=route_key, sync_every=sync_every, seed=11))
            jtb, jls, jm = jtr.fit_stream(jtb, jls, iter(chunks),
                                          jax.random.key(1))
            ttb, tls, tm = ttr.fit_stream(ttb, tls, iter(chunks), 1)
        else:
            kw = dict(num_workers=1, local_batch=64, route_key=route_key,
                      seed=7, sync_every=sync_every)
            jplan = jdi.DeviceEpochPlan(jdi.DeviceDataset(_jmesh(), data),
                                        **kw)
            tplan = DeviceEpochPlan(
                DeviceDataset(make_ps_mesh(device="cpu"), data), **kw)
            # Calls of whole rounds that do not divide the epoch: its last
            # call is shorter on the port, padded with weight-0 steps in
            # JAX, and the pushes in flight are delivered at each call's
            # end.
            s = sync_every or 1
            cap = next(c for c in range(2 * s, tplan.steps_per_epoch, s)
                       if tplan.steps_per_epoch % c)
            for tr in (jtr, ttr):
                tr.config = dataclasses.replace(tr.config,
                                                max_steps_per_call=cap)
            jtb, jls, jm = jtr.run_indexed(jtb, jls, jplan,
                                           jax.random.key(1), epochs=2)
            ttb, tls, tm = ttr.run_indexed(ttb, tls, tplan, 1, epochs=2)
        assert len(tm) == len(jm)
        loss = "se" if model == "mf" else "logloss"
        for g, w in zip(tm, jm):
            np.testing.assert_array_equal(g["n"], np.asarray(w["n"]))
            np.testing.assert_allclose(g[loss], np.asarray(w[loss]),
                                       rtol=1e-5, atol=1e-7)
        _close_tables(ttb, jtb, model)
        if model == "mf":
            np.testing.assert_allclose(tls.numpy(), np.asarray(jls), rtol=0,
                                       atol=1e-6)
        outs[d] = {k: v.numpy() for k, v in ttb.items()}
    # The delay acts: the tables differ from those without it.
    for k in outs[0]:
        assert float(np.abs(outs[2][k] - outs[0][k]).max()) > 1e-4


def _jtap(tables, batch, local_state, t):
    return {"t": jnp.asarray(t, jnp.int32),
            "item_sum": jnp.sum(tables[jmf.ITEM_TABLE])}


def _ttap(tables, batch, local_state, t):
    return {"t": torch.tensor(t, dtype=torch.int32),
            "item_sum": torch.sum(tables[tmf.ITEM_TABLE])}


@pytest.mark.parametrize("sync_every", [None, 4])
def test_step_tap_sees_the_delivered_tables_as_jax(sync_every):
    """With ``push_delay = 2`` the tap reads the tables after each step's
    delivery (the push of two steps before; none on steps 0 and 1)."""
    (jtr, jtb, jls), (ttr, ttb, tls) = _model_pair("mf", sync_every, 2)
    jtr.config = dataclasses.replace(jtr.config, step_tap=_jtap)
    ttr.config = dataclasses.replace(ttr.config, step_tap=_ttap)
    first = float(ttb[tmf.ITEM_TABLE][0].sum())  # the one position's
    data, _ = _model_data("mf")
    chunks = list(jingest.epoch_chunks(
        data, num_workers=1, local_batch=32, steps_per_chunk=8,
        route_key="user", sync_every=sync_every, seed=5))[:3]
    _, _, jms = jtr.fit_stream(jtb, jls, iter(chunks), jax.random.key(2))
    _, _, tms = ttr.fit_stream(ttb, tls, iter(chunks), 2)
    for jm, tm in zip(jms, tms):
        got = tm["tap"]
        assert got["item_sum"].shape == (8, 1)
        np.testing.assert_array_equal(got["t"][:, 0], np.arange(8))
        np.testing.assert_allclose(got["item_sum"],
                                   np.asarray(jm["tap"]["item_sum"]),
                                   rtol=0, atol=1e-5)
    # Nothing is delivered on a chunk's first two steps.
    sums = tms[0]["tap"]["item_sum"][:, 0]
    assert sums[0] == sums[1] == np.float32(first)
    assert sums[2] != sums[1]


def test_staleness_sweep_degrades_gracefully():
    """The oracle's sweep (``tests/test_staleness.py``) on the port: MF by
    (sync_every, push_delay) at the async-SGD recipe's learning rates;
    every configuration learns, and read-stale plus write-delayed at the
    scaled rate comes near the synchronous quality."""
    NU_, NI_, NR_ = 96, 64, 6000
    data = tdatasets.synthetic_ratings(NU_, NI_, NR_, rank=3, noise=0.05,
                                       seed=3)
    train, test = tdatasets.train_test_split(data)

    def run(sync_every, delay, lr, epochs):
        cfg = tmf.MFConfig(num_users=NU_, num_items=NI_, rank=4,
                           learning_rate=lr, reg=0.005)
        trainer, store = tmf.online_mf(make_ps_mesh(device="cpu"), cfg,
                                       sync_every=sync_every,
                                       push_delay=delay)
        tables, ls = trainer.init_state(0)
        chunks = tingest.multi_epoch_chunks(
            train, epochs, num_workers=1, local_batch=32,
            steps_per_chunk=max(8, sync_every or 0), route_key="user",
            sync_every=sync_every, seed=11)
        tables, ls, _ = trainer.fit_stream(tables, ls, chunks, 1)
        pred = tmf.predict_host(store, ls, 1, test["user"], test["item"])
        return tmf.rmse(pred, test["rating"])

    results = {
        ("sync", 0): run(None, 0, lr=0.08, epochs=3),
        ("s=4", 0): run(4, 0, lr=0.08, epochs=3),
        ("s=4", 4): run(4, 4, lr=0.04, epochs=6),
        ("s=16", 16): run(16, 16, lr=0.02, epochs=6),
    }
    for k, v in results.items():
        assert v < 0.42, (k, v, results)
    assert results[("s=4", 4)] < results[("sync", 0)] * 1.35 + 0.05, results
