"""The PyTorch port's logistic-regression slice against the JAX package's, on
the CPU.

The same synthetic examples and the same chunks go through JAX
``logistic_regression`` on a (data=1, shard=1) mesh and through the port on
``device="cpu"``, from the same tables (carried across with
``fps_tpu_torch.convert``): SGD in sync and SSP mode, AdaGrad with its state
in table column 1, and the fixed-slot dense head. Per-step ``logloss`` /
``mistakes`` / ``n`` and the table are compared after every chunk
(tests/test_logreg.py is the oracle). Also here: the port's own convergence
and staleness checks, the dense head against the plain scatter path, and
the example CLI.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

from fps_tpu.core import ingest as jingest
from fps_tpu.models.logistic_regression import LogRegConfig as JLogRegConfig
from fps_tpu.models.logistic_regression import (
    LogisticRegressionWorker as JWorker,
)
from fps_tpu.models.logistic_regression import (
    logistic_regression as jlogistic_regression,
)
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import LogRegConfig, logistic_regression, make_ps_mesh
from fps_tpu_torch.convert import tables_from_jax, to_numpy
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.models.logistic_regression import (
    WEIGHT_TABLE,
    predict_proba_host,
)
from fps_tpu_torch.utils import datasets as tdatasets

NF, NNZ = 400, 8


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _data(n=6000, nf=NF, nnz=NNZ, seed=7, dense=0):
    data = jdatasets.synthetic_sparse_classification(
        n, nf, nnz, seed=seed, noise=0.05, dense_features=dense)
    return dict(data, label=(data["label"] > 0).astype(np.float32))


def _parity(data, kw, *, sync_every, chunks_n, local_batch=64, seed=0):
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    jtrainer, _ = jlogistic_regression(jmesh, JLogRegConfig(**kw),
                                       sync_every=sync_every)
    ttrainer, tstore = logistic_regression(make_ps_mesh(device="cpu"),
                                           LogRegConfig(**kw),
                                           sync_every=sync_every)
    jtables, jlocal = jtrainer.init_state(jax.random.key(seed))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    tlocal = ()
    chunks = jingest.epoch_chunks(data, num_workers=1,
                                  local_batch=local_batch, steps_per_chunk=8,
                                  sync_every=sync_every, seed=3)
    for i, chunk in enumerate(list(chunks)[:chunks_n]):
        jtables, jlocal, jm = jtrainer.run_chunk(jtables, jlocal, chunk,
                                                 jax.random.key(i))
        ttables, tlocal, tm = ttrainer.run_chunk(ttables, tlocal, chunk, i)
        tm = to_numpy(tm)
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
        # Both sides read exactly and fold pushes in batch order; they part
        # where XLA and PyTorch order a row's logit sum or round sigmoid and
        # log differently (about one float32 rounding each), so per-step
        # losses agree to float32 precision and the 0.5-threshold mistake
        # count exactly (no probability lies within those ulps of 0.5).
        np.testing.assert_allclose(tm["logloss"], np.asarray(jm["logloss"]),
                                   rtol=1e-5)
        np.testing.assert_array_equal(tm["mistakes"],
                                      np.asarray(jm["mistakes"]))
        got, want = ttables[WEIGHT_TABLE].numpy(), np.asarray(
            jtables[WEIGHT_TABLE])
        # Weights are O(0.1-1); those ulps move them by about 1e-7 a step.
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    return ttables[WEIGHT_TABLE].numpy()


@pytest.mark.parametrize("sync_every", [None, 4])
def test_sgd_matches_jax(sync_every):
    table = _parity(_data(), dict(num_features=NF, learning_rate=0.5),
                    sync_every=sync_every, chunks_n=4)
    assert table.shape == (NF, 1) and np.abs(table).max() > 0


@pytest.mark.parametrize("sync_every", [None, 4])
def test_adagrad_matches_jax(sync_every):
    table = _parity(_data(), dict(num_features=NF, learning_rate=0.3,
                                  optimizer="adagrad"),
                    sync_every=sync_every, chunks_n=4)
    assert table.shape == (NF, 2)
    assert (table[:, 1] >= 0).all() and (table[:, 1] > 0).any()


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_dense_head_matches_jax(optimizer):
    data = _data(n=2048, nf=2000, dense=3)
    _parity(data, dict(num_features=2000, learning_rate=0.3,
                       optimizer=optimizer, dense_features=3),
            sync_every=8, chunks_n=3)


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_dense_head_matches_the_scatter_path(optimizer):
    """The oracle's test (tests/test_logreg.py): the fixed-slot dense head
    trains to the weights of the all-scatter path on the same data, the head
    deltas being pre-combined on the worker (equal up to the order of
    float32 sums)."""
    D, NFD = 3, 2000
    data = _data(n=2048, nf=NFD, dense=D, seed=5)
    np.testing.assert_array_equal(
        data["feat_ids"][:, :D], np.broadcast_to(np.arange(D), (2048, D)))
    out = {}
    for d in (0, D):
        cfg = LogRegConfig(num_features=NFD, learning_rate=0.3,
                           optimizer=optimizer, dense_features=d)
        trainer, store = logistic_regression(make_ps_mesh(device="cpu"), cfg)
        tables, ls = trainer.init_state(0)
        chunks = tingest.multi_epoch_chunks(data, 2, num_workers=1,
                                            local_batch=256,
                                            steps_per_chunk=4, seed=3)
        trainer.fit_stream(tables, ls, chunks, 1)
        out[d] = store.dump_model(WEIGHT_TABLE)[1]
    assert np.abs(out[0][:D, 0]).max() > 0
    np.testing.assert_allclose(out[D], out[0], rtol=1e-4, atol=1e-5)


def _train_port(sync_every, epochs=4, lr=0.5, optimizer="sgd"):
    data = tdatasets.synthetic_sparse_classification(6000, NF, NNZ, seed=7,
                                                     noise=0.05)
    data = dict(data, label=(data["label"] > 0).astype(np.float32))
    train, test = tdatasets.train_test_split(data)
    trainer, store = logistic_regression(
        make_ps_mesh(device="cpu"),
        LogRegConfig(num_features=NF, learning_rate=lr, optimizer=optimizer),
        sync_every=sync_every)
    tables, ls = trainer.init_state(0)
    chunks = tingest.multi_epoch_chunks(train, epochs, num_workers=1,
                                        local_batch=32, steps_per_chunk=8,
                                        sync_every=sync_every, seed=3)
    tables, ls, m = trainer.fit_stream(tables, ls, chunks, 1)
    logloss = np.concatenate([x["logloss"] for x in m])
    n = np.concatenate([x["n"] for x in m])
    p = predict_proba_host(store, test["feat_ids"], test["feat_vals"])
    acc = float(np.mean((p > 0.5) == (test["label"] > 0.5)))
    return logloss, n, acc, store


def test_port_logreg_converges_sync_and_ssp():
    logloss, n, acc, _ = _train_port(None)
    q = len(logloss) // 4
    assert logloss[-q:].sum() / n[-q:].sum() < 0.693
    assert acc > 0.8, acc
    _, _, acc_ssp, _ = _train_port(4, epochs=6)
    assert acc_ssp > 0.78, acc_ssp


def test_port_ssp_staleness_changes_trajectory():
    _, _, acc_sync, s_sync = _train_port(None, epochs=3)
    _, _, acc_ssp, s_ssp = _train_port(4, epochs=3)
    w_sync = s_sync.lookup_host(WEIGHT_TABLE, np.arange(NF))
    w_ssp = s_ssp.lookup_host(WEIGHT_TABLE, np.arange(NF))
    assert not np.allclose(w_sync, w_ssp)
    assert acc_sync > 0.72 and acc_ssp > 0.72


def test_port_adagrad_keeps_state_in_the_table():
    _, _, acc, store = _train_port(None, epochs=4, lr=0.3,
                                   optimizer="adagrad")
    assert acc > 0.8, acc
    rows = store.lookup_host(WEIGHT_TABLE, np.arange(NF))
    assert rows.shape == (NF, 2)
    assert (rows[:, 1] >= 0).all() and (rows[:, 1] > 0).sum() > NF // 2


@pytest.mark.parametrize("dense", [0, 3])
def test_pulled_ids_host_matches_jax(dense):
    data = _data(n=300, nf=2000, dense=dense)
    chunk = next(jingest.epoch_chunks(data, num_workers=1, local_batch=16,
                                      steps_per_chunk=8, sync_every=4))
    kw = dict(num_features=2000, dense_features=dense)
    got = logistic_regression(make_ps_mesh(device="cpu"),
                              LogRegConfig(**kw))[0].logic.pulled_ids_host(
                                  chunk)
    want = JWorker(JLogRegConfig(**kw)).pulled_ids_host(chunk)
    if dense:
        assert got is None and want is None
    else:
        np.testing.assert_array_equal(got[WEIGHT_TABLE], want[WEIGHT_TABLE])


@pytest.mark.parametrize("optimizer", ["sgd", "adagrad"])
def test_hot_features_match_jax(optimizer):
    """``hot_features`` marks the write-hot head of the one weight table:
    under AdaGrad the ``(NF, 3)`` sum-and-count scatter takes the hot/cold
    split (K3's plain version for the head); under SGD the ``(NF, 1)`` push
    stays on K4's. Against the JAX package (tests/test_logreg.py)."""
    kw = dict(num_features=NF, learning_rate=0.3, optimizer=optimizer,
              hot_features=8)
    table = _parity(_data(), kw, sync_every=4, chunks_n=4)
    assert np.abs(table[:8]).max() > 0
    trainer, store = logistic_regression(make_ps_mesh(device="cpu"),
                                         LogRegConfig(**kw))
    assert store.specs[WEIGHT_TABLE].hot_ids == 8


@pytest.mark.parametrize("argv", [
    ["--dense-features", "3", "--nnz", "8"],
    ["--optimizer", "adagrad", "--learning-rate", "0.3"],
    ["--dense-features", "3", "--nnz", "8", "--ingest", "host"],
    ["--optimizer", "adagrad", "--learning-rate", "0.3", "--ingest",
     "device"],
], ids=["sgd_dense_head", "adagrad", "sgd_host_ingest",
        "adagrad_device_ingest"])
def test_example_cli_runs_on_cpu(argv):
    from fps_tpu_torch.examples import logreg_ssp as example

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = example.main(["--device", "cpu", "--num-features", "2000",
                           "--num-examples", "3000", "--local-batch", "64",
                           "--epochs", "2", *argv])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["sync_every"] == 8
    assert any(e["event"] == "chunk" for e in events)
    assert events[-1]["event"] == "done"
    assert events[-1]["test_accuracy"] > 0.5
