"""The PyTorch port's online-MF slice against the JAX package's, on the CPU.

The same synthetic ratings and the same chunks go through JAX ``online_mf``
on a (data=1, shard=1) mesh and through the port on ``device="cpu"``, from
the same tables (carried across with ``fps_tpu_torch.convert``). Per-step
``se`` / ``n`` and both tables are compared after every chunk, in sync and
SSP mode, with the ``"sum"`` and ``"mean"`` combines. Also here: chunk and
dataset parity, the import guard, negative sampling, the example CLI.
"""

import contextlib
import io
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import fps_tpu.ops as jops
from fps_tpu.core import ingest as jingest
from fps_tpu.models.matrix_factorization import MFConfig as JMFConfig
from fps_tpu.models.matrix_factorization import online_mf as jonline_mf
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import MFConfig, make_ps_mesh, online_mf
from fps_tpu_torch.convert import local_state_from_jax, tables_from_jax, to_numpy
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.models.matrix_factorization import (
    ITEM_TABLE,
    predict_host,
    rmse,
)
from fps_tpu_torch.utils import datasets as tdatasets

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NU, NI, NR, RANK = 96, 64, 6000, 4
MF_KW = dict(num_users=NU, num_items=NI, rank=RANK, learning_rate=0.08,
             reg=0.005)


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def pallas_backend():
    prev = jops.get_backend()
    jops.set_backend("pallas")
    yield
    jops.set_backend(prev)


def _parity(sync_every, combine, chunks_n, atol, **extra):
    data = jdatasets.synthetic_ratings(NU, NI, NR, rank=3, noise=0.05, seed=3)
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    jtrainer, _ = jonline_mf(jmesh, JMFConfig(**MF_KW, **extra),
                             sync_every=sync_every, combine=combine)
    ttrainer, tstore = online_mf(make_ps_mesh(device="cpu"),
                                 MFConfig(**MF_KW, **extra),
                                 sync_every=sync_every, combine=combine)
    jtables, jlocal = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    tlocal = local_state_from_jax(ttrainer.logic, np.asarray(jlocal),
                                  device="cpu")
    chunks = jingest.epoch_chunks(
        data, num_workers=1, local_batch=64, steps_per_chunk=8,
        route_key="user", sync_every=sync_every, seed=11)
    for i, chunk in enumerate(list(chunks)[:chunks_n]):
        jtables, jlocal, jm = jtrainer.run_chunk(jtables, jlocal, chunk,
                                                 jax.random.key(i))
        ttables, tlocal, tm = ttrainer.run_chunk(ttables, tlocal, chunk, i)
        tm = to_numpy(tm)
        assert tm["se"].shape == (8,)
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
        # Per-step squared error: float32 sums of B terms in another order
        # (XLA's dot and reduction against PyTorch's).
        np.testing.assert_allclose(tm["se"], np.asarray(jm["se"]), rtol=1e-5)
        # Tables: the same SGD steps; the last bits differ where the two
        # frameworks order a dot product or fuse a multiply-add differently.
        np.testing.assert_allclose(ttables[ITEM_TABLE].numpy(),
                                   np.asarray(jtables[ITEM_TABLE]),
                                   rtol=0, atol=atol)
        np.testing.assert_allclose(tlocal.numpy(), np.asarray(jlocal),
                                   rtol=0, atol=atol)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("sync_every", [None, 4])
def test_mf_slice_matches_jax(sync_every, combine):
    # Factors are O(0.1); measured differences are O(1e-8) after 4 chunks.
    _parity(sync_every, combine, chunks_n=4, atol=1e-6)


def test_mf_slice_matches_jax_pallas_backend(pallas_backend):
    # The JAX side's pushes run scatter_add_pallas in interpret mode, which
    # sums duplicates by a one-hot contraction: another order again.
    _parity(None, "sum", chunks_n=2, atol=1e-5)


@pytest.mark.parametrize("combine", ["sum", "mean"])
@pytest.mark.parametrize("sync_every", [None, 4])
def test_mf_hot_items_matches_jax(sync_every, combine):
    """``hot_items``: the item push takes the hot/cold split (K3's plain
    version for the head, K2's for the tail); the JAX package off a TPU
    folds the same pushes by its XLA scatter. The head rows' sums part by
    the order of float32 additions only."""
    _parity(sync_every, combine, chunks_n=4, atol=1e-6, hot_items=16)


@pytest.mark.parametrize("hot_items", [16, NI])
def test_mf_hot_items_matches_jax_pallas_backend(pallas_backend, hot_items):
    # The JAX side's head runs its packed kernel in interpret mode (bf16
    # hi+lo, about 2^-16 of each delta); NI is the whole-table route.
    _parity(None, "mean", chunks_n=2, atol=1e-5, hot_items=hot_items)


def _train_port(sync_every=None, epochs=3, seed=3, combine="sum"):
    cfg = MFConfig(**MF_KW)
    mesh = make_ps_mesh(device="cpu")
    trainer, store = online_mf(mesh, cfg, sync_every=sync_every,
                               combine=combine)
    data = tdatasets.synthetic_ratings(NU, NI, NR, rank=3, noise=0.05,
                                       seed=seed)
    train, test = tdatasets.train_test_split(data)
    tables, local_state = trainer.init_state(0)
    chunks = tingest.multi_epoch_chunks(
        train, epochs, num_workers=1, local_batch=32, steps_per_chunk=8,
        route_key="user", sync_every=sync_every, seed=11)
    tables, local_state, metrics = trainer.fit_stream(
        tables, local_state, chunks, 1)
    n = np.concatenate([m["n"] for m in metrics])
    pred = predict_host(store, local_state, 1, test["user"], test["item"])
    return rmse(pred, test["rating"]), n, tables, local_state


@pytest.mark.parametrize("sync_every,limit", [(None, 0.35), (4, 0.4)])
def test_port_mf_converges(sync_every, limit):
    # The thresholds of tests/test_mf.py for the JAX package.
    test_rmse, n, _, _ = _train_port(sync_every)
    assert test_rmse < limit, f"test RMSE {test_rmse}"
    assert int(np.sum(n)) == 3 * int(0.9 * NR)


def test_port_mf_deterministic():
    r1 = _train_port(epochs=1)
    r2 = _train_port(epochs=1)
    assert r1[0] == r2[0]
    np.testing.assert_array_equal(r1[2][ITEM_TABLE].numpy(),
                                  r2[2][ITEM_TABLE].numpy())
    np.testing.assert_array_equal(r1[3].numpy(), r2[3].numpy())


@pytest.mark.parametrize("donate", [True, False])
def test_donate_updates_tables_in_place_or_not(donate):
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW),
                           donate=donate, combine="mean")
    tables, local_state = trainer.init_state(0)
    (block,) = tables[ITEM_TABLE]  # the one position's block
    before = block.clone()
    data = tdatasets.synthetic_ratings(NU, NI, 500, seed=1)
    chunk = next(tingest.epoch_chunks(data, num_workers=1, local_batch=32,
                                      steps_per_chunk=4, route_key="user"))
    new_tables, _, _ = trainer.run_chunk(tables, local_state, chunk, 0)
    (new_block,) = new_tables[ITEM_TABLE]
    assert not torch.equal(new_block, before)
    assert (new_block is block) == donate
    assert torch.equal(block, before) == (not donate)


@pytest.mark.parametrize("kw", [
    dict(sync_every=None, route_key="user"),
    dict(sync_every=4, route_key="user"),
    dict(sync_every=None, route_key=None, drop_remainder=True),
    dict(sync_every=2, route_key=None, seed=None),
])
def test_chunks_equal_jax_array_for_array(kw):
    data = jdatasets.synthetic_ratings(50, 30, 1000, seed=2)
    common = dict(num_workers=3, local_batch=16, steps_per_chunk=8)
    want = list(jingest.epoch_chunks(data, **common, **kw))
    got = list(tingest.epoch_chunks(data, **common, **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])
    got = list(tingest.multi_epoch_chunks(data, 2, **common, **kw))
    want = list(jingest.multi_epoch_chunks(data, 2, **common, **kw))
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_stream_chunks_equal_jax():
    data = jdatasets.synthetic_ratings(50, 30, 700, seed=4)
    batches = [{k: v[i:i + 90] for k, v in data.items()}
               for i in range(0, 700, 90)]
    kw = dict(num_workers=2, local_batch=8, steps_per_chunk=4,
              route_key="user", sync_every=2)
    got = list(tingest.stream_chunks(iter(batches), **kw))
    want = list(jingest.stream_chunks(iter(batches), **kw))
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


def test_datasets_equal_jax(tmp_path):
    got = tdatasets.synthetic_ratings(70, 40, 900, seed=6)
    want = jdatasets.synthetic_ratings(70, 40, 900, seed=6)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    for g, w in zip(tdatasets.train_test_split(got, seed=2),
                    jdatasets.train_test_split(want, seed=2)):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])
    path = tmp_path / "u.data"
    rows = np.stack([got["user"][:50] + 1, got["item"][:50] + 1,
                     np.arange(50) % 5 + 1, np.arange(50)], 1)
    np.savetxt(path, rows, fmt="%d", delimiter="\t")
    (gd, gnu, gni) = tdatasets.load_movielens(str(path))
    (wd, wnu, wni) = jdatasets.load_movielens(str(path))
    assert (gnu, gni) == (wnu, wni)
    for k in wd:
        np.testing.assert_array_equal(gd[k], wd[k])


def test_negative_sampling_layout():
    cfg = MFConfig(**MF_KW, negative_samples=3, negative_weight=0.5)
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), cfg)
    tables, local_state = trainer.init_state(0)
    logic = trainer.logic
    B = 40
    batch = {"user": torch.arange(B, dtype=torch.int32) % NU,
             "item": torch.arange(B, dtype=torch.int32) % NI,
             "rating": torch.ones(B), "weight": torch.ones(B)}
    batch["weight"][-5:] = 0.0  # padding
    gen = torch.Generator().manual_seed(0)
    prepared = logic.prepare(batch, gen)
    items = prepared["all_items"]
    assert items.shape == (B, 4) and items.dtype == torch.int32
    assert torch.equal(items[:, 0], batch["item"])  # column 0: the rating
    assert int(items.min()) >= 0 and int(items.max()) < NI
    ids = logic.pull_ids(prepared)["item_factors"]
    assert torch.equal(ids, items.reshape(-1))
    # Worker 0's blocks: the one position's.
    pulled = {"item_factors": tables["item_factors"][0][ids]}
    out = logic.step(prepared, pulled, local_state[0], gen)
    push_ids, deltas = out.pushes["item_factors"]
    assert push_ids.shape == (B * 4,) and deltas.shape == (B * 4, RANK)
    # Padding examples push -1 in every column; live ones their items.
    assert (push_ids.reshape(B, 4)[-5:] == -1).all()
    assert torch.equal(push_ids.reshape(B, 4)[:-5], items[:-5])
    again = logic.prepare(batch, torch.Generator().manual_seed(0))
    assert torch.equal(again["all_items"], items)


def test_touched_local_rows_match_jax():
    from fps_tpu.models.matrix_factorization import (
        MatrixFactorizationWorker as JWorker,
    )

    rng = np.random.default_rng(8)
    batch = {"user": rng.integers(0, NU, 50).astype(np.int32),
             "weight": (rng.random(50) > 0.3).astype(np.float32)}
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    (got,) = trainer.logic.touched_local_rows(
        {k: torch.from_numpy(v) for k, v in batch.items()})
    (want,) = JWorker(JMFConfig(**MF_KW), 1).touched_local_rows(batch)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_convert_checks_shapes_and_dtypes():
    trainer, store = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    good = np.zeros((NI, RANK), np.float32)
    assert tables_from_jax(store, {ITEM_TABLE: good})[
        ITEM_TABLE].numpy().shape == (NI, RANK)
    with pytest.raises(ValueError, match="shape"):
        tables_from_jax(store, {ITEM_TABLE: good[:-1]})
    with pytest.raises(ValueError, match="dtype"):
        tables_from_jax(store, {ITEM_TABLE: good.astype(np.float64)})
    with pytest.raises(ValueError, match="tables"):
        tables_from_jax(store, {"other": good})
    users = np.zeros((NU, RANK), np.float32)
    assert local_state_from_jax(trainer.logic, users,
                                device="cpu").numpy().shape == (NU, RANK)
    with pytest.raises(ValueError, match="shape"):
        local_state_from_jax(trainer.logic, users[:, :2], device="cpu")


def test_local_state_export_import_round_trip():
    trainer, _ = online_mf(make_ps_mesh(device="cpu"), MFConfig(**MF_KW))
    _, local_state = trainer.init_state(4)
    logical = trainer.logic.export_local_state(local_state)
    assert logical.shape == (NU, RANK)
    back = trainer.logic.import_local_state([logical], 1)
    np.testing.assert_array_equal(back, local_state.numpy())


def test_port_imports_neither_jax_nor_fps_tpu():
    code = (
        "import sys\n"
        "import fps_tpu_torch, fps_tpu_torch.convert\n"
        "import fps_tpu_torch.core.api, fps_tpu_torch.core.driver\n"
        "import fps_tpu_torch.core.device_ingest\n"
        "import fps_tpu_torch.core.ingest, fps_tpu_torch.core.rng\n"
        "import fps_tpu_torch.core.store, fps_tpu_torch.ops\n"
        "import fps_tpu_torch.ops._build, fps_tpu_torch.ops.kernels\n"
        "import torch.distributed\n"
        "import fps_tpu_torch.parallel.mesh, fps_tpu_torch.utils.datasets\n"
        "import fps_tpu_torch.parallel.collectives\n"
        "from fps_tpu_torch.parallel.mesh import init_distributed\n"
        "import fps_tpu_torch.utils.trace_summary\n"
        "import fps_tpu_torch.models.matrix_factorization\n"
        "import fps_tpu_torch.models.recommendation\n"
        "import fps_tpu_torch.models.passive_aggressive\n"
        "import fps_tpu_torch.models.logistic_regression\n"
        "import fps_tpu_torch.models.word2vec\n"
        "import fps_tpu_torch.models.ials, fps_tpu_torch.sketch\n"
        "import fps_tpu_torch.core.combinators, fps_tpu_torch.core.prefetch\n"
        "import fps_tpu_torch.tiering, fps_tpu_torch.tiering.planner\n"
        "import fps_tpu_torch.tiering.retier, fps_tpu_torch.tiering.probe\n"
        "import fps_tpu_torch.tiering.tick, fps_tpu_torch.core.megastep\n"
        "import fps_tpu_torch.core.autok\n"
        "import fps_tpu_torch.examples.common, fps_tpu_torch.examples.mf\n"
        "import fps_tpu_torch.examples.passive_aggressive\n"
        "import fps_tpu_torch.examples.logreg_ssp\n"
        "import fps_tpu_torch.examples.word2vec\n"
        "import fps_tpu_torch.examples.ials\n"
        "import fps_tpu_torch.examples.streaming_mf\n"
        "import fps_tpu_torch.core.checkpoint, fps_tpu_torch.core.resilience\n"
        "import fps_tpu_torch.core.retry, fps_tpu_torch.core.snapshot_format\n"
        "import fps_tpu_torch.obs, fps_tpu_torch.obs.fleet\n"
        "import fps_tpu_torch.obs.health, fps_tpu_torch.obs.journal\n"
        "import fps_tpu_torch.obs.registry, fps_tpu_torch.obs.sinks\n"
        "import fps_tpu_torch.obs.timing, fps_tpu_torch.obs.events\n"
        "import fps_tpu_torch.utils.profiling\n"
        "import fps_tpu_torch.testing, fps_tpu_torch.testing.faultfs\n"
        "import fps_tpu_torch.testing.faultnet, fps_tpu_torch.serve\n"
        "import fps_tpu_torch.serve.fleet, fps_tpu_torch.serve.shadow\n"
        "import fps_tpu_torch.serve.net, fps_tpu_torch.serve.wire\n"
        "import fps_tpu_torch.examples.serve\n"
        "import fps_tpu_torch.supervise, fps_tpu_torch.supervise.child\n"
        "import fps_tpu_torch.supervise.supervisor\n"
        "import fps_tpu_torch.testing.workloads\n"
        "import fps_tpu_torch.testing.supervised_demo\n"
        "import fps_tpu_torch.examples.supervise\n"
        "import fps_tpu_torch.supervise.pod, fps_tpu_torch.tenancy\n"
        "import fps_tpu_torch.tenancy.manager, fps_tpu_torch.tenancy.audit\n"
        "import fps_tpu_torch.testing.tenant_demo\n"
        "import fps_tpu_torch.examples.trace_export\n"
        "import fps_tpu_torch.analysis, fps_tpu_torch.analysis.record\n"
        "import fps_tpu_torch.analysis.lint, fps_tpu_torch.obs.drift\n"
        "import fps_tpu_torch.examples.audit_programs\n"
        "import fps_tpu_torch.examples.lint\n"
        "import fps_tpu_torch.native\n"
        "assert fps_tpu_torch.native.available()\n"
        "import fps_tpu_torch.examples.chaos_sweep\n"
        "import fps_tpu_torch.examples.plan\n"
        "import fps_tpu_torch.examples.staleness_sweep\n"
        "import fps_tpu_torch.testing.serve_race_trace\n"
        "import fps_tpu_torch.entry, fps_tpu_torch.utils.route_timing\n"
        "import fps_tpu_torch.examples.profile_mf_step\n"
        "import fps_tpu_torch.examples.bench_scatter\n"
        "import fps_tpu_torch.examples.bench_logreg_routes\n"
        "import fps_tpu_torch.examples.pa_scaling\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'fps_tpu' or m.startswith('fps_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "clean"


def test_chip_smoke_refuses_to_run_without_cuda():
    out = subprocess.run(
        [sys.executable, "-c",
         "import torch, sys; torch.cuda.is_available = lambda: False; "
         "sys.argv = ['chip_smoke.py']; import runpy; "
         "runpy.run_path('chip_smoke.py', run_name='__main__')"],
        cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""


def test_example_cli_host_ingest_matches_device_ingest_quality():
    """``--ingest host`` (numpy chunks copied over) and the default
    ``--ingest device`` (chunks built from the resident dataset) both train
    to a finite, comparable held-out RMSE."""
    from fps_tpu_torch.examples import mf

    rmse_of = {}
    for ingest in ("host", "device"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            rc = mf.main(["--scale", "100k", "--device", "cpu", "--rank",
                          "4", "--local-batch", "2048", "--sync-every", "4",
                          "--combine", "mean", "--learning-rate", "0.1",
                          "--ingest", ingest, "--epochs", "2"])
        events = [json.loads(line) for line in buf.getvalue().splitlines()]
        assert rc == 0 and events[-1]["event"] == "done"
        rmse_of[ingest] = events[-1]["test_rmse"]
    assert all(np.isfinite(list(rmse_of.values())))
    assert abs(rmse_of["host"] - rmse_of["device"]) < 0.1, rmse_of


def test_example_cli_runs_on_cpu():
    from fps_tpu_torch.examples import mf

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = mf.main(["--scale", "100k", "--device", "cpu", "--rank", "4",
                      "--local-batch", "2048", "--steps-per-chunk", "8",
                      "--sync-every", "4", "--combine", "mean",
                      "--learning-rate", "0.1"])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["device"] == "cpu"
    assert events[-1]["event"] == "done"
    assert np.isfinite(events[-1]["test_rmse"])
    assert any(e["event"] == "chunk" for e in events)


def test_trace_summary_counts_device_work_only():
    from fps_tpu_torch.utils import trace_summary

    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    trace = {"deviceProperties": [{"name": "card"}], "traceEvents": [
        ev("gpu_user_annotation", "ProfilerStep#2", 0.0, 100.0),
        ev("user_annotation", "ProfilerStep#2", 0.0, 120.0),
        ev("kernel", "k1", 10.0, 20.0),
        ev("kernel", "k2", 20.0, 20.0),   # overlaps k1: union 10..40
        ev("gpu_memcpy", "Memcpy HtoD", 50.0, 10.0),
        ev("cpu_op", "aten::add", 0.0, 90.0),
    ]}
    got = trace_summary.summarize(trace, steps=2)
    assert got["device"] == "card"
    assert got["device_busy_ms_per_step"] == pytest.approx(40 / 1e3 / 2)
    assert got["device_window_ms_per_step"] == pytest.approx(50 / 1e3 / 2)
    assert got["traced_host_ms_per_step"] == pytest.approx(120 / 1e3 / 2)
    assert got["device_launches_per_step"] == 1.5
    assert [k["name"] for k in got["kernels"]] == ["k1", "k2", "Memcpy HtoD"]
    with pytest.raises(ValueError, match="no device activity"):
        trace_summary.summarize({"traceEvents": trace["traceEvents"][:2]}, 1)


def test_example_profile_refuses_the_cpu(tmp_path):
    from fps_tpu_torch.examples import mf

    with contextlib.redirect_stdout(io.StringIO()):
        with pytest.raises(SystemExit, match="CUDA"):
            mf.main(["--scale", "100k", "--device", "cpu",
                     "--profile", str(tmp_path)])
