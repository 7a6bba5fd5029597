"""The PyTorch port's passive-aggressive slice against the JAX package's, on
the CPU.

The same synthetic examples and the same chunks go through JAX
``passive_aggressive`` on a (data=1, shard=1) mesh and through the port on
``device="cpu"``, from the same tables (carried across with
``fps_tpu_torch.convert``). Per-step ``mistakes`` / ``loss`` / ``n`` and the
table are compared after every chunk: binary PA in each variant, with and
without the head-prefix route, and multiclass PA, under the JAX package's
``auto`` and ``pallas`` backends (tests/test_passive_aggressive.py is the
oracle). Also here: the datasets array for array, the loaders, the refusals
and the example CLI.
"""

import contextlib
import io
import json

import jax
import numpy as np
import pytest
import torch

import fps_tpu.ops as jops
from fps_tpu.core import ingest as jingest
from fps_tpu.models.passive_aggressive import PAConfig as JPAConfig
from fps_tpu.models.passive_aggressive import (
    passive_aggressive as jpassive_aggressive,
)
from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import PAConfig, make_ps_mesh, passive_aggressive
from fps_tpu_torch.convert import tables_from_jax, to_numpy
from fps_tpu_torch.core import ingest as tingest
from fps_tpu_torch.models.passive_aggressive import WEIGHT_TABLE, predict_host
from fps_tpu_torch.ops import kernels
from fps_tpu_torch.utils import datasets as tdatasets

NF, NNZ, H = 500, 10, 64


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(params=["auto", "pallas"])
def backend(request):
    prev = jops.get_backend()
    jops.set_backend(request.param)
    yield request.param
    jops.set_backend(prev)


def _binary_data(n=4096, seed=9):
    data = jdatasets.synthetic_sparse_classification(n, NF, NNZ, seed=seed,
                                                     noise=0.05)
    data, q = jdatasets.head_sort_slots(data, H)
    assert q >= 1
    return data, q


def _parity(data, kw, *, local_batch, chunks_n, backend):
    """Run both packages over the same chunks from the same (zero) tables;
    compare metrics and tables after every chunk. Returns the port's table
    and the largest table difference seen."""
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    jtrainer, _ = jpassive_aggressive(jmesh, JPAConfig(**kw))
    ttrainer, tstore = passive_aggressive(make_ps_mesh(device="cpu"),
                                          PAConfig(**kw))
    jtables, jlocal = jtrainer.init_state(jax.random.key(0))
    ttables = tables_from_jax(tstore, {k: np.asarray(v)
                                       for k, v in jtables.items()})
    tlocal = ()
    chunks = jingest.epoch_chunks(data, num_workers=1,
                                  local_batch=local_batch, steps_per_chunk=2,
                                  seed=3)
    worst = 0.0
    for i, chunk in enumerate(list(chunks)[:chunks_n]):
        jtables, jlocal, jm = jtrainer.run_chunk(jtables, jlocal, chunk,
                                                 jax.random.key(i))
        ttables, tlocal, tm = ttrainer.run_chunk(ttables, tlocal, chunk, i)
        tm = to_numpy(tm)
        np.testing.assert_array_equal(tm["n"], np.asarray(jm["n"]))
        got, want = ttables[WEIGHT_TABLE].numpy(), np.asarray(
            jtables[WEIGHT_TABLE])
        scale = max(1.0, float(np.abs(want).max()))
        if backend == "auto":
            # Both sides read exactly and fold pushes in batch order; they
            # part only where XLA and PyTorch order a B x nnz row sum
            # differently (about one float32 rounding of a margin), which
            # moves a closed-form step by a few ulps and can flip the sign
            # of a margin within those ulps of zero: no such margin occurs
            # in these runs, so the counts agree exactly.
            np.testing.assert_array_equal(tm["mistakes"],
                                          np.asarray(jm["mistakes"]))
            np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                       rtol=1e-5)
            tol = 1e-5 * scale
        else:
            # The JAX side reads and sums scalar tables through bf16 hi+lo
            # pairs (2^-16 of each value); after a few steps the weights
            # part by about that much of their size, and a margin that
            # close to zero may count as a mistake on one side only.
            np.testing.assert_allclose(tm["mistakes"],
                                       np.asarray(jm["mistakes"]),
                                       atol=0.01 * local_batch)
            np.testing.assert_allclose(tm["loss"], np.asarray(jm["loss"]),
                                       rtol=1e-3)
            tol = 3e-4 * scale
        diff = float(np.abs(got - want).max())
        worst = max(worst, diff)
        assert diff <= tol, (i, diff, tol)
    return ttables[WEIGHT_TABLE].numpy(), worst


@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
@pytest.mark.parametrize("head", [False, True])
def test_binary_pa_matches_jax(backend, variant, head):
    data, q = _binary_data()
    kw = dict(num_features=NF, variant=variant, C=1.0,
              hot_features=H if head else 0,
              head_prefix_cols=q if head else 0)
    # local_batch 2048: the head prefix is q * 2048 >= 2048 ids, so the JAX
    # side routes it through its head-only kernel under "pallas".
    _parity(data, kw, local_batch=2048, chunks_n=2, backend=backend)


def test_multiclass_pa_matches_jax(backend):
    data = jdatasets.synthetic_sparse_multiclass(2000, NF, 5, NNZ, seed=3)
    kw = dict(num_features=NF, num_classes=5, variant="PA-I", C=1.0)
    _parity(data, kw, local_batch=128, chunks_n=3, backend=backend)


def test_head_prefix_trains_as_the_plain_layout():
    """The head-prefix route is a routing hint: on the same sorted data the
    port trains to the weights of the plain row-major layout, up to the
    order of float32 sums (prefix pushes fold before the tail's)."""
    data, q = _binary_data()
    out = {}
    for head in (False, True):
        cfg = PAConfig(num_features=NF, variant="PA-I", C=1.0,
                       hot_features=H if head else 0,
                       head_prefix_cols=q if head else 0)
        trainer, store = passive_aggressive(make_ps_mesh(device="cpu"), cfg)
        tables, ls = trainer.init_state(0)
        chunks = tingest.multi_epoch_chunks(data, 2, num_workers=1,
                                            local_batch=1024,
                                            steps_per_chunk=4, seed=3)
        tables, ls, m = trainer.fit_stream(tables, ls, chunks, 1)
        out[head] = (store.dump_model(WEIGHT_TABLE)[1],
                     float(np.sum(m[-1]["mistakes"])))
    assert np.abs(out[False][0]).max() > 0
    np.testing.assert_allclose(out[True][0], out[False][0], rtol=1e-5,
                               atol=1e-6)
    assert out[True][1] == out[False][1]


@pytest.mark.parametrize("variant", ["PA", "PA-I", "PA-II"])
def test_port_pa_binary_learns(variant):
    """The oracle's learning test (tests/test_passive_aggressive.py) on the
    port: the online mistake rate falls and held-out accuracy beats 0.8."""
    data = tdatasets.synthetic_sparse_classification(6000, NF, NNZ, seed=2,
                                                     noise=0.05)
    train, test = tdatasets.train_test_split(data)
    trainer, store = passive_aggressive(
        make_ps_mesh(device="cpu"),
        PAConfig(num_features=NF, variant=variant, C=1.0))
    tables, ls = trainer.init_state(0)
    chunks = tingest.multi_epoch_chunks(train, 4, num_workers=1,
                                        local_batch=16, steps_per_chunk=8)
    tables, ls, m = trainer.fit_stream(tables, ls, chunks, 1)
    mistakes = np.concatenate([x["mistakes"] for x in m])
    n = np.concatenate([x["n"] for x in m])
    k = len(mistakes) // 4
    assert mistakes[-k:].sum() / n[-k:].sum() < (
        0.7 * mistakes[:k].sum() / n[:k].sum())
    pred = predict_host(store, test["feat_ids"], test["feat_vals"])
    assert float(np.mean(pred == test["label"])) > 0.8


def test_untouched_features_stay_zero():
    data = tdatasets.synthetic_sparse_classification(200, NF, NNZ, seed=4)
    data["feat_ids"] = data["feat_ids"] % (NF // 2)
    trainer, store = passive_aggressive(make_ps_mesh(device="cpu"),
                                        PAConfig(num_features=NF))
    tables, ls = trainer.init_state(0)
    chunks = tingest.epoch_chunks(data, num_workers=1, local_batch=16,
                                  steps_per_chunk=4, seed=0)
    trainer.fit_stream(tables, ls, chunks, 1)
    np.testing.assert_array_equal(
        store.lookup_host(WEIGHT_TABLE, np.arange(NF // 2, NF)), 0.0)


def test_head_prefix_counts_only_with_a_declared_head():
    data, q = _binary_data(n=256)
    batch = {k: torch.from_numpy(v[:32]) for k, v in data.items()}
    for hot, want in ((H, {WEIGHT_TABLE: q * 32}), (0, {})):
        cfg = PAConfig(num_features=NF, hot_features=hot,
                       head_prefix_cols=q)
        trainer, _ = passive_aggressive(make_ps_mesh(device="cpu"), cfg)
        assert trainer.logic.head_prefix(batch) == {WEIGHT_TABLE: q * 32}
        assert trainer._head_prefix(batch) == want


@pytest.mark.parametrize("kw", [
    dict(num_features=NF, hot_features=H),
    dict(num_features=NF, num_classes=5, hot_features=H),
], ids=["binary_without_prefix", "multiclass"])
def test_hot_features_without_prefix_route_match_jax(backend, kw):
    """``hot_features`` without the head prefix: the binary ``(NF, 1)``
    push stays on K4's plain version, the multiclass push takes the
    hot/cold split (K3's plain version for the head). Against the JAX
    package, whose pallas backend runs its packed kernel for the head."""
    if kw.get("num_classes", 2) == 2:
        data, _ = _binary_data()
        local_batch = 512
    else:
        data = jdatasets.synthetic_sparse_multiclass(2000, NF, 5, NNZ, seed=3)
        local_batch = 128
    kw = dict(kw, variant="PA-I", C=1.0)
    table, _ = _parity(data, kw, local_batch=local_batch, chunks_n=3,
                       backend=backend)
    assert float(np.abs(table[:H]).max()) > 0
    ttrainer, _ = passive_aggressive(make_ps_mesh(device="cpu"),
                                     PAConfig(**kw))
    assert ttrainer._hot_rows(WEIGHT_TABLE) == H


def test_multiclass_refuses_head_prefix():
    with pytest.raises(ValueError, match="binary-only"):
        passive_aggressive(make_ps_mesh(device="cpu"),
                           PAConfig(num_features=NF, num_classes=5,
                                    head_prefix_cols=2))


def test_cpu_run_launches_no_kernel():
    data, q = _binary_data(n=512)
    cfg = PAConfig(num_features=NF, hot_features=H, head_prefix_cols=q)
    trainer, _ = passive_aggressive(make_ps_mesh(device="cpu"), cfg)
    tables, ls = trainer.init_state(0)
    kernels.reset_launch_counts()
    chunk = next(tingest.epoch_chunks(data, num_workers=1, local_batch=64,
                                      steps_per_chunk=2))
    trainer.run_chunk(tables, ls, chunk, 0)
    assert not any(kernels.launch_counts().values())


# ---------------------------------------------------------------------------
# Datasets and loaders, array for array.
# ---------------------------------------------------------------------------

def _equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("dense", [0, 3])
def test_sparse_datasets_equal_jax(dense):
    args = (700, 300, 9)
    kw = dict(seed=5, noise=0.07, dense_features=dense)
    got = tdatasets.synthetic_sparse_classification(*args, **kw)
    want = jdatasets.synthetic_sparse_classification(*args, **kw)
    _equal(got, want)
    (g2, gq), (w2, wq) = (tdatasets.head_sort_slots(got, 40),
                          jdatasets.head_sort_slots(want, 40))
    assert gq == wq
    _equal(g2, w2)
    _equal(tdatasets.synthetic_sparse_multiclass(400, 300, 6, 9, seed=2),
           jdatasets.synthetic_sparse_multiclass(400, 300, 6, 9, seed=2))


def test_sparse_loaders_equal_jax(tmp_path):
    svm = tmp_path / "rcv1.svm"
    svm.write_text("1 3:0.5 10:1.25\n-1 1:2 # comment\n\n0 7:1e-2 2:3 9:4\n")
    crit = tmp_path / "criteo.tsv"
    num = ["1", "", "3", "-2"] + ["0.5"] * 9
    cat = ["a1b2", "", "ff"] + ["x"] * 23
    crit.write_text("\t".join(["1"] + num + cat) + "\n"
                    + "\t".join(["0"] + [""] * 13 + ["q"] * 26) + "\n")
    assert tdatasets.sniff_sparse_format(str(svm)) == "svmlight"
    assert tdatasets.sniff_sparse_format(str(crit)) == "criteo"
    for path, kw in ((svm, {}), (svm, {"nnz_cap": 2}),
                     (crit, {"num_features": 1000})):
        with pytest.warns(UserWarning) if "nnz_cap" in kw else \
                contextlib.nullcontext():
            got, gnf = tdatasets.load_sparse(str(path), **kw)
        with pytest.warns(UserWarning) if "nnz_cap" in kw else \
                contextlib.nullcontext():
            want, wnf = jdatasets.load_sparse(str(path), use_native=False,
                                              **kw)
        assert gnf == wnf
        _equal(got, want)
    bad = tmp_path / "bad.svm"
    bad.write_text("1 3:x\n")
    with pytest.raises(ValueError, match="malformed"):
        tdatasets.load_svmlight(str(bad))


# ---------------------------------------------------------------------------
# The example CLI.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [
    ["--head-features", "100"],
    ["--num-classes", "5", "--sync-every", "2"],
    ["--head-features", "100", "--ingest", "host"],
    ["--num-classes", "5", "--ingest", "device"],
], ids=["binary_head_prefix", "multiclass_ssp", "host_ingest",
        "device_ingest"])
def test_example_cli_runs_on_cpu(argv):
    from fps_tpu_torch.examples import passive_aggressive as example

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = example.main(["--device", "cpu", "--num-features", "500",
                           "--num-examples", "3000", "--local-batch", "64",
                           "--steps-per-chunk", "8", "--epochs", "2", *argv])
    events = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert rc == 0
    assert events[0]["event"] == "start" and events[0]["device"] == "cpu"
    if "--head-features" in argv:
        assert events[0]["head_prefix_cols"] >= 1
    assert any(e["event"] == "chunk" for e in events)
    assert events[-1]["event"] == "done"
    assert events[-1]["test_accuracy"] > 0.4
