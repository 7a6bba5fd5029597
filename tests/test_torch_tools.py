"""The port's route-timing tools (``fps_tpu_torch/examples/profile_mf_step.py``,
``bench_scatter.py``, ``bench_logreg_routes.py``, ``pa_scaling.py``) against
the JAX package's ``tools/`` of the same names, on the CPU.

The ids and data each tool draws equal the reference's for the same seed;
where the reference draws inline, its lines are transcribed here and tied
to its source. At a small scale each tool's arms equal their library
counterparts: gathers bit for bit, scatter-adds within the float32 bound
of the exact sum (``k`` terms in any order lie within ``k * eps32 * (sum
of their magnitudes)``). Each tool's output parses as JSON lines. The
full-step analog of ``profile_mf_step`` is held against a JAX transcription
of the reference's step (``tools/profile_mf_step.py:148-166``) within
1e-6: factors are O(0.1), and the two frameworks part by the order of
float32 sums.
"""

import contextlib
import importlib.util
import inspect
import io
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import lax

from fps_tpu import ops as jops
from fps_tpu.utils import datasets as jdatasets

from fps_tpu_torch import ops
from fps_tpu_torch.examples import bench_logreg_routes as blr
from fps_tpu_torch.examples import bench_scatter as bsc
from fps_tpu_torch.examples import pa_scaling as pas
from fps_tpu_torch.examples import profile_mf_step as pms
from fps_tpu_torch.utils import route_timing as rt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _one_thread():
    """One intra-op thread: the files run beside others under xdist, and
    the small tensors here gain nothing from more."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _reference(name):
    """``tools/<name>.py`` as a module (``tools/`` is not a package)."""
    spec = importlib.util.spec_from_file_location(
        f"_ref_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(main, argv):
    """Run a tool's ``main`` and parse its output: the card's line, then
    one JSON object a line."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        assert main(argv) == 0
    first, *rest = buf.getvalue().splitlines()
    assert first == "cpu"
    out = [json.loads(line) for line in rest]
    assert out and all(o["card"] == "cpu" for o in out)
    return out


def _within_bound(before, ids, deltas, got):
    """Steps' pushes folded into ``got`` lie within the float32 bound of
    their exact sum (the steps' pushes as one push of their concatenation:
    a row's sequential sums are a float32 sum of its terms in one order)."""
    excess = rt.scatter_bound_excess(before, ids.reshape(-1),
                                     deltas.reshape(-1, deltas.shape[-1]),
                                     got)
    assert excess <= 0, excess


# ---------------------------------------------------------------------------
# (e) The draws.
# ---------------------------------------------------------------------------

def test_constants_are_the_references():
    ref_p = _reference("profile_mf_step")
    ref_s = _reference("bench_scatter")
    ref_l = _reference("bench_logreg_routes")
    ref_a = _reference("pa_scaling")
    assert (pms.R_ITEMS, pms.R_USERS, pms.RANK, pms.B, pms.T, pms.N) == (
        ref_p.R_ITEMS, ref_p.R_USERS, ref_p.RANK, ref_p.B, ref_p.T, ref_p.N)
    assert bsc.T == ref_s.T
    src = inspect.getsource(ref_s.main)
    for name, R, D, B, alpha in bsc.SHAPES:
        assert f'"{name}"' in src
    assert (blr.T, blr.R_FULL, blr.B_EX, blr.NNZ, blr.B, blr.ALPHA) == (
        ref_l.T, ref_l.R_FULL, ref_l.B_EX, ref_l.NNZ, ref_l.B, ref_l.ALPHA)
    assert (pas.PER_WORKER_EX, pas.LOCAL_BATCH, pas.NF, pas.NNZ) == (
        ref_a.PER_WORKER_EX, ref_a.LOCAL_BATCH, ref_a.NF, ref_a.NNZ)


@pytest.mark.parametrize("R,B,T_,alpha,seed", [
    (1000, 64, 3, 0.9, 0), (5000, 333, 2, 0.9, 2), (47, 1024, 4, 0.9, 4)])
def test_logreg_make_ids_is_the_references(R, B, T_, alpha, seed):
    ref = _reference("bench_logreg_routes")
    np.testing.assert_array_equal(blr.make_ids(R, B, T_, alpha, seed),
                                  ref.make_ids(R, B, T_, alpha, seed))


@pytest.mark.parametrize("R,D,B,alpha", [(2674, 11, 328, 0.8),
                                         (500, 100, 492, 0.75),
                                         (472, 1, 10486, 0.9)])
def test_bench_scatter_draw_is_the_references(R, D, B, alpha):
    """The reference draws inline in ``run`` and ``dim1_shapes``: the table,
    then the popularity ids, from ``default_rng(0)``."""
    ref = _reference("bench_scatter")
    for fn in (ref.run, ref.dim1_shapes):
        src = inspect.getsource(fn)
        assert "rng = np.random.default_rng(0)" in src
        assert "np.searchsorted(cdf, rng.random((T, B)))" in src
    T_ = 3
    rng = np.random.default_rng(0)
    tab = np.asarray(rng.normal(0, 0.1, (R, D)), np.float32)
    pop = 1.0 / np.arange(1, R + 1) ** alpha
    pop /= pop.sum()
    cdf = np.cumsum(pop)
    ids = np.asarray(np.searchsorted(cdf, rng.random((T_, B))), np.int32)
    got_tab, got_ids, deltas = bsc.draw(R, D, B, alpha, T_, CPU)
    np.testing.assert_array_equal(got_tab, tab)
    np.testing.assert_array_equal(got_ids, ids)
    assert tuple(deltas.shape) == (T_, B, D)


def test_profile_draws_are_the_references():
    """The reference's draws in ``main``, in its order, at a small size."""
    ref = _reference("profile_mf_step")
    src = inspect.getsource(ref.main)
    for line in ("items = jnp.asarray(rng.integers(0, R_ITEMS, (T, B)), "
                 "jnp.int32)",
                 "packed = jnp.asarray(rng.integers(0, 2**30, (N, 3)), "
                 "jnp.int32)",
                 "queue_slots = jnp.asarray(rng.integers(0, N, (T, B)), "
                 "jnp.int32)"):
        assert line in src
    scale, T_ = 0.001, 3
    ri, ru, b, n = (rt.scaled(x, scale) for x in (pms.R_ITEMS, pms.R_USERS,
                                                  pms.B, pms.N))
    rng = np.random.default_rng(0)
    want = {
        "items": rng.integers(0, ri, (T_, b)).astype(np.int32),
        "users": rng.integers(0, ru, (T_, b)).astype(np.int32),
        "ratings": rng.normal(0, 1, (T_, b)).astype(np.float32),
        "qtab": rng.normal(0, 0.1, (ri, pms.RANK)).astype(np.float32),
        "ptab": rng.normal(0, 0.1, (ru, pms.RANK)).astype(np.float32),
        "packed": rng.integers(0, 2**30, (n, 3)).astype(np.int32),
        "slots": rng.integers(0, n, (T_, b)).astype(np.int32)}
    got = pms.make_data(CPU, T_, scale)
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k].numpy(), v)


def test_pa_scaling_data_is_the_references():
    ref = _reference("pa_scaling")
    src = inspect.getsource(ref.run_curve)
    assert ("synthetic_sparse_classification(nex, NF, NNZ, seed=3,\n"
            in src)
    got = pas.data_for(2, scale=0.002)
    want = jdatasets.synthetic_sparse_classification(
        rt.scaled(pas.PER_WORKER_EX, 0.002) * 2, pas.NF, pas.NNZ, seed=3,
        noise=0.05)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


# ---------------------------------------------------------------------------
# (f) The arms against the library, and the tools' output.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("R,D,B", [(300, 11, 512), (40, 100, 256),
                                   (1311, 2, 799)])
def test_bench_scatter_arms_equal_the_library(R, D, B):
    """K3 over the whole table and K2, chained over 4 steps, within the
    bound of the exact sum, as ``index_add_``."""
    tab, ids, deltas = bsc.draw(R, D, B, 0.8, 4, CPU)
    tab, ids = torch.from_numpy(tab), torch.from_numpy(ids)
    for arm, op in bsc.SCATTERS.items():
        state = tab.clone()
        for t in range(4):
            op(state, ids[t], deltas[t])
        _within_bound(tab, ids, deltas, state)


def test_bench_scatter_dim1_arms_equal_the_library():
    tab, ids, deltas = bsc.draw(472, 1, 4096, 0.9, 3, CPU)
    tab, ids = torch.from_numpy(tab), torch.from_numpy(ids)
    for op in bsc.DIM1_SCATTERS.values():
        state = tab.clone()
        for t in range(3):
            op(state, ids[t], deltas[t])
        _within_bound(tab, ids, deltas, state)
    for t in range(3):
        want = bsc.DIM1_GATHERS["library index_select"](tab, ids[t])
        assert torch.equal(bsc.DIM1_GATHERS["K5"](tab, ids[t]), want)


def test_logreg_route_arms_equal_the_library():
    """K4 and K5 over the whole table, and through the head route over
    ``table[:H]`` (pushes past H dropped, reads past H zero)."""
    R, B, H = 2000, 852, 131
    tab = torch.from_numpy(np.random.default_rng(1).normal(
        0, 0.1, (R, 1)).astype(np.float32))
    ids = torch.from_numpy(blr.make_ids(R, B, 3))
    deltas = rt.device_normal((3, B, 1), 1e-4, 1, CPU)
    for scatter, gather, view in ((blr.k4, blr.k5, R),
                                  (blr.head_k4(H), blr.head_k5(H), H)):
        state = tab.clone()
        for t in range(3):
            scatter(state, ids[t], deltas[t])
            got = gather(tab, ids[t])
            want = tab.index_select(0, ids[t].clamp(max=view - 1))
            want = torch.where((ids[t] < view)[:, None], want, 0.0)
            assert torch.equal(got, want)
        _within_bound(tab[:view], ids, deltas, state[:view])
        assert torch.equal(state[view:], tab[view:])


def test_bench_scatter_output_parses_and_passes_its_checks():
    out = _lines(bsc.main, ["--device", "cpu", "--iters", "2", "--scale",
                            "0.01"])
    assert [o["shape"] for o in out] == [s[0] for s in bsc.SHAPES]
    for o in out:
        assert set(o["arms"]) == set(bsc.SCATTERS)
        assert all(c["excess"] <= 0 for c in o["checks"])
        assert o["arms"]["K2"]["us_per_step"] > 0
        assert len(o["arms"]["K2"]["us_repeats"]) == 3
    (dim1,) = _lines(bsc.main, ["dim1", "--device", "cpu", "--iters", "2",
                                "--scale", "0.005"])
    assert set(dim1["arms"]) == set(bsc.DIM1_SCATTERS) | set(bsc.DIM1_GATHERS)
    sweep = _lines(bsc.main, ["sweep", "--device", "cpu", "--iters", "1",
                              "--scale", "0.002"])
    assert len(sweep) == len(bsc.SWEEP_D) * len(bsc.SWEEP_R)
    skipped = [(o["D"], o["R"]) for o in sweep if "skipped" in o]
    assert skipped == [(100, 8192), (100, 16384)]


def test_bench_logreg_routes_output_parses_and_passes_its_checks():
    out = _lines(blr.main, ["--device", "cpu", "--iters", "2", "--scale",
                            "0.002"])
    assert [o["stage"] for o in out] == (
        ["a"] + ["b1"] * 2 + ["b2"] * 2 + ["c"] * 3 + ["d"] * 4
        + ["pa_head"] * 2 + ["tune"])
    for o in out:
        for c in o.get("checks", []):
            assert c.get("excess", 0) <= 0 and c["max_abs_diff"] < 1e-6


def test_profile_mf_step_output_parses():
    out = _lines(pms.main, ["--device", "cpu", "--iters", "2", "--scale",
                            "0.005"])
    assert [o["arm"] for o in out] == list(pms.ARMS)
    assert [o["route"] for o in out] == list(pms.ROUTES)
    assert all(o["us_per_step"] > 0 for o in out)


def test_pa_scaling_points_parse_and_process_every_example():
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = pas.run_curves(["gathered"], "cpu", "cpu", epochs=1,
                             scale=0.004, ws=(1, 2))
    lines = [json.loads(line) for line in buf.getvalue().splitlines()]
    assert lines == json.loads(json.dumps(out))
    assert [(o["route"], o["W"]) for o in out] == [("gathered", 1),
                                                   ("gathered", 2)]
    assert out[0]["rate_vs_w1"] == 1.0
    assert out[1]["examples"] == 2 * out[0]["examples"]
    assert out[1]["work_per_example_vs_w1"] == pytest.approx(
        1 / out[1]["rate_vs_w1"])


def test_tools_exit_non_zero_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    for main in (pms.main, bsc.main, blr.main, pas.main):
        with pytest.raises(SystemExit) as e:
            main([])
        assert e.value.code not in (0, None)


# ---------------------------------------------------------------------------
# (g) The full-step analog against the reference's step.
# ---------------------------------------------------------------------------

def _jax_full(qtab, ptab, items, users, ratings):
    """``tools/profile_mf_step.py:148-166`` (``mean_push`` from ``:90-98``),
    transcribed: the item pull through ``fps_tpu.ops``, the user side
    through XLA."""
    def mean_push(tab, ids, deltas):
        rps = tab.shape[0]
        summed = jax.ops.segment_sum(deltas, ids, num_segments=rps + 1)[:rps]
        counts = jax.ops.segment_sum(
            jnp.ones_like(ids, jnp.int32), ids, num_segments=rps + 1)[:rps]
        summed = summed / jnp.maximum(counts, 1)[:, None].astype(jnp.float32)
        touched = counts > 0
        return jnp.where(touched[:, None], tab + summed, tab)

    @jax.jit
    def full(qtab, ptab, items, users, ratings):
        def body(carry, x):
            qtab, ptab = carry
            ids, u, r = x
            q = jops.gather_rows(qtab, ids)
            p = jnp.take(ptab, u, axis=0)
            pred = jnp.sum(p * q, axis=-1)
            err = r - pred
            dp = 0.05 * (err[:, None] * q - 0.01 * p)
            dq = 0.05 * (err[:, None] * p - 0.01 * q)
            ptab = ptab.at[u].add(dp)
            qtab = mean_push(qtab, ids, dq)
            return (qtab, ptab), (jnp.sum(err * err), jnp.float32(B))
        B = items.shape[1]
        (qtab, ptab), outs = lax.scan(body, (qtab, ptab),
                                      (items, users, ratings))
        return qtab, ptab, outs

    return full(qtab, ptab, items, users, ratings)


def test_profile_full_step_matches_the_reference_step():
    d = pms.make_data(CPU, 4, 0.002)
    qtab, ptab = d["qtab"].clone(), d["ptab"].clone()
    se = [float(pms.full_step_(qtab, ptab, d["items"][t], d["users"][t],
                               d["ratings"][t])[0]) for t in range(4)]
    jq, jp, (jse, jn) = _jax_full(*(jnp.asarray(d[k].numpy()) for k in (
        "qtab", "ptab", "items", "users", "ratings")))
    np.testing.assert_allclose(se, np.asarray(jse), rtol=1e-5)
    assert np.asarray(jn).tolist() == [d["items"].shape[1]] * 4
    np.testing.assert_allclose(qtab.numpy(), np.asarray(jq), rtol=0,
                               atol=1e-6)
    np.testing.assert_allclose(ptab.numpy(), np.asarray(jp), rtol=0,
                               atol=1e-6)
    assert not np.array_equal(qtab.numpy(), d["qtab"].numpy())


def test_ops_routes_of_the_tools_are_the_kernels_contract():
    """On the CPU the tools' kernel arms are the plain versions: K1's read
    equals ``index_select`` bit for bit."""
    d = pms.make_data(CPU, 2, 0.002)
    for t in range(2):
        assert torch.equal(ops.gather_rows(d["qtab"], d["items"][t]),
                           d["qtab"].index_select(0, d["items"][t]))
