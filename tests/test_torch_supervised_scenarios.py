"""The port's supervised scenarios, part 1 of 3, on the CPU: the wedge (both
modes) and the deterministic crash, through the port's supervisor CLI
(torch unimportable there) over the port's demo child
(``fps_tpu_torch.testing.supervised_demo``, ``--device cpu``); and the
demo's straight run against the JAX package's ``workloads.run_logreg``.

The oracles are the slow ``test_supervised_logreg_resumes_bit_identical``
of tests/test_supervise.py and ``tools/chaos_sweep.py``'s scenarios: each
supervised run must end on its straight run's weights bit for bit. Parts
2 and 3: tests/test_torch_supervised_kills.py and
tests/test_torch_supervised_serving.py (split so that xdist's
``--dist loadfile`` spreads them).
"""

import os

import jax
import numpy as np
import pytest
import torch

from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.testing import workloads as jworkloads

from fps_tpu_torch import make_ps_mesh
from fps_tpu_torch.convert import tables_from_jax
from fps_tpu_torch.models.logistic_regression import (
    LogRegConfig,
    logistic_regression,
)
from fps_tpu_torch.testing import supervised_demo as sd
from fps_tpu_torch.testing import workloads

# Every scenario subprocess ends well inside this.
TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("wedge_mode", ["sigstop", "sleep"])
def test_wedged_demo_resumes_bit_identical(tmp_path, wedge_mode):
    """A wedged training child (SIGSTOP, or a host loop asleep) is
    deadline-aborted, restarted, resumes at the wedged chunk from
    ``latest_valid_step`` and ends bit-equal to the straight run."""
    ok, detail = sd.run_supervised_scenario(
        str(tmp_path), device="cpu", wedge_mode=wedge_mode,
        stall_timeout_s=5.0, timeout=TIMEOUT)
    assert ok, detail
    assert detail["device"] == "cpu"
    # The SIGSTOP'd attempt never came back: only a SIGKILL ends it.
    assert [s.get("restored_step") for s in detail["attempt_starts"]] == [
        0, sd.SCENARIO_WEDGE_AT]


def test_deterministic_crash_is_quarantined_bit_identical(tmp_path):
    ok, detail = sd.run_crash_quarantine_scenario(str(tmp_path),
                                                  device="cpu",
                                                  timeout=TIMEOUT)
    assert ok, detail
    assert detail["attempt_codes"] == [3, 3, 0]
    assert detail["quarantine_carried"] and detail["skipped"] == [
        sd.SCENARIO_CRASH_AT]


def test_straight_demo_matches_the_reference_workload(tmp_path):
    """The demo's straight run (in process, on the CPU) against the JAX
    package's ``workloads.run_logreg`` on the same chunks, from the same
    tables (carried through ``convert.py``): within the float32 bound of
    tests/test_torch_logreg.py."""
    out = str(tmp_path / "w.npz")
    assert sd.main([*sd.SCENARIO_DEMO_ARGS, "--ckpt-dir",
                    str(tmp_path / "ck"), "--out", out,
                    "--device", "cpu"]) == 0
    with np.load(out) as z:
        got = z["weights"]

    jtrain, _ = jworkloads.logreg_data(8000)
    jchunks = jworkloads.logreg_chunks(jtrain, 1, epochs=2)
    train, _ = workloads.logreg_data(8000)
    chunks = workloads.logreg_chunks(train, 1, epochs=2)
    assert len(chunks) == len(jchunks)
    for c, jc in zip(chunks, jchunks):
        assert c.keys() == jc.keys()
        for k in c:
            np.testing.assert_array_equal(c[k], jc[k])
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    jtrainer, jstore, _ = jworkloads.run_logreg(jmesh, jchunks)
    want = jworkloads.weights(jstore)
    # The same start: the JAX package's initial tables through convert.py
    # are the port's initial tables.
    jtables, _ = jtrainer.init_state(jax.random.key(0))
    trainer, store = logistic_regression(
        make_ps_mesh(device="cpu"),
        LogRegConfig(num_features=workloads.NF, learning_rate=0.5))
    tables, _ = trainer.init_state(0)
    carried = tables_from_jax(store, {k: np.asarray(v)
                                      for k, v in jtables.items()})
    for name in tables:
        np.testing.assert_array_equal(carried[name].numpy(),
                                      tables[name].numpy())
    assert got.shape == want.shape == (workloads.NF, 1)
    # Both read exactly and fold pushes in batch order; they part by about
    # one float32 rounding of a logit a step (tests/test_torch_logreg.py).
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_a_child_without_cuda_and_without_a_device_exits_nonzero(tmp_path):
    """No fallback: with no CUDA and no ``--device`` the child refuses to
    train on the CPU (here, where there is no card)."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the child trains on it")
    r = subprocess.run(
        sd.demo_cmd(*sd.SCENARIO_DEMO_ARGS, "--ckpt-dir",
                    str(tmp_path / "ck"), "--out", str(tmp_path / "w.npz")),
        env=sd._env(None), cwd=sd._ROOT, capture_output=True, text=True,
        timeout=TIMEOUT)
    assert r.returncode != 0 and "CUDA" in r.stderr, r.stderr[-2000:]
    assert not os.path.exists(tmp_path / "w.npz")
