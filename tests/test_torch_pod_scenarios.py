"""The port's pod scenarios on the CPU, part 1 of 3: one host killed and
the slow lease near its TTL; the pod's straight demo run against the JAX
package's ``workloads.run_logreg``; and no fallback for a pod child
without a card.

Three member agents (the port's CLI in pod mode, torch and jax
unimportable) over one pod dir, each supervising the port's demo child
(``--device cpu``); every member must end on the straight run's weights
bit for bit. The oracles are the reference's slow pod tests
(tests/test_pod.py) and ``run_slow_lease_near_ttl_scenario`` of
tests/test_storage_faults.py. Parts 2 and 3:
tests/test_torch_pod_restarts.py (the flapping member, the elastic cycle)
and tests/test_torch_pod_partition.py (the partitioned leader, paced by
design), split so that xdist's ``--dist loadfile`` spreads them.
"""

import jax
import numpy as np
import pytest
import torch

from fps_tpu.parallel.mesh import make_ps_mesh as jmake_ps_mesh
from fps_tpu.testing import workloads as jworkloads

from fps_tpu_torch.testing import supervised_demo as sd

from test_torch_pod import collect
from test_torch_pod_parity import trace_readers_agree

# Every scenario subprocess ends well inside this.
TIMEOUT = 150


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gates_common(detail):
    assert all(detail["bit_identical"].values()), detail["bit_identical"]
    assert detail["debris"] == [] and detail["stale_publishes"] == []
    for h, ch in detail["children"].items():
        assert all(s["device"] == "cpu" for s in ch["attempt_starts"] if s)
        assert ch["meta"]["finished"], h


def test_pod_kill_one_host_bit_identical(tmp_path):
    """h1's child is SIGKILLed after chunk 3: one coordinated restart of
    all three from the common step, one span tree over h0-h2 carrying its
    epoch (read alike by both packages' trace readers), every member
    bit-equal to the straight run."""
    ok, detail = sd.run_pod_kill_one_host_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    gates_common(detail)
    assert detail["kill_fired"]
    trees = trace_readers_agree(tmp_path / "pod")
    assert [t["epoch"] for t in trees] == [
        t["epoch"] for t in detail["trace"]["restart_trees"]]
    assert detail["fleet"]["hosts"]
    assert detail["time_to_recovered_s"] > 0


def test_slow_lease_near_ttl_steps_down(tmp_path):
    """Two slow renewals (faultfs through the one fault seam): the holder
    steps down before its record expires, a follower seizes at a higher
    epoch, and the deposed holder stays out."""
    ok, detail = sd.run_slow_lease_near_ttl_scenario(str(tmp_path),
                                                     timeout=TIMEOUT)
    assert ok, detail
    assert detail["stepdowns"] >= 1 and detail["epoch_monotone"]


def test_elastic_straight_demo_matches_the_reference_workload(tmp_path):
    """The elastic scenario's straight run (20,000 examples, 4 epochs, in
    process on the CPU) against the JAX package's ``workloads.run_logreg``
    on the same chunks, within the float32 bound of
    tests/test_torch_logreg.py (the port's and the reference's initial
    tables are equal: tests/test_torch_supervised_scenarios.py)."""
    out = str(tmp_path / "w.npz")
    assert sd.main([*sd.SCENARIO_ELASTIC_ARGS, "--ckpt-dir",
                    str(tmp_path / "ck"), "--out", out, "--keep", "2",
                    "--device", "cpu"]) == 0
    with np.load(out) as z:
        got = z["weights"]
    jtrain, _ = jworkloads.logreg_data(20000)
    jchunks = jworkloads.logreg_chunks(jtrain, 1, epochs=4)
    jmesh = jmake_ps_mesh(num_shards=1, num_data=1, devices=jax.devices()[:1])
    _, jstore, _ = jworkloads.run_logreg(jmesh, jchunks)
    want = jworkloads.weights(jstore)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    assert np.abs(want).max() > 0.1


def test_a_pod_child_without_cuda_gives_the_pod_up(tmp_path):
    """No fallback under a pod: a demo child given no ``--device`` on a
    machine without CUDA exits non-zero on every attempt, and the pod of
    one gives up instead of training on the CPU."""
    import subprocess

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is visible: the child trains on it")
    pod_dir = str(tmp_path / "pod")
    cmd = sd.pod_member_cmd(pod_dir, "h0", 1, sd.SCENARIO_DEMO_ARGS,
                            member_flags=("--max-restarts", "1"))
    proc = subprocess.Popen(cmd, env=sd._env(None), cwd=sd._ROOT,
                            stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    rc, digest, tail = collect({"h0": proc}, timeout=TIMEOUT)["h0"]
    assert rc == 1 and digest["action"] == "give_up", tail
    log = (tmp_path / "pod" / "h0" / "attempt-0.log").read_text()
    assert "CUDA is not available" in log
    assert not (tmp_path / "pod" / "h0" / "out.npz").exists()
