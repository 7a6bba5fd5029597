"""The port's pod scenarios on the CPU, part 2 of 3: a flapping member
(its chunk quarantined pod-wide) and the elastic W -> W-1 -> W cycle,
through three member agents (the port's CLI in pod mode, torch and jax
unimportable) over the port's demo child (``--device cpu``). Oracles: the
reference's slow pod tests (tests/test_pod.py). Part 1:
tests/test_torch_pod_scenarios.py.
"""

import pytest
import torch

from fps_tpu_torch.testing import supervised_demo as sd

from test_torch_pod_scenarios import TIMEOUT, gates_common


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_pod_flapping_member_quarantine_broadcast(tmp_path):
    """h1's child crashes at chunk 5 on every attempt: two coordinated
    restarts, chunk 5 quarantined pod-wide and skipped by every member,
    each bit-equal to a straight run carrying the same quarantine."""
    ok, detail = sd.run_pod_flapping_member_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    gates_common(detail)
    assert detail["skipped"] == {h: [sd.SCENARIO_POD_CRASH_AT]
                                 for h in sd.SCENARIO_POD_HOSTS}


def test_pod_elastic_resize_bit_identical(tmp_path):
    """A non-leader host (agent and child) is SIGKILLed: evicted at world
    2, relaunched, re-admitted from the copied canonical snapshot; every
    member, the returned one included, bit-equal to the straight run."""
    ok, detail = sd.run_pod_elastic_resize_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    gates_common(detail)
    assert detail["evicted_world_observed"] == 2
    assert detail["victim_restored_step"] >= 2
