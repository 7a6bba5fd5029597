"""The port's supervised scenarios, part 3, on the CPU: the delta chain
killed mid-publish and its compaction killed at every phase, and the read
side over a supervised child (serve-while-train, the step-fenced fleet),
through the port's supervisor CLI over the demo child with ``--device
cpu`` (see tests/test_torch_supervised_scenarios.py); then the storage
scenarios in process under the port's faultfs (a brownout, a blackout and
its resume, ENOSPC mid-compaction). The oracles are tools/chaos_sweep.py's
scenarios and the slow tests of tests/test_serve.py and
tests/test_serve_fleet.py.
"""

import pytest
import torch

from fps_tpu_torch.testing import supervised_demo as sd

TIMEOUT = 120


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_delta_chain_kill_and_compaction_kills(tmp_path):
    ok, detail = sd.run_delta_chain_kill_scenario(str(tmp_path),
                                                  device="cpu",
                                                  timeout=TIMEOUT)
    assert ok, detail
    assert set(detail["compaction"]) == {"precommit", "published",
                                         "swept_one"}


def test_serve_while_train_survives_kill_and_torn_candidate(tmp_path):
    ok, detail = sd.run_serve_while_train_scenario(str(tmp_path),
                                                   device="cpu",
                                                   timeout=TIMEOUT)
    assert ok, detail


def test_fleet_fence_under_child_and_reader_restarts(tmp_path):
    ok, detail = sd.run_fleet_fence_scenario(str(tmp_path), device="cpu",
                                             timeout=TIMEOUT)
    assert ok, detail


def test_storage_brownout_costs_recency_never_state(tmp_path):
    ok, detail = sd.run_storage_brownout_scenario(str(tmp_path),
                                                  device="cpu")
    assert ok, detail
    assert detail["degraded_publishes"] >= 1 and detail["poll_errors"] > 0


def test_storage_blackout_recovers_and_resumes(tmp_path):
    ok, detail = sd.run_storage_blackout_recover_scenario(str(tmp_path),
                                                          device="cpu")
    assert ok, detail
    assert detail["degraded_publishes"] == 3


def test_enospc_mid_compaction_aborts_then_completes(tmp_path):
    ok, detail = sd.run_enospc_compaction_scenario(str(tmp_path),
                                                   device="cpu")
    assert ok, detail
    assert detail["compaction_aborts_counted"] >= 1
