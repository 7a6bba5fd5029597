"""The port's supervised scenarios, part 2 of 3, on the CPU: SIGKILLs
between boundaries (mid-prefetch, mid-megastep, between hot-tier
reconciles, between a sharded reconcile window and its checkpoint,
between a re-rank and its checkpoint), each through the port's supervisor
CLI over the demo child with ``--device cpu``, each ending on its straight
run's weights bit for bit (see tests/test_torch_supervised_scenarios.py).
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


def test_prefetch_kill_resumes_bit_identical(tmp_path):
    ok, detail = sd.run_prefetch_kill_scenario(str(tmp_path), device="cpu",
                                               timeout=TIMEOUT)
    assert ok, detail


def test_megastep_kill_resumes_bit_identical(tmp_path):
    ok, detail = sd.run_megastep_kill_scenario(str(tmp_path), device="cpu",
                                               timeout=TIMEOUT)
    assert ok, detail
    assert detail["restored_step"] == sd.SCENARIO_MEGASTEP_KILL_AT


def test_hot_tier_kill_resumes_bit_identical(tmp_path):
    ok, detail = sd.run_hot_tier_kill_scenario(str(tmp_path), device="cpu",
                                               timeout=TIMEOUT)
    assert ok, detail


def test_reconcile_shard_kill_restores_the_fold_state(tmp_path):
    ok, detail = sd.run_reconcile_shard_kill_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    assert detail["fold_persisted"]


def test_retier_kill_restores_the_sidecar(tmp_path):
    ok, detail = sd.run_retier_kill_scenario(str(tmp_path), device="cpu",
                                             timeout=TIMEOUT)
    assert ok, detail
    assert detail["sidecar_restored"] is True
