"""The port's supervised scenarios, part 4, on the CPU: the wire plane under
the port's faultnet (torn frames, a reconnect storm, a slow peer and a dead
deadline, a batched storm with admission shedding), the autoscaled fleet
under reader churn, and a partitioned (SIGSTOPped) reader beside training,
from ``fps_tpu_torch.testing.supervised_demo`` (the oracles:
tools/chaos_sweep.py's network scenarios). Each returns ``ok``; the
answers are bit-identical to the fault-free run's.
"""

import pytest
import torch

from fps_tpu_torch.testing import supervised_demo as sd


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("scenario", [
    "net_torn_frames", "net_reconnect_storm", "net_slow_peer",
    "serve_batch_storm", "autoscale_reader_churn"])
def test_wire_scenario(tmp_path, scenario):
    ok, detail = getattr(sd, f"run_{scenario}_scenario")(str(tmp_path),
                                                         timeout=120)
    assert ok, detail


def test_partitioned_reader_is_an_incident_and_recovers(tmp_path):
    ok, detail = sd.run_net_partition_reader_scenario(str(tmp_path),
                                                      timeout=120,
                                                      device="cpu")
    assert ok, detail
    assert detail["live_before_stop"]["wedged"] == []
