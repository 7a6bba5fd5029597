"""The port's pod scenarios on the CPU, part 3 of 3: the partitioned
coordinator. The lease holder's member agent is SIGSTOPped while its
child trains on, orphaned; a follower seizes the lease, fences every
member dir and restarts the pod, the orphan's next publish is refused
(``StaleEpochError`` in its log), and after SIGCONT every member ends
bit-equal to the straight run. The pod's children pace every chunk
boundary (0.3 s, as the reference's), so the scenario takes about a
minute. Oracle: ``test_pod_partition_coordinator_fenced`` of
tests/test_pod.py. Part 1: tests/test_torch_pod_scenarios.py.
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


def test_pod_partition_coordinator_fenced(tmp_path):
    ok, detail = sd.run_pod_partition_coordinator_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    gates_common(detail)
    assert detail["seized_by"] not in (None, detail["stopped_leader"])
    assert detail["fenced_logs"]
    assert detail["lease_seizures"] >= 1
