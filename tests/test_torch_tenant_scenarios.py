"""The port's tenant scenarios on the CPU (fps_tpu_torch.testing.tenant_demo):
a poisoned tenant beside an untouched neighbour, an ENOSPC brownout
confined to one namespace, one tenant's wedged serving reader restarted
without touching its neighbour's fence, and a noisy neighbour squeezed by
the replica-budget arbitration. The tenants' manager runs in a process of
its own with torch and jax unimportable; every non-injected tenant must
end on its solo run's weights bit for bit, and the namespace audit must
find nothing outside the two namespaces. Oracle: the reference's scenarios
in fps_tpu/testing/tenant_demo.py (run by tools/chaos_sweep.py).
"""

import pytest
import torch

from fps_tpu_torch.obs import fleet
from fps_tpu_torch.testing import tenant_demo as td

# Every scenario subprocess ends well inside this.
TIMEOUT = 150


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_tenant_poison_isolation(tmp_path):
    ok, detail = td.run_tenant_poison_isolation_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    assert detail["injected_skipped"] == [td.SCENARIO_TENANT_CRASH_AT]
    tenants = fleet.tenant_fleet_digest(str(tmp_path / "pod"))["tenants"]
    assert sorted(tenants) == [td.TENANT_INJECTED, td.TENANT_NEIGHBOR]
    assert tenants[td.TENANT_NEIGHBOR]["recovery"]["count"] == 0
    for name, ch in detail["children"].items():
        assert all(s["device"] == "cpu" for s in ch["attempt_starts"] if s)


def test_tenant_enospc_brownout_confined(tmp_path):
    ok, detail = td.run_tenant_enospc_brownout_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    assert detail["degraded_publishes"][td.TENANT_NEIGHBOR] == 0


def test_tenant_reader_wedge_confined(tmp_path):
    ok, detail = td.run_tenant_reader_wedge_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    assert detail["neighbor_fence_unchanged"]


def test_tenant_noisy_neighbor_squeezed_alone(tmp_path):
    ok, detail = td.run_tenant_noisy_neighbor_scenario(
        str(tmp_path), device="cpu", timeout=TIMEOUT)
    assert ok, detail
    arb = detail["arbitration"]
    assert arb["granted"][td.TENANT_NEIGHBOR] == \
        arb["demand"][td.TENANT_NEIGHBOR]
