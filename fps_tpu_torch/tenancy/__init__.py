"""Multi-tenant pods: blast-radius isolation for many models on one fleet.

Port of ``fps_tpu/tenancy/``. :mod:`~fps_tpu_torch.tenancy.paths` is the
one namespace helper (the reference's lint rule FPS009 enforces it there), :mod:`~fps_tpu_torch.tenancy.manager` runs M supervised model
instances side by side with per-tenant fences/quarantine/fault scope,
and :mod:`~fps_tpu_torch.tenancy.audit` proves zero cross-tenant writes after
a faulted run. All stdlib-only — safe in control-plane processes.
"""

from fps_tpu_torch.tenancy.paths import (  # noqa: F401
    CKPT_DIRNAME,
    MANIFEST_FILENAME,
    OBS_DIRNAME,
    OUT_FILENAME,
    STATE_DIRNAME,
    TENANTS_DIRNAME,
    TenantPaths,
    list_tenants,
    tenants_root,
    validate_tenant_name,
)
from fps_tpu_torch.tenancy.audit import audit_namespaces  # noqa: F401
from fps_tpu_torch.tenancy.manager import (  # noqa: F401
    MANIFEST_SCHEMA_VERSION,
    TENANT_ENV,
    TenantManager,
    TenantSpec,
)
