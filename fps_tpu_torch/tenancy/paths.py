"""Tenant namespace layout: THE one place tenant paths are built.

Port of ``fps_tpu/tenancy/paths.py``; the constants and the layout are the
reference's letter for letter, so either package reads the other's tenants
root. Every plane that is tenancy-aware (the manager, the audit, the chaos
scenarios, the obs fleet rollup) derives its on-disk locations from
:class:`TenantPaths`, never by joining ``"tenants"`` / ``"ckpt"`` /
``"obs"`` string literals itself (lint rule FPS009 of
:mod:`fps_tpu_torch.analysis.lint` flags such a literal). The payoff is
the blast-radius contract — if no plane can even *spell* a neighbor's
namespace, one tenant's fault cannot write into another's state.

Layout under a fleet root ``R``::

    R/tenants/<name>/tenant.json   manifest (weight, seed, SLO overrides)
    R/tenants/<name>/ckpt/         snapshots, sidecars, fleet/ fences
    R/tenants/<name>/obs/          events-p*.jsonl, journal-*.jsonl
    R/tenants/<name>/state/        supervisor state/journal/heartbeat/logs
    R/tenants/<name>/out.npz       the tenant's exported weights

Stdlib-only and importable both as ``fps_tpu_torch.tenancy.paths`` and by
bare file path (the :mod:`fps_tpu_torch.supervise.pod` convention): it
never brings torch into a control-plane process.
"""

from __future__ import annotations

import dataclasses
import os
import re

# Mirrored (with a mirror test) in fps_tpu_torch/obs/fleet.py, which is loaded
# by file path and cannot import this module.
TENANTS_DIRNAME = "tenants"
MANIFEST_FILENAME = "tenant.json"
CKPT_DIRNAME = "ckpt"
OBS_DIRNAME = "obs"
STATE_DIRNAME = "state"
OUT_FILENAME = "out.npz"

_NAME_RE = re.compile(r"^[a-z0-9][a-z0-9_-]{0,63}$")


def validate_tenant_name(name: str) -> str:
    """Return ``name`` if it is a legal tenant name, else raise.

    Names become directory components and journal/metric labels, so the
    grammar is deliberately narrow: lowercase alphanumerics, ``-`` and
    ``_``, at most 64 chars, no leading separator. Anything that could
    escape the namespace (``..``, ``/``, empty) is rejected here, once.
    """
    if not isinstance(name, str) or not _NAME_RE.match(name):
        raise ValueError(
            f"illegal tenant name {name!r}: must match {_NAME_RE.pattern}")
    return name


def tenants_root(root: str) -> str:
    """``<root>/tenants`` — the directory holding all tenant namespaces."""
    return os.path.join(root, TENANTS_DIRNAME)


@dataclasses.dataclass(frozen=True)
class TenantPaths:
    """All on-disk locations for one tenant under one fleet root."""

    root: str
    name: str

    def __post_init__(self):
        validate_tenant_name(self.name)

    @property
    def tenant_dir(self) -> str:
        return os.path.join(tenants_root(self.root), self.name)

    @property
    def manifest_path(self) -> str:
        return os.path.join(self.tenant_dir, MANIFEST_FILENAME)

    @property
    def ckpt_dir(self) -> str:
        return os.path.join(self.tenant_dir, CKPT_DIRNAME)

    @property
    def obs_dir(self) -> str:
        return os.path.join(self.tenant_dir, OBS_DIRNAME)

    @property
    def state_dir(self) -> str:
        return os.path.join(self.tenant_dir, STATE_DIRNAME)

    @property
    def out_path(self) -> str:
        return os.path.join(self.tenant_dir, OUT_FILENAME)

    def ensure(self) -> "TenantPaths":
        """Create the namespace directories (idempotent)."""
        for d in (self.ckpt_dir, self.obs_dir, self.state_dir):
            os.makedirs(d, exist_ok=True)
        return self

    def owns(self, path: str) -> bool:
        """True iff ``path`` lies inside this tenant's namespace."""
        tenant = os.path.abspath(self.tenant_dir)
        return os.path.commonpath(
            [tenant, os.path.abspath(path)]) == tenant


def list_tenants(root: str) -> list[str]:
    """Tenant names present under ``root`` (sorted; [] if none)."""
    base = tenants_root(root)
    try:
        entries = os.listdir(base)
    except OSError:
        return []
    return sorted(n for n in entries
                  if _NAME_RE.match(n)
                  and os.path.isdir(os.path.join(base, n)))
