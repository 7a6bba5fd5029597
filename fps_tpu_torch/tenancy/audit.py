"""Post-run namespace audit: prove zero cross-tenant writes.

Port of ``fps_tpu/tenancy/audit.py``.

The blast-radius contract is structural — every byte a tenant's planes
produce must land inside ``<root>/tenants/<name>/``. The audit walks a
fleet root after a (possibly faulted) run and classifies every file it
finds:

* inside a known tenant's namespace → attributed to that tenant;
* directly under the fleet root or ``tenants/`` itself (no files are
  ever legal there — only directories) → violation;
* under ``tenants/<unknown>/`` → violation (a plane invented a
  namespace no spec declared).

Chaos scenarios run this after every multi-tenant arm and carry the
result into the sweep digest, so "no cross-contamination" is evidence,
not assertion. Stdlib-only, loadable by file path.
"""

from __future__ import annotations

import os
import sys as _sys


def _load_sibling(name: str, *parts: str):
    import importlib.util as _ilu
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.join(here, *parts, name + ".py")
    spec = _ilu.spec_from_file_location(
        f"fps_tpu_torch.tenancy.{name}" if not parts else name, path)
    mod = _ilu.module_from_spec(spec)
    _sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_paths = (_sys.modules.get("fps_tpu_torch.tenancy.paths")
          or _load_sibling("paths"))


def audit_namespaces(root: str, tenant_names) -> dict:
    """Walk ``root`` and attribute every file to exactly one tenant.

    Returns ``{"files": N, "per_tenant": {name: count},
    "violations": [relpath, ...], "clean": bool}``. ``violations`` is
    every file that is not inside a declared tenant's namespace —
    including files under an undeclared ``tenants/<x>/`` subtree and
    loose files at the fleet root (the manager keeps no root-level
    files; all its state is per-tenant).
    """
    names = [_paths.validate_tenant_name(n) for n in tenant_names]
    tenant_dirs = {n: os.path.abspath(_paths.TenantPaths(root, n).tenant_dir)
                   for n in names}
    per_tenant = {n: 0 for n in names}
    violations = []
    total = 0
    root_abs = os.path.abspath(root)
    for dirpath, _dirnames, filenames in os.walk(root_abs):
        for fn in filenames:
            full = os.path.join(dirpath, fn)
            total += 1
            owner = None
            for n, tdir in tenant_dirs.items():
                if os.path.commonpath([tdir, full]) == tdir:
                    owner = n
                    break
            if owner is None:
                violations.append(os.path.relpath(full, root_abs))
            else:
                per_tenant[owner] += 1
    violations.sort()
    return {
        "files": total,
        "per_tenant": per_tenant,
        "violations": violations,
        "clean": not violations,
    }
