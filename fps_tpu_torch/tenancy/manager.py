"""TenantManager: M independent model instances on one pod, zero shared fate.

Port of ``fps_tpu/tenancy/manager.py``.
A :class:`TenantSpec` names one model instance — its child argv (with
``{ckpt}``/``{obs}``/``{state}``/``{out}``/``{name}`` placeholders the
manager resolves through :class:`~fps_tpu_torch.tenancy.paths.TenantPaths`),
its hot-tier arbitration weight, seed, extra child env, and SLO target
overrides. :class:`TenantManager` runs every spec under its own
:class:`~fps_tpu_torch.supervise.supervisor.RunSupervisor` in its own thread,
with:

* a private namespace for everything it writes (checkpoints, sidecars,
  obs streams, supervisor state, exported weights) — built ONLY through
  ``TenantPaths``;
* a private fencing epoch: ``pod_fence.json`` lives in the tenant's own
  checkpoint dir and ``FPS_TPU_POD_EPOCH`` is injected per child, so one
  tenant's epoch bump / ``StaleEpochError`` cannot regress or advance a
  neighbor's fence;
* private quarantine state: the supervisor's poison-chunk presets live
  in the tenant's own ``state/supervisor_state.json``;
* private fault scope: per-spec env is the ONLY way injection reaches a
  child, so a ``FPS_TPU_FAULTFS`` schedule in tenant A's spec is
  invisible to tenant B by construction.

The isolation proof lives in :mod:`fps_tpu_torch.testing.tenant_demo` — every
non-injected tenant must finish bit-identical to its solo run.

Stdlib-only: the supervise modules are resolved from ``sys.modules``
when the package is imported normally, by file path otherwise (the
:mod:`fps_tpu_torch.supervise.pod` convention), so a control-plane
process never imports torch.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys as _sys
import threading


def _load_sibling(name: str, package: str, *parts: str):
    import importlib.util as _ilu
    here = os.path.dirname(os.path.abspath(__file__))
    path = os.path.abspath(os.path.join(here, *parts, name + ".py"))
    spec = _ilu.spec_from_file_location(f"fps_tpu_torch.{package}.{name}", path)
    mod = _ilu.module_from_spec(spec)
    # Pre-register so dataclasses in the module resolve their own module
    # (required on 3.10 for modules executed from a file location).
    _sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


_paths = (_sys.modules.get("fps_tpu_torch.tenancy.paths")
          or _load_sibling("paths", "tenancy"))
_sup = (_sys.modules.get("fps_tpu_torch.supervise.supervisor")
        or _load_sibling("supervisor", "supervise", os.pardir, "supervise"))
_child = (_sys.modules.get("fps_tpu_torch.supervise.child")
          or _load_sibling("child", "supervise", os.pardir, "supervise"))

TENANT_ENV = "FPS_TPU_TENANT"
MANIFEST_SCHEMA_VERSION = 1
# Placeholders a spec's argv/watch entries may carry; resolved against
# the tenant's TenantPaths before anything runs.
_PLACEHOLDERS = ("{ckpt}", "{obs}", "{state}", "{out}", "{name}", "{root}")


@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant: a workload command plus its arbitration/SLO identity.

    Args:
      name: tenant name (namespace component; validated).
      cmd: child argv template. Entries may embed ``{ckpt}``, ``{obs}``,
        ``{state}``, ``{out}``, ``{name}``, ``{root}`` — resolved to the
        tenant's namespaced locations.
      weight: hot-tier replica-budget arbitration weight (> 0); consumed
        by :func:`fps_tpu_torch.tiering.planner.arbitrate_replica_budget`.
      seed: workload seed, recorded in the manifest for solo replays.
      env: extra child environment — also the per-tenant fault-injection
        scope (``FPS_TPU_FAULTFS`` here reaches ONLY this tenant).
      slo: SLO target overrides, ``{slo_name: target}``; consumed by the
        obs fleet rollup.
      watch: extra supervisor liveness watch globs (placeholders ok).
    """

    name: str
    cmd: tuple = ()
    weight: float = 1.0
    seed: int = 0
    env: dict = dataclasses.field(default_factory=dict)
    slo: dict = dataclasses.field(default_factory=dict)
    watch: tuple = ()

    def __post_init__(self):
        _paths.validate_tenant_name(self.name)
        if not self.cmd:
            raise ValueError(f"tenant {self.name!r}: empty cmd")
        if not (isinstance(self.weight, (int, float)) and self.weight > 0):
            raise ValueError(
                f"tenant {self.name!r}: weight must be > 0, "
                f"got {self.weight!r}")
        object.__setattr__(self, "cmd", tuple(self.cmd))
        object.__setattr__(self, "watch", tuple(self.watch))


class TenantManager:
    """Run M TenantSpecs side by side with per-tenant blast radius.

    thread-safety: ``run()`` starts one thread per tenant; each thread
    touches only ITS tenant's supervisor and writes only its own key of
    the shared digests dict (distinct-key dict writes are atomic under
    CPython), and ``run()`` joins every thread before reading them —
    there is no other cross-thread state.
    """

    def __init__(self, root: str, specs, *,
                 config=None, base_env: dict | None = None):
        specs = tuple(specs)
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate tenant names: {names}")
        self.root = root
        self.specs = {s.name: s for s in specs}
        self.config = config or _sup.SupervisorConfig()
        self.base_env = dict(base_env or {})
        self.paths = {s.name: _paths.TenantPaths(root, s.name)
                      for s in specs}
        self._digests: dict = {}

    # -- namespace + manifest ------------------------------------------

    def prepare(self) -> None:
        """Create every namespace, write manifests, seed fences at epoch 1."""
        for name, spec in self.specs.items():
            tp = self.paths[name].ensure()
            manifest = {
                "schema": MANIFEST_SCHEMA_VERSION,
                "name": name,
                "weight": spec.weight,
                "seed": spec.seed,
                "slo": dict(spec.slo),
            }
            tmp = tp.manifest_path + ".tmp"
            with open(tmp, "w", encoding="utf-8") as f:
                json.dump(manifest, f, sort_keys=True)
                f.flush()
                os.fsync(f.fileno())
            os.replace(tmp, tp.manifest_path)
            if _child.read_fence(tp.ckpt_dir) is None:
                _child.write_fence(tp.ckpt_dir, 1, 0)

    # -- per-tenant fencing epochs -------------------------------------

    def fence_epoch(self, name: str) -> int:
        """Current fencing epoch of ONE tenant (0 if unfenced)."""
        fence = _child.read_fence(self.paths[name].ckpt_dir)
        return int(fence["min_epoch"]) if fence else 0

    def bump_fence(self, name: str, *, step: int = 0) -> int:
        """Advance ONE tenant's fencing epoch; neighbors are untouched."""
        epoch = self.fence_epoch(name) + 1
        _child.write_fence(self.paths[name].ckpt_dir, epoch, step)
        return epoch

    # -- running -------------------------------------------------------

    def _resolve(self, spec, text: str) -> str:
        tp = self.paths[spec.name]
        for key, val in (("{ckpt}", tp.ckpt_dir), ("{obs}", tp.obs_dir),
                         ("{state}", tp.state_dir), ("{out}", tp.out_path),
                         ("{name}", spec.name), ("{root}", tp.root)):
            text = text.replace(key, val)
        return text

    def supervisor(self, name: str):
        """Build the per-tenant RunSupervisor (state in the tenant's
        namespace, fence epoch + tenant identity in the child env)."""
        spec = self.specs[name]
        tp = self.paths[name]
        env = dict(self.base_env)
        env.update(spec.env)
        env[TENANT_ENV] = name
        env[_child.POD_EPOCH_ENV] = str(max(self.fence_epoch(name), 1))
        cmd = [self._resolve(spec, a) for a in spec.cmd]
        watch = tuple(self._resolve(spec, w) for w in spec.watch)
        return _sup.RunSupervisor(
            cmd, state_dir=tp.state_dir, config=self.config,
            watch=watch, env=env)

    def run(self) -> dict:
        """Run every tenant concurrently; return ``{name: digest}``.

        One tenant exhausting its restarts (digest ``success: False``)
        or raising does not interrupt the others — its entry records the
        failure and every other tenant runs to its own conclusion.
        """
        self.prepare()
        digests: dict = {}

        def _one(name: str):
            try:
                digests[name] = self.supervisor(name).run()
            except Exception as exc:  # isolation: never kill neighbors
                digests[name] = {"success": False,
                                 "error": f"{type(exc).__name__}: {exc}"}

        threads = [threading.Thread(target=_one, args=(n,),
                                    name=f"tenant-{n}", daemon=True)
                   for n in self.specs]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        self._digests = digests
        return digests

    def journal_path(self, name: str) -> str:
        """The tenant's supervisor journal (for recovery-time extraction)."""
        return os.path.join(self.paths[name].state_dir,
                            _sup.JOURNAL_FILENAME)
