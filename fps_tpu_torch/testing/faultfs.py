"""faultfs — deterministic, seed-replayable I/O fault injection.

The port's copy of ``fps_tpu/testing/faultfs.py``: :func:`install` and
:func:`uninstall` act on the port's seams
(:mod:`fps_tpu_torch.core.retry`) only, so a test that drives both
packages installs a schedule into each.

The hostile-filesystem half of the chaos harness (``docs/resilience.md``
"Hostile filesystem"): :class:`FaultFS` interposes on the framework's
file operations through the seams in :mod:`fps_tpu_torch.core.retry`
(``_atomic_savez``, snapshot reads, lease/fence writes, sidecar writes,
directory scans) — NEVER by global monkeypatching, so only the
framework's own storage traffic is ever faulted and the schedule is
stated in the framework's vocabulary: *path classes* (``snapshot`` /
``lease`` / ``fence`` / ``sidecar`` / ``control`` / ``journal``) crossed
with *operations* (``write`` / ``fsync`` / ``replace`` / ``read`` /
``listdir`` / ``remove``).

Fault types (:class:`FaultRule.fault`):

* ``"errno"``  — raise ``OSError(errno_name)`` (ENOSPC, EIO, ETIMEDOUT,
  transient ENOENT, ...);
* ``"delay"``  — sleep ``delay_s`` before the operation proceeds (slow
  write / slow fsync / storage brownout latency);
* ``"torn"``   — rename seams publish a truncated prefix of the tmp
  file at the destination and then fail with EIO: the torn-publish the
  CRC gates must catch;
* ``"stale"``  — read seams are redirected to the PRE-rename content of
  the path (captured by the injector when it sees the ``replace``), the
  stale read-after-rename of a caching network filesystem; with no
  shadow captured yet it degrades to a transient ENOENT.

Scheduling is **per (path_class, op) operation count**: each matching
operation increments a deterministic counter, and a rule fires for
counts in ``[start, start + count)`` hitting ``every``-th occurrence
(``count=None`` = forever). An optional ``prob`` makes a rule
probabilistic but still REPLAYABLE: the decision is
``sha256(seed, class, op, n)``, a pure function of the schedule seed and
the op index — same seed, same op stream, same faults, every run.

Cross-process: :meth:`FaultFS.to_env` serializes the schedule into the
``FPS_TPU_FAULTFS`` env var (or a spec file path) and
:func:`fps_tpu_torch.core.retry.get_injector` self-installs it lazily in any
child process — supervised training children, pod agents, and jax-free
serving processes all honor one schedule format.

Stdlib-only, like the seams it feeds.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import hashlib
import json
import os
import shutil
import tempfile
import threading
import time

__all__ = ["FaultRule", "FaultFS", "install", "uninstall"]

# Mirror of fps_tpu_torch.core.retry.FAULTFS_ENV (this module must stay
# loadable by file path with zero package imports — the env-activation
# path in retry.get_injector does exactly that; mirror-tested).
FAULTFS_ENV = "FPS_TPU_FAULTFS"

OPS = ("write", "fsync", "replace", "read", "listdir", "remove")
FAULTS = ("errno", "delay", "torn", "stale")


@dataclasses.dataclass(frozen=True)
class FaultRule:
    """One scheduled fault: which (path_class, op) stream it targets and
    which occurrences it hits. ``path_class``/``op`` accept ``"*"``."""

    path_class: str
    op: str
    fault: str
    errno_name: str = "EIO"
    delay_s: float = 0.0
    start: int = 0
    count: int | None = 1
    every: int = 1
    prob: float = 1.0

    def __post_init__(self):
        if self.fault not in FAULTS:
            raise ValueError(
                f"fault must be one of {FAULTS}, got {self.fault!r}")
        if self.op != "*" and self.op not in OPS:
            raise ValueError(f"op must be one of {OPS} or '*', "
                             f"got {self.op!r}")
        if self.fault == "errno" and not hasattr(_errno,
                                                 self.errno_name):
            raise ValueError(f"unknown errno name {self.errno_name!r}")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")

    def matches(self, cls: str, op: str, n: int, seed: int) -> bool:
        """Does this rule fire for occurrence ``n`` (0-based) of
        ``(cls, op)``? Pure function of the schedule — replayable."""
        if self.path_class != "*" and self.path_class != cls:
            return False
        if self.op != "*" and self.op != op:
            return False
        if n < self.start:
            return False
        if self.count is not None and n >= self.start + self.count:
            return False
        if (n - self.start) % self.every:
            return False
        if self.prob < 1.0:
            h = hashlib.sha256(
                f"{seed}:{cls}:{op}:{n}".encode()).digest()
            if int.from_bytes(h[:8], "big") / float(1 << 64) >= self.prob:
                return False
        return True

    def to_json(self) -> dict:
        return dataclasses.asdict(self)


class FaultFS:
    """The injector the :func:`fps_tpu_torch.core.retry.fault_check` seam
    consults. Deterministic per-(class, op) counters; thread-safe (the
    async checkpoint writer, the fleet pollers, and the training thread
    all cross the seams concurrently). ``injected`` accumulates an
    evidence trail ``(class, op, n, fault, basename)`` the scenarios
    assert on."""

    def __init__(self, rules, *, seed: int = 0, sleep=time.sleep):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}
        self.injected: list[tuple] = []
        # Pre-rename shadows for "stale": path -> shadow copy of the
        # content that was live at the last faulted-window replace.
        self._shadow_dir: str | None = None
        self._shadows: dict[str, str] = {}
        self._shadow_seq = 0
        self._wants_stale = any(r.fault == "stale" for r in self.rules)

    # -- seam entry ---------------------------------------------------------

    def check(self, op: str, cls: str, path: str):
        with self._lock:
            n = self._counts.get((cls, op), 0)
            self._counts[(cls, op)] = n + 1
            rule = next((r for r in self.rules
                         if r.matches(cls, op, n, self.seed)), None)
            if rule is not None:
                self.injected.append(
                    (cls, op, n, rule.fault, os.path.basename(path)))
        if self._wants_stale and op == "replace":
            # Capture the pre-rename content so a later "stale" read
            # can serve it — whether or not THIS replace is itself
            # faulted. Outside the lock: copying a multi-MB snapshot
            # under it would serialize every plane behind the copy.
            self._capture_shadow(path)
        if rule is None:
            return None
        # Side effects OUTSIDE the lock: sleeping under it would
        # serialize every plane behind one injected latency.
        if rule.fault == "delay":
            self._sleep(rule.delay_s)
            return None
        if rule.fault == "errno":
            if rule.delay_s > 0:
                self._sleep(rule.delay_s)
            code = getattr(_errno, rule.errno_name)
            raise OSError(code, f"faultfs injected {rule.errno_name}",
                          path)
        if rule.fault == "torn":
            return "torn"
        # "stale": redirect reads to the pre-rename shadow when one was
        # captured; a not-yet-shadowed path degrades to the transient
        # ENOENT form of the same failure (the rename not visible yet).
        shadow = self._shadows.get(os.path.abspath(path))
        if shadow is not None and os.path.exists(shadow):
            return ("redirect", shadow)
        raise OSError(_errno.ENOENT,
                      "faultfs injected stale read (no shadow)", path)

    def _capture_shadow(self, path: str) -> None:
        try:
            if not os.path.exists(path):
                return
            with self._lock:
                if self._shadow_dir is None:
                    self._shadow_dir = tempfile.mkdtemp(
                        prefix="faultfs-")
                self._shadow_seq += 1
                name = f"{self._shadow_seq}-{os.path.basename(path)}"
                shadow = os.path.join(self._shadow_dir, name)
            # The copy itself runs UNLOCKED (see check()); only the
            # bookkeeping takes the lock, and the unique sequence
            # number keeps concurrent captures from clobbering.
            shutil.copyfile(path, shadow)
            with self._lock:
                self._shadows[os.path.abspath(path)] = shadow
        except OSError:
            pass  # best-effort: stale degrades to transient ENOENT

    # -- evidence -----------------------------------------------------------

    def injected_counts(self) -> dict:
        """``{(class, op, fault): n}`` totals — scenario evidence."""
        out: dict[tuple, int] = {}
        with self._lock:
            for cls, op, _, fault, _ in self.injected:
                key = (cls, op, fault)
                out[key] = out.get(key, 0) + 1
        return out

    def quiesce(self) -> None:
        """Drop every rule (storage 'recovers') while keeping counters
        and the evidence trail — the recovery half of a brownout."""
        self.rules = ()

    def close(self) -> None:
        if self._shadow_dir is not None:
            shutil.rmtree(self._shadow_dir, ignore_errors=True)
            self._shadow_dir = None

    # -- (de)serialization (the cross-process env contract) -----------------

    def to_spec(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_json() for r in self.rules]})

    def to_env(self, env: dict | None = None) -> dict:
        env = dict(os.environ if env is None else env)
        env[FAULTFS_ENV] = self.to_spec()
        return env

    @classmethod
    def from_spec(cls, spec: str) -> "FaultFS":
        """Build from a JSON spec string or a path to a spec file (the
        two forms ``FPS_TPU_FAULTFS`` accepts)."""
        text = spec
        if not spec.lstrip().startswith("{"):
            with open(spec, encoding="utf-8") as f:
                text = f.read()
        obj = json.loads(text)
        return cls([FaultRule(**r) for r in obj.get("rules", ())],
                   seed=int(obj.get("seed", 0)))


def install(rules, *, seed: int = 0, sleep=time.sleep) -> FaultFS:
    """Build + install a :class:`FaultFS` as the process injector."""
    from fps_tpu_torch.core import retry as _retry

    fs = FaultFS(rules, seed=seed, sleep=sleep)
    _retry.install_injector(fs)
    return fs


def uninstall() -> None:
    from fps_tpu_torch.core import retry as _retry

    inj = _retry.get_injector()
    _retry.remove_injector()
    if inj is not None and hasattr(inj, "close"):
        inj.close()
