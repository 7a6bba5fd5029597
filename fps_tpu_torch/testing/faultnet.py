"""faultnet — deterministic, seed-replayable NETWORK fault injection.

The port's copy of ``fps_tpu/testing/faultnet.py``: the same rules, the
same ``FPS_TPU_FAULTNET`` schedule format and the same sha256-seeded
decisions, so one schedule faults both packages' wires alike. It installs
into the port's seams (:mod:`fps_tpu_torch.core.retry`) only.

The hostile-network half of the chaos harness (``docs/resilience.md``
"Hostile network"), and the exact sibling of
:mod:`fps_tpu_torch.testing.faultfs`: :class:`FaultNet` interposes on the
framework's socket operations through the
:func:`fps_tpu_torch.core.retry.net_fault_check` seam (client connect/send/
recv in :class:`~fps_tpu_torch.serve.wire.WireClient`, server accept/send in
:class:`~fps_tpu_torch.serve.net.TcpServe`) — NEVER by global monkeypatching,
so only the framework's own wire traffic is ever faulted. Schedules are
stated in the wire plane's vocabulary: *peer classes* (``serve`` for
query traffic, ``fleet`` for reader-side sockets) crossed with
*operations* (``connect`` / ``accept`` / ``send`` / ``recv``).

Fault types (:class:`NetFaultRule.fault`):

* ``"refuse"``    — connect seams raise ``ConnectionRefusedError``
  (server down / port closed);
* ``"reset"``     — raise ``ConnectionResetError`` (peer died
  mid-conversation);
* ``"delay"``     — sleep ``delay_s`` before the operation proceeds
  (congested path, slow peer);
* ``"cut"``       — send seams transmit only ``cut_bytes`` of the frame
  and then drop the connection: the torn-frame producer the framing
  CRC/length gates must catch;
* ``"partition"`` — recv seams raise ``TimeoutError`` (a one-way
  partition: our bytes leave, theirs never arrive);
* ``"drop"``      — accept seams close the fresh connection unserved
  (SYN accepted, then silence);
* ``"trickle"``   — send seams emit the frame ``chunk`` bytes at a time
  with ``delay_s`` between chunks (slow-peer byte-trickle that holds a
  naive reader hostage).

Scheduling is **per (peer_class, op) operation count**, identical to
faultfs: each matching operation increments a deterministic counter and
a rule fires for counts in ``[start, start + count)`` hitting
``every``-th occurrence (``count=None`` = forever); an optional ``prob``
is still REPLAYABLE via ``sha256(seed, class, op, n)``. Same seed, same
op stream, same faults, every run — the determinism the bit-identity
chaos assertions stand on.

Cross-process: :meth:`FaultNet.to_env` serializes the schedule into
``FPS_TPU_FAULTNET`` and :func:`fps_tpu_torch.core.retry.get_net_injector`
self-installs it lazily in any child (supervised training children,
torch-free serving processes).

Stdlib-only, like the seams it feeds.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import hashlib
import json
import os
import threading
import time

__all__ = ["NetFaultRule", "FaultNet", "install", "uninstall"]

# Mirror of fps_tpu_torch.core.retry.FAULTNET_ENV (this module must stay
# loadable by file path with zero package imports — the env-activation
# path in retry.get_net_injector does exactly that; mirror-tested).
FAULTNET_ENV = "FPS_TPU_FAULTNET"

OPS = ("connect", "accept", "send", "recv")
FAULTS = ("refuse", "reset", "delay", "cut", "partition", "drop",
          "trickle")

# Which ops each fault makes sense on; a rule targeting an op its fault
# cannot express is a schedule bug, rejected at construction.
_FAULT_OPS = {
    "refuse": ("connect",),
    "reset": ("connect", "send", "recv"),
    "delay": OPS,
    "cut": ("send",),
    "partition": ("recv",),
    "drop": ("accept",),
    "trickle": ("send",),
}


@dataclasses.dataclass(frozen=True)
class NetFaultRule:
    """One scheduled wire fault: which (peer_class, op) stream it
    targets and which occurrences it hits. ``peer_class``/``op`` accept
    ``"*"`` (a ``"*"`` op is only legal for faults valid on every op,
    i.e. ``delay``)."""

    peer_class: str
    op: str
    fault: str
    delay_s: float = 0.0
    cut_bytes: int = 8
    chunk: int = 1
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
        legal = _FAULT_OPS[self.fault]
        if self.op == "*":
            if legal != OPS:
                raise ValueError(
                    f"fault {self.fault!r} only applies to ops {legal}; "
                    f"op='*' is ambiguous")
        elif self.op not in legal:
            raise ValueError(
                f"fault {self.fault!r} cannot fire on op {self.op!r} "
                f"(legal: {legal})")
        if self.every < 1:
            raise ValueError(f"every must be >= 1, got {self.every}")
        if not 0.0 < self.prob <= 1.0:
            raise ValueError(f"prob must be in (0, 1], got {self.prob}")
        if self.cut_bytes < 0 or self.chunk < 1:
            raise ValueError("cut_bytes must be >= 0 and chunk >= 1")

    def matches(self, cls: str, op: str, n: int, seed: int) -> bool:
        """Does this rule fire for occurrence ``n`` (0-based) of
        ``(cls, op)``? Pure function of the schedule — replayable."""
        if self.peer_class != "*" and self.peer_class != cls:
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


class FaultNet:
    """The injector the :func:`fps_tpu_torch.core.retry.net_fault_check` seam
    consults. Deterministic per-(class, op) counters; thread-safe (the
    server's accept/handler threads and any number of client threads
    cross the seams concurrently). ``injected`` accumulates an evidence
    trail ``(class, op, n, fault)`` the scenarios assert on."""

    def __init__(self, rules, *, seed: int = 0, sleep=time.sleep):
        self.rules = tuple(rules)
        self.seed = int(seed)
        self._sleep = sleep
        self._lock = threading.Lock()
        self._counts: dict[tuple, int] = {}
        self.injected: list[tuple] = []

    # -- seam entry ---------------------------------------------------------

    def check(self, op: str, cls: str):
        with self._lock:
            n = self._counts.get((cls, op), 0)
            self._counts[(cls, op)] = n + 1
            rule = next((r for r in self.rules
                         if r.matches(cls, op, n, self.seed)), None)
            if rule is not None:
                self.injected.append((cls, op, n, rule.fault))
        if rule is None:
            return None
        # Side effects OUTSIDE the lock: sleeping under it would
        # serialize every connection behind one injected latency.
        if rule.fault == "delay":
            self._sleep(rule.delay_s)
            return None
        if rule.fault == "refuse":
            raise ConnectionRefusedError(
                _errno.ECONNREFUSED, "faultnet injected connection "
                f"refused ({cls}/{op} #{n})")
        if rule.fault == "reset":
            if rule.delay_s > 0:
                self._sleep(rule.delay_s)
            raise ConnectionResetError(
                _errno.ECONNRESET,
                f"faultnet injected connection reset ({cls}/{op} #{n})")
        if rule.fault == "partition":
            if rule.delay_s > 0:
                self._sleep(rule.delay_s)
            raise TimeoutError(
                f"faultnet injected one-way partition ({cls}/{op} #{n})")
        if rule.fault == "cut":
            return ("cut", rule.cut_bytes)
        if rule.fault == "trickle":
            return ("trickle", rule.chunk, rule.delay_s)
        return "drop"  # accept seams close the connection unserved

    # -- evidence -----------------------------------------------------------

    def injected_counts(self) -> dict:
        """``{(class, op, fault): n}`` totals — scenario evidence."""
        out: dict[tuple, int] = {}
        with self._lock:
            for cls, op, _, fault in self.injected:
                key = (cls, op, fault)
                out[key] = out.get(key, 0) + 1
        return out

    def trail(self) -> list[tuple]:
        """A snapshot copy of the evidence trail (determinism tests
        compare two runs' trails for equality)."""
        with self._lock:
            return list(self.injected)

    def quiesce(self) -> None:
        """Drop every rule (the network 'heals') while keeping counters
        and the evidence trail — the recovery half of a brownout."""
        self.rules = ()

    def close(self) -> None:
        pass  # symmetric with FaultFS.close for uninstall()

    # -- (de)serialization (the cross-process env contract) -----------------

    def to_spec(self) -> str:
        return json.dumps({"seed": self.seed,
                           "rules": [r.to_json() for r in self.rules]})

    def to_env(self, env: dict | None = None) -> dict:
        env = dict(os.environ if env is None else env)
        env[FAULTNET_ENV] = self.to_spec()
        return env

    @classmethod
    def from_spec(cls, spec: str) -> "FaultNet":
        """Build from a JSON spec string or a path to a spec file (the
        two forms ``FPS_TPU_FAULTNET`` accepts)."""
        text = spec
        if not spec.lstrip().startswith("{"):
            with open(spec, encoding="utf-8") as f:
                text = f.read()
        obj = json.loads(text)
        return cls([NetFaultRule(**r) for r in obj.get("rules", ())],
                   seed=int(obj.get("seed", 0)))


def install(rules, *, seed: int = 0, sleep=time.sleep) -> FaultNet:
    """Build + install a :class:`FaultNet` as the process net injector."""
    from fps_tpu_torch.core import retry as _retry

    net = FaultNet(rules, seed=seed, sleep=sleep)
    _retry.install_net_injector(net)
    return net


def uninstall() -> None:
    from fps_tpu_torch.core import retry as _retry

    inj = _retry.get_net_injector()
    _retry.remove_net_injector()
    if inj is not None and hasattr(inj, "close"):
        inj.close()
