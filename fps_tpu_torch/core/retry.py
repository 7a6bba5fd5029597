"""Bounded retry/backoff + the storage fault-injection seam.

The port's own copy of ``fps_tpu/core/retry.py`` (stdlib only): the same
policies, the same errno classes, the same path classes and the same
``FPS_TPU_FAULTFS`` schedule format, so one fault schedule serves both
packages. The injector is this module's own global: installing one into
the JAX package's seams leaves the port's untouched, and the other way
round.

Everything coordination-critical in this framework — snapshot chains,
the LSM compactor, the pod lease/fence, tiering sidecars, the fleet
step fence — lives on ONE shared filesystem. The chaos model used to
kill processes and tear files; a *misbehaving* filesystem (ENOSPC, EIO,
slow writes, stale NFS-style reads, vanishing dirents) needs two more
pieces, both here:

* :class:`RetryPolicy` — errno classification (retryable vs fatal),
  bounded deterministic exponential backoff with seeded
  jitter, and a deadline cap; :func:`call_with_retry` drives it. The
  write planes (checkpoint publishes, compaction, sidecars) retry
  transient errors and then DEGRADE (skip the publish, burn a
  staleness budget) instead of crashing training; the read planes
  (watcher/fleet polls) degrade immediately to last-good state.
* the **fault seam** — :func:`fault_check` is called by every
  framework file-operation site (``_atomic_savez``, snapshot reads,
  lease/fence writes, sidecar writes, directory scans) with an
  ``(op, path)`` pair. An installed injector
  (:mod:`fps_tpu_torch.testing.faultfs`) classifies the path
  (:func:`classify_path`) and may raise an ``OSError``, sleep
  (latency), or return a directive the seam honors (``"torn"`` for a
  torn rename, ``("redirect", shadow)`` for a stale
  read-after-rename). With no injector installed the seam is one
  attribute read — zero cost in production.

Stdlib-only by contract, like the reference's: it loads by file path in
a process that has neither torch nor numpy.
"""

from __future__ import annotations

import dataclasses
import errno as _errno
import hashlib
import os
import re
import time

__all__ = [
    "RETRYABLE_ERRNOS", "FATAL_ERRNOS", "classify_error",
    "RetryPolicy", "call_with_retry", "DEFAULT_PUBLISH_RETRY",
    "classify_path", "fault_check", "read_path", "install_injector",
    "remove_injector", "get_injector", "FAULTFS_ENV",
    "RETRYABLE_NET_ERRNOS", "classify_net", "DEFAULT_NET_RETRY",
    "net_fault_check", "install_net_injector", "remove_net_injector",
    "get_net_injector", "FAULTNET_ENV",
]

# ---------------------------------------------------------------------------
# Errno classification.
# ---------------------------------------------------------------------------

# Transient-environment errnos: the operation may succeed if simply
# retried (disk pressure clears, the NFS server answers, the dirent
# becomes visible). ENOENT is retryable by design — on a hostile shared
# filesystem a just-renamed file can be transiently invisible to a
# sibling host; callers for whom a missing file is a REAL terminal
# condition (a pinned-but-gc'd checkpoint) do not route through
# call_with_retry at all.
RETRYABLE_ERRNOS = frozenset({
    _errno.ENOSPC, _errno.EIO, _errno.ETIMEDOUT, _errno.EAGAIN,
    _errno.ENOENT, _errno.ESTALE, _errno.EINTR, _errno.EBUSY,
    _errno.EDQUOT,
})

# Permanent-environment errnos: retrying cannot help (a read-only or
# mispermissioned mount needs an operator, not a backoff loop) — these
# must surface immediately and loudly.
FATAL_ERRNOS = frozenset({
    _errno.EACCES, _errno.EROFS, _errno.EPERM, _errno.ENOTDIR,
    _errno.EISDIR, _errno.ENAMETOOLONG, _errno.ENODEV, _errno.ENXIO,
})


def classify_error(err: BaseException) -> str:
    """``"retryable"`` or ``"fatal"`` for one exception. Only OSErrors
    with a known-transient errno are retryable; everything else —
    fatal errnos, unknown errnos, and non-OSError exceptions (a pod
    fence refusal, a corruption error) — is fatal: retrying an error we
    do not understand hides bugs behind latency."""
    if isinstance(err, OSError) and err.errno in RETRYABLE_ERRNOS:
        return "retryable"
    return "fatal"


# The wire plane's transient errnos: a refused/reset/unreachable peer
# or a timed-out socket may answer on the next attempt (the server is
# restarting, a partition is healing, a kernel buffer drained). These
# are DISJOINT in spirit from the filesystem set above — a serve client
# must never treat EACCES-on-connect as transient.
RETRYABLE_NET_ERRNOS = frozenset({
    _errno.ECONNREFUSED, _errno.ECONNRESET, _errno.ECONNABORTED,
    _errno.EPIPE, _errno.ETIMEDOUT, _errno.EAGAIN, _errno.EINTR,
    _errno.EHOSTUNREACH, _errno.ENETUNREACH, _errno.ENETDOWN,
    _errno.ENETRESET, _errno.EADDRNOTAVAIL,
})


def classify_net(err: BaseException) -> str:
    """The wire twin of :func:`classify_error`: ``"retryable"`` or
    ``"fatal"`` for one network exception. Retryable: socket timeouts
    (``TimeoutError`` covers ``socket.timeout`` since 3.10), the
    connection-lifecycle OSError subclasses (refused / reset / aborted /
    broken pipe — the peer may be mid-restart), and OSErrors carrying a
    transient network errno. ``EOFError``/``ConnectionError`` raised by
    a framing layer on a half-closed peer is retryable for the same
    reason: reconnect-and-resend (with idempotent request ids) is the
    correct response. Everything else — protocol violations, CRC
    failures, application errors — is fatal: retrying a malformed
    conversation hides bugs behind latency."""
    if isinstance(err, TimeoutError):
        return "retryable"
    if isinstance(err, (ConnectionError, EOFError)):
        # ConnectionRefusedError/ConnectionResetError/BrokenPipeError/
        # ConnectionAbortedError plus the bare ConnectionError a client
        # raises on an empty read (peer closed mid-conversation).
        return "retryable"
    if isinstance(err, OSError) and err.errno in RETRYABLE_NET_ERRNOS:
        return "retryable"
    return "fatal"


# ---------------------------------------------------------------------------
# Bounded deterministic retry.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class RetryPolicy:
    """Bounded exponential backoff with deterministic seeded jitter.

    ``retries`` transient failures are retried (``retries + 1`` attempts
    total); backoff for attempt ``i`` is ``base_s * factor**i`` capped at
    ``max_backoff_s``, stretched by up to ``jitter`` fraction via the
    sha256 scheme — seeded by ``seed`` so a given process retries
    on a REPLAYABLE schedule while distinct seeds (per host/plane)
    desynchronize, instead of stampeding the shared filesystem in
    lockstep. ``deadline_s`` caps total time inside one
    :func:`call_with_retry` (attempts + sleeps): a slow-but-failing
    filesystem must not hold a boundary hostage for minutes."""

    retries: int = 3
    base_s: float = 0.02
    factor: float = 2.0
    max_backoff_s: float = 1.0
    jitter: float = 0.25
    deadline_s: float | None = 20.0
    seed: str = ""

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError(f"retries must be >= 0, got {self.retries}")
        if self.base_s < 0 or self.factor < 1.0:
            raise ValueError("base_s must be >= 0 and factor >= 1.0")
        if not 0.0 <= self.jitter:
            raise ValueError(f"jitter must be >= 0, got {self.jitter}")

    def backoff_s(self, attempt: int) -> float:
        """Deterministic backoff before retry ``attempt`` (0-based)."""
        base = min(self.base_s * self.factor ** attempt,
                   self.max_backoff_s)
        if self.jitter <= 0.0 or base <= 0.0:
            return base
        h = hashlib.sha256(
            f"{self.seed}:{attempt}".encode()).digest()
        frac = int.from_bytes(h[:8], "big") / float(1 << 64)
        return base * (1.0 + self.jitter * frac)


# The write-plane default: worst case ~0.14s of backoff — negligible
# beside a real serialize+fsync, generous against one transient blip.
DEFAULT_PUBLISH_RETRY = RetryPolicy(retries=3, base_s=0.02,
                                    max_backoff_s=0.25, deadline_s=10.0)

# The wire-plane default: more retries than the write plane (a serve
# request is cheap to resend and the request-id dedupe makes resends
# idempotent) but a tighter per-call deadline — a query client must
# degrade to "serving unavailable" in seconds, not hold a bench or a
# reader hostage for the filesystem plane's 10s.
DEFAULT_NET_RETRY = RetryPolicy(retries=5, base_s=0.02,
                                max_backoff_s=0.5, deadline_s=5.0)


def call_with_retry(fn, *, policy: RetryPolicy, op: str = "",
                    on_retry=None, classify=classify_error,
                    clock=time.monotonic, sleep=time.sleep):
    """Run ``fn()`` under ``policy``: transient failures retry with
    backoff until the retry budget or the deadline is exhausted, then
    the LAST error re-raises unchanged (the caller's degrade logic sees
    the real errno). Fatal errors re-raise immediately. ``on_retry``
    (optional ``fn(attempt, err, delay_s)``) is the telemetry hook."""
    t0 = clock()
    attempt = 0
    while True:
        try:
            return fn()
        except BaseException as e:  # noqa: BLE001 — classified below
            if classify(e) != "retryable" or attempt >= policy.retries:
                raise
            delay = policy.backoff_s(attempt)
            if (policy.deadline_s is not None
                    and clock() - t0 + delay > policy.deadline_s):
                raise
            if on_retry is not None:
                on_retry(attempt, e, delay)
            sleep(delay)
            attempt += 1


# ---------------------------------------------------------------------------
# Path classification (which plane an operation belongs to).
# ---------------------------------------------------------------------------

# Ordered: first match wins. Classes are the fault injector's targeting
# unit — a schedule against "lease" can never hit a snapshot publish.
_PATH_CLASSES = (
    ("lease", re.compile(r"pod_lease\.json")),
    ("fence", re.compile(
        r"pod_fence\.json|serve_fence\.json|ready_.*\.json")),
    ("sidecar", re.compile(r"tiering-\d+\.npz(\.tmp\.npz)?")),
    ("control", re.compile(
        r"pod_control\.json|pod_state\.json|supervisor_state\.json")),
    ("journal", re.compile(r"(journal|events)-.*\.jsonl")),
    ("liveness", re.compile(r"heartbeat_.*\.json")),
    ("snapshot", re.compile(
        r"ckpt_\d+\.npz|delta_\d+_\d+\.npz|.*\.tmp\.npz|.*\.corrupt")),
)


def classify_path(path: str) -> str:
    """The storage plane ``path`` belongs to: ``lease`` / ``fence`` /
    ``sidecar`` / ``control`` / ``journal`` / ``liveness`` /
    ``snapshot`` / ``other``. Matches on the basename only —
    directories never change a file's plane."""
    name = os.path.basename(path.rstrip("/\\"))
    for cls, pat in _PATH_CLASSES:
        if pat.fullmatch(name):
            return cls
    if os.path.splitext(name)[1] == "":
        # A bare directory operand (listdir seams) classifies by any
        # plane-marker file it could hold — callers pass the dir of
        # snapshots, so default the extension-free case to snapshot.
        return "snapshot"
    return "other"


# ---------------------------------------------------------------------------
# The fault seam.
# ---------------------------------------------------------------------------

FAULTFS_ENV = "FPS_TPU_FAULTFS"

_injector = None
_env_checked = False


def install_injector(inj) -> None:
    """Install ``inj`` as the process-global fault injector. The
    injector's ``check(op, path_class, path)`` is called by every seam;
    see :mod:`fps_tpu_torch.testing.faultfs` for the implementation.
    Passing None uninstalls."""
    global _injector
    _injector = inj


def remove_injector() -> None:
    install_injector(None)


def get_injector():
    """The installed injector, activating the :data:`FAULTFS_ENV`
    contract lazily on first call: a subprocess launched with
    ``FPS_TPU_FAULTFS=<json-or-path>`` self-installs the described
    schedule (the chaos scenarios' cross-process hook) without any
    caller wiring. Returns None when no injector is configured."""
    global _env_checked, _injector
    if _injector is None and not _env_checked:
        _env_checked = True
        spec = os.environ.get(FAULTFS_ENV)
        if spec:
            _injector = _load_env_injector(spec)
    return _injector


def _load_env_injector(spec: str):
    """Build a FaultFS from the env spec — faultfs.py loaded by FILE
    path (it is stdlib-only, like this module). The port's own FaultFS,
    never the JAX package's: a process that has loaded both packages
    keeps their injectors apart."""
    import importlib.util as _ilu
    import sys as _sys

    mod = _sys.modules.get("fps_tpu_torch.testing.faultfs")
    if mod is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "testing", "faultfs.py")
        ld = _ilu.spec_from_file_location("_fps_torch_faultfs", path)
        mod = _ilu.module_from_spec(ld)
        _sys.modules[ld.name] = mod
        ld.loader.exec_module(mod)
    return mod.FaultFS.from_spec(spec)


def read_path(path: str) -> str:
    """The read seam in path form: run :func:`fault_check` for a read
    of ``path`` and return the EFFECTIVE path — the injector's
    pre-rename shadow under a ``("redirect", shadow)`` directive (the
    stale NFS read), else ``path`` unchanged. One shared helper so the
    checkpoint, snapshot-format, and fleet read sites cannot drift."""
    directive = fault_check("read", path)
    if isinstance(directive, tuple) and directive[0] == "redirect":
        return directive[1]
    return path


def fault_check(op: str, path: str, *, path_class: str | None = None):
    """The seam: called immediately before a framework file operation.
    ``op`` is one of ``write`` / ``fsync`` / ``replace`` / ``read`` /
    ``listdir`` / ``remove``. With no injector installed this is one
    module-attribute read. An injector may raise an ``OSError``
    (injected errno), sleep (injected latency), or return a directive:
    ``"torn"`` (rename seams publish a truncated file and fail) or
    ``("redirect", shadow_path)`` (read seams read pre-rename content —
    the stale NFS read). Seams that get a directive they do not
    implement ignore it."""
    inj = _injector if _injector is not None else get_injector()
    if inj is None:
        return None
    return inj.check(op, path_class or classify_path(path), path)


# ---------------------------------------------------------------------------
# The network fault seam (the wire twin of the above).
# ---------------------------------------------------------------------------

FAULTNET_ENV = "FPS_TPU_FAULTNET"

_net_injector = None
_net_env_checked = False


def install_net_injector(inj) -> None:
    """Install ``inj`` as the process-global NETWORK fault injector.
    Its ``check(op, peer_class)`` is consulted by every socket seam
    of the serving plane (:mod:`fps_tpu_torch.serve.wire` /
    :mod:`fps_tpu_torch.serve.net`); see
    :mod:`fps_tpu_torch.testing.faultnet` for the implementation.
    Passing None uninstalls."""
    global _net_injector
    _net_injector = inj


def remove_net_injector() -> None:
    install_net_injector(None)


def get_net_injector():
    """The installed network injector, activating the
    :data:`FAULTNET_ENV` contract lazily on first call — a subprocess
    launched with ``FPS_TPU_FAULTNET=<json-or-path>`` self-installs the
    described schedule, exactly like the faultfs env hook. Returns None
    when no injector is configured."""
    global _net_env_checked, _net_injector
    if _net_injector is None and not _net_env_checked:
        _net_env_checked = True
        spec = os.environ.get(FAULTNET_ENV)
        if spec:
            _net_injector = _load_env_net_injector(spec)
    return _net_injector


def _load_env_net_injector(spec: str):
    """Build a FaultNet from the env spec — faultnet.py loaded by FILE
    path (stdlib-only, like this module), so env activation works in
    torch-free serving processes. The port's own FaultNet, never the JAX
    package's."""
    import importlib.util as _ilu
    import sys as _sys

    mod = _sys.modules.get("fps_tpu_torch.testing.faultnet")
    if mod is None:
        path = os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "testing", "faultnet.py")
        ld = _ilu.spec_from_file_location("_fps_torch_faultnet", path)
        mod = _ilu.module_from_spec(ld)
        _sys.modules[ld.name] = mod
        ld.loader.exec_module(mod)
    return mod.FaultNet.from_spec(spec)


def net_fault_check(op: str, peer_class: str):
    """The wire seam: called immediately before a framework socket
    operation. ``op`` is one of ``connect`` / ``accept`` / ``send`` /
    ``recv``; ``peer_class`` names which conversation the socket
    belongs to (``"serve"`` for query traffic, ``"fleet"`` for
    reader-side sockets — the injector's targeting unit, like
    faultfs's path classes). With no injector installed this is one
    module-attribute read. An injector may raise (connect-refused,
    reset), sleep (read/write delay), or return a directive the seam
    honors: ``("cut", nbytes)`` — send only a prefix then drop the
    connection, the torn-frame producer; ``("trickle", chunk, delay_s)``
    — slow-peer byte-trickle; ``"drop"`` — accept seams close the
    connection unserved (one-way partition). Seams that get a directive
    they do not implement ignore it."""
    inj = (_net_injector if _net_injector is not None
           else get_net_injector())
    if inj is None:
        return None
    return inj.check(op, peer_class)
