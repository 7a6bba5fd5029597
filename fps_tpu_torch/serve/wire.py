"""Versioned, length-prefixed binary framing for the serve wire.

The filesystem planes have a fault model (``core/retry.py``); this
module is the same discipline for the WIRE plane. The line-JSON transport in
:mod:`fps_tpu_torch.serve.net` had no integrity or liveness story: a peer
dying mid-write hands the reader half a JSON line, a slow peer holds a
blocking ``readline`` hostage forever, and a reconnecting client cannot
tell whether its in-flight request executed. Framing fixes all three:

``frame := header(20B) || payload || crc32(header || payload)(4B)``
``header := magic(4s) | version(u16) | op(u8) | flags(u8) |``
``          req_id(u64) | payload_len(u32)``   (network byte order)

* **magic** — ``\\xabFPS``; the first byte is deliberately outside
  ASCII, so a stray legacy line-JSON peer (whose bytes always start
  ``{`` or whitespace) fails the magic gate on its FIRST frame and is
  rejected loudly — the dual-stack peek that once routed such
  peers to a compat loop is retired (``docs/serving.md``).
* **version** — negotiated by a HELLO exchange: the client offers its
  versions, the server picks the highest common one or rejects LOUDLY
  (:class:`ProtocolVersionError`), never guesses.
* **req_id** — client-assigned, monotone per session, REUSED across
  retries of the same logical request: the server's replay cache keyed
  on ``(session, req_id)`` makes reconnect-resend idempotent (a retry
  of an already-executed request replays the cached response instead
  of executing twice).
* **crc32 + length** — a torn frame (peer died mid-write, injected
  ``cut`` fault) is detected by short read or checksum mismatch and
  rejected as :class:`TornFrameError` with the failing layer named;
  it is NEVER decoded and never poisons the stream. Oversized length
  prefixes (corruption or abuse) reject as
  :class:`FrameTooLargeError` before any allocation.

:class:`WireClient` is the failure-aware client: per-request deadline
budgets, bounded retry with the sha256-jittered backoff
(:func:`fps_tpu_torch.core.retry.classify_net` decides transient vs fatal),
reconnect-with-backoff that re-handshakes under the SAME session id
and resends under the SAME req_id (the dedupe key), and honest
accounting (``net.retries`` / ``net.reconnects`` /
``net.deadline_exceeded`` through the obs registry when a recorder is
wired, plus plain attributes for tests).

Payloads are JSON (the request/response dicts of
:func:`fps_tpu_torch.serve.net.handle_request`, unchanged) — the framing adds
integrity and liveness, not a new schema language.

Stdlib-only by contract: the torch-free serving CLI
(``fps_tpu_torch/examples/serve.py``) and any login-node client import
this module without torch or numpy. The frames are the JAX package's
byte for byte: a client of either package talks to a server of the
other.
"""

from __future__ import annotations

import binascii
import io
import json
import os
import socket
import struct
import threading
import time
import zlib

from fps_tpu_torch.core.retry import (DEFAULT_NET_RETRY, classify_net,
                                net_fault_check)

__all__ = [
    "PROTO_VERSION", "MAGIC", "MAX_PAYLOAD",
    "OP_HELLO", "OP_HELLO_OK", "OP_REQ", "OP_RESP", "OP_BUSY", "OP_ERR",
    "CAP_MULTI", "CAP_BIN", "CAP_CRC_LIGHT", "SUPPORTED_CAPS",
    "DEFAULT_CLIENT_CAPS", "FLAG_BIN", "FLAG_CRC_LIGHT",
    "CRC_LIGHT_THRESHOLD",
    "Frame", "WireError", "TornFrameError", "FrameTooLargeError",
    "ProtocolVersionError", "ServerBusyError",
    "encode_frame", "encode_frame_parts", "decode_frame", "read_frame",
    "pack_bin_payload", "split_bin_payload", "decode_bin_response",
    "WireClient",
]

MAGIC = b"\xabFPS"
PROTO_VERSION = 1
SUPPORTED_VERSIONS = (1,)
# Length-prefix cap: the largest legitimate payload (a dense topk over
# a big batch) is well under a MiB; 16 MiB rejects corrupt/hostile
# prefixes before any allocation.
MAX_PAYLOAD = 16 << 20

# HELLO-negotiated CAPABILITIES (the version stays 1: capabilities are
# strictly additive, and a peer that never offers them gets the exact
# capability-less wire — old clients keep working against new servers and vice
# versa). The server replies with the intersection of what the client
# offered and what it supports; a capability is live on a session only
# when BOTH sides named it.
CAP_MULTI = "multi"          # batched multi-lookup op in one frame
CAP_BIN = "bin"              # binary row segments in responses (FLAG_BIN)
CAP_CRC_LIGHT = "crc_light"  # header-only CRC above CRC_LIGHT_THRESHOLD
SUPPORTED_CAPS = (CAP_MULTI, CAP_BIN, CAP_CRC_LIGHT)
# Clients offer only CAP_MULTI by default: binary responses change the
# response value types (ndarrays, NaN passthrough) and crc-light trades
# payload integrity for throughput — both are explicit opt-ins
# (loopback-trusted, throughput-hungry sessions like bench serve_scale).
DEFAULT_CLIENT_CAPS = (CAP_MULTI,)

# Frame flag bits (header ``flags`` byte).
FLAG_BIN = 0x01        # payload = u32 meta_len | meta json | raw segments
FLAG_CRC_LIGHT = 0x02  # CRC trailer covers the HEADER only (negotiated)

# Payloads at or below this size always carry the full CRC even on a
# crc-light session: integrity of small control/response frames is
# ~free, and the ~2% CRC tax only matters on MiB-scale batched rows.
CRC_LIGHT_THRESHOLD = 64 << 10

_HEADER = struct.Struct("!4sHBBQI")  # magic, version, op, flags, id, len
_CRC = struct.Struct("!I")

OP_HELLO = 1      # client -> server: version offer + session id
OP_HELLO_OK = 2   # server -> client: chosen version
OP_REQ = 3        # client -> server: one request envelope
OP_RESP = 4       # server -> client: one response
OP_BUSY = 5       # server -> client: load-shed, retry after backoff
OP_ERR = 6        # server -> client: protocol-level rejection


class WireError(Exception):
    """Base for protocol-layer failures."""


class TornFrameError(WireError, ConnectionError):
    """A frame that stopped mid-air or failed its checksum — short
    header, short payload, short CRC trailer, bad magic, or CRC
    mismatch. Subclasses ConnectionError deliberately: a torn frame
    means the CONNECTION is garbage (reconnect-and-resend is the
    correct response, and :func:`classify_net` already says so); the
    frame itself is never decoded."""


class FrameTooLargeError(WireError):
    """Length prefix beyond :data:`MAX_PAYLOAD` — corruption or abuse;
    fatal, never retried."""


class ProtocolVersionError(WireError):
    """No common protocol version (or a frame in an unknown version) —
    fatal: retrying cannot negotiate a version we do not speak."""


class ServerBusyError(WireError):
    """The server shed this request under admission control (OP_BUSY).
    Retryable WITHOUT reconnecting — the connection is healthy, the
    server is just full; :class:`WireClient` backs off and resends,
    surfacing this only when the deadline budget exhausts."""


class Frame:
    """One decoded frame. Plain attribute record (no numpy, no
    dataclass machinery — this sits on the per-request hot path)."""

    __slots__ = ("op", "req_id", "payload", "version", "flags")

    def __init__(self, op, req_id, payload, version=PROTO_VERSION,
                 flags=0):
        self.op = op
        self.req_id = req_id
        self.payload = payload
        self.version = version
        self.flags = flags

    def json(self) -> dict:
        return json.loads(self.payload)


def _dumps(obj) -> bytes:
    return json.dumps(obj, allow_nan=False).encode("utf-8")


def encode_frame(op: int, req_id: int, payload: bytes, *,
                 version: int = PROTO_VERSION, flags: int = 0) -> bytes:
    """Serialize one frame: header + payload + CRC32 trailer."""
    if len(payload) > MAX_PAYLOAD:
        raise FrameTooLargeError(
            f"payload {len(payload)} bytes exceeds cap {MAX_PAYLOAD}")
    head = _HEADER.pack(MAGIC, version, op, flags, req_id, len(payload))
    # Incremental CRC + single join: no full-payload concat copies on
    # the per-request hot path.
    crc = zlib.crc32(payload, zlib.crc32(head)) & 0xFFFFFFFF
    return b"".join((head, payload, _CRC.pack(crc)))


def _as_buf(part):
    """Normalize any C-contiguous buffer (bytes, memoryview, ndarray)
    to a flat byte view WITHOUT copying the underlying memory."""
    if isinstance(part, (bytes, bytearray)):
        return part
    mv = part if isinstance(part, memoryview) else memoryview(part)
    if mv.ndim != 1 or mv.format != "B":
        mv = mv.cast("B")
    return mv


def encode_frame_parts(op: int, req_id: int, parts, *,
                       version: int = PROTO_VERSION, flags: int = 0,
                       crc_light: bool = False) -> list:
    """Scatter-gather frame encoder: header + the caller's buffers +
    CRC trailer, returned as a LIST of buffers for ``socket.sendmsg``
    — row bytes gathered off the mmap'd tables go straight to the
    kernel, never joined into an intermediate payload copy (the
    zero-copy response path; :func:`send_frame` accepts the list).

    ``crc_light=True`` (only on sessions that negotiated
    :data:`CAP_CRC_LIGHT`, for payloads above
    :data:`CRC_LIGHT_THRESHOLD`) computes the trailer over the header
    alone and sets :data:`FLAG_CRC_LIGHT` — the length prefix and
    header stay guarded, the MiB-scale row bytes skip the CRC pass."""
    bufs = [_as_buf(p) for p in parts]
    total = sum(len(b) for b in bufs)
    if total > MAX_PAYLOAD:
        raise FrameTooLargeError(
            f"payload {total} bytes exceeds cap {MAX_PAYLOAD}")
    if crc_light:
        flags |= FLAG_CRC_LIGHT
    head = _HEADER.pack(MAGIC, version, op, flags, req_id, total)
    crc = zlib.crc32(head)
    if not (flags & FLAG_CRC_LIGHT):
        for b in bufs:
            crc = zlib.crc32(b, crc)
    return [head, *bufs, _CRC.pack(crc & 0xFFFFFFFF)]


def _read_exact(rfile, n: int, what: str) -> bytes:
    """Read exactly ``n`` bytes or reject the frame as torn, naming the
    layer that came up short (the truncation tests assert the reason)."""
    buf = rfile.read(n)
    if buf is None:
        buf = b""
    while len(buf) < n:
        more = rfile.read(n - len(buf))
        if not more:
            raise TornFrameError(
                f"torn frame: {what} truncated "
                f"({len(buf)}/{n} bytes)")
        buf += more
    return buf


def read_frame(rfile, *, allowed_versions=SUPPORTED_VERSIONS,
               allow_crc_light: bool = False):
    """Read one complete frame from a buffered binary stream.

    Returns None on clean EOF AT a frame boundary (zero bytes read);
    any partial frame raises :class:`TornFrameError` with the
    truncated layer named, an unknown version raises
    :class:`ProtocolVersionError`, an oversized length prefix raises
    :class:`FrameTooLargeError` — all BEFORE any payload is decoded.

    ``allow_crc_light`` accepts frames whose trailer CRCs the header
    only (:data:`FLAG_CRC_LIGHT`) — legal ONLY on sessions that
    negotiated :data:`CAP_CRC_LIGHT`; an unnegotiated crc-light frame
    is rejected as torn (a peer must not be able to opt itself out of
    integrity unilaterally)."""
    # Magic is validated from the first 4 bytes ALONE, before waiting
    # for the rest of the header: a non-wire peer (e.g. a retired
    # legacy line-JSON client) may send fewer bytes than a full header
    # and then wait for a reply — it must fail fast with a torn-frame
    # OP_ERR, not hang until the connection timeout reaps it.
    first = rfile.read(len(MAGIC))
    if not first:
        return None
    if len(first) < len(MAGIC):
        try:
            first += _read_exact(rfile, len(MAGIC) - len(first), "magic")
        except TornFrameError:
            raise TornFrameError(
                f"torn frame: header truncated "
                f"({len(first)}/{_HEADER.size} bytes)") from None
    if first != MAGIC:
        raise TornFrameError(
            f"torn frame: bad magic {first!r} (mid-stream desync or a "
            f"non-wire peer)")
    try:
        first += _read_exact(rfile, _HEADER.size - len(MAGIC), "header")
    except TornFrameError:
        raise TornFrameError(
            f"torn frame: header truncated "
            f"({len(first)}/{_HEADER.size} bytes)") from None
    _magic, version, op, flags, req_id, length = _HEADER.unpack(first)
    if version not in allowed_versions:
        raise ProtocolVersionError(
            f"unsupported protocol version {version} "
            f"(supported: {list(allowed_versions)})")
    if length > MAX_PAYLOAD:
        raise FrameTooLargeError(
            f"frame announces {length} payload bytes, cap {MAX_PAYLOAD}")
    payload = _read_exact(rfile, length, "payload") if length else b""
    (crc,) = _CRC.unpack(_read_exact(rfile, _CRC.size, "crc trailer"))
    if flags & FLAG_CRC_LIGHT:
        if not allow_crc_light:
            raise TornFrameError(
                "torn frame: crc-light flag on a session that did not "
                "negotiate it")
        want = zlib.crc32(first) & 0xFFFFFFFF
    else:
        want = zlib.crc32(payload, zlib.crc32(first)) & 0xFFFFFFFF
    if crc != want:
        raise TornFrameError(
            f"torn frame: crc mismatch (got {crc:#010x}, "
            f"want {want:#010x})")
    return Frame(op, req_id, payload, version, flags)


def decode_frame(data: bytes, *, allow_crc_light: bool = False):
    """Decode one frame from a complete byte string (tests and tools).
    Truncated input rejects exactly like a torn stream read."""
    fr = read_frame(io.BytesIO(data), allow_crc_light=allow_crc_light)
    if fr is None:
        raise TornFrameError("torn frame: empty input")
    return fr


# ---------------------------------------------------------------------------
# Binary (zero-copy) response payloads — FLAG_BIN.
#
# ``payload := meta_len(u32) || meta_json || seg_0 || seg_1 || ...``
# where ``meta = {"resp": <response dict with {"__seg__": i}
# placeholders>, "segs": [{"dtype", "shape", "nbytes"}, ...]}``. The
# server packs each segment as a memoryview over the fancy-index gather
# output (O(batch) rows, already a fresh buffer — the mmap'd table
# itself is never materialized); the client reconstructs ndarrays with
# ``np.frombuffer`` over payload slices. numpy stays a LAZY import on
# the client side: the stdlib-only import contract holds, and only
# sessions that negotiated CAP_BIN ever decode these.
# ---------------------------------------------------------------------------

_U32 = struct.Struct("!I")


def pack_bin_payload(resp: dict, segs) -> list:
    """Build the parts list for a FLAG_BIN payload: ``resp`` is the
    response dict with ``{"__seg__": i}`` placeholders, ``segs`` the
    matching buffers (ndarrays/memoryviews, C-contiguous). Returns
    buffers ready for :func:`encode_frame_parts` — segment bytes are
    referenced, not copied."""
    bufs = [_as_buf(s) for s in segs]
    descs = []
    for s, b in zip(segs, bufs):
        dt = getattr(s, "dtype", None)
        descs.append({
            "dtype": "B" if dt is None else str(getattr(dt, "str", dt)),
            "shape": list(getattr(s, "shape", (len(b),))),
            "nbytes": len(b)})
    meta = {"resp": resp, "segs": descs}
    mb = _dumps(meta)
    return [_U32.pack(len(mb)), mb, *bufs]


def split_bin_payload(payload) -> tuple[dict, list]:
    """Inverse of :func:`pack_bin_payload` framing: returns
    ``(meta, [seg memoryviews])`` — slices of the received payload,
    no copies."""
    mv = memoryview(payload)
    if len(mv) < _U32.size:
        raise TornFrameError("torn frame: bin payload shorter than its "
                             "meta length prefix")
    (mlen,) = _U32.unpack(mv[:_U32.size])
    end = _U32.size + mlen
    if end > len(mv):
        raise TornFrameError("torn frame: bin meta block truncated")
    meta = json.loads(bytes(mv[_U32.size:end]))
    segs, off = [], end
    for d in meta.get("segs", ()):
        n = int(d["nbytes"])
        if off + n > len(mv):
            raise TornFrameError("torn frame: bin segment truncated")
        segs.append(mv[off:off + n])
        off += n
    return meta, segs


def _resolve_segs(node, arrays):
    if isinstance(node, dict):
        if set(node) == {"__seg__"}:
            return arrays[int(node["__seg__"])]
        return {k: _resolve_segs(v, arrays) for k, v in node.items()}
    if isinstance(node, list):
        return [_resolve_segs(v, arrays) for v in node]
    return node


def decode_bin_response(payload) -> dict:
    """Decode a FLAG_BIN payload into the response dict, segment
    placeholders resolved to ndarrays (``np.frombuffer`` over payload
    slices — the copy happens only if the caller writes)."""
    import numpy as np  # lazy: only CAP_BIN sessions pay the import

    meta, segs = split_bin_payload(payload)
    arrays = [np.frombuffer(seg, dtype=np.dtype(d["dtype"])).reshape(
        d["shape"]) for seg, d in zip(segs, meta.get("segs", ()))]
    return _resolve_segs(meta["resp"], arrays)


# ---------------------------------------------------------------------------
# Seam-aware socket I/O (shared by client and server).
# ---------------------------------------------------------------------------

def _sendall_parts(sock, parts) -> None:
    """Scatter-gather sendall: one ``sendmsg`` (kernel writev) per
    <=512-buffer slice with partial-send continuation — the frame's
    header, row segments, and CRC trailer leave the process without
    ever being joined into one contiguous copy."""
    bufs = [b if isinstance(b, memoryview) else memoryview(b)
            for b in parts]
    i = 0
    while i < len(bufs):
        sent = sock.sendmsg(bufs[i:i + 512])  # IOV_MAX headroom
        while i < len(bufs) and sent >= len(bufs[i]):
            sent -= len(bufs[i])
            i += 1
        if sent:
            bufs[i] = bufs[i][sent:]


def send_frame(sock, data, peer_class: str,
               sleep=time.sleep) -> None:
    """Send one encoded frame through the :func:`net_fault_check` seam.
    ``data`` is either one contiguous frame (:func:`encode_frame`) or a
    parts LIST (:func:`encode_frame_parts` — scatter-gather, zero-copy).
    Honors the injector's directives: ``("cut", n)`` transmits only the
    first ``n`` bytes and kills the connection (the torn-frame
    producer); ``("trickle", chunk, delay_s)`` drips the frame out
    ``chunk`` bytes at a time (the slow peer)."""
    directive = net_fault_check("send", peer_class)
    if isinstance(data, (list, tuple)):
        if directive is None:
            _sendall_parts(sock, data)
            return
        # Fault path only (never the hot path): directives address byte
        # offsets, so flatten the parts to apply cut/trickle exactly.
        data = b"".join(bytes(p) if not isinstance(p, (bytes, bytearray))
                        else p for p in data)
    if directive is None:
        sock.sendall(data)
        return
    if isinstance(directive, tuple) and directive[0] == "cut":
        sock.sendall(data[:directive[1]])
        try:
            sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        raise ConnectionResetError(
            "faultnet cut the frame mid-send "
            f"({directive[1]}/{len(data)} bytes left the host)")
    if isinstance(directive, tuple) and directive[0] == "trickle":
        chunk, delay_s = int(directive[1]), float(directive[2])
        for i in range(0, len(data), chunk):
            sock.sendall(data[i:i + chunk])
            if delay_s > 0:
                sleep(delay_s)
        return
    sock.sendall(data)  # unknown directive: ignore, per seam contract


def recv_frame(rfile, peer_class: str, *,
               allowed_versions=SUPPORTED_VERSIONS,
               allow_crc_light: bool = False):
    """Read one frame through the seam (``recv`` faults: partition
    timeouts, delays) then :func:`read_frame`."""
    net_fault_check("recv", peer_class)
    return read_frame(rfile, allowed_versions=allowed_versions,
                      allow_crc_light=allow_crc_light)


def _emit_metric(recorder, kind: str, name: str, value,
                 **labels) -> None:
    # Same guarded shape as serve.watcher._emit_metric, duplicated so
    # this module keeps its zero-dependency import graph (no recorder =
    # no emission; the WireClient attributes still count).
    if recorder is None:
        return
    getattr(recorder, kind)(name, value, **labels)


# ---------------------------------------------------------------------------
# The failure-aware client.
# ---------------------------------------------------------------------------

class WireClient:
    """Blocking framed client with deadlines, bounded retry, and
    idempotent reconnect.

    Every ``request()`` gets ONE req_id for its whole retry journey:
    transient failures (refused/reset/timeout/torn frame — see
    :func:`classify_net`) drop the connection, back off on the policy's
    deterministic jittered schedule, re-handshake under the same
    session id, and RESEND under the same req_id, so the server's
    replay cache guarantees at-most-once execution. The per-request
    deadline budget caps the whole journey (attempts + backoffs +
    socket waits); when it exhausts, the last error surfaces.

    thread-safety: one in-flight request at a time (internal lock) —
    it is a blocking point-query client, like the line client it
    replaces; run one client per load thread for parallelism."""

    def __init__(self, host: str, port: int, *, timeout: float = 10.0,
                 deadline_s: float = 10.0, policy=None,
                 peer_class: str = "serve", session: str | None = None,
                 recorder=None, caps=DEFAULT_CLIENT_CAPS):
        self.host, self.port = host, int(port)
        self._timeout = float(timeout)
        self._deadline_s = float(deadline_s)
        self._policy = DEFAULT_NET_RETRY if policy is None else policy
        self._peer_class = peer_class
        self._recorder = recorder
        self.session = session or binascii.hexlify(
            os.urandom(8)).decode("ascii")
        self.version: int | None = None
        # Capabilities OFFERED in HELLO; ``self.caps`` holds what the
        # server granted (intersection) after the handshake. A server
        # predating capabilities replies without a "caps" key → empty
        # set → the exact capability-less behavior.
        self._offered_caps = tuple(caps)
        self.caps: set = set()
        self._req_seq = 0
        self._sock = None
        self._rfile = None
        self._connected_once = False
        self._lock = threading.Lock()
        # Honest accounting, recorder or not.
        self.retries = 0
        self.reconnects = 0
        self.deadline_exceeded = 0
        self.busy_rejections = 0
        self._connect()

    # -- connection lifecycle ----------------------------------------------

    def _connect(self) -> None:
        net_fault_check("connect", self._peer_class)
        self._sock = socket.create_connection(
            (self.host, self.port), timeout=self._timeout)
        # Request/response RPC: Nagle only adds delayed-ACK stalls.
        self._sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        self._rfile = self._sock.makefile("rb")
        try:
            hello = {"versions": list(SUPPORTED_VERSIONS),
                     "session": self.session,
                     "caps": list(self._offered_caps)}
            send_frame(self._sock, encode_frame(OP_HELLO, 0,
                                                _dumps(hello)),
                       self._peer_class)
            fr = recv_frame(self._rfile, self._peer_class)
        except BaseException:
            self._drop()
            raise
        if fr is None:
            self._drop()
            raise ConnectionError("server closed during handshake")
        if fr.op == OP_ERR:
            err = fr.json().get("error", "handshake rejected")
            self._drop()
            raise ProtocolVersionError(err)
        if fr.op != OP_HELLO_OK:
            self._drop()
            raise TornFrameError(
                f"torn frame: expected HELLO_OK, got op {fr.op}")
        ok = fr.json()
        self.version = int(ok.get("version", PROTO_VERSION))
        self.caps = set(ok.get("caps", ())) & set(self._offered_caps)
        if self._connected_once:
            self.reconnects += 1
            _emit_metric(self._recorder, "inc", "net.reconnects", 1)
        self._connected_once = True

    def _drop(self) -> None:
        for closer in (self._rfile, self._sock):
            if closer is not None:
                try:
                    closer.close()
                except OSError:
                    pass
        self._sock = self._rfile = None

    def close(self) -> None:
        self._drop()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # -- requests -----------------------------------------------------------

    def request(self, req: dict, *, deadline_s: float | None = None,
                clock=time.monotonic, sleep=time.sleep) -> dict:
        """One request -> one response dict, surviving transient wire
        failures inside the deadline budget. Application-level errors
        (``ok: false`` responses from ``handle_request``) return to the
        caller unchanged — only TRANSPORT failures and server
        shed/deadline frames are retried here."""
        budget = (self._deadline_s if deadline_s is None
                  else float(deadline_s))
        with self._lock:
            self._req_seq += 1
            req_id = self._req_seq
            t0 = clock()
            attempt = 0
            last: BaseException | None = None
            while True:
                remaining = budget - (clock() - t0)
                if remaining <= 0:
                    break
                try:
                    return self._attempt(req, req_id, remaining)
                except (ProtocolVersionError, FrameTooLargeError):
                    raise  # speaking-past-each-other: never retry
                except ServerBusyError as e:
                    last = e
                    self.busy_rejections += 1
                    # Connection is healthy; do NOT reconnect.
                except (WireError, ConnectionError, TimeoutError,
                        OSError) as e:
                    if classify_net(e) != "retryable":
                        raise
                    last = e
                    self._drop()
                if attempt >= self._policy.retries:
                    break
                delay = self._policy.backoff_s(attempt)
                if clock() - t0 + delay > budget:
                    break
                self.retries += 1
                _emit_metric(self._recorder, "inc", "net.retries", 1,
                             peer_class=self._peer_class)
                sleep(delay)
                attempt += 1
            # Budget or retry budget exhausted.
            if isinstance(last, (TimeoutError, ServerBusyError)) or (
                    budget - (clock() - t0) <= 0):
                self.deadline_exceeded += 1
                _emit_metric(self._recorder, "inc",
                             "net.deadline_exceeded", 1)
            if last is None:
                last = TimeoutError(
                    f"request {req_id}: deadline budget {budget}s "
                    f"exhausted before the first attempt")
            raise last

    def _attempt(self, req: dict, req_id: int,
                 remaining: float) -> dict:
        if self._sock is None:
            self._connect()
        self._sock.settimeout(max(min(self._timeout, remaining), 1e-3))
        envelope = {"d": round(remaining, 3), "q": req}
        send_frame(self._sock, encode_frame(OP_REQ, req_id,
                                            _dumps(envelope)),
                   self._peer_class)
        while True:
            fr = recv_frame(self._rfile, self._peer_class,
                            allow_crc_light=CAP_CRC_LIGHT in self.caps)
            if fr is None:
                raise ConnectionError("server closed the connection")
            if fr.op == OP_BUSY:
                raise ServerBusyError(
                    "server shed the request under admission control")
            if fr.op == OP_ERR:
                raise TornFrameError(
                    f"torn frame: server protocol rejection: "
                    f"{fr.json().get('error')}")
            if fr.op != OP_RESP:
                raise TornFrameError(
                    f"torn frame: unexpected op {fr.op} mid-request")
            if fr.req_id != req_id:
                # A reply to an EARLIER attempt of this session that
                # the server flushed late; ours is still coming on
                # this same (healthy) connection — keep reading.
                if fr.req_id < req_id:
                    continue
                raise TornFrameError(
                    f"torn frame: response id {fr.req_id} from the "
                    f"future (sent {req_id})")
            resp = (decode_bin_response(fr.payload)
                    if fr.flags & FLAG_BIN else fr.json())
            if (not resp.get("ok") and resp.get("deadline_exceeded")
                    and resp.get("retryable")):
                # The server gave up on our stale deadline; retry with
                # what is left of OUR budget.
                raise ServerBusyError("server-side deadline exceeded")
            return resp

    def multi(self, reqs, *, deadline_s: float | None = None) -> list:
        """Batched lookups: ONE frame carries every request in ``reqs``
        (pull/score/topk dicts, same shapes as :meth:`request`), one
        frame comes back with per-request results — the per-request
        framing/syscall/CRC overhead is amortized across the batch, and
        the server merges the whole frame into one fancy-index gather
        per table. Returns the per-request response list (each entry an
        ``{"ok": ...}`` dict; item failures ride inside their entry and
        never fail siblings).

        Against a server that did not grant :data:`CAP_MULTI` (an old
        peer), falls back to sequential single requests — same results,
        one round trip per request."""
        reqs = list(reqs)
        if CAP_MULTI in self.caps:
            resp = self.request({"op": "multi", "reqs": reqs},
                                deadline_s=deadline_s)
            if not resp.get("ok"):
                raise WireError(
                    f"multi rejected: {resp.get('error')}")
            results = resp.get("results")
            if not isinstance(results, list) or len(results) != len(reqs):
                raise TornFrameError(
                    f"torn frame: multi returned "
                    f"{None if results is None else len(results)} "
                    f"results for {len(reqs)} requests")
            return results
        return [self.request(r, deadline_s=deadline_s) for r in reqs]
