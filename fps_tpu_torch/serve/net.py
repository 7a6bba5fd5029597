"""TCP transport for ReadServer: framed wire only.

The wire protocol proper lives in :mod:`fps_tpu_torch.serve.wire` (versioned
length-prefixed frames, CRC32, HELLO negotiation, the failure-aware
:class:`~fps_tpu_torch.serve.wire.WireClient`). This module is the SERVER
side. The dual-stack bridge (first-byte peek routing legacy
line-JSON clients into a compat loop) is RETIRED: every connection must open with the framed
HELLO. A legacy line-JSON peer now fails the first frame's magic/CRC
gates and gets a counted ``torn_frames`` OP_ERR + dropped connection —
loud, immediate, and impossible to half-support (``docs/serving.md``).
:class:`JsonlClient` remains as a thin compat shim over ``WireClient``
(same constructor and ``request()`` surface, framed wire underneath).

Server-side survival (the tentpole's third leg):

* **admission control** — a cost-weighted, latency-governed
  :class:`~fps_tpu_torch.serve.admission.AdmissionController` (a ``topk``
  matmul weighs ~8x a ``pull``; a batched ``multi`` frame weighs the
  sum of its members); a request the budget cannot cover is shed with
  a retryable ``BUSY`` frame (counted as ``net.shed_requests`` — the
  shed-rate SLO in ``fps_tpu_torch.obs.fleet`` burns on it) instead of
  queueing unboundedly. Load shedding is lost WORK, never lost
  CORRECTNESS: the client retries or degrades (``docs/STALENESS.md``).
* **deadline enforcement** — request envelopes carry the client's
  remaining budget; a request that is already dead on arrival is
  answered with a retryable ``deadline_exceeded`` response
  (``net.deadline_exceeded``) rather than executed into a void. A
  per-connection socket timeout reaps partitioned peers so a silent
  client can never pin a handler thread forever.
* **torn-frame accounting** — a frame that fails its length/CRC gates
  is counted (``net.torn_frames``), journaled, and the connection
  dropped loudly; the payload is NEVER decoded.
* **idempotent replay** — executed responses are cached per
  ``(session, req_id)`` in a BYTE-bounded LRU (``replay_cache_bytes``;
  cache cost is response-size-dependent, so an entry-count bound would
  let one big-response tenant evict a small tenant's entries at ~zero
  byte cost); a reconnecting client resending an in-flight request
  gets the cached response, not a second execution (the
  zero-duplicate-applies chaos invariant). Evictions are counted
  (``net.replay_cache_evictions``): an evicted entry's resend
  re-executes — duplicate work, never a duplicate side effect for
  these idempotent reads.

The request/response dicts (and :func:`handle_request`) are unchanged
from the line protocol — framing added integrity and liveness, not a
new schema.

thread-safety: one daemon thread per connection plus the acceptor
(``socketserver.ThreadingTCPServer``); shared state is the ReadServer
(lock-free read path by design), the replay cache and wire-stat
counters (one lock each), and the admission controller (its own lock).
"""

from __future__ import annotations

import collections
import json
import math
import socket
import socketserver
import threading
import time

import numpy as np

from fps_tpu_torch.core.retry import net_fault_check
from fps_tpu_torch.obs.sinks import scrub_nonfinite
from fps_tpu_torch.serve.admission import AdmissionController
from fps_tpu_torch.serve.server import NoSnapshotError, ReadServer
from fps_tpu_torch.serve.watcher import _emit_event, _emit_metric
from fps_tpu_torch.serve.wire import (CAP_BIN, CAP_CRC_LIGHT, CAP_MULTI,
                                CRC_LIGHT_THRESHOLD, FLAG_BIN,
                                OP_BUSY, OP_ERR, OP_HELLO, OP_HELLO_OK,
                                OP_REQ, OP_RESP,
                                SUPPORTED_CAPS, SUPPORTED_VERSIONS,
                                FrameTooLargeError,
                                ProtocolVersionError, TornFrameError,
                                WireClient, encode_frame,
                                encode_frame_parts, pack_bin_payload,
                                read_frame, send_frame)

__all__ = ["TcpServe", "JsonlClient", "handle_request",
           "handle_request_segs", "MULTI_MAX_REQS"]

# One multi frame may carry at most this many sub-requests: bounds the
# per-frame work admission charges as one unit, and keeps the merged
# response under MAX_PAYLOAD for any sane row width.
MULTI_MAX_REQS = 4096


def _py(v):
    # Non-finite floats serialize as null: json.dumps would otherwise emit
    # Python-only NaN/Infinity tokens that strict parsers reject, and a
    # published snapshot CAN hold non-finite rows (observe-mode guards
    # count them without reverting).
    if isinstance(v, np.ndarray):
        out = v.tolist()
        if v.dtype.kind == "f" and not np.isfinite(v).all():
            out = scrub_nonfinite(out)
        return out
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.floating,)):
        return None if not math.isfinite(v) else float(v)
    return v


def _seg_ref(segs: list, arr) -> dict:
    """Park one result array in the segment list, return its payload
    placeholder. Gather outputs are C-contiguous by construction; the
    defensive copy below fires only for exotic strides."""
    arr = np.asarray(arr)
    if not arr.flags.c_contiguous:
        arr = np.ascontiguousarray(arr)
    segs.append(arr)
    return {"__seg__": len(segs) - 1}


def handle_request_segs(server: ReadServer, req) -> tuple[dict, list]:
    """One request → ``(response, segments)``: the response dict holds
    ``{"__seg__": i}`` placeholders where result ARRAYS go, and
    ``segments`` the arrays themselves — the transport decides whether
    to JSON-materialize them (:func:`handle_request`) or write their
    bytes straight into a FLAG_BIN frame (zero-copy sessions)."""
    segs: list = []
    if not isinstance(req, dict):
        # Valid JSON but not an object ('[1]', 'null'): still one error
        # response, never a dropped connection.
        return ({"ok": False,
                 "error": f"request must be a JSON object, got "
                          f"{type(req).__name__}"}, segs)
    try:
        op = req.get("op")
        if op == "pull":
            step, vals = server.pull(req["table"], req["ids"])
            return ({"ok": True, "step": step,
                     "values": _seg_ref(segs, vals)}, segs)
        if op == "score":
            step, scores = server.score_linear(
                req["feat_ids"], req["feat_vals"],
                table=req.get("table", "weights"),
                link=req.get("link", "sigmoid"))
            return ({"ok": True, "step": step,
                     "scores": _seg_ref(segs, scores)}, segs)
        if op == "topk":
            step, items, scores = server.topk(
                req["users"], int(req.get("k", 10)),
                item_table=req.get("item_table", "item_factors"),
                user_leaf=int(req.get("user_leaf", 0)))
            return ({"ok": True, "step": step,
                     "items": _seg_ref(segs, items),
                     "scores": _seg_ref(segs, scores)}, segs)
        if op == "multi":
            return _handle_multi(server, req, segs), segs
        if op == "stats":
            return {"ok": True, **server.stats()}, segs
        return {"ok": False, "error": f"unknown op {op!r}"}, segs
    except NoSnapshotError as e:
        return {"ok": False, "error": str(e), "retryable": True}, segs
    except (KeyError, IndexError, TypeError, ValueError) as e:
        return {"ok": False, "error": f"{type(e).__name__}: {e}"}, segs


def _handle_multi(server: ReadServer, req: dict, segs: list) -> dict:
    """The batched multi-lookup op: every sub-request in ``reqs``
    executes as ONE :meth:`ReadServer.multi` batch (one snapshot
    binding, one merged gather per table). Sub-request failures ride
    inside their own result entry — siblings are unaffected."""
    reqs = req.get("reqs")
    if not isinstance(reqs, list):
        return {"ok": False, "error": "multi needs a 'reqs' list"}
    if len(reqs) > MULTI_MAX_REQS:
        return {"ok": False,
                "error": f"multi carries {len(reqs)} requests, "
                         f"cap {MULTI_MAX_REQS}"}
    calls = []
    for r in reqs:
        if isinstance(r, dict):
            calls.append((r.get("op"), r))
        else:
            calls.append(("__not_a_dict__", {}))
    results = server.multi(calls)  # NoSnapshotError propagates whole
    out = []
    for (kind, _payload), r, sub in zip(calls, results, reqs):
        if kind == "__not_a_dict__":
            out.append({"ok": False,
                        "error": f"request must be a JSON object, got "
                                 f"{type(sub).__name__}"})
        elif isinstance(r, NoSnapshotError):
            out.append({"ok": False, "error": str(r), "retryable": True})
        elif isinstance(r, BaseException):
            out.append({"ok": False,
                        "error": f"{type(r).__name__}: {r}"})
        elif kind == "pull":
            step, vals = r
            out.append({"ok": True, "step": step,
                        "values": _seg_ref(segs, vals)})
        elif kind == "score":
            step, scores = r
            out.append({"ok": True, "step": step,
                        "scores": _seg_ref(segs, scores)})
        elif kind == "stats":
            out.append({"ok": True, **r})
        else:  # topk
            step, items, scores = r
            out.append({"ok": True, "step": step,
                        "items": _seg_ref(segs, items),
                        "scores": _seg_ref(segs, scores)})
    return {"ok": True, "results": out}


def _jsonify_resp(node, segs):
    """Resolve segment placeholders into JSON-safe lists (:func:`_py`)
    — the compat path for sessions that did not negotiate CAP_BIN."""
    if isinstance(node, dict):
        if set(node) == {"__seg__"}:
            return _py(segs[node["__seg__"]])
        return {k: _jsonify_resp(v, segs) for k, v in node.items()}
    if isinstance(node, list):
        return [_jsonify_resp(v, segs) for v in node]
    return node


def handle_request(server: ReadServer, req: dict) -> dict:
    """One request → one JSON-safe response dict (transport-independent:
    the TCP handler's non-binary sessions and the in-process client in
    tests both ride this)."""
    resp, segs = handle_request_segs(server, req)
    return _jsonify_resp(resp, segs) if segs else resp


def _safe_dumps(resp: dict) -> bytes:
    try:
        return json.dumps(resp, allow_nan=False).encode("utf-8")
    except ValueError:
        # Belt-and-braces: _py() nulls non-finite floats, so any stray
        # NaN here is a protocol bug — fail the one response, not the
        # wire contract.
        return json.dumps(
            {"ok": False,
             "error": "non-finite value in response"}).encode("utf-8")


class TcpServe:
    """Serve a :class:`ReadServer` on ``127.0.0.1:port`` (0 = ephemeral;
    read the bound port from :attr:`port`). ``start()`` returns
    immediately (daemon threads); ``close()`` shuts the socket down.

    ``max_inflight`` seeds the default admission budget (cost units of
    concurrently-EXECUTING work across all connections; excess is shed
    with BUSY) — pass ``admission=`` for per-op cost weights and a
    latency-target governor (:mod:`fps_tpu_torch.serve.admission`);
    ``caps=`` limits which wire capabilities this server will grant
    (``multi``/``bin``/``crc_light``, default: all).
    ``conn_timeout_s`` reaps connections whose peer goes silent
    mid-conversation; the (session, req_id) → response replay LRU that
    makes client resends idempotent is bounded BOTH by entries
    (``replay_cache``) and by payload bytes (``replay_cache_bytes`` —
    the binding bound in practice: responses vary from tens of bytes to
    MiBs, and fairness between peers is a byte property). Wire-plane
    metrics ride the ReadServer's recorder; :meth:`wire_stats` exposes
    the same counts as plain ints for tests and scenarios."""

    def __init__(self, server: ReadServer, *, host: str = "127.0.0.1",
                 port: int = 0, max_inflight: int = 64,
                 conn_timeout_s: float = 60.0,
                 replay_cache: int = 1024,
                 replay_cache_bytes: int = 8 << 20,
                 admission: AdmissionController | None = None,
                 caps=SUPPORTED_CAPS):
        read_server = server
        tcp_serve = self
        self._read_server = server
        # Admission: cost-weighted and (optionally) latency-governed
        # (fps_tpu_torch/serve/admission.py). The default reproduces the old
        # semaphore semantics — unit-ish costs against max_inflight.
        self.admission = (AdmissionController(max_cost=float(max_inflight))
                          if admission is None else admission)
        self._caps = frozenset(caps)
        self._stats_lock = threading.Lock()
        self._replay: collections.OrderedDict = collections.OrderedDict()
        self._replay_cap = int(replay_cache)
        self._replay_max_bytes = int(replay_cache_bytes)
        self._replay_bytes = 0
        self._counts = {"torn_frames": 0, "shed_requests": 0,
                        "deadline_exceeded": 0, "dedup_replays": 0,
                        "framed_conns": 0, "replay_evictions": 0,
                        "dropped_accepts": 0, "bin_responses": 0,
                        "crc_light_frames": 0, "multi_frames": 0}

        class Handler(socketserver.StreamRequestHandler):
            timeout = conn_timeout_s

            def handle(self):
                # Request/response RPC: Nagle only adds delayed-ACK
                # stalls on single-write responses.
                self.connection.setsockopt(
                    socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
                try:
                    directive = net_fault_check("accept", "serve")
                except OSError:
                    return  # injected accept failure: connection dies
                if directive == "drop":
                    tcp_serve._bump("dropped_accepts")
                    return  # one-way partition: accepted, never served
                # Framed wire only (the dual-stack peek is
                # retired): a legacy line-JSON peer fails the first
                # frame's magic gate inside the handshake and gets a
                # counted OP_ERR + dropped connection.
                tcp_serve._bump("framed_conns")
                self._handle_framed()

            # -- framed path --------------------------------------------

            def _send(self, op, req_id, payload: bytes):
                send_frame(self.connection,
                           encode_frame(op, req_id, payload), "serve")

            def _handle_framed(self):
                recorder = read_server.recorder
                try:
                    if not self._handshake():
                        return
                    while True:
                        try:
                            fr = read_frame(self.rfile)
                        except (TornFrameError, FrameTooLargeError,
                                ProtocolVersionError) as e:
                            tcp_serve._bump("torn_frames")
                            _emit_metric(recorder, "inc",
                                         "net.torn_frames", 1)
                            _emit_event(recorder, "wire_torn_frame",
                                        reason=str(e))
                            try:
                                self._send(OP_ERR, 0, _safe_dumps(
                                    {"ok": False, "error": str(e)}))
                            except OSError:
                                pass
                            return  # drop the connection loudly
                        if fr is None:
                            return  # clean EOF at a frame boundary
                        if fr.op != OP_REQ:
                            self._send(OP_ERR, fr.req_id, _safe_dumps(
                                {"ok": False,
                                 "error": f"unexpected op {fr.op}"}))
                            return
                        self._serve_one(fr, recorder)
                except (TimeoutError, ConnectionError, OSError):
                    return  # peer vanished / partitioned: reap quietly

            def _handshake(self) -> bool:
                try:
                    fr = read_frame(self.rfile)
                except (TornFrameError, FrameTooLargeError,
                        ProtocolVersionError) as e:
                    tcp_serve._bump("torn_frames")
                    _emit_metric(read_server.recorder, "inc",
                                 "net.torn_frames", 1)
                    try:
                        self._send(OP_ERR, 0, _safe_dumps(
                            {"ok": False, "error": str(e)}))
                    except OSError:
                        pass
                    return False
                if fr is None or fr.op != OP_HELLO:
                    self._send(OP_ERR, 0, _safe_dumps(
                        {"ok": False,
                         "error": "expected HELLO as the first frame"}))
                    return False
                hello = fr.json()
                offered = {int(v) for v in hello.get("versions", ())}
                common = offered & set(SUPPORTED_VERSIONS)
                if not common:
                    self._send(OP_ERR, 0, _safe_dumps(
                        {"ok": False,
                         "error": "no common protocol version",
                         "supported": list(SUPPORTED_VERSIONS)}))
                    return False
                self.wire_session = str(
                    hello.get("session", f"conn-{id(self)}"))
                self.wire_version = max(common)
                # Capability negotiation (additive — the protocol
                # version does not move): grant the intersection of
                # what the client offered and what this server allows.
                # Old clients offer nothing and get nothing; every
                # pre-capability frame shape still works.
                offered_caps = {str(c) for c in hello.get("caps", ())}
                self.wire_caps = offered_caps & tcp_serve._caps
                self._send(OP_HELLO_OK, 0, _safe_dumps(
                    {"ok": True, "version": self.wire_version,
                     "caps": sorted(self.wire_caps)}))
                return True

            def _serve_one(self, fr, recorder):
                envelope = fr.json()
                key = (self.wire_session, fr.req_id)
                cached = tcp_serve._replay_get(key)
                if cached is not None:
                    # Idempotent resend after a reconnect: replay the
                    # recorded response, never execute twice.
                    send_frame(self.connection, cached, "serve")
                    return
                deadline = envelope.get("d")
                if deadline is not None and float(deadline) <= 0:
                    tcp_serve._bump("deadline_exceeded")
                    _emit_metric(recorder, "inc",
                                 "net.deadline_exceeded", 1)
                    self._send(OP_RESP, fr.req_id, _safe_dumps(
                        {"ok": False, "error": "deadline exceeded",
                         "retryable": True, "deadline_exceeded": True}))
                    return
                q = envelope.get("q")
                if (isinstance(q, dict) and q.get("op") == "multi"
                        and CAP_MULTI not in self.wire_caps):
                    # A multi frame on a session that never negotiated
                    # the capability is a protocol bug, not load.
                    self._send(OP_RESP, fr.req_id, _safe_dumps(
                        {"ok": False,
                         "error": "multi not negotiated on this "
                                  "session"}))
                    return
                cost = tcp_serve.admission.cost_of(q)
                if not tcp_serve.admission.try_admit(cost):
                    # Admission control: the cost budget (queue depth
                    # in op-weighted units, latency-governed) is spent.
                    # Shed with a retryable BUSY — bounded latency
                    # beats an unbounded queue (docs/STALENESS.md).
                    tcp_serve._bump("shed_requests")
                    _emit_metric(recorder, "inc",
                                 "net.shed_requests", 1)
                    self._send(OP_BUSY, fr.req_id, _safe_dumps(
                        {"ok": False, "error": "server busy",
                         "retryable": True, "busy": True}))
                    return
                t0 = time.monotonic()
                try:
                    resp, segs = handle_request_segs(read_server, q)
                finally:
                    tcp_serve.admission.release(
                        cost, time.monotonic() - t0)
                if isinstance(q, dict) and q.get("op") == "multi":
                    tcp_serve._bump("multi_frames")
                data = self._encode_resp(fr.req_id, resp, segs,
                                         recorder)
                if resp.get("ok"):
                    # Only EXECUTED successes are replayable; errors
                    # and sheds must re-execute on resend.
                    tcp_serve._replay_put(key, data)
                send_frame(self.connection, data, "serve")

            def _encode_resp(self, req_id, resp, segs, recorder):
                """Encode a response for THIS session's capabilities.

                * ``bin`` negotiated and array segments present →
                  binary payload framing: the raw table rows ride as
                  memoryview segments straight off the snapshot (no
                  base64, no JSON digit-printing, no copy).
                * ``crc_light`` negotiated and the payload is large →
                  header-only CRC trailer (the loopback-trusted mode;
                  default sessions keep the full-payload CRC).

                Returns either ``bytes`` or a parts list; both
                ``send_frame`` and the replay cache accept either.
                """
                use_bin = bool(segs) and CAP_BIN in self.wire_caps
                if use_bin:
                    parts = pack_bin_payload(resp, segs)
                    flags = FLAG_BIN
                else:
                    # No bin capability: materialize segments into the
                    # JSON body (the compatible, copying path).
                    parts = [_safe_dumps(_jsonify_resp(resp, segs))]
                    flags = 0
                nbytes = sum(
                    getattr(p, "nbytes", None) or len(p) for p in parts)
                crc_light = (CAP_CRC_LIGHT in self.wire_caps
                             and nbytes > CRC_LIGHT_THRESHOLD)
                if use_bin:
                    tcp_serve._bump("bin_responses")
                    _emit_metric(recorder, "inc",
                                 "net.bin_responses", 1)
                if crc_light:
                    tcp_serve._bump("crc_light_frames")
                    _emit_metric(recorder, "inc",
                                 "net.crc_light_frames", 1)
                if not use_bin and not crc_light:
                    return encode_frame(OP_RESP, req_id, parts[0])
                return encode_frame_parts(
                    OP_RESP, req_id, parts,
                    flags=flags, crc_light=crc_light)

        self._tcp = socketserver.ThreadingTCPServer(
            (host, port), Handler, bind_and_activate=True)
        self._tcp.daemon_threads = True
        self._thread = threading.Thread(
            target=self._tcp.serve_forever, name="fps-serve-tcp",
            daemon=True)
        self.host, self.port = self._tcp.server_address[:2]

    # -- shared wire state (handler threads) --------------------------------

    def _bump(self, name: str) -> None:
        with self._stats_lock:
            self._counts[name] += 1

    def _replay_get(self, key):
        with self._stats_lock:
            data = self._replay.get(key)
            if data is not None:
                self._replay.move_to_end(key)
                self._counts["dedup_replays"] += 1
            return data

    @staticmethod
    def _frame_nbytes(data) -> int:
        """Wire size of a cached response — bytes or a parts list
        (binary responses are cached as the scatter-gather parts they
        were sent as; no join on the hot path)."""
        if isinstance(data, (bytes, bytearray, memoryview)):
            return len(data)
        return sum(getattr(p, "nbytes", None) or len(p) for p in data)

    def _replay_put(self, key, data) -> None:
        recorder = self._read_server.recorder
        with self._stats_lock:
            old = self._replay.pop(key, None)
            if old is not None:
                self._replay_bytes -= self._frame_nbytes(old)
            self._replay[key] = data
            self._replay_bytes += self._frame_nbytes(data)
            # Byte bound first (the binding one — fairness between a
            # MiB-response tenant and a tens-of-bytes tenant is a byte
            # property), entry bound as a backstop. Strict LRU order:
            # oldest-touched entries go first, pinned by the test.
            # The just-inserted entry is IN FLIGHT (its response may
            # still be resent after a reconnect) — eviction never
            # touches it, even when it alone exceeds the byte bound.
            evicted = 0
            while (len(self._replay) > 1
                   and (self._replay_bytes > self._replay_max_bytes
                        or len(self._replay) > self._replay_cap)):
                _k, v = self._replay.popitem(last=False)
                self._replay_bytes -= self._frame_nbytes(v)
                evicted += 1
            self._counts["replay_evictions"] += evicted
        if evicted:
            # Outside the stats lock: the recorder takes its own.
            _emit_metric(recorder, "inc",
                         "net.replay_cache_evictions", evicted)

    def replay_bytes(self) -> int:
        """Current replay-cache payload bytes (<= replay_cache_bytes)."""
        with self._stats_lock:
            return self._replay_bytes

    def wire_stats(self) -> dict:
        """Plain-int wire counters (scenario/bench evidence):
        torn_frames, shed_requests, deadline_exceeded, dedup_replays,
        framed_conns, replay_evictions, dropped_accepts,
        bin_responses, crc_light_frames, multi_frames — plus the
        admission controller's snapshot under ``"admission"``."""
        with self._stats_lock:
            out = dict(self._counts)
        out["admission"] = self.admission.stats()
        return out

    # -- lifecycle ----------------------------------------------------------

    def start(self) -> "TcpServe":
        self._thread.start()
        return self

    def close(self) -> None:
        self._tcp.shutdown()
        self._tcp.server_close()

    def __enter__(self):
        return self.start()

    def __exit__(self, *exc):
        self.close()


class JsonlClient:
    """DEPRECATED compat shim: the old line-protocol client surface
    (constructor, ``request()``, ``close()``, context manager) speaking
    the FRAMED wire through :class:`~fps_tpu_torch.serve.wire.WireClient`.
    Existing tools/tests keep working and silently gain deadlines,
    bounded retry, and idempotent reconnect. The dual-stack server that
    accepted raw line-JSON peers is retired (``docs/serving.md``); new
    code should use ``WireClient``."""

    def __init__(self, host: str, port: int, *, timeout: float = 10.0):
        self._wire = WireClient(host, port, timeout=timeout,
                                deadline_s=timeout)

    def request(self, req: dict) -> dict:
        return self._wire.request(req)

    def close(self) -> None:
        self._wire.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
