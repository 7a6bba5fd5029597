"""The port's wire (``fps_tpu_torch.serve.wire`` / ``serve.net``) and
network fault injector (``fps_tpu_torch.testing.faultnet``) against the
JAX package's: the oracle of ``tests/test_wire.py``, case for case, each
case run against both packages (``_serve_pkgs``).

* framing round-trips arbitrary payloads and every single-byte truncation
  of a valid frame is refused with its layer named;
* the ``classify_net`` table; faultnet's schedules replay (same seed, same
  trail) and ``FPS_TPU_FAULTNET`` self-installs;
* a reconnecting client's resent request executes once; shedding,
  dead-on-arrival deadlines, version negotiation, torn frames;
* the readers' liveness beacons.

Across the packages: the frames are the same bytes; the port's
``WireClient`` talks to the JAX package's ``TcpServe`` and the reverse
over loopback with finite timeouts; the same ``FaultNet`` schedule makes
the same decisions in both; torn frames, CRC mismatch, ``MAX_PAYLOAD`` and
a failed version negotiation are refused the same way.
"""


import errno
import json
import os
import socket
import time

import numpy as np
import pytest
import torch

from fps_tpu_torch.core import retry as retry_mod
from fps_tpu_torch.core.retry import (
    DEFAULT_NET_RETRY,
    RETRYABLE_NET_ERRNOS,
    classify_net,
    classify_path,
    net_fault_check,
)
from fps_tpu_torch.serve import wire
from fps_tpu_torch.serve.fleet import (
    DEFAULT_LIVENESS_TIMEOUT_S,
    FleetReader,
    liveness_check,
    scan_heartbeats,
)
from fps_tpu_torch.serve.net import JsonlClient, TcpServe, handle_request
from fps_tpu_torch.serve.server import ReadServer
from fps_tpu_torch.serve.snapshot import ServableSnapshot
from fps_tpu_torch.serve.wire import (
    CAP_BIN,
    CAP_CRC_LIGHT,
    CAP_MULTI,
    MAGIC,
    MAX_PAYLOAD,
    OP_ERR,
    OP_HELLO,
    OP_HELLO_OK,
    OP_REQ,
    OP_RESP,
    PROTO_VERSION,
    FrameTooLargeError,
    ProtocolVersionError,
    ServerBusyError,
    TornFrameError,
    WireClient,
    decode_frame,
    encode_frame,
)
from fps_tpu_torch.testing import faultnet
from fps_tpu_torch.testing.faultnet import FaultNet, NetFaultRule

import _serve_pkgs


@pytest.fixture(autouse=True, params=_serve_pkgs.PACKAGES)
def pkg(request, monkeypatch):
    """Every case runs twice: against the JAX package's serving plane,
    then against the port's (the names above, rebound by
    :func:`_serve_pkgs.rebind`)."""
    _serve_pkgs.rebind(globals(), request.param, monkeypatch)
    return request.param


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



@pytest.fixture(autouse=True)
def _clean_injector(pkg):
    """Every test leaves the process net injector uninstalled — a
    leaked schedule would fault unrelated tests' sockets."""
    yield
    faultnet.uninstall()


# ---------------------------------------------------------------------------
# Framing units.
# ---------------------------------------------------------------------------


def test_frame_roundtrip_random_payloads():
    rng = np.random.default_rng(0)
    payloads = [b"", b"{}", bytes(rng.integers(0, 256, 1, np.uint8)),
                bytes(rng.integers(0, 256, 4096, np.uint8)),
                json.dumps({"op": "pull", "ids": list(range(64))},
                           ).encode()]
    for i, payload in enumerate(payloads):
        data = encode_frame(OP_REQ, i + 1, payload)
        fr = decode_frame(data)
        assert fr.op == OP_REQ
        assert fr.req_id == i + 1
        assert fr.payload == payload
        assert fr.version == PROTO_VERSION


def test_every_single_byte_truncation_rejected():
    data = encode_frame(OP_RESP, 7, b'{"ok": true}')
    # Zero bytes is a CLEAN EOF at a frame boundary, not a torn frame.
    assert wire.read_frame(__import__("io").BytesIO(b"")) is None
    for n in range(1, len(data)):
        with pytest.raises(TornFrameError) as e:
            decode_frame(data[:n])
        # The failing layer is named (header / payload / crc trailer).
        assert "torn frame" in str(e.value), n


def test_bad_magic_rejected():
    data = encode_frame(OP_REQ, 1, b"{}")
    with pytest.raises(TornFrameError, match="bad magic"):
        decode_frame(b"XXXX" + data[4:])


def test_unknown_version_rejected():
    data = encode_frame(OP_REQ, 1, b"{}", version=99)
    with pytest.raises(ProtocolVersionError, match="99"):
        decode_frame(data)


def test_flipped_payload_byte_fails_crc():
    data = bytearray(encode_frame(OP_REQ, 1, b'{"op": "stats"}'))
    data[wire._HEADER.size + 3] ^= 0xFF
    with pytest.raises(TornFrameError, match="crc mismatch"):
        decode_frame(bytes(data))


def test_oversized_length_prefix_rejected_before_allocation():
    # A corrupt length prefix must reject WITHOUT reading the payload.
    head = wire._HEADER.pack(MAGIC, PROTO_VERSION, OP_REQ, 0, 1,
                             MAX_PAYLOAD + 1)
    with pytest.raises(FrameTooLargeError):
        decode_frame(head)
    with pytest.raises(FrameTooLargeError):
        encode_frame(OP_REQ, 1, b"x" * (MAX_PAYLOAD + 1))


def test_torn_frame_is_a_connection_error():
    # The retry loop treats a torn frame as "the connection is garbage":
    # reconnect-and-resend, which classify_net already blesses.
    assert issubclass(TornFrameError, ConnectionError)
    assert classify_net(TornFrameError("x")) == "retryable"


# ---------------------------------------------------------------------------
# classify_net + the wire retry policy.
# ---------------------------------------------------------------------------


def test_classify_net_table_exact():
    retryable = [TimeoutError("t"), ConnectionResetError("r"),
                 ConnectionRefusedError("c"), BrokenPipeError("b"),
                 EOFError("e"), ConnectionError("closed"),
                 OSError(errno.EHOSTUNREACH, "x")]
    for err in retryable:
        assert classify_net(err) == "retryable", err
    fatal = [OSError(errno.EACCES, "x"), OSError("no errno"),
             ValueError("v"), ProtocolVersionError("p"),
             FrameTooLargeError("f")]
    for err in fatal:
        assert classify_net(err) == "fatal", err
    for code in sorted(RETRYABLE_NET_ERRNOS):
        assert classify_net(OSError(code, "x")) == "retryable", code


def test_default_net_retry_tighter_than_storage():
    # A query client must degrade in seconds, not inherit the storage
    # plane's patience.
    assert DEFAULT_NET_RETRY.retries == 5
    assert DEFAULT_NET_RETRY.deadline_s <= 5.0
    assert DEFAULT_NET_RETRY.max_backoff_s <= 0.5
    seq = [DEFAULT_NET_RETRY.backoff_s(i) for i in range(6)]
    assert seq == [DEFAULT_NET_RETRY.backoff_s(i) for i in range(6)]


# ---------------------------------------------------------------------------
# faultnet: schedule semantics, determinism, env contract.
# ---------------------------------------------------------------------------


def test_faultnet_env_mirror():
    assert faultnet.FAULTNET_ENV == retry_mod.FAULTNET_ENV


def test_rule_validation_rejects_illegal_combos():
    with pytest.raises(ValueError):
        NetFaultRule("serve", "recv", "cut")       # cut is send-only
    with pytest.raises(ValueError):
        NetFaultRule("serve", "send", "refuse")    # refuse is connect
    with pytest.raises(ValueError):
        NetFaultRule("serve", "connect", "drop")   # drop is accept-only
    with pytest.raises(ValueError):
        NetFaultRule("serve", "*", "cut")          # '*' only for delay
    with pytest.raises(ValueError):
        NetFaultRule("serve", "send", "nonsense")
    with pytest.raises(ValueError):
        NetFaultRule("serve", "send", "cut", every=0)
    with pytest.raises(ValueError):
        NetFaultRule("serve", "send", "cut", prob=0.0)
    NetFaultRule("*", "*", "delay", delay_s=0.001)  # legal wildcard


def test_rule_window_semantics():
    # count is the WINDOW WIDTH [start, start+count), not a fire count:
    # start=2, count=9, every=3 fires at n = 2, 5, 8.
    r = NetFaultRule("c", "send", "cut", start=2, count=9, every=3)
    fired = [n for n in range(20) if r.matches("c", "send", n, seed=0)]
    assert fired == [2, 5, 8]
    forever = NetFaultRule("c", "send", "cut", start=1, count=None,
                           every=4)
    fired = [n for n in range(14) if forever.matches("c", "send", n, 0)]
    assert fired == [1, 5, 9, 13]
    assert not r.matches("other", "send", 2, 0)  # class targeted
    assert not r.matches("c", "recv", 2, 0)      # op targeted


def _drive(net: FaultNet, n: int = 40):
    """A synthetic deterministic op stream over two peer classes."""
    for i in range(n):
        for cls in ("client", "serve"):
            for op in ("connect", "send", "recv"):
                try:
                    net.check(op, cls)
                except (ConnectionError, TimeoutError, OSError):
                    pass


def test_faultnet_same_seed_same_trail():
    rules = [NetFaultRule("client", "connect", "refuse", start=3,
                          count=None, every=5, prob=0.6),
             NetFaultRule("serve", "send", "cut", start=0, count=20,
                          every=4),
             NetFaultRule("*", "*", "delay", delay_s=0.0, start=10,
                          count=None, every=7, prob=0.4)]
    a = FaultNet(rules, seed=7, sleep=lambda s: None)
    b = FaultNet(rules, seed=7, sleep=lambda s: None)
    _drive(a)
    _drive(b)
    assert a.trail() == b.trail()
    assert a.trail(), "schedule fired nothing — test is vacuous"
    c = FaultNet(rules, seed=8, sleep=lambda s: None)
    _drive(c)
    assert c.trail() != a.trail()  # distinct seeds desynchronize prob


def test_faultnet_quiesce_heals_but_keeps_evidence():
    net = FaultNet([NetFaultRule("c", "connect", "refuse", start=0,
                                 count=None)], seed=0)
    with pytest.raises(ConnectionRefusedError):
        net.check("connect", "c")
    net.quiesce()
    assert net.check("connect", "c") is None  # healed
    assert net.injected_counts() == {("c", "connect", "refuse"): 1}


def test_spec_roundtrip_string_and_file(tmp_path):
    rules = [NetFaultRule("serve", "send", "trickle", chunk=3,
                          delay_s=0.001, start=1, count=None, every=2)]
    net = FaultNet(rules, seed=5)
    again = FaultNet.from_spec(net.to_spec())
    assert again.rules == net.rules and again.seed == 5
    p = tmp_path / "schedule.json"
    p.write_text(net.to_spec(), encoding="utf-8")
    from_file = FaultNet.from_spec(str(p))
    assert from_file.rules == net.rules and from_file.seed == 5


def test_env_self_install(tmp_path, monkeypatch):
    """A process launched with FPS_TPU_FAULTNET self-installs the
    schedule at the first seam crossing — no imports required of it."""
    net = FaultNet([NetFaultRule("client", "connect", "refuse",
                                 start=0, count=1)], seed=0)
    monkeypatch.setenv(retry_mod.FAULTNET_ENV, net.to_spec())
    monkeypatch.setattr(retry_mod, "_net_injector", None)
    monkeypatch.setattr(retry_mod, "_net_env_checked", False)
    try:
        with pytest.raises(ConnectionRefusedError):
            net_fault_check("connect", "client")
        assert net_fault_check("connect", "client") is None  # count=1
        assert net_fault_check("send", "serve") is None  # other stream
    finally:
        retry_mod.remove_net_injector()
        monkeypatch.setattr(retry_mod, "_net_env_checked", False)


def test_cut_and_trickle_directives():
    net = FaultNet([NetFaultRule("c", "send", "cut", cut_bytes=6,
                                 start=0, count=1),
                    NetFaultRule("c", "send", "trickle", chunk=2,
                                 delay_s=0.0, start=1, count=1)],
                   seed=0)
    assert net.check("send", "c") == ("cut", 6)
    assert net.check("send", "c") == ("trickle", 2, 0.0)
    assert net.check("send", "c") is None


# ---------------------------------------------------------------------------
# End-to-end: WireClient <-> TcpServe.
# ---------------------------------------------------------------------------


def _snapshot():
    rng = np.random.default_rng(3)
    tables = {"weights": rng.normal(size=(64, 4)).astype(np.float32)}
    return ServableSnapshot(11, "test-wire", tables, [], "none")


def _tcp(**kw):
    server = ReadServer()
    server.swap_to(_snapshot())
    return server, TcpServe(server, **kw).start()


def _raw_conn(port):
    s = socket.create_connection(("127.0.0.1", port), timeout=5.0)
    return s, s.makefile("rb")


def test_wire_client_roundtrip_matches_handle_request():
    server, tcp = _tcp()
    try:
        with WireClient("127.0.0.1", tcp.port,
                        peer_class="client") as c:
            assert c.version == PROTO_VERSION
            req = {"op": "pull", "table": "weights", "ids": [1, 5, 9]}
            got = c.request(req)
            want = handle_request(server, req)
            assert got == json.loads(json.dumps(want))
            assert c.request({"op": "stats"})["ok"]
            # Application-level errors return unchanged, NOT retried.
            bad = c.request({"op": "bogus"})
            assert not bad["ok"] and c.retries == 0
        assert tcp.wire_stats()["framed_conns"] == 1
    finally:
        tcp.close()


def test_legacy_line_json_is_rejected_with_op_err():
    # The dual stack is retired: a raw line-JSON peer fails the
    # first frame's magic gate, is counted as a torn frame, answered
    # with one OP_ERR frame, and dropped — never served a line reply.
    server, tcp = _tcp()
    try:
        sock, rfile = _raw_conn(tcp.port)
        try:
            sock.sendall(json.dumps(
                {"op": "pull", "table": "weights",
                 "ids": [0]}).encode() + b"\n")
            fr = wire.read_frame(rfile)
            assert fr.op == OP_ERR and not fr.json()["ok"]
            assert rfile.read(1) == b""  # dropped after the OP_ERR
        finally:
            sock.close()
        stats = tcp.wire_stats()
        assert stats["torn_frames"] == 1
        assert stats["framed_conns"] == 1  # every conn is framed now
    finally:
        tcp.close()


def test_jsonl_client_is_a_framed_shim():
    server, tcp = _tcp()
    try:
        with JsonlClient("127.0.0.1", tcp.port) as c:
            assert c.request({"op": "stats"})["ok"]
        # The compat shim speaks the FRAMED wire, not line-JSON.
        assert tcp.wire_stats()["framed_conns"] == 1
        assert tcp.wire_stats()["torn_frames"] == 0
    finally:
        tcp.close()


def test_replay_cache_is_byte_bounded_with_lru_eviction_order():
    """The (session, req_id) replay cache evicts by BYTES, oldest-touched
    first: cache cost is response-size-dependent, and a 16 MiB-response
    tenant must not be able to hold unbounded memory behind a generous
    entry cap. Pins the eviction order, the byte accounting, and the
    replay_evictions counter."""
    server = ReadServer()
    tcp = TcpServe(server, replay_cache=1024,
                   replay_cache_bytes=100).start()
    try:
        put, get = tcp._replay_put, tcp._replay_get
        put(("s", 1), b"a" * 40)
        put(("s", 2), b"b" * 40)
        assert tcp.replay_bytes() == 80
        assert tcp.wire_stats()["replay_evictions"] == 0
        # Touch 1 so 2 becomes the LRU victim.
        assert get(("s", 1)) == b"a" * 40
        put(("s", 3), b"c" * 40)  # 120 > 100: evicts exactly (s, 2)
        assert get(("s", 2)) is None
        assert get(("s", 1)) == b"a" * 40
        assert get(("s", 3)) == b"c" * 40
        assert tcp.replay_bytes() == 80
        assert tcp.wire_stats()["replay_evictions"] == 1
        # Re-putting a key replaces its bytes, never double-counts.
        put(("s", 1), b"A" * 10)
        assert tcp.replay_bytes() == 50
        # An entry bigger than the whole budget flushes everything
        # older — but NEVER itself: the just-executed response is in
        # flight (a reconnecting client may resend its req_id, and a
        # replay miss means a duplicate execution), so the newest entry
        # survives even when it alone exceeds the byte bound.
        put(("s", 4), b"x" * 101)
        assert get(("s", 4)) == b"x" * 101
        assert tcp.replay_bytes() == 101
        assert tcp.wire_stats()["replay_evictions"] == 3
    finally:
        tcp.close()


def test_dedupe_on_reconnect_executes_once():
    """Server response frame cut mid-send -> client sees a torn frame,
    reconnects, resends the SAME req_id -> server replays the cached
    response instead of executing twice."""
    server, tcp = _tcp()
    try:
        # serve/send stream: n=0 HELLO_OK, n=1 first response (cut),
        # n=2 HELLO_OK on reconnect, n=3 cached replay.
        faultnet.install([NetFaultRule("serve", "send", "cut",
                                       cut_bytes=5, start=1, count=1)],
                         seed=0)
        executed_before = server.requests
        with WireClient("127.0.0.1", tcp.port,
                        peer_class="client") as c:
            resp = c.request({"op": "pull", "table": "weights",
                              "ids": [2, 3]})
            assert resp["ok"]
            assert c.reconnects == 1 and c.retries >= 1
        stats = tcp.wire_stats()
        assert stats["dedup_replays"] == 1
        assert server.requests == executed_before + 1  # at-most-once
    finally:
        tcp.close()


def test_busy_shed_is_retryable_and_bounded():
    server, tcp = _tcp(max_inflight=1)
    try:
        # Wedge the whole cost budget: every request sheds.
        assert tcp.admission.try_admit(tcp.admission.max_cost)
        try:
            c = WireClient("127.0.0.1", tcp.port, peer_class="client",
                           deadline_s=0.3)
            with pytest.raises(ServerBusyError):
                c.request({"op": "stats"})
            assert c.busy_rejections >= 1
            assert c.deadline_exceeded == 1
            assert c.reconnects == 0  # BUSY never drops the connection
            assert tcp.wire_stats()["shed_requests"] >= 1
        finally:
            tcp.admission.release(tcp.admission.max_cost)
        # The budget freed: the SAME client recovers on its next request.
        assert c.request({"op": "stats"})["ok"]
        c.close()
    finally:
        tcp.close()


def test_dead_on_arrival_deadline_not_executed():
    server, tcp = _tcp()
    try:
        executed_before = server.requests
        sock, rfile = _raw_conn(tcp.port)
        try:
            def _send(op, req_id, obj):
                sock.sendall(encode_frame(op, req_id, json.dumps(
                    obj).encode()))

            _send(OP_HELLO, 0, {"versions": [PROTO_VERSION],
                                "session": "doa"})
            assert wire.read_frame(rfile).op == OP_HELLO_OK
            _send(OP_REQ, 1, {"d": 0.0, "q": {"op": "pull",
                                              "table": "weights",
                                              "ids": [0]}})
            fr = wire.read_frame(rfile)
            assert fr.op == OP_RESP and fr.req_id == 1
            resp = fr.json()
            assert resp["deadline_exceeded"] and resp["retryable"]
        finally:
            sock.close()
        assert tcp.wire_stats()["deadline_exceeded"] == 1
        assert server.requests == executed_before  # never executed
    finally:
        tcp.close()


def test_version_negotiation_rejects_loudly():
    server, tcp = _tcp()
    try:
        sock, rfile = _raw_conn(tcp.port)
        try:
            sock.sendall(encode_frame(OP_HELLO, 0, json.dumps(
                {"versions": [99], "session": "v99"}).encode()))
            fr = wire.read_frame(rfile)
            assert fr.op == OP_ERR
            body = fr.json()
            assert "no common protocol version" in body["error"]
            assert body["supported"] == list(wire.SUPPORTED_VERSIONS)
        finally:
            sock.close()
    finally:
        tcp.close()


def test_garbage_after_magic_byte_counted_as_torn():
    server, tcp = _tcp()
    try:
        sock, _ = _raw_conn(tcp.port)
        try:
            # First byte routes to the framed path; the rest is junk.
            sock.sendall(MAGIC[:1] + b"garbage-not-a-frame")
            sock.shutdown(socket.SHUT_WR)
            deadline = time.monotonic() + 5.0
            while time.monotonic() < deadline:
                if tcp.wire_stats()["torn_frames"]:
                    break
                time.sleep(0.01)
        finally:
            sock.close()
        assert tcp.wire_stats()["torn_frames"] == 1
        assert tcp.wire_stats()["framed_conns"] == 1
    finally:
        tcp.close()


def test_client_retries_through_injected_resets():
    server, tcp = _tcp()
    try:
        # connect #0 is the constructor (no-retry by contract); faults
        # start at #1 so only request-path reconnects are faulted.
        faultnet.install([NetFaultRule("client", "send", "cut",
                                       cut_bytes=4, start=2, count=5,
                                       every=2)], seed=0)
        with WireClient("127.0.0.1", tcp.port,
                        peer_class="client") as c:
            for i in range(4):
                assert c.request({"op": "stats"})["ok"], i
            assert c.retries >= 1 and c.reconnects >= 1
    finally:
        tcp.close()


# ---------------------------------------------------------------------------
# Per-reader liveness beacons.
# ---------------------------------------------------------------------------


def test_reader_heartbeat_beacon_on_poll(tmp_path):
    d = str(tmp_path)
    r = FleetReader(d, "r0", heartbeat_interval_s=0.0)
    r.poll()  # nothing servable yet — the beacon still beats
    beats = scan_heartbeats(d)
    assert set(beats) == {"r0"}
    assert beats["r0"]["polls"] == 1 and beats["r0"]["step"] is None
    assert beats["r0"]["age_s"] < DEFAULT_LIVENESS_TIMEOUT_S
    assert os.path.exists(r.heartbeat_path)


def test_liveness_check_fresh_stale_and_missing(tmp_path):
    d = str(tmp_path)
    r = FleetReader(d, "r0", heartbeat_interval_s=0.0)
    r.poll()
    fresh = liveness_check(d)
    assert fresh["wedged"] == [] and "r0" in fresh["ages"]
    # Judged 10s in the future the same beacon is stale -> wedged.
    stale = liveness_check(d, timeout_s=5.0, now=time.time() + 10.0)
    assert stale["wedged"] == ["r0"]
    # An expected reader that never wrote a beacon is wedged too —
    # a reader that never came up must not be a silent absence.
    ghost = liveness_check(d, expected=["r0", "ghost"])
    assert ghost["wedged"] == ["ghost"]
    assert ghost["ages"]["ghost"] is None


def test_liveness_check_empty_dir(tmp_path):
    rep = liveness_check(str(tmp_path))
    assert rep == {"ages": {}, "wedged": []}


def test_heartbeat_path_class_is_liveness():
    assert classify_path("/ckpt/fleet/heartbeat_r0.json") == "liveness"
    assert classify_path("/ckpt/fleet/ready_r0.json") != "liveness"


# ---------------------------------------------------------------------------
# Across the packages: the same frames, both directions, the same faults.
# ---------------------------------------------------------------------------

# A test parametrized on ``pkg`` directly overrides the autouse fixture:
# its names stay the port's, and it reaches the JAX package's through
# ``_serve_pkgs.counterpart``.
ACROSS = pytest.mark.parametrize("pkg", ["across"])
_J = _serve_pkgs.counterpart


def _mf_snapshot(snapshot_cls):
    rng = np.random.default_rng(5)
    tables = {"weights": rng.normal(size=(64, 4)).astype(np.float32),
              "item_factors": rng.normal(size=(30, 4)).astype(np.float32)}
    users = [rng.normal(size=(12, 4)).astype(np.float32)]
    return snapshot_cls(11, "test-wire", tables, users, "exported")


def _tcp_of(server_cls, tcp_cls, snapshot_cls, **kw):
    server = server_cls()
    server.swap_to(_mf_snapshot(snapshot_cls))
    return server, tcp_cls(server, **kw).start()


_REQUESTS = [
    {"op": "pull", "table": "weights", "ids": [0, 5, -1, 63]},
    {"op": "score", "table": "weights", "feat_ids": [[1, 2, -1], [3, 4, 5]],
     "feat_vals": [[0.5, -1.0, 2.0], [1.0, 1.0, 1.0]], "link": "sigmoid"},
    {"op": "score", "table": "weights", "feat_ids": [[1, 2]],
     "feat_vals": [[0.25, 4.0]], "link": "none"},
    {"op": "topk", "users": [0, 3, 11], "k": 4},
    {"op": "pull", "table": "weights", "ids": [64]},
    {"op": "pull", "table": "missing", "ids": [0]},
    {"op": "nope"},
]


def _canon(resp):
    """A response with its arrays as (dtype, shape, bytes) and the
    per-request wall-clock fields dropped."""
    if isinstance(resp, dict):
        return {k: _canon(v) for k, v in resp.items()
                if k not in ("latency_s", "t")}
    if isinstance(resp, (list, tuple)):
        return [_canon(v) for v in resp]
    if isinstance(resp, np.ndarray):
        return (str(resp.dtype), resp.shape, resp.tobytes())
    return resp


@ACROSS
@pytest.mark.parametrize("caps", [(), (CAP_MULTI,),
                                  (CAP_MULTI, CAP_BIN, CAP_CRC_LIGHT)],
                         ids=["plain", "multi", "bin"])
def test_each_packages_client_talks_to_the_others_server(caps):
    """The port's ``WireClient`` against the JAX package's ``TcpServe``
    and the reverse (and each against its own): HELLO grants the same
    caps, and every request, multi batch and error answers the same."""
    got = {}
    for cpkg in _serve_pkgs.PACKAGES:
        for spkg in _serve_pkgs.PACKAGES:
            pick = (lambda x: x) if spkg == "fps_tpu_torch" else _J
            client_cls = WireClient if cpkg == "fps_tpu_torch" else _J(
                WireClient)
            _, tcp = _tcp_of(pick(ReadServer), pick(TcpServe),
                             pick(ServableSnapshot))
            try:
                with client_cls("127.0.0.1", tcp.port, timeout=10.0,
                                deadline_s=10.0, caps=caps) as c:
                    singles = [c.request(r) for r in _REQUESTS]
                    batch = c.multi(_REQUESTS)
                    got[cpkg, spkg] = (sorted(c.caps), c.version,
                                       _canon(singles), _canon(batch))
            finally:
                tcp.close()
    ref = got["fps_tpu", "fps_tpu"]
    assert ref[0] == sorted(caps)
    assert [r["ok"] for r in ref[2]] == [True] * 4 + [False] * 3
    for pair, val in got.items():
        assert val == ref, pair


@ACROSS
def test_the_same_request_bytes_get_the_same_response_frames():
    """A raw framed conversation (HELLO, then each request) sent byte for
    byte to either package's server gets back byte-identical frames."""
    frames = {}
    for spkg in _serve_pkgs.PACKAGES:
        pick = (lambda x: x) if spkg == "fps_tpu_torch" else _J
        _, tcp = _tcp_of(pick(ReadServer), pick(TcpServe),
                         pick(ServableSnapshot))
        try:
            sock, rfile = _raw_conn(tcp.port)
            try:
                sock.sendall(encode_frame(OP_HELLO, 0, json.dumps(
                    {"versions": [1], "session": "across",
                     "caps": []}).encode()))
                fr = wire.read_frame(rfile)
                got = [(fr.op, fr.req_id, fr.flags, fr.payload)]
                for i, req in enumerate(_REQUESTS, 1):
                    sock.sendall(encode_frame(OP_REQ, i, json.dumps(
                        {"q": req}).encode()))
                    fr = wire.read_frame(rfile)
                    got.append((fr.op, fr.req_id, fr.flags, fr.payload))
            finally:
                sock.close()
        finally:
            tcp.close()
        frames[spkg] = got
    assert frames["fps_tpu"] == frames["fps_tpu_torch"]
    assert len(frames["fps_tpu"]) == len(_REQUESTS) + 1


def _refusal(fn):
    """``(exception class name, message)`` of ``fn()``, or its result."""
    try:
        return ("ok", fn())
    except Exception as e:  # noqa: BLE001 — compared across packages
        return (type(e).__name__, str(e))


@ACROSS
def test_frames_and_their_refusals_are_the_same_bytes():
    """``encode_frame`` makes the same bytes in both packages, each
    decodes the other's, and both refuse a torn frame (every truncation),
    a flipped payload byte (CRC), a length prefix past ``MAX_PAYLOAD``,
    a bad magic and an unknown version with the same error and
    message."""
    jwire = _J(wire)
    rng = np.random.default_rng(0)
    for n in (0, 1, 17, 4096):
        payload = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        for op in (OP_HELLO, OP_REQ, OP_RESP, OP_ERR):
            a = wire.encode_frame(op, 7 + n, payload)
            assert a == jwire.encode_frame(op, 7 + n, payload)
            for mod in (wire, jwire):
                fr = mod.decode_frame(a)
                assert (fr.op, fr.req_id, fr.payload) == (op, 7 + n,
                                                          payload)
    good = wire.encode_frame(OP_REQ, 3, b'{"q": {"op": "stats"}}')
    bad = [good[:cut] for cut in range(len(good))]
    flipped = bytearray(good)
    flipped[-6] ^= 0x40
    bad.append(bytes(flipped))
    bad.append(b"X" + good[1:])
    versioned = bytearray(good)
    versioned[4:6] = (99).to_bytes(2, "big")
    bad.append(bytes(versioned))
    huge = bytearray(good)
    huge[16:20] = (wire.MAX_PAYLOAD + 1).to_bytes(4, "big")
    bad.append(bytes(huge))
    kinds = set()
    for data in bad:
        mine = _refusal(lambda: wire.decode_frame(data))
        theirs = _refusal(lambda: jwire.decode_frame(data))
        assert mine == theirs, data
        assert mine[0] != "ok"
        kinds.add(mine[0])
    assert {"TornFrameError", "FrameTooLargeError",
            "ProtocolVersionError"} <= kinds, kinds


@ACROSS
def test_the_same_faultnet_schedule_decides_the_same_in_both():
    """One schedule (probabilistic rules included) driven over the same
    op stream makes the same decisions in both packages, and each loads
    the other's ``FPS_TPU_FAULTNET`` spec."""
    rules = [("client", "connect", "refuse",
              dict(start=3, count=None, every=5, prob=0.6)),
             ("serve", "send", "cut", dict(cut_bytes=5, start=0, count=20,
                                           every=4)),
             ("serve", "send", "trickle", dict(chunk=3, delay_s=0.0,
                                               start=1, count=None,
                                               every=9, prob=0.5)),
             ("*", "*", "delay", dict(delay_s=0.0, start=10, count=None,
                                      every=7, prob=0.4)),
             ("fleet", "accept", "drop", dict(start=2, count=3)),
             ("fleet", "recv", "partition", dict(start=4, count=None,
                                                 every=6, prob=0.7))]
    trails, decisions = {}, {}
    for name, net_cls, rule_cls in (
            ("fps_tpu_torch", FaultNet, NetFaultRule),
            ("fps_tpu", _J(FaultNet), _J(NetFaultRule))):
        net = net_cls([rule_cls(c, o, f, **kw) for c, o, f, kw in rules],
                      seed=11, sleep=lambda s: None)
        seen = []
        for _ in range(60):
            for cls in ("client", "serve", "fleet"):
                for op in ("connect", "accept", "send", "recv"):
                    seen.append(_refusal(lambda: net.check(op, cls)))
        trails[name], decisions[name] = net.trail(), seen
        assert net.to_spec() == net_cls.from_spec(net.to_spec()).to_spec()
    assert decisions["fps_tpu_torch"] == decisions["fps_tpu"]
    assert trails["fps_tpu_torch"] == trails["fps_tpu"]
    # Not vacuous: refusals, timeouts, cuts, trickles, drops and passes.
    assert len({repr(d) for d in decisions["fps_tpu"]}) >= 6
    spec = FaultNet([NetFaultRule(c, o, f, **kw) for c, o, f, kw in rules],
                    seed=11).to_spec()
    assert _J(FaultNet).from_spec(spec).to_spec() == spec
