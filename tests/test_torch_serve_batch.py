"""The port's batched read plane against the JAX package's: the oracle of
``tests/test_serve_batch.py``, case for case, each case run against both
packages (``_serve_pkgs``).

* HELLO capability negotiation (the intersection of offered and
  supported), the binary response path (``CAP_BIN``), header-only CRC
  (``CAP_CRC_LIGHT``) and its refusal when not negotiated;
* ``multi``: per-item failures inside their entry, same-table members
  merged into one gather, a resent frame replayed exactly once;
* the coalescer: requests queued behind a running batch merge into one
  (held open by construction: the leader's first batch waits until the
  others have queued, so the merge does not depend on thread timing),
  answers unchanged; an idle server never waits;
* zero-copy batched pulls, admission control's cost weights and AIMD
  governor, and the ReadAutoscaler.
"""


import json
import os
import threading
import time
import tracemalloc

import numpy as np
import pytest
import torch

from fps_tpu_torch.core import snapshot_format as fmt
from fps_tpu_torch.serve import (
    AdmissionController,
    CoalesceConfig,
    ReadAutoscaler,
    ReadServer,
    ServableSnapshot,
    ServingFleet,
    TcpServe,
    WireClient,
)
from fps_tpu_torch.serve.admission import DEFAULT_COST_WEIGHTS
from fps_tpu_torch.serve.net import handle_request, handle_request_segs
from fps_tpu_torch.serve.wire import (
    CAP_BIN,
    CAP_CRC_LIGHT,
    CAP_MULTI,
    CRC_LIGHT_THRESHOLD,
    FLAG_CRC_LIGHT,
    OP_RESP,
    SUPPORTED_CAPS,
    TornFrameError,
    decode_bin_response,
    encode_frame_parts,
    pack_bin_payload,
    read_frame,
)
from fps_tpu_torch.testing import faultnet
from fps_tpu_torch.testing.faultnet import NetFaultRule

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
    yield
    faultnet.uninstall()


def _snapshot(nrows=64, rank=4, step=11):
    rng = np.random.default_rng(3)
    tables = {"weights": rng.normal(
        size=(nrows, rank)).astype(np.float32)}
    return ServableSnapshot(step, "test-batch", tables, [], "none")


def _tcp(**kw):
    server = ReadServer()
    server.swap_to(_snapshot())
    return server, TcpServe(server, **kw).start()


# ---------------------------------------------------------------------------
# Capability negotiation
# ---------------------------------------------------------------------------

def test_hello_caps_granted_is_the_intersection():
    server, tcp = _tcp(caps=(CAP_MULTI, CAP_BIN))
    try:
        with WireClient("127.0.0.1", tcp.port,
                        caps=SUPPORTED_CAPS) as c:
            # Client offered all three; server supports two.
            assert c.caps == {CAP_MULTI, CAP_BIN}
        with WireClient("127.0.0.1", tcp.port, caps=()) as c:
            # Client offered nothing: a capability-less peer, nothing granted.
            assert c.caps == set()
    finally:
        tcp.close()


def test_multi_not_negotiated_falls_back_sequential():
    server, tcp = _tcp(caps=())  # a server predating multi
    try:
        reqs = [{"op": "pull", "table": "weights", "ids": [i, i + 1]}
                for i in range(4)]
        with WireClient("127.0.0.1", tcp.port) as c:
            assert CAP_MULTI not in c.caps
            got = c.multi(reqs)
        assert [r["values"] for r in got] == [
            handle_request(server, r)["values"] for r in reqs]
        # Four single frames, zero multi frames: the fallback is the
        # capability-less shape, not a rejected batch.
        assert tcp.wire_stats()["multi_frames"] == 0
    finally:
        tcp.close()


# ---------------------------------------------------------------------------
# Binary (zero-copy) responses + header-only CRC
# ---------------------------------------------------------------------------

def test_bin_payload_roundtrip_is_exact_and_zero_copy():
    rng = np.random.default_rng(0)
    segs = [rng.normal(size=(16, 8)).astype(np.float32),
            rng.integers(0, 1 << 40, 5).astype(np.int64)]
    resp = {"ok": True, "step": 3,
            "values": {"__seg__": 0}, "items": {"__seg__": 1}}
    parts = pack_bin_payload(resp, segs)
    payload = b"".join(bytes(p) for p in parts)
    out = decode_bin_response(payload)
    assert out["ok"] and out["step"] == 3
    assert np.array_equal(out["values"], segs[0])
    assert out["values"].dtype == np.float32
    assert np.array_equal(out["items"], segs[1])
    assert out["items"].dtype == np.int64
    # np.frombuffer views, not copies: the arrays alias the payload.
    assert out["values"].base is not None
    assert out["items"].base is not None


def test_bin_multi_over_tcp_matches_json():
    server, tcp = _tcp()
    try:
        reqs = [{"op": "pull", "table": "weights",
                 "ids": [1, 5, 9, 13]},
                {"op": "score", "table": "weights",
                 "feat_ids": [[1, 2], [3, 4]],
                 "feat_vals": [[1.0, 2.0], [0.5, -1.0]]}]
        with WireClient("127.0.0.1", tcp.port) as cj:
            want = cj.multi(reqs)
        with WireClient("127.0.0.1", tcp.port,
                        caps=(CAP_MULTI, CAP_BIN)) as cb:
            got = cb.multi(reqs)
        assert np.array_equal(
            np.asarray(want[0]["values"], np.float32),
            got[0]["values"])
        assert np.allclose(
            np.asarray(want[1]["scores"]), got[1]["scores"])
        assert tcp.wire_stats()["bin_responses"] >= 1
    finally:
        tcp.close()


def test_crc_light_negotiated_above_threshold_only():
    # A pull big enough that its binary response crosses the
    # threshold: 64KiB / (4 bytes * 4 cols) = 4096 rows.
    server = ReadServer()
    server.swap_to(_snapshot(nrows=8192))
    tcp = TcpServe(server).start()
    big = {"op": "pull", "table": "weights",
           "ids": np.arange(8192).tolist()}
    small = {"op": "pull", "table": "weights", "ids": [1, 2, 3]}
    try:
        with WireClient("127.0.0.1", tcp.port,
                        caps=(CAP_MULTI, CAP_BIN, CAP_CRC_LIGHT)) as c:
            assert CAP_CRC_LIGHT in c.caps
            got_small = c.request(small)
            assert tcp.wire_stats()["crc_light_frames"] == 0
            got_big = c.request(big)
            assert tcp.wire_stats()["crc_light_frames"] == 1
        assert np.array_equal(
            got_big["values"],
            server.snapshot.lookup("weights", np.arange(8192)))
        assert np.array_equal(
            np.asarray(got_small["values"]),
            server.snapshot.lookup("weights", [1, 2, 3]))
        # Without the cap offered: same big response, full CRC.
        with WireClient("127.0.0.1", tcp.port,
                        caps=(CAP_MULTI, CAP_BIN)) as c:
            c.request(big)
        assert tcp.wire_stats()["crc_light_frames"] == 1
    finally:
        tcp.close()


def test_unnegotiated_crc_light_frame_rejected_as_torn():
    import io

    payload = json.dumps({"ok": True}).encode()
    parts = encode_frame_parts(OP_RESP, 1, [payload], crc_light=True)
    raw = b"".join(bytes(p) for p in parts)
    fr = read_frame(io.BytesIO(raw), allow_crc_light=True)
    assert fr.flags & FLAG_CRC_LIGHT and fr.json()["ok"]
    with pytest.raises(TornFrameError):
        read_frame(io.BytesIO(raw), allow_crc_light=False)


def test_crc_light_threshold_is_meaningfully_large():
    # The "small responses stay fully guarded" contract only means
    # something while the threshold dwarfs a typical single lookup.
    assert CRC_LIGHT_THRESHOLD >= 16 << 10


# ---------------------------------------------------------------------------
# multi: one frame, many lookups
# ---------------------------------------------------------------------------

def test_multi_roundtrip_with_per_item_errors():
    server, tcp = _tcp()
    try:
        reqs = [
            {"op": "pull", "table": "weights", "ids": [0, 2]},
            {"op": "pull", "table": "nope", "ids": [0]},     # bad table
            {"op": "stats"},
            {"op": "bogus"},                                 # bad op
            {"op": "pull", "table": "weights", "ids": [63]},
        ]
        with WireClient("127.0.0.1", tcp.port) as c:
            got = c.multi(reqs)
        assert len(got) == len(reqs)
        assert got[0]["ok"] and got[4]["ok"]     # siblings unharmed
        assert not got[1]["ok"] and "nope" in got[1]["error"]
        assert got[2]["ok"] and "requests" in got[2]
        assert not got[3]["ok"]
        assert got[0]["values"] == handle_request(
            server, reqs[0])["values"]
        assert tcp.wire_stats()["multi_frames"] == 1
    finally:
        tcp.close()


def test_server_multi_merges_same_table_pulls_into_one_batch():
    server = ReadServer()
    server.swap_to(_snapshot())
    calls = [("pull", {"table": "weights", "ids": [i, i + 3]})
             for i in range(8)]
    before = server.batches
    results = server.multi(calls)
    assert server.batches == before + 1       # ONE merged execution
    assert server.batched_requests >= 8
    for (kind, payload), (step, values) in zip(calls, results):
        assert step == 11
        assert np.array_equal(
            values, server.snapshot.lookup("weights", payload["ids"]))


def test_server_multi_isolates_per_item_failures():
    server = ReadServer()
    server.swap_to(_snapshot())
    results = server.multi([
        ("pull", {"table": "weights", "ids": [1]}),
        ("pull", {"table": "weights", "ids": [9999]}),  # out of range
        ("pull", {"table": "weights", "ids": [2]}),
    ])
    assert isinstance(results[1], Exception)
    assert np.array_equal(
        results[0][1], server.snapshot.lookup("weights", [1]))
    assert np.array_equal(
        results[2][1], server.snapshot.lookup("weights", [2]))


def test_multi_replayed_exactly_once_after_reconnect():
    # S3's chaos half at unit scale: the server's FIRST response send
    # after the handshake is cut mid-frame — the whole multi executed,
    # its response died on the wire, and the client's resend must be
    # answered from the replay cache WITHOUT re-executing any member.
    # serve send occurrences are 0-based: #0 is the HELLO response,
    # #1 the first data response — cut that one.
    rules = [NetFaultRule("serve", "send", "cut", cut_bytes=4,
                          start=1, count=1)]
    reqs = [{"op": "pull", "table": "weights", "ids": [i]}
            for i in range(6)]
    net = faultnet.install(rules, seed=0)
    try:
        server, tcp = _tcp()
        try:
            with WireClient("127.0.0.1", tcp.port,
                            peer_class="client") as c:
                got = c.multi(reqs)
                assert c.reconnects == 1
            stats = tcp.wire_stats()
            executed = server.requests
        finally:
            tcp.close()
    finally:
        faultnet.uninstall()
    assert [r["values"] for r in got] == [
        handle_request(server, r)["values"] for r in reqs]
    # Exactly once: 6 member executions total, the resend a cache hit.
    assert executed == len(reqs)
    assert stats["dedup_replays"] == 1
    # The resend is answered from the replay cache BEFORE dispatch, so
    # only the original execution counts as a multi frame.
    assert stats["multi_frames"] == 1


# ---------------------------------------------------------------------------
# The coalescer
# ---------------------------------------------------------------------------

def test_coalescer_merges_concurrent_pulls_answers_unchanged():
    """Requests queued behind a running batch merge into one. The merge is
    made by construction: the leader's first batch (its own request) is
    held until the other N - 1 requests have queued behind it, then
    released, so they run as one batch whatever the threads' timing."""
    server = ReadServer(coalesce=CoalesceConfig(max_batch=64,
                                                max_delay_s=0.002))
    snap = _snapshot()
    server.swap_to(snap)
    N = 8
    execute = server._execute_entries
    holding = threading.Event()

    def held(entries):
        if not holding.is_set():
            holding.set()
            deadline = time.monotonic() + 30.0
            while server._coalescer.depth() < N - 1:
                assert time.monotonic() < deadline, "requests never queued"
                time.sleep(0.001)
        execute(entries)

    server._execute_entries = held
    errors: list = []

    def client(idx):
        ids = np.random.default_rng(idx).integers(0, 64, 4)
        try:
            step, values = server.pull("weights", ids)
            if step != 11 or not np.array_equal(
                    values, snap.lookup("weights", ids)):
                errors.append((idx, ids))
        except Exception as e:  # noqa: BLE001 — surfaced below
            errors.append((idx, repr(e)))

    threads = [threading.Thread(target=client, args=(i,))
               for i in range(N)]
    threads[0].start()  # the leader: its first batch is held
    assert holding.wait(timeout=30)
    for t in threads[1:]:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    assert not errors
    assert server.requests == N
    # Batching actually happened: fewer executions than requests.
    assert 1 <= server.batches < N
    assert server.batches == 2
    assert server.batched_requests == N


def test_coalescer_idle_server_never_waits():
    server = ReadServer(coalesce=CoalesceConfig(max_batch=64,
                                                max_delay_s=0.25))
    server.swap_to(_snapshot())
    t0 = time.perf_counter()
    step, values = server.pull("weights", [1, 2, 3])
    elapsed = time.perf_counter() - t0
    assert step == 11 and values.shape == (3, 4)
    # max_delay only applies while another batch is EXECUTING; an idle
    # server answers immediately (far under the 250ms knob).
    assert elapsed < 0.2


def test_coalescer_per_item_errors_do_not_fail_siblings():
    server = ReadServer(coalesce=CoalesceConfig(max_batch=64))
    snap = _snapshot()
    server.swap_to(snap)
    results: dict = {}
    barrier = threading.Barrier(3)

    def go(name, ids):
        barrier.wait()
        try:
            results[name] = server.pull("weights", ids)
        except Exception as e:  # noqa: BLE001 — asserted below
            results[name] = e

    threads = [threading.Thread(target=go, args=(n, ids)) for n, ids in
               (("good_a", [1, 2]), ("bad", [9999]), ("good_b", [3]))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert isinstance(results["bad"], Exception)
    assert np.array_equal(results["good_a"][1],
                          snap.lookup("weights", [1, 2]))
    assert np.array_equal(results["good_b"][1],
                          snap.lookup("weights", [3]))


# ---------------------------------------------------------------------------
# Zero-copy: no O(table) allocation per request
# ---------------------------------------------------------------------------

def test_batched_pulls_never_materialize_the_table():
    # A table far larger than any legitimate per-request allocation:
    # 1M rows x 16 float32 = 64 MiB. Serving batched pulls (including
    # the segment/binary encode path) must allocate O(batch), never
    # O(table) — the FPS010 lint is the static half of this contract.
    NROWS, RANK = 1 << 20, 16
    table = np.zeros((NROWS, RANK), np.float32)
    table_bytes = table.nbytes
    server = ReadServer()
    server.swap_to(ServableSnapshot(5, "big", {"emb": table}, [],
                                    "none"))
    ids = np.arange(0, NROWS, NROWS // 256).tolist()
    req = {"op": "multi",
           "reqs": [{"op": "pull", "table": "emb", "ids": ids}
                    for _ in range(4)]}
    handle_request_segs(server, req)  # warm allocator pools
    tracemalloc.start()
    try:
        for _ in range(8):
            resp, segs = handle_request_segs(server, req)
            parts = pack_bin_payload(resp, segs)
            assert sum(getattr(p, "nbytes", None) or len(p)
                       for p in parts) < table_bytes // 64
        _cur, peak = tracemalloc.get_traced_memory()
    finally:
        tracemalloc.stop()
    # Peak transient allocation stays orders of magnitude under the
    # table: one full .copy()/np.asarray() of it would blow this.
    assert peak < table_bytes // 8, (
        f"peak {peak} bytes vs table {table_bytes} — something "
        f"materialized O(table) per request")


# ---------------------------------------------------------------------------
# Admission control
# ---------------------------------------------------------------------------

def test_admission_cost_weights_and_multi_sums():
    adm = AdmissionController(max_cost=16.0)
    assert adm.cost_of({"op": "pull"}) == DEFAULT_COST_WEIGHTS["pull"]
    assert adm.cost_of({"op": "topk"}) == DEFAULT_COST_WEIGHTS["topk"]
    assert adm.cost_of({"op": "stats"}) == DEFAULT_COST_WEIGHTS["stats"]
    multi = {"op": "multi",
             "reqs": [{"op": "pull"}] * 5 + [{"op": "topk"}]}
    assert adm.cost_of(multi) == 5 * 1.0 + 8.0
    assert adm.cost_of("garbage") == 1.0


def test_admission_idle_always_admits_busy_sheds():
    adm = AdmissionController(max_cost=8.0)
    # One request larger than the whole budget: admitted while idle
    # (degrade to serial, never starve).
    assert adm.try_admit(100.0)
    assert not adm.try_admit(1.0)       # budget wedged: shed
    assert adm.stats()["rejected"] == 1
    adm.release(100.0)
    assert adm.try_admit(4.0) and adm.try_admit(4.0)
    assert not adm.try_admit(1.0)       # 8 + 1 > 8
    adm.release(4.0)
    assert adm.try_admit(1.0)


def test_admission_aimd_governor_tracks_latency_target():
    adm = AdmissionController(max_cost=64.0, target_latency_s=0.010,
                              min_limit_fraction=0.125)
    # Sustained over-target completions: multiplicative decrease down
    # to the floor, never below it.
    for _ in range(200):
        assert adm.try_admit(1.0) or True
        adm.release(1.0, latency_s=0.100)
    assert adm.limit() == pytest.approx(64.0 * 0.125)
    # Recovery: under-target completions regrow additively to the cap.
    for _ in range(200):
        adm.release(0.0, latency_s=0.001)
    assert adm.limit() == pytest.approx(64.0)


def test_tcp_serve_exposes_admission_stats():
    server, tcp = _tcp()
    try:
        with WireClient("127.0.0.1", tcp.port) as c:
            c.request({"op": "pull", "table": "weights", "ids": [1]})
        stats = tcp.wire_stats()["admission"]
        assert stats["admitted"] >= 1 and stats["rejected"] == 0
        assert stats["max_cost"] == 64.0
    finally:
        tcp.close()


# ---------------------------------------------------------------------------
# The ReadAutoscaler (unit scale; the chaos scenario covers churn)
# ---------------------------------------------------------------------------

def _write_full(dirpath, step, tables):
    arrays = {f"table::{k}": np.asarray(v) for k, v in tables.items()}
    arrays["meta::ls_format"] = np.array("exported")
    for k in list(arrays):
        arrays["meta::crc::" + k] = np.uint32(fmt.array_crc32(arrays[k]))
    os.makedirs(dirpath, exist_ok=True)
    np.savez(fmt.snapshot_path(dirpath, step), **arrays)


def _converged_fleet(tmp_path, n_readers=1, **scaler_kw):
    d = str(tmp_path)
    table = np.arange(32, dtype=np.float32).reshape(8, 4)
    _write_full(d, 1, {"w": table})
    fleet = ServingFleet(d, n_readers)
    for _ in range(3):
        fleet.poll()   # verify + fence + heartbeat, no threads
    assert all(r.stats()["step"] == 1 for r in fleet.readers)
    return fleet, ReadAutoscaler(fleet, **scaler_kw)


def test_autoscaler_scale_up_cooldown_and_lag_veto(tmp_path):
    fleet, scaler = _converged_fleet(
        tmp_path, 1, min_readers=1, max_readers=3,
        latency_slo_s=0.010, fence_lag_slo_steps=4.0, cooldown_s=5.0)
    for _ in range(20):
        fleet.readers[0].server.latency.add(0.050)  # p99 over SLO

    d1 = scaler.evaluate(newest_step=1, now=100.0)
    assert d1["action"] == "scale_up" and d1["fleet_size"] == 2
    assert fleet.quorum == 2    # majority follows membership

    # Cooldown gates the next action even though p99 still burns.
    d2 = scaler.evaluate(newest_step=1, now=101.0)
    assert d2["action"] == "hold"

    # Fence-lag veto: latency burn with a STALE fence is publish-bound
    # — another reader won't help, hold instead of thrash.
    d3 = scaler.evaluate(newest_step=100, now=200.0)
    assert d3["action"] == "hold"
    assert "publish-bound" in d3["reason"]
    assert len(fleet.readers) == 2

    # Decisions are journaled with their evidence.
    assert [d["action"] for d in scaler.decisions] == [
        "scale_up", "hold", "hold"]
    assert d1["worst_p99_s"] == pytest.approx(0.050)


def test_autoscaler_scale_down_to_min_then_holds(tmp_path):
    fleet, scaler = _converged_fleet(
        tmp_path, 2, min_readers=1, max_readers=3,
        latency_slo_s=1.0, scale_down_fraction=0.25, cooldown_s=0.0)
    for r in fleet.readers:
        for _ in range(20):
            r.server.latency.add(0.001)   # way under 25% of the SLO

    d1 = scaler.evaluate(newest_step=1, now=10.0)
    assert d1["action"] == "scale_down" and d1["fleet_size"] == 1
    d2 = scaler.evaluate(newest_step=1, now=20.0)
    assert d2["action"] == "hold"         # never below min_readers
    assert len(fleet.readers) == 1
    assert fleet.quorum == 1


def test_fleet_dynamic_membership_requorum(tmp_path):
    fleet, _scaler = _converged_fleet(tmp_path, 3, min_readers=1)
    assert fleet.quorum == 2
    r = fleet.add_reader()
    assert len(fleet.readers) == 4 and fleet.quorum == 3
    assert fleet.remove_reader(r.reader_id)
    assert len(fleet.readers) == 3 and fleet.quorum == 2
    # The last reader is never removable.
    for rid in [x.reader_id for x in fleet.readers[1:]]:
        assert fleet.remove_reader(rid)
    assert not fleet.remove_reader(fleet.readers[0].reader_id)
    assert len(fleet.readers) == 1
