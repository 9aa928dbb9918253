"""The port's wire layer (``repro_torch.core.wire``), the client's
retry and stats fixes (``schedclient``) and the daemon's frame cache
(``schedcache.FrameCache``): the cases of ``tests/test_wire.py`` and
``tests/test_framecache.py`` in the port, and the port's own namespace.

Wire: frames dribbled through socketpairs (headers split from bodies,
MACs split across segments, EOF mid-frame), MAC sessions, the HMAC
handshake, address and key parsing, and the retry budget.  Namespace: the
port's frame magic, HMAC labels and environment variables differ from
the reference package's, so a frame of one package's daemon is a
``ProtocolError`` to the other's client.

Frame cache: **accounting** — CacheStats rows (hits/misses/evicted/
bytes/latency_saved_s) stay exact through put/get/replace/evict/clear;
**FIFO dominance** — on any replayed admission trace with uniform frame
sizes and a fixed per-key compute cost, the compute seconds retained are
at least what FIFO eviction would keep (a seeded sweep, and a hypothesis
version through the ``_hypothesis_compat`` shim).
"""
import random
import socket
import threading
import time

import pytest
from _hypothesis_compat import given, settings, st

from repro.core import wire as jwire
from repro_torch.core import wire
from repro_torch.core.resilience import Deadline
from repro_torch.core.schedclient import (
    MIN_RETRY_BUDGET_S,
    AuthFailed,
    ClientStats,
    DaemonUnavailable,
    ProtocolError,
    SchedClient,
)
from repro_torch.core.schedcache import CacheStats, FrameCache


def _pair():
    a, b = socket.socketpair()
    a.settimeout(5.0)
    b.settimeout(5.0)
    return a, b


def _dribble(sock, data, chunk=1, delay=0.0):
    """Write ``data`` in ``chunk``-byte segments from a thread."""
    def run():
        for i in range(0, len(data), chunk):
            sock.sendall(data[i:i + chunk])
            if delay:
                time.sleep(delay)
    t = threading.Thread(target=run, daemon=True)
    t.start()
    return t


# ---------------------------------------------------------------------------
# partial delivery
# ---------------------------------------------------------------------------


def test_frame_dribbled_byte_by_byte():
    a, b = _pair()
    try:
        payload = {"op": "ping", "blob": list(range(50))}
        t = _dribble(a, wire.encode_frame(payload), chunk=1)
        assert wire.recv_frame(b) == payload
        t.join(timeout=5.0)
    finally:
        a.close(); b.close()


def test_header_split_from_body():
    a, b = _pair()
    try:
        frame = wire.encode_frame({"x": 1})
        # header in two pieces, then a pause, then the body in two pieces
        mid = wire.HEADER_LEN - 2
        for part in (frame[:3], frame[3:mid], frame[mid:mid + 4],
                     frame[mid + 4:]):
            t = _dribble(a, part, chunk=len(part) or 1)
            t.join(timeout=5.0)
        assert wire.recv_frame(b) == {"x": 1}
    finally:
        a.close(); b.close()


def test_mac_split_across_segments():
    """A MAC'd frame whose 32-byte tag arrives one byte at a time still
    verifies — and verifies BEFORE the body is decoded."""
    a, b = _pair()
    try:
        tx = wire.Session(b"k" * 32, is_client=True)
        rx = wire.Session(b"k" * 32, is_client=False)
        frame = wire.encode_frame({"n": 7}, session=tx)
        # everything up to mid-MAC at once, then dribble the rest
        cut = len(frame) - wire.MAC_LEN // 2
        a.sendall(frame[:cut])
        t = _dribble(a, frame[cut:], chunk=1)
        assert wire.recv_frame(b, session=rx) == {"n": 7}
        t.join(timeout=5.0)
    finally:
        a.close(); b.close()


def test_eof_mid_header_and_mid_body():
    for cut in (2, wire.HEADER_LEN + 3):
        a, b = _pair()
        try:
            frame = wire.encode_frame({"x": 1})
            a.sendall(frame[:cut])
            a.close()
            with pytest.raises(ProtocolError, match="truncated"):
                wire.recv_frame(b)
        finally:
            b.close()
    # EOF exactly at a frame boundary is clean when eof_ok
    a, b = _pair()
    try:
        a.close()
        assert wire.recv_frame(b, eof_ok=True) is None
    finally:
        b.close()


def test_eof_mid_mac_is_truncated():
    a, b = _pair()
    try:
        tx = wire.Session(b"k" * 32, is_client=True)
        rx = wire.Session(b"k" * 32, is_client=False)
        frame = wire.encode_frame({"n": 1}, session=tx)
        a.sendall(frame[:-5])       # everything but the MAC tail
        a.close()
        with pytest.raises(ProtocolError, match="truncated"):
            wire.recv_frame(b, session=rx)
    finally:
        b.close()


# ---------------------------------------------------------------------------
# MAC sessions
# ---------------------------------------------------------------------------


def test_tampered_body_fails_before_decode():
    a, b = _pair()
    try:
        tx = wire.Session(b"k" * 32, is_client=True)
        rx = wire.Session(b"k" * 32, is_client=False)
        frame = bytearray(wire.encode_frame({"n": 7}, session=tx))
        frame[wire.HEADER_LEN] ^= 0xFF        # flip a body byte
        a.sendall(bytes(frame))
        with pytest.raises(AuthFailed, match="MAC mismatch"):
            wire.recv_frame(b, session=rx)
    finally:
        a.close(); b.close()


def test_reordered_frames_fail_sequence_check():
    """Per-direction sequence numbers: swapping two frames in flight
    breaks both MACs (no replay / reorder within a connection)."""
    a, b = _pair()
    try:
        tx = wire.Session(b"k" * 32, is_client=True)
        rx = wire.Session(b"k" * 32, is_client=False)
        f1 = wire.encode_frame({"n": 1}, session=tx)
        f2 = wire.encode_frame({"n": 2}, session=tx)
        a.sendall(f2 + f1)                     # swapped
        with pytest.raises(AuthFailed):
            wire.recv_frame(b, session=rx)
    finally:
        a.close(); b.close()


def test_direction_bytes_prevent_reflection():
    """A frame signed by the client cannot be verified as if it came
    from the server (and vice versa)."""
    tx = wire.Session(b"k" * 32, is_client=True)
    reflected = wire.Session(b"k" * 32, is_client=True)  # same direction
    a, b = _pair()
    try:
        a.sendall(wire.encode_frame({"n": 1}, session=tx))
        with pytest.raises(AuthFailed):
            wire.recv_frame(b, session=reflected)
    finally:
        a.close(); b.close()


# ---------------------------------------------------------------------------
# pre-auth cap + JSON codec
# ---------------------------------------------------------------------------


def test_pre_auth_cap_rejects_large_header():
    a, b = _pair()
    try:
        import struct
        a.sendall(wire.MAGIC
                  + struct.pack(">I", wire.PRE_AUTH_MAX_FRAME_BYTES + 1))
        with pytest.raises(ProtocolError, match="cap"):
            wire.recv_frame(b, max_bytes=wire.PRE_AUTH_MAX_FRAME_BYTES)
    finally:
        a.close(); b.close()


def test_json_codec_rejects_garbage_and_non_dict():
    for body in (b"\x80\x04notjson", b"[1,2,3]"):
        a, b = _pair()
        try:
            import struct
            a.sendall(wire.MAGIC + struct.pack(">I", len(body)) + body)
            with pytest.raises(ProtocolError):
                wire.recv_frame(b, json_codec=True)
        finally:
            a.close(); b.close()


# ---------------------------------------------------------------------------
# the handshake
# ---------------------------------------------------------------------------


def _server_side(conn, key, require_auth):
    hello = wire.recv_frame(conn, json_codec=True,
                            max_bytes=wire.PRE_AUTH_MAX_FRAME_BYTES)
    return wire.server_handshake(
        conn, hello, key=key, require_auth=require_auth,
        hello_ok={"ok": True, "op": "hello", **wire.wire_versions()})


def _client_side(sock, key, out):
    try:
        out["resp"], out["session"] = wire.client_handshake(
            sock, {"op": "hello", **wire.wire_versions()}, key=key)
    except Exception as e:          # surfaced by the test thread join
        out["error"] = e
        sock.close()    # like SchedClient._dial: abort is visible as EOF


def test_handshake_roundtrip_with_macs():
    a, b = _pair()
    try:
        out = {}
        t = threading.Thread(target=_client_side,
                             args=(a, b"shared-key", out), daemon=True)
        t.start()
        server_session = _server_side(b, b"shared-key", True)
        t.join(timeout=5.0)
        assert "error" not in out, out.get("error")
        assert out["resp"].get("authed") is True
        # both sides derived the same session key; MAC'd traffic flows
        wire.send_frame(a, {"op": "ping"}, session=out["session"])
        assert wire.recv_frame(b, session=server_session) == {"op": "ping"}
        wire.send_frame(b, {"ok": True}, session=server_session)
        assert wire.recv_frame(a, session=out["session"]) == {"ok": True}
    finally:
        a.close(); b.close()


def test_handshake_wrong_key_typed_both_sides():
    a, b = _pair()
    try:
        out = {}
        t = threading.Thread(target=_client_side,
                             args=(a, b"wrong", out), daemon=True)
        t.start()
        with pytest.raises(wire.AuthFailed):
            _server_side(b, b"right", True)
        t.join(timeout=5.0)
        assert isinstance(out.get("error"), wire.AuthFailed)
    finally:
        a.close(); b.close()


def test_handshake_unix_no_auth_no_session():
    a, b = _pair()
    try:
        out = {}
        t = threading.Thread(target=_client_side, args=(a, None, out),
                             daemon=True)
        t.start()
        assert _server_side(b, None, False) is None
        t.join(timeout=5.0)
        assert "error" not in out
        assert out["session"] is None
    finally:
        a.close(); b.close()


# ---------------------------------------------------------------------------
# address parsing + keys
# ---------------------------------------------------------------------------


def test_parse_address():
    assert wire.parse_address("127.0.0.1:9000") == \
        ("tcp", ("127.0.0.1", 9000))
    assert wire.parse_address("example.com:80") == \
        ("tcp", ("example.com", 80))
    assert wire.parse_address("/tmp/x/s.sock") == ("unix", "/tmp/x/s.sock")
    assert wire.parse_address("/tmp/odd:name.sock") == \
        ("unix", "/tmp/odd:name.sock")          # path separator wins
    assert wire.parse_address("sock")[0] == "unix"
    assert wire.parse_address("host:")[0] == "unix"
    assert wire.parse_address(":123")[0] == "unix"


def test_load_key_sources(tmp_path, monkeypatch):
    monkeypatch.delenv(wire.KEY_ENV, raising=False)
    assert wire.load_key() is None
    monkeypatch.setenv(wire.KEY_ENV, "envkey")
    assert wire.load_key() == b"envkey"
    kf = tmp_path / "key"
    kf.write_bytes(b"filekey\n")
    assert wire.load_key(str(kf)) == b"filekey"   # keyfile beats env
    (tmp_path / "empty").write_bytes(b"")
    with pytest.raises(ValueError):
        wire.load_key(str(tmp_path / "empty"))


# ---------------------------------------------------------------------------
# retry backoff must not eat the whole deadline (regression)
# ---------------------------------------------------------------------------


class _FakeClock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def test_retry_skipped_when_budget_below_nap_plus_floor(monkeypatch):
    """With less budget left than the backoff nap + a minimum useful
    request, the retry would be dead on arrival — the client must raise
    the last typed error immediately instead of napping through the
    deadline and double-counting a breaker failure."""
    clock = _FakeClock()
    deadline = Deadline(1.0, clock=clock)
    c = SchedClient("/nonexistent/sock", retries=3, backoff_s=0.9)
    calls = []

    def failing_request(payload, timeout):
        clock.t += 0.2            # each attempt burns fake time
        calls.append(timeout)
        raise DaemonUnavailable("down")

    monkeypatch.setattr(c, "_request", failing_request)
    naps = []
    monkeypatch.setattr(time, "sleep", lambda s: naps.append(s))

    with pytest.raises(DaemonUnavailable):
        c._call({"op": "ping"}, deadline)
    # one attempt burns 0.2s leaving 0.8s < 0.9 nap + floor: no retry
    assert len(calls) == 1
    assert naps == []
    assert c.stats.as_dict()["retries"] == 0
    # exactly ONE breaker failure for the whole call
    assert c.breaker.failures == 1


def test_retry_proceeds_with_ample_budget(monkeypatch):
    clock = _FakeClock()
    deadline = Deadline(10.0, clock=clock)
    c = SchedClient("/nonexistent/sock", retries=2, backoff_s=0.05)
    calls = []

    def failing_request(payload, timeout):
        clock.t += 0.01
        calls.append(payload["deadline_s"])
        raise DaemonUnavailable("down")

    monkeypatch.setattr(c, "_request", failing_request)
    naps = []
    monkeypatch.setattr(time, "sleep", lambda s: naps.append(s))
    with pytest.raises(DaemonUnavailable):
        c._call({"op": "ping"}, deadline)
    assert len(calls) == 3                  # initial + 2 retries
    assert naps == [0.05, 0.1]              # exponential, never clipped
    assert c.stats.as_dict()["retries"] == 2
    # the wire deadline shrinks as fake time passes
    assert calls == sorted(calls, reverse=True)


def test_min_retry_budget_floor_constant():
    assert 0.0 < MIN_RETRY_BUDGET_S < 1.0


# ---------------------------------------------------------------------------
# ClientStats under thread contention (regression)
# ---------------------------------------------------------------------------


def test_client_stats_threaded_hammer():
    """Concurrent increments from many threads lose no updates — the
    old dataclass ``+=`` did, once SchedClient was shared across
    connection threads."""
    stats = ClientStats()
    threads, per_thread = 8, 2000
    fields = ["remote_ok", "retries", "fallbacks", "remote_errors"]

    def hammer():
        for _ in range(per_thread):
            for f in fields:
                stats.incr(f)

    ts = [threading.Thread(target=hammer) for _ in range(threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = stats.as_dict()
    for f in fields:
        assert snap[f] == threads * per_thread, f
    assert snap["breaker_skips"] == 0


# ---------------------------------------------------------------------------
# the port's own namespace
# ---------------------------------------------------------------------------


def test_namespace_differs_from_the_reference():
    assert wire.wire_versions() == jwire.wire_versions()
    assert wire.MAGIC != jwire.MAGIC and len(wire.MAGIC) == len(jwire.MAGIC)
    for name in ("SOCKET_ENV", "ADDR_ENV", "KEY_ENV"):
        assert getattr(wire, name) != getattr(jwire, name)
        assert getattr(wire, name).startswith("POLYTOPS_TORCH_SCHEDD_")
    for name in ("_S2C_LABEL", "_C2S_LABEL", "_SESSION_LABEL"):
        assert getattr(wire, name) != getattr(jwire, name)


def test_reference_frame_is_a_protocol_error():
    """A reference daemon's frame never reaches ``pickle.loads`` in the
    port, nor the reverse: the magic is checked first."""
    a, b = _pair()
    try:
        a.sendall(jwire.encode_frame({"ok": True, "op": "hello"}))
        with pytest.raises(ProtocolError, match="bad magic"):
            wire.recv_frame(b)
        b.sendall(wire.encode_frame({"ok": True}))
        with pytest.raises(jwire.ProtocolError, match="bad magic"):
            jwire.recv_frame(a)
    finally:
        a.close()
        b.close()

# ---------------------------------------------------------------------------
# frame cache
# ---------------------------------------------------------------------------

SIZE = 64          # uniform frame size: the provable-dominance regime


def frame(byte=b"x"):
    return byte * SIZE


def cost_of(key: int) -> float:
    """Fixed per-key compute cost (distinct across keys)."""
    return 0.013 * (key + 1)


# ---------------------------------------------------------------------------
# accounting
# ---------------------------------------------------------------------------


def test_hit_miss_and_latency_saved_accounting():
    fc = FrameCache(cap_entries=8)
    assert fc.get("a") is None
    assert fc.stats.misses == 1
    assert fc.put("a", frame(), 2.5)
    assert fc.get("a") == frame()
    assert fc.get("a") == frame()
    assert fc.stats.hits == 2
    assert fc.stats.latency_saved_s == pytest.approx(5.0)
    assert "a" in fc and len(fc) == 1


def test_entry_cap_evicts_lowest_score_first():
    fc = FrameCache(cap_entries=2)
    fc.put("cheap", frame(), 0.001)
    fc.put("dear", frame(), 5.0)
    fc.put("mid", frame(), 1.0)          # over cap: "cheap" must go
    assert "cheap" not in fc
    assert "dear" in fc and "mid" in fc
    assert fc.stats.evicted == 1
    assert fc.retained_latency_s() == pytest.approx(6.0)


def test_newcomer_scoring_below_everything_is_rejected():
    fc = FrameCache(cap_entries=2)
    fc.put("a", frame(), 5.0)
    fc.put("b", frame(), 4.0)
    retained = fc.put("c", frame(), 0.001)   # worst score in the cache
    assert not retained
    assert "c" not in fc and "a" in fc and "b" in fc
    assert fc.stats.evicted == 1             # the rejection is counted


def test_byte_cap_enforced_and_bytes_exact():
    fc = FrameCache(cap_entries=100, cap_bytes=3 * SIZE)
    for i in range(5):
        fc.put(i, frame(), cost_of(i))
    assert fc.stats.bytes <= 3 * SIZE
    assert fc.stats.bytes == len(fc) * SIZE
    assert fc.stats.evicted == 2


def test_replace_updates_bytes_and_preserves_hits():
    fc = FrameCache(cap_entries=4)
    fc.put("k", b"a" * 10, 1.0)
    fc.get("k")
    fc.put("k", b"b" * 30, 2.0)          # re-admit: new frame, same key
    assert fc.stats.bytes == 30
    assert fc._entries["k"].hits == 1    # hit history survives replace
    assert fc.get("k") == b"b" * 30
    assert len(fc) == 1 and fc.stats.evicted == 0


def test_clear_resets_occupancy_not_history():
    fc = FrameCache(cap_entries=4)
    fc.put("a", frame(), 1.0)
    fc.get("a")
    fc.clear()
    assert len(fc) == 0 and fc.stats.bytes == 0
    assert fc.stats.hits == 1            # lifetime stats survive clear


def test_snapshot_shape():
    fc = FrameCache(cap_entries=4, cap_bytes=1 << 20)
    fc.put("a", frame(), 2.0)
    fc.put("b", frame(), 0.5)
    snap = fc.snapshot()
    assert snap["entries"] == 2
    assert snap["cap_entries"] == 4 and snap["cap_bytes"] == 1 << 20
    assert snap["bytes"] == 2 * SIZE
    assert snap["retained_latency_s"] == pytest.approx(2.5)
    assert snap["min_score"] == pytest.approx(0.5 / SIZE)
    assert snap["max_score"] == pytest.approx(2.0 / SIZE)
    assert snap["stats"]["evicted"] == 0


def test_shared_stats_object():
    stats = CacheStats()
    fc = FrameCache(cap_entries=2, stats=stats)
    fc.put("a", frame(), 1.0)
    fc.get("a")
    assert stats.hits == 1 and stats.bytes == SIZE


# ---------------------------------------------------------------------------
# FIFO dominance
# ---------------------------------------------------------------------------


def fifo_retained(trace, cap):
    """The FIFO policy replayed: on admission of a new key to a full
    cache, evict the oldest insertion.  Returns retained compute_s."""
    d = {}
    for key in trace:
        if key in d:
            continue                     # warm: FIFO served the frame,
        if len(d) >= cap:                # no re-admission
            d.pop(next(iter(d)))
        d[key] = cost_of(key)
    return sum(d.values())


def scored_retained(trace, cap):
    fc = FrameCache(cap_entries=cap, cap_bytes=1 << 30)
    for key in trace:
        if fc.get(key) is None:
            fc.put(key, frame(), cost_of(key))
    return fc.retained_latency_s()


def test_retained_latency_dominates_fifo_seeded_sweep():
    rng = random.Random(0xF0F0)
    for _ in range(300):
        cap = rng.randint(1, 8)
        trace = [rng.randrange(12) for _ in range(rng.randint(0, 80))]
        scored = scored_retained(trace, cap)
        fifo = fifo_retained(trace, cap)
        assert scored >= fifo - 1e-12, (trace, cap, scored, fifo)


def test_retained_equals_top_cap_of_seen_keys():
    """Stronger than dominance: with uniform sizes the retained set is
    exactly the top-``cap`` compute costs among distinct keys seen."""
    trace = [3, 0, 7, 1, 7, 2, 5, 0, 4]
    cap = 3
    scored = scored_retained(trace, cap)
    best = sum(sorted((cost_of(k) for k in set(trace)), reverse=True)[:cap])
    assert scored == pytest.approx(best)


@given(st.lists(st.integers(min_value=0, max_value=11), max_size=80),
       st.integers(min_value=1, max_value=8))
@settings(max_examples=200, deadline=None)
def test_retained_latency_dominates_fifo_property(trace, cap):
    assert scored_retained(trace, cap) >= fifo_retained(trace, cap) - 1e-12
