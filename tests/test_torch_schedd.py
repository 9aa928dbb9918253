"""The port's schedd daemon (``repro_torch.launch.schedd``) and its
client (``repro_torch.core.schedclient``): the cases of
``tests/test_schedd.py`` in the port — protocol, coalescing, shedding,
deadlines, breaker, journal, worker pool, TCP auth, peer pushes,
fallback — and the port's own:

* a daemon plan of each of the four planners equals the in-process plan;
* ``launch.serve.warm_kernel_plans`` with ``$POLYTOPS_TORCH_SCHEDD_SOCK``
  set plans through the daemon (``remote_ok`` equal to its plans, no
  fallback) and gets the in-process plans;
* a port client in a subprocess, pointed at a *reference* daemon, falls
  back to local planning without unpickling anything of the reference
  (no ``repro`` module enters it), and a reference client falls back
  from the port's daemon;
* the daemon, in a fresh interpreter and as ``python -m
  repro_torch.launch.schedd``, never imports ``torch`` (its worker pool
  forks).

Most daemons here run *in-process* (threads on a temp Unix socket), so
their counters are visible to assertions.  Sockets live in a short
``tempfile.mkdtemp`` under /tmp (``tmp_path`` under xdist can pass the
108-byte AF_UNIX limit); every wait is on an observable counter with a
time limit (:func:`wait_until`), and the keyed-computation tests run at
both worker levels (``workers=0`` inline, ``workers=2`` pooled).
"""
import json
import os
import shutil
import socket as socketlib
import struct
import subprocess
import sys
import tempfile
import threading
import time
from contextlib import contextmanager

import pytest

from repro_torch.core import akg as takg
from repro_torch.core import schedcache as tsc
from repro_torch.core import schedclient as wire
from repro_torch.core.resilience import Deadline
from repro_torch.core.schedclient import (CircuitBreaker, DaemonUnavailable,
                                    Overloaded, ProtocolError, SchedClient,
                                    VersionSkew, WorkerCrashed, local_only,
                                    wire_versions)
from repro_torch.core.schedcache import schedule_fingerprint
from repro_torch.core.scop import Scop
from repro_torch.launch.schedd import AutotuneJournal, SchedDaemon

#: worker levels every keyed-path test runs at: inline and pooled
WORKER_LEVELS = [0, 2]
SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
PLANNERS = {"matmul": takg.plan_matmul, "attention": takg.plan_attention,
            "mamba_scan": takg.plan_mamba_scan, "scan_gate": takg.plan_scan_gate}


def clear_plan_memos():
    for fn in PLANNERS.values():
        fn.cache_clear()


@pytest.fixture(autouse=True)
def _isolated(tmp_path, monkeypatch):
    """The process-global schedule cache in the test's own directory, no
    daemon address in the environment, fresh plan memos and client."""
    monkeypatch.setenv("POLYTOPS_TORCH_CACHE_DIR", str(tmp_path / "global"))
    monkeypatch.setattr(tsc, "_GLOBAL", None)
    for env in (wire.SOCKET_ENV, wire.ADDR_ENV, wire.KEY_ENV):
        monkeypatch.delenv(env, raising=False)
    monkeypatch.setattr(wire, "_DEFAULT", None)
    clear_plan_memos()
    yield
    clear_plan_memos()
    wire._DEFAULT = None


def wait_until(pred, timeout=15.0, interval=0.01, msg="condition"):
    """Poll ``pred`` on the monotonic clock — the only sanctioned way
    to wait for daemon-side state in this file."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if pred():
            return
        time.sleep(interval)
    raise AssertionError(f"timed out after {timeout}s waiting for {msg}")


def tiny_scop(name="schedd_t", n=24):
    s = Scop(name, params={"N": n})
    with s.loop("i", 0, "N"):
        with s.loop("j", 0, "N"):
            s.stmt("A[i,j] = A[i,j] + B[j,i]")
    return s


def other_scop():
    """Structurally distinct from tiny_scop: the cache key fingerprints
    structure, not the scop's name."""
    s = Scop("schedd_other", params={"M": 16})
    with s.loop("i", 0, "M"):
        s.stmt("X[i] = X[i] * 2.0")
    return s


@contextmanager
def daemon(tmp_path, **kwargs):
    # short unique socket dir: AF_UNIX paths cap at ~108 bytes and
    # xdist-nested tmp_path can blow past that
    sdir = tempfile.mkdtemp(prefix="sd-", dir="/tmp")
    sock = os.path.join(sdir, "s.sock")
    kwargs.setdefault("cache_dir", str(tmp_path / "pool"))
    kwargs.setdefault("chaos", True)
    d = SchedDaemon(sock, **kwargs)
    d.start()
    try:
        yield d, sock
    finally:
        d.stop()
        shutil.rmtree(sdir, ignore_errors=True)


# ---------------------------------------------------------------------------
# protocol + roundtrips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_schedule_roundtrip_and_frame_cache(tmp_path, workers):
    with daemon(tmp_path, workers=workers) as (d, sock):
        c = SchedClient(sock, retries=0)
        scop = tiny_scop()
        s1 = c.schedule(scop)
        assert not s1.degraded
        s2 = c.schedule(tiny_scop())
        assert schedule_fingerprint(s1) == schedule_fingerprint(s2)
        assert d.counters["computed"] == 1
        assert d.counters["frame_hits"] == 1
        assert c.stats.remote_ok == 2 and c.stats.fallbacks == 0
        if workers:
            assert d.counters["pool_jobs"] == 1


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_plan_roundtrip_matches_local(tmp_path, workers):
    with daemon(tmp_path, workers=workers) as (_, sock):
        c = SchedClient(sock, retries=0)
        remote = c.plan("matmul", 48, 48, 48)
        with local_only():
            from repro_torch.core import akg
            akg.plan_matmul.cache_clear()
            local = akg.plan_matmul(48, 48, 48)
        assert remote == local
        assert c.stats.fallbacks == 0


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_autotune_roundtrip(tmp_path, workers):
    with daemon(tmp_path, workers=workers) as (d, sock):
        c = SchedClient(sock, retries=0)
        r1 = c.autotune(tiny_scop("schedd_at"), measure=False)
        assert r1.config.label
        r2 = c.autotune(tiny_scop("schedd_at"), measure=False)
        assert r2.config.label == r1.config.label
        assert d.counters["computed"] == 1      # second was a frame hit


def test_ping_stats_shutdown(tmp_path):
    with daemon(tmp_path) as (d, sock):
        c = SchedClient(sock, retries=0)
        assert c.ping()["op"] == "pong"
        st = c.daemon_stats()
        assert st["counters"]["requests"] >= 1
        assert st["versions"] == wire_versions()
        assert st["workers"] == 0 and st["pool"] is None
        assert st["frames"]["entries"] == st["frame_cache"]
        c.shutdown()
        assert d._stop.wait(timeout=5.0)


def test_unknown_op_is_typed(tmp_path):
    with daemon(tmp_path) as (_, sock):
        c = SchedClient(sock, retries=0)
        with pytest.raises(ProtocolError, match="unknown op"):
            c._request({"op": "frobnicate"}, 5.0)


def test_garbage_and_truncated_frames_are_survivable(tmp_path):
    with daemon(tmp_path) as (d, sock):
        # garbage magic -> typed bad_frame reply (or clean close)
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.settimeout(5.0)
        s.connect(sock)
        s.sendall(b"NOPE" + b"\x00" * 64)
        reply = s.recv(1 << 16)
        s.close()
        assert not reply or b"bad_frame" in reply
        # truncated frame -> dropped connection, daemon survives
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.settimeout(5.0)
        s.connect(sock)
        s.sendall(wire.MAGIC + struct.pack(">I", 1024) + b"short")
        s.close()
        wait_until(lambda: d.counters["bad_frames"] >= 1,
                   msg="bad_frames counted")
        assert SchedClient(sock, retries=0).ping()["op"] == "pong"


def test_oversized_length_rejected(tmp_path):
    with daemon(tmp_path) as (_, sock):
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.settimeout(5.0)
        s.connect(sock)
        s.sendall(wire.MAGIC + struct.pack(">I", 0xFFFFFFF0))
        reply = s.recv(1 << 16)
        s.close()
        assert not reply or b"bad_frame" in reply


def test_slow_loris_dropped(tmp_path):
    with daemon(tmp_path, conn_timeout=0.3) as (d, sock):
        s = socketlib.socket(socketlib.AF_UNIX, socketlib.SOCK_STREAM)
        s.settimeout(5.0)
        s.connect(sock)
        s.sendall(wire.MAGIC[:2])        # stall mid-header
        assert s.recv(1) == b""          # daemon hangs up
        s.close()
        assert d.counters["slow_loris"] >= 1
        assert SchedClient(sock, retries=0).ping()["op"] == "pong"


# ---------------------------------------------------------------------------
# coalescing + shedding
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_identical_concurrent_requests_coalesce(tmp_path, workers):
    with daemon(tmp_path, workers=workers) as (d, sock):
        scop = tiny_scop("schedd_co")
        metas = []

        def go():
            c = SchedClient(sock, retries=0, request_timeout=30.0)
            resp = c._request({"op": "schedule", "scop": scop,
                               "test_delay_s": 0.4}, 30.0)
            metas.append(resp["meta"])

        first = threading.Thread(target=go)
        first.start()
        # the rest must arrive while the first owns the flight
        wait_until(lambda: d.counters["computed"] >= 1,
                   msg="first request owns the flight")
        rest = [threading.Thread(target=go) for _ in range(2)]
        for t in rest:
            t.start()
        for t in [first] + rest:
            t.join(timeout=30.0)
        assert len(metas) == 3
        assert d.counters["computed"] == 1
        assert d.counters["coalesced"] == 2


def test_overload_sheds_typed(tmp_path):
    with daemon(tmp_path, max_inflight=1) as (d, sock):
        done = threading.Event()

        def hold():
            c = SchedClient(sock, retries=0, request_timeout=30.0)
            c._request({"op": "schedule", "scop": tiny_scop("schedd_h"),
                        "test_delay_s": 1.0}, 30.0)
            done.set()

        t = threading.Thread(target=hold)
        t.start()
        wait_until(lambda: d.counters["computed"] >= 1,
                   msg="holder occupies the flight table")
        c = SchedClient(sock, retries=0)
        with pytest.raises(Overloaded):
            c._request({"op": "schedule", "scop": other_scop()}, 10.0)
        # the total API serves in-process while the daemon is saturated
        sched = c.schedule(other_scop())
        assert sched is not None
        assert c.stats.fallbacks == 1 and c.stats.overloaded >= 1
        assert done.wait(timeout=30.0)
        t.join(timeout=5.0)
        assert d.counters["shed"] >= 1


# ---------------------------------------------------------------------------
# deadlines + degraded results
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_expired_deadline_degrades_and_is_never_frame_cached(tmp_path,
                                                             workers):
    with daemon(tmp_path, workers=workers) as (d, sock):
        c = SchedClient(sock, retries=0)
        scop = tiny_scop("schedd_dl")
        r1 = c._request({"op": "schedule", "scop": scop,
                         "deadline_s": 0.0}, 10.0)
        assert r1["meta"]["degraded"]
        r2 = c._request({"op": "schedule", "scop": scop,
                         "deadline_s": 0.0}, 10.0)
        assert r2["meta"]["degraded"]
        # both computed: a degraded response must never be served warm
        assert d.counters["computed"] == 2
        assert d.counters["frame_hits"] == 0
        assert d.counters["degraded"] == 2


def test_client_exhausted_deadline_falls_back_without_dialing(tmp_path):
    from repro_torch.core.schedcache import ScheduleCache

    with daemon(tmp_path) as (d, sock):
        # isolated fallback cache: the key is structural, so a warm hit
        # from the process-global pool would serve a clean schedule and
        # mask the deadline degradation this test asserts
        c = SchedClient(sock, retries=0,
                        cache=ScheduleCache(cache_dir=str(tmp_path / "fb")))
        dl = Deadline(0.0)
        wait_until(lambda: dl.elapsed() > 0.0, msg="deadline clock ticks")
        sched = c.schedule(tiny_scop("schedd_dl2"), deadline=dl)
        assert sched.degraded              # local ladder, identity rung
        assert c.stats.fallbacks == 1
        assert d.counters["requests"] == 0  # never reached the daemon


# ---------------------------------------------------------------------------
# worker pool
# ---------------------------------------------------------------------------


def test_pool_distinct_keys_overlap(tmp_path):
    """Two distinct-key holds on two workers must overlap — the proof
    the pool actually escapes the single-process serialization."""
    with daemon(tmp_path, workers=2) as (d, sock):
        results = []

        def go(i, n, delay):
            c = SchedClient(sock, retries=0, request_timeout=30.0)
            results.append(c._request(
                {"op": "schedule", "scop": tiny_scop(f"schedd_p{i}", n),
                 "test_delay_s": delay}, 30.0))

        def both(n0, delay):
            # two *structurally distinct* scops (the key fingerprints
            # structure, so the sizes must differ), one per worker
            threads = [threading.Thread(target=go, args=(i, n0 + i, delay))
                       for i in range(2)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(timeout=30.0)

        # warmup: the first job on each worker pays one-time lazy-init
        # cost; measuring it would only test fork latency
        both(18, 0.2)
        results.clear()
        t0 = time.monotonic()
        both(24, 0.8)
        elapsed = time.monotonic() - t0
        assert len(results) == 2 and all(r["ok"] for r in results)
        # steady state measures ~0.83s; serialized would be >= 1.6s
        assert elapsed < 1.5, f"holds serialized: {elapsed:.2f}s"
        assert d.counters["pool_jobs"] == 4
        # the holds ran in workers, not the daemon process
        pids = {r["meta"]["pid"] for r in results}
        assert os.getpid() not in pids


def test_pool_poison_request_is_typed_and_bounded(tmp_path):
    """A request that SIGKILLs its worker burns exactly two workers
    (one retry on a fresh fork), then surfaces as WorkerCrashed; the
    pool respawns and stays healthy."""
    with daemon(tmp_path, workers=2) as (d, sock):
        c = SchedClient(sock, retries=0, request_timeout=60.0)
        with pytest.raises(WorkerCrashed):
            c._request({"op": "schedule", "scop": tiny_scop("schedd_px"),
                        "test_kill_worker": True}, 60.0)
        assert d.counters["worker_crashes"] == 2
        assert d.pool.stats()["crashes"] == 2
        # respawn restored the pool size
        wait_until(lambda: d.pool.stats()["idle"] == 2,
                   msg="pool respawned to full strength")
        # and it still serves
        sched = c.schedule(tiny_scop("schedd_px2"))
        assert not sched.degraded
        # WorkerCrashed is a SchedClientError, so the client's total
        # API (schedule/autotune) falls back in-process on it — same
        # contract the breaker/fallback tests pin for the other kinds
        from repro_torch.core.schedclient import SchedClientError
        assert issubclass(WorkerCrashed, SchedClientError)


def test_pool_worker_kill9_between_jobs_is_respawned(tmp_path):
    """kill -9 of an idle worker: the corpse is detected at the next
    acquire, counted, replaced, and the job runs on the fresh fork."""
    import signal as _signal

    with daemon(tmp_path, workers=1) as (d, sock):
        victim = d.pool._procs[0].proc
        os.kill(victim.pid, _signal.SIGKILL)
        victim.join(timeout=10.0)
        assert not victim.is_alive()
        c = SchedClient(sock, retries=0, request_timeout=30.0)
        sched = c.schedule(tiny_scop("schedd_k9"))
        assert not sched.degraded
        assert d.pool.stats()["crashes"] == 1
        assert d.pool.stats()["spawned"] == 2


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_winner_push_warms_schedule_frame(tmp_path, workers):
    """An autotune winner's schedule is pushed into the frame cache, so
    the follow-up schedule request for the tuned config is a warm hit
    that never touches the solver."""
    with daemon(tmp_path, workers=workers) as (d, sock):
        c = SchedClient(sock, retries=0, request_timeout=60.0)
        r = c.autotune(tiny_scop("schedd_wp"), measure=False, top_k=2)
        assert not r.degraded
        assert d.counters["winner_pushes"] == 1
        computed = d.counters["computed"]
        sched = c.schedule(tiny_scop("schedd_wp"),
                           config=r.config.scheduler_config())
        assert not sched.degraded
        assert d.counters["computed"] == computed      # no new flight
        assert d.counters["frame_hits"] == 1


def test_pool_crash_is_witnessed_not_orphaned(tmp_path):
    """A worker kill -9 mid-autotune is journalled as `crashed` by the
    surviving daemon — so a later restart does NOT re-count it as an
    unwitnessed orphan."""
    pool_dir = tmp_path / "pool"
    with daemon(tmp_path, workers=1, cache_dir=str(pool_dir)) as (d, sock):
        c = SchedClient(sock, retries=0, request_timeout=60.0)
        with pytest.raises(WorkerCrashed):
            c._request({"op": "autotune", "scop": tiny_scop("schedd_jw"),
                        "kwargs": {"measure": False},
                        "test_kill_worker": True}, 60.0)
        assert d.counters["worker_crashes"] == 2
    journal = AutotuneJournal(str(pool_dir / "schedd_journal.jsonl"))
    assert journal.recover() == []         # witnessed, not orphaned


def test_frames_snapshot_accounts_eviction(tmp_path):
    """The daemon's stats surface the latency-saved frame cache: entry
    cap enforced, evictions counted, retained latency tracked."""
    with daemon(tmp_path, frame_cache_cap=2) as (d, sock):
        c = SchedClient(sock, retries=0)
        for i in range(4):
            c.plan("matmul", 32 + 8 * i, 32, 32)
        st = c.daemon_stats()
        assert st["frames"]["entries"] <= 2
        assert st["frames"]["stats"]["evicted"] >= 2
        assert st["frames"]["retained_latency_s"] >= 0.0
        assert st["frame_cache"] == st["frames"]["entries"]


# ---------------------------------------------------------------------------
# version handshake + breaker + fallback
# ---------------------------------------------------------------------------


def test_version_skew_rejected_and_breaker_opens(tmp_path):
    with daemon(tmp_path) as (d, sock):
        stale = dict(wire_versions(), cache=-99)
        c = SchedClient(sock, retries=2, versions=stale)
        with pytest.raises(VersionSkew):
            c.remote_plan("matmul", 32, 32, 32)
        assert c.stats.retries == 0        # skew is not transient
        assert c.breaker.state != "closed"
        sched = c.schedule(tiny_scop("schedd_vs"))
        assert sched is not None
        assert c.stats.fallbacks == 1
        assert c.stats.breaker_skips == 1  # went straight to fallback
        assert d.counters["version_skew"] >= 1


def test_missing_socket_falls_back_and_breaker_trips(tmp_path):
    c = SchedClient(str(tmp_path / "nope.sock"), retries=1,
                    connect_timeout=0.2, breaker_threshold=2)
    with pytest.raises(DaemonUnavailable):
        c.remote_plan("matmul", 32, 32, 32)
    sched = c.schedule(tiny_scop("schedd_ms"))
    assert sched is not None and not sched.degraded
    assert c.stats.fallbacks == 1
    assert c.breaker.state == "open"
    before = c.stats.remote_errors
    c.schedule(tiny_scop("schedd_ms"))
    assert c.stats.breaker_skips >= 1
    assert c.stats.remote_errors == before   # open breaker: no dialing


def test_breaker_half_open_recovers():
    t = [0.0]
    b = CircuitBreaker(threshold=2, reset_s=5.0, clock=lambda: t[0])
    assert b.state == "closed"
    b.failure()
    assert b.allow()
    b.failure()
    assert b.state == "open" and not b.allow()
    t[0] = 6.0
    assert b.allow()                   # the single half-open probe
    assert b.state == "half-open" and not b.allow()
    b.success()
    assert b.state == "closed" and b.allow()
    # a failing probe re-opens for another window
    b.failure()
    b.failure()
    t[0] = 12.0
    assert b.allow()
    b.failure()
    assert b.state == "open" and not b.allow()


def test_maybe_client_respects_env_and_server_guard(tmp_path, monkeypatch):
    monkeypatch.delenv(wire.SOCKET_ENV, raising=False)
    assert wire.maybe_client() is None
    monkeypatch.setenv(wire.SOCKET_ENV, str(tmp_path / "x.sock"))
    wire._DEFAULT = None
    assert wire.maybe_client() is not None
    monkeypatch.setattr(wire, "_SERVER_PROCESS", True)
    assert wire.maybe_client() is None
    monkeypatch.setattr(wire, "_SERVER_PROCESS", False)
    with local_only():
        assert wire.maybe_remote_plan("matmul", 8, 8, 8) is None
    wire._DEFAULT = None


def test_akg_routes_through_daemon(tmp_path, monkeypatch):
    from repro_torch.core import akg

    with daemon(tmp_path) as (d, sock):
        monkeypatch.setenv(wire.SOCKET_ENV, sock)
        wire._DEFAULT = None
        akg.plan_matmul.cache_clear()
        try:
            plan = akg.plan_matmul(40, 40, 40)
            assert not plan.degraded
            assert d.counters["requests"] >= 1
            assert d.counters["computed"] == 1
        finally:
            akg.plan_matmul.cache_clear()
            wire._DEFAULT = None


# ---------------------------------------------------------------------------
# journal
# ---------------------------------------------------------------------------


def test_journal_recover_counts_orphans(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = AutotuneJournal(path)
    j.begin("aaa")
    j.done("aaa")
    j.begin("bbb")                      # orphan: a crash mid-request
    j.begin("ccc")
    with open(path, "a") as f:
        f.write('{"ev": "beg')          # torn tail from a kill -9
    assert AutotuneJournal(path).recover() == ["bbb", "ccc"]
    # recovery truncates: a second recover sees a clean journal
    assert AutotuneJournal(path).recover() == []


def test_journal_crashed_completes_begin(tmp_path):
    path = str(tmp_path / "journal.jsonl")
    j = AutotuneJournal(path)
    j.begin("xx")
    j.crashed("xx", "worker pid 123 died")   # witnessed: not an orphan
    j.begin("yy")                            # unwitnessed: an orphan
    assert AutotuneJournal(path).recover() == ["yy"]


def test_daemon_surfaces_recovered_journal(tmp_path):
    pool = tmp_path / "pool"
    pool.mkdir()
    j = AutotuneJournal(str(pool / "schedd_journal.jsonl"))
    j.begin("orphaned-by-kill9")
    with daemon(tmp_path, cache_dir=str(pool)) as (d, sock):
        st = SchedClient(sock, retries=0).daemon_stats()
        assert st["journal_recovered"] == 1
        assert st["journal_recovered_keys"] == ["orphaned-by-kill9"]


# ---------------------------------------------------------------------------
# TCP transport + auth
# ---------------------------------------------------------------------------

TCP_KEY = b"test-shared-key"


@contextmanager
def tcp_daemon(tmp_path, key=TCP_KEY, **kwargs):
    kwargs.setdefault("cache_dir", str(tmp_path / "pool"))
    kwargs.setdefault("chaos", True)
    d = SchedDaemon(None, listen="127.0.0.1:0", auth_key=key, **kwargs)
    d.start()
    try:
        yield d, f"127.0.0.1:{d.tcp_port}"
    finally:
        d.stop()


def test_tcp_requires_key():
    with pytest.raises(ValueError, match="without a shared key"):
        SchedDaemon(None, listen="127.0.0.1:0", auth_key=None)


def test_tcp_roundtrip_and_frame_cache(tmp_path):
    with tcp_daemon(tmp_path) as (d, addr):
        c = SchedClient(addr, retries=0, key=TCP_KEY)
        s1 = c.schedule(tiny_scop())
        assert not s1.degraded
        s2 = c.schedule(tiny_scop())
        assert schedule_fingerprint(s1) == schedule_fingerprint(s2)
        assert d.counters["computed"] == 1
        assert d.counters["frame_hits"] == 1
        assert c.stats.remote_ok == 2 and c.stats.fallbacks == 0
        c.close()


def test_tcp_connection_reuse_one_handshake(tmp_path):
    """Pooled connections: N sequential requests cost ONE dial (one
    version/auth handshake), not N — the whole point of reuse over TCP."""
    with tcp_daemon(tmp_path) as (d, addr):
        c = SchedClient(addr, retries=0, key=TCP_KEY)
        for _ in range(5):
            assert c.ping()["ok"]
        snap = c.stats.as_dict()
        assert snap["dials"] == 1
        assert snap["reuses"] == 4
        c.close()


def test_tcp_wrong_key_typed_and_daemon_survives(tmp_path):
    with tcp_daemon(tmp_path) as (d, addr):
        bad = SchedClient(addr, retries=0, key=b"not-the-key")
        with pytest.raises(wire.AuthFailed):
            bad.ping()                 # raw path raises typed
        wait_until(lambda: d.counters["auth_failed"] >= 1,
                   msg="daemon-side auth_failed count")
        # the public API degrades to the fallback, not a raise — and
        # the auth failure trips the breaker immediately (not transient)
        sched = bad.schedule(tiny_scop("schedd_tcpw"))
        assert sched is not None
        assert bad.stats.fallbacks == 1
        assert bad.stats.auth_failed == 1
        assert bad.breaker.state == "open"
        # the daemon keeps serving authenticated clients
        good = SchedClient(addr, retries=0, key=TCP_KEY)
        assert good.ping()["ok"]
        good.close()


def test_tcp_missing_key_is_typed(tmp_path):
    with tcp_daemon(tmp_path) as (d, addr):
        c = SchedClient(addr, retries=0, key=None)
        c.key = None                   # defeat any ambient env key
        with pytest.raises(wire.AuthFailed, match="no key"):
            c.ping()


def test_tcp_tampered_mac_rejected_conn_dropped(tmp_path):
    """A post-handshake frame whose MAC does not verify gets a typed
    auth_failed reply and a dropped connection — never unpickled."""
    with tcp_daemon(tmp_path) as (d, addr):
        host, port = addr.rsplit(":", 1)
        s = socketlib.create_connection((host, int(port)), timeout=5.0)
        try:
            _, session = wire.client_handshake(
                s, {"op": "hello", **wire_versions()}, key=TCP_KEY)
            frame = bytearray(wire.encode_frame({"op": "ping"},
                                                session=session))
            frame[-1] ^= 0xFF                      # corrupt the MAC
            s.sendall(bytes(frame))
            reply = wire.recv_frame(s, session=session, eof_ok=True)
            assert reply is not None and reply["error"] == "auth_failed"
            wait_until(lambda: d.counters["auth_failed"] >= 1,
                       msg="auth_failed counter")
        finally:
            s.close()
        # unpoisoned: the daemon still serves
        good = SchedClient(addr, retries=0, key=TCP_KEY)
        assert good.ping()["ok"]
        good.close()


def test_tcp_idle_conn_closed_quietly_then_redialed(tmp_path):
    """A pooled connection the daemon idle-closes is NOT a slow-loris
    (separate counter) and the client transparently redials."""
    with tcp_daemon(tmp_path, conn_timeout=0.3) as (d, addr):
        c = SchedClient(addr, retries=0, key=TCP_KEY)
        assert c.ping()["ok"]
        wait_until(lambda: d.counters["idle_closed"] >= 1,
                   msg="idle close")
        assert d.counters["slow_loris"] == 0
        assert c.ping()["ok"]          # stale pooled conn -> one redial
        assert c.stats.dials == 2
        assert c.stats.remote_errors == 0
        c.close()


def test_addr_env_routes_client(tmp_path, monkeypatch):
    with tcp_daemon(tmp_path) as (d, addr):
        monkeypatch.setenv(wire.ADDR_ENV, addr)
        monkeypatch.setenv(wire.KEY_ENV, TCP_KEY.decode())
        monkeypatch.delenv(wire.SOCKET_ENV, raising=False)
        wire._DEFAULT = None
        try:
            c = wire.maybe_client()
            assert c is not None and c.sock_path == addr
            assert c.ping()["ok"]
        finally:
            wire._DEFAULT = None


def test_peer_winner_push_between_daemons(tmp_path):
    """Daemon A's autotune winner lands in daemon B's frame cache: a
    schedule request for the tuned config on B is a warm frame hit
    with zero computes."""
    with tcp_daemon(tmp_path, cache_dir=str(tmp_path / "pb")) as (db, addr_b):
        with tcp_daemon(tmp_path, cache_dir=str(tmp_path / "pa"),
                        peers=(addr_b,)) as (da, addr_a):
            ca = SchedClient(addr_a, retries=0, key=TCP_KEY,
                             request_timeout=60.0)
            r = ca.autotune(tiny_scop("schedd_pp"), measure=False, top_k=2)
            assert not r.degraded
            assert da.counters["winner_pushes"] == 1
            wait_until(lambda: db.counters["peer_pushes_recv"] >= 1,
                       msg="peer push arrival")
            wait_until(lambda: da.counters["peer_pushes_sent"] >= 1,
                       msg="peer push sent count")
            cb = SchedClient(addr_b, retries=0, key=TCP_KEY)
            sched = cb.schedule(tiny_scop("schedd_pp"),
                                config=r.config.scheduler_config())
            assert not sched.degraded
            assert db.counters["frame_hits"] == 1
            assert db.counters["computed"] == 0
            ca.close(); cb.close()


def test_winner_push_storm_cap(tmp_path):
    """Admitted peer pushes are bounded per sliding window: a push storm
    cannot churn the frame cache.  Refusals are typed (admitted=False,
    capped=True) and tallied on both the daemon counters and the frame
    cache's CacheStats; once the window slides past, pushes admit
    again."""
    with tcp_daemon(tmp_path, push_storm_max=2,
                    push_storm_window=60.0) as (d, addr):
        c = SchedClient(addr, retries=0, key=TCP_KEY)

        def push(i):
            return c._request(
                {"op": "winner_push",
                 "key": ("schedule", f"storm-{i}", False),
                 "resp": {"ok": True, "schedule": None,
                          "meta": {"degraded": False}},
                 "compute_s": 1.0}, 5.0)

        rs = [push(i) for i in range(5)]
        assert [bool(r.get("admitted")) for r in rs] == \
            [True, True, False, False, False]
        assert all(rs[i].get("capped") for i in range(2, 5))
        assert d.counters["peer_pushes_recv"] == 2
        assert d.counters["peer_pushes_capped"] == 3
        assert d._frames.stats["push_capped"] == 3
        # slide the window: pretend the admits happened long ago
        with d._lock:
            d._push_admits.clear()
        assert push(9).get("admitted") is True
        c.close()


def test_winner_push_op_validates(tmp_path):
    """The winner_push op rejects degraded/malformed pushes with a
    typed error instead of admitting poison."""
    with tcp_daemon(tmp_path) as (d, addr):
        c = SchedClient(addr, retries=0, key=TCP_KEY)
        with pytest.raises(ProtocolError):
            c._request({"op": "winner_push"}, 5.0)
        with pytest.raises(ProtocolError):
            c._request({"op": "winner_push", "key": ("schedule", "k", False),
                        "resp": {"ok": True,
                                 "meta": {"degraded": True}}}, 5.0)
        assert d.counters["peer_pushes_recv"] == 0
        c.close()


# ---------------------------------------------------------------------------
# the port's planners through the daemon
# ---------------------------------------------------------------------------

PLAN_ARGS = {"matmul": (64, 256, 128), "attention": (64, 256, 64),
             "mamba_scan": (64, 256, 16), "scan_gate": (64, 256, 16)}


def local_plan(kind, args):
    with local_only():
        PLANNERS[kind].cache_clear()
        return PLANNERS[kind](*args)


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_daemon_plans_equal_in_process_plans(tmp_path, workers):
    with daemon(tmp_path, workers=workers) as (d, sock):
        c = SchedClient(sock, retries=0, request_timeout=120.0)
        for kind, args in PLAN_ARGS.items():
            remote = c.remote_plan(kind, *args)
            assert type(remote) is takg.KernelPlan
            assert remote == local_plan(kind, args), kind
            assert remote.tile == local_plan(kind, args).tile
            assert not remote.degraded
        assert c.stats.remote_ok == len(PLAN_ARGS) and c.stats.fallbacks == 0
        assert d.counters["computed"] == len(PLAN_ARGS)
        if workers:
            assert d.counters["pool_jobs"] == len(PLAN_ARGS)


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_warm_kernel_plans_through_the_daemon(tmp_path, workers, monkeypatch,
                                              capsys):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve

    cfg = get_arch("granite_3_2b").smoke()
    with daemon(tmp_path, workers=workers) as (d, sock):
        monkeypatch.setenv(wire.SOCKET_ENV, sock)
        plans = serve.warm_kernel_plans(cfg, 64, 16, rows=(5,))
        out = capsys.readouterr().out
        assert f"warmed via schedd ({sock}, remote_ok={len(plans)} fallbacks=0)" in out
        assert d.counters["computed"] == len(plans)
        # memoized: a second warm-up asks nobody
        again = serve.warm_kernel_plans(cfg, 64, 16, rows=(5,))
        assert "remote_ok=0 fallbacks=0" in capsys.readouterr().out
        assert again == plans
    shapes = serve.kernel_plan_shapes(cfg, 64, 16, (5,))
    assert plans == [local_plan(kind, args) for kind, args in shapes]


def test_warm_kernel_plans_in_process_without_a_daemon(capsys):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import serve

    plans = serve.warm_kernel_plans(get_arch("granite_3_2b").smoke(), 64, 16)
    assert f"serve: {len(plans)} kernel plans warmed in-process" in \
        capsys.readouterr().out


def test_unreachable_daemon_counts_a_fallback(tmp_path, monkeypatch):
    monkeypatch.setenv(wire.SOCKET_ENV, str(tmp_path / "absent.sock"))
    plan = takg.plan_matmul(64, 256, 128)
    c = wire.maybe_client()
    assert c.stats.remote_ok == 0 and c.stats.fallbacks == 1
    assert plan == local_plan("matmul", (64, 256, 128))


@contextmanager
def reference_daemon(tmp_path):
    from repro.launch.schedd import SchedDaemon as RefDaemon

    sdir = tempfile.mkdtemp(prefix="sd-", dir="/tmp")
    sock = os.path.join(sdir, "s.sock")
    d = RefDaemon(sock, cache_dir=str(tmp_path / "refpool"))
    d.start()
    try:
        yield d, sock
    finally:
        d.stop()
        shutil.rmtree(sdir, ignore_errors=True)


PORT_CLIENT = """
import json, sys
from repro_torch import plan as P
from repro_torch.core.schedclient import maybe_client
p = P.plan_matmul(64, 256, 128)
print(json.dumps({"tile": p.tile, "order": list(p.loop_order),
                  "stats": maybe_client().stats.as_dict(),
                  "repro": sorted(m for m in sys.modules
                                  if m == "repro" or m.startswith("repro.")),
                  "torch": "torch" in sys.modules, "jax": "jax" in sys.modules}))
"""


def test_port_client_falls_back_from_a_reference_daemon(tmp_path):
    with reference_daemon(tmp_path) as (d, sock):
        env = dict(os.environ, PYTHONPATH=SRC,
                   POLYTOPS_TORCH_CACHE_DIR=str(tmp_path / "client"),
                   **{wire.SOCKET_ENV: sock})
        out = subprocess.run([sys.executable, "-c", PORT_CLIENT], env=env,
                             capture_output=True, text=True, timeout=120)
        assert out.returncode == 0, out.stderr
        got = json.loads(out.stdout.strip().splitlines()[-1])
        assert got["stats"]["remote_ok"] == 0
        assert got["stats"]["fallbacks"] == 1
        assert got["repro"] == [] and not got["jax"] and not got["torch"]
        want = local_plan("matmul", (64, 256, 128))
        assert got["tile"] == want.tile and tuple(got["order"]) == want.loop_order
        wait_until(lambda: d.counters["bad_frames"] >= 1,
                   msg="the reference daemon refused the port's frame")
        assert d.counters["computed"] == 0


def test_reference_client_falls_back_from_the_port_daemon(tmp_path):
    from repro.core.schedclient import DaemonUnavailable as RefUnavailable
    from repro.core.schedclient import ProtocolError as RefProtocolError
    from repro.core.schedclient import SchedClient as RefClient

    with daemon(tmp_path) as (d, sock):
        c = RefClient(sock, retries=0)
        with pytest.raises((RefProtocolError, RefUnavailable)):
            c.ping()
        wait_until(lambda: d.counters["bad_frames"] >= 1,
                   msg="the port's daemon refused the reference's frame")
        assert d.counters["computed"] == 0


DAEMON_IN_FRESH_INTERPRETER = """
import json, os, sys
import repro_torch.launch.schedd as S
from repro_torch.core.schedclient import SchedClient
sock, cache = sys.argv[1], sys.argv[2]
d = S.SchedDaemon(sock, cache_dir=cache, workers=int(sys.argv[3]))
d.start()
try:
    p = SchedClient(sock, retries=0).remote_plan("matmul", 64, 256, 128)
    stats = d.stats()
finally:
    d.stop()
print(json.dumps({"tile": p.tile, "computed": stats["counters"]["computed"],
                  "torch": sorted(m for m in sys.modules if m.split(".")[0] == "torch"),
                  "repro": sorted(m for m in sys.modules if m.split(".")[0] == "repro")}))
"""


CORE_IMPORTS = """
import importlib, json, pkgutil, sys
import repro_torch.core
names = [m.name for m in pkgutil.walk_packages(repro_torch.core.__path__,
                                               "repro_torch.core.")]
names += ["repro_torch.plan", "repro_torch.launch.schedd"]
for name in names:
    importlib.import_module(name)
print(json.dumps({"names": names,
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("torch", "repro", "jax"))}))
"""


def test_core_and_daemon_modules_import_no_torch():
    """Every module of ``repro_torch.core``, ``plan`` and the daemon, in a
    fresh interpreter: none brings in ``torch`` (or the reference)."""
    out = subprocess.run([sys.executable, "-c", CORE_IMPORTS],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert {"repro_torch.core.wire", "repro_torch.core.schedclient",
            "repro_torch.core.autotune", "repro_torch.core.crunner",
            "repro_torch.core.scops_polybench"} <= set(got["names"])
    assert got["foreign"] == []


@pytest.mark.parametrize("workers", WORKER_LEVELS)
def test_daemon_never_imports_torch(tmp_path, workers):
    sdir = tempfile.mkdtemp(prefix="sd-", dir="/tmp")
    try:
        out = subprocess.run(
            [sys.executable, "-c", DAEMON_IN_FRESH_INTERPRETER,
             os.path.join(sdir, "s.sock"), str(tmp_path / "pool"), str(workers)],
            env=dict(os.environ, PYTHONPATH=SRC), capture_output=True, text=True,
            timeout=120)
    finally:
        shutil.rmtree(sdir, ignore_errors=True)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["computed"] == 1
    assert got["torch"] == [] and got["repro"] == []
    assert got["tile"] == local_plan("matmul", (64, 256, 128)).tile


def test_cli_daemon_serves_and_stops(tmp_path):
    """``python -m repro_torch.launch.schedd`` with a worker pool: plans
    through it equal the in-process plans; shutdown exits it cleanly."""
    sdir = tempfile.mkdtemp(prefix="sd-", dir="/tmp")
    sock = os.path.join(sdir, "s.sock")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.schedd", "--sock", sock,
         "--cache-dir", str(tmp_path / "pool"), "--workers", "2"],
        env=dict(os.environ, PYTHONPATH=SRC), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True)
    try:
        c = SchedClient(sock, retries=0, request_timeout=120.0)

        def up():
            try:
                return c.ping(timeout=1.0)["ok"]
            except (DaemonUnavailable, ProtocolError):
                return False

        wait_until(up, timeout=60.0, interval=0.1, msg="the daemon listening")
        for kind in ("matmul", "attention"):
            assert c.remote_plan(kind, *PLAN_ARGS[kind]) == \
                local_plan(kind, PLAN_ARGS[kind])
        st = c.daemon_stats()
        assert st["pool"]["jobs"] == 2 and st["cache_dir"] == str(tmp_path / "pool")
        c.shutdown()
        out, _ = proc.communicate(timeout=60)
        assert proc.returncode == 0, out
        assert "workers 2" in out and "schedd: stopped" in out
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=10)
        shutil.rmtree(sdir, ignore_errors=True)


def test_default_socket_path_is_the_ports(monkeypatch):
    from repro_torch.launch.schedd import default_socket_path

    monkeypatch.delenv(wire.SOCKET_ENV, raising=False)
    assert default_socket_path().endswith(
        os.path.join(".cache", "polytops_torch", "schedd.sock"))
    monkeypatch.setenv(wire.SOCKET_ENV, "/tmp/x.sock")
    assert default_socket_path() == "/tmp/x.sock"
