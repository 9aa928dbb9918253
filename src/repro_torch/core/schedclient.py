"""Scheduling-service client: resilient fallback client over the shared
wire layer.

``repro_torch.launch.schedd`` turns the hardened scheduling pipeline (the
degradation ladder, deadlines and crash-safe caches) into a long-lived *service* so
concurrent compiles from many client processes amortize one scheduler
instead of repeating it.  This module is the client side; the frame
protocol, handshake, and typed error family live in
:mod:`repro_torch.core.wire` (shared with the daemon) and are re-exported
here for compatibility.

* **Wire protocol + trust boundary** — length-prefixed frames
  (``MAGIC | uint32 length | body``), JSON for the handshake, pickle
  for requests/responses.  Each connection opens with a version
  handshake carrying ``PROTOCOL_VERSION`` plus the three
  cache-compatibility versions — a stale peer on either side is
  rejected with a typed ``version_skew`` before any request is served.
  Pickle over the wire is only safe against peers who could already
  run code as us, so each transport pins that down differently: the
  **Unix socket** lives in a user-owned 0o600 directory, so any peer
  that can connect can already write our cache files; the **TCP
  transport** requires a shared key (``$POLYTOPS_TORCH_SCHEDD_KEY`` /
  ``--keyfile``) proven by an HMAC-SHA256 challenge–response inside
  the hello, after which every frame carries a per-direction
  sequence-numbered MAC that is verified *before* the body is
  unpickled.  Handshake frames are JSON with a small pre-auth size
  cap, so an unauthenticated TCP peer can never reach ``pickle.loads``
  or make the daemon buffer a 64 MiB frame.

* **Typed errors** — every way a request can fail maps to one
  exception class (:class:`Overloaded`, :class:`VersionSkew`,
  :class:`ProtocolError`, :class:`DaemonUnavailable`,
  :class:`AuthFailed`, :class:`RemoteError`), mirroring the daemon's
  wire-level error kinds.

* **The resilient client** — :class:`SchedClient` wraps every request
  in bounded retry-with-backoff and a circuit breaker, propagates the
  caller's :class:`~repro_torch.core.resilience.Deadline` onto the wire
  (``deadline_s`` = remaining budget; the daemon resumes it
  server-side) and clips the socket timeout to it, **reuses pooled
  connections** (the handshake runs once per connection, not once per
  request — two round-trips saved per call over TCP; a stale pooled
  connection is redialed transparently once), and **falls back
  in-process** when the daemon is down, overloaded, version-skewed,
  auth-rejected, or misbehaving: ``schedule`` falls back to the
  degradation ladder over ``cached_schedule_scop``, ``autotune`` to
  the local tuner, ``plan`` to the local ``akg`` planners.  The public
  API therefore *never* raises for daemon trouble — the worst case is
  the same in-process behaviour the codebase had before the daemon
  existed, with the fallback counted in :class:`ClientStats`.

The module-level :func:`maybe_client` / :func:`maybe_remote_plan`
helpers are the integration seam: ``akg``'s plan functions and
``launch/serve.py`` route through the daemon exactly when
``$POLYTOPS_TORCH_SCHEDD_ADDR`` (a ``host:port`` or socket path) or
``$POLYTOPS_TORCH_SCHEDD_SOCK`` names one, and never from inside the
daemon's own process (:func:`mark_server_process` guards recursion).
"""
from __future__ import annotations

import os
import socket
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Union

from .resilience import Deadline
from .wire import (  # noqa: F401  (re-exported compatibility surface)
    ADDR_ENV,
    HEADER_LEN,
    KEY_ENV,
    MAC_LEN,
    MAGIC,
    MAX_FRAME_BYTES,
    PRE_AUTH_MAX_FRAME_BYTES,
    PROTOCOL_VERSION,
    SOCKET_ENV,
    AuthFailed,
    DaemonUnavailable,
    Overloaded,
    ProtocolError,
    RemoteError,
    SchedClientError,
    Session,
    VersionSkew,
    WorkerCrashed,
    _HEADER,
    client_handshake,
    encode_frame,
    is_tcp_address,
    load_key,
    normalize_key,
    parse_address,
    recv_frame,
    response_error,
    send_frame,
    version_skew,
    wire_versions,
)
from .wire import _recv_exact  # noqa: F401  (test surface)

#: retrying is pointless unless at least this much deadline budget
#: remains *after* the backoff nap — below it, the retried request
#: would be dead on arrival
MIN_RETRY_BUDGET_S = 0.05


# ---------------------------------------------------------------------------
# circuit breaker
# ---------------------------------------------------------------------------


class CircuitBreaker:
    """Consecutive-failure breaker with a single half-open probe.

    ``threshold`` whole-call failures open the circuit for ``reset_s``;
    after that one probe call is let through — success closes the
    circuit, failure re-opens it for another ``reset_s``.  While open,
    :meth:`allow` returns False and the client skips the daemon
    entirely (straight to the in-process fallback) — a dead daemon
    costs one failed ``connect`` per reset window, not per request."""

    def __init__(self, threshold: int = 3, reset_s: float = 5.0,
                 clock=time.monotonic):
        self.threshold = threshold
        self.reset_s = reset_s
        self._clock = clock
        self._lock = threading.Lock()
        self.failures = 0
        self.opens = 0
        self._opened_at: Optional[float] = None
        self._probing = False

    @property
    def state(self) -> str:
        with self._lock:
            if self._opened_at is None:
                return "closed"
            return "half-open" if self._probing else "open"

    def allow(self) -> bool:
        with self._lock:
            if self._opened_at is None:
                return True
            if self._probing:
                return False
            if self._clock() - self._opened_at >= self.reset_s:
                self._probing = True    # one probe through
                return True
            return False

    def success(self) -> None:
        with self._lock:
            self.failures = 0
            self._opened_at = None
            self._probing = False

    def failure(self) -> None:
        with self._lock:
            self.failures += 1
            if self._probing or self.failures >= self.threshold:
                self._trip_locked()

    def trip(self) -> None:
        """Open immediately (version skew / auth: retrying cannot help)."""
        with self._lock:
            self._trip_locked()

    def _trip_locked(self) -> None:
        if self._opened_at is None or self._probing:
            self.opens += 1
        self._opened_at = self._clock()
        self._probing = False


# ---------------------------------------------------------------------------
# the client
# ---------------------------------------------------------------------------


class ClientStats:
    """Every client-side outcome, counted (same spirit as CacheStats).

    A :class:`SchedClient` is shared across daemon/connection threads,
    so increments go through :meth:`incr` under a lock — a plain
    ``+=`` on a shared counter loses updates under contention."""

    FIELDS = ("remote_ok", "remote_errors", "retries", "fallbacks",
              "overloaded", "version_skew", "auth_failed",
              "breaker_skips", "dials", "reuses")

    remote_ok: int          # requests answered by the daemon
    remote_errors: int      # failed attempts (before retry/fallback)
    retries: int
    fallbacks: int          # requests served by the in-process path
    overloaded: int         # typed load-shed replies received
    version_skew: int
    auth_failed: int        # typed auth rejections (TCP)
    breaker_skips: int      # requests that never tried the daemon
    dials: int              # fresh connections opened (handshakes run)
    reuses: int             # requests served over a pooled connection

    def __init__(self) -> None:
        self._lock = threading.Lock()
        for f in self.FIELDS:
            setattr(self, f, 0)

    def incr(self, field: str, n: int = 1) -> None:
        assert field in self.FIELDS, field
        with self._lock:
            setattr(self, field, getattr(self, field) + n)

    def as_dict(self) -> Dict[str, int]:
        with self._lock:
            return {f: getattr(self, f) for f in self.FIELDS}


class _PooledConn:
    """A live, handshaken connection parked for reuse."""

    __slots__ = ("sock", "session")

    def __init__(self, sock: socket.socket, session: Optional[Session]):
        self.sock = sock
        self.session = session

    def close(self) -> None:
        try:
            self.sock.close()
        except OSError:
            pass


class SchedClient:
    """Resilient client for the ``repro_torch.launch.schedd`` daemon.

    The public entry points (:meth:`schedule`, :meth:`autotune`,
    :meth:`plan`) are *total*: any daemon trouble — down, overloaded,
    version-skewed, auth-rejected, garbage on the wire, deadline
    exhausted before the request could even be sent — degrades to the
    in-process path and is counted in :attr:`stats`.
    :meth:`remote_plan`, :meth:`ping`, :meth:`daemon_stats` and
    :meth:`shutdown` raise typed errors instead, for callers that need
    to observe the daemon itself.

    ``address`` is either a Unix socket path or ``host:port``; a TCP
    address requires the shared key (``key=`` or
    ``$POLYTOPS_TORCH_SCHEDD_KEY``).  Connections are pooled per client: the
    version/auth handshake runs once per connection and requests reuse
    it until EOF/timeout, when the next request redials.

    ``cache`` names the :class:`~repro_torch.core.schedcache.ScheduleCache`
    the fallback path uses (default: the process-global one), so tests
    and the chaos harness can isolate fallback state from the daemon's
    pool.  ``versions`` overrides the handshake versions (chaos: a
    deliberately stale peer).
    """

    #: pooled idle connections kept per client
    POOL_SIZE = 4

    def __init__(self, sock_path: Optional[str] = None, *,
                 connect_timeout: float = 1.0, request_timeout: float = 120.0,
                 retries: int = 1, backoff_s: float = 0.05,
                 breaker_threshold: int = 3, breaker_reset_s: float = 5.0,
                 cache=None, versions: Optional[Dict[str, int]] = None,
                 key: Union[str, bytes, None] = None):
        self.sock_path = sock_path or daemon_address()
        self.connect_timeout = connect_timeout
        self.request_timeout = request_timeout
        self.retries = retries
        self.backoff_s = backoff_s
        self.cache = cache
        self._versions = versions
        self.key = normalize_key(key) if key is not None else load_key()
        self.breaker = CircuitBreaker(breaker_threshold, breaker_reset_s)
        self.stats = ClientStats()
        self._pool_lock = threading.Lock()
        self._idle: List[_PooledConn] = []

    # -- connection pool ---------------------------------------------------

    def _dial(self, timeout: float) -> _PooledConn:
        """A fresh connected + handshaken connection."""
        assert self.sock_path
        kind, target = parse_address(self.sock_path)
        if kind == "tcp":
            sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            sock.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        else:
            sock = socket.socket(socket.AF_UNIX, socket.SOCK_STREAM)
        try:
            sock.settimeout(min(self.connect_timeout, timeout))
            try:
                sock.connect(target)
            except OSError as e:
                raise DaemonUnavailable(
                    f"connect {self.sock_path!r}: {e}") from e
            sock.settimeout(timeout)
            try:
                hello = {"op": "hello",
                         **(self._versions or wire_versions())}
                _, session = client_handshake(sock, hello, key=self.key)
            except socket.timeout as e:
                raise DaemonUnavailable(
                    f"daemon timed out after {timeout:.3f}s") from e
            except (BrokenPipeError, ConnectionError) as e:
                raise DaemonUnavailable(f"connection died: {e}") from e
            self.stats.incr("dials")
            return _PooledConn(sock, session)
        except BaseException:
            try:
                sock.close()
            except OSError:
                pass
            raise

    def _checkout(self) -> Optional[_PooledConn]:
        with self._pool_lock:
            return self._idle.pop() if self._idle else None

    def _checkin(self, conn: _PooledConn) -> None:
        with self._pool_lock:
            if len(self._idle) < self.POOL_SIZE:
                self._idle.append(conn)
                return
        conn.close()

    def close(self) -> None:
        """Drop every pooled connection (test/bench teardown)."""
        with self._pool_lock:
            idle, self._idle = self._idle, []
        for c in idle:
            c.close()

    # -- low-level ---------------------------------------------------------

    def _roundtrip(self, conn: _PooledConn, payload: Dict[str, Any],
                   timeout: float) -> Dict[str, Any]:
        conn.sock.settimeout(timeout)
        send_frame(conn.sock, payload, session=conn.session)
        resp = recv_frame(conn.sock, session=conn.session)
        if resp is None:
            raise ProtocolError("daemon closed mid-request")
        if not resp.get("ok"):
            raise response_error(resp)
        return resp

    def _request(self, payload: Dict[str, Any],
                 timeout: float) -> Dict[str, Any]:
        """One request/response over a pooled connection.

        A pooled connection may have been closed by the daemon while
        idle (conn-timeout, restart) — since requests are idempotent,
        a *reused* connection that dies before yielding a response is
        retried once on a fresh dial; errors on a fresh connection
        propagate (the daemon is actually unhealthy)."""
        if not self.sock_path:
            raise DaemonUnavailable("no daemon socket configured")
        conn = self._checkout()
        reused = conn is not None
        if conn is None:
            conn = self._dial(timeout)
        else:
            self.stats.incr("reuses")
        try:
            resp = self._roundtrip(conn, payload, timeout)
        except (socket.timeout, OSError, ProtocolError, AuthFailed) as e:
            conn.close()
            if not reused:
                raise self._typed_transport_error(e) from e
            # stale pooled connection — one transparent redial
            conn = self._dial(timeout)
            try:
                resp = self._roundtrip(conn, payload, timeout)
            except (socket.timeout, OSError, ProtocolError,
                    AuthFailed) as e2:
                conn.close()
                raise self._typed_transport_error(e2) from e2
        except BaseException:
            conn.close()      # typed daemon reply — connection is fine,
            raise             # but don't pool mid-error state
        self._checkin(conn)
        return resp

    @staticmethod
    def _typed_transport_error(e: BaseException) -> SchedClientError:
        """Map a transport-layer exception to the typed error family."""
        if isinstance(e, SchedClientError):
            return e
        if isinstance(e, socket.timeout):
            return DaemonUnavailable(f"daemon timed out: {e}")
        return DaemonUnavailable(f"connection died: {e}")

    def _call(self, payload: Dict[str, Any],
              deadline: Optional[Deadline] = None) -> Dict[str, Any]:
        """Breaker + bounded retry-with-backoff around :meth:`_request`.
        Raises the last typed error when the daemon could not serve the
        request; the public API turns that into the local fallback."""
        if not self.breaker.allow():
            self.stats.incr("breaker_skips")
            raise DaemonUnavailable("circuit breaker open")
        delay = self.backoff_s
        last: Optional[SchedClientError] = None
        for attempt in range(self.retries + 1):
            timeout = self.request_timeout
            if deadline is not None and deadline.budget_s is not None:
                rem = deadline.remaining()
                if rem <= 0:
                    self.breaker.failure()
                    raise DaemonUnavailable(
                        "deadline exhausted before the request was sent")
                timeout = min(timeout, max(rem, 1e-3))
                payload = dict(payload, deadline_s=rem)
            try:
                resp = self._request(payload, timeout)
                self.breaker.success()
                self.stats.incr("remote_ok")
                return resp
            except VersionSkew:
                # not transient: no retry, breaker opens immediately so
                # every later request goes straight to the fallback
                self.stats.incr("version_skew")
                self.stats.incr("remote_errors")
                self.breaker.trip()
                raise
            except AuthFailed:
                # wrong/missing key cannot fix itself between retries
                self.stats.incr("auth_failed")
                self.stats.incr("remote_errors")
                self.breaker.trip()
                raise
            except Overloaded as e:
                self.stats.incr("overloaded")
                self.stats.incr("remote_errors")
                last = e
            except (DaemonUnavailable, ProtocolError, RemoteError) as e:
                self.stats.incr("remote_errors")
                last = e
            if attempt < self.retries:
                nap = delay
                if deadline is not None and deadline.budget_s is not None:
                    # a retry is only worth napping for if enough budget
                    # remains to actually serve it afterwards — otherwise
                    # the retried request would be DOA and we'd just be
                    # double-counting a breaker failure
                    if deadline.remaining() <= nap + MIN_RETRY_BUDGET_S:
                        break
                self.stats.incr("retries")
                time.sleep(nap)
                delay *= 2
        self.breaker.failure()
        assert last is not None
        raise last

    def _fallback_cache(self):
        from .schedcache import global_cache
        return self.cache if self.cache is not None else global_cache()

    # -- public API --------------------------------------------------------

    def schedule(self, scop, config=None, engine: str = "lex",
                 with_tree: bool = False,
                 deadline: Optional[Deadline] = None, **extra):
        """Schedule ``scop`` through the daemon, falling back to the
        in-process degradation ladder over ``cached_schedule_scop`` —
        total, like everything the ladder serves."""
        payload = {"op": "schedule", "scop": scop, "config": config,
                   "engine": engine, "with_tree": bool(with_tree),
                   "extra": dict(extra)}
        try:
            return self._call(payload, deadline)["result"]
        except (SchedClientError, OSError):
            self.stats.incr("fallbacks")
            from .resilience import schedule_with_ladder
            return schedule_with_ladder(
                scop, config, engine=engine, deadline=deadline,
                cache=self._fallback_cache(), with_tree=with_tree, **extra)

    def autotune(self, scop, *, deadline: Optional[Deadline] = None,
                 **kwargs):
        """Kernel-specific autotuning through the daemon (one shared
        winner store + measurement pool), falling back to the local
        tuner on daemon trouble."""
        payload = {"op": "autotune", "scop": scop, "kwargs": dict(kwargs)}
        try:
            return self._call(payload, deadline)["result"]
        except (SchedClientError, OSError):
            self.stats.incr("fallbacks")
            from .autotune import autotune as local_autotune
            return local_autotune(scop, deadline=deadline,
                                  cache=self.cache, **kwargs)

    def remote_plan(self, kind: str, *args,
                    deadline: Optional[Deadline] = None, **kwargs):
        """A kernel plan from the daemon, raising typed errors on any
        failure — the ``akg`` hook treats a raise as 'plan locally'."""
        payload = {"op": "plan", "kind": kind, "args": list(args),
                   "kwargs": dict(kwargs)}
        return self._call(payload, deadline)["result"]

    def plan(self, kind: str, *args, **kwargs):
        """A kernel plan, falling back to the local ``akg`` planners."""
        try:
            return self.remote_plan(kind, *args, **kwargs)
        except (SchedClientError, OSError):
            self.stats.incr("fallbacks")
            with local_only():
                return _local_plan(kind, *args, **kwargs)

    def ping(self, timeout: float = 2.0) -> Dict[str, Any]:
        return self._request({"op": "ping"}, timeout)

    def daemon_stats(self, timeout: float = 5.0) -> Dict[str, Any]:
        return self._request({"op": "stats"}, timeout)["result"]

    def shutdown(self, timeout: float = 5.0) -> None:
        """Ask the daemon to exit cleanly (bench/test teardown)."""
        try:
            self._request({"op": "shutdown"}, timeout)
        except (DaemonUnavailable, ProtocolError):
            pass          # already gone / died while answering
        finally:
            self.close()


# ---------------------------------------------------------------------------
# integration seam: env-configured singleton + the akg plan hook
# ---------------------------------------------------------------------------

_SERVER_PROCESS = False
_LOCAL_ONLY = threading.local()
_DEFAULT: Optional[SchedClient] = None
_DEFAULT_LOCK = threading.Lock()


def mark_server_process() -> None:
    """Called by the daemon at startup: its own plan/schedule work must
    never route back through a client (recursion guard)."""
    global _SERVER_PROCESS
    _SERVER_PROCESS = True


@contextmanager
def local_only():
    """Force in-process planning inside the block — used by the client's
    own fallback so ``akg``'s remote hook cannot re-enter the daemon."""
    prev = getattr(_LOCAL_ONLY, "active", False)
    _LOCAL_ONLY.active = True
    try:
        yield
    finally:
        _LOCAL_ONLY.active = prev


def daemon_socket_path() -> Optional[str]:
    return os.environ.get(SOCKET_ENV) or None


def daemon_address() -> Optional[str]:
    """The configured daemon address: ``$POLYTOPS_TORCH_SCHEDD_ADDR`` (socket
    path or ``host:port``) wins over ``$POLYTOPS_TORCH_SCHEDD_SOCK``."""
    return os.environ.get(ADDR_ENV) or daemon_socket_path()


def maybe_client() -> Optional[SchedClient]:
    """The process-wide client when ``$POLYTOPS_TORCH_SCHEDD_ADDR`` or
    ``$POLYTOPS_TORCH_SCHEDD_SOCK`` is set, else None.  Always None inside
    the daemon's own process."""
    if _SERVER_PROCESS:
        return None
    path = daemon_address()
    if not path:
        return None
    global _DEFAULT
    with _DEFAULT_LOCK:
        if _DEFAULT is None or _DEFAULT.sock_path != path:
            _DEFAULT = SchedClient(path)
        return _DEFAULT


def maybe_remote_plan(kind: str, *args, **kwargs):
    """The ``akg`` hook: a daemon-planned kernel when one is configured
    and reachable, else None (caller plans in-process, counted as one of
    the client's ``fallbacks``).  Never raises — the breaker makes
    repeated failures cost one check, not one connect, per request."""
    if getattr(_LOCAL_ONLY, "active", False):
        return None
    client = maybe_client()
    if client is None:
        return None
    try:
        return client.remote_plan(kind, *args, **kwargs)
    except (SchedClientError, OSError):
        client.stats.incr("fallbacks")
        return None


def _local_plan(kind: str, *args, **kwargs):
    from . import akg

    planners = {"matmul": akg.plan_matmul, "attention": akg.plan_attention,
                "mamba_scan": akg.plan_mamba_scan,
                "scan_gate": akg.plan_scan_gate}
    if kind not in planners:
        raise ValueError(f"unknown plan kind {kind!r}; "
                         f"known: {', '.join(sorted(planners))}")
    return planners[kind](*args, **kwargs)


__all__ = [  # the compatibility surface tests and the daemon import
    "ADDR_ENV", "KEY_ENV", "MAGIC", "MAX_FRAME_BYTES", "HEADER_LEN",
    "MAC_LEN", "PRE_AUTH_MAX_FRAME_BYTES", "PROTOCOL_VERSION",
    "SOCKET_ENV", "AuthFailed", "CircuitBreaker", "ClientStats",
    "DaemonUnavailable", "Overloaded", "ProtocolError", "RemoteError",
    "SchedClient", "SchedClientError", "Session", "VersionSkew",
    "WorkerCrashed", "client_handshake", "daemon_address",
    "daemon_socket_path", "encode_frame", "is_tcp_address", "load_key",
    "local_only", "mark_server_process", "maybe_client",
    "maybe_remote_plan", "normalize_key", "parse_address", "recv_frame",
    "response_error", "send_frame", "version_skew", "wire_versions",
]
