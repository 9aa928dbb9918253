"""Wire layer shared by the schedd daemon and its clients.

Everything both ends of a scheduling-service connection must agree on
lives here, so the two cannot drift:

* **Framing** — length-prefixed frames (``MAGIC | uint32 length |
  body [| 32-byte MAC]``) over a stream socket.  The body is either
  JSON (handshake control frames — safe to parse from an untrusted
  peer) or pickle (post-handshake request/response frames).

* **The handshake** — every connection opens with a JSON ``hello``
  carrying :data:`PROTOCOL_VERSION` plus the three cache-compatibility
  versions; a stale peer on either side is rejected with a typed
  ``version_skew`` before any pickle is exchanged.  Over TCP the hello
  continues into an HMAC-SHA256 challenge–response (both directions
  prove knowledge of the shared key over fresh nonces), and the rest of
  the connection carries per-frame MAC tags keyed by a per-connection
  session key.  See :func:`client_handshake` / :func:`server_handshake`.

* **The trust boundary** — pickle is only ever decoded from a peer
  that has already been authenticated (TCP: the challenge–response
  succeeded AND the frame's MAC verifies; Unix socket: the 0o600
  socket directory restricts peers to the same user).  Pre-auth frames
  are JSON, capped at :data:`PRE_AUTH_MAX_FRAME_BYTES`, so an
  unauthenticated peer can neither execute a pickle payload nor make
  the daemon allocate :data:`MAX_FRAME_BYTES` per connection.

* **Typed errors** — the exception family mirroring the daemon's
  wire-level error kinds (re-exported by :mod:`repro_torch.core.schedclient`
  for compatibility).

* **The port's own namespace** — :data:`MAGIC`, the HMAC labels and the
  three environment variables differ from the reference package's, whose
  wire versions are equal to these: a port client never unpickles a
  frame of a reference daemon (its objects are ``repro.core``'s), and
  the reverse.  A frame with the other package's magic is a
  ``ProtocolError``, and the client plans in-process.

This module must stay cheap to import: it is reachable from ``akg``'s
plan hook on every compile.
"""
from __future__ import annotations

import hashlib
import hmac
import json
import os
import pickle
import socket
import struct
from typing import Any, Dict, Optional, Tuple, Union

#: bump on any incompatible change to the frame format or message
#: shapes.  v2: JSON handshake frames, optional HMAC auth + per-frame
#: MACs (TCP), pre-auth frame cap.
PROTOCOL_VERSION = 2
MAGIC = b"PTTD"
_HEADER = struct.Struct(">I")
HEADER_LEN = len(MAGIC) + _HEADER.size
#: hard cap on a single post-auth frame — a garbage length prefix must
#: not make either side try to allocate gigabytes
MAX_FRAME_BYTES = 64 << 20
#: cap on a frame from a peer that has not completed the handshake —
#: hello/challenge/auth are tiny JSON, so an unauthenticated TCP peer
#: can make us buffer at most this much
PRE_AUTH_MAX_FRAME_BYTES = 64 << 10
#: HMAC-SHA256 tag appended to every post-handshake frame on an
#: authenticated connection
MAC_LEN = 32

#: environment variable naming the daemon's Unix socket; unset → none
SOCKET_ENV = "POLYTOPS_TORCH_SCHEDD_SOCK"
#: environment variable naming the daemon address — either a Unix
#: socket path or ``host:port``; takes precedence over ``SOCKET_ENV``
ADDR_ENV = "POLYTOPS_TORCH_SCHEDD_ADDR"
#: environment variable holding the shared TCP auth key (any string)
KEY_ENV = "POLYTOPS_TORCH_SCHEDD_KEY"

_S2C_LABEL = b"polytops-torch-schedd-s2c-v2"
_C2S_LABEL = b"polytops-torch-schedd-c2s-v2"
_SESSION_LABEL = b"polytops-torch-schedd-session-v2"


def wire_versions() -> Dict[str, int]:
    """The four versions exchanged in the handshake.  Imported lazily:
    this module is reachable from ``akg`` and must stay cheap to load."""
    from .autotune import SPACE_VERSION
    from .schedcache import CACHE_VERSION
    from .schedtree import TREE_VERSION

    return {"proto": PROTOCOL_VERSION, "cache": CACHE_VERSION,
            "tree": TREE_VERSION, "space": SPACE_VERSION}


def version_skew(theirs: Dict[str, Any]) -> Optional[str]:
    """Human-readable mismatch description, or None when compatible."""
    ours = wire_versions()
    bad = [f"{k}: ours={ours[k]} theirs={theirs.get(k)!r}"
           for k in ours if theirs.get(k) != ours[k]]
    return "; ".join(bad) or None


# ---------------------------------------------------------------------------
# typed errors (re-exported by schedclient)
# ---------------------------------------------------------------------------


class SchedClientError(RuntimeError):
    """Base of every typed daemon-communication error."""


class DaemonUnavailable(SchedClientError):
    """No daemon: socket missing, connection refused/reset, timeout."""


class ProtocolError(SchedClientError):
    """Malformed wire data: bad magic, truncated frame, unpicklable
    payload, or a ``bad_frame``/``bad_request`` response."""


class Overloaded(SchedClientError):
    """The daemon load-shed this request (typed ``overloaded`` reply)."""


class VersionSkew(SchedClientError):
    """Handshake rejected: the peer runs incompatible cache/tree/space
    versions.  Not transient — the breaker opens immediately."""


class AuthFailed(SchedClientError):
    """The HMAC handshake or a per-frame MAC failed: wrong or missing
    shared key, tampered frame, or an unauthenticated peer on a TCP
    transport.  Not transient — retrying with the same key cannot
    help, so the breaker opens immediately."""


class RemoteError(SchedClientError):
    """The daemon failed serving the request (typed ``internal`` /
    ``deadline`` reply); carries the wire error kind."""

    def __init__(self, kind: str, detail: str = ""):
        super().__init__(f"daemon error [{kind}]"
                         + (f": {detail}" if detail else ""))
        self.kind = kind
        self.detail = detail


class WorkerCrashed(RemoteError):
    """A daemon pool worker died (or wedged) computing this request,
    twice — the daemon already retried once on a fresh worker.  The
    daemon itself is healthy; the request is the likely poison, so the
    client falls back in-process rather than hammering the pool."""

    def __init__(self, detail: str = ""):
        super().__init__("worker_crashed",
                         detail or "pool worker died computing the request")


class IdleTimeout(Exception):
    """Internal: a recv timed out at a clean frame boundary with zero
    bytes read — an idle keep-alive connection, not a slow-loris.  The
    daemon closes these quietly instead of counting a stalled peer."""


def response_error(resp: Dict[str, Any]) -> SchedClientError:
    """Map a ``{"ok": False, ...}`` response to its typed exception."""
    kind = str(resp.get("error", "internal"))
    detail = str(resp.get("detail", ""))
    if kind == "overloaded":
        return Overloaded(detail or "daemon load-shed the request")
    if kind == "version_skew":
        return VersionSkew(detail or "incompatible peer versions")
    if kind == "auth_failed":
        return AuthFailed(detail or "authentication failed")
    if kind in ("bad_frame", "bad_request"):
        return ProtocolError(f"{kind}: {detail}")
    if kind == "worker_crashed":
        return WorkerCrashed(detail)
    return RemoteError(kind, detail)


# ---------------------------------------------------------------------------
# addresses + keys
# ---------------------------------------------------------------------------

#: a parsed daemon address: ("unix", path) or ("tcp", (host, port))
Address = Tuple[str, Any]


def parse_address(addr: str) -> Address:
    """``host:port`` → a TCP address; anything else is a Unix socket
    path.  A path is never mistaken for ``host:port``: the TCP form
    requires a numeric port and no path separator."""
    if ":" in addr and os.sep not in addr:
        host, _, port = addr.rpartition(":")
        if host and port.isdigit():
            return ("tcp", (host, int(port)))
    return ("unix", addr)


def is_tcp_address(addr: Optional[str]) -> bool:
    return addr is not None and parse_address(addr)[0] == "tcp"


def load_key(keyfile: Optional[str] = None,
             env: Optional[str] = None) -> Optional[bytes]:
    """The shared auth key: an explicit keyfile wins, else
    ``$POLYTOPS_TORCH_SCHEDD_KEY`` (or ``env`` when given).  None when
    neither is configured — the caller decides whether that is fatal
    (it is, for any TCP endpoint)."""
    if keyfile:
        with open(keyfile, "rb") as f:
            key = f.read().strip()
        if not key:
            raise ValueError(f"keyfile {keyfile!r} is empty")
        return key
    val = env if env is not None else os.environ.get(KEY_ENV)
    if val:
        return val.encode() if isinstance(val, str) else val
    return None


def normalize_key(key: Union[str, bytes, None]) -> Optional[bytes]:
    if key is None:
        return None
    return key.encode() if isinstance(key, str) else bytes(key)


# ---------------------------------------------------------------------------
# MAC session
# ---------------------------------------------------------------------------


def _tag(key: bytes, label: bytes, *parts: bytes) -> bytes:
    mac = hmac.new(key, label, hashlib.sha256)
    for p in parts:
        mac.update(p)
    return mac.digest()


def derive_session_key(key: bytes, client_nonce: bytes,
                       server_nonce: bytes) -> bytes:
    return _tag(key, _SESSION_LABEL, client_nonce, server_nonce)


class Session:
    """Per-connection MAC state after a successful handshake.

    Every post-handshake frame carries
    ``HMAC-SHA256(session_key, dir || seq || body)`` where ``dir`` is a
    direction byte (client→server vs server→client) and ``seq`` a
    per-direction monotonically increasing counter — so a frame cannot
    be replayed, reordered, or reflected within the connection, and a
    body is never unpickled before its tag verifies."""

    __slots__ = ("key", "send_dir", "recv_dir", "send_seq", "recv_seq")

    CLIENT_DIR = b"C"
    SERVER_DIR = b"S"

    def __init__(self, key: bytes, *, is_client: bool):
        self.key = key
        self.send_dir = self.CLIENT_DIR if is_client else self.SERVER_DIR
        self.recv_dir = self.SERVER_DIR if is_client else self.CLIENT_DIR
        self.send_seq = 0
        self.recv_seq = 0

    def _frame_tag(self, direction: bytes, seq: int, body: bytes) -> bytes:
        return _tag(self.key, b"frame", direction,
                    struct.pack(">Q", seq), body)

    def sign(self, body: bytes) -> bytes:
        tag = self._frame_tag(self.send_dir, self.send_seq, body)
        self.send_seq += 1
        return tag

    def verify(self, body: bytes, tag: bytes) -> None:
        want = self._frame_tag(self.recv_dir, self.recv_seq, body)
        self.recv_seq += 1
        if not hmac.compare_digest(want, tag):
            raise AuthFailed(
                f"frame MAC mismatch (recv seq {self.recv_seq - 1})")


# ---------------------------------------------------------------------------
# framing
# ---------------------------------------------------------------------------


def _encode_body(obj: Any, json_codec: bool) -> bytes:
    if json_codec:
        return json.dumps(obj, sort_keys=True,
                          separators=(",", ":")).encode()
    return pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)


def encode_frame(obj: Any, *, json_codec: bool = False,
                 session: Optional[Session] = None) -> bytes:
    body = _encode_body(obj, json_codec)
    if len(body) > MAX_FRAME_BYTES:
        raise ProtocolError(f"frame too large: {len(body)} B")
    frame = MAGIC + _HEADER.pack(len(body)) + body
    if session is not None:
        frame += session.sign(body)
    return frame


def send_frame(sock: socket.socket, obj: Any, *, json_codec: bool = False,
               session: Optional[Session] = None) -> None:
    sock.sendall(encode_frame(obj, json_codec=json_codec, session=session))


def _recv_exact(sock: socket.socket, n: int, *, eof_ok: bool,
                idle_ok: bool = False) -> Optional[bytes]:
    """Exactly ``n`` bytes, or None on clean EOF at a frame boundary
    (``eof_ok``).  EOF mid-read is always a truncated frame.  With
    ``idle_ok``, a recv timeout before the *first* byte raises
    :class:`IdleTimeout` (an idle keep-alive connection) instead of
    ``socket.timeout`` (a mid-frame stall — a slow-loris)."""
    buf = b""
    while len(buf) < n:
        try:
            chunk = sock.recv(n - len(buf))
        except socket.timeout:
            if idle_ok and not buf:
                raise IdleTimeout() from None
            raise
        if not chunk:
            if not buf and eof_ok:
                return None
            raise ProtocolError(
                f"truncated frame: got {len(buf)} of {n} bytes before EOF")
        buf += chunk
    return buf


def recv_frame(sock: socket.socket, *, eof_ok: bool = False,
               max_bytes: int = MAX_FRAME_BYTES, json_codec: bool = False,
               session: Optional[Session] = None,
               idle_ok: bool = False) -> Any:
    """One decoded frame; None on clean EOF when ``eof_ok``.  Raises
    :class:`ProtocolError` on garbage (bad magic, oversized length,
    truncation, undecodable body) and :class:`AuthFailed` on a MAC
    mismatch — never anything untyped.  On an authenticated session the
    MAC is verified *before* the body is unpickled."""
    head = _recv_exact(sock, HEADER_LEN, eof_ok=eof_ok, idle_ok=idle_ok)
    if head is None:
        return None
    if head[:len(MAGIC)] != MAGIC:
        raise ProtocolError(f"bad magic {head[:len(MAGIC)]!r}")
    (length,) = _HEADER.unpack(head[len(MAGIC):])
    if length > max_bytes:
        raise ProtocolError(f"frame length {length} exceeds {max_bytes} cap")
    body = _recv_exact(sock, length, eof_ok=False)
    assert body is not None
    if session is not None:
        tag = _recv_exact(sock, MAC_LEN, eof_ok=False)
        assert tag is not None
        session.verify(body, tag)     # raises AuthFailed before any decode
    try:
        if json_codec:
            obj = json.loads(body.decode())
        else:
            obj = pickle.loads(body)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception as e:
        raise ProtocolError(f"undecodable frame body: "
                            f"{type(e).__name__}: {e}") from e
    if json_codec and not isinstance(obj, dict):
        raise ProtocolError(
            f"handshake frame is {type(obj).__name__}, not an object")
    return obj


# ---------------------------------------------------------------------------
# the handshake
# ---------------------------------------------------------------------------
#
# Unix socket (peers gated by 0o600 file permissions):
#
#     C → S   {"op": "hello", proto/cache/tree/space, "nonce": hex}
#     S → C   {"ok": true, "op": "hello", "pid": ..., versions...}
#     ... pickle frames, no MAC ...
#
# TCP (a shared key is mandatory — the daemon refuses to listen
# without one):
#
#     C → S   {"op": "hello", versions..., "nonce": c}        (JSON)
#     S → C   {"ok": true, "op": "challenge", "nonce": s,
#              "mac": HMAC(key, s2c-label || c || s)}         (JSON)
#     C → S   {"op": "auth", "mac": HMAC(key, c2s-label || s || c)}
#     S → C   {"ok": true, "op": "hello", "authed": true, ...} (JSON)
#     ... pickle frames, each MAC-tagged with the session key ...
#
# The server proves key knowledge first (its challenge MAC covers both
# nonces), so a client never authenticates to an impostor; the client's
# response covers the nonces in the opposite order under a different
# label, so neither side's MAC can be reflected back.  Version skew is
# rejected before the challenge: a stale peer never gets far enough to
# exchange pickles, with or without the key.


def client_handshake(sock: socket.socket, hello: Dict[str, Any], *,
                     key: Optional[bytes] = None
                     ) -> Tuple[Dict[str, Any], Optional[Session]]:
    """Run the client side of the handshake.  ``hello`` must carry the
    versions (see :func:`wire_versions`); a nonce is added here.
    Returns ``(hello_response, session)`` — session is None on an
    unauthenticated (Unix) transport.  Raises the typed error family
    on any failure."""
    client_nonce = os.urandom(16)
    hello = dict(hello, nonce=client_nonce.hex())
    send_frame(sock, hello, json_codec=True)
    resp = recv_frame(sock, json_codec=True,
                      max_bytes=PRE_AUTH_MAX_FRAME_BYTES)
    if resp is None:
        raise ProtocolError("daemon closed during handshake")
    if not resp.get("ok"):
        raise response_error(resp)
    if resp.get("op") != "challenge":
        return resp, None             # unauthenticated transport: done
    if key is None:
        raise AuthFailed("daemon requires authentication but no key is "
                         f"configured (set ${KEY_ENV} or pass key=)")
    try:
        server_nonce = bytes.fromhex(str(resp.get("nonce", "")))
        server_mac = bytes.fromhex(str(resp.get("mac", "")))
    except ValueError as e:
        raise ProtocolError(f"malformed challenge: {e}") from e
    if len(server_nonce) < 8:
        raise ProtocolError("malformed challenge: short nonce")
    want = _tag(key, _S2C_LABEL, client_nonce, server_nonce)
    if not hmac.compare_digest(want, server_mac):
        raise AuthFailed("server failed the challenge (key mismatch)")
    send_frame(sock, {"op": "auth",
                      "mac": _tag(key, _C2S_LABEL, server_nonce,
                                  client_nonce).hex()},
               json_codec=True)
    final = recv_frame(sock, json_codec=True,
                       max_bytes=PRE_AUTH_MAX_FRAME_BYTES)
    if final is None:
        raise ProtocolError("daemon closed during auth")
    if not final.get("ok"):
        raise response_error(final)
    session = Session(derive_session_key(key, client_nonce, server_nonce),
                      is_client=True)
    return final, session


def server_handshake(conn: socket.socket, hello: Dict[str, Any], *,
                     key: Optional[bytes], require_auth: bool,
                     hello_ok: Dict[str, Any]) -> Optional[Session]:
    """Run the server side of the handshake *after* the hello frame has
    been received and version-checked by the caller.  Sends either the
    plain hello-ok (Unix) or the challenge/auth exchange (TCP).
    Returns the MAC session (None when unauthenticated).  Raises
    :class:`AuthFailed` on bad credentials — after sending the typed
    ``auth_failed`` reply, so the caller only has to close."""
    if not require_auth:
        send_frame(conn, dict(hello_ok), json_codec=True)
        return None
    assert key is not None, "TCP listener started without a key"
    try:
        client_nonce = bytes.fromhex(str(hello.get("nonce", "")))
    except ValueError:
        client_nonce = b""
    if len(client_nonce) < 8:
        send_frame(conn, {"ok": False, "error": "auth_failed",
                          "detail": "hello carries no usable nonce"},
                   json_codec=True)
        raise AuthFailed("hello carries no usable nonce")
    server_nonce = os.urandom(16)
    send_frame(conn, {"ok": True, "op": "challenge",
                      "nonce": server_nonce.hex(),
                      "mac": _tag(key, _S2C_LABEL, client_nonce,
                                  server_nonce).hex()},
               json_codec=True)
    reply = recv_frame(conn, json_codec=True,
                       max_bytes=PRE_AUTH_MAX_FRAME_BYTES, eof_ok=True)
    if reply is None:
        raise AuthFailed("peer hung up at the challenge")
    try:
        client_mac = bytes.fromhex(str(reply.get("mac", "")))
    except ValueError:
        client_mac = b""
    want = _tag(key, _C2S_LABEL, server_nonce, client_nonce)
    if reply.get("op") != "auth" or not hmac.compare_digest(want,
                                                            client_mac):
        send_frame(conn, {"ok": False, "error": "auth_failed",
                          "detail": "bad credentials"}, json_codec=True)
        raise AuthFailed("peer failed the challenge")
    send_frame(conn, dict(hello_ok, authed=True), json_codec=True)
    return Session(derive_session_key(key, client_nonce, server_nonce),
                   is_client=False)
