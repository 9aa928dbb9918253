"""schedd: the fault-tolerant scheduling daemon (Unix socket + TCP).

    PYTHONPATH=src python -m repro_torch.launch.schedd \
        --sock /run/user/$UID/schedd.sock [--workers N] [--cache-dir DIR] \
        [--listen host:port --keyfile FILE] [--peers host:port,...] \
        [--chaos]

The paper puts PolyTOPS *inside* a production compiler, where compiles
arrive concurrently from many clients and must be amortized, not
repeated.  ``schedd`` is that shape: a long-lived process owning one
:class:`~repro_torch.core.schedcache.ScheduleCache` pool, serving
``schedule`` / ``autotune`` / ``plan`` requests over the wire protocol
in :mod:`repro_torch.core.wire`.  Guarantees:

* **Request coalescing** — concurrent identical requests (same
  ``schedule_key`` / autotune-space digest / plan signature) share ONE
  in-flight computation: the first arrival computes, the rest block on
  its flight and receive the identical encoded response.  Warm
  non-degraded responses are additionally kept as pre-encoded frames,
  so a warm hit is one ``sendall`` of cached bytes — no re-pickling.

* **Worker pool** — with ``--workers N`` the accept loop stays a thin
  coalescing/shedding front and every non-coalesced keyed computation
  is dispatched to one of N *forked* worker processes (each inheriting
  the already-imported scheduling stack, so the fork is warm).  Distinct
  keys genuinely schedule in parallel across cores instead of
  serializing on one GIL.  The request's remaining deadline budget is
  re-measured at dispatch and propagated into the worker; worker
  failures come back as the same typed error dicts the inline path
  produces.  A worker that dies mid-job (``kill -9``, OOM) is detected
  through its pipe, counted, journalled as a witnessed crash, replaced,
  and the job is retried once on a fresh worker — a poison request
  burns exactly two workers and yields a typed ``worker_crashed``
  response (the client's cue to fall back in-process).  ``--workers 0``
  (the default) computes inline in the connection thread, the
  single-process behaviour this daemon always had.

* **Latency-saved frame cache** — warm frames are retained by a
  :class:`~repro_torch.core.schedcache.FrameCache` scored on *measured
  compute seconds saved per byte* (each flight's wall time is recorded
  when its frame is admitted), evicting the lowest score first — a
  multi-second autotune frame is never displaced by a swarm of
  millisecond plan frames.

* **Winner-store push** — an autotune computation also returns its
  winning configuration's *schedule* (already computed during the
  search); the daemon pushes that frame into the frame cache **before**
  waking coalesced followers, so a follow-up ``schedule`` request for
  the tuned config is a warm one-``sendall`` hit even on its first
  arrival.

* **Deadline propagation** — a request's ``deadline_s`` (the client's
  remaining budget) resumes as a server-side
  :class:`~repro_torch.core.resilience.Deadline` threaded into the ladder /
  autotuner (re-measured at worker dispatch), so the end-to-end budget
  covers the wire hop and the pool queue too.

* **Load shedding** — when ``max_inflight`` distinct computations are
  already running, new *keyed work* is refused with a typed
  ``overloaded`` response (the client's cue to fall back in-process);
  coalescible requests, frame-cache hits, ping and stats are always
  served — shedding protects the solver, not the socket.

* **Version handshake** — every connection opens with a JSON
  four-version hello (:func:`repro_torch.core.wire.wire_versions`); a skewed
  peer is rejected with ``version_skew`` before any pickle of a
  Schedule is exchanged.

* **Authenticated TCP transport** — ``--listen host:port`` serves the
  same protocol to remote hosts, gated by an HMAC-SHA256
  challenge–response woven into the hello (shared key from
  ``--keyfile`` / ``$POLYTOPS_TORCH_SCHEDD_KEY``; the daemon *refuses to
  listen* without one).  Handshake frames are JSON and capped at
  ``PRE_AUTH_MAX_FRAME_BYTES``, so an unauthenticated peer can neither
  reach ``pickle.loads`` nor make the daemon buffer a 64 MiB frame;
  after auth every frame carries a sequence-numbered MAC verified
  before its body is unpickled.  Bad credentials get a typed
  ``auth_failed`` reply and a closed connection — never a crash.

* **Peer winner push** — ``--peers host:port,...`` names sibling
  daemons; an autotune winner's pre-encoded schedule frame is pushed
  to every peer (async, best-effort, authenticated like any client) so
  a fleet shares tuned schedules without re-searching.  Reception
  reuses the local winner-push admission path: never displacing a
  hotter frame, never admitted over an in-flight computation, and
  pushed frames are never re-forwarded (no push loops).

* **Crash recovery** — accepted autotune work is journalled
  (begin/done rows, flock'd O_APPEND like the measurement pool) so a
  ``kill -9`` mid-request loses at most the in-flight measurement:
  every persistent store the daemon touches (schedule pickles, the
  winner store, ``measurements.jsonl``) already publishes atomically,
  and on restart the journal's begin-without-done rows are
  counted as ``journal_recovered`` and cleared.  A worker killed
  mid-autotune is *witnessed*: the daemon appends a ``crashed`` row
  (which completes the begin, so a witnessed crash is never
  double-counted as an orphan on restart) and retries the job.
  Degraded results are never persisted and never frame-cached — a
  transient fault cannot poison future clients.

* **Hostile-socket robustness** — per-connection recv timeouts drop
  slow-loris peers; bad magic, truncated frames, oversized lengths and
  unpicklable bodies get a best-effort typed ``bad_frame`` reply and a
  closed connection; no client behaviour can crash the daemon.

``--chaos`` enables the test-only ``test_delay_s`` request field (tests
use it to hold a computation open long enough to race a second client
or a ``kill -9`` against it) and ``test_kill_worker`` (a pool worker
SIGKILLs itself mid-job — the worker-crash recovery drill).

This is the port's daemon, beside the reference package's
(``python -m repro.launch.schedd``): its own socket
(``$POLYTOPS_TORCH_SCHEDD_SOCK``, default
``~/.cache/polytops_torch/schedd.sock``), address and key variables,
frame magic and cache pool (``$POLYTOPS_TORCH_CACHE_DIR``), so neither
package's client can reach the other's daemon.  Neither this module nor
anything it imports loads ``torch``: the worker pool forks, and a fork
of a process holding a CUDA context is unsafe.  A serving process on the
card therefore runs the daemon as a subprocess.
"""
from __future__ import annotations

import argparse
import hashlib
import json
import multiprocessing
import os
import queue
import signal
import socket
import sys
import threading
import time
from collections import deque
from typing import Any, Callable, Deque, Dict, List, Optional, Tuple

from ..core import schedclient, wire
from ..core.resilience import Deadline, fault_point, provenance, \
    schedule_with_ladder
from ..core.schedcache import FrameCache, ScheduleCache, schedule_key, \
    scop_fingerprint

try:
    import fcntl
except ImportError:            # non-POSIX: O_APPEND keeps lines atomic
    fcntl = None

JOURNAL_FILE = "schedd_journal.jsonl"

#: a frame pushed from an autotune winner is valued at this fraction of
#: the autotune flight's wall time: a follower hitting it saves a
#: schedule computation, not the whole search — but the push should
#: still outrank millisecond plan frames under eviction pressure
PUSH_COST_FRACTION = 0.1

#: peer winner-push storm cap: at most MAX pushes *admitted* per sliding
#: WINDOW seconds.  A large fleet autotuning in lock-step pushes its
#: winners everywhere at once; unbounded admission would churn a
#: daemon's own hot frames through the latency-saved eviction fight.
#: Excess pushes are refused (not errors — the sender treats pushes as
#: best-effort) and tallied as ``push_capped`` on the frame cache's
#: CacheStats.  Overridable per daemon via --push-storm-max/-window or
#: $POLYTOPS_TORCH_PUSH_STORM_MAX / $POLYTOPS_TORCH_PUSH_STORM_WINDOW.
PUSH_STORM_MAX = 32
PUSH_STORM_WINDOW_S = 10.0

#: set in pool workers only — guards the chaos-only self-kill field so
#: an inline daemon can never SIGKILL itself
_IN_POOL_WORKER = False


# ---------------------------------------------------------------------------
# autotune journal
# ---------------------------------------------------------------------------


class AutotuneJournal:
    """Append-only begin/done/crashed journal for accepted autotune work.

    The journal exists for *observability after a crash*, not for
    replay: every store autotune writes (winner pickles, the
    measurement pool) publishes atomically, so a ``kill -9``
    mid-request can only lose the in-flight measurement — the journal's
    begin-without-done rows say exactly which work that was.  A pool
    worker's death is different: the daemon survives to witness it, so
    it appends a ``crashed`` row — which completes the begin (the loss
    is already accounted) instead of leaving a false orphan for the
    next restart.  Appends reuse the measurement pool's discipline (one
    ``write`` on an O_APPEND handle under an advisory flock); torn tail
    lines from a dying writer are tolerated on read.  Disk trouble
    degrades to "not journalled" — it never fails the request."""

    def __init__(self, path: str):
        self.path = path

    def _append(self, row: Dict[str, Any]) -> None:
        try:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            with open(self.path, "a") as f:
                if fcntl is not None:
                    try:
                        fcntl.flock(f.fileno(), fcntl.LOCK_EX)
                    except OSError:
                        pass
                f.write(json.dumps(row, sort_keys=True) + "\n")
                f.flush()
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            pass

    def begin(self, key: str) -> None:
        self._append({"ev": "begin", "key": key, "pid": os.getpid(),
                      "t": time.time()})

    def done(self, key: str) -> None:
        self._append({"ev": "done", "key": key})

    def crashed(self, key: str, detail: str = "") -> None:
        """A worker died computing ``key`` and the daemon witnessed it —
        completes the begin so restart-time recovery doesn't re-count a
        loss that was already observed and (once) retried."""
        self._append({"ev": "crashed", "key": key, "detail": detail})

    def recover(self) -> List[str]:
        """Keys begun but never finished by a previous daemon (the work
        a crash interrupted).  ``done`` and witnessed ``crashed`` rows
        both complete a begin.  Clears the journal atomically; returns
        [] on any disk trouble."""
        orphans: List[str] = []
        try:
            with open(self.path) as f:
                begun: Dict[str, int] = {}
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        row = json.loads(ln)
                    except json.JSONDecodeError:
                        continue          # torn tail line from a kill -9
                    key = str(row.get("key"))
                    if row.get("ev") == "begin":
                        begun[key] = begun.get(key, 0) + 1
                    elif (row.get("ev") in ("done", "crashed")
                          and begun.get(key)):
                        begun[key] -= 1
                orphans = sorted(k for k, n in begun.items() if n > 0)
            import tempfile
            fd, tmp = tempfile.mkstemp(dir=os.path.dirname(self.path),
                                       suffix=".tmp")
            os.close(fd)
            os.replace(tmp, self.path)    # atomically truncate
        except FileNotFoundError:
            pass
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            return []
        return orphans


# ---------------------------------------------------------------------------
# the computation itself — shared by the inline path and pool workers
# ---------------------------------------------------------------------------


def compute_request(op: str, req: Dict[str, Any], cache: ScheduleCache, *,
                    chaos: bool = False,
                    deadline: Optional[Deadline] = None
                    ) -> Tuple[Dict[str, Any], bool, List[Tuple[Any, Dict[str, Any]]]]:
    """Run one keyed computation exactly as the daemon serves it.

    Returns ``(response_dict, cacheable, pushes)``: the wire response,
    whether its frame may be retained warm (non-degraded success), and
    any *push* entries — ``(frame_key, response_dict)`` pairs for
    sibling keys this computation warmed as a by-product (today: an
    autotune winner's schedule).  Runs identically inline (``--workers
    0``) and inside a forked pool worker; typed failures come back as
    error dicts, anything else raises for the caller to marshal.
    """
    if chaos and req.get("test_kill_worker") and _IN_POOL_WORKER:
        os.kill(os.getpid(), signal.SIGKILL)      # the kill -9 drill
    if deadline is None:
        budget = req.get("deadline_s")
        deadline = Deadline(float(budget)) if budget is not None else None
    if chaos and req.get("test_delay_s"):
        time.sleep(float(req["test_delay_s"]))

    if op == "schedule":
        return _compute_schedule(req, cache, deadline)
    if op == "autotune":
        return _compute_autotune(req, cache, deadline)
    if op == "plan":
        return _compute_plan(req, cache, deadline)
    return ({"ok": False, "error": "bad_request",
             "detail": f"unknown op {op!r}"}, False, [])


def _compute_schedule(req, cache, deadline):
    from ..core.config import SchedulerConfig

    scop = req["scop"]
    config = req.get("config") or SchedulerConfig()
    engine = req.get("engine", "lex")
    with_tree = bool(req.get("with_tree", False))
    extra = dict(req.get("extra") or {})
    sched = schedule_with_ladder(
        scop, config, engine=engine, deadline=deadline,
        cache=cache, with_tree=with_tree, **extra)
    prov = provenance(sched)
    meta = {"degraded": prov["degraded"], "rung": prov["rung"],
            "pid": os.getpid()}
    # degraded schedules are served (every rung is legal) but never
    # frame-cached: the next request re-plans clean
    return ({"ok": True, "result": sched, "meta": meta},
            not prov["degraded"], [])


def _compute_autotune(req, cache, deadline):
    from ..core.autotune import autotune

    scop = req["scop"]
    kwargs = dict(req.get("kwargs") or {})
    result = autotune(scop, deadline=deadline, cache=cache, **kwargs)
    meta = {"degraded": result.degraded, "source": result.source,
            "pid": os.getpid()}
    pushes: List[Tuple[Any, Dict[str, Any]]] = []
    if not result.degraded:
        # winner-store push: the search already scheduled the winning
        # base through the cache, so its Schedule is warm here — hand
        # it up so the daemon can pre-encode the frame a follower's
        # plain `schedule` request for the tuned config would ask for
        try:
            wcfg = result.config.scheduler_config()
            wkey = schedule_key(scop, wcfg, "lex")
            sched = cache.get(wkey) if wkey is not None else None
            if sched is not None and not getattr(sched, "degraded", False):
                pushes.append((("schedule", wkey, False),
                               {"ok": True, "result": sched,
                                "meta": {"degraded": False, "rung": 0,
                                         "pid": os.getpid(),
                                         "pushed": True}}))
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            pass          # the push is an optimization, never a failure
    return ({"ok": True, "result": result, "meta": meta},
            not result.degraded, pushes)


def _compute_plan(req, cache, deadline):
    from ..core import akg

    kind = req.get("kind")
    planners = {"matmul": akg.plan_matmul,
                "attention": akg.plan_attention,
                "mamba_scan": akg.plan_mamba_scan,
                "scan_gate": akg.plan_scan_gate}
    if kind not in planners:
        return ({"ok": False, "error": "bad_request",
                 "detail": f"unknown plan kind {kind!r}"}, False, [])
    args = tuple(req.get("args") or ())
    kwargs = dict(req.get("kwargs") or {})
    plan = planners[kind](*args, **kwargs)
    meta = {"degraded": plan.degraded, "pid": os.getpid()}
    return ({"ok": True, "result": plan, "meta": meta},
            not plan.degraded, [])


# ---------------------------------------------------------------------------
# the worker pool
# ---------------------------------------------------------------------------


class WorkerCrash(Exception):
    """A pool worker died (or wedged past its cap) computing a job.
    Internal to the daemon — on the wire this becomes the typed
    ``worker_crashed`` error kind."""


def _worker_main(conn, cache_dir: Optional[str], disk: bool,
                 chaos: bool) -> None:
    """One pool worker: recv job → compute → send result, forever.

    Forked from the daemon after the scheduling stack is imported, so
    the fork inherits warm modules.  Marks itself a server process
    (its own akg/plan work must never route back through a client),
    opens its own ScheduleCache handle on the shared pool directory
    (the disk tier's atomic publishes make cross-process sharing safe),
    and exits via ``os._exit`` so inherited atexit machinery (pytest,
    coverage) never runs in the child."""
    global _IN_POOL_WORKER
    _IN_POOL_WORKER = True
    schedclient.mark_server_process()
    try:
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        signal.signal(signal.SIGTERM, signal.SIG_DFL)
    except (ValueError, OSError):
        pass
    cache = ScheduleCache(cache_dir=cache_dir, disk=disk)
    code = 0
    while True:
        try:
            job = conn.recv()
        except (EOFError, OSError):
            break
        if job is None:                   # clean shutdown sentinel
            break
        op, req = job
        t0 = time.perf_counter()
        try:
            resp, cacheable, pushes = compute_request(op, req, cache,
                                                      chaos=chaos)
        except (KeyboardInterrupt, SystemExit):
            code = 1
            break
        except Exception as e:            # typed marshalling, never a crash
            resp, cacheable, pushes = (
                {"ok": False, "error": "internal",
                 "detail": f"{type(e).__name__}: {e}"}, False, [])
        payload = (resp, cacheable, pushes, time.perf_counter() - t0)
        try:
            conn.send(payload)
        except (BrokenPipeError, OSError):
            break
        except Exception as e:            # unpicklable result: typed reply
            try:
                conn.send(({"ok": False, "error": "internal",
                            "detail": f"unmarshallable result: "
                                      f"{type(e).__name__}: {e}"},
                           False, [], time.perf_counter() - t0))
            except Exception:
                break
    os._exit(code)


class _WorkerProc:
    __slots__ = ("proc", "conn")

    def __init__(self, proc, conn):
        self.proc = proc
        self.conn = conn


class WorkerPool:
    """N forked worker processes, each serving one job at a time.

    Dispatch is pull-based: a daemon connection thread takes an idle
    worker off the queue, sends the job down its pipe, and waits for
    the reply while watching liveness — so a ``kill -9`` of a worker is
    detected within the poll interval, the corpse is replaced, and
    :meth:`run` retries the job once on a fresh worker.  A worker that
    exceeds the job cap (the request deadline plus grace, or
    ``job_timeout_s``) is presumed wedged, killed and replaced the same
    way.  Workers are forked *after* the scheduling stack is imported
    into the daemon, so every worker starts warm and respawns never
    race daemon threads through the import machinery."""

    POLL_S = 0.1
    GRACE_S = 10.0

    def __init__(self, workers: int, cache_dir: Optional[str], *,
                 disk: bool = True, chaos: bool = False,
                 job_timeout_s: float = 600.0):
        # warm the stack once in the parent; every fork inherits it
        from ..core import akg              # noqa: F401
        from ..core import autotune         # noqa: F401
        from ..core import config           # noqa: F401
        from ..core import scheduler        # noqa: F401

        self.workers = workers
        self.cache_dir = cache_dir
        self.disk = disk
        self.chaos = chaos
        self.job_timeout_s = job_timeout_s
        try:
            self._ctx = multiprocessing.get_context("fork")
        except ValueError:                  # non-POSIX: cold spawns
            self._ctx = multiprocessing.get_context()
        self._lock = threading.Lock()
        self._idle: "queue.Queue[_WorkerProc]" = queue.Queue()
        self._procs: List[_WorkerProc] = []
        self.spawned = 0
        self.crashes = 0
        self.jobs = 0
        self._closed = False
        for _ in range(workers):
            self._idle.put(self._spawn())

    def _spawn(self) -> _WorkerProc:
        parent, child = self._ctx.Pipe()
        proc = self._ctx.Process(
            target=_worker_main,
            args=(child, self.cache_dir, self.disk, self.chaos),
            daemon=True, name="schedd-worker")
        proc.start()
        child.close()
        w = _WorkerProc(proc, parent)
        with self._lock:
            self._procs.append(w)
            self.spawned += 1
        return w

    def _retire(self, w: _WorkerProc) -> None:
        with self._lock:
            if w in self._procs:
                self._procs.remove(w)
        try:
            w.conn.close()
        except OSError:
            pass
        if w.proc.is_alive():
            w.proc.kill()
        w.proc.join(timeout=5.0)

    def _acquire(self, deadline: Optional[Deadline]) -> _WorkerProc:
        cap = self.job_timeout_s
        if deadline is not None and deadline.budget_s is not None:
            cap = min(cap, max(deadline.remaining(), 0.0) + self.GRACE_S)
        end = time.monotonic() + cap
        while True:
            if self._closed:
                raise WorkerCrash("pool closed")
            try:
                w = self._idle.get(timeout=self.POLL_S)
            except queue.Empty:
                if time.monotonic() >= end:
                    raise WorkerCrash(
                        f"no idle worker within {cap:.1f}s "
                        f"({self.workers} workers all busy)")
                continue
            if w.proc.is_alive():
                return w
            # a corpse parked in the idle queue (killed between jobs)
            with self._lock:
                self.crashes += 1
            self._retire(w)
            self._idle.put(self._spawn())

    def run_once(self, op: str, req: Dict[str, Any],
                 deadline: Optional[Deadline]) -> Tuple:
        """One job on one worker; raises :class:`WorkerCrash` when the
        worker dies or wedges.  Returns the worker's
        ``(resp, cacheable, pushes, compute_s)`` tuple."""
        w = self._acquire(deadline)
        with self._lock:
            self.jobs += 1
        lost = False
        try:
            # the budget is re-measured at dispatch: pool queue wait has
            # already consumed part of the client's remaining time
            if deadline is not None and deadline.budget_s is not None:
                req = dict(req, deadline_s=max(deadline.remaining(), 0.0))
            cap = self.job_timeout_s
            if deadline is not None and deadline.budget_s is not None:
                cap = min(cap, max(deadline.remaining(), 0.0) + self.GRACE_S)
            try:
                w.conn.send((op, req))
                end = time.monotonic() + cap
                while True:
                    if w.conn.poll(self.POLL_S):
                        return w.conn.recv()
                    if not w.proc.is_alive():
                        raise WorkerCrash(
                            f"worker pid {w.proc.pid} died mid-job")
                    if time.monotonic() >= end:
                        raise WorkerCrash(
                            f"worker pid {w.proc.pid} wedged past "
                            f"{cap:.1f}s cap; killed")
            except (EOFError, BrokenPipeError, OSError) as e:
                raise WorkerCrash(f"worker pipe died: {e}") from e
        except WorkerCrash:
            lost = True
            raise
        finally:
            if lost:
                with self._lock:
                    self.crashes += 1
                self._retire(w)
                if not self._closed:
                    self._idle.put(self._spawn())
            else:
                self._idle.put(w)

    def run(self, op: str, req: Dict[str, Any],
            deadline: Optional[Deadline],
            on_crash: Optional[Callable[[WorkerCrash], None]] = None
            ) -> Tuple:
        """:meth:`run_once` with one bounded retry on a fresh worker —
        a random crash is recovered transparently; a poison request
        burns exactly two workers, then surfaces as
        :class:`WorkerCrash` for the daemon to marshal as the typed
        ``worker_crashed`` response."""
        try:
            return self.run_once(op, req, deadline)
        except WorkerCrash as e:
            if on_crash is not None:
                on_crash(e)
            return self.run_once(op, req, deadline)

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            return {"workers": self.workers, "spawned": self.spawned,
                    "crashes": self.crashes, "jobs": self.jobs,
                    "idle": self._idle.qsize()}

    def close(self) -> None:
        self._closed = True
        while True:                       # polite sentinel to idle workers
            try:
                w = self._idle.get_nowait()
            except queue.Empty:
                break
            try:
                w.conn.send(None)
            except (BrokenPipeError, OSError):
                pass
        with self._lock:
            procs = list(self._procs)
            self._procs = []
        for w in procs:
            w.proc.join(timeout=1.0)
            if w.proc.is_alive():
                w.proc.terminate()
                w.proc.join(timeout=2.0)
            if w.proc.is_alive():
                w.proc.kill()
                w.proc.join(timeout=2.0)
            try:
                w.conn.close()
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the daemon
# ---------------------------------------------------------------------------


class _Flight:
    """One in-flight keyed computation; waiters block on the event and
    read the identical encoded response frame."""

    __slots__ = ("event", "frame")

    def __init__(self):
        self.event = threading.Event()
        self.frame: Optional[bytes] = None


class _Shutdown(Exception):
    pass


class SchedDaemon:
    """See the module docstring.  Thread-per-connection; all shared
    state (the flight table, the frame cache, counters) is mutated
    under ``_lock``; the ScheduleCache itself relies on the GIL plus
    atomic on-disk publishes, same as the multi-process case."""

    def __init__(self, sock_path: Optional[str],
                 cache_dir: Optional[str] = None, *,
                 workers: int = 0, max_inflight: int = 8,
                 conn_timeout: float = 10.0, frame_cache_cap: int = 256,
                 frame_cache_bytes: int = 32 << 20,
                 job_timeout: float = 600.0, chaos: bool = False,
                 listen: Optional[str] = None,
                 auth_key: Optional[bytes] = None,
                 peers: Tuple[str, ...] = (),
                 push_storm_max: Optional[int] = None,
                 push_storm_window: Optional[float] = None):
        self.sock_path = sock_path
        self.listen = listen
        self.auth_key = auth_key
        self.peers = tuple(peers)
        if listen is not None and auth_key is None:
            raise ValueError(
                "refusing to listen on TCP without a shared key: pickle "
                "from an unauthenticated network peer is code execution "
                f"(set ${wire.KEY_ENV} or pass --keyfile)")
        if sock_path is None and listen is None:
            raise ValueError("daemon needs --sock and/or --listen")
        self.tcp_port: Optional[int] = None   # set by start() (port 0 ok)
        self.cache = ScheduleCache(cache_dir=cache_dir)
        self.max_inflight = max_inflight
        self.conn_timeout = conn_timeout
        self.chaos = chaos
        self.journal = (AutotuneJournal(os.path.join(self.cache.dir,
                                                     JOURNAL_FILE))
                        if self.cache.disk else None)
        self.recovered: List[str] = (self.journal.recover()
                                     if self.journal else [])
        self._lock = threading.Lock()
        self._flights: Dict[Any, _Flight] = {}
        self._frames = FrameCache(cap_entries=frame_cache_cap,
                                  cap_bytes=frame_cache_bytes)
        self.pool: Optional[WorkerPool] = (
            WorkerPool(workers, self.cache.dir, disk=self.cache.disk,
                       chaos=chaos, job_timeout_s=job_timeout)
            if workers > 0 else None)
        self._listener: Optional[socket.socket] = None
        self._tcp_listener: Optional[socket.socket] = None
        self._accept_threads: List[threading.Thread] = []
        self._stop = threading.Event()
        self._peer_clients: Dict[str, Any] = {}
        if push_storm_max is None:
            push_storm_max = int(os.environ.get(
                "POLYTOPS_TORCH_PUSH_STORM_MAX", PUSH_STORM_MAX))
        if push_storm_window is None:
            push_storm_window = float(os.environ.get(
                "POLYTOPS_TORCH_PUSH_STORM_WINDOW", PUSH_STORM_WINDOW_S))
        self.push_storm_max = max(push_storm_max, 0)
        self.push_storm_window = max(push_storm_window, 0.0)
        self._push_admits: Deque[float] = deque()
        self.counters: Dict[str, int] = {
            "requests": 0, "computed": 0, "coalesced": 0, "frame_hits": 0,
            "shed": 0, "bad_frames": 0, "version_skew": 0, "slow_loris": 0,
            "degraded": 0, "errors": 0, "pool_jobs": 0, "worker_crashes": 0,
            "winner_pushes": 0, "auth_failed": 0, "idle_closed": 0,
            "peer_pushes_sent": 0, "peer_pushes_recv": 0,
            "peer_pushes_capped": 0,
        }

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.sock_path is not None:
            d = os.path.dirname(self.sock_path)
            if d:
                os.makedirs(d, exist_ok=True)
            try:
                os.unlink(self.sock_path)  # stale socket from a kill -9
            except FileNotFoundError:
                pass
            self._listener = socket.socket(socket.AF_UNIX,
                                           socket.SOCK_STREAM)
            self._listener.bind(self.sock_path)
            os.chmod(self.sock_path, 0o600)   # same-user peers only
            self._start_listener(self._listener, tcp=False)
        if self.listen is not None:
            kind, target = wire.parse_address(self.listen)
            if kind != "tcp":
                raise ValueError(f"--listen wants host:port, got "
                                 f"{self.listen!r}")
            tl = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            tl.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            tl.bind(target)
            self.tcp_port = tl.getsockname()[1]   # resolves port 0
            self._tcp_listener = tl
            self._start_listener(tl, tcp=True)

    def _start_listener(self, listener: socket.socket, *,
                        tcp: bool) -> None:
        listener.listen(64)
        listener.settimeout(0.2)
        t = threading.Thread(
            target=self._accept_loop, args=(listener, tcp),
            name=f"schedd-accept-{'tcp' if tcp else 'unix'}", daemon=True)
        t.start()
        self._accept_threads.append(t)

    def stop(self) -> None:
        self._stop.set()
        for t in self._accept_threads:
            t.join(timeout=5.0)
        for listener in (self._listener, self._tcp_listener):
            if listener is not None:
                try:
                    listener.close()
                except OSError:
                    pass
        if self.pool is not None:
            self.pool.close()
        for c in self._peer_clients.values():
            c.close()
        if self.sock_path is not None:
            try:
                os.unlink(self.sock_path)
            except OSError:
                pass

    def wait(self) -> None:
        while not self._stop.wait(timeout=0.5):
            pass

    def _accept_loop(self, listener: socket.socket, tcp: bool) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = listener.accept()
            except socket.timeout:
                continue
            except OSError:
                break
            if tcp:
                try:
                    conn.setsockopt(socket.IPPROTO_TCP,
                                    socket.TCP_NODELAY, 1)
                except OSError:
                    pass
            threading.Thread(target=self._handle_conn, args=(conn, tcp),
                             daemon=True).start()

    # -- connection handling ----------------------------------------------

    def _handle_conn(self, conn: socket.socket, tcp: bool = False) -> None:
        conn.settimeout(self.conn_timeout)
        session: Optional[wire.Session] = None
        handshaken = False
        try:
            # the hello (and the whole handshake) is JSON under the
            # pre-auth cap: nothing a yet-unauthenticated peer sends is
            # ever unpickled or buffered beyond a few KiB
            hello = wire.recv_frame(conn, eof_ok=True, json_codec=True,
                                    max_bytes=wire.PRE_AUTH_MAX_FRAME_BYTES)
            if hello is None:
                return
            if hello.get("op") != "hello":
                self._count("bad_frames")
                wire.send_frame(conn, {"ok": False, "error": "bad_frame",
                                       "detail": "expected hello"},
                                json_codec=True)
                return
            skew = wire.version_skew(hello)
            if skew:
                self._count("version_skew")
                wire.send_frame(conn, {"ok": False, "error": "version_skew",
                                       "detail": skew}, json_codec=True)
                return
            hello_ok = {"ok": True, "op": "hello", "pid": os.getpid(),
                        **wire.wire_versions()}
            try:
                session = wire.server_handshake(
                    conn, hello, key=self.auth_key, require_auth=tcp,
                    hello_ok=hello_ok)
            except wire.AuthFailed:
                self._count("auth_failed")   # typed reply already sent
                return
            handshaken = True
            while True:
                try:
                    req = wire.recv_frame(conn, eof_ok=True,
                                          session=session, idle_ok=True)
                except wire.IdleTimeout:
                    # a pooled keep-alive connection went quiet at a
                    # frame boundary — that's reuse working, not a
                    # stalled peer
                    self._count("idle_closed")
                    return
                if req is None:
                    return
                self._count("requests")
                if not isinstance(req, dict):
                    self._count("bad_frames")
                    wire.send_frame(conn, {
                        "ok": False, "error": "bad_frame",
                        "detail": f"request is {type(req).__name__}, "
                                  f"not a dict"}, session=session)
                    continue
                # local_only: the inline handlers call into akg, whose
                # remote hook must never route the daemon's own work
                # back to a daemon (ourselves, for the in-process test
                # harness); pool workers carry the server mark instead
                with schedclient.local_only():
                    frame = self._dispatch(req)
                self._send_prepared(conn, session, frame)
        except _Shutdown as e:
            try:
                self._send_prepared(conn, session, e.args[0])  # "bye"
            except OSError:
                pass
            self._stop.set()
        except wire.AuthFailed as e:
            # a post-handshake MAC mismatch: typed reply, drop the conn
            self._count("auth_failed")
            try:
                wire.send_frame(conn, {"ok": False, "error": "auth_failed",
                                       "detail": str(e)}, session=session)
            except OSError:
                pass
        except wire.ProtocolError as e:
            self._count("bad_frames")
            try:          # best effort: the peer may already be gone
                wire.send_frame(conn, {"ok": False, "error": "bad_frame",
                                       "detail": str(e)},
                                json_codec=not handshaken,
                                session=session)
            except OSError:
                pass
        except socket.timeout:
            self._count("slow_loris")     # stalled peer: drop it
        except OSError:
            pass
        finally:
            try:
                conn.close()
            except OSError:
                pass

    @staticmethod
    def _send_prepared(conn: socket.socket,
                       session: Optional["wire.Session"],
                       frame: bytes) -> None:
        """Send a pre-encoded (possibly frame-cached) response frame,
        appending this connection's MAC tag when authenticated — cached
        bytes are shared across connections, tags never are."""
        if session is None:
            conn.sendall(frame)
        else:
            body = frame[wire.HEADER_LEN:]
            conn.sendall(frame + session.sign(body))

    def _count(self, name: str, n: int = 1) -> None:
        with self._lock:
            self.counters[name] = self.counters.get(name, 0) + n

    # -- dispatch ----------------------------------------------------------

    def _dispatch(self, req: Dict[str, Any]) -> bytes:
        op = req.get("op")
        if op == "ping":
            return wire.encode_frame({"ok": True, "op": "pong",
                                      "pid": os.getpid()})
        if op == "stats":
            return wire.encode_frame({"ok": True, "result": self.stats()})
        if op == "shutdown":
            frame = wire.encode_frame({"ok": True, "op": "bye"})
            raise _Shutdown(frame)        # _handle_conn sets the stop flag
        handlers = {"schedule": self._handle_schedule,
                    "autotune": self._handle_autotune,
                    "plan": self._handle_plan,
                    "winner_push": self._handle_winner_push}
        if op not in handlers:
            return wire.encode_frame({"ok": False, "error": "bad_request",
                                      "detail": f"unknown op {op!r}"})
        try:
            return handlers[op](req)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:     # a handler bug must not kill the daemon
            self._count("errors")
            return wire.encode_frame({
                "ok": False, "error": "internal",
                "detail": f"{type(e).__name__}: {e}"})

    def _deadline(self, req: Dict[str, Any]) -> Optional[Deadline]:
        budget = req.get("deadline_s")
        return Deadline(float(budget)) if budget is not None else None

    # -- coalescing + compute core ----------------------------------------

    def _serve_keyed(self, key: Optional[Any], op: str,
                     req: Dict[str, Any],
                     deadline: Optional[Deadline]) -> bytes:
        """Coalesce + shed + frame-cache around one keyed computation.

        The computation itself runs through :meth:`_compute_job`
        (inline or on a pool worker).  The encoded frame is shared with
        every coalesced waiter and, when cacheable (non-degraded
        success), admitted to the latency-saved frame cache weighted by
        the flight's measured wall time; winner pushes are admitted
        *before* the flight event wakes the waiters."""
        owner_flight: Optional[_Flight] = None
        existing: Optional[_Flight] = None
        if key is not None:
            with self._lock:
                cached = self._frames.get(key)
                if cached is not None:
                    self.counters["frame_hits"] += 1
                    return cached
                existing = self._flights.get(key)
                if existing is not None:
                    self.counters["coalesced"] += 1
                else:
                    if len(self._flights) >= self.max_inflight:
                        self.counters["shed"] += 1
                        return wire.encode_frame({
                            "ok": False, "error": "overloaded",
                            "detail": f"{len(self._flights)} computations "
                                      f"in flight (cap {self.max_inflight})"})
                    owner_flight = _Flight()
                    self._flights[key] = owner_flight
            if owner_flight is None:
                budget = None
                if deadline is not None and deadline.budget_s is not None:
                    budget = max(deadline.remaining(), 0.0)
                if not existing.event.wait(
                        timeout=budget if budget is not None else 600.0):
                    return wire.encode_frame({
                        "ok": False, "error": "deadline",
                        "detail": "coalesced wait exceeded the budget"})
                assert existing.frame is not None
                return existing.frame
        else:
            with self._lock:
                if len(self._flights) >= self.max_inflight:
                    self.counters["shed"] += 1
                    return wire.encode_frame({
                        "ok": False, "error": "overloaded",
                        "detail": f"{len(self._flights)} computations "
                                  f"in flight (cap {self.max_inflight})"})

        self._count("computed")
        try:
            resp, cacheable, pushes, compute_s = self._compute_job(
                key, op, req, deadline)
            # encode inside the try: an unencodable result must not
            # leave coalesced waiters blocked on a never-set flight
            frame = wire.encode_frame(resp)
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception as e:
            resp, cacheable, pushes, compute_s = (
                {"ok": False, "error": "internal",
                 "detail": f"{type(e).__name__}: {e}"}, False, [], 0.0)
            frame = wire.encode_frame(resp)
        meta = resp.get("meta") if isinstance(resp, dict) else None
        if isinstance(meta, dict) and meta.get("degraded"):
            self._count("degraded")
        if not resp.get("ok") and resp.get("error") in ("internal",
                                                        "worker_crashed"):
            self._count("errors")
        if owner_flight is not None:
            admitted: List[Tuple[Any, Dict[str, Any]]] = []
            with self._lock:
                self._flights.pop(key, None)
                if cacheable and resp.get("ok"):
                    self._frames.put(key, frame, compute_s)
                # winner-store push BEFORE event.set(): a follower woken
                # by this flight already finds the pushed frame warm
                for pkey, presp in pushes or ():
                    try:
                        pframe = wire.encode_frame(presp)
                    except Exception:
                        continue
                    if self._admit_push_locked(
                            pkey, pframe, compute_s * PUSH_COST_FRACTION):
                        self.counters["winner_pushes"] += 1
                        admitted.append((pkey, presp))
            owner_flight.frame = frame
            owner_flight.event.set()
            if admitted and self.peers:
                self._push_to_peers(admitted, compute_s)
        return frame

    def _admit_push_locked(self, pkey: Any, pframe: bytes,
                           cost_s: float) -> bool:
        """The winner-push admission path (held ``_lock`` required):
        never displace an existing frame or race an in-flight
        computation for the same key."""
        if pkey in self._frames or pkey in self._flights:
            return False
        return bool(self._frames.put(pkey, pframe, cost_s))

    # -- peer winner push ---------------------------------------------------

    def _peer_client(self, peer: str):
        c = self._peer_clients.get(peer)
        if c is None:
            c = schedclient.SchedClient(
                peer, connect_timeout=1.0, request_timeout=10.0,
                retries=0, key=self.auth_key)
            self._peer_clients[peer] = c
        return c

    def _push_to_peers(self, admitted: List[Tuple[Any, Dict[str, Any]]],
                       compute_s: float) -> None:
        """Forward freshly admitted winner frames to every ``--peers``
        daemon, asynchronously and best-effort: a slow or dead peer
        costs a background thread a timeout, never a client request.
        Only *locally computed* winners are forwarded (the receiving
        handler never re-forwards), so a fleet cannot push in circles."""

        def _send() -> None:
            for peer in self.peers:
                c = self._peer_client(peer)
                for pkey, presp in admitted:
                    try:
                        with schedclient.local_only():
                            c._request({"op": "winner_push", "key": pkey,
                                        "resp": presp,
                                        "compute_s": compute_s}, 10.0)
                        self._count("peer_pushes_sent")
                    except (wire.SchedClientError, OSError):
                        break             # skip this peer's remaining keys

        threading.Thread(target=_send, name="schedd-peer-push",
                         daemon=True).start()

    def _compute_job(self, key: Optional[Any], op: str,
                     req: Dict[str, Any],
                     deadline: Optional[Deadline]) -> Tuple:
        """One computation: pool dispatch (with crash retry + journal
        witnessing) when a pool exists, else inline.  Returns
        ``(resp, cacheable, pushes, compute_s)``; only unexpected
        daemon-side failures raise."""
        fault_point("pool.dispatch")
        jkey: Optional[str] = None
        if (op == "autotune" and self.journal is not None
                and isinstance(key, tuple) and len(key) == 2):
            jkey = str(key[1])
            # journal BEFORE the computation (including any chaos hold):
            # the work is accepted the moment we own the flight, so a
            # kill -9 during it is exactly the "crash mid-request" the
            # journal must witness
            self.journal.begin(jkey)
        outcome = "done"
        try:
            if self.pool is not None:
                self._count("pool_jobs")

                def witness(crash: WorkerCrash) -> None:
                    self._count("worker_crashes")
                    if jkey is not None and self.journal is not None:
                        self.journal.crashed(jkey, str(crash))

                try:
                    return self.pool.run(op, req, deadline, on_crash=witness)
                except WorkerCrash as e:
                    outcome = "crashed"
                    witness(e)
                    return ({"ok": False, "error": "worker_crashed",
                             "detail": str(e)}, False, [], 0.0)
            t0 = time.perf_counter()
            resp, cacheable, pushes = compute_request(
                op, req, self.cache, chaos=self.chaos, deadline=deadline)
            return resp, cacheable, pushes, time.perf_counter() - t0
        finally:
            if jkey is not None and self.journal is not None \
                    and outcome == "done":
                # done even on typed failure: the work is over either
                # way — only an unwitnessed crash leaves an orphan
                self.journal.done(jkey)

    # -- handlers ----------------------------------------------------------

    def _handle_schedule(self, req: Dict[str, Any]) -> bytes:
        from ..core.config import SchedulerConfig

        scop = req["scop"]
        config = req.get("config") or SchedulerConfig()
        engine = req.get("engine", "lex")
        with_tree = bool(req.get("with_tree", False))
        extra = dict(req.get("extra") or {})
        try:
            skey = schedule_key(scop, config, engine, extra=extra)
        except Exception:
            skey = None
        key = ("schedule", skey, with_tree) if skey is not None else None
        return self._serve_keyed(key, "schedule", req, self._deadline(req))

    def _handle_autotune(self, req: Dict[str, Any]) -> bytes:
        scop = req["scop"]
        kwargs = dict(req.get("kwargs") or {})
        try:
            digest = hashlib.sha256(json.dumps(
                {"scop": scop_fingerprint(scop),
                 "kwargs": {k: kwargs[k] for k in sorted(kwargs)}},
                sort_keys=True, separators=(",", ":"),
                default=str).encode()).hexdigest()
            key: Optional[Any] = ("autotune", digest)
        except Exception:
            key = None
        return self._serve_keyed(key, "autotune", req, self._deadline(req))

    def _handle_plan(self, req: Dict[str, Any]) -> bytes:
        kind = req.get("kind")
        if kind not in ("matmul", "attention", "mamba_scan", "scan_gate"):
            # reject before burning a flight slot or a pool worker
            return wire.encode_frame({
                "ok": False, "error": "bad_request",
                "detail": f"unknown plan kind {kind!r}"})
        args = tuple(req.get("args") or ())
        kwargs = dict(req.get("kwargs") or {})
        try:
            key: Optional[Any] = ("plan", kind, args,
                                  tuple(sorted(kwargs.items())))
        except TypeError:
            key = None
        return self._serve_keyed(key, "plan", req, self._deadline(req))

    def _handle_winner_push(self, req: Dict[str, Any]) -> bytes:
        """A sibling daemon pushing an autotune winner's schedule frame.
        Reuses the local admission path; never re-forwarded (the sender
        is the only daemon that computed it), so pushes cannot loop."""
        pkey = req.get("key")
        presp = req.get("resp")
        if not (isinstance(presp, dict) and presp.get("ok")
                and pkey is not None):
            return wire.encode_frame({
                "ok": False, "error": "bad_request",
                "detail": "winner_push wants key + ok resp"})
        meta = presp.get("meta")
        if not (isinstance(meta, dict) and not meta.get("degraded")):
            return wire.encode_frame({
                "ok": False, "error": "bad_request",
                "detail": "refusing a degraded winner push"})
        try:
            cost_s = float(req.get("compute_s") or 0.0)
            pframe = wire.encode_frame(presp)
        except Exception as e:
            return wire.encode_frame({
                "ok": False, "error": "bad_request",
                "detail": f"unencodable push: {type(e).__name__}: {e}"})
        with self._lock:
            if not self._push_storm_ok_locked():
                self.counters["peer_pushes_capped"] += 1
                self._frames.stats["push_capped"] += 1
                return wire.encode_frame({"ok": True, "admitted": False,
                                          "capped": True})
            admitted = self._admit_push_locked(
                pkey, pframe, cost_s * PUSH_COST_FRACTION)
            if admitted:
                self.counters["peer_pushes_recv"] += 1
                self._push_admits.append(time.monotonic())
        return wire.encode_frame({"ok": True, "admitted": admitted})

    def _push_storm_ok_locked(self) -> bool:
        """Sliding-window admission bound on peer pushes (held ``_lock``
        required): True while fewer than ``push_storm_max`` pushes were
        admitted in the trailing ``push_storm_window`` seconds."""
        now = time.monotonic()
        horizon = now - self.push_storm_window
        while self._push_admits and self._push_admits[0] < horizon:
            self._push_admits.popleft()
        return len(self._push_admits) < self.push_storm_max

    # -- introspection -----------------------------------------------------

    def stats(self) -> Dict[str, Any]:
        with self._lock:
            counters = dict(self.counters)
            inflight = len(self._flights)
            frames = self._frames.snapshot()
        return {
            "pid": os.getpid(),
            "sock": self.sock_path,
            "listen": self.listen,
            "tcp_port": self.tcp_port,
            "peers": list(self.peers),
            "cache_dir": self.cache.dir,
            "counters": counters,
            "inflight": inflight,
            "workers": self.pool.workers if self.pool is not None else 0,
            "pool": self.pool.stats() if self.pool is not None else None,
            "frame_cache": frames["entries"],
            "frames": frames,
            "cache": self.cache.stats.as_dict(),
            "journal_recovered": len(self.recovered),
            "journal_recovered_keys": list(self.recovered),
            "versions": wire.wire_versions(),
            "chaos": self.chaos,
        }


def default_socket_path() -> str:
    env = os.environ.get(wire.SOCKET_ENV)
    if env:
        return env
    return os.path.join(os.path.expanduser("~"), ".cache", "polytops_torch",
                        "schedd.sock")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--sock", default=default_socket_path(),
                    help="Unix socket path (default $POLYTOPS_TORCH_SCHEDD_SOCK "
                         "or ~/.cache/polytops_torch/schedd.sock)")
    ap.add_argument("--cache-dir", default=None,
                    help="schedule-cache pool (default schedcache's)")
    ap.add_argument("--workers", type=int, default=0,
                    help="forked worker processes for keyed computations "
                         "(0 = compute inline in the connection thread)")
    ap.add_argument("--max-inflight", type=int, default=8)
    ap.add_argument("--conn-timeout", type=float, default=10.0,
                    help="per-connection recv timeout (slow-loris guard)")
    ap.add_argument("--job-timeout", type=float, default=600.0,
                    help="hard cap on one worker job (wedge guard)")
    ap.add_argument("--frame-cache-cap", type=int, default=256,
                    help="frame-cache entry cap")
    ap.add_argument("--listen", default=None, metavar="HOST:PORT",
                    help="also serve TCP (requires a shared key via "
                         "--keyfile or $POLYTOPS_TORCH_SCHEDD_KEY); port 0 "
                         "binds an ephemeral port (see --port-file)")
    ap.add_argument("--keyfile", default=None,
                    help="file holding the shared TCP auth key")
    ap.add_argument("--peers", default="",
                    help="comma-separated sibling daemon addresses to "
                         "push autotune winners to")
    ap.add_argument("--port-file", default=None,
                    help="write the bound TCP port here once listening "
                         "(ephemeral-port discovery)")
    ap.add_argument("--push-storm-max", type=int, default=None,
                    help="peer winner pushes admitted per storm window "
                         f"(default $POLYTOPS_TORCH_PUSH_STORM_MAX or "
                         f"{PUSH_STORM_MAX})")
    ap.add_argument("--push-storm-window", type=float, default=None,
                    help="sliding window seconds for --push-storm-max "
                         f"(default $POLYTOPS_TORCH_PUSH_STORM_WINDOW or "
                         f"{PUSH_STORM_WINDOW_S})")
    ap.add_argument("--chaos", action="store_true",
                    help="enable the test-only test_delay_s / "
                         "test_kill_worker request fields")
    args = ap.parse_args(argv)

    # the daemon's own scheduling work must never route back through a
    # client pointed at ourselves
    schedclient.mark_server_process()

    auth_key = wire.load_key(args.keyfile)
    peers = tuple(p.strip() for p in args.peers.split(",") if p.strip())
    daemon = SchedDaemon(args.sock, cache_dir=args.cache_dir,
                         workers=args.workers,
                         max_inflight=args.max_inflight,
                         conn_timeout=args.conn_timeout,
                         frame_cache_cap=args.frame_cache_cap,
                         job_timeout=args.job_timeout, chaos=args.chaos,
                         listen=args.listen, auth_key=auth_key,
                         peers=peers,
                         push_storm_max=args.push_storm_max,
                         push_storm_window=args.push_storm_window)
    daemon.start()
    if args.port_file and daemon.tcp_port is not None:
        tmp = args.port_file + ".tmp"
        with open(tmp, "w") as f:
            f.write(str(daemon.tcp_port))
        os.replace(tmp, args.port_file)
    listening = " + ".join(
        s for s in (args.sock,
                    f"tcp:{daemon.tcp_port}" if daemon.tcp_port else None)
        if s)
    print(f"schedd: pid {os.getpid()} listening on {listening} "
          f"(cache {daemon.cache.dir}, workers {args.workers}, "
          f"peers {len(peers)}, "
          f"journal recovered {len(daemon.recovered)})", flush=True)

    def _term(signum, frame):
        daemon._stop.set()

    signal.signal(signal.SIGTERM, _term)
    signal.signal(signal.SIGINT, _term)
    try:
        daemon.wait()
    finally:
        daemon.stop()
    print("schedd: stopped", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
