"""Structural schedule cache: (Scop, SchedulerConfig, engine) → Schedule.

The AKG-style integration puts PolyTOPS on the compile hot path of every
custom op, and serving/benchmark loops schedule the *same kernel shapes*
over and over.  This module makes repeat scheduling a dictionary lookup:

* **Cache key** — a SHA-256 over a canonical JSON rendering of the SCoP
  structure (statement iterators, domains, access subscripts, beta
  vectors, loop nesting), the full scheduler configuration (including
  the fields ``to_json`` elides: coefficient bounds, parametric-shift,
  fusion mode), the engine, and a format version.  Two structurally
  identical kernels built through any code path hash equal; any change
  that could alter the resulting schedule changes the key.
  Configurations with a Python ``strategy`` callback are *uncacheable*
  (the callback's behaviour is not hashable) and bypass the cache.

* **Two tiers** — a process-local dict, then an on-disk pickle pool
  (``$POLYTOPS_TORCH_CACHE_DIR`` or ``~/.cache/polytops_torch/sched``) so
  separate processes (benchmark sweeps, serving workers) share warm
  schedules.  The pool is the port's own: its pickles hold
  ``repro_torch.core`` objects, and the reference package keeps its
  pickles of its own objects under its own directory and variable.
  Disk failures degrade to cache-miss behaviour, but never silently
  anymore: every outcome is counted in :class:`CacheStats`
  (hits/misses/disk_hits/corrupt/evicted) and a corrupt pickle is
  *quarantined* — moved aside for inspection and recomputed, so one bad
  file can't re-corrupt every future read.  Writes are atomic
  (tmp+rename) and the measurement pool appends under an advisory lock.
  The ``cache.read``/``cache.write`` fault sites let tests inject disk
  failures deterministically.

Cached ``Schedule`` objects carry their own ``Scop``/dependence objects;
per-dependence compiled-LP state is stripped on pickling (see
``Dependence.__getstate__``), so entries stay compact.
"""
from __future__ import annotations

import contextlib
import hashlib
import json
import os
import pickle
import tempfile
from dataclasses import asdict, dataclass
from typing import Any, Dict, Optional

from .config import SchedulerConfig
from .ilp import SOLVER_TAG
from .resilience import fault_point
from .schedtree import TREE_VERSION
from .scop import Scop

try:
    import fcntl
except ImportError:          # non-POSIX: appends still line-atomic via O_APPEND
    fcntl = None

# bump when Schedule layout or scheduler semantics change incompatibly
# (v2: exact lexsimplex backend became the default — canonical optima
# differ from the HiGHS-era vertices, so v1 entries must not be reused;
# v3: Schedule carries degradation-ladder provenance fields — pre-
# resilience pickles lack them and must not be served)
CACHE_VERSION = 3


# ---------------------------------------------------------------------------
# fingerprints
# ---------------------------------------------------------------------------

def _affine_json(expr) -> list:
    return sorted((str(k), str(v)) for k, v in expr.items() if v)


def scop_fingerprint(scop: Scop) -> Dict[str, Any]:
    """Canonical, order-stable rendering of everything about a SCoP that
    can influence its schedule."""
    stmts = []
    for s in scop.statements:
        stmts.append({
            "iters": list(s.iters),
            "domain": sorted((kind, _affine_json(e)) for e, kind in s.domain),
            "accesses": [
                [a.array, a.is_write, [_affine_json(sub) for sub in a.subscripts]]
                for a in s.accesses
            ],
            "beta": list(s.beta),
            "loop_ids": list(s.loop_ids),
        })
    return {
        "params": dict(sorted(scop.params.items())),
        "param_min": scop.param_min,
        "stmts": stmts,
    }


def config_fingerprint(cfg: SchedulerConfig) -> Optional[Dict[str, Any]]:
    """Canonical config rendering, or None when the config is not
    cacheable (dynamic strategy callback)."""
    if cfg.strategy is not None:
        return None
    fp = cfg.to_json()
    # to_json omits fields that nevertheless steer the scheduler
    fp["coeff_bound"] = cfg.coeff_bound
    fp["cst_bound"] = cfg.cst_bound
    fp["parametric_shift"] = cfg.parametric_shift
    fp["custom_constraints"] = {
        str(k): list(v) for k, v in sorted(cfg.custom_constraints.items(),
                                           key=lambda kv: str(kv[0]))
    }
    return fp


def schedule_key(scop: Scop, cfg: SchedulerConfig, engine: str,
                 extra: Optional[Dict[str, Any]] = None) -> Optional[str]:
    """Stable digest for a (Scop, config, engine) triple, or None when
    the combination cannot be cached.  The key carries the solver tag of
    the exact backend: a pivoting/canonicalization change that could
    alter the chosen optimum invalidates every entry.  ``extra`` carries
    any scheduler kwargs that can change the result (``incremental``,
    ``decompose``); under the exact engine both pipelines provably agree,
    but the keys stay distinct so a disagreement could never be masked
    by cache sharing."""
    cfp = config_fingerprint(cfg)
    if cfp is None:
        return None
    payload = json.dumps(
        {"v": CACHE_VERSION, "engine": engine, "solver": SOLVER_TAG,
         # cached Schedule payloads may carry a memoized schedule tree
         # (see cached_schedule_scop); a tree-format/construction change
         # must invalidate them even when the schedule rows are unchanged
         "tree": TREE_VERSION,
         "scop": scop_fingerprint(scop), "config": cfp,
         "extra": dict(sorted((extra or {}).items()))},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# the cache
# ---------------------------------------------------------------------------

def default_cache_dir() -> Optional[str]:
    d = os.environ.get("POLYTOPS_TORCH_CACHE_DIR")
    if d:
        return d
    home = os.path.expanduser("~")
    return os.path.join(home, ".cache", "polytops_torch", "sched")


@dataclass
class CacheStats:
    """Every cache outcome, counted — nothing is swallowed untallied.

    ``corrupt`` counts quarantined on-disk entries (unpicklable payload,
    injected read fault); ``evicted`` counts entries dropped by a cap
    (the ScheduleCache memory tier's FIFO cap, or a FrameCache's
    entry/byte caps).  ``bytes`` and ``latency_saved_s`` are maintained
    by :class:`FrameCache` only: the bytes currently retained, and the
    cumulative measured compute-seconds that warm hits avoided
    recomputing.  ``push_capped`` counts peer winner pushes refused by
    the schedd storm cap (rate-bounded admission protecting the frame
    cache from fleet-wide push bursts).  Indexable like a dict
    (``stats["hits"]``).
    """
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    corrupt: int = 0
    evicted: int = 0
    bytes: int = 0
    latency_saved_s: float = 0.0
    push_capped: int = 0

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __setitem__(self, k: str, v) -> None:
        setattr(self, k, v)

    def as_dict(self) -> Dict[str, Any]:
        d = asdict(self)
        d["latency_saved_s"] = round(d["latency_saved_s"], 6)
        return d


class ScheduleCache:
    """In-memory + on-disk schedule cache.  Disk trouble degrades to a
    miss; corrupt entries are quarantined and counted, never raised."""

    def __init__(self, cache_dir: Optional[str] = None, disk: bool = True,
                 mem_cap: int = 4096):
        self.mem: Dict[str, Any] = {}
        self.dir = cache_dir if cache_dir is not None else default_cache_dir()
        self.disk = disk and self.dir is not None
        self.mem_cap = mem_cap
        self.stats = CacheStats()

    def _path(self, key: str) -> str:
        return os.path.join(self.dir, key[:2], key + ".pkl")

    def _quarantine(self, path: str) -> None:
        """Move a corrupt entry aside (bad file kept for inspection,
        recomputed as a miss — never a crash, never re-read)."""
        self.stats.corrupt += 1
        try:
            qdir = os.path.join(self.dir, "quarantine")
            os.makedirs(qdir, exist_ok=True)
            os.replace(path, os.path.join(qdir, os.path.basename(path)))
        except OSError:
            try:
                os.unlink(path)
            except OSError:
                pass

    def get(self, key: Optional[str]):
        if key is None:
            self.stats.misses += 1
            return None
        hit = self.mem.get(key)
        if hit is not None:
            self.stats.hits += 1
            return hit
        if self.disk:
            path = self._path(key)
            try:
                fault_point("cache.read")
                with open(path, "rb") as f:
                    hit = pickle.load(f)
                self._mem_put(key, hit)
                self.stats.hits += 1
                self.stats.disk_hits += 1
                return hit
            except FileNotFoundError:
                pass
            except (KeyboardInterrupt, SystemExit):
                raise
            except Exception:
                # one retry distinguishes a transient IO/injected fault
                # (passes the second time — serve it) from genuine
                # corruption (fails again — quarantine, count, recompute)
                try:
                    with open(path, "rb") as f:
                        hit = pickle.load(f)
                    self._mem_put(key, hit)
                    self.stats.hits += 1
                    self.stats.disk_hits += 1
                    return hit
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception:
                    if os.path.exists(path):
                        self._quarantine(path)
        self.stats.misses += 1
        return None

    def _mem_put(self, key: str, sched) -> None:
        if key not in self.mem and len(self.mem) >= self.mem_cap:
            # FIFO eviction: dicts preserve insertion order, and the
            # disk tier still holds the entry for a later warm read
            self.mem.pop(next(iter(self.mem)))
            self.stats.evicted += 1
        self.mem[key] = sched

    def put(self, key: Optional[str], sched) -> None:
        if key is None:
            return
        self._mem_put(key, sched)
        if not self.disk:
            return
        try:
            fault_point("cache.write")
            d = os.path.dirname(self._path(key))
            os.makedirs(d, exist_ok=True)
            # atomic publish: temp file + rename, so concurrent workers
            # never observe a torn pickle
            fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
            try:
                with os.fdopen(fd, "wb") as f:
                    pickle.dump(sched, f, protocol=pickle.HIGHEST_PROTOCOL)
                os.replace(tmp, self._path(key))
            except Exception:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        except (KeyboardInterrupt, SystemExit):
            raise
        except Exception:
            pass

    def clear(self) -> None:
        self.mem.clear()


# ---------------------------------------------------------------------------
# frame cache: pre-encoded response frames, retained by latency saved
# ---------------------------------------------------------------------------


class _Frame:
    """One cached frame: the encoded bytes, the measured seconds the
    original computation took (what a warm hit saves), and hit count."""

    __slots__ = ("frame", "compute_s", "hits", "seq")

    def __init__(self, frame: bytes, compute_s: float, seq: int):
        self.frame = frame
        self.compute_s = compute_s
        self.hits = 0
        self.seq = seq

    @property
    def score(self) -> float:
        """Measured compute seconds saved per byte of cache spent."""
        return self.compute_s / max(1, len(self.frame))


class FrameCache:
    """Latency-saved-weighted cache of pre-encoded response frames.

    The schedd daemon keeps warm, non-degraded responses as encoded
    frames so a repeat request is one ``sendall``.  FIFO eviction
    treats a 2-second autotune the same as a 2-millisecond
    plan; this cache instead scores every entry by the **measured
    compute seconds a warm hit saves per byte of cache spent**
    (``compute_s / len(frame)``, from the flight timings the daemon
    already collects) and always evicts the lowest score first —
    including the newcomer, so a cheap-to-recompute frame never
    displaces an expensive one.

    Retention is provably no worse than FIFO: every eviction discards
    the minimum-score element of a full cache, so any key FIFO would
    still hold was only dropped here in favour of keys scoring at least
    as high (the frame-cache tests replay random traces against a FIFO
    baseline to pin this down).

    ``stats`` is a :class:`CacheStats`: ``hits``/``misses`` per lookup,
    ``evicted`` per cap-driven drop (newcomer rejections included),
    ``bytes`` the currently retained total, and ``latency_saved_s`` the
    cumulative compute seconds that hits avoided.  Not thread-safe —
    the daemon serializes access under its own lock.
    """

    def __init__(self, cap_entries: int = 256, cap_bytes: int = 32 << 20,
                 stats: Optional[CacheStats] = None):
        self.cap_entries = cap_entries
        self.cap_bytes = cap_bytes
        self.stats = stats if stats is not None else CacheStats()
        self._entries: Dict[Any, _Frame] = {}
        self._seq = 0

    def __len__(self) -> int:
        return len(self._entries)

    def __contains__(self, key: Any) -> bool:
        return key in self._entries

    def get(self, key: Any) -> Optional[bytes]:
        e = self._entries.get(key)
        if e is None:
            self.stats.misses += 1
            return None
        e.hits += 1
        self.stats.hits += 1
        self.stats.latency_saved_s += e.compute_s
        return e.frame

    def put(self, key: Any, frame: bytes, compute_s: float) -> bool:
        """Admit ``frame`` (``compute_s`` = measured seconds the
        computation took).  Returns True when the key is retained after
        cap enforcement — a newcomer scoring below everything already
        cached is dropped immediately (and counted as evicted)."""
        old = self._entries.pop(key, None)
        if old is not None:
            self.stats.bytes -= len(old.frame)
        e = _Frame(frame, max(0.0, float(compute_s)), self._seq)
        self._seq += 1
        if old is not None:
            e.hits = old.hits
        self._entries[key] = e
        self.stats.bytes += len(frame)
        self._enforce_caps()
        return key in self._entries

    def _enforce_caps(self) -> None:
        while self._entries and (len(self._entries) > self.cap_entries
                                 or self.stats.bytes > self.cap_bytes):
            victim = min(self._entries,
                         key=lambda k: (self._entries[k].score,
                                        self._entries[k].seq))
            dropped = self._entries.pop(victim)
            self.stats.bytes -= len(dropped.frame)
            self.stats.evicted += 1

    def retained_latency_s(self) -> float:
        """Total measured compute seconds the retained set would save if
        every entry were hit once — the quantity the eviction policy
        maximizes (per byte), and what the property test compares
        against a FIFO baseline."""
        return sum(e.compute_s for e in self._entries.values())

    def clear(self) -> None:
        self._entries.clear()
        self.stats.bytes = 0

    def snapshot(self) -> Dict[str, Any]:
        """Introspection row for daemon stats: caps, occupancy and the
        score range of the retained set."""
        scores = sorted(e.score for e in self._entries.values())
        return {
            "entries": len(self._entries),
            "cap_entries": self.cap_entries,
            "bytes": self.stats.bytes,
            "cap_bytes": self.cap_bytes,
            "retained_latency_s": round(self.retained_latency_s(), 6),
            "min_score": scores[0] if scores else None,
            "max_score": scores[-1] if scores else None,
            "stats": self.stats.as_dict(),
        }


_GLOBAL: Optional[ScheduleCache] = None


def global_cache() -> ScheduleCache:
    global _GLOBAL
    if _GLOBAL is None:
        _GLOBAL = ScheduleCache()
    return _GLOBAL


def cached_schedule_scop(scop: Scop, config: Optional[SchedulerConfig] = None,
                         engine: str = "lex",
                         cache: Optional[ScheduleCache] = None,
                         with_tree: bool = False, deadline=None, **kwargs):
    """Drop-in cached variant of :func:`repro_torch.core.scheduler.schedule_scop`.

    Uncacheable configs (strategy callbacks) schedule normally.  The
    returned Schedule is shared between callers of the same key — treat
    it as immutable.  Deliberately no ``deps`` pass-through: a cached
    Schedule embeds its Dependence objects (codegen reads their
    ``satisfied_at``), so sharing a caller's dependence list across
    entries would let a later scheduling run mutate earlier cache hits.

    ``with_tree=True`` (the AKG kernel-plan hot path) builds the
    schedule tree (:func:`repro_torch.core.schedtree.schedule_tree`) before
    publishing, so the cache payload carries the FM bounds too — a warm
    process skips both the scheduler *and* the bound computation.  The
    cache key includes the tree format version, so construction changes
    invalidate tree-carrying entries.

    ``deadline`` (a :class:`repro_torch.core.resilience.Deadline`) is
    forwarded to the scheduler but deliberately excluded from the cache
    key: a deadline that never fires doesn't change the schedule, and
    one that fires raises before anything is published — a deadline-
    truncated run can never poison the pool.  Degraded schedules (the
    resilience ladder's rungs 1–3) are likewise never published here.
    """
    from .scheduler import schedule_scop

    config = config or SchedulerConfig()
    cache = cache or global_cache()
    key = schedule_key(scop, config, engine, extra=kwargs)
    hit = cache.get(key)
    if hit is not None:
        if with_tree and getattr(hit, "_tree", None) is None:
            try:
                from .schedtree import schedule_tree
                schedule_tree(hit)          # attach + persist for next time
                cache.put(key, hit)
            except Exception:
                pass
        return hit
    sched = schedule_scop(scop, config, engine=engine, deadline=deadline,
                          **kwargs)
    if with_tree:
        try:
            from .schedtree import schedule_tree
            schedule_tree(sched)
        except Exception:
            pass                            # tree is an optimization only
    if not getattr(sched, "degraded", False):
        cache.put(key, sched)
    return sched


# ---------------------------------------------------------------------------
# autotuner persistence: (SCoP structure, search-space version) → winning
# kernel-specific configuration.  Reuses the same two-tier cache pool —
# entries are plain dicts, distinguished from Schedule pickles by key
# namespace.
# ---------------------------------------------------------------------------

def autotune_key(scop: Scop, space: Dict[str, Any]) -> str:
    """Digest for a tuned-config cache entry: the SCoP structure plus the
    autotuner's search-space descriptor (its version, cache-model spec
    and measurement settings — anything that can change the winner)."""
    payload = json.dumps(
        {"v": CACHE_VERSION, "kind": "autotune",
         "scop": scop_fingerprint(scop),
         "space": dict(sorted(space.items()))},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


def schedule_fingerprint(sched) -> str:
    """Structural digest of a *computed* schedule (rows, band structure,
    parallelism, fallback) — two configurations whose schedules hash
    equal generate identical code for identical tile choices.  The
    autotuner uses this to deduplicate enumerated configurations: on a
    single-SCC kernel ``max``/``no``/``smart`` fusion all collapse to
    one candidate instead of three."""
    rows = {}
    for idx, rr in sorted(sched.rows.items()):
        rows[str(idx)] = [
            [r.kind, sorted(("|".join(map(str, k)), str(v))
                            for k, v in r.coeffs.items() if v)]
            for r in rr
        ]
    payload = json.dumps(
        {"rows": rows, "bands": list(sched.bands),
         "parallel": list(sched.parallel), "fallback": bool(sched.fallback),
         # codegen-visible annotations beyond the rows: vectorized
         # iterators and explicit sequential marks
         "vec": sorted((str(k), int(v)) for k, v in sched.vector_iter.items()),
         "seq": sorted(map(list, sched.seq_marked))},
        sort_keys=True, separators=(",", ":"),
    )
    return hashlib.sha256(payload.encode()).hexdigest()


# ---------------------------------------------------------------------------
# measurement pool: every autotuner *measurement* is persisted as a
# (kernel, config, features, seconds) triple in an append-only JSONL
# file next to the pickle pool.  The learned static ranker
# (:mod:`repro_torch.core.ranker`) trains on these rows; like the rest of the
# cache, disk failures degrade silently to "no training data".
# ---------------------------------------------------------------------------

MEASUREMENTS_FILE = "measurements.jsonl"

#: size-triggered compaction threshold for the measurement pool — the
#: file is bounded at roughly this size plus one writer's batch
MEASUREMENTS_MAX_BYTES = 4 << 20


def _measurement_fingerprint(row) -> Optional[tuple]:
    """What makes two measurement rows 'the same point': one kernel ×
    candidate config under one search-space and feature version.
    Compaction keeps the newest row per fingerprint — a re-measurement
    supersedes its predecessor (machine state drifts; the ranker wants
    the current truth)."""
    try:
        return (str(row["kernel"]), str(row["label"]),
                row.get("v"), row.get("fv"))
    except (KeyError, TypeError):
        return None


@contextlib.contextmanager
def _pool_lock(cache_dir: str):
    """Advisory exclusive lock for the measurement pool, taken on a
    *sidecar* file (``measurements.jsonl.lock``) that is never
    replaced.  Locking the data file itself is unsound once compaction
    publishes via ``os.replace``: a waiter that finally acquires the
    flock holds the orphaned pre-replace inode, and anything it does
    there (append, rewrite) is silently lost or clobbers fresh
    appends.  The sidecar's inode is stable for the pool's lifetime,
    so one lock serializes appenders and compactors with no
    identity-re-check/retry dance.  Degrades to unlocked on platforms
    without ``fcntl`` (single ``write`` on O_APPEND still keeps
    individual batches atomic)."""
    f = open(os.path.join(cache_dir, MEASUREMENTS_FILE + ".lock"), "a")
    try:
        if fcntl is not None:
            try:
                fcntl.flock(f.fileno(), fcntl.LOCK_EX)
            except OSError:
                pass
        yield
    finally:
        f.close()                     # closing drops the flock


def compact_measurements(cache: ScheduleCache,
                         max_bytes: int = MEASUREMENTS_MAX_BYTES,
                         force: bool = False) -> bool:
    """Rewrite the pool keeping the newest row per fingerprint.

    No-op unless the file exceeds ``max_bytes`` (or ``force``).  The
    rewrite holds the pool's sidecar lock (see :func:`_pool_lock`),
    writes a temp file in the same directory, and publishes with
    ``os.replace`` — readers see the old file or the new one, never a
    partial state, and concurrent appenders (who take the same lock)
    land either before the rewrite (and are carried into it) or after
    it (into the fresh file); no append is ever stranded in the
    orphaned pre-compaction inode.  Rows whose fingerprint cannot be
    computed (foreign/corrupt) are preserved in order rather than
    dropped.  Returns True when a rewrite was published; disk trouble
    returns False and leaves the pool untouched."""
    if not cache.disk:
        return False
    path = os.path.join(cache.dir, MEASUREMENTS_FILE)
    try:
        fault_point("cache.write")
        with _pool_lock(cache.dir):
            with open(path, "a+") as f:
                size = os.fstat(f.fileno()).st_size
                if size <= max_bytes and not force:
                    return False
                f.seek(0)
                keep: Dict[Any, str] = {}
                extras = []           # unfingerprintable rows, in order
                for ln in f:
                    ln = ln.strip()
                    if not ln:
                        continue
                    try:
                        row = json.loads(ln)
                    except json.JSONDecodeError:
                        continue      # torn tail line from a dying writer
                    fp = _measurement_fingerprint(row)
                    if fp is None:
                        extras.append(ln)
                        continue
                    # del+reinsert keeps dict order = last-occurrence
                    # order, so the compacted file preserves the pool's
                    # recency ordering (load_measurements' tail window
                    # still sees the newest rows last)
                    keep.pop(fp, None)
                    keep[fp] = ln
            fd, tmp = tempfile.mkstemp(dir=cache.dir,
                                       prefix=".measurements-",
                                       suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as out:
                    for ln in extras:
                        out.write(ln + "\n")
                    for ln in keep.values():
                        out.write(ln + "\n")
                os.replace(tmp, path)
            except BaseException:
                try:
                    os.unlink(tmp)
                except OSError:
                    pass
                raise
        return True
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        return False


def record_measurements(cache: ScheduleCache, rows, *,
                        max_bytes: int = MEASUREMENTS_MAX_BYTES) -> None:
    """Append measurement triples (plain dicts) to the cache's pool.

    Safe under concurrent writers: batches append under the pool's
    sidecar lock (see :func:`_pool_lock`), which also serializes them
    against compaction's ``os.replace`` — a batch always lands in the
    live file, never the orphaned pre-compaction inode.  One ``write``
    call per batch on an O_APPEND descriptor additionally keeps lines
    atomic on POSIX even where ``flock`` is unavailable.  When the
    appended pool crosses ``max_bytes``, :func:`compact_measurements`
    bounds it (newest row per fingerprint).  Disk failures degrade to
    "rows not recorded" — the search result is unaffected."""
    if not rows or not cache.disk:
        return
    try:
        fault_point("cache.write")
        os.makedirs(cache.dir, exist_ok=True)
        blob = "".join(json.dumps(r, sort_keys=True) + "\n" for r in rows)
        path = os.path.join(cache.dir, MEASUREMENTS_FILE)
        with _pool_lock(cache.dir):
            with open(path, "a") as f:
                f.write(blob)
                f.flush()
                size = os.fstat(f.fileno()).st_size
        if size > max_bytes:
            compact_measurements(cache, max_bytes=max_bytes)
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        pass


def load_measurements(cache: ScheduleCache, space_version: Optional[int] = None,
                      limit: int = 20000,
                      tail_bytes: int = 8 << 20) -> list:
    """Recent persisted measurement rows (most recent ``limit``),
    optionally filtered to one search-space version.  The pool is
    append-only and sits on the compile hot path, so only the last
    ``tail_bytes`` of the file are read and parsed — an unboundedly
    grown pool costs a bounded seek+read, not an O(file) parse.
    Returns [] on any disk trouble."""
    if not cache.disk:
        return []
    out = []
    try:
        fault_point("cache.read")
        with open(os.path.join(cache.dir, MEASUREMENTS_FILE), "rb") as f:
            f.seek(0, os.SEEK_END)
            size = f.tell()
            start = max(0, size - tail_bytes)
            f.seek(start)
            blob = f.read().decode("utf-8", errors="replace")
        lines = blob.splitlines()
        if start > 0 and lines:
            lines = lines[1:]         # drop the partial first line
        for ln in lines:
            ln = ln.strip()
            if not ln:
                continue
            try:
                row = json.loads(ln)
            except json.JSONDecodeError:
                continue              # torn tail line from a dying writer
            if space_version is not None and row.get("v") != space_version:
                continue
            out.append(row)
    except Exception:
        return []
    return out[-limit:]
