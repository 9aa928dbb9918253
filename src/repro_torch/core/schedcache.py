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
  (tmp+rename).  The ``cache.read``/``cache.write`` fault sites let
  tests inject disk failures deterministically.

Cached ``Schedule`` objects carry their own ``Scop``/dependence objects;
per-dependence compiled-LP state is stripped on pickling (see
``Dependence.__getstate__``), so entries stay compact.
"""
from __future__ import annotations

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
    (the ScheduleCache memory tier's FIFO cap, or a plan memo's).
    Indexable like a dict (``stats["hits"]``).
    """
    hits: int = 0
    misses: int = 0
    disk_hits: int = 0
    corrupt: int = 0
    evicted: int = 0

    def __getitem__(self, k: str):
        return getattr(self, k)

    def __setitem__(self, k: str, v) -> None:
        setattr(self, k, v)

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)


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
# schedule fingerprints (the autotuner's deduplication)
# ---------------------------------------------------------------------------

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
