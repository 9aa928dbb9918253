"""Kernel-specific autotuning (paper §III-E / §IV-B "kernel-specific").

The paper's headline PolyBench numbers come from *kernel-specific
configurations* — per-kernel choices of cost functions, fusion,
vectorization and tiling.  This module searches that full §III-E space:

1. **Configuration enumeration** — candidate ``SchedulerConfig``s are
   composed from four axes:

   * scheduling strategy (``pluto``/``tensor``/``bigloops``/``feautrier``
     — isl-style is excluded: its dynamic Python callback makes
     schedules uncacheable, see schedcache);
   * **fusion**: ``smart``/``max``/``no`` modes plus explicit
     SCC-derived :class:`~repro_torch.core.config.FusionSpec` statement groups
     (adjacent SCCs of the dependence graph merged pairwise — points
     *between* the extremes);
   * **per-dimension cost-function mixes**
     (:data:`repro_torch.core.costs.COST_MIXES`): contiguity/proximity stride
     orderings, big-loops-first outer dims, and a static isl-style
     require-parallel variant — threaded into the per-dim ILP objective
     construction by the scheduler;
   * tile source (none / cache-model L1 / cache-model L2 / fixed 32) ×
     wavefront × auto-vectorization, pruned by schedule structure.

   Base schedules come through the structural schedule cache and are
   **deduplicated** by :func:`repro_torch.core.schedcache.schedule_fingerprint`
   — on a single-SCC kernel the fusion modes all collapse to one
   candidate instead of three.
2. **Static ranking** — the analytic access-stride cost model below
   (:func:`static_cost`), replaced by a *learned* ridge ranker (:mod:`repro_torch.core.ranker`) once
   enough measured (kernel, config, time) triples have accumulated in
   the cache pool.  Ranking prunes the enumeration to a measurable
   ``top_k``.
3. **Measurement** — the ``top_k`` ranked candidates are compiled and
   timed through :mod:`repro_torch.core.crunner`; each must checksum-match the
   original-program-order reference or it is discarded.  Every valid
   measurement is persisted as a training triple
   (:func:`repro_torch.core.schedcache.record_measurements`).
4. **Persistence** — the winner is stored in the schedule-cache pool
   keyed by SCoP structure + search-space version
   (:func:`repro_torch.core.schedcache.autotune_key`), so the second compile
   of the same kernel shape is a dictionary/disk lookup — winner
   replay, no re-enumeration.
5. **Kernel-plan lowering** — :func:`rank_pallas_plans` lowers the
   best-ranked schedule trees to
   :class:`~repro_torch.core.akg.KernelPlan`\\ s for the kernels in
   ``csrc/`` (the fused scan+gate planner picks its plan this way).  The
   name is the reference's, whose plans feed Pallas kernels.

Measured times are host CPU times of gcc-built C
(:mod:`repro_torch.core.crunner`), as in the reference package; the card
takes no part in them.

Everything is deterministic: candidate order is fixed, ranking
tie-breaks on candidate index, and measurements go through crunner's
on-disk result cache, so re-tuning the same kernel against the same
measurement pool returns the same configuration.
"""
from __future__ import annotations

import time
from dataclasses import asdict, dataclass, field, replace
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import config as CFG
from . import costs as C
from .resilience import Deadline, DeadlineExceeded, MeasurementError
from .cachemodel import (CacheSpec, default_spec, shared_bands,
                         shared_groups, shared_scan, shared_tile_sizes,
                         working_set_bytes)
from .schedtree import (iterator_substitution, level_parallel,
                        schedule_tree, yvar as _yvar)
from .postproc import find_tilable_bands, tile_schedule
from .schedcache import (ScheduleCache, autotune_key, cached_schedule_scop,
                         global_cache, load_measurements,
                         record_measurements, schedule_fingerprint)
from .scheduler import PolyTOPSScheduler, Schedule, _scc_groups
from .scop import Scop

SPACE_VERSION = 2          # bump when the candidate space / model changes

#: strategies the autotuner explores (isl-style is excluded: its dynamic
#: Python callback makes schedules uncacheable — see schedcache)
TUNE_STRATEGIES = ("pluto", "tensor", "bigloops", "feautrier")
TILED_STRATEGIES = ("pluto", "tensor")
#: strategies the fusion axis is enumerated on
FUSION_STRATEGIES = ("pluto", "tensor")
#: strategies the cost-mix axis is enumerated on (mixes replace the
#: per-dim ILP recipe, so they only compose with the plain-proximity base)
MIX_STRATEGIES = ("pluto",)
#: cap on explicit SCC-derived statement-group variants per kernel
MAX_GROUP_VARIANTS = 2


@dataclass(frozen=True)
class TunedConfig:
    """One point of the kernel-specific search space."""
    strategy: str                       # key into config.STRATEGIES
    tile: Optional[Union[int, str]] = None   # None | int | 'l1' | 'l2'
    wavefront: bool = False
    autovec: bool = False
    fusion: str = "smart"               # 'smart' | 'max' | 'no' | 'groups'
    #: explicit statement groups (fusion == 'groups'), outermost dim
    fusion_groups: Optional[Tuple[Tuple[int, ...], ...]] = None
    mix: Optional[str] = None           # key into costs.COST_MIXES

    @property
    def label(self) -> str:
        bits = [self.strategy]
        if self.mix:
            bits.append(f"mix{self.mix}")
        if self.fusion == "groups" and self.fusion_groups:
            bits.append("fg" + "-".join(
                "".join(str(i) for i in g) for g in self.fusion_groups))
        elif self.fusion != "smart":
            bits.append(f"f{self.fusion}")
        if self.autovec:
            bits.append("autovec")
        if self.tile is not None:
            bits.append(f"tile{self.tile}")
        if self.wavefront:
            bits.append("wave")
        return "+".join(bits)

    @property
    def base(self) -> "TunedConfig":
        """The schedule-determining part (tile/wavefront are
        post-processing and share the base schedule)."""
        return replace(self, tile=None, wavefront=False)

    @property
    def uses_new_axes(self) -> bool:
        """True when the winning choice exercises the fusion or cost-mix
        axis (the §III-E space beyond strategy×tile×wavefront)."""
        return self.fusion != "smart" or self.mix is not None

    def scheduler_config(self) -> CFG.SchedulerConfig:
        if self.strategy == "original":    # untransformed program order
            return CFG.SchedulerConfig()
        cfg = CFG.STRATEGIES[self.strategy]()
        if self.autovec:
            cfg.auto_vectorize = True
        if self.fusion in ("max", "no"):
            cfg.fusion_mode = self.fusion
        elif self.fusion == "groups" and self.fusion_groups:
            cfg.fusion = [CFG.FusionSpec(
                0, groups=[list(g) for g in self.fusion_groups])]
        if self.mix:
            base_cons = list(cfg.ilp.get("default", CFG.DimConfig()).constraints)
            cfg.ilp = {
                dim: CFG.DimConfig(list(cfs), list(base_cons), rp)
                for dim, (cfs, rp) in C.COST_MIXES[self.mix].items()
            }
            cfg.name = f"{cfg.name}+mix{self.mix}"
        return cfg

    @classmethod
    def from_dict(cls, d: dict) -> "TunedConfig":
        d = dict(d)
        fg = d.get("fusion_groups")
        if fg is not None:
            d["fusion_groups"] = tuple(tuple(int(i) for i in g) for g in fg)
        return cls(**d)


@dataclass
class TunedResult:
    config: TunedConfig
    static_cost: float = 0.0
    seconds: Optional[float] = None
    checksum: Optional[float] = None
    source: str = "static"              # 'static' | 'measured' | 'cache'
    ranked: List[str] = field(default_factory=list)   # candidate labels, best-first
    ranker: str = "analytic"            # 'analytic' | 'learned'
    #: True when the search itself was compromised (deadline truncation,
    #: reference-measurement failure) — the winner may not be the true
    #: optimum and is never persisted.  Individual candidate failures
    #: alone do not degrade the result: the surviving winner is still a
    #: fully validated measurement.
    degraded: bool = False
    reasons: List[str] = field(default_factory=list)
    #: MeasurementError rows (kind/tag/phase/detail) of every failed
    #: compile-and-measure attempt, including retries and checksum
    #: mismatches — the search's failure log, not an error state
    failures: List[dict] = field(default_factory=list)

    def to_dict(self) -> dict:
        d = asdict(self)
        d["config"] = asdict(self.config)
        return d

    @classmethod
    def from_dict(cls, d: dict) -> "TunedResult":
        cfg = TunedConfig.from_dict(d["config"])
        return cls(cfg, d.get("static_cost", 0.0), d.get("seconds"),
                   d.get("checksum"), "cache", list(d.get("ranked", [])),
                   d.get("ranker", "analytic"),
                   bool(d.get("degraded", False)),
                   list(d.get("reasons", [])),
                   list(d.get("failures", [])))


# ---------------------------------------------------------------------------
# configuration enumeration
# ---------------------------------------------------------------------------


def scc_group_variants(scop: Scop, deps=None) -> List[Tuple[Tuple[int, ...], ...]]:
    """Explicit FusionSpec statement groups derived from the SCC
    condensation of the dependence graph: adjacent SCCs (in topological
    order) merged pairwise — legal by construction, and points *between*
    total distribution and maximal fusion.  Bounded and deterministic."""
    stmts = scop.statements
    if len(stmts) < 3:
        return []           # with ≤2 statements 'max'/'no' already cover this
    if deps is None:
        from .deps import compute_dependences
        deps = compute_dependences(scop)
    for d in deps:
        d.satisfied_at = None
    sccs = _scc_groups(stmts, deps)
    if not 2 <= len(sccs) <= 6:
        return []
    out: List[Tuple[Tuple[int, ...], ...]] = []
    for i in range(min(len(sccs) - 1, MAX_GROUP_VARIANTS)):
        groups = (sccs[:i] + [sorted(sccs[i] + sccs[i + 1])] + sccs[i + 2:])
        if len(groups) < 2:
            continue     # all statements in one group ≡ 'max', already enumerated
        out.append(tuple(tuple(g) for g in groups))
    return out


def base_configs(scop: Scop, deps=None) -> List[TunedConfig]:
    """Schedule-determining configuration bases: strategy × fusion ×
    cost-mix (+ tensor autovec).  Deterministic order; tile/wavefront
    variants are layered on later by :func:`candidate_space`."""
    out: List[TunedConfig] = [TunedConfig(s) for s in TUNE_STRATEGIES]
    out.append(TunedConfig("tensor", autovec=True))
    if len(scop.statements) > 1:
        for strat in FUSION_STRATEGIES:
            for fm in ("max", "no"):
                out.append(TunedConfig(strat, fusion=fm))
        for groups in scc_group_variants(scop, deps):
            out.append(TunedConfig("pluto", fusion="groups",
                                   fusion_groups=groups))
    for strat in MIX_STRATEGIES:
        for mix in sorted(C.COST_MIXES):
            out.append(TunedConfig(strat, mix=mix))
    return out


def _schedules_for_space(scop: Scop, cache: ScheduleCache,
                         bases: Optional[Sequence[TunedConfig]] = None,
                         deadline: Optional[Deadline] = None,
                         reasons: Optional[List[str]] = None
                         ) -> Dict[TunedConfig, Schedule]:
    """One schedule per configuration base — structural-cache lookups
    after the first tuning of a kernel shape.  Each miss computes its
    own dependences so cached Schedule objects never share mutable
    dependence state across candidates.  Bases whose configuration
    cannot schedule (an illegal fusion spec, an infeasible
    require-parallel demand) are dropped — any *other* exception is a
    real defect in the enumerated space and propagates loudly instead
    of silently shrinking the search.

    A ``deadline`` breach (checked at each base boundary and inside the
    scheduler's dimension loop) *truncates* enumeration rather than
    raising: the bases already scheduled stay usable, and the truncation
    is appended to ``reasons`` so the caller can mark its result
    degraded."""
    from .scheduler import SchedulingError

    if bases is None:
        bases = base_configs(scop)
    scheds: Dict[TunedConfig, Schedule] = {}
    for base in bases:
        if deadline is not None and deadline.expired():
            if reasons is not None:
                reasons.append(
                    f"enumeration truncated at {base.label!r}: deadline "
                    f"({deadline.elapsed():.3f}s > {deadline.budget_s:.3f}s)")
            break
        try:
            scheds[base] = cached_schedule_scop(
                scop, base.scheduler_config(), cache=cache,
                deadline=deadline)
        except SchedulingError:
            continue
        except DeadlineExceeded as e:
            if reasons is not None:
                reasons.append(f"enumeration truncated at {base.label!r}: {e}")
            break
    return scheds


def candidate_space(scop: Scop, scheds: Dict[TunedConfig, Schedule]
                    ) -> List[TunedConfig]:
    """The bounded, deterministic search space: every *structurally
    distinct* base schedule (fingerprint-deduplicated, first base wins)
    plus its tile/wavefront variants where the schedule shape admits
    them."""
    out: List[TunedConfig] = []
    seen: Dict[str, TunedConfig] = {}
    for base, sched in scheds.items():
        fp = schedule_fingerprint(sched)
        if fp in seen:
            continue
        seen[fp] = base
        out.append(base)
        if base.strategy not in TILED_STRATEGIES:
            continue
        bands = find_tilable_bands(sched)
        if not bands:
            continue
        out.append(replace(base, tile="l1"))
        out.append(replace(base, tile="l2"))
        out.append(replace(base, tile=32))
        if any(b.length >= 2 and not b.parallel_first for b in bands):
            # pipelined-parallel shape: wavefront variants
            out.append(replace(base, tile="l2", wavefront=True))
            out.append(replace(base, tile=32, wavefront=True))
    return out


# ---------------------------------------------------------------------------
# static cost model
# ---------------------------------------------------------------------------

# relative per-iteration access costs (arbitrary units ~ cache-line moves)
_COST_INVARIANT = 0.05     # register / L1-resident scalar
_COST_CONTIG = 0.125       # stride-1: one line per line_elems iterations
_COST_STRIDED = 1.0        # one line per iteration
_SIMD_FACTOR = 0.55        # innermost simd-legal all-contiguous loop
_REUSE_FACTOR = 0.35       # temporal reuse captured in-cache
_WAVE_PENALTY = 1.08       # wavefront bound overhead (single-core container)


def _stmt_trip(scop: Scop, stmt) -> float:
    """Box-volume iteration estimate with concrete parameter values.
    Identical across candidate schedules of the same SCoP, so it only
    weights statements against each other."""
    from .cachemodel import stmt_iter_ranges

    trip = 1.0
    for rng in stmt_iter_ranges(scop, stmt).values():
        if rng is None:
            trip *= 100.0
        else:
            trip *= max(1.0, float(rng[1] - rng[0]) + 1.0)
    return trip


def static_cost(scop: Scop, sched: Schedule, tc: TunedConfig,
                spec: Optional[CacheSpec] = None,
                trips: Optional[Dict[int, float]] = None,
                memo: Optional[dict] = None) -> float:
    """Estimated relative runtime of ``tc`` applied to ``sched``.

    ``trips`` (statement index → box-volume iteration estimate) is
    SCoP-invariant and ``memo`` caches the per-(schedule, tile-source)
    intermediates (scan, bands, access groups, cache-model tile sizes):
    candidates share 1-2 schedules, so callers scoring the whole space
    pass both to avoid recomputing LP extents per candidate."""
    spec = spec or default_spec()
    if trips is None:
        trips = {s.index: _stmt_trip(scop, s) for s in scop.statements}
    memo = {} if memo is None else memo
    sid = id(sched)
    scan = shared_scan(sched, memo)
    bands = shared_bands(sched, memo) if tc.tile is not None else []
    tiled_ws_ok: Dict[int, bool] = {}
    if tc.tile is not None and bands:
        wskey = ("wsok", sid, str(tc.tile))
        if wskey not in memo:
            sizes_by_band = shared_tile_sizes(sched, memo, tc.tile, spec)
            ok: Dict[int, bool] = {}
            for b in bands:
                groups = shared_groups(sched, memo, b.start, b.length)
                ws = working_set_bytes(groups, sizes_by_band.get(
                    b.start, [32] * b.length), spec.elem_bytes)
                ok[b.start] = ws <= spec.l2_bytes
            memo[wskey] = ok
        tiled_ws_ok = memo[wskey]
    total = 0.0
    for ss in scan:
        stmt = ss.stmt
        try:
            subst = iterator_substitution(ss)
        except ValueError:
            total += trips[stmt.index] * _COST_STRIDED * len(stmt.accesses)
            continue
        # innermost linear scan dim
        inner = None
        for d in range(ss.n_dims() - 1, -1, -1):
            phi = ss.dims[d].phi
            if any(it in stmt.iters for it in phi):
                inner = d
                break
        if inner is None:
            continue

        def coeff(e, d):
            c = Fraction(0)
            for it, v in e.items():
                if it in subst:
                    c += v * subst[it].get(_yvar(d), Fraction(0))
            return c

        cost = 0.0
        all_vec_friendly = True
        for acc in stmt.accesses:
            cs = [coeff(e, inner) for e in acc.subscripts]
            moves_inner = any(c != 0 for c in cs)
            contiguous = (
                moves_inner and abs(cs[-1]) == 1
                and all(c == 0 for c in cs[:-1])
            )
            if not moves_inner:
                a = _COST_INVARIANT
            elif contiguous:
                a = _COST_CONTIG
            else:
                a = _COST_STRIDED
                all_vec_friendly = False
            # temporal reuse along a non-innermost band dim: captured when
            # a tile working set fits the budget
            if tc.tile is not None and a >= _COST_CONTIG:
                for b in bands:
                    if not tiled_ws_ok.get(b.start):
                        continue
                    dims_in_b = [d for d in range(b.start, b.start + b.length)
                                 if d != inner]
                    if any(all(coeff(e, d) == 0 for e in acc.subscripts)
                           for d in dims_in_b):
                        a *= _REUSE_FACTOR
                        break
            cost += a
        if all_vec_friendly and level_parallel(sched, [ss], inner):
            cost *= _SIMD_FACTOR
        total += trips[stmt.index] * max(cost, 1e-3)
    if tc.wavefront:
        total *= _WAVE_PENALTY
    return total


# ---------------------------------------------------------------------------
# source building + measurement
# ---------------------------------------------------------------------------


def build_source(scop: Scop, tc: TunedConfig, sched: Schedule,
                 scalars: Optional[Dict[str, float]] = None,
                 repeats: int = 1) -> str:
    from .cbackend import CCodeGenerator

    scan = (tile_schedule(sched, tc.tile, wavefront=tc.wavefront)
            if tc.tile is not None else None)
    return CCodeGenerator(sched, scan=scan, scalars=scalars,
                          repeats=repeats).generate()


def _ref_source(scop: Scop, scalars) -> str:
    """C source of the untransformed program order — the correctness
    anchor every measured candidate must checksum-match."""
    from .cbackend import CCodeGenerator

    sched = PolyTOPSScheduler(scop, CFG.SchedulerConfig())._fallback_original()
    return CCodeGenerator(sched, scalars=scalars).generate()


def _original_reference(scop: Scop, scalars, use_cache: bool):
    """Measured reference checksum/seconds (no retry policy — callers
    needing record/retry/exclude go through autotune's loop)."""
    from .crunner import measure_source

    return measure_source(_ref_source(scop, scalars),
                          tag=f"tune_{scop.name}_orig", use_cache=use_cache)


# ---------------------------------------------------------------------------
# the tuner
# ---------------------------------------------------------------------------


#: backoff before the single retry of a failed measurement — long
#: enough to ride out a transient (a scheduler blip, an injected
#: one-shot fault), short enough not to dominate the search
RETRY_BACKOFF_S = 0.05


def autotune(scop: Scop, *, scalars: Optional[Dict[str, float]] = None,
             measure: bool = True, top_k: int = 8,
             cache: Optional[ScheduleCache] = None, use_cache: bool = True,
             spec: Optional[CacheSpec] = None,
             checksum_rel: float = 1e-6,
             deadline: Optional[Deadline] = None) -> TunedResult:
    """Pick a kernel-specific configuration for ``scop``.

    With ``measure=True`` the ``top_k`` statically-ranked candidates are
    compiled and timed (crunner's result cache makes repeats free); with
    ``measure=False`` the static ranking alone decides.  Winners persist
    in the schedule-cache pool — the second call for the same kernel
    shape returns the tuned config without scheduling or compiling
    anything (``result.source == 'cache'``).

    Failure policy: a candidate whose compile-and-measure attempt dies
    with a typed :class:`~repro_torch.core.resilience.MeasurementError`
    (source blowup, gcc timeout/failure, crashing or hanging binary,
    parse error) is recorded in ``result.failures``, retried once after
    a short backoff, then excluded; checksum mismatches are recorded
    the same way and excluded without retry (a wrong answer is
    deterministic, not transient).  The search never raises for a
    candidate failure — it returns the best *surviving* measured
    candidate, or the analytic winner when nothing could be measured.
    A ``deadline`` is checked at every enumeration and candidate
    boundary; a breach truncates the search with best-so-far and marks
    the result ``degraded`` (degraded winners are never persisted).
    """
    spec = spec or default_spec()
    cache = cache or global_cache()
    scalars = {k: v for k, v in (scalars or {}).items() if k in scop.scalars}
    for sc in scop.scalars:
        scalars.setdefault(sc, 1.0)     # match the oracle's default
    from .crunner import CFLAGS, compiler_version

    space_desc = {
        "version": SPACE_VERSION,
        "strategies": list(TUNE_STRATEGIES),
        "fusion": list(FUSION_STRATEGIES),
        "mixes": sorted(C.COST_MIXES),
        "measure": bool(measure),
        "top_k": int(top_k),
        "analytic_guard": max(3, int(top_k) // 2),
        "measure_bases": True,
        "l1": spec.l1_bytes, "l2": spec.l2_bytes,
        "elem": spec.elem_bytes,
        "scalars": sorted(scalars.items()),
        "checksum_rel": checksum_rel,
        # winners were measured under a specific toolchain: a compiler
        # upgrade or flag change invalidates them, same as crunner's
        # result cache
        "cflags": list(CFLAGS),
        "gcc": compiler_version(),
    }
    key = autotune_key(scop, space_desc) if use_cache else None
    hit = cache.get(key)
    if isinstance(hit, dict) and "config" in hit:
        # winner replay: no enumeration, no scheduling, no compilation
        return TunedResult.from_dict(hit)

    # use_cache=False must mean *no* caching anywhere: candidate
    # schedules go through a throwaway in-memory cache, not the shared
    # pool (else POLYTOPS_NO_CACHE runs would serve stale schedules)
    sched_cache = cache if use_cache else ScheduleCache(disk=False)
    reasons: List[str] = []
    failures: List[dict] = []
    scheds = _schedules_for_space(scop, sched_cache, deadline=deadline,
                                  reasons=reasons)
    cands = candidate_space(scop, scheds)
    if not cands:
        return TunedResult(TunedConfig("pluto"), source="static",
                           degraded=bool(reasons), reasons=reasons)
    trips = {s.index: _stmt_trip(scop, s) for s in scop.statements}
    memo: dict = {}

    # the learned ranker replaces the analytic ordering once the pool
    # holds enough measured triples of the current search space; the
    # analytic cost stays as a feature (and as the fallback)
    from . import ranker as RK
    model = RK.fit_ranker(load_measurements(cache, SPACE_VERSION)
                          if use_cache else [])
    feats_by_label: Dict[str, List[float]] = {}
    scored: List[Tuple[float, int, TunedConfig, float]] = []
    for i, tc in enumerate(cands):
        sched = scheds[tc.base]
        cost = static_cost(scop, sched, tc, spec, trips, memo)
        feats = RK.features(scop, sched, tc, cost, spec, trips, memo)
        feats_by_label[tc.label] = feats
        score = model.predict(feats) if model is not None else cost
        scored.append((score, i, tc, cost))
    scored.sort(key=lambda t: (t[0], t[1]))
    ranked_labels = [tc.label for _, _, tc, _ in scored]
    ranker_name = "learned" if model is not None else "analytic"

    # measured set: the primary ranking's top_k, plus the analytic
    # prior's top picks whenever the learned model decided the order —
    # a cold-start guard: a ridge model fitted on a few kernels can
    # misrank an unseen kernel and silently drop the true winner from
    # the measured set, which the prior's picks cap at a bounded cost
    measured_set: List[Tuple[float, int, TunedConfig, float]] = list(scored[:top_k])
    have = {t[2] for t in measured_set}
    if model is not None:
        by_analytic = sorted(scored, key=lambda t: (t[3], t[1]))
        for t in by_analytic[:max(3, top_k // 2)]:
            if t[2] not in have:
                measured_set.append(t)
                have.add(t[2])
    # every structurally distinct *base* schedule is measured at least
    # once: the strategy/fusion/mix axes change the loop structure, which
    # is exactly where both rankers are least reliable, and the base
    # count is already fingerprint-deduplicated and small.  Ranking
    # prunes only the tile/wavefront fan-out.
    for t in scored:
        if t[2].tile is None and not t[2].wavefront and t[2] not in have:
            measured_set.append(t)
            have.add(t[2])

    best: Optional[TunedResult] = None
    ref = None
    if measure:
        from .crunner import checksums_match, measure_source

        def _measure_once(make_src, tag: str):
            """One compile-and-measure attempt with the shared failure
            policy: a typed MeasurementError is recorded and retried
            once after a backoff; a second failure (or any untyped
            codegen exception) excludes the candidate (returns None)."""
            for attempt in (1, 2):
                try:
                    return measure_source(make_src(), tag=tag,
                                          use_cache=use_cache)
                except MeasurementError as e:
                    failures.append(dict(e.row(), attempt=attempt))
                    if attempt == 1:
                        time.sleep(RETRY_BACKOFF_S)
                except (KeyboardInterrupt, SystemExit):
                    raise
                except Exception as e:   # untyped codegen defect: exclude,
                    failures.append({    # no retry (it is deterministic)
                        "kind": "codegen_error", "tag": tag,
                        "phase": "codegen",
                        "detail": f"{type(e).__name__}: {e}"[:200],
                        "attempt": attempt})
                    return None
            return None

        ref = _measure_once(
            lambda: _ref_source(scop, scalars),
            f"tune_{scop.name}_orig")
        if ref is None:
            reasons.append("reference measurement failed twice: "
                           "no checksum oracle, falling back to static "
                           "ranking")
        triples: List[dict] = []
        for _, _, tc, cost in (measured_set if ref is not None else []):
            if deadline is not None and deadline.expired():
                reasons.append(
                    f"measurement truncated at {tc.label!r}: deadline "
                    f"({deadline.elapsed():.3f}s > {deadline.budget_s:.3f}s)")
                break
            sched = scheds[tc.base]
            r = _measure_once(
                lambda tc=tc, sched=sched:
                    build_source(scop, tc, sched, scalars),
                f"tune_{scop.name}_{tc.label}")
            if r is None:
                continue                 # recorded + retried above: exclude
            if not checksums_match(r.checksum, ref.checksum, checksum_rel):
                # wrong answer: deterministic, so no retry — record the
                # mismatch as a typed failure row and discard
                failures.append(MeasurementError(
                    "checksum_mismatch", tag=f"tune_{scop.name}_{tc.label}",
                    phase="validate",
                    detail=f"got {r.checksum!r}, want {ref.checksum!r}"
                ).row())
                continue
            triples.append({
                "kernel": scop.name, "label": tc.label,
                "feats": feats_by_label[tc.label], "seconds": r.seconds,
                "v": SPACE_VERSION, "fv": RK.FEATURE_VERSION,
            })
            if best is None or r.seconds < best.seconds:
                best = TunedResult(tc, cost, r.seconds, r.checksum,
                                   "measured", ranked_labels, ranker_name)
        if use_cache:
            record_measurements(cache, triples)
        if best is None and ref is not None:
            # every measured candidate was rejected (compile failure or
            # wrong checksum): return the original program order — the
            # reference we just measured and know is correct — and do
            # NOT persist; caching a config we just saw fail (or never
            # validated) would poison every future compile of this
            # kernel shape
            return TunedResult(TunedConfig("original"), seconds=ref.seconds,
                               checksum=ref.checksum, source="measured",
                               ranked=ranked_labels, ranker=ranker_name,
                               degraded=bool(reasons), reasons=reasons,
                               failures=failures)
    if best is None:
        _, _, tc, cost = scored[0]
        best = TunedResult(tc, cost, source="static", ranked=ranked_labels,
                           ranker=ranker_name)
    best.degraded = bool(reasons)
    best.reasons = reasons
    best.failures = failures
    if measure and best.source == "measured" and not best.degraded \
            and key is not None:
        # only clean *measured* winners persist: a static winner can
        # depend on the learned ranker's pool state, which the
        # pool-independent autotune_key cannot encode, and a degraded
        # winner reflects a truncated search — replaying either would
        # serve a stale or unlucky answer to every future compile of
        # this kernel shape
        cache.put(key, best.to_dict())
    return best


# ---------------------------------------------------------------------------
# backend-aware candidate lowering: the enumerated configuration space,
# ranked by the static model, lowered to KernelPlans through the schedule
# tree — so the autotuner ranks the card's kernel plans.
# ---------------------------------------------------------------------------


@dataclass
class PallasCandidate:
    """One kernel-plan lowering: a scheduler configuration, its schedule
    tree lowered to a :class:`~repro_torch.core.akg.KernelPlan`, and the
    analytic cost that ranked it."""
    config: TunedConfig
    plan: object                       # repro_torch.core.akg.KernelPlan
    static_cost: float


def rank_pallas_plans(scop: Scop, *, top_k: int = 4,
                      cache: Optional[ScheduleCache] = None,
                      use_cache: bool = True,
                      spec: Optional[CacheSpec] = None,
                      deadline: Optional[Deadline] = None
                      ) -> List[PallasCandidate]:
    """Enumerate the schedule-determining bases (strategy × fusion ×
    cost mix, fingerprint-deduplicated like :func:`autotune`), rank them
    with the static cost model, and lower the best trees to
    :class:`~repro_torch.core.akg.KernelPlan`\\ s, best-first.

    Tile/wavefront variants are deliberately excluded: tile fitting is
    the lowering's job (shared-memory budget and edge snapping), not a
    search axis.  Deterministic: candidate order, ranking
    tie-breaks and the lowering are all pure functions of the SCoP."""
    from .akg import lower_to_kernel_plan

    spec = spec or default_spec()
    cache = cache or global_cache()
    sched_cache = cache if use_cache else ScheduleCache(disk=False)
    scheds = _schedules_for_space(scop, sched_cache, deadline=deadline)
    bases = [tc for tc in candidate_space(scop, scheds)
             if tc.tile is None and not tc.wavefront]
    trips = {s.index: _stmt_trip(scop, s) for s in scop.statements}
    memo: dict = {}
    scored = sorted(
        ((static_cost(scop, scheds[tc.base], tc, spec, trips, memo), i, tc)
         for i, tc in enumerate(bases)),
        key=lambda t: (t[0], t[1]))
    out: List[PallasCandidate] = []
    for cost, _, tc in scored:
        if len(out) >= top_k:
            break
        if deadline is not None and deadline.expired():
            break          # best-so-far: the list is already best-first
        sched = scheds[tc.base]
        try:
            plan = lower_to_kernel_plan(schedule_tree(sched), sched=sched)
        except ValueError:
            continue       # non-invertible/unbounded schedule: not lowerable
        out.append(PallasCandidate(tc, plan, cost))
    return out
