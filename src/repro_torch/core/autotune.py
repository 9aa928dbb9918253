"""Kernel-specific configuration search, the measurement-free half
(paper §III-E / §IV-B "kernel-specific").

The paper's headline numbers come from *kernel-specific
configurations* — per-kernel choices of cost functions, fusion,
vectorization and tiling.  This module enumerates that space and ranks
it statically:

1. **Configuration enumeration** — candidate ``SchedulerConfig``s are
   composed from the scheduling strategy (``pluto``/``tensor``/
   ``bigloops``/``feautrier`` — isl-style is excluded: its dynamic
   Python callback makes schedules uncacheable, see schedcache), the
   fusion mode (``smart``/``max``/``no`` plus explicit SCC-derived
   :class:`~repro_torch.core.config.FusionSpec` statement groups) and
   the per-dimension cost-function mixes
   (:data:`repro_torch.core.costs.COST_MIXES`), with tile/wavefront
   variants pruned by schedule structure.  Base schedules come through
   the structural schedule cache and are **deduplicated** by
   :func:`repro_torch.core.schedcache.schedule_fingerprint`.
2. **Static ranking** — the analytic access-stride cost model
   (:func:`static_cost`).
3. **Kernel-plan lowering** — :func:`rank_pallas_plans` lowers the
   best-ranked schedule trees to
   :class:`~repro_torch.core.akg.KernelPlan`\\ s for the kernels in
   ``csrc/`` (the fused scan+gate planner picks its plan this way).  The
   name is the reference's, whose plans feed Pallas kernels.

The reference package also measures the top candidates as compiled C
(its ``autotune()``, with a C backend and a learned ranker); that half is
not part of the port.

Everything is deterministic: candidate order is fixed and ranking
tie-breaks on candidate index.
"""
from __future__ import annotations

from dataclasses import dataclass, replace
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple, Union

from . import config as CFG
from . import costs as C
from .resilience import Deadline, DeadlineExceeded
from .cachemodel import (CacheSpec, default_spec, shared_bands,
                         shared_groups, shared_scan, shared_tile_sizes,
                         working_set_bytes)
from .schedtree import (iterator_substitution, level_parallel,
                        schedule_tree, yvar as _yvar)
from .postproc import find_tilable_bands
from .schedcache import (ScheduleCache, cached_schedule_scop, global_cache,
                         schedule_fingerprint)
from .scheduler import Schedule, _scc_groups
from .scop import Scop

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

    def scheduler_config(self) -> CFG.SchedulerConfig:
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
