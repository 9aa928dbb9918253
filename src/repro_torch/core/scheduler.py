"""The PolyTOPS iterative scheduler — paper Algorithm 1.

Finds Θ dimension by dimension (outermost → innermost). Each dimension
is either a *scalar* dimension (loop distribution: constant per
statement, from the fusion configuration / SCC fallback) or a *linear*
dimension solved as an ILP:

  validity  (Eq. 2, Farkas-linearized)     — always
  progression (Eq. 3, orthogonal complement) — always
  cost stages (config: proximity/feautrier/contiguity/BLF/custom vars)
  custom constraints + directives (dropped if they break legality)

Band bookkeeping matches Pluto: all dependences not strongly satisfied
before the current band are weakly enforced (φ_R − φ_S ≥ 0) at every
dimension of the band, which makes bands fully permutable (→ tilable in
post-processing). On ILP failure the band is cut (satisfied dependences
removed) and the dimension retried; if that fails too, statements are
distributed by SCCs; if a single SCC remains, the scheduler falls back
to the original program order (paper §IV-B: nussinov/adi/deriche
behaviour without negative coefficients).

Incremental architecture (compile-time hot path)
------------------------------------------------

Scheduling runs per-kernel inside the compiler (AKG integration), so the
solver pipeline is built to amortize everything that repeats:

* **Per-band base problems** (``_base_problem``): the schedule-coefficient
  variables and the legality Farkas rows of the band's active dependences
  are compiled once per band; each dimension pushes only its own rows
  (completed-statement pinning, cost bounding for unsatisfied deps,
  progression, directives) and pops them after the solve.
* **Memoized Farkas expansions** (``costs.cached_farkas``): a dependence's
  linearization is dimension-independent, so dimension k+1 replays the
  expansion computed at dimension k.
* **Per-component ILP decomposition** (``_ilp_components``): one ILP per
  connected component of the active dependence graph.  Components share
  no constraints and every objective stage is a sum of per-component
  terms, so the merged per-component lexmins equal the monolithic lexmin;
  components coupled through proximity's shared bounding coefficients
  u/w are merged to keep this exact.  Custom constraints / user
  variables force the monolithic problem.
* **Compiled dependence polyhedra** (``deps.compiled_poly``): distance /
  satisfaction queries reuse per-dependence LP matrices, with an
  affine-hull reduction that answers constant-distance queries with no
  LP at all.
* **Incremental lexmin** (``ilp.ILPProblem.lexmin`` → the exact
  rational simplex in ``lexsimplex``): append-only fixing rows on one
  live tableau, warm-start stage skipping, exact (uncapped) weighted
  combination of the box-bounded integer tail stages, and a canonical
  tie-break over the schedule coefficients that makes the chosen
  optimum unique — seed path ≡ incremental path ≡ repeat runs,
  bit-for-bit, on every kernel×strategy combination (the
  golden-schedule CI gate).

``incremental=False`` reproduces the seed pipeline end to end and is the
baseline of ``benchmarks/bench_scheduler.py`` (≈3–4x geomean win).
Repeat scheduling of the same kernel shape is a structural-cache lookup
(``repro_torch.core.schedcache``).
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Any, Dict, List, Optional, Sequence, Set, Tuple

from . import costs as C
from .affine import Affine, parse_constraint
from .config import DimConfig, Directive, SchedulerConfig
from .deps import Dependence, compiled_poly, compute_dependences, dep_distance_max, dep_distance_min, dep_distance_range, phi_difference
from .farkas import add_farkas_nonneg
from .ilp import ILPProblem, Unbounded
from .linalg_q import orth_complement_basis
from .resilience import fault_point
from .scop import Scop, Statement


@dataclass
class ScheduleRow:
    kind: str                      # 'linear' | 'scalar'
    coeffs: Dict[Tuple, Fraction]  # ('it',k) / ('par',p) / ('cst',) -> value

    def it_vector(self, dim: int) -> List[int]:
        return [int(self.coeffs.get(("it", k), 0)) for k in range(dim)]

    def cst(self) -> int:
        return int(self.coeffs.get(("cst",), 0))


@dataclass
class Schedule:
    scop: Scop
    rows: Dict[int, List[ScheduleRow]]        # stmt index -> rows per dim
    bands: List[int]                          # band id per dim
    parallel: List[bool]                      # per dim: zero-distance for all
    seq_marked: Set[Tuple[int, int]] = field(default_factory=set)
    vector_iter: Dict[int, int] = field(default_factory=dict)  # stmt -> iter idx
    dropped_directives: List[Directive] = field(default_factory=list)
    fallback: bool = False
    deps: List[Dependence] = field(default_factory=list)
    stats: Dict[str, Any] = field(default_factory=dict)
    # degradation-ladder provenance (repro_torch.core.resilience): a clean
    # schedule is level 0; faults/deadline breaches step the ladder down
    # and record why.  Read through resilience.provenance() — cached
    # pickles from older format versions may lack the fields.
    degraded: bool = False
    fallback_level: int = 0
    degrade_reasons: List[str] = field(default_factory=list)

    @property
    def n_dims(self) -> int:
        return len(self.bands)

    def theta(self, stmt: Statement) -> List[ScheduleRow]:
        return self.rows[stmt.index]

    def it_matrix(self, stmt: Statement) -> List[List[int]]:
        return [r.it_vector(stmt.dim) for r in self.rows[stmt.index] if r.kind == "linear"]

    def pretty(self) -> str:
        out = []
        params = self.scop.param_names()
        for s in self.scop.statements:
            terms = []
            for r in self.rows[s.index]:
                if r.kind == "scalar":
                    terms.append(str(r.cst()))
                else:
                    bits = []
                    for k, it in enumerate(s.iters):
                        c = int(r.coeffs.get(("it", k), 0))
                        if c == 1:
                            bits.append(it)
                        elif c:
                            bits.append(f"{c}{it}")
                    for p in params:
                        c = int(r.coeffs.get(("par", p), 0))
                        if c:
                            bits.append(f"{c}{p}" if c != 1 else p)
                    c = r.cst()
                    if c or not bits:
                        bits.append(str(c))
                    terms.append("+".join(bits).replace("+-", "-"))
            out.append(f"S{s.index}: [{', '.join(terms)}]   # {s.body[:48]}")
        out.append(f"bands={self.bands} parallel={self.parallel}")
        return "\n".join(out)

    def innermost_linear_dim(self, stmt: Statement) -> Optional[int]:
        rr = self.rows[stmt.index]
        for d in range(len(rr) - 1, -1, -1):
            if rr[d].kind == "linear" and any(v != 0 for v in rr[d].it_vector(stmt.dim)):
                return d
        return None

    def stmt_parallel_at(self, stmt: Statement, dim: int) -> bool:
        """True if executing dim `dim` in parallel/vector fashion is legal
        for `stmt` alone: every dependence touching stmt that is not
        strongly satisfied at an *outer* dim has zero distance at `dim`."""
        return self.stmt_parallel_at_set({stmt.index}, dim)

    def stmt_parallel_at_set(self, stmt_set, dim: int) -> bool:
        """Parallel-execution legality of dim `dim` for a loop containing
        exactly the statements in `stmt_set`: every dependence with BOTH
        endpoints in the set, not strongly satisfied at an outer dim, must
        have zero distance at `dim`."""
        params = self.scop.param_names()
        for dep in self.deps:
            if dep.source.index not in stmt_set or dep.target.index not in stmt_set:
                continue
            if dep.satisfied_at is not None and dep.satisfied_at < dim:
                continue
            rs = self.rows[dep.source.index][dim].coeffs
            rt = self.rows[dep.target.index][dim].coeffs
            lo, hi = dep_distance_range(dep, rs, rt, params)
            if lo != 0 or hi != 0:
                return False
        return True


class SchedulingError(Exception):
    pass


@dataclass
class StrategyState:
    """State handed to the Python strategy callback (the paper's C++
    interface analogue): inspect anything, return a DimConfig."""
    dim: int
    band: int
    band_start: bool
    parallel_failed: bool
    scop: Scop
    rows: Dict[int, List[ScheduleRow]]
    active_deps: List[Dependence]
    completed: Set[int]


class PolyTOPSScheduler:
    def __init__(self, scop: Scop, config: Optional[SchedulerConfig] = None,
                 deps: Optional[List[Dependence]] = None, engine: str = "lex",
                 incremental: bool = True, decompose: bool = True,
                 record_stage_values: bool = False,
                 deadline: Optional["Deadline"] = None):
        self.scop = scop
        self.config = config or SchedulerConfig()
        self.deps = deps if deps is not None else compute_dependences(scop)
        self.engine = engine
        # wall-clock budget (resilience.Deadline), checked at dimension
        # boundaries and before every ILP solve; None → never expires
        self.deadline = deadline
        self._partial: Optional[Tuple] = None
        # incremental=False reproduces the seed pipeline end to end
        # (clone-per-lexmin dense ILPs, no Farkas memoization, no compiled
        # dependence polyhedra) — kept for benchmarking and differential
        # tests.  decompose=False forces one monolithic ILP per dimension.
        self.incremental = incremental
        self.decompose = decompose and incremental
        self._farkas_cache: Optional[Dict[Tuple, Any]] = {} if incremental else None
        self._base_probs: Dict[Tuple, Any] = {}
        self._fusion_applied: Set[int] = set()
        # opt-in (differential tests): exact per-dim stage objective
        # values in stats — off on the production path, where nothing
        # reads them
        self.record_stage_values = record_stage_values
        self.params = scop.param_names()
        self.stats: Dict[str, Any] = {
            "ilp_solves": 0, "ilp_time": 0.0,
            "components": 0, "lex_stages_skipped": 0, "lex_pivots": 0,
        }

    def _want_order(self, stmts) -> List[str]:
        """The canonical variable order for lexmin tie-breaking AND the
        set of variables materialized from solutions.  Identical in the
        seed and incremental paths — together with the exact engine's
        canonicalization this makes the chosen optimum a pure function
        of the mathematical problem, not of the pipeline."""
        want: List[str] = []
        for s in stmts:
            want += [C.t_it(s, k) for k in range(s.dim)]
            want += [C.t_par(s, p) for p in self.params]
            want.append(C.t_cst(s))
        return want

    # -- public -------------------------------------------------------------
    def schedule(self) -> Schedule:
        t0 = time.time()
        scop, cfg = self.scop, self.config
        stmts = scop.statements
        self._base_probs.clear()
        self._fusion_applied: Set[int] = set()
        for d in self.deps:
            d.satisfied_at = None
        active: List[Dependence] = list(self.deps)
        H: Dict[int, List[List[Fraction]]] = {s.index: [] for s in stmts}
        rows: Dict[int, List[ScheduleRow]] = {s.index: [] for s in stmts}
        bands: List[int] = []
        parallel: List[bool] = []
        band = 0
        band_start = True
        dropped: List[Directive] = []
        directives = self._expand_directives()
        vector_iter = {d.stmts[0]: d.iterator for d in directives
                       if d.type == "vectorize" and d.iterator is not None}
        seq_marked: Set[Tuple[int, int]] = set()
        max_dims = 2 * max((s.dim for s in stmts), default=1) + 3 + len(stmts)
        dim = 0
        # live references for partial-prefix salvage: rows/bands/parallel
        # are mutated in place only at completed-dimension boundaries, so
        # the ladder can recover everything solved before a fault
        self._partial = (rows, bands, parallel, seq_marked, vector_iter,
                         dropped)

        def completed() -> Set[int]:
            return {s.index for s in stmts if len(H[s.index]) >= s.dim}

        while dim < max_dims:
            if self.deadline is not None:
                self.deadline.check(f"scheduler dim {dim}")
            comp = completed()
            if len(comp) == len(stmts):
                # progression exhausted — remaining (equal-date) dependences
                # are ordered by the final textual scalar dimension and
                # verified in _verify_remaining.
                break

            # ---- distribution step (Algorithm 1 lines 8-14) -------------
            groups = self._distribution_groups(dim, active, comp, band_start)
            if groups is not None and len(groups) > 1:
                self._check_groups_legal(groups, active)
                self._emit_scalar(rows, groups)
                self._mark_scalar_satisfied(groups, active, dim)
                bands.append(band)
                parallel.append(False)
                active = [d for d in active if d.satisfied_at is None]
                band += 1
                band_start = True
                dim += 1
                continue

            # ---- ILP step (lines 16-30) ----------------------------------
            state = StrategyState(dim, band, band_start, False, scop, rows,
                                  list(active), comp)
            dc = cfg.dim_config(dim, state if cfg.strategy else None)
            sol = None
            attempts: List[Tuple[DimConfig, bool]] = [(dc, True)]
            if dc.require_parallel:
                state2 = StrategyState(dim, band, band_start, True, scop, rows,
                                       list(active), comp)
                dc_fb = cfg.dim_config(dim, state2 if cfg.strategy else None)
                if cfg.strategy is None:
                    dc_fb = DimConfig(cost_functions=["feautrier"])
                attempts.append((dc_fb, True))
            attempts.append((attempts[-1][0], False))  # drop directives

            for cand, with_dirs in attempts:
                sol = self._solve_dim(cand, active, comp, H, dim, directives,
                                      vector_iter, with_dirs, band_start)
                if sol is not None:
                    if not with_dirs:
                        dropped.extend(d for d in directives if d.type == "vectorize")
                        directives = [d for d in directives if d.type != "vectorize"]
                        vector_iter = {}
                    break

            if sol is None:
                # cut band, retry (lines 23-30)
                if any(d.satisfied_at is not None for d in active):
                    active = [d for d in active if d.satisfied_at is None]
                    band += 1
                    band_start = True
                    continue
                # SCC distribution (lines 32-36) — only if it makes progress
                # (at least one unsatisfied dependence crosses groups)
                sccs = _scc_groups(stmts, active)
                if len(sccs) > 1 and self._distribution_progress(sccs, active):
                    self._check_groups_legal(sccs, active)
                    self._emit_scalar(rows, sccs)
                    self._mark_scalar_satisfied(sccs, active, dim)
                    bands.append(band)
                    parallel.append(False)
                    active = [d for d in active if d.satisfied_at is None]
                    band += 1
                    band_start = True
                    dim += 1
                    continue
                return self._fallback_original()

            # record the linear dimension
            for s in stmts:
                row = ScheduleRow("linear", sol[s.index])
                rows[s.index].append(row)
                itv = [Fraction(sol[s.index].get(("it", k), 0)) for k in range(s.dim)]
                if any(itv) and len(H[s.index]) < s.dim:
                    H[s.index].append(itv)
            # satisfaction + parallelism bookkeeping (max-side LP only
            # when the min side leaves parallelism possible)
            is_par = True
            for dep in active:
                rs = sol[dep.source.index]
                rt = sol[dep.target.index]
                lo = dep_distance_min(dep, rs, rt, self.params,
                                      cache=self.incremental)
                if dep.satisfied_at is None and lo is not None and lo >= 1:
                    dep.satisfied_at = dim
                if dep.satisfied_at is None or dep.satisfied_at == dim:
                    if lo != 0:
                        is_par = False
                    elif is_par:
                        hi = dep_distance_max(dep, rs, rt, self.params,
                                              cache=self.incremental)
                        if hi != 0:
                            is_par = False
            # honor explicit 'sequential' directives in the report
            for dv in directives:
                if dv.type == "sequential":
                    for si in dv.stmts:
                        seq_marked.add((si, dim))
            bands.append(band)
            parallel.append(is_par)
            band_start = False
            dim += 1

        sched = Schedule(scop, rows, bands, parallel, seq_marked, vector_iter,
                         dropped, False, self.deps, dict(self.stats))
        if not self._append_final_order(sched):
            # remaining equal-date dependences are cyclic across
            # statements: no scalar ordering exists → original schedule
            # (paper §IV-B fallback behaviour)
            return self._fallback_original()
        self._verify_remaining(active, sched)
        self.stats["time"] = time.time() - t0
        sched.stats = dict(self.stats)
        return sched

    # -- distribution -------------------------------------------------------
    def _distribution_groups(self, dim, active, comp, band_start):
        fspec = self.config.fusion_for(dim)
        stmts = self.scop.statements
        # an explicit FusionSpec is a *one-shot* distribution decision:
        # once its scalar dimension is emitted the spec must not fire
        # again (a 'default'-dimension spec would otherwise re-distribute
        # at every subsequent dim, emitting scalar dims until max_dims
        # with no linear progression at all)
        if fspec is not None and id(fspec) in self._fusion_applied:
            fspec = None
        if fspec is not None:
            if fspec.groups is not None:
                self._fusion_applied.add(id(fspec))
                covered = {i for g in fspec.groups for i in g}
                groups = [list(g) for g in fspec.groups]
                for s in stmts:
                    if s.index not in covered:
                        groups.append([s.index])
                return groups
            if fspec.total_distribution:
                self._fusion_applied.add(id(fspec))
                return _scc_groups(stmts, active)
        if dim == 0 and self.config.fusion_mode != "max" and len(stmts) > 1:
            sccs = _scc_groups(stmts, active)
            if self.config.fusion_mode == "no":
                return sccs
            # smart fuse: merge adjacent SCCs with equal loop dimensionality
            merged: List[List[int]] = []
            for g in sccs:
                gdim = max(stmts[i].dim for i in g)
                if merged and max(stmts[i].dim for i in merged[-1]) == gdim:
                    merged[-1].extend(g)
                else:
                    merged.append(list(g))
            return merged
        return None

    def _distribution_progress(self, groups, active) -> bool:
        pos = {}
        for gi, g in enumerate(groups):
            for si in g:
                pos[si] = gi
        return any(
            d.satisfied_at is None and pos[d.source.index] < pos[d.target.index]
            for d in active
        )

    def _check_groups_legal(self, groups, active):
        pos = {}
        for gi, g in enumerate(groups):
            for si in g:
                pos[si] = gi
        for dep in active:
            if dep.satisfied_at is not None:
                continue
            if pos[dep.source.index] > pos[dep.target.index]:
                raise SchedulingError(
                    f"fusion/distribution config violates dependence {dep}"
                )

    def _emit_scalar(self, rows, groups):
        pos = {}
        for gi, g in enumerate(groups):
            for si in g:
                pos[si] = gi
        for s in self.scop.statements:
            rows[s.index].append(ScheduleRow("scalar", {("cst",): Fraction(pos[s.index])}))

    def _mark_scalar_satisfied(self, groups, active, dim):
        pos = {}
        for gi, g in enumerate(groups):
            for si in g:
                pos[si] = gi
        for dep in active:
            if dep.satisfied_at is None and pos[dep.source.index] < pos[dep.target.index]:
                dep.satisfied_at = dim

    # -- the per-dimension ILP ----------------------------------------------
    def _ilp_components(self, active, dc: DimConfig) -> Optional[List[List[int]]]:
        """Connected components of the active dependence graph (undirected),
        or None when a single monolithic ILP is required.

        Statements in different components share no validity/cost
        constraints — every constraint row is induced by a dependence or
        is per-statement (progression, bounds, tail) — and every
        objective stage is a sum of per-component terms (proximity's
        bounding coefficients u/w become per-component instances), so
        solving the components independently and merging is exact: the
        lexmin of a separable objective over a product feasible set is
        the product of the per-component lexmins."""
        if not self.decompose:
            return None
        # custom constraints / user variables may couple arbitrary
        # statements → stay monolithic
        if self.config.new_variables or dc.constraints:
            return None
        stmts = self.scop.statements
        parent = {s.index: s.index for s in stmts}

        def find(x: int) -> int:
            while parent[x] != x:
                parent[x] = parent[parent[x]]
                x = parent[x]
            return x

        for d in active:
            a, b = find(d.source.index), find(d.target.index)
            if a != b:
                parent[a] = b
        groups: Dict[int, List[int]] = {}
        for s in stmts:
            groups.setdefault(find(s.index), []).append(s.index)
        if len(groups) <= 1:
            return None
        out = [sorted(g) for g in sorted(groups.values(), key=min)]
        if "proximity" in dc.cost_functions:
            # proximity's bounding coefficients u/w are shared by every
            # unsatisfied dependence: merge all components that contain
            # one, so the decomposition stays exact wrt the monolithic
            # lexmin (components without unsat deps contribute only
            # per-statement/per-dep terms and stay separate)
            unsat_stmts = {d.source.index for d in active if d.satisfied_at is None}
            unsat_stmts |= {d.target.index for d in active if d.satisfied_at is None}
            coupled = [g for g in out if any(i in unsat_stmts for i in g)]
            if len(coupled) > 1:
                rest = [g for g in out if not any(i in unsat_stmts for i in g)]
                merged = sorted(i for g in coupled for i in g)
                out = sorted(rest + [merged], key=min)
        if len(out) <= 1:
            return None
        return out

    def _solve_dim(self, dc: DimConfig, active, comp, H, dim, directives,
                   vector_iter, with_directives, band_start):
        groups = self._ilp_components(active, dc)
        if groups is None:
            return self._solve_dim_group(None, dc, active, comp, H, dim,
                                         directives, vector_iter,
                                         with_directives, band_start)
        out: Dict[int, Dict[Tuple, Fraction]] = {}
        self.stats["components"] += len(groups)
        for g in groups:
            gset = set(g)
            gdeps = [d for d in active if d.source.index in gset]
            if len(g) == 1 and g[0] in comp and not gdeps:
                # completed isolated statement: T_it is pinned to zero and
                # the tail stages drive T_par/T_cst to their lower bound 0
                # — the unique lexmin, no LP needed
                out[g[0]] = {}
                continue
            sub = self._solve_dim_group(gset, dc, gdeps, comp, H, dim,
                                        directives, vector_iter,
                                        with_directives, band_start)
            if sub is None:
                # one infeasible component makes the monolithic problem
                # infeasible too (disjoint constraint systems)
                return None
            out.update(sub)
        return out

    def _base_problem(self, group, stmts, active, feautrier_mode):
        """Per-band persistent base ILP: schedule-coefficient variables +
        legality Farkas rows for the band's active dependences.

        Those rows are identical for every dimension of a band (the
        active set only changes on band cuts / distribution, which change
        the key), so the compiled float matrices are built once per band;
        each dimension pushes only its own rows (completed pinning, cost
        bounding for still-unsatisfied deps, progression, directives) and
        pops them after the solve."""
        scop, cfg = self.scop, self.config
        gkey = None if group is None else tuple(sorted(group))
        key = (gkey, tuple(d.id for d in active), feautrier_mode)
        entry = self._base_probs.get(key)
        if entry is not None:
            return entry
        # bound memory without thrashing: evict the oldest entry only
        # (a band of a many-component SCoP holds one base per group)
        if len(self._base_probs) >= 64:
            self._base_probs.pop(next(iter(self._base_probs)))
        prob = ILPProblem(self.engine, incremental=True)
        cb = cfg.coeff_bound
        for s in stmts:
            for k in range(s.dim):
                prob.var(C.t_it(s, k), lb=0, ub=cb, integer=True)
            for p in self.params:
                ub = cb if getattr(cfg, "parametric_shift", False) else 0
                prob.var(C.t_par(s, p), lb=0, ub=ub, integer=True)
            prob.var(C.t_cst(s), lb=0, ub=cfg.cst_bound, integer=True)
        for v in cfg.new_variables:
            prob.ensure_var(v, lb=0, ub=None, integer=True)
        # validity (Eq. 2); deps the feautrier cost covers get their
        # (stronger) farkas rows per-dim instead
        legal_ids: Set[int] = set()
        for dep in active:
            if feautrier_mode and dep.satisfied_at is None:
                continue
            C.cached_farkas(prob, self._farkas_cache, "legality", dep,
                            lambda dep=dep: C.phi_coef_map(dep, self.params),
                            f"lv{dep.id}")
            legal_ids.add(dep.id)
        # canonical tail: small coefficients, no parametric part, prefer
        # the original loop order on ties, small consts
        tp: Affine = {}
        ti: Affine = {}
        to: Affine = {}
        tc: Affine = {}
        for s in stmts:
            for p in self.params:
                tp[C.t_par(s, p)] = Fraction(1)
            for k in range(s.dim):
                ti[C.t_it(s, k)] = Fraction(1)
                to[C.t_it(s, k)] = Fraction(k + 1)
            tc[C.t_cst(s)] = Fraction(1)
        entry = (prob, legal_ids, [tp, ti, to, tc])
        self._base_probs[key] = entry
        return entry

    def _solve_dim_group(self, group, dc: DimConfig, active, comp, H, dim,
                         directives, vector_iter, with_directives, band_start):
        if not self.incremental:
            return self._solve_dim_seed(dc, active, comp, H, dim, directives,
                                        vector_iter, with_directives,
                                        band_start)
        scop, cfg = self.scop, self.config
        stmts = (scop.statements if group is None
                 else [s for s in scop.statements if s.index in group])
        unsat = [d for d in active if d.satisfied_at is None]
        feautrier_mode = "feautrier" in dc.cost_functions

        prob, legal_ids, tail = self._base_problem(group, stmts, active,
                                                   feautrier_mode)
        # feautrier mode: deps strongly satisfied after the base was built
        # now need plain legality — append to the base (persists; the
        # active set, and hence the base key, is unchanged)
        if feautrier_mode:
            for dep in active:
                if dep.satisfied_at is not None and dep.id not in legal_ids:
                    C.cached_farkas(
                        prob, self._farkas_cache, "legality", dep,
                        lambda dep=dep: C.phi_coef_map(dep, self.params),
                        f"lv{dep.id}")
                    legal_ids.add(dep.id)

        mark = prob.push()
        try:
            for s in stmts:
                if s.index in comp:
                    for k in range(s.dim):
                        prob.add({C.t_it(s, k): Fraction(1)}, "==0")

            stages: List[Affine] = []
            for name in dc.cost_functions:
                if name == "proximity":
                    stages += C.setup_proximity(prob, unsat, self.params, dim,
                                                cache=self._farkas_cache)
                elif name == "feautrier":
                    stages += C.setup_feautrier(prob, unsat, self.params, dim,
                                                cache=self._farkas_cache)
                elif name == "contiguity":
                    coeffs = {s.index: C.contiguity_coeffs(s) for s in stmts}
                    obj = C.stage_from_coeffs(stmts, coeffs,
                                              [s.index for s in stmts if s.index not in comp])
                    if obj:
                        stages.append(obj)
                elif name == "bigLoopsFirst":
                    coeffs = {s.index: C.bigloops_coeffs(s, scop) for s in stmts}
                    obj = C.stage_from_coeffs(stmts, coeffs,
                                              [s.index for s in stmts if s.index not in comp])
                    if obj:
                        stages.append(obj)
                elif name in cfg.new_variables:
                    stages.append({name: Fraction(1)})
                else:
                    raise SchedulingError(f"unknown cost function {name!r}")

            # require_parallel (isl-style coincidence): zero distance on
            # unsat deps
            if dc.require_parallel:
                for dep in unsat:
                    C.cached_farkas(
                        prob, self._farkas_cache, "coincidence", dep,
                        lambda dep=dep: C.phi_coef_map(dep, self.params,
                                                       negate=True),
                        f"lc{dep.id}")

            # progression (Eq. 3) — row basis of H⊥ (see linalg_q)
            for s in stmts:
                if s.index in comp:
                    continue
                orth = orth_complement_basis(H[s.index], s.dim)
                total: Affine = {}
                for r in orth:
                    expr: Affine = {}
                    for k in range(s.dim):
                        if r[k]:
                            expr[C.t_it(s, k)] = r[k]
                            total[C.t_it(s, k)] = total.get(C.t_it(s, k), Fraction(0)) + r[k]
                    if expr:
                        prob.add(expr, ">=0")
                if total:
                    total[1] = Fraction(-1)
                    prob.add(total, ">=0")   # Σ H⊥_i · h ≥ 1

            # custom constraints
            for text in dc.constraints:
                for expr, kind in self._expand_custom(text, comp):
                    prob.add(expr, kind)

            # directives
            if with_directives:
                coin_added: Set[int] = set()   # deps already zero-forced
                if dc.require_parallel:
                    coin_added.update(d.id for d in unsat)
                for dv in directives:
                    if dv.type == "vectorize" and dv.iterator is not None:
                        for si in dv.stmts:
                            if group is not None and si not in group:
                                continue
                            s = scop.statements[si]
                            if si in comp or dv.iterator >= s.dim:
                                continue
                            remaining = s.dim - len(H[si])
                            if remaining > 1:
                                prob.add({C.t_it(s, dv.iterator): Fraction(1)}, "==0")
                            else:
                                prob.add({C.t_it(s, dv.iterator): Fraction(1),
                                          1: Fraction(-1)}, "==0")
                    elif dv.type == "parallel" and band_start:
                        for si in dv.stmts:
                            for dep in unsat:
                                if dep.id in coin_added:
                                    continue
                                if dep.source.index == si or dep.target.index == si:
                                    coin_added.add(dep.id)
                                    C.cached_farkas(
                                        prob, self._farkas_cache, "coincidence",
                                        dep,
                                        lambda dep=dep: C.phi_coef_map(
                                            dep, self.params, negate=True),
                                        f"lc{dep.id}")

            want = self._want_order(stmts)

            if self.deadline is not None:
                self.deadline.check("ilp.solve")
            fault_point("ilp.solve")
            t0 = time.time()
            self.stats["ilp_solves"] += 1
            try:
                sol = prob.lexmin(stages + tail, want=want, canon=want)
            except Unbounded:
                sol = None
            self.stats["ilp_time"] += time.time() - t0
            self.stats["lex_stages_skipped"] += prob.stages_skipped
            self.stats["lex_pivots"] += prob.last_pivots
            prob.last_pivots = 0
            if sol is not None and self.record_stage_values:
                from .ilp import stage_values
                self.stats.setdefault("stage_values", []).append(
                    (dim, stage_values(stages, sol)))
        finally:
            prob.pop(mark)
        if sol is None:
            return None
        out: Dict[int, Dict[Tuple, Fraction]] = {}
        for s in stmts:
            coeffs: Dict[Tuple, Fraction] = {}
            for k in range(s.dim):
                v = sol[C.t_it(s, k)]
                if v:
                    coeffs[("it", k)] = v
            for p in self.params:
                v = sol[C.t_par(s, p)]
                if v:
                    coeffs[("par", p)] = v
            v = sol[C.t_cst(s)]
            if v:
                coeffs[("cst",)] = v
            out[s.index] = coeffs
        return out

    def _solve_dim_seed(self, dc: DimConfig, active, comp, H, dim, directives,
                        vector_iter, with_directives, band_start):
        """The seed per-dimension ILP: one monolithic problem rebuilt
        from scratch every dimension, no Farkas memoization, no
        decomposition.  Kept as the benchmarking baseline
        (``incremental=False``).  It shares the exact engine and the
        canonical lexmin tie-break with the incremental path, so both
        must produce bit-identical schedules — a tier-1 invariant."""
        scop, cfg = self.scop, self.config
        stmts = scop.statements
        prob = ILPProblem(self.engine, incremental=False)
        cb = cfg.coeff_bound
        for s in stmts:
            for k in range(s.dim):
                prob.var(C.t_it(s, k), lb=0, ub=cb, integer=True)
            for p in self.params:
                ub = cb if getattr(cfg, "parametric_shift", False) else 0
                prob.var(C.t_par(s, p), lb=0, ub=ub, integer=True)
            prob.var(C.t_cst(s), lb=0, ub=cfg.cst_bound, integer=True)
            if s.index in comp:
                for k in range(s.dim):
                    prob.add({C.t_it(s, k): Fraction(1)}, "==0")
        for v in cfg.new_variables:
            prob.ensure_var(v, lb=0, ub=None, integer=True)

        # validity (Eq. 2) for every active dependence
        unsat = [d for d in active if d.satisfied_at is None]
        feautrier_mode = "feautrier" in dc.cost_functions
        stages: List[Affine] = []
        for name in dc.cost_functions:
            if name == "proximity":
                stages += C.setup_proximity(prob, unsat, self.params, dim)
            elif name == "feautrier":
                stages += C.setup_feautrier(prob, unsat, self.params, dim)
            elif name == "contiguity":
                coeffs = {s.index: C.contiguity_coeffs(s) for s in stmts}
                obj = C.stage_from_coeffs(stmts, coeffs,
                                          [s.index for s in stmts if s.index not in comp])
                if obj:
                    stages.append(obj)
            elif name == "bigLoopsFirst":
                coeffs = {s.index: C.bigloops_coeffs(s, scop) for s in stmts}
                obj = C.stage_from_coeffs(stmts, coeffs,
                                          [s.index for s in stmts if s.index not in comp])
                if obj:
                    stages.append(obj)
            elif name in cfg.new_variables:
                stages.append({name: Fraction(1)})
            else:
                raise SchedulingError(f"unknown cost function {name!r}")
        # plain legality for deps not already covered by feautrier's farkas
        for dep in active:
            if feautrier_mode and dep.satisfied_at is None:
                continue  # feautrier already added φ_R − φ_S − e ≥ 0, e ≥ 0
            coef, const = C.phi_coef_map(dep, self.params)
            add_farkas_nonneg(prob, dep.cons, coef, const, tag="v")

        # require_parallel (isl-style coincidence): zero distance on unsat deps
        if dc.require_parallel:
            for dep in unsat:
                coef, const = C.phi_coef_map(dep, self.params, negate=True)
                add_farkas_nonneg(prob, dep.cons, coef, const, tag="c")

        # progression (Eq. 3) — row basis of H⊥ (see linalg_q)
        for s in stmts:
            if s.index in comp:
                continue
            orth = orth_complement_basis(H[s.index], s.dim)
            total: Affine = {}
            for r in orth:
                expr: Affine = {}
                for k in range(s.dim):
                    if r[k]:
                        expr[C.t_it(s, k)] = r[k]
                        total[C.t_it(s, k)] = total.get(C.t_it(s, k), Fraction(0)) + r[k]
                if expr:
                    prob.add(expr, ">=0")
            if total:
                total[1] = Fraction(-1)
                prob.add(total, ">=0")   # Σ H⊥_i · h ≥ 1

        # custom constraints
        for text in dc.constraints:
            for expr, kind in self._expand_custom(text, comp):
                prob.add(expr, kind)

        # directives
        if with_directives:
            for dv in directives:
                if dv.type == "vectorize" and dv.iterator is not None:
                    for si in dv.stmts:
                        s = stmts[si]
                        if si in comp or dv.iterator >= s.dim:
                            continue
                        remaining = s.dim - len(H[si])
                        if remaining > 1:
                            prob.add({C.t_it(s, dv.iterator): Fraction(1)}, "==0")
                        else:
                            prob.add({C.t_it(s, dv.iterator): Fraction(1),
                                      1: Fraction(-1)}, "==0")
                elif dv.type == "parallel" and band_start:
                    for si in dv.stmts:
                        for dep in unsat:
                            if dep.source.index == si or dep.target.index == si:
                                coef, const = C.phi_coef_map(dep, self.params, negate=True)
                                add_farkas_nonneg(prob, dep.cons, coef, const, tag="d")

        # canonical tail: small coefficients, no parametric part, prefer the
        # original loop order on ties, small consts
        tp: Affine = {}
        ti: Affine = {}
        to: Affine = {}
        tc: Affine = {}
        for s in stmts:
            for p in self.params:
                tp[C.t_par(s, p)] = Fraction(1)
            for k in range(s.dim):
                ti[C.t_it(s, k)] = Fraction(1)
                to[C.t_it(s, k)] = Fraction(k + 1)
            tc[C.t_cst(s)] = Fraction(1)
        tail = [tp, ti, to, tc]
        want = self._want_order(stmts)

        if self.deadline is not None:
            self.deadline.check("ilp.solve")
        fault_point("ilp.solve")
        t0 = time.time()
        self.stats["ilp_solves"] += 1
        try:
            sol = prob.lexmin(stages + tail, want=want, canon=want)
        except Unbounded:
            sol = None
        self.stats["ilp_time"] += time.time() - t0
        self.stats["lex_pivots"] += prob.last_pivots
        prob.last_pivots = 0
        if sol is None:
            return None
        if self.record_stage_values:
            from .ilp import stage_values
            self.stats.setdefault("stage_values", []).append(
                (dim, stage_values(stages, sol)))
        out: Dict[int, Dict[Tuple, Fraction]] = {}
        for s in stmts:
            coeffs: Dict[Tuple, Fraction] = {}
            for k in range(s.dim):
                v = sol[C.t_it(s, k)]
                if v:
                    coeffs[("it", k)] = v
            for p in self.params:
                v = sol[C.t_par(s, p)]
                if v:
                    coeffs[("par", p)] = v
            v = sol[C.t_cst(s)]
            if v:
                coeffs[("cst",)] = v
            out[s.index] = coeffs
        return out

    # -- custom constraint expansion -----------------------------------------
    _CUSTOM = re.compile(r"^S(\d+|i)_(it|par)_(\d+|i)$|^S(\d+|i)_cst$")

    def _expand_custom(self, text: str, comp) -> List[Tuple[Affine, str]]:
        stmts = self.scop.statements
        if text.strip() == "no-skewing":
            out = []
            for s in stmts:
                if s.index in comp:
                    continue
                expr = {C.t_it(s, k): Fraction(-1) for k in range(s.dim)}
                expr[1] = Fraction(1)
                out.append((expr, ">=0"))   # Σ T_it ≤ 1
            return out
        expr, kind = parse_constraint(text)
        mapped: Affine = {}
        for sym, coef in expr.items():
            if sym == 1:
                mapped[1] = mapped.get(1, Fraction(0)) + coef
                continue
            m = self._CUSTOM.match(str(sym))
            if not m:
                if sym in self.config.new_variables:
                    mapped[sym] = mapped.get(sym, Fraction(0)) + coef
                    continue
                raise SchedulingError(f"unknown symbol {sym!r} in custom constraint")
            if m.group(4) is not None:   # S<x>_cst
                sids = range(len(stmts)) if m.group(4) == "i" else [int(m.group(4))]
                for si in sids:
                    key = C.t_cst(stmts[si])
                    mapped[key] = mapped.get(key, Fraction(0)) + coef
            else:
                sids = range(len(stmts)) if m.group(1) == "i" else [int(m.group(1))]
                vt = m.group(2)
                for si in sids:
                    s = stmts[si]
                    if vt == "it":
                        ks = range(s.dim) if m.group(3) == "i" else [int(m.group(3))]
                        for k in ks:
                            if k < s.dim:
                                key = C.t_it(s, k)
                                mapped[key] = mapped.get(key, Fraction(0)) + coef
                    else:
                        ps = (self.params if m.group(3) == "i"
                              else [self.params[int(m.group(3))]])
                        for p in ps:
                            key = C.t_par(s, p)
                            mapped[key] = mapped.get(key, Fraction(0)) + coef
        return [(mapped, kind)]

    # -- directives -----------------------------------------------------------
    def _expand_directives(self) -> List[Directive]:
        out = [Directive(d.type, list(d.stmts), d.iterator) for d in self.config.directives]
        if self.config.auto_vectorize:
            for s in self.scop.statements:
                if any(d.type == "vectorize" and s.index in d.stmts for d in out):
                    continue
                v = _auto_vector_iter(s)
                if v is not None:
                    out.append(Directive("vectorize", [s.index], v))
        # one directive entry per statement simplifies handling
        flat: List[Directive] = []
        for d in out:
            for si in d.stmts:
                flat.append(Directive(d.type, [si], d.iterator))
        return flat

    # -- fallback + verification ----------------------------------------------
    def partial_schedule(self) -> Optional[Schedule]:
        """Degradation rung 1: salvage the legal prefix a failed
        :meth:`schedule` run already solved.

        Every completed dimension is legality-constrained (all active
        dependences weakly satisfied), so any completed prefix followed
        by the program-order suffix (beta scalars interleaved with
        identity dims) is a legal schedule.  The per-dim ILPs decompose
        per SCC, so the prefix carries every SCC result solved before
        the fault.  Returns None when nothing was solved; the result is
        point-wise verified (the salvage path must never publish an
        illegal schedule — verification failure raises and the ladder
        steps down instead)."""
        st = self._partial
        if st is None:
            return None
        rows, bands, parallel, seq_marked, _vec, dropped = st
        n = min((len(rr) for rr in rows.values()), default=0)
        if n == 0:
            return None
        prows = {i: list(rr[:n]) for i, rr in rows.items()}
        pbands = list(bands[:n])
        ppar = list(parallel[:n])
        stmts = self.scop.statements
        maxd = max((s.dim for s in stmts), default=0)
        nb = (max(pbands) + 1) if pbands else 0
        for level in range(maxd + 1):
            for s in stmts:
                b = s.beta[level] if level < len(s.beta) else 0
                prows[s.index].append(
                    ScheduleRow("scalar", {("cst",): Fraction(b)}))
            pbands.append(nb)
            ppar.append(False)
            nb += 1
            if level < maxd:
                for s in stmts:
                    coeffs = ({("it", level): Fraction(1)}
                              if level < s.dim else {})
                    prows[s.index].append(ScheduleRow("linear", coeffs))
                pbands.append(nb)
                ppar.append(False)
                nb += 1
        # conservative marks: directives may have been mid-application
        # when the fault hit, so no vectorization claims survive salvage
        sched = Schedule(self.scop, prows, pbands, ppar, set(seq_marked),
                         {}, list(dropped), True, self.deps,
                         dict(self.stats))
        for dep in self.deps:
            if dep.satisfied_at is not None and dep.satisfied_at >= n:
                dep.satisfied_at = None
        self._verify_remaining([d for d in self.deps
                                if d.satisfied_at is None], sched)
        return sched

    def _fallback_original(self) -> Schedule:
        scop = self.scop
        stmts = scop.statements
        maxd = max((s.dim for s in stmts), default=0)
        rows: Dict[int, List[ScheduleRow]] = {s.index: [] for s in stmts}
        bands: List[int] = []
        parallel: List[bool] = []
        for level in range(maxd + 1):
            for s in stmts:
                b = s.beta[level] if level < len(s.beta) else 0
                rows[s.index].append(ScheduleRow("scalar", {("cst",): Fraction(b)}))
            bands.append(2 * level)
            parallel.append(False)
            if level < maxd:
                sol = {}
                for s in stmts:
                    coeffs = {("it", level): Fraction(1)} if level < s.dim else {}
                    rows[s.index].append(ScheduleRow("linear", coeffs))
                    sol[s.index] = coeffs
                is_par = True
                for dep in self.deps:
                    lo = dep_distance_min(dep, sol[dep.source.index],
                                          sol[dep.target.index], self.params,
                                          cache=self.incremental)
                    if dep.satisfied_at is None and lo is not None and lo >= 1:
                        dep.satisfied_at = len(bands)
                    if dep.satisfied_at is None or dep.satisfied_at == len(bands):
                        if lo != 0:
                            is_par = False
                        elif is_par:
                            hi = dep_distance_max(dep, sol[dep.source.index],
                                                  sol[dep.target.index], self.params,
                                                  cache=self.incremental)
                            if hi != 0:
                                is_par = False
                bands.append(2 * level + 1)
                parallel.append(is_par)
        self.stats["fallback"] = True
        return Schedule(scop, rows, bands, parallel, set(), {}, [], True,
                        self.deps, dict(self.stats))

    def _append_final_order(self, sched: Schedule) -> bool:
        """Final scalar dimension ordering statements at equal linear
        dates. Ordered by the topology of still-unsatisfied dependences
        (NOT plain textual order — backward anti/output deps at equal
        dates would be reversed). Returns False if cyclic."""
        stmts = self.scop.statements
        if len(stmts) < 2:
            return True
        remaining = [d for d in self.deps if d.satisfied_at is None
                     and d.source.index != d.target.index]
        groups = _scc_groups(stmts, remaining)
        if any(len(g) > 1 for g in groups):
            return False
        pos = {g[0]: gi for gi, g in enumerate(groups)}
        for s in stmts:
            sched.rows[s.index].append(
                ScheduleRow("scalar", {("cst",): Fraction(pos[s.index])})
            )
        sched.bands.append(sched.bands[-1] + 1 if sched.bands else 0)
        sched.parallel.append(False)
        return True

    def _verify_remaining(self, active, sched: Schedule) -> None:
        """Safety net: any dependence never strongly satisfied must still be
        lexicographically satisfied point-wise by the full schedule."""
        for dep in active:
            if dep.satisfied_at is not None:
                continue
            if not self._lex_satisfied(dep, sched):
                raise SchedulingError(f"schedule does not satisfy {dep}")
            dep.satisfied_at = sched.n_dims - 1

    def _lex_satisfied(self, dep: Dependence, sched: Schedule) -> bool:
        rows_s = sched.rows[dep.source.index]
        rows_t = sched.rows[dep.target.index]
        cp = compiled_poly(dep, self.params) if self.incremental else None

        def _piece_feasible(extra):
            if cp is not None:
                return cp.feasible_with(extra)
            from .polyhedron import feasible as _feas
            return _feas(list(dep.cons) + list(extra))

        prefix: List[Affine] = []
        for d in range(len(rows_s)):
            diff = phi_difference(dep, rows_s[d].coeffs, rows_t[d].coeffs, self.params)
            # piece: all previous diffs == 0 and this diff <= -1  → must be empty
            neg = {k: -v for k, v in diff.items()}
            neg[1] = neg.get(1, Fraction(0)) - 1
            if _piece_feasible([(p, "==0") for p in prefix] + [(neg, ">=0")]):
                return False
            prefix.append(diff)
        # all-equal piece must be empty too (no unordered equal dates)
        return not _piece_feasible([(p, "==0") for p in prefix])


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

def _scc_groups(stmts: Sequence[Statement], deps: Sequence[Dependence]) -> List[List[int]]:
    """SCC condensation of the dependence graph, in topological order."""
    adj: Dict[int, Set[int]] = {s.index: set() for s in stmts}
    for d in deps:
        if d.satisfied_at is None and d.source.index != d.target.index:
            adj[d.source.index].add(d.target.index)
    # Tarjan
    index: Dict[int, int] = {}
    low: Dict[int, int] = {}
    on: Set[int] = set()
    stack: List[int] = []
    out: List[List[int]] = []
    counter = [0]

    def strong(v):
        work = [(v, iter(sorted(adj[v])))]
        index[v] = low[v] = counter[0]
        counter[0] += 1
        stack.append(v)
        on.add(v)
        while work:
            node, it = work[-1]
            advanced = False
            for w in it:
                if w not in index:
                    index[w] = low[w] = counter[0]
                    counter[0] += 1
                    stack.append(w)
                    on.add(w)
                    work.append((w, iter(sorted(adj[w]))))
                    advanced = True
                    break
                elif w in on:
                    low[node] = min(low[node], index[w])
            if advanced:
                continue
            work.pop()
            if work:
                low[work[-1][0]] = min(low[work[-1][0]], low[node])
            if low[node] == index[node]:
                comp = []
                while True:
                    w = stack.pop()
                    on.discard(w)
                    comp.append(w)
                    if w == node:
                        break
                out.append(sorted(comp))

    for s in stmts:
        if s.index not in index:
            strong(s.index)
    # Tarjan emits reverse topological order
    out.reverse()
    # stable order among independent SCCs: by textual position
    comp_of = {}
    for ci, comp in enumerate(out):
        for v in comp:
            comp_of[v] = ci
    cadj: Dict[int, Set[int]] = {i: set() for i in range(len(out))}
    for d in deps:
        if d.satisfied_at is None:
            a, b = comp_of[d.source.index], comp_of[d.target.index]
            if a != b:
                cadj[a].add(b)
    # Kahn with min-textual-position tie-break
    indeg = {i: 0 for i in range(len(out))}
    for a, succs in cadj.items():
        for b in succs:
            indeg[b] += 1
    import heapq
    heap = [(min(out[i]), i) for i in range(len(out)) if indeg[i] == 0]
    heapq.heapify(heap)
    order: List[List[int]] = []
    while heap:
        _, i = heapq.heappop(heap)
        order.append(out[i])
        for b in cadj[i]:
            indeg[b] -= 1
            if indeg[b] == 0:
                heapq.heappush(heap, (min(out[b]), b))
    return order


def _auto_vector_iter(stmt: Statement) -> Optional[int]:
    """Paper §III-B2: pick the iterator moving contiguously in memory."""
    best, best_score = None, 0
    for k, it in enumerate(stmt.iters):
        score = 0
        for acc in stmt.accesses:
            if not acc.subscripts:
                continue
            last = acc.subscripts[-1]
            outer = acc.subscripts[:-1]
            c = last.get(it, Fraction(0))
            if abs(c) == 1 and not any(o.get(it) for o in outer):
                score += 3 if acc.is_write else 2
        if score > best_score:
            best, best_score = k, score
    return best


def schedule_scop(scop: Scop, config: Optional[SchedulerConfig] = None,
                  engine: str = "lex", **kwargs) -> Schedule:
    """Schedule a SCoP. Extra kwargs (``incremental``, ``decompose``)
    are forwarded to :class:`PolyTOPSScheduler`."""
    return PolyTOPSScheduler(scop, config, engine=engine, **kwargs).schedule()
