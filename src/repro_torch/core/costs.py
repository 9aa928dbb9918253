"""Predefined cost functions (paper §III-A1).

Each cost function contributes (a) optional ILP variables+constraints,
(b) one or more lexicographic objective *stages*. The textual order in
the configuration gives the stage priority, exactly as in the paper
("the order of the variables is important because they are minimized in
lexicographic order").

Predefined: ``proximity`` (Pluto, Eq. 4), ``feautrier`` (maximize
strongly-satisfied deps), ``contiguity`` (Tensor-scheduler-inspired,
Eq. 5), ``bigLoopsFirst`` (largest-extent loops outermost).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, List, Sequence

from .affine import Affine
from .deps import Dependence
from .farkas import add_farkas_nonneg, project_farkas
from .ilp import ILPProblem
from .scop import Scop, Statement


def cached_farkas(prob: ILPProblem, cache, key: str, dep: Dependence,
                  build, prefix: str) -> None:
    """Add dep's Farkas-linearized constraint to ``prob``, memoized in
    ``cache`` (dict or None).  ``build() -> (coef_of_z, const_term)`` is
    only called on a miss.

    The cached value is the *projected* row set (multipliers exactly
    eliminated, see ``farkas.project_farkas``): dimension-independent,
    so dimension k+1 replays the rows computed at dimension k, and no
    multiplier variables ever reach the solver.  ``prefix`` is retained
    for interface stability only.  (An earlier revision evaluated naive
    Fourier–Motzkin here and rejected it — without Imbert's acceleration
    it densified the system and slowed HiGHS by an order of magnitude;
    the accelerated exact projection is what made the rational simplex
    backend competitive.)"""
    if cache is not None:
        ck = (key, dep.id)
        rows = cache.get(ck)
        if rows is None:
            coef, const = build()
            rows = cache[ck] = project_farkas(dep.cons, coef, const)
        for expr, kind in rows:
            prob.add(dict(expr), kind)
        return
    coef, const = build()
    add_farkas_nonneg(prob, dep.cons, coef, const)


def t_it(s: Statement, k: int) -> str:
    return f"T{s.index}_it_{k}"


def t_par(s: Statement, p: str) -> str:
    return f"T{s.index}_par_{p}"


def t_cst(s: Statement) -> str:
    return f"T{s.index}_cst"


def phi_coef_map(dep: Dependence, params: Sequence[str], negate: bool = False):
    """coef_of_z and const for φ_R(t) − φ_S(s), as affine exprs over the
    schedule-coefficient ILP variables. negate=True gives φ_S − φ_R."""
    sgn = Fraction(-1 if negate else 1)
    coef: Dict[str, Affine] = {}
    for k in range(dep.target.dim):
        coef[f"t{k}"] = {t_it(dep.target, k): sgn}
    for k in range(dep.source.dim):
        cur = coef.get(f"s{k}", {})
        cur[t_it(dep.source, k)] = cur.get(t_it(dep.source, k), Fraction(0)) - sgn
        coef[f"s{k}"] = cur
    for p in params:
        coef[p] = _merge({t_par(dep.target, p): sgn}, {t_par(dep.source, p): -sgn})
    const = _merge({t_cst(dep.target): sgn}, {t_cst(dep.source): -sgn})
    return coef, const


def _merge(a: Affine, b: Affine) -> Affine:
    out = dict(a)
    for k, v in b.items():
        out[k] = out.get(k, Fraction(0)) + v
        if out[k] == 0:
            del out[k]
    return out


# ---------------------------------------------------------------------------
# proximity (Pluto bounding function): u·N + w − (φ_R − φ_S) ≥ 0
# ---------------------------------------------------------------------------

def setup_proximity(prob: ILPProblem, deps: Sequence[Dependence], params, dim: int,
                    cache=None):
    u_vars = [prob.ensure_var(f"u_{p}", lb=0, ub=None, integer=True) for p in params]
    w = prob.ensure_var("w", lb=0, ub=None, integer=True)
    for dep in deps:
        def build(dep=dep):
            coef, const = phi_coef_map(dep, params, negate=True)  # −(φ_R − φ_S)
            for p in params:
                coef[p] = _merge(coef.get(p, {}), {f"u_{p}": Fraction(1)})
            return coef, _merge(const, {w: Fraction(1)})
        cached_farkas(prob, cache, "proximity", dep, build, f"lp{dep.id}")
    stages: List[Affine] = []
    if u_vars:
        stages.append({u: Fraction(1) for u in u_vars})
    stages.append({w: Fraction(1)})
    return stages


# ---------------------------------------------------------------------------
# feautrier: maximize the number of strongly satisfied dependences
# ---------------------------------------------------------------------------

def setup_feautrier(prob: ILPProblem, deps: Sequence[Dependence], params, dim: int,
                    cache=None):
    es = []
    for dep in deps:
        e = prob.ensure_var(f"e_{dep.id}", lb=0, ub=1, integer=True)
        es.append(e)

        def build(dep=dep, e=e):
            coef, const = phi_coef_map(dep, params)
            return coef, _merge(const, {e: Fraction(-1)})   # φ_R − φ_S − e ≥ 0
        cached_farkas(prob, cache, "feautrier", dep, build, f"lf{dep.id}")
    if not es:
        return []
    return [{e: Fraction(-1) for e in es}]  # minimize −Σe = maximize satisfied


# ---------------------------------------------------------------------------
# contiguity (Eq. 5) and bigLoopsFirst
# ---------------------------------------------------------------------------

def contiguity_coeffs(stmt: Statement) -> List[int]:
    """Support coefficients c_{S,i}: contiguous (stride-1, last-subscript)
    iterators get the LARGEST c so they end up innermost (paper Listing 1
    example: accesses a[j][i] give c = (10, 1) over (i, j))."""
    d = stmt.dim
    score = [0] * d
    for k, it in enumerate(stmt.iters):
        for acc in stmt.accesses:
            if not acc.subscripts:
                continue
            last = acc.subscripts[-1]
            outer = acc.subscripts[:-1]
            c = last.get(it, Fraction(0))
            if c != 0 and abs(c) == 1 and not any(o.get(it) for o in outer):
                score[k] += 2
            elif c != 0:
                score[k] += 1
    order = sorted(range(d), key=lambda k: (score[k], k))
    c = [0] * d
    for rank_pos, k in enumerate(order):
        c[k] = 10 ** rank_pos
    return c


def bigloops_coeffs(stmt: Statement, scop: Scop) -> List[int]:
    """c_{S,i} prioritizing the largest iteration ranges (paper: BLF)."""

    env = {p: Fraction(v) for p, v in scop.params.items()}
    extents = []
    for k, it in enumerate(stmt.iters):
        lo = hi = None
        for expr, kind in stmt.domain:
            c = expr.get(it, Fraction(0))
            if c == 0 or kind != ">=0":
                continue
            # evaluate other iterators at 0 for a cheap extent estimate
            val = expr.get(1, Fraction(0))
            for kk, vv in expr.items():
                if kk in env:
                    val += vv * env[kk]
            bound = -val / c
            if c > 0:
                lo = bound if lo is None else max(lo, bound)
            else:
                hi = -bound if hi is None else min(hi, -bound)
        if lo is None or hi is None:
            extents.append(Fraction(10 ** 6))
        else:
            extents.append(hi - lo + 1)
    order = sorted(range(stmt.dim), key=lambda k: (-extents[k], k))
    c = [0] * stmt.dim
    for rank_pos, k in enumerate(order):
        c[k] = 10 ** rank_pos
    return c


def stage_from_coeffs(stmts: Sequence[Statement], coeffs: Dict[int, List[int]],
                      incomplete: Sequence[int]) -> Affine:
    obj: Affine = {}
    for s in stmts:
        if s.index not in incomplete:
            continue
        for k in range(s.dim):
            c = coeffs[s.index][k]
            if c:
                obj[t_it(s, k)] = obj.get(t_it(s, k), Fraction(0)) + Fraction(c)
    return obj


# ---------------------------------------------------------------------------
# per-dimension cost-function mixes (paper §III-E): named recipes the
# autotuner composes into kernel-specific configurations.  Each mix maps
# a scheduling dimension (or 'default') to (cost_functions, require_parallel)
# — the raw material for a DimConfig.  All mixes are static (no Python
# callback), so mixed configurations stay cacheable.
# ---------------------------------------------------------------------------

COST_MIXES: Dict[str, Dict[object, tuple]] = {
    # stride ordering: contiguity before proximity on every dim (the
    # tensor-style costs without its no-skewing constraint)
    "cp": {"default": (("contiguity", "proximity"), False)},
    # stride ordering reversed: proximity first, contiguity tie-break
    "pc": {"default": (("proximity", "contiguity"), False)},
    # contiguity steers only the outer two scheduling dims (one of which
    # is typically a scalar distribution dim), plain proximity below
    "c01": {0: (("contiguity", "proximity"), False),
            1: (("contiguity", "proximity"), False),
            "default": (("proximity",), False)},
    # largest-extent loops outermost, plain proximity below
    "blf0": {0: (("bigLoopsFirst", "proximity"), False),
             1: (("bigLoopsFirst", "proximity"), False),
             "default": (("proximity",), False)},
    # parallelism-demanding outer dims: static isl-style coincidence
    # (require_parallel with the scheduler's feautrier fallback), but
    # cacheable because there is no dynamic callback
    "par0": {0: (("proximity",), True),
             1: (("proximity",), True),
             "default": (("proximity",), False)},
}
