"""Polyhedron helpers: feasibility, affine optimization, Fourier–Motzkin.

A polyhedron is a list of (Affine, kind) constraints over named
variables, kind in {'>=0', '==0'}. Variables not mentioned in ``free``
are unbounded rationals. Feasibility and optimization go through the LP
layer (rational relaxation — conservative for dependence analysis).
"""
from __future__ import annotations

from fractions import Fraction
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

from .affine import Affine, affine_scale
from .ilp import ILPProblem, Unbounded
from .resilience import fault_point

Constraint = Tuple[Affine, str]


def _vars_of(cons: Sequence[Constraint]) -> List[str]:
    seen: List[str] = []
    for expr, _ in cons:
        for k in expr:
            if k != 1 and k not in seen:
                seen.append(k)
    return seen


def _build_lp(cons: Sequence[Constraint], extra_vars: Iterable[str] = ()) -> ILPProblem:
    # deliberately pinned to the float HiGHS engine: polyhedron queries
    # (dependence distances, satisfaction probes, redundancy pruning in
    # prune_redundant) only consume optimal *values* on rational
    # relaxations, where HiGHS is cheap and a tie between alternate
    # optimal vertices cannot change a schedule.  The exact ``lex``
    # engine is reserved for the scheduler's lexmin, where the vertex
    # itself is the answer.
    p = ILPProblem(engine="highs")
    for v in list(_vars_of(cons)) + list(extra_vars):
        p.ensure_var(v, lb=None, integer=False)
    for expr, kind in cons:
        p.add(expr, kind)
    return p


def feasible(cons: Sequence[Constraint]) -> bool:
    """Rational feasibility (conservative over integer feasibility)."""
    return _build_lp(cons).feasible()


def minimum(cons: Sequence[Constraint], obj: Affine) -> Optional[Fraction]:
    """Rational min of obj over the polyhedron.

    Returns None if empty, -inf (float) if unbounded below.
    """
    p = _build_lp(cons, [k for k in obj if k != 1])
    try:
        r = p.solve_min({k: v for k, v in obj.items()})
    except Unbounded:
        return Fraction(-(10 ** 18))  # sentinel: unbounded below
    if r is None:
        return None
    return r[0]


def maximum(cons: Sequence[Constraint], obj: Affine) -> Optional[Fraction]:
    m = minimum(cons, {k: -v for k, v in obj.items()})
    if m is None:
        return None
    return -m


class CompiledPolyhedron:
    """Reusable LP over a *fixed* constraint system.

    The scheduler optimizes many affine forms (per-row dependence
    distances, satisfaction probes) over the same dependence polyhedron
    at every scheduling dimension.  Building the LP once and swapping
    only the objective/extra rows amortizes the Fraction→float
    compilation across the whole run; results are identical to the
    module-level :func:`minimum`/:func:`maximum`/:func:`feasible`.
    """

    def __init__(self, cons: Sequence[Constraint], extra_vars: Iterable[str] = ()):
        self.prob = _build_lp(cons, extra_vars)
        self.prob._compile()
        self._subst = self._hull_substitution(cons)
        self._memo: Dict[tuple, Optional[Fraction]] = {}

    @staticmethod
    def _hull_substitution(cons: Sequence[Constraint]):
        """Pivot-variable substitution map from the rref of the equality
        rows (the polyhedron's affine hull): pivot var -> affine expr over
        the free variables.  Used to reduce objectives before solving —
        roughly half the scheduler's distance queries become constants
        (e.g. schedule rows equal on both dependence endpoints) and need
        no LP at all."""
        from .linalg_q import rref

        eqs = [e for e, k in cons if k == "==0"]
        if not eqs:
            return {}
        vars_ = sorted({v for e in eqs for v in e if v != 1})
        m = [[Fraction(e.get(v, 0)) for v in vars_] + [Fraction(e.get(1, 0))]
             for e in eqs]
        r, pivots = rref(m)
        subst: Dict[str, Affine] = {}
        for i, pc in enumerate(pivots):
            if pc >= len(vars_):
                continue   # pivot on the constant column: inconsistent row
            # row: x_pc + Σ_j r_ij x_j + r_ib == 0  →  x_pc = −Σ r_ij x_j − r_ib
            expr: Affine = {}
            for j, v in enumerate(vars_):
                if j != pc and r[i][j]:
                    expr[v] = -r[i][j]
            if r[i][len(vars_)]:
                expr[1] = -r[i][len(vars_)]
            subst[vars_[pc]] = expr
        return subst

    def reduce(self, obj: Affine) -> Affine:
        """Substitute the affine hull into ``obj`` (equal pointwise on the
        polyhedron)."""
        if not self._subst:
            return obj
        red: Affine = {}
        for k, c in obj.items():
            if k != 1 and k in self._subst:
                for k2, c2 in self._subst[k].items():
                    red[k2] = red.get(k2, Fraction(0)) + c * c2
            else:
                red[k] = red.get(k, Fraction(0)) + c
        return {k: v for k, v in red.items() if v != 0}

    def _ensure(self, obj: Affine) -> None:
        for k in obj:
            if k != 1:
                self.prob.ensure_var(k, lb=None, integer=False)

    def minimum(self, obj: Affine) -> Optional[Fraction]:
        """Exact rational min of obj; assumes the polyhedron is non-empty
        (dependence polyhedra are feasible by construction)."""
        red = self.reduce(obj)
        if not any(k != 1 for k in red):
            return red.get(1, Fraction(0))   # constant on the hull
        key = tuple(sorted((str(k), v) for k, v in red.items()))
        if key in self._memo:
            return self._memo[key]
        self._ensure(red)
        try:
            r = self.prob.solve_min(dict(red), want=())
        except Unbounded:
            self._memo[key] = out = Fraction(-(10 ** 18))  # unbounded below
            return out
        out = None if r is None else r[0]
        self._memo[key] = out
        return out

    def maximum(self, obj: Affine) -> Optional[Fraction]:
        m = self.minimum({k: -v for k, v in obj.items()})
        if m is None:
            return None
        return -m

    def feasible_with(self, extra: Sequence[Constraint] = ()) -> bool:
        """Feasibility of the base polyhedron ∩ ``extra`` rows; the extra
        rows are appended and rewound around a single solve."""
        mark = self.prob.push()
        try:
            for expr, kind in extra:
                for k in expr:
                    if k != 1:
                        self.prob.ensure_var(k, lb=None, integer=False)
                self.prob.add(expr, kind)
            return self.prob.feasible()
        finally:
            self.prob.pop(mark)


# ---------------------------------------------------------------------------
# Fourier–Motzkin elimination (used by codegen to derive loop bounds)
# ---------------------------------------------------------------------------

def fm_eliminate(cons: Sequence[Constraint], var: str) -> List[Constraint]:
    """Eliminate ``var`` from the system by Fourier–Motzkin.

    Equalities involving var are used as substitutions first.
    The result is the projection (rational); redundant rows are pruned
    cheaply (exact duplicates + trivially-true rows).
    """
    cons = [(dict(e), k) for e, k in cons]
    # substitution via an equality if available
    for i, (expr, kind) in enumerate(cons):
        if kind == "==0" and expr.get(var):
            c = expr[var]
            # var = -(expr - c*var)/c
            rest = {k: v for k, v in expr.items() if k != var}
            sub = affine_scale(rest, Fraction(-1) / c)
            out: List[Constraint] = []
            for j, (e2, k2) in enumerate(cons):
                if j == i:
                    continue
                if e2.get(var):
                    coef = e2[var]
                    e3 = {k: v for k, v in e2.items() if k != var}
                    for k3, v3 in sub.items():
                        e3[k3] = e3.get(k3, Fraction(0)) + coef * v3
                    e3 = {k: v for k, v in e3.items() if v != 0}
                    out.append((e3, k2))
                else:
                    out.append((e2, k2))
            return _prune(out)
    lowers, uppers, rest = [], [], []
    for expr, kind in cons:
        c = expr.get(var, Fraction(0))
        if kind == "==0" or c == 0:
            if c == 0:
                rest.append((expr, kind))
            continue
        if c > 0:
            lowers.append((expr, c))   # c*var + rest >= 0  →  var >= -rest/c
        else:
            uppers.append((expr, c))   # c*var + rest >= 0  →  var <= rest/(-c)
    out = list(rest)
    for le, lc in lowers:
        for ue, uc in uppers:
            # combine: (-uc)*le + lc*ue  eliminates var
            comb: Affine = {}
            for k, v in le.items():
                comb[k] = comb.get(k, Fraction(0)) + (-uc) * v
            for k, v in ue.items():
                comb[k] = comb.get(k, Fraction(0)) + lc * v
            comb.pop(var, None)
            comb = {k: v for k, v in comb.items() if v != 0}
            out.append((comb, ">=0"))
    return _prune(out)


def _normalize(expr: Affine, kind: str) -> Affine:
    """Scale a constraint row to a canonical form: integer coefficients
    with gcd 1 (and, for equalities, first nonzero coefficient positive).
    FM combinations produce scalar multiples of the same hyperplane
    constantly; normalization makes them hash-equal."""
    from math import gcd

    nonconst = sorted((k for k in expr if k != 1), key=str)
    if not nonconst:
        return dict(expr)
    den = 1
    for v in expr.values():
        den = den * v.denominator // gcd(den, v.denominator)
    num = 0
    for v in expr.values():
        num = gcd(num, abs(v.numerator * (den // v.denominator)))
    scale = Fraction(den, num or 1)
    if kind == "==0" and expr[nonconst[0]] < 0:
        scale = -scale
    return {k: v * scale for k, v in expr.items()}


def _prune(cons):
    """Cheap syntactic pruning: drop trivially-true rows, exact and
    scaled duplicates, and '>=0' rows dominated by a parallel row with a
    tighter constant (same normalized non-constant part: expr+c1 >= 0
    implies expr+c2 >= 0 whenever c2 >= c1).

    Rows may be ``(expr, kind)`` or ``(expr, kind, *extra)`` — extra
    fields (e.g. the ancestor sets of ``farkas``' accelerated FM) ride
    along unchanged, so every pruner in the repo shares this one
    implementation."""
    out: List[tuple] = []
    seen = set()
    best_const: Dict[tuple, int] = {}   # parallel-row key -> index in out
    for expr, kind, *extra in cons:
        expr = {k: v for k, v in expr.items() if v != 0}
        nonconst = {k: v for k, v in expr.items() if k != 1}
        if not nonconst:
            c = expr.get(1, Fraction(0))
            if (kind == ">=0" and c >= 0) or (kind == "==0" and c == 0):
                continue  # trivially true
            # trivially false → keep to signal emptiness
            out.append((expr, kind, *extra))
            continue
        expr = _normalize(expr, kind)
        key = (kind, tuple(sorted(((str(k), v) for k, v in expr.items()))))
        if key in seen:
            continue
        if kind == ">=0":
            pkey = tuple(sorted((str(k), v) for k, v in expr.items() if k != 1))
            prev = best_const.get(pkey)
            if prev is not None:
                if out[prev][0].get(1, Fraction(0)) <= expr.get(1, Fraction(0)):
                    continue          # an existing row is at least as tight
                out[prev] = (expr, kind, *extra)   # tighter: replace
                seen.add(key)
                continue
            best_const[pkey] = len(out)
        seen.add(key)
        out.append((expr, kind, *extra))
    return out


def prune_redundant(cons: Sequence[Constraint], context: Sequence[Constraint] = (),
                    max_lp_rows: int = 200) -> List[Constraint]:
    """LP-based redundancy elimination for '>=0' rows.

    A row r is removed when the remaining rows (plus ``context``, extra
    constraints known to hold — e.g. parameter bounds or concrete
    parameter values baked into the generated code) rationally imply it:
    min of r's expression over the rest is >= 0.  Removal is exact for
    integer scanning: any (integer) point satisfying the rest satisfies
    r.  This is what keeps Fourier–Motzkin projections — and the
    MINI/MAXI bound chains codegen emits from them — from blowing up on
    tiled/wavefronted nests.

    ``max_lp_rows`` bounds the work; beyond it the system is returned
    after syntactic pruning only.
    """
    rows = _prune(list(cons))
    ineq_idx = [i for i, (_, k) in enumerate(rows) if k == ">=0"]
    if len(ineq_idx) > max_lp_rows:
        return rows
    ctx = list(context)
    removed: Set[int] = set()
    # widest rows first: combination rows produced by FM have many terms
    # and are the likeliest to be redundant, and removing them first
    # shrinks later LP systems
    order = sorted(ineq_idx, key=lambda i: (-len(rows[i][0]),
                                            tuple(sorted(map(str, rows[i][0])))))
    for i in order:
        expr, _ = rows[i]
        rest = [rows[j] for j in range(len(rows)) if j != i and j not in removed]
        m = minimum(rest + ctx, expr)   # unbounded sentinel is negative
        if m is not None and m >= 0:
            removed.add(i)
    return [r for j, r in enumerate(rows) if j not in removed]


def bounds_of(cons: Sequence[Constraint], var: str, inner: Sequence[str],
              context: Sequence[Constraint] = (), lp_prune: int = 12):
    """Return (lower_exprs, upper_exprs) for var after eliminating the
    ``inner`` variables. Bounds are affine in the remaining variables:
    lower:  var >= ceil(expr) ;  upper:  var <= floor(expr)
    Each returned as (affine_over_outer, denominator) with
    var >= expr/denom (lower) etc.

    ``context`` rows (known-true at runtime: parameter bounds, concrete
    parameter values) feed LP redundancy pruning whenever an elimination
    leaves more than ``lp_prune`` rows — this is what keeps chained FM
    from exploding on tiled/wavefronted systems (``lp_prune=0``
    disables).
    """
    fault_point("fm.bounds")
    sys = list(cons)
    for v in inner:
        sys = fm_eliminate(sys, v)
        if lp_prune and len(sys) > lp_prune:
            sys = prune_redundant(sys, context)
    if lp_prune and len(sys) > lp_prune:
        sys = prune_redundant(sys, context)
    lowers, uppers = [], []
    for expr, kind in sys:
        kinds = [kind] if kind == ">=0" else [">=0", "<=0"]
        for kk in kinds:
            e = expr if kk == ">=0" else {k: -v for k, v in expr.items()}
            cc = e.get(var, Fraction(0))
            if cc == 0:
                continue
            rest = {k: -v / cc for k, v in e.items() if k != var}
            if cc > 0:
                lowers.append(rest)   # var >= rest
            else:
                uppers.append(rest)   # var <= rest
    return lowers, uppers
