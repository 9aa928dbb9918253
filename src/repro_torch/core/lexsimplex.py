"""Exact rational lexicographic simplex — the default lexmin backend.

The scheduler computes schedules as lexicographic minima of small ILPs
(paper §III-A1).  Solving them with a floating-point MIP solver (HiGHS)
made the *optimum value* reliable but the *optimal vertex* a coin flip:
equally-legal alternate optima were picked depending on row ordering,
warm starts and tolerances, which left ~4/56 kernel×strategy combos
where the seed and incremental pipelines disagreed (ROADMAP residual).
This module removes the float solver from the loop:

* **Fraction-free integer tableau** — the simplex dictionary is kept as
  an integer matrix with one denominator per row (`basic_i = (M[i,0] +
  Σ_j M[i,j+1]·nonbasic_j) / den[i]`).  Pivots are two vectorized
  numpy int64 passes; rows are gcd-normalized after every pivot and the
  whole tableau is promoted to exact Python ints (object dtype) the
  moment an int64 overflow is possible, so arithmetic is always exact.
* **Feasibility** via the single-artificial-variable trick (Chvátal):
  one column, one forced pivot to the most-violated row, then minimize
  the artificial with the ordinary primal loop.
* **Primal simplex** with Dantzig pricing and a deterministic switch to
  Bland's rule after a degenerate streak — finite termination, and every
  choice (entering, leaving, ties) is a pure function of the tableau.
* **Integrality** by bounded depth-first branch & bound on the
  (box-bounded) scheduler variables, exact Fraction bound pruning.
* **Lexmin** runs append-only on one tableau: each stage optimizes from
  the previous stage's basis and appends a single `obj ≤ val` fixing
  row (sound for integer points: `obj ≥ val` is implied by optimality).
  Box-bounded integer suffix stages are collapsed into one exactly
  weighted objective — with exact arithmetic there is no big-M
  tolerance cap, so the scheduler's whole canonical tail is one solve.
* **Canonicalization** — after the caller's objectives, the requested
  ``canon`` variables are minimized lexicographically as final stages
  (folded into the same weighted objective).  This makes the returned
  point *mathematically unique* on the canon variables: any two
  algorithms solving the same problem — the seed pipeline, the
  incremental pipeline, a re-run — return bit-identical schedule
  coefficients.  Determinism is a property of the answer, not of the
  pivot path.

The tableau consumes problems through :class:`repro_torch.core.ilp.ILPProblem`
(which compiles its rational rows into reusable integer arrays, see
``LexCompiled``); it deliberately does not import that module.
"""
from __future__ import annotations

from fractions import Fraction
from math import gcd
from typing import Dict, List, Optional, Tuple

import numpy as np

from .linalg_q import rationals_to_int_row

# recorded in schedule-cache keys: bump when pivoting/canonicalization
# semantics change in a way that can alter returned optima
SOLVER_TAG = "lexsimplex-1"

# promote the tableau to exact Python ints past this magnitude
_I64_GUARD = 1 << 61
# degenerate pivots before switching from Dantzig to Bland pricing
_BLAND_AFTER = 40
# branch & bound safety valve (never reached by scheduler problems)
_BB_NODE_LIMIT = 50_000


class Unbounded(Exception):
    """Objective unbounded below over the feasible region."""


class PivotLimit(Exception):
    """Safety valve tripped (cycling or a runaway branch & bound)."""


# ---------------------------------------------------------------------------
# compiled integer image of an ILPProblem (exact twin of CompiledProblem)
# ---------------------------------------------------------------------------

class LexCompiled:
    """Append-only integer-scaled image of an ILPProblem's vars/cons.

    Each model variable maps to one tableau column (shifted so its lower
    bound is 0) or to a split pair ``x = x⁺ − x⁻`` when free.  Each
    constraint row becomes one (``>=0``) or two (``==0``) integer rows
    ``const + Σ coef·col ≥ 0``; upper bounds become explicit rows.
    ``truncate`` rewinds to an earlier var/row count — the same
    contract :class:`repro_torch.core.ilp.CompiledProblem` has, driven by
    ``ILPProblem.push``/``pop``.
    """

    def __init__(self):
        self.n_vars = 0                    # model vars consumed
        self.n_rows = 0                    # model cons consumed
        self.cols: List[Tuple] = []   # per var: ('one',ent,lb)|('two',entp,entn,ub)
        self.col_names: List[str] = []
        self._name_idx: Dict[str, int] = {}
        self.ent_var: List[Tuple[str, int]] = []  # entity -> (name, +1|-1)
        self.integer: List[bool] = []      # per entity
        self.ub: List[Optional[Fraction]] = []  # per entity (shifted)
        self.rows: List[Tuple[Tuple[int, ...], Tuple[int, ...], int]] = []
        # each row: (entity idx tuple, int coef tuple, int const)
        self._row_marks: List[int] = []    # rows emitted per source con

    @property
    def n_entities(self) -> int:
        return len(self.ent_var)

    def sync(self, prob) -> None:
        names = list(prob.vars)
        for name in names[self.n_vars:]:
            v = prob.vars[name]
            if v.lb is None:
                entp, entn = len(self.ent_var), len(self.ent_var) + 1
                # the model ub rides on the spec: a bound on xp−xn is a
                # general row over both entities, not a per-entity box
                self.cols.append(("two", entp, entn, v.ub))
                self.ent_var.extend([(name, 1), (name, -1)])
                self.integer.extend([v.integer, v.integer])
                self.ub.extend([None, None])
            else:
                if v.integer and v.lb.denominator != 1:
                    raise ValueError(f"integer var {name} has fractional lb")
                ent = len(self.ent_var)
                self.cols.append(("one", ent, v.lb))
                self.ent_var.append((name, 1))
                self.integer.append(v.integer)
                ub = None if v.ub is None else v.ub - v.lb
                if v.integer and ub is not None and ub.denominator != 1:
                    raise ValueError(f"integer var {name} has fractional ub")
                self.ub.append(ub)
            self._name_idx[name] = len(self.col_names)
            self.col_names.append(name)
        self.n_vars = len(names)
        for expr, kind in prob.cons[self.n_rows:]:
            emitted = self._emit(prob, expr, kind)
            self._row_marks.append(emitted)
        self.n_rows = len(prob.cons)

    def _affine_to_row(self, prob, expr) -> Tuple[List[int], List[int], int]:
        idxs: List[int] = []
        coefs: List[Fraction] = []
        const = expr.get(1, Fraction(0))
        order = self._name_idx
        cols = self.cols
        for k, c in expr.items():
            if k == 1 or not c:
                continue
            spec = cols[order[k]]
            if spec[0] == "one":
                if spec[2]:
                    const = const + c * spec[2]   # x = lb + x'
                idxs.append(spec[1])
                coefs.append(c)
            else:
                idxs.extend([spec[1], spec[2]])
                coefs.extend([c, -c])
        ints, den = rationals_to_int_row(coefs + [const])
        return idxs, ints[:-1], ints[-1]

    def _emit(self, prob, expr, kind) -> int:
        idxs, ints, const = self._affine_to_row(prob, expr)
        self.rows.append((tuple(idxs), tuple(ints), const))
        if kind == "==0":
            self.rows.append((tuple(idxs), tuple(-c for c in ints), -const))
            return 2
        return 1

    def truncate(self, n_vars: int, n_rows: int) -> None:
        while self.n_rows > n_rows:
            emitted = self._row_marks.pop()
            del self.rows[len(self.rows) - emitted:]
            self.n_rows -= 1
        while self.n_vars > n_vars:
            spec = self.cols.pop()
            del self._name_idx[self.col_names.pop()]
            drop = 1 if spec[0] == "one" else 2
            del self.ent_var[len(self.ent_var) - drop:]
            del self.integer[len(self.integer) - drop:]
            del self.ub[len(self.ub) - drop:]
            self.n_vars -= 1

    # -- tableau construction ---------------------------------------------
    def tableau(self) -> "Tableau":
        n = self.n_entities
        rows = list(self.rows)
        for ent, ub in enumerate(self.ub):
            if ub is not None:
                # ub = p/q:  q·(ub − x) = p − q·x ≥ 0
                rows.append(((ent,), (-ub.denominator,), ub.numerator))
        for spec in self.cols:
            if spec[0] == "two" and spec[3] is not None:
                ub = spec[3]   # ub − (x⁺ − x⁻) ≥ 0, scaled integer
                rows.append(((spec[1], spec[2]),
                             (-ub.denominator, ub.denominator),
                             ub.numerator))
        m = len(rows)
        M = np.zeros((m, n + 1), dtype=np.int64)
        for i, (idxs, ints, const) in enumerate(rows):
            M[i, 0] = const
            for j, c in zip(idxs, ints):
                M[i, j + 1] += c
        den = np.ones(m, dtype=np.int64)
        return Tableau(self, M, den)


# ---------------------------------------------------------------------------
# the tableau
# ---------------------------------------------------------------------------

class Tableau:
    """Fraction-free simplex dictionary.

    ``M`` has one column per *nonbasic* entity plus the constant column
    0; one row per *basic* entity.  Structural entities are
    ``0..n_struct-1``; slack entities get ids from ``n_struct`` up; the
    phase-1 artificial is entity ``-1`` (never present outside
    ``make_feasible``).  ``row_ent[i]``/``col_ent[j]`` name the basic /
    nonbasic entity of each row / column.  All entities are ≥ 0.
    """

    def __init__(self, comp: LexCompiled, M, den):
        self.comp = comp
        self.M = M
        self.den = den
        n = comp.n_entities
        self.row_ent = list(range(n, n + M.shape[0]))
        self.col_ent = list(range(n))
        self.next_slack = n + M.shape[0]
        self.obj: List[Tuple[np.ndarray, int]] = []
        # shared (not copied) across B&B child tableaus, so the count
        # covers the whole solve tree — both for reporting and for the
        # pivot-limit safety valve
        self._stats = {"pivots": 0}

    @property
    def pivots(self) -> int:
        return self._stats["pivots"]

    def copy(self) -> "Tableau":
        t = object.__new__(Tableau)
        t.comp = self.comp
        t.M = self.M.copy()
        t.den = self.den.copy()
        t.row_ent = list(self.row_ent)
        t.col_ent = list(self.col_ent)
        t.next_slack = self.next_slack
        t.obj = [(z.copy(), zd) for z, zd in self.obj]
        t._stats = self._stats
        return t

    # -- exact arithmetic helpers -----------------------------------------
    def _promote(self) -> None:
        if self.M.dtype == object:
            return
        self.M = self.M.astype(object)
        self.den = self.den.astype(object)

    def _reduce_rows(self, rows=None) -> None:
        M, den = self.M, self.den
        if M.dtype == object:
            it = range(M.shape[0]) if rows is None else rows
            for i in it:
                g = int(den[i])
                for v in M[i]:
                    g = gcd(g, abs(int(v)))
                    if g == 1:
                        break
                if g > 1:
                    M[i] //= g
                    den[i] //= g
            return
        g = np.gcd.reduce(np.abs(M), axis=1)
        g = np.gcd(g, np.abs(self.den))
        mask = g > 1
        if mask.any():
            M[mask] //= g[mask, None]
            den[mask] //= g[mask]

    def _pivot(self, r: int, jc: int) -> None:
        self._stats["pivots"] += 1
        M, den = self.M, self.den
        a = int(M[r, jc + 1])
        dr = int(den[r])
        assert a != 0
        if M.dtype != object:
            mx = int(np.abs(M).max(initial=0))
            mxd = int(np.abs(den).max(initial=0))
            col_mx = int(np.abs(M[:, jc + 1]).max(initial=0))
            row_mx = int(np.abs(M[r]).max(initial=0))
            if (abs(a) * mx + col_mx * row_mx > _I64_GUARD
                    or col_mx * dr > _I64_GUARD
                    or abs(a) * mxd > _I64_GUARD):
                self._promote()
                M, den = self.M, self.den
        Mr = M[r].copy()
        col = M[:, jc + 1].copy()
        M *= a
        M -= np.outer(col, Mr)
        M[:, jc + 1] = col * dr
        newr = -Mr
        newr[jc + 1] = dr
        M[r] = newr
        den *= a
        den[r] = a
        if a < 0:            # every denominator carries a's sign: flip
            M *= -1
            den *= -1
        # objective rows transform like ordinary rows
        for oi, (z, zd) in enumerate(self.obj):
            if z.dtype != object and (
                    abs(a) * int(np.abs(z).max(initial=0))
                    + abs(int(z[jc + 1])) * int(np.abs(Mr).max(initial=0))
                    > _I64_GUARD or abs(a) * abs(zd) > _I64_GUARD):
                z = z.astype(object)
            B = z[jc + 1]
            z2 = z * a - B * Mr.astype(z.dtype, copy=False)
            z2[jc + 1] = B * dr
            zd2 = zd * a
            if zd2 < 0:
                z2, zd2 = -z2, -zd2
            g = int(abs(zd2))
            for v in z2:
                g = gcd(g, abs(int(v)))
                if g == 1:
                    break
            if g > 1:
                z2 //= g
                zd2 //= g
            self.obj[oi] = (z2, int(zd2))
        self.row_ent[r], self.col_ent[jc] = self.col_ent[jc], self.row_ent[r]
        self._reduce_rows()

    # -- queries -----------------------------------------------------------
    def value_of(self, ent: int) -> Fraction:
        try:
            i = self.row_ent.index(ent)
        except ValueError:
            return Fraction(0)
        return Fraction(int(self.M[i, 0]), int(self.den[i]))

    def entity_values(self) -> Dict[int, Fraction]:
        out = {ent: Fraction(0) for ent in range(self.comp.n_entities)}
        for i, ent in enumerate(self.row_ent):
            if ent < self.comp.n_entities:
                out[ent] = Fraction(int(self.M[i, 0]), int(self.den[i]))
        return out

    def solution(self) -> Dict[str, Fraction]:
        vals = self.entity_values()
        out: Dict[str, Fraction] = {}
        for name, spec in zip(self.comp.col_names, self.comp.cols):
            if spec[0] == "one":
                _, ent, lb = spec
                out[name] = lb + vals[ent]
            else:
                out[name] = vals[spec[1]] - vals[spec[2]]
        return out

    # -- row / objective construction --------------------------------------
    def _express(self, coefs: Dict[int, Fraction], const: Fraction):
        """An affine form over entities, rewritten over the current
        nonbasic columns: returns (int vector len ncols+1, den)."""
        ncols = self.M.shape[1] - 1
        vec = [const] + [Fraction(0)] * ncols
        col_of = {e: j for j, e in enumerate(self.col_ent)}
        row_of = {e: i for i, e in enumerate(self.row_ent)}
        for ent, c in coefs.items():
            if not c:
                continue
            j = col_of.get(ent)
            if j is not None:
                vec[j + 1] += c
                continue
            i = row_of[ent]
            f = c / int(self.den[i])
            row = self.M[i]
            for l in range(ncols + 1):
                v = int(row[l])
                if v:
                    vec[l] += f * v
        return rationals_to_int_row(vec)

    def append_row(self, coefs: Dict[int, Fraction], const: Fraction) -> int:
        ints, den = self._express(coefs, const)
        if den > _I64_GUARD or any(abs(v) > _I64_GUARD for v in ints):
            self._promote()
        arr = np.asarray(ints, dtype=object)
        if self.M.dtype != object:
            arr = arr.astype(np.int64)
        self.M = np.vstack([self.M, arr[None, :]])
        self.den = np.append(self.den, np.asarray([den], dtype=self.den.dtype))
        ent = self.next_slack
        self.next_slack += 1
        self.row_ent.append(ent)
        return ent

    def push_objective(self, coefs: Dict[int, Fraction],
                       const: Fraction = Fraction(0)) -> None:
        ints, den = self._express(coefs, const)
        arr = np.asarray(ints, dtype=object)
        try:
            arr = arr.astype(np.int64)
        except OverflowError:
            pass
        self.obj.append((arr, den))

    def pop_objective(self) -> None:
        self.obj.pop()

    def objective_value(self) -> Fraction:
        z, zd = self.obj[-1]
        return Fraction(int(z[0]), int(zd))

    # -- simplex loops ------------------------------------------------------
    def _leave_for(self, jc: int) -> Optional[int]:
        """Primal ratio test for entering column jc: the leaving row
        keeping all basic values ≥ 0, exact, ties by smallest entity.

        A float pass pre-filters the candidates (generous tolerance so
        the true minimum can never be excluded); the winner among the
        survivors is chosen by exact cross-multiplication, so the result
        is identical to a fully exact scan."""
        col = self.M[:, jc + 1]
        cand = np.flatnonzero(col < 0)
        if cand.size == 0:
            return None
        if cand.size > 8 and self.M.dtype != object:
            num = self.M[cand, 0].astype(np.float64)
            denom = (-col[cand]).astype(np.float64)
            rat = num / denom
            m = rat.min()
            cand = cand[rat <= m + abs(m) * 1e-6 + 1e-9]
        best = None
        bn = bd = 0
        for i in cand:
            i = int(i)
            n, d = int(self.M[i, 0]), -int(col[i])
            if best is None or n * bd < bn * d or (
                    n * bd == bn * d and self.row_ent[i] < self.row_ent[best]):
                best, bn, bd = i, n, d
        return best

    def optimize(self) -> Fraction:
        """Minimize the top objective from the current (feasible) basis."""
        degen = 0
        while True:
            z, zd = self.obj[-1]
            neg = np.flatnonzero(z[1:] < 0)
            if neg.size == 0:
                return Fraction(int(z[0]), int(zd))
            if degen > _BLAND_AFTER:
                jc = min((int(j) for j in neg),
                         key=lambda j: self.col_ent[j])
            else:
                vals = z[1:][neg]
                jc = min((int(j) for j in neg[vals == vals.min()]),
                         key=lambda j: self.col_ent[j])
            r = self._leave_for(jc)
            if r is None:
                raise Unbounded()
            degen = degen + 1 if int(self.M[r, 0]) == 0 else 0
            self._pivot(r, jc)
            if self.pivots > 200_000:
                raise PivotLimit("primal simplex pivot limit")

    def make_feasible(self) -> bool:
        """Restore ``basic ≥ 0`` via the single artificial variable."""
        M = self.M
        if M.shape[0] == 0 or bool((M[:, 0] >= 0).all()):
            return True
        # append the artificial column: every basic row gains +x0
        x0col = M.shape[1] - 1
        self.M = np.hstack([M, self.den[:, None].copy()])
        self.col_ent.append(-1)
        self.obj = [(np.append(z, np.zeros(1, dtype=z.dtype)), zd)
                    for z, zd in self.obj]
        # forced pivot: most violated row (exact min of const/den)
        cand = np.flatnonzero(self.M[:, 0] < 0)
        best = None
        bn = bd = 0
        for i in cand:
            i = int(i)
            n, d = int(self.M[i, 0]), int(self.den[i])
            if best is None or n * bd < bn * d or (
                    n * bd == bn * d and self.row_ent[i] < self.row_ent[best]):
                best, bn, bd = i, n, d
        self._pivot(best, x0col)
        self.push_objective({-1: Fraction(1)})
        try:
            val = self.optimize()
        finally:
            self.pop_objective()
        feasible = val == 0
        # drive x0 out of the basis if it parked there at value 0
        if feasible and -1 in self.row_ent:
            r = self.row_ent.index(-1)
            row = self.M[r]
            piv = None
            for j in range(self.M.shape[1] - 1):
                if int(row[j + 1]) != 0 and self.col_ent[j] != -1:
                    if piv is None or self.col_ent[j] < self.col_ent[piv]:
                        piv = j
            if piv is None:
                self.M = np.delete(self.M, r, axis=0)
                self.den = np.delete(self.den, r)
                self.row_ent.pop(r)
            else:
                self._pivot(r, piv)
        if -1 in self.col_ent:
            j = self.col_ent.index(-1)
            self.M = np.delete(self.M, j + 1, axis=1)
            self.col_ent.pop(j)
            self.obj = [(np.delete(z, j + 1), zd) for z, zd in self.obj]
        return feasible


# ---------------------------------------------------------------------------
# branch & bound
# ---------------------------------------------------------------------------

def _first_fractional(tab: Tableau) -> Optional[Tuple[int, Fraction]]:
    """Smallest-id structural integer entity with a fractional value
    (nonbasic entities sit at 0 and are always integral)."""
    comp = tab.comp
    best = None
    for i, ent in enumerate(tab.row_ent):
        if (ent < comp.n_entities and comp.integer[ent]
                and (best is None or ent < best[0])):
            v = Fraction(int(tab.M[i, 0]), int(tab.den[i]))
            if v.denominator != 1:
                best = (ent, v)
    return best


def ilp_min(tab: Tableau, coefs: Dict[int, Fraction],
            const: Fraction = Fraction(0)):
    """Exact integer minimum of an affine objective over the tableau's
    region.  Returns ``(value, entity_values)`` or ``None`` (infeasible).
    The root tableau is left at its *LP-relaxation* optimum (callers
    append a fixing row and re-repair).  Deterministic: DFS, ≤-branch
    first, smallest fractional entity, exact bound pruning."""
    if not tab.make_feasible():
        return None
    tab.push_objective(coefs, const)
    try:
        root_val = tab.optimize()
    except Unbounded:
        tab.pop_objective()
        raise
    frac = _first_fractional(tab)
    if frac is None:
        vals = tab.entity_values()
        tab.pop_objective()
        return root_val, vals
    best: Optional[Tuple[Fraction, Dict[int, Fraction]]] = None
    stack = [(tab.copy(), root_val)]
    tab.pop_objective()
    nodes = 0
    while stack:
        t, bound = stack.pop()
        if best is not None and bound >= best[0]:
            continue
        frac = _first_fractional(t)
        if frac is None:
            val = t.objective_value()
            if best is None or val < best[0]:
                best = (val, t.entity_values())
            continue
        nodes += 1
        if nodes > _BB_NODE_LIMIT:
            raise PivotLimit("branch & bound node limit")
        ent, v = frac
        fl = v.numerator // v.denominator
        children = []
        right = t.copy()
        right.append_row({ent: Fraction(1)}, Fraction(-(fl + 1)))  # x ≥ fl+1
        children.append(right)
        left = t
        left.append_row({ent: Fraction(-1)}, Fraction(fl))         # x ≤ fl
        children.append(left)
        for child in children:   # left pushed last → explored first
            if not child.make_feasible():
                continue
            try:
                cv = child.optimize()
            except Unbounded:     # cannot happen under a bounded root
                continue
            if best is None or cv < best[0]:
                stack.append((child, cv))
    if best is None:
        return None
    return best


# ---------------------------------------------------------------------------
# the ILPProblem-facing API
# ---------------------------------------------------------------------------

def _entity_objective(comp: LexCompiled, objective) -> Tuple[Dict[int, Fraction], Fraction]:
    order = comp._name_idx
    coefs: Dict[int, Fraction] = {}
    const = Fraction(objective.get(1, 0))
    for k, c in objective.items():
        if k == 1 or not c:
            continue
        spec = comp.cols[order[k]]
        if spec[0] == "one":
            _, ent, lb = spec
            const += c * lb
            coefs[ent] = coefs.get(ent, Fraction(0)) + c
        else:
            entp, entn = spec[1], spec[2]
            coefs[entp] = coefs.get(entp, Fraction(0)) + c
            coefs[entn] = coefs.get(entn, Fraction(0)) - c
    return coefs, const


def _solution_from_entities(comp: LexCompiled, vals: Dict[int, Fraction],
                            names=None) -> Dict[str, Fraction]:
    out: Dict[str, Fraction] = {}
    order = comp._name_idx
    for name in (comp.col_names if names is None else names):
        spec = comp.cols[order[name]]
        if spec[0] == "one":
            _, ent, lb = spec
            out[name] = lb + vals.get(ent, Fraction(0))
        else:
            entp, entn = spec[1], spec[2]
            out[name] = vals.get(entp, Fraction(0)) - vals.get(entn, Fraction(0))
    return out


def _compiled(prob) -> LexCompiled:
    comp = getattr(prob, "_lex", None)
    if comp is None:
        comp = prob._lex = LexCompiled()
    comp.sync(prob)
    return comp


def solve_min(prob, objective, want=None):
    """Exact integer minimum of one objective (ILPProblem entry point).
    Returns ``(value, solution)`` or None; raises Unbounded."""
    comp = _compiled(prob)
    tab = comp.tableau()
    coefs, const = _entity_objective(comp, objective)
    res = ilp_min(tab, coefs, const)
    prob.last_pivots = getattr(prob, "last_pivots", 0) + tab.pivots
    if res is None:
        return None
    val, vals = res
    names = None
    if want is not None:
        names = {k for k in objective if k != 1}
        names.update(k for k in want if k in prob.vars)
    return val, _solution_from_entities(comp, vals, names)


def _stage_box(prob, obj):
    lo = hi = Fraction(obj.get(1, 0))
    for k, c in obj.items():
        if k == 1 or not c:
            continue
        v = prob.vars[k]
        lo += c * (v.lb if c > 0 else v.ub)
        hi += c * (v.ub if c > 0 else v.lb)
    return lo, hi


def _combinable(prob, obj) -> bool:
    for k, c in obj.items():
        if k == 1 or not c:
            continue
        if c.denominator != 1:
            return False
        v = prob.vars[k]
        if (not v.integer or v.lb is None or v.ub is None
                or v.lb.denominator != 1 or v.ub.denominator != 1):
            return False
    return True


def _combine_suffix(prob, stages):
    """Collapse the maximal all-integer box-bounded suffix of ``stages``
    into one exactly weighted objective (no weight cap: arithmetic is
    exact, so the weights may grow as large as the boxes require)."""
    n = len(stages)
    if n < 2 or not _combinable(prob, stages[-1]):
        return list(stages), None
    combined = dict(stages[-1])
    clo, chi = _stage_box(prob, combined)
    first = n - 1
    while first > 0 and _combinable(prob, stages[first - 1]):
        w = chi - clo + 1
        stage = stages[first - 1]
        slo, shi = _stage_box(prob, stage)
        for k, c in stage.items():
            combined[k] = combined.get(k, Fraction(0)) + w * c
        clo, chi = w * slo + clo, w * shi + chi
        first -= 1
    if first == n - 1:
        return list(stages), None
    return list(stages[:first]), combined


def lexmin(prob, objectives, want=None, canon=None):
    """Exact lexicographic minimization with a canonical tie-break.

    ``canon`` lists variables whose values must be reproducible across
    *any* solver run: after the caller's objectives they are minimized
    lexicographically in the given order, which makes the optimum unique
    on those variables.  ``None`` canonicalizes every box-bounded
    integer variable in declaration order.  ``want`` limits which
    variables are materialized in the returned dict (plus objective and
    canon variables)."""
    comp = _compiled(prob)
    tab = comp.tableau()
    objectives = list(objectives) if objectives else [{}]
    if canon is None:
        canon = [n for n, v in prob.vars.items()
                 if v.integer and v.lb is not None and v.ub is not None]
    canon = [v for v in canon if v in prob.vars]
    stages = [dict(o) for o in objectives]
    stages += [{v: Fraction(1)} for v in canon]
    head, combined = _combine_suffix(prob, stages)
    seq = head + ([combined] if combined is not None else [])
    prob.stages_skipped = 0
    cur: Optional[Dict[int, Fraction]] = None

    def value_at(obj, vals):
        coefs, const = _entity_objective(comp, obj)
        v = const
        for ent, c in coefs.items():
            v += c * vals.get(ent, Fraction(0))
        return v

    for si, obj in enumerate(seq):
        last = si == len(seq) - 1
        coefs, const = _entity_objective(comp, obj)
        val = None
        if cur is not None:
            bound = prob._objective_lower_bound(obj)
            if bound is not None and value_at(obj, cur) == bound:
                val = bound
                prob.stages_skipped += 1
        if val is None:
            res = ilp_min(tab, coefs, const)
            if res is None:
                # later stages keep the previous optimum feasible (its
                # fixing row holds with equality) — only stage 0 can be
                # genuinely infeasible
                prob.last_pivots = getattr(prob, "last_pivots", 0) + tab.pivots
                return None
            val, cur = res
        if not last:
            # fix this stage: obj ≤ val (obj ≥ val implied by optimality
            # for every integer point — the one-sided row keeps the
            # dictionary small and never cuts the incumbent)
            tab.append_row({e: -c for e, c in coefs.items()}, val - const)
    prob.last_pivots = getattr(prob, "last_pivots", 0) + tab.pivots
    names = None
    if want is not None:
        names = set(canon)
        names.update(k for k in want if k in prob.vars)
        for obj in objectives:
            names.update(k for k in obj if k != 1)
    return _solution_from_entities(comp, cur, names)
