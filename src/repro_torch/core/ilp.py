"""(I)LP solving for the scheduler.

Two engines:

* ``lex`` (default; ``exact`` is an alias) — the exact rational
  lexicographic simplex in :mod:`repro_torch.core.lexsimplex`: fraction-free
  integer tableau, branch & bound on the integer variables, and a
  canonicalizing lexmin whose optimum is *mathematically unique* on the
  schedule coefficients.  Every schedule is bit-reproducible: the seed
  pipeline, the incremental pipeline and repeat runs return identical
  coefficients, which is what the golden-schedule CI gate asserts.
* ``highs`` — scipy.optimize.linprog(method='highs'), a floating-point
  branch-and-cut MILP.  Kept as an opt-in cross-check oracle (the
  hypothesis tests solve random ILPs with both engines) and as the
  pruning/query backend for :mod:`repro_torch.core.polyhedron`, where rational
  relaxations are cheap and a wrong vertex cannot change a schedule.

Both are wrapped by :class:`ILPProblem`, which exposes the lexicographic
multi-objective minimization the paper relies on (Section III-A1: cost
functions are "minimized in lexicographic order").

All problem data is rational; solutions are returned as Fractions with
integer variables snapped exactly.

Incremental core (the compile-time hot path)
--------------------------------------------

The scheduler solves *one* constraint system under many objectives:
each lexicographic stage only appends a single objective-fixing row.

* :class:`CompiledProblem` keeps the constraint system as growing
  CSR-style ``(indptr, indices, data)`` triplets with a stable variable
  index; Fraction→float conversion happens exactly once per row (highs
  engine).  :class:`repro_torch.core.lexsimplex.LexCompiled` is its exact
  twin: integer-scaled rows reused across lexmins (lex engine).
* ``lexmin`` runs append-only: fixing rows are appended per stage on
  one live model/tableau; ``push()``/``pop()`` rewind both the exact
  constraint list and the compiled images.
* Warm-start stage skipping: when the previous stage's solution already
  attains the objective's lower bound implied by variable bounds, the
  stage is provably optimal there and the solve is skipped.

``ILPProblem(..., incremental=False)`` preserves the seed clone+dense
pipeline for benchmarking and differential tests; under the ``lex``
engine both modes share the per-lexmin tableau (the incremental flag
then only controls the *scheduler-level* reuse: Farkas memoization,
per-band base problems, compiled dependence polyhedra).
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .affine import Affine
from . import lexsimplex
from .lexsimplex import SOLVER_TAG, Unbounded  # re-exported  # noqa: F401

INF = float("inf")


@dataclass
class _Var:
    name: str
    lb: Optional[Fraction]
    ub: Optional[Fraction]
    integer: bool


class CompiledProblem:
    """Append-only numeric (float/CSR) image of an :class:`ILPProblem`
    for the highs engine.

    ``>=0`` rows are stored negated as ``A_ub · x <= b_ub`` and ``==0``
    rows as ``A_eq · x = b_eq`` — exactly the layout scipy's linprog
    consumes, so a solve is triplet→csr_matrix + one HiGHS call with no
    per-row Python work.  ``truncate`` rewinds to an earlier row/var
    count (lexmin fixing rows, temporary feasibility probes).
    """

    def __init__(self):
        self.names: List[str] = []
        self.idx: Dict[str, int] = {}
        self.lb: List[float] = []
        self.ub: List[float] = []
        self.integrality: List[int] = []
        self.kinds: List[str] = []          # source-row kinds, append order
        self.ub_indptr: List[int] = [0]
        self.ub_indices: List[int] = []
        self.ub_data: List[float] = []
        self.ub_rhs: List[float] = []
        self.eq_indptr: List[int] = [0]
        self.eq_indices: List[int] = []
        self.eq_data: List[float] = []
        self.eq_rhs: List[float] = []

    @property
    def n_vars(self) -> int:
        return len(self.names)

    @property
    def n_rows(self) -> int:
        return len(self.kinds)

    def add_var(self, name: str, lb, ub, integer: bool) -> None:
        self.idx[name] = len(self.names)
        self.names.append(name)
        self.lb.append(-INF if lb is None else float(lb))
        self.ub.append(INF if ub is None else float(ub))
        self.integrality.append(1 if integer else 0)

    def add_cons_batch(self, rows) -> None:
        """Append many constraint rows with one batched Fraction→float
        conversion (see ``linalg_q.fractions_to_float_array``)."""
        from .linalg_q import fractions_to_float_array

        flat = []
        meta = []
        for expr, kind in rows:
            cols = []
            for k, v in expr.items():
                if k != 1 and v:
                    cols.append(self.idx[k])
                    flat.append(v)
            flat.append(expr.get(1, 0))
            meta.append((kind, cols))
        arr = fractions_to_float_array(flat)
        pos = 0
        for kind, cols in meta:
            n = len(cols)
            coefs = arr[pos:pos + n]
            const = float(arr[pos + n])
            pos += n + 1
            if kind == ">=0":   # row·x + const >= 0  →  -row·x <= const
                self.ub_indices.extend(cols)
                self.ub_data.extend((-coefs).tolist())
                self.ub_indptr.append(len(self.ub_indices))
                self.ub_rhs.append(const)
            else:
                self.eq_indices.extend(cols)
                self.eq_data.extend(coefs.tolist())
                self.eq_indptr.append(len(self.eq_indices))
                self.eq_rhs.append(-const)
            self.kinds.append(kind)

    def truncate(self, n_vars: int, n_rows: int) -> None:
        while len(self.kinds) > n_rows:
            kind = self.kinds.pop()
            if kind == ">=0":
                self.ub_indptr.pop()
                nz = self.ub_indptr[-1]
                del self.ub_indices[nz:]
                del self.ub_data[nz:]
                self.ub_rhs.pop()
            else:
                self.eq_indptr.pop()
                nz = self.eq_indptr[-1]
                del self.eq_indices[nz:]
                del self.eq_data[nz:]
                self.eq_rhs.pop()
        while len(self.names) > n_vars:
            del self.idx[self.names.pop()]
            self.lb.pop()
            self.ub.pop()
            self.integrality.pop()

    def linprog(self, objective: Affine):
        """One scipy HiGHS call over the compiled arrays. Returns the raw
        scipy result (caller interprets status / converts to exact).

        Goes straight to ``_linprog_highs`` (the exact backend that
        ``linprog(method='highs')`` dispatches to, with the same solver
        and status mapping) — the public wrapper re-validates and
        re-canonicalizes every input on every call, which dominates solve
        time for the scheduler's many small problems.  Falls back to the
        public API if the private one ever changes shape."""
        import numpy as np
        from scipy.optimize import OptimizeResult
        from scipy.sparse import csr_matrix

        n = len(self.names)
        c = np.zeros(n)
        for k, v in objective.items():
            if k != 1:
                c[self.idx[k]] = float(v)
        a_ub = csr_matrix(
            (self.ub_data, self.ub_indices, self.ub_indptr),
            shape=(len(self.ub_rhs), n),
        )
        b_ub = np.asarray(self.ub_rhs, dtype=float)
        a_eq = csr_matrix(
            (self.eq_data, self.eq_indices, self.eq_indptr),
            shape=(len(self.eq_rhs), n),
        )
        b_eq = np.asarray(self.eq_rhs, dtype=float)
        bounds = np.column_stack([self.lb, self.ub])
        integrality = np.asarray(self.integrality)
        if not integrality.any():
            integrality = None
        try:
            from scipy.optimize._linprog_highs import _linprog_highs
            from scipy.optimize._linprog_util import _LPProblem

            lp = _LPProblem(c, a_ub, b_ub, a_eq, b_eq, bounds, None,
                            integrality)
            return OptimizeResult(_linprog_highs(lp, solver=None))
        except (ImportError, TypeError):  # private API moved: public path
            from scipy.optimize import linprog

            return linprog(
                c,
                A_ub=a_ub if len(b_ub) else None,
                b_ub=b_ub if len(b_ub) else None,
                A_eq=a_eq if len(b_eq) else None,
                b_eq=b_eq if len(b_eq) else None,
                bounds=bounds if n else None,
                integrality=integrality,
                method="highs",
            )


class ILPProblem:
    """An ILP over named variables with affine constraints.

    Constraints are Affine dicts ({var: coeff, 1: const}) with kind
    '>=0' or '==0'.
    """

    def __init__(self, engine: str = "lex", incremental: bool = True):
        if engine == "exact":
            engine = "lex"
        self.vars: Dict[str, _Var] = {}
        self.cons: List[tuple[Affine, str]] = []
        self.engine = engine
        self.incremental = incremental
        self.stages_skipped = 0     # warm-skipped stages of the last lexmin
        self.last_pivots = 0        # exact-simplex pivots accumulated
        self._compiled: Optional[CompiledProblem] = None
        self._lex: Optional[lexsimplex.LexCompiled] = None

    # -- model building ---------------------------------------------------
    def var(self, name: str, lb=0, ub=None, integer: bool = True) -> str:
        if name in self.vars:
            raise ValueError(f"duplicate var {name}")
        self.vars[name] = _Var(
            name,
            None if lb is None else Fraction(lb),
            None if ub is None else Fraction(ub),
            integer,
        )
        return name

    def ensure_var(self, name: str, lb=0, ub=None, integer: bool = True) -> str:
        if name not in self.vars:
            self.var(name, lb, ub, integer)
        return name

    def add(self, expr: Affine, kind: str = ">=0") -> None:
        assert kind in (">=0", "==0"), kind
        for k in expr:
            if k != 1 and k not in self.vars:
                raise KeyError(f"unknown var {k!r} in constraint")
        self.cons.append((dict(expr), kind))

    def clone(self) -> "ILPProblem":
        p = ILPProblem(self.engine, self.incremental)
        p.vars = {k: _Var(v.name, v.lb, v.ub, v.integer) for k, v in self.vars.items()}
        p.cons = [(dict(e), k) for e, k in self.cons]
        return p

    # -- incremental state -------------------------------------------------
    def _compile(self) -> CompiledProblem:
        """Sync the compiled float image with vars/cons added since the
        last call (highs engine)."""
        c = self._compiled
        if c is None:
            c = self._compiled = CompiledProblem()
        if c.n_vars < len(self.vars):
            names = list(self.vars)
            for name in names[c.n_vars:]:
                v = self.vars[name]
                c.add_var(name, v.lb, v.ub, v.integer)
        pending = self.cons[c.n_rows:]
        if pending:
            c.add_cons_batch(pending)
        return c

    def push(self) -> Tuple[int, int]:
        """Mark the model; :meth:`pop` rewinds vars/cons added after."""
        return (len(self.vars), len(self.cons))

    def pop(self, mark: Tuple[int, int]) -> None:
        n_vars, n_cons = mark
        del self.cons[n_cons:]
        if len(self.vars) > n_vars:
            for name in list(self.vars)[n_vars:]:
                del self.vars[name]
        if self._compiled is not None:
            self._compiled.truncate(n_vars, n_cons)
        if self._lex is not None:
            self._lex.truncate(n_vars, n_cons)

    # -- solving -----------------------------------------------------------
    def _order(self) -> List[str]:
        return list(self.vars)

    def solve_min(self, objective: Affine, want=None) -> Optional[tuple[Fraction, Dict[str, Fraction]]]:
        """Minimize one objective. Returns (value, solution) or None if
        infeasible. Raises Unbounded if unbounded.

        ``want``: iterable of variable names to materialize in the
        returned solution, in addition to the objective's own variables.
        ``None`` converts everything."""
        if self.engine == "lex":
            return lexsimplex.solve_min(self, objective, want)
        if self.incremental:
            return _highs_solve_compiled(self, objective, want)
        return _highs_solve(self, objective)

    def _objective_lower_bound(self, objective: Affine) -> Optional[Fraction]:
        """Lower bound of the objective implied by variable bounds alone,
        or None when some needed bound is missing (unbounded side)."""
        lb = objective.get(1, Fraction(0))
        for k, c in objective.items():
            if k == 1 or c == 0:
                continue
            v = self.vars[k]
            b = v.lb if c > 0 else v.ub
            if b is None:
                return None
            lb += c * b
        return lb

    def lexmin(self, objectives: Sequence[Affine], want=None,
               canon=None) -> Optional[Dict[str, Fraction]]:
        """Lexicographic minimization: minimize objectives[0], fix its
        value, then objectives[1], ... Returns the final solution.

        Under the ``lex`` engine this is exact and *canonical*: after
        the given objectives, the ``canon`` variables (default: every
        box-bounded integer variable, in declaration order) are
        minimized lexicographically, so the returned values of those
        variables are a pure function of the mathematical problem —
        identical across the seed path, the incremental path and repeat
        runs.  ``want`` limits solution materialization as in
        :meth:`solve_min`."""
        if self.engine == "lex":
            return lexsimplex.lexmin(self, objectives, want=want, canon=canon)
        if not self.incremental:
            return self._lexmin_cloned(objectives)
        if not objectives:
            objectives = [{}]
        if want is not None:
            want = set(want)
            for obj in objectives:
                want.update(k for k in obj if k != 1)
        mark = self.push()
        try:
            self.stages_skipped = 0
            sol: Optional[Dict[str, Fraction]] = None
            for obj in objectives:
                val: Optional[Fraction] = None
                if sol is not None:
                    bound = self._objective_lower_bound(obj)
                    if bound is not None:
                        cur = obj.get(1, Fraction(0))
                        for k, c in obj.items():
                            if k != 1:
                                cur += c * sol[k]
                        if cur == bound:
                            val = cur   # provably optimal: skip the solve
                            self.stages_skipped += 1
                if val is None:
                    res = self.solve_min(obj, want)
                    if res is None:
                        return None
                    val, sol = res
                # fix this objective at its optimum before the next stage
                fixed = {k: -c for k, c in obj.items()}
                fixed[1] = fixed.get(1, Fraction(0)) + val
                self.add(fixed, ">=0")
            return sol
        finally:
            self.pop(mark)

    def _lexmin_cloned(self, objectives: Sequence[Affine]) -> Optional[Dict[str, Fraction]]:
        """The seed clone-per-lexmin path (kept for benchmarking the
        highs engine; the lex engine handles both modes above)."""
        prob = self.clone()
        sol: Optional[Dict[str, Fraction]] = None
        if not objectives:
            objectives = [{}]
        for obj in objectives:
            res = prob.solve_min(obj)
            if res is None:
                return None
            val, sol = res
            fixed = {k: -c for k, c in obj.items()}
            fixed[1] = fixed.get(1, Fraction(0)) + val
            prob.add(fixed, ">=0")
        return sol

    def feasible(self) -> bool:
        return self.solve_min({}, want=()) is not None


def stage_values(stages: Sequence[Affine], sol: Dict[str, Fraction]
                 ) -> List[Fraction]:
    """Exact value of each lexicographic objective stage at ``sol``.

    ``lexmin(want=...)`` always materializes the objectives' own
    variables, so the returned solution is sufficient to evaluate every
    stage — this is the engine-agnostic ground truth the differential
    tests compare between the exact core and the HiGHS oracle (two
    engines may pick different alternate optima, but the stage values of
    a lexicographic optimum are unique)."""
    out: List[Fraction] = []
    for obj in stages:
        v = Fraction(obj.get(1, 0))
        for k, c in obj.items():
            if k != 1:
                v += Fraction(c) * sol[k]
        out.append(v)
    return out


# ---------------------------------------------------------------------------
# HiGHS engine (scipy) — opt-in cross-check / polyhedron-query backend
# ---------------------------------------------------------------------------

def _highs_solve(prob: ILPProblem, objective: Affine):
    import numpy as np
    from scipy.optimize import linprog

    names = prob._order()
    idx = {n: i for i, n in enumerate(names)}
    n = len(names)
    c = np.zeros(n)
    for k, v in objective.items():
        if k != 1:
            c[idx[k]] = float(v)
    a_ub, b_ub, a_eq, b_eq = [], [], [], []
    for expr, kind in prob.cons:
        row = np.zeros(n)
        for k, v in expr.items():
            if k != 1:
                row[idx[k]] = float(v)
        const = float(expr.get(1, 0))
        if kind == ">=0":  # row·x + const >= 0  →  -row·x <= const
            a_ub.append(-row)
            b_ub.append(const)
        else:
            a_eq.append(row)
            b_eq.append(-const)
    bounds = []
    integrality = np.zeros(n)
    for i, name in enumerate(names):
        v = prob.vars[name]
        bounds.append(
            (None if v.lb is None else float(v.lb), None if v.ub is None else float(v.ub))
        )
        integrality[i] = 1 if v.integer else 0
    res = linprog(
        c,
        A_ub=np.array(a_ub) if a_ub else None,
        b_ub=np.array(b_ub) if b_ub else None,
        A_eq=np.array(a_eq) if a_eq else None,
        b_eq=np.array(b_eq) if b_eq else None,
        bounds=bounds,
        integrality=integrality if integrality.any() else None,
        method="highs",
    )
    return _interpret_highs(prob, res, objective, None, names, idx)


def _highs_solve_compiled(prob: ILPProblem, objective: Affine, want=None):
    """Incremental-path twin of :func:`_highs_solve`: the constraint
    matrices come from the cached :class:`CompiledProblem` arrays and
    only the requested variables (``want`` + objective vars; None = all)
    are converted to Fractions."""
    comp = prob._compile()
    res = comp.linprog(objective)
    return _interpret_highs(prob, res, objective, want, comp.names, comp.idx)


def _point_valid(prob, names, x, tol: float = 1e-6) -> bool:
    """Float-level residual/bounds/integrality check of a HiGHS point.
    HiGHS can report an invalid point as optimal (MIP fixing-row chains,
    ill-scaled rational relaxations); an invalid point is re-solved with
    the exact engine rather than silently accepted — the polyhedron
    query layer is pinned to ``highs`` and must never abort a
    compilation over a tolerance hiccup.  (The float-era *scheduling*
    recovery — incumbent pinning on mis-reported lexmin infeasibility —
    stays deleted: the schedule path defaults to the exact engine.)"""
    idx = {n: i for i, n in enumerate(names)}
    for expr, kind in prob.cons:
        v = float(expr.get(1, 0))
        scale = 1.0 + abs(v)
        for k, c in expr.items():
            if k != 1:
                v += float(c) * x[idx[k]]
        if kind == ">=0" and v < -tol * scale:
            return False
        if kind == "==0" and abs(v) > tol * scale:
            return False
    for i, name in enumerate(names):
        var = prob.vars[name]
        if var.lb is not None and x[i] < float(var.lb) - tol:
            return False
        if var.ub is not None and x[i] > float(var.ub) + tol:
            return False
        if var.integer and abs(x[i] - round(x[i])) > 1e-5:
            return False
    return True


def _interpret_highs(prob, res, objective, want, names, idx):
    if res.status == 2:  # infeasible
        return None
    if res.status == 3:
        raise Unbounded(str(objective))
    if not res.success or not _point_valid(prob, names, res.x):
        # numerical trouble: the exact engine answers instead
        return lexsimplex.solve_min(prob, objective, want)
    if want is None:
        sel = names
    else:
        sel = {k for k in objective if k != 1}
        sel.update(k for k in want if k in idx)
    sol: Dict[str, Fraction] = {}
    for name in sel:
        x = res.x[idx[name]]
        if prob.vars[name].integer:
            sol[name] = Fraction(round(x))
        else:
            sol[name] = Fraction(x).limit_denominator(10**9)
    val = Fraction(0)
    for k, v in objective.items():
        val += v if k == 1 else v * sol[k]
    return val, sol
