"""Polyhedral dependence analysis (paper §II-A2).

For every pair of accesses to the same array (at least one write) and
every common-loop depth, a candidate dependence polyhedron is built over
(source iters s0.., target iters t0.., params) and kept if rationally
feasible (a conservative over-approximation — spurious dependences only
restrict the schedule, never break legality).

Dependence polyhedra are *per-depth*, which lets the scheduler remove
them individually once strongly satisfied (Algorithm 1's
RemoveSatisfiedDependencies).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence

from .affine import Affine, affine_sub
from .polyhedron import Constraint, feasible, maximum, minimum
from .scop import Scop, Statement


@dataclass
class Dependence:
    id: int
    source: Statement
    target: Statement
    depth: int                    # loop level carrying the candidate dep
    loop_independent: bool        # textual-order dep at equal iterations
    cons: List[Constraint]        # over s*, t*, params
    kind: str                     # 'flow' | 'anti' | 'output'
    array: str
    satisfied_at: Optional[int] = None   # schedule dim that strongly satisfies
    # lazily-built CompiledPolyhedron over cons (see compiled_poly());
    # excluded from pickling so cached Schedules stay lean
    _compiled: Optional[object] = field(default=None, repr=False, compare=False)

    def src_var(self, k: int) -> str:
        return f"s{k}"

    def tgt_var(self, k: int) -> str:
        return f"t{k}"

    def __getstate__(self):
        state = dict(self.__dict__)
        state["_compiled"] = None
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)

    def __repr__(self):
        s = f"dep#{self.id} {self.kind} {self.array} S{self.source.index}->S{self.target.index} d={self.depth}"
        if self.loop_independent:
            s += " (li)"
        return s


def _rename(expr: Affine, iters: Sequence[str], prefix: str) -> Affine:
    out: Affine = {}
    pos = {it: i for i, it in enumerate(iters)}
    for k, v in expr.items():
        if k in pos:
            out[f"{prefix}{pos[k]}"] = v
        else:
            out[k] = out.get(k, Fraction(0)) + v if k in out else v
    return out


def _domain_cons(stmt: Statement, prefix: str) -> List[Constraint]:
    return [(_rename(e, stmt.iters, prefix), k) for e, k in stmt.domain]


def _param_context(scop: Scop) -> List[Constraint]:
    return scop.param_min_rows()


def compute_dependences(scop: Scop) -> List[Dependence]:
    deps: List[Dependence] = []
    stmts = scop.statements
    ctx = _param_context(scop)
    did = 0
    for s in stmts:
        for r in stmts:
            # we only build deps s -> r where s executes before r; both
            # directions are covered because (s, r) iterates all pairs.
            for a in s.accesses:
                for b in r.accesses:
                    if a.array != b.array:
                        continue
                    if not (a.is_write or b.is_write):
                        continue
                    kind = (
                        "flow" if a.is_write and not b.is_write
                        else "anti" if not a.is_write and b.is_write
                        else "output"
                    )
                    deps.extend(
                        _deps_for_pair(scop, s, r, a, b, kind, ctx, start_id=did + len(deps))
                    )
    for i, d in enumerate(deps):
        d.id = i
    return deps


def tighten_equalities(cons: List[Constraint]) -> List[Constraint]:
    """Integer tightening of equalities: if  g·X + R == 0  with the range
    of R over the polyhedron strictly inside (−g, g) and every X-term
    coefficient divisible by g, then X == 0 and R == 0 separately.

    Closes the rational-relaxation gap for linearized subscripts like
    ``b[j, 16*l + kv]`` (kv ∈ [0,16)): without it, l₁ == l₂ is not
    rationally implied and zero-distance (parallelism/coincidence) tests
    fail (paper §IV-A operators are exactly of this shape)."""
    cons = [(dict(e), k) for e, k in cons]
    changed = True
    while changed:
        changed = False
        for i, (expr, kind) in enumerate(cons):
            if kind != "==0":
                continue
            coeffs = {k: v for k, v in expr.items() if k != 1 and v != 0}
            if len(coeffs) < 2:
                continue
            g = max(abs(v) for v in coeffs.values())
            if g <= 1:
                continue
            d_part = {k: v for k, v in coeffs.items() if v % g == 0}
            r_part = {k: v for k, v in expr.items() if k == 1 or (k in coeffs and v % g != 0)}
            if not d_part or not any(k != 1 for k in r_part):
                continue
            rest = [c for j, c in enumerate(cons) if j != i]
            lo = minimum(rest, r_part)
            hi = maximum(rest, r_part)
            if lo is None or hi is None:
                continue
            if lo > -g and hi < g:
                cons[i] = (d_part, "==0")
                cons.append((r_part, "==0"))
                changed = True
                break
    return cons


def _deps_for_pair(scop, s, r, a, b, kind, ctx, start_id) -> List[Dependence]:
    out: List[Dependence] = []
    ncommon = scop.common_loops(s, r)
    base: List[Constraint] = []
    base += _domain_cons(s, "s")
    base += _domain_cons(r, "t")
    base += ctx
    # subscript equality
    for sub_a, sub_b in zip(a.subscripts, b.subscripts):
        ea = _rename(sub_a, s.iters, "s")
        eb = _rename(sub_b, r.iters, "t")
        base.append((affine_sub(ea, eb), "==0"))
    base = tighten_equalities(base)
    # carried deps at each common depth
    for depth in range(ncommon):
        cons = [(dict(e), k) for e, k in base]
        for k in range(depth):
            cons.append(({f"s{k}": Fraction(1), f"t{k}": Fraction(-1)}, "==0"))
        cons.append(({f"t{depth}": Fraction(1), f"s{depth}": Fraction(-1), 1: Fraction(-1)}, ">=0"))
        if feasible(cons):
            out.append(Dependence(start_id + len(out), s, r, depth, False, cons, kind, a.array))
    # loop-independent dep (equal common iterations, textual order)
    if (s is not r and scop.textually_before(s, r)) or (s is not r and ncommon == min(s.dim, r.dim) and scop.textually_before(s, r)):
        cons = [(dict(e), k) for e, k in base]
        for k in range(ncommon):
            cons.append(({f"s{k}": Fraction(1), f"t{k}": Fraction(-1)}, "==0"))
        if feasible(cons):
            out.append(Dependence(start_id + len(out), s, r, ncommon, True, cons, kind, a.array))
    return out


# ---------------------------------------------------------------------------
# schedule-row evaluation over a dependence
# ---------------------------------------------------------------------------

def compiled_poly(dep: Dependence, params: Sequence[str]):
    """The dependence polyhedron compiled once per Dependence (numeric LP
    matrices cached), reused for every distance/satisfaction query across
    all scheduling dimensions."""
    if dep._compiled is None:
        from .polyhedron import CompiledPolyhedron

        extra = [f"s{k}" for k in range(dep.source.dim)]
        extra += [f"t{k}" for k in range(dep.target.dim)]
        extra += list(params)
        dep._compiled = CompiledPolyhedron(dep.cons, extra)
    return dep._compiled

def phi_difference(dep: Dependence, row_src: Dict, row_tgt: Dict, params: Sequence[str]) -> Affine:
    """Affine form φ_R(t) − φ_S(s) over the dep polyhedron variables,
    given concrete schedule rows {var: Fraction} keyed by
    it<k>/par names/'1'."""
    expr: Affine = {}

    def acc(key, coef):
        if coef:
            expr[key] = expr.get(key, Fraction(0)) + coef

    for k in range(dep.target.dim):
        acc(f"t{k}", Fraction(row_tgt.get(("it", k), 0)))
    for k in range(dep.source.dim):
        acc(f"s{k}", -Fraction(row_src.get(("it", k), 0)))
    for p in params:
        acc(p, Fraction(row_tgt.get(("par", p), 0)) - Fraction(row_src.get(("par", p), 0)))
    acc(1, Fraction(row_tgt.get(("cst",), 0)) - Fraction(row_src.get(("cst",), 0)))
    return expr


def dep_distance_range(dep: Dependence, row_src, row_tgt, params, cache: bool = True):
    """(min, max) of φ_R − φ_S over the dependence polyhedron.

    ``cache=True`` optimizes over the per-dependence compiled polyhedron
    (same results, no LP rebuild); ``cache=False`` is the seed path."""
    diff = phi_difference(dep, row_src, row_tgt, params)
    if cache:
        cp = compiled_poly(dep, params)
        return cp.minimum(diff), cp.maximum(diff)
    lo = minimum(dep.cons, diff)
    hi = maximum(dep.cons, diff)
    return lo, hi


def dep_distance_min(dep: Dependence, row_src, row_tgt, params, cache: bool = True):
    """Just the minimum dependence distance (satisfaction tests) — lets
    hot callers skip the max-side LP when parallelism is already ruled
    out."""
    diff = phi_difference(dep, row_src, row_tgt, params)
    if cache:
        return compiled_poly(dep, params).minimum(diff)
    return minimum(dep.cons, diff)


def dep_distance_max(dep: Dependence, row_src, row_tgt, params, cache: bool = True):
    diff = phi_difference(dep, row_src, row_tgt, params)
    if cache:
        return compiled_poly(dep, params).maximum(diff)
    return maximum(dep.cons, diff)


def strongly_satisfied(dep: Dependence, row_src, row_tgt, params) -> bool:
    diff = phi_difference(dep, row_src, row_tgt, params)
    lo = compiled_poly(dep, params).minimum(diff)
    return lo is not None and lo >= 1


def zero_distance(dep: Dependence, row_src, row_tgt, params) -> bool:
    lo, hi = dep_distance_range(dep, row_src, row_tgt, params)
    return lo == 0 and hi == 0
