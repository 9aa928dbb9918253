"""Tree-walking numpy emitter + reference interpreter.

Turns a :class:`~repro_torch.core.schedtree.ScheduleTree` (built once from a
:class:`Schedule` by :mod:`repro_torch.core.schedtree` — loop separation,
Fourier–Motzkin bounds and parallel/vector marks all live there) into
executable Python/numpy source that scans statement instances in
lexicographic schedule-date order:

* sequence nodes → sequencing (loop distribution),
* band nodes     → loops over the tree's precomputed FM bounds,
* bands carrying the ``vector`` mark (single-statement innermost
  parallel loops) are emitted as numpy slice/sum expressions — the CPU
  stand-in for the paper's NPU/SIMD vector unit.

Tile/wavefront dims (from postproc) are ordinary bands with
``tile``/``wavefront`` marks and flow through the same walk.  This
emitter is the correctness oracle; the C measurement backend
(:mod:`repro_torch.core.cbackend`) walks the *same* tree.
"""
from __future__ import annotations

import math
import re
from fractions import Fraction
from typing import Dict, List, Optional, Set, Tuple

import numpy as np

from .affine import Affine, parse_affine
from .schedtree import (BandNode, LeafNode, ScanStmt, ScheduleTree,
                        SequenceNode, build_tree, coeff_of_y, render_affine,
                        schedule_tree, yvar as _yvar)
from .scheduler import Schedule
from .scop import Scop

# functions visible to generated Python code (match C's libm names)
_EXEC_ENV: Dict[str, object] = {
    "np": np, "math": math, "sqrt": np.sqrt, "fabs": np.abs, "pow": np.power,
    "exp": np.exp, "log": np.log, "fmod": np.fmod, "floor": np.floor,
}


# ---------------------------------------------------------------------------
# emission helpers
# ---------------------------------------------------------------------------

def _ceil_div_src(num: str, den: int) -> str:
    return num if den == 1 else f"-((-({num})) // {den})"


def _floor_div_src(num: str, den: int) -> str:
    return num if den == 1 else f"({num}) // {den}"


def _affine_src(e: Affine, sub: Optional[Dict[str, Affine]] = None) -> str:
    """Affine over y*/params (ints at runtime) to source, optionally
    substituting iterator expressions first.  Returns (body, den)."""
    if sub:
        e2: Affine = {}
        for k, v in e.items():
            if k != 1 and k in sub:
                for k2, v2 in sub[k].items():
                    e2[k2] = e2.get(k2, Fraction(0)) + v * v2
            else:
                e2[k] = e2.get(k, Fraction(0)) + v
        e = {k: v for k, v in e2.items() if v != 0}
    return render_affine(e)


_NAME_RE = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")


def _substitute_body(body: str, subst: Dict[str, str]) -> str:
    def repl(m):
        nm = m.group(0)
        return f"({subst[nm]})" if nm in subst else nm

    return _NAME_RE.sub(repl, body)


def _drop_var(e: Affine, sub: Dict[str, Affine], d: int) -> Optional[Affine]:
    """Substituted expr with the y_d term removed (slice base address)."""
    out: Affine = {}
    for k, v in e.items():
        if k == 1:
            out[1] = out.get(1, Fraction(0)) + v
        elif k in sub:
            for k2, v2 in sub[k].items():
                out[k2] = out.get(k2, Fraction(0)) + v * v2
        else:
            out[k] = out.get(k, Fraction(0)) + v
    out.pop(_yvar(d), None)
    return {k: v for k, v in out.items() if v != 0}


# ---------------------------------------------------------------------------
# the generator
# ---------------------------------------------------------------------------

class CodeGenerator:
    """Tree-walking Python/numpy emitter.

    Accepts either a prebuilt ``tree`` or a ``Schedule`` (+ optional
    tiled ``scan``), in which case the tree is built here with the
    parametric bound context (see :data:`CONCRETE`)."""

    #: bound-pruning context: the numpy oracle stays parametric (only the
    #: SCoP's assumed parameter lower bound); the C backend overrides
    #: this to bake concrete parameter values (see CCodeGenerator)
    CONCRETE = False

    def __init__(self, sched: Schedule, scan: Optional[List[ScanStmt]] = None,
                 vectorize: bool = True, func_name: Optional[str] = None,
                 tree: Optional[ScheduleTree] = None):
        self.sched = sched
        self.scop = sched.scop
        self.params = self.scop.param_names()
        self.vectorize = vectorize
        self.func_name = func_name or f"kernel_{self.scop.name}".replace("-", "_")
        self.lines: List[str] = []
        self.indent = 0
        if tree is None:
            if scan is None and not self.CONCRETE:
                tree = schedule_tree(sched)      # shared memoized tree
            else:
                tree = build_tree(sched, scan=scan, concrete=self.CONCRETE)
        self.tree = tree
        self.vectorized_stmts: Set[int] = set()
        self._bands: Dict[int, BandNode] = {}
        self._loop_depth = 0

    # -- public ---------------------------------------------------------
    def generate(self) -> str:
        self.lines = []
        self._bands = {}
        self._loop_depth = 0
        args = ", ".join(list(self.scop.arrays) + self.scop.scalars + self.params)
        self._emit(f"def {self.func_name}({args}):")
        self.indent += 1
        self._walk(self.tree.root)
        self._emit("return None")
        self.indent -= 1
        return "\n".join(self.lines)

    def build(self):
        src = self.generate()
        env: Dict[str, object] = dict(_EXEC_ENV)
        exec(compile(src, f"<polytops:{self.func_name}>", "exec"), env)
        return env[self.func_name], src

    # -- the walk ---------------------------------------------------------
    def _emit(self, line: str):
        self.lines.append("    " * self.indent + line)

    def _walk(self, node):
        if node is None:
            return
        if isinstance(node, SequenceNode):
            for c in node.children:
                self._walk(c)
        elif isinstance(node, BandNode):
            self._emit_band(node)
        else:
            self._emit_leaf(node)

    def _band_bounds(self, node: BandNode) -> Tuple[str, str]:
        """Loop bounds: per-statement rendered bounds, folded across the
        group (min of lowers / max of uppers for the domain union)."""
        los, his = [], []
        for s in node.stmts:
            lo, hi = node.bounds[s]
            los.append(self._render_bound(lo, lower=True))
            his.append(self._render_bound(hi, lower=False))
        lo_src = (los[0] if len(set(los)) == 1
                  else self._fold_group(sorted(set(los)), lower=True))
        hi_src = (his[0] if len(set(his)) == 1
                  else self._fold_group(sorted(set(his)), lower=False))
        return lo_src, hi_src

    def _render_bound(self, bounds: List[Affine], lower: bool) -> str:
        terms = []
        for e in bounds:
            body, den = render_affine(e)
            terms.append(_ceil_div_src(body, den) if lower
                         else _floor_div_src(body, den))
        if not terms:
            raise ValueError("unbounded loop dimension")
        uniq = sorted(set(terms))
        if len(uniq) == 1:
            return uniq[0]
        return ("max(" if lower else "min(") + ", ".join(uniq) + ")"

    def _fold_group(self, terms: List[str], lower: bool) -> str:
        return ("min(" if lower else "max(") + ", ".join(terms) + ")"

    def _emit_band(self, node: BandNode):
        self._bands[node.dim] = node
        y = _yvar(node.dim)
        lo_src, hi_src = self._band_bounds(node)
        if (self.vectorize and node.vector
                and self._emit_vectorized(node, lo_src, hi_src)):
            return
        self._emit(f"for {y} in range({lo_src}, ({hi_src}) + 1):")
        self.indent += 1
        self._loop_depth += 1
        body_start = len(self.lines)
        self._walk(node.child)
        if len(self.lines) == body_start:
            self._emit("pass")
        self._loop_depth -= 1
        self.indent -= 1

    def _band_guards(self, leaf: LeafNode) -> List[str]:
        """Per-statement bound guards for mixed-bound fused loops, from
        the enclosing bands the tree flagged."""
        out: List[str] = []
        for d in leaf.guards:
            band = self._bands[d]
            lo, hi = band.bounds[leaf.stmt]
            l = self._render_bound(lo, lower=True)
            h = self._render_bound(hi, lower=False)
            y = _yvar(d)
            out += [f"{y} >= {l}", f"{y} <= {h}"]
        return out

    def _emit_vectorized(self, node: BandNode, lo: str, hi: str) -> bool:
        """Emit a ``vector``-marked band as numpy slices. Two patterns:
        parallel assignment (LHS varies with y) or sum-reduction
        (LHS constant in y, body is `X = X + expr`)."""
        d = node.dim
        s = self.scop.statements[node.stmts[0]]
        sub = self.tree.subst[s.index]
        y = _yvar(d)
        lhs_acc = s.writes()[0]
        lhs_coef = [coeff_of_y(e, sub, d, self.params)
                    for e in lhs_acc.subscripts]
        if any(_affine_src(expr)[1] != 1 for expr in sub.values()):
            return False   # non-unimodular substitution: fall back to loops
        sub_src = {it: _affine_src(expr)[0] for it, expr in sub.items()}

        def slice_subscripts(text_subs: List[Affine]) -> Optional[str]:
            # the vector iterator may appear in at most ONE subscript —
            # otherwise independent slices form a cross product instead
            # of the diagonal access (hypothesis-found bug)
            n_vec = sum(1 for e in text_subs
                        if coeff_of_y(e, sub, d, self.params) not in (0, None))
            if n_vec > 1:
                return None
            parts = []
            for e in text_subs:
                c = coeff_of_y(e, sub, d, self.params)
                body, den = _affine_src(e, sub)
                if den != 1:
                    return None
                if c == 0:
                    parts.append(body)
                else:
                    base = _drop_var(e, sub, d)
                    if base is None:
                        return None
                    bsrc, bden = _affine_src(base)
                    if bden != 1:
                        return None
                    if c == 1:
                        parts.append(f"({bsrc})+({lo}):({bsrc})+({hi})+1")
                    else:  # c == -1 → reversed slice
                        top = f"({bsrc})-({lo})"
                        bot = f"({bsrc})-({hi})"
                        parts.append(f"{top}:({bot})-1 if ({bot})>0 else None:-1")
            return ", ".join(parts)

        from .scop import _find_assign
        eq = _find_assign(s.body)
        lhs_txt, rhs_txt = s.body[:eq].strip(), s.body[eq + 1:].strip()

        def vec_expr(txt: str) -> Optional[str]:
            out = []
            pos = 0
            from .scop import _ACCESS
            for m in _ACCESS.finditer(txt):
                out.append(_substitute_body(txt[pos:m.start()], sub_src))
                arr = m.group(1)
                from .scop import _split_subscripts
                subs = [parse_affine(t) for t in _split_subscripts(m.group(2))]
                sl = slice_subscripts(subs)
                if sl is None:
                    return None
                out.append(f"{arr}[{sl}]")
                pos = m.end()
            out.append(_substitute_body(txt[pos:], sub_src))
            return "".join(out)

        if any(c != 0 for c in lhs_coef):
            # parallel elementwise
            lv = vec_expr(lhs_txt)
            rv = vec_expr(rhs_txt)
            if lv is None or rv is None:
                return False
            self._emit(f"if ({hi}) >= ({lo}):  # vectorized {y}")
            self.indent += 1
            self._emit(f"{lv} = {rv}")
            self.indent -= 1
            self.vectorized_stmts.add(s.index)
            return True
        # reduction: X = X + f(y)  →  X += np.sum(f(slice))
        m = re.match(re.escape(lhs_txt) + r"\s*\+\s*(.*)$", rhs_txt)
        if not m:
            return False
        addend = m.group(1)
        av = vec_expr(addend)
        lv = _substitute_body(lhs_txt, sub_src)
        if av is None:
            return False
        self._emit(f"if ({hi}) >= ({lo}):  # vectorized reduction {y}")
        self.indent += 1
        self._emit(f"{lv} = {lv} + np.sum({av})")
        self.indent -= 1
        self.vectorized_stmts.add(s.index)
        return True

    def _emit_leaf(self, leaf: LeafNode):
        s = self.scop.statements[leaf.stmt]
        guard_exprs = self._band_guards(leaf)
        sub_src = {}
        for it, expr in self.tree.subst[s.index].items():
            body, den = _affine_src(expr)
            if den != 1:
                sub_src[it] = _floor_div_src(body, den)
                guard_exprs = guard_exprs + [f"({body}) % {den} == 0"]
            else:
                sub_src[it] = body
        body = _substitute_body(s.body, sub_src)
        if guard_exprs:
            self._emit("if " + " and ".join(guard_exprs) + ":")
            self.indent += 1
            self._emit(body)
            self.indent -= 1
        else:
            self._emit(body)


# ---------------------------------------------------------------------------
# reference interpreter (independent oracle for equivalence tests)
# ---------------------------------------------------------------------------

def interpret_source(scop: Scop) -> str:
    """Python source executing the SCoP in original program order — the
    independent oracle for schedule-equivalence tests."""
    src_lines = ["def __run__(arrays, scalars, params):"]
    for a in scop.arrays:
        src_lines.append(f"    {a} = arrays['{a}']")
    for sc in scop.scalars:
        src_lines.append(f"    {sc} = scalars.get('{sc}', 1.0)")
    for p in scop.params:
        src_lines.append(f"    {p} = params['{p}']")

    open_loops: List[int] = []

    def indent() -> str:
        return "    " * (1 + len(open_loops))

    order = sorted(scop.statements, key=lambda s: tuple(s.beta))
    for s in order:
        while open_loops and open_loops != s.loop_ids[: len(open_loops)]:
            open_loops.pop()
        for lid in s.loop_ids[len(open_loops):]:
            loop = scop.loops[lid]
            lo, lo_den = _affine_src(loop.lower)
            hi, hi_den = _affine_src(loop.upper)
            assert lo_den == 1 and hi_den == 1
            src_lines.append(f"{indent()}for {loop.iterator} in range({lo}, {hi}):")
            open_loops.append(lid)
        src_lines.append(indent() + s.body)
    return "\n".join(src_lines)


def interpret_scop(scop: Scop, arrays: Dict[str, np.ndarray],
                   scalars: Optional[Dict[str, float]] = None) -> None:
    """Execute the SCoP in original program order, mutating ``arrays``."""
    src = interpret_source(scop)
    env: Dict[str, object] = dict(_EXEC_ENV)
    exec(compile(src, f"<interp:{scop.name}>", "exec"), env)
    env["__run__"](arrays, scalars or {}, dict(scop.params))
