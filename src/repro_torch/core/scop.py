"""SCoP (Static Control Part) representation + builder DSL.

A SCoP is the scheduler's input: statements with iteration domains,
affine array accesses and an original (2d+1-style) schedule encoded by
loop nesting + textual order (beta vectors). The paper consumes
OpenScop/isl objects produced by Clan; here SCoPs are built
programmatically with a small context-manager DSL:

    k = Scop("gemm", params={"N": 512})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            k.stmt("C[i,j] = C[i,j] * beta")
            with k.loop("k", 0, "N"):
                k.stmt("C[i,j] = C[i,j] + alpha * A[i,k] * B[k,j]")

Accesses (reads/writes) are parsed out of the statement body text:
``Name[aff, aff, ...]`` on the LHS of ``=`` is the write, everything on
the RHS (plus LHS re-reads for ``x = x + ...`` forms) are reads.
Non-subscripted names that are not iterators/parameters are scalars
(treated as read-only runtime constants; scalar *writes* are declared
explicitly via ``scalar_out``).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from .affine import Affine, affine_sub, parse_affine

# ---------------------------------------------------------------------------
# Constraint rows: affine dicts over iterator/param names (+ const key 1),
# meaning expr >= 0 (or == 0 for equalities).
# ---------------------------------------------------------------------------


@dataclass
class Access:
    array: str
    subscripts: List[Affine]  # one affine map per array dimension
    is_write: bool

    def __repr__(self):
        from .affine import affine_to_str

        idx = ",".join(affine_to_str(s) for s in self.subscripts)
        rw = "W" if self.is_write else "R"
        return f"{rw}:{self.array}[{idx}]"


@dataclass
class Statement:
    index: int
    name: str
    iters: List[str]                 # surrounding loop iterators, outer→inner
    domain: List[Tuple[Affine, str]]  # constraints over iters+params ('>=0'/'==0')
    body: str                        # executable text, e.g. "C[i,j] = ..."
    accesses: List[Access]
    beta: List[int]                  # textual position vector, len == len(iters)+1
    loop_ids: List[int]              # AST identity of surrounding loops

    @property
    def dim(self) -> int:
        return len(self.iters)

    def writes(self) -> List[Access]:
        return [a for a in self.accesses if a.is_write]

    def reads(self) -> List[Access]:
        return [a for a in self.accesses if not a.is_write]

    def __repr__(self):
        return f"S{self.index}<{self.body[:40]}>"


@dataclass
class Loop:
    loop_id: int
    iterator: str
    lower: Affine   # it >= lower  →  it - lower >= 0
    upper: Affine   # it < upper   →  upper - 1 - it >= 0


class Scop:
    def __init__(self, name: str, params: Optional[Dict[str, int]] = None,
                 param_min: int = 1):
        self.name = name
        self.params: Dict[str, int] = dict(params or {})  # name -> concrete size
        self.param_min = param_min  # assumed lower bound for parametric analysis
        self.statements: List[Statement] = []
        self.arrays: Dict[str, int] = {}   # array -> rank
        self.scalars: List[str] = []
        self.loops: Dict[int, Loop] = {}   # loop_id -> Loop (bounds registry)
        # optional per-array init override for harnesses: C expression over
        # indices i0, i1, ... (e.g. diagonally-dominant input for cholesky)
        self.c_init: Dict[str, str] = {}
        # numpy-side counterpart for the differential oracles: array name
        # -> callable(shape, rng) -> ndarray (this module stays numpy-free;
        # cbackend.init_arrays consults it)
        self.np_init: Dict[str, Callable] = {}
        self._stack: List[Loop] = []
        self._counters: List[int] = [0]    # textual position counters per depth
        self._next_loop_id = 0

    # -- DSL ----------------------------------------------------------------
    def loop(self, iterator: str, lower, upper) -> "_LoopCtx":
        return _LoopCtx(self, iterator, lower, upper)

    def stmt(self, body: str, name: Optional[str] = None) -> Statement:
        iters = [l.iterator for l in self._stack]
        domain: List[Tuple[Affine, str]] = []
        for l in self._stack:
            domain.append((affine_sub({l.iterator: Fraction(1)}, l.lower), ">=0"))
            up = dict(l.upper)
            up[1] = up.get(1, Fraction(0)) - 1
            domain.append((affine_sub(up, {l.iterator: Fraction(1)}), ">=0"))
        accesses = _parse_accesses(body, iters, list(self.params))
        beta = self._counters[: len(iters) + 1][:]
        s = Statement(
            index=len(self.statements),
            name=name or f"S{len(self.statements)}",
            iters=iters,
            domain=domain,
            body=body.strip(),
            accesses=accesses,
            beta=beta,
            loop_ids=[l.loop_id for l in self._stack],
        )
        self.statements.append(s)
        self._counters[len(iters)] += 1
        for a in accesses:
            r = self.arrays.get(a.array)
            if r is None:
                self.arrays[a.array] = len(a.subscripts)
            elif r != len(a.subscripts):
                raise ValueError(f"array {a.array} used with ranks {r} and {len(a.subscripts)}")
        for nm in _scalar_names(body, iters, list(self.params), set(self.arrays)):
            if nm not in self.scalars:
                self.scalars.append(nm)
        return s

    # -- queries -------------------------------------------------------------
    def common_loops(self, s: Statement, r: Statement) -> int:
        n = 0
        for a, b in zip(s.loop_ids, r.loop_ids):
            if a != b:
                break
            n += 1
        return n

    def textually_before(self, s: Statement, r: Statement) -> bool:
        n = self.common_loops(s, r)
        return s.beta[: n + 1] < r.beta[: n + 1] or (
            s.beta[: n + 1] == r.beta[: n + 1] and s.index < r.index
        )

    def param_names(self) -> List[str]:
        return list(self.params)

    def param_rows(self) -> List[Tuple[Affine, str]]:
        """Concrete-parameter equality rows (``p == value``) — the LP
        context shared by array-extent computation, cache-model extent
        estimation, and C-backend bound pruning."""
        return [({p: Fraction(1), 1: Fraction(-v)}, "==0")
                for p, v in self.params.items()]

    def param_min_rows(self) -> List[Tuple[Affine, str]]:
        """Parametric lower-bound rows (``p >= param_min``) — the
        context for dependence analysis and the Python oracle's bound
        pruning, where parameters stay symbolic."""
        return [({p: Fraction(1), 1: Fraction(-self.param_min)}, ">=0")
                for p in self.params]

    def __repr__(self):
        return f"Scop({self.name}, {len(self.statements)} stmts, params={self.params})"


class _LoopCtx:
    def __init__(self, scop: Scop, iterator: str, lower, upper):
        self.scop = scop
        lo = lower if isinstance(lower, dict) else parse_affine(str(lower))
        up = upper if isinstance(upper, dict) else parse_affine(str(upper))
        self.loop = Loop(scop._next_loop_id, iterator, lo, up)
        scop.loops[self.loop.loop_id] = self.loop
        scop._next_loop_id += 1

    def __enter__(self):
        s = self.scop
        s._stack.append(self.loop)
        depth = len(s._stack)
        if len(s._counters) <= depth:
            s._counters.append(0)
        else:
            s._counters[depth] = 0
        return self.loop

    def __exit__(self, *exc):
        s = self.scop
        depth = len(s._stack)
        s._stack.pop()
        s._counters[depth - 1] += 1
        # reset deeper counters
        del s._counters[depth + 1:]
        return False


# ---------------------------------------------------------------------------
# Access parsing
# ---------------------------------------------------------------------------

_ACCESS = re.compile(r"([A-Za-z_][A-Za-z_0-9]*)\s*\[((?:[^\[\]]|\[[^\]]*\])*)\]")
_NAME = re.compile(r"[A-Za-z_][A-Za-z_0-9]*")
_FUNCS = {"sqrt", "abs", "min", "max", "exp", "log", "pow", "floor", "SCALAR_VAL"}


def _split_subscripts(text: str) -> List[str]:
    parts, depth, cur = [], 0, ""
    for ch in text:
        if ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
        else:
            if ch == "[":
                depth += 1
            elif ch == "]":
                depth -= 1
            cur += ch
    parts.append(cur)
    return parts


def _parse_accesses(body: str, iters: Sequence[str], params: Sequence[str]) -> List[Access]:
    if "=" not in body:
        raise ValueError(f"statement body must be an assignment: {body!r}")
    # split on the first top-level '=' that isn't ==, <=, >=, !=
    eq = _find_assign(body)
    lhs, rhs = body[:eq], body[eq + 1:]
    accesses: List[Access] = []
    lhs_accs = list(_ACCESS.finditer(lhs))
    if len(lhs_accs) != 1:
        raise ValueError(f"LHS must be exactly one array access: {lhs!r}")
    m = lhs_accs[0]
    write = Access(m.group(1), [parse_affine(s) for s in _split_subscripts(m.group(2))], True)
    accesses.append(write)
    for m in _ACCESS.finditer(rhs):
        accesses.append(
            Access(m.group(1), [parse_affine(s) for s in _split_subscripts(m.group(2))], False)
        )
    return accesses


def _find_assign(body: str) -> int:
    depth = 0
    i = 0
    while i < len(body):
        ch = body[i]
        if ch in "[(":
            depth += 1
        elif ch in "])":
            depth -= 1
        elif ch == "=" and depth == 0:
            prev = body[i - 1] if i else ""
            nxt = body[i + 1] if i + 1 < len(body) else ""
            if prev not in "<>=!" and nxt != "=":
                return i
        i += 1
    raise ValueError(f"no assignment in {body!r}")


def _scalar_names(body: str, iters, params, arrays) -> List[str]:
    out = []
    for m in _NAME.finditer(body):
        nm = m.group(0)
        if nm in iters or nm in params or nm in arrays or nm in _FUNCS or nm in out:
            continue
        # skip names immediately followed by '(' (function calls) or '[' (arrays)
        rest = body[m.end():].lstrip()
        if rest[:1] in ("(", "["):
            continue
        out.append(nm)
    return out
