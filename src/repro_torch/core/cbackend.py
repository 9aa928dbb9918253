"""C backend: emit a self-contained PolyBench-style C program for a
schedule (kernel + deterministic init + timing + checksum).

The Python/numpy backend (codegen.py) is the correctness oracle; this
backend is the *measurement* path for the paper's CPU experiments
(§IV-B/C/D): gcc -O3 -march=native applies real SIMD vectorization and
real cache behaviour.  Both emitters walk the same schedule-tree IR
(:mod:`repro_torch.core.schedtree`): loop separation, FM bounds and the
``parallel`` marks are computed once at tree construction; this class
only renders C syntax.  ``parallel``-marked bands get ``#pragma omp
parallel for`` (outermost / wavefront-inner only) and parallel innermost
bands ``#pragma omp simd`` (this container has one core, so omp-parallel
speedups are structural — documented in EXPERIMENTS.md; SIMD + locality
effects are real).

Concrete parameter values are baked in as compile-time constants,
exactly like PolyBench reference harnesses — and the tree for this
backend is built with that concrete context (``concrete=True``), which
is what collapses tiled/wavefronted MINI/MAXI bound chains.
"""
from __future__ import annotations

from typing import Dict, List, Optional

from .affine import Affine
from .codegen import CodeGenerator, _affine_src, _substitute_body, _yvar
from .polyhedron import maximum, minimum
from .schedtree import (BandNode, LeafNode, ScanStmt, ScheduleTree,
                        render_affine)
from .scheduler import Schedule
from .scop import Scop, _ACCESS, _split_subscripts

# Identifiers the generated program may not (re)declare: C keywords, the
# libc/libm names pulled in by the emitted #includes (math.h's Bessel
# functions y0/y1/yn/j0/j1/jn are the classic PolyBench trap — `mvt`'s
# vector y1 collides), and the harness's own symbols.  SCoP arrays or
# scalars with these names are transparently renamed in the C output.
_C_RESERVED = frozenset("""
auto break case char const continue default do double else enum extern
float for goto if inline int long register restrict return short signed
sizeof static struct switch typedef union unsigned void volatile while
y0 y1 yn j0 j1 jn gamma lgamma tgamma exp exp2 expm1 log log2 log10
log1p sqrt cbrt pow sin cos tan asin acos atan atan2 sinh cosh tanh
fabs fmod floor ceil round trunc erf erfc hypot fma fmin fmax nan
remainder copysign nearbyint rint ilogb logb frexp ldexp modf signbit
abs div rand srand exit free malloc calloc realloc abort atexit system
getenv atof atoi atol qsort bsearch labs ldiv printf scanf puts getchar
putchar fopen fclose remove rename tmpfile fflush stdin stdout stderr
time clock difftime mktime asctime ctime gmtime localtime strftime
main init_arrays checksum cksum_ secs warm REPEATS MINI MAXI floord
ceild
""".split())


def _ceild_c(num: str, den: int) -> str:
    return num if den == 1 else f"ceild({num}, {den})"


def _floord_c(num: str, den: int) -> str:
    return num if den == 1 else f"floord({num}, {den})"


def _fold(fn: str, terms: List[str]) -> str:
    out = terms[0]
    for t in terms[1:]:
        out = f"{fn}({out}, {t})"
    return out


def array_extents(scop: Scop) -> Dict[str, List[int]]:
    """Numeric extent of each array dim = 1 + max subscript value over all
    accesses (with the SCoP's concrete parameter values)."""
    ctx = scop.param_rows()
    ext: Dict[str, List[int]] = {a: [0] * r for a, r in scop.arrays.items()}
    for s in scop.statements:
        cons = list(s.domain) + ctx
        for acc in s.accesses:
            for d, sub in enumerate(acc.subscripts):
                hi = maximum(cons, sub)
                lo = minimum(cons, sub)
                if hi is None:   # empty domain
                    continue
                if lo is not None and lo < 0:
                    raise ValueError(f"negative subscript for {acc.array} in S{s.index}")
                ext[acc.array][d] = max(ext[acc.array][d], int(hi) + 1)
    return ext


def init_arrays(scop: Scop, seed: int = 0) -> Dict[str, "object"]:
    """Deterministic numpy inputs for the differential harnesses (the
    oracle and test helpers all share this so they cannot drift).

    Default: small positive noise.  Per-array ``scop.np_init``
    overrides apply where the default is numerically unsound — e.g.
    cholesky needs a symmetric positive-definite input or its oracle
    takes ``sqrt`` of negative intermediates and fills the output with
    NaNs (which ``assert_allclose`` happily matches NaN-to-NaN,
    silently voiding the comparison)."""
    import numpy as np

    ext = array_extents(scop)
    r = np.random.default_rng(seed)
    out: Dict[str, "object"] = {}
    for a, dims in ext.items():
        shape = tuple(max(d, 1) for d in dims)
        arr = r.standard_normal(shape) * 0.1 + 1.0
        override = scop.np_init.get(a)
        if override is not None:
            arr = np.asarray(override(shape, r), dtype=float)
            if arr.shape != shape:
                raise ValueError(
                    f"np_init[{a!r}] returned shape {arr.shape}, "
                    f"wanted {shape}")
        out[a] = arr
    return out


class CCodeGenerator(CodeGenerator):
    #: bake concrete parameter values into the FM bound-pruning context
    #: (they are #defines in the emitted program)
    CONCRETE = True

    def __init__(self, sched: Schedule, scan: Optional[List[ScanStmt]] = None,
                 scalars: Optional[Dict[str, float]] = None,
                 omp: bool = True, repeats: int = 1,
                 func_name: Optional[str] = None,
                 tree: Optional[ScheduleTree] = None):
        super().__init__(sched, scan=scan, vectorize=False,
                         func_name=func_name, tree=tree)
        self.scalars = dict(scalars or {})
        self.omp = omp
        self.repeats = repeats
        self._parallel_emitted = False
        self._cname = self._rename_map()

    def _rename_map(self) -> Dict[str, str]:
        """C-safe name for every array/scalar (identity unless reserved).
        Parameters are emitted as ``#define`` and appear verbatim in
        bound expressions everywhere — renaming them is not supported,
        so a reserved parameter name fails loudly instead of producing a
        cryptic macro-expansion gcc error."""
        for p in self.params:
            if p in _C_RESERVED:
                raise ValueError(
                    f"SCoP parameter {p!r} collides with a C/libm "
                    f"identifier; rename the parameter")
        taken = set(self.scop.arrays) | set(self.scop.scalars) | set(self.params)
        out: Dict[str, str] = {}
        for name in list(self.scop.arrays) + list(self.scop.scalars):
            if name in _C_RESERVED:
                new = name + "_pt"
                while new in taken or new in _C_RESERVED:
                    new += "_"
                taken.add(new)
                out[name] = new
        return out

    # -- program ----------------------------------------------------------
    def generate(self) -> str:
        scop = self.scop
        self.lines = []
        self.indent = 0
        self._bands = {}
        self._loop_depth = 0
        self._parallel_emitted = False
        ext = array_extents(scop)
        e = self._emit
        e("#include <stdio.h>")
        e("#include <stdlib.h>")
        e("#include <math.h>")
        e("#include <time.h>")
        e("#define floord(n,d) (((n)<0) ? -((-(n)+(d)-1)/(d)) : (n)/(d))")
        e("#define ceild(n,d)  (((n)<0) ? -((-(n))/(d)) : ((n)+(d)-1)/(d))")
        e("#define MINI(a,b)   (((a)<(b)) ? (a) : (b))")
        e("#define MAXI(a,b)   (((a)>(b)) ? (a) : (b))")
        for p, v in scop.params.items():
            e(f"#define {p} {v}")
        cn = lambda name: self._cname.get(name, name)
        for sc, v in self.scalars.items():
            e(f"static const double {cn(sc)} = {v!r};")
        for a, dims in ext.items():
            dd = "".join(f"[{max(d,1)}]" for d in dims)
            e(f"static double {cn(a)}{dd};")
        e("")
        e("static void init_arrays(void) {")
        self.indent += 1
        for a, dims in ext.items():
            idx = [f"i{k}" for k in range(len(dims))]
            for k, d in enumerate(dims):
                e("    " * k + f"for (int {idx[k]} = 0; {idx[k]} < {max(d,1)}; {idx[k]}++)")
            expr = " + ".join(f"{ix}*{7 + 6 * k}" for k, ix in enumerate(idx)) or "0"
            sub = "".join(f"[{ix}]" for ix in idx)
            init = scop.c_init.get(
                a, f"((double)(({expr} + 3) % 251)) / 251.0 + 0.1"
            )
            e("    " * len(dims) + f"{cn(a)}{sub} = {init};")
        self.indent -= 1
        e("}")
        e("")
        e("static double checksum(void) {")
        self.indent += 1
        e("double cksum_ = 0.0;")
        for a, dims in ext.items():
            idx = [f"i{k}" for k in range(len(dims))]
            for k, d in enumerate(dims):
                e("    " * k + f"for (int {idx[k]} = 0; {idx[k]} < {max(d,1)}; {idx[k]}++)")
            sub = "".join(f"[{ix}]" for ix in idx)
            e("    " * len(dims) + f"cksum_ += {cn(a)}{sub} * (1.0 + 0.0001*(({' + '.join(idx) if idx else '0'}) % 17));")
        e("return cksum_;")
        self.indent -= 1
        e("}")
        e("")
        e(f"static void {self.func_name}(void) {{")
        self.indent += 1
        self._walk(self.tree.root)
        self.indent -= 1
        e("}")
        e("")
        e(f"#define REPEATS {self.repeats}")
        e("int main(void) {")
        self.indent += 1
        e("init_arrays();")
        e(f"{self.func_name}();  /* warmup + correctness */")
        e("double warm = checksum();")
        e("init_arrays();")
        e("struct timespec t0, t1;")
        e("clock_gettime(CLOCK_MONOTONIC, &t0);")
        e(f"for (int r = 0; r < REPEATS; r++) {self.func_name}();")
        e("clock_gettime(CLOCK_MONOTONIC, &t1);")
        e("double secs = (t1.tv_sec - t0.tv_sec) + 1e-9*(t1.tv_nsec - t0.tv_nsec);")
        e('printf("TIME_S %.9f CHECKSUM %.9e\\n", secs / REPEATS, warm);')
        e("return 0;")
        self.indent -= 1
        e("}")
        return "\n".join(self.lines)

    # -- loop emission (C syntax + pragmas from the tree's marks) -----------
    def _emit_band(self, node: BandNode):
        self._bands[node.dim] = node
        y = _yvar(node.dim)
        lo_src, hi_src = self._band_bounds(node)
        # omp-parallel only on OUTERMOST loops: a parallel region inside a
        # hot nest pays fork/join per outer iteration (measured ~60 µs of
        # constant overhead on trsmL when emitted at depth 2).  Wavefront
        # tile counters are the exception — their parallelism only exists
        # under the sequential wave loop.
        if (self.omp and node.parallel and not self._parallel_emitted
                and not node.innermost
                and (self._loop_depth == 0 or node.role == "wave_par")):
            self._emit("#pragma omp parallel for")
            self._parallel_emitted = True
        if self.omp and node.parallel and node.innermost:
            self._emit("#pragma omp simd")
            for s in node.stmts:
                self.vectorized_stmts.add(s)
        self._emit(f"for (int {y} = {lo_src}; {y} <= {hi_src}; {y}++) {{")
        self.indent += 1
        self._loop_depth += 1
        body_start = len(self.lines)
        self._walk(node.child)
        if len(self.lines) == body_start:
            self._emit(";")
        self._loop_depth -= 1
        self.indent -= 1
        self._emit("}")

    def _render_bound(self, bounds: List[Affine], lower: bool) -> str:
        terms = []
        for e in bounds:
            body, den = render_affine(e)
            terms.append(_ceild_c(body, den) if lower else _floord_c(body, den))
        if not terms:
            raise ValueError("unbounded loop dimension")
        uniq = sorted(set(terms))
        return _fold("MAXI" if lower else "MINI", uniq)

    def _fold_group(self, terms: List[str], lower: bool) -> str:
        return _fold("MINI" if lower else "MAXI", terms)

    def _emit_leaf(self, leaf: LeafNode):
        s = self.scop.statements[leaf.stmt]
        guard_exprs = self._band_guards(leaf)
        sub_src = {}
        for it, expr in self.tree.subst[s.index].items():
            body, den = _affine_src(expr)
            if den != 1:
                sub_src[it] = _floord_c(body, den)
                guard_exprs.append(f"(({body}) % {den}) == 0")
            else:
                sub_src[it] = body
        for old, new in self._cname.items():
            sub_src.setdefault(old, new)     # reserved-name scalars
        body = _c_body(s.body, sub_src, self._cname)
        if guard_exprs:
            self._emit("if (" + " && ".join(guard_exprs) + ") {")
            self.indent += 1
            self._emit(body + ";")
            self.indent -= 1
            self._emit("}")
        else:
            self._emit(body + ";")


def _c_body(body: str, sub_src: Dict[str, str],
            rename: Optional[Dict[str, str]] = None) -> str:
    """Rewrite ``A[i,j]`` → ``A[(i)][(j)]`` and substitute iterators;
    ``rename`` maps reserved array names to their C-safe spelling."""
    out = []
    pos = 0
    rename = rename or {}
    for m in _ACCESS.finditer(body):
        out.append(_substitute_body(body[pos:m.start()], sub_src))
        arr = m.group(1)
        subs = _split_subscripts(m.group(2))
        csubs = "".join(f"[{_substitute_body(t.strip(), sub_src)}]" for t in subs)
        out.append(f"{rename.get(arr, arr)}{csubs}")
        pos = m.end()
    out.append(_substitute_body(body[pos:], sub_src))
    return "".join(out)
