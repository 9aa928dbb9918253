"""Backend-agnostic schedule-tree IR: one scheduler output, many emitters.

The PolyTOPS pipeline feeds *multiple* code generators (the paper pairs
the scheduler with isl and CLooG; the reference package has a numpy
oracle and a C measurement backend, this port the Hopper kernel-plan
lowering).  Before
this module each backend re-derived the same facts from the raw
``Schedule`` — loop separation, Fourier–Motzkin bounds, parallel/vector
legality.  Now everything a backend needs is computed **once** here and
recorded on an explicit tree (Tiramisu-style: transformations are named
marks on the tree, not facts re-derived per emitter):

* :class:`BandNode` — one loop dimension.  Carries the FM-derived lower/
  upper bound expressions *per statement* (affine over outer loop vars
  and parameters), the governing schedule dim, and the marks:

  - ``parallel``   — zero dependence distance (``level_parallel``),
  - ``vector``     — single-statement innermost dim legal for SIMD /
                     lane mapping (unit access strides),
  - ``tile(T)``    — a tile counter of size ``T`` inserted by postproc,
  - ``wavefront``  — the sequential wave-sum dim of a skewed band,
  - ``wave_par``   — the tile counter whose parallelism lives under a
                     wavefront (legal by band permutability).

* :class:`SequenceNode` — ordered children (scalar schedule dims /
  loop distribution; the statement-separation decision is taken here,
  once, via the dependence SCCs).
* :class:`LeafNode` — one statement instance; records which enclosing
  band dims need per-statement bound guards (mixed-bound fused loops).

The tree also carries the iterator substitution ``it = g(y*, params)``
per statement, the schedule's band ids and vectorize directives — enough
for every backend: the reference's numpy and C emitters walk the tree,
and :func:`repro_torch.core.akg.lower_to_kernel_plan` maps it to a
:class:`~repro_torch.core.akg.KernelPlan` for the kernels in ``csrc/``.

Trees serialize losslessly to JSON (:func:`tree_to_json` /
:func:`tree_from_json`) for the golden corpus and the schedule-cache
payload; bump :data:`TREE_VERSION` whenever construction semantics
change (the cache key includes it).

Bound context: FM chains are LP-redundancy-pruned against what is known
true at runtime.  ``concrete=False`` keeps parameters symbolic (numpy
oracle: only the SCoP's assumed parameter lower bound); ``concrete=True``
additionally assumes the SCoP's concrete parameter values (C backend,
which bakes them in as ``#define``\\ s — this is what collapses tiled/
wavefronted MINI/MAXI chains).
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Set, Tuple, Union

from .affine import Affine
from .polyhedron import Constraint, bounds_of
from .scheduler import Schedule, _scc_groups
from .scop import Scop, Statement

#: serialization/construction format version — part of the schedule
#: cache key, so cached trees can never go stale silently
TREE_VERSION = 1


# ---------------------------------------------------------------------------
# Scanning systems: per statement, dims described as equalities or
# tile inequalities over (y*, it*, params)
# ---------------------------------------------------------------------------


@dataclass
class DimSpec:
    kind: str              # 'eq' (y == phi(it, N, 1)) | 'tile'
    phi: Affine            # over stmt iterators / params / const(1)
    tile: int = 0          # tile size for kind == 'tile'
    sched_dim: int = 0     # schedule dim governing dependence satisfaction:
                           # own dim for eq rows, band start for tile/wave dims
    role: str = ""         # '' (point/eq) | 'tile' (tile counter) |
                           # 'wave' (sequential wavefront sum) |
                           # 'wave_par' (tile counter inside a wave: parallel
                           # by band permutability, see level_parallel)


@dataclass
class ScanStmt:
    stmt: Statement
    dims: List[DimSpec]
    guards: List[str] = field(default_factory=list)

    def n_dims(self) -> int:
        return len(self.dims)


def scan_from_schedule(sched: Schedule) -> List[ScanStmt]:
    out = []
    for s in sched.scop.statements:
        dims = []
        for d, row in enumerate(sched.rows[s.index]):
            phi: Affine = {}
            for (key, *rest), v in row.coeffs.items():
                if key == "it":
                    phi[s.iters[rest[0]]] = v
                elif key == "par":
                    phi[rest[0]] = v
                else:
                    phi[1] = v
            dims.append(DimSpec("eq", phi, sched_dim=d))
        out.append(ScanStmt(s, dims))
    return out


def yvar(d: int) -> str:
    # underscore avoids collisions with SCoP array/scalar names like "y1"
    return f"y_{d}"


def _full_system(ss: ScanStmt, params: Sequence[str]) -> List[Constraint]:
    """Constraints over (y*, it*, params) for one statement."""
    cons: List[Constraint] = [(dict(e), k) for e, k in ss.stmt.domain]
    for d, spec in enumerate(ss.dims):
        y = yvar(d)
        if spec.kind == "eq":
            e = dict(spec.phi)
            e[y] = e.get(y, Fraction(0)) - 1
            cons.append((e, "==0"))
        else:  # tile: T*y <= phi <= T*y + T - 1
            T = Fraction(spec.tile)
            e1 = dict(spec.phi)
            e1[y] = e1.get(y, Fraction(0)) - T
            cons.append((e1, ">=0"))                      # phi - T*y >= 0
            e2 = {k: -v for k, v in spec.phi.items()}
            e2[y] = e2.get(y, Fraction(0)) + T
            e2[1] = e2.get(1, Fraction(0)) + T - 1
            cons.append((e2, ">=0"))                      # T*y + T-1 - phi >= 0
    return cons


def iterator_substitution(ss: ScanStmt) -> Dict[str, Affine]:
    """Express each statement iterator as affine over (y*, params) by
    inverting a full-rank subset of the scan's 'eq' rows.  Shared by the
    tree builder, the cache model (tile-footprint strides) and the
    autotuner (locality scoring)."""
    from .linalg_q import inverse, mat, rank

    s = ss.stmt
    eqs = []
    for d, spec in enumerate(ss.dims):
        if spec.kind == "eq" and any(k in s.iters for k in spec.phi):
            eqs.append((d, spec.phi))
    # build T (rows over iterators) picking a full-rank subset
    rows, chosen = [], []
    for d, phi in eqs:
        row = [phi.get(it, Fraction(0)) for it in s.iters]
        if rank(mat(rows + [row])) > len(rows):
            rows.append(row)
            chosen.append((d, phi))
        if len(rows) == s.dim:
            break
    if len(rows) < s.dim:
        raise ValueError(f"schedule not invertible for {s}")
    tinv = inverse(mat(rows))
    subst: Dict[str, Affine] = {}
    for i, it in enumerate(s.iters):
        expr: Affine = {}
        for j, (d, phi) in enumerate(chosen):
            c = tinv[i][j]
            if c == 0:
                continue
            expr[yvar(d)] = expr.get(yvar(d), Fraction(0)) + c
            for k, v in phi.items():
                if k not in s.iters:   # params / const move to RHS
                    expr[k] = expr.get(k, Fraction(0)) - c * v
        subst[it] = {k: v for k, v in expr.items() if v != 0}
    return subst


def wave_parallel(group: Sequence[ScanStmt], d: int) -> bool:
    """True when scan level ``d`` is a wavefront-inner tile counter for
    every statement in the group — the one loop whose parallelism lives
    under a sequential wave dim (see level_parallel)."""
    specs = [ss.dims[d] for ss in group if d < ss.n_dims()]
    return bool(specs) and all(spec.role == "wave_par" for spec in specs)


def level_parallel(sched: Schedule, group: Sequence[ScanStmt], d: int) -> bool:
    """Single source of truth for loop-level parallel legality — the
    ``parallel`` mark of the tree, consumed by the numpy emitter
    (vectorized emission), the C backend (omp parallel/simd pragmas) and
    the kernel-plan lowering, so every backend marks the same dims.

    * wavefront sum dims are sequential by construction;
    * the tile counter inside a wavefront ('wave_par') is parallel: the
      band is fully permutable, so every active dependence has
      componentwise non-negative distance, tile counters inherit that,
      and equal wave value forces both tile deltas to zero (same tile);
    * everything else is judged against SCHEDULE dims via
      stmt_parallel_at_set (distance zero for all deps not satisfied
      outside)."""
    specs = [ss.dims[d] for ss in group if d < ss.n_dims()]
    if not specs:
        return False
    if any(spec.role == "wave" for spec in specs):
        return False
    if wave_parallel(group, d):
        return True
    stmt_set = {ss.stmt.index for ss in group if d < ss.n_dims()}
    sd = min(spec.sched_dim for spec in specs)
    return sched.stmt_parallel_at_set(stmt_set, sd)


def coeff_of_y(e: Affine, sub: Dict[str, Affine], d: int,
               params: Sequence[str]) -> Optional[Fraction]:
    """Coefficient of loop var ``y_d`` in subscript ``e`` after iterator
    substitution; None when fractional (non-unimodular)."""
    tot = Fraction(0)
    for k, v in e.items():
        if k == 1 or k in params:
            continue
        c = sub[k].get(yvar(d), Fraction(0))
        tot += v * c
    if tot.denominator != 1:
        return None
    return tot


def render_affine(e: Affine) -> Tuple[str, int]:
    """Canonical source rendering of an affine over y*/params (ints at
    runtime): ``(body, den)`` with the expression equal to body/den.
    The body is valid in both Python and C; backends wrap the division
    in their own ceil/floor idiom."""
    den = 1
    for v in e.values():
        den = den * v.denominator // math.gcd(den, v.denominator)
    parts = []
    for k, v in sorted(e.items(), key=lambda kv: str(kv[0])):
        c = int(v * den)
        if c == 0:
            continue
        if k == 1:
            parts.append(f"{c:+d}")
        elif c == 1:
            parts.append(f"+{k}")
        elif c == -1:
            parts.append(f"-{k}")
        else:
            parts.append(f"{c:+d}*{k}")
    body = "".join(parts) or "0"
    if body.startswith("+"):
        body = body[1:]
    return body, den


# ---------------------------------------------------------------------------
# tree nodes
# ---------------------------------------------------------------------------

#: per-statement loop bounds of one band dim: (lower affines, upper affines);
#: the loop var is >= ceil(max lowers) and <= floor(min uppers)
BoundPair = Tuple[List[Affine], List[Affine]]


@dataclass
class SequenceNode:
    """Ordered execution of children (scalar dims / loop distribution)."""
    children: List["Node"]


@dataclass
class BandNode:
    """One loop dimension of the scanned schedule."""
    dim: int                           # scan level; loop var is yvar(dim)
    sched_dim: int                     # governing schedule dimension
    role: str                          # '' | 'tile' | 'wave' | 'wave_par'
    tile: int                          # tile size when role == 'tile'
    parallel: bool                     # zero-distance for the group
    vector: bool                       # SIMD/lane-legal single-stmt innermost
    innermost: bool                    # no further bands below
    stmts: Tuple[int, ...]             # statements scanned by this loop
    bounds: Dict[int, BoundPair]       # per-stmt FM-derived bounds
    child: "Node"

    @property
    def marks(self) -> Tuple[str, ...]:
        """Named transformation marks (the backend vocabulary)."""
        out = []
        if self.role == "tile":
            out.append(f"tile({self.tile})")
        elif self.role == "wave":
            out.append("wavefront")
        elif self.role == "wave_par":
            out.append("wave_par")
        if self.parallel:
            out.append("parallel")
        if self.vector:
            out.append("vector")
        return tuple(out)


@dataclass
class LeafNode:
    """One statement instance; ``guards`` lists enclosing band dims whose
    per-statement bounds must be re-checked (mixed-bound fused loops)."""
    stmt: int
    guards: Tuple[int, ...] = ()


Node = Union[SequenceNode, BandNode, LeafNode]


@dataclass
class ScheduleTree:
    """Root of the IR plus everything per-statement the backends need."""
    scop: Scop                                   # not serialized (structure)
    root: Node
    n_dims: int
    params: List[str]
    subst: Dict[int, Dict[str, Affine]]          # stmt -> it = g(y*, params)
    vector_iter: Dict[int, int]                  # stmt -> directive iter idx
    sched_bands: List[int]                       # band id per schedule dim
    concrete: bool                               # bound-pruning context used
    pretty: str = ""                             # schedule text (debug)

    def bands(self) -> List[BandNode]:
        """All band nodes, outermost-first (document order)."""
        out: List[BandNode] = []

        def walk(n: Optional[Node]):
            if isinstance(n, SequenceNode):
                for c in n.children:
                    walk(c)
            elif isinstance(n, BandNode):
                out.append(n)
                walk(n.child)
        walk(self.root)
        return out


# ---------------------------------------------------------------------------
# construction
# ---------------------------------------------------------------------------


class _FakeDep:
    """Adapter so separation can reuse the scheduler's SCC machinery."""

    def __init__(self, a: int, b: int, idx):
        self.source = idx[a].stmt
        self.target = idx[b].stmt
        self.satisfied_at = None


class _TreeBuilder:
    def __init__(self, sched: Schedule, scan: Sequence[ScanStmt],
                 context: Sequence[Constraint]):
        self.sched = sched
        self.scop = sched.scop
        self.params = self.scop.param_names()
        self.scan = list(scan)
        self.n_dims = max(ss.n_dims() for ss in self.scan)
        # FM-derived bounds + iterator substitution: computed ONCE here,
        # consumed by every backend
        self.bounds: Dict[int, List[BoundPair]] = {}
        self.subst: Dict[int, Dict[str, Affine]] = {}
        for ss in self.scan:
            sys_full = _full_system(ss, self.params)
            per_dim: List[BoundPair] = []
            for d in range(ss.n_dims()):
                inner = [it for it in ss.stmt.iters] + [
                    yvar(k) for k in range(ss.n_dims() - 1, d, -1)]
                lo, hi = bounds_of(sys_full, yvar(d), inner, context=context)
                per_dim.append((lo, hi))
            self.bounds[ss.stmt.index] = per_dim
            self.subst[ss.stmt.index] = iterator_substitution(ss)

    # -- structural helpers -------------------------------------------------
    def _const_at(self, ss: ScanStmt, d: int) -> Optional[int]:
        spec = ss.dims[d]
        if spec.kind != "eq":
            return None
        if any(k in ss.stmt.iters for k in spec.phi):
            return None
        if any(k != 1 for k in spec.phi):
            return None   # parametric constant: treat as loop
        return int(spec.phi.get(1, Fraction(0)))

    def _innermost_linear(self, ss: ScanStmt, d: int) -> bool:
        for dd in range(d + 1, ss.n_dims()):
            if self._const_at(ss, dd) is None:
                return False
        return True

    def _separate(self, group: List[ScanStmt], d: int) -> List[List[ScanStmt]]:
        """Order statements into sequential loop groups; merge cyclic ones."""
        if len(group) == 1:
            return [group]
        idx = {ss.stmt.index: ss for ss in group}
        # deps that still constrain relative order at/below this level —
        # satisfaction is judged against SCHEDULE dims, not scan levels
        level_sd = min(ss.dims[d].sched_dim for ss in group if d < ss.n_dims())
        edges: Set[Tuple[int, int]] = set()
        for dep in self.sched.deps:
            a, b = dep.source.index, dep.target.index
            if a == b or a not in idx or b not in idx:
                continue
            if dep.satisfied_at is not None and dep.satisfied_at < level_sd:
                continue
            edges.add((a, b))
        # union cyclic pairs via SCC on the subgraph
        deps_like = [_FakeDep(a, b, idx) for (a, b) in edges]
        sccs = _scc_groups([ss.stmt for ss in group], deps_like)
        out = []
        for comp in sccs:
            # keep statements with *identical* loop structure together only
            # if they are in the same SCC; singleton SCCs become their own
            # sequential loop (classic distribution)
            out.append([idx[i] for i in comp if i in idx])
        return [g for g in out if g]

    def _vectorizable(self, ss: ScanStmt, d: int) -> bool:
        spec = ss.dims[d]
        if spec.kind != "eq":
            return False
        s = ss.stmt
        # schedule legality shared with every backend's parallel marking
        if not level_parallel(self.sched, [ss], d):
            return False
        # the loop variable must enter subscripts with coeff in {0, ±1}
        sub = self.subst[s.index]
        for acc in s.accesses:
            for e in acc.subscripts:
                c = coeff_of_y(e, sub, d, self.params)
                if c is None or abs(c) not in (0, 1):
                    return False
        return True

    @staticmethod
    def _bound_key(blist: List[Affine]) -> frozenset:
        """Canonical identity of a rendered bound set — two statements
        share loop bounds iff their keys are equal, in every backend
        (both render through :func:`render_affine`)."""
        return frozenset(render_affine(e) for e in blist)

    # -- recursion ----------------------------------------------------------
    def build(self) -> Node:
        return self._level(list(self.scan), 0, {})

    def _level(self, group: List[ScanStmt], d: int,
               guards: Dict[int, Tuple[int, ...]]) -> Optional[Node]:
        if not group:
            return None
        if d >= self.n_dims or all(ss.n_dims() <= d for ss in group):
            leaves: List[Node] = [
                LeafNode(ss.stmt.index, guards.get(ss.stmt.index, ()))
                for ss in sorted(group, key=lambda s: s.stmt.index)]
            return leaves[0] if len(leaves) == 1 else SequenceNode(leaves)
        consts = {ss.stmt.index: self._const_at(ss, d) for ss in group}
        if all(c is not None for c in consts.values()):
            order: Dict[int, List[ScanStmt]] = {}
            for ss in group:
                order.setdefault(consts[ss.stmt.index], []).append(ss)
            children = [self._level(order[c], d + 1, guards)
                        for c in sorted(order)]
            children = [c for c in children if c is not None]
            if not children:
                return None
            return children[0] if len(children) == 1 else SequenceNode(children)
        # linear level: separate into sequential loop groups when legal
        nodes = [self._band(sub, d, guards) for sub in self._separate(group, d)]
        return nodes[0] if len(nodes) == 1 else SequenceNode(nodes)

    def _band(self, group: List[ScanStmt], d: int,
              guards: Dict[int, Tuple[int, ...]]) -> BandNode:
        bounds = {ss.stmt.index: self.bounds[ss.stmt.index][d] for ss in group}
        lo_keys = {self._bound_key(lo) for lo, _ in bounds.values()}
        hi_keys = {self._bound_key(hi) for _, hi in bounds.values()}
        mixed = len(group) > 1 and (len(lo_keys) > 1 or len(hi_keys) > 1)
        new_guards = dict(guards)
        if mixed:
            for ss in group:
                prev = new_guards.get(ss.stmt.index, ())
                new_guards[ss.stmt.index] = prev + (d,)
        specs = [ss.dims[d] for ss in group if d < ss.n_dims()]
        roles = {spec.role for spec in specs}
        vector = (
            len(group) == 1
            and self._innermost_linear(group[0], d)
            and not new_guards.get(group[0].stmt.index)
            and self._vectorizable(group[0], d)
        )
        return BandNode(
            dim=d,
            sched_dim=min(spec.sched_dim for spec in specs),
            role=roles.pop() if len(roles) == 1 else "",
            tile=specs[0].tile,
            parallel=level_parallel(self.sched, group, d),
            vector=vector,
            innermost=all(self._innermost_linear(ss, d) for ss in group),
            stmts=tuple(sorted(bounds)),
            bounds=bounds,
            child=self._level(group, d + 1, new_guards),
        )


def build_tree(sched: Schedule, scan: Optional[Sequence[ScanStmt]] = None,
               concrete: bool = False,
               context: Optional[Sequence[Constraint]] = None) -> ScheduleTree:
    """Build the schedule tree for ``sched`` (optionally over a tiled /
    wavefronted ``scan`` from :func:`repro_torch.core.postproc.tile_schedule`).

    ``concrete=True`` prunes FM bound chains against the SCoP's concrete
    parameter values (the C backend's context); the default keeps
    parameters symbolic (numpy oracle).  ``context`` overrides both.
    """
    scop = sched.scop
    if scan is None:
        scan = scan_from_schedule(sched)
    if context is None:
        context = scop.param_min_rows()
        if concrete:
            context = context + scop.param_rows()
    b = _TreeBuilder(sched, scan, context)
    return ScheduleTree(
        scop=scop,
        root=b.build(),
        n_dims=b.n_dims,
        params=b.params,
        subst=b.subst,
        vector_iter=dict(sched.vector_iter),
        sched_bands=list(sched.bands),
        concrete=bool(concrete),
        pretty=sched.pretty(),
    )


def schedule_tree(sched: Schedule, scan: Optional[Sequence[ScanStmt]] = None,
                  concrete: bool = False) -> ScheduleTree:
    """Like :func:`build_tree`, but the plain (untiled, parametric) tree
    is memoized on the Schedule object — repeat consumers (kernel-plan
    lowering, the numpy emitter, the golden dumps) share one FM pass,
    and the memo rides along in schedule-cache pickles (see
    :func:`repro_torch.core.schedcache.cached_schedule_scop`)."""
    if scan is not None or concrete:
        return build_tree(sched, scan=scan, concrete=concrete)
    tree = getattr(sched, "_tree", None)
    if tree is None:
        tree = build_tree(sched)
        try:
            sched._tree = tree
        except Exception:
            pass
    return tree


# ---------------------------------------------------------------------------
# lossless JSON round-trip
# ---------------------------------------------------------------------------


def _aff_json(e: Affine) -> list:
    return [[str(k), str(Fraction(v))]
            for k, v in sorted(e.items(), key=lambda kv: str(kv[0])) if v]


def _aff_from(pairs) -> Affine:
    out: Affine = {}
    for k, v in pairs:
        out[1 if k == "1" else k] = Fraction(v)
    return out


def _node_json(node: Optional[Node]):
    if node is None:
        return None
    if isinstance(node, SequenceNode):
        return {"t": "seq", "children": [_node_json(c) for c in node.children]}
    if isinstance(node, BandNode):
        return {
            "t": "band", "dim": node.dim, "sched_dim": node.sched_dim,
            "role": node.role, "tile": node.tile,
            "parallel": node.parallel, "vector": node.vector,
            "innermost": node.innermost,
            # display-only: derived from role/tile/parallel/vector (the
            # fields above are authoritative; _node_from never reads it)
            # — kept so golden dumps show the mark vocabulary directly
            "marks": list(node.marks),
            "stmts": list(node.stmts),
            "bounds": {str(s): [[_aff_json(e) for e in lo],
                                [_aff_json(e) for e in hi]]
                       for s, (lo, hi) in sorted(node.bounds.items())},
            "child": _node_json(node.child),
        }
    return {"t": "leaf", "stmt": node.stmt, "guards": list(node.guards)}


def _node_from(data) -> Optional[Node]:
    if data is None:
        return None
    t = data["t"]
    if t == "seq":
        return SequenceNode([_node_from(c) for c in data["children"]])
    if t == "band":
        return BandNode(
            dim=data["dim"], sched_dim=data["sched_dim"], role=data["role"],
            tile=data["tile"], parallel=data["parallel"],
            vector=data["vector"], innermost=data["innermost"],
            stmts=tuple(data["stmts"]),
            bounds={int(s): ([_aff_from(e) for e in lo],
                             [_aff_from(e) for e in hi])
                    for s, (lo, hi) in data["bounds"].items()},
            child=_node_from(data["child"]),
        )
    return LeafNode(data["stmt"], tuple(data["guards"]))


def tree_to_json(tree: ScheduleTree) -> dict:
    """Plain-dict rendering of the tree; json.dumps-able, deterministic,
    and lossless (see :func:`tree_from_json`)."""
    return {
        "version": TREE_VERSION,
        "n_dims": tree.n_dims,
        "params": list(tree.params),
        "concrete": tree.concrete,
        "subst": {str(s): {it: _aff_json(e) for it, e in sorted(sub.items())}
                  for s, sub in sorted(tree.subst.items())},
        "vector_iter": {str(s): int(v)
                        for s, v in sorted(tree.vector_iter.items())},
        "sched_bands": list(tree.sched_bands),
        "pretty": tree.pretty,
        "root": _node_json(tree.root),
    }


def tree_from_json(data: dict, scop: Scop) -> ScheduleTree:
    """Inverse of :func:`tree_to_json`.  ``scop`` supplies the statement
    bodies/accesses the serialization deliberately does not duplicate."""
    if data.get("version") != TREE_VERSION:
        raise ValueError(
            f"schedule-tree format {data.get('version')!r} != {TREE_VERSION}")
    return ScheduleTree(
        scop=scop,
        root=_node_from(data["root"]),
        n_dims=data["n_dims"],
        params=list(data["params"]),
        subst={int(s): {it: _aff_from(e) for it, e in sub.items()}
               for s, sub in data["subst"].items()},
        vector_iter={int(s): int(v) for s, v in data["vector_iter"].items()},
        sched_bands=list(data["sched_bands"]),
        concrete=data["concrete"],
        pretty=data.get("pretty", ""),
    )
