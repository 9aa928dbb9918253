"""Cache-model tile sizing (paper §III-E kernel-specific configuration).

PolyTOPS deliberately takes *no* tile-size decision in the core
scheduler — sizes are provided externally.  This module is that external
provider for the CPU measurement path (and, with a shared-memory budget,
for the Hopper kernel plans in :mod:`repro_torch.core.akg`): instead of a fixed
``tile=32`` it derives per-band, per-dimension tile sizes from the
SCoP's access functions so that one tile's working set fits a target
cache level.

Model
-----
For a tilable band (schedule dims ``[start, start+length)``, fully
permutable by construction) and a statement scanned by it, every array
access is summarized by the *stride matrix* ``c[j][d]`` = how much array
subscript ``j`` moves per unit step of band dim ``d`` (computed through
the schedule's iterator substitution, so skewed bands are handled).
Accesses to the same array whose stride rows agree are one *access
group* (``C[i,j]`` read + write, the three points of a stencil, ...);
within a group only the constant offsets differ and their spread widens
the footprint.  One tile of sizes ``T`` then touches, per group,

    elems(T) = prod_j (spread_j + 1 + sum_d |c[j][d]| * (T_d - 1))

and the tile working set is ``elem_bytes * sum_groups elems(T)``.

Sizes are chosen by deterministic greedy doubling: starting from
``min_tile`` in every dim, repeatedly double the dimension with the
highest temporal-reuse weight (number of access groups *not* moved by
that dim — those groups are re-touched ``T_d`` times, so growing ``T_d``
amortizes the most traffic), tie-broken toward balanced tiles, while the
working set stays under budget.  The result is a power-of-two tile
vector that fits the cache — per band and per statement group, exactly
the "cache-model-driven selector" the kernel-specific configurations
plug in.
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

from .schedtree import (ScanStmt, iterator_substitution, scan_from_schedule,
                        yvar as _yvar)
from .scheduler import Schedule


@dataclass(frozen=True)
class CacheSpec:
    """Target memory hierarchy for tile sizing."""
    l1_bytes: int = 32 * 1024
    l2_bytes: int = 512 * 1024
    line_bytes: int = 64
    elem_bytes: int = 8       # double

    def budget(self, level: str) -> int:
        if level == "l1":
            return self.l1_bytes
        if level in ("l2", "auto"):
            return self.l2_bytes
        raise ValueError(f"unknown cache level {level!r}")


def default_spec() -> CacheSpec:
    """CacheSpec with env overrides (POLYTOPS_L1_BYTES / POLYTOPS_L2_BYTES)."""
    return CacheSpec(
        l1_bytes=int(os.environ.get("POLYTOPS_L1_BYTES", 32 * 1024)),
        l2_bytes=int(os.environ.get("POLYTOPS_L2_BYTES", 512 * 1024)),
    )


# ---------------------------------------------------------------------------
# access groups: stride signature of every access wrt the band dims
# ---------------------------------------------------------------------------


@dataclass
class AccessGroup:
    array: str
    strides: Tuple[Tuple[Fraction, ...], ...]   # [array_dim][band_dim]
    spread: List[Fraction]                      # constant-offset spread per dim

    def tile_elems(self, sizes: Sequence[int]) -> int:
        total = 1
        for j, row in enumerate(self.strides):
            extent = Fraction(1) + self.spread[j]
            for d, c in enumerate(row):
                if c:
                    extent += abs(c) * (sizes[d] - 1)
            total *= max(1, int(extent))
        return total

    def reused_by(self, d: int) -> bool:
        """True when band dim d does not move this access (temporal reuse:
        the whole group footprint is re-touched T_d times)."""
        return all(row[d] == 0 for row in self.strides)


def band_access_groups(scan: Sequence[ScanStmt], start: int,
                       length: int) -> List[AccessGroup]:
    """Access groups of all statements scanned by the band, deduplicated
    across statements by (array, stride signature, offset pattern)."""
    band = [_yvar(start + k) for k in range(length)]
    # key -> (strides, per-array-dim [min_const, max_const])
    acc_info: Dict[tuple, Tuple[tuple, List[List[Fraction]]]] = {}
    for ss in scan:
        if ss.n_dims() <= start:
            continue
        try:
            subst = iterator_substitution(ss)
        except ValueError:
            continue                     # non-invertible: skip statement
        for acc in ss.stmt.accesses:
            strides = []
            base_consts = []
            base_rest = []
            for e in acc.subscripts:
                row = []
                for y in band:
                    c = Fraction(0)
                    for it, v in e.items():
                        if it in subst:
                            c += v * subst[it].get(y, Fraction(0))
                    row.append(c)
                strides.append(tuple(row))
                # substituted expr minus the band terms: constant part and
                # the non-constant remainder (params / outer dims)
                const = Fraction(0)
                rest: Dict[object, Fraction] = {}
                for it, v in e.items():
                    if it == 1:
                        const += v
                    elif it in subst:
                        for k2, v2 in subst[it].items():
                            if k2 == 1:
                                const += v * v2
                            elif k2 not in band:
                                rest[k2] = rest.get(k2, Fraction(0)) + v * v2
                    else:
                        rest[it] = rest.get(it, Fraction(0)) + v
                base_consts.append(const)
                base_rest.append(tuple(sorted(
                    (str(k), v) for k, v in rest.items() if v)))
            key = (acc.array, tuple(strides), tuple(base_rest))
            entry = acc_info.get(key)
            if entry is None:
                acc_info[key] = (tuple(strides),
                                 [[c, c] for c in base_consts])
            else:
                for j, c in enumerate(base_consts):
                    entry[1][j][0] = min(entry[1][j][0], c)
                    entry[1][j][1] = max(entry[1][j][1], c)
    return [
        AccessGroup(key[0], strides, [mx - mn for mn, mx in mm])
        for key, (strides, mm) in acc_info.items()
    ]


def working_set_bytes(groups: Sequence[AccessGroup], sizes: Sequence[int],
                      elem_bytes: int = 8) -> int:
    return elem_bytes * sum(g.tile_elems(sizes) for g in groups)


def stmt_iter_ranges(scop, stmt) -> Dict[str, Optional[Tuple[Fraction, Fraction]]]:
    """Rational (min, max) of each statement iterator over its domain
    with the SCoP's concrete parameter values, or None when the LP finds
    no bound — the shared extent primitive behind the autotuner's trip
    estimate and the kernel-plan tile fitter."""
    from .polyhedron import maximum, minimum

    cons = list(stmt.domain) + scop.param_rows()
    out: Dict[str, Optional[Tuple[Fraction, Fraction]]] = {}
    for it in stmt.iters:
        hi = maximum(cons, {it: Fraction(1)})
        lo = minimum(cons, {it: Fraction(1)})
        out[it] = None if hi is None or lo is None else (lo, hi)
    return out


def stmt_access_groups(stmt, iters: Sequence[str]) -> List[AccessGroup]:
    """Access groups over the statement's own iterators (identity
    schedule) — the working-set primitive for consumers that tile by
    iterator name rather than by schedule band (the kernel-plan tile
    fitter)."""
    acc_info: Dict[tuple, Tuple[tuple, List[List[Fraction]]]] = {}
    for acc in stmt.accesses:
        strides = []
        base_consts = []
        base_rest = []
        for e in acc.subscripts:
            strides.append(tuple(e.get(it, Fraction(0)) for it in iters))
            base_consts.append(e.get(1, Fraction(0)))
            # non-iterator remainder (parameters): accesses offset by a
            # parametric distance (A[i] vs A[i+N]) are separate groups,
            # not one group with zero spread
            base_rest.append(tuple(sorted(
                (str(k), v) for k, v in e.items()
                if k != 1 and k not in iters and v)))
        key = (acc.array, tuple(strides), tuple(base_rest))
        entry = acc_info.get(key)
        if entry is None:
            acc_info[key] = (tuple(strides), [[c, c] for c in base_consts])
        else:
            for j, c in enumerate(base_consts):
                entry[1][j][0] = min(entry[1][j][0], c)
                entry[1][j][1] = max(entry[1][j][1], c)
    return [
        AccessGroup(key[0], strides, [mx - mn for mn, mx in mm])
        for key, (strides, mm) in acc_info.items()
    ]


# ---------------------------------------------------------------------------
# extents + selection
# ---------------------------------------------------------------------------


def _band_extents(sched: Schedule, scan: Sequence[ScanStmt], start: int,
                  length: int, cap: int = 1 << 20) -> List[int]:
    """Estimated trip count of each band dim (max over statements), with
    the SCoP's concrete parameter values."""
    from .polyhedron import maximum, minimum

    scop = sched.scop
    ctx = scop.param_rows()
    extents = [1] * length
    for ss in scan:
        cons = list(ss.stmt.domain) + ctx
        for k in range(length):
            if start + k >= ss.n_dims():
                continue
            phi = ss.dims[start + k].phi
            if not any(it in ss.stmt.iters for it in phi):
                continue
            hi = maximum(cons, phi)
            lo = minimum(cons, phi)
            if hi is None or lo is None:
                extents[k] = cap
                continue
            extents[k] = max(extents[k], min(cap, int(hi - lo) + 1))
    return extents


def select_tile_sizes(sched: Schedule, start: int, length: int,
                      budget_bytes: Optional[int] = None,
                      spec: Optional[CacheSpec] = None,
                      scan: Optional[Sequence[ScanStmt]] = None,
                      min_tile: int = 4, max_tile: int = 512) -> List[int]:
    """Tile sizes for one band by greedy doubling under the budget."""
    spec = spec or default_spec()
    if budget_bytes is None:
        budget_bytes = spec.l2_bytes
    scan = scan if scan is not None else scan_from_schedule(sched)
    groups = band_access_groups(scan, start, length)
    extents = _band_extents(sched, scan, start, length)
    if not groups:
        return [32] * length     # no access info: legacy default
    reuse = [sum(1 for g in groups if g.reused_by(d)) for d in range(length)]
    sizes = [max(1, min(min_tile, extents[d])) for d in range(length)]
    while True:
        best = None
        for d in range(length):
            nd = sizes[d] * 2
            if nd > max_tile or nd > extents[d]:
                continue
            trial = list(sizes)
            trial[d] = nd
            if working_set_bytes(groups, trial, spec.elem_bytes) > budget_bytes:
                continue
            # highest reuse first; then the smallest current size (keep
            # tiles balanced); then lowest dim index — fully deterministic
            key = (reuse[d], -sizes[d], -d)
            if best is None or key > best[0]:
                best = (key, d)
        if best is None:
            break
        sizes[best[1]] *= 2
    return sizes


# ---------------------------------------------------------------------------
# shared per-schedule memo: the autotuner's analytic cost model and the
# learned ranker's feature extraction score the same candidates over the
# same handful of schedules — these helpers give both one set of memo
# keys (keyed on id(schedule)) so every intermediate is computed once.
# ---------------------------------------------------------------------------


def shared_scan(sched: Schedule, memo: dict):
    key = ("scan", id(sched))
    if key not in memo:
        memo[key] = scan_from_schedule(sched)
    return memo[key]


def shared_bands(sched: Schedule, memo: dict):
    from .postproc import find_tilable_bands

    key = ("bands", id(sched))
    if key not in memo:
        memo[key] = find_tilable_bands(sched)
    return memo[key]


def shared_groups(sched: Schedule, memo: dict, start: int, length: int):
    key = ("groups", id(sched), start)
    if key not in memo:
        memo[key] = band_access_groups(shared_scan(sched, memo), start, length)
    return memo[key]


def shared_tile_sizes(sched: Schedule, memo: dict, tile,
                      spec: Optional[CacheSpec] = None) -> Dict[int, List[int]]:
    """Per-band tile sizes for a candidate tile source (int or cache
    level), memoized: ``{band_start: [sizes]}``."""
    spec = spec or default_spec()
    bands = shared_bands(sched, memo)
    key = ("sizes", id(sched), str(tile))
    if key not in memo:
        memo[key] = (
            {b.start: [int(tile)] * b.length for b in bands}
            if isinstance(tile, int)
            else auto_tile_sizes(sched, level=str(tile), spec=spec,
                                 bands=bands)
        )
    return memo[key]


def auto_tile_sizes(sched: Schedule, level: str = "l2",
                    spec: Optional[CacheSpec] = None,
                    bands=None) -> Dict[int, List[int]]:
    """Per-band tile sizes for every tilable band of ``sched``:
    ``{band_start: [sizes]}`` — the shape ``postproc.tile_schedule``
    consumes."""
    from .postproc import find_tilable_bands

    spec = spec or default_spec()
    budget = spec.budget(level)
    scan = scan_from_schedule(sched)
    if bands is None:
        bands = find_tilable_bands(sched)
    return {
        b.start: select_tile_sizes(sched, b.start, b.length, budget,
                                   spec, scan=scan)
        for b in bands
    }
