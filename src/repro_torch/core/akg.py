"""AKG bridge: tensor ops → SCoPs → PolyTOPS schedule trees → kernel plans.

The schedule tree PolyTOPS produces for an operator's SCoP
(:mod:`repro_torch.core.schedtree`) is *lowered* into a
:class:`KernelPlan` — grid dimension order from the outer bands, the
contiguous vector dim from the ``vector`` mark (or the vectorize
directive / innermost band), tile shapes fitted to the card — consumed by
the hand-written Hopper kernels in ``csrc/`` through
:mod:`repro_torch.kernels`.

:func:`lower_to_kernel_plan` is fully general: any scheduled SCoP's tree
maps to a plan.  ``plan_matmul`` / ``plan_attention`` /
``plan_mamba_scan`` / ``plan_scan_gate`` build the operator's SCoP,
schedule it (through the degradation ladder and the structural schedule
cache, tree included in the payload; the fused scan+gate ranks its legal
schedule bases first) and lower it, then apply their kernel's
constraints to the tile, as the reference's planners apply their clamps.

Hopper fit (:func:`_fit_tiles`): the reference fits its tiles to a TPU's
VMEM, lanes and sublanes.  Here a tile starts from the same rule (the
vector iterator up to 512, the others up to 128), its edges snap to
multiples of :data:`~repro_torch.plan.EDGE` (bf16 tensor-core fragments
are 16 deep), and non-vector dims shrink while one tile's working set —
from the statement's real access groups
(:func:`repro_torch.core.cachemodel.stmt_access_groups`) — exceeds the
shared memory of one block (:data:`~repro_torch.plan.SMEM_BYTES`).  How
many such tiles a kernel's load ring holds is launch geometry, chosen
after the tile (:mod:`repro_torch.plan`).  The kernel constraints, the
shapes ``csrc/`` is built for, are applied by each ``plan_*``.

The card's constants, shared-memory formulas and launch geometry live in
:mod:`repro_torch.plan`, which re-exports the planners; this module reads
them at call time.

Each memoized planner first asks a schedd daemon
(:mod:`repro_torch.launch.schedd`) when ``$POLYTOPS_TORCH_SCHEDD_SOCK``
or ``$POLYTOPS_TORCH_SCHEDD_ADDR`` names one (:func:`_remote_plan`), so N
serving processes amortize one scheduler; any remote failure plans
in-process.
"""
from __future__ import annotations

import functools
import os
from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

from .config import tensor_style
from .resilience import provenance as _provenance, schedule_with_ladder
from .schedcache import CacheStats, global_cache
from .schedtree import ScheduleTree, schedule_tree, yvar
from .scop import Scop, Statement


@dataclass(frozen=True)
class KernelPlan:
    """Loop-nest plan for a kernel.

    ``degraded``/``fallback_level``/``degrade_reasons`` carry the
    degradation-ladder provenance of the schedule the plan was lowered
    from (see :mod:`repro_torch.core.resilience`): a plan is still
    *correct* when degraded — every ladder rung is legal — but it may be
    lowered from a fallback schedule rather than the configured one,
    which a serving layer may want to log or re-plan later."""
    loop_order: Tuple[str, ...]       # outer → inner iterator names
    vector_iter: Optional[str]        # contiguous innermost iterator
    tile: Dict[str, int] = field(hash=False)   # iterator -> tile size
    bands: Tuple[int, ...]            # band id per scheduled dim
    schedule_str: str = ""            # human-readable schedule (debug)
    degraded: bool = False
    fallback_level: int = 0
    degrade_reasons: Tuple[str, ...] = ()


def _matmul_scop(m: int, n: int, k: int) -> Scop:
    s = Scop("matmul", params={"M": m, "N": n, "K": k})
    with s.loop("i", 0, "M"):
        with s.loop("j", 0, "N"):
            with s.loop("kk", 0, "K"):
                s.stmt("C[i,j] = C[i,j] + A[i,kk] * B[kk,j]")
    return s


def _iter_extents(scop: Scop, stmt: Statement) -> Dict[str, int]:
    """Concrete trip count per statement iterator (parameter values baked
    in) — the dimension sizes the tile fitter works against."""
    from .cachemodel import stmt_iter_ranges

    return {it: (max(1, int(rng[1] - rng[0]) + 1) if rng is not None else 1)
            for it, rng in stmt_iter_ranges(scop, stmt).items()}


def _fit_tiles(order: List[str], dims: Dict[str, int], vector_iter: str,
               stmt: Statement,
               fixed: Optional[Dict[str, int]] = None) -> Dict[str, int]:
    """Tiles for the card under a shared-memory budget.

    Starts from the reference's rule (the vector iterator up to 512, the
    others up to 128), snaps every edge down to a multiple of ``EDGE``
    (the whole dim when it is smaller), then halves non-vector dims, in
    loop order, while one tile's bf16 working set exceeds
    ``SMEM_BYTES``.  The working set comes from the shared cache model
    (:func:`repro_torch.core.cachemodel.stmt_access_groups`): per-access
    tile footprints from the statement's actual subscript strides.  The
    depth of a kernel's load ring is launch geometry, chosen after the
    tile (:mod:`repro_torch.plan`), so one tile is what must fit.

    ``fixed`` pins dims to a given tile (a dim the kernel is built for,
    or a state that must stay whole); pinned dims are exempt from
    snapping and shrinking, so the others shrink against the true
    footprint."""
    from .. import plan as hw
    from .cachemodel import stmt_access_groups, working_set_bytes

    fixed = fixed or {}
    tile = {}
    for it in order:
        d = dims[it]
        if it in fixed:
            tile[it] = min(fixed[it], d)
            continue
        if it == vector_iter:
            t = min(d, 512 if d % 512 == 0 else 128 * max(d // 128, 1))
            t = max(min(t, d), min(d, 128))
        else:
            t = min(d, 128)
        tile[it] = t if t < hw.EDGE else t // hw.EDGE * hw.EDGE
    groups = stmt_access_groups(stmt, order)

    def wset():
        return working_set_bytes(groups, [tile[i] for i in order], 2)

    shrink_order = [it for it in order if it != vector_iter and it not in fixed]
    while wset() > hw.SMEM_BYTES and any(tile[i] > hw.EDGE for i in shrink_order):
        for it in shrink_order:
            if tile[it] > hw.EDGE:
                tile[it] = max(hw.EDGE, tile[it] // 2 // hw.EDGE * hw.EDGE)
                break
    return tile


def lower_to_kernel_plan(tree: ScheduleTree, stmt_idx: Optional[int] = None,
                         *, fixed_tiles: Optional[Dict[str, int]] = None,
                         sched=None) -> KernelPlan:
    """Map any scheduled SCoP's schedule tree to a :class:`KernelPlan`.

    * **grid order** — outer→inner point bands of the tree (tile/wave
      counter bands are post-processing artifacts and skipped), each
      mapped back to the statement iterator it scans through the tree's
      iterator substitution;
    * **vector dim** — the band carrying the ``vector`` mark when one
      exists, else the schedule's vectorize directive, else the
      innermost loop (contiguity put it there);
    * **tiles** — edge-snapped sizes fitted to a block's shared memory
      via the shared cache model (:func:`_fit_tiles`).

    ``stmt_idx`` defaults to the deepest statement (scalar-init
    statements have no loop nest to map to a grid); a zero-dimensional
    choice raises ``ValueError`` so rankers can drop the candidate.

    ``sched`` (the Schedule the tree was built from) supplies the
    degradation-ladder provenance stamped on the plan; omitted, the
    plan reports a clean, non-degraded lowering.
    """
    scop = tree.scop
    if stmt_idx is None:
        stmt_idx = max(range(len(scop.statements)),
                       key=lambda i: (scop.statements[i].dim, -i))
    stmt = scop.statements[stmt_idx]
    if stmt.dim == 0:
        raise ValueError(
            f"statement S{stmt.index} has no loop dimensions to lower")
    sub = tree.subst.get(stmt.index, {})
    order: List[str] = []
    vec: Optional[str] = None
    for band in tree.bands():
        if stmt.index not in band.stmts or band.role:
            continue
        y = yvar(band.dim)
        cands = [it for it in stmt.iters if sub.get(it, {}).get(y)]
        if len(cands) == 1 and cands[0] not in order:
            order.append(cands[0])
            if band.vector and vec is None:
                vec = cands[0]
    for it in stmt.iters:     # safety: append anything unplaced
        if it not in order:
            order.append(it)
    if vec is None:
        vi = tree.vector_iter.get(stmt.index)
        vec = stmt.iters[vi] if vi is not None else order[-1]
    dims = _iter_extents(scop, stmt)
    tile = _fit_tiles(order, dims, vec, stmt, fixed=fixed_tiles)
    prov = _provenance(sched) if sched is not None else None
    return KernelPlan(tuple(order), vec, tile, tuple(tree.sched_bands),
                      tree.pretty,
                      degraded=bool(prov["degraded"]) if prov else False,
                      fallback_level=prov["fallback_level"] if prov else 0,
                      degrade_reasons=tuple(prov["reasons"]) if prov else ())


def _remote_plan(kind: str, *args, **kwargs) -> Optional[KernelPlan]:
    """Route a kernel plan through a running schedd daemon, if any.

    Returns None (plan locally) unless ``POLYTOPS_TORCH_SCHEDD_SOCK`` (or
    ``POLYTOPS_TORCH_SCHEDD_ADDR``) points at a live daemon — and never
    from inside the daemon itself or a client's fallback path
    (:mod:`schedclient` guards both).  Remote failures of any kind also
    return None: the daemon is an amortizer, never a point of failure
    for planning."""
    from .schedclient import maybe_remote_plan

    plan = maybe_remote_plan(kind, *args, **kwargs)
    return plan if isinstance(plan, KernelPlan) else None


#: default in-process memo capacity per planner.  Ragged serving shapes
#: produce one (seq_q, seq_k, head_dim) triple per distinct chunk×page
#: geometry, so attention needs more than a handful of entries.
#: Override per planner with ``POLYTOPS_TORCH_PLAN_MEMO_<NAME>`` or
#: globally with ``POLYTOPS_TORCH_PLAN_MEMO``.
PLAN_MEMO_DEFAULTS: Dict[str, int] = {
    "matmul": 64, "attention": 64, "mamba_scan": 16, "scan_gate": 16,
}

#: per-planner :class:`~repro_torch.core.schedcache.CacheStats` — hits/
#: misses/evicted of the in-process plan memos (:func:`plan_memo_stats`).
_PLAN_MEMO_STATS: Dict[str, CacheStats] = {}


def plan_memo_size(name: str) -> int:
    """Resolved memo capacity for planner ``name`` (env-overridable)."""
    raw = (os.environ.get(f"POLYTOPS_TORCH_PLAN_MEMO_{name.upper()}")
           or os.environ.get("POLYTOPS_TORCH_PLAN_MEMO"))
    if raw:
        try:
            return max(1, int(raw))
        except ValueError:
            pass
    return PLAN_MEMO_DEFAULTS.get(name, 16)


def plan_memo_stats() -> Dict[str, Dict[str, object]]:
    """``{planner: CacheStats.as_dict()}`` for every registered memo."""
    return {name: st.as_dict() for name, st in _PLAN_MEMO_STATS.items()}


def _plan_memo(name: str):
    """Like ``functools.lru_cache`` but degraded plans are returned
    without being pinned: a plan lowered from a fault- or deadline-
    degraded schedule must not be served for the rest of the process —
    the next call re-plans and caches the clean result once the
    transient clears (the in-memory twin of schedcache's rule that
    degraded schedules are never published).

    Capacity is resolved per call via :func:`plan_memo_size`; every
    hit/miss/eviction is counted in the planner's :class:`CacheStats`."""
    stats = _PLAN_MEMO_STATS.setdefault(name, CacheStats())

    def deco(fn):
        memo: Dict[tuple, KernelPlan] = {}

        @functools.wraps(fn)
        def wrapper(*args):
            hit = memo.get(args)
            if hit is not None:
                stats.hits += 1
                return hit
            stats.misses += 1
            plan = fn(*args)
            if not plan.degraded:
                while len(memo) >= plan_memo_size(name):  # FIFO, as lru
                    memo.pop(next(iter(memo)))
                    stats.evicted += 1
                memo[args] = plan
            return plan

        wrapper.cache_clear = memo.clear
        wrapper.stats = stats
        return wrapper
    return deco


def _snap(t: int, allowed: Tuple[int, ...]) -> int:
    """Largest allowed size ≤ t, or the smallest allowed one."""
    fits = [a for a in allowed if a <= t]
    return max(fits) if fits else min(allowed)


@_plan_memo("matmul")
def plan_matmul(m: int, n: int, k: int) -> KernelPlan:
    """PolyTOPS-planned matmul: tensor-style scheduling yields the
    (i, k, j) order with j vectorized.  ``csrc/matmul.cu`` is built for
    ``j`` = 128 (wgmma's n) and ``kk`` = 64 (one 128-byte swizzle row of
    bf16): both are pinned in the fit, which sizes ``i``, then ``i``
    snaps to the kernel's 64 or 128 rows (one or two consumer
    warpgroups)."""
    remote = _remote_plan("matmul", m, n, k)
    if remote is not None:
        return remote
    from .. import plan as hw

    scop = _matmul_scop(m, n, k)
    cfg = tensor_style()
    cfg.auto_vectorize = True
    # structural cache: repeat plans for the same (m, n, k) shape are a
    # lookup, persisted on disk across serving/benchmark processes —
    # with the schedule tree riding along in the payload.  The ladder
    # makes planning total: a fault degrades the schedule (provenance on
    # the plan) instead of failing the kernel build.
    sched = schedule_with_ladder(scop, cfg, cache=global_cache(),
                                 with_tree=True)
    plan = lower_to_kernel_plan(
        schedule_tree(sched), sched=sched,
        fixed_tiles={"j": max(hw.MATMUL_J), "kk": hw.MATMUL_KK})
    tile = dict(plan.tile)
    tile["i"] = _snap(tile["i"], hw.MATMUL_I)
    tile["j"] = _snap(tile["j"], hw.MATMUL_J)
    tile["kk"] = hw.MATMUL_KK
    return replace(plan, tile=tile)


@_plan_memo("attention")
def plan_attention(seq_q: int, seq_k: int, head_dim: int) -> KernelPlan:
    """Schedule the S = Q·Kᵀ core (q, k, d loops): contiguity puts d
    innermost and yields the q-block × k-block band that the flash kernel
    tiles over.  Kernel constraints: the head stays whole (a row of the
    output spans it), ``q`` and ``kk`` are powers of two up to 128 (the
    online-softmax state), and ``kk`` halves while one Q, K and V tile
    would not fit a block's shared memory."""
    remote = _remote_plan("attention", seq_q, seq_k, head_dim)
    if remote is not None:
        return remote
    from .. import plan as hw

    s = Scop("attn_score", params={"Q": seq_q, "K": seq_k, "D": head_dim})
    with s.loop("q", 0, "Q"):
        with s.loop("kk", 0, "K"):
            with s.loop("d", 0, "D"):
                s.stmt("S[q,kk] = S[q,kk] + Qm[q,d] * Km[kk,d]")
    cfg = tensor_style()
    sched = schedule_with_ladder(s, cfg, cache=global_cache(),
                                 with_tree=True)
    plan = lower_to_kernel_plan(schedule_tree(sched), sched=sched,
                                fixed_tiles={"d": head_dim})
    tile = dict(plan.tile)
    tile["d"] = head_dim
    tile["q"] = _snap(min(tile["q"], 128), hw.POW2)
    tile["kk"] = _snap(min(tile["kk"], 128), hw.POW2)
    while hw.attention_smem_bytes(tile) > hw.SMEM_BYTES and tile["kk"] > hw.EDGE:
        tile["kk"] //= 2
    return replace(plan, tile=tile)


@_plan_memo("mamba_scan")
def plan_mamba_scan(seq: int, d_inner: int, state: int) -> KernelPlan:
    """Selective-scan (Mamba-1) recurrence h_t = a_t ⊙ h_{t-1} + b_t with
    y_t = h_t · c_t: the scheduler discovers t sequential-outermost (the
    recurrence dependence) with the d/state dims parallel inside.  The
    kernel's tile is its thread block (:func:`repro_torch.plan.scan_tile`):
    the state whole, d so that d·state threads fill the block, t the
    time steps whose c rows are staged at a time."""
    remote = _remote_plan("mamba_scan", seq, d_inner, state)
    if remote is not None:
        return remote
    from .. import plan as hw

    s = Scop("mamba_scan", params={"T": seq, "D": d_inner, "S": state})
    with s.loop("t", 0, "T"):
        with s.loop("d", 0, "D"):
            with s.loop("n", 0, "S"):
                s.stmt("H[d,n] = A[t,d,n] * H[d,n] + B[t,d,n]")
                s.stmt("Y[t,d] = Y[t,d] + H[d,n] * Cs[t,n]")
    cfg = tensor_style()
    sched = schedule_with_ladder(s, cfg, cache=global_cache(),
                                 with_tree=True)
    plan = lower_to_kernel_plan(schedule_tree(sched), stmt_idx=0, sched=sched)
    return replace(plan, tile=hw.scan_tile(seq, d_inner, state))


def _scan_gate_scop(seq: int, d_inner: int, state: int) -> Scop:
    """Fused Mamba tail: recurrence + C-contraction (3-deep) and the
    skip+gate epilogue (2-deep) share one t/d nest, so the scheduler
    sees the fusion."""
    s = Scop("scan_gate", params={"T": seq, "D": d_inner, "S": state})
    with s.loop("t", 0, "T"):
        with s.loop("d", 0, "D"):
            with s.loop("n", 0, "S"):
                s.stmt("H[d,n] = A[t,d,n] * H[d,n] + B[t,d,n]")
                s.stmt("Y[t,d] = Y[t,d] + H[d,n] * Cs[t,n]")
            s.stmt("O[t,d] = (Y[t,d] + X[t,d] * Dk[d]) * G[t,d]")
    return s


@_plan_memo("scan_gate")
def plan_scan_gate(seq: int, d_inner: int, state: int) -> KernelPlan:
    """Plan the fused scan+skip+gate kernel (``csrc/scan_gate.cu``).

    Unlike the single-schedule planners this one is *autotuned*: the
    fused SCoP's schedule bases are enumerated and statically ranked by
    :func:`repro_torch.core.autotune.rank_pallas_plans` (the cost model
    picks among legal schedules), and the best lowerable candidate with
    t and d in its grid is taken.  Falls back to the ladder path on any
    autotune failure so planning stays total.  The tile is the scan
    kernel's thread block, as for :func:`plan_mamba_scan`."""
    remote = _remote_plan("scan_gate", seq, d_inner, state)
    if remote is not None:
        return remote
    from .. import plan as hw

    scop = _scan_gate_scop(seq, d_inner, state)
    plan: Optional[KernelPlan] = None
    try:
        from .autotune import rank_pallas_plans

        cands = rank_pallas_plans(scop, top_k=4, cache=global_cache())
        for cand in cands:
            if cand.plan is not None and "t" in cand.plan.tile \
                    and "d" in cand.plan.tile:
                plan = cand.plan
                break
    except Exception:
        plan = None
    if plan is None:
        cfg = tensor_style()
        sched = schedule_with_ladder(scop, cfg, cache=global_cache(),
                                     with_tree=True)
        plan = lower_to_kernel_plan(schedule_tree(sched), stmt_idx=0,
                                    sched=sched)
    return replace(plan, tile=hw.scan_tile(seq, d_inner, state))
