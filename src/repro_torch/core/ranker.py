"""Learned static ranker for the autotuner (paper §III-E, LOOPer-style).

The analytic cost model in :mod:`repro_torch.core.autotune` is a hand-built
prior.  This module learns a correction from the *measured*
(kernel, configuration, time) triples the autotuner persists in the
schedule-cache pool (:func:`repro_torch.core.schedcache.record_measurements`):
a ridge regression from cheap static features of a candidate
configuration to its log runtime.  The fitted model replaces the
analytic ranking when enough training data has accumulated, pruning the
enumerated configuration space to the measurable top-k.

Design constraints:

* **Deterministic** — features are exact functions of the SCoP/schedule,
  the closed-form ridge solve has no randomness, and training rows come
  from an append-only JSONL pool in file order.  Re-ranking the same
  kernel against the same pool returns the same order.
* **Within-kernel contrastive** — rows are centered per kernel (both X
  and y) before fitting, so the model learns *which configuration of a
  kernel is faster*, not absolute kernel speed; ranking candidates of
  one kernel is exactly the question the autotuner asks.
* **Graceful** — below :data:`MIN_SAMPLES` usable rows (or on any
  numerical trouble) :func:`fit_ranker` returns None and the autotuner
  keeps the analytic ranking.

Features come from the same primitives as the cache model
(:mod:`repro_torch.core.cachemodel`): tile working sets vs the cache budget,
temporal-reuse weights, band structure, parallel depth.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

from .cachemodel import (CacheSpec, default_spec, shared_bands,
                         shared_groups, shared_tile_sizes, working_set_bytes)

#: bump when the feature definition changes — rows from an older
#: feature version must not train a newer model
FEATURE_VERSION = 1

FEATURE_NAMES = (
    "log_static_cost",     # the analytic model's opinion (strong prior)
    "log_trip",            # total box-volume iteration estimate
    "n_dims",              # schedule dims
    "n_scalar_dims",       # distribution structure (the fusion axis)
    "par_frac",            # fraction of parallel dims
    "outer_par",           # first linear dim parallel?
    "max_band_len",        # longest permutable band
    "reuse_frac",          # access groups with temporal reuse in band 0
    "log_ws_ratio",        # tile working set / L2 budget (0 when untiled)
    "tiled",
    "wave",
    "autovec",
)

MIN_SAMPLES = 32           # usable rows before the learned model kicks in
RIDGE_LAMBDA = 1.0


def features(scop, sched, tc, static_cost_val: float,
             spec: Optional[CacheSpec] = None,
             trips: Optional[Dict[int, float]] = None,
             memo: Optional[dict] = None) -> List[float]:
    """Feature vector of candidate ``tc`` applied to ``sched`` —
    deterministic and cheap: ``memo`` uses the *same* keys as the
    analytic model (``autotune.static_cost``), so the per-schedule
    scan/bands/groups/tile-size intermediates are computed once per
    schedule across both rankers."""
    spec = spec or default_spec()
    memo = {} if memo is None else memo
    bands = shared_bands(sched, memo)

    n_dims = sched.n_dims
    n_scalar = 0
    for d in range(n_dims):
        if all(sched.rows[s.index][d].kind == "scalar"
               for s in scop.statements):
            n_scalar += 1
    par_frac = (sum(1 for p in sched.parallel if p) / n_dims) if n_dims else 0.0
    outer_par = 0.0
    for d in range(n_dims):
        if any(sched.rows[s.index][d].kind == "linear"
               for s in scop.statements):
            outer_par = 1.0 if sched.parallel[d] else 0.0
            break
    max_band = max((b.length for b in bands), default=0)

    reuse_frac = 0.0
    log_ws_ratio = 0.0
    if bands:
        b = bands[0]
        groups = shared_groups(sched, memo, b.start, b.length)
        if groups:
            reuse_frac = sum(
                1 for g in groups if any(g.reused_by(d) for d in range(b.length))
            ) / len(groups)
        if tc.tile is not None and groups:
            sizes = shared_tile_sizes(sched, memo, tc.tile, spec).get(
                b.start, [32] * b.length)
            ws = working_set_bytes(groups, sizes, spec.elem_bytes)
            log_ws_ratio = math.log(max(ws, 1) / spec.l2_bytes)

    trip_total = sum(trips.values()) if trips else 1.0
    return [
        math.log(max(static_cost_val, 1e-9)),
        math.log(max(trip_total, 1.0)),
        float(n_dims),
        float(n_scalar),
        float(par_frac),
        float(outer_par),
        float(max_band),
        float(reuse_frac),
        float(log_ws_ratio),
        1.0 if tc.tile is not None else 0.0,
        1.0 if tc.wavefront else 0.0,
        1.0 if tc.autovec else 0.0,
    ]


@dataclass
class LearnedRanker:
    """Fitted ridge model: ``score = w · x`` ranks candidates of one
    kernel (lower = predicted faster).  The per-kernel intercept is
    deliberately dropped — it cancels within a kernel."""
    weights: List[float]
    n_rows: int
    n_kernels: int

    def predict(self, feats: Sequence[float]) -> float:
        return float(sum(w * x for w, x in zip(self.weights, feats)))


def fit_ranker(rows: Sequence[dict]) -> Optional[LearnedRanker]:
    """Fit from measurement-pool rows ({kernel, feats, seconds, fv}).

    Rows with the wrong feature version, malformed feature vectors, or
    non-positive times are dropped; kernels with fewer than two rows
    carry no within-kernel contrast and are dropped too.  Returns None
    below :data:`MIN_SAMPLES` usable rows or when the solve fails."""
    import numpy as np

    by_kernel: Dict[str, List[tuple]] = {}
    nf = len(FEATURE_NAMES)
    for r in rows:
        feats = r.get("feats")
        secs = r.get("seconds")
        if (r.get("fv") != FEATURE_VERSION or not isinstance(feats, list)
                or len(feats) != nf or not isinstance(secs, (int, float))
                or not secs or secs <= 0):
            continue
        by_kernel.setdefault(str(r.get("kernel")), []).append(
            (feats, math.log(secs)))
    xs, ys = [], []
    n_kernels = 0
    for rows_k in by_kernel.values():
        if len(rows_k) < 2:
            continue
        n_kernels += 1
        fm = [sum(f[i] for f, _ in rows_k) / len(rows_k) for i in range(nf)]
        ym = sum(y for _, y in rows_k) / len(rows_k)
        for f, y in rows_k:
            xs.append([f[i] - fm[i] for i in range(nf)])
            ys.append(y - ym)
    if len(xs) < MIN_SAMPLES or n_kernels < 2:
        return None
    try:
        x = np.asarray(xs, dtype=float)
        y = np.asarray(ys, dtype=float)
        a = x.T @ x + RIDGE_LAMBDA * np.eye(nf)
        w = np.linalg.solve(a, x.T @ y)
        if not np.all(np.isfinite(w)):
            return None
    except Exception:
        return None
    return LearnedRanker([float(v) for v in w], len(xs), n_kernels)
