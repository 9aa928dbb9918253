"""Post-processing: tiling and wavefront skewing (paper Fig. 1, §III).

Per the paper, *no tile-size decision* happens in the core scheduler —
sizes are provided externally. Tiling applies to maximal runs of linear
dimensions sharing a band id (those are fully permutable by
construction: every active dependence was weakly enforced at each dim of
the band). Each tiled dim φ gets a tile counter y with
``T·y ≤ φ ≤ T·y + T − 1`` — an inequality-defined scan dimension that
flows through the same Fourier–Motzkin codegen machinery.

Wavefront skewing (for pipelined parallelism on bands whose first dim
carries dependences) replaces the first two tile counters (t0, t1) by
(t0 + t1, t1): the new outer wave dimension is sequential while t1
becomes parallel within a wave.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Dict, List, Sequence, Tuple

from .schedtree import DimSpec, ScanStmt, scan_from_schedule, yvar as _yvar
from .scheduler import Schedule


@dataclass
class Band:
    start: int            # first schedule dim of the band (linear run)
    length: int
    parallel_first: bool  # first dim already parallel → no wavefront needed


def find_tilable_bands(sched: Schedule, min_len: int = 2) -> List[Band]:
    """Maximal runs of linear dims with equal band id (≥ min_len)."""
    bands: List[Band] = []
    d = 0
    n = sched.n_dims
    # a dim is 'linear' if any statement has a non-constant row there
    def is_linear(dim: int) -> bool:
        for s in sched.scop.statements:
            row = sched.rows[s.index][dim]
            if row.kind == "linear" and any(
                k[0] == "it" for k in row.coeffs
            ):
                return True
        return False

    while d < n:
        if not is_linear(d):
            d += 1
            continue
        start = d
        bid = sched.bands[d]
        while d < n and sched.bands[d] == bid and is_linear(d):
            d += 1
        if d - start >= min_len:
            bands.append(Band(start, d - start, sched.parallel[start]))
    return bands


def tile_schedule(
    sched: Schedule,
    tile_sizes: Dict[int, Sequence[int]] | Sequence[int] | int | str = 32,
    wavefront: bool = False,
    min_band: int = 2,
) -> List[ScanStmt]:
    """Build codegen scan specs with tile dimensions inserted.

    tile_sizes: int (uniform), list (per band-dim), {band_start: [..]},
    or a cache-model level: ``"l1"`` / ``"l2"`` / ``"auto"`` (= l2) pick
    per-band per-dim sizes from the SCoP's access functions so the tile
    working set fits that cache (see :mod:`repro_torch.core.cachemodel`).
    """
    scan = scan_from_schedule(sched)
    bands = find_tilable_bands(sched, min_band)
    if not bands:
        return scan
    if isinstance(tile_sizes, str):
        from .cachemodel import auto_tile_sizes
        tile_sizes = auto_tile_sizes(
            sched, level="l2" if tile_sizes == "auto" else tile_sizes,
            bands=bands)

    def sizes_for(band: Band) -> List[int]:
        if isinstance(tile_sizes, int):
            return [tile_sizes] * band.length
        if isinstance(tile_sizes, dict):
            ts = tile_sizes.get(band.start)
            if ts is None:
                return [32] * band.length
            return list(ts) + [ts[-1]] * (band.length - len(ts))
        return list(tile_sizes)[: band.length] + [list(tile_sizes)[-1]] * max(
            0, band.length - len(tile_sizes)
        )

    for ss in scan:
        new_dims: List[DimSpec] = []
        d = 0
        nd = len(ss.dims)
        inserted: List[Tuple[int, Band]] = []   # (insert position, band)
        while d < nd:
            band = next((b for b in bands if b.start == d), None)
            if band is None:
                new_dims.append(ss.dims[d])
                d += 1
                continue
            sizes = sizes_for(band)
            pos = len(new_dims)
            for k in range(band.length):
                spec = ss.dims[band.start + k]
                new_dims.append(
                    DimSpec("tile", dict(spec.phi), tile=sizes[k],
                            sched_dim=band.start, role="tile")
                )
            for k in range(band.length):
                new_dims.append(ss.dims[band.start + k])
            inserted.append((pos, band))
            d += band.length
        if wavefront:
            # outermost-first; each insertion shifts deeper y references
            for i, (pos, band) in enumerate(inserted):
                if band.length >= 2 and not band.parallel_first:
                    _insert_wavefront(new_dims, pos)
                    inserted[i + 1:] = [(p + 1, b) for p, b in inserted[i + 1:]]
        ss.dims = new_dims
    return scan


def _insert_wavefront(dims: List[DimSpec], pos: int) -> None:
    """Insert y_pos == y_{pos+1} + y_{pos+2} before the two tile dims at
    ``pos``. Any existing dim phi referencing y variables with index ≥ pos
    is renumbered (+1)."""
    for spec in dims:
        shifted = {}
        for k, v in spec.phi.items():
            if isinstance(k, str) and k.startswith("y_") and k[2:].isdigit() and int(k[2:]) >= pos:
                shifted[_yvar(int(k[2:]) + 1)] = v
            else:
                shifted[k] = v
        spec.phi = shifted
    wave_phi = {_yvar(pos + 1): Fraction(1), _yvar(pos + 2): Fraction(1)}
    dims.insert(pos, DimSpec("eq", wave_phi, sched_dim=dims[pos].sched_dim,
                             role="wave"))
    # the first tile counter inside the wave spans the wavefront (the
    # second is pinned by the equality): mark it parallel for the shared
    # level_parallel marking (legal by band permutability)
    dims[pos + 1].role = "wave_par"
