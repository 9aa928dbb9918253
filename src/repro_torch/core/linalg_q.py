"""Exact rational linear algebra over fractions.Fraction.

The polyhedral scheduler needs exact arithmetic: rank computations for
the progression constraint (Eq. 3 of the paper), orthogonal complements,
nullspaces, and small inverses. Everything here is dense and tiny
(matrices are at most ~tens of rows), so plain lists of Fractions are
fine and keep the implementation dependency-free and exact.
"""
from __future__ import annotations

from fractions import Fraction
from math import gcd
from typing import List, Sequence

Mat = List[List[Fraction]]
Vec = List[Fraction]


def mat(rows: Sequence[Sequence]) -> Mat:
    return [[Fraction(x) for x in r] for r in rows]


def zeros(m: int, n: int) -> Mat:
    return [[Fraction(0)] * n for _ in range(m)]


def eye(n: int) -> Mat:
    out = zeros(n, n)
    for i in range(n):
        out[i][i] = Fraction(1)
    return out


def matmul(a: Mat, b: Mat) -> Mat:
    n, k, m = len(a), len(b), len(b[0]) if b else 0
    out = zeros(n, m)
    for i in range(n):
        ai = a[i]
        for j in range(m):
            s = Fraction(0)
            for t in range(k):
                if ai[t]:
                    s += ai[t] * b[t][j]
            out[i][j] = s
    return out


def transpose(a: Mat) -> Mat:
    if not a:
        return []
    return [list(col) for col in zip(*a)]


def rref(a: Mat) -> tuple[Mat, list[int]]:
    """Reduced row echelon form; returns (rref_matrix, pivot_columns)."""
    m = [row[:] for row in a]
    rows = len(m)
    cols = len(m[0]) if rows else 0
    pivots: list[int] = []
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        # find pivot
        piv = None
        for i in range(r, rows):
            if m[i][c] != 0:
                piv = i
                break
        if piv is None:
            continue
        m[r], m[piv] = m[piv], m[r]
        pv = m[r][c]
        m[r] = [x / pv for x in m[r]]
        for i in range(rows):
            if i != r and m[i][c] != 0:
                f = m[i][c]
                m[i] = [x - f * y for x, y in zip(m[i], m[r])]
        pivots.append(c)
        r += 1
    return m, pivots


def rank(a: Mat) -> int:
    if not a:
        return 0
    _, pivots = rref(a)
    return len(pivots)


def nullspace(a: Mat) -> Mat:
    """Basis (rows) of the right nullspace of a."""
    if not a:
        return []
    r, pivots = rref(a)
    cols = len(a[0])
    free = [c for c in range(cols) if c not in pivots]
    basis: Mat = []
    for fc in free:
        v = [Fraction(0)] * cols
        v[fc] = Fraction(1)
        for i, pc in enumerate(pivots):
            v[pc] = -r[i][fc]
        basis.append(v)
    return basis


def inverse(a: Mat) -> Mat:
    n = len(a)
    aug = [a[i][:] + eye(n)[i] for i in range(n)]
    r, pivots = rref(aug)
    if pivots[:n] != list(range(n)):
        raise ValueError("matrix not invertible")
    return [row[n:] for row in r]


def det(a: Mat) -> Fraction:
    n = len(a)
    m = [row[:] for row in a]
    d = Fraction(1)
    for c in range(n):
        piv = None
        for i in range(c, n):
            if m[i][c] != 0:
                piv = i
                break
        if piv is None:
            return Fraction(0)
        if piv != c:
            m[c], m[piv] = m[piv], m[c]
            d = -d
        d *= m[c][c]
        pv = m[c][c]
        for i in range(c + 1, n):
            if m[i][c] != 0:
                f = m[i][c] / pv
                m[i] = [x - f * y for x, y in zip(m[i], m[c])]
    return d


def row_basis(h: Mat) -> Mat:
    """Linearly independent subset of rows (rref pivot rows, int-scaled)."""
    if not h:
        return []
    r, pivots = rref(h)
    return batch_scale_to_int(r[: len(pivots)])


def orth_complement_rows(h: Mat, n: int) -> Mat:
    """H⊥ = I − Hᵀ(HHᵀ)⁻¹H for row-space H (paper Eq. 3 support).

    ``h`` holds previously found schedule rows (each of length n). Returns
    the projector onto the orthogonal complement of their row space, with
    each row scaled to coprime integers (LP-friendly). H is reduced to a
    row basis first so zero/dependent rows never make HHᵀ singular.
    """
    h = row_basis(h)
    if not h:
        return eye(n)
    hht = matmul(h, transpose(h))
    proj = matmul(matmul(transpose(h), inverse(hht)), h)
    comp = eye(n)
    for i in range(n):
        for j in range(n):
            comp[i][j] -= proj[i][j]
    return batch_scale_to_int(
        [row for row in comp if any(x != 0 for x in row)])


def orth_complement_basis(h: Mat, n: int) -> Mat:
    """A row *basis* of the orthogonal complement (rref pivot rows of the
    projector, integer-scaled). Using a basis instead of all projector
    rows avoids the degenerate case where two rows are negatives of each
    other and the paper's Σᵢ H⊥ᵢ·h ≥ 1 constraint becomes infeasible."""
    rows = orth_complement_rows(h, n)
    if not rows:
        return []
    r, pivots = rref(rows)
    return batch_scale_to_int(r[: len(pivots)])


def scale_to_int(row: Vec) -> Vec:
    """Scale a rational row to the smallest integer row (same direction)."""
    denoms = [x.denominator for x in row]
    l = 1
    for d in denoms:
        l = l * d // gcd(l, d)
    ints = [int(x * l) for x in row]
    g = 0
    for v in ints:
        g = gcd(g, abs(v))
    if g > 1:
        ints = [v // g for v in ints]
    return [Fraction(v) for v in ints]


def batch_scale_to_int(rows: Mat) -> Mat:
    """:func:`scale_to_int` over many rows — the single entry point the
    basis/projector helpers funnel through (a vectorized implementation
    would slot in here)."""
    return [scale_to_int(r) for r in rows]


def rationals_to_int_row(vals: Sequence[Fraction]) -> tuple[List[int], int]:
    """Scale a rational row to ``(integer_row, den)`` with
    ``integer_row[i] / den == vals[i]`` and ``den`` the lcm of the
    denominators (1 for already-integer rows — the common case for
    normalized constraint systems, returned without any multiplication).
    This is the Fraction→integer boundary of the exact simplex tableau
    (``repro_torch.core.lexsimplex``): every constraint row and objective
    crosses through here exactly once."""
    den = 1
    for v in vals:
        d = v.denominator
        if d != 1:
            den = den * d // gcd(den, d)
    if den == 1:
        return [v.numerator for v in vals], 1
    return [int(v * den) for v in vals], den


def fractions_to_float_array(vals: Sequence[Fraction]):
    """Batched exact→float conversion (numpy float64 array).

    Fast path: when every value fits int64 as numerator/denominator
    pairs, the division runs vectorized in numpy instead of calling
    ``Fraction.__float__`` per element — this is the Fraction→numeric
    boundary the compiled ILP layer crosses for every constraint row.
    Falls back to per-element conversion for huge rationals."""
    import numpy as np

    try:
        num = np.array([v.numerator for v in vals], dtype=np.int64)
        den = np.array([v.denominator for v in vals], dtype=np.int64)
        return num / den
    except (OverflowError, TypeError):
        return np.array([float(v) for v in vals], dtype=np.float64)


def hnf_row(a: List[List[int]]) -> tuple[List[List[int]], List[List[int]]]:
    """Row-style Hermite Normal Form: returns (H, U) with U·A = H, U unimodular.

    Used by codegen to detect strides of non-unimodular schedule maps.
    """
    m = [row[:] for row in a]
    rows = len(m)
    cols = len(m[0]) if rows else 0
    u = [[1 if i == j else 0 for j in range(rows)] for i in range(rows)]
    r = 0
    for c in range(cols):
        if r >= rows:
            break
        # euclidean elimination below the pivot
        while True:
            nz = [i for i in range(r, rows) if m[i][c] != 0]
            if not nz:
                break
            piv = min(nz, key=lambda i: abs(m[i][c]))
            m[r], m[piv] = m[piv], m[r]
            u[r], u[piv] = u[piv], u[r]
            done = True
            for i in range(r + 1, rows):
                if m[i][c] != 0:
                    q = m[i][c] // m[r][c]
                    m[i] = [x - q * y for x, y in zip(m[i], m[r])]
                    u[i] = [x - q * y for x, y in zip(u[i], u[r])]
                    if m[i][c] != 0:
                        done = False
            if done:
                break
        if m[r][c] != 0:
            if m[r][c] < 0:
                m[r] = [-x for x in m[r]]
                u[r] = [-x for x in u[r]]
            # reduce above
            for i in range(r):
                if m[i][c] % m[r][c] != 0 or m[i][c] != 0:
                    q = m[i][c] // m[r][c]
                    if q:
                        m[i] = [x - q * y for x, y in zip(m[i], m[r])]
                        u[i] = [x - q * y for x, y in zip(u[i], u[r])]
            r += 1
    return m, u
