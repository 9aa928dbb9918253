"""PolyBench-derived SCoP definitions (paper §IV-B/C, Fig. 2/3/4).

Each ``make_<kernel>()`` builds the SCoP with concrete dataset sizes
(PolyBench MEDIUM-ish, tuned so C-backend runs take O(0.1–1 s) on this
box). Scalar accumulators of the original C kernels are modeled as
1-element arrays (the polyhedral representation is identical).

Kernels whose optimization needs negative schedule coefficients
(nussinov, deriche, adi) fall back to the original schedule — exactly
the behaviour the paper reports for PolyTOPS and Pluto; nussinov's
body is additionally non-affine (max), so it is represented here by its
affine core only for fallback demonstration.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

from .scop import Scop

SIZE = {
    "gemm": 420, "mm2": 260, "mm3": 220, "atax": 1900, "bicg": 1900,
    "mvt": 2000, "gesummv": 1300, "gemver": 2000, "symm": 300,
    "syrk": 320, "syr2k": 260, "trmm": 340, "trisolv": 2000,
    "cholesky": 340, "lu": 300, "gramschmidt": 240,
    "covariance": 300, "correlation": 300, "doitgen": (128, 128, 64),
    "jacobi1d": (500, 16000), "jacobi2d": (100, 450),
    "heat3d": (60, 90), "fdtd2d": (120, 400), "seidel2d": (60, 400),
    "durbin": 1200,
}

Registry = Dict[str, Callable[[], Scop]]
REGISTRY: Registry = {}


def register(fn):
    REGISTRY[fn.__name__.replace("make_", "")] = fn
    return fn


@register
def make_gemm(n: Optional[int] = None) -> Scop:
    n = n or SIZE["gemm"]
    k = Scop("gemm", params={"N": n, "M": n, "K": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "M"):
            k.stmt("C[i,j] = C[i,j] * beta")
            with k.loop("kk", 0, "K"):
                k.stmt("C[i,j] = C[i,j] + alpha * A[i,kk] * B[kk,j]")
    return k


@register
def make_mm2(n: Optional[int] = None) -> Scop:
    n = n or SIZE["mm2"]
    k = Scop("mm2", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            k.stmt("tmp[i,j] = 0.0 * zero")
            with k.loop("kk", 0, "N"):
                k.stmt("tmp[i,j] = tmp[i,j] + alpha * A[i,kk] * B[kk,j]")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "N"):
            k.stmt("D[i2,j2] = D[i2,j2] * beta")
            with k.loop("k2", 0, "N"):
                k.stmt("D[i2,j2] = D[i2,j2] + tmp[i2,k2] * C[k2,j2]")
    return k


@register
def make_mm3(n: Optional[int] = None) -> Scop:
    n = n or SIZE["mm3"]
    k = Scop("mm3", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            k.stmt("E[i,j] = 0.0 * zero")
            with k.loop("kk", 0, "N"):
                k.stmt("E[i,j] = E[i,j] + A[i,kk] * B[kk,j]")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "N"):
            k.stmt("F[i2,j2] = 0.0 * zero")
            with k.loop("k2", 0, "N"):
                k.stmt("F[i2,j2] = F[i2,j2] + C[i2,k2] * D[k2,j2]")
    with k.loop("i3", 0, "N"):
        with k.loop("j3", 0, "N"):
            k.stmt("G[i3,j3] = 0.0 * zero")
            with k.loop("k3", 0, "N"):
                k.stmt("G[i3,j3] = G[i3,j3] + E[i3,k3] * F[k3,j3]")
    return k


@register
def make_atax(n: Optional[int] = None) -> Scop:
    n = n or SIZE["atax"]
    k = Scop("atax", params={"N": n, "M": n})
    with k.loop("i0", 0, "N"):
        k.stmt("y[i0] = 0.0 * zero")
    with k.loop("i", 0, "M"):
        k.stmt("tmp[i] = 0.0 * zero")
        with k.loop("j", 0, "N"):
            k.stmt("tmp[i] = tmp[i] + A[i,j] * x[j]")
        with k.loop("j2", 0, "N"):
            k.stmt("y[j2] = y[j2] + A[i,j2] * tmp[i]")
    return k


@register
def make_bicg(n: Optional[int] = None) -> Scop:
    n = n or SIZE["bicg"]
    k = Scop("bicg", params={"N": n, "M": n})
    with k.loop("i0", 0, "M"):
        k.stmt("s[i0] = 0.0 * zero")
    with k.loop("i", 0, "N"):
        k.stmt("q[i] = 0.0 * zero")
        with k.loop("j", 0, "M"):
            k.stmt("s[j] = s[j] + r[i] * A[i,j]")
            k.stmt("q[i] = q[i] + A[i,j] * p[j]")
    return k


@register
def make_mvt(n: Optional[int] = None) -> Scop:
    n = n or SIZE["mvt"]
    k = Scop("mvt", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            k.stmt("x1[i] = x1[i] + A[i,j] * y1[j]")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "N"):
            k.stmt("x2[i2] = x2[i2] + A[j2,i2] * y2[j2]")
    return k


@register
def make_gesummv(n: Optional[int] = None) -> Scop:
    n = n or SIZE["gesummv"]
    k = Scop("gesummv", params={"N": n})
    with k.loop("i", 0, "N"):
        k.stmt("tmp[i] = 0.0 * zero")
        k.stmt("y[i] = 0.0 * zero")
        with k.loop("j", 0, "N"):
            k.stmt("tmp[i] = A[i,j] * x[j] + tmp[i]")
            k.stmt("y[i] = B[i,j] * x[j] + y[i]")
        k.stmt("y[i] = alpha * tmp[i] + beta * y[i]", name="S4")
    return k


@register
def make_gemver(n: Optional[int] = None) -> Scop:
    n = n or SIZE["gemver"]
    k = Scop("gemver", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "N"):
            k.stmt("A[i,j] = A[i,j] + u1[i] * v1[j] + u2[i] * v2[j]")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "N"):
            k.stmt("x[i2] = x[i2] + beta * A[j2,i2] * y[j2]")
    with k.loop("i3", 0, "N"):
        k.stmt("x[i3] = x[i3] + z[i3]")
    with k.loop("i4", 0, "N"):
        with k.loop("j4", 0, "N"):
            k.stmt("w[i4] = w[i4] + alpha * A[i4,j4] * x[j4]")
    return k


@register
def make_symm(n: Optional[int] = None) -> Scop:
    n = n or SIZE["symm"]
    k = Scop("symm", params={"N": n, "M": n})
    # C := alpha*A*B + beta*C with A symmetric (lower stored)
    with k.loop("i", 0, "M"):
        with k.loop("j", 0, "N"):
            with k.loop("kk", 0, "i"):
                k.stmt("C[kk,j] = C[kk,j] + alpha * B[i,j] * A[i,kk]")
                k.stmt("temp2[i,j] = temp2[i,j] + B[kk,j] * A[i,kk]")
            k.stmt("C[i,j] = beta * C[i,j] + alpha * B[i,j] * A[i,i] + alpha * temp2[i,j]")
    return k


@register
def make_syrk(n: Optional[int] = None) -> Scop:
    n = n or SIZE["syrk"]
    k = Scop("syrk", params={"N": n, "M": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "i+1"):
            k.stmt("C[i,j] = C[i,j] * beta")
        with k.loop("kk", 0, "M"):
            with k.loop("j2", 0, "i+1"):
                k.stmt("C[i,j2] = C[i,j2] + alpha * A[i,kk] * A[j2,kk]")
    return k


@register
def make_syr2k(n: Optional[int] = None) -> Scop:
    n = n or SIZE["syr2k"]
    k = Scop("syr2k", params={"N": n, "M": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "i+1"):
            k.stmt("C[i,j] = C[i,j] * beta")
        with k.loop("kk", 0, "M"):
            with k.loop("j2", 0, "i+1"):
                k.stmt("C[i,j2] = C[i,j2] + A[j2,kk]*alpha*B[i,kk] + B[j2,kk]*alpha*A[i,kk]")
    return k


@register
def make_trmm(n: Optional[int] = None) -> Scop:
    n = n or SIZE["trmm"]
    k = Scop("trmm", params={"N": n, "M": n})
    with k.loop("i", 0, "M"):
        with k.loop("j", 0, "N"):
            with k.loop("kk", "i+1", "M"):
                k.stmt("B[i,j] = B[i,j] + A[kk,i] * B[kk,j]")
            k.stmt("B[i,j] = alpha * B[i,j]")
    return k


@register
def make_trisolv(n: Optional[int] = None) -> Scop:
    n = n or SIZE["trisolv"]
    k = Scop("trisolv", params={"N": n})
    with k.loop("i", 0, "N"):
        k.stmt("x[i] = b[i]")
        with k.loop("j", 0, "i"):
            k.stmt("x[i] = x[i] - L[i,j] * x[j]")
        k.stmt("x[i] = x[i] / L[i,i]")
    k.c_init["L"] = (
        "((i0 == i1) ? (2.0 * N) : (0.5 * ((double)((i0*7 + i1*13) % 251)) / 251.0))"
    )
    return k


@register
def make_cholesky(n: Optional[int] = None) -> Scop:
    n = n or SIZE["cholesky"]
    k = Scop("cholesky", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "i"):
            with k.loop("kk", 0, "j"):
                k.stmt("A[i,j] = A[i,j] - A[i,kk] * A[j,kk]")
            k.stmt("A[i,j] = A[i,j] / A[j,j]")
        with k.loop("k2", 0, "i"):
            k.stmt("A[i,i] = A[i,i] - A[i,k2] * A[i,k2]")
        k.stmt("A[i,i] = sqrt(A[i,i])")
    # positive-definite input (diagonally dominant), as in PolyBench init
    k.c_init["A"] = (
        "((i0 == i1) ? (2.0 * N) : 0.0)"
        " + ((double)((i0*7 + i1*13 + 3) % 251)) / 251.0"
    )
    k.np_init["A"] = _spd_init
    return k


def _spd_init(shape, rng):
    """Symmetric diagonally-dominant (hence positive-definite) matrix —
    the numpy oracle's counterpart of the cholesky ``c_init`` above;
    with the default noise init the factorization hits ``sqrt`` of
    negative intermediates and fills A with NaNs."""
    import numpy as np

    n = shape[0]
    a = rng.standard_normal(shape) * 0.1 + 1.0
    a = (a + a.T) / 2.0
    a[np.diag_indices(n)] = 2.0 * n
    return a


@register
def make_lu(n: Optional[int] = None) -> Scop:
    n = n or SIZE["lu"]
    k = Scop("lu", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "i"):
            with k.loop("kk", 0, "j"):
                k.stmt("A[i,j] = A[i,j] - A[i,kk] * A[kk,j]")
            k.stmt("A[i,j] = A[i,j] / A[j,j]")
        with k.loop("j2", "i", "N"):
            with k.loop("k2", 0, "i"):
                k.stmt("A[i,j2] = A[i,j2] - A[i,k2] * A[k2,j2]")
    k.c_init["A"] = (
        "((i0 == i1) ? (2.0 * N) : 0.0)"
        " + ((double)((i0*7 + i1*13 + 3) % 251)) / 251.0"
    )
    return k


@register
def make_gramschmidt(n: Optional[int] = None) -> Scop:
    n = n or SIZE["gramschmidt"]
    k = Scop("gramschmidt", params={"N": n, "M": n})
    with k.loop("kk", 0, "N"):
        k.stmt("nrm[kk] = 0.0 * zero")
        with k.loop("i", 0, "M"):
            k.stmt("nrm[kk] = nrm[kk] + A[i,kk] * A[i,kk]")
        k.stmt("R[kk,kk] = sqrt(nrm[kk])")
        with k.loop("i2", 0, "M"):
            k.stmt("Q[i2,kk] = A[i2,kk] / R[kk,kk]")
        with k.loop("j", "kk+1", "N"):
            k.stmt("R[kk,j] = 0.0 * zero")
            with k.loop("i3", 0, "M"):
                k.stmt("R[kk,j] = R[kk,j] + Q[i3,kk] * A[i3,j]")
            with k.loop("i4", 0, "M"):
                k.stmt("A[i4,j] = A[i4,j] - Q[i4,kk] * R[kk,j]")
    return k


@register
def make_covariance(n: Optional[int] = None) -> Scop:
    n = n or SIZE["covariance"]
    k = Scop("covariance", params={"N": n, "M": n})
    with k.loop("j", 0, "M"):
        k.stmt("mean[j] = 0.0 * zero")
        with k.loop("i", 0, "N"):
            k.stmt("mean[j] = mean[j] + data[i,j]")
        k.stmt("mean[j] = mean[j] / fn")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "M"):
            k.stmt("data[i2,j2] = data[i2,j2] - mean[j2]")
    with k.loop("i3", 0, "M"):
        with k.loop("j3", "i3", "M"):
            k.stmt("cov[i3,j3] = 0.0 * zero")
            with k.loop("k3", 0, "N"):
                k.stmt("cov[i3,j3] = cov[i3,j3] + data[k3,i3] * data[k3,j3]")
            k.stmt("cov[i3,j3] = cov[i3,j3] / (fn - 1.0)")
            k.stmt("cov[j3,i3] = cov[i3,j3]")
    return k


@register
def make_correlation(n: Optional[int] = None) -> Scop:
    n = n or SIZE["correlation"]
    k = Scop("correlation", params={"N": n, "M": n})
    with k.loop("j", 0, "M"):
        k.stmt("mean[j] = 0.0 * zero")
        with k.loop("i", 0, "N"):
            k.stmt("mean[j] = mean[j] + data[i,j]")
        k.stmt("mean[j] = mean[j] / fn")
    with k.loop("j1", 0, "M"):
        k.stmt("stddev[j1] = 0.0 * zero")
        with k.loop("i1", 0, "N"):
            k.stmt("stddev[j1] = stddev[j1] + (data[i1,j1]-mean[j1]) * (data[i1,j1]-mean[j1])")
        k.stmt("stddev[j1] = sqrt(stddev[j1] / fn) + eps")
    with k.loop("i2", 0, "N"):
        with k.loop("j2", 0, "M"):
            k.stmt("data[i2,j2] = (data[i2,j2] - mean[j2]) / (sqrt(fn) * stddev[j2])")
    with k.loop("i3", 0, "M"):
        k.stmt("corr[i3,i3] = 1.0 * one")
        with k.loop("j3", "i3+1", "M"):
            k.stmt("corr[i3,j3] = 0.0 * zero")
            with k.loop("k3", 0, "N"):
                k.stmt("corr[i3,j3] = corr[i3,j3] + data[k3,i3] * data[k3,j3]")
            k.stmt("corr[j3,i3] = corr[i3,j3]")
    return k


@register
def make_doitgen(sz: Optional[Tuple[int, int, int]] = None) -> Scop:
    r, q, p = sz or SIZE["doitgen"]
    k = Scop("doitgen", params={"R": r, "Q": q, "P": p})
    with k.loop("r", 0, "R"):
        with k.loop("q", 0, "Q"):
            with k.loop("p", 0, "P"):
                k.stmt("sum[r,q,p] = 0.0 * zero")
                with k.loop("s", 0, "P"):
                    k.stmt("sum[r,q,p] = sum[r,q,p] + A[r,q,s] * C4[s,p]")
            with k.loop("p2", 0, "P"):
                k.stmt("A[r,q,p2] = sum[r,q,p2]")
    return k


@register
def make_jacobi1d(sz: Optional[Tuple[int, int]] = None) -> Scop:
    t, n = sz or SIZE["jacobi1d"]
    k = Scop("jacobi1d", params={"T": t, "N": n})
    with k.loop("t", 0, "T"):
        with k.loop("i", 1, "N-1"):
            k.stmt("B[i] = 0.33333 * (A[i-1] + A[i] + A[i+1])")
        with k.loop("i2", 1, "N-1"):
            k.stmt("A[i2] = 0.33333 * (B[i2-1] + B[i2] + B[i2+1])")
    return k


@register
def make_jacobi2d(sz: Optional[Tuple[int, int]] = None) -> Scop:
    t, n = sz or SIZE["jacobi2d"]
    k = Scop("jacobi2d", params={"T": t, "N": n})
    with k.loop("t", 0, "T"):
        with k.loop("i", 1, "N-1"):
            with k.loop("j", 1, "N-1"):
                k.stmt("B[i,j] = 0.2 * (A[i,j] + A[i,j-1] + A[i,j+1] + A[i+1,j] + A[i-1,j])")
        with k.loop("i2", 1, "N-1"):
            with k.loop("j2", 1, "N-1"):
                k.stmt("A[i2,j2] = 0.2 * (B[i2,j2] + B[i2,j2-1] + B[i2,j2+1] + B[i2+1,j2] + B[i2-1,j2])")
    return k


@register
def make_heat3d(sz: Optional[Tuple[int, int]] = None) -> Scop:
    t, n = sz or SIZE["heat3d"]
    k = Scop("heat3d", params={"T": t, "N": n})
    with k.loop("t", 0, "T"):
        with k.loop("i", 1, "N-1"):
            with k.loop("j", 1, "N-1"):
                with k.loop("m", 1, "N-1"):
                    k.stmt(
                        "B[i,j,m] = 0.125*(A[i+1,j,m]-2.0*A[i,j,m]+A[i-1,j,m])"
                        " + 0.125*(A[i,j+1,m]-2.0*A[i,j,m]+A[i,j-1,m])"
                        " + 0.125*(A[i,j,m+1]-2.0*A[i,j,m]+A[i,j,m-1]) + A[i,j,m]"
                    )
        with k.loop("i2", 1, "N-1"):
            with k.loop("j2", 1, "N-1"):
                with k.loop("m2", 1, "N-1"):
                    k.stmt(
                        "A[i2,j2,m2] = 0.125*(B[i2+1,j2,m2]-2.0*B[i2,j2,m2]+B[i2-1,j2,m2])"
                        " + 0.125*(B[i2,j2+1,m2]-2.0*B[i2,j2,m2]+B[i2,j2-1,m2])"
                        " + 0.125*(B[i2,j2,m2+1]-2.0*B[i2,j2,m2]+B[i2,j2,m2-1]) + B[i2,j2,m2]"
                    )
    return k


@register
def make_fdtd2d(sz: Optional[Tuple[int, int]] = None) -> Scop:
    t, n = sz or SIZE["fdtd2d"]
    k = Scop("fdtd2d", params={"T": t, "N": n, "M": n})
    with k.loop("t", 0, "T"):
        with k.loop("j", 0, "M"):
            k.stmt("ey[0,j] = fict[t]")
        with k.loop("i", 1, "N"):
            with k.loop("j2", 0, "M"):
                k.stmt("ey[i,j2] = ey[i,j2] - 0.5*(hz[i,j2] - hz[i-1,j2])")
        with k.loop("i2", 0, "N"):
            with k.loop("j3", 1, "M"):
                k.stmt("ex[i2,j3] = ex[i2,j3] - 0.5*(hz[i2,j3] - hz[i2,j3-1])")
        with k.loop("i3", 0, "N-1"):
            with k.loop("j4", 0, "M-1"):
                k.stmt("hz[i3,j4] = hz[i3,j4] - 0.7*(ex[i3,j4+1] - ex[i3,j4] + ey[i3+1,j4] - ey[i3,j4])")
    return k


@register
def make_seidel2d(sz: Optional[Tuple[int, int]] = None) -> Scop:
    t, n = sz or SIZE["seidel2d"]
    k = Scop("seidel2d", params={"T": t, "N": n})
    with k.loop("t", 0, "T"):
        with k.loop("i", 1, "N-1"):
            with k.loop("j", 1, "N-1"):
                k.stmt(
                    "A[i,j] = (A[i-1,j-1] + A[i-1,j] + A[i-1,j+1] + A[i,j-1]"
                    " + A[i,j] + A[i,j+1] + A[i+1,j-1] + A[i+1,j] + A[i+1,j+1]) / 9.0"
                )
    return k


@register
def make_durbin(n: Optional[int] = None) -> Scop:
    n = n or SIZE["durbin"]
    # scalar accumulators modeled as 1-element arrays (z: workspace per iter)
    k = Scop("durbin", params={"N": n})
    with k.loop("kk", 1, "N"):
        k.stmt("sum[kk] = 0.0 * zero")
        with k.loop("i", 0, "kk"):
            k.stmt("sum[kk] = sum[kk] + r[kk-i-1] * y[i,kk-1]")
        k.stmt("alpha[kk] = -(r[kk] + sum[kk]) / beta[kk-1]")
        k.stmt("beta[kk] = beta[kk-1] * (1.0 - alpha[kk] * alpha[kk])")
        with k.loop("i2", 0, "kk"):
            k.stmt("y[i2,kk] = y[i2,kk-1] + alpha[kk] * y[kk-i2-1,kk-1]")
        k.stmt("y[kk,kk] = alpha[kk]")
    # keep |alpha| < 1 so the recursion stays bounded
    k.c_init["r"] = "0.01 * ((double)((i0*7 + 3) % 251)) / 251.0"
    k.c_init["y"] = "0.01 * ((double)((i0*7 + i1*13 + 3) % 251)) / 251.0"
    k.c_init["beta"] = "1.0"
    k.c_init["sum"] = "0.0"
    k.c_init["alpha"] = "0.0"
    return k


def all_kernels() -> Registry:
    return dict(REGISTRY)
