"""MindSpore/AKG hybrid custom-operator SCoPs (paper §IV-A, Table I).

The paper evaluates three NPU custom operators: an LU decomposition,
``trsmL_off_diag`` (paper Listing 4) and ``trsmU_transpose``. Shapes are
(rows × cols) with the columns grouped into 16-wide vector lanes
(`l`/`k` loops), matching Ascend's vector unit; on the CPU measurement
backend the 16-lane axis maps to one SIMD-width strip.

The paper's directive configuration — *vectorize k* — is expressed with
the same PolyTOPS directive interface; the baseline is the isl-style
strategy, which (as the paper describes) hoists the parallel ``l``/``k``
dims outermost and loses vectorization.
"""
from __future__ import annotations

from typing import Dict, Tuple

from .config import Directive, DimConfig, SchedulerConfig, tensor_style
from .scop import Scop

V = 16  # vector-lane width of the paper's operators


def make_trsml(rows: int = 16, mid: int = 16, cols: int = 16) -> Scop:
    """trsmL_off_diag (paper Listing 4a): row×mid triangular update of a
    row×cols RHS, cols grouped into 16-lane strips."""
    L = max(cols // V, 1)
    k = Scop("trsml", params={"R": rows, "L": L})
    with k.loop("i", 0, "R"):
        with k.loop("j", 0, "i"):          # triangular, as in paper Listing 4
            with k.loop("l", 0, "L"):
                with k.loop("kv", 0, V):
                    k.stmt(f"inv0[i,l*{V}+kv] = a[i,j] * b[j,l*{V}+kv]")
                    k.stmt(f"b[i,l*{V}+kv] = b[i,l*{V}+kv] - inv0[i,l*{V}+kv]")
    return k


def make_trsmu(rows: int = 16, mid: int = 16, cols: int = 16) -> Scop:
    """trsmU_transpose: like trsmL but the triangular operand is accessed
    transposed (a[j,i]) — the interchange matters even more."""
    L = max(cols // V, 1)
    k = Scop("trsmu", params={"R": max(rows, mid), "L": L})
    with k.loop("i", 0, "R"):
        with k.loop("j", 0, "i"):          # triangular; a accessed transposed
            with k.loop("l", 0, "L"):
                with k.loop("kv", 0, V):
                    k.stmt(f"inv0[i,l*{V}+kv] = a[j,i] * b[j,l*{V}+kv]")
                    k.stmt(f"b[i,l*{V}+kv] = b[i,l*{V}+kv] - inv0[i,l*{V}+kv]")
    return k


def make_lu16(n: int = 16) -> Scop:
    """16×16 LU decomposition block (paper Table I row 1)."""
    k = Scop("lu16", params={"N": n})
    with k.loop("i", 0, "N"):
        with k.loop("j", 0, "i"):
            with k.loop("kk", 0, "j"):
                k.stmt("A[i,j] = A[i,j] - A[i,kk] * A[kk,j]")
            k.stmt("A[i,j] = A[i,j] / A[j,j]")
        with k.loop("j2", "i", "N"):
            with k.loop("k2", 0, "i"):
                k.stmt("A[i,j2] = A[i,j2] - A[i,k2] * A[k2,j2]")
    return k


def directive_config() -> SchedulerConfig:
    """The paper's manual configuration (Listing 4a): parallel(l),
    vectorize(kv); contiguity+proximity for the rest."""
    cfg = tensor_style()
    cfg.name = "polytops-directives"
    cfg.directives = [
        Directive("parallel", [0, 1], 2),
        Directive("vectorize", [0], 3),
        Directive("vectorize", [1], 3),
    ]
    return cfg


def autovec_config() -> SchedulerConfig:
    """§IV-A last paragraph: the same effect from auto-vectorization +
    proximity, with no per-kernel manual directives."""
    cfg = tensor_style()
    cfg.name = "polytops-autovec"
    cfg.auto_vectorize = True
    return cfg


def baseline_config() -> SchedulerConfig:
    """AKG's isl behaviour on the NPU (paper §IV-A): detected-parallel
    loops are hoisted outermost (outer parallelism for block mapping), so
    the contiguous dim ends up away from the innermost position and
    vectorization is lost. Modeled as: demand coincidence (zero-distance)
    for the outer dims, plain proximity once no parallelism remains."""

    def strategy(state) -> DimConfig:
        if state.parallel_failed:
            return DimConfig(cost_functions=["proximity"])
        if state.dim < 2:
            return DimConfig(cost_functions=["proximity"], require_parallel=True)
        return DimConfig(cost_functions=["proximity"])

    return SchedulerConfig(name="akg-isl-style", strategy=strategy)


TABLE1_SIZES: Dict[str, Tuple[Tuple[int, int, int], ...]] = {
    "trsml": tuple((16, 16, c) for c in (16, 32, 48, 64, 80, 96, 112)),
    "trsmu": tuple((16, m, 16) for m in (16, 32, 48, 64, 80, 96, 112)),
}
