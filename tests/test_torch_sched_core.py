"""The port's solver stack (``repro_torch.core``) against the reference's
(``repro.core``) on the same seeded inputs.

* the exact ILP: ``ILPProblem.solve_min`` / ``lexmin`` and
  ``lexsimplex.lexmin`` on seeded numpy-random integer programs (one with
  coefficients past the int64 range), equal as exact ``Fraction``\\ s;
* ``polyhedron``: feasibility, LP minimum/maximum and Fourier–Motzkin
  bounds of random constraint systems;
* ``deps.compute_dependences`` and the Farkas expansion and projection of
  every dependence on polybench SCoPs;
* the cache model's access groups and working sets;
* the measurement-free autotuner: candidate space, static costs and the
  scan+gate's ranked kernel plans;
* the schedule cache: the port's own directory and variable, a second
  process served from disk and faster, and pickles that load in a fresh
  process with neither ``repro`` nor ``jax`` imported;
* an import guard over every module of ``repro_torch``.
"""
from __future__ import annotations

import json
import os
import pickle
import subprocess
import sys
from fractions import Fraction
from pathlib import Path

import numpy as np
import pytest

from repro.core import cachemodel as jcm
from repro.core import deps as jdeps
from repro.core import farkas as jfarkas
from repro.core import ilp as jilp
from repro.core import lexsimplex as jlex
from repro.core import polyhedron as jpoly
from repro.core import schedcache as jsc
from repro.core import scops_polybench
from repro_torch.core import akg as takg
from repro_torch.core import cachemodel as tcm
from repro_torch.core import deps as tdeps
from repro_torch.core import farkas as tfarkas
from repro_torch.core import ilp as tilp
from repro_torch.core import lexsimplex as tlex
from repro_torch.core import polyhedron as tpoly
from repro_torch.core import schedcache as tsc
from repro_torch.core import scop as tscop

SRC = str(Path(__file__).resolve().parent.parent / "src")
VARS = ("x", "y", "z", "w")


def random_ilp(seed: int, scale: int = 1):
    """Integer program over VARS in a box: random rows a·v + b ≥ 0 (some
    equalities) and 1-3 objectives; ``scale`` multiplies every
    coefficient (a large one takes the tableau past int64)."""
    r = np.random.RandomState(seed)
    rows = []
    for _ in range(r.randint(2, 7)):
        expr = {v: int(c) * scale for v, c in zip(VARS, r.randint(-4, 5, len(VARS))) if c}
        expr[1] = int(r.randint(-10, 11)) * scale
        rows.append((expr, "==0" if r.rand() < 0.15 else ">=0"))
    objs = [{v: int(c) for v, c in zip(VARS, r.randint(-3, 4, len(VARS))) if c}
            for _ in range(r.randint(1, 4))]
    ubs = [int(u) for u in r.randint(3, 9, len(VARS))]
    return rows, objs, ubs


def build(ilp_mod, rows, ubs):
    p = ilp_mod.ILPProblem()
    for v, ub in zip(VARS, ubs):
        p.var(v, lb=-ub, ub=ub)
    for expr, kind in rows:
        p.add({k: Fraction(c) for k, c in expr.items()}, kind)
    return p


def solve_all(ilp_mod, lex_mod, rows, objs, ubs):
    """(solve_min of the first objective, ILPProblem.lexmin,
    lexsimplex.lexmin), each None when infeasible."""
    first = build(ilp_mod, rows, ubs).solve_min({k: Fraction(c) for k, c in objs[0].items()})
    objs_f = [{k: Fraction(c) for k, c in o.items()} for o in objs]
    lexmin = build(ilp_mod, rows, ubs).lexmin(objs_f)
    direct = lex_mod.lexmin(build(ilp_mod, rows, ubs), objs_f)
    return first, lexmin, direct


def test_solver_tag_is_the_reference_s():
    assert tilp.SOLVER_TAG == jilp.SOLVER_TAG == tlex.SOLVER_TAG


@pytest.mark.parametrize("seed", range(16))
def test_ilp_and_lexmin_equal_the_reference_exactly(seed):
    rows, objs, ubs = random_ilp(seed)
    got = solve_all(tilp, tlex, rows, objs, ubs)
    want = solve_all(jilp, jlex, rows, objs, ubs)
    assert got == want
    for sol in got[1:]:
        assert sol is None or all(isinstance(v, Fraction) for v in sol.values())


@pytest.mark.parametrize("seed", range(4))
def test_lexmin_past_int64_equals_the_reference(seed):
    rows, objs, ubs = random_ilp(100 + seed, scale=2 ** 40)
    assert solve_all(tilp, tlex, rows, objs, ubs) == solve_all(jilp, jlex, rows, objs, ubs)


def random_system(seed: int):
    """A random rational constraint system over VARS and a parameter N."""
    r = np.random.RandomState(seed)
    cons = [({"N": Fraction(1), 1: Fraction(-4)}, ">=0"),
            ({"N": Fraction(-1), 1: Fraction(64)}, ">=0")]
    for v in VARS:
        cons.append(({v: Fraction(1)}, ">=0"))
        cons.append(({v: Fraction(-1), "N": Fraction(1)}, ">=0"))
    for _ in range(r.randint(1, 5)):
        expr = {v: Fraction(int(c)) for v, c in zip(VARS, r.randint(-3, 4, len(VARS))) if c}
        expr[1] = Fraction(int(r.randint(-6, 7)))
        cons.append((expr, "==0" if r.rand() < 0.1 else ">=0"))
    obj = {v: Fraction(int(c)) for v, c in zip(VARS, r.randint(-2, 3, len(VARS))) if c}
    return cons, obj or {"x": Fraction(1)}


@pytest.mark.parametrize("seed", range(12))
def test_polyhedron_queries_equal_the_reference(seed):
    cons, obj = random_system(seed)

    def queries(poly):
        return (poly.feasible(cons), poly.minimum(cons, obj), poly.maximum(cons, obj),
                poly.bounds_of(cons, "x", ["y", "z", "w"]),
                poly.bounds_of(cons, "y", ["w"], context=cons[:2]))
    assert queries(tpoly) == queries(jpoly)


DEP_KERNELS = ("gemm", "jacobi1d", "trisolv", "fdtd2d", "cholesky", "mvt")


def both_scops(kernel, monkeypatch):
    """The reference's SCoP and the port's, from the reference's builder."""
    ref = scops_polybench.REGISTRY[kernel]()
    monkeypatch.setattr(scops_polybench, "Scop", tscop.Scop)
    port = scops_polybench.REGISTRY[kernel]()
    assert type(port) is tscop.Scop
    return ref, port


def dep_sig(d):
    return (d.id, d.source.index, d.target.index, d.depth, d.loop_independent,
            d.kind, d.array, [(sorted(e.items(), key=str), k) for e, k in d.cons])


def expansion_sig(exp):
    return (exp.multipliers, [(sorted(e.items(), key=str), k) for e, k in exp.rows])


@pytest.mark.parametrize("kernel", DEP_KERNELS)
def test_dependences_and_farkas_equal_the_reference(kernel, monkeypatch):
    ref, port = both_scops(kernel, monkeypatch)
    jd, td = jdeps.compute_dependences(ref), tdeps.compute_dependences(port)
    assert [dep_sig(d) for d in td] == [dep_sig(d) for d in jd]
    assert td and all(type(d) is tdeps.Dependence for d in td)
    for dj, dt in zip(jd, td):
        # the legality form of a dependence: Σ c_v·v + c0 ≥ 0 over it,
        # with one unknown coefficient per variable of its polyhedron
        zs = sorted({k for e, _ in dt.cons for k in e if k != 1}, key=str)
        coef = {z: {f"c_{z}": Fraction(1)} for z in zs}
        const = {"c0": Fraction(1)}
        assert (expansion_sig(tfarkas.farkas_expansion(dt.cons, coef, const, "L"))
                == expansion_sig(jfarkas.farkas_expansion(dj.cons, coef, const, "L")))
        assert (sorted(map(str, tfarkas.project_farkas(dt.cons, coef, const)))
                == sorted(map(str, jfarkas.project_farkas(dj.cons, coef, const))))


@pytest.mark.parametrize("kernel", ("gemm", "mm2", "jacobi2d", "doitgen", "covariance"))
def test_cache_model_equals_the_reference(kernel, monkeypatch):
    ref, port = both_scops(kernel, monkeypatch)
    r = np.random.RandomState(len(kernel))
    for sj, st in zip(ref.statements, port.statements):
        assert tcm.stmt_iter_ranges(port, st) == jcm.stmt_iter_ranges(ref, sj)
        gj, gt = jcm.stmt_access_groups(sj, sj.iters), tcm.stmt_access_groups(st, st.iters)
        assert ([(g.array, g.strides, g.spread) for g in gt]
                == [(g.array, g.strides, g.spread) for g in gj])
        for _ in range(3):
            sizes = [int(s) for s in r.randint(1, 257, len(st.iters))]
            elem = int(r.choice([2, 4, 8]))
            assert (tcm.working_set_bytes(gt, sizes, elem)
                    == jcm.working_set_bytes(gj, sizes, elem))
    assert tcm.default_spec() == tcm.CacheSpec(**vars(jcm.default_spec()))


def test_operator_scops_cache_model_equals_the_reference():
    """The four kernel SCoPs the planners build."""
    from repro.core import akg as jakg
    pairs = [(jakg._matmul_scop(256, 8192, 2048), takg._matmul_scop(256, 8192, 2048)),
             (jakg._scan_gate_scop(256, 8192, 16), takg._scan_gate_scop(256, 8192, 16))]
    for ref, port in pairs:
        for sj, st in zip(ref.statements, port.statements):
            gj, gt = (m.stmt_access_groups(s, s.iters) for m, s in ((jcm, sj), (tcm, st)))
            assert ([(g.array, g.strides, g.spread) for g in gt]
                    == [(g.array, g.strides, g.spread) for g in gj])
            sizes = [128] * len(st.iters)
            assert tcm.working_set_bytes(gt, sizes, 2) == jcm.working_set_bytes(gj, sizes, 2)
            assert takg._iter_extents(port, st) == jakg._iter_extents(ref, sj)


@pytest.mark.parametrize("kernel", ("gemm", "mvt", "jacobi1d", "trmm"))
def test_static_ranking_equals_the_reference(kernel, monkeypatch):
    """The measurement-free autotuner: the enumerated bases, the
    fingerprint-deduplicated candidate space (tile and wavefront variants
    included) and every candidate's static cost."""
    from repro.core import autotune as jat
    from repro_torch.core import autotune as tat
    ref, port = both_scops(kernel, monkeypatch)
    spaces = []
    for at, sc, scop in ((jat, jsc, ref), (tat, tsc, port)):
        scheds = at._schedules_for_space(scop, sc.ScheduleCache(disk=False))
        cands = at.candidate_space(scop, scheds)
        spec = at.CacheSpec(l1_bytes=32 * 1024, l2_bytes=512 * 1024)
        spaces.append([(tc.label, at.static_cost(scop, scheds[tc.base], tc, spec))
                       for tc in cands])
    assert spaces[1] == spaces[0]
    assert len(spaces[0]) > 1


def test_scan_gate_ranking_equals_the_reference():
    """``rank_pallas_plans`` on the fused scan+gate SCoP: the same
    candidates, costs, orders, vector iterators and bands."""
    from repro.core import akg as jakg
    from repro.core import autotune as jat
    from repro_torch.core import autotune as tat
    got = tat.rank_pallas_plans(takg._scan_gate_scop(256, 8192, 16),
                                cache=tsc.ScheduleCache(disk=False))
    want = jat.rank_pallas_plans(jakg._scan_gate_scop(256, 8192, 16),
                                 cache=jsc.ScheduleCache(disk=False))

    def sig(c):
        return (c.config.label, c.static_cost, c.plan.loop_order, c.plan.vector_iter,
                c.plan.bands, c.plan.schedule_str)
    assert [sig(c) for c in got] == [sig(c) for c in want]
    assert got[0].plan.loop_order == ("d", "t", "n")


# ---------------------------------------------------------------------------
# the schedule cache
# ---------------------------------------------------------------------------

def test_cache_directory_and_variable_are_the_port_s(tmp_path, monkeypatch):
    monkeypatch.setenv("HOME", str(tmp_path))
    monkeypatch.delenv("POLYTOPS_TORCH_CACHE_DIR", raising=False)
    monkeypatch.setenv("POLYTOPS_CACHE_DIR", str(tmp_path / "reference"))
    assert tsc.default_cache_dir() == str(tmp_path / ".cache" / "polytops_torch" / "sched")
    assert jsc.default_cache_dir() == str(tmp_path / "reference")
    monkeypatch.setenv("POLYTOPS_TORCH_CACHE_DIR", str(tmp_path / "port"))
    assert tsc.default_cache_dir() == str(tmp_path / "port")
    assert tsc.ScheduleCache().dir == str(tmp_path / "port")


PLAN_SCRIPT = """
import json, sys, time
t0 = time.perf_counter()
from repro_torch.core import akg, schedcache
plan = akg.plan_scan_gate(64, 128, 8)
akg.plan_matmul(128, 128, 64)
dt = time.perf_counter() - t0
st = schedcache.global_cache().stats.as_dict()
print(json.dumps({"seconds": dt, "stats": st, "order": plan.loop_order,
                  "tile": plan.tile, "degraded": plan.degraded,
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("repro", "jax"))}))
"""

LOAD_SCRIPT = """
import json, pickle, sys
from pathlib import Path
mods = set()
n = 0
for p in sorted(Path(sys.argv[1]).rglob("*.pkl")):
    with open(p, "rb") as f:
        obj = pickle.load(f)
    for o in (obj, obj.scop, *obj.deps, getattr(obj, "_tree", None)):
        if o is not None:
            mods.add(type(o).__module__)
    n += 1
print(json.dumps({"n": n, "modules": sorted(mods),
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("repro", "jax"))}))
"""


def run_py(script: str, cache_dir: Path, *args) -> dict:
    env = dict(os.environ, PYTHONPATH=SRC, POLYTOPS_TORCH_CACHE_DIR=str(cache_dir))
    out = subprocess.run([sys.executable, "-c", script, *map(str, args)], env=env,
                         capture_output=True, text=True, timeout=300, check=True)
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_second_process_hits_disk_and_pickles_load_without_reference(tmp_path):
    cache_dir = tmp_path / "sched"
    cold = run_py(PLAN_SCRIPT, cache_dir)
    warm = run_py(PLAN_SCRIPT, cache_dir)
    assert cold["foreign"] == warm["foreign"] == []
    assert cold["stats"]["disk_hits"] == 0 and cold["stats"]["misses"] > 0
    assert warm["stats"]["disk_hits"] > 0 and warm["stats"]["misses"] == 0
    assert warm["seconds"] < cold["seconds"]
    assert (warm["order"], warm["tile"]) == (cold["order"], cold["tile"])
    assert not cold["degraded"] and not warm["degraded"]
    loaded = run_py(LOAD_SCRIPT, cache_dir, cache_dir)
    assert loaded["n"] > 0 and loaded["foreign"] == []
    assert {"repro_torch.core.scheduler", "repro_torch.core.scop",
            "repro_torch.core.deps", "repro_torch.core.schedtree"} <= set(loaded["modules"])
    assert all(m.startswith("repro_torch.core.") for m in loaded["modules"])
    with open(next(cache_dir.rglob("*.pkl")), "rb") as f:
        assert type(pickle.load(f)).__module__ == "repro_torch.core.scheduler"


IMPORT_SCRIPT = """
import importlib, json, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
import torch.distributed as dist
print(json.dumps({"n": len(names), "names": names,
                  "group": dist.is_available() and dist.is_initialized(),
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("repro", "jax", "ml_dtypes"))}))
"""


def test_importing_every_port_module_leaves_jax_and_repro_out(tmp_path):
    """Every module of the port in a fresh interpreter, the distributed
    half's among them: none brings in ``jax``, ``ml_dtypes`` or the
    reference, and importing starts no process group."""
    got = run_py(IMPORT_SCRIPT, tmp_path)
    assert got["n"] > 40 and got["foreign"] == [] and not got["group"]
    assert {"repro_torch.launch.roofline", "repro_torch.launch.mesh",
            "repro_torch.launch.dryrun", "repro_torch.model.sharding",
            "repro_torch.optim.grad_compress"} <= set(got["names"])
