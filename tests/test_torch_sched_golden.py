"""The port's PolyTOPS scheduler (``repro_torch.core``) against the
reference's frozen golden-schedule corpus (``artifacts/golden_schedules``).

Every kernel × strategy combo (and the pluto ``fmax``/``fno`` fusion
extremes) must come out of the port's ``PolyTOPSScheduler`` with the port's
``STRATEGIES`` bit for bit as frozen: rows, bands, parallel, fallback,
solver tag and the serialized schedule tree, dumped as
``scripts/golden_schedules.py``'s ``schedule_dump`` dumps them.

The port carries no SCoP suites, so each kernel is built by the
reference's builders (``scops_polybench``/``scops_npu``) with their
module-level ``Scop`` rebound to the port's class; a walk of the result
checks that no object of the reference package reaches the port's
scheduler.  The ``__autotune`` combos freeze the measured autotuner's
static winner, which the port does not carry.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from repro.core import scops_npu, scops_polybench
from repro_torch.core import config as CFG
from repro_torch.core import scop as tscop
from repro_torch.core.ilp import SOLVER_TAG
from repro_torch.core.schedtree import schedule_tree, tree_to_json
from repro_torch.core.scheduler import PolyTOPSScheduler

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "artifacts" / "golden_schedules"
#: combo suffix -> (strategy, fusion mode or None)
STYLES = {"pluto": ("pluto", None), "tensor": ("tensor", None),
          "pluto_fmax": ("pluto", "max"), "pluto_fno": ("pluto", "no")}
COMBOS = sorted(p.stem for p in GOLDEN_DIR.glob("*.json")
                if not p.stem.endswith("__autotune"))
MAKERS = {**scops_polybench.REGISTRY, "npu_trsml": scops_npu.make_trsml,
          "npu_trsmu": scops_npu.make_trsmu, "npu_lu16": scops_npu.make_lu16}


def test_corpus_holds_every_schedule_combo():
    """28 kernels × pluto/tensor, plus the fusion extremes on six."""
    assert len(COMBOS) == 68
    assert {c.split("__")[0] for c in COMBOS} == set(MAKERS)


def port_scop(kernel: str, monkeypatch) -> tscop.Scop:
    """The reference's builder for ``kernel``, building the port's Scop.
    The builders' numpy-side init callables (``np_init``, read only by the
    reference's C backend and oracles) are dropped: they are functions of
    the reference package and take no part in scheduling."""
    monkeypatch.setattr(scops_polybench, "Scop", tscop.Scop)
    monkeypatch.setattr(scops_npu, "Scop", tscop.Scop)
    scop = MAKERS[kernel]()
    scop.np_init = {}
    assert_port_objects(scop)
    return scop


def assert_port_objects(root) -> None:
    """Every object reachable from ``root`` is of the standard library or
    of ``repro_torch``, never of the reference package."""
    seen, stack = set(), [root]
    while stack:
        o = stack.pop()
        if id(o) in seen:
            continue
        seen.add(id(o))
        mod = getattr(type(o), "__module__", "") or ""
        assert not (mod == "repro" or mod.startswith("repro.")), (type(o), o)
        if callable(o) and not isinstance(o, type):
            fmod = getattr(o, "__module__", "") or ""
            assert not (fmod == "repro" or fmod.startswith("repro.")), o
        if isinstance(o, dict):
            stack.extend(o.keys())
            stack.extend(o.values())
        elif isinstance(o, (list, tuple, set, frozenset)):
            stack.extend(o)
        elif hasattr(o, "__dict__") and not isinstance(o, type):
            stack.extend(vars(o).values())


def schedule_dump(sched) -> dict:
    """``scripts/golden_schedules.py``'s dump, of the port's objects."""
    rows = {}
    for idx, rr in sorted(sched.rows.items()):
        rows[str(idx)] = [
            [r.kind, {"|".join(map(str, k)): str(v)
                      for k, v in sorted(r.coeffs.items())}]
            for r in rr
        ]
    try:
        tree = tree_to_json(schedule_tree(sched))
    except ValueError as e:
        tree = {"error": str(e)}
    return {
        "solver": SOLVER_TAG,
        "rows": rows,
        "bands": list(sched.bands),
        "parallel": list(sched.parallel),
        "fallback": bool(sched.fallback),
        "tree": tree,
    }


@pytest.mark.parametrize("combo", COMBOS)
def test_port_scheduler_reproduces_golden_schedule(combo, monkeypatch):
    kernel, style = combo.split("__")
    strategy, fusion = STYLES[style]
    cfg = CFG.STRATEGIES[strategy]()
    if fusion is not None:
        cfg.fusion_mode = fusion
    scop = port_scop(kernel, monkeypatch)
    scheduler = PolyTOPSScheduler(scop, cfg)
    assert type(scheduler.config).__module__ == "repro_torch.core.config"
    sched = scheduler.schedule()
    assert type(sched).__module__ == "repro_torch.core.scheduler"
    golden = json.loads((GOLDEN_DIR / f"{combo}.json").read_text())
    assert schedule_dump(sched) == golden
