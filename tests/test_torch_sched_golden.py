"""The port's PolyTOPS scheduler (``repro_torch.core``) against the
reference's frozen golden-schedule corpus (``artifacts/golden_schedules``).

Every kernel × strategy combo (and the pluto ``fmax``/``fno`` fusion
extremes) must come out of the port's ``PolyTOPSScheduler`` with the port's
``STRATEGIES`` bit for bit as frozen: rows, bands, parallel, fallback,
solver tag and the serialized schedule tree, dumped as
``scripts/golden_schedules.py``'s ``schedule_dump`` dumps them.  The six
``__autotune`` combos freeze the autotuner's static winner: the port's
``autotune(measure=False)`` against a fixed ``CacheSpec`` and a throwaway
cache must give the same winner, label, ranker and top eight ranked
candidates, dumped as ``autotune_dump`` dumps them.

Each kernel is built by the port's own suites
(``repro_torch.core.scops_polybench``/``scops_npu``); a walk of the result
checks that no object of the reference package reaches the port's
scheduler.
"""
from __future__ import annotations

import json
from pathlib import Path

import pytest

from repro_torch.core import config as CFG
from repro_torch.core import scop as tscop
from repro_torch.core import scops_npu, scops_polybench
from repro_torch.core.ilp import SOLVER_TAG
from repro_torch.core.schedtree import schedule_tree, tree_to_json
from repro_torch.core.scheduler import PolyTOPSScheduler

GOLDEN_DIR = Path(__file__).resolve().parent.parent / "artifacts" / "golden_schedules"
#: combo suffix -> (strategy, fusion mode or None)
STYLES = {"pluto": ("pluto", None), "tensor": ("tensor", None),
          "pluto_fmax": ("pluto", "max"), "pluto_fno": ("pluto", "no")}
COMBOS = sorted(p.stem for p in GOLDEN_DIR.glob("*.json")
                if not p.stem.endswith("__autotune"))
AUTOTUNE_COMBOS = sorted(p.stem for p in GOLDEN_DIR.glob("*__autotune.json"))
MAKERS = {**scops_polybench.REGISTRY, "npu_trsml": scops_npu.make_trsml,
          "npu_trsmu": scops_npu.make_trsmu, "npu_lu16": scops_npu.make_lu16}


def test_corpus_holds_every_schedule_combo():
    """28 kernels × pluto/tensor, plus the fusion extremes on six, plus
    the static autotune winners of six: 74 combos."""
    assert len(COMBOS) == 68
    assert {c.split("__")[0] for c in COMBOS} == set(MAKERS)
    assert [c.split("__")[0] for c in AUTOTUNE_COMBOS] == \
        ["gemm", "gesummv", "jacobi1d", "jacobi2d", "mvt", "trmm"]
    assert len(COMBOS) + len(AUTOTUNE_COMBOS) == 74


def port_scop(kernel: str) -> tscop.Scop:
    """The port's builder for ``kernel``, holding only objects of the
    standard library or of ``repro_torch``."""
    scop = MAKERS[kernel]()
    assert type(scop) is tscop.Scop
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
def test_port_scheduler_reproduces_golden_schedule(combo):
    kernel, style = combo.split("__")
    strategy, fusion = STYLES[style]
    cfg = CFG.STRATEGIES[strategy]()
    if fusion is not None:
        cfg.fusion_mode = fusion
    scop = port_scop(kernel)
    scheduler = PolyTOPSScheduler(scop, cfg)
    assert type(scheduler.config).__module__ == "repro_torch.core.config"
    sched = scheduler.schedule()
    assert type(sched).__module__ == "repro_torch.core.scheduler"
    golden = json.loads((GOLDEN_DIR / f"{combo}.json").read_text())
    assert schedule_dump(sched) == golden


def autotune_dump(scop) -> dict:
    """``scripts/golden_schedules.py``'s ``autotune_dump``, of the port's
    autotuner."""
    from repro_torch.core.autotune import SPACE_VERSION, autotune
    from repro_torch.core.cachemodel import CacheSpec
    from repro_torch.core.schedcache import ScheduleCache

    r = autotune(scop, measure=False, use_cache=False,
                 cache=ScheduleCache(disk=False), spec=CacheSpec())
    assert type(r.config).__module__ == "repro_torch.core.autotune"
    dump = {
        "solver": SOLVER_TAG,
        "space_version": SPACE_VERSION,
        "winner": r.to_dict()["config"],
        "label": r.config.label,
        "ranker": r.ranker,
        "ranked": r.ranked[:8],
    }
    # tuples → lists, exactly as a reloaded golden file sees them
    return json.loads(json.dumps(dump))


@pytest.mark.parametrize("combo", AUTOTUNE_COMBOS)
def test_port_autotuner_reproduces_golden_winner(combo):
    kernel = combo.split("__")[0]
    golden = json.loads((GOLDEN_DIR / f"{combo}.json").read_text())
    assert autotune_dump(port_scop(kernel)) == golden
