"""The port's kernel plans, now from its own PolyTOPS scheduler
(``repro_torch.core.akg`` through ``repro_torch.plan``).

* **Frozen tiles.** ``FROZEN_TILES`` is the table of tiles the port's
  kernels were planned with before the scheduler was in the loop, when
  ``plan.py`` stated fixed loop orders; it was generated from those fixed
  planners at every shape the port launches: ``chip_smoke.py``'s
  ``MM_CASES``/``FLASH_CASES`` and scan cases, each served model's traffic
  (chunk rows 44, 128, 132, 232, 256, 512, 768 and 4096 × its MLP widths,
  its ``(c, max_len, hd)`` and falcon's ``(c, 8192, 16)``), the kernel
  bench's shapes and the plan tests' shapes.  The scheduler's plans must
  have exactly these tiles, so every launch is as it was.
* **The reference's schedule.** At each of those shapes the plan's loop
  order, vector iterator, bands, schedule string and ``degraded`` flag
  must equal the reference's ``akg.plan_*``.
* **The ladder.** A fault injected through the port's
  ``resilience.inject`` gives a degraded plan that is not memoized; the
  next call replans clean (the reference's ``_plan_memo`` rule).

Both packages plan against fresh schedule-cache directories of this
module's own, so every plan here is scheduled cold.
"""
from __future__ import annotations

import importlib.util
from pathlib import Path

import pytest

from repro.core import akg as jakg
from repro.core import schedcache as jsc
from repro_torch import plan as tplan
from repro_torch.core import akg as takg
from repro_torch.core import resilience as tres
from repro_torch.core import schedcache as tsc

FROZEN_TILES = {
    ('matmul', (1, 8, 8)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (16, 64, 128)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (16, 128, 64)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (37, 56, 72)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 768, 2048)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 1024, 8192)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 2048, 768)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 2048, 8192)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 2560, 10240)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 3584, 18944)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 8192, 1024)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 8192, 2048)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 10240, 2560)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 18944, 3584)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (128, 128, 128)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (200, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 256, 256)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2048, 8160)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 512, 512)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (1024, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (2048, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (2048, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (2560, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (3584, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 768, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 2048, 768)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 4096, 4096)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('attention', (8, 32, 16)): {'q': 16, 'kk': 32, 'd': 16},
    ('attention', (16, 48, 16)): {'q': 16, 'kk': 32, 'd': 16},
    ('attention', (44, 384, 64)): {'q': 32, 'kk': 128, 'd': 64},
    ('attention', (44, 384, 128)): {'q': 32, 'kk': 128, 'd': 128},
    ('attention', (44, 384, 256)): {'q': 32, 'kk': 128, 'd': 256},
    ('attention', (44, 1088, 64)): {'q': 32, 'kk': 128, 'd': 64},
    ('attention', (44, 1088, 128)): {'q': 32, 'kk': 128, 'd': 128},
    ('attention', (44, 1088, 256)): {'q': 32, 'kk': 128, 'd': 256},
    ('attention', (100, 1000, 64)): {'q': 64, 'kk': 128, 'd': 64},
    ('attention', (128, 128, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 640, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 640, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (128, 640, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (128, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (128, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (132, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (132, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (132, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (132, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (132, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (132, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (232, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (232, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (232, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (232, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (232, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (232, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 256, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 768, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 768, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (256, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (256, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1536, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 4096, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (512, 512, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (512, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (512, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (512, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (768, 768, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (768, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (768, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (768, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (1088, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (1088, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (1088, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (4096, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (4096, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (4096, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('mamba_scan', (44, 8192, 16)): {'t': 44, 'd': 32, 'n': 16},
    ('mamba_scan', (64, 128, 8)): {'t': 64, 'd': 64, 'n': 8},
    ('mamba_scan', (128, 256, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (128, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (132, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (232, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (256, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (512, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (768, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (4096, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (44, 8192, 16)): {'t': 44, 'd': 32, 'n': 16},
    ('scan_gate', (64, 128, 8)): {'t': 64, 'd': 64, 'n': 8},
    ('scan_gate', (128, 256, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (128, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (132, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (232, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (256, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (512, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (768, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (4096, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
}

#: each operator's loop order and vector iterator
ORDERS = {"matmul": (("i", "kk", "j"), "j"), "attention": (("q", "kk", "d"), "d"),
          "mamba_scan": (("t", "d", "n"), "n"), "scan_gate": (("d", "t", "n"), "n")}
PLANNERS = {"matmul": (tplan.plan_matmul, jakg.plan_matmul),
            "attention": (tplan.plan_attention, jakg.plan_attention),
            "mamba_scan": (tplan.plan_mamba_scan, jakg.plan_mamba_scan),
            "scan_gate": (tplan.plan_scan_gate, jakg.plan_scan_gate)}


@pytest.fixture(scope="module", autouse=True)
def fresh_schedule_caches(tmp_path_factory):
    """Both packages' schedule caches in directories of this module's
    own, each package's global cache rebuilt on them."""
    root = tmp_path_factory.mktemp("sched")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("POLYTOPS_TORCH_CACHE_DIR", str(root / "port"))
        mp.setenv("POLYTOPS_CACHE_DIR", str(root / "reference"))
        mp.delenv("POLYTOPS_SCHEDD_SOCK", raising=False)
        mp.setattr(tsc, "_GLOBAL", None)
        mp.setattr(jsc, "_GLOBAL", None)
        yield root


def test_planners_are_the_scheduler_s():
    """``plan.py`` states no loop order: its planners are ``core.akg``'s."""
    for name in PLANNERS:
        assert getattr(tplan, f"plan_{name}") is getattr(takg, f"plan_{name}")
    assert tplan.KernelPlan is takg.KernelPlan


@pytest.mark.parametrize("name,args", sorted(FROZEN_TILES))
def test_plan_has_frozen_tile_and_reference_schedule(name, args):
    port_fn, ref_fn = PLANNERS[name]
    got, want = port_fn(*args), ref_fn(*args)
    assert got.tile == FROZEN_TILES[name, args]
    assert not got.degraded and got.fallback_level == 0 and not got.degrade_reasons
    assert (got.loop_order, got.vector_iter) == ORDERS[name]
    assert got.loop_order == want.loop_order
    assert got.vector_iter == want.vector_iter
    assert got.bands == want.bands
    assert got.schedule_str == want.schedule_str
    assert got.degraded == want.degraded
    assert set(got.tile) == set(want.tile)        # the reference's iterators


@pytest.mark.parametrize("site", ["ilp.solve", "farkas.project"])
def test_injected_fault_degrades_and_is_not_memoized(site):
    """A fault on every call degrades the plan (a lower ladder rung) and
    the plan is not pinned in the memo; with the fault gone the same
    shape replans clean and is memoized."""
    shape = (48, 96, 80) if site == "ilp.solve" else (40, 112, 72)
    before = takg.plan_memo_stats()["matmul"]["misses"]
    with tres.inject(site, times=-1):
        bad = tplan.plan_matmul(*shape)
    assert bad.degraded and bad.fallback_level > 0 and bad.degrade_reasons
    assert bad.tile["i"] in tplan.MATMUL_I and bad.tile["kk"] == tplan.MATMUL_KK
    good = tplan.plan_matmul(*shape)
    assert not good.degraded and good.fallback_level == 0
    assert good.tile == {"i": 64, "kk": 64, "j": 128}
    assert good.loop_order == ("i", "kk", "j")
    assert tplan.plan_matmul(*shape) is good          # now memoized
    assert takg.plan_memo_stats()["matmul"]["misses"] == before + 2


def test_plan_memo_variables_are_the_port_s(monkeypatch):
    monkeypatch.delenv("POLYTOPS_TORCH_PLAN_MEMO", raising=False)
    monkeypatch.delenv("POLYTOPS_TORCH_PLAN_MEMO_ATTENTION", raising=False)
    monkeypatch.setenv("POLYTOPS_PLAN_MEMO", "3")
    assert takg.plan_memo_size("attention") == takg.PLAN_MEMO_DEFAULTS["attention"]
    monkeypatch.setenv("POLYTOPS_TORCH_PLAN_MEMO", "5")
    assert takg.plan_memo_size("attention") == 5
    monkeypatch.setenv("POLYTOPS_TORCH_PLAN_MEMO_ATTENTION", "7")
    assert takg.plan_memo_size("attention") == 7


def test_chip_smoke_plans_the_frozen_table():
    """``chip_smoke.py``'s ``plans`` phase holds its plans to a literal of
    its own: every entry of it is an entry of this table."""
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
    chip_smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(chip_smoke)
    assert chip_smoke.PLAN_TILES
    for key, tile in chip_smoke.PLAN_TILES.items():
        assert FROZEN_TILES[key] == tile, key
    assert set(chip_smoke.plan_cases()) == set(chip_smoke.PLAN_TILES)
