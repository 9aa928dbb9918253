"""One run of a cell: the driver its mix names, the metrics read from the
record by their readers in ``metrics/`` (one file per metric, found by
name), the output check, and the result line."""
from __future__ import annotations

import importlib
import importlib.util
import sys
from functools import lru_cache
from typing import Any, Callable, Dict

from . import check
from .cell import BENCH_DIR, Cell, end_to_end, per_layer
from .trace import breakdown

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
DRIVERS = {"serve": "serving", "train": "training"}


@lru_cache(maxsize=None)
def reader(name: str) -> Callable:
    path = BENCH_DIR / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"perfbench_metric_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's, Flax's or the JAX
    package's (compared whole: the port's name begins with the latter)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def metrics(rec, specs) -> Dict[str, Any]:
    out = {}
    for m in specs:
        v = reader(m["name"])(rec)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def execute(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float,
            log: Callable[[str], None], e2e=None, layer=None) -> Dict[str, Any]:
    """Run ``cell`` and return its result line as a dict (``checks`` last)."""
    import torch

    driver = importlib.import_module(f"harness.{DRIVERS[cell.mix['kind']]}")
    rec = driver.run(cell, seed, seconds, trace, device, t0, log)
    e2e = end_to_end(cell.name) if e2e is None else e2e
    layer = per_layer(cell.name) if layer is None else layer
    result: Dict[str, Any] = {
        "metrics": metrics(rec, layer if trace else e2e),
        "attempted": rec["attempted"],
        "failed": rec["failed"],
    }
    log(driver.summary(rec))
    readings = driver.check(rec, cell, seed, device, log)
    lim = check.limits(cell.name)
    checks = check.judge(readings, lim)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
           "count": cell.chips, "memory_peak_bytes": int(rec["memory_peak_bytes"])}
    if trace and rec.get("trace"):
        dev["busy_s"] = rec["trace"]["busy_s"]
        dev["window_s"] = rec["trace"]["window_s"]
        result["breakdown"] = breakdown(rec["trace"])
    result = {"correct": all(c["ok"] for c in checks.values()), **result, "device": dev}
    result["checks"] = {k: {"value": c["value"], "limit": c["limit"]} for k, c in checks.items()}
    return result
