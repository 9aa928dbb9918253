"""What the benchmark loads: after the harness, the kinds, the reference and
every metric reader are imported and a small run has gone through them, no
module's top-level name (compared whole) is JAX's, Flax's or the JAX
package's; and the reference and the kinds load nothing of the port.  Each
check runs in a fresh interpreter: the test process may hold JAX from other
tests."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
SRC = HERE.parent / "src"

PRELUDE = f"""
import sys, json, time
sys.path[:0] = [{str(HERE)!r}, {str(SRC)!r}]
import torch
torch.set_num_threads(1)
"""


def fresh(code: str) -> dict:
    out = subprocess.run([sys.executable, "-c", PRELUDE + code], capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_harness_and_reference_load_no_jax():
    got = fresh("""
import importlib
from harness import runner, serving, check, cell, traffic, trace, warmup, weights, window, work
import kinds, reference, reference.common
for k in kinds.names():
    kinds.kind(k), reference.model(k)
for p in sorted((runner.BENCH_DIR / "metrics").glob("*.py")):
    runner.reader(p.stem)
import tiny
from harness.cell import Cell
res = runner.execute(Cell("tiny.closed", tiny.config("dense_gqa"), tiny.mix(), 1, "tiny", "closed"),
                     3, 0.5, True, torch.device("cpu"), time.perf_counter(), lambda m: None,
                     [{"name": "tok_s", "unit": "tokens/s"}], [{"name": "plan_s", "unit": "s"}])
tops = sorted({m.split(".")[0] for m in sys.modules})
print(json.dumps({"forbidden": runner.forbidden_modules(), "tops": tops,
                  "tok_s": res["metrics"].get("plan_s")}))
""")
    assert got["forbidden"] == []
    assert not {"jax", "jaxlib", "flax", "repro"} & set(got["tops"])
    assert "repro_torch" in got["tops"]          # the run did drive the port
    assert got["tok_s"] is not None


def test_reference_loads_nothing_of_the_port():
    got = fresh("""
import kinds, reference, reference.common
from harness import weights
import tiny
for kind in kinds.names():
    cfg = tiny.config(kind)
    p = weights.make(cfg, 1, "cpu")
    reference.model(kind).logits(p, cfg, torch.arange(2, 40), [0, 37])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
""")
    assert not {"repro_torch", "repro", "jax", "jaxlib", "flax"} & set(got)
