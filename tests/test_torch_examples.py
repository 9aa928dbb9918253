"""The port's two examples (``examples/serve_batched_torch.py``,
``examples/train_100m_torch.py``) on the CPU, each in a fresh
interpreter: they run, and import nothing of ``jax``, ``ml_dtypes`` or
the reference package."""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

RUN = """
import json, runpy, sys
import torch
torch.set_num_threads(1)
main = runpy.run_path(sys.argv[1])["main"]
out = main(sys.argv[2:])
print(json.dumps({"out": out if isinstance(out, tuple) else out.tolist(),
                  "foreign": sorted(m for m in sys.modules
                                    if m.split(".")[0] in ("repro", "jax", "ml_dtypes"))}))
"""


def run_example(name: str, *args) -> dict:
    proc = subprocess.run([sys.executable, "-c", RUN, str(ROOT / "examples" / name), *args],
                          env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                   OMP_NUM_THREADS="1"),
                          capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_serve_batched_example():
    got = run_example("serve_batched_torch.py", "--device", "cpu", "--gen", "8")
    tokens = got["out"]
    assert len(tokens) == 4 and all(len(t) == 8 for t in tokens)
    assert all(0 <= x < 512 for t in tokens for x in t)
    assert got["foreign"] == []
    assert run_example("serve_batched_torch.py", "--device", "cpu", "--gen", "8")["out"] == tokens


def test_train_example_restores_after_the_simulated_preemption(tmp_path):
    got = run_example("train_100m_torch.py", "--smoke", "--device", "cpu", "--steps", "16",
                      "--simulate-preemption", "--ckpt", str(tmp_path / "ckpt"))
    out, losses = got["out"]
    assert out["final_step"] == 16 and out["restarts"] == 1
    assert all(l == l for l in losses) and losses[-1] < losses[0]
    assert got["foreign"] == []
