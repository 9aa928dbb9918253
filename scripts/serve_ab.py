#!/usr/bin/env python3
"""Serve walls of two trees of this repository, in turns on one card:
other, this, this, other.

    python3 scripts/serve_ab.py OTHER_ROOT [ARCH ...]

``OTHER_ROOT`` is another checkout, for example ``git archive`` of an
earlier commit unpacked under ``build/``; the archs default to
``granite_3_2b`` and ``falcon_mamba_7b``.  Each turn is a fresh process
that imports that tree's ``chip_smoke`` (which puts the tree's ``src/``
first on the path), builds the tree's kernels into the tree's own
``build/`` and runs its ``phase_serve`` for each arch: the same traffic
served with every tick eager, then with graphs.  Prints, per arch and
tree, the eager wall, the graph run's wall and that wall without the
captures, each turn's and the mean of each tree's two turns, and the
card's name and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import re
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# phase_serve's arguments, as chip_smoke.main passes them
ARCHS = {"granite_3_2b": (("matmul", "flash_attention"), {}),
         "falcon_mamba_7b": (("scan_gate",), {"relative_logits": True}),
         "gemma3_4b": (("matmul", "flash_attention"), {"check_offsets": (256, 1280)}),
         "qwen3_moe_30b_a3b": (("flash_attention",), {})}

TURN = r"""
import contextlib, io, json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
cs.phase_build()
gpu = cs.gpu_line()
for arch, (kernels, kw) in json.loads(sys.argv[2]).items():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cs.phase_serve(gpu, arch, tuple(kernels), **kw)
    line = [l for l in out.getvalue().splitlines() if "serve wall eager" in l][0]
    print("WALLS", arch, line)
"""

WALLS = re.compile(r"serve wall eager ([0-9.]+) s, graphs ([0-9.]+) s \(([0-9.]+) s without")


def turn(root: str, archs):
    out = subprocess.run([sys.executable, "-c", TURN, root, json.dumps(archs)],
                         capture_output=True, text=True, timeout=1800)
    if out.returncode:
        raise SystemExit(f"turn in {root} failed:\n{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    walls = {}
    for line in out.stdout.splitlines():
        if line.startswith("WALLS "):
            arch = line.split()[1]
            walls[arch] = [float(x) for x in WALLS.search(line).groups()]
    return walls


def main() -> int:
    if len(sys.argv) < 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    names = sys.argv[2:] or ["granite_3_2b", "falcon_mamba_7b"]
    archs = {a: [list(ARCHS[a][0]), ARCHS[a][1]] for a in names}
    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        runs[name].append(turn(root, archs))
        print(f"turn {name} ({root}): {runs[name][-1]}", flush=True)
    print("arch: tree, mean of two turns: eager s, graphs s, graphs without captures s")
    for arch in names:
        for name in ("other", "this"):
            mean = [sum(r[arch][i] for r in runs[name]) / 2 for i in range(3)]
            print(f"  {arch}: {name} {mean[0]:.3f} {mean[1]:.3f} {mean[2]:.3f}")
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
