#!/usr/bin/env python3
"""Kernel B's times at ``chip_smoke.FLASH_CASES`` for two trees of this
repository, in turns on one card: other, this, this, other.

    python3 scripts/flash_ab.py OTHER_ROOT

``OTHER_ROOT`` is another checkout, for example ``git archive`` of an
earlier commit unpacked under ``build/``.  Each turn is a fresh process
that imports that tree's ``chip_smoke`` (which puts the tree's ``src/``
first on the path), builds the tree's kernels into the tree's own
``build/``, and times ``flash_attention(q, k, v, q_offset=int)`` at every
case with ``chip_smoke.time_ms`` (L2 flushed before each call, events
queued behind a device delay).  Prints each turn's times, then per case
the mean of each tree's two turns and their ratio, and the card's name
and power limit.  Needs one CUDA device.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TURN = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
import torch
import chip_smoke as cs
from repro_torch.kernels import build
from repro_torch.kernels import flash_attention as fa
build.load_library()
gen = torch.Generator(device="cuda")
gen.manual_seed(0)
times = []
for b, c, kv_len, off, h, hkv, d in cs.FLASH_CASES:
    q, k, v = cs.flash_operands(gen, b, c, kv_len, h, hkv, d)
    times.append(cs.time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off), iters=50))
print(json.dumps(times))
"""


def turn(root: str):
    out = subprocess.run([sys.executable, "-c", TURN, root], capture_output=True, text=True,
                         timeout=900)
    if out.returncode:
        raise SystemExit(f"turn in {root} failed:\n{out.stdout}\n{out.stderr}")
    return json.loads(out.stdout.strip().splitlines()[-1])


def main() -> int:
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    other = os.path.abspath(sys.argv[1])
    sys.path.insert(0, HERE)
    import chip_smoke as cs

    runs = {"other": [], "this": []}
    for name, root in (("other", other), ("this", HERE), ("this", HERE), ("other", other)):
        runs[name].append(turn(root))
        print(f"turn {name} ({root}): {['%.4f' % t for t in runs[name][-1]]}", flush=True)
    print("case (b, c, kv_len, q_offset, h, hkv, d): other ms, this ms, this / other")
    ratios = []
    for i, case in enumerate(cs.FLASH_CASES):
        a = sum(r[i] for r in runs["other"]) / 2
        b = sum(r[i] for r in runs["this"]) / 2
        ratios.append(b / a)
        print(f"  {case}: {a:.4f} {b:.4f} {b / a:.4f}")
    print(f"this / other over the cases: mean {sum(ratios) / len(ratios):.4f}, "
          f"min {min(ratios):.4f}, max {max(ratios):.4f}")
    print(cs.gpu_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
