#!/usr/bin/env python3
"""One run of one cell of the PyTorch/CUDA port's benchmark.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``src/repro_torch``.  Loads the
cell's configuration and traffic mix by name (``BENCHMARK.json``), makes
the weights and traffic from the seed on the card, warms up, measures for
``--seconds``, checks what the timed path produced against the plain
reference, and prints one JSON line last: with ``--trace 0`` the cell's
end-to-end metrics, with ``--trace 1`` its per-layer metrics, the device
trace's busy seconds and a breakdown.  The numbers compared for
``correct`` come last, on standard error and under ``checks``.

It exits with another code than 0, printing no result, when no card (or
too few) is there, and when JAX, Flax or the JAX package were loaded.
Build and plan caches live in fixed directories under ``build/`` of the
checkout."""
from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def environment() -> None:
    """Caches at fixed paths inside the checkout; plans made in-process."""
    build = ROOT / "build"
    os.environ["POLYTOPS_TORCH_CACHE_DIR"] = str(build / "perfbench_sched")
    os.environ["POLYTOPS_TORCH_CC_CACHE"] = str(build / "perfbench_cc")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    for var in ("POLYTOPS_TORCH_SCHEDD_SOCK", "POLYTOPS_TORCH_SCHEDD_ADDR"):
        os.environ.pop(var, None)
    for p in (str(HERE), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    environment()
    from harness.cell import load

    cell = load(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        log(f"{args.workload} needs {cell.chips} CUDA device(s); "
            f"available: {torch.cuda.is_available()}, count {torch.cuda.device_count()}")
        return 2
    torch.set_num_threads(4)
    from harness.runner import execute, forbidden_modules

    result = execute(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda"),
                     T0, log)
    bad = forbidden_modules()
    if bad:
        log(f"modules that may not be loaded were loaded: {bad}")
        return 3
    log(card_line())
    for name, c in result["checks"].items():
        log(f"check {name}: {c['value']} (limit {c['limit']})")
    print(json.dumps(result), flush=True)
    return 0


def card_line() -> str:
    import subprocess
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=20)
        return f"card: {out.stdout.strip()}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"card: nvidia-smi not read ({e})"


if __name__ == "__main__":
    sys.exit(main())
