"""The port's dry run (``repro_torch.launch.dryrun``) on fake process
groups of 256 and 512 ranks.

The CLI runs the reference test's smallest cell on both meshes with the
reference test's assertions (``tests/test_dryrun.py``).  The reference's
own dry run has no numbers to compare with (its two tests fail), so the
rest holds the port to its own counts: the per-device FLOPs of a sharded
matmul are the local product's (``FlopCounterMode``, above DTensor,
counts the global one); FLOPs are linear in depth, since every layer is
counted; the ``chunked_attn`` and ``tp_off`` variants run.  Each runs in
a subprocess, so this process never starts a process group.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
ART = ROOT / "artifacts" / "dryrun_torch"


def run_py(args, timeout: int = 600) -> subprocess.CompletedProcess:
    out = subprocess.run([sys.executable, *args], env=dict(os.environ, PYTHONPATH=SRC),
                         capture_output=True, text=True, timeout=timeout, cwd=ROOT)
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-3000:]
    return out


def test_cli_smallest_cell_on_both_meshes():
    cp = run_py(["-m", "repro_torch.launch.dryrun", "--arch", "qwen3_0_6b",
                 "--shape", "decode_32k"])
    assert cp.stdout.count(": OK") == 2, cp.stdout
    for mesh, devices in (("pod16x16", 256), ("pod2x16x16", 512)):
        d = json.loads((ART / f"qwen3_0_6b__decode_32k__{mesh}__baseline.json").read_text())
        assert d["ok"] and d["devices"] == devices and "error" not in d
        assert set(d["memory"]) >= {"bytes_per_device", "arguments", "output", "temp"}
        assert d["memory"]["bytes_per_device"] > 0 and d["cost"]["flops"] > 0
        assert d["cost"]["bytes_accessed"] > 0 and "weighted_bytes" in d["collectives"]
        rf = d["roofline"]
        assert rf["compute_s"] > 0 and rf["memory_s"] > 0
        assert rf["bottleneck"] in ("compute", "memory", "collective")
        assert 0 < rf["model_flops_frac"] <= 1.5


CELLS_SCRIPT = """
import json
import torch
from torch.utils.flop_counter import FlopCounterMode
from repro_torch.configs.registry import get_arch
from repro_torch.launch import dryrun as D
from repro_torch.model.sharding import P

out = {}
D.init_fake_group(4)
from torch.distributed.device_mesh import init_device_mesh
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
x = D._meta_dtensor((8, 16), torch.float32, mesh, P("data", None))
w = D._meta_dtensor((16, 32), torch.float32, mesh, P(None, "model"))
with D.DeviceCounter() as cnt:
    x @ w
with FlopCounterMode(display=False) as fc:
    x @ w
out["matmul"] = {"local": cnt.flops, "global": fc.get_total_flops()}

D.init_fake_group(256)
cfg = get_arch("qwen3_0_6b")
out["depth"] = {
    shape: [D.run_cell("qwen3_0_6b", shape, False, save=False, n_micro=1,
                       cfg=cfg.scaled(n_layers=n))["cost"]["flops"] for n in (2, 4, 6)]
    for shape in ("decode_32k", "prefill_32k", "train_4k")}
out["variants"] = {v: D.run_cell("qwen3_0_6b", "prefill_32k", False, save=False, variant=v,
                                 cfg=cfg.scaled(n_layers=2))
                   for v in ("baseline", "chunked_attn", "tp_off")}
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=1)
def cells() -> dict:
    cp = run_py(["-c", CELLS_SCRIPT])
    return json.loads(cp.stdout.strip().splitlines()[-1])


def test_sharded_matmul_counts_the_local_product():
    """(8, 16)·(16, 32) with rows over "data" and columns over "model" of a
    2×2 mesh: rank 0 multiplies (4, 16)·(16, 16)."""
    got = cells()["matmul"]
    assert got["local"] == 2 * 4 * 16 * 16
    assert got["global"] == 2 * 8 * 16 * 32


def test_flops_are_linear_in_depth():
    """2, 4 and 6 layers of qwen3-0.6B: each pair of layers adds the same
    FLOPs (the train step at one micro-batch)."""
    for shape, (f2, f4, f6) in cells()["depth"].items():
        assert f4 - f2 == f6 - f4 > 0, shape


def test_chunked_attention_and_tp_off_variants_run():
    v = cells()["variants"]
    assert all(r["ok"] for r in v.values()), {k: r.get("error") for k, r in v.items()}
    base, chunked, tp_off = v["baseline"], v["chunked_attn"], v["tp_off"]
    # the same products, a chunk's logits live at a time instead of all
    assert chunked["cost"]["flops"] == base["cost"]["flops"]
    assert chunked["memory"]["temp"] < base["memory"]["temp"] / 8
    # parameters replicated instead of split over "model"
    assert tp_off["memory"]["arguments"] > 4 * base["memory"]["arguments"]
