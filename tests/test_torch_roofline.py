"""The port's Hopper roofline (``repro_torch.launch.roofline``) and the
registry's dry-run table against the reference.

``active_params`` and ``model_flops`` are integer counts, so they must be
exactly the reference's for every arch and shape; ``roofline_terms`` is
checked on a synthetic per-device cost at the H100's data-sheet
constants; ``collective_bytes_from_comm`` on a ``CommDebugMode`` that
recorded two collectives of a 2×2 mesh over a fake process group (in a
subprocess, so this process never starts one).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from repro.configs import registry as JREG
from repro.launch import roofline as JR
from repro_torch.configs import registry as REG
from repro_torch.launch import roofline as R

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")


def test_registry_shapes_and_cells_equal_reference():
    assert REG.ARCH_IDS == JREG.ARCH_IDS
    assert {k: vars(v) for k, v in REG.SHAPES.items()} == \
        {k: vars(v) for k, v in JREG.SHAPES.items()}
    cells = REG.runnable_cells()
    assert cells == JREG.runnable_cells() and len(cells) == 33
    assert sorted(a for a, s in cells if s == "long_500k") == \
        ["falcon_mamba_7b", "gemma3_4b", "jamba_v0_1_52b"]


@pytest.mark.parametrize("arch", REG.ARCH_IDS)
def test_active_params_and_model_flops_equal_reference(arch):
    cfg, jcfg = REG.get_arch(arch), JREG.get_arch(arch)
    assert R.active_params(cfg) == JR.active_params(jcfg)
    for name, shape in REG.SHAPES.items():
        assert R.model_flops(cfg, shape) == JR.model_flops(jcfg, JREG.SHAPES[name])


def test_roofline_terms_on_a_synthetic_cost():
    """Half a second of bf16 compute, a quarter of HBM traffic, three
    quarters of link traffic per device: the collective bounds the step."""
    assert (R.PEAK_BF16, R.PEAK_F32, R.HBM_BW, R.LINK_BW) == (989e12, 67e12, 3.35e12, 50e9)
    cfg, shape = REG.get_arch("granite_3_2b"), REG.SHAPES["train_4k"]
    cost = {"flops": 0.5 * R.PEAK_BF16, "bytes accessed": 0.25 * R.HBM_BW}
    coll = {"weighted_bytes": 0.75 * R.LINK_BW}
    rf = R.roofline_terms(cfg, shape, cost, coll, 256)
    assert rf.keys() == JR.roofline_terms(JREG.get_arch("granite_3_2b"),
                                          JREG.SHAPES["train_4k"], cost, coll, 256).keys()
    assert rf["compute_s"] == pytest.approx(0.5)
    assert rf["memory_s"] == pytest.approx(0.25)
    assert rf["collective_s"] == pytest.approx(0.75)
    assert rf["bottleneck"] == "collective"
    assert rf["step_time_lower_bound_s"] == pytest.approx(0.75)
    mf = R.model_flops(cfg, shape)
    assert rf["model_flops"] == mf and rf["hlo_flops_per_dev"] == cost["flops"]
    assert rf["model_flops_frac"] == pytest.approx(mf / (cost["flops"] * 256))
    assert rf["mfu_upper_bound"] == pytest.approx(mf / (256 * R.PEAK_BF16) / 0.75)


def test_kernel_bounds_are_the_smoke_runs():
    """Kernel A's bound at granite's gate/up shape (256, 2048)·(2048, 8192)
    in bf16: bytes over 3.35 TB/s, 0.0116 ms, as ``chip_smoke.py`` printed
    it before the constants moved here."""
    m, k, n = 256, 2048, 8192
    ms, by = R.bound_ms((m * k + k * n + m * n) * 2, 2.0 * m * n * k)
    assert by == "bytes" and round(ms, 4) == 0.0116
    assert R.bound_ms(0.0, 2 * R.PEAK_F32, R.PEAK_F32) == (2000.0, "operations")
    # bf16 and f32 operations run one after the other
    assert R.work_bound((R.PEAK_BF16, R.PEAK_F32, R.HBM_BW)) == pytest.approx(2000.0)


COMM_SCRIPT = """
import json, torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from torch.distributed.device_mesh import init_device_mesh
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor.debug import CommDebugMode
from repro_torch.launch.dryrun import DeviceCounter, _meta_dtensor
from repro_torch.launch.roofline import collective_bytes_from_comm
from repro_torch.model.sharding import P
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
mesh = init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))
x = _meta_dtensor((8, 16), torch.float32, mesh, P("data", "model"))
w = _meta_dtensor((16, 32), torch.float32, mesh, P("model", None))
with CommDebugMode() as comm, DeviceCounter() as cnt:
    y = x @ w                                              # partial over model
    y = y.redistribute(mesh, [Shard(0), Replicate()])      # all-reduce (4, 32)
    y = y.redistribute(mesh, [Replicate(), Replicate()])   # all-gather (8, 32)
print(json.dumps({"coll": collective_bytes_from_comm(comm, cnt.coll_bytes),
                  "flops": cnt.flops}))
dist.destroy_process_group()
"""


def run_py(script: str, *args, timeout: int = 300) -> dict:
    out = subprocess.run([sys.executable, "-c", script, *args],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_collective_bytes_from_comm():
    got = run_py(COMM_SCRIPT)
    coll = got["coll"]
    assert coll["all-reduce"] == {"count": 1, "bytes": 4 * 32 * 4}
    assert coll["all-gather"] == {"count": 1, "bytes": 8 * 32 * 4}
    for kind in ("reduce-scatter", "all-to-all", "collective-permute"):
        assert coll[kind] == {"count": 0, "bytes": 0}
    assert coll["weighted_bytes"] == 2 * 4 * 32 * 4 + 8 * 32 * 4
    assert got["flops"] == 2 * 4 * 8 * 32          # rank 0's local product
