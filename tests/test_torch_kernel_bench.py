"""The port's kernel bench (``repro_torch.kernels.bench``) on the CPU.

Its smoke gate runs every kernel wrapper at the reference bench's smoke
shapes; on the CPU the wrappers run their plain versions.  Here those are
held against the reference's jnp oracles (``repro.kernels.ref``) on the
same numpy inputs at the reference's f32 tolerance of 1e-4, and the plan
lines against the reference's ``smoke()`` output: the same loop order and
vector iterator (only the tiles may differ).
"""
from __future__ import annotations

import io

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import bench as jbench
from repro.kernels import ref as jref
from repro_torch.kernels import bench

torch.set_num_threads(1)


def _np(*ts):
    return [jnp.asarray(t.detach().float().numpy()) for t in ts]


def _jax_flash(q, k, v):
    """The reference's oracle on its (b·h, s, d) layout, as its smoke calls it."""
    b, s, h, d = q.shape
    bh = [x.transpose(0, 2, 1, 3).reshape(b * h, s, d) for x in _np(q, k, v)]
    out = jref.attention_ref(*bh, causal=True)
    return np.asarray(out).reshape(b, h, s, d).transpose(0, 2, 1, 3)


JAX_ORACLES = {
    "matmul": lambda a, b: np.asarray(jref.matmul_ref(*_np(a, b))),
    "flash_attention": _jax_flash,
    "selective_scan": lambda *abc: np.asarray(jref.selective_scan_ref(*_np(*abc))),
    "scan_gate": lambda *g: tuple(np.asarray(t) for t in jref.scan_gate_ref(*_np(*g))),
}


def lines(text, prefix):
    return [ln.split(",") for ln in text.splitlines() if ln.startswith(prefix)]


def test_smoke_on_cpu_matches_reference_oracles():
    out = io.StringIO()
    assert bench.smoke(out, device="cpu", oracles=JAX_ORACLES) == 0
    checks = lines(out.getvalue(), "")
    names = [c[0] for c in checks if len(c) > 1 and c[1] in ("PASS", "FAIL")]
    assert names == ["matmul_smoke", "flash_attention_smoke", "mamba_scan_smoke",
                     "scan_gate_smoke", "scan_gate_state_smoke",
                     "scan_gate_chunk_carry_smoke", "scan_gate_chunk_state_smoke",
                     "kernel_smoke"]


def test_smoke_counts_a_mismatch():
    """An oracle off by 1e-3 fails its check and only its check."""
    off = {"matmul": lambda a, b: np.asarray(jref.matmul_ref(*_np(a, b))) + 1e-3}
    out = io.StringIO()
    assert bench.smoke(out, device="cpu", oracles=off) == 1
    assert "matmul_smoke,FAIL" in out.getvalue()


def test_plans_match_reference_loop_order_and_vector_iterator():
    ref_out, out = io.StringIO(), io.StringIO()
    assert jbench.smoke(ref_out) == 0
    bench.smoke(out, device="cpu")
    want = lines(ref_out.getvalue(), "plan_")
    got = lines(out.getvalue(), "plan_")
    assert [w[0] for w in want] == [g[0] for g in got] == [
        "plan_matmul", "plan_attention", "plan_mamba_scan", "plan_scan_gate"]
    for w, g in zip(want, got):
        assert g[1] == w[1], (g, w)                                   # loop order
        assert g[2].split()[0] == w[2].split()[0], (g, w)             # vec=<iterator>


def test_main_smoke_on_cpu_exits_zero(capsys):
    assert bench.main(["--smoke", "--device", "cpu"]) == 0
    assert "kernel_smoke,PASS,failures=0,device=cpu" in capsys.readouterr().out


def test_main_timings_on_cpu(capsys):
    assert bench.main(["--device", "cpu"]) == 0
    rows = lines(capsys.readouterr().out, "")[1:]
    assert [r[0] for r in rows] == ["matmul_256x256x256", "matmul_512x512x512",
                                    "flash_attn_512", "mamba_scan_128", "scan_gate_128"]


def test_default_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA"):
        bench.smoke(io.StringIO())
