"""Selective scan (the Mamba-1 recurrence): the launch wrapper of
``csrc/scan_gate.cu``'s ``repro_selective_scan``.

Ports ``src/repro/kernels/mamba_scan.py``: h_t = a_t ⊙ h_{t-1} + b_t
from a zero state, y_t = Σ_n h_t[d, n]·c_t[n], no state out, y in
``a_bar``'s dtype (f32).  Only ``ops.selective_scan`` calls it; no model
path does (the reference's non-fused Mamba route is plain jnp,
``src/repro/model/ssm.py:87-94``).  Block geometry comes from
:func:`repro_torch.plan.plan_mamba_scan`.  The plain version is
:func:`repro_torch.kernels.ref.selective_scan_ref`.
"""
from __future__ import annotations

import torch

from ..plan import plan_mamba_scan
from . import build
from .scan_gate import check_scan_operands

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0


def selective_scan(a_bar: torch.Tensor, b_bar: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    """a_bar, b_bar: (b, s, di, st) f32; c: (b, s, st) f32, on one CUDA
    device.  Returns y: (b, s, di) f32."""
    global LAUNCHES
    check_scan_operands(a_bar, b_bar, c, "selective_scan")
    bsz, seq, di, st = a_bar.shape
    a_bar, b_bar, c = a_bar.contiguous(), b_bar.contiguous(), c.contiguous()
    y = torch.empty((bsz, seq, di), dtype=torch.float32, device=a_bar.device)
    if bsz == 0 or seq == 0 or di == 0:
        return y
    tile = plan_mamba_scan(seq, di, st).tile
    lib = build.load_library()
    rc = lib.repro_selective_scan(
        a_bar.data_ptr(), b_bar.data_ptr(), c.data_ptr(), y.data_ptr(),
        bsz, seq, di, st, tile["d"], tile["t"], build.stream_ptr(a_bar.device))
    build.check(rc, "selective_scan")
    LAUNCHES += 1
    return y
