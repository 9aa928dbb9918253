"""Fused selective scan + skip + SiLU gate: the launch wrapper of
``csrc/scan_gate.cu``.

Ports ``src/repro/kernels/scan_gate.py``, the Mamba block's tail on the
chunked-prefill path: h_t = a_t ⊙ h_{t-1} + b_t from ``h0``, then
o_t = (h_t·c_t + x_t ⊙ d_skip) ⊙ silu(z_t).  Returns (o in x's dtype,
h_last f32), the carry for the next chunk.  Block geometry comes from
:func:`repro_torch.plan.plan_scan_gate`; the sequence length is a runtime
argument of the kernel, so a ragged chunk needs no recompile.  The plain
version is :func:`repro_torch.kernels.ref.scan_gate_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..plan import plan_scan_gate
from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0


def check_scan_operands(a_bar: torch.Tensor, b_bar: torch.Tensor,
                        c: torch.Tensor, what: str) -> None:
    """Device, dtype and shape checks shared by the two scan wrappers."""
    dev = a_bar.device
    if dev.type != "cuda" or b_bar.device != dev or c.device != dev:
        raise ValueError(f"{what} kernel takes tensors on one CUDA device")
    if not (a_bar.dtype == b_bar.dtype == c.dtype == torch.float32):
        raise TypeError(f"{what} kernel takes f32 a_bar, b_bar and c; got "
                        f"{a_bar.dtype}, {b_bar.dtype}, {c.dtype}")
    if a_bar.dim() != 4 or b_bar.shape != a_bar.shape or \
            c.shape != a_bar.shape[:2] + a_bar.shape[3:]:
        raise ValueError(f"{what} shapes a {tuple(a_bar.shape)} b "
                         f"{tuple(b_bar.shape)} c {tuple(c.shape)}")
    st = a_bar.shape[3]
    if st < 1 or 32 % st:
        raise ValueError(f"{what} kernel needs a state size dividing 32, got {st}")


def scan_gate(a_bar: torch.Tensor, b_bar: torch.Tensor, c: torch.Tensor,
              x_skip: torch.Tensor, d_skip: torch.Tensor, z: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """a_bar, b_bar: (b, s, di, st) f32; c: (b, s, st) f32; x_skip, z:
    (b, s, di) bf16 or f32 (one dtype); d_skip: (di,); h0: (b, di, st) or
    None (zeros).  All on one CUDA device."""
    global LAUNCHES
    check_scan_operands(a_bar, b_bar, c, "scan_gate")
    bsz, seq, di, st = a_bar.shape
    dev = a_bar.device
    if x_skip.device != dev or z.device != dev or d_skip.device != dev or \
            (h0 is not None and h0.device != dev):
        raise ValueError("scan_gate kernel takes tensors on one CUDA device")
    if x_skip.dtype != z.dtype or x_skip.dtype not in (torch.bfloat16,
                                                       torch.float32):
        raise TypeError(f"scan_gate kernel takes x_skip and z as one of bf16 "
                        f"or f32; got {x_skip.dtype}, {z.dtype}")
    if x_skip.shape != (bsz, seq, di) or z.shape != x_skip.shape or \
            d_skip.shape != (di,) or (h0 is not None and h0.shape != (bsz, di, st)):
        raise ValueError(f"scan_gate shapes x {tuple(x_skip.shape)} z "
                         f"{tuple(z.shape)} d_skip {tuple(d_skip.shape)} h0 "
                         f"{None if h0 is None else tuple(h0.shape)}")
    a_bar, b_bar, c = a_bar.contiguous(), b_bar.contiguous(), c.contiguous()
    x_skip, z = x_skip.contiguous(), z.contiguous()
    d_skip = d_skip.float().contiguous()
    if h0 is not None:
        h0 = h0.float().contiguous()
    out = torch.empty((bsz, seq, di), dtype=x_skip.dtype, device=dev)
    h_last = torch.empty((bsz, di, st), dtype=torch.float32, device=dev)
    if bsz == 0 or seq == 0 or di == 0:
        return out, (h_last.zero_() if h0 is None else h_last.copy_(h0))
    tile = plan_scan_gate(seq, di, st).tile
    lib = build.load_library()
    rc = lib.repro_scan_gate(
        a_bar.data_ptr(), b_bar.data_ptr(), c.data_ptr(), x_skip.data_ptr(),
        d_skip.data_ptr(), z.data_ptr(), None if h0 is None else h0.data_ptr(),
        out.data_ptr(), h_last.data_ptr(), bsz, seq, di, st, tile["d"],
        tile["t"], int(x_skip.dtype == torch.bfloat16),
        build.stream_ptr(dev))
    build.check(rc, "scan_gate")
    LAUNCHES += 1
    return out, h_last
