"""Planned tiled matmul: the launch wrapper of ``csrc/matmul.cu``.

Ports ``src/repro/kernels/matmul_polytops.py``.  C[M,N] = A[M,K]·B[K,N]
in bf16 with f32 accumulation; tiles (i, j, kk) come from
:func:`repro_torch.plan.plan_matmul`.  Ragged M, N and K are handled in
the kernel, so no tile has to divide its dimension.  The plain version
is :func:`repro_torch.kernels.ref.matmul_ref`.
"""
from __future__ import annotations

import torch

from ..plan import plan_matmul
from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the card.  a: (M, K), b: (K, N), both bf16 CUDA."""
    global LAUNCHES
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("matmul kernel takes two tensors on one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    a, b = a.contiguous(), b.contiguous()
    m, k = a.shape
    n = b.shape[1]
    c = torch.empty((m, n), dtype=a.dtype, device=a.device)
    if m == 0 or n == 0:
        return c
    if k == 0:
        return c.zero_()
    tile = plan_matmul(m, n, k).tile
    lib = build.load_library()
    rc = lib.repro_matmul_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               m, n, k, tile["i"], tile["j"], tile["kk"],
                               build.stream_ptr(a.device))
    build.check(rc, "matmul")
    LAUNCHES += 1
    return c
