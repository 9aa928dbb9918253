"""Planned tiled matmul: the launch wrapper of ``csrc/matmul.cu``.

Ports ``src/repro/kernels/matmul_polytops.py``.  C[M,N] = A[M,K]·B[K,N]
in bf16 with f32 accumulation; the tile (i, j, kk) comes from
:func:`repro_torch.plan.plan_matmul`, the K split and ring depth from
:func:`repro_torch.plan.matmul_launch_geometry`.  Ragged M, N and K
inside a tile are handled in the kernel, so no tile has to divide its
dimension; the kernel's TMA loads need K and N to be multiples of 8 and
the operands 16-byte aligned, which :func:`pad_operands` provides.  A
split K needs an f32 workspace for the partial tiles and a zeroed integer
counter per output tile, which every launch leaves zeroed again.  Both
are kept per device and stream and reused: launches on one stream run
one after another, and launches that could overlap never share them.  A
CUDA graph holds the addresses its launches were captured with, and a
stream's scratch is made anew (and the old one freed) when it must grow,
so a launch that is being captured never takes the stream's scratch: it
gets its own from the graph's memory pool, with its tickets zeroed by
the graph before the launch, and it lives as long as the graph does.
The plain version is :func:`repro_torch.kernels.ref.matmul_ref`.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch

from ..plan import matmul_launch_geometry, plan_matmul
from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0

ALIGN = 8          # elements: TMA takes 16-byte row strides of bf16

_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _split_scratch(device: torch.device, stream: int, workspace: int,
                   tiles: int, capturing: bool = False
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The split-K scratch of ``stream``: an f32 workspace of at least
    ``workspace`` elements and ``tiles`` int tickets, zero between
    launches (a buffer that grows is made anew, zeroed).  ``capturing``:
    the launch is being captured into a graph, which gets scratch of its
    own (allocated in the graph's pool, tickets zeroed at each replay)
    and leaves the stream's scratch alone."""
    if capturing:
        return (torch.empty(workspace, dtype=torch.float32, device=device),
                torch.zeros(max(tiles, 1), dtype=torch.int32, device=device))
    key = (device.index, stream)
    ws, tickets = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < workspace or tickets.numel() < tiles:
        ws = torch.empty(workspace, dtype=torch.float32, device=device)
        tickets = torch.zeros(max(tiles, 1024), dtype=torch.int32, device=device)
        _SCRATCH[key] = (ws, tickets)
    return ws, tickets


def _aligned(t: torch.Tensor) -> bool:
    return t.shape[1] % ALIGN == 0 and t.data_ptr() % 16 == 0


def pad_operands(a: torch.Tensor, b: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """A (M, K) and B (K, N), contiguous, zero-padded to K and N that are
    multiples of 8 and copied where a base is not 16-byte aligned.  The
    product of the padded operands, sliced to ``[:, :N]``, is A·B: the
    extra K terms are products with zeros.  Operands that are already
    aligned come back as they are."""
    m, k = a.shape
    n = b.shape[1]
    k8, n8 = -(-k // ALIGN) * ALIGN, -(-n // ALIGN) * ALIGN
    if k8 != k or not _aligned(a):
        a_p = a.new_zeros((m, k8))
        a_p[:, :k] = a
        a = a_p
    if k8 != k or n8 != n or not _aligned(b):
        b_p = b.new_zeros((k8, n8))
        b_p[:k, :n] = b
        b = b_p
    return a, b


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A @ B on the card.  a: (M, K), b: (K, N), both bf16 CUDA."""
    global LAUNCHES
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("matmul kernel takes two tensors on one CUDA device")
    if a.dtype != torch.bfloat16 or b.dtype != torch.bfloat16:
        raise TypeError(f"matmul kernel takes bf16, got {a.dtype}, {b.dtype}")
    if a.dim() != 2 or b.dim() != 2 or a.shape[1] != b.shape[0]:
        raise ValueError(f"matmul shapes {tuple(a.shape)} @ {tuple(b.shape)}")
    m, k = a.shape
    n = b.shape[1]
    if m == 0 or n == 0 or k == 0:
        return torch.zeros((m, n), dtype=a.dtype, device=a.device)
    a, b = pad_operands(a.contiguous(), b.contiguous())
    k8, n8 = b.shape
    c = torch.empty((m, n8), dtype=a.dtype, device=a.device)
    tile = plan_matmul(m, n8, k8).tile
    geo = matmul_launch_geometry(m, n8, k8)
    stream = build.stream_ptr(a.device)
    ws = counters = None
    if geo["split"] > 1:
        ws, counters = _split_scratch(a.device, stream, geo["workspace"],
                                      geo["blocks"] // geo["split"],
                                      torch.cuda.is_current_stream_capturing())
    lib = build.load_library()
    rc = lib.repro_matmul_bf16(a.data_ptr(), b.data_ptr(), c.data_ptr(),
                               None if ws is None else ws.data_ptr(),
                               None if counters is None else counters.data_ptr(),
                               m, n8, k8, tile["i"], tile["j"], tile["kk"],
                               geo["split"], geo["stages"], stream)
    build.check(rc, "matmul")
    LAUNCHES += 1
    return c if n8 == n else c[:, :n]
