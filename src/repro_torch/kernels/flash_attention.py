"""Causal flash attention: the launch wrapper of ``csrc/flash_attention.cu``.

Ports ``src/repro/kernels/flash_attention.py``.  The kernel takes the
public layout of ``ops.flash_attention`` — q (b, sq, h, d) and k/v
(kb, sk, hkv, d) — through strides, so a page-aligned prefix of the KV
cache is read in place (through TMA tensor maps over the cache's own
strides) and GQA reads kv head ``h // rep`` without a repeated copy.
``sk`` is a runtime argument, and ``q_offset`` (the chunk's position)
and ``kv_row`` (the batch row of k/v where q's batch starts: a serving
slot) are device data, a two-int32 descriptor the kernel reads, as the
reference's kernel reads its offset from SMEM: one build, and one
captured launch, serves every prefill chunk of every slot.  The load
ring's depth comes from :func:`repro_torch.plan.attention_launch_geometry`;
ragged ``sq`` and ``sk`` are masked in the kernel.  The kernel is built
for head dims 64, 128 and 256; other head dims raise.  The plain version
is :func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

from typing import Dict, Tuple, Union

import torch

from ..plan import attention_launch_geometry
from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0

Index = Union[int, torch.Tensor]

_INT_DESCRIPTORS: Dict[Tuple[torch.device, int, int], torch.Tensor] = {}


def _strides(x: torch.Tensor, name: str):
    if x.stride(-1) != 1:
        raise ValueError(f"flash kernel needs {name} with a contiguous head "
                         f"dim; got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def descriptor(q_offset: Index, kv_row: Index, device: torch.device) -> torch.Tensor:
    """The kernel's int32 ``(q_offset, kv_row)`` on ``device``.  Device
    scalars are stacked there, with no host read, so a captured graph
    reads whatever they hold at its replay; Python ints alone, checked
    here, get a device tensor made once per value and kept."""
    if not isinstance(q_offset, torch.Tensor) and not isinstance(kv_row, torch.Tensor):
        key = (device, int(q_offset), int(kv_row))
        if key[1] < 0 or key[2] < 0:
            raise ValueError(f"flash kernel needs q_offset and kv_row >= 0, got "
                             f"{q_offset}, {kv_row}")
        if key not in _INT_DESCRIPTORS:
            _INT_DESCRIPTORS[key] = torch.tensor(key[1:], dtype=torch.int32, device=device)
        return _INT_DESCRIPTORS[key]
    parts = [x.reshape(()) if isinstance(x, torch.Tensor) else
             torch.full((), x, dtype=torch.int32, device=device) for x in (q_offset, kv_row)]
    if any(x.device != device for x in parts):
        raise ValueError(f"flash descriptor scalars must lie on {device}")
    return torch.stack(parts).to(torch.int32)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           q_offset: Index, causal: bool, stages: int, kv_row: Index = 0) -> None:
    """One launch with a ring of ``stages`` slots, into ``out``, without
    counting it (``chip_smoke.py``'s geometry sweep calls this directly)."""
    b, sq, h, d = q.shape
    kb, sk, hkv, _ = k.shape
    desc = descriptor(q_offset, kv_row, q.device)
    rc = build.load_library().repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), desc.data_ptr(),
        b, kb, h, hkv, sq, sk, d, int(causal), stages,
        *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"), *_strides(out, "out"),
        build.stream_ptr(q.device))
    build.check(rc, "flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: Index = 0,
                    kv_row: Index = 0) -> torch.Tensor:
    """q: (b, sq, h, d); k, v: (kb, sk, hkv, d) with q's batch row i at
    k/v row ``kv_row + i``; all bf16 on one CUDA device.  ``q_offset``
    and ``kv_row`` are ints or 0-d integer tensors on that device.
    Returns (b, sq, h, d)."""
    global LAUNCHES
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash kernel takes tensors on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16, got {q.dtype}")
    b, sq, h, d = q.shape
    kb, sk, hkv, _ = k.shape
    rows_fit = kb >= b if isinstance(kv_row, torch.Tensor) else 0 <= kv_row <= kb - b
    if v.shape != k.shape or not rows_fit or k.shape[3] != d or h % hkv:
        raise ValueError(f"flash shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} kv_row {kv_row}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    stages = attention_launch_geometry(sq, sk, d, b, h, hkv)["stages"]
    launch(q, k, v, out, q_offset, causal, stages, kv_row)
    LAUNCHES += 1
    return out
