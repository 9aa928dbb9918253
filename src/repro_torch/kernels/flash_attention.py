"""Causal flash attention: the launch wrapper of ``csrc/flash_attention.cu``.

Ports ``src/repro/kernels/flash_attention.py``.  The kernel takes the
public layout of ``ops.flash_attention`` — q (b, sq, h, d) and k/v
(b, sk, hkv, d) — through strides, so a page-aligned prefix of the KV
cache is read in place (through TMA tensor maps over the cache's own
strides) and GQA reads kv head ``h // rep`` without a repeated copy.
``q_offset`` (the chunk's position) and ``sk`` are runtime arguments:
one build serves every prefill chunk.  The load ring's depth comes from
:func:`repro_torch.plan.attention_launch_geometry`; ragged ``sq`` and
``sk`` are masked in the kernel.  The kernel is built for head dims 64,
128 and 256; other head dims raise.  The plain version is
:func:`repro_torch.kernels.ref.flash_attention_ref`.
"""
from __future__ import annotations

import torch

from ..plan import attention_launch_geometry
from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0


def _strides(x: torch.Tensor, name: str):
    if x.stride(-1) != 1:
        raise ValueError(f"flash kernel needs {name} with a contiguous head "
                         f"dim; got strides {x.stride()}")
    return x.stride(0), x.stride(1), x.stride(2)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
           q_offset: int, causal: bool, stages: int) -> None:
    """One launch with a ring of ``stages`` slots, into ``out``, without
    counting it (``chip_smoke.py``'s geometry sweep calls this directly)."""
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    rc = build.load_library().repro_flash_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        b, h, hkv, sq, sk, d, int(q_offset), int(causal), stages,
        *_strides(q, "q"), *_strides(k, "k"), *_strides(v, "v"), *_strides(out, "out"),
        build.stream_ptr(q.device))
    build.check(rc, "flash_attention")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (b, sq, h, d); k, v: (b, sk, hkv, d); all bf16 on one CUDA
    device.  Returns (b, sq, h, d)."""
    global LAUNCHES
    if q.device.type != "cuda" or k.device != q.device or v.device != q.device:
        raise ValueError("flash kernel takes tensors on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"flash kernel takes bf16, got {q.dtype}")
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    if v.shape != k.shape or k.shape[0] != b or k.shape[3] != d or h % hkv:
        raise ValueError(f"flash shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    out = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    if b == 0 or sq == 0:
        return out
    stages = attention_launch_geometry(sq, sk, d, b, h, hkv)["stages"]
    launch(q, k, v, out, q_offset, causal, stages)
    LAUNCHES += 1
    return out
