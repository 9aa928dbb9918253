"""Public wrappers for the kernels: CUDA tensors go to the hand-written
Hopper kernel, CPU tensors to its plain version.  Nothing else happens
here — no fallback from one to the other.

Ports ``src/repro/kernels/ops.py`` and keeps its layouts: q is
(b, s, h, d), k/v are (b, s, hkv, d), GQA has rep = h // hkv.  The Mamba
kernels (``scan_gate``, ``selective_scan``) come with the Mamba slice.
"""
from __future__ import annotations

import torch

from . import flash_attention as _fa
from . import matmul_polytops as _mm
from . import ref


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return _mm.matmul(a, b) if _on_cuda(a) else ref.matmul_ref(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (b, s, h, d); k/v: (b, s_kv, hkv, d).  ``q_offset`` positions
    the q chunk for causal masking against a longer kv prefix (chunked
    prefill)."""
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
