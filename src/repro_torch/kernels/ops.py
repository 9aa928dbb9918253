"""Public wrappers for the kernels: CUDA tensors go to the hand-written
Hopper kernel, CPU tensors to its plain version.  Nothing else happens
here — no fallback from one to the other.

Kernels A-E have no backward (the reference's Pallas kernels have no VJP
either), so each of their wrappers refuses an input that requires grad
while autograd records: on the CPU autograd would otherwise differentiate
the plain version quietly, where the card's kernel cannot.  The check
reads tensor flags only, so it costs no device work and holds inside a
CUDA graph capture.  Kernel F, ``train_attention``, is the one with a
backward: on the card a ``torch.autograd.Function`` whose backward is
kernels too, on the CPU its plain version under autograd.

Ports ``src/repro/kernels/ops.py`` and keeps its layouts: q is
(b, s, h, d), k/v are (b, s, hkv, d), GQA has rep = h // hkv; the scans
take a_bar/b_bar (b, s, di, st), c (b, s, st) and x/z (b, s, di).
``paged_decode_attention`` (kernel E) and ``train_attention`` (kernel F)
have no counterpart there: the reference's ragged decode attention and
its training attention are plain jnp.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import decode_attention as _da
from . import flash_attention as _fa
from . import mamba_scan as _ms
from . import matmul_polytops as _mm
from . import ref
from . import scan_gate as _sg
from . import train_attention as _ta


def _no_grad_through(*ts: Optional[torch.Tensor]) -> None:
    """Refuse operands autograd would differentiate: kernels A-E have no backward."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in ts):
        raise RuntimeError("kernels A-E have no backward: run the kernel mode "
                           "only on inputs that do not require grad")


def _on_cuda(x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return True
    if x.device.type == "cpu":
        return False
    raise ValueError(f"no kernel for device {x.device}")


def matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    _no_grad_through(a, b)
    return _mm.matmul(a, b) if _on_cuda(a) else ref.matmul_ref(a, b)


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    causal: bool = True, q_offset: _fa.Index = 0,
                    kv_row: _fa.Index = 0) -> torch.Tensor:
    """q: (b, s, h, d); k/v: (kb, s_kv, hkv, d), q's batch row i at k/v
    row ``kv_row + i`` (kb = b and ``kv_row`` 0 unless q is one slot of a
    batched cache).  ``q_offset`` positions the q chunk for causal masking
    against a longer kv prefix (chunked prefill).  Both are ints or 0-d
    integer tensors on q's device; a tensor is never read on the host."""
    _no_grad_through(q, k, v)
    if _on_cuda(q):
        return _fa.flash_attention(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_row=kv_row)
    return ref.flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset,
                                   kv_row=kv_row)


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """One query row per slot over a page-aligned KV prefix: q (b, 1, h,
    d); k/v (b, kv_len, hkv, d); ``lengths`` (b,) on q's device, never
    read on the host.  Row j of slot i counts when j <= ``lengths[i]``
    and, with a ``window``, j > ``lengths[i] - window``."""
    _no_grad_through(q, k, v)
    if _on_cuda(q):
        return _da.paged_decode_attention(q, k, v, lengths, window)
    return ref.paged_decode_attention_ref(q, k, v, lengths, window)


def selective_scan(a_bar: torch.Tensor, b_bar: torch.Tensor,
                   c: torch.Tensor) -> torch.Tensor:
    _no_grad_through(a_bar, b_bar, c)
    if _on_cuda(a_bar):
        return _ms.selective_scan(a_bar, b_bar, c)
    return ref.selective_scan_ref(a_bar, b_bar, c)


def scan_gate(a_bar: torch.Tensor, b_bar: torch.Tensor, c: torch.Tensor,
              x_skip: torch.Tensor, d_skip: torch.Tensor, z: torch.Tensor,
              h0: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused selective scan + skip + SiLU gate with state carry.
    Returns (o (b, s, di) in x_skip's dtype, h_last (b, di, st) f32)."""
    _no_grad_through(a_bar, b_bar, c, x_skip, d_skip, z, h0)
    if _on_cuda(a_bar):
        return _sg.scan_gate(a_bar, b_bar, c, x_skip, d_skip, z, h0=h0)
    return ref.scan_gate_ref(a_bar, b_bar, c, x_skip, d_skip, z, h0=h0)


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of the training step, differentiable: q (b, s,
    h, d), k/v (b, s, hkv, d), row i sees rows j <= i.  On the card kernel
    F (bf16, head dims 64 and 128), on the CPU its plain version."""
    if _on_cuda(q):
        return _ta.train_attention(q, k, v)
    return ref.train_attention_ref(q, k, v)
