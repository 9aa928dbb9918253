"""Plain PyTorch versions of the kernels (allclose targets).

Ports ``src/repro/kernels/ref.py`` for the two kernels of the serving
path.  ``kernels/ops.py`` runs these whenever its tensors lie on the CPU;
``chip_smoke.py`` holds each CUDA kernel against them on the card.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30        # the flash kernel's mask value (flash_attention.py:28)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with f32 accumulation, cast to A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """q: (bh, sq, d); k, v: (bh, sk, d).  The q rows sit at sequence
    positions ``q_offset + row`` (chunked prefill over a kv prefix of
    ``sk`` rows); causal masking compares those positions with the kv
    columns.  f32 softmax, output ``acc / max(l, 1e-30)`` as the flash
    kernel computes it."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, sk = s.shape[-2:]
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: int = 0) -> torch.Tensor:
    """Public layout of ``ops.flash_attention``: q (b, sq, h, d), k/v
    (b, sk, hkv, d).  GQA repeats each kv head ``h // hkv`` times, as
    ``src/repro/kernels/ops.py:36-39`` does, then runs
    :func:`attention_ref` on the (b·h, s, d) layout."""
    b, sq, h, d = q.shape
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * h, -1, d)
    vf = v.transpose(1, 2).reshape(b * h, -1, d)
    out = attention_ref(qf, kf, vf, causal=causal, q_offset=q_offset)
    return out.reshape(b, h, sq, d).transpose(1, 2)
