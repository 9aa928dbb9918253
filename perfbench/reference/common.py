"""Pieces shared by the reference models: the products (in f32, or with
both operands rounded to fp8 for the control), RMSNorm, rope, the output
head and the greedy gaps."""
from __future__ import annotations

from contextlib import contextmanager

import torch


@contextmanager
def exact_f32():
    """TF32 off for every f32 product inside the block."""
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev


FP8_MAX = 448.0      # largest finite float8_e4m3fn


def fp8(x: torch.Tensor, dim=None) -> torch.Tensor:
    """x rounded to float8 e4m3 and back to f32, scaled per tensor (``dim``
    None) or per slice along ``dim`` so that the largest magnitude maps to
    448, as an fp8 serving path scales weights and activations."""
    x = x.float()
    with torch.no_grad():
        amax = x.abs().amax() if dim is None else x.abs().amax(dim=dim, keepdim=True)
        scale = (amax / FP8_MAX).clamp(min=1e-30)
        q = (x / scale).to(torch.float8_e4m3fn).float() * scale
    # the rounded values forward, the gradient straight through (as fp8
    # training keeps its gradients in a wider type)
    return x + (q - x).detach()


class Prec:
    """How the reference multiplies: ``f32`` (the reference) or ``fp8`` (the
    control: each weight rounded per output column, each activation per
    row, accumulation in f32)."""

    def __init__(self, kind: str = "f32"):
        if kind not in ("f32", "fp8"):
            raise ValueError(kind)
        self.kind = kind

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., in) f32 @ w (in, out) stored weight."""
        if self.kind == "fp8":
            return fp8(x, -1) @ fp8(w, 0)
        return x @ w.float()

    def head(self, x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
        """x (n, d) against the (vocab, d) head."""
        if self.kind == "fp8":
            return fp8(x, -1) @ fp8(table, -1).T
        return x @ table.float().T


def rmsnorm(x: torch.Tensor, gain: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + gain.float())


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """x (seq, heads, hd) rotated by position: channel i of the first half
    pairs with channel i of the second, at frequency theta^(-i/half)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = pos.float()[:, None] * freq                      # (seq, half)
    cos, sin = ang.cos()[:, None, :], ang.sin()[:, None, :]
    a, b = x[..., :half], x[..., half:]
    return torch.cat([a * cos - b * sin, b * cos + a * sin], -1)


def gaps(logits: torch.Tensor, served: torch.Tensor) -> torch.Tensor:
    """How far each served token's logit lies below the row's best, in units
    of the row's standard deviation: logits (n, vocab) f32, served (n,)."""
    best = logits.max(-1).values
    got = logits.gather(-1, served[:, None].long())[:, 0]
    return (best - got) / logits.std(-1)
