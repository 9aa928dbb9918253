"""Core layers: dtype and device resolution, init, rmsnorm, rope, M-RoPE, embed.

Ports ``src/repro/model/layers.py``.  Conventions are the reference's:
matmul weights are stored ``(in, out)`` and used as ``x @ W``; norms,
softmax and rope math run in f32 and cast back to the input dtype.
Weights are drawn through an explicit ``torch.Generator`` (the reference
draws them from ``jax.random``; the two streams differ, so parity tests
carry the reference's weights across with :mod:`repro_torch.bridge`).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

Device = Union[str, torch.device]


def dtype_of(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


def device_of(device: Optional[Device] = "cuda") -> torch.device:
    """Resolve an entry point's ``device`` argument.  CUDA is the
    default; the CPU runs only when asked for.  Asking for CUDA on a
    machine without a card raises rather than carrying on elsewhere."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA device requested but torch.cuda.is_available() is False; "
            "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def make_generator(seed: int, device: torch.device) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return gen


# ---------------------------------------------------------------------------
# init helpers
# ---------------------------------------------------------------------------

def dense_init(gen: torch.Generator, in_dim: int, out_dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    scale = 1.0 / math.sqrt(in_dim)
    w = torch.randn((in_dim, out_dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * scale).to(dtype)


def embed_init(gen: torch.Generator, vocab: int, dim: int,
               dtype: torch.dtype) -> torch.Tensor:
    w = torch.randn((vocab, dim), generator=gen, device=gen.device,
                    dtype=torch.float32)
    return (w * 0.02).to(dtype)


def rmsnorm_init(dim: int, device: torch.device) -> torch.Tensor:
    return torch.zeros((dim,), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# norms
# ---------------------------------------------------------------------------

def rmsnorm(x: torch.Tensor, gamma: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    """Scales by ``(1 + gamma)`` with gamma initialized to zeros, as the
    reference does; ``torch.nn.RMSNorm`` uses its weight differently."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + gamma.float())).to(x.dtype)


# ---------------------------------------------------------------------------
# RoPE (half-split, theta 1e6) and M-RoPE for qwen2-vl
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e6,
               device: Optional[torch.device] = None) -> torch.Tensor:
    half = head_dim // 2
    return 1.0 / (theta ** (torch.arange(0, half, dtype=torch.float32,
                                         device=device) / half))


def _rotate(x: torch.Tensor, angles: torch.Tensor) -> torch.Tensor:
    """Rotate x's half-split channel pairs by ``angles`` (..., seq, half)
    in f32 and cast back to x's dtype."""
    half = x.shape[-1] // 2
    cos = torch.cos(angles)[..., :, None, :]
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e6) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (half,)
    return _rotate(x, positions[..., :, None].float() * freqs)    # (..., seq, half)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor,
                sections: Tuple[int, int, int] = (1, 1, 2),
                theta: float = 1e6) -> torch.Tensor:
    """Qwen2-VL M-RoPE: the head_dim/2 rotary channels are split into
    (t, h, w) sections, each rotated by its own position stream (at head
    dim 128: 16, 16 and 32 of the 64 channels).  x: (..., seq, heads,
    head_dim); positions3: (..., seq, 3)."""
    half = x.shape[-1] // 2
    bounds = [half * s // sum(sections) for s in sections]
    p = positions3.float()                                        # (..., seq, 3)
    # each channel takes its section's position (the reference's jnp.take)
    chan_pos = torch.cat([p[..., i:i + 1].expand(*p.shape[:-1], n)
                          for i, n in enumerate(bounds)], dim=-1)  # (..., seq, half)
    return _rotate(x, chan_pos * rope_freqs(x.shape[-1], theta, x.device))


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------

def embed(tokens: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return table[tokens]


def unembed(x: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    return x @ table.T
