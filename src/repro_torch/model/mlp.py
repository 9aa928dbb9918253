"""SwiGLU MLP.

Ports ``mlp`` and ``init_mlp`` of ``src/repro/model/mlp.py``.  At or
above ``min_matmul_rows`` tokens, with the kernel mode enabled, the three
projections go through the planned matmul kernel (``mlp.py:31-49``).
Mixture-of-experts comes with the MoE families.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from .kernel_mode import mode
from .layers import dense_init


def init_mlp(gen: torch.Generator, d_model: int, d_ff: int,
             dtype: torch.dtype) -> Dict:
    return {
        "w_gate": dense_init(gen, d_model, d_ff, dtype),
        "w_up": dense_init(gen, d_model, d_ff, dtype),
        "w_down": dense_init(gen, d_ff, d_model, dtype),
    }


def mlp(p, x):
    md = mode()
    rows = x[..., 0].numel()
    if md.enabled and rows >= md.min_matmul_rows:
        from ..kernels import ops
        x2 = x.reshape(rows, x.shape[-1])
        h = F.silu(ops.matmul(x2, p["w_gate"])) * ops.matmul(x2, p["w_up"])
        return ops.matmul(h, p["w_down"]).reshape(x.shape)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    return h @ p["w_down"]
