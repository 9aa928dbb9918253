"""SwiGLU MLP and Mixture-of-Experts.

Ports ``mlp``, ``init_mlp``, ``init_moe`` and ``moe`` of
``src/repro/model/mlp.py``.  At or above ``min_matmul_rows`` tokens, with
the kernel mode enabled, the three MLP projections go through the planned
matmul kernel (``mlp.py:31-49``).

MoE is the reference's top-k token-choice routing with a capacity-bounded
one-hot dispatch, and the expert products are batched einsums over all
experts, as the reference leaves them to XLA: no kernel runs them.  The
reference routes in G groups, one per data-parallel shard
(``sharding.moe_groups``); on one device G is 1, so the port routes all
of a call's tokens as one group.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.registry import ArchConfig
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


def init_moe(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> Dict:
    """Router (d, e) in f32; expert weights stacked over the expert axis:
    ``w_gate``/``w_up`` (e, d, f), ``w_down`` (e, f, d)."""
    e, d, f = cfg.n_experts, cfg.d_model, cfg.d_ff

    def experts(shape, scale):
        w = torch.randn(shape, generator=gen, device=gen.device,
                        dtype=torch.float32)
        return w.mul_(scale).to(dtype)

    p = {
        "router": dense_init(gen, d, e, torch.float32),
        "w_gate": experts((e, d, f), d ** -0.5),
        "w_up": experts((e, d, f), d ** -0.5),
        "w_down": experts((e, f, d), f ** -0.5),
    }
    if cfg.shared_expert:
        p["shared"] = init_mlp(gen, d, f, dtype)
    return p


def route(p, cfg: ArchConfig, xt: torch.Tensor
          ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Top-k routing of tokens ``xt`` (t, d): the router's softmax
    probabilities (t, e) in f32, and each token's k picks as gates
    renormalised to sum to 1 (t, k) and expert ids (t, k), best first."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = torch.topk(probs, cfg.top_k, dim=-1)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, gate_idx


def moe(p, cfg: ArchConfig, x: torch.Tensor, capacity_factor: float = 1.25
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Token-choice MoE over x (b, s, d).  Returns (output, aux_loss).

    Each expert seats at most ``cap`` picks, in the order of the
    flattened (token, k) picks; the picks past it are dropped, so a
    token's output depends on the other rows of the call."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = route(p, cfg, xt)

    cap = max(int(capacity_factor * t * k / e) + 3 & ~3, 4)
    # seat of each (token, k) pick in its expert's queue: a running count
    # over the flattened picks, scanned along the last axis, which CUDA
    # scans in parallel (along the first, one thread walks all t·k rows)
    oh = F.one_hot(gate_idx, e)                                 # (t, k, e)
    count = oh.reshape(t * k, e).T.cumsum(-1).T.reshape(t, k, e)
    pos = ((count - 1) * oh).sum(-1)
    seat = torch.where(pos < cap, pos, cap)                     # cap = dropped
    disp4 = (oh.to(x.dtype)[..., None]
             * F.one_hot(seat, cap + 1).to(x.dtype)[..., None, :])[..., :cap]
    comb4 = disp4 * gate_vals[..., None, None].to(x.dtype)
    disp, comb = disp4.sum(1), comb4.sum(1)                     # (t, e, cap)

    xe = torch.einsum("tec,td->ecd", disp, xt)                  # (e, cap, d)
    h = F.silu(torch.einsum("ecd,edf->ecf", xe, p["w_gate"])) \
        * torch.einsum("ecd,edf->ecf", xe, p["w_up"])
    ye = torch.einsum("ecf,efd->ecd", h, p["w_down"])           # (e, cap, d)
    out = torch.einsum("tec,ecd->td", comb, ye).reshape(b, s, d)

    if cfg.shared_expert:
        out = out + mlp(p["shared"], x)

    # load-balancing aux loss (Switch-style)
    frac_tokens = F.one_hot(gate_idx[:, 0], e).float().mean(0)
    aux = e * torch.sum(frac_tokens * probs.mean(0))
    return out.to(x.dtype), aux
