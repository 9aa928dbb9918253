"""SwiGLU MLP and Mixture-of-Experts.

Ports ``mlp``, ``init_mlp``, ``init_moe`` and ``moe`` of
``src/repro/model/mlp.py``.  At or above ``min_matmul_rows`` tokens, with
the kernel mode enabled, the three MLP projections go through the planned
matmul kernel (``mlp.py:31-49``).

MoE is the reference's top-k token-choice routing with a capacity-bounded
one-hot dispatch, and the expert products are batched einsums over all
experts, as the reference leaves them to XLA: no kernel runs them.
Tokens route in G groups (``sharding.moe_groups``, which the launcher
sets to the data-parallel shard count; 1 otherwise), each with its own
capacity, as the reference's do.  The activation annotations are the
reference's (``sharding.shard_activation``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.registry import ArchConfig
from .kernel_mode import mode
from .layers import dense_init
from .sharding import moe_groups, one_hot, shard_activation, topk_last


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
        h = shard_activation(h.reshape(x.shape[:-1] + (-1,)), ("batch", "seq", "ffn"))
        return ops.matmul(h.reshape(rows, -1), p["w_down"]).reshape(x.shape)
    h = F.silu(x @ p["w_gate"]) * (x @ p["w_up"])
    h = shard_activation(h, ("batch", "seq", "ffn"))
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
    """Top-k routing of tokens ``xt`` (..., d): the router's softmax
    probabilities (..., e) in f32, and each token's k picks as gates
    renormalised to sum to 1 (..., k) and expert ids (..., k), best
    first."""
    probs = torch.softmax(xt.float() @ p["router"], dim=-1)
    gate_vals, gate_idx = topk_last(probs, cfg.top_k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp(min=1e-9)
    return probs, gate_vals, gate_idx


def _expert_mm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Each expert's rows times its weight: x (g, e, cap, i), w (e, i, o)
    → (g, e, cap, o), as one batched matmul over the experts."""
    g, e, cap, i = x.shape
    y = torch.bmm(x.transpose(0, 1).reshape(e, g * cap, i), w)
    return y.reshape(e, g, cap, w.shape[-1]).transpose(0, 1)


def moe(p, cfg: ArchConfig, x: torch.Tensor, capacity_factor: float = 1.25
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Grouped token-choice MoE over x (b, s, d).  Returns (output,
    aux_loss).

    The b·s tokens split into G = ``moe_groups()`` routing groups (1 if G
    does not divide them).  In each group an expert seats at most ``cap``
    picks, in the order of the group's flattened (token, k) picks; the
    picks past it are dropped, so a token's output depends on the other
    rows of its group.  Dispatch tensors are (G, t/G, e, cap)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.top_k
    t = b * s
    g = moe_groups()
    if t % g:
        g = 1
    tg = t // g
    xt = shard_activation(x.reshape(g, tg, d), ("batch", None, None))
    probs, gate_vals, gate_idx = route(p, cfg, xt)               # (g, tg, ·)

    cap = max(int(capacity_factor * tg * k / e) + 3 & ~3, 4)
    # seat of each (token, k) pick in its expert's queue: a running count
    # over the group's flattened picks, scanned along the last axis, which
    # CUDA scans in parallel (along the picks, one thread walks all tg·k)
    oh = one_hot(gate_idx, e)                                   # (g, tg, k, e)
    count = oh.reshape(g, tg * k, e).transpose(1, 2).cumsum(-1).transpose(1, 2)
    pos = ((count.reshape(g, tg, k, e) - 1) * oh).sum(-1)
    seat = torch.where(pos < cap, pos, cap)                     # cap = dropped
    disp4 = (oh.to(x.dtype)[..., None]
             * one_hot(seat, cap + 1).to(x.dtype)[..., None, :])[..., :cap]
    comb4 = disp4 * gate_vals[..., None, None].to(x.dtype)
    disp, comb = disp4.sum(2), comb4.sum(2)                     # (g, tg, e, cap)
    disp = shard_activation(disp, ("batch", None, "experts", None))
    comb = shard_activation(comb, ("batch", None, "experts", None))

    # the products as batched matmuls whose flattened dims put the
    # expert dim first: DTensor cannot flatten a split dim behind another
    # on every version, and einsum orders them as it likes
    xe = torch.bmm(disp.reshape(g, tg, e * cap).transpose(1, 2), xt)
    xe = shard_activation(xe.reshape(g, e, cap, d), ("batch", "experts", None, None))
    h = F.silu(_expert_mm(xe, p["w_gate"])) * _expert_mm(xe, p["w_up"])
    ye = shard_activation(_expert_mm(h, p["w_down"]),           # (g, e, cap, d)
                          ("batch", "experts", None, None))
    out = torch.bmm(comb.reshape(g, tg, e * cap), ye.reshape(g, e * cap, d))
    out = out.reshape(b, s, d)

    if cfg.shared_expert:
        out = out + mlp(p["shared"], x)

    # load-balancing aux loss (Switch-style)
    frac_tokens = one_hot(gate_idx[..., 0], e).float().mean((0, 1))
    aux = e * torch.sum(frac_tokens * probs.mean((0, 1)))
    return out.to(x.dtype), aux
