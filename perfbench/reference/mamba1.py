"""A Mamba-1 stack (Falcon-Mamba as the port runs it): RMSNorm before each
block, the input projection to x and the gate z, a causal depthwise conv
with bias and SiLU, the selective SSM (dt from a low-rank projection
through softplus, A = -exp(A_log), a_t = exp(dt·A), b_t = dt·B_t·x_t,
h_t = a_t ⊙ h_{t-1} + b_t, y_t = h_t·C_t + D ⊙ x_t), the gate y ⊙ silu(z)
and the output projection; a final RMSNorm and the head.  All in f32.

The recurrence runs in blocks of ``T_BLOCK`` steps over every sequence at
once: inside a block by doubling (Hillis-Steele, log2 T steps), the state
carried from block to block, so the time paid grows with the length and
not with the number of steps."""
from __future__ import annotations

from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .common import Prec, rmsnorm

T_BLOCK = 128


def softplus(x: torch.Tensor) -> torch.Tensor:
    return torch.logaddexp(x, torch.zeros_like(x))


def scan_block(a: torch.Tensor, b: torch.Tensor, h0: torch.Tensor) -> torch.Tensor:
    """Every state of h_t = a_t ⊙ h_{t-1} + b_t over a block: a, b
    (n, T, di, st), h0 (n, di, st)."""
    k = 1
    while k < a.shape[1]:
        b = torch.cat([b[:, :k], torch.addcmul(b[:, k:], b[:, :-k], a[:, k:])], 1)
        a = torch.cat([a[:, :k], a[:, :-k] * a[:, k:]], 1)
        k *= 2
    return torch.addcmul(b, a, h0[:, None])


def mixer(x, m: Dict[str, Any], cfg: Dict[str, Any], prec: Prec) -> torch.Tensor:
    """The Mamba block on x (n, s, d); the SSM state starts at 0."""
    n, s, _ = x.shape
    di, st, dtr = cfg["intermediate_size"], cfg["state_size"], cfg["time_step_rank"]
    xs, z = prec.mm(x, m["in_proj"]).split([di, di], -1)
    w = m["conv_w"].float()                                  # (cw, di)
    cw = w.shape[0]
    pad = F.pad(xs, (0, 0, cw - 1, 0))
    xs = F.silu(sum(pad[:, i:i + s] * w[i] for i in range(cw)) + m["conv_b"].float())
    dt_r, B, C = prec.mm(xs, m["x_proj"]).split([dtr, st, st], -1)
    dt = softplus(prec.mm(dt_r, m["dt_proj"]) + m["dt_bias"].float())   # (n, s, di)
    A = -torch.exp(m["a_log"].float())                       # (di, st)
    y = torch.empty_like(xs)
    h = torch.zeros((n, di, st), dtype=torch.float32, device=x.device)
    for lo in range(0, s, T_BLOCK):
        hi = min(lo + T_BLOCK, s)
        d = dt[:, lo:hi, :, None]
        hs = scan_block(torch.exp(d * A), d * B[:, lo:hi, None, :] * xs[:, lo:hi, :, None], h)
        y[:, lo:hi] = torch.einsum("ntds,nts->ntd", hs, C[:, lo:hi])
        h = hs[:, -1]
    y = (y + xs * m["d_skip"].float()) * F.silu(z)
    return prec.mm(y, m["out_proj"])


def logits(params: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor,
           rows: List[int], prec: Prec = Prec()) -> torch.Tensor:
    """The logits (len(rows), vocab) at positions ``rows`` of one sequence
    ``tokens`` (s,)."""
    return batch_logits(params, cfg, tokens[None], [rows], prec)[0]


def batch_logits(params: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor,
                 rows: List[List[int]], prec: Prec = Prec()) -> List[torch.Tensor]:
    """Sequences of one length (n, s) at once: a list of (len(rows[i]),
    vocab) logits."""
    eps = cfg["layer_norm_epsilon"]
    x = params["embed"][tokens].float()
    for p in params["layers"]:
        x = x + mixer(rmsnorm(x, p["ln1"], eps), p["mixer"], cfg, prec)
    head = params.get("lm_head", params["embed"])
    return [prec.head(rmsnorm(x[i, r], params["final_ln"], eps), head)
            for i, r in enumerate(rows)]
