"""A dense decoder with grouped-query attention (Granite as the port runs
it): RMSNorm before each block, rope, causal softmax attention over
``num_key_value_heads`` shared key/value heads, a SwiGLU MLP, a final
RMSNorm and an output head.  Everything in f32."""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
import torch.nn.functional as F

from .common import Prec, rmsnorm, rope

Q_BLOCK = 512


def attention(q, k, v, n_rep: int) -> torch.Tensor:
    """Causal attention of q (s, h, hd) over k, v (s, hkv, hd), in blocks of
    query rows; returns (s, h·hd)."""
    s, h, hd = q.shape
    kx = k.repeat_interleave(n_rep, 1).transpose(0, 1)      # (h, s, hd)
    vx = v.repeat_interleave(n_rep, 1).transpose(0, 1)
    out = torch.empty_like(q)
    cols = torch.arange(s, device=q.device)
    for lo in range(0, s, Q_BLOCK):
        hi = min(lo + Q_BLOCK, s)
        qb = q[lo:hi].transpose(0, 1) / math.sqrt(hd)       # (h, b, hd)
        sc = qb @ kx[:, :hi].transpose(1, 2)                # (h, b, hi)
        mask = cols[None, :hi] <= torch.arange(lo, hi, device=q.device)[:, None]
        sc = sc.masked_fill(~mask, float("-inf"))
        out[lo:hi] = (sc.softmax(-1) @ vx[:, :hi]).transpose(0, 1)
    return out.reshape(s, h * hd)


def layer(x, p: Dict[str, Any], cfg: Dict[str, Any], pos, prec: Prec):
    hd = cfg["head_dim"]
    h, hkv = cfg["num_attention_heads"], cfg["num_key_value_heads"]
    eps, theta = cfg["rms_norm_eps"], cfg["rope_theta"]
    m = p["mixer"]
    a = rmsnorm(x, p["ln1"], eps)
    q = rope(prec.mm(a, m["wq"]).view(-1, h, hd), pos, theta)
    k = rope(prec.mm(a, m["wk"]).view(-1, hkv, hd), pos, theta)
    v = prec.mm(a, m["wv"]).view(-1, hkv, hd)
    x = x + prec.mm(attention(q, k, v, h // hkv), m["wo"])
    f = p["ffn"]
    a = rmsnorm(x, p["ln2"], eps)
    return x + prec.mm(F.silu(prec.mm(a, f["w_gate"])) * prec.mm(a, f["w_up"]), f["w_down"])


def logits(params: Dict[str, Any], cfg: Dict[str, Any], tokens: torch.Tensor,
           rows: List[int], prec: Prec = Prec()) -> torch.Tensor:
    """The logits (len(rows), vocab) at positions ``rows`` of one sequence
    ``tokens`` (s,)."""
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens].float()
    for p in params["layers"]:
        x = layer(x, p, cfg, pos, prec)
    x = rmsnorm(x[rows], params["final_ln"], cfg["rms_norm_eps"])
    return prec.head(x, params.get("lm_head", params["embed"]))
