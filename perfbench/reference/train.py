"""The reference's training steps: the mean next-token cross entropy of a
batch and a plain AdamW step, in f32 with TF32 off, on f32 copies of the
weights.  Each layer runs under an activation checkpoint and the batch's
rows one after another, so a 4096-token row fits beside the optimizer's
state.  Parameters are stored in the configuration's dtype after every
update, as the configuration keeps them (computed in f32, then rounded)."""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch
from torch.utils.checkpoint import checkpoint

from . import model
from .common import Prec, rmsnorm


def row_loss(params, cfg: Dict[str, Any], tokens: torch.Tensor, labels: torch.Tensor,
             prec: Prec) -> torch.Tensor:
    """The summed cross entropy of one row (f32)."""
    mod = model(cfg["reference"])
    pos = torch.arange(tokens.shape[0], device=tokens.device)
    x = params["embed"][tokens]
    for p in params["layers"]:
        x = checkpoint(lambda h, p=p: mod.layer(h, p, cfg, pos, prec), x, use_reentrant=False)
    x = rmsnorm(x, params["final_ln"], cfg.get("rms_norm_eps", cfg.get("layer_norm_epsilon")))
    logits = prec.head(x, params.get("lm_head", params["embed"]))
    return (torch.logsumexp(logits, -1) - logits.gather(-1, labels[:, None])[:, 0]).sum()


def lr_at(opt: Dict[str, float], step: int) -> float:
    """Linear warm-up, then a cosine to ``min_lr_frac`` of the peak."""
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    span = max(opt["total_steps"] - opt["warmup_steps"], 1)
    prog = min(max((step - opt["warmup_steps"]) / span, 0.0), 1.0)
    frac = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (1 + math.cos(math.pi * prog))
    return opt["lr"] * warm * frac


def leaves(tree) -> List[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    return [t for v in tree for t in leaves(v)]


def steps(params, cfg: Dict[str, Any], opt: Dict[str, float], batches, store: torch.dtype,
          prec: Prec = Prec()) -> Dict[str, Any]:
    """Train ``params`` (f32 leaves, updated in place) over ``batches``
    [(tokens (b, s), labels (b, s))]: each step's loss, the first step's
    clipped gradient norm per leaf, and the parameters at the end.  With
    ``prec`` fp8, the control: every product's operands rounded to fp8."""
    flat = leaves(params)
    m = [torch.zeros_like(p) for p in flat]
    v = [torch.zeros_like(p) for p in flat]
    losses, first = [], None
    for t, (tokens, labels) in enumerate(batches, start=1):
        for p in flat:
            p.grad = None
        n = tokens.numel()
        total = 0.0
        for r in range(tokens.shape[0]):
            loss = row_loss(params, cfg, tokens[r], labels[r], prec) / n
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            g = [p.grad for p in flat]
            gnorm = torch.stack([x.square().sum() for x in g]).sum().sqrt()
            scale = torch.clamp(opt["grad_clip"] / (gnorm + 1e-9), max=1.0)
            lr = lr_at(opt, t)
            b1c, b2c = 1 - opt["b1"] ** t, 1 - opt["b2"] ** t
            for p, gi, mi, vi in zip(flat, g, m, v):
                gi = gi * scale
                mi.mul_(opt["b1"]).add_(gi, alpha=1 - opt["b1"])
                vi.mul_(opt["b2"]).addcmul_(gi, gi, value=1 - opt["b2"])
                delta = (mi / b1c) / ((vi / b2c).sqrt() + opt["eps"]) + opt["weight_decay"] * p
                p.copy_((p - lr * delta).to(store).float())
            if first is None:
                first = [float(x.norm() * scale) for x in g]
    for p in flat:
        p.grad = None
    return {"losses": losses, "grad_norms": first}
