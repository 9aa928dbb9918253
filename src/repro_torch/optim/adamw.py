"""AdamW with decoupled weight decay, a warmup-cosine learning rate and
global-norm clipping.

Ports ``src/repro/optim/adamw.py`` with its numerics: m and v in f32,
the learning rate, bias corrections and clip scale in f32 on the device,
and each parameter updated in f32 and cast back to its dtype.  The
reference's update is pure; here :func:`update` writes parameters, m, v
and the step counter in place under ``torch.no_grad()`` (at 2.6 B
parameters an out-of-place update would need a second copy of all of
them) and returns the objects it was given.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, NamedTuple, Tuple

import torch

from ..tree import leaves, map_tree


class AdamWState(NamedTuple):
    step: torch.Tensor      # int32 scalar on the parameters' device
    m: Any
    v: Any


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def init(params) -> AdamWState:
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    dev = leaves(params)[0].device
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      m=map_tree(zeros, params), v=map_tree(zeros, params))


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def global_norm(tree) -> torch.Tensor:
    """The f32 norm of all leaves together, on their device: each leaf's
    f32 squares summed, as the reference sums them.  (``torch.sum`` sums
    in a cascade on the CPU; ``linalg.vector_norm`` there keeps one f32
    running sum, which drifts on leaves of millions of entries.)"""
    sq = [x.to(torch.float32, copy=True).square_().sum() for x in leaves(tree)]
    return torch.stack(sq).sum().sqrt()


@torch.no_grad()
def update(cfg: AdamWConfig, grads, state: AdamWState, params
           ) -> Tuple[Any, AdamWState, Dict[str, torch.Tensor]]:
    """One AdamW step, in place.  Returns (params, state, metrics) with
    ``grad_norm`` and ``lr`` as f32 scalars on the device."""
    flat_g = leaves(grads)
    gnorm = global_norm(flat_g)
    scale = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    state.step.add_(1)
    lr = lr_at(cfg, state.step)
    step = state.step.float()
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for p, g, m, v in zip(leaves(params), flat_g, leaves(state.m),
                          leaves(state.v)):
        g32 = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        v.mul_(cfg.b2).addcmul_(g32, g32, value=1 - cfg.b2)
        # delta = m̂ / (√v̂ + eps) + wd · p, with g32's storage for the
        # denominator
        denom = torch.div(v, b2c, out=g32).sqrt_().add_(cfg.eps)
        delta = torch.div(m, b1c).div_(denom)
        p32 = p.float()
        delta.add_(p32, alpha=cfg.weight_decay).mul_(lr)
        if p.dtype == torch.float32:
            p.sub_(delta)
        else:
            p.copy_(p32.sub_(delta))
    return params, state, {"grad_norm": gnorm, "lr": lr}
