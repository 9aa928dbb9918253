"""Train / prefill / serve step builders.

Ports ``src/repro/train/steps.py``.  ``make_train_step`` splits the batch
into ``n_micro`` micro-batches, takes each one's gradients with
``torch.autograd.grad`` (in the parameters' dtype, as
``jax.value_and_grad`` gives them), sums them in f32 and hands the mean
to AdamW.  The step updates the parameters and optimizer state in place
and returns the objects it was given.  A batch is ``tokens`` and
``labels``, and for a vlm also ``frontend`` (b, frontend_len, d_model),
for an encoder-decoder ``enc_frontend`` (b, frames, d_model), split into
micro-batches with them (:func:`_batch_kw`).

On a mesh (parameters, optimizer state and batch as DTensors, rules
installed by the launcher) the steps run under
``sharding.sharded()``, and each micro-batch's gradients pass through
``sharding.constrain_grads``, as the reference's accumulators do, and
are then placed as their parameters (a partial gradient is reduced);
the metrics come back as plain (replicated) scalars.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..configs.registry import ArchConfig
from ..model import transformer as T
from ..model.sharding import constrain_grads, full, placed_like, sharded
from ..optim import adamw
from ..tree import leaves, with_leaves


def _batch_kw(cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The model inputs of ``batch`` beside the tokens."""
    kw = {}
    if cfg.family == "vlm":
        kw["frontend"] = batch["frontend"]
    if cfg.enc_layers:
        kw["enc_frontend"] = batch["enc_frontend"]
    return kw


def make_train_step(cfg: ArchConfig, opt_cfg: adamw.AdamWConfig, n_micro: int):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: metrics ``loss`` (mean of the micro-batch losses),
    ``grad_norm`` and ``lr``, f32 scalars on the device.  The parameters
    must require grad.  With more than one micro-batch the f32
    accumulators are allocated at the first call and reused; with one,
    the gradients go to AdamW as they are, which casts them to f32: the
    same values as the reference's f32 sum of one term."""
    acc: Optional[List[torch.Tensor]] = None

    def train_step(params, opt_state: adamw.AdamWState,
                   batch: Dict[str, torch.Tensor]):
        with sharded():
            return step(params, opt_state, batch)

    def step(params, opt_state, batch):
        nonlocal acc
        flat_p = leaves(params)
        gb = batch["tokens"].shape[0]
        if gb % n_micro:
            raise ValueError(f"batch of {gb} rows does not split into "
                             f"{n_micro} micro-batches")
        mb = gb // n_micro
        extra = _batch_kw(cfg, batch)
        micro = zip(batch["tokens"].split(mb), batch["labels"].split(mb),
                    *(x.split(mb) for x in extra.values()))
        losses, grads = [], None
        for i, (tok, lab, *ex) in enumerate(micro):
            loss = T.lm_loss(params, cfg, tok, lab, **dict(zip(extra, ex)))
            # at their parameters' placements: AdamW updates in place,
            # which DTensor allows only there
            g = [placed_like(gi, p) for gi, p in zip(leaves(constrain_grads(
                with_leaves(params, list(torch.autograd.grad(loss, flat_p))))), flat_p)]
            losses.append(loss.detach())
            if n_micro == 1:
                grads = g
                continue
            if acc is None:
                acc = [torch.empty_like(p, dtype=torch.float32,
                                        memory_format=torch.contiguous_format)
                       for p in flat_p]
            with torch.no_grad():
                for a, gi in zip(acc, g):
                    if i == 0:
                        a.copy_(gi)
                    else:
                        a.add_(gi)
            del g     # free this micro-batch's gradients before the next
        if n_micro > 1:
            with torch.no_grad():
                torch._foreach_div_(acc, float(n_micro))
            grads = acc
        params, opt_state, metrics = adamw.update(
            opt_cfg, with_leaves(params, list(grads)), opt_state, params)
        metrics = dict(metrics, loss=torch.stack([full(x) for x in losses]).mean())
        return params, opt_state, {k: full(v) for k, v in metrics.items()}

    return train_step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        with sharded():
            return T.prefill(params, cfg, batch["tokens"], **_batch_kw(cfg, batch))
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One decode step over a full KV cache at the shared position
    ``batch["cache_len"]`` (an int), with an encoder-decoder's
    ``batch["memory"]`` if given."""
    @torch.no_grad()
    def serve_step(params, batch):
        with sharded():
            return T.decode_step(params, cfg, batch["token"], batch["cache"],
                                 batch["cache_len"], batch.get("memory"))
    return serve_step
