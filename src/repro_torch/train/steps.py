"""Train / prefill / serve step builders.

Ports ``src/repro/train/steps.py``.  ``make_train_step`` splits the batch
into ``n_micro`` micro-batches, takes each one's gradients with
``torch.autograd.grad`` (in the parameters' dtype, as
``jax.value_and_grad`` gives them), sums them in f32 and hands the mean
to AdamW.  The step updates the parameters and optimizer state in place
and returns the objects it was given.  A batch is ``tokens`` and
``labels``, and for an encoder-decoder also ``enc_frontend`` (b, frames,
d_model), split into micro-batches with them (:func:`_batch_kw`).  The
vlm's ``frontend`` waits for qwen2-vl (``transformer.check_supported``
refuses it).
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import torch

from ..configs.registry import ArchConfig
from ..model import transformer as T
from ..optim import adamw
from ..tree import leaves, with_leaves


def _batch_kw(cfg: ArchConfig, batch: Dict[str, torch.Tensor]) -> Dict[str, Any]:
    """The model inputs of ``batch`` beside the tokens."""
    return {"enc_frontend": batch["enc_frontend"]} if cfg.enc_layers else {}


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
            g = torch.autograd.grad(loss, flat_p)
            losses.append(loss.detach())
            if n_micro == 1:
                grads = g
                continue
            if acc is None:
                acc = [torch.empty(p.shape, dtype=torch.float32, device=p.device)
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
        metrics = dict(metrics, loss=torch.stack(losses).mean())
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ArchConfig):
    @torch.no_grad()
    def prefill_step(params, batch):
        return T.prefill(params, cfg, batch["tokens"], **_batch_kw(cfg, batch))
    return prefill_step


def make_serve_step(cfg: ArchConfig):
    """One decode step over a full KV cache at the shared position
    ``batch["cache_len"]`` (an int), with an encoder-decoder's
    ``batch["memory"]`` if given."""
    @torch.no_grad()
    def serve_step(params, batch):
        return T.decode_step(params, cfg, batch["token"], batch["cache"],
                             batch["cache_len"], batch.get("memory"))
    return serve_step
