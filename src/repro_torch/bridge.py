"""Bridge between the reference's parameter, optimizer-state and cache
pytrees (as numpy arrays) and the port's per-layer dictionaries.

The reference (``src/repro/model/transformer.py``) stacks the layers of
each pattern slot for ``lax.scan``: ``decoder.slots[s]`` leaves carry a
leading repeat axis, and layers past the last full period sit in
``decoder.tail``.  Stacked slot ``s``, repeat ``r`` is the port's layer
``r·period + s``; tail entry ``i`` is layer ``repeats·period + i``.  An
encoder-decoder's ``encoder`` stack (period 1) becomes the port's
``enc_layers`` the same way, and ``enc_final_ln`` and ``frontend_proj``
cross as they are.  Caches (decoder only) follow
``transformer.py:363-367``: ``slots`` entries carry batch on axis 1
(after the repeat axis), ``tail`` entries on axis 0.

Matmul weights keep the reference's ``(in, out)`` orientation.  A JAX
bf16 array arrives in numpy as the ``bfloat16`` extension dtype; it is
viewed as ``uint16`` and reinterpreted as ``torch.bfloat16``, so the
bits are carried over unchanged.  On the way back, bf16 tensors become
``uint16`` arrays holding the same bits (the port does not depend on
the package that defines numpy's ``bfloat16``).
"""
from __future__ import annotations

from typing import Any, Callable, Dict, List

import numpy as np
import torch

from .configs.registry import ArchConfig
from .model.layers import device_of
from .model.transformer import check_supported, pattern_period
from .optim.adamw import AdamWState
from .tree import map_tree


def to_torch(a: Any, device="cuda") -> torch.Tensor:
    a = np.array(a)     # a writable copy: JAX hands out read-only arrays
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a)
    return t.to(device_of(device))


def to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _stack(trees: List[Any]):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _unstack(stack: Dict, cfg: ArchConfig, pick: Callable,
             role: str = "decoder") -> List[Any]:
    """Per-layer list from ``role``'s ``{"slots", "tail"}`` stack."""
    period = pattern_period(cfg, role)
    n = len(check_supported(cfg, role))
    repeats = n // period
    layers: List[Any] = [None] * n
    for s, slot in enumerate(stack["slots"]):
        for r in range(repeats if slot is not None else 0):
            layers[r * period + s] = pick(slot, r)
    for i, lt in enumerate(stack["tail"]):
        layers[repeats * period + i] = lt
    return layers


def _restack(layers: List[Any], cfg: ArchConfig, empty: List[Any],
             role: str = "decoder") -> Dict:
    """Inverse of :func:`_unstack`.  With fewer layers than one period
    the reference leaves ``empty`` as the slots: ``[None] * period`` in
    parameters (``transformer.py:124-128``), ``[]`` in caches (``:356``)."""
    period = pattern_period(cfg, role)
    repeats = len(layers) // period
    slots = [_stack([layers[r * period + s] for r in range(repeats)])
             for s in range(period)] if repeats else empty
    return {"slots": slots, "tail": list(layers[repeats * period:])}


def _pick(slot, r):
    return map_tree(lambda a: np.asarray(a)[r], slot)


def params_from_numpy(tree: Dict, cfg: ArchConfig, device="cuda") -> Dict:
    """The reference's ``init_params`` pytree (numpy leaves) → the port's
    parameters on ``device``."""
    conv = lambda a: to_torch(a, device)  # noqa: E731
    p = {"embed": conv(tree["embed"]), "final_ln": conv(tree["final_ln"]),
         "layers": [map_tree(conv, lt) for lt in _unstack(tree["decoder"], cfg, _pick)]}
    if "lm_head" in tree:
        p["lm_head"] = conv(tree["lm_head"])
    if "encoder" in tree:
        p["enc_layers"] = [map_tree(conv, lt)
                           for lt in _unstack(tree["encoder"], cfg, _pick, "encoder")]
        p["enc_final_ln"] = conv(tree["enc_final_ln"])
    if "frontend_proj" in tree:
        p["frontend_proj"] = conv(tree["frontend_proj"])
    return p


def params_to_numpy(params: Dict, cfg: ArchConfig) -> Dict:
    """Inverse of :func:`params_from_numpy` (bf16 leaves as ``uint16``
    bits)."""
    def stack(layers, role):
        return _restack([map_tree(to_numpy, lt) for lt in layers], cfg,
                        [None] * pattern_period(cfg, role), role)
    tree = {"embed": to_numpy(params["embed"]),
            "final_ln": to_numpy(params["final_ln"]),
            "decoder": stack(params["layers"], "decoder")}
    if "lm_head" in params:
        tree["lm_head"] = to_numpy(params["lm_head"])
    if "enc_layers" in params:
        tree["encoder"] = stack(params["enc_layers"], "encoder")
        tree["enc_final_ln"] = to_numpy(params["enc_final_ln"])
    if "frontend_proj" in params:
        tree["frontend_proj"] = to_numpy(params["frontend_proj"])
    return tree


def opt_state_from_numpy(state, cfg: ArchConfig, device="cuda") -> AdamWState:
    """The reference's ``AdamWState`` (numpy leaves; any ``(step, m, v)``
    triple) → the port's.  m and v have the parameters' tree and take
    the same slot ↔ layer mapping; ``step`` becomes an int32 scalar."""
    step, m, v = state
    return AdamWState(
        torch.tensor(int(np.asarray(step)), dtype=torch.int32,
                     device=device_of(device)),
        params_from_numpy(m, cfg, device), params_from_numpy(v, cfg, device))


def opt_state_to_numpy(state: AdamWState, cfg: ArchConfig) -> AdamWState:
    """Inverse of :func:`opt_state_from_numpy`: numpy leaves in the
    reference's tree (``AdamWState(*result)`` rebuilds the reference's
    state)."""
    return AdamWState(to_numpy(state.step), params_to_numpy(state.m, cfg),
                      params_to_numpy(state.v, cfg))


def cache_from_numpy(tree: Dict, cfg: ArchConfig, device="cuda") -> List[Dict]:
    """The reference's ``init_cache`` pytree → the port's per-layer
    cache; both have batch first within a layer."""
    return [map_tree(lambda a: to_torch(a, device), lc) for lc in _unstack(tree, cfg, _pick)]


def cache_to_numpy(cache: List[Dict], cfg: ArchConfig) -> Dict:
    return _restack([map_tree(to_numpy, lc) for lc in cache], cfg, [])
