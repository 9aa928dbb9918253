"""Weights from the run's seed, made on the device in a few large calls, in
the layout of the port's parameter tree (what a checkpoint of it holds):
``embed``, ``final_ln``, ``lm_head`` and ``layers[l]`` with ``ln1``,
``mixer`` and, for a layer with an MLP, ``ln2`` and ``ffn``.  The layers are
drawn by the configuration's kind of model (``kinds/<kind>.py``).

Each kind of tensor is drawn for all layers at once, in slabs, and each
layer holds a view of its slab row (or, with ``leaves``, a copy of its own,
so that every parameter can be a leaf of autograd).  The scales are the
port's init: products N(0, 1/fan_in), embedding and head N(0, 0.02²), the
conv taps N(0, 0.2²); norm gains, biases and dt bias 0; A_log = log(1..N);
D = 1.  The same tensors are handed to the port and to the reference.
"""
from __future__ import annotations

import math
from typing import Any, Dict, List

import torch

from kinds import kind

from .traffic import torch_seed

SALT_WEIGHTS = 7
SLAB = 1 << 28            # elements drawn per call


def _dtype(name: str) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32,
            "float16": torch.float16}[name]


class Drawer:
    def __init__(self, seed: int, device, dtype: torch.dtype):
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(torch_seed(seed, SALT_WEIGHTS))
        self.device, self.dtype = torch.device(device), dtype

    def normal(self, shape, std: float) -> torch.Tensor:
        """N(0, std²) of ``shape`` in the served dtype, drawn in f32 slabs of
        whole leading rows."""
        out = torch.empty(shape, dtype=self.dtype, device=self.device)
        flat = out.view(shape[0], -1)
        rows = max(1, SLAB // max(flat.shape[1], 1))
        for lo in range(0, shape[0], rows):
            part = flat[lo:lo + rows]
            part.copy_(torch.randn(part.shape, generator=self.gen, device=self.device,
                                   dtype=torch.float32).mul_(std))
        return out


def split(big: torch.Tensor, leaves: bool) -> List[torch.Tensor]:
    """The rows of a slab drawn for all layers: views, or with ``leaves``
    copies of their own."""
    return [t.clone() if leaves else t for t in big.unbind(0)]


def zeros(n_layers: int, dim: int, device, leaves: bool) -> List[torch.Tensor]:
    return split(torch.zeros((n_layers, dim), dtype=torch.float32, device=device), leaves)


def products(draw: Drawer, n_layers: int, shapes, leaves: bool) -> Dict[str, List[torch.Tensor]]:
    """Each (name, fan_in, fan_out) of ``shapes`` drawn for all layers at
    N(0, 1/fan_in), in that order, split into its layers' rows."""
    return {name: split(draw.normal((n_layers, i, o), 1 / math.sqrt(i)), leaves)
            for name, i, o in shapes}


def make(config: Dict[str, Any], seed: int, device, leaves: bool = False) -> Dict[str, Any]:
    """The parameter tree of ``config`` drawn from ``seed`` on ``device``:
    the embedding, then the layers as the configuration's kind draws them,
    then an untied head."""
    layers = kind(config["reference"]).layers
    dt = _dtype(config["torch_dtype"])
    draw = Drawer(seed, device, dt)
    d, vocab = config["hidden_size"], config["vocab_size"]
    p: Dict[str, Any] = {"embed": draw.normal((vocab, d), 0.02),
                         "final_ln": torch.zeros((d,), dtype=torch.float32, device=device)}
    p["layers"] = layers(config, draw, device, leaves)
    if not config["tie_word_embeddings"]:
        p["lm_head"] = draw.normal((vocab, d), 0.02)
    return p


def leaves(tree) -> List[torch.Tensor]:
    """The tensors of a tree, in a fixed order."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [t for k in tree for t in leaves(tree[k])]
    return [t for v in tree for t in leaves(v)]


def leaf_names(tree, at: str = "") -> List[str]:
    """The paths of a tree's tensors (``layers.3.mixer.wq``), in the order of
    :func:`leaves`."""
    if isinstance(tree, torch.Tensor):
        return [at]
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    return [n for k, v in items for n in leaf_names(v, f"{at}.{k}" if at else str(k))]

