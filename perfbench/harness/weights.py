"""Weights from the run's seed, made on the device in a few large calls, in
the layout of the port's parameter tree (what a checkpoint of it holds):
``embed``, ``final_ln``, ``lm_head`` and ``layers[l]`` with ``ln1``,
``mixer`` and, for a layer with an MLP, ``ln2`` and ``ffn``.

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


def _split(big: torch.Tensor, leaves: bool) -> List[torch.Tensor]:
    return [t.clone() if leaves else t for t in big.unbind(0)]


def _zeros(n_layers: int, dim: int, device, leaves: bool) -> List[torch.Tensor]:
    return _split(torch.zeros((n_layers, dim), dtype=torch.float32, device=device), leaves)


def make(config: Dict[str, Any], seed: int, device, leaves: bool = False) -> Dict[str, Any]:
    """The parameter tree of ``config`` drawn from ``seed`` on ``device``."""
    kind = config["reference"]
    dt = _dtype(config["torch_dtype"])
    draw = Drawer(seed, device, dt)
    d, vocab, L = config["hidden_size"], config["vocab_size"], config["num_hidden_layers"]
    p: Dict[str, Any] = {"embed": draw.normal((vocab, d), 0.02),
                         "final_ln": torch.zeros((d,), dtype=torch.float32, device=device)}
    if kind == "dense_gqa":
        hd = config["head_dim"]
        q, kv, ff = config["num_attention_heads"] * hd, config["num_key_value_heads"] * hd, \
            config["intermediate_size"]
        mats = {name: _split(draw.normal((L, i, o), 1 / math.sqrt(i)), leaves) for name, i, o in (
            ("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
            ("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d))}
        ln1, ln2 = _zeros(L, d, device, leaves), _zeros(L, d, device, leaves)
        p["layers"] = [{"ln1": ln1[i],
                        "mixer": {k: mats[k][i] for k in ("wq", "wk", "wv", "wo")},
                        "ln2": ln2[i],
                        "ffn": {k: mats[k][i] for k in ("w_gate", "w_up", "w_down")}}
                       for i in range(L)]
    elif kind == "mamba1":
        di, st, dtr, cw = (config["intermediate_size"], config["state_size"],
                           config["time_step_rank"], config["conv_kernel"])
        mats = {name: _split(draw.normal((L, i, o), 1 / math.sqrt(i)), leaves) for name, i, o in (
            ("in_proj", d, 2 * di), ("x_proj", di, dtr + 2 * st), ("dt_proj", dtr, di),
            ("out_proj", di, d))}
        conv_w = _split(draw.normal((L, cw, di), 0.2), leaves)
        a = torch.log(torch.arange(1, st + 1, dtype=torch.float32, device=device))
        a_log = _split(a.expand(L, di, st).contiguous(), leaves)
        d_skip = _split(torch.ones((L, di), dtype=torch.float32, device=device), leaves)
        zeros = {k: _zeros(L, di, device, leaves) for k in ("conv_b", "dt_bias")}
        ln1 = _zeros(L, d, device, leaves)
        p["layers"] = [{"ln1": ln1[i], "mixer": {
            "in_proj": mats["in_proj"][i], "conv_w": conv_w[i], "conv_b": zeros["conv_b"][i],
            "x_proj": mats["x_proj"][i], "dt_proj": mats["dt_proj"][i],
            "dt_bias": zeros["dt_bias"][i], "a_log": a_log[i], "d_skip": d_skip[i],
            "out_proj": mats["out_proj"][i]}} for i in range(L)]
    else:
        raise ValueError(f"no weights for reference kind {kind!r}")
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

