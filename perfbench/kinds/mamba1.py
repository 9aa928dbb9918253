"""A pure Mamba-1 stack: a selective-scan mixer in every layer, no MLP
(Falcon-Mamba).  Its ``intermediate_size`` is d_inner, and kernel C runs in
every layer."""
from __future__ import annotations

from typing import Any, Dict, List

import torch

from harness.weights import products, split, zeros


def port_keys(arch) -> Dict[str, Any]:
    return {"intermediate_size": arch.d_inner, "state_size": arch.ssm_state,
            "conv_kernel": arch.conv_width, "time_step_rank": arch.dt_rank_,
            "layer_norm_epsilon": arch.norm_eps}


def layers(config: Dict[str, Any], draw, device, leaves: bool) -> List[Dict[str, Any]]:
    d, L = config["hidden_size"], config["num_hidden_layers"]
    di, st, dtr, cw = (config["intermediate_size"], config["state_size"],
                       config["time_step_rank"], config["conv_kernel"])
    mats = products(draw, L, (("in_proj", d, 2 * di), ("x_proj", di, dtr + 2 * st),
                              ("dt_proj", dtr, di), ("out_proj", di, d)), leaves)
    conv_w = split(draw.normal((L, cw, di), 0.2), leaves)
    a = torch.log(torch.arange(1, st + 1, dtype=torch.float32, device=device))
    a_log = split(a.expand(L, di, st).contiguous(), leaves)
    d_skip = split(torch.ones((L, di), dtype=torch.float32, device=device), leaves)
    zero = {k: zeros(L, di, device, leaves) for k in ("conv_b", "dt_bias")}
    ln1 = zeros(L, d, device, leaves)
    return [{"ln1": ln1[i], "mixer": {
        "in_proj": mats["in_proj"][i], "conv_w": conv_w[i], "conv_b": zero["conv_b"][i],
        "x_proj": mats["x_proj"][i], "dt_proj": mats["dt_proj"][i],
        "dt_bias": zero["dt_bias"][i], "a_log": a_log[i], "d_skip": d_skip[i],
        "out_proj": mats["out_proj"][i]}} for i in range(L)]


def matmul_params(config: Dict[str, Any]) -> int:
    d, L = config["hidden_size"], config["num_hidden_layers"]
    di, st, r = config["intermediate_size"], config["state_size"], config["time_step_rank"]
    return L * (d * 2 * di + di * (r + 2 * st) + r * di + di * d)


def attention(config: Dict[str, Any]):
    return 0, 0, 0


def mlp_widths(config: Dict[str, Any]):
    return None


def scan_widths(config: Dict[str, Any]):
    return config["num_hidden_layers"], config["intermediate_size"], config["state_size"]


def tiny(dtype: str) -> Dict[str, Any]:
    return {"reference": "mamba1", "model_type": "falcon_mamba", "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "state_size": 16,
            "conv_kernel": 4, "time_step_rank": 8, "vocab_size": 512, "torch_dtype": dtype,
            "layer_norm_epsilon": 1e-5, "tie_word_embeddings": False,
            "port": {"name": "tiny-mamba", "family": "ssm", "n_layers": 2, "d_model": 64,
                     "n_heads": 1, "n_kv_heads": 1, "d_ff": 0, "vocab": 512, "ssm_state": 16,
                     "d_inner_mult": 2, "dt_rank": 8, "norm_eps": 1e-5, "dtype": dtype}}
