"""A dense decoder with grouped-query attention and a SwiGLU MLP in every
layer (Granite)."""
from __future__ import annotations

from typing import Any, Dict, List

from harness.weights import products, zeros


def port_keys(arch) -> Dict[str, Any]:
    return {"num_attention_heads": arch.n_heads, "num_key_value_heads": arch.n_kv_heads,
            "head_dim": arch.hd, "intermediate_size": arch.d_ff, "rms_norm_eps": arch.norm_eps}


def layers(config: Dict[str, Any], draw, device, leaves: bool) -> List[Dict[str, Any]]:
    d, L, hd = config["hidden_size"], config["num_hidden_layers"], config["head_dim"]
    q, kv, ff = config["num_attention_heads"] * hd, config["num_key_value_heads"] * hd, \
        config["intermediate_size"]
    mats = products(draw, L, (("wq", d, q), ("wk", d, kv), ("wv", d, kv), ("wo", q, d),
                              ("w_gate", d, ff), ("w_up", d, ff), ("w_down", ff, d)), leaves)
    ln1, ln2 = zeros(L, d, device, leaves), zeros(L, d, device, leaves)
    return [{"ln1": ln1[i],
             "mixer": {k: mats[k][i] for k in ("wq", "wk", "wv", "wo")},
             "ln2": ln2[i],
             "ffn": {k: mats[k][i] for k in ("w_gate", "w_up", "w_down")}}
            for i in range(L)]


def matmul_params(config: Dict[str, Any]) -> int:
    d, L = config["hidden_size"], config["num_hidden_layers"]
    q = config["num_attention_heads"] * config["head_dim"]
    kv = config["num_key_value_heads"] * config["head_dim"]
    return L * (d * q + 2 * d * kv + q * d + 3 * d * config["intermediate_size"])


def attention(config: Dict[str, Any]):
    return config["num_hidden_layers"], config["num_attention_heads"], config["head_dim"]


def mlp_widths(config: Dict[str, Any]):
    return config["hidden_size"], config["intermediate_size"]


def scan_widths(config: Dict[str, Any]):
    return None


def tiny(dtype: str) -> Dict[str, Any]:
    """Ties its output head to the embedding, as Granite does."""
    return {"reference": "dense_gqa", "model_type": "granite", "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
            "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512,
            "torch_dtype": dtype, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
            "tie_word_embeddings": True,
            "port": {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
                     "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 512,
                     "head_dim": 16, "norm_eps": 1e-5, "dtype": dtype,
                     "tie_embeddings": True}}
