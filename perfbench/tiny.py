"""Small configurations and mixes of the benchmark's kinds, for its CPU
tests: the same keys as the files in ``configs/`` (as run) and ``mixes/``;
the dense one ties its output head to the embedding, as Granite does."""
from __future__ import annotations

import copy


def config(kind: str, dtype: str = "bfloat16") -> dict:
    if kind == "dense_gqa":
        return {"reference": "dense_gqa", "model_type": "granite", "hidden_size": 64,
                "intermediate_size": 128, "num_hidden_layers": 2, "num_attention_heads": 4,
                "num_key_value_heads": 2, "head_dim": 16, "vocab_size": 512,
                "torch_dtype": dtype, "rms_norm_eps": 1e-5, "rope_theta": 1e6,
                "tie_word_embeddings": True,
                "port": {"name": "tiny-dense", "family": "dense", "n_layers": 2, "d_model": 64,
                         "n_heads": 4, "n_kv_heads": 2, "d_ff": 128, "vocab": 512,
                         "head_dim": 16, "norm_eps": 1e-5, "dtype": dtype,
                         "tie_embeddings": True}}
    return {"reference": "mamba1", "model_type": "falcon_mamba", "hidden_size": 64,
            "intermediate_size": 128, "num_hidden_layers": 2, "state_size": 16,
            "conv_kernel": 4, "time_step_rank": 8, "vocab_size": 512, "torch_dtype": dtype,
            "layer_norm_epsilon": 1e-5, "tie_word_embeddings": False,
            "port": {"name": "tiny-mamba", "family": "ssm", "n_layers": 2, "d_model": 64,
                     "n_heads": 1, "n_kv_heads": 1, "d_ff": 0, "vocab": 512, "ssm_state": 16,
                     "d_inner_mult": 2, "dt_rank": 8, "norm_eps": 1e-5, "dtype": dtype}}


def mix(loop: str = "closed") -> dict:
    return copy.deepcopy({
        "kind": "serve", "loop": loop, "clients": 4, "rate": 20.0, "cv": 1.0, "slots": 4,
        "max_len": 256, "chunk": 32, "round": 8, "strata": 4, "rounds": 20, "table_seed": 3,
        "prompt": {"dist": "lognormal", "median": 80, "sigma": 0.5, "min": 40, "max": 200},
        "output": {"dist": "lognormal", "median": 8, "sigma": 0.5, "min": 4, "max": 16},
        "warm_table": loop == "closed", "ramp_s": 0.2, "trace_s": 0.3, "check_requests": 3})


def train_mix() -> dict:
    return {"kind": "train", "batch": 2, "seq": 32, "remat": "full", "n_micro": 1,
            "opt": {"lr": 3e-3, "b1": 0.9, "b2": 0.95, "eps": 1e-8, "weight_decay": 0.1,
                    "grad_clip": 1.0, "warmup_steps": 0, "total_steps": 1000,
                    "min_lr_frac": 0.1},
            "checked_steps": 3, "trace_steps": 2}
