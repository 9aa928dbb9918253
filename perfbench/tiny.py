"""Small configurations and mixes of the benchmark's kinds, for its CPU
tests: the same keys as the files in ``configs/`` (as run) and ``mixes/``.
Each kind's configuration is its module's ``tiny`` (``kinds/<kind>.py``)."""
from __future__ import annotations

import copy

from kinds import kind


def config(name: str, dtype: str = "bfloat16") -> dict:
    """The small configuration of kind ``name``; an unknown kind raises."""
    return kind(name).tiny(dtype)


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
