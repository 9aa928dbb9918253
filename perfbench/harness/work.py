"""Operations and bytes, counted from the configuration's widths and the
shapes served: the model's FLOPs per token (2 per weight of every product,
the head among them, plus attention's score and value products over the
causal prefix) and the least time of a kernel A or C launch on the card.
The peaks are the data sheet's (``peaks.json``)."""
from __future__ import annotations

import json
from functools import lru_cache
from pathlib import Path
from typing import Any, Dict

from kinds import kind


@lru_cache(maxsize=1)
def peaks() -> Dict[str, float]:
    return json.loads((Path(__file__).with_name("peaks.json")).read_text())


def matmul_params(cfg: Dict[str, Any]) -> int:
    """Weights that a token multiplies through: the products of the layers,
    as the configuration's kind counts them, and the output head (the
    embedding is a lookup).  A kind whose layers differ by index counts
    each layer's own products, and one that routes a token to some of its
    experts counts those experts alone, not every expert held."""
    return kind(cfg["reference"]).matmul_params(cfg) + cfg["vocab_size"] * cfg["hidden_size"]


def attn_flops(cfg: Dict[str, Any], start: int, n: int) -> float:
    """Score and value products of ``n`` query rows at positions start..
    start+n-1, each over its causal prefix, over every attention layer."""
    layers, heads, hd = kind(cfg["reference"]).attention(cfg)
    keys = n * start + n * (n + 1) / 2
    return 4.0 * heads * hd * keys * layers


def forward_flops(cfg: Dict[str, Any], start: int, n: int) -> float:
    """Model FLOPs of a forward over ``n`` tokens at positions start..
    start+n-1 of one sequence."""
    return 2.0 * matmul_params(cfg) * n + attn_flops(cfg, start, n)


def train_flops(cfg: Dict[str, Any], batch: int, seq: int) -> float:
    """Model FLOPs of a training step: forward and backward, three times a
    forward (recomputation is not counted)."""
    return 3.0 * batch * forward_flops(cfg, 0, seq)


def bound_s(nbytes: float, flops: float, peak: str = "bf16_flops") -> float:
    """The least time on the card: bytes over HBM's rate or the operations
    over ``peak`` (bf16 on the tensor cores, or f32), whichever is longer."""
    pk = peaks()
    return max(nbytes / pk["hbm_bytes_per_s"], flops / pk[peak])


def matmul_bound_s(m: int, k: int, n: int) -> float:
    """Kernel A on (m, k)·(k, n) in bf16: each operand read once, the
    product written once."""
    return bound_s(2.0 * (m * k + k * n + m * n), 2.0 * m * k * n)


def scan_gate_bound_s(rows: int, di: int, st: int, x_bytes: int = 2) -> float:
    """Kernel C on one chunk of ``rows``: a_bar and b_bar (rows, di, st) and
    C (rows, st) in f32, x and z (rows, di) and the output in the model
    dtype, D (di) f32, and h0 read and h_last written (di, st) f32; the
    recurrence's and the contraction's multiply-adds per state and the
    skip, SiLU and gate per channel, at the f32 peak."""
    nbytes = (2 * rows * di * st + rows * st) * 4 + 3 * rows * di * x_bytes \
        + di * 4 + 2 * di * st * 4
    flops = rows * di * st * 4.0 + rows * di * 6.0
    return bound_s(nbytes, flops, "f32_flops")
