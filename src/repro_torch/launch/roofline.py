"""Roofline terms for the H100, from per-device counts of a step.

Ports ``src/repro/launch/roofline.py`` (``active_params``,
``model_flops``, ``roofline_terms``) with the NVIDIA H100 SXM's
data-sheet figures in place of the TPU's.  They are data-sheet figures,
not measurements:

  compute term    = FLOPs per device / PEAK_BF16
  memory term     = bytes accessed per device / HBM_BW
  collective term = weighted collective bytes per device / LINK_BW

``LINK_BW`` is the per-GPU InfiniBand NDR rate (400 Gb/s = 50 GB/s),
not NVLink's: every axis of the 16×16 and 2×16×16 production meshes
spans more than one 8-GPU NVLink node, so each axis's rings run at the
inter-node rate.  As in the reference, the compute term takes every
FLOP at the bf16 peak.

The reference parses collectives out of XLA's optimized HLO; the port
has no HLO, so :func:`collective_bytes_from_comm` reads a
``torch.distributed.tensor.debug.CommDebugMode`` record instead: its
count per collective, beside the result bytes per kind that the caller
summed at the same dispatch.  Each all-reduce counts 2× its bytes
(ring), all-gather, reduce-scatter and all-to-all 1×.

The card's bounds for single kernels and model paths (``bound_ms``,
``work_bound``) use the same constants.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Tuple

PEAK_BF16 = 989e12    # H100 SXM dense bf16 FLOP/s on the tensor cores (data sheet)
PEAK_F32 = 67e12      # H100 SXM f32 FLOP/s on the CUDA cores (data sheet)
HBM_BW = 3.35e12      # H100 SXM HBM3 bytes/s (data sheet)
LINK_BW = 50e9        # bytes/s per GPU: InfiniBand NDR, 400 Gb/s (data sheet)

_FACTORS = {
    "all-reduce": 2.0,
    "all-gather": 1.0,
    "reduce-scatter": 1.0,
    "all-to-all": 1.0,
    "collective-permute": 1.0,
}

# ``torch.ops._c10d_functional`` collectives (what DTensor issues) by kind
COLLECTIVE_KINDS = {
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}


def collective_kind(op) -> str:
    """The reference's kind of a functional collective (an op, its
    overload packet or its name), or '' for any other op."""
    name = str(op).split("::")[-1].split(".")
    return next((COLLECTIVE_KINDS[n] for n in name if n in COLLECTIVE_KINDS), "")


def collective_bytes_from_comm(comm, nbytes: Mapping[str, float]) -> Dict[str, Any]:
    """The reference's collective record (``count`` and ``bytes`` per kind,
    ``weighted_bytes``) from ``comm``, a ``CommDebugMode`` that ran around
    the step, and ``nbytes``, the result bytes per kind summed over the
    same collectives."""
    out: Dict[str, Any] = {k: {"count": 0, "bytes": 0} for k in _FACTORS}
    for op, n in comm.get_comm_counts().items():
        kind = collective_kind(op)
        if kind:
            out[kind]["count"] += n
    for kind, b in nbytes.items():
        out[kind]["bytes"] += b
    out["weighted_bytes"] = sum(
        v["bytes"] * _FACTORS[k] for k, v in out.items() if k in _FACTORS)
    return out


def model_flops(cfg, shape) -> float:
    """6·N_active·D (training) / 2·N_active·D (inference) useful FLOPs."""
    n_active = active_params(cfg)
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_active * tokens


def active_params(cfg) -> float:
    """Parameters touched per token (MoE counts top_k experts)."""
    d, hd = cfg.d_model, cfg.hd
    per_layer_attn = d * cfg.n_heads * hd + 2 * d * cfg.n_kv_heads * hd \
        + cfg.n_heads * hd * d
    per_layer_mlp = 3 * d * cfg.d_ff if cfg.d_ff else 0
    per_layer_moe = 3 * d * cfg.d_ff * cfg.top_k if cfg.n_experts else 0
    if cfg.shared_expert:
        per_layer_moe += per_layer_mlp
    di = cfg.d_inner
    per_layer_mamba = 2 * d * di + di * (cfg.dt_rank_ + 2 * cfg.ssm_state) \
        + cfg.dt_rank_ * di + di * d
    total = 0.0
    from ..model.transformer import layer_specs
    for spec in layer_specs(cfg, "decoder"):
        if spec.mixer == "attn":
            total += per_layer_attn
        elif spec.mixer == "mamba":
            total += per_layer_mamba
        if spec.cross:
            total += per_layer_attn
        if spec.ffn == "moe":
            total += per_layer_moe
        elif spec.ffn == "mlp":
            total += per_layer_mlp
    for _ in range(cfg.enc_layers):
        total += per_layer_attn + 3 * cfg.d_model * cfg.d_ff
    total += 2 * cfg.vocab * cfg.d_model   # embed + head
    return total


def roofline_terms(cfg, shape, cost: Dict, coll: Dict, n_dev: int) -> Dict[str, Any]:
    """``cost``: per-device ``flops`` and ``bytes accessed``; ``coll``: a
    :func:`collective_bytes_from_comm` record."""
    flops = float(cost.get("flops", 0.0))
    bytes_acc = float(cost.get("bytes accessed", 0.0))
    compute_s = flops / PEAK_BF16
    memory_s = bytes_acc / HBM_BW
    collective_s = float(coll.get("weighted_bytes", 0)) / LINK_BW
    terms = {"compute_s": compute_s, "memory_s": memory_s,
             "collective_s": collective_s}
    bottleneck = max(terms, key=terms.get).replace("_s", "")
    mf = model_flops(cfg, shape)
    total = flops * n_dev
    return {
        **terms,
        "bottleneck": bottleneck,
        "model_flops": mf,
        "hlo_flops_per_dev": flops,
        "model_flops_frac": (mf / total) if total else 0.0,
        "step_time_lower_bound_s": max(terms.values()),
        "mfu_upper_bound": (mf / (n_dev * PEAK_BF16)) / max(max(terms.values()), 1e-12),
    }


def bound_ms(nbytes: float, flops: float, peak: float = PEAK_BF16) -> Tuple[float, str]:
    """The least time in ms for one kernel's work on the card, and what
    bounds it: the larger of ``nbytes`` over the memory rate and
    ``flops`` over ``peak``."""
    t_bytes, t_ops = nbytes / HBM_BW, flops / peak
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def work_bound(work) -> float:
    """The least time in ms for (bf16 FLOPs, f32 FLOPs, bytes): the
    larger of the bytes over the memory rate and the operations, each
    type over its own peak (the two types run one after the other)."""
    bf16, f32, nbytes = work
    return max(nbytes / HBM_BW, bf16 / PEAK_BF16 + f32 / PEAK_F32) * 1e3
