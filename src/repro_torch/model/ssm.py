"""Mamba-1 block (selective SSM): the falcon-mamba and jamba layers.

Ports ``src/repro/model/ssm.py`` (``init_mamba``, ``_ssm_inputs``,
``_selective_ssm``, ``mamba``, ``init_mamba_cache``, ``mamba_decode`` and
``mamba_chunk``) with the reference's dtype casts.  Decode keeps
(conv_state, ssm_state) as the cache: the conv state is the *pre-conv*
tail of the inner activations in the model dtype, the SSM state is f32.

The recurrence h_t = a_t ⊙ h_{t-1} + b_t has two routes, chosen as the
reference chooses them (``ssm.py:58-62``):

* with the kernel mode on and a sequence of at least ``min_scan_seq``
  rows, the fused scan + skip + gate kernel (``ops.scan_gate``), which
  takes the carried state as ``h0`` and applies the gate in f32;
* otherwise the plain torch scan, a sequential loop in f32
  (:func:`repro_torch.kernels.ref.ssm_scan`), whose y is cast to the
  model dtype before the gate.  The reference runs an associative scan
  here; the sequential loop does the same operations whether a prompt is
  processed whole or in chunks, so chunked prefill equals whole-prompt
  prefill bit for bit.  The selective_scan kernel is on no model path,
  as in the reference (``ssm.py:87-94``).
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from ..configs.registry import ArchConfig
from ..kernels.ref import contract_state, ssm_scan
from .kernel_mode import mode
from .layers import dense_init


def softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: log(1 + eˣ) as ``logaddexp(x, 0)``, with no
    switch to x above a threshold (``F.softplus`` has one at 20)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def init_mamba(gen: torch.Generator, cfg: ArchConfig,
               dtype: torch.dtype) -> Dict:
    d, di, st, dtr = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    dev = gen.device
    a = torch.arange(1, st + 1, dtype=torch.float32, device=dev)
    return {   # drawn in the reference's order
        "in_proj": dense_init(gen, d, 2 * di, dtype),
        "conv_w": (torch.randn((cfg.conv_width, di), generator=gen, device=dev,
                               dtype=torch.float32) * 0.2).to(dtype),
        "conv_b": torch.zeros((di,), dtype=torch.float32, device=dev),
        "x_proj": dense_init(gen, di, dtr + 2 * st, dtype),
        "dt_proj": dense_init(gen, dtr, di, dtype),
        "dt_bias": torch.zeros((di,), dtype=torch.float32, device=dev),
        "a_log": torch.log(a).expand(di, st).contiguous(),
        "d_skip": torch.ones((di,), dtype=torch.float32, device=dev),
        "out_proj": dense_init(gen, di, d, dtype),
    }


def _ssm_inputs(p, cfg: ArchConfig, xs):
    """Input-dependent recurrence coefficients from post-conv
    activations xs (b, s, di): (a_bar, b_bar (b, s, di, st) f32,
    Cm (b, s, st) f32)."""
    st, dtr = cfg.ssm_state, cfg.dt_rank_
    proj = (xs @ p["x_proj"]).float()                           # (b, s, dtr+2st)
    dt_r, Bm, Cm = proj.split([dtr, st, st], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])                                  # (di, st)
    a_bar = torch.exp(dt[..., None] * A)                        # (b, s, di, st)
    b_bar = (dt[..., None] * Bm[..., None, :]) * xs.float()[..., None]
    return a_bar, b_bar, Cm


def _fused_scan_gate(xs) -> bool:
    md = mode()
    return (md.enabled and md.fused_scan_gate
            and xs.shape[1] >= md.min_scan_seq)


def _selective_ssm(p, cfg: ArchConfig, xs, return_last: bool = False):
    """xs: (b, s, di) post-conv activations; returns ((b, s, di) in the
    model dtype, h_last f32 or None)."""
    a_bar, b_bar, Cm = _ssm_inputs(p, cfg, xs)
    h = ssm_scan(a_bar, b_bar)                                  # (b, s, di, st)
    y = contract_state(h, Cm) + xs.float() * p["d_skip"]
    return y.to(xs.dtype), (h[:, -1] if return_last else None)


def _conv(hist, w, c: int):
    """Causal depthwise conv over ``hist`` (b, cw-1+c, di) f32 with
    ``w`` (cw, di) f32: the reference's sum of shifted products."""
    return sum(hist[:, i:i + c, :] * w[i] for i in range(w.shape[0]))


def mamba(p, cfg: ArchConfig, x, return_state: bool = False):
    """Full-sequence Mamba block.  x: (b, s, d).  With ``return_state``
    also returns (conv_state (b, cw-1, di), h_last (b, di, st) f32)."""
    di = cfg.d_inner
    xs, z = (x @ p["in_proj"]).split([di, di], dim=-1)
    w = p["conv_w"].float()                                     # (cw, di)
    cw = w.shape[0]
    pre_conv = xs
    pad = F.pad(xs.float(), (0, 0, cw - 1, 0))
    xs = F.silu(_conv(pad, w, xs.shape[1]) + p["conv_b"]).to(x.dtype)
    if _fused_scan_gate(xs):
        from ..kernels import ops
        a_bar, b_bar, Cm = _ssm_inputs(p, cfg, xs)
        y, h_last = ops.scan_gate(a_bar, b_bar, Cm, xs, p["d_skip"], z)
    else:
        y, h_last = _selective_ssm(p, cfg, xs, return_last=return_state)
        y = y * F.silu(z)
    out = y @ p["out_proj"]
    if return_state:
        return out, (pre_conv[:, -(cw - 1):, :], h_last)
    return out


def init_mamba_cache(cfg: ArchConfig, batch: int, dtype: torch.dtype,
                     device) -> Dict[str, torch.Tensor]:
    """One layer's decode state (the reference stacks ``layer_count`` of
    these): conv (b, cw-1, di) in the model dtype, ssm (b, di, st) f32."""
    di = cfg.d_inner
    return {
        "conv": torch.zeros((batch, cfg.conv_width - 1, di), dtype=dtype,
                            device=device),
        "ssm": torch.zeros((batch, di, cfg.ssm_state), dtype=torch.float32,
                           device=device),
    }


def mamba_decode(p, cfg: ArchConfig, x, conv_state, ssm_state
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode.  x: (b, 1, d); conv_state: (b, cw-1, di);
    ssm_state: (b, di, st).  Returns (out, new conv_state, new ssm_state)."""
    di, st, dtr = cfg.d_inner, cfg.ssm_state, cfg.dt_rank_
    xs, z = (x @ p["in_proj"]).split([di, di], dim=-1)          # (b, 1, di)
    w = p["conv_w"].float()
    hist = torch.cat([conv_state.float(), xs.float()], dim=1)   # (b, cw, di)
    conv = (hist * w).sum(1) + p["conv_b"]
    xs1 = F.silu(conv).to(x.dtype)                              # (b, di)
    proj = (xs1 @ p["x_proj"]).float()
    dt_r, Bm, Cm = proj.split([dtr, st, st], dim=-1)
    dt = softplus(dt_r @ p["dt_proj"].float() + p["dt_bias"])
    A = -torch.exp(p["a_log"])
    a_bar = torch.exp(dt[..., None] * A)                        # (b, di, st)
    b_bar = (dt[..., None] * Bm[:, None, :]) * xs1.float()[..., None]
    h = ssm_state * a_bar + b_bar
    y = (h * Cm[:, None, :]).sum(-1) + xs1.float() * p["d_skip"]
    y = (y.to(x.dtype) * F.silu(z[:, 0]))[:, None, :]
    out = y @ p["out_proj"]
    return out, hist[:, 1:].to(conv_state.dtype), h


def mamba_chunk(p, cfg: ArchConfig, x, conv_state, ssm_state
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked-prefill Mamba with explicit state carry: x (b, c, d) is a
    contiguous chunk of the sequence; conv_state (b, cw-1, di) and
    ssm_state (b, di, st) carry the causal conv tail and hidden state
    from the previous chunk.  The kernel route hands ``ssm_state`` to the
    scan+gate kernel's ``h0``; the plain route starts its scan from it.
    Returns (out, new_conv_state, h_last)."""
    di = cfg.d_inner
    c = x.shape[1]
    xs, z = (x @ p["in_proj"]).split([di, di], dim=-1)          # (b, c, di)
    w = p["conv_w"].float()
    cw = w.shape[0]
    pre = torch.cat([conv_state, xs], dim=1)                    # (b, cw-1+c, di)
    new_conv = pre[:, -(cw - 1):, :] if cw > 1 else conv_state
    xs = F.silu(_conv(pre.float(), w, c) + p["conv_b"]).to(x.dtype)
    a_bar, b_bar, Cm = _ssm_inputs(p, cfg, xs)
    if _fused_scan_gate(xs):
        from ..kernels import ops
        y, h_last = ops.scan_gate(a_bar, b_bar, Cm, xs, p["d_skip"], z,
                                  h0=ssm_state)
    else:
        h = ssm_scan(a_bar, b_bar, ssm_state)
        y = contract_state(h, Cm) + xs.float() * p["d_skip"]
        y = y.to(xs.dtype) * F.silu(z)
        h_last = h[:, -1]
    out = y @ p["out_proj"]
    return out, new_conv, h_last
