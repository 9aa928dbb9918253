"""Plain PyTorch versions of the kernels (allclose targets).

Ports ``src/repro/kernels/ref.py``: matmul, flash attention, the
selective scan and the fused scan + skip + gate; and the plain versions of
the decode attention kernel and of the training attention kernel, which
have no TPU counterpart: both are :func:`sdpa_dense`, the port's plain
masked attention (``model/attention.py`` runs it as ``_sdpa_dense``).
``kernels/ops.py`` runs these whenever its tensors lie on the CPU;
``chip_smoke.py`` holds each CUDA kernel against them on the card.

The reference's scan oracles use an associative scan; here the
recurrence is a sequential loop over time in f32, as the kernels run it.
A sequential loop does the same f32 operations for a sequence whether it
is processed whole or in chunks carried through ``h0``, so chunking
changes no bit.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

NEG_INF = -1e30        # the flash kernel's mask value (flash_attention.py:28)
SDPA_NEG_INF = -2.3819763e38   # sdpa_dense's mask value (the reference's)


def matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """C = A·B with f32 accumulation, cast to A's dtype."""
    return (a.float() @ b.float()).to(a.dtype)


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  causal: bool = True,
                  q_offset: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """q: (bh, sq, d); k, v: (bh, sk, d).  The q rows sit at sequence
    positions ``q_offset + row`` (chunked prefill over a kv prefix of
    ``sk`` rows; ``q_offset`` an int or a 0-d tensor on q's device);
    causal masking compares those positions with the kv columns.  f32
    softmax, output ``acc / max(l, 1e-30)`` as the flash kernel computes
    it."""
    d = q.shape[-1]
    s = torch.einsum("bqd,bkd->bqk", q.float(), k.float()) / (d ** 0.5)
    if causal:
        sq, sk = s.shape[-2:]
        rows = q_offset + torch.arange(sq, device=q.device)[:, None]
        cols = torch.arange(sk, device=q.device)[None, :]
        s = torch.where(rows >= cols, s, torch.full_like(s, NEG_INF))
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = p.sum(dim=-1, keepdim=True)
    out = torch.einsum("bqk,bkd->bqd", p, v.float()) / torch.clamp(l, min=1e-30)
    return out.to(q.dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True, q_offset: Union[int, torch.Tensor] = 0,
                        kv_row: Union[int, torch.Tensor] = 0) -> torch.Tensor:
    """Public layout of ``ops.flash_attention``: q (b, sq, h, d), k/v
    (kb, sk, hkv, d) with q's batch row i at k/v row ``kv_row + i``.
    The b rows are gathered, GQA repeats each kv head ``h // hkv`` times,
    as ``src/repro/kernels/ops.py:36-39`` does, then :func:`attention_ref`
    runs on the (b·h, s, d) layout."""
    b, sq, h, d = q.shape
    if isinstance(kv_row, torch.Tensor) or kv_row or k.shape[0] != b:
        rows = kv_row + torch.arange(b, device=k.device)
        k, v = k.index_select(0, rows), v.index_select(0, rows)
    rep = h // k.shape[2]
    if rep > 1:
        k = torch.repeat_interleave(k, rep, dim=2)
        v = torch.repeat_interleave(v, rep, dim=2)
    qf = q.transpose(1, 2).reshape(b * h, sq, d)
    kf = k.transpose(1, 2).reshape(b * h, -1, d)
    vf = v.transpose(1, 2).reshape(b * h, -1, d)
    out = attention_ref(qf, kf, vf, causal=causal, q_offset=q_offset)
    return out.reshape(b, h, sq, d).transpose(1, 2)


def sdpa_dense(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               mask: Optional[torch.Tensor], n_rep: int) -> torch.Tensor:
    """Masked GQA attention as the reference's ``_sdpa`` computes it: q
    (b, sq, h, d), k/v (b, skv, hkv, d), mask (b, sq, skv) or None; q
    scaled by 1/sqrt(d) in f32, f32 scores, masked to ``SDPA_NEG_INF``,
    softmax and P·V over f32 copies of k and v.  Returns (b, sq, h, d) in
    v's dtype."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float() / math.sqrt(d)
    q_g = qf.reshape(b, sq, hkv, n_rep, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", q_g, k.float())
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits,
                             torch.full_like(logits, SDPA_NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, d).to(v.dtype)


def train_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal self-attention of the training step, the plain version of
    kernel F: q (b, s, h, d), k/v (b, s, hkv, d), row i sees rows j <= i;
    :func:`sdpa_dense` with the causal mask, differentiable by autograd."""
    b, s = q.shape[:2]
    i = torch.arange(s, device=q.device)
    mask = (i[None, :] <= i[:, None])[None].expand(b, s, s)
    return sdpa_dense(q, k, v, mask, q.shape[2] // k.shape[2])


def paged_decode_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q: (b, 1, h, d); k, v: (b, kv_len, hkv, d); lengths: (b,).  Row j
    of slot i counts when j <= ``lengths[i]`` and, with a window, j >
    ``lengths[i] - window``: the ragged decode's mask through
    :func:`sdpa_dense`, as ``model/attention.py`` computes it.  Returns
    (b, 1, h, d) in v's dtype."""
    b, sq, h, _ = q.shape
    kv_len = k.shape[1]
    j = torch.arange(kv_len, device=q.device)[None, None, :]
    mask = j <= lengths[:, None, None]
    if window:
        mask &= j > (lengths[:, None, None] - window)
    return sdpa_dense(q, k, v, mask.expand(b, sq, kv_len), h // k.shape[2])


def ssm_scan(a: torch.Tensor, b: torch.Tensor,
             h0: Optional[torch.Tensor] = None) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1 in f32, from ``h0`` (zeros
    when None).  a, b: (batch, seq, d, n); h0: (batch, d, n).  Returns
    every h_t: (batch, seq, d, n) f32."""
    a32, b32 = a.float(), b.float()
    h = (torch.zeros_like(a32[:, 0]) if h0 is None else h0.float())
    hs = torch.empty_like(a32)
    for t in range(a32.shape[1]):
        h = a32[:, t] * h + b32[:, t]
        hs[:, t] = h
    return hs


def contract_state(h: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """y[b, s, d] = Σ_n h[b, s, d, n] · c[b, s, n] in f32."""
    return (h * c.float()[:, :, None, :]).sum(-1)


def selective_scan_ref(a_bar: torch.Tensor, b_bar: torch.Tensor,
                       c: torch.Tensor) -> torch.Tensor:
    """The Mamba recurrence from a zero state; y in ``a_bar``'s dtype
    (``src/repro/kernels/mamba_scan.py:73``)."""
    return contract_state(ssm_scan(a_bar, b_bar), c).to(a_bar.dtype)


def scan_gate_ref(a_bar: torch.Tensor, b_bar: torch.Tensor, c: torch.Tensor,
                  x_skip: torch.Tensor, d_skip: torch.Tensor, z: torch.Tensor,
                  h0: Optional[torch.Tensor] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fused scan + skip + gate: h_t = a⊙h+b from ``h0``, then
    o_t = (h_t·c_t + x_t⊙d_skip) ⊙ silu(z_t), all in f32.  Returns
    (o in ``x_skip``'s dtype, h_last f32)."""
    h = ssm_scan(a_bar, b_bar, h0)
    y = contract_state(h, c) + x_skip.float() * d_skip.float()
    z32 = z.float()
    o = y * (z32 * torch.sigmoid(z32))
    return o.to(x_skip.dtype), h[:, -1]
