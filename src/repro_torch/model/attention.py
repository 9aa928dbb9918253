"""GQA attention with KV-cache decode, chunked prefill and paged decode.

Ports ``src/repro/model/attention.py``: ``_qkv``, ``_sdpa``,
``causal_mask``, ``attention``, ``attention_noncausal`` (the encoder's),
``cross_attention`` (the decoder's over encoder memory),
``decode_attention``, ``chunk_attention`` and ``paged_decode_attention``.
Sliding-window layers keep their mask.  The encoder and cross attention
are plain ``_sdpa`` with no mask, as in the reference: no kernel runs
them.  ``_sdpa_chunked`` (the reference's ``ATTN_CHUNK``, which only its
dry run sets) waits for a caller, and M-RoPE for qwen2-vl.

The reference's functions are pure; here the cache updates are made in
place (the returned cache tensors are the ones passed in), which saves a
copy of every layer's cache per step.  Sharding annotations are no-ops on
one device and are dropped.
"""
from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from ..configs.registry import ArchConfig
from .kernel_mode import mode
from .layers import apply_rope, dense_init, rmsnorm, rmsnorm_init

NEG_INF = -2.3819763e38


def _flash(q, k, v, q_offset=0, kv_row=0):
    from ..kernels import ops
    return ops.flash_attention(q, k, v, causal=True, q_offset=q_offset, kv_row=kv_row)


def init_attention(gen: torch.Generator, cfg: ArchConfig,
                   dtype: torch.dtype) -> Dict:
    hd = cfg.hd
    p = {
        "wq": dense_init(gen, cfg.d_model, cfg.n_heads * hd, dtype),
        "wk": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wv": dense_init(gen, cfg.d_model, cfg.n_kv_heads * hd, dtype),
        "wo": dense_init(gen, cfg.n_heads * hd, cfg.d_model, dtype),
    }
    if cfg.qk_norm:
        p["q_norm"] = rmsnorm_init(hd, gen.device)
        p["k_norm"] = rmsnorm_init(hd, gen.device)
    return p


def _split_heads(x, n, hd):
    return x.reshape(x.shape[:-1] + (n, hd))


def _qkv(p, cfg: ArchConfig, x, positions):
    if cfg.mrope:
        raise NotImplementedError("M-RoPE is not ported yet")
    hd = cfg.hd
    q = _split_heads(x @ p["wq"], cfg.n_heads, hd)
    k = _split_heads(x @ p["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(x @ p["wv"], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
        k = rmsnorm(k, p["k_norm"], cfg.norm_eps)
    return apply_rope(q, positions), apply_rope(k, positions), v


def _sdpa(q, k, v, mask, n_rep: int):
    """q: (b, sq, h, d); k/v: (b, skv, hkv, d); mask: (b, sq, skv) or None."""
    b, sq, h, d = q.shape
    hkv = k.shape[2]
    qf = q.float() / math.sqrt(d)
    q_g = qf.reshape(b, sq, hkv, n_rep, d)
    logits = torch.einsum("bqgrd,bkgd->bgrqk", q_g, k.float())
    if mask is not None:
        logits = torch.where(mask[:, None, None, :, :], logits,
                             torch.full_like(logits, NEG_INF))
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bgrqk,bkgd->bqgrd", probs, v.float())
    return out.reshape(b, sq, h, d).to(v.dtype)


def causal_mask(sq: int, window: int = 0, device=None) -> torch.Tensor:
    i = torch.arange(sq, device=device)[:, None]
    j = torch.arange(sq, device=device)[None, :]
    m = j <= i
    if window:
        m &= (i - j) < window
    return m[None]   # (1, sq, sq)


def attention(p, cfg: ArchConfig, x, positions, *, window: int = 0,
              return_kv: bool = False):
    """Training/prefill self-attention (causal, optional sliding window)."""
    q, k, v = _qkv(p, cfg, x, positions)
    sq = x.shape[1]
    md = mode()
    if md.enabled and window == 0 and sq >= md.min_attn_q:
        out = _flash(q, k, v)
    else:
        mask = causal_mask(sq, window, x.device).expand(x.shape[0], sq, sq)
        out = _sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(x.shape[0], sq, -1) @ p["wo"]
    if return_kv:
        return out, (k, v)
    return out


def attention_noncausal(p, cfg: ArchConfig, x, positions) -> torch.Tensor:
    """Encoder self-attention (bidirectional)."""
    q, k, v = _qkv(p, cfg, x, positions)
    out = _sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv_heads)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


def cross_attention(p, cfg: ArchConfig, x, memory, positions) -> torch.Tensor:
    """Decoder cross-attention over encoder memory (no rope on memory)."""
    hd = cfg.hd
    q = _split_heads(x @ p["wq"], cfg.n_heads, hd)
    if cfg.qk_norm:
        q = rmsnorm(q, p["q_norm"], cfg.norm_eps)
    q = apply_rope(q, positions)
    k = _split_heads(memory @ p["wk"], cfg.n_kv_heads, hd)
    v = _split_heads(memory @ p["wv"], cfg.n_kv_heads, hd)
    out = _sdpa(q, k, v, None, cfg.n_heads // cfg.n_kv_heads)
    return out.reshape(x.shape[0], x.shape[1], -1) @ p["wo"]


# ---------------------------------------------------------------------------
# decode with KV cache
# ---------------------------------------------------------------------------

def decode_attention(p, cfg: ArchConfig, x, k_cache, v_cache, cache_len: int,
                     *, window: int = 0
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token decode: x (b, 1, d); k/v_cache (b, S, hkv, hd) hold
    ``cache_len`` valid entries; the new entry is written at
    ``cache_len``.  Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), cache_len, dtype=torch.long,
                           device=x.device)
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    k_cache[:, cache_len] = k_new[:, 0].to(k_cache.dtype)
    v_cache[:, cache_len] = v_new[:, 0].to(v_cache.dtype)
    S = k_cache.shape[1]
    j = torch.arange(S, device=x.device)[None, None, :]
    mask = j <= cache_len
    if window:
        mask &= j > (cache_len - window)
    out = _sdpa(q, k_cache, v_cache, mask.expand(b, 1, S),
                cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(b, 1, -1) @ p["wo"]
    return out, k_cache, v_cache


# ---------------------------------------------------------------------------
# serving fast path: chunked prefill + ragged paged decode
# ---------------------------------------------------------------------------

def chunk_attention(p, cfg: ArchConfig, x, k_cache, v_cache, offset, kv_len: int,
                    *, window: int = 0, slot: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Chunked-prefill self-attention: x (b, c, d) holds rows
    ``[offset, offset+c)`` of the sequence (``offset`` an int or a 0-d
    integer tensor on x's device); the chunk's k/v are written into the
    cache at ``offset`` (``index_put_``, the reference's
    ``dynamic_update_slice``; ``offset + c`` must fit the cache) and
    attention runs causally over ``cache[:, :kv_len]``, the page-aligned
    prefix covering ``offset + c``.  With ``slot`` (a 0-d integer tensor),
    x is one sequence (b = 1) in batch row ``slot`` of the caches, which
    are read and written there in place.  The kernel route hands
    ``offset`` and ``slot`` to the flash kernel as device data and reads
    the cache prefix in place; the plain route builds its causal and
    window mask from the same device positions.  Neither reads a device
    value on the host, so one CUDA graph serves every offset and slot.
    Returns (out, k_cache, v_cache)."""
    b, c, _ = x.shape
    pos = offset + torch.arange(c, device=x.device)                # (c,)
    q, k_new, v_new = _qkv(p, cfg, x, pos[None, :].expand(b, c))
    rows = torch.arange(b, device=x.device)
    if slot is not None:
        rows = rows + slot
    at = (rows[:, None], pos[None, :])
    k_cache.index_put_(at, k_new.to(k_cache.dtype))
    v_cache.index_put_(at, v_new.to(v_cache.dtype))
    kp = k_cache[:, :kv_len]
    vp = v_cache[:, :kv_len]
    md = mode()
    if md.enabled and window == 0 and c >= md.min_attn_q:
        out = _flash(q, kp, vp, q_offset=offset, kv_row=0 if slot is None else slot)
    else:
        if slot is not None:
            kp, vp = kp.index_select(0, rows), vp.index_select(0, rows)
        cols = torch.arange(kv_len, device=x.device)[None, :]
        m = pos[:, None] >= cols
        if window:
            m &= (pos[:, None] - cols) < window
        out = _sdpa(q, kp, vp, m[None].expand(b, c, kv_len),
                    cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(b, c, -1) @ p["wo"]
    return out, k_cache, v_cache


def paged_decode_attention(p, cfg: ArchConfig, x, k_cache, v_cache, lengths,
                           kv_len: int, *, window: int = 0
                           ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Ragged one-token decode over a page-aligned KV prefix.

    x: (b, 1, d); lengths: (b,) per-slot valid lengths on the device —
    each slot's token is written at its own ``lengths[i]`` (clamped to
    the cache as the reference's ``dynamic_update_slice`` clamps);
    ``kv_len``: attention reads only ``cache[:, :kv_len]``.  Masked
    entries contribute exact zeros, so the page bound changes no bit.
    Returns (out, k_cache, v_cache)."""
    b = x.shape[0]
    positions = lengths[:, None].long()
    q, k_new, v_new = _qkv(p, cfg, x, positions)
    rows = torch.arange(b, device=x.device)
    at = lengths.long().clamp(0, k_cache.shape[1] - 1)
    k_cache[rows, at] = k_new[:, 0].to(k_cache.dtype)
    v_cache[rows, at] = v_new[:, 0].to(v_cache.dtype)
    kp = k_cache[:, :kv_len]
    vp = v_cache[:, :kv_len]
    j = torch.arange(kv_len, device=x.device)[None, None, :]
    mask = j <= lengths[:, None, None]
    if window:
        mask &= j > (lengths[:, None, None] - window)
    out = _sdpa(q, kp, vp, mask.expand(b, 1, kv_len),
                cfg.n_heads // cfg.n_kv_heads)
    out = out.reshape(b, 1, -1) @ p["wo"]
    return out, k_cache, v_cache
