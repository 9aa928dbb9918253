"""Model assembly: init, the training forward and loss, KV cache,
chunked prefill and ragged decode steps.

Ports ``src/repro/model/transformer.py`` (``layer_specs``,
``pattern_period``, ``init_params``, ``REMAT``, ``_apply_layer``,
``_run_stack``, ``_frontend_embeds``, ``_mrope_positions``, ``forward``, ``lm_loss``,
``init_cache``, the cache-slot helpers, ``_stack_walk``, ``chunk_step``,
``serve_decode_step``, ``prefill`` and ``decode_step``).  Differences
from the reference:

* Parameters and caches are per layer: ``params["layers"][l]`` (the
  decoder), ``params["enc_layers"][l]`` (an encoder-decoder's encoder)
  and ``cache[l]``.  The reference stacks the layers of each pattern slot
  for ``lax.scan``; here a Python loop walks the layers, and
  :mod:`repro_torch.bridge` maps stacked slot ``s``, repeat ``r`` to
  layer ``r·period + s``.  :func:`_run_stack` still puts each period's
  layers under one activation checkpoint, as the reference remats its
  scanned period body (the encoder's period is one layer).
* Cache updates are in place (the KV rows, and in
  :func:`serve_decode_step` the Mamba states too); the step functions
  return the cache they were given, so callers read as in the reference.
* Sharding annotations and ``gather_params_for_compute`` are no-ops on
  one device and are dropped.

The decoder's mixers are attention and Mamba (``model/ssm.py``), each
with a SwiGLU MLP, a mixture of experts or no FFN: dense decoders, the
MoE decoders (qwen3-moe, llama4 with its shared expert), falcon-mamba
and the jamba attention/Mamba interleave with its experts.
:func:`forward` sums MoE's f32 aux loss over the layers, as the
reference's does; the serving steps drop it, as the reference's do.

The encoder-decoder (seamless-m4t) runs its stub frames through
``frontend_proj``, a bidirectional encoder stack and ``enc_final_ln``
into memory, which each decoder layer's cross attention reads in
:func:`forward`, :func:`prefill` and :func:`decode_step` (recomputing
memory's k/v at every decode step, as the reference does).  As in the
reference, :func:`chunk_step` and :func:`serve_decode_step` have no
cross branch: the continuous engine serves the decoder alone.

The vlm (qwen2-vl) prepends its vision stub, through ``frontend_proj``,
to the text in :func:`forward` and :func:`prefill`, and rotates q and k
with M-RoPE at :func:`_mrope_positions` there and at
``_mrope_positions(cfg, b, 1) + cache_len`` in :func:`decode_step`.  As
in the reference, :func:`chunk_step` and :func:`serve_decode_step` pass
no M-RoPE positions: the continuous engine serves it with plain rope.
Every arch of the registry runs.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from functools import partial
from typing import Any, Dict, List, Optional, Tuple, Union

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.registry import ArchConfig
from . import attention as ATT
from . import mlp as MLP
from . import ssm as SSM
from .layers import (dense_init, device_of, dtype_of, embed, embed_init,
                     make_generator, rmsnorm, rmsnorm_init, unembed)

Cache = List[Dict[str, torch.Tensor]]

# Activation checkpointing policy for the layer stack ('none' | 'full' |
# 'dots'), as in the reference.  'full' recomputes each period's layers
# in backward and saves only the input of each period; 'dots' also saves
# the outputs of the weight products (2-D matmuls), trading memory for
# less recompute.
REMAT = "full"


def _save_weight_products(ctx, op, *args, **kwargs):
    """'dots': save what ``aten.mm`` returns, recompute the rest.  The
    batched attention and expert einsums run as ``bmm`` and are
    recomputed, as the reference's ``dots_with_no_batch_dims_saveable``
    recomputes products with batch dimensions."""
    if op == torch.ops.aten.mm.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _maybe_remat(fn):
    if REMAT == "none":
        return fn
    kw = {}
    if REMAT == "dots":
        kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                   _save_weight_products)
    return lambda *args: checkpoint(fn, *args, use_reentrant=False, **kw)


@dataclass(frozen=True)
class LayerSpec:
    mixer: str          # 'attn' | 'mamba' | 'enc_attn'
    window: int         # sliding window (0 = full)
    ffn: str            # 'mlp' | 'moe' | 'none'
    cross: bool = False


def layer_specs(cfg: ArchConfig, role: str = "decoder") -> List[LayerSpec]:
    n = cfg.enc_layers if role == "encoder" else cfg.n_layers
    specs = []
    for i in range(n):
        if role == "encoder":
            specs.append(LayerSpec("enc_attn", 0, "mlp"))
            continue
        if cfg.family == "ssm":
            specs.append(LayerSpec("mamba", 0, "none"))
            continue
        mixer = "attn" if cfg.is_attn_layer(i) else "mamba"
        window = 0
        if cfg.sliding_window and not cfg.is_global_attn_layer(i):
            window = cfg.sliding_window
        ffn = "moe" if cfg.is_moe_layer(i) else "mlp"
        specs.append(LayerSpec(mixer, window, ffn, cross=cfg.cross_attention))
    return specs


def pattern_period(cfg: ArchConfig, role: str = "decoder") -> int:
    if role == "encoder" or cfg.family == "ssm":
        return 1
    p = 1
    if cfg.attn_every:
        p = cfg.attn_every
    if cfg.n_experts:
        p = _lcm(p, cfg.moe_every)
    if cfg.local_global_ratio:
        p = _lcm(p, cfg.local_global_ratio + 1)
    return p


def _lcm(a, b):
    return a * b // math.gcd(a, b)


# ---------------------------------------------------------------------------
# init
# ---------------------------------------------------------------------------

def _init_layer(gen: torch.Generator, cfg: ArchConfig, spec: LayerSpec,
                dtype: torch.dtype) -> Dict:
    p: Dict[str, Any] = {"ln1": rmsnorm_init(cfg.d_model, gen.device)}
    if spec.mixer in ("attn", "enc_attn"):
        p["mixer"] = ATT.init_attention(gen, cfg, dtype)
    else:
        p["mixer"] = SSM.init_mamba(gen, cfg, dtype)
    if spec.cross:
        p["ln_x"] = rmsnorm_init(cfg.d_model, gen.device)
        p["cross"] = ATT.init_attention(gen, cfg, dtype)
    if spec.ffn == "mlp":
        p["ln2"] = rmsnorm_init(cfg.d_model, gen.device)
        p["ffn"] = MLP.init_mlp(gen, cfg.d_model, cfg.d_ff, dtype)
    elif spec.ffn == "moe":
        p["ln2"] = rmsnorm_init(cfg.d_model, gen.device)
        p["ffn"] = MLP.init_moe(gen, cfg, dtype)
    return p


def init_params(cfg: ArchConfig, *, seed: int = 0, device="cuda",
                generator: Optional[torch.Generator] = None) -> Dict:
    """Random weights drawn on ``device`` from ``generator`` (or a new
    one seeded with ``seed``).  Matmul weights are ``(in, out)``.  An
    encoder-decoder also has ``enc_layers``, ``enc_final_ln`` and
    ``frontend_proj``; a vlm ``frontend_proj``."""
    specs = layer_specs(cfg)
    dev = device_of(device)
    gen = generator if generator is not None else make_generator(seed, dev)
    dtype = dtype_of(cfg.dtype)
    p: Dict[str, Any] = {
        "embed": embed_init(gen, cfg.vocab, cfg.d_model, dtype),
        "final_ln": rmsnorm_init(cfg.d_model, dev),
        "layers": [_init_layer(gen, cfg, spec, dtype) for spec in specs],
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = embed_init(gen, cfg.vocab, cfg.d_model, dtype)
    if cfg.enc_layers:
        p["enc_layers"] = [_init_layer(gen, cfg, spec, dtype)
                           for spec in layer_specs(cfg, "encoder")]
        p["enc_final_ln"] = rmsnorm_init(cfg.d_model, dev)
    if cfg.frontend_stub:
        # learned projection applied to the stub frontend embeddings
        p["frontend_proj"] = dense_init(gen, cfg.d_model, cfg.d_model, dtype)
    return p


def _head(params) -> torch.Tensor:
    return params.get("lm_head", params["embed"])


def _ffn(p, spec: LayerSpec, cfg: ArchConfig, x):
    """The layer's FFN on the residual stream: (x, MoE's f32 aux loss,
    or None for a layer without experts).  The serving steps drop aux."""
    if spec.ffn == "mlp":
        return x + MLP.mlp(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps)), None
    if spec.ffn == "moe":
        h, aux = MLP.moe(p["ffn"], cfg, rmsnorm(x, p["ln2"], cfg.norm_eps))
        return x + h, aux
    return x, None


def _cross(p, spec: LayerSpec, cfg: ArchConfig, x, memory, positions):
    """The cross-attention branch on the residual stream of a decoder
    layer with ``spec.cross``, given encoder ``memory``; x as it is
    otherwise."""
    if not spec.cross or memory is None:
        return x
    return x + ATT.cross_attention(p["cross"], cfg, rmsnorm(x, p["ln_x"], cfg.norm_eps),
                                   memory, positions)


# ---------------------------------------------------------------------------
# forward (train / prefill)
# ---------------------------------------------------------------------------

def _apply_layer(p, spec: LayerSpec, cfg: ArchConfig, x, positions,
                 memory=None, mrope_positions=None, collect: bool = False):
    """One layer over the whole sequence: (x, aux, kv).  aux is MoE's f32
    aux loss or None; kv the layer's decode cache with ``collect``, else
    None (an encoder layer has none)."""
    kv = None
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        r = ATT.attention(p["mixer"], cfg, h, positions, window=spec.window,
                          mrope_positions=mrope_positions, return_kv=collect)
        if collect:
            h, (k, v) = r
            kv = {"k": k, "v": v}
        else:
            h = r
    elif spec.mixer == "enc_attn":
        h = ATT.attention_noncausal(p["mixer"], cfg, h, positions)
    else:
        r = SSM.mamba(p["mixer"], cfg, h, return_state=collect)
        if collect:
            h, (conv, ssm_st) = r
            kv = {"conv": conv, "ssm": ssm_st}
        else:
            h = r
    x = _cross(p, spec, cfg, x + h, memory, positions)
    x, aux = _ffn(p, spec, cfg, x)
    return x, aux, kv


def _run_stack(layers, cfg: ArchConfig, role: str, x, positions, memory=None,
               mrope_positions=None):
    """``role``'s stack (``params["layers"]`` for the decoder,
    ``params["enc_layers"]`` for the encoder) over the whole sequence:
    (x, aux summed over the layers in f32).  Each pattern period's layers
    run as one body under :func:`_maybe_remat`; the tail past the last
    full period runs without, as in the reference."""
    specs = layer_specs(cfg, role)
    period = pattern_period(cfg, role)
    repeats = len(specs) // period

    def run(x, aux, lo: int, hi: int):
        for i in range(lo, hi):
            x, a, _ = _apply_layer(layers[i], specs[i], cfg, x, positions, memory,
                                   mrope_positions)
            if a is not None:
                aux = aux + a
        return x, aux

    body = _maybe_remat(run)
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for r in range(repeats):
        x, aux = body(x, aux, r * period, (r + 1) * period)
    return run(x, aux, repeats * period, len(specs))


def _frontend_embeds(params, cfg: ArchConfig, stub: torch.Tensor) -> torch.Tensor:
    """``stub @ frontend_proj`` in the wider of the two dtypes, as JAX
    promotes (the trainer's stub is bf16 whatever the model's dtype)."""
    w = params["frontend_proj"]
    dt = torch.promote_types(stub.dtype, w.dtype)
    return stub.to(dt) @ w.to(dt)


def encode(params, cfg: ArchConfig, enc_frontend: Optional[torch.Tensor]):
    """The encoder's memory as :func:`forward` and :func:`prefill`
    compute it, and as :func:`decode_step` reads it: ``enc_frontend``
    (b, frames, d_model) through ``frontend_proj``, the encoder stack at
    positions 0..frames-1 and ``enc_final_ln``.  None for a model
    without an encoder."""
    if not cfg.enc_layers:
        return None
    if enc_frontend is None:
        raise ValueError(f"{cfg.name} is an encoder-decoder: pass enc_frontend, the "
                         "(b, frames, d_model) stub its encoder reads")
    enc_in = _frontend_embeds(params, cfg, enc_frontend)
    b, fl = enc_in.shape[:2]
    epos = torch.arange(fl, device=enc_in.device)[None].expand(b, fl)
    memory, _ = _run_stack(params["enc_layers"], cfg, "encoder", enc_in, epos)
    return rmsnorm(memory, params["enc_final_ln"], cfg.norm_eps)


def _mrope_positions(cfg: ArchConfig, batch: int, seq: int, device=None) -> torch.Tensor:
    """(b, s, 3) M-RoPE positions: the first ``frontend_len`` rows, the
    image patches, get (0, h, w) on a ``grid``-wide grid; text row i gets
    (t, t, t) with t = i − frontend_len + grid (Qwen2-VL scheme).  The
    grid is host arithmetic on sizes; the positions are built on
    ``device``."""
    fl = cfg.frontend_len
    grid = int(math.sqrt(max(fl, 1)))
    idx = torch.arange(seq, device=device)
    in_img = idx < fl
    zero = torch.zeros_like(idx)
    h = torch.where(in_img, (idx % max(fl, 1)) // max(grid, 1), zero)
    w = torch.where(in_img, idx % max(grid, 1), zero)
    t = torch.where(in_img, zero, idx - fl + grid)
    pos = torch.stack([t, torch.where(in_img, h, t), torch.where(in_img, w, t)], -1)
    return pos[None].expand(batch, seq, 3)


def _inputs(params, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor], enc_frontend: Optional[torch.Tensor]):
    """What :func:`forward` and :func:`prefill` run the decoder on: (x,
    positions, M-RoPE positions or None, encoder memory or None).  A vlm's
    ``frontend`` (b, frontend_len, d_model) goes through
    ``frontend_proj`` and is prepended to the text, so the positions
    count its rows too.  Any other family refuses one, where the
    reference would drop it."""
    x = embed(tokens, params["embed"])
    if frontend is not None:
        if not (cfg.frontend_stub and cfg.family == "vlm"):
            raise NotImplementedError(
                f"{cfg.name} is not a vlm: it reads no vision frontend stub")
        x = torch.cat([_frontend_embeds(params, cfg, frontend), x], 1)
    b, seq = x.shape[:2]
    positions = torch.arange(seq, device=x.device)[None].expand(b, seq)
    mpos = _mrope_positions(cfg, b, seq, x.device) if cfg.mrope else None
    return x, positions, mpos, encode(params, cfg, enc_frontend)


def forward(params, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            enc_frontend: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Full-sequence forward.  tokens: (b, s).  Returns (logits
    (b, s, vocab) in the model dtype, aux loss f32).  For an
    encoder-decoder, ``enc_frontend`` (b, frames, d_model) feeds the
    encoder.  For a vlm, ``frontend`` (b, frontend_len, d_model) is
    prepended, and the logits have ``frontend_len + s`` rows."""
    x, positions, mpos, memory = _inputs(params, cfg, tokens, frontend, enc_frontend)
    x, aux = _run_stack(params["layers"], cfg, "decoder", x, positions, memory, mpos)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(x, _head(params)), aux


def lm_loss(params, cfg: ArchConfig, tokens: torch.Tensor,
            labels: torch.Tensor, frontend: Optional[torch.Tensor] = None,
            enc_frontend: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean next-token cross entropy in f32 plus 0.01 · aux, over the
    labels' positions: a vlm's frontend rows predict no token."""
    logits, aux = forward(params, cfg, tokens, frontend, enc_frontend)
    lf = logits[:, -labels.shape[1]:].float()
    logz = torch.logsumexp(lf, dim=-1)
    gold = lf.gather(-1, labels[..., None].long())[..., 0]
    return (logz - gold).mean() + 0.01 * aux


# ---------------------------------------------------------------------------
# prefill / decode (alternating engine)
# ---------------------------------------------------------------------------

def prefill(params, cfg: ArchConfig, tokens: torch.Tensor,
            frontend: Optional[torch.Tensor] = None,
            enc_frontend: Optional[torch.Tensor] = None
            ) -> Tuple[torch.Tensor, Cache]:
    """Full forward that also materializes the decode cache.
    Returns (last-position logits (b, vocab), per-layer cache of
    ``seq`` rows, a vlm's frontend rows among them).  ``frontend`` and
    ``enc_frontend`` as in :func:`forward`; the cache holds the decoder's
    self-attention rows only (:func:`decode_step` takes memory again)."""
    x, positions, mpos, memory = _inputs(params, cfg, tokens, frontend, enc_frontend)
    cache: Cache = []
    for p, spec in zip(params["layers"], layer_specs(cfg)):
        x, _, kv = _apply_layer(p, spec, cfg, x, positions, memory, mpos, collect=True)
        cache.append(kv)
    x = rmsnorm(x[:, -1:, :], params["final_ln"], cfg.norm_eps)
    return unembed(x[:, 0, :], _head(params)), cache


def decode_step(params, cfg: ArchConfig, token: torch.Tensor, cache: Cache,
                cache_len: int, memory: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, Cache]:
    """One decode step at the shared position ``cache_len``.
    token: (b, 1); returns (logits (b, vocab), cache).  An
    encoder-decoder's cross attention reads ``memory`` (b, frames,
    d_model), its query at position ``cache_len``; memory's k/v are
    projected again at every step, as in the reference.  M-RoPE takes
    ``_mrope_positions(cfg, b, 1) + cache_len``, (L, L, L) at
    ``cache_len`` L, as in the reference (a teacher-forced
    :func:`forward` gives a text row other positions, so the two differ)."""
    b = token.shape[0]
    cross_pos = None if memory is None else torch.full(
        (b, 1), cache_len, dtype=torch.long, device=token.device)
    mpos = (_mrope_positions(cfg, b, 1, token.device) + cache_len
            if cfg.mrope else None)

    def layer(p, spec, x, lc):
        h = rmsnorm(x, p["ln1"], cfg.norm_eps)
        if spec.mixer == "attn":
            h, k, v = ATT.decode_attention(p["mixer"], cfg, h, lc["k"],
                                           lc["v"], cache_len,
                                           window=spec.window, mrope_positions=mpos)
            nc = {"k": k, "v": v}
        else:
            h, conv, ssm_st = SSM.mamba_decode(p["mixer"], cfg, h,
                                               lc["conv"], lc["ssm"])
            nc = {"conv": conv, "ssm": ssm_st}
        x = _cross(p, spec, cfg, x + h, memory, cross_pos)
        return _ffn(p, spec, cfg, x)[0], nc

    x, cache = _stack_walk(params, cfg, embed(token, params["embed"]),
                           cache, layer)
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(x[:, 0, :], _head(params)), cache


# ---------------------------------------------------------------------------
# KV cache
# ---------------------------------------------------------------------------

def init_cache(cfg: ArchConfig, batch: int, max_len: int,
               device="cuda") -> Cache:
    """Per-layer cache: ``{"k", "v"}`` of shape (batch, max_len, hkv, hd)
    for an attention layer, ``{"conv", "ssm"}`` (:func:`ssm.init_mamba_cache`)
    for a Mamba layer."""
    specs = layer_specs(cfg)
    dev = device_of(device)
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    dtype = dtype_of(cfg.dtype)
    return [{"k": torch.zeros(shape, dtype=dtype, device=dev),
             "v": torch.zeros(shape, dtype=dtype, device=dev)}
            if spec.mixer == "attn" else
            SSM.init_mamba_cache(cfg, batch, dtype, dev)
            for spec in specs]


def cache_slot_view(cache: Cache, i: Union[int, torch.Tensor]) -> Cache:
    """Batch-size-1 view of batch slot ``i``: writes through the view
    land in ``cache``.  ``i`` may be a 0-d integer tensor on the cache's
    device (the reference's traced index), never read on the host: then
    an attention layer's view is its whole k/v with the slot beside them
    (``{"k", "v", "slot"}``, which :func:`chunk_step` reads and writes in
    place at that row), and a Mamba layer's small conv tail and SSM state
    are gathered (``index_select``) for :func:`cache_slot_write` to put
    back."""
    if not isinstance(i, torch.Tensor):
        return [{name: t[i:i + 1] for name, t in lc.items()} for lc in cache]
    at = i.reshape(1)
    return [dict(lc, slot=i) if "k" in lc else
            {name: t.index_select(0, at) for name, t in lc.items()} for lc in cache]


def cache_slot_write(cache: Cache, sub: Cache, i: Union[int, torch.Tensor]) -> Cache:
    """Write a b=1 sub-cache back at slot ``i`` (an int or a 0-d device
    tensor, as in :func:`cache_slot_view`).  A sub-cache entry that
    :func:`cache_slot_view` made as a view of ``cache`` already lives
    there and is not copied."""
    tensor_slot = isinstance(i, torch.Tensor)
    for lc, sc in zip(cache, sub):
        for name, t in lc.items():
            src = sc[name]
            if tensor_slot:
                if src is not t:
                    t.index_put_((i.reshape(1),), src.to(t.dtype))
                continue
            dst = t[i:i + 1]
            if src.data_ptr() != dst.data_ptr():
                dst.copy_(src)
    return cache


def merge_cache_slot(cache: Cache, pre: Cache, slot: int) -> Cache:
    """Write a b=1 prefill cache into batch slot ``slot`` of ``cache``:
    an attention layer's ``plen`` KV rows, a Mamba layer's conv tail and
    SSM state."""
    for lc, pc in zip(cache, pre):
        for name, t in lc.items():
            src = pc[name]
            t[slot:slot + 1, :src.shape[1]] = src.to(t.dtype)
    return cache


def zero_cache_slot(cache: Cache, i: int) -> Cache:
    """Zero every cache row of batch slot ``i`` — reused-slot hygiene:
    a new request admitted into a slot must never see KV rows, conv
    tails or SSM state left by a previous occupant."""
    for lc in cache:
        for t in lc.values():
            t[i].zero_()
    return cache


# ---------------------------------------------------------------------------
# serving fast path: chunked prefill + ragged paged decode
# ---------------------------------------------------------------------------

def _stack_walk(params, cfg: ArchConfig, x, cache: Cache, layer_fn):
    """Walk the layers for the serving step functions:
    ``layer_fn(p, spec, x, layer_cache) -> (x, new_layer_cache)``."""
    specs = layer_specs(cfg)
    new_cache: Cache = []
    for p, spec, lc in zip(params["layers"], specs, cache):
        x, nc = layer_fn(p, spec, x, lc)
        new_cache.append(nc)
    return x, new_cache


def _chunk_layer(p, spec: LayerSpec, cfg: ArchConfig, x, cache, offset,
                 kv_len: int):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        h, k, v = ATT.chunk_attention(p["mixer"], cfg, h, cache["k"],
                                      cache["v"], offset, kv_len,
                                      window=spec.window, slot=cache.get("slot"))
        nc = {"k": k, "v": v}
    else:
        h, conv, ssm_st = SSM.mamba_chunk(p["mixer"], cfg, h, cache["conv"],
                                          cache["ssm"])
        nc = {"conv": conv, "ssm": ssm_st}
    return _ffn(p, spec, cfg, x + h)[0], nc


def chunk_step(params, cfg: ArchConfig, tokens: torch.Tensor, cache: Cache,
               offset, kv_len: int) -> Tuple[torch.Tensor, Cache]:
    """Prefill one chunk of a sequence into an existing cache.

    tokens: (b, c) — rows ``[offset, offset+c)`` of the prompt, ``offset``
    an int or a 0-d integer tensor on the device (the reference's traced
    offset, never read on the host); cache (typically a b=1
    :func:`cache_slot_view`, by an int or a device slot) with all rows
    < offset already prefilled.  Returns (logits (b, c, vocab) for every
    chunk position, cache)."""
    x = embed(tokens, params["embed"])
    x, cache = _stack_walk(
        params, cfg, x, cache,
        lambda p, spec, xc, lc: _chunk_layer(p, spec, cfg, xc, lc, offset,
                                             kv_len))
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(x, _head(params)), cache


def _serve_decode_layer(p, spec: LayerSpec, cfg: ArchConfig, x, cache,
                        lengths, active, kv_len: int):
    h = rmsnorm(x, p["ln1"], cfg.norm_eps)
    if spec.mixer == "attn":
        # inactive slots (mid-prefill / retired) write at their own
        # lengths[i] — a row the next prefill chunk or admission zeroing
        # overwrites, so no select is needed on the KV pages
        h, k, v = ATT.paged_decode_attention(p["mixer"], cfg, h, cache["k"],
                                             cache["v"], lengths, kv_len,
                                             window=spec.window)
        nc = {"k": k, "v": v}
    else:
        h, conv, ssm_st = SSM.mamba_decode(p["mixer"], cfg, h, cache["conv"],
                                           cache["ssm"])
        # the recurrent states are the carry of an in-flight prefill: a
        # garbage decode update would corrupt its next chunk, so inactive
        # slots keep theirs.  Written into the cache's own tensors, as
        # the KV rows are, so the state keeps its storage across ticks
        sel = active[:, None, None]
        cache["conv"].copy_(torch.where(sel, conv, cache["conv"]))
        cache["ssm"].copy_(torch.where(sel, ssm_st, cache["ssm"]))
        nc = cache
    return _ffn(p, spec, cfg, x + h)[0], nc


def serve_decode_step(params, cfg: ArchConfig, token: torch.Tensor,
                      cache: Cache, lengths: torch.Tensor,
                      active: torch.Tensor, kv_len: int
                      ) -> Tuple[torch.Tensor, Cache]:
    """Ragged continuous-batching decode step.

    token: (b, 1); lengths: (b,) per-slot valid cache lengths (each slot
    attends to and extends its own prefix); active: (b,) bool — slots
    currently decoding (Mamba layers keep the recurrent state of the
    others; attention caches need no select); kv_len: page-aligned bound
    ≥ max(lengths)+1.  Returns (logits (b, vocab), cache)."""
    x = embed(token, params["embed"])
    x, cache = _stack_walk(
        params, cfg, x, cache,
        lambda p, spec, xc, lc: _serve_decode_layer(p, spec, cfg, xc, lc,
                                                    lengths, active, kv_len))
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return unembed(x[:, 0, :], _head(params)), cache
