"""Split-KV decode attention: the launch wrapper of ``csrc/decode_attention.cu``.

Kernel E has no TPU counterpart: the reference's ragged decode attention
is plain jnp, and the kernel was added to the port for speed (see the
source's note).  It computes what ``model/attention.py``'s ``_sdpa_dense``
computes for one query row per slot over a page-aligned KV prefix: row j
of slot i counts when j < kv_len, j <= ``lengths[i]`` and, with a window,
j > ``lengths[i] - window``.  ``lengths`` is read on the device, so one
launch (and one captured graph per kv bucket) serves every mix of slot
lengths.  The split length comes from kv_len and b·hkv (:func:`geometry`);
the kernel is built for head dims 64, 128 and 256, and other head dims
raise.  The plain version is
:func:`repro_torch.kernels.ref.paged_decode_attention_ref`.
"""
from __future__ import annotations

from functools import lru_cache
from typing import Optional, Tuple

import torch

from . import build

#: launches of the CUDA kernel since the last reset (main-path evidence)
LAUNCHES = 0

#: the most splits a launch takes (the merge runs one a thread)
MAX_SPLITS = 256

#: the splits of a launch aim at this many blocks an SM (some exit at once:
#: those past their slot's valid rows); the best of a sweep at the docqa
#: decode shapes, on an H100
BLOCKS_PER_SM = 8


def tile_rows(d: int) -> int:
    """Rows of K (and of V) in one slot of the kernel's load ring: 16 KB."""
    return 8192 // d


@lru_cache(maxsize=None)
def _sms(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def geometry(kv_len: int, bh: int, d: int, sms: int) -> Tuple[int, int]:
    """(rows per split, splits) for a launch over ``bh`` (slot, kv head)
    pairs of ``kv_len`` rows on a card of ``sms`` SMs: splits of whole
    ring tiles, about ``BLOCKS_PER_SM`` blocks an SM in all, and at most
    ``MAX_SPLITS``."""
    tile = tile_rows(d)
    per_block = max(-(-kv_len * bh // (BLOCKS_PER_SM * sms)), -(-kv_len // MAX_SPLITS))
    chunk = max(tile, -(-per_block // tile) * tile)
    return chunk, -(-kv_len // chunk)


def _check(x: torch.Tensor, name: str) -> None:
    if x.stride(-1) != 1 or any(s % 8 for s in x.stride()[:-1]) or x.data_ptr() % 16:
        raise ValueError(f"decode attention kernel needs {name} 16-byte aligned with a "
                         f"contiguous head dim and strides in multiples of 8; got "
                         f"strides {x.stride()}")


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
           out: torch.Tensor, window: int, chunk: int) -> None:
    """One launch with splits of ``chunk`` rows, into ``out``, without
    counting it (``chip_smoke.py``'s split sweep calls this directly)."""
    b, _, h, d = q.shape
    kv_len, hkv = k.shape[1], k.shape[2]
    splits = -(-kv_len // chunk)
    part: Optional[torch.Tensor] = None
    if splits > 1:
        part = torch.empty(b * hkv * splits * (h // hkv) * (d + 2), dtype=torch.float32,
                           device=q.device)
    rc = build.load_library().repro_decode_attention_bf16(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        None if part is None else part.data_ptr(), b, h, hkv, kv_len, d, window, chunk,
        splits, q.stride(0), q.stride(2), *k.stride()[:3], *v.stride()[:3],
        build.stream_ptr(q.device))
    build.check(rc, "decode_attention")


def paged_decode_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                           lengths: torch.Tensor, window: int = 0) -> torch.Tensor:
    """q: (b, 1, h, d); k, v: (b, kv_len, hkv, d), a prefix of the KV cache
    read in place; lengths: (b,) integer on the same CUDA device; all of q,
    k, v bf16.  Returns (b, 1, h, d) bf16."""
    global LAUNCHES
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev or lengths.device != dev:
        raise ValueError("decode attention kernel takes tensors on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"decode attention kernel takes bf16, got {q.dtype}, {k.dtype}, "
                        f"{v.dtype}")
    b, sq, h, d = q.shape
    _, kv_len, hkv, _ = k.shape
    if sq != 1 or k.shape[0] != b or v.shape != k.shape or k.shape[3] != d or h % hkv \
            or lengths.shape != (b,) or lengths.is_floating_point() or kv_len < 1:
        raise ValueError(f"decode attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)} lengths {tuple(lengths.shape)}")
    if d not in (64, 128, 256) or h // hkv > 8192 // d:
        raise ValueError(f"decode attention kernel is built for head dims 64, 128 and 256 "
                         f"with at most 8192 / d query heads a kv head; got d {d}, "
                         f"{h // hkv}")
    for x, name in ((q, "q"), (k, "k"), (v, "v")):
        _check(x, name)
    out = torch.empty((b, 1, h, d), dtype=q.dtype, device=dev)
    if b == 0:
        return out
    chunk, _ = geometry(kv_len, b * hkv, d, _sms(dev))
    launch(q, k, v, lengths.long(), out, int(window), chunk)
    LAUNCHES += 1
    return out
