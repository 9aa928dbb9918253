"""Causal attention with its own backward for the training step: the
launch wrappers of ``csrc/train_attention.cu`` (kernel F).

Kernel F has no TPU counterpart: the reference trains through plain jnp
attention, and its Pallas flash kernel has no VJP.  It computes what
``model/attention.py``'s causal ``_sdpa_dense`` computes, forward and
backward, in f32 on the widened bf16 values, without writing scores,
probabilities or their gradients to device memory (see the source's
note).  :class:`TrainAttention` is its ``torch.autograd.Function``: the
forward keeps q, k, v, the f32 output and each row's max and 1/sum for the
backward, which recomputes the rest.  Head dims 64 and 128, bf16 q, k, v;
anything else raises.  The plain version is
:func:`repro_torch.kernels.ref.train_attention_ref`.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build

#: launches of the forward and of the backward since the last reset
#: (main-path evidence; a backward is one call of its kernels)
LAUNCHES_FWD = 0
LAUNCHES_BWD = 0

#: the head dims the kernels are built for
HEAD_DIMS = (64, 128)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    dev = q.device
    if dev.type != "cuda" or k.device != dev or v.device != dev:
        raise ValueError("train attention kernel takes tensors on one CUDA device")
    if not (q.dtype == k.dtype == v.dtype == torch.bfloat16):
        raise TypeError(f"train attention kernel takes bf16 q, k and v; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    if q.dim() != 4 or k.shape != v.shape or k.dim() != 4 or k.shape[:2] != q.shape[:2] \
            or k.shape[3] != q.shape[3] or q.shape[2] % k.shape[2]:
        raise ValueError(f"train attention shapes q {tuple(q.shape)} k {tuple(k.shape)} "
                         f"v {tuple(v.shape)}")
    if q.shape[3] not in HEAD_DIMS:
        raise ValueError(f"train attention kernel is built for head dims {HEAD_DIMS}, "
                         f"got {q.shape[3]}")


def _parts(q: torch.Tensor) -> Optional[torch.Tensor]:
    """Scratch for q / sqrt(d) as three bf16 parts (d 128; d 64 reads q)."""
    return None if q.shape[3] == 64 else torch.empty((3,) + q.shape, dtype=q.dtype,
                                                      device=q.device)


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def run_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """q (b, s, h, d), k and v (b, s, hkv, d), bf16 on one CUDA device.
    Returns (o bf16, o f32, stats (2, b, h, s) f32: each row's max and
    1/sum), without counting the launch."""
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    b, s, h, d = q.shape
    o = torch.empty_like(q)
    o32 = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    stats = torch.empty((2, b, h, s), dtype=torch.float32, device=q.device)
    rc = build.load_library().repro_train_attention_fwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), _ptr(_parts(q)), o.data_ptr(),
        o32.data_ptr(), stats.data_ptr(), b, s, h, k.shape[2], d,
        build.stream_ptr(q.device))
    build.check(rc, "train_attention forward")
    return o, o32, stats


def run_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, o32: torch.Tensor,
                 stats: torch.Tensor, do: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """dq, dk, dv (bf16, like q, k, v) of :func:`run_forward` for the output's
    gradient ``do``, without counting the launch."""
    _check(q, k, v)
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    do = do.contiguous()
    if do.dtype != q.dtype or do.shape != q.shape or o32.shape != q.shape:
        raise ValueError(f"train attention backward takes do like q: do {do.dtype} "
                         f"{tuple(do.shape)}, q {q.dtype} {tuple(q.shape)}")
    b, s, h, d = q.shape
    delta = torch.empty((b, h, s), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    rc = build.load_library().repro_train_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), o32.data_ptr(),
        stats.data_ptr(), _ptr(_parts(q)), delta.data_ptr(), dq.data_ptr(), dk.data_ptr(),
        dv.data_ptr(), b, s, h, k.shape[2], d, build.stream_ptr(q.device))
    build.check(rc, "train_attention backward")
    return dq, dk, dv


class TrainAttention(torch.autograd.Function):
    """Kernel F under autograd: causal attention of q over k, v."""

    @staticmethod
    def forward(ctx, q, k, v):
        global LAUNCHES_FWD
        o, o32, stats = run_forward(q, k, v)
        LAUNCHES_FWD += 1
        ctx.save_for_backward(q, k, v, o32, stats)
        return o

    @staticmethod
    def backward(ctx, do):
        global LAUNCHES_BWD
        q, k, v, o32, stats = ctx.saved_tensors
        grads = run_backward(q, k, v, o32, stats, do)
        LAUNCHES_BWD += 1
        return grads


def train_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Causal attention of q (b, s, h, d) over k, v (b, s, hkv, d), bf16 on
    one CUDA device, differentiable.  Returns o (b, s, h, d) bf16."""
    return TrainAttention.apply(q, k, v)
