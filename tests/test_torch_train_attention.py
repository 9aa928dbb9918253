"""Kernel F's routes on the CPU: its plain version against the JAX
reference, forward and gradients, the routing in ``attention()``, and its
``torch.autograd.Function`` under a ``REMAT="full"`` step.

The CUDA kernel itself runs only on the card (``chip_smoke.py``'s train
attention phase holds it to the plain version there); here ``ops``
dispatches CPU tensors to ``ref.train_attention_ref``, and the Function's
launches are stood in for by the plain version to test its plumbing.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.model import attention as JA
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops, ref
from repro_torch.kernels import train_attention as TRA
from repro_torch.model import attention as TA
from repro_torch.model import transformer as TT
from repro_torch.tree import leaves

torch.set_num_threads(1)

# (heads, kv heads, head dim): granite's training layout and a d 128 one
# (qwen3's, jamba's attention layers)
LAYOUTS = {"granite": (32, 8, 64), "d128": (32, 8, 128)}
# f32: summation order alone; bf16: outputs and gradients are cast to bf16
# in both packages, so a few ulps of O(1) values
TOL = {"float32": dict(rtol=0, atol=2e-5), "bfloat16": dict(rtol=1e-2, atol=1e-2)}


def operands(seed: int, b: int, s: int, h: int, hkv: int, d: int, dtype: str):
    """q, k, v and an output cotangent as f32 numpy arrays, already rounded
    to ``dtype`` so both packages see the same values."""
    r = np.random.RandomState(seed)
    arrs = [r.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d), (b, s, h, d))]
    tdt = getattr(torch, dtype)
    return [torch.from_numpy(a).to(tdt).float().numpy() for a in arrs]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("seq", [64, 77])
@pytest.mark.parametrize("layout", sorted(LAYOUTS))
def test_plain_train_attention_matches_reference(layout, seq, dtype):
    """``ops.train_attention`` on the CPU (the plain version) against JAX's
    ``_sdpa`` with a causal mask: the output, and dq, dk, dv by autograd
    against ``jax.vjp``; 77 rows is no multiple of the kernel's 64-row
    tile."""
    h, hkv, d = LAYOUTS[layout]
    q, k, v, g = operands(3, 2, seq, h, hkv, d, dtype)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    mask = jnp.broadcast_to(JA.causal_mask(seq), (2, seq, seq))
    want, vjp = jax.vjp(lambda a, b_, c: JA._sdpa(a, b_, c, mask, h // hkv),
                        *(jnp.asarray(a, jdt) for a in (q, k, v)))
    wq, wk, wv = vjp(jnp.asarray(g, jdt))
    tdt = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(a).to(tdt).requires_grad_() for a in (q, k, v))
    got = ops.train_attention(tq, tk, tv)
    assert got.dtype == tdt
    got.backward(torch.from_numpy(g).to(tdt))
    for name, t, j in (("o", got, want), ("dq", tq.grad, wq), ("dk", tk.grad, wk),
                       ("dv", tv.grad, wv)):
        np.testing.assert_allclose(t.detach().float().numpy(),
                                   np.asarray(j, np.float32), err_msg=name, **TOL[dtype])


def test_plain_version_is_the_masked_sdpa():
    """The plain version is ``_sdpa_dense`` with the causal mask, bit for bit."""
    q, k, v, _ = operands(4, 2, 33, 8, 2, 64, "bfloat16")
    tq, tk, tv = (torch.from_numpy(a).bfloat16() for a in (q, k, v))
    mask = TA.causal_mask(33).expand(2, 33, 33)
    assert torch.equal(ref.train_attention_ref(tq, tk, tv),
                       TA._sdpa_dense(tq, tk, tv, mask, 4))


def layer(dtype=torch.bfloat16, head_dim: int = 64):
    """A smoke granite attention layer at ``head_dim``: weights requiring
    grad and an input."""
    cfg = get_arch("granite_3_2b").smoke().scaled(dtype="bfloat16", head_dim=head_dim)
    gen = torch.Generator().manual_seed(0)
    p = TA.init_attention(gen, cfg, dtype)
    for t in p.values():
        t.requires_grad_(True)
    x = torch.randn(2, 40, cfg.d_model, generator=gen).to(dtype)
    return cfg, p, x, torch.arange(40)[None].expand(2, 40)


@pytest.fixture
def on_card(monkeypatch):
    """Take every CPU tensor for one on the card in ``attention()``'s
    predicate, and spy on ``ops.train_attention``."""
    calls = []
    routed = ops.train_attention
    monkeypatch.setattr(TA, "_on_card", lambda t: True)
    monkeypatch.setattr(ops, "train_attention",
                        lambda *a: calls.append(a[0].shape) or routed(*a))
    return calls


def test_attention_routes_training_calls_to_kernel_f(on_card):
    """A grad-recording, window-0 call at head dim 64 goes to
    ``ops.train_attention``, with the old path's numbers bit for bit."""
    cfg, p, x, pos = layer()
    got = TA.attention(p, cfg, x, pos)
    assert len(on_card) == 1
    q, k, v = TA._qkv(p, cfg, x, pos)
    mask = TA.causal_mask(40).expand(2, 40, 40)
    want = TA._sdpa(q, k, v, mask, cfg.n_heads // cfg.n_kv_heads).reshape(2, 40, -1) @ p["wo"]
    assert torch.equal(got, want)
    grads = torch.autograd.grad(got.float().sum(), list(p.values()))
    wants = torch.autograd.grad(want.float().sum(), list(p.values()))
    assert all(torch.equal(a, b) for a, b in zip(grads, wants))


@pytest.mark.parametrize("case", ["window", "no_grad", "weights_frozen", "f32", "d256",
                                  "chunked"])
def test_attention_keeps_other_calls_on_their_paths(case, on_card, monkeypatch):
    """Windowed layers, inference (no grad recorded, or weights that do not
    require it), f32, head dim 256 and ``ATTN_CHUNK`` keep their paths."""
    cfg, p, x, pos = layer(torch.float32 if case == "f32" else torch.bfloat16,
                           256 if case == "d256" else 64)
    if case == "weights_frozen":
        p = {name: t.detach() for name, t in p.items()}
    if case == "chunked":
        monkeypatch.setattr(TA, "ATTN_CHUNK", 8)
    with torch.set_grad_enabled(case != "no_grad"):
        TA.attention(p, cfg, x, pos, window=16 if case == "window" else 0)
    assert on_card == []


def test_dtensor_calls_keep_the_sharded_path(monkeypatch):
    """A DTensor q (the sharded ``_sdpa_sharded``) is never kernel F's."""
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    monkeypatch.setattr(TA, "_on_card", lambda t: True)
    assert TA._train_kernel_takes(q, 0)
    monkeypatch.setattr(TA, "is_dtensor", lambda t: True)
    assert not TA._train_kernel_takes(q, 0)


def test_cpu_tensors_are_not_on_the_card():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16, requires_grad=True)
    assert not TA._train_kernel_takes(q, 0)


def test_kernel_wrapper_refuses_cpu_tensors():
    q = torch.zeros(1, 4, 2, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        TRA.run_forward(q, q, q)


def plain_launches(monkeypatch):
    """Stand the plain version in for the kernel's launches, so that
    :class:`TRA.TrainAttention` runs on the CPU: the forward returns the
    plain output (and its f32 copy), the backward autograd's gradients of
    the plain version."""
    def fwd(q, k, v):
        with torch.no_grad():
            o32 = ref.train_attention_ref(q.float(), k.float(), v.float())
        return o32.to(v.dtype), o32, torch.zeros(2, q.shape[0], q.shape[2], q.shape[1])

    def bwd(q, k, v, o32, stats, do):
        with torch.enable_grad():
            ins = [t.detach().requires_grad_() for t in (q, k, v)]
            return torch.autograd.grad(ref.train_attention_ref(*ins), ins, do)

    monkeypatch.setattr(TRA, "run_forward", fwd)
    monkeypatch.setattr(TRA, "run_backward", bwd)
    monkeypatch.setattr(ops, "_on_cuda", lambda t: True)
    monkeypatch.setattr(TA, "_on_card", lambda t: True)


@pytest.mark.parametrize("remat,fwd_per_layer", [("full", 2), ("none", 1)])
def test_function_launches_per_train_step(remat, fwd_per_layer, monkeypatch):
    """Through a granite loss and its backward, the Function counts one
    forward a layer and one more for each recompute under ``REMAT="full"``
    (granite's 40 layers: 80), and one backward a layer (40); its
    gradients are the plain path's, bit for bit."""
    cfg = get_arch("granite_3_2b").smoke().scaled(dtype="bfloat16", head_dim=64)
    monkeypatch.setattr(TT, "REMAT", remat)
    params = TT.init_params(cfg, seed=0, device="cpu")
    for t in leaves(params):
        t.requires_grad_(True)
    tok = torch.randint(0, cfg.vocab, (2, 48), generator=torch.Generator().manual_seed(1))

    def grads():
        loss = TT.lm_loss(params, cfg, tok[:, :-1], tok[:, 1:])
        return [loss] + list(torch.autograd.grad(loss, leaves(params)))

    want = grads()
    plain_launches(monkeypatch)
    monkeypatch.setattr(TRA, "LAUNCHES_FWD", 0)
    monkeypatch.setattr(TRA, "LAUNCHES_BWD", 0)
    got = grads()
    assert (TRA.LAUNCHES_FWD, TRA.LAUNCHES_BWD) == (fwd_per_layer * cfg.n_layers,
                                                    cfg.n_layers)
    assert all(torch.equal(a, b) for a, b in zip(got, want))
