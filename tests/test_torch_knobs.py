"""The dry run's model knobs and ``optim.grad_compress`` against the
reference.

``attention.ATTN_CHUNK`` (q-chunked attention, ``_sdpa_chunked``) and
``layers.EMBED_MODE = "onehot"`` are module globals in both packages, set
here with ``monkeypatch``; inputs come from numpy under a seed, in f32.
``grad_compress`` repeats the reference's error-feedback case
(``tests/test_train.py``) in both packages, step for step.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.model import attention as JA
from repro.model import layers as JL
from repro.optim import grad_compress as JG
from repro_torch.configs.registry import get_arch
from repro_torch.model import attention as TA
from repro_torch.model import layers as TL
from repro_torch.optim import grad_compress as TG

torch.set_num_threads(1)

TOL = dict(rtol=0, atol=1e-5)


def qkv(seed, b=2, sq=32, h=4, hkv=2, d=16):
    r = np.random.RandomState(seed)
    return (r.standard_normal((b, sq, h, d)).astype(np.float32),
            r.standard_normal((b, sq, hkv, d)).astype(np.float32),
            r.standard_normal((b, sq, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("causal,window", [(True, 0), (True, 5), (False, 0)])
def test_sdpa_chunked_matches_reference(causal, window):
    q, k, v = qkv(3)
    want = JA._sdpa_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), 2,
                            window, 8, causal=causal)
    got = TA._sdpa_chunked(torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
                           2, window, 8, causal=causal)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("window", [0, 6])
def test_attention_with_attn_chunk_matches_reference(monkeypatch, window):
    """``attention`` at ATTN_CHUNK 8 over 32 rows in both packages, and in
    the port equal to the unchunked attention within 1e-5, gradients
    too (each chunk is recomputed in backward)."""
    import jax
    from repro.model import transformer as JT
    from repro_torch import bridge
    jcfg = jax_get_arch("granite_3_2b").smoke().scaled(dtype="float32")
    tcfg = get_arch("granite_3_2b").smoke().scaled(dtype="float32")
    jp = jax.tree.map(lambda a: a[0], JT.init_params(jax.random.PRNGKey(0), jcfg)
                      ["decoder"]["slots"][0]["mixer"])
    tp = {name: bridge.to_torch(np.asarray(a), "cpu") for name, a in jp.items()}
    x = np.random.RandomState(5).standard_normal((2, 32, 64)).astype(np.float32)
    pos = np.broadcast_to(np.arange(32)[None], (2, 32))
    monkeypatch.setattr(JA, "ATTN_CHUNK", 8)
    monkeypatch.setattr(TA, "ATTN_CHUNK", 8)
    want = JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos), window=window)
    xt = torch.from_numpy(x).requires_grad_(True)
    got = TA.attention(tp, tcfg, xt, torch.from_numpy(pos.copy()), window=window)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    (gx,) = torch.autograd.grad(got.square().sum(), xt)
    monkeypatch.setattr(TA, "ATTN_CHUNK", 0)
    xt2 = torch.from_numpy(x).requires_grad_(True)
    plain = TA.attention(tp, tcfg, xt2, torch.from_numpy(pos.copy()), window=window)
    (gx2,) = torch.autograd.grad(plain.square().sum(), xt2)
    np.testing.assert_allclose(got.detach().numpy(), plain.detach().numpy(), **TOL)
    np.testing.assert_allclose(gx.numpy(), gx2.numpy(), rtol=0, atol=1e-4)


def test_onehot_embed_matches_reference(monkeypatch):
    r = np.random.RandomState(9)
    table = r.standard_normal((50, 8)).astype(np.float32)
    tokens = r.randint(0, 50, (3, 5)).astype(np.int32)
    monkeypatch.setattr(JL, "EMBED_MODE", "onehot")
    monkeypatch.setattr(TL, "EMBED_MODE", "onehot")
    want = JL.embed(jnp.asarray(tokens), jnp.asarray(table))
    got = TL.embed(torch.from_numpy(tokens), torch.from_numpy(table))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    monkeypatch.setattr(TL, "EMBED_MODE", "take")
    assert torch.equal(got, TL.embed(torch.from_numpy(tokens), torch.from_numpy(table)))


def test_grad_compress_error_feedback_matches_reference():
    """bf16 compression with feedback is unbiased over repeated steps, and
    every step's compressed gradient and residual are the reference's."""
    g = np.full((64,), 0.1001, np.float32)        # not bf16-representable
    jr = JG.init_residual({"w": jnp.asarray(g)})["w"] * 0
    tr = TG.init_residual({"w": torch.from_numpy(g)})["w"]
    assert tr.dtype == torch.float32 and not tr.any()
    total = torch.zeros(64)
    for _ in range(64):
        jq, jr = JG.compress_with_feedback({"w": jnp.asarray(g)}, {"w": jr})
        tq, tr_ = TG.compress_with_feedback({"w": torch.from_numpy(g)}, {"w": tr})
        jq, jr, tq, tr = jq["w"], jr["w"], tq["w"], tr_["w"]
        assert tq.dtype == torch.bfloat16
        np.testing.assert_array_equal(tq.float().numpy(), np.asarray(jq, np.float32))
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        total += TG.decompress({"w": tq})["w"]
    np.testing.assert_allclose((total / 64).numpy(), g, rtol=1e-3)
