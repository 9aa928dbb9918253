"""The PyTorch port's layers and model steps against the JAX reference.

Inputs come from numpy under a seed; weights are the reference's
``init_params`` carried across by ``repro_torch.bridge``.  At
``dtype="float32"`` the port must agree with the reference to 1e-5 on a
layer and 1e-4 on the logits (summation order differs between XLA and
torch); in bf16 the logits are held to a stated looser tolerance.  The
kernel routes run their plain versions here, on the CPU.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.model import attention as JA
from repro.model import layers as JL
from repro.model import mlp as JM
from repro.model import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.model import attention as TA
from repro_torch.model import layers as TL
from repro_torch.model import mlp as TM
from repro_torch.model import transformer as TT
from repro_torch.model.kernel_mode import kernel_mode

torch.set_num_threads(1)

ARCH = "granite_3_2b"
LAYER_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
# bf16: the two frameworks round activations at different places (XLA
# may fuse an elementwise chain in f32, torch rounds after each op);
# logits of the smoke model are O(1), so a few bf16 ulps of O(1)
BF16_LOGIT_TOL = dict(rtol=0, atol=6e-2)


def cfgs(dtype="float32"):
    return (jax_get_arch(ARCH).smoke().scaled(dtype=dtype),
            get_arch(ARCH).smoke().scaled(dtype=dtype))


@functools.lru_cache(maxsize=2)
def weights(dtype="float32"):
    jcfg, tcfg = cfgs(dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jp)
    return jp, bridge.params_from_numpy(tree, tcfg, "cpu")


def rng(seed):
    return np.random.RandomState(seed)


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.float().numpy(),
                               np.asarray(j, np.float32), **tol)


def both_caches(jcfg, tcfg, batch, max_len, seed):
    """Equal random caches for the two packages (f32)."""
    jc = JT.init_cache(jcfg, batch, max_len)
    r = rng(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        r.standard_normal(a.shape).astype(np.float32)), jc)
    return jc, bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg,
                                       "cpu")


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_rmsnorm_matches_reference():
    r = rng(0)
    x = r.standard_normal((2, 5, 64)).astype(np.float32)
    g = (0.1 * r.standard_normal(64)).astype(np.float32)
    close(TL.rmsnorm(torch.from_numpy(x), torch.from_numpy(g)),
          JL.rmsnorm(jnp.asarray(x), jnp.asarray(g)), LAYER_TOL)


def test_rope_matches_reference():
    r = rng(1)
    x = r.standard_normal((2, 7, 4, 16)).astype(np.float32)
    pos = (np.arange(7)[None] + np.array([[0], [29]])).astype(np.int32)
    close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos).long()),
          JL.apply_rope(jnp.asarray(x), jnp.asarray(pos)), LAYER_TOL)


def test_sdpa_matches_reference():
    r = rng(2)
    q = r.standard_normal((2, 6, 4, 16)).astype(np.float32)
    k = r.standard_normal((2, 9, 2, 16)).astype(np.float32)
    v = r.standard_normal((2, 9, 2, 16)).astype(np.float32)
    mask = r.rand(2, 6, 9) < 0.7
    mask[..., 0] = True
    close(TA._sdpa(*(torch.from_numpy(a) for a in (q, k, v)),
                   torch.from_numpy(mask), 2),
          JA._sdpa(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                   jnp.asarray(mask), 2), LAYER_TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_mlp_matches_reference(kernels):
    jp, tp = weights()
    x = rng(3).standard_normal((2, 5, 64)).astype(np.float32)
    with kernel_mode(enabled=kernels, min_matmul_rows=1):
        got = TM.mlp(tp["layers"][0]["ffn"], torch.from_numpy(x))
    want = JM.mlp(jax.tree.map(lambda a: a[0], jp["decoder"]["slots"][0]["ffn"]),
                  jnp.asarray(x))
    close(got, want, LAYER_TOL)


@pytest.mark.parametrize("kernels", [False, True])
def test_chunk_attention_matches_reference(kernels):
    jcfg, tcfg = cfgs()
    jp, tp = weights()
    jc, tc = both_caches(jcfg, tcfg, 1, 32, seed=4)
    x = rng(5).standard_normal((1, 8, 64)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["decoder"]["slots"][0]["mixer"])
    want, jk, jv = JA.chunk_attention(jattn, jcfg, jnp.asarray(x),
                                      jc["slots"][0]["k"][0],
                                      jc["slots"][0]["v"][0], 8, 16)
    with kernel_mode(enabled=kernels, min_attn_q=8):
        got, tk, tv = TA.chunk_attention(tp["layers"][0]["mixer"], tcfg,
                                         torch.from_numpy(x), tc[0]["k"],
                                         tc[0]["v"], 8, 16)
    close(got, want, LAYER_TOL)
    close(tk, jk, LAYER_TOL)
    close(tv, jv, LAYER_TOL)


def test_paged_decode_attention_matches_reference():
    jcfg, tcfg = cfgs()
    jp, tp = weights()
    jc, tc = both_caches(jcfg, tcfg, 2, 32, seed=6)
    x = rng(7).standard_normal((2, 1, 64)).astype(np.float32)
    lengths = np.array([3, 10], np.int32)
    jattn = jax.tree.map(lambda a: a[0], jp["decoder"]["slots"][0]["mixer"])
    want, jk, jv = JA.paged_decode_attention(
        jattn, jcfg, jnp.asarray(x), jc["slots"][0]["k"][0],
        jc["slots"][0]["v"][0], jnp.asarray(lengths), 16)
    got, tk, tv = TA.paged_decode_attention(
        tp["layers"][0]["mixer"], tcfg, torch.from_numpy(x), tc[0]["k"],
        tc[0]["v"], torch.from_numpy(lengths).long(), 16)
    close(got, want, LAYER_TOL)
    close(tk, jk, LAYER_TOL)
    close(tv, jv, LAYER_TOL)


# Head layouts of the served attention models: (arch, heads, kv heads,
# head dim, window); gemma3's local layers take the 1024-row window, its
# global layers none.
DECODE_LAYOUTS = {
    "granite": ("granite_3_2b", 32, 8, 64, 0),
    "gemma3_local": ("gemma3_4b", 8, 4, 256, 1024),
    "gemma3_global": ("gemma3_4b", 8, 4, 256, 0),
    "qwen2_vl": ("qwen2_vl_7b", 28, 4, 128, 0),
    "qwen3_moe": ("qwen3_moe_30b_a3b", 32, 4, 128, 0),
    "seamless": ("seamless_m4t_large_v2", 16, 16, 64, 0),
}


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("layout", sorted(DECODE_LAYOUTS))
def test_paged_decode_attention_layouts_match_reference(layout, kernels, monkeypatch):
    """The ragged decode's attention at each served head layout, with the
    kernel mode off (the masked ``_sdpa``) and on (``ops``'s plain
    version of kernel E), against the reference; ragged lengths with a
    slot at 0, one at kv_len - 1 and one past kv_len.  The plain version
    in ``kernels/ref.py`` agrees with ``_sdpa_dense`` bit for bit, in f32
    and in bf16."""
    from repro_torch.kernels import ops, ref

    arch, h, hkv, hd, window = DECODE_LAYOUTS[layout]
    kv_len = 1152 if window else 96
    shape = dict(n_heads=h, n_kv_heads=hkv, head_dim=hd)
    jcfg = jax_get_arch(arch).smoke().scaled(**shape)
    tcfg = get_arch(arch).smoke().scaled(**shape)
    r = rng(20)
    p = {"wq": (jcfg.d_model, h * hd), "wk": (jcfg.d_model, hkv * hd),
         "wv": (jcfg.d_model, hkv * hd), "wo": (h * hd, jcfg.d_model)}
    p = {k: (r.standard_normal(s) / np.sqrt(s[0])).astype(np.float32) for k, s in p.items()}
    if jcfg.qk_norm:
        p.update(q_norm=(1 + 0.1 * r.standard_normal(hd)).astype(np.float32),
                 k_norm=(1 + 0.1 * r.standard_normal(hd)).astype(np.float32))
    lengths = np.array([0, kv_len - 1, kv_len + 30, kv_len // 3, kv_len - 70], np.int32)
    b = len(lengths)
    kc, vc = (r.standard_normal((b, kv_len + 64, hkv, hd)).astype(np.float32)
              for _ in range(2))
    x = r.standard_normal((b, 1, jcfg.d_model)).astype(np.float32)
    want, jk, jv = JA.paged_decode_attention(
        {k: jnp.asarray(a) for k, a in p.items()}, jcfg, jnp.asarray(x), jnp.asarray(kc),
        jnp.asarray(vc), jnp.asarray(lengths), kv_len, window=window)
    calls = []
    routed = ops.paged_decode_attention
    monkeypatch.setattr(ops, "paged_decode_attention",
                        lambda *a, **kw: calls.append(a) or routed(*a, **kw))
    tp = {k: torch.from_numpy(a) for k, a in p.items()}
    tlen = torch.from_numpy(lengths).long()
    with kernel_mode(enabled=kernels):
        got, tk, tv = TA.paged_decode_attention(
            tp, tcfg, torch.from_numpy(x), torch.from_numpy(kc), torch.from_numpy(vc),
            tlen, kv_len, window=window)
    assert len(calls) == int(kernels)
    close(got, want, LAYER_TOL)
    close(tk, jk, LAYER_TOL)
    close(tv, jv, LAYER_TOL)

    q, _, _ = TA._qkv(tp, tcfg, torch.from_numpy(x), tlen[:, None])
    j = torch.arange(kv_len)[None, None, :]
    mask = j <= tlen[:, None, None]
    if window:
        mask &= j > (tlen[:, None, None] - window)
    for dt in (torch.float32, torch.bfloat16):
        qd, kd, vd = (t.to(dt) for t in (q, tk[:, :kv_len], tv[:, :kv_len]))
        plain = ref.paged_decode_attention_ref(qd, kd, vd, tlen, window)
        assert torch.equal(plain, TA._sdpa_dense(qd, kd, vd, mask.expand(b, 1, kv_len),
                                                 h // hkv))


def test_engine_decode_ticks_route_through_the_decode_kernel(monkeypatch):
    """A CUDA-free engine in kernel mode sends every attention layer of
    every decode tick through ``ops.paged_decode_attention`` (kernel E's
    plain version here), and serves the same tokens as with the kernel
    mode off."""
    from repro_torch.kernels import ops

    _, tcfg = cfgs()
    calls = []
    routed = ops.paged_decode_attention
    monkeypatch.setattr(ops, "paged_decode_attention",
                        lambda *a, **kw: calls.append(a) or routed(*a, **kw))

    def serve(kernels: bool):
        eng = tserve.ContinuousEngine(tcfg, weights()[1], 2, 48, chunk=8, max_new=4,
                                      use_kernels=kernels)
        reqs = [tserve.Request(i, torch.from_numpy(_prompt(30 + i, n)).long())
                for i, n in enumerate((11, 6, 9))]
        for req in reqs:
            eng.submit(req)
        eng.run()
        return eng, [req.generated for req in reqs]

    eng, toks = serve(True)
    attn = sum(spec.mixer == "attn" for spec in TT.layer_specs(tcfg))
    assert eng.ticks_decode > 0 and len(calls) == attn * eng.ticks_decode
    calls.clear()
    assert serve(False)[1] == toks and not calls


def test_decode_attention_matches_reference():
    jcfg, tcfg = cfgs()
    jp, tp = weights()
    jc, tc = both_caches(jcfg, tcfg, 2, 16, seed=8)
    x = rng(9).standard_normal((2, 1, 64)).astype(np.float32)
    jattn = jax.tree.map(lambda a: a[0], jp["decoder"]["slots"][0]["mixer"])
    want, jk, _ = JA.decode_attention(jattn, jcfg, jnp.asarray(x),
                                      jc["slots"][0]["k"][0],
                                      jc["slots"][0]["v"][0], 5)
    got, tk, _ = TA.decode_attention(tp["layers"][0]["mixer"], tcfg,
                                     torch.from_numpy(x), tc[0]["k"],
                                     tc[0]["v"], 5)
    close(got, want, LAYER_TOL)
    close(tk, jk, LAYER_TOL)


# ---------------------------------------------------------------------------
# model steps
# ---------------------------------------------------------------------------

def _prompt(seed, n, vocab=512):
    return rng(seed).randint(2, vocab, size=(1, n)).astype(np.int32)


def _chunked(dtype, kernels):
    """Two chunks (offsets 0 and 8) through both packages; returns
    ((jax logits, cache), (port logits, cache)) of the second chunk."""
    jcfg, tcfg = cfgs(dtype)
    jp, tp = weights(dtype)
    toks = _prompt(10, 16)
    jc = JT.init_cache(jcfg, 1, 32)
    tc = TT.init_cache(tcfg, 1, 32, "cpu")
    jstep = jax.jit(lambda p, t, c, off: JT.chunk_step(p, jcfg, t, c, off, 16))
    _, jc = jstep(jp, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    jl, jc = jstep(jp, jnp.asarray(toks[:, 8:]), jc, jnp.int32(8))
    tt = torch.from_numpy(toks).long()
    with kernel_mode(enabled=kernels, min_attn_q=8, min_matmul_rows=8):
        _, tc = TT.chunk_step(tp, tcfg, tt[:, :8], tc, 0, 16)
        tl, tc = TT.chunk_step(tp, tcfg, tt[:, 8:], tc, 8, 16)
    return (jl, jc), (tl, tc)


@pytest.mark.parametrize("kernels", [False, True])
def test_chunk_step_matches_reference(kernels):
    _, tcfg = cfgs()
    (jl, jc), (tl, tc) = _chunked("float32", kernels)
    close(tl, jl, LOGIT_TOL)
    jk = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    for a, b in zip(tc, jk):
        close(a["k"], b["k"].numpy(), LAYER_TOL)
        close(a["v"], b["v"].numpy(), LAYER_TOL)


def test_chunk_step_bf16_logits_within_tolerance():
    (jl, _), (tl, _) = _chunked("bfloat16", kernels=True)
    close(tl, jnp.asarray(jl, jnp.float32), BF16_LOGIT_TOL)


def test_serve_decode_step_matches_reference():
    jcfg, tcfg = cfgs()
    jp, tp = weights()
    jc, tc = both_caches(jcfg, tcfg, 3, 32, seed=11)
    token = _prompt(12, 3).reshape(3, 1)
    lengths = np.array([4, 17, 9], np.int32)
    active = np.array([True, True, False])
    jl, jc = jax.jit(lambda p, t, c, n, a: JT.serve_decode_step(
        p, jcfg, t, c, n, a, 24))(jp, jnp.asarray(token), jc,
                                  jnp.asarray(lengths), jnp.asarray(active))
    tl, tc = TT.serve_decode_step(tp, tcfg, torch.from_numpy(token).long(), tc,
                                  torch.from_numpy(lengths).long(),
                                  torch.from_numpy(active), 24)
    close(tl, jl, LOGIT_TOL)
    jk = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    for a, b in zip(tc, jk):
        close(a["k"], b["k"].numpy(), LAYER_TOL)


def test_prefill_and_decode_step_match_reference():
    jcfg, tcfg = cfgs()
    jp, tp = weights()
    toks = _prompt(13, 9)
    jl, jpre = JT.prefill(jp, jcfg, jnp.asarray(toks))
    tl, tpre = TT.prefill(tp, tcfg, torch.from_numpy(toks).long())
    close(tl, jl, LOGIT_TOL)
    # decode one token from the merged prefill cache in both packages
    from repro.launch.serve import _merge_slot
    jc = _merge_slot(JT.init_cache(jcfg, 1, 16), jpre, 0)
    tc = TT.merge_cache_slot(TT.init_cache(tcfg, 1, 16, "cpu"), tpre, 0)
    tok = np.array([[7]], np.int32)
    jl2, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), jc, jnp.int32(9))
    tl2, _ = TT.decode_step(tp, tcfg, torch.from_numpy(tok).long(), tc, 9)
    close(tl2, jl2, LOGIT_TOL)


# ---------------------------------------------------------------------------
# Mamba layers in the model steps: falcon-mamba, and jamba's attention/Mamba
# interleave without experts (7 Mamba layers and 1 attention layer, MLPs)
# ---------------------------------------------------------------------------

MAMBA_ARCHS = {
    "falcon_mamba_7b": {},
    "jamba_v0_1_52b": dict(n_experts=0, top_k=0),
}


@functools.lru_cache(maxsize=2)
def mamba_setup(arch):
    over = dict(MAMBA_ARCHS[arch], dtype="float32")
    jcfg = jax_get_arch(arch).smoke().scaled(**over)
    tcfg = get_arch(arch).smoke().scaled(**over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def _close_caches(tc, jc, tcfg):
    want = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    assert [sorted(lc) for lc in tc] == [sorted(lc) for lc in want]
    for a, b in zip(tc, want):
        for name in a:
            close(a[name], b[name].numpy(), LOGIT_TOL)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", sorted(MAMBA_ARCHS))
def test_mamba_chunk_step_matches_reference(arch, kernels):
    """Two chunks (offsets 0 and 8) from a random cache: logits and every
    layer's cache (KV rows, conv tails, SSM states) equal the
    reference's."""
    jcfg, tcfg, jp, tp = mamba_setup(arch)
    jc, tc = both_caches(jcfg, tcfg, 1, 32, seed=14)
    toks = _prompt(15, 16)
    jstep = jax.jit(lambda p, t, c, off: JT.chunk_step(p, jcfg, t, c, off, 16))
    _, jc = jstep(jp, jnp.asarray(toks[:, :8]), jc, jnp.int32(0))
    jl, jc = jstep(jp, jnp.asarray(toks[:, 8:]), jc, jnp.int32(8))
    tt = torch.from_numpy(toks).long()
    with kernel_mode(enabled=kernels, min_scan_seq=8, min_attn_q=8,
                     min_matmul_rows=8):
        _, tc = TT.chunk_step(tp, tcfg, tt[:, :8], tc, 0, 16)
        tl, tc = TT.chunk_step(tp, tcfg, tt[:, 8:], tc, 8, 16)
    close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc, tcfg)


@pytest.mark.parametrize("arch", sorted(MAMBA_ARCHS))
def test_mamba_serve_decode_step_matches_reference(arch):
    """Ragged decode with one inactive slot: logits and caches equal the
    reference's, and the inactive slot's conv and SSM states are kept."""
    jcfg, tcfg, jp, tp = mamba_setup(arch)
    jc, tc = both_caches(jcfg, tcfg, 3, 32, seed=16)
    before = [{k: t.clone() for k, t in lc.items()} for lc in tc]
    token = _prompt(17, 3).reshape(3, 1)
    lengths = np.array([4, 17, 9], np.int32)
    active = np.array([True, False, True])
    jl, jc = jax.jit(lambda p, t, c, n, a: JT.serve_decode_step(
        p, jcfg, t, c, n, a, 24))(jp, jnp.asarray(token), jc,
                                  jnp.asarray(lengths), jnp.asarray(active))
    tl, tc = TT.serve_decode_step(tp, tcfg, torch.from_numpy(token).long(), tc,
                                  torch.from_numpy(lengths).long(),
                                  torch.from_numpy(active), 24)
    close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc, tcfg)
    for lc, old in zip(tc, before):
        if "ssm" in lc:
            assert torch.equal(lc["ssm"][1], old["ssm"][1])
            assert torch.equal(lc["conv"][1], old["conv"][1])
            assert not torch.equal(lc["ssm"][0], old["ssm"][0])


# ---------------------------------------------------------------------------
# gemma3: a 16-token window (smoke) on the local layers, full attention on
# every 6th layer.  Smoke leaves 2 layers, both local, so the steps run at
# 6 layers (the global one last) and 7 (a local layer after it, past the
# pattern's period)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def gemma3_setup(n_layers):
    over = dict(n_layers=n_layers, dtype="float32")
    jcfg = jax_get_arch("gemma3_4b").smoke().scaled(**over)
    tcfg = get_arch("gemma3_4b").smoke().scaled(**over)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("n_layers", [6, 7])
def test_gemma3_chunk_step_matches_reference(n_layers, kernels):
    """Four 8-row chunks over 32 positions from a random cache: by the
    last chunk the window has cut the local layers' prefix.  Every
    chunk's logits and every layer's KV rows equal the reference's; with
    the kernel routes on, the global layer takes flash (plain version)."""
    jcfg, tcfg, jp, tp = gemma3_setup(n_layers)
    assert [tcfg.is_global_attn_layer(i) for i in range(n_layers)].count(True) == 1
    jc, tc = both_caches(jcfg, tcfg, 1, 32, seed=18)
    toks = _prompt(19, 32)
    tt = torch.from_numpy(toks).long()
    jstep = jax.jit(lambda p, t, c, off: JT.chunk_step(p, jcfg, t, c, off, 32))
    for off in range(0, 32, 8):
        jl, jc = jstep(jp, jnp.asarray(toks[:, off:off + 8]), jc, jnp.int32(off))
        with kernel_mode(enabled=kernels, min_attn_q=8, min_matmul_rows=8):
            tl, tc = TT.chunk_step(tp, tcfg, tt[:, off:off + 8], tc, off, 32)
        close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc, tcfg)


@pytest.mark.parametrize("n_layers", [6, 7])
def test_gemma3_serve_decode_step_matches_reference(n_layers):
    """Ragged decode with one inactive slot; two slots sit past the window
    (lengths 33 and 20 against 16), so their local layers read a cut
    prefix while the global layer reads all of it."""
    jcfg, tcfg, jp, tp = gemma3_setup(n_layers)
    jc, tc = both_caches(jcfg, tcfg, 3, 40, seed=20)
    token = _prompt(21, 3).reshape(3, 1)
    lengths = np.array([5, 33, 20], np.int32)
    active = np.array([True, True, False])
    jl, jc = jax.jit(lambda p, t, c, n, a: JT.serve_decode_step(
        p, jcfg, t, c, n, a, 40))(jp, jnp.asarray(token), jc,
                                  jnp.asarray(lengths), jnp.asarray(active))
    tl, tc = TT.serve_decode_step(tp, tcfg, torch.from_numpy(token).long(), tc,
                                  torch.from_numpy(lengths).long(),
                                  torch.from_numpy(active), 40)
    close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc, tcfg)


# ---------------------------------------------------------------------------
# bridge, init and devices
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_3_2b", "qwen3_0_6b", "gemma3_4b",
                                  "falcon_mamba_7b", "qwen3_moe_30b_a3b",
                                  "jamba_v0_1_52b", "llama4_scout_17b_a16e",
                                  "seamless_m4t_large_v2", "qwen2_vl_7b"])
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_bridge_round_trip_is_bit_exact(arch, dtype):
    jcfg = jax_get_arch(arch).smoke().scaled(dtype=dtype)
    tcfg = get_arch(arch).smoke().scaled(dtype=dtype)
    tree = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(3), jcfg))
    back = bridge.params_to_numpy(bridge.params_from_numpy(tree, tcfg, "cpu"),
                                  tcfg)
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(tree), jax.tree.leaves(back)):
        bits = a.view(np.uint16) if a.dtype.name == "bfloat16" else a
        assert bits.dtype == b.dtype and np.array_equal(bits, b)
    cache = jax.tree.map(np.asarray, JT.init_cache(jcfg, 2, 8))
    cback = bridge.cache_to_numpy(bridge.cache_from_numpy(cache, tcfg, "cpu"),
                                  tcfg)
    assert jax.tree.structure(cback) == jax.tree.structure(cache)


def test_init_params_shapes_and_seed():
    _, tcfg = cfgs("bfloat16")
    a = TT.init_params(tcfg, seed=5, device="cpu")
    b = TT.init_params(tcfg, seed=5, device="cpu")
    jshapes = jax.tree.map(lambda x: x.shape, bridge.params_to_numpy(a, tcfg))
    ref = jax.eval_shape(lambda k: JT.init_params(k, cfgs("bfloat16")[0]),
                         jax.random.PRNGKey(0))
    assert jshapes == jax.tree.map(lambda x: x.shape, ref)
    assert all(torch.equal(a["layers"][0]["mixer"][name], w)
               for name, w in b["layers"][0]["mixer"].items())
    assert a["embed"].dtype == torch.bfloat16 and a["final_ln"].dtype == torch.float32


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    _, tcfg = cfgs()
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_params(tcfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.init_cache(tcfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        tserve.main(["--smoke"])
