"""The port's mixture of experts against the JAX reference.

``moe`` itself at the smoke widths of qwen3-moe (128 → 4 experts, top-2)
and llama4 (top-1 with a shared expert), then the serving steps of the
archs that carry experts — qwen3-moe, jamba with its experts, llama4 —
and of the dense ``qwen3_0_6b`` (qk_norm at the same head layout).
Inputs come from numpy under a seed; weights are the reference's
``init_params`` carried across by ``repro_torch.bridge``; everything runs
in f32, where ``moe`` must agree to 1e-5 and the logits to 1e-4.

Routing is a top-k pick per token, so the picked expert sets are checked
first: an exact tie is the one place ``torch.topk`` and
``jax.lax.top_k`` may pick differently.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.model import mlp as JM
from repro.model import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.model import mlp as TM
from repro_torch.model import transformer as TT
from repro_torch.model.kernel_mode import kernel_mode

torch.set_num_threads(1)

LAYER_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
MOE_ARCHS = ("qwen3_moe_30b_a3b", "jamba_v0_1_52b", "llama4_scout_17b_a16e")
STEP_ARCHS = MOE_ARCHS + ("qwen3_0_6b",)


@functools.lru_cache(maxsize=4)
def setup(arch):
    jcfg = jax_get_arch(arch).smoke().scaled(dtype="float32")
    tcfg = get_arch(arch).smoke().scaled(dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, bridge.params_from_numpy(
        jax.tree.map(np.asarray, jp), tcfg, "cpu")


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **tol)


def first_moe_layer(cfg) -> int:
    return next(i for i in range(cfg.n_layers) if cfg.is_moe_layer(i))


def moe_params(arch):
    """The first MoE layer's ``ffn`` in both packages."""
    jcfg, tcfg, jp, tp = setup(arch)
    layer = first_moe_layer(tcfg)
    period = TT.pattern_period(tcfg)
    slot = jp["decoder"]["slots"][layer % period]["ffn"]
    return (jcfg, jax.tree.map(lambda a: a[layer // period], slot),
            tcfg, tp["layers"][layer]["ffn"])


def reference_picks(jp, jcfg, x):
    """The reference's expert ids per token (its ``moe`` l.91-92)."""
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, x.shape[-1]) @ jp["router"])
    return np.asarray(jax.lax.top_k(probs, jcfg.top_k)[1])


def capacity(t, cfg):
    return max(int(1.25 * t * cfg.top_k / cfg.n_experts) + 3 & ~3, 4)


@pytest.mark.parametrize("arch,rows,kernels", [
    ("qwen3_moe_30b_a3b", 16, False),
    ("qwen3_moe_30b_a3b", 7, False),
    ("llama4_scout_17b_a16e", 16, False),
    ("llama4_scout_17b_a16e", 16, True),
])
def test_moe_matches_reference(arch, rows, kernels):
    """Output at 1e-5 and aux loss equal, with the same experts picked.
    At 7 rows qwen3-moe's capacity is 4 for 14 picks over 4 experts and
    the reference drops picks; with the kernels on, llama4's shared
    expert takes the matmul route (its plain version here)."""
    jcfg, jp, tcfg, tp = moe_params(arch)
    x = np.random.RandomState(7).standard_normal((1, rows, 64)).astype(np.float32)
    want, jaux = JM.moe(jp, jcfg, jnp.asarray(x))
    with kernel_mode(enabled=kernels, min_matmul_rows=1):
        got, taux = TM.moe(tp, tcfg, torch.from_numpy(x))
    picks = reference_picks(jp, jcfg, x)
    _, _, tidx = TM.route(tp, tcfg, torch.from_numpy(x).reshape(rows, 64))
    assert np.array_equal(np.sort(picks, -1), np.sort(tidx.numpy(), -1))
    if rows == 7:
        counts = np.bincount(picks.ravel(), minlength=jcfg.n_experts)
        assert counts.max() > capacity(rows, jcfg), counts
    close(got, want, LAYER_TOL)
    close(taux, jaux, LAYER_TOL)


def test_moe_drops_picks_past_capacity():
    """Picks seated at ``cap`` or beyond contribute nothing.  Every token
    points along one direction, and the router ranks experts 0 then 1 for
    all of them; at the floor capacity of 4 the first four tokens fill
    both queues, so the last four get an exact zero, and the first four
    get what they get alone (4 rows: cap 4, nothing dropped)."""
    _, _, tcfg, tp = moe_params("qwen3_moe_30b_a3b")
    u = torch.from_numpy(np.random.RandomState(8).standard_normal(64).astype(np.float32))
    x = torch.linspace(0.5, 2.0, 8)[None, :, None] * u
    router = torch.zeros_like(tp["router"])
    router[:, 0], router[:, 1] = u, 0.5 * u
    p = dict(tp, router=router)
    assert TM.route(p, tcfg, x[0])[2].tolist() == [[0, 1]] * 8
    out, _ = TM.moe(p, tcfg, x, capacity_factor=0.0)
    assert torch.equal(out[:, 4:], torch.zeros_like(out[:, 4:]))
    close(out[:, :4], TM.moe(p, tcfg, x[:, :4])[0], LAYER_TOL)


@pytest.mark.parametrize("kernels", [False, True])
@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_moe_chunk_step_matches_reference(arch, kernels):
    """Two 8-row chunks (offsets 0 and 8) from a random cache: logits and
    every layer's cache equal the reference's.  With the kernel routes on
    (thresholds at 8), attention chunks take flash and dense MLPs and
    llama4's shared expert the planned matmul, their plain versions
    here."""
    jcfg, tcfg, jp, tp = setup(arch)
    jc, tc = both_caches(jcfg, tcfg, 1, seed=30)
    toks = np.random.RandomState(31).randint(2, tcfg.vocab, (1, 16)).astype(np.int32)
    jstep = jax.jit(lambda p, t, c, off: JT.chunk_step(p, jcfg, t, c, off, 16))
    tt = torch.from_numpy(toks).long()
    for off in (0, 8):
        jl, jc = jstep(jp, jnp.asarray(toks[:, off:off + 8]), jc, jnp.int32(off))
        with kernel_mode(enabled=kernels, min_attn_q=8, min_matmul_rows=8,
                         min_scan_seq=8):
            tl, tc = TT.chunk_step(tp, tcfg, tt[:, off:off + 8], tc, off, 16)
        close(tl, jl, LOGIT_TOL)
    _close_caches(tc, jc, tcfg)


@pytest.mark.parametrize("arch", STEP_ARCHS)
def test_moe_serve_decode_step_matches_reference(arch):
    """Ragged decode of three slots, one inactive: its garbage row is
    routed with the others, as in the reference."""
    jcfg, tcfg, jp, tp = setup(arch)
    jc, tc = both_caches(jcfg, tcfg, 3, seed=32)
    token = np.random.RandomState(33).randint(2, tcfg.vocab, (3, 1)).astype(np.int32)
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


def both_caches(jcfg, tcfg, batch, seed, max_len=32):
    """Equal random caches (KV rows, conv tails, SSM states) for the two
    packages."""
    r = np.random.RandomState(seed)
    jc = jax.tree.map(lambda a: jnp.asarray(
        r.standard_normal(a.shape).astype(np.float32)),
        JT.init_cache(jcfg, batch, max_len))
    return jc, bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")


def _close_caches(tc, jc, tcfg):
    want = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    assert [sorted(lc) for lc in tc] == [sorted(lc) for lc in want]
    for a, b in zip(tc, want):
        for name in a:
            close(a[name], b[name].numpy(), LOGIT_TOL)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_moe_init_params_match_reference_shapes(arch):
    """The port's own ``init_params`` gives the reference's tree: the
    stacked expert weights (repeats, e, d, f) and the f32 router."""
    jcfg = jax_get_arch(arch).smoke()
    tcfg = get_arch(arch).smoke()
    tp = TT.init_params(tcfg, seed=1, device="cpu")
    got = jax.tree.map(lambda a: (a.shape, a.dtype.name),
                       bridge.params_to_numpy(tp, tcfg))
    want = jax.eval_shape(lambda k: JT.init_params(k, jcfg), jax.random.PRNGKey(0))
    want = jax.tree.map(lambda a: (a.shape, "uint16" if a.dtype.name == "bfloat16"
                                   else a.dtype.name), want)
    assert got == want
    ffn = tp["layers"][first_moe_layer(tcfg)]["ffn"]
    assert ffn["router"].dtype == torch.float32
    assert ffn["w_gate"].dtype == torch.bfloat16
    assert ffn["w_gate"].shape == (tcfg.n_experts, tcfg.d_model, tcfg.d_ff)
    assert ("shared" in ffn) == tcfg.shared_expert
