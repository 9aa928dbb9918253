"""The port's training path against the JAX reference, on the CPU.

``forward``, ``lm_loss`` and its gradients, the activation-checkpoint
modes, AdamW and the train step, each held to the reference on the same
inputs and weights: token batches come from numpy under a seed, weights
are the reference's ``init_params`` carried across by
``repro_torch.bridge`` (optimizer states too).  The model checks run in
f32; the bf16 section holds AdamW's update and the train step in bf16,
the dtype the card trains in.

The model checks run at the smoke widths of six archs: granite (dense
GQA), gemma3 (sliding window, at a sequence past its smoke window),
qwen3_0_6b (qk-norm, tied embeddings), falcon-mamba (Mamba), jamba
(attention/Mamba interleave with experts) and qwen3-moe (experts on
every layer).  Tolerances: logits 1e-4 and aux 1e-5 absolute; the loss
1e-5 relative; each gradient leaf within 1e-4 of its largest reference
entry (summation order differs between XLA and torch, and the
reference's Mamba scan is associative where the port's is sequential).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.model import transformer as JT
from repro.optim import adamw as JAD
from repro.train import steps as JSTEPS
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import ops
from repro_torch.model import transformer as TT
from repro_torch.optim import adamw as TAD
from repro_torch.train import steps as TSTEPS
from repro_torch.tree import leaves, map_tree, with_leaves

torch.set_num_threads(1)

ARCHS = ("granite_3_2b", "gemma3_4b", "qwen3_0_6b", "falcon_mamba_7b",
         "jamba_v0_1_52b", "qwen3_moe_30b_a3b")
LOGIT_TOL = dict(rtol=0, atol=1e-4)
AUX_TOL = dict(rtol=0, atol=1e-5)
BATCH, SEQ = 2, 24          # gemma3's smoke window is 16


@functools.lru_cache(maxsize=None)
def setup(arch, dtype="float32"):
    jcfg = jax_get_arch(arch).smoke().scaled(dtype=dtype)
    tcfg = get_arch(arch).smoke().scaled(dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jcfg, tcfg, jp, jax.tree.map(np.asarray, jp)


def port_params(arch, requires_grad=True, dtype="float32"):
    _, tcfg, _, tree = setup(arch, dtype)
    p = bridge.params_from_numpy(tree, tcfg, "cpu")
    for t in leaves(p):
        t.requires_grad_(requires_grad)
    return p


def batch(cfg, seed=0, b=BATCH, s=SEQ):
    r = np.random.RandomState(seed)
    toks = r.randint(2, cfg.vocab, (b, s + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def enc_inputs(cfg, seed, b):
    """An encoder-decoder's stub frames (b, frontend_len, d_model) in the
    model's dtype, for each package: ``{}`` for any other arch."""
    if not cfg.enc_layers:
        return {}, {}
    x = np.random.RandomState(100 + seed).standard_normal(
        (b, cfg.frontend_len, cfg.d_model)).astype(np.float32)
    return ({"enc_frontend": jnp.asarray(x, cfg.dtype)},
            {"enc_frontend": torch.from_numpy(x).to(getattr(torch, cfg.dtype))})


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(),
                               np.asarray(j, np.float32), **tol)


def jax_leaves(tree):
    """A port tree's leaves as f32 numpy arrays, in ``jax.tree.leaves``
    order (which sorts dict keys)."""
    return jax.tree.leaves(map_tree(lambda t: t.detach().float().numpy(), tree))


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def grad_leaves_close(tgrads, jgrads, tcfg, frac=1e-4):
    """Each leaf: max |Δ| ≤ frac · max |g_ref| + 1e-7."""
    ours = bridge.params_to_numpy(tgrads, tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    oflat = jax.tree.leaves(ours)
    assert len(jflat) == len(oflat)
    for (path, g), o in zip(jflat, oflat):
        g = np.asarray(g, np.float32)
        assert o.shape == g.shape, path
        bound = frac * np.abs(g).max() + 1e-7
        err = np.abs(o - g).max()
        assert err <= bound, (jax.tree_util.keystr(path), err, bound)


@functools.lru_cache(maxsize=None)
def jax_loss_and_grads(arch, seed=0):
    jcfg, _, jp, _ = setup(arch)
    tok, lab = batch(jcfg, seed)
    fn = jax.jit(jax.value_and_grad(
        lambda p, t, y: JT.lm_loss(p, jcfg, t, y)))
    return fn(jp, jnp.asarray(tok), jnp.asarray(lab))


def port_loss_and_grads(arch, seed=0):
    _, tcfg, _, _ = setup(arch)
    params = port_params(arch)
    tok, lab = batch(tcfg, seed)
    loss = TT.lm_loss(params, tcfg, torch.from_numpy(tok).long(),
                      torch.from_numpy(lab).long())
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.detach(), with_leaves(params, list(grads))


# ---------------------------------------------------------------------------
# forward, loss, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_matches_reference(arch):
    jcfg, tcfg, jp, _ = setup(arch)
    tok, _ = batch(jcfg)
    jl, jaux = jax.jit(lambda p, t: JT.forward(p, jcfg, t))(jp, jnp.asarray(tok))
    with torch.no_grad():
        tl, taux = TT.forward(port_params(arch, False), tcfg,
                              torch.from_numpy(tok).long())
    assert tl.shape == (BATCH, SEQ, tcfg.vocab) and taux.dtype == torch.float32
    close(tl, jl, LOGIT_TOL)
    close(taux, jaux, AUX_TOL)
    if tcfg.n_experts:
        assert float(taux) > 0


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_loss_and_grads_match_reference(arch):
    _, tcfg, _, _ = setup(arch)
    jloss, jgrads = jax_loss_and_grads(arch)
    loss, grads = port_loss_and_grads(arch)
    assert rel(float(loss), float(jloss)) <= 1e-5, (float(loss), float(jloss))
    grad_leaves_close(grads, jgrads, tcfg)


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_modes_agree(arch, monkeypatch):
    """'none', 'full' and 'dots' give the same loss and gradients; with
    experts, the recomputed forward routes as the first one did."""
    runs = {}
    for mode in ("none", "full", "dots"):
        monkeypatch.setattr(TT, "REMAT", mode)
        loss, grads = port_loss_and_grads(arch)
        runs[mode] = (float(loss), [g.numpy() for g in leaves(grads)])
    for mode in ("full", "dots"):
        assert abs(runs[mode][0] - runs["none"][0]) <= 1e-6
        for a, b in zip(runs[mode][1], runs["none"][1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


# ---------------------------------------------------------------------------
# optimizer, bridge
# ---------------------------------------------------------------------------

def adam_inputs(seed, grad_scale):
    r = np.random.RandomState(seed)
    f = np.float32
    shapes = {"w": (7, 5), "b": (5,), "deep": [(3, 4), (6,)]}

    def make(scale, positive=False):
        def one(shape):
            x = r.standard_normal(shape).astype(f) * scale
            return np.abs(x) if positive else x
        return {"w": one(shapes["w"]), "b": one(shapes["b"]),
                "deep": [one(s) for s in shapes["deep"]]}
    return (make(1.0), make(grad_scale), make(0.01), make(1e-4, True))


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_matches_reference(grad_scale):
    cfg = dict(lr=1e-3, warmup_steps=3, total_steps=20)
    params, grads, m, v = adam_inputs(0, grad_scale)
    jstate = JAD.AdamWState(jnp.asarray(4, jnp.int32), m, v)
    jp, js, jm = JAD.update(JAD.AdamWConfig(**cfg), grads, jstate, params)

    tt = lambda tree: map_tree(torch.from_numpy, tree)  # noqa: E731
    tstate = TAD.AdamWState(torch.tensor(4, dtype=torch.int32), tt(m), tt(v))
    tp, ts, tm = TAD.update(TAD.AdamWConfig(**cfg), tt(grads), tstate, tt(params))
    assert int(ts.step) == int(js.step) == 5
    assert rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-6
    assert rel(float(tm["lr"]), float(jm["lr"])) <= 1e-6
    for mine, theirs in ((tp, jp), (ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(jax_leaves(mine), jax.tree.leaves(theirs)):
            np.testing.assert_allclose(a, np.asarray(b), rtol=1e-6, atol=0)


def test_lr_schedule_matches_reference():
    cfg = dict(lr=3e-4, warmup_steps=5, total_steps=25, min_lr_frac=0.1)
    for step in range(31):
        want = float(JAD.lr_at(JAD.AdamWConfig(**cfg), jnp.asarray(step)))
        got = float(TAD.lr_at(TAD.AdamWConfig(**cfg), torch.tensor(step)))
        assert abs(got - want) <= 1e-6 * max(want, 1e-12), (step, got, want)


def test_global_norm_is_accurate_on_large_leaves():
    """Ten million f32 entries and a bf16 leaf: the norm within 1e-6 of
    the f64 one, as the reference's f32 sum of squares is.  (A single
    f32 running sum, which ``linalg.vector_norm`` keeps on the CPU, falls
    outside this.)"""
    r = np.random.RandomState(11)
    big = (r.standard_normal(10_000_000) * 1e-3).astype(np.float32)
    small = r.standard_normal((64, 32)).astype(np.float32)
    tree = {"big": torch.from_numpy(big),
            "small": [torch.from_numpy(small).to(torch.bfloat16)]}
    want = np.sqrt(np.sum(big.astype(np.float64) ** 2)
                   + np.sum(tree["small"][0].double().numpy() ** 2))
    got = TAD.global_norm(tree)
    assert got.dtype == torch.float32
    assert rel(float(got), float(want)) <= 1e-6


def test_adamw_bf16_params_stay_bf16():
    p = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    g = {"w": torch.randn(4, 4).to(torch.bfloat16)}
    state = TAD.init(p)
    before = p["w"].clone()
    out, state, _ = TAD.update(TAD.AdamWConfig(lr=1e-2, warmup_steps=1), g, state, p)
    assert out is p and out["w"].dtype == torch.bfloat16
    assert state.m["w"].dtype == torch.float32 and int(state.step) == 1
    assert not torch.equal(out["w"], before)


@pytest.mark.parametrize("arch", ARCHS)
def test_opt_state_bridge_round_trip(arch):
    """The reference's ``AdamWState`` → the port's → back, exactly."""
    jcfg, tcfg, jp, _ = setup(arch)
    r = np.random.RandomState(7)
    noisy = lambda x: jnp.asarray(r.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    jstate = JAD.init(jp)
    jstate = JAD.AdamWState(jnp.asarray(11, jnp.int32),
                            jax.tree.map(noisy, jstate.m), jax.tree.map(noisy, jstate.v))
    tstate = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    assert tstate.step.dtype == torch.int32 and tstate.step.shape == ()
    back = JAD.AdamWState(*bridge.opt_state_to_numpy(tstate, tcfg))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


# ---------------------------------------------------------------------------
# train / prefill / serve steps
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def jax_train_run(arch, n_micro, steps=3, dtype="float32"):
    """The reference's jitted step, ``steps`` times: per step (loss,
    grad_norm, lr), and the parameters after the first step as numpy."""
    jcfg, _, jp, _ = setup(arch, dtype)
    opt = JAD.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    step = jax.jit(JSTEPS.make_train_step(jcfg, opt, n_micro))
    state = JAD.init(jp)
    out, first = [], None
    for s in range(steps):
        tok, lab = batch(jcfg, seed=10 + s, b=4)
        jp, state, m = step(jp, state, {"tokens": jnp.asarray(tok),
                                        "labels": jnp.asarray(lab),
                                        **enc_inputs(jcfg, s, 4)[0]})
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
        if first is None:
            first = jax.tree.map(np.asarray, jp)
    return out, first


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_steps_track_reference(arch, n_micro):
    """Three optimizer steps from the same weights and batches: losses and
    gradient norms within 1e-4 relative of the reference's jitted step."""
    _, tcfg, _, _ = setup(arch)
    want, _ = jax_train_run(arch, n_micro)
    opt = TAD.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=len(want))
    step = TSTEPS.make_train_step(tcfg, opt, n_micro)
    params = port_params(arch)
    state = TAD.init(params)
    for s, (jloss, jnorm, jlr) in enumerate(want):
        tok, lab = batch(tcfg, seed=10 + s, b=4)
        params2, state2, m = step(params, state, {
            "tokens": torch.from_numpy(tok).long(),
            "labels": torch.from_numpy(lab).long()})
        assert params2 is params and state2 is state
        assert rel(float(m["loss"]), jloss) <= 1e-4, (s, float(m["loss"]), jloss)
        assert rel(float(m["grad_norm"]), jnorm) <= 1e-4, (s, float(m["grad_norm"]), jnorm)
        assert rel(float(m["lr"]), jlr) <= 1e-6
    assert int(state.step) == len(want)


def test_train_step_rejects_uneven_micro_batches():
    _, tcfg, _, _ = setup("granite_3_2b")
    step = TSTEPS.make_train_step(tcfg, TAD.AdamWConfig(), 2)
    params = port_params("granite_3_2b")
    tok = torch.zeros((3, 8), dtype=torch.long)
    with pytest.raises(ValueError, match="micro-batches"):
        step(params, TAD.init(params), {"tokens": tok, "labels": tok})


def test_prefill_and_serve_steps_match_reference():
    jcfg, tcfg, jp, _ = setup("granite_3_2b")
    tok, _ = batch(jcfg, b=2, s=8)
    jlog, jcache = JSTEPS.make_prefill_step(jcfg)(jp, {"tokens": jnp.asarray(tok)})
    params = port_params("granite_3_2b", False)
    tlog, tcache = TSTEPS.make_prefill_step(tcfg)(
        params, {"tokens": torch.from_numpy(tok).long()})
    close(tlog, jlog, LOGIT_TOL)
    # decode one token into a cache of 16 rows holding the prompt
    jfull = JT.init_cache(jcfg, 2, 16)
    jfull = jax.tree.map(lambda c, p: c.at[..., :8, :, :].set(p), jfull, jcache)
    tfull = TT.init_cache(tcfg, 2, 16, "cpu")
    for lc, pc in zip(tfull, tcache):
        for n in lc:
            lc[n][:, :8] = pc[n]
    nxt = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    jl2, _ = JSTEPS.make_serve_step(jcfg)(jp, {
        "token": jnp.asarray(nxt), "cache": jfull, "cache_len": jnp.asarray(8)})
    tl2, _ = TSTEPS.make_serve_step(tcfg)(params, {
        "token": torch.from_numpy(nxt).long(), "cache": tfull, "cache_len": 8})
    close(tl2, jl2, LOGIT_TOL)


# ---------------------------------------------------------------------------
# bf16: AdamW's update and the train step in the dtype the card trains in
# ---------------------------------------------------------------------------

def bf16_bits(a) -> np.ndarray:
    """A bf16 array, from either side of the bridge, as its uint16 bits."""
    a = np.asarray(a)
    return a if a.dtype == np.uint16 else a.view(np.uint16)


@pytest.mark.parametrize("grad_scale", [0.01, 10.0], ids=["unclipped", "clipped"])
def test_adamw_update_bf16_matches_reference(grad_scale):
    """bf16 parameters and gradients, f32 m and v: the port's update, done
    in f32 and rounded once to bf16, gives the reference's parameter bits
    exactly.  lr 1e-2 moves each weight by many bf16 ulps, so an update
    rounded in bf16 before or after the subtraction differs."""
    cfg = dict(lr=1e-2, warmup_steps=3, total_steps=20)
    params, grads, m, v = adam_inputs(1, grad_scale)
    bf = lambda tree: jax.tree.map(lambda x: jnp.asarray(x, jnp.bfloat16), tree)  # noqa: E731
    jstate = JAD.AdamWState(jnp.asarray(4, jnp.int32), m, v)
    jp, js, jm = JAD.update(JAD.AdamWConfig(**cfg), bf(grads), jstate, bf(params))

    tb = lambda tree: map_tree(lambda x: torch.from_numpy(x).to(torch.bfloat16), tree)  # noqa: E731
    tt = lambda tree: map_tree(torch.from_numpy, tree)  # noqa: E731
    tstate = TAD.AdamWState(torch.tensor(4, dtype=torch.int32), tt(m), tt(v))
    tp, ts, tm = TAD.update(TAD.AdamWConfig(**cfg), tb(grads), tstate, tb(params))
    assert all(t.dtype == torch.bfloat16 for t in leaves(tp))
    assert all(t.dtype == torch.float32 for t in leaves(ts.m) + leaves(ts.v))
    assert rel(float(tm["grad_norm"]), float(jm["grad_norm"])) <= 1e-6
    moved = 0
    for a, b, p0 in zip(jax.tree.leaves(map_tree(bridge.to_numpy, tp)),
                        jax.tree.leaves(jp), jax.tree.leaves(bf(params))):
        np.testing.assert_array_equal(a, bf16_bits(b))
        moved += int((a != bf16_bits(p0)).sum())
    assert moved > 0
    # m and v within 1e-6 relative, or 1e-6 of the leaf's largest entry
    # where an entry is a near-cancellation of its two terms
    for mine, theirs in ((ts.m, js.m), (ts.v, js.v)):
        for a, b in zip(jax_leaves(mine), jax.tree.leaves(theirs)):
            b = np.asarray(b)
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6 * np.abs(b).max())


# jamba's smoke MoE (4 experts, top 2) picks another expert for 2-4 of its
# 96 tokens in three of its four MoE layers when XLA and torch round bf16
# activations differently, and its Mamba layers carry each such token's
# change to every later position, so its bf16 logits differ by ~12% RMS
# (3% with the experts off).  Its f32 steps are held above.  The
# encoder-decoder (no router) trains on bf16 stub frames; its f32 steps
# are held in tests/test_torch_encdec.py.
BF16_ARCHS = tuple(a for a in ARCHS if a != "jamba_v0_1_52b") + ("seamless_m4t_large_v2",)


@pytest.mark.parametrize("n_micro", [1, 2])
@pytest.mark.parametrize("arch", BF16_ARCHS)
def test_train_steps_bf16_track_reference(arch, n_micro):
    """Three bf16 optimizer steps from the reference's bf16 weights and the
    same batches, against its jitted step.  Tolerances: the f32 loss 1e-3
    relative (a bf16 log-sum-exp is off by ~4e-3), the grad norm 2e-2
    (bf16 gradients rounded at different places), and at most 2% of the
    bf16 weights with other bits than the reference's after the first
    step, where the update is ≈ lr · sign(g) and only entries with g ≈ 0
    or at a rounding boundary may differ."""
    _, tcfg, _, _ = setup(arch, "bfloat16")
    want, first = jax_train_run(arch, n_micro, dtype="bfloat16")
    opt = TAD.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=len(want))
    step = TSTEPS.make_train_step(tcfg, opt, n_micro)
    params = port_params(arch, dtype="bfloat16")
    state = TAD.init(params)
    for s, (jloss, jnorm, jlr) in enumerate(want):
        tok, lab = batch(tcfg, seed=10 + s, b=4)
        _, _, m = step(params, state, {"tokens": torch.from_numpy(tok).long(),
                                       "labels": torch.from_numpy(lab).long(),
                                       **enc_inputs(tcfg, s, 4)[1]})
        assert rel(float(m["loss"]), jloss) <= 1e-3, (s, float(m["loss"]), jloss)
        assert rel(float(m["grad_norm"]), jnorm) <= 2e-2, (s, float(m["grad_norm"]), jnorm)
        assert rel(float(m["lr"]), jlr) <= 1e-6
        if s == 0:
            differ = total = 0
            for a, b in zip(jax.tree.leaves(bridge.params_to_numpy(params, tcfg)),
                            jax.tree.leaves(first)):
                if b.dtype.name == "bfloat16":
                    differ += int((a != bf16_bits(b)).sum())
                    total += a.size
            assert total and differ <= 0.02 * total, (differ, total)
    assert {t.dtype for t in leaves(params)} == {
        t.dtype for t in leaves(port_params(arch, False, "bfloat16"))}
    assert all(t.dtype == torch.float32 for t in leaves(state.m) + leaves(state.v))


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_step_bf16_sums_micro_grads_in_f32(n_micro, monkeypatch):
    """What the bf16 step hands AdamW: with one micro-batch, the bf16
    gradients themselves; with two, the f32 sum of each micro-batch's
    bf16 gradients over two, as the reference's f32 accumulators hold
    it, exactly.  (A sum kept in bf16 rounds differently.)"""
    _, tcfg, _, _ = setup("granite_3_2b", "bfloat16")
    params = port_params("granite_3_2b", dtype="bfloat16")
    tok, lab = (torch.from_numpy(x).long() for x in batch(tcfg, seed=4, b=4))
    want = None
    for t, y in zip(tok.split(4 // n_micro), lab.split(4 // n_micro)):
        g = torch.autograd.grad(TT.lm_loss(params, tcfg, t, y), leaves(params))
        g = [x.float() for x in g] if n_micro > 1 else list(g)
        want = g if want is None else [a + b for a, b in zip(want, g)]
    if n_micro > 1:
        want = [a / n_micro for a in want]
    seen = {}
    update = TAD.update

    def spy(cfg, grads, state, p):
        seen["grads"] = [g.clone() for g in leaves(grads)]
        return update(cfg, grads, state, p)

    monkeypatch.setattr(TAD, "update", spy)
    step = TSTEPS.make_train_step(tcfg, TAD.AdamWConfig(), n_micro)
    step(params, TAD.init(params), {"tokens": tok, "labels": lab})
    assert len(seen["grads"]) == len(want)
    for got, exp in zip(seen["grads"], want):
        assert got.dtype == exp.dtype
        assert torch.equal(got, exp)


# ---------------------------------------------------------------------------
# kernel wrappers under autograd
# ---------------------------------------------------------------------------

def _kernel_calls(x):
    """Each ``ops`` wrapper with one operand ``x`` that may require grad."""
    r = torch.Generator().manual_seed(0)
    rnd = lambda *s: torch.randn(s, generator=r)  # noqa: E731
    a = torch.rand(1, 8, 4, 2, generator=r)
    return {
        "matmul": lambda: ops.matmul(x.reshape(8, 8), rnd(8, 8)),
        "flash_attention": lambda: ops.flash_attention(
            x.reshape(1, 4, 2, 8), rnd(1, 4, 2, 8), rnd(1, 4, 2, 8)),
        "selective_scan": lambda: ops.selective_scan(
            a, x.reshape(1, 8, 4, 2), rnd(1, 8, 2)),
        "scan_gate": lambda: ops.scan_gate(
            a, rnd(1, 8, 4, 2), rnd(1, 8, 2), x.reshape(1, 8, 4, 2)[..., 0],
            torch.ones(4), rnd(1, 8, 4)),
    }


@pytest.mark.parametrize("name", ["matmul", "flash_attention", "selective_scan",
                                  "scan_gate"])
def test_ops_refuse_autograd(name):
    x = torch.randn(64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no backward"):
        _kernel_calls(x)[name]()
    with torch.no_grad():
        _kernel_calls(x)[name]()
    _kernel_calls(x.detach())[name]()
