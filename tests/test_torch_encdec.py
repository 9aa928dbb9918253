"""The port's encoder-decoder (seamless-m4t) against the JAX reference, on
the CPU.

At the smoke config (2 encoder + 2 decoder layers, d_model 64, 8 stub
frames) in f32, with the reference's ``init_params`` carried across by
``repro_torch.bridge``: the encoder's bidirectional attention and the
decoder's cross attention, ``forward``, ``prefill`` and chained
``decode_step``s with encoder memory, ``lm_loss`` and every gradient
leaf, the activation-checkpoint modes, the train step, ``Trainer``, the
prefill and serve steps, the bridge of the AdamW state both ways (the
parameters' round trip is a case of ``tests/test_torch_layers.py``), both
serving engines and both launchers.  Inputs come from numpy under a seed.

Tolerances, as in ``tests/test_torch_layers.py`` and
``tests/test_torch_train.py``: a layer 1e-5 and logits 1e-4 absolute;
the loss 1e-5 relative; each gradient leaf within 1e-4 of its largest
reference entry; train-step losses and gradient norms 1e-4 relative.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.launch import serve as jserve
from repro.model import attention as JA
from repro.model import transformer as JT
from repro.optim import adamw as JAD
from repro.train import loop as JLOOP
from repro.train import steps as JSTEPS
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.model import attention as TA
from repro_torch.model import transformer as TT
from repro_torch.optim import adamw as TAD
from repro_torch.train import loop as TLOOP
from repro_torch.train import steps as TSTEPS
from repro_torch.tree import leaves, map_tree, with_leaves

torch.set_num_threads(1)

ARCH = "seamless_m4t_large_v2"
LAYER_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
BATCH, SEQ, FRAMES = 2, 12, 8


def cfgs(dtype="float32", **kw):
    return (jax_get_arch(ARCH).smoke().scaled(dtype=dtype, **kw),
            get_arch(ARCH).smoke().scaled(dtype=dtype, **kw))


@functools.lru_cache(maxsize=2)
def weights(dtype="float32"):
    jcfg, tcfg = cfgs(dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def port_params(requires_grad=False):
    _, tcfg = cfgs()
    p = bridge.params_from_numpy(weights()[1], tcfg, "cpu")
    for t in leaves(p):
        t.requires_grad_(requires_grad)
    return p


def batch(seed=0, b=BATCH, s=SEQ):
    """Tokens, next-token labels and the encoder's stub frames (f32)."""
    r = np.random.RandomState(seed)
    toks = r.randint(2, cfgs()[0].vocab, (b, s + 1)).astype(np.int32)
    enc = r.standard_normal((b, FRAMES, cfgs()[0].d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], enc


def t_(a, dtype=torch.long):
    return torch.from_numpy(np.array(a)).to(dtype)


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


# ---------------------------------------------------------------------------
# attention layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("qk_norm", [False, True])
def test_encoder_and_cross_attention_match_reference(qk_norm):
    """``attention_noncausal`` at the encoder's positions, and
    ``cross_attention`` with the decoder's query over memory (rope on
    the query only), each within 1e-5."""
    jcfg, tcfg = cfgs(qk_norm=qk_norm)
    jp = JA.init_attention(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = map_tree(lambda a: t_(a, torch.float32), jax.tree.map(np.asarray, jp))
    r = np.random.RandomState(1)
    x = r.standard_normal((BATCH, 10, jcfg.d_model)).astype(np.float32)
    mem = r.standard_normal((BATCH, FRAMES, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(3, 13)[None], (BATCH, 10)).astype(np.int32)
    epos = np.broadcast_to(np.arange(FRAMES)[None], (BATCH, FRAMES)).astype(np.int32)
    close(TA.attention_noncausal(tp, tcfg, t_(mem, torch.float32), t_(epos)),
          JA.attention_noncausal(jp, jcfg, jnp.asarray(mem), jnp.asarray(epos)), LAYER_TOL)
    close(TA.cross_attention(tp, tcfg, t_(x, torch.float32), t_(mem, torch.float32),
                             t_(pos)),
          JA.cross_attention(jp, jcfg, jnp.asarray(x), jnp.asarray(mem), jnp.asarray(pos)),
          LAYER_TOL)


# ---------------------------------------------------------------------------
# forward, prefill, decode with memory
# ---------------------------------------------------------------------------

def test_forward_and_prefill_match_reference():
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, enc = batch()
    jl, jaux = JT.forward(jp, jcfg, jnp.asarray(tok), enc_frontend=jnp.asarray(enc))
    with torch.no_grad():
        tl, taux = TT.forward(tp, tcfg, t_(tok), enc_frontend=t_(enc, torch.float32))
    assert tl.shape == (BATCH, SEQ, tcfg.vocab)
    close(tl, jl, LOGIT_TOL)
    assert float(taux) == float(jaux) == 0.0
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(tok), enc_frontend=jnp.asarray(enc))
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg, t_(tok), enc_frontend=t_(enc, torch.float32))
    close(tl, jl, LOGIT_TOL)
    want = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    assert [sorted(c) for c in tc] == [["k", "v"]] * tcfg.n_layers
    for a, b in zip(tc, want):
        close(a["k"], b["k"].numpy(), LAYER_TOL)
        close(a["v"], b["v"].numpy(), LAYER_TOL)


def reference_memory(jp, jcfg, enc, final_ln: bool):
    """Encoder memory as the reference's ``prefill`` builds it (with
    ``enc_final_ln``), or as ``tests/test_models.py`` builds it for its
    decode test (without)."""
    enc_in = JT._frontend_embeds(jp, jcfg, jnp.asarray(enc))
    epos = jnp.broadcast_to(jnp.arange(FRAMES)[None], (enc.shape[0], FRAMES))
    mem, _ = JT._run_stack(jp["encoder"], jcfg, "encoder", enc_in, epos)
    if final_ln:
        from repro.model.layers import rmsnorm
        mem = rmsnorm(mem, jp["enc_final_ln"], jcfg.norm_eps)
    return mem


def port_memory(tp, tcfg, enc, final_ln: bool):
    if final_ln:
        return TT.encode(tp, tcfg, t_(enc, torch.float32))
    enc_in = TT._frontend_embeds(tp, tcfg, t_(enc, torch.float32))
    epos = torch.arange(FRAMES)[None].expand(enc.shape[0], FRAMES)
    return TT._run_stack(tp["enc_layers"], tcfg, "encoder", enc_in, epos)[0]


@pytest.mark.parametrize("final_ln", [True, False], ids=["as_prefill", "as_test_models"])
def test_chained_decode_steps_with_memory_match_reference(final_ln):
    """The prompt's prefill cache merged into a 16-row cache, then three
    chained ``decode_step``s with memory, each fed the reference's greedy
    token: logits within 1e-4 at every step."""
    from repro.launch.serve import _merge_slot
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, enc = batch(seed=3, b=1, s=9)
    jmem = reference_memory(jp, jcfg, enc, final_ln)
    with torch.no_grad():
        tmem = port_memory(tp, tcfg, enc, final_ln)
        close(tmem, jmem, LAYER_TOL)
        jl, jpre = JT.prefill(jp, jcfg, jnp.asarray(tok), enc_frontend=jnp.asarray(enc))
        _, tpre = TT.prefill(tp, tcfg, t_(tok), enc_frontend=t_(enc, torch.float32))
        jc = _merge_slot(JT.init_cache(jcfg, 1, 16), jpre, 0)
        tc = TT.merge_cache_slot(TT.init_cache(tcfg, 1, 16, "cpu"), tpre, 0)
        nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)
        for n in range(9, 12):
            jl, jc = JT.decode_step(jp, jcfg, jnp.asarray(nxt), jc, jnp.int32(n), jmem)
            tl, tc = TT.decode_step(tp, tcfg, t_(nxt), tc, n, tmem)
            close(tl, jl, LOGIT_TOL)
            nxt = np.argmax(np.asarray(jl), -1)[:, None].astype(np.int32)


def test_decode_step_without_memory_skips_cross_attention():
    """As in the reference, a decoder layer with cross attention given no
    memory skips the branch (the serving engine's path)."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tok = np.array([[5], [9]], np.int32)
    jl, _ = JT.decode_step(jp, jcfg, jnp.asarray(tok), JT.init_cache(jcfg, 2, 8),
                           jnp.int32(0))
    with torch.no_grad():
        tl, _ = TT.decode_step(port_params(), tcfg, t_(tok),
                               TT.init_cache(tcfg, 2, 8, "cpu"), 0)
    close(tl, jl, LOGIT_TOL)


def test_missing_encoder_input_raises():
    _, tcfg = cfgs()
    with pytest.raises(ValueError, match="enc_frontend"):
        TT.forward(port_params(), tcfg, t_(batch()[0]))


@pytest.mark.parametrize("entry", ["forward", "prefill", "lm_loss"])
def test_vision_frontend_input_raises(entry):
    """A vlm's ``frontend`` stub is not read by any ported arch: passing
    one raises rather than being dropped."""
    _, tcfg = cfgs()
    tok, enc = batch()[0], batch()[-1]
    args = (t_(tok), t_(tok)) if entry == "lm_loss" else (t_(tok),)
    with pytest.raises(NotImplementedError, match="frontend"):
        getattr(TT, entry)(port_params(), tcfg, *args,
                           frontend=torch.zeros((tok.shape[0], 2, tcfg.d_model)),
                           enc_frontend=t_(enc, torch.float32))


# ---------------------------------------------------------------------------
# loss, gradients, train step, trainer
# ---------------------------------------------------------------------------

def port_loss_and_grads(seed=0):
    _, tcfg = cfgs()
    params = port_params(True)
    tok, lab, enc = batch(seed)
    loss = TT.lm_loss(params, tcfg, t_(tok), t_(lab), enc_frontend=t_(enc, torch.float32))
    grads = torch.autograd.grad(loss, leaves(params))
    return loss.detach(), with_leaves(params, list(grads))


def test_lm_loss_and_every_gradient_leaf_match_reference():
    """Every leaf: the encoder's layers, ``frontend_proj``,
    ``enc_final_ln`` and each decoder layer's ``ln_x`` and ``cross``
    among them."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tok, lab, enc = batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p, t, y, e: JT.lm_loss(p, jcfg, t, y, None, e)))(
        jp, jnp.asarray(tok), jnp.asarray(lab), jnp.asarray(enc))
    loss, grads = port_loss_and_grads()
    assert rel(float(loss), float(jloss)) <= 1e-5, (float(loss), float(jloss))
    ours = bridge.params_to_numpy(grads, tcfg)
    jflat = jax.tree_util.tree_flatten_with_path(jgrads)[0]
    oflat = jax.tree.leaves(ours)
    assert len(jflat) == len(oflat)
    names = set()
    for (path, g), o in zip(jflat, oflat):
        g = np.asarray(g, np.float32)
        name = jax.tree_util.keystr(path)
        names.add(name)
        assert o.shape == g.shape, name
        err, bound = np.abs(o - g).max(), 1e-4 * np.abs(g).max() + 1e-7
        assert err <= bound, (name, err, bound)
    for part in ("['encoder']", "['frontend_proj']", "['enc_final_ln']", "['ln_x']",
                 "['cross']['wk']"):
        assert any(part in n for n in names), part


def test_remat_modes_agree(monkeypatch):
    """'none', 'full' and 'dots' give the same loss and gradients with the
    encoder's memory read inside the decoder's checkpointed bodies."""
    runs = {}
    for mode in ("none", "full", "dots"):
        monkeypatch.setattr(TT, "REMAT", mode)
        loss, grads = port_loss_and_grads()
        runs[mode] = (float(loss), [g.numpy() for g in leaves(grads)])
    for mode in ("full", "dots"):
        assert abs(runs[mode][0] - runs["none"][0]) <= 1e-6
        for a, b in zip(runs[mode][1], runs["none"][1]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@functools.lru_cache(maxsize=None)
def jax_train_run(n_micro, steps=3):
    jcfg, _ = cfgs()
    jp, _ = weights()
    opt = JAD.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=steps)
    step = jax.jit(JSTEPS.make_train_step(jcfg, opt, n_micro))
    state = JAD.init(jp)
    out = []
    for s in range(steps):
        tok, lab, enc = batch(seed=10 + s, b=4)
        jp, state, m = step(jp, state, {"tokens": jnp.asarray(tok), "labels": jnp.asarray(lab),
                                        "enc_frontend": jnp.asarray(enc)})
        out.append((float(m["loss"]), float(m["grad_norm"]), float(m["lr"])))
    return out


@pytest.mark.parametrize("n_micro", [1, 2])
def test_train_steps_track_reference(n_micro):
    """Three steps from the same weights and batches, ``enc_frontend``
    split into micro-batches with the tokens: losses and gradient norms
    within 1e-4 relative of the reference's jitted step."""
    _, tcfg = cfgs()
    want = jax_train_run(n_micro)
    step = TSTEPS.make_train_step(
        tcfg, TAD.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=len(want)), n_micro)
    params = port_params(True)
    state = TAD.init(params)
    for s, (jloss, jnorm, jlr) in enumerate(want):
        tok, lab, enc = batch(seed=10 + s, b=4)
        _, _, m = step(params, state, {"tokens": t_(tok), "labels": t_(lab),
                                       "enc_frontend": t_(enc, torch.float32)})
        assert rel(float(m["loss"]), jloss) <= 1e-4, (s, float(m["loss"]), jloss)
        assert rel(float(m["grad_norm"]), jnorm) <= 1e-4, (s, float(m["grad_norm"]), jnorm)
        assert rel(float(m["lr"]), jlr) <= 1e-6
    assert int(state.step) == len(want)


def test_trainer_run_step_matches_reference():
    """One ``Trainer.run_step`` of each package from the same weights: both
    add the zero bf16 ``enc_frontend`` of (batch, frontend_len, d_model),
    which meets the f32 ``frontend_proj`` in f32."""
    jcfg, tcfg = cfgs()
    opt = dict(lr=1e-3, warmup_steps=1, total_steps=3)
    jtr = JLOOP.Trainer(JLOOP.TrainConfig(arch=jcfg, global_batch=2, seq_len=16,
                                          opt=JAD.AdamWConfig(**opt)))
    ttr = TLOOP.Trainer(TLOOP.TrainConfig(arch=tcfg, global_batch=2, seq_len=16,
                                          device="cpu", opt=TAD.AdamWConfig(**opt)))
    ttr.params = ttr._trainable(bridge.params_from_numpy(
        jax.tree.map(np.asarray, jtr.params), tcfg, "cpu"))
    ttr.opt_state = TAD.init(ttr.params)
    want, got = jtr.run_step(0), ttr.run_step(0)
    assert rel(got["loss"], want["loss"]) <= 1e-5, (got, want)
    assert rel(got["grad_norm"], want["grad_norm"]) <= 1e-4, (got, want)


# ---------------------------------------------------------------------------
# bridge, steps, engines, launchers
# ---------------------------------------------------------------------------

def test_init_params_matches_reference_shapes():
    _, tcfg = cfgs("bfloat16")
    port = TT.init_params(tcfg, seed=1, device="cpu")
    shapes = jax.tree.map(lambda x: x.shape, bridge.params_to_numpy(port, tcfg))
    ref = jax.eval_shape(lambda k: JT.init_params(k, cfgs("bfloat16")[0]),
                         jax.random.PRNGKey(0))
    assert shapes == jax.tree.map(lambda x: x.shape, ref)


def test_opt_state_bridge_round_trip():
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    r = np.random.RandomState(7)
    noisy = lambda x: jnp.asarray(r.standard_normal(x.shape).astype(np.float32))  # noqa: E731
    jstate = JAD.init(jp)
    jstate = JAD.AdamWState(jnp.asarray(11, jnp.int32), jax.tree.map(noisy, jstate.m),
                            jax.tree.map(noisy, jstate.v))
    tstate = bridge.opt_state_from_numpy(jax.tree.map(np.asarray, jstate), tcfg, "cpu")
    assert len(tstate.m["enc_layers"]) == tcfg.enc_layers
    back = JAD.AdamWState(*bridge.opt_state_to_numpy(tstate, tcfg))
    assert jax.tree.structure(back) == jax.tree.structure(jstate)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_prefill_and_serve_steps_match_reference():
    """``make_prefill_step`` with ``enc_frontend`` in the batch, then one
    ``make_serve_step`` with ``memory`` in the batch."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, enc = batch(b=2, s=8)
    jlog, jcache = JSTEPS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(tok), "enc_frontend": jnp.asarray(enc)})
    tlog, tcache = TSTEPS.make_prefill_step(tcfg)(
        tp, {"tokens": t_(tok), "enc_frontend": t_(enc, torch.float32)})
    close(tlog, jlog, LOGIT_TOL)
    jfull = jax.tree.map(lambda c, p: c.at[..., :8, :, :].set(p),
                         JT.init_cache(jcfg, 2, 16), jcache)
    tfull = TT.init_cache(tcfg, 2, 16, "cpu")
    for lc, pc in zip(tfull, tcache):
        for n in lc:
            lc[n][:, :8] = pc[n]
    nxt = np.argmax(np.asarray(jlog), -1)[:, None].astype(np.int32)
    jmem = reference_memory(jp, jcfg, enc, True)
    with torch.no_grad():
        tmem = port_memory(tp, tcfg, enc, True)
    jl2, _ = JSTEPS.make_serve_step(jcfg)(jp, {
        "token": jnp.asarray(nxt), "cache": jfull, "cache_len": jnp.asarray(8),
        "memory": jmem})
    tl2, _ = TSTEPS.make_serve_step(tcfg)(tp, {
        "token": t_(nxt), "cache": tfull, "cache_len": 8, "memory": tmem})
    close(tl2, jl2, LOGIT_TOL)


def test_alternating_engines_refuse_the_arch():
    """The reference's alternating engine prefills with no
    ``enc_frontend`` and fails on it (``None @ frontend_proj``); the port's
    refuses the arch when it is made."""
    jcfg, tcfg = cfgs()
    jeng = jserve.ServeEngine(jcfg, weights()[0], 1, 32)
    with pytest.raises(TypeError):
        jeng.admit(jserve.Request(0, jnp.ones((1, 5), jnp.int32)), 0)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserve.ServeEngine(tcfg, port_params(), 1, 32)
    with pytest.raises(ValueError, match="encoder-decoder"):
        tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--engine",
                     "alternating", "--batch", "1", "--prompt-len", "4", "--gen", "2"])


def test_serve_main_runs_seamless_on_cpu(capsys):
    """The continuous engine serves the decoder alone: 20-token prompts
    in 16-row chunks through the kernel routes' plain versions."""
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kernels", "--batch", "2",
                 "--prompt-len", "20", "--gen", "3", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "2 seqs, 6 tokens" in out and "seamless-m4t-large-v2" in out


def test_train_main_runs_seamless_on_cpu(capsys):
    out = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16"])
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert all(np.isfinite(v) for v in out["last_metrics"].values())
    assert "[train] step=0" in capsys.readouterr().out
