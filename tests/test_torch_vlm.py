"""The port's vision-language decoder (qwen2-vl) against the JAX reference,
on the CPU.

At the smoke config (2 layers, d_model 64, head dim 16, an 8-row vision
stub on a 2-wide grid) in f32, with the reference's ``init_params``
carried across by ``repro_torch.bridge``: ``apply_mrope`` and
``_mrope_positions``, attention with M-RoPE, ``forward`` and ``prefill``
with and without the ``frontend`` stub, chained ``decode_step``s at
M-RoPE positions, ``Trainer``, the prefill and serve steps, both serving
engines and both launchers.  ``lm_loss`` over the text rows, every
gradient leaf, the activation-checkpoint modes and the train steps with
the stub split into micro-batches are qwen2-vl's cases of
``tests/test_torch_train.py``, and its chunk ticks those of
``tests/test_torch_chunk_graph.py``.  Inputs come from numpy under a seed.

A quirk of the reference, ported as it is: ``forward`` and ``prefill``
give text row i ≥ frontend_len the M-RoPE position i − frontend_len +
grid, while ``decode_step`` at ``cache_len`` L gives (L, L, L); so a
teacher-forced forward does not reproduce prefill plus decode steps, in
either package, by the same amount.  The continuous engine's steps pass
no M-RoPE positions and serve qwen2-vl with plain rope, as the
reference's do.

Tolerances, as in ``tests/test_torch_encdec.py``: positions exactly,
M-RoPE 1e-6, a layer 1e-5 and logits 1e-4 absolute; the trainer's loss
1e-5 and gradient norm 1e-4 relative.
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
from repro.model import layers as JL
from repro.model import pallas_mode
from repro.model import transformer as JT
from repro.optim import adamw as JAD
from repro.train import loop as JLOOP
from repro.train import steps as JSTEPS
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.launch import train as tlaunch
from repro_torch.model import attention as TA
from repro_torch.model import layers as TL
from repro_torch.model import transformer as TT
from repro_torch.model.kernel_mode import kernel_mode
from repro_torch.optim import adamw as TAD
from repro_torch.train import loop as TLOOP
from repro_torch.train import steps as TSTEPS
from repro_torch.tree import map_tree

torch.set_num_threads(1)

ARCH = "qwen2_vl_7b"
MROPE_TOL = dict(rtol=0, atol=1e-6)
LAYER_TOL = dict(rtol=0, atol=1e-5)
LOGIT_TOL = dict(rtol=0, atol=1e-4)
BATCH, SEQ = 2, 12
# the kernel routes at smoke sizes (test_serve.py:157)
OPTS = dict(min_attn_q=16, min_matmul_rows=16)


def cfgs(dtype="float32", **kw):
    return (jax_get_arch(ARCH).smoke().scaled(dtype=dtype, **kw),
            get_arch(ARCH).smoke().scaled(dtype=dtype, **kw))


FL = cfgs()[1].frontend_len          # 8 stub rows at smoke, a 2-wide grid


@functools.lru_cache(maxsize=1)
def weights():
    jcfg, _ = cfgs()
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, jax.tree.map(np.asarray, jp)


def port_params():
    return bridge.params_from_numpy(weights()[1], cfgs()[1], "cpu")


def batch(seed=0, b=BATCH, s=SEQ):
    """Tokens, next-token labels and the vision stub (f32)."""
    r = np.random.RandomState(seed)
    toks = r.randint(2, cfgs()[0].vocab, (b, s + 1)).astype(np.int32)
    fe = r.standard_normal((b, FL, cfgs()[0].d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], fe


def t_(a, dtype=torch.long):
    return torch.from_numpy(np.array(a)).to(dtype)


def close(t: torch.Tensor, j, tol):
    np.testing.assert_allclose(t.detach().float().numpy(), np.asarray(j, np.float32), **tol)


def rel(a: float, b: float) -> float:
    return abs(a - b) / abs(b)


def greedy(logits) -> np.ndarray:
    return np.argmax(np.asarray(logits), -1)[:, None].astype(np.int32)


# ---------------------------------------------------------------------------
# M-RoPE and its positions
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("head_dim", [16, 128])
def test_apply_mrope_matches_reference(head_dim):
    """Random (t, h, w) positions; at head dim 128 the sections are 16, 16
    and 32 of the 64 rotary channels."""
    r = np.random.RandomState(head_dim)
    x = r.standard_normal((2, 10, 3, head_dim)).astype(np.float32)
    pos = r.randint(0, 300, (2, 10, 3)).astype(np.int32)
    close(TL.apply_mrope(t_(x, torch.float32), t_(pos)),
          JL.apply_mrope(jnp.asarray(x), jnp.asarray(pos)), MROPE_TOL)


@pytest.mark.parametrize("full_width", [False, True], ids=["smoke", "full"])
@pytest.mark.parametrize("seq", [1, 5, 20, 300])
def test_mrope_positions_match_reference(full_width, seq):
    """The image grid, then linear text positions: at smoke 8 rows on a
    2-wide grid, at full width 256 on a 16-wide one."""
    jcfg, tcfg = (jax_get_arch(ARCH), get_arch(ARCH)) if full_width else cfgs()
    got = TT._mrope_positions(tcfg, 2, seq)
    assert got.shape == (2, seq, 3)
    np.testing.assert_array_equal(got.numpy(), np.asarray(JT._mrope_positions(jcfg, 2, seq)))


def test_attention_with_mrope_matches_reference():
    """``attention`` at M-RoPE positions, and ``decode_attention`` with and
    without them (plain rope at ``cache_len`` without, as the reference)."""
    jcfg, tcfg = cfgs()
    jp = JA.init_attention(jax.random.PRNGKey(4), jcfg, jnp.float32)
    tp = map_tree(lambda a: t_(a, torch.float32), jax.tree.map(np.asarray, jp))
    r = np.random.RandomState(2)
    x = r.standard_normal((BATCH, 10, jcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(10)[None], (BATCH, 10)).astype(np.int32)
    mpos = np.asarray(JT._mrope_positions(jcfg, BATCH, 10))
    close(TA.attention(tp, tcfg, t_(x, torch.float32), t_(pos), mrope_positions=t_(mpos)),
          JA.attention(jp, jcfg, jnp.asarray(x), jnp.asarray(pos),
                       mrope_positions=jnp.asarray(mpos)), LAYER_TOL)
    kc = r.standard_normal((BATCH, 16, jcfg.n_kv_heads, jcfg.hd)).astype(np.float32)
    x1 = x[:, :1]
    for m in (mpos[:, :1] + 7, None):
        jo, jk, _ = JA.decode_attention(jp, jcfg, jnp.asarray(x1), jnp.asarray(kc),
                                        jnp.asarray(kc), jnp.int32(7),
                                        mrope_positions=None if m is None else jnp.asarray(m))
        to, tk, _ = TA.decode_attention(tp, tcfg, t_(x1, torch.float32),
                                        t_(kc, torch.float32), t_(kc, torch.float32), 7,
                                        mrope_positions=None if m is None else t_(m))
        close(to, jo, LAYER_TOL)
        close(tk, jk, LAYER_TOL)


# ---------------------------------------------------------------------------
# forward, prefill, decode
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_frontend", [True, False], ids=["frontend", "text_only"])
def test_forward_and_prefill_match_reference(with_frontend):
    """With the stub prepended (logits over FL + s rows), and without it,
    where the first FL text rows sit on the image grid, as in the
    reference; prefill's logits and its cache of every row."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, fe = batch()
    jkw = dict(frontend=jnp.asarray(fe)) if with_frontend else {}
    tkw = dict(frontend=t_(fe, torch.float32)) if with_frontend else {}
    rows = SEQ + (FL if with_frontend else 0)
    jl, _ = JT.forward(jp, jcfg, jnp.asarray(tok), **jkw)
    with torch.no_grad():
        tl, taux = TT.forward(tp, tcfg, t_(tok), **tkw)
    assert tl.shape == (BATCH, rows, tcfg.vocab) and float(taux) == 0.0
    close(tl, jl, LOGIT_TOL)
    jl, jc = JT.prefill(jp, jcfg, jnp.asarray(tok), **jkw)
    with torch.no_grad():
        tl, tc = TT.prefill(tp, tcfg, t_(tok), **tkw)
    close(tl, jl, LOGIT_TOL)
    want = bridge.cache_from_numpy(jax.tree.map(np.asarray, jc), tcfg, "cpu")
    for a, b in zip(tc, want):
        assert a["k"].shape[1] == rows
        close(a["k"], b["k"].numpy(), LAYER_TOL)
        close(a["v"], b["v"].numpy(), LAYER_TOL)


def prefill_and_decode(mod, params, cfg, tok, fe, fed, to_in, dtype):
    """Prefill the stub and prompt into a 32-row cache, then one
    ``decode_step`` per token of ``fed``; the logits of each."""
    n = FL + tok.shape[1]
    logits, pre = mod.prefill(params, cfg, to_in(tok), frontend=to_in(fe, dtype))
    if mod is JT:
        cache = jserve._merge_slot(JT.init_cache(cfg, 1, 32), pre, 0)
        step = lambda t, i: JT.decode_step(params, cfg, jnp.asarray(t), cache,  # noqa: E731
                                           jnp.int32(n + i))
    else:
        cache = TT.merge_cache_slot(TT.init_cache(cfg, 1, 32, "cpu"), pre, 0)
        step = lambda t, i: TT.decode_step(params, cfg, t_(t), cache, n + i)  # noqa: E731
    out = [np.asarray(logits.detach() if torch.is_tensor(logits) else logits)]
    for i, t in enumerate(fed):
        lg, cache = step(t, i)
        out.append(np.asarray(lg.detach() if torch.is_tensor(lg) else lg))
    return out


def test_chained_decode_steps_match_reference():
    """The stub and a 9-token prompt prefilled, then three chained
    ``decode_step``s at M-RoPE positions (L, L, L), each fed the
    reference's greedy token: logits within 1e-4 at every step."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, fe = batch(seed=3, b=1, s=9)
    jin = lambda a, dtype=None: jnp.asarray(a)  # noqa: E731
    fed, jl = [], None
    jl = prefill_and_decode(JT, jp, jcfg, tok, fe, fed, jin, None)[0]
    for _ in range(3):
        fed.append(greedy(jl))
        jl = prefill_and_decode(JT, jp, jcfg, tok, fe, fed, jin, None)[-1]
    want = prefill_and_decode(JT, jp, jcfg, tok, fe, fed, jin, None)
    with torch.no_grad():
        got = prefill_and_decode(TT, tp, tcfg, tok, fe, fed, t_, torch.float32)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **LOGIT_TOL)


def test_teacher_forced_forward_differs_from_decode_in_both_packages():
    """The reference's quirk, ported: a forward over the stub, the prompt
    and the fed tokens gives the prefill's last row the prefill's logits,
    but each decode step's row other logits than the decode step, whose
    M-RoPE positions are (L, L, L) where the forward's are i − FL + grid.
    Both packages differ by the same amounts."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, fe = batch(seed=5, b=1, s=9)
    fed = [np.array([[7 + 11 * i]], np.int32) for i in range(3)]
    jin = lambda a, dtype=None: jnp.asarray(a)  # noqa: E731
    full = np.concatenate([tok] + fed, 1)
    jsteps = np.concatenate(prefill_and_decode(JT, jp, jcfg, tok, fe, fed, jin, None))
    jfwd = np.asarray(JT.forward(jp, jcfg, jnp.asarray(full), frontend=jnp.asarray(fe))[0])
    with torch.no_grad():
        tsteps = np.concatenate(prefill_and_decode(TT, tp, tcfg, tok, fe, fed, t_,
                                                   torch.float32))
        tfwd = TT.forward(tp, tcfg, t_(full), frontend=t_(fe, torch.float32))[0].numpy()
    rows = slice(FL + tok.shape[1] - 1, None)
    jdiff, tdiff = jsteps - jfwd[0, rows], tsteps - tfwd[0, rows]
    assert np.abs(jdiff[0]).max() <= 1e-4             # the prefill's row agrees
    assert all(np.abs(d).max() > 1e-2 for d in jdiff[1:])
    np.testing.assert_allclose(tdiff, jdiff, **LOGIT_TOL)


# ---------------------------------------------------------------------------
# trainer (the loss over the text rows, every gradient leaf, the remat
# modes and the train steps with the stub are qwen2_vl_7b's cases of
# tests/test_torch_train.py)
# ---------------------------------------------------------------------------

def test_trainer_run_step_matches_reference():
    """One ``Trainer.run_step`` of each package from the same weights: both
    add the zero bf16 ``frontend`` of (batch, frontend_len, d_model),
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
    assert port["frontend_proj"].shape == (tcfg.d_model, tcfg.d_model) and "lm_head" in port
    shapes = jax.tree.map(lambda x: x.shape, bridge.params_to_numpy(port, tcfg))
    ref = jax.eval_shape(lambda k: JT.init_params(k, cfgs("bfloat16")[0]),
                         jax.random.PRNGKey(0))
    assert shapes == jax.tree.map(lambda x: x.shape, ref)


def test_prefill_and_serve_steps_match_reference():
    """``make_prefill_step`` with ``frontend`` in the batch, then one
    ``make_serve_step`` at the next position."""
    jcfg, tcfg = cfgs()
    jp, _ = weights()
    tp = port_params()
    tok, _, fe = batch(b=2, s=8)
    n = FL + 8
    jlog, jcache = JSTEPS.make_prefill_step(jcfg)(
        jp, {"tokens": jnp.asarray(tok), "frontend": jnp.asarray(fe)})
    tlog, tcache = TSTEPS.make_prefill_step(tcfg)(
        tp, {"tokens": t_(tok), "frontend": t_(fe, torch.float32)})
    close(tlog, jlog, LOGIT_TOL)
    jfull = jax.tree.map(lambda c, p: c.at[..., :n, :, :].set(p),
                         JT.init_cache(jcfg, 2, 32), jcache)
    tfull = TT.init_cache(tcfg, 2, 32, "cpu")
    for lc, pc in zip(tfull, tcache):
        for name in lc:
            lc[name][:, :n] = pc[name]
    nxt = greedy(jlog)
    jl2, _ = JSTEPS.make_serve_step(jcfg)(jp, {
        "token": jnp.asarray(nxt), "cache": jfull, "cache_len": jnp.asarray(n)})
    tl2, _ = TSTEPS.make_serve_step(tcfg)(tp, {
        "token": t_(nxt), "cache": tfull, "cache_len": n})
    close(tl2, jl2, LOGIT_TOL)


def prompts(plens, seed):
    return [np.random.RandomState(seed + i).randint(2, cfgs()[0].vocab, size=(1, n))
            .astype(np.int32) for i, n in enumerate(plens)]


@pytest.mark.parametrize("kernels", [False, True])
def test_continuous_engine_matches_reference(kernels):
    """Ragged prompts through both packages' continuous engines, which
    serve qwen2-vl with plain rope (their steps pass no M-RoPE
    positions): greedy tokens equal, on the plain route and with the
    thresholds lowered to 16 on both sides, where full chunks take flash
    and the planned matmul."""
    jcfg, tcfg = cfgs()
    gen, max_len, chunk, page = 6, 64, 16, 16
    ps = prompts([35, 19, 26], 40)
    eng = tserve.ContinuousEngine(tcfg, port_params(), 2, max_len, chunk=chunk, max_new=gen,
                                  page=page, use_kernels=kernels, kernel_opts=OPTS)
    treqs = [tserve.Request(i, p) for i, p in enumerate(ps)]
    for r in treqs:
        eng.submit(r)
    eng.run()
    assert eng.ticks_overlap > 0
    with pallas_mode.pallas_mode(enabled=False):
        jeng = jserve.ContinuousEngine(jcfg, weights()[0], 2, max_len, chunk=chunk,
                                       max_new=gen, page=page, use_pallas=kernels,
                                       pallas_opts=OPTS)
        jreqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(ps)]
        for r in jreqs:
            jeng.submit(r)
        jeng.run()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


@pytest.mark.parametrize("kernels", [False, True])
def test_alternating_engine_matches_reference(kernels):
    """Both packages' alternating engines: the prefill takes no stub, so the
    prompt's first FL rows sit on M-RoPE's image grid, and each lock-step
    decode runs at (L, L, L).  Greedy tokens equal, plain and with the
    kernel routes at lowered thresholds (the 20-row prefill takes flash
    and the planned matmul)."""
    jcfg, tcfg = cfgs()
    gen, max_len = 5, 48
    ps = prompts([20, 17], 60)
    with kernel_mode(enabled=kernels, **OPTS):
        teng = tserve.ServeEngine(tcfg, port_params(), 2, max_len)
        treqs = [tserve.Request(i, p) for i, p in enumerate(ps)]
        for i, r in enumerate(treqs):
            teng.admit(r, slot=i)
        for _ in range(gen - 1):
            teng.step()
    with pallas_mode.pallas_mode(enabled=kernels, **OPTS):
        jeng = jserve.ServeEngine(jcfg, weights()[0], 2, max_len)
        jreqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(ps)]
        for i, r in enumerate(jreqs):
            jeng.admit(r, slot=i)
        for _ in range(gen - 1):
            jeng.step()
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]
    assert all(len(r.generated) == gen for r in treqs)


def test_serve_main_runs_qwen2_vl_on_cpu(capsys):
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--kernels", "--batch", "2",
                 "--prompt-len", "20", "--gen", "3", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "2 seqs, 6 tokens" in out and "qwen2-vl-7b" in out


def test_train_main_runs_qwen2_vl_on_cpu(capsys):
    out = tlaunch.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
                        "--batch", "2", "--seq", "16"])
    assert out["final_step"] == 3 and out["restarts"] == 0
    assert all(np.isfinite(v) for v in out["last_metrics"].values())
    assert "[train] step=0" in capsys.readouterr().out
