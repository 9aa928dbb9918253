"""The port's serving engines against the JAX reference engines.

The cases of ``tests/test_serve.py`` — slot-reuse hygiene, FIFO
admission with slot recycling, the ragged chunked-prefill interleave,
kernel routing with thresholds lowered to 16 (``test_serve.py:157``),
and continuous against alternating — run on both packages with the same
f32 weights (carried across by ``repro_torch.bridge``), the same prompts
(numpy, seeded) and the same page size.  Greedy tokens must be equal.
The ragged interleave also runs on falcon-mamba smoke, where the decode
half of a mixed tick must leave the prefilling slot's recurrent state
alone, on gemma3 smoke at 7 layers, with prompts past its 16-token
window, and on the MoE archs' smoke configs, whose capacity-bounded
routing makes a token's output depend on the other rows of its chunk or
decode tick.

The JAX engines here never enable the Pallas path, and each runs inside
``pallas_mode.pallas_mode(...)`` so the process-wide mode is restored
for whatever test runs next in this worker.
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
from repro.model import pallas_mode
from repro.model import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.model import kernel_mode
from repro_torch.plan import plan_attention

torch.set_num_threads(1)

JCFG = jax_get_arch("granite_3_2b").smoke().scaled(dtype="float32")
TCFG = get_arch("granite_3_2b").smoke().scaled(dtype="float32")
PAGE = 16


FALCON = (jax_get_arch("falcon_mamba_7b").smoke().scaled(dtype="float32"),
          get_arch("falcon_mamba_7b").smoke().scaled(dtype="float32"))
# a global layer (5) between local ones: smoke's 2 layers are both local
GEMMA3 = (jax_get_arch("gemma3_4b").smoke().scaled(n_layers=7, dtype="float32"),
          get_arch("gemma3_4b").smoke().scaled(n_layers=7, dtype="float32"))
MOE = {arch: (jax_get_arch(arch).smoke().scaled(dtype="float32"),
              get_arch(arch).smoke().scaled(dtype="float32"))
       for arch in ("qwen3_moe_30b_a3b", "llama4_scout_17b_a16e", "jamba_v0_1_52b")}
SEAMLESS = (jax_get_arch("seamless_m4t_large_v2").smoke().scaled(dtype="float32"),
            get_arch("seamless_m4t_large_v2").smoke().scaled(dtype="float32"))


@functools.lru_cache(maxsize=8)
def weights(cfgs=(JCFG, TCFG)):
    jcfg, tcfg = cfgs
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg,
                                        "cpu")


def prompt(seed: int, plen: int) -> np.ndarray:
    return np.random.RandomState(seed).randint(
        2, JCFG.vocab, size=(1, plen)).astype(np.int32)


def jax_continuous(prompts, gen, max_len, batch, cfgs=(JCFG, TCFG), **kw):
    """The reference engine's greedy tokens; ``use_pallas`` and
    ``pallas_opts`` in ``kw`` route its ticks through the Pallas kernels
    (interpret mode on the CPU)."""
    with pallas_mode.pallas_mode(enabled=False):
        eng = jserve.ContinuousEngine(cfgs[0], weights(cfgs)[0], batch,
                                      max_len, max_new=gen, page=PAGE, **kw)
        reqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(prompts)]
        for r in reqs:
            eng.submit(r)
        eng.run()
    return [r.generated for r in reqs]


def port_continuous(prompts, gen, max_len, batch, cfgs=(JCFG, TCFG), **kw):
    eng = tserve.ContinuousEngine(cfgs[1], weights(cfgs)[1], batch, max_len,
                                  max_new=gen, page=PAGE, **kw)
    reqs = [tserve.Request(i, p) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return eng, reqs


def port_alternating(prompts, gen, max_len):
    eng = tserve.ServeEngine(TCFG, weights()[1], len(prompts), max_len)
    reqs = [tserve.Request(i, p) for i, p in enumerate(prompts)]
    for i, r in enumerate(reqs):
        eng.admit(r, slot=i)
    for _ in range(gen - 1):
        eng.step()
    return [r.generated for r in reqs]


def test_admit_slot_reuse_zeroes_stale_rows():
    """``test_serve.py::test_admit_slot_reuse_zeroes_stale_rows`` on both
    packages: request B reuses slot 0 after A decoded there; its rows
    past the prompt must be zero, and its tokens equal the reference's."""
    plen, j, k, max_len = 8, 4, 4, 32
    ps = [prompt(1, plen), prompt(2, plen), prompt(3, plen)]

    def scenario(mod, eng, to_prompt):
        a, other = mod.Request(0, to_prompt(ps[0])), mod.Request(1, to_prompt(ps[1]))
        eng.admit(a, slot=0)
        eng.admit(other, slot=1)
        for _ in range(j):
            eng.step()
        a.done = True
        b = mod.Request(2, to_prompt(ps[2]))
        eng.admit(b, slot=0)
        return b

    with pallas_mode.pallas_mode(enabled=False):
        jeng = jserve.ServeEngine(JCFG, weights()[0], 2, max_len)
        jb = scenario(jserve, jeng, jnp.asarray)
        for _ in range(k):
            jeng.step()
    teng = tserve.ServeEngine(TCFG, weights()[1], 2, max_len)
    tb = scenario(tserve, teng, lambda p: p)
    for lc in teng.cache:
        assert not lc["k"][0, plen:].any()
        assert lc["k"][1, plen:plen + j].any()
    for _ in range(k):
        teng.step()
    assert tb.generated == jb.generated


def test_admission_ordering_and_slot_recycling():
    gen, max_len = 6, 32
    prompts = [prompt(1, 8), prompt(2, 8), prompt(3, 8), prompt(1, 8),
               prompt(2, 8)]
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=8)
    assert all(r.done for r in reqs)
    assert [len(r.generated) for r in reqs] == [gen] * 5
    assert eng.state == [0, 0] and not eng.queue
    assert reqs[0].generated == reqs[3].generated
    assert reqs[1].generated == reqs[4].generated
    assert reqs[0].generated != reqs[1].generated
    assert [r.generated for r in reqs] == jax_continuous(
        prompts, gen, max_len, batch=2, chunk=8)


def test_ragged_prefill_interleave_determinism():
    gen, max_len, chunk = 6, 48, 8
    plens = [7, 19, 13]
    prompts = [prompt(i + 10, pl) for i, pl in enumerate(plens)]
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk)
    got = [r.generated for r in reqs]
    assert got == jax_continuous(prompts, gen, max_len, batch=2, chunk=chunk)
    for r, p in zip(got, prompts):
        assert r == port_alternating([p], gen, max_len)[0]
    eng.reset()
    reqs2 = [tserve.Request(i, p) for i, p in enumerate(prompts)]
    for r in reqs2:
        eng.submit(r)
    eng.run()
    assert [r.generated for r in reqs2] == got


@pytest.mark.parametrize("kernels", [False, True])
def test_falcon_ragged_interleave_matches_reference(kernels):
    """Falcon-mamba smoke through the continuous engine: ragged prompts
    make mixed (decode + chunk) ticks; greedy tokens equal the reference
    engine's, on the plain route and with the scan+gate route taken by
    every 8-row chunk (``min_scan_seq=8``)."""
    gen, max_len, chunk = 6, 48, 8
    plens = [7, 19, 13]
    prompts = [prompt(i + 60, pl) for i, pl in enumerate(plens)]
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk,
                                cfgs=FALCON, use_kernels=kernels,
                                kernel_opts=dict(min_scan_seq=8))
    assert eng.ticks_overlap > 0
    assert [r.generated for r in reqs] == jax_continuous(
        prompts, gen, max_len, batch=2, chunk=chunk, cfgs=FALCON)


@pytest.mark.parametrize("kernels", [False, True])
def test_gemma3_ragged_interleave_matches_reference(kernels):
    """gemma3 smoke (7 layers) through the continuous engine with ragged
    prompts longer than the 16-token window, so prefill chunks and
    decode steps both read a cut prefix on the local layers.  Greedy
    tokens equal the reference engine's, on the plain route and with the
    thresholds lowered to 16 on both sides (``test_serve.py:157``), where
    the global layer's 16-row chunks take flash: the port's plain version
    against the Pallas kernel."""
    gen, max_len, chunk = 6, 64, 16
    plens = [40, 23, 33]
    prompts = [prompt(i + 80, pl) for i, pl in enumerate(plens)]
    opts = dict(min_attn_q=16, min_matmul_rows=16)
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk,
                                cfgs=GEMMA3, use_kernels=kernels,
                                kernel_opts=opts)
    assert eng.ticks_overlap > 0
    assert [r.generated for r in reqs] == jax_continuous(
        prompts, gen, max_len, batch=2, chunk=chunk, cfgs=GEMMA3,
        use_pallas=kernels, pallas_opts=opts)


@pytest.mark.parametrize("arch,kernels", [
    ("qwen3_moe_30b_a3b", False), ("qwen3_moe_30b_a3b", True),
    ("llama4_scout_17b_a16e", False), ("llama4_scout_17b_a16e", True),
    # jamba's plain Mamba route is held by the step tests; one engine run
    ("jamba_v0_1_52b", True),
])
def test_moe_ragged_interleave_matches_reference(arch, kernels):
    """The MoE archs at smoke (4 experts; top-2, or top-1 with llama4's
    shared expert; jamba's experts on every other layer of its Mamba/
    attention interleave) through the continuous engine: ragged prompts
    make mixed ticks and ragged last chunks, whose rows are routed
    together with a capacity set by their count (cap 12 for a 16-row
    chunk of qwen3-moe, 4 for its 3-row tail), and decode ticks route
    the inactive slot's row with the active one.  Greedy tokens equal
    the reference engine's, on the plain route and with the thresholds
    lowered to 16 on both sides (``test_serve.py:157``)."""
    gen, max_len, chunk = 6, 64, 16
    plens = [35, 19, 26]
    prompts = [prompt(i + 90, pl) for i, pl in enumerate(plens)]
    opts = dict(min_attn_q=16, min_matmul_rows=16, min_scan_seq=16)
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk,
                                cfgs=MOE[arch], use_kernels=kernels,
                                kernel_opts=opts)
    assert eng.ticks_overlap > 0
    assert [r.generated for r in reqs] == jax_continuous(
        prompts, gen, max_len, batch=2, chunk=chunk, cfgs=MOE[arch],
        use_pallas=kernels, pallas_opts=opts)


@pytest.mark.parametrize("kernels", [False, True])
def test_seamless_ragged_interleave_matches_reference(kernels):
    """The encoder-decoder at smoke through the continuous engine, which
    in both packages runs its decoder alone (the chunk and decode steps
    have no cross attention): ragged prompts make mixed ticks; greedy
    tokens equal the reference engine's, on the plain route and with the
    thresholds lowered to 16 on both sides (``test_serve.py:157``), where
    full chunks take flash and the planned matmul."""
    gen, max_len, chunk = 6, 64, 16
    plens = [35, 19, 26]
    prompts = [prompt(i + 95, pl) for i, pl in enumerate(plens)]
    opts = dict(min_attn_q=16, min_matmul_rows=16)
    eng, reqs = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk,
                                cfgs=SEAMLESS, use_kernels=kernels, kernel_opts=opts)
    assert eng.ticks_overlap > 0
    assert [r.generated for r in reqs] == jax_continuous(
        prompts, gen, max_len, batch=2, chunk=chunk, cfgs=SEAMLESS,
        use_pallas=kernels, pallas_opts=opts)


def test_falcon_slot_reuse_zeroes_recurrent_state():
    """Admission into a reused slot zeroes its conv tail and SSM state
    (left nonzero by the previous occupant) and no other slot's; the
    request then decodes the tokens it gets in a fresh engine."""
    gen, max_len = 4, 48
    eng, _ = port_continuous([prompt(70, 19), prompt(71, 9)], gen, max_len,
                             batch=2, chunk=8, cfgs=FALCON)
    mamba = [lc for lc in eng.cache if "ssm" in lc]
    assert all(lc["ssm"][i].any() and lc["conv"][i].any()
               for lc in mamba for i in (0, 1))
    other = [lc["ssm"][1].clone() for lc in mamba]
    req = tserve.Request(2, prompt(72, 13))
    eng.submit(req)
    eng._admit_free_slots()
    assert eng.slots[0] is req
    for lc, keep in zip(mamba, other):
        assert not lc["ssm"][0].any() and not lc["conv"][0].any()
        assert torch.equal(lc["ssm"][1], keep)
    eng.run()
    _, fresh = port_continuous([prompt(72, 13)], gen, max_len, batch=1,
                               chunk=8, cfgs=FALCON)
    assert req.generated == fresh[0].generated


def test_kernel_routing_parity():
    """Kernel routes (plain versions on the CPU) with thresholds lowered
    to 16 give the tokens of the plain torch path and of the reference;
    the engine's kernel mode does not leak out of its ticks."""
    gen, max_len, chunk = 5, 48, 16
    prompts = [prompt(21, 32), prompt(22, 32)]
    _, plain = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk)
    _, kern = port_continuous(prompts, gen, max_len, batch=2, chunk=chunk,
                              use_kernels=True,
                              kernel_opts=dict(min_attn_q=16,
                                               min_matmul_rows=16))
    assert kernel_mode.mode() == kernel_mode.KernelMode()
    want = jax_continuous(prompts, gen, max_len, batch=2, chunk=chunk)
    assert [r.generated for r in kern] == [r.generated for r in plain] == want


def test_continuous_matches_alternating():
    gen, max_len, plen, batch = 6, 48, 16, 3
    prompts = [prompt(30 + i, plen) for i in range(batch)]
    _, cont = port_continuous(prompts, gen, max_len, batch=batch, chunk=8)
    base = port_alternating(prompts, gen, max_len)
    assert [r.generated for r in cont] == base
    with pallas_mode.pallas_mode(enabled=False):
        jeng = jserve.ServeEngine(JCFG, weights()[0], batch, max_len)
        jreqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(prompts)]
        for i, r in enumerate(jreqs):
            jeng.admit(r, slot=i)
        for _ in range(gen - 1):
            jeng.step()
    assert base == [r.generated for r in jreqs]


def test_sync_mode_reads_tokens_per_tick():
    gen, max_len = 4, 32
    prompts = [prompt(40, 9), prompt(41, 5)]
    _, lazy = port_continuous(prompts, gen, max_len, batch=2, chunk=8)
    _, eager = port_continuous(prompts, gen, max_len, batch=2, chunk=8,
                               sync=True)
    assert [r.generated for r in eager] == [r.generated for r in lazy]
    assert all(len(r.token_times) == gen for r in eager)


def test_eos_stops_a_request_early():
    """``eos`` makes the engine read tokens per tick and retire a request
    at its first eos token, as the reference engine does."""
    gen, max_len = 6, 32
    prompts = [prompt(50, 9), prompt(51, 12)]
    _, full = port_continuous(prompts, gen, max_len, batch=2, chunk=8)
    eos = full[0].generated[2]
    _, cut = port_continuous(prompts, gen, max_len, batch=2, chunk=8, eos=eos)
    got = [r.generated for r in cut]
    assert got[0] == full[0].generated[:full[0].generated.index(eos) + 1]
    assert got == jax_continuous(prompts, gen, max_len, batch=2, chunk=8,
                                 eos=eos)


def test_submit_validation():
    eng = tserve.ContinuousEngine(TCFG, weights()[1], 1, 16, max_new=4)
    with pytest.raises(ValueError, match="exceeds max_len"):
        eng.submit(tserve.Request(0, prompt(1, 16)))
    with pytest.raises(ValueError, match="exceeds token buffer"):
        eng.submit(tserve.Request(1, prompt(1, 4), max_new=12))


def test_page_size_from_plan():
    eng = tserve.ContinuousEngine(TCFG, weights()[1], 1, 64, chunk=16)
    assert eng.page == plan_attention(16, 64, TCFG.hd).tile["kk"]
    assert tserve.ContinuousEngine(TCFG, weights()[1], 1, 64, page=8).page == 8


@pytest.mark.parametrize("arch,device,chunk,refused", [
    ("smoke", "cuda", 32, True),      # head dim 16: no flash kernel on the card
    ("smoke", "cuda", 16, False),     # chunks below min_attn_q never reach it
    ("smoke", "cpu", 32, False),      # the plain version takes every head dim
    ("granite", "cuda", 256, False),  # head dim 64
    ("falcon", "cuda", 256, False),   # no attention layers
    ("gemma3", "cuda", 256, False),   # head dim 256 on its global layers
    ("qwen3_moe", "cuda", 256, False),  # head dim 128
])
def test_kernel_mode_refuses_head_dims_without_a_flash_kernel(arch, device, chunk,
                                                              refused):
    cfg = {"smoke": TCFG, "granite": get_arch("granite_3_2b"),
           "falcon": get_arch("falcon_mamba_7b").smoke(),
           "gemma3": get_arch("gemma3_4b"),
           "qwen3_moe": get_arch("qwen3_moe_30b_a3b")}[arch]
    check = functools.partial(tserve.check_flash_head_dim, cfg, torch.device(device),
                              chunk, kernel_mode.KernelMode().min_attn_q)
    if refused:
        with pytest.raises(ValueError, match="no flash kernel"):
            check()
    else:
        check()


@pytest.mark.parametrize("arch,device,refused", [
    ("smoke", "cuda", True),      # head dim 16: no decode attention kernel on the card
    ("smoke", "cpu", False),      # the plain version takes every head dim
    ("granite", "cuda", False),   # head dim 64
    ("falcon", "cuda", False),    # no attention layers
    ("gemma3", "cuda", False),    # head dim 256
    ("qwen2_vl", "cuda", False),  # head dim 128
])
def test_kernel_mode_refuses_head_dims_without_a_decode_kernel(arch, device, refused):
    cfg = {"smoke": TCFG, "granite": get_arch("granite_3_2b"),
           "falcon": get_arch("falcon_mamba_7b").smoke(),
           "gemma3": get_arch("gemma3_4b"), "qwen2_vl": get_arch("qwen2_vl_7b")}[arch]
    check = functools.partial(tserve.check_decode_head_dim, cfg, torch.device(device))
    if refused:
        with pytest.raises(ValueError, match="no decode attention kernel"):
            check()
    else:
        check()


def test_engine_in_kernel_mode_on_cpu_takes_any_head_dim():
    eng = tserve.ContinuousEngine(TCFG, weights()[1], 1, 64, chunk=32,
                                  use_kernels=True)
    assert eng.chunk == 32


def test_serve_main_runs_on_cpu(capsys):
    tserve.main(["--smoke", "--device", "cpu", "--kernels", "--batch", "2",
                 "--prompt-len", "20", "--gen", "3", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "2 seqs, 6 tokens" in out and "on cpu" in out


def test_serve_main_runs_falcon_on_cpu(capsys):
    tserve.main(["--arch", "falcon_mamba_7b", "--smoke", "--device", "cpu",
                 "--kernels", "--batch", "2", "--prompt-len", "40", "--gen",
                 "3", "--chunk", "32"])
    out = capsys.readouterr().out
    assert "2 kernel plans warmed" in out      # the fused scan at chunk rows 32 and 8
    assert "2 seqs, 6 tokens" in out and "falcon-mamba-7b" in out


def test_serve_main_runs_gemma3_on_cpu(capsys):
    """The README's gemma3 command, with prompts past the smoke window."""
    tserve.main(["--arch", "gemma3_4b", "--smoke", "--device", "cpu", "--kernels",
                 "--batch", "2", "--prompt-len", "40", "--gen", "3", "--chunk", "16"])
    out = capsys.readouterr().out
    assert "2 seqs, 6 tokens" in out and "gemma3-4b" in out


def test_serve_main_runs_qwen3_moe_on_cpu(capsys):
    """The README's qwen3-moe command: 20-token prompts in 16-row chunks
    (the 4-row tails routed with capacity 4) and 2-slot decode."""
    tserve.main(["--arch", "qwen3_moe_30b_a3b", "--smoke", "--device", "cpu",
                 "--kernels", "--batch", "2", "--prompt-len", "20", "--gen", "3",
                 "--chunk", "16"])
    out = capsys.readouterr().out
    assert "2 seqs, 6 tokens" in out and "qwen3-moe-30b-a3b" in out
