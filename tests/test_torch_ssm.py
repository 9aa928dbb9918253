"""The port's Mamba path on the CPU: the scan kernels' plain versions
against the JAX package's Pallas kernels (interpret mode), the SSM layer
against ``repro.model.ssm``, chunked prefill against whole-prompt
prefill, the scan plans against the reference's scheduler, and the CUDA
wrappers' refusal of CPU tensors.

Inputs are made with numpy under a seed, at the shape of
``python -m repro.kernels.bench --smoke`` (1, 64, 128, 8) and its f32
tolerance of 1e-4 (``bench.py:120-154``), plus a ragged 44-row chunk.
Layer weights are the reference's ``init_params`` carried across by
``repro_torch.bridge``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import get_arch as jax_get_arch
from repro.core import akg
from repro.kernels import ops as jops
from repro.model import ssm as JS
from repro.model import transformer as JT
from repro_torch import bridge
from repro_torch import plan as tplan
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import mamba_scan as ms
from repro_torch.kernels import scan_gate as sg
from repro_torch.model import ssm as TS
from repro_torch.model import transformer as TT
from repro_torch.model.kernel_mode import kernel_mode

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)
SMOKE = (1, 64, 128, 8)          # bench.py --smoke scan shape (b, s, di, st)


def scan_inputs(b, s, di, st, seed=0):
    """a in (0, 0.9) as the bench draws it; everything f32 numpy."""
    r = np.random.RandomState(seed)
    f = np.float32
    return dict(
        a=(0.9 / (1 + np.exp(-r.standard_normal((b, s, di, st))))).astype(f),
        b=(0.1 * r.standard_normal((b, s, di, st))).astype(f),
        c=r.standard_normal((b, s, st)).astype(f),
        x=r.standard_normal((b, s, di)).astype(f),
        dk=r.standard_normal((di,)).astype(f),
        z=r.standard_normal((b, s, di)).astype(f),
        h0=(0.5 * r.standard_normal((b, di, st))).astype(f))


def _port(d, names):
    return [torch.from_numpy(d[k]) for k in names]


def _jax(d, names):
    return [jnp.asarray(d[k]) for k in names]


# ---------------------------------------------------------------------------
# kernels' plain versions against the Pallas kernels
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,with_h0", [(64, False), (44, True)])
def test_scan_gate_plain_matches_pallas(seq, with_h0):
    b, _, di, st = SMOKE
    d = scan_inputs(b, seq, di, st, seed=1)
    names = ["a", "b", "c", "x", "dk", "z"]
    h0 = d["h0"] if with_h0 else None
    o_want, h_want = jops.scan_gate(
        *_jax(d, names), h0=None if h0 is None else jnp.asarray(h0),
        interpret=True)
    o_got, h_got = ops.scan_gate(
        *_port(d, names), h0=None if h0 is None else torch.from_numpy(h0))
    assert o_got.dtype == torch.float32 and h_got.dtype == torch.float32
    np.testing.assert_allclose(o_got.numpy(), np.asarray(o_want), **TOL)
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want), **TOL)


def test_scan_gate_chunk_carry():
    """Split in half with the h0 carry: the second half's o and the final
    state equal the whole run's, bit for bit in the port (the sequential
    scan does the same operations) and to 1e-4 against the Pallas kernel
    run whole."""
    d = scan_inputs(*SMOKE, seed=2)
    names = ["a", "b", "c", "x", "dk", "z"]
    a, b_, c, x, dk, z = _port(d, names)
    o_whole, h_whole = ops.scan_gate(a, b_, c, x, dk, z)
    m = SMOKE[1] // 2
    _, h1 = ops.scan_gate(a[:, :m], b_[:, :m], c[:, :m], x[:, :m], dk,
                          z[:, :m])
    o2, h2 = ops.scan_gate(a[:, m:], b_[:, m:], c[:, m:], x[:, m:], dk,
                           z[:, m:], h0=h1)
    assert torch.equal(o2, o_whole[:, m:]) and torch.equal(h2, h_whole)
    o_want, h_want = jops.scan_gate(*_jax(d, names), interpret=True)
    np.testing.assert_allclose(o2.numpy(), np.asarray(o_want)[:, m:], **TOL)
    np.testing.assert_allclose(h2.numpy(), np.asarray(h_want), **TOL)


def test_scan_gate_bf16_skip_and_gate_keep_their_dtype():
    d = scan_inputs(1, 16, 32, 16, seed=3)
    a, b_, c, x, dk, z = _port(d, ["a", "b", "c", "x", "dk", "z"])
    o, h = ops.scan_gate(a, b_, c, x.bfloat16(), dk, z.bfloat16())
    assert o.dtype == torch.bfloat16 and h.dtype == torch.float32
    o32, h32 = ops.scan_gate(a, b_, c, x.bfloat16().float(), dk,
                             z.bfloat16().float())
    assert torch.equal(h, h32)
    assert torch.equal(o, o32.bfloat16())


@pytest.mark.parametrize("seq", [64, 44])
def test_selective_scan_plain_matches_pallas(seq):
    b, _, di, st = SMOKE
    d = scan_inputs(b, seq, di, st, seed=4)
    want = jops.selective_scan(*_jax(d, ["a", "b", "c"]), interpret=True)
    got = ops.selective_scan(*_port(d, ["a", "b", "c"]))
    assert got.dtype == torch.float32 and got.shape == (b, seq, di)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the scan wrappers launch on CUDA or raise, and nothing
    is built or launched for a CPU tensor."""
    a, b_, c, x, dk, z = _port(scan_inputs(1, 8, 32, 8),
                               ["a", "b", "c", "x", "dk", "z"])
    before = (sg.LAUNCHES, ms.LAUNCHES)
    with pytest.raises(ValueError):
        sg.scan_gate(a, b_, c, x, dk, z)
    with pytest.raises(ValueError):
        ms.selective_scan(a, b_, c)
    assert (sg.LAUNCHES, ms.LAUNCHES) == before
    assert build._LIB is None


def test_ops_dispatch_cpu_to_plain_versions():
    d = scan_inputs(1, 8, 32, 8, seed=5)
    a, b_, c, x, dk, z, h0 = _port(d, ["a", "b", "c", "x", "dk", "z", "h0"])
    assert torch.equal(ops.selective_scan(a, b_, c),
                       ref.selective_scan_ref(a, b_, c))
    for got, want in zip(ops.scan_gate(a, b_, c, x, dk, z, h0=h0),
                         ref.scan_gate_ref(a, b_, c, x, dk, z, h0=h0)):
        assert torch.equal(got, want)
    with pytest.raises(ValueError):
        ops.selective_scan(a.to("meta"), b_.to("meta"), c.to("meta"))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seq,di,st", [(256, 8192, 16), (64, 128, 8)])
def test_scan_plans_order_matches_reference_and_fit_hopper(seq, di, st):
    for jplan, tplan_fn in ((akg.plan_scan_gate, tplan.plan_scan_gate),
                            (akg.plan_mamba_scan, tplan.plan_mamba_scan)):
        want, got = jplan(seq, di, st), tplan_fn(seq, di, st)
        assert got.loop_order == want.loop_order
        assert got.vector_iter == want.vector_iter
        t = got.tile
        assert t["n"] == want.tile["n"] == st
        assert t["d"] * st <= tplan.SCAN_THREADS and (t["d"] * st) % 32 == 0
        assert t["t"] == min(seq, 128)


def test_scan_plan_full_width_tiles():
    assert tplan.plan_scan_gate(256, 8192, 16).tile == {"t": 128, "d": 32,
                                                        "n": 16}
    assert tplan.plan_mamba_scan(44, 8192, 16).tile == {"t": 44, "d": 32,
                                                        "n": 16}


# ---------------------------------------------------------------------------
# the SSM layer against repro.model.ssm
# ---------------------------------------------------------------------------

ARCH = "falcon_mamba_7b"


@functools.lru_cache(maxsize=2)
def falcon(dtype="float32"):
    jcfg = jax_get_arch(ARCH).smoke().scaled(dtype=dtype)
    tcfg = get_arch(ARCH).smoke().scaled(dtype=dtype)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    jmix = jax.tree.map(lambda a: a[0], jp["decoder"]["slots"][0]["mixer"])
    return jcfg, tcfg, jp, tp, jmix, tp["layers"][0]["mixer"]


def close(t, j):
    np.testing.assert_allclose(t.float().numpy(), np.asarray(j, np.float32),
                               **TOL)


def _states(tcfg, b, seed):
    r = np.random.RandomState(seed)
    conv = (0.5 * r.standard_normal((b, tcfg.conv_width - 1, tcfg.d_inner))
            ).astype(np.float32)
    ssm = (0.5 * r.standard_normal((b, tcfg.d_inner, tcfg.ssm_state))
           ).astype(np.float32)
    return conv, ssm


@pytest.mark.parametrize("kernels", [False, True])
def test_mamba_matches_reference(kernels):
    jcfg, tcfg, _, _, jmix, tmix = falcon()
    x = np.random.RandomState(6).standard_normal((2, 12, 64)).astype(np.float32)
    want, (jconv, jh) = JS.mamba(jmix, jcfg, jnp.asarray(x), return_state=True)
    with kernel_mode(enabled=kernels, min_scan_seq=8):
        got, (tconv, th) = TS.mamba(tmix, tcfg, torch.from_numpy(x),
                                    return_state=True)
    close(got, want)
    close(tconv, jconv)
    close(th, jh)


@pytest.mark.parametrize("kernels", [False, True])
def test_mamba_chunk_matches_reference(kernels):
    jcfg, tcfg, _, _, jmix, tmix = falcon()
    x = np.random.RandomState(7).standard_normal((1, 9, 64)).astype(np.float32)
    conv, ssm = _states(tcfg, 1, seed=8)
    want = JS.mamba_chunk(jmix, jcfg, jnp.asarray(x), jnp.asarray(conv),
                          jnp.asarray(ssm))
    with kernel_mode(enabled=kernels, min_scan_seq=8):
        got = TS.mamba_chunk(tmix, tcfg, torch.from_numpy(x),
                             torch.from_numpy(conv), torch.from_numpy(ssm))
    for g, w in zip(got, want):
        close(g, w)


def test_mamba_decode_matches_reference():
    jcfg, tcfg, _, _, jmix, tmix = falcon()
    x = np.random.RandomState(9).standard_normal((3, 1, 64)).astype(np.float32)
    conv, ssm = _states(tcfg, 3, seed=10)
    want = JS.mamba_decode(jmix, jcfg, jnp.asarray(x), jnp.asarray(conv),
                           jnp.asarray(ssm))
    got = TS.mamba_decode(tmix, tcfg, torch.from_numpy(x),
                          torch.from_numpy(conv), torch.from_numpy(ssm))
    for g, w in zip(got, want):
        close(g, w)


def test_softplus_is_jax_softplus():
    x = np.linspace(-40, 40, 161).astype(np.float32)
    np.testing.assert_allclose(TS.softplus(torch.from_numpy(x)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-6)


def test_mamba_chunked_prefill_state_carry():
    """``tests/test_serve.py::test_mamba_chunked_prefill_state_carry`` on
    the port: chunked prefill (8 + 8 rows) of falcon-mamba smoke in bf16
    equals whole-prompt prefill bit for bit on the plain route, and the
    kernel route (plain version on the CPU) stays within the reference's
    bf16 tolerance of it."""
    tcfg = get_arch(ARCH).smoke()
    params = TT.init_params(tcfg, seed=1, device="cpu")
    toks = torch.from_numpy(np.random.RandomState(2).randint(
        2, tcfg.vocab, size=(1, 16))).long()
    full, _ = TT.prefill(params, tcfg, toks)

    def chunked(enabled):
        cache = TT.init_cache(tcfg, 1, 32, "cpu")
        with kernel_mode(enabled=enabled, min_scan_seq=8):
            _, cache = TT.chunk_step(params, tcfg, toks[:, :8], cache, 0, 32)
            lg, _ = TT.chunk_step(params, tcfg, toks[:, 8:], cache, 8, 32)
        return lg[:, -1]

    assert torch.equal(chunked(False), full)
    torch.testing.assert_close(chunked(True).float(), full.float(),
                               rtol=0.02, atol=0.02)
