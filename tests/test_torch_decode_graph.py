"""The port's decode tick made capturable as a CUDA graph, on the CPU.

On ``cuda`` the port's ``ContinuousEngine`` replays a captured graph of
its decode tick (``_decode_step``) for every pure decode tick, the
decode half of every mixed tick and every step of the k-step path, the
reference's jitted ``_decode_tick`` and ``_decode_k``.  A graph replays
fixed addresses, so the tick must write every state and cache tensor in
place, and the warm-up tick that precedes a capture must leave no trace.
These tests hold that on the CPU, where the engine runs the same tick
as eager ops: on granite, falcon-mamba and qwen3-moe smoke and gemma3
smoke at 7 layers, with the reference's f32 weights carried across by
``repro_torch.bridge``, greedy tokens equal to the reference engine's.

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

torch.set_num_threads(1)

PAGE = 16


def _cfgs(arch: str, **kw):
    return (jax_get_arch(arch).smoke().scaled(dtype="float32", **kw),
            get_arch(arch).smoke().scaled(dtype="float32", **kw))


# gemma3 at 7 layers: a global layer (5) between local ones
ARCHS = {"granite_3_2b": _cfgs("granite_3_2b"),
         "falcon_mamba_7b": _cfgs("falcon_mamba_7b"),
         "gemma3_4b": _cfgs("gemma3_4b", n_layers=7),
         "qwen3_moe_30b_a3b": _cfgs("qwen3_moe_30b_a3b")}


@functools.lru_cache(maxsize=4)
def weights(arch: str):
    jcfg, tcfg = ARCHS[arch]
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def prompts(arch: str, seed: int, plens):
    vocab = ARCHS[arch][1].vocab
    return [np.random.RandomState(seed + i).randint(2, vocab, size=(1, n)).astype(np.int32)
            for i, n in enumerate(plens)]


def jax_tokens(arch, ps, gen, max_len, batch, chunk):
    """The reference engine's greedy tokens."""
    jcfg = ARCHS[arch][0]
    with pallas_mode.pallas_mode(enabled=False):
        eng = jserve.ContinuousEngine(jcfg, weights(arch)[0], batch, max_len,
                                      chunk=chunk, max_new=gen, page=PAGE)
        reqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(ps)]
        for r in reqs:
            eng.submit(r)
        eng.run()
    return [r.generated for r in reqs]


def port_engine(arch, batch, max_len, gen, chunk, **kw):
    return tserve.ContinuousEngine(ARCHS[arch][1], weights(arch)[1], batch, max_len,
                                   chunk=chunk, max_new=gen, page=PAGE, **kw)


def serve(eng, ps):
    reqs = [tserve.Request(i, p) for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    n = eng.run()
    return n, [r.generated for r in reqs]


def storage(eng):
    """Every tensor a decode graph reads or writes, by address."""
    tensors = [eng.toks, eng.lens, eng.pos, eng.buf, eng._active, eng.nxt, eng.logits]
    tensors += [t for lc in eng.cache for t in lc.values()]
    return [t.data_ptr() for t in tensors]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_state_keeps_its_storage(arch):
    """A served run with a queue (slot reuse, admission zeroing,
    retirement), mixed ticks and k-step decode, then ``reset`` and a
    second run: no state or cache tensor, Mamba conv and SSM states
    included, changes its storage, and the tokens are the reference's."""
    gen, max_len, chunk = 6, 64, 8
    ps = prompts(arch, 200, [19, 7, 13])
    eng = port_engine(arch, 2, max_len, gen, chunk)
    before = storage(eng)
    if arch == "falcon_mamba_7b":
        assert sum("ssm" in lc for lc in eng.cache) == ARCHS[arch][1].n_layers
    _, got = serve(eng, ps)
    assert eng.ticks_overlap > 0
    assert storage(eng) == before
    eng.reset()
    assert storage(eng) == before
    assert not eng._active.any() and not eng.lens.any()
    _, again = serve(eng, ps)
    assert storage(eng) == before
    assert got == again == jax_tokens(arch, ps, gen, max_len, 2, chunk)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_fused_decode_path_matches_reference(arch):
    """4 requests on 4 slots and no queue: once every prompt is in, the
    engine takes the k-step path (``_decode_k``), so it counts more
    decode ticks than ``run()`` iterations.  Greedy tokens equal the
    reference engine's, whose path there is its fused ``lax.scan``."""
    gen, max_len, chunk = 12, 64, 8
    ps = prompts(arch, 300, [9, 14, 11, 16])
    eng = port_engine(arch, 4, max_len, gen, chunk)
    calls = []
    eng._decode_k = lambda kv, k, f=eng._decode_k: (calls.append(k), f(kv, k))
    n, got = serve(eng, ps)
    assert calls and all(k > 1 for k in calls)
    assert eng.ticks_decode > n
    assert [len(t) for t in got] == [gen] * 4
    assert got == jax_tokens(arch, ps, gen, max_len, 4, chunk)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_warm_up_leaves_no_trace(arch):
    """The capture routine's warm-up (an eager tick inside the
    snapshot-and-restore of the decode state) run before every decode
    tick, mixed and k-step ticks included, changes no token: the state
    comes back bit for bit, and the KV rows it wrote are written again
    before they are read."""
    gen, max_len, chunk = 8, 64, 8
    ps = prompts(arch, 400, [19, 7, 13, 10])
    want = serve(port_engine(arch, 2, max_len, gen, chunk), ps)[1]

    eng = port_engine(arch, 2, max_len, gen, chunk)
    warmed = []

    def tick(kv, f=eng._decode_tick):
        state = [t.clone() for t in eng._decode_state()]
        eng._warm_up(kv)
        assert all(torch.equal(a, b) for a, b in zip(eng._decode_state(), state))
        warmed.append(kv)
        return f(kv)
    eng._decode_tick = tick
    _, got = serve(eng, ps)
    assert len(warmed) == eng.ticks_decode
    assert got == want == jax_tokens(arch, ps, gen, max_len, 2, chunk)


def test_graphs_are_refused_on_the_cpu():
    """Graphs are the default on cuda only; asking for them on the CPU
    raises, at construction or later."""
    eng = port_engine("granite_3_2b", 1, 32, 4, 8)
    assert eng.cuda_graphs is False
    with pytest.raises(ValueError, match="CUDA graphs need an engine on cuda"):
        port_engine("granite_3_2b", 1, 32, 4, 8, cuda_graphs=True)
    with pytest.raises(ValueError, match="CUDA graphs need an engine on cuda"):
        eng.cuda_graphs = True
    assert eng.cuda_graphs is False and not eng.graphs
    assert eng.graph_pool_bytes() == 0

