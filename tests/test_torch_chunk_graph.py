"""The port's chunk tick made capturable as a CUDA graph, on the CPU.

On ``cuda`` the port's ``ContinuousEngine`` replays a captured graph of
its chunk tick (``_chunk_step``) for every prefill chunk, one graph per
(chunk length, kv bucket), the keys of the reference's jitted
``_chunk_tick`` and ``_mixed_tick``.  The chunk's offset, slot and last
flag are device scalars written before each replay, so the body indexes
the cache by device values only and never reads one on the host.  These
tests hold that body on the CPU, where the engine runs it as eager ops:

* tick by tick against the reference engine's jitted ``_chunk`` /
  ``_mixed`` (caches, lengths, tokens, buffers, positions and the chunk's
  last-row logits at 1e-4 in f32) on granite, falcon-mamba, gemma3 past
  its window, qwen3-moe, jamba and seamless-m4t (its decoder alone, as
  both engines serve it) smoke, with the kernel routes (plain
  versions; thresholds lowered to 16 as at ``tests/test_serve.py:157``)
  and without;
* bit for bit against the int-offset, int-slot path of the same modules;
* with a stand-in for the card's graphs (a "replay" reruns the body with
  the device scalars of the moment): one key serves several offsets and
  slots, the tokens are the eager run's, and no tensor the body writes
  changes its storage;
* under ``FakeTensorMode``, where a host read of a device value raises:
  the CPU's stand-in for the card's warm-up in sync debug mode "error".

Also: the flash kernel's plain version with a device ``q_offset`` and
``kv_row`` against the Pallas kernel (interpret mode) at the shapes of
``python -m repro.kernels.bench --smoke``; the split-K scratch that
kernel A hands a graph (its own, never a stream's); and a capture's launch
accounting (a replay adds what its capture recorded, a warm-up nothing).

The JAX engines run inside ``pallas_mode.pallas_mode(...)`` so the
process-wide mode is restored for whatever test runs next in this worker.
"""
from __future__ import annotations

import functools
from contextlib import nullcontext

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           FakeTensorMode)

from repro.configs.registry import get_arch as jax_get_arch
from repro.kernels import ops as jops
from repro.launch import serve as jserve
from repro.model import pallas_mode
from repro.model import transformer as JT
from repro_torch import bridge, kernels
from repro_torch.configs.registry import get_arch
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_polytops as mm
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve as tserve
from repro_torch.model import transformer as T
from repro_torch.model.kernel_mode import kernel_mode

torch.set_num_threads(1)

PAGE = 16
TOL = dict(rtol=1e-4, atol=1e-4)
# the kernel routes at smoke sizes (test_serve.py:157)
OPTS = dict(min_attn_q=16, min_matmul_rows=16, min_scan_seq=16)


def _cfgs(arch: str, **kw):
    return (jax_get_arch(arch).smoke().scaled(dtype="float32", **kw),
            get_arch(arch).smoke().scaled(dtype="float32", **kw))


# gemma3 at 7 layers: a global layer (5) between local ones, 16-token window
ARCHS = {"granite_3_2b": _cfgs("granite_3_2b"),
         "falcon_mamba_7b": _cfgs("falcon_mamba_7b"),
         "gemma3_4b": _cfgs("gemma3_4b", n_layers=7),
         "qwen3_moe_30b_a3b": _cfgs("qwen3_moe_30b_a3b"),
         "jamba_v0_1_52b": _cfgs("jamba_v0_1_52b"),
         # the decoder alone: the engines' steps have no cross attention
         "seamless_m4t_large_v2": _cfgs("seamless_m4t_large_v2")}


@functools.lru_cache(maxsize=6)
def weights(arch: str):
    jcfg, tcfg = ARCHS[arch]
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")


def prompts(arch: str, seed: int, plens):
    vocab = ARCHS[arch][1].vocab
    return [np.random.RandomState(seed + i).randint(2, vocab, size=(1, n)).astype(np.int32)
            for i, n in enumerate(plens)]


def port_engine(arch, batch, max_len, gen, chunk, page=PAGE, **kw):
    return tserve.ContinuousEngine(ARCHS[arch][1], weights(arch)[1], batch, max_len,
                                   chunk=chunk, max_new=gen, page=page, **kw)


def serve(eng, ps):
    reqs = [tserve.Request(i, p) for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    eng.run()
    return [r.generated for r in reqs]


class FakeGraph:
    """The card's graph as the CPU can have it: a replay runs the
    captured body again, reading the device scalars of the moment."""

    def __init__(self, eng, kv, c):
        self.eng, self.kv, self.c = eng, kv, c

    def replay(self):
        self.eng._step(self.kv, self.c)


def fake_graphs(eng, monkeypatch):
    """Turn on ``eng``'s graph path with :class:`FakeGraph` captures (a
    capture itself runs nothing; its warm-up runs as on the card)."""
    monkeypatch.setattr(eng, "_side_stream", nullcontext)
    monkeypatch.setattr(eng, "_record", lambda kv, c: FakeGraph(eng, kv, c))
    eng._cuda_graphs = True
    return eng


def written(eng):
    """Every tensor a tick reads or writes, by address."""
    tensors = [eng.toks, eng.lens, eng.pos, eng.buf, eng._active, eng.nxt, eng.logits,
               eng._ctoks, eng._coff, eng._cslot, eng._clast, eng.chunk_logits]
    tensors += [t for lc in eng.cache for t in lc.values()]
    return [t.data_ptr() for t in tensors]


# ---------------------------------------------------------------------------
# against the reference's jitted chunk and mixed ticks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_chunk_ticks_match_reference_tick_by_tick(arch, kernels_on):
    """Both engines serve ragged prompts (chunk ticks, mixed ticks with
    ragged tails past gemma3's 16-token window, decode ticks) in lock
    step.  After every tick the port's whole cache, its lengths, tokens,
    token buffer and positions equal the reference's (caches at 1e-4,
    integers exactly), and after every tick that landed a chunk its
    last-row logits equal the reference's ``chunk_step`` logits."""
    jcfg, tcfg = ARCHS[arch]
    jp, tp = weights(arch)
    gen, max_len, chunk = 4, 64, 16
    ps = prompts(arch, 500, [35, 19, 26])
    opts = OPTS if kernels_on else {}
    ref_logits = jax.jit(
        lambda p, toks, c, off, slot, kv: JT.chunk_step(
            p, jcfg, toks, JT.cache_slot_view(c, slot), off, kv)[0][0, -1],
        static_argnames="kv")
    want_logits = []
    with pallas_mode.pallas_mode(enabled=False):
        jeng = jserve.ContinuousEngine(jcfg, jp, 2, max_len, chunk=chunk, max_new=gen,
                                       page=PAGE, use_pallas=kernels_on, pallas_opts=opts)
        chunk_j, mixed_j = jeng._chunk, jeng._mixed

        def chunk_tick(p, toks, c, dev, off, slot, last, kv):
            want_logits.append(ref_logits(p, toks, c, off, slot, kv=kv))
            return chunk_j(p, toks, c, dev, off, slot, last, kv)

        def mixed_tick(p, toks, c, dev, act, off, slot, last, kv_d, kv_p):
            # the decode half's write into the prefilling slot lands on a
            # row the chunk overwrites before it attends
            want_logits.append(ref_logits(p, toks, c, off, slot, kv=kv_p))
            return mixed_j(p, toks, c, dev, act, off, slot, last, kv_d, kv_p)
        jeng._chunk, jeng._mixed = chunk_tick, mixed_tick
        teng = tserve.ContinuousEngine(tcfg, tp, 2, max_len, chunk=chunk, max_new=gen,
                                       page=PAGE, use_kernels=kernels_on, kernel_opts=opts)
        jreqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(ps)]
        treqs = [tserve.Request(i, p) for i, p in enumerate(ps)]
        for jr, tr in zip(jreqs, treqs):
            jeng.submit(jr)
            teng.submit(tr)
        ticks = chunks = 0
        while True:
            busy = jeng.tick()
            assert teng.tick() == busy
            if not busy:
                break
            ticks += 1
            want = jax.tree.map(np.asarray, jeng.cache)
            got = bridge.cache_to_numpy(teng.cache, tcfg)
            jax.tree.map(lambda w, g: np.testing.assert_allclose(g, w, **TOL), want, got)
            for w, g in zip(jeng.dev, (teng.toks, teng.lens, teng.buf, teng.pos)):
                np.testing.assert_array_equal(g.numpy(), np.asarray(w))
            if len(want_logits) > chunks:
                chunks = len(want_logits)
                np.testing.assert_allclose(teng.chunk_logits.numpy(),
                                           np.asarray(want_logits[-1]), **TOL)
    assert chunks == teng.ticks_prefill == 7 and teng.ticks_overlap > 0
    assert [r.generated for r in treqs] == [r.generated for r in jreqs]


# ---------------------------------------------------------------------------
# the device-index body against the int-offset path
# ---------------------------------------------------------------------------

def random_state(eng, seed: int):
    """Fill every cache tensor with seeded values, and the decode state
    with plausible integers."""
    rs = np.random.RandomState(seed)
    for lc in eng.cache:
        for t in lc.values():
            t.copy_(torch.from_numpy(rs.standard_normal(t.shape).astype(np.float32)))
    eng.toks.copy_(torch.from_numpy(rs.randint(2, 50, size=eng.toks.shape)))
    eng.lens.copy_(torch.tensor([40, 24, 9]))
    eng.pos.copy_(torch.tensor([3, 0, 1]))


def int_path_tick(eng, cache, state, toks, off: int, slot: int, last: bool, kv: int):
    """The chunk tick as the port ran it with Python ints: the slot's
    rows as a view, the offset sliced, the state written by index."""
    sub = T.cache_slot_view(cache, slot)
    logits, sub = T.chunk_step(eng.params, eng.cfg, toks, sub, off, kv)
    T.cache_slot_write(cache, sub, slot)
    tok, lens, buf, pos = state
    lens[slot] = off + toks.shape[1]
    if last:
        ctok = torch.argmax(logits[0, -1])
        tok[slot, 0] = ctok
        buf[slot, 0] = ctok
        pos[slot] = 1
    return logits[0, -1]


@pytest.mark.parametrize("kernels_on", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_device_index_body_equals_int_path(arch, kernels_on):
    """Chunks of 16 and 7 rows at offsets 24 and 33 of slot 1 (of 3), the
    second the last: the device-index body gives the int-offset path's
    cache, state and logits bit for bit."""
    eng = port_engine(arch, 3, 64, 4, 16, use_kernels=kernels_on, kernel_opts=OPTS)
    random_state(eng, 7)
    cache = [{n: t.clone() for n, t in lc.items()} for lc in eng.cache]
    state = [t.clone() for t in (eng.toks, eng.lens, eng.buf, eng.pos)]
    toks = torch.from_numpy(prompts(arch, 600, [23])[0]).long()
    with kernel_mode(**eng._mode_kw):
        for off, c, last in ((24, 16, False), (40, 7, True)):
            want = int_path_tick(eng, cache, state, toks[:, off - 24:off - 24 + c], off, 1,
                                 last, eng._bucket(off + c))
            eng._chunk_tick(toks[:, off - 24:off - 24 + c], off, 1, last,
                            eng._bucket(off + c))
            assert torch.equal(eng.chunk_logits, want)
    for lc, wc in zip(eng.cache, cache):
        for name, t in lc.items():
            assert torch.equal(t, wc[name]), name
    for t, w in zip((eng.toks, eng.lens, eng.buf, eng.pos), state):
        assert torch.equal(t, w)
    assert eng.lens[1] == 47 and eng.pos[1] == 1


# ---------------------------------------------------------------------------
# the graph path on the CPU, with FakeGraph
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite_3_2b", "falcon_mamba_7b"])
def test_one_key_serves_many_offsets_and_slots(arch, monkeypatch):
    """Chunk 16, page 128: every full chunk of every prompt is one key,
    (16, 128) — (16, 0) for falcon, which reads no kv bound — captured
    once and replayed at offsets 0, 16 and 32 of both slots; the ragged
    tails are keys of their own.  The tokens are the eager engine's and
    the reference's."""
    gen, max_len = 4, 128
    ps = prompts(arch, 700, [40, 37, 50])
    want = serve(port_engine(arch, 2, max_len, gen, 16, page=128), ps)
    eng = fake_graphs(port_engine(arch, 2, max_len, gen, 16, page=128), monkeypatch)
    seen = []
    chunk_step = eng._chunk_step

    def spy(c, kv):
        seen.append((c, kv, int(eng._coff), int(eng._cslot)))
        chunk_step(c, kv)
    monkeypatch.setattr(eng, "_chunk_step", spy)
    assert serve(eng, ps) == want
    kv = 128 if arch == "granite_3_2b" else 0
    assert sorted(eng.chunk_graphs) == [(2, kv), (5, kv), (8, kv), (16, kv)]
    full = eng.chunk_graphs[(16, kv)]
    assert full.replays == 7
    # the warm-up ran each key once; every replay ran the same body
    replayed = [(off, slot) for c, _, off, slot in seen if c == 16][1:]
    assert {off for off, _ in replayed} == {0, 16, 32}
    assert {slot for _, slot in replayed} == {0, 1}
    with pallas_mode.pallas_mode(enabled=False):
        jeng = jserve.ContinuousEngine(ARCHS[arch][0], weights(arch)[0], 2, max_len,
                                       chunk=16, max_new=gen, page=128)
        jreqs = [jserve.Request(i, jnp.asarray(p)) for i, p in enumerate(ps)]
        for r in jreqs:
            jeng.submit(r)
        jeng.run()
    assert want == [r.generated for r in jreqs]


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tick_writes_keep_their_storage(arch, monkeypatch):
    """A served run through the graph path (chunk, mixed and k-step
    ticks, slot reuse), then ``reset`` and a second run: no tensor a
    tick reads or writes changes its storage — the chunk's token buffer,
    offset, slot, last flag and logits, every state and cache tensor —
    and the second run's tokens are the first's."""
    ps = prompts(arch, 800, [19, 7, 13])
    eng = fake_graphs(port_engine(arch, 2, 64, 6, 8), monkeypatch)
    before = written(eng)
    got = serve(eng, ps)
    assert eng.ticks_overlap > 0 and eng.chunk_graphs and eng.graphs
    assert written(eng) == before
    eng.reset()
    assert written(eng) == before
    assert serve(eng, ps) == got
    assert written(eng) == before


# ---------------------------------------------------------------------------
# no host read of a device value inside the body
# ---------------------------------------------------------------------------

def test_fake_tensor_mode_catches_a_host_read():
    """The harness below: a body that reads a device value on the host
    raises under it."""
    eng = port_engine("granite_3_2b", 2, 32, 4, 8)
    with FakeTensorMode(allow_non_fake_inputs=True):
        with pytest.raises(DataDependentOutputException):
            eng.lens[int(eng._cslot)].fill_(1)
        with pytest.raises(DataDependentOutputException):
            bool(eng._clast)


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tick_bodies_read_no_device_value(arch):
    """The chunk body (16 rows and a 5-row tail, kernel routes on with
    their thresholds lowered) and the decode body run under
    ``FakeTensorMode``, where ``.item()``, ``int()``, ``bool()`` or
    ``.tolist()`` of a tensor raise; the engine's real tensors keep their
    values."""
    eng = port_engine(arch, 2, 64, 4, 16, use_kernels=True, kernel_opts=OPTS)
    eng.lens.copy_(torch.tensor([20, 5]))
    eng._ctoks.copy_(torch.from_numpy(np.random.RandomState(9).randint(2, 50, size=(1, 16))))
    eng._coff.fill_(16)
    eng._cslot.fill_(1)
    eng._clast.fill_(True)
    saved = [t.clone() for t in eng._decode_state()]
    with kernel_mode(**eng._mode_kw), FakeTensorMode(allow_non_fake_inputs=True):
        eng._chunk_step(16, 32)
        eng._chunk_step(5, 48)
        eng._decode_step(32)
    assert all(torch.equal(t, s) for t, s in zip(eng._decode_state(), saved))


# ---------------------------------------------------------------------------
# kernel B's plain version with device scalars
# ---------------------------------------------------------------------------

def _flash_inputs(b, sq, sk, h, hkv, d, seed):
    rs = np.random.RandomState(seed)
    return ((rs.standard_normal((b, sq, h, d)) * 0.3).astype(np.float32),
            (rs.standard_normal((b, sk, hkv, d)) * 0.3).astype(np.float32),
            rs.standard_normal((b, sk, hkv, d)).astype(np.float32))


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,q_offset", [
    (1, 128, 128, 2, 2, 64, 0),      # bench.py --smoke flash case
    (1, 32, 128, 2, 2, 64, 64),      # prefill chunk at offset 64, page-bound kv
    (2, 16, 48, 4, 2, 16, 16),       # smoke serving chunk, GQA, offset
    (1, 64, 128, 2, 1, 256, 64),     # head dim 256 (gemma3), GQA, offset
])
def test_flash_plain_with_device_offset_matches_pallas(b, sq, sk, h, hkv, d, q_offset):
    """``flash_attention_ref`` with ``q_offset`` a 0-d int32 tensor equals
    the Pallas kernel (interpret mode) at 1e-4, and so does the same q
    against a batched cache whose rows from ``kv_row`` (a 0-d tensor)
    hold k and v; ``ops.flash_attention`` routes both to it on the CPU."""
    q, k, v = _flash_inputs(b, sq, sk, h, hkv, d, seed=11)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, q_offset=jnp.int32(q_offset), interpret=True)
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    off = torch.tensor(q_offset, dtype=torch.int32)
    got = ref.flash_attention_ref(tq, tk, tv, causal=True, q_offset=off)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    kc, vc = (torch.zeros((b + 3,) + t.shape[1:]) for t in (tk, tv))
    kc[2:2 + b], vc[2:2 + b] = tk, tv
    row = torch.tensor(2, dtype=torch.int32)
    assert torch.equal(ref.flash_attention_ref(tq, kc, vc, q_offset=off, kv_row=row), got)
    assert torch.equal(ops.flash_attention(tq, kc, vc, q_offset=off, kv_row=row), got)
    assert torch.equal(ops.flash_attention(tq, kc, vc, q_offset=q_offset, kv_row=2), got)


def test_flash_descriptor_checks_ints_and_devices():
    """Python ints are checked on the host (a device scalar cannot be);
    a scalar on another device than q is refused."""
    cpu = torch.device("cpu")
    assert fa.descriptor(5, 2, cpu).tolist() == [5, 2]
    assert fa.descriptor(5, 2, cpu) is fa.descriptor(5, 2, cpu)
    assert fa.descriptor(torch.tensor(7, dtype=torch.int32), 0, cpu).tolist() == [7, 0]
    assert fa.descriptor(3, torch.tensor(1), cpu).tolist() == [3, 1]
    assert fa.descriptor(torch.tensor(3), torch.tensor(1), cpu).dtype == torch.int32
    with pytest.raises(ValueError, match=">= 0"):
        fa.descriptor(-1, 0, cpu)
    with pytest.raises(ValueError, match="must lie on"):
        fa.descriptor(torch.tensor(3, device="meta"), 0, cpu)


# ---------------------------------------------------------------------------
# kernel A's split-K scratch and the capture's launch accounting
# ---------------------------------------------------------------------------

def test_captured_split_scratch_is_the_graphs_own(monkeypatch):
    """A launch being captured into a graph gets split-K scratch of its
    own (zeroed tickets), never the stream's, so a later regrow of the
    stream's scratch cannot free memory a graph replays; the stream's
    scratch is reused while it is large enough and regrown after."""
    monkeypatch.setattr(mm, "_SCRATCH", {})
    cpu = torch.device("cpu")
    ws, tickets = mm._split_scratch(cpu, 7, 64, 8)
    assert mm._split_scratch(cpu, 7, 32, 8)[0] is ws
    for _ in range(2):
        cws, ctickets = mm._split_scratch(cpu, 7, 64, 8, capturing=True)
        assert cws is not ws and ctickets is not tickets
        assert cws.numel() == 64 and ctickets.numel() == 8 and not ctickets.any()
    assert mm._SCRATCH == {(None, 7): (ws, tickets)}
    ws2, tickets2 = mm._split_scratch(cpu, 7, 4096, 2048)
    assert ws2 is not ws and ws2.numel() >= 4096 and tickets2.numel() >= 2048
    assert not tickets2.any() and mm._SCRATCH[(None, 7)][0] is ws2


class NullGraph:
    def replay(self):
        pass


def test_replay_adds_the_captured_launches_and_warm_up_adds_none(monkeypatch):
    """A chunk body that launches two flash kernels and one matmul (a
    stand-in on the CPU): its capture's warm-up and the capture itself
    leave every count as it was; the graph records {flash 2, matmul 1}
    and each replay adds that.  A decode capture during which a kernel
    launched raises."""
    for mod in (fa, mm):
        monkeypatch.setattr(mod, "LAUNCHES", 0)
    eng = port_engine("granite_3_2b", 2, 32, 4, 8)
    monkeypatch.setattr(eng, "_side_stream", nullcontext)

    def record(kv, c):
        with eng._state_kept():
            eng._step(kv, c)           # a capture runs the Python body once
        return NullGraph()
    monkeypatch.setattr(eng, "_record", record)
    chunk_step, decode_step = eng._chunk_step, eng._decode_step

    def launching_chunk(c, kv):
        fa.LAUNCHES += 2
        mm.LAUNCHES += 1
        chunk_step(c, kv)
    monkeypatch.setattr(eng, "_chunk_step", launching_chunk)
    fa.LAUNCHES = 5
    before = kernels.launch_counts()
    graph = eng._capture(16, 8)
    assert kernels.launch_counts() == before
    assert graph.launches == {"matmul": 1, "flash_attention": 2, "scan_gate": 0,
                              "selective_scan": 0}
    graph.replay()
    graph.replay()
    assert kernels.launch_counts() == dict(before, matmul=2, flash_attention=9)
    assert graph.replays == 2 and eng.chunk_capture_seconds > 0

    def launching_decode(kv):
        fa.LAUNCHES += 1
        decode_step(kv)
    monkeypatch.setattr(eng, "_decode_step", launching_decode)
    with pytest.raises(RuntimeError, match="launched while the decode tick"):
        eng._capture(16)
