"""Batched serving launcher: continuous batching over the planned kernels.

    PYTHONPATH=src python -m repro_torch.launch.serve \
        [--arch granite_3_2b|falcon_mamba_7b|gemma3_4b|qwen3_moe_30b_a3b|...] \
        [--batch 4 --prompt-len 16 --gen 12 --chunk 16] [--kernels] \
        [--smoke] [--device cuda|cpu]

Ports ``src/repro/launch/serve.py``.  Full width on ``cuda`` is the
default; ``--smoke`` opts in to the reduced config and ``--device cpu``
to the CPU, where the kernels' plain versions run.

* :class:`ServeEngine` — the alternating baseline: whole-prompt prefill
  into a slot, then lock-step decode of every slot at a shared
  ``max(lengths)`` cache length.
  It refuses an encoder-decoder, whose prefill needs encoder input.  A
  vlm's prefill takes no vision stub, as in the reference, and its
  decode steps run at M-RoPE positions (L, L, L).
* :class:`ContinuousEngine` — per-request FIFO admission into free
  slots (each zeroed first), prompt prefill in fixed-size chunks
  interleaved with decode ticks, ragged per-slot cache lengths and paged
  KV — a tick reads only the page-aligned used prefix of the cache, the
  page size from ``plan_attention``'s kk tile.  The decode state (last
  token, lengths, generated-token buffer) lives on the device; the host
  keeps exact mirrors of lengths and counters, so admission and
  retirement never read the device, and a request's tokens are read once,
  when it retires.  With ``use_kernels=True`` the layers route through
  the Hopper kernels (see :mod:`repro_torch.model.kernel_mode`).  As in
  the reference, its steps have no cross attention: an encoder-decoder
  (seamless-m4t) is served as its decoder alone; and they pass no M-RoPE
  positions: the vlm (qwen2-vl) is served with plain rope.

The reference jit-compiles each decode tick and each prefill-chunk tick
into one dispatch, with the cache and state donated, and fuses up to 16
steady-state decode steps into one ``lax.scan`` dispatch
(``_decode_k``).  Here, on ``cuda``, every tick is the replay of
captured CUDA graphs, each captured at its key's first use into one
shared memory pool:

* a decode tick replays a graph of :meth:`ContinuousEngine._decode_step`,
  one per kv bucket (the only shape that varies between decode ticks;
  one graph in all for a model without attention layers).  Pure decode
  ticks, the decode half of a mixed tick and each of the k steps of the
  steady-state path replay it; ``_decode_k`` replays it k times with no
  host read between the replays;
* a chunk tick replays a graph of :meth:`ContinuousEngine._chunk_step`,
  one per (chunk length, kv bucket), the reference's jit keys (a model
  without attention layers reads no kv bound: one per chunk length).
  The chunk's offset, slot and last flag are device scalars and its
  tokens a fixed buffer, all written in place before the replay, so one
  graph serves every chunk position of every slot; the flash kernel
  reads the offset and slot from the device.  A mixed tick is the decode
  graph's replay and then the chunk graph's, on one stream.

Every state and cache tensor is written in place and indexed by device
scalars, so a graph's captured addresses stay valid across ticks.  A
replay adds the kernel launches its capture recorded to the wrappers'
counts.  ``ContinuousEngine(..., cuda_graphs=False)`` runs every tick as
eager ops of the same bodies, the CPU's only path.
"""
from __future__ import annotations

import argparse
import time
from collections import deque
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Deque, Dict, List, Optional, Tuple

import torch

from ..configs.registry import get_arch
from ..model import transformer as T
from ..model.kernel_mode import KernelMode, kernel_mode
from ..model.layers import device_of, make_generator
from ..plan import ATTN_HEAD_DIMS, plan_attention, plan_matmul, plan_scan_gate


@dataclass
class Request:
    rid: int
    prompt: torch.Tensor           # (1, plen) token ids
    generated: List[int] = field(default_factory=list)
    done: bool = False
    max_new: int = 0               # 0 = engine default
    t_submit: float = 0.0
    t_first: float = 0.0           # first generated token (prefill done)
    token_times: List[float] = field(default_factory=list)


def _tokens(x, device: torch.device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.long, device=device)


class ServeEngine:
    """Fixed-batch decode engine with greedy sampling (alternating
    prefill/decode baseline).

    Its prefill passes no ``enc_frontend``, so the reference's fails on an
    encoder-decoder (``None @ frontend_proj``); this one refuses such an
    arch when it is made.  :class:`ContinuousEngine` serves its decoder."""

    def __init__(self, cfg, params, batch: int, max_len: int):
        if cfg.enc_layers:
            raise ValueError(f"{cfg.name} is an encoder-decoder: the alternating engine's "
                             "prefill has no encoder input; serve it with ContinuousEngine, "
                             "which runs the decoder alone")
        self.cfg, self.params = cfg, params
        self.device = params["embed"].device
        self.batch, self.max_len = batch, max_len
        self.cache = T.init_cache(cfg, batch, max_len, self.device)
        self.tokens = torch.zeros((batch, 1), dtype=torch.long,
                                  device=self.device)
        self.lengths = [0] * batch
        self.slots: List[Optional[Request]] = [None] * batch

    def admit(self, req: Request, slot: int):
        req.prompt = _tokens(req.prompt, self.device)
        logits, pre = T.prefill(self.params, self.cfg, req.prompt)
        # zero the slot's rows first (reused-slot hygiene: a shorter new
        # prompt must not expose the previous occupant's KV rows through
        # the shared max(lengths) decode mask), then merge
        T.merge_cache_slot(T.zero_cache_slot(self.cache, slot), pre, slot)
        self.slots[slot] = req
        self.lengths[slot] = req.prompt.shape[1]
        nxt = int(torch.argmax(logits[0]))
        req.generated.append(nxt)
        self.tokens[slot, 0] = nxt

    def step(self):
        n = max(self.lengths)
        logits, self.cache = T.decode_step(self.params, self.cfg, self.tokens,
                                           self.cache, n)
        nxt = torch.argmax(logits, -1)
        self.tokens = nxt[:, None]
        host = nxt.tolist()
        for i, req in enumerate(self.slots):
            if req is not None and not req.done:
                req.generated.append(host[i])
                self.lengths[i] += 1


FREE, PREFILL, DECODE = 0, 1, 2


class CapturedTick:
    """A captured CUDA graph of one tick body and the kernel launches its
    capture recorded.  A replay makes no Python call, so it adds those
    launches to the wrappers' counts itself."""

    def __init__(self, graph, launches: Dict[str, int]):
        self.graph, self.launches = graph, launches
        self.replays = 0

    def replay(self) -> None:
        from ..kernels import add_launches

        self.graph.replay()
        add_launches(self.launches)
        self.replays += 1


class ContinuousEngine:
    """Continuous-batching engine: per-request admission, chunked
    prefill interleaved with decode ticks, ragged paged KV.

    ``eos``-triggered stopping and ``sync=True`` (per-token latency
    measurement) read the new tokens once per tick; otherwise the loop
    reads the device only when a request retires.  ``cuda_graphs``
    (default: on when the engine is on ``cuda``) replays each decode and
    chunk tick from a captured graph; asking for graphs on the CPU
    raises."""

    def __init__(self, cfg, params, batch: int, max_len: int, *,
                 chunk: int = 16, page: Optional[int] = None,
                 use_kernels: bool = False, max_new: int = 16,
                 eos: Optional[int] = None, sync: bool = False,
                 kernel_opts: Optional[Dict] = None,
                 cuda_graphs: Optional[bool] = None):
        self.cfg, self.params = cfg, params
        self.device = dev = params["embed"].device
        self.batch, self.max_len = batch, max_len
        self.chunk, self.max_new, self.eos = chunk, max_new, eos
        self.sync = sync or eos is not None
        self.cuda_graphs = dev.type == "cuda" if cuda_graphs is None else cuda_graphs
        # kernel_opts: extra KernelMode fields (threshold overrides for
        # small-shape parity tests; see model/kernel_mode.py)
        self._mode_kw = dict(enabled=use_kernels, **(kernel_opts or {}))
        if use_kernels:
            check_flash_head_dim(cfg, dev, chunk, KernelMode(**self._mode_kw).min_attn_q)
        # paged-KV geometry from the plan: the attention plan's kk tile
        # is the unit the flash kernel streams, so pages align with
        # kernel tiles
        plan = plan_attention(max(chunk, 8), max_len, cfg.hd)
        self.page = page or max(min(plan.tile["kk"], max_len), 8)

        self.cache = T.init_cache(cfg, batch, max_len, dev)
        # device-resident decode state, every tensor written in place so
        # that a captured graph's addresses stay valid
        self.toks = torch.zeros((batch, 1), dtype=torch.long, device=dev)
        self.lens = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.buf = torch.zeros((batch, max_new), dtype=torch.long, device=dev)
        self.pos = torch.zeros((batch,), dtype=torch.long, device=dev)
        # the last decode tick's next tokens and logits
        self.nxt = torch.zeros((batch,), dtype=torch.long, device=dev)
        self.logits = torch.zeros((batch, cfg.vocab), dtype=params["embed"].dtype,
                                  device=dev)
        self._rows = torch.arange(batch, device=dev)
        self.lengths = [0] * batch          # host mirror of lens
        self.gen_count = [0] * batch        # host mirror of pos
        self.state = [FREE] * batch
        self.slots: List[Optional[Request]] = [None] * batch
        self.prefill_pos = [0] * batch
        self.queue: Deque[Request] = deque()
        self._active = torch.zeros((batch,), dtype=torch.bool, device=dev)
        # the chunk tick's inputs, written in place before each tick: its
        # tokens (the first c of a fixed buffer), offset, slot and last
        # flag; and the logits of its last row
        self._ctoks = torch.zeros((1, chunk), dtype=torch.long, device=dev)
        self._coff = torch.zeros((), dtype=torch.int32, device=dev)
        self._cslot = torch.zeros((), dtype=torch.int32, device=dev)
        self._clast = torch.zeros((), dtype=torch.bool, device=dev)
        self.chunk_logits = torch.zeros((cfg.vocab,), dtype=params["embed"].dtype,
                                        device=dev)
        # graphs, all in one memory pool: decode graphs by kv bucket and
        # chunk graphs by (c, kv bucket); a model without attention layers
        # reads no kv bound, so its keys have kv 0
        self.graphs: Dict[int, CapturedTick] = {}
        self.chunk_graphs: Dict[Tuple[int, int], CapturedTick] = {}
        self._attends = any(spec.mixer == "attn" for spec in T.layer_specs(cfg))
        self.capture_seconds = 0.0
        self.chunk_capture_seconds = 0.0
        self._pool = None
        self._capture_stream = None
        # tick accounting for the prefill/decode overlap ratio
        self.ticks = self.ticks_decode = self.ticks_prefill = 0
        self.ticks_overlap = 0

    @property
    def cuda_graphs(self) -> bool:
        return self._cuda_graphs

    @cuda_graphs.setter
    def cuda_graphs(self, on: bool):
        if on and self.device.type != "cuda":
            raise ValueError(f"CUDA graphs need an engine on cuda, not {self.device}; "
                             "pass cuda_graphs=False or leave it unset")
        self._cuda_graphs = on

    # -- device-side tick bodies ---------------------------------------------
    def _decode_step(self, kv: int) -> None:
        """One decode tick as device ops, every write in place: the body
        of the reference's jitted ``_decode_tick`` and of each graph."""
        act = self._active
        # the cache is written in place
        logits, _ = T.serve_decode_step(
            self.params, self.cfg, self.toks, self.cache, self.lens, act, kv)
        nxt = torch.argmax(logits, -1)                               # (b,)
        self.logits.copy_(logits)
        self.nxt.copy_(nxt)
        self.toks.copy_(torch.where(act[:, None], nxt[:, None], self.toks))
        at = self.pos.clamp(max=self.buf.shape[1] - 1)
        self.buf[self._rows, at] = torch.where(act, nxt, self.buf[self._rows, at])
        self.lens.add_(act)
        self.pos.add_(act)

    def _decode_tick(self, kv: int) -> torch.Tensor:
        """One decode tick: with graphs, a replay of kv bucket ``kv``'s
        graph (captured at its first use), else eager ops.  Returns the
        next-token buffer."""
        if not self.cuda_graphs:
            self._decode_step(kv)
            return self.nxt
        key = kv if self._attends else 0
        graph = self.graphs.get(key)
        if graph is None:
            graph = self.graphs[key] = self._capture(kv)
        graph.replay()
        return self.nxt

    def _decode_k(self, kv: int, k: int) -> None:
        """The reference's ``_decode_k``: k decode ticks at one kv bound,
        with no host read between them."""
        for _ in range(k):
            self._decode_tick(kv)

    def _chunk_step(self, c: int, kv: int) -> None:
        """One prefill-chunk tick as device ops, every write in place: the
        body of the reference's jitted ``_chunk_tick`` and of each chunk
        graph.  The chunk is ``_ctoks[:, :c]`` at offset ``_coff`` of slot
        ``_cslot``, all on the device; the cache is read and written at
        that row in place, and the slot's length, and on its last chunk
        its first token, set by selects against the slot."""
        off, slot = self._coff, self._cslot
        sub = T.cache_slot_view(self.cache, slot)
        logits, sub = T.chunk_step(self.params, self.cfg, self._ctoks[:, :c], sub,
                                   off, kv)
        T.cache_slot_write(self.cache, sub, slot)
        sl = self._rows == slot
        self.lens.copy_(torch.where(sl, off + c, self.lens))
        # final chunk: its last-position logits seed decoding
        last = logits[0, -1]
        ctok = torch.argmax(last)
        fin = sl & self._clast
        self.toks.copy_(torch.where(fin[:, None], ctok, self.toks))
        self.buf[:, 0] = torch.where(fin, ctok, self.buf[:, 0])
        self.pos.copy_(torch.where(fin, 1, self.pos))
        self.chunk_logits.copy_(last)

    def _chunk_tick(self, toks: torch.Tensor, off: int, slot: int, last: bool,
                    kv: int) -> None:
        """One chunk tick: its tokens, offset, slot and last flag written
        to the device, then with graphs a replay of the (c, kv) graph
        (captured at its first use), else eager ops."""
        c = toks.shape[1]
        self._ctoks[:, :c].copy_(toks)
        self._coff.fill_(off)
        self._cslot.fill_(slot)
        self._clast.fill_(last)
        if not self.cuda_graphs:
            self._chunk_step(c, kv)
            return
        key = (c, kv if self._attends else 0)
        graph = self.chunk_graphs.get(key)
        if graph is None:
            graph = self.chunk_graphs[key] = self._capture(kv, c)
        graph.replay()

    def _mixed_tick(self, toks, off, slot, last, kv_d, kv_p) -> torch.Tensor:
        # overlap tick: decode every active slot AND land one prefill
        # chunk, with no host read between the two.  Decode runs first:
        # its garbage write into the prefilling slot (row = that slot's
        # current length) is overwritten by the chunk that follows.
        nxt = self._decode_tick(kv_d)
        self._chunk_tick(toks, off, slot, last, kv_p)
        return nxt

    def _step(self, kv: int, c: Optional[int]) -> None:
        """The tick body a graph captures: the chunk tick of c rows at kv
        bucket ``kv``, or with ``c`` None the decode tick."""
        if c is None:
            self._decode_step(kv)
        else:
            self._chunk_step(c, kv)

    def _decode_state(self) -> List[torch.Tensor]:
        """What a tick advances: last tokens, lengths, token buffer,
        positions, and every Mamba layer's conv tail and SSM state.  The
        KV rows it writes are rows that the real tick writes again, with
        the same values (a chunk's rows), or that a slot's next tick
        writes before reading them (a decode row at the slot's length)."""
        return [self.toks, self.lens, self.buf, self.pos] + [
            lc[name] for lc in self.cache if "ssm" in lc for name in ("conv", "ssm")]

    @contextmanager
    def _state_kept(self):
        """Put the decode state back as it was on entry when the block
        exits."""
        saved = [t.clone() for t in self._decode_state()]
        try:
            yield
        finally:
            for t, old in zip(self._decode_state(), saved):
                t.copy_(old)

    def _warm_up(self, kv: int, c: Optional[int] = None) -> None:
        """The eager tick that precedes a capture (decode, or with ``c``
        a chunk of c rows), with the state put back after it, so that its
        advance is not engine progress.  On the card it runs in sync debug
        mode "error": a host sync inside the tick raises."""
        with self._state_kept():
            if self.device.type != "cuda":
                self._step(kv, c)
                return
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                self._step(kv, c)
            finally:
                torch.cuda.set_sync_debug_mode(prev)

    @contextmanager
    def _side_stream(self):
        """Run the block on the engine's capture stream, which waits for
        the current one and which the current one waits for after it.
        One stream serves every capture: PyTorch keeps a cuBLAS workspace
        (32 MiB on Hopper) for each stream that runs a product, for the
        life of the process."""
        dev = self.device
        if self._capture_stream is None:
            self._capture_stream = torch.cuda.Stream(dev)
        stream = self._capture_stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream):
            yield
        torch.cuda.current_stream(dev).wait_stream(stream)

    def _record(self, kv: int, c: Optional[int]):
        """Capture the tick body on the current stream into the shared
        pool."""
        if self._pool is None:
            self._pool = torch.cuda.graph_pool_handle()
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph, pool=self._pool,
                              stream=torch.cuda.current_stream(self.device)):
            self._step(kv, c)
        return graph

    def _capture(self, kv: int, c: Optional[int] = None) -> CapturedTick:
        """Capture one tick at kv bound ``kv`` (decode, or with ``c`` a
        chunk of c rows) after a warm-up tick, both on a side stream.
        Neither advances the wrappers' launch counts: the capture's
        launches are recorded and added at every replay.  A decode capture
        raises if a hand-written kernel launched: none runs in a decode
        tick."""
        from ..kernels import add_launches, launch_counts

        t0 = time.perf_counter()
        before = launch_counts()
        with self._side_stream():
            self._warm_up(kv, c)
            warm = launch_counts()
            graph = self._record(kv, c)
        after = launch_counts()
        add_launches({k: before[k] - n for k, n in after.items()})
        if c is None and after != before:
            raise RuntimeError(f"a hand-written kernel launched while the decode tick at "
                               f"kv {kv} was captured ({before} -> {after})")
        dt = time.perf_counter() - t0
        self.capture_seconds += dt
        if c is not None:
            self.chunk_capture_seconds += dt
        return CapturedTick(graph, {k: n - warm[k] for k, n in after.items()})

    def graph_pool_bytes(self) -> int:
        """Device bytes held by the graphs' shared pool."""
        if self._pool is None:
            return 0
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg["segment_pool_id"]) == tuple(self._pool))

    # -- admission -------------------------------------------------------
    def submit(self, req: Request):
        req.prompt = _tokens(req.prompt, self.device)
        plen = req.prompt.shape[1]
        if plen + (req.max_new or self.max_new) > self.max_len:
            raise ValueError(f"request {req.rid} exceeds max_len")
        if (req.max_new or self.max_new) > self.buf.shape[1]:
            raise ValueError(f"request {req.rid} exceeds token buffer")
        req.t_submit = req.t_submit or time.time()
        self.queue.append(req)

    def _set_state(self, i: int, st: int):
        self.state[i] = st
        # in place: the decode graphs read this buffer
        self._active[i].fill_(st == DECODE)

    def _admit_free_slots(self):
        for i in range(self.batch):
            if not self.queue:
                return
            if self.state[i] == FREE:
                req = self.queue.popleft()
                # reused-slot hygiene: drop every cache row the previous
                # occupant wrote before the new request's chunks land
                T.zero_cache_slot(self.cache, i)
                self.lens[i] = 0
                self.pos[i] = 0
                self.slots[i] = req
                self._set_state(i, PREFILL)
                self.prefill_pos[i] = 0
                self.lengths[i] = 0
                self.gen_count[i] = 0

    def _bucket(self, need: int) -> int:
        return min(-(-need // self.page) * self.page, self.max_len)

    # -- one engine tick -------------------------------------------------
    def tick(self) -> bool:
        """Run one engine iteration; returns True if any work was done."""
        with kernel_mode(**self._mode_kw):
            return self._tick()

    def _tick(self) -> bool:
        self._admit_free_slots()
        decoding = [i for i in range(self.batch) if self.state[i] == DECODE]
        prefilling = [i for i in range(self.batch)
                      if self.state[i] == PREFILL]
        if not decoding and not prefilling:
            return False
        self.ticks += 1
        nxt_dev = None

        if decoding and not prefilling and not self.queue and not self.sync:
            # steady state: every slot is decoding and nothing is waiting,
            # so run up to 16 greedy steps back to back.  Safe because
            # retirement is count-based host bookkeeping: the earliest any
            # slot can retire is min remaining-budget steps away, and a
            # roomier kv bucket only adds exact-zero masked rows.
            rem = min((self.slots[i].max_new or self.max_new)
                      - self.gen_count[i] for i in decoding)
            k = min(rem, 16)
            k = 1 << (k.bit_length() - 1)
            if k > 1:
                kv = self._bucket(max(self.lengths[i] for i in decoding) + k)
                self._decode_k(kv, k)
                self.ticks += k - 1
                self.ticks_decode += k
                for i in decoding:
                    self.lengths[i] += k
                    self.gen_count[i] += k
                    self._maybe_retire(i)
                return True

        kv_d = (self._bucket(max(self.lengths[i] for i in decoding) + 1)
                if decoding else 0)
        ci = prefilling[0] if prefilling else None
        if ci is not None:
            req = self.slots[ci]
            off = self.prefill_pos[ci]
            c = min(self.chunk, req.prompt.shape[1] - off)
            toks = req.prompt[:, off:off + c]
            kv_p = self._bucket(off + c)
            last = off + c == req.prompt.shape[1]

        if decoding and ci is not None:
            nxt_dev = self._mixed_tick(toks, off, ci, last, kv_d, kv_p)
            self.ticks_decode += 1
            self.ticks_prefill += 1
            self.ticks_overlap += 1
        elif decoding:
            nxt_dev = self._decode_tick(kv_d)
            self.ticks_decode += 1
        else:
            self._chunk_tick(toks, off, ci, last, kv_p)
            self.ticks_prefill += 1

        if decoding:
            for i in decoding:
                self.lengths[i] += 1
                self.gen_count[i] += 1
        if ci is not None:
            self.prefill_pos[ci] = off + c
            self.lengths[ci] = off + c
            if last:
                self._set_state(ci, DECODE)
                self.gen_count[ci] = 1

        if self.sync:
            # per-token observation: one fetch per tick (EOS stopping /
            # latency measurement)
            nxt = nxt_dev.tolist() if nxt_dev is not None else None
            now = time.time()
            for i in decoding:
                req = self.slots[i]
                req.generated.append(nxt[i])
                req.token_times.append(now)
            if ci is not None and self.state[ci] == DECODE \
                    and self.gen_count[ci] == 1:
                req = self.slots[ci]
                req.t_first = now
                req.generated.append(int(self.toks[ci, 0]))
                req.token_times.append(now)

        for i in range(self.batch):
            if self.state[i] == DECODE:
                self._maybe_retire(i)
        return True

    def _maybe_retire(self, i: int):
        req = self.slots[i]
        limit = req.max_new or self.max_new
        if self.gen_count[i] >= limit or \
                (self.eos is not None and req.generated
                 and req.generated[-1] == self.eos):
            if not self.sync:
                # one blocking read per request: its finished token row
                req.generated = self.buf[i, :self.gen_count[i]].tolist()
            req.done = True
            self._set_state(i, FREE)
            self.lengths[i] = 0

    def run(self) -> int:
        """Tick until the queue and all slots drain; returns tick count."""
        n = 0
        while self.tick():
            n += 1
        return n

    def reset(self):
        """Back to the post-init state, zeroing in place, so the captured
        graphs stay valid and are kept."""
        for lc in self.cache:
            for t in lc.values():
                t.zero_()
        for t in (self.toks, self.lens, self.buf, self.pos, self.nxt,
                  self.logits, self._active, self._ctoks, self._coff, self._cslot,
                  self._clast, self.chunk_logits):
            t.zero_()
        b = self.batch
        self.lengths = [0] * b
        self.gen_count = [0] * b
        self.state = [FREE] * b
        self.slots = [None] * b
        self.prefill_pos = [0] * b
        self.queue.clear()
        self.ticks = self.ticks_decode = self.ticks_prefill = 0
        self.ticks_overlap = 0

    def overlap_ratio(self) -> float:
        busy = max(self.ticks_decode + self.ticks_prefill
                   - self.ticks_overlap, 1)
        return self.ticks_overlap / busy


def check_flash_head_dim(cfg, device: torch.device, chunk: int, min_attn_q: int) -> None:
    """Kernel mode on the card sends prefill chunks of ``min_attn_q`` rows
    or more to the flash kernel, which is built for the head dims in
    ``ATTN_HEAD_DIMS`` only: refuse any other when the engine is made,
    not at its first such chunk.  On the CPU the kernels' plain versions
    run at every head dim."""
    attends = any(cfg.is_attn_layer(i) for i in range(cfg.n_layers))
    if (device.type == "cuda" and attends and chunk >= min_attn_q
            and cfg.hd not in ATTN_HEAD_DIMS):
        raise ValueError(f"{cfg.name}: head dim {cfg.hd} has no flash kernel (built for "
                         f"{ATTN_HEAD_DIMS}); serve with --chunk below {min_attn_q}, "
                         f"without --kernels, or on the CPU")


def kernel_plan_shapes(cfg, max_len: int, chunk: int = 16, rows=()) -> list:
    """``(planner, args)`` of every kernel plan serving ``cfg`` makes:
    the reference's warm set (the MLP at ``d_model`` rows, attention over
    the whole cache and the chunk over it, the fused scan at the chunk)
    and, for every chunk row count in ``chunk`` and ``rows`` (the ragged
    chunks the traffic sends), the MLP's two matmul shapes, the chunk's
    attention over the cache and its fused scan.  Only the kernels of the
    model's decoder layers are planned: no matmul without a dense MLP
    layer, no attention without an attention layer, no scan without a
    Mamba layer."""
    rows = sorted({max(chunk, 8), *(r for r in rows if r > 0)})
    specs = T.layer_specs(cfg)
    shapes = []
    if any(spec.ffn == "mlp" for spec in specs):
        shapes.append(("matmul", (cfg.d_model, cfg.d_ff, cfg.d_model)))
        for r in rows:
            shapes += [("matmul", (r, cfg.d_ff, cfg.d_model)),
                       ("matmul", (r, cfg.d_model, cfg.d_ff))]
    if any(spec.mixer == "attn" for spec in specs):
        shapes.append(("attention", (max_len, max_len, cfg.hd)))
        shapes += [("attention", (r, max_len, cfg.hd)) for r in rows]
    if any(spec.mixer == "mamba" for spec in specs):
        shapes += [("scan_gate", (r, cfg.d_inner, cfg.ssm_state)) for r in rows]
    return shapes


PLANNERS = {"matmul": plan_matmul, "attention": plan_attention,
            "scan_gate": plan_scan_gate}


def warm_kernel_plans(cfg, max_len: int, chunk: int = 16, rows=()) -> list:
    """Plan the serving kernels up front, at :func:`kernel_plan_shapes`,
    so no tick of the traffic schedules a kernel: through a schedd daemon
    when ``$POLYTOPS_TORCH_SCHEDD_SOCK`` names one (so N serving processes
    amortize one scheduler) and in-process otherwise — ``akg``'s remote
    hook makes the same call total either way.  Prints the daemon
    client's ``remote_ok`` and ``fallbacks`` of this call (a plan already
    in the process's memo asks nobody) and the degraded plans; returns
    the plans."""
    from ..core.schedclient import maybe_client

    client = maybe_client()
    before = client.stats.as_dict() if client is not None else None
    plans = [PLANNERS[name](*args)
             for name, args in kernel_plan_shapes(cfg, max_len, chunk, rows)]
    degraded = sum(1 for p in plans if p.degraded)
    if client is not None:
        st = {k: v - before[k] for k, v in client.stats.as_dict().items()}
        via = (f"via schedd ({client.sock_path}, "
               f"remote_ok={st['remote_ok']} fallbacks={st['fallbacks']})")
    else:
        via = "in-process"
    print(f"serve: {len(plans)} kernel plans warmed {via}"
          + (f", {degraded} degraded" if degraded else ""))
    return plans


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite_3_2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=12)
    ap.add_argument("--engine", choices=("alternating", "continuous"),
                    default="continuous")
    ap.add_argument("--chunk", type=int, default=16)
    ap.add_argument("--kernels", action="store_true",
                    help="route through the Hopper kernels (plain versions "
                         "on the CPU)")
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config instead of full width")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    dev = device_of(args.device)
    cfg = get_arch(args.arch)
    if args.smoke:
        cfg = cfg.smoke()
    max_len = args.prompt_len + args.gen + 1
    warm_kernel_plans(cfg, max_len, args.chunk, rows=(args.prompt_len % args.chunk,))
    params = T.init_params(cfg, seed=args.seed, device=dev)
    gen = make_generator(args.seed + 1, dev)
    prompts = [torch.randint(2, cfg.vocab, (1, args.prompt_len),
                             generator=gen, device=dev)
               for _ in range(args.batch)]
    t0 = time.perf_counter()
    if args.engine == "alternating":
        eng = ServeEngine(cfg, params, args.batch, max_len)
        for i, prompt in enumerate(prompts):
            eng.admit(Request(i, prompt), slot=i)
        for _ in range(args.gen - 1):
            eng.step()
        reqs = [r for r in eng.slots if r is not None]
    else:
        ceng = ContinuousEngine(cfg, params, args.batch, max_len,
                                chunk=args.chunk, use_kernels=args.kernels,
                                max_new=args.gen)
        reqs = [Request(i, p) for i, p in enumerate(prompts)]
        for r in reqs:
            ceng.submit(r)
        ceng.run()
        print(f"overlap ratio: {ceng.overlap_ratio():.2f}, page={ceng.page}")
        if ceng.cuda_graphs:
            print(f"graphs: {len(ceng.graphs)} decode, {len(ceng.chunk_graphs)} chunk, "
                  f"captured in {ceng.capture_seconds:.2f} s, pool "
                  f"{ceng.graph_pool_bytes() / 2**20:.1f} MiB")
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    dt = time.perf_counter() - t0
    ntok = sum(len(r.generated) for r in reqs)
    where = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    print(f"{len(reqs)} seqs, {ntok} tokens in {dt:.2f}s "
          f"({ntok / max(dt, 1e-9):.1f} tok/s on {where}, {cfg.name}, "
          f"{args.engine})")
    for req in reqs:
        print(f"req{req.rid}: {req.generated[:10]}")


if __name__ == "__main__":
    main()
