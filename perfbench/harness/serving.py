"""The serving driver: the port's ``ContinuousEngine`` on the card, set up
from the cell's configuration and mix, warmed, then driven through
``submit`` and ``tick`` alone for the window.  The harness stamps every
token on its own monotonic clock after the tick that produced it (the
engine runs with ``sync=True``, so each tick returns once its tokens are
on the host), and times each request from the moment it was due: its
arrival in an open loop, its client's previous completion in a closed one.

Set-up: the weights from the seed, the engine, the kernel plans of every
row count the traffic and the warm-up send (timed as ``plan_s``), then
the warm-up traffic of :mod:`.warmup`, then ``reset()``, which keeps the
graphs.  A ramp of ``ramp_s`` seconds of the mix's own traffic leads into
the window, so the window opens on a loaded server; it counts neither as
set-up nor as window."""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional

from . import traffic, warmup, weights
from .cell import Cell, arch_config
from .trace import Slice, span


@dataclass
class Live:
    spec: traffic.Spec
    req: Any
    due: float
    sub: float
    client: int = -1
    times: List[float] = field(default_factory=list)
    done_t: Optional[float] = None


def graph_keys(eng) -> int:
    return len(eng.graphs) + len(eng.chunk_graphs)


def warm(eng, first: List[int], rest: List[int], seed: int, device, log) -> None:
    """Serve the warm-up prompts (:func:`warmup.prompts`), each with two new
    tokens, their tokens discarded, and ``reset()``.  The decode-bucket
    prompts after a probe, only if the probe made a decode graph."""
    import torch
    from repro_torch.launch.serve import Request

    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.torch_seed(seed, 19))

    def serve(plens):
        for i, p in enumerate(sorted(plens, reverse=True)):
            eng.submit(Request(-1 - i, torch.randint(2, eng.cfg.vocab, (1, p), generator=gen,
                                                     device=device), max_new=2))
        eng.run()

    serve(first)
    sent = list(first)
    if rest:
        before = len(eng.graphs)
        serve(rest[:1])
        sent += rest[:1]
        if len(eng.graphs) > before:
            serve(rest[1:])
            sent += rest[1:]
    eng.reset()
    log(f"warm-up: {len(sent)} requests of 2 new tokens, prompts {sorted(sent)}; graphs "
        f"{len(eng.graphs)} decode, {len(eng.chunk_graphs)} chunk, captured in "
        f"{eng.capture_seconds:.3f} s")


class Server:
    """The engine of a cell with its weights, traffic and warmed graphs."""

    def __init__(self, cell: Cell, seed: int, device, t0: float, log):
        import torch
        from repro_torch.launch.serve import ContinuousEngine, warm_kernel_plans

        self.cell, self.device, self.log = cell, device, log
        mix, cfg = cell.mix, cell.config
        arch = arch_config(cfg)
        self.params = weights.make(cfg, seed, device)
        log(f"{cfg['port']['name']}: {sum(t.numel() for t in weights.leaves(self.params)) / 1e9:.3f}"
            f" B parameters")
        self.eng = ContinuousEngine(arch, self.params, mix["slots"], mix["max_len"],
                                    chunk=mix["chunk"], use_kernels=True,
                                    max_new=mix["output"]["max"], sync=True)
        self.draw_traffic(seed)
        tables = traffic.Tables(mix)
        first, rest = warmup.prompts(mix, tables, self.eng.page)
        rows = sorted({p % mix["chunk"] for p in tables.prompt + first + rest} - {0})
        tp = time.perf_counter()
        warm_kernel_plans(arch, mix["max_len"], mix["chunk"], rows=rows)
        self.plan_s = time.perf_counter() - tp
        warm(self.eng, first, rest, seed, device, log)
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        self.setup_s = time.perf_counter() - t0

    def draw_traffic(self, seed: int) -> None:
        self.specs = traffic.sequence(self.cell.mix, seed)
        self.toks = traffic.tokens(self.specs, self.cell.config["vocab_size"], seed,
                                   self.device)

    def reseed(self, seed: int) -> None:
        """Another seed's weights, drawn into the same tensors (the graphs
        keep their addresses), and its traffic."""
        import torch
        fresh = weights.make(self.cell.config, seed, self.device)
        with torch.no_grad():
            for a, b in zip(weights.leaves(self.params), weights.leaves(fresh)):
                a.copy_(b)
        del fresh
        self.draw_traffic(seed)
        self.eng.reset()

    def close(self) -> None:
        import torch
        self.eng.cache = self.eng.graphs = self.eng.chunk_graphs = None
        self.eng = None
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def drive(self, seconds: float, trace: bool = False) -> Dict[str, Any]:
        """The ramp and the window, and with ``trace`` a traced slice of
        ``trace_s`` seconds after it: returns the run's record."""
        import torch
        from repro_torch.launch.serve import Request

        eng, specs, toks, device = self.eng, self.specs, self.toks, self.device
        mix = self.cell.mix
        closed = mix["loop"] == "closed"
        ramp, trace_s = mix["ramp_s"], mix["trace_s"]
        live: List[Live] = []
        done: List[Live] = []
        nxt = 0
        ticks: List[tuple] = []            # (start, end, captured a graph, chunks)
        traced: List[tuple] = []           # the same, of the traced slice
        tslice = Slice(device) if trace else None

        def submit(due: float, client: int = -1) -> None:
            nonlocal nxt
            i = nxt % len(specs)
            req = Request(nxt, toks[i], max_new=specs[i].new)
            with span("submit"):
                eng.submit(req)
            live.append(Live(specs[i], req, due, time.perf_counter(), client))
            nxt += 1

        span_s = specs[-1].at

        def due_at(i: int) -> float:
            """Request i's arrival, the sequence repeated past its end."""
            return start + specs[i % len(specs)].at + (i // len(specs)) * span_s

        def progress():
            pos = getattr(eng, "prefill_pos", None)
            return list(pos) if pos is not None else None

        start = time.perf_counter()
        w0, w1 = start + ramp, start + ramp + seconds
        if closed:
            for c in range(mix["clients"]):
                submit(start, c)
        keys = graph_keys(eng)
        snap = None                        # the engine's counters when the window opens

        def loop(until: float, tracing: bool) -> None:
            """Tick, submit as due and stamp tokens until ``until``."""
            nonlocal keys, snap
            while True:
                now = time.perf_counter()
                if now >= until:
                    return
                if snap is None and now >= w0:
                    snap = counters(eng)
                if not closed:
                    while due_at(nxt) <= now:
                        submit(due_at(nxt))
                pre = progress()
                with span("tick"):
                    worked = eng.tick()
                t = time.perf_counter()
                k = graph_keys(eng)
                cap, keys = k != keys, k
                if tracing:
                    tslice.tick_captured.append(cap)
                if not worked:
                    if not closed:
                        with span("wait"):
                            time.sleep(max(0.0, min(due_at(nxt), until) - time.perf_counter()))
                    continue
                chunks = prefill_chunks(pre, progress())
                (traced if tracing else ticks).append((now, t, cap, chunks))
                with span("stamp"):
                    finished = []
                    for lv in live:
                        n = len(lv.req.generated)
                        if n > len(lv.times):
                            lv.times += [t] * (n - len(lv.times))
                        if lv.req.done:
                            lv.done_t = t
                            finished.append(lv)
                    for lv in finished:
                        live.remove(lv)
                        done.append(lv)
                        if closed:
                            submit(t, lv.client)

        loop(w1, False)
        at_close = counters(eng)
        if tslice is not None:
            # the profiler slows what runs after its first start, so the
            # traced slice follows the window, on the same traffic
            tslice.prime()
            tslice.start()
            loop(time.perf_counter() + trace_s, True)
            tslice.stop()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        return {
            "kind": "serve", "at_open": snap or at_close, "at_close": at_close,
            "setup_s": self.setup_s, "plan_s": self.plan_s,
            "window": (w0, w1),
            "requests": done + live, "done": done, "ticks": ticks, "trace_ticks": traced,
            "graphs": (len(eng.graphs), len(eng.chunk_graphs)),
            "pool_bytes": eng.graph_pool_bytes() if device.type == "cuda" else 0,
            "memory_peak_bytes": (torch.cuda.max_memory_allocated(device)
                                  if device.type == "cuda" else 0),
            "wrapped": nxt > len(specs), "config": self.cell.config, "mix": mix,
            # requests due in the window; none fails (a refused submit raises)
            "attempted": sum(1 for lv in done + live if w0 <= lv.due <= w1), "failed": 0,
            "params": self.params,
            "trace": tslice.reduce() if tslice is not None and tslice.tick_captured else None,
        }


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, log
        ) -> Dict[str, Any]:
    """One run: set-up, the ramp and the window; the engine is freed before
    the record goes to the check."""
    srv = Server(cell, seed, device, t0, log)
    rec = srv.drive(seconds, trace)
    srv.close()
    return rec


def prefill_chunks(before, after) -> Optional[List[tuple]]:
    """The prompt rows a tick prefilled, as (offset, rows) per slot, from the
    engine's per-slot prefill positions before and after it (a position
    that fell was a new request admitted into the slot: it counts from 0);
    None where the engine has no such positions."""
    if before is None or after is None:
        return None
    out = []
    for b, a in zip(before, after):
        b = b if a >= b else 0
        if a > b:
            out.append((b, a - b))
    return out


def counters(eng) -> Dict[str, float]:
    """The engine's own counters (see ``ContinuousEngine``)."""
    return {"ticks": eng.ticks, "ticks_decode": eng.ticks_decode,
            "ticks_prefill": eng.ticks_prefill, "ticks_overlap": eng.ticks_overlap,
            "capture_s": eng.capture_seconds, "chunk_capture_s": eng.chunk_capture_seconds,
            "keys": graph_keys(eng)}


def summary(rec) -> str:
    """The window's counts, on a line of their own before the result."""
    from . import window

    w0, w1 = rec["window"]
    due = [lv for lv in rec["requests"] if w0 <= lv.due <= w1]
    late = sorted(lv.sub - lv.due for lv in due)
    tok = window.tokens(rec)
    return (f"window {w1 - w0:.1f} s: {len(due)} requests due, {len(window.ttft_ms(rec))} "
            f"first tokens, {sum(1 for lv in rec['done'] if w0 <= lv.done_t <= w1)} "
            f"completed, {len(window.itl_ms(rec))} gaps between tokens; tokens "
            f"{tok}; generator late by p90 "
            f"{window.percentile(late, 90) if late else 0:.4f} s, max "
            f"{late[-1] if late else 0:.4f} s; engine counters in the window "
            f"{ {k: rec['at_close'][k] - rec['at_open'][k] for k in rec['at_open']} }; "
            f"graphs {rec['graphs']}, pool {rec['pool_bytes'] / 2**20:.1f} MiB; "
            f"sequence wrapped: {rec['wrapped']}; peak {rec['memory_peak_bytes'] / 2**30:.2f} GiB")


def check(rec, cell, seed: int, device, log) -> Dict[str, Any]:
    """The served sample against the reference (see :mod:`.check`)."""
    from . import check as chk

    t = time.perf_counter()
    out = chk.serve(rec, seed, device,
                    chk.limits(cell.name).get("requests", cell.mix["check_requests"]))
    log(f"check: {out} in {time.perf_counter() - t:.1f} s")
    return out
