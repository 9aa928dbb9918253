#!/usr/bin/env python3
"""The port's tracer (``repro_torch.spans``) on the card: what recording
costs, and how its device intervals sit against the profiler's trace.

    python3 scripts/span_check.py [--seed N] [--seconds S] [--out PATH]

Run from the root of a checkout, on one CUDA device.  The benchmark's
harness (``perfbench/harness``) sets up and warms each docqa cell's server
and the train cell's step as a run of the cell does; then:

* cost, serving: windows of ``--seconds`` of the cell's traffic in turns
  without and with ``spans.recording()`` (off, on, off, on; the engine
  reset between them), each window's median tick wall; the spans and
  device spans per tick, the replays' host and device times and the host
  gap of the last recorded window (no profiler); and one span's host cost
  (off, host only, with device events) over 20,000 spans;
* clock: a slice of the cell's traffic under ``torch.profiler`` as the
  benchmark traces it.  A ``record_function`` mark between two
  ``perf_counter`` reads gives the offset of the profiler's clock; through
  it each replay's device interval (``serve.decode``, ``serve.chunk``) is
  held against the profiler's kernels inside it: the lead from the
  interval's start to its first kernel and the lag from its last kernel
  to its end (their medians are the clocks' offset, their spread the
  residual), and the idle inside the replays.  The slice's idle (ticks'
  extent less the union of every device activity) splits into the
  tracer's host gap, by the innermost host span, and the idle inside the
  engine's device intervals;
* drift: spans on an idle device over 6 s, each one's device start
  against its host start, without the profiler;
* train: step walls off and on; under the profiler, the three phases'
  device time against each step's device busy time.

Each part runs in a process of its own.  Prints a JSON line per part, and
writes them all to ``--out``.
"""
from __future__ import annotations

import argparse
import bisect
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from contextlib import nullcontext
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "perfbench"), str(ROOT / "src")]

import run as bench  # noqa: E402  (perfbench/run.py: caches and paths)

bench.environment()

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile, record_function  # noqa: E402

from harness import training, weights  # noqa: E402
from harness.cell import arch_config, load  # noqa: E402
from harness.serving import Server  # noqa: E402
from harness.trace import Slice  # noqa: E402
from repro_torch import spans  # noqa: E402

DEV = torch.device("cuda")
MARK = "span_check.mark"
REPLAYS = ("serve.decode", "serve.chunk")


def quartiles(xs):
    xs = sorted(xs)
    if len(xs) < 4:
        return {"n": len(xs), "median": statistics.median(xs) if xs else None}
    q = statistics.quantiles(xs, n=4)
    return {"n": len(xs), "q1": q[0], "median": q[1], "q3": q[2], "min": xs[0], "max": xs[-1]}


def union(ivs):
    """Total length of the union of (start, end) intervals."""
    total, edge = 0.0, float("-inf")
    for a, b in sorted(ivs):
        a = max(a, edge)
        if b > a:
            total += b - a
            edge = b
    return total


def span_cost(n: int = 20000) -> dict:
    """Host µs per span: recording off, on without and with device events
    (new events, then events the last session left in the pool)."""
    out = {}
    for label, ctx, dev in (("off", nullcontext(), DEV), ("host", spans.recording(), None),
                            ("device", spans.recording(), DEV),
                            ("device_pooled", spans.recording(), DEV)):
        with ctx:
            torch.cuda.synchronize()
            t = time.perf_counter()
            for _ in range(n):
                with spans.span("span_check.cost", dev, rows=1):
                    pass
            out[label + "_us"] = (time.perf_counter() - t) / n * 1e6
    return out


def window_ticks(rec) -> list:
    w0, _ = rec["window"]
    return [b - a for a, b, *_ in rec["ticks"] if a >= w0]


def replays(sp) -> dict:
    """Host and device ms of the decode and full-chunk spans."""
    out = {}
    for key, name, rows in (("decode", "serve.decode", None), ("chunk", "serve.chunk", 256)):
        got = [x for x in sp if x["name"] == name and "d0" in x
               and (rows is None or x["attrs"].get("rows") == rows)]
        out[key] = {"host_ms": quartiles([(x["t1"] - x["t0"]) * 1e3 for x in got]),
                    "device_ms": quartiles([(x["d1"] - x["d0"]) * 1e3 for x in got])}
    return out


def serve_cost(srv, seconds: float) -> dict:
    walls, per_tick, waits = {"off": [], "on": []}, {}, []
    for turn in ("off", "on", "off", "on"):
        srv.eng.reset()
        with spans.recording() if turn == "on" else nullcontext():
            rec = srv.drive(seconds)
        walls[turn].append(statistics.median(window_ticks(rec)) * 1e3)
        w0, w1 = rec["window"]
        waits += [(lv.req.t_prefill - lv.req.t_admit) * 1e3 for lv in rec["requests"]
                  if w0 <= lv.req.t_prefill <= w1]
        if turn == "on":
            s = spans.last_session()
            ticks = sum(1 for x in s["spans"] if x["name"] == "serve.tick")
            extent = (max(x["t1"] for x in s["spans"]) - min(x["t0"] for x in s["spans"]))
            per_tick = {"spans": len(s["spans"]) / ticks,
                        "device_spans": sum("d0" in x for x in s["spans"]) / ticks,
                        "dropped": s["dropped"], "unprofiled": replays(s["spans"]),
                        "unprofiled_host_gap_pct": 100 * sum(s["gaps"].values()) / extent,
                        "unprofiled_gaps_by_span_s": s["gaps"], "unprofiled_extent_s": extent}
    off, on = statistics.mean(walls["off"]), statistics.mean(walls["on"])
    waits.sort()
    return {"tick_wall_ms": walls, "on_over_off_pct": 100 * (on / off - 1), **per_tick,
            "prefill_wait_ms": {**quartiles(waits),
                                "p90": waits[int(0.9 * (len(waits) - 1))] if waits else None,
                                "over_100ms": sum(w > 100 for w in waits)}}


def slope(points) -> float:
    """Least-squares slope of (x, y) points."""
    n = len(points)
    mx = sum(x for x, _ in points) / n
    my = sum(y for _, y in points) / n
    sxx = sum((x - mx) ** 2 for x, _ in points)
    return sum((x - mx) * (y - my) for x, y in points) / sxx if sxx else 0.0


def drift(seconds: float = 6.0, n: int = 13) -> dict:
    """The tracer's device clock against the host's, without the profiler:
    spans on an idle device ``seconds`` apart in all, each one's device
    start against its host start (an idle device runs the event as it is
    recorded), from the session's anchor on."""
    out = []
    with spans.recording():
        for _ in range(n):
            torch.cuda.synchronize()
            with spans.span("span_check.drift", DEV):
                pass
            time.sleep(seconds / (n - 1))
    sp = spans.last_session()["spans"]
    base = sp[0]["t0"]
    out = [(x["t0"] - base, (x["d0"] - x["t0"]) * 1e6) for x in sp]
    return {"offset_us": [round(y, 2) for _, y in out], "slope_us_per_s": slope(out)}


def profiler_offset(prof_events, marks) -> float:
    """Seconds to add to a ``perf_counter`` time to read it on the
    profiler's clock: the narrowest of the marks."""
    ev = sorted((e for e in prof_events if e.name == MARK), key=lambda e: e.time_range.start)
    best = min(zip(ev, marks), key=lambda em: em[1][1] - em[1][0])
    e, (a, b) = best
    return (e.time_range.start + e.time_range.end) / 2 * 1e-6 - (a + b) / 2


def mark(marks) -> None:
    for _ in range(5):
        a = time.perf_counter()
        with record_function(MARK):
            b = time.perf_counter()
        marks.append((a, b))


def clock(srv, seconds: float) -> dict:
    """One profiled slice: the tracer's intervals against the profiler's."""
    srv.eng.reset()
    srv.drive(2.0)                                  # slots busy, as in a window
    tslice = Slice(DEV)
    tslice.prime()
    marks = []
    tslice.prof.start()
    mark(marks)
    cell = srv.cell
    srv.cell = dataclasses.replace(cell, mix=dict(cell.mix, ramp_s=0.0))
    try:
        srv.drive(seconds)
    finally:
        srv.cell = cell
    torch.cuda.synchronize()
    mark(marks)
    tslice.prof.stop()
    session = spans.last_session()
    events = list(tslice.prof.events())
    off = profiler_offset(events, marks)
    dev = sorted((e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
                 if e.device_type == DeviceType.CUDA
                 and not e.name.startswith(("bench.", MARK)))
    sp = session["spans"]
    ticks = [x for x in sp if x["name"] == "serve.tick"]
    lo, hi = min(x["t0"] for x in ticks) + off, max(x["t1"] for x in ticks) + off
    inside = [(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi]
    starts = [a for a, _ in dev]
    lead, lag, fill, counts, series = {}, {}, {}, {}, {}
    idle_in_intervals = 0.0
    for x in sp:
        if "d0" not in x:
            continue
        d0, d1 = x["d0"] + off, x["d1"] + off
        i, j = bisect.bisect_left(starts, d0), bisect.bisect_right(starts, d1)
        ks = [(a, min(b, d1)) for a, b in dev[i:j]]
        busy = union(ks)
        last = max((b for _, b in dev[i:j]), default=None)
        idle_in_intervals += max(0.0, (min(d1, hi) - max(d0, lo))) - union(
            [(max(a, lo), min(b, hi)) for a, b in ks if b > lo and a < hi])
        if x["name"] in REPLAYS and ks:
            key = f"{x['name']}:{x['attrs'].get('rows')}" if x["name"] == "serve.chunk" \
                else x["name"]
            lead.setdefault(x["name"], []).append((ks[0][0] - d0) * 1e6)
            lag.setdefault(x["name"], []).append((d1 - last) * 1e6)
            series.setdefault(x["name"], []).append((d1 - lo, (d1 - last) * 1e6))
            fill.setdefault(key, []).append(100 * busy / (d1 - d0))
            counts.setdefault(key, []).append(len(ks))
    busy_prof = union(inside)
    host_gap = (hi - lo) - union([(max(x["d0"] + off, lo), min(x["d1"] + off, hi))
                                  for x in sp if "d0" in x])
    return {"slice_s": hi - lo, "ticks": len(ticks),
            "idle_profiler_pct": 100 * (1 - busy_prof / (hi - lo)),
            "host_gap_pct": 100 * host_gap / (hi - lo),
            "idle_inside_intervals_pct": 100 * idle_in_intervals / (hi - lo),
            "gaps_by_span_s": session["gaps"],
            "lead_us": {k: quartiles(v) for k, v in lead.items()},
            "lag_us": {k: quartiles(v) for k, v in lag.items()},
            "lag_slope_us_per_s": {k: slope(v) for k, v in series.items()},
            "kernel_fill_pct": {k: quartiles(v) for k, v in fill.items()},
            "kernels_per_replay": {k: quartiles(v) for k, v in counts.items()},
            "mark_width_us": min(b - a for a, b in marks) * 1e6,
            "anchor_width_us": {k: v * 1e6 for k, v in session["anchors"].items()},
            "profiled": replays(sp)}


def serving(name: str, seed: int, seconds: float) -> dict:
    cell = load(name)
    srv = Server(cell, seed, DEV, time.perf_counter(), lambda m: None)
    try:
        out = {"cell": name, "cost": serve_cost(srv, seconds), "clock": clock(srv, 2.0),
               "drift": drift()}
    finally:
        srv.close()
    return out


def train(seed: int) -> dict:
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    cell = load("granite_3_2b.train")
    mix, cfg = cell.mix, cell.config
    T.REMAT = mix["remat"]
    params = weights.make(cfg, seed, DEV, leaves=True)
    for p in weights.leaves(params):
        p.requires_grad_(True)
    opt = adamw.AdamWConfig(**mix["opt"])
    state = adamw.init(params)
    step_fn = make_train_step(arch_config(cfg), opt, mix["n_micro"])
    i = 0

    def one():
        nonlocal params, state, i
        tok, lab = training.rows(mix, cfg["vocab_size"], seed, i, DEV)
        i += 1
        t = time.perf_counter()
        params, state, m = step_fn(params, state, {"tokens": tok, "labels": lab})
        torch.stack(list(m.values())).tolist()
        return time.perf_counter() - t

    one(), one()
    walls = {"off": [], "on": []}
    for turn in ("off", "on", "off", "on"):
        with spans.recording() if turn == "on" else nullcontext():
            walls[turn] += [one() * 1e3 for _ in range(2)]
    prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])
    prof.start()
    marks = []
    mark(marks)
    one(), one()
    mark(marks)
    prof.stop()
    events = list(prof.events())
    off = profiler_offset(events, marks)
    dev = [(e.time_range.start * 1e-6, e.time_range.end * 1e-6) for e in events
           if e.device_type == DeviceType.CUDA and not e.name.startswith(MARK)]
    sp = spans.last_session()["spans"]
    steps = []
    for st in (x for x in sp if x["name"] == "train.step"):
        kids = [x for x in sp if x["parent"] == st["id"]]
        lo, hi = st["t0"] + off, st["t1"] + off
        busy = union([(max(a, lo), min(b, hi)) for a, b in dev if b > lo and a < hi])
        phases = {x["name"]: (x["d1"] - x["d0"]) * 1e3 for x in kids}
        steps.append({"wall_ms": (hi - lo) * 1e3, "busy_ms": busy * 1e3, **phases,
                      "phases_over_busy": sum(phases.values()) / (busy * 1e3) if busy else None})
    del params, state, step_fn
    torch.cuda.empty_cache()
    return {"cell": cell.name, "step_wall_ms": walls,
            "on_over_off_pct": 100 * (statistics.mean(walls["on"])
                                      / statistics.mean(walls["off"]) - 1),
            "profiled_steps": steps}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=3141592653)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out", default="build/span_check.json")
    ap.add_argument("--parts", default="granite_3_2b.docqa,falcon_mamba_7b.docqa,train")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("span_check needs a CUDA device", file=sys.stderr)
        return 2
    parts = args.parts.split(",")
    if len(parts) == 1:
        torch.set_num_threads(4)
        part = parts[0]
        got = train(args.seed) if part == "train" else \
            {"span_cost": span_cost(), **serving(part, args.seed, args.seconds)}
        print(json.dumps(got), flush=True)
        return 0
    # each part in a process of its own: the profiler slows what runs
    # after its first start
    results = [{"card": bench.card_line(), "torch": torch.__version__}]
    print(json.dumps(results[0]), flush=True)
    for part in parts:
        run = subprocess.run([sys.executable, __file__, "--seed", str(args.seed),
                              "--seconds", str(args.seconds), "--parts", part],
                             capture_output=True, text=True)
        if run.returncode:
            print(run.stderr[-4000:], file=sys.stderr)
            return run.returncode
        results.append(json.loads(run.stdout.strip().splitlines()[-1]))
        print(json.dumps(results[-1]), flush=True)
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(results, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
