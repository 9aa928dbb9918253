"""The device trace of a slice of the window, and its reduction: busy time
(the union of every device activity), idle gaps labelled by the harness's
own span that the host was in, and device time and launches by kernel."""
from __future__ import annotations

import re
from collections import defaultdict
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

SPAN = "bench."
SLICE = "bench.slice"


@contextmanager
def span(name: str):
    """A host span of the harness (``bench.<name>``), seen in the trace."""
    from torch.profiler import record_function
    with record_function(SPAN + name):
        yield


def short(name: str) -> str:
    """A kernel's name without its arguments and namespaces: the port's
    ``void repro::(anonymous namespace)::matmul_kernel<2>(...)`` reads
    ``matmul_kernel<2>``."""
    name = name.replace("(anonymous namespace)::", "")
    if name.startswith("void "):
        name = name[5:]
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    base = "".join(out)
    base = re.sub(r"^[\w:]*::(?=[\w<])", "", base.split("<")[0]) + \
        ("<" + base.split("<", 1)[1] if "<" in base else "")
    return base.strip()[:96]


class Slice:
    """``torch.profiler`` over a stretch of ticks; ``mark`` each tick with
    whether it captured a graph, so its idle gaps can say so."""

    def __init__(self, device):
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
        self.prof = profile(activities=acts)
        self.device = device
        self.tick_captured: List[bool] = []
        self._span = None

    def prime(self) -> None:
        """A short profile of a few device ops in set-up: the profiler's
        first use costs about a second, which must not fall in the slice."""
        import torch
        from torch.profiler import profile
        with profile(activities=self.prof.activities):
            with span("prime"):
                x = torch.ones(1024, device=self.device)
                (x @ x).item()

    def start(self) -> None:
        from torch.profiler import record_function
        self.prof.start()
        self._span = record_function(SLICE)
        self._span.__enter__()

    def stop(self) -> None:
        import torch
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self._span.__exit__(None, None, None)
        self.prof.stop()

    def reduce(self) -> Dict[str, Any]:
        from torch.autograd import DeviceType
        events = list(self.prof.events())
        return reduce_events(
            [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CUDA and not e.name.startswith(SPAN)],
            [(e.time_range.start, e.time_range.end, e.name) for e in events
             if e.device_type == DeviceType.CPU and e.name.startswith(SPAN)],
            self.tick_captured)


def reduce_events(device: List[tuple], spans: List[tuple],
                  tick_captured: Optional[List[bool]] = None) -> Dict[str, Any]:
    """``device``: (start µs, end µs, name) of every device activity (the
    profiler mirrors the harness's spans onto the device's timeline; those
    are not activity and are left out before this);
    ``spans``: the harness's host spans, among them one ``bench.slice``
    around the whole slice.  Returns busy and window seconds, device
    seconds and launches by kernel name, and idle seconds by the span the
    host was in (a tick that captured a graph reads ``tick+capture``)."""
    win = [s for s in spans if s[2] == SLICE]
    lo, hi = win[0][0], win[0][1]
    kernels: Dict[str, List[float]] = defaultdict(lambda: [0, 0.0])
    ivs = []
    for s, e, name in device:
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        k = kernels[short(name)]
        k[0] += 1
        k[1] += (e - s) * 1e-6
        ivs.append((s, e))
    ivs.sort()
    busy, gaps, cur = 0.0, [], None
    edge = lo
    for s, e in ivs:
        if cur is None or s > cur[1]:
            if cur is not None:
                busy += cur[1] - cur[0]
            if s > edge:
                gaps.append((edge, s))
            cur = [s, e]
        else:
            cur[1] = max(cur[1], e)
        edge = max(edge, e)
    if cur is not None:
        busy += cur[1] - cur[0]
    if hi > edge:
        gaps.append((edge, hi))
    ticks = sorted(s for s in spans if s[2] == SPAN + "tick")
    captured = dict(zip((t[0] for t in ticks), tick_captured or []))
    inner = [s for s in spans if s[2] != SLICE]
    idle: Dict[str, float] = defaultdict(float)
    for a, b in gaps:
        mid = (a + b) / 2
        around = [s for s in inner if s[0] <= mid <= s[1]]
        if around:
            s = min(around, key=lambda x: x[1] - x[0])
            label = s[2][len(SPAN):]
            if label == "tick" and captured.get(s[0]):
                label = "tick+capture"
        else:
            label = "harness"
        idle[label] += (b - a) * 1e-6
    return {"busy_s": busy * 1e-6, "window_s": (hi - lo) * 1e-6,
            "kernels": {k: (int(v[0]), v[1]) for k, v in kernels.items()},
            "idle": dict(idle)}


def breakdown(red: Dict[str, Any]) -> Dict[str, list]:
    """The contract's ``breakdown``: the ten device operations that took most
    time and the ten largest idle totals by host span."""
    ops = sorted(red["kernels"].items(), key=lambda kv: -kv[1][1])[:10]
    gaps = sorted(red["idle"].items(), key=lambda kv: -kv[1])[:10]
    return {"device_ops": [[k, v[1]] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in gaps]}
