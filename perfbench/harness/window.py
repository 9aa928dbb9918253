"""What a run's record says about its window: the requests whose first
token, the gaps between tokens and the ticks that fell inside it, and the
model FLOPs of that work.  The metric readers are made of these."""
from __future__ import annotations

from typing import List

import numpy as np

from . import work


def inside(rec, t: float) -> bool:
    w0, w1 = rec["window"]
    return w0 <= t <= w1


def percentile(values: List[float], q: float):
    return float(np.percentile(np.asarray(values, dtype=np.float64), q)) if values else None


def ttft_ms(rec) -> List[float]:
    """Time to first token of every request whose first token fell in the
    window, from the moment it was due."""
    return [(lv.times[0] - lv.due) * 1e3 for lv in rec["requests"]
            if lv.times and inside(rec, lv.times[0])]


def itl_ms(rec) -> List[float]:
    """Every gap between consecutive tokens of one request, both inside the
    window."""
    out = []
    for lv in rec["requests"]:
        t = [x for x in lv.times if inside(rec, x)]
        out += [(b - a) * 1e3 for a, b in zip(t, t[1:])]
    return out


def chunks(rec):
    """(offset, rows) of every prompt chunk prefilled by a tick that ended
    in the window, from the engine's per-slot prefill positions; None where
    the engine shows none."""
    ticks = [tk for tk in rec["ticks"] if inside(rec, tk[1])]
    if any(tk[3] is None for tk in ticks):
        return None
    return [c for tk in ticks for c in tk[3]]


def tokens(rec):
    """Prompt tokens prefilled and tokens generated (and of those, decoded:
    not a first token) in the window; None without prefill positions."""
    ch = chunks(rec)
    if ch is None:
        return None
    gen = sum(1 for lv in rec["requests"] for t in lv.times if inside(rec, t))
    first = sum(1 for lv in rec["requests"] if lv.times and inside(rec, lv.times[0]))
    return {"prompt": sum(n for _, n in ch), "generated": gen, "decoded": gen - first}


def model_flops(rec):
    """Model FLOPs of the window's work: every prompt chunk prefilled in it
    and every token decoded in it, each at its position."""
    cfg = rec["config"]
    ch = chunks(rec)
    if ch is None:
        return None
    total = sum(work.forward_flops(cfg, o, n) for o, n in ch)
    for lv in rec["requests"]:
        p = lv.spec.plen
        total += sum(work.forward_flops(cfg, p + j - 1, 1)
                     for j, t in enumerate(lv.times) if j > 0 and inside(rec, t))
    return total


def tick_seconds(rec) -> float:
    """The ticks' wall time inside the window."""
    w0, w1 = rec["window"]
    return sum(max(0.0, min(b, w1) - max(a, w0)) for a, b, *_ in rec["ticks"])


def mfu(rec):
    s, flops = tick_seconds(rec), model_flops(rec)
    if s <= 0 or flops is None:
        return None
    return 100.0 * flops / (s * work.peaks()["bf16_flops"])


def idle_share(rec):
    tr = rec.get("trace")
    if not tr or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def kernel(rec, prefix: str):
    """(launches, device seconds) of the kernels whose name starts with
    ``prefix`` in the traced slice, or None."""
    tr = rec.get("trace")
    if not tr:
        return None
    n = sum(c for k, (c, _) in tr["kernels"].items() if k.startswith(prefix))
    s = sum(t for k, (_, t) in tr["kernels"].items() if k.startswith(prefix))
    return (n, s) if n else None


def counter(rec, name: str):
    return rec["at_close"][name] - rec["at_open"][name]
