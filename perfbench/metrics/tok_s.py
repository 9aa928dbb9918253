"""tok_s: prompt tokens prefilled (from the engine's per-slot prefill
positions, tick by tick) plus tokens generated, by the ticks that ended in
the window, over the window's seconds."""
from harness import window


def read(rec):
    if rec["kind"] != "serve":
        return None
    t = window.tokens(rec)
    if t is None:
        return None
    w0, w1 = rec["window"]
    return (t["prompt"] + t["generated"]) / (w1 - w0)
