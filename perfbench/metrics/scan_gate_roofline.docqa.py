"""scan_gate_roofline.docqa: kernel C's least time for the launches it ran
in the traced slice over its device time there, in percent.  C runs once a
layer for each chunk tick (the largest chunks, where the kernel's threshold
sends the smallest to the plain scan); each launch's least time counts its
chunk's rows, from the engine's prefilled rows per tick."""
from harness import window, work


def read(rec):
    k = window.kernel(rec, "scan_kernel")
    cfg = rec["config"]
    if k is None or cfg["reference"] != "mamba1":
        return None
    n, secs = k
    layers = cfg["num_hidden_layers"]
    if any(tk[3] is None for tk in rec["trace_ticks"]):
        return None
    rows = sorted((sum(n for _, n in tk[3]) for tk in rec["trace_ticks"]), reverse=True)
    rows = [r for r in rows if r > 0]
    if n % layers or n // layers > len(rows):
        return None
    least = sum(layers * work.scan_gate_bound_s(r, cfg["intermediate_size"],
                                                cfg["state_size"])
                for r in rows[:n // layers])
    return 100.0 * least / secs
