"""scan_gate_roofline.docqa: kernel C's least time for the launches it ran
in the traced slice over its device time there, in percent.  C runs once in
each layer that has a scan for each chunk tick (the largest chunks, where
the kernel's threshold sends the smallest to the plain scan); each launch's
least time counts its chunk's rows, from the engine's prefilled rows per
tick.  The layer count, d_inner and state are the kind's
(``scan_widths``)."""
from harness import window, work
from kinds import kind


def read(rec):
    k = window.kernel(rec, "scan_kernel")
    cfg = rec["config"]
    widths = kind(cfg["reference"]).scan_widths(cfg)
    if k is None or widths is None:
        return None
    n, secs = k
    layers, di, st = widths
    if any(tk[3] is None for tk in rec["trace_ticks"]):
        return None
    rows = sorted((sum(n for _, n in tk[3]) for tk in rec["trace_ticks"]), reverse=True)
    rows = [r for r in rows if r > 0]
    if n % layers or n // layers > len(rows):
        return None
    least = sum(layers * work.scan_gate_bound_s(r, di, st) for r in rows[:n // layers])
    return 100.0 * least / secs
