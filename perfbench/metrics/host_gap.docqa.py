"""host_gap.docqa: the share of the traced slice, from its first tick's
start to its last tick's end (the program's ``serve.tick`` spans), that
lies outside every device interval of the engine's spans, in percent: the
device waits on the host there.  Idle time inside a graph replay is not
in it."""
from harness import spans


def read(rec):
    if rec["kind"] != "serve":
        return None
    got = spans.traced(rec) or ()
    ticks = [sp for sp in got if sp["name"] == "serve.tick"]
    if not ticks:
        return None
    lo, hi = min(sp["t0"] for sp in ticks), max(sp["t1"] for sp in ticks)
    covered, edge = 0.0, lo
    for a, b in sorted((sp["d0"], sp["d1"]) for sp in got
                       if sp["name"].startswith("serve.") and "d0" in sp):
        a, b = max(a, edge), min(b, hi)
        if b > a:
            covered += b - a
            edge = b
    return 100.0 * (1.0 - covered / (hi - lo))
