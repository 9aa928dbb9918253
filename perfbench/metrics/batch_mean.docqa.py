"""batch_mean.docqa: tokens decoded in the window over the engine's decode
ticks in it (its ``ticks_decode`` counter; a mixed tick counts)."""
from harness import window


def read(rec):
    if rec["kind"] != "serve":
        return None
    ticks, t = window.counter(rec, "ticks_decode"), window.tokens(rec)
    return t["decoded"] / ticks if ticks and t is not None else None
