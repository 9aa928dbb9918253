"""Model FLOPs of the window's work (2 per weight of every product and the
head, per token, plus attention's score and value products over each
token's causal prefix) over the ticks' summed wall time at the card's bf16
peak, in percent."""
from harness import window


def read(rec):
    if rec["kind"] != "serve":
        return None
    return window.mfu(rec)
