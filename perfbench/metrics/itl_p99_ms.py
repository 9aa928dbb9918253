"""itl_p99_ms: the 99th percentile of every gap between consecutive tokens
of one request inside the window."""
from harness import window


def read(rec):
    if rec["kind"] != "serve":
        return None
    return window.percentile(window.itl_ms(rec), 99)
