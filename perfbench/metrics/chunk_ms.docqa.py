"""chunk_ms.docqa: the median device time of a prefill chunk of the mix's
full ``chunk`` rows (the program's ``serve.chunk`` spans: a graph replay)
in the traced slice, in ms."""
from harness import spans


def read(rec):
    if rec["kind"] != "serve":
        return None
    return spans.median_ms(rec, "serve.chunk", rows=rec["mix"]["chunk"])
