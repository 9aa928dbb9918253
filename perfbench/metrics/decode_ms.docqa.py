"""decode_ms.docqa: the median device time of a decode tick (the
program's ``serve.decode`` spans: a graph replay of every decoding slot)
in the traced slice, in ms."""
from harness import spans


def read(rec):
    if rec["kind"] != "serve":
        return None
    return spans.median_ms(rec, "serve.decode")
