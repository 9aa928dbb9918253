"""The share of the traced slice in which no device activity ran, in
percent (the union of every kernel, copy and set in the profiler's trace)."""
from harness import window


def read(rec):
    return window.idle_share(rec)
