"""The benchmark's harness: cells, traffic, weights, the drivers of the
serving and training entries, the trace's reduction and the output checks."""

