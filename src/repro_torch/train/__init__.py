"""Training runtime of the port (mirrors ``src/repro/train``)."""
