"""Model layers of the port (mirrors ``src/repro/model``)."""
