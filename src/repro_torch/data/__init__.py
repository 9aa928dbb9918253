"""Data pipeline of the port (a copy of ``src/repro/data``)."""
