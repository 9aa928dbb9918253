"""Optimizer of the port (mirrors ``src/repro/optim/adamw.py``)."""
