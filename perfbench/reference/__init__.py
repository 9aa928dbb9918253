"""The plain reference: float32 PyTorch with TF32 off, written from the
published equations as the port runs them (each departure from the
published model is listed in the configuration's file).  It imports nothing
of the port, of ``repro`` or of JAX, and takes nothing the port made: only
the weights and tokens the benchmark drew.  One module per kind of model,
named by the configuration's ``reference`` key."""
from __future__ import annotations

import importlib


def model(kind: str):
    return importlib.import_module(f"reference.{kind}")
