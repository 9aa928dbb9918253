"""What the harness knows of each kind of model, one module per kind, named
by the configuration's ``reference`` key as ``reference/`` is.  A kind
module defines:

- ``port_keys(arch)``: the configuration file's top-level keys of the kind,
  each with the port ``ArchConfig``'s value for it;
- ``layers(config, draw, device, leaves)``: the per-layer parameter dicts of
  the port's tree, drawn with ``harness.weights.Drawer`` ``draw``;
- ``matmul_params(config)``: the weights one token multiplies through in
  the layers (the output head is counted by ``harness.work``);
- ``attention(config)``: (attention layers, heads, head_dim), (0, 0, 0)
  for none;
- ``mlp_widths(config)``: (d, ff) of kernel A's MLP launches, or None;
- ``scan_widths(config)``: (layers that run kernel C, d_inner, state), or
  None;
- ``tiny(dtype)``: the small configuration of the CPU tests.

Widths come from these functions and never from a key's name: a key such
as ``intermediate_size`` means another width in another kind."""
from __future__ import annotations

import importlib
from pathlib import Path
from types import ModuleType
from typing import List

HERE = Path(__file__).resolve().parent


def kind(name: str) -> ModuleType:
    try:
        return importlib.import_module(f"kinds.{name}")
    except ModuleNotFoundError as e:
        if e.name != f"kinds.{name}":
            raise
        raise ValueError(
            f"no kind of model {name!r}: a configuration of a new kind adds "
            f"kinds/{name}.py (port_keys, layers, matmul_params, attention, mlp_widths, "
            f"scan_widths, tiny) and reference/{name}.py beside configs/<name>.json and "
            f"limits/<cell>.json; present: {names()}") from None


def names() -> List[str]:
    """The kinds whose modules are present."""
    return sorted(p.stem for p in HERE.glob("*.py") if p.stem != "__init__")
