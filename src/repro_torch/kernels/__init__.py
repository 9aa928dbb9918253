"""Hand-written Hopper kernels and their plain PyTorch versions (mirrors ``src/repro/kernels``)."""
from __future__ import annotations

from typing import Dict


def _wrappers():
    from . import flash_attention, mamba_scan, matmul_polytops, scan_gate
    return {"matmul": matmul_polytops, "flash_attention": flash_attention,
            "scan_gate": scan_gate, "selective_scan": mamba_scan}


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's ``LAUNCHES``: its kernel's launches since
    the count was last set to 0."""
    return {name: mod.LAUNCHES for name, mod in _wrappers().items()}


def add_launches(delta: Dict[str, int]) -> None:
    """Add ``delta`` (by :func:`launch_counts` name) to the wrappers'
    counts: a CUDA graph's replay launches the kernels its capture
    recorded without calling a wrapper."""
    for name, mod in _wrappers().items():
        mod.LAUNCHES += delta.get(name, 0)
