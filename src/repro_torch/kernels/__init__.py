"""Hand-written Hopper kernels and their plain PyTorch versions (mirrors ``src/repro/kernels``)."""
from __future__ import annotations

from typing import Dict


def launch_counts() -> Dict[str, int]:
    """Each kernel wrapper's ``LAUNCHES``: its kernel's launches since
    the count was last set to 0."""
    from . import flash_attention, mamba_scan, matmul_polytops, scan_gate
    return {"matmul": matmul_polytops.LAUNCHES, "flash_attention": flash_attention.LAUNCHES,
            "scan_gate": scan_gate.LAUNCHES, "selective_scan": mamba_scan.LAUNCHES}
