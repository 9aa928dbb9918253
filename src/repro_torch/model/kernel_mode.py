"""Process-wide switch wiring the hand-written Hopper kernels into the
model layers.

Ports ``src/repro/model/pallas_mode.py``: same fields, same defaults,
same ``configure`` and scoped context manager.  The layers
(:mod:`.attention`, :mod:`.mlp`, :mod:`.ssm`) read :func:`mode` on every
call: when ``enabled``, the plain torch paths are replaced by the kernels in
:mod:`repro_torch.kernels.ops` wherever the operand shapes clear the
per-kernel thresholds below.  On a CUDA tensor ``ops`` launches the
kernel; on a CPU tensor it runs the kernel's plain version, so the CPU
tests exercise the same routing as the card.
"""
from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class KernelMode:
    enabled: bool = False
    #: route a matmul through the planned kernel only at/above this many
    #: output rows (tokens)
    min_matmul_rows: int = 256
    #: flash attention only for query chunks at/above this length
    min_attn_q: int = 32
    #: fused scan+gate kernel only for sequence chunks at/above this
    min_scan_seq: int = 32
    #: use the fused scan+gate kernel; when off, the Mamba layers run the
    #: plain torch scan (as the reference runs jnp, ``ssm.py:87-94``), not
    #: the selective_scan kernel
    fused_scan_gate: bool = True


_MODE = KernelMode()


def mode() -> KernelMode:
    return _MODE


def configure(**kw) -> KernelMode:
    """Install a new mode (fields as keyword overrides); returns it."""
    global _MODE
    _MODE = replace(KernelMode(), **kw)
    return _MODE


@contextmanager
def kernel_mode(**kw):
    """Scoped :func:`configure` — restores the previous mode on exit."""
    global _MODE
    prev = _MODE
    _MODE = replace(KernelMode(), **kw)
    try:
        yield _MODE
    finally:
        _MODE = prev
