"""Build and load the port's CUDA kernels.

The sources in ``src/repro_torch/csrc/`` have a plain C interface (no
PyTorch headers, so ``nvcc`` takes seconds, not minutes).  They are
compiled for ``sm_90a`` by ``torch.utils.cpp_extension.load`` into
``build/repro_torch_kernels/`` at the repository root (listed in
``.gitignore``) at first use, and the resulting shared library is bound
with ``ctypes``.  Nothing is built when a module is imported, and a
build failure raises.
"""
from __future__ import annotations

import ctypes
import os
import time
from pathlib import Path
from typing import Optional

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("matmul.cu", "flash_attention.cu", "scan_gate.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
CUDA_FLAGS = ("-O3", "-std=c++17", "-gencode=arch=compute_90a,code=sm_90a")

_LIB: Optional[ctypes.CDLL] = None
BUILD_SECONDS: Optional[float] = None


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.repro_matmul_bf16.argtypes = [p] * 5 + [i] * 8 + [p]
    lib.repro_matmul_bf16.restype = i
    lib.repro_flash_attention_bf16.argtypes = [p] * 5 + [i] * 9 + [ll] * 12 + [p]
    lib.repro_flash_attention_bf16.restype = i
    lib.repro_scan_gate.argtypes = [p] * 9 + [i] * 7 + [p]
    lib.repro_scan_gate.restype = i
    lib.repro_selective_scan.argtypes = [p] * 4 + [i] * 6 + [p]
    lib.repro_selective_scan.restype = i
    lib.repro_cuda_error_string.argtypes = [i]
    lib.repro_cuda_error_string.restype = ctypes.c_char_p
    return lib


def load_library() -> ctypes.CDLL:
    """Compile (first call only) and load the kernels' shared library."""
    global _LIB, BUILD_SECONDS
    if _LIB is None:
        from torch.utils.cpp_extension import load

        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        path = load(name="repro_torch_kernels",
                    sources=[str(CSRC / s) for s in SOURCES],
                    extra_cuda_cflags=list(CUDA_FLAGS),
                    build_directory=os.fspath(BUILD_DIR),
                    is_python_module=False)
        BUILD_SECONDS = time.perf_counter() - t0
        _LIB = _bind(ctypes.CDLL(path))
    return _LIB


def check(rc: int, what: str) -> None:
    """Raise if a launch returned an error code."""
    if rc == -1:
        raise ValueError(f"{what}: shape or tile not instantiated in csrc/")
    if rc == -2:
        raise RuntimeError(f"{what}: a TMA tensor map could not be encoded")
    if rc != 0:
        msg = load_library().repro_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA launch failed ({rc}: {msg})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
