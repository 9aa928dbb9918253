"""Compile-and-run harness for the C backend, with on-disk caching.

Failure model (repro_torch.core.resilience): every way a measurement can die
— oversized source, gcc OOM/timeout, a crashing or hanging binary,
malformed TIME_S/CHECKSUM output — surfaces as a typed
:class:`~repro_torch.core.resilience.MeasurementError` carrying the build tag
and the phase that failed, so the autotuner can record/retry/exclude
instead of aborting the search.  The result cache is crash-safe: writes
are atomic (tmp+rename) and a corrupt/truncated cache file is
quarantined and recomputed, never raised.  Fault sites ``cache.read``,
``cache.write``, ``cc.compile``, ``cc.run`` and ``measure`` let tests
inject each of those failures deterministically.

The result cache is the port's own (``$POLYTOPS_TORCH_CC_CACHE``, default
``/tmp/polytops_torch_cc_cache``), beside the reference package's.
"""
from __future__ import annotations

import functools
import hashlib
import json
import os
import subprocess
import tempfile
from dataclasses import dataclass
from pathlib import Path
from typing import Optional

from .resilience import InjectedFault, MeasurementError, fault_point

CACHE_DIR = Path(os.environ.get("POLYTOPS_TORCH_CC_CACHE",
                               "/tmp/polytops_torch_cc_cache"))
CFLAGS = ["-O3", "-march=native", "-fopenmp", "-lm"]


@dataclass
class RunResult:
    seconds: float
    checksum: float
    cached: bool = False


MAX_SOURCE_BYTES = 400_000      # FM blowups produce pathological sources
GCC_MEM_KB = 6 * 1024 * 1024    # cap cc1 at 6 GB (observed 36 GB OOM on
                                # a wavefront-tiled 3D stencil at -O3)


@functools.lru_cache(maxsize=1)
def compiler_version() -> str:
    """Toolchain fingerprint for the result cache: a compiler upgrade can
    change both timings and (for FP reassociation) checksums, so cached
    results must not survive one."""
    try:
        cp = subprocess.run(["gcc", "-dumpfullversion", "-dumpversion"],
                            capture_output=True, text=True, timeout=30)
        return cp.stdout.split()[0] if cp.stdout.split() else "unknown"
    except Exception:
        return "unknown"


def _result_key(source: str) -> str:
    """Cache key over everything that determines the measured result:
    source text, the exact CFLAGS, and the gcc version — flag or
    toolchain changes must never serve stale binaries' numbers."""
    payload = json.dumps({
        "src": hashlib.sha256(source.encode()).hexdigest(),
        "cflags": list(CFLAGS),
        "gcc": compiler_version(),
    }, sort_keys=True)
    return hashlib.sha256(payload.encode()).hexdigest()[:24]


def _quarantine(path: Path) -> None:
    """Move a corrupt cache file aside (never delete evidence, never
    raise): recompute proceeds as a plain miss."""
    try:
        qdir = path.parent / "quarantine"
        qdir.mkdir(parents=True, exist_ok=True)
        os.replace(path, qdir / path.name)
    except OSError:
        try:
            path.unlink()
        except OSError:
            pass


def _read_cached(cache_file: Path, tag: str) -> Optional[RunResult]:
    """Cached result, or None on miss.  A truncated/corrupt/partial
    JSON file (a writer died mid-write before writes were atomic, disk
    corruption, an injected cache.read fault) is quarantined and
    recomputed — it must never crash the measurement."""
    try:
        fault_point("cache.read")
        data = json.loads(cache_file.read_text())
        return RunResult(float(data["seconds"]), float(data["checksum"]),
                         cached=True)
    except FileNotFoundError:
        return None
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:   # corrupt payload or injected fault: quarantine
        if cache_file.exists():
            _quarantine(cache_file)
        return None


def _write_cached(cache_file: Path, seconds: float, checksum: float) -> None:
    """Atomic tmp+rename publish; failures degrade to uncached."""
    try:
        fault_point("cache.write")
        fd, tmp = tempfile.mkstemp(dir=str(cache_file.parent), suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                f.write(json.dumps({"seconds": seconds, "checksum": checksum}))
            os.replace(tmp, cache_file)
        except Exception:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    except (KeyboardInterrupt, SystemExit):
        raise
    except Exception:
        pass


def compile_and_run(source: str, tag: str = "kernel", timeout: int = 600,
                    use_cache: bool = True) -> RunResult:
    key = _result_key(source)
    CACHE_DIR.mkdir(parents=True, exist_ok=True)
    cache_file = CACHE_DIR / f"{key}.json"
    if use_cache:
        hit = _read_cached(cache_file, tag)
        if hit is not None:
            return hit
    if len(source) > MAX_SOURCE_BYTES:
        raise MeasurementError(
            "source_blowup", tag=tag, phase="codegen",
            detail=f"{len(source)} B > {MAX_SOURCE_BYTES} B cap")
    with tempfile.TemporaryDirectory(prefix="polytops_cc_") as td:
        csrc = Path(td) / f"{tag}.c"
        exe = Path(td) / tag
        csrc.write_text(source)
        gcc_cmd = " ".join(["gcc", str(csrc), "-o", str(exe)] + CFLAGS)
        try:
            fault_point("cc.compile")
            cp = subprocess.run(
                ["bash", "-c", f"ulimit -v {GCC_MEM_KB}; exec {gcc_cmd}"],
                capture_output=True, text=True, timeout=timeout,
            )
        except subprocess.TimeoutExpired:
            raise MeasurementError("compile_timeout", tag=tag,
                                   phase="compile",
                                   detail=f"gcc exceeded {timeout}s") from None
        except InjectedFault as e:
            raise MeasurementError("injected", tag=tag, phase="compile",
                                   detail=str(e)) from e
        if cp.returncode != 0:
            raise MeasurementError(
                "compile_failed", tag=tag, phase="compile",
                detail=f"gcc rc={cp.returncode}:\n{cp.stderr[:4000]}"
                       f"\n--- source ---\n{source[:4000]}")
        try:
            fault_point("cc.run")
            rp = subprocess.run([str(exe)], capture_output=True, text=True,
                                timeout=timeout)
        except subprocess.TimeoutExpired:
            raise MeasurementError("run_timeout", tag=tag, phase="run",
                                   detail=f"binary exceeded {timeout}s"
                                   ) from None
        except InjectedFault as e:
            raise MeasurementError("injected", tag=tag, phase="run",
                                   detail=str(e)) from e
        if rp.returncode != 0:
            raise MeasurementError("run_failed", tag=tag, phase="run",
                                   detail=f"rc={rp.returncode}: "
                                          f"{rp.stderr[:2000]}")
        try:
            out = rp.stdout.strip().split()
            seconds = float(out[out.index("TIME_S") + 1])
            checksum = float(out[out.index("CHECKSUM") + 1])
        except (ValueError, IndexError) as e:
            raise MeasurementError(
                "parse", tag=tag, phase="parse",
                detail=f"{e}: stdout={rp.stdout[:500]!r}") from None
    # written even under use_cache=False (matching the original
    # behaviour): a no-cache *read* run still warms the pool
    _write_cached(cache_file, seconds, checksum)
    return RunResult(seconds, checksum)


def measure_source(source: str, tag: str = "kernel", target_s: float = 0.15,
                   timeout: int = 900, use_cache: bool = True) -> RunResult:
    """compile_and_run plus the shared re-measurement policy: a result
    too fast to trust (< 20 ms) is re-run with an internal repeat loop
    sized to ~``target_s``.  The single policy used by both the
    benchmark harness and the autotuner, so winners are picked under
    the same measurement rules they are later reported with."""
    try:
        fault_point("measure")
    except InjectedFault as e:
        raise MeasurementError("injected", tag=tag, phase="measure",
                               detail=str(e)) from e
    r = compile_and_run(source, tag=tag, timeout=timeout, use_cache=use_cache)
    if r.seconds < 0.02:
        reps = max(3, min(200000, int(target_s / max(r.seconds, 1e-7))))
        src2 = source.replace("#define REPEATS 1\n", f"#define REPEATS {reps}\n")
        r = compile_and_run(src2, tag=f"{tag}_r", timeout=timeout,
                            use_cache=use_cache)
    return r


def checksums_match(got: float, ref: float, rel: float = 1e-6) -> bool:
    """NaN-aware checksum comparison (NaN only matches NaN) — shared by
    the benchmark checksum gate and the autotuner's oracle guard."""
    import math

    if math.isnan(got) or math.isnan(ref):
        return math.isnan(got) and math.isnan(ref)
    return abs(got - ref) <= rel * max(1.0, abs(ref))
