"""Kernel microbenchmarks and smoke gate of the port.

    PYTHONPATH=src python -m repro_torch.kernels.bench [--smoke] [--device cuda|cpu]

Ports ``src/repro/kernels/bench.py``.  ``--smoke`` is the numerical gate:
every kernel wrapper in :mod:`repro_torch.kernels.ops` runs at the
reference's smoke shapes (matmul 128³; causal flash attention over
(1, 128, 2, 64); the selective scan and the fused scan + skip + gate over
(1, 64, 128, 8), the latter whole and in two halves carried through
``h0``) and must agree with its oracle, or the exit status is 1.  Beside
each kernel stands its plan from :mod:`repro_torch.plan`, in the
reference's ``plan_*`` lines: loop order and vector iterator are the
reference scheduler's, the tiles are fitted to the card.

The smoke inputs are drawn from numpy under a seed (:func:`smoke_inputs`).  On
``cuda`` (the default; it raises without a card) the wrappers launch the
hand-written kernels and the oracles are the plain versions in
:mod:`repro_torch.kernels.ref` on the same operands: kernels A and B take
bf16 only, so they run on bf16 casts of the inputs and are held to
``MM_TOL`` / ``FA_TOL`` (``chip_smoke.py``'s tolerances), the f32 scans to
the reference's 1e-4.  On ``cpu`` the wrappers run those plain versions
themselves, in f32 at 1e-4: there the check has teeth only against
another oracle, and ``smoke(oracles=...)`` takes one (the CPU tests pass
the reference's jnp oracles).

Without ``--smoke``, :func:`run` times each wrapper at the reference's
benchmark shapes beside its plain version and, where one exists, the one
PyTorch call that computes the same function (``torch.matmul``,
``scaled_dot_product_attention``): CUDA events on the card; on the CPU
the host clock, and those are times of the plain versions, not of any
kernel.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..model.layers import device_of
from ..plan import plan_attention, plan_matmul, plan_mamba_scan, plan_scan_gate
from . import ops, ref

F32_TOL = 1e-4      # the reference bench's tolerance, for f32 operands
MM_TOL = 1e-2       # bf16 output rounding (chip_smoke.py MM_TOL)
FA_TOL = 2e-2       # the flash kernel rounds P to bf16 for P·V (chip_smoke.py FA_TOL)

#: name -> oracle on the wrapper's operands; flash attention in the public
#: (b, s, h, d) layout, causal
PLAIN: Dict[str, Callable] = {
    "matmul": ref.matmul_ref,
    "flash_attention": lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
    "selective_scan": ref.selective_scan_ref,
    "scan_gate": ref.scan_gate_ref,
}


def smoke_inputs() -> Dict[str, np.ndarray]:
    """The reference smoke's operands, f32, drawn from numpy under seed 0
    (the reference draws them from ``jax.random``)."""
    r = np.random.RandomState(0)

    def randn(*shape):
        return r.standard_normal(shape).astype(np.float32)

    bsz, s, di, st = 1, 64, 128, 8
    return {
        "a": randn(128, 128), "b": randn(128, 128),
        "q": randn(1, 128, 2, 64) * 0.3, "k": randn(1, 128, 2, 64) * 0.3,
        "v": randn(1, 128, 2, 64),
        "a_bar": 0.9 / (1.0 + np.exp(-randn(bsz, s, di, st))),
        "b_bar": randn(bsz, s, di, st) * 0.1, "c": randn(bsz, s, st),
        "x_skip": randn(bsz, s, di), "d_skip": randn(di), "z": randn(bsz, s, di),
    }


def _plan_line(name: str, plan) -> str:
    return f"{name},{'>'.join(plan.loop_order)},vec={plan.vector_iter} tiles={plan.tile}"


def smoke(out=None, device="cuda", oracles: Optional[Dict[str, Callable]] = None) -> int:
    """The numerical gate (see the module docstring).  ``oracles`` maps a
    :data:`PLAIN` name to a function of the wrapper's operands that
    returns what it must give (tensors or arrays); by default the plain
    versions.  Prints to ``out`` (stdout by default).  Returns the number
    of failures."""
    out = out or sys.stdout
    dev = device_of(device)
    oracles = {**PLAIN, **(oracles or {})}
    card = dev.type == "cuda"
    failures = 0

    def check(name, got, want, tol):
        nonlocal failures
        got = got.detach().float().cpu().numpy()
        want = np.asarray(want.detach().float().cpu() if torch.is_tensor(want) else want,
                          np.float32)
        err = float(np.max(np.abs(got - want)))
        ok = bool(np.allclose(got, want, rtol=tol, atol=tol))
        print(f"{name},{'PASS' if ok else 'FAIL'},max_abs_err={err:.3e},tol={tol:g}",
              file=out)
        failures += not ok

    x = {k: torch.from_numpy(v).to(dev) for k, v in smoke_inputs().items()}
    # kernels A and B take bf16 on the card
    half = (lambda t: t.to(torch.bfloat16)) if card else (lambda t: t)

    a, b = half(x["a"]), half(x["b"])
    print(_plan_line("plan_matmul", plan_matmul(*a.shape, b.shape[1])), file=out)
    check("matmul_smoke", ops.matmul(a, b), oracles["matmul"](a, b),
          MM_TOL if card else F32_TOL)

    q, k, v = half(x["q"]), half(x["k"]), half(x["v"])
    print(_plan_line("plan_attention", plan_attention(q.shape[1], k.shape[1], q.shape[3])),
          file=out)
    check("flash_attention_smoke", ops.flash_attention(q, k, v, causal=True),
          oracles["flash_attention"](q, k, v), FA_TOL if card else F32_TOL)

    abc = [x["a_bar"], x["b_bar"], x["c"]]
    _, s, di, st = x["a_bar"].shape
    print(_plan_line("plan_mamba_scan", plan_mamba_scan(s, di, st)), file=out)
    check("mamba_scan_smoke", ops.selective_scan(*abc), oracles["selective_scan"](*abc),
          F32_TOL)

    gate = abc + [x["x_skip"], x["d_skip"], x["z"]]
    print(_plan_line("plan_scan_gate", plan_scan_gate(s, di, st)), file=out)
    o_got, h_got = ops.scan_gate(*gate)
    o_want, h_want = oracles["scan_gate"](*gate)
    check("scan_gate_smoke", o_got, o_want, F32_TOL)
    check("scan_gate_state_smoke", h_got, h_want, F32_TOL)
    # the second half, carried through h0, against the whole sequence
    m = s // 2

    def rows(lo, hi):
        return [t if t.dim() == 1 else t[:, lo:hi] for t in gate]
    _, h1 = ops.scan_gate(*rows(0, m))
    o2, h2 = ops.scan_gate(*rows(m, s), h0=h1)
    check("scan_gate_chunk_carry_smoke", o2, o_want[:, m:], F32_TOL)
    check("scan_gate_chunk_state_smoke", h2, h_want, F32_TOL)

    print(f"kernel_smoke,{'PASS' if not failures else 'FAIL'},failures={failures},"
          f"device={torch.cuda.get_device_name(dev) if card else 'cpu'}", file=out)
    return failures


def _time_us(fn, dev: torch.device, reps: int = 10) -> float:
    """µs per call: CUDA events around ``reps`` calls on the card, the
    host clock on the CPU; after one warm-up call."""
    fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize(dev)
        return s.elapsed_time(e) / reps * 1e3
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e6


def run(out=None, device="cuda") -> None:
    """CSV of µs per call at the reference's benchmark shapes: the wrapper
    (the kernel on the card), its plain version and the library call."""
    out = out or sys.stdout
    dev = device_of(device)
    card = dev.type == "cuda"
    dt = torch.bfloat16 if card else torch.float32
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape, scale=1.0, dtype=torch.float32):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    def row(name, wrapper, plain, library, plan):
        lib = f"{_time_us(library, dev):.1f}" if library else "-"
        print(f"{name},{_time_us(wrapper, dev):.1f},{_time_us(plain, dev):.1f},{lib},{plan}",
              file=out)

    print(f"kernel,wrapper_us,plain_us,library_us,plan "
          f"(device {torch.cuda.get_device_name(dev) if card else 'cpu: plain versions'})",
          file=out)
    for n in (256, 512):
        a, b = randn(n, n, dtype=dt), randn(n, n, scale=n ** -0.5, dtype=dt)
        plan = plan_matmul(n, n, n)
        row(f"matmul_{n}x{n}x{n}", lambda: ops.matmul(a, b), lambda: ref.matmul_ref(a, b),
            lambda: torch.matmul(a, b),
            f"order={'>'.join(plan.loop_order)} tiles={plan.tile}")
    bsz, s, h, d = 1, 512, 4, 64
    q, k = randn(bsz, s, h, d, scale=0.3, dtype=dt), randn(bsz, s, h, d, scale=0.3, dtype=dt)
    v = randn(bsz, s, h, d, dtype=dt)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    plan = plan_attention(s, s, d)
    row(f"flash_attn_{s}", lambda: ops.flash_attention(q, k, v),
        lambda: ref.flash_attention_ref(q, k, v),
        lambda: F.scaled_dot_product_attention(qt, kt, vt, is_causal=True),
        f"bq={plan.tile['q']} bk={plan.tile['kk']} lanes={plan.vector_iter}")
    s, di, st = 128, 256, 16
    a_bar = torch.sigmoid(randn(1, s, di, st)) * 0.9
    b_bar, c = randn(1, s, di, st, scale=0.1), randn(1, s, st)
    x_skip, dk, z = randn(1, s, di), randn(di), randn(1, s, di)
    plan = plan_mamba_scan(s, di, st)
    row(f"mamba_scan_{s}", lambda: ops.selective_scan(a_bar, b_bar, c),
        lambda: ref.selective_scan_ref(a_bar, b_bar, c), None,
        f"chunk={plan.tile['t']} dblock={plan.tile['d']}")
    gate = (a_bar, b_bar, c, x_skip, dk, z)
    plan = plan_scan_gate(s, di, st)
    row(f"scan_gate_{s}", lambda: ops.scan_gate(*gate), lambda: ref.scan_gate_ref(*gate),
        None, f"chunk={plan.tile['t']} dblock={plan.tile['d']} fused-gate")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--smoke", action="store_true",
                    help="run the numerical smoke gate instead of timings")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the default: the hand-written kernels) or cpu "
                         "(their plain versions)")
    args = ap.parse_args(argv)
    if args.smoke:
        return 1 if smoke(device=args.device) else 0
    run(device=args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
