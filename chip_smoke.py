#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

1. build — compile ``src/repro_torch/csrc/*.cu`` for ``sm_90a``;
2. kernels — each kernel of the serving path against its plain PyTorch
   version on the card at the path's shapes, with the tolerance printed
   beside the measured error, and its time beside the plain version's,
   the one PyTorch call that computes the same function, and the bound
   (the larger of bytes over 3.35 TB/s and operations over 989 TFLOP/s,
   the H100 SXM's published bf16 peaks);
3. serve — ``granite_3_2b`` at full width in bf16 with seeded random
   weights through ``ContinuousEngine`` (chunk 256, 4 slots, 8 requests of
   256-1024 prompt tokens, 32 new tokens each), with the kernels' launch
   counts read around that run, and one ``chunk_step`` with the kernels
   held against the same step with them disabled.

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402

PEAK_BF16 = 989e12      # H100 SXM dense bf16 FLOP/s (data sheet)
PEAK_BYTES = 3.35e12    # H100 SXM HBM3 bytes/s (data sheet)
MM_TOL = dict(atol=1e-2, rtol=1e-2)      # f32 accumulation in both; bf16 output rounding
FA_TOL = dict(atol=2e-2, rtol=2e-2)      # the kernel rounds P to bf16 for P·V
# Logits after 40 bf16 layers: rounding differs per element, so the check
# is on the RMS of the difference relative to the logits' RMS, with a
# looser bound on the worst element; and against an f32 run of the same
# step, the kernels may be at most twice as far from it as the plain
# bf16 ops are (the flash kernel rounds P to bf16; the rest matches).
LOGIT_RMS_TOL = 0.05
LOGIT_MAX_TOL = 0.5
LOGIT_VS_F32 = 2.0

SERVE_PLENS = (1024, 300, 768, 256, 900, 512, 640, 1000)
SERVE_GEN = 32
SERVE_CHUNK = 256
SERVE_SLOTS = 4


class SmokeFailure(Exception):
    pass


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def bound_ms(nbytes: float, flops: float):
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_BF16
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


_L2_FLUSH = None


def time_ms(fn, iters: int = 20) -> float:
    """Mean device time of ``fn`` with L2 flushed before each call (the
    serving path finds each weight cold): CUDA events around each call."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(iters):
        _L2_FLUSH.zero_()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        pairs.append((s, e))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def compare(name: str, got: torch.Tensor, want: torch.Tensor, tol: dict) -> float:
    g, w = got.float(), want.float()
    require(bool(torch.isfinite(g).all()), f"{name}: non-finite output")
    err = (g - w).abs()
    max_abs = float(err.max())
    max_rel = max_abs / max(float(w.abs().max()), 1e-12)
    ok = bool((err <= tol["atol"] + tol["rtol"] * w.abs()).all())
    print(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
          f"tol(atol={tol['atol']}, rtol={tol['rtol']}) {'PASS' if ok else 'FAIL'}")
    require(ok, f"{name}: kernel disagrees with its plain version")
    return max_abs


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def phase_build() -> float:
    from repro_torch.kernels import build
    build.load_library()
    print(f"[build] csrc/{{{','.join(build.SOURCES)}}} for sm_90a in "
          f"{build.BUILD_SECONDS:.1f} s")
    return build.BUILD_SECONDS


def phase_matmul(gen: torch.Generator) -> dict:
    from repro_torch.kernels import matmul_polytops as mm
    from repro_torch.kernels import ref
    from repro_torch.plan import plan_matmul

    print("[kernels] matmul (csrc/matmul.cu) vs ref.matmul_ref")
    rec = None
    worst = 0.0
    for m, k, n in [(256, 2048, 8192), (256, 8192, 2048), (200, 2048, 8192),
                    (37, 70, 50)]:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        tile = plan_matmul(m, n, k).tile
        got = mm.matmul(a, b)
        torch.cuda.synchronize()
        worst = max(worst, compare(f"({m},{k})x({k},{n}) tiles={tile}", got,
                                   ref.matmul_ref(a, b), MM_TOL))
        ms = time_ms(lambda: mm.matmul(a, b))
        plain = time_ms(lambda: ref.matmul_ref(a, b))
        lib = time_ms(lambda: torch.matmul(a, b))
        bms, by = bound_ms((m * k + k * n + m * n) * 2, 2.0 * m * n * k)
        print(f"  time ({m},{k})x({k},{n}): kernel {ms:.4f} ms, plain "
              f"{plain:.4f} ms, torch.matmul {lib:.4f} ms, bound {bms:.4f} ms "
              f"({by})")
        if rec is None:
            rec = dict(name="matmul", route="cuda",
                       source="src/repro_torch/csrc/matmul.cu",
                       replaces="src/repro/kernels/matmul_polytops.py:60",
                       ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=lib)
    rec["max_abs_err"] = worst
    return rec


def phase_flash(gen: torch.Generator) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.plan import plan_attention

    print("[kernels] flash attention (csrc/flash_attention.cu) vs "
          "ref.flash_attention_ref")
    b, h, hkv, d, cache_len = 4, 32, 8, 64, 1088
    rec = None
    worst = 0.0
    for c, kv_len, off in [(256, 1024, 768), (256, 256, 0), (100, 1000, 900)]:
        q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(torch.bfloat16)
        # k/v are page-aligned prefixes of a KV cache, read in place as the
        # serving path reads them
        kc = torch.randn((b, cache_len, hkv, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        vc = torch.randn((b, cache_len, hkv, d), generator=gen,
                         device="cuda").to(torch.bfloat16)
        k, v = kc[:, :kv_len], vc[:, :kv_len]
        tile = plan_attention(c, kv_len, d).tile
        got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
        worst = max(worst, compare(
            f"b·h={b}·{h} hkv={hkv} c={c} kv_len={kv_len} q_offset={off} "
            f"tiles={tile}", got, want, FA_TOL))
        rows = off + torch.arange(c)
        pairs = int(torch.clamp(rows + 1, max=kv_len).sum()) * b * h
        mask = (off + torch.arange(c, device="cuda")[:, None]
                >= torch.arange(kv_len, device="cuda")[None, :])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off))
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, q_offset=off))
        lib = time_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True))
        nbytes = (2 * q.numel() + 2 * b * kv_len * hkv * d) * 2
        bms, by = bound_ms(nbytes, 4.0 * d * pairs)
        print(f"  time c={c} kv_len={kv_len} q_offset={off}: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms, bound "
              f"{bms:.4f} ms ({by})")
        if rec is None:
            rec = dict(name="flash_attention", route="cuda",
                       source="src/repro_torch/csrc/flash_attention.cu",
                       replaces="src/repro/kernels/flash_attention.py:96",
                       ms=ms, plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=lib)
    rec["max_abs_err"] = worst
    return rec


def phase_serve(gpu: str) -> dict:
    from repro_torch.configs.registry import get_arch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import matmul_polytops as mm
    from repro_torch.launch.serve import ContinuousEngine, Request
    from repro_torch.model import transformer as T
    from repro_torch.model.layers import make_generator

    cfg = get_arch("granite_3_2b")
    max_len = max(SERVE_PLENS) + SERVE_GEN + 32
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _leaves(params))
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} heads / {cfg.n_kv_heads} kv, head_dim {cfg.hd}, "
          f"d_ff {cfg.d_ff}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters, init {time.perf_counter() - t0:.1f} s")

    gen = make_generator(1, torch.device("cuda"))
    prompts = [torch.randint(2, cfg.vocab, (1, n), generator=gen, device="cuda")
               for n in SERVE_PLENS]
    eng = ContinuousEngine(cfg, params, SERVE_SLOTS, max_len, chunk=SERVE_CHUNK,
                           use_kernels=True, max_new=SERVE_GEN)
    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()
    mm.LAUNCHES = 0
    fa.LAUNCHES = 0
    t0 = time.perf_counter()
    ticks = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {"matmul": mm.LAUNCHES, "flash_attention": fa.LAUNCHES}

    require(all(r.done for r in reqs), "a request did not retire")
    require([len(r.generated) for r in reqs] == [SERVE_GEN] * len(reqs),
            f"token counts {[len(r.generated) for r in reqs]}")
    require(all(0 <= t < cfg.vocab for r in reqs for t in r.generated),
            "token id out of range")
    require(launches["matmul"] > 0 and launches["flash_attention"] > 0,
            f"a kernel was not launched on the main path: {launches}")
    ntok = SERVE_GEN * len(reqs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {len(reqs)} requests, prompts {list(SERVE_PLENS)}, {ntok} new "
          f"tokens in {dt:.3f} s: {ntok / dt:.1f} generated tok/s, "
          f"{(sum(SERVE_PLENS) + ntok) / dt:.1f} total tok/s")
    print(f"  ticks {ticks} (decode {eng.ticks_decode}, prefill "
          f"{eng.ticks_prefill}, overlap {eng.ticks_overlap}), overlap ratio "
          f"{eng.overlap_ratio():.3f}, page {eng.page}, peak memory "
          f"{peak:.2f} GiB, launches {launches}")
    print(f"  first tokens: {[r.generated[:4] for r in reqs[:3]]}")
    print(f"  card: {gpu}")

    check_chunk_step(cfg, params, prompts[0], max_len)
    profile_steps(cfg, params, max_len)
    return launches


def profile_steps(cfg, params, max_len) -> None:
    """Where a tick's time goes: host wall time (synchronized) against
    the device's busy time (sum of kernel times from ``torch.profiler``)
    for one prefill chunk and one decode step with the kernels on."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode
    from repro_torch.model.layers import make_generator

    dev = torch.device("cuda")
    gen = make_generator(2, dev)
    cache = T.init_cache(cfg, SERVE_SLOTS, max_len, dev)
    chunk = torch.randint(2, cfg.vocab, (1, SERVE_CHUNK), generator=gen, device=dev)
    tok = torch.randint(2, cfg.vocab, (SERVE_SLOTS, 1), generator=gen, device=dev)
    lens = torch.tensor([700, 300, 900, 512], device=dev)
    act = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=dev)
    steps = {
        "chunk step (256 rows at offset 512, kv 768)": lambda: T.chunk_step(
            params, cfg, chunk, T.cache_slot_view(cache, 1), 512, 768),
        "decode step (4 slots, kv 1024)": lambda: T.serve_decode_step(
            params, cfg, tok, cache, lens, act, 1024),
    }
    reps = 5
    with kernel_mode(enabled=True):
        for name, fn in steps.items():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / reps * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                for _ in range(reps):
                    fn()
                torch.cuda.synchronize()
            # kernel records only: a CPU op also carries the device time
            # of the kernels it launched, which would count them twice
            events = [e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA]
            busy = sum(e.self_device_time_total for e in events) / reps / 1e3
            require(busy > 0, f"{name}: the profiler saw no device time")
            top = sorted(events, key=lambda e: e.self_device_time_total,
                         reverse=True)[:4]
            tops = "; ".join(f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.3f} ms"
                             f" x{e.count // reps}" for e in top)
            print(f"  {name}: wall {wall:.2f} ms, device busy {busy:.2f} ms "
                  f"({busy / wall:.1%}), idle {1 - busy / wall:.1%}; top: {tops}")


def check_chunk_step(cfg, params, toks, max_len) -> None:
    """The prompt's first two chunks (offsets 0 and 256) through
    ``chunk_step`` three ways — with the kernels, with plain torch ops,
    and with plain ops on f32 copies of the weights — and the second
    chunk's logits compared."""
    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode

    def run(cfg_, params_, kernels):
        cache = T.init_cache(cfg_, 1, max_len, "cuda")
        with kernel_mode(enabled=kernels):
            T.chunk_step(params_, cfg_, toks[:, :256], cache, 0, 256)
            lg, _ = T.chunk_step(params_, cfg_, toks[:, 256:512], cache, 256, 512)
        return lg.float()

    kern = run(cfg, params, True)
    plain = run(cfg, params, False)
    f32 = run(cfg.scaled(dtype="float32"), _to_f32(params), False)
    torch.cuda.synchronize()
    require(bool(torch.isfinite(kern).all()), "chunk_step: non-finite logits")

    def rms(x):
        return float(x.pow(2).mean().sqrt())

    rel = rms(kern - plain) / rms(plain)
    worst = float((kern - plain).abs().max())
    e_kern, e_plain = rms(kern - f32) / rms(f32), rms(plain - f32) / rms(f32)
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    ok = (rel <= LOGIT_RMS_TOL and worst <= LOGIT_MAX_TOL
          and e_kern <= LOGIT_VS_F32 * e_plain)
    print(f"  chunk_step logits {tuple(kern.shape)} at offset 256, kernels vs "
          f"plain bf16: rms_rel={rel:.3e} (tol {LOGIT_RMS_TOL}) max_abs_err="
          f"{worst:.3e} (tol {LOGIT_MAX_TOL}); vs f32: kernels rms_rel="
          f"{e_kern:.3e}, plain rms_rel={e_plain:.3e} (tol {LOGIT_VS_F32}x); "
          f"argmax agreement {agree:.4f} {'PASS' if ok else 'FAIL'}")
    require(ok, "chunk_step with the kernels disagrees with the plain path")


def _to_f32(tree):
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_f32(v) for v in tree]
    return tree.float()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v)
    else:
        yield tree


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    import repro_torch  # noqa: F401  (fails without the repository's src/)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    gpu = gpu_line()
    print(f"card: {gpu}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    try:
        phase_build()
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        records = [phase_matmul(gen), phase_flash(gen)]
        launches = phase_serve(gpu)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    for rec in records:
        rec["launches"] = launches[rec["name"]]
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")
    print(json.dumps({"kernels": [{k: r[k] for k in keys} for r in records]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
