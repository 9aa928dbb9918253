#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

0. plans — every kernel plan the later phases make, through the port's
   PolyTOPS scheduler (``repro_torch.core``: SCoP, exact ILP schedule
   through the degradation ladder, schedule tree, Hopper lowering) against
   a fresh schedule-cache directory under ``build/``, once cold and once
   from the cache's disk tier: the matmul, flash and scan cases below, the
   kernel bench's shapes and each served model's traffic
   (``launch.serve.kernel_plan_shapes`` at chunk rows 44-4096).  Every
   plan is printed (order, vector iterator, tile, bands, ``degraded``) and
   must have its operator's order and vector iterator, no degradation,
   and the tile in ``PLAN_TILES``, the tiles the kernels were planned
   with before the scheduler was in the loop, so every later launch is as
   it was.  The host seconds per planner, cold and disk-warm, are printed
   beside the card's name and power limit.  Each serve phase warms its
   traffic's plans again (``warm_kernel_plans``) before its timed runs
   and prints that time apart from the serve walls;
0a. schedd — the port's scheduling daemon (``python -m
   repro_torch.launch.schedd``, 4 forked workers) runs as a subprocess
   for the whole run, on a short socket under /tmp and fresh caches under
   ``build/chip_smoke_schedd``; it never imports ``torch``, and this
   process, which holds the card, never forks it.  A client subprocess
   plans every phase 0 case through it (cold: the daemon's workers
   compute), then a second one again (warm: the daemon's frames answer,
   no computation).  Each plan must equal phase 0's (order, vector
   iterator, tile, bands, schedule string), each client must count all
   of them answered by the daemon, no fallback and no degraded plan; the
   clients' host seconds and the daemon's counters and frame bytes are
   printed.  From here on ``$POLYTOPS_TORCH_SCHEDD_SOCK`` names the
   daemon, and every serve phase warms its plans through it with the
   in-process memos cleared first: each must print ``via schedd`` with
   every plan answered remotely and no fallback;
0b. autotune — the measured autotuner through the daemon's ``autotune``
   op at PolyBench SIZE for gemm, gesummv, jacobi1d, jacobi2d, mvt and
   trmm (``scripts/golden_schedules.py``'s ``AUTOTUNE_KERNELS``): per
   kernel the winner, its ranker, µs per call and checksum, the µs of
   the pluto configuration's C build and of the original order, and the
   failures; every candidate must checksum-match the original order, no
   result may be degraded, the static winner must equal its golden
   ``__autotune`` file, a repeated request must be a frame hit and the
   winner's replay from the daemon's pool ``source == "cache"``, each in
   under 1 s.  Times are host CPU times (gcc ``-O3 -march=native
   -fopenmp``), printed with the host's CPU model and the card line; the
   kernels past a 180 s budget are left out and named;
1. build — compile ``src/repro_torch/csrc/*.cu`` for ``sm_90a``, and
   print the matmul and flash kernels' registers and spills
   (``-Xptxas -v``);
2. kernels — each kernel against its plain PyTorch version on the card
   at the serving paths' shapes, with the tolerance printed beside the
   measured error, and its time beside the plain version's, the one
   PyTorch call that computes the same function (where there is one),
   and the bound (the larger of bytes over 3.35 TB/s and operations over
   the H100 SXM's published peak for their type: 989 TFLOP/s bf16 on the
   tensor cores, 67 TFLOP/s f32 on the CUDA cores for the scans).  Times
   are device times with L2 flushed, the events queued behind a device
   delay so no host latency falls between them (``time_ms``); beside the
   kernel and the library call stands the host's µs per call
   (``host_us``).  The matmul and flash kernels must give the same bits
   on two launches with the same inputs, and flash the same bits again
   with its offset from a device scalar, and as one slot (batch row 1) of
   a larger cache with offset and row from device scalars, the serving
   chunk's launch.  The matmul cases include
   gemma3's MLP shapes, seamless's (its encoder's over 4096 stub
   frames) and qwen2-vl's (a 256-row chunk and its 768-row prefill); the
   flash cases the ragged chunks granite's, qwen3-moe's, gemma3's,
   seamless's and qwen2-vl's traffic send (head dims 64, 128 and 256; 16
   heads over 16 KV heads for seamless, 28 over 4 for qwen2-vl), a gemma3
   chunk over a 1536-row prefix and the prefills of seamless (512 rows)
   and qwen2-vl (768); beside them
   stand which backend ``scaled_dot_product_attention`` takes for the
   library call and each backend's time, and, for both kernels, a sweep
   of the launch geometry at the serving shapes (for flash the ring
   depth, at head dims 64, 128 and 256).  Last, the port's kernel bench
   (``repro_torch.kernels.bench``): its smoke gate, every kernel at the
   reference bench's smoke shapes against its plain version, must count
   no failure, and its timings are printed;
3. serve — ``granite_3_2b`` at full width in bf16 with seeded random
   weights through ``ContinuousEngine`` (chunk 256, 4 slots, 8 requests of
   256-1024 prompt tokens, 32 new tokens each), served twice by one
   engine: first with every tick as eager ops (``cuda_graphs=False``),
   then, after ``reset``, with every decode and chunk tick a replay of a
   captured CUDA graph, the main path, whose greedy tokens must equal the
   eager run's and in which every chunk tick must be a replay.  Around
   each run every kernel's launch count is set to 0 just before and read
   just after, with the same exact expectations (a replay adds the
   launches its capture recorded); both walls and tok/s, the graphs
   captured (decode graphs by kv bucket, chunk graphs by chunk length and
   kv bucket), their capture seconds and their pool's bytes are printed.
   Then one ``chunk_step`` with the kernels held against the same step
   with them disabled and against f32 weights, and a profile of one chunk
   step and one decode step (eager), and through the engine one chunk
   tick eager and as a replay, one decode tick and a 16-step
   ``_decode_k`` loop as graph replays; one replayed decode tick's logits
   against one eager tick's from the same state (maximum absolute
   difference printed); and one chunk graph (128 rows, kv bucket 1024)
   replayed at offsets 800 and 896 of a slot, each held bit for bit
   against an eager chunk tick from the same state (last-row logits, the
   slot's KV rows, lengths, tokens, token buffer and positions, and the
   Mamba layers' conv and SSM states).  Capturing a graph first runs one
   eager tick in sync debug mode "error" (a host sync in the tick fails
   the run); a decode capture fails if a hand-written kernel launched:
   none runs inside a decode tick at these shapes;
4. serve — the same for ``falcon_mamba_7b`` at full width and depth
   (64 Mamba layers, d_model 4096), after granite's engine and weights
   are freed.  Every prefill chunk of that traffic has 32 rows or more,
   so every chunk tick launches the scan+gate kernel once per layer;
5. serve — the same for ``gemma3_4b`` at full width and depth (34
   layers, head dim 256, a 1024-token window on the 29 local layers),
   after falcon's engine and weights are freed.  Its 5 global layers
   send every chunk to the flash kernel (local layers take the plain
   windowed path, as in the reference), so flash launches are 5 per
   chunk tick; the chunk-step check runs a 1536-token prompt and
   compares the chunk at offset 1280 as well, where the window cuts the
   local layers' prefix and flash reads 1536 kv rows;
6. serve — the same for ``qwen3_moe_30b_a3b`` at full width and depth
   (48 layers, head dim 128 with 32 heads over 4 KV heads, 128 experts
   top-8 of d_ff 768 on every layer; 30.5 B parameters, about 61 GB in
   bf16), after gemma3's engine and weights are freed.  Every chunk
   goes to the flash kernel on all 48 layers, so flash launches are 48
   per chunk tick; the experts run as batched einsums over all 128 of
   them, as in the reference, and no path of this model takes the
   matmul kernel.  The chunk-step check prints how many (token, k)
   expert picks differ between its runs, and the kernels' distance from
   the plain run when they take the plain run's picks;
7. encoder-decoder — ``seamless_m4t_large_v2`` at full width and depth
   (24 encoder and 24 decoder layers, d_model 1024, 16 heads over 16 KV
   heads of head dim 64, d_ff 8192; 2.036 B parameters), after
   qwen3-moe's engine and weights are freed.  (a) Its own path through
   ``make_prefill_step`` and ``make_serve_step``: a 4096-frame bf16 stub
   and a 512-token prompt prefilled with the kernels on (the MLP's three
   products through the matmul kernel in all 48 layers, the decoder's
   causal attention through flash in its 24; the encoder's and the cross
   attention are plain, as in the reference), memory computed as the
   prefill computes it, and 16 greedy decode steps with memory from the
   merged prefill cache, which launch no kernel.  The prefill's logits are
   held against the same prefill with the kernels off and against an f32
   run, and a teacher-forced ``forward`` over the prompt and the fed
   tokens against the prefill's and every decode step's logits; the
   encoder, the whole prefill and one decode step are profiled beside
   their bounds (``model_work``).  (b) ``phase_serve``: the engine serves
   its decoder alone, as the reference's does (its steps have no cross
   attention), with the same traffic and checks as phases 3-6;
8. vision-language — ``qwen2_vl_7b`` at full width and depth (28 layers,
   d_model 3584, 28 heads over 4 KV heads of head dim 128, d_ff 18944,
   M-RoPE, a 256-row vision stub; 7.628 B parameters), after seamless's
   engine and weights are freed.  (a) Its own path through
   ``make_prefill_step`` and ``make_serve_step``: a (1, 256, 3584) bf16
   stub and a 512-token prompt prefilled with the kernels on (the MLP's
   three products through the matmul kernel and the causal attention
   through flash in all 28 layers, 768 rows), then 16 greedy decode steps
   at M-RoPE positions (L, L, L), which launch no kernel.  The prefill's
   logits are held against the same prefill with the kernels off and
   against an f32 run, and the decode steps' logits against plain bf16
   decode steps fed the same tokens from the plain prefill's cache.  No
   teacher-forced check: the reference gives a decode step other M-RoPE
   positions than ``forward`` gives the same row.  The prefill and one
   decode step are profiled beside their bounds (``model_work``).
   (b) ``phase_serve``: the engine serves it with plain rope, as the
   reference's does (its steps pass no M-RoPE positions), with the same
   traffic and checks as phases 3-7;
9. train — the training path (``transformer.lm_loss``, ``train.steps``,
   ``optim.adamw``, ``train.checkpoint``, ``Trainer``) on
   ``granite_3_2b``, after qwen2-vl's engine and weights are freed, with
   the kernel mode off, as the reference trains: (a) two train steps in
   f32 at full width and 2 layers (batch 2, seq 128) on the card and on
   the CPU from the same weights and batches, the losses and gradient
   norms held together; (b) the ``Trainer`` at full width and depth in
   bf16 (batch 8, seq 256, ``REMAT="full"``) for 8 steps, every loss
   and gradient norm finite and the last loss at least 0.05 below the
   first, with the medians over steps 2-8 of step wall, tokens/s, the
   model FLOPs share (6·N·tokens per step against the bf16 peak), the
   forward+backward and AdamW device spans (CUDA events; the update
   against its bytes bound), one step's device busy against its wall
   (profiler) and peak memory; then two steps with ``REMAT="none"``;
   (c) two steps, ``save``, ``restore`` into a fresh ``Trainer`` and a
   third step, at full width and 2 layers, against three steps without
   the interruption: loss and gradient norm within 1e-6, and whether
   they and every parameter are bit-identical.  No kernel launch count
   may move in this phase;
10. distributed — the port's distributed half (``model.sharding``,
   ``launch.mesh``, ``launch.dryrun``, ``launch.roofline``), after
   phase 9: (a) granite's full-width bf16 train step (phase 9's batch 8 x
   seq 256, ``REMAT="full"``) for 4 steps unsharded, then from the same
   weights on a one-rank NCCL group's 1x1 ("data", "model") mesh with
   parameters, AdamW state and batch as DTensors placed by
   ``param_pspecs`` and ``batch_pspec``: losses and gradient norms within
   phase 9's tolerances (and whether they are bit-identical), both
   steps' walls (DTensor's host cost) and peak memory; the group is
   destroyed in a ``finally``.  A one-rank mesh runs no collective across
   ranks, so this checks placements and dispatch, not collectives;
   (b) the dry-run CLI (``python -m repro_torch.launch.dryrun``) for
   qwen3_0_6b decode_32k on both meshes and granite_3_2b train_4k on the
   16x16 mesh, run as subprocesses on fake process groups of 256 and 512
   ranks from the start of phase 1 on (one host core each; they need no
   card): each cell must be ``ok`` with 256 or 512 devices, and its bytes
   per device, per-device FLOPs and bytes, collective bytes and
   bottleneck are printed; (c) ``roofline.model_flops`` of the (a) step
   against the FLOPs the step ran (``dryrun.DeviceCounter``), the
   reference's ``model_flops_frac``.  No kernel launches in this phase.

The chunk-step check carries the cache each chunk returns into the next
(each Mamba state copied, so no view of a whole chunk's f32 states stays
alive), and its f32 leg casts one layer at a time to f32 as the walk
reaches it: a whole f32 copy of qwen3-moe's weights would need some
122 GB.

The selective-scan kernel runs on no model path (the reference's
non-fused Mamba route is plain jnp), so phase 2 alone launches it.

The last lines are the ``{"kernels": [...]}`` record, the card's name and
power limit, and ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the repository's ``src/`` beside it, it exits nonzero
and prints no result.
"""
from __future__ import annotations

import gc
import json
import math
import os
import shutil
import statistics
import subprocess
import sys
import time
from contextlib import contextmanager

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

import torch  # noqa: E402
import torch.nn.functional as F  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

# the H100's data-sheet peaks and the bounds built on them (fails without
# the repository's src/)
from repro_torch.launch.roofline import (HBM_BW as PEAK_BYTES, PEAK_BF16,  # noqa: E402
                                         PEAK_F32, bound_ms, work_bound)

MM_TOL = dict(atol=1e-2, rtol=1e-2)      # f32 accumulation in both; bf16 output rounding
FA_TOL = dict(atol=2e-2, rtol=2e-2)      # the kernel rounds P to bf16 for P·V
# The scans run in f32 in both versions; they differ in the fused
# multiply-add of the recurrence and the order of the 16-lane sum, so f32
# results agree to 1e-4 (the reference bench's tolerance) and a bf16 output
# to one bf16 rounding step.
SCAN_TOL = dict(atol=1e-4, rtol=1e-4)
SCAN_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
# Logits after 40 bf16 layers: rounding differs per element, so the check
# is on the RMS of the difference relative to the logits' RMS, with a
# looser bound on the worst element; and against an f32 run of the same
# step, the kernels may be at most twice as far from it as the plain
# bf16 ops are (the flash kernel rounds P to bf16; the rest matches).
LOGIT_RMS_TOL = 0.05
LOGIT_MAX_TOL = 0.5
LOGIT_VS_F32 = 2.0
# After 64 bf16 Mamba layers the plain path alone lies some 6% RMS from the
# f32 run (its residual stream, conv output and gate round to bf16 in every
# layer), and the scan+gate kernel applies the skip and gate in f32 before
# it rounds, as the reference's kernel does (scan_gate.py:49), where the
# plain path rounds y first (ssm.py:165-166).  There the fixed bounds above
# do not apply: the kernels may differ from the plain bf16 path by at most
# LOGIT_VS_F32 times the plain path's own distance from the f32 run (RMS
# and worst element), besides being no more than LOGIT_VS_F32 times as far
# from f32 as the plain path.

SERVE_PLENS = (1024, 300, 768, 256, 900, 512, 640, 1000)
SERVE_GEN = 32
SERVE_CHUNK = 256
SERVE_SLOTS = 4
SERVE_MAX_LEN = max(SERVE_PLENS) + SERVE_GEN + 32


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


_L2_FLUSH = None
_CYCLES_PER_US = None


def _event() -> torch.cuda.Event:
    return torch.cuda.Event(enable_timing=True)


def _hold(us: float) -> torch.cuda.Event:
    """Queue a device-side delay of about ``us`` µs (``torch.cuda._sleep``,
    calibrated once against CUDA events) and return an event recorded
    after it.  Work the host queues while that event is pending starts
    on the device back to back, without waiting on the host."""
    global _CYCLES_PER_US
    if _CYCLES_PER_US is None:
        torch.cuda._sleep(1000)
        s, e = _event(), _event()
        s.record()
        torch.cuda._sleep(2_000_000)
        e.record()
        torch.cuda.synchronize()
        _CYCLES_PER_US = 2e6 / (s.elapsed_time(e) * 1e3)
    torch.cuda._sleep(int(us * _CYCLES_PER_US))
    done = torch.cuda.Event()
    done.record()
    return done


def time_ms(fn, iters: int = 20, cover: bool = True) -> float:
    """Mean device time of ``fn`` with L2 flushed before each call (the
    serving path finds each weight cold): CUDA events around each call.

    Each iteration first queues a device-side delay that outlasts the
    host's enqueue of flush, start event, call and end event, so the
    events bracket device work only and not the wrapper's host latency.
    If a delay ran out before its iteration was queued, the run is
    repeated with longer delays; with ``cover`` it fails if that never
    holds.  ``cover=False`` is for plain versions that are host-driven
    loops of thousands of launches, which a delay may not cover: the
    calls it did not cover are counted in a printed note, and their
    times include the host's gaps."""
    global _L2_FLUSH
    if _L2_FLUSH is None:
        _L2_FLUSH = torch.empty(64 * 2**20, dtype=torch.uint8, device="cuda")
    fn()
    torch.cuda.synchronize()
    s, e = _event(), _event()
    t0 = time.perf_counter()
    _L2_FLUSH.zero_()
    s.record()
    fn()
    e.record()
    delay_us = 2e6 * (time.perf_counter() - t0) + 50.0
    torch.cuda.synchronize()
    for _ in range(3):
        pairs, late = [], 0
        for _ in range(iters):
            held = _hold(delay_us)
            _L2_FLUSH.zero_()
            s, e = _event(), _event()
            s.record()
            fn()
            e.record()
            late += held.query()
            pairs.append((s, e))
        torch.cuda.synchronize()
        if late == 0 or not cover:
            break
        delay_us *= 4
    require(late == 0 or not cover,
            f"timing: the device delay ran out before the host queued "
            f"{late} of {iters} calls")
    if late:
        print(f"  note: {late} of {iters} timed calls outran the device delay; "
              f"their times include host gaps")
    return sum(s.elapsed_time(e) for s, e in pairs) / iters


def host_us(fn, n: int = 50) -> float:
    """Host µs per call of ``fn`` (the wrapper's checks, plan and launch)
    over ``n`` calls queued while the device is held busy, so no call
    waits on the card."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    hold_us = 4e6 * n * (time.perf_counter() - t0) + 200.0
    torch.cuda.synchronize()
    for _ in range(3):
        held = _hold(hold_us)
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        dt = time.perf_counter() - t0
        late = held.query()
        torch.cuda.synchronize()
        if not late:
            return dt / n * 1e6
        hold_us *= 4
    raise SmokeFailure("host timing: the device delay ran out")


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

def phase_plans(gpu: str) -> dict:
    """Plan every shape the later phases launch (:func:`plan_cases`)
    through the port's PolyTOPS scheduler, against a fresh schedule-cache
    directory under ``build/``: once cold, then again from the disk tier
    (memory tier and plan memos cleared).  Each plan must have its tile
    in :data:`PLAN_TILES`, its operator's loop order and vector iterator
    (:data:`PLAN_ORDERS`) and no degradation.  Prints every plan and the
    host seconds per planner, cold and disk-warm; returns the plans by
    ``(planner, args)``."""
    from repro_torch import plan as P
    from repro_torch.core import akg, schedcache

    cache_dir = os.path.join(ROOT, "build", "chip_smoke_sched")
    shutil.rmtree(cache_dir, ignore_errors=True)
    os.environ["POLYTOPS_TORCH_CACHE_DIR"] = cache_dir
    require(schedcache.global_cache().dir == cache_dir,
            f"the schedule cache is not at {cache_dir}")
    planners = {name: getattr(P, f"plan_{name}") for name in PLAN_ORDERS}
    cases = plan_cases()
    print(f"[plans] {len(cases)} plans through the port's scheduler (cache {cache_dir})")
    seconds, plans = {}, {}
    for run in ("cold", "disk-warm"):
        if run == "disk-warm":
            schedcache.global_cache().clear()
            for fn in planners.values():
                fn.cache_clear()
        times = dict.fromkeys(planners, 0.0)
        for name, args in cases:
            t0 = time.perf_counter()
            plan = planners[name](*args)
            times[name] += time.perf_counter() - t0
            if run == "cold":
                print(f"  {name}{args}: order {'>'.join(plan.loop_order)}, vec "
                      f"{plan.vector_iter}, tile {plan.tile}, bands {plan.bands}, "
                      f"degraded {plan.degraded}")
            require(not plan.degraded, f"plan_{name}{args} degraded: {plan.degrade_reasons}")
            require((plan.loop_order, plan.vector_iter) == PLAN_ORDERS[name],
                    f"plan_{name}{args}: order {plan.loop_order}, vec {plan.vector_iter}, "
                    f"expected {PLAN_ORDERS[name]}")
            require(plan.tile == PLAN_TILES[name, args],
                    f"plan_{name}{args}: tile {plan.tile}, frozen {PLAN_TILES[name, args]}")
            plans[name, args] = plan
        seconds[run] = times
        counts = {name: sum(n == name for n, _ in cases) for name in planners}
        print(f"  {run}: " + ", ".join(f"{name} {times[name]:.3f} s ({counts[name]} plans)"
                                       for name in planners)
              + f"; total {sum(times.values()):.3f} s (host seconds; card: {gpu})")
    stats = schedcache.global_cache().stats.as_dict()
    print(f"  every tile equal to the frozen table, no plan degraded; schedule cache "
          f"{stats}, plan memos {akg.plan_memo_stats()}")
    return plans


# ---------------------------------------------------------------------------
# the scheduling daemon: plans and the measured autotuner through it
# ---------------------------------------------------------------------------

SCHEDD_DIR = os.path.join(ROOT, "build", "chip_smoke_schedd")
SCHEDD_WORKERS = 4
#: scripts/golden_schedules.py's AUTOTUNE_KERNELS, at the suite's SIZE
AUTOTUNE_KERNELS = ("gemm", "gesummv", "jacobi1d", "jacobi2d", "mvt", "trmm")
AUTOTUNE_BUDGET_S = 180.0
#: the client subprocess of phase_schedd: plans every case of the JSON
#: file argv[1] through the daemon named by $POLYTOPS_TORCH_SCHEDD_SOCK
SCHEDD_CLIENT = r"""
import json, sys, time
from repro_torch import plan as P
from repro_torch.core.schedclient import maybe_client
cases = json.load(open(sys.argv[1]))
client = maybe_client()
assert client is not None, "no daemon configured"
out, t0 = [], time.perf_counter()
for name, args in cases:
    p = getattr(P, "plan_" + name)(*args)
    out.append([name, args, list(p.loop_order), p.vector_iter, p.tile, list(p.bands),
                p.schedule_str, p.degraded])
print(json.dumps({"seconds": time.perf_counter() - t0, "plans": out,
                  "stats": client.stats.as_dict(),
                  "torch": "torch" in sys.modules,
                  "repro": [m for m in sys.modules if m.split(".")[0] == "repro"]}))
"""


def schedd_env(**extra) -> dict:
    return dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), **extra)


@contextmanager
def schedd_daemon():
    """The port's daemon as a subprocess (never in this process: its
    worker pool forks, and this process holds the card's context) on a
    short socket under /tmp, with fresh schedule, frame and compile
    caches under ``build/``.  Yields the socket path; stops the daemon
    and its workers on the way out."""
    import tempfile

    from repro_torch.core.schedclient import (DaemonUnavailable, ProtocolError,
                                              SchedClient)

    shutil.rmtree(SCHEDD_DIR, ignore_errors=True)
    os.makedirs(SCHEDD_DIR)
    sdir = tempfile.mkdtemp(prefix="sd-", dir="/tmp")
    sock = os.path.join(sdir, "s.sock")
    log = open(os.path.join(SCHEDD_DIR, "schedd.log"), "w")
    # the C builds' result cache, the daemon's and this process's
    os.environ["POLYTOPS_TORCH_CC_CACHE"] = os.path.join(SCHEDD_DIR, "c_builds")
    proc = subprocess.Popen(
        [sys.executable, "-m", "repro_torch.launch.schedd", "--sock", sock,
         "--cache-dir", SCHEDD_DIR, "--workers", str(SCHEDD_WORKERS)],
        env=schedd_env(POLYTOPS_TORCH_CACHE_DIR=SCHEDD_DIR),
        stdout=log, stderr=subprocess.STDOUT)
    try:
        client = SchedClient(sock, retries=0)
        t0 = time.perf_counter()
        while True:
            require(proc.poll() is None, f"the daemon exited with {proc.returncode}")
            try:
                client.ping(timeout=1.0)
                break
            except (DaemonUnavailable, ProtocolError):
                require(time.perf_counter() - t0 < 60, "the daemon did not listen in 60 s")
                time.sleep(0.1)
        client.close()
        print(f"[schedd] daemon pid {proc.pid} listening on {sock} after "
              f"{time.perf_counter() - t0:.3f} s ({SCHEDD_WORKERS} workers, cache {SCHEDD_DIR})")
        yield sock
    finally:
        try:
            SchedClient(sock, retries=0).shutdown()
            proc.wait(timeout=30)
        except Exception:
            pass
        if proc.poll() is None:
            proc.terminate()
            try:
                proc.wait(timeout=10)
            except subprocess.TimeoutExpired:
                proc.kill()
                proc.wait(timeout=10)
        log.close()
        shutil.rmtree(sdir, ignore_errors=True)
        print(f"[schedd] daemon stopped (exit {proc.returncode})")


def daemon_stats(sock: str) -> dict:
    from repro_torch.core.schedclient import SchedClient

    client = SchedClient(sock, retries=0)
    try:
        return client.daemon_stats()
    finally:
        client.close()


def phase_schedd(gpu: str, sock: str, plans: dict) -> None:
    """Plan every case of :func:`plan_cases` through the daemon from two
    client subprocesses in turn: the first cold (the daemon's workers
    compute), the second warm (its frames answer).  Each plan must equal
    phase 0's (order, vector iterator, tile, bands, schedule string), and
    each client must count every plan answered by the daemon, no
    fallback and no degraded plan; the second client may cause no new
    computation.  Prints each client's host seconds and the daemon's
    stats."""
    cases = plan_cases()
    path = os.path.join(SCHEDD_DIR, "cases.json")
    with open(path, "w") as f:
        json.dump(cases, f)
    print(f"[schedd] {len(cases)} plans through the daemon from two client processes")
    for run in ("cold", "warm"):
        before = daemon_stats(sock)["counters"]
        t0 = time.perf_counter()
        out = subprocess.run([sys.executable, "-c", SCHEDD_CLIENT, path],
                             env=schedd_env(POLYTOPS_TORCH_SCHEDD_SOCK=sock,
                                            POLYTOPS_TORCH_CACHE_DIR=os.path.join(
                                                SCHEDD_DIR, f"client_{run}")),
                             capture_output=True, text=True, timeout=600)
        wall = time.perf_counter() - t0
        require(out.returncode == 0, f"{run} client failed: {out.stderr[-2000:]}")
        got = json.loads(out.stdout.strip().splitlines()[-1])
        st = daemon_stats(sock)
        counters = st["counters"]
        computed = counters["computed"] - before["computed"]
        frame_hits = counters["frame_hits"] - before["frame_hits"]
        cs = got["stats"]
        print(f"  {run} client: {got['seconds']:.3f} s planning ({wall:.3f} s with its "
              f"start; host seconds; card: {gpu}); remote_ok {cs['remote_ok']}, fallbacks "
              f"{cs['fallbacks']}, dials {cs['dials']}; daemon computed {computed}, frame "
              f"hits {frame_hits}; torch imported: {got['torch']}")
        print(f"  daemon: counters {counters}, pool {st['pool']}, frames "
              f"{ {k: st['frames'][k] for k in ('entries', 'bytes', 'retained_latency_s')} }")
        require(cs["remote_ok"] == len(cases) and cs["fallbacks"] == 0,
                f"{run} client: remote_ok {cs['remote_ok']} of {len(cases)}, fallbacks "
                f"{cs['fallbacks']}")
        require(not got["repro"], f"{run} client imported {got['repro']}")
        if run == "warm":
            require(computed == 0, f"the warm client caused {computed} computations")
        for name, args, order, vec, tile, bands, sched_str, degraded in got["plans"]:
            want = plans[name, tuple(args)]
            require(not degraded, f"{run}: plan_{name}{tuple(args)} degraded")
            require((tuple(order), vec, tile, tuple(bands), sched_str)
                    == (want.loop_order, want.vector_iter, want.tile, want.bands,
                        want.schedule_str),
                    f"{run}: plan_{name}{tuple(args)} from the daemon differs from phase 0's")
    print(f"  every plan equal to phase 0's in both clients, none degraded, no fallback")


def host_cpu() -> str:
    """The host CPU as /proc/cpuinfo names it (model name, vendor, family
    and model numbers; a sandboxed host may give its name as "unknown"),
    with the machine's architecture."""
    import platform

    info = {}
    with open("/proc/cpuinfo") as f:
        for line in f:
            key, _, value = line.partition(":")
            info.setdefault(key.strip(), value.strip())
    return (f"{info.get('model name', 'unknown')} ({info.get('vendor_id', '?')} family "
            f"{info.get('cpu family', '?')} model {info.get('model', '?')}, "
            f"{platform.machine()})")


def phase_autotune(gpu: str, sock: str) -> None:
    """The measured autotuner through the daemon's ``autotune`` op
    (``measure=True``) at the suite's SIZE for :data:`AUTOTUNE_KERNELS`,
    on the daemon's fresh cache.  Per kernel: the winner's label, ranker,
    µs per call and checksum, the µs of the pluto configuration's C build
    and of the original order (built and measured here), and the failures
    list.  Requires no degraded result, no checksum mismatch among the
    candidates, the winner's and pluto's checksums equal to the original
    order's, the static winner (``measure=False``) equal to the golden
    ``__autotune`` file, a repeated request answered by the daemon's
    frames in under 1 s, and the winner replayed from the daemon's pool
    (``source == "cache"``) in under 1 s.  Kernels past the budget of
    AUTOTUNE_BUDGET_S are left out and named.  Times are host CPU times
    of gcc-built C on the card's host."""
    from repro_torch.core import crunner
    from repro_torch.core import scops_polybench as PB
    from repro_torch.core.autotune import (SPACE_VERSION, TunedConfig, _original_reference,
                                           autotune, build_source)
    from repro_torch.core.cachemodel import CacheSpec
    from repro_torch.core.ilp import SOLVER_TAG
    from repro_torch.core.schedcache import ScheduleCache
    from repro_torch.core.schedclient import SchedClient
    from repro_torch.core.scheduler import schedule_scop

    host = (f"host CPU {host_cpu()}, {os.cpu_count()} cores, gcc "
            f"{crunner.compiler_version()}; card: {gpu}")
    print(f"[autotune] {len(AUTOTUNE_KERNELS)} PolyBench kernels at SIZE through the "
          f"daemon's autotune op, measured (CFLAGS {' '.join(crunner.CFLAGS)}); {host}")
    client = SchedClient(sock, retries=0, request_timeout=600.0)
    t_phase = time.perf_counter()
    done = []
    for name in AUTOTUNE_KERNELS:
        if time.perf_counter() - t_phase > AUTOTUNE_BUDGET_S:
            break
        t0 = time.perf_counter()
        r = client.autotune(PB.REGISTRY[name](), measure=True)
        t_tune = time.perf_counter() - t0
        require(client.stats.fallbacks == 0, f"{name}: the autotune request fell back")
        scop = PB.REGISTRY[name]()
        orig = _original_reference(scop, {sc: 1.0 for sc in scop.scalars}, use_cache=False)
        pluto_tc = TunedConfig("pluto")
        pluto = crunner.measure_source(
            build_source(scop, pluto_tc, schedule_scop(scop, pluto_tc.scheduler_config()),
                         {sc: 1.0 for sc in scop.scalars}),
            tag=f"smoke_{name}_pluto", use_cache=False)
        print(f"  {name} {scop.params}: winner {r.config.label} ({r.source}, ranker "
              f"{r.ranker}) {r.seconds * 1e6:.1f} us/call, checksum {r.checksum!r}; pluto "
              f"{pluto.seconds * 1e6:.1f} us/call (checksum {pluto.checksum!r}); original "
              f"order {orig.seconds * 1e6:.1f} us/call (checksum {orig.checksum!r}); "
              f"pluto/winner {pluto.seconds / r.seconds:.3f}x; search {t_tune:.3f} s; "
              f"failures {r.failures}")
        require(r.source == "measured" and not r.degraded,
                f"{name}: source {r.source}, degraded {r.degraded}: {r.reasons}")
        require(not [f for f in r.failures if f["kind"] == "checksum_mismatch"],
                f"{name}: a candidate's checksum differs from the original order's")
        for what, res in (("winner", r), ("pluto", pluto)):
            require(crunner.checksums_match(res.checksum, orig.checksum, 1e-6),
                    f"{name}: {what} checksum {res.checksum!r}, original {orig.checksum!r}")
        static = autotune(scop, measure=False, use_cache=False,
                          cache=ScheduleCache(disk=False), spec=CacheSpec())
        dump = json.loads(json.dumps({
            "solver": SOLVER_TAG, "space_version": SPACE_VERSION,
            "winner": static.to_dict()["config"], "label": static.config.label,
            "ranker": static.ranker, "ranked": static.ranked[:8]}))
        golden_path = os.path.join(ROOT, "artifacts", "golden_schedules",
                                   f"{name}__autotune.json")
        with open(golden_path) as f:
            golden = json.load(f)
        require(dump == golden, f"{name}: static winner {static.config.label} differs "
                                f"from {golden_path} ({golden['label']})")
        hits = daemon_stats(sock)["counters"]["frame_hits"]
        t0 = time.perf_counter()
        again = client.autotune(PB.REGISTRY[name](), measure=True)
        t_again = time.perf_counter() - t0
        require(daemon_stats(sock)["counters"]["frame_hits"] == hits + 1
                and again.config == r.config and t_again < 1.0,
                f"{name}: the repeat was no frame hit of the same winner in under 1 s "
                f"({t_again:.3f} s)")
        t0 = time.perf_counter()
        replay = autotune(PB.REGISTRY[name](), measure=True,
                          cache=ScheduleCache(cache_dir=SCHEDD_DIR))
        t_replay = time.perf_counter() - t0
        require(replay.source == "cache" and replay.config == r.config and t_replay < 1.0,
                f"{name}: the replay from the daemon's pool: source {replay.source}, "
                f"{t_replay:.3f} s")
        print(f"    static winner {static.config.label} equal to the golden file; repeat "
              f"through the daemon {t_again * 1e3:.1f} ms (frame hit), replay from its "
              f"pool {t_replay * 1e3:.1f} ms (source {replay.source})")
        done.append(name)
    client.close()
    left = [k for k in AUTOTUNE_KERNELS if k not in done]
    print(f"  {len(done)} kernels tuned in {time.perf_counter() - t_phase:.3f} s (host)"
          + (f"; left out past the {AUTOTUNE_BUDGET_S:.0f} s budget: {left}" if left else ""))
    require(done, "no kernel was tuned within the budget")


def warm_through_daemon(cfg, max_len: int, rows) -> list:
    """``warm_kernel_plans`` with the in-process memos and the schedule
    cache's memory tier cleared first, so every plan asks the daemon
    (``$POLYTOPS_TORCH_SCHEDD_SOCK``); requires each to come from it."""
    from repro_torch.core import akg, schedcache
    from repro_torch.core.schedclient import maybe_client
    from repro_torch.launch.serve import kernel_plan_shapes, warm_kernel_plans

    for fn in (akg.plan_matmul, akg.plan_attention, akg.plan_mamba_scan,
               akg.plan_scan_gate):
        fn.cache_clear()
    schedcache.global_cache().clear()
    client = maybe_client()
    require(client is not None, "no daemon configured for the serve phases")
    before = client.stats.as_dict()
    plans = warm_kernel_plans(cfg, max_len, SERVE_CHUNK, rows=rows)
    st = {k: v - before[k] for k, v in client.stats.as_dict().items()}
    want = len(set(kernel_plan_shapes(cfg, max_len, SERVE_CHUNK, rows)))
    require(st["remote_ok"] == want and st["fallbacks"] == 0,
            f"{cfg.name}: warmed {st['remote_ok']} of {want} plans via schedd, "
            f"{st['fallbacks']} fallbacks")
    return plans


def phase_build() -> float:
    """Build the library; meanwhile compile ``matmul.cu`` and
    ``flash_attention.cu`` once more with ``-Xptxas -v`` (one nvcc each,
    started together) and print their kernels' registers and spills."""
    from torch.utils.cpp_extension import CUDA_HOME

    from repro_torch.kernels import build
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "nvcc")
    ptxas = {src: subprocess.Popen(
        [nvcc, *build.CUDA_FLAGS, "-Xptxas", "-v", "-c", str(build.CSRC / src),
         "-o", str(build.BUILD_DIR / f"ptxas_{src[:-3]}.o")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src in ("matmul.cu", "flash_attention.cu")}
    outs = {}
    try:
        build.load_library()
        for src, proc in ptxas.items():
            outs[src], _ = proc.communicate(timeout=600)
    finally:
        for proc in ptxas.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    print(f"[build] csrc/{{{','.join(build.SOURCES)}}} for sm_90a in "
          f"{build.BUILD_SECONDS:.1f} s")
    for src, proc in ptxas.items():
        require(proc.returncode == 0, f"nvcc -Xptxas -v {src} failed:\n{outs[src]}")
        print(f"  -Xptxas -v {src}:")
        for line in outs[src].splitlines():
            if "Compiling entry" in line or "registers" in line or "spill" in line:
                print(f"    {line.strip()}")
    return build.BUILD_SECONDS


MM_CASES = [(256, 2048, 8192), (256, 8192, 2048), (200, 2048, 8192),
            (37, 70, 50),
            # K a multiple of neither the split x kk (256) nor kk: the last
            # split's last k tile is ragged
            (256, 8160, 2048),
            # gemma3's MLP: gate/up and down of a full chunk
            (256, 2560, 10240), (256, 10240, 2560),
            # seamless-m4t's MLP: the encoder's over 4096 stub frames, then
            # the decoder's over a full chunk
            (4096, 1024, 8192), (4096, 8192, 1024), (256, 1024, 8192),
            (256, 8192, 1024),
            # ... and the decoder's over the 512-token prefill prompt
            (512, 1024, 8192), (512, 8192, 1024),
            # qwen2-vl's MLP: gate/up and down of a full serving chunk, then
            # of its prefill (256 stub rows and a 512-token prompt)
            (256, 3584, 18944), (256, 18944, 3584), (768, 3584, 18944),
            (768, 18944, 3584)]


def phase_matmul(gen: torch.Generator) -> dict:
    from repro_torch.kernels import matmul_polytops as mm
    from repro_torch.kernels import ref
    from repro_torch.plan import matmul_launch_geometry, plan_matmul

    print("[kernels] matmul (csrc/matmul.cu) vs ref.matmul_ref")
    cases = []
    worst = 0.0
    for m, k, n in MM_CASES:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        k8, n8 = -(-k // 8) * 8, -(-n // 8) * 8
        tile = plan_matmul(m, n8, k8).tile
        geo = matmul_launch_geometry(m, n8, k8)
        got = mm.matmul(a, b)
        again = mm.matmul(a, b)
        torch.cuda.synchronize()
        worst = max(worst, compare(
            f"({m},{k})x({k},{n}) tiles={tile} split={geo['split']} "
            f"stages={geo['stages']} blocks={geo['blocks']}", got,
            ref.matmul_ref(a, b), MM_TOL))
        same = torch.equal(got, again)
        print(f"    two launches bit-identical: {same}")
        require(same, f"matmul ({m},{k})x({k},{n}): two launches differ")
        ms = time_ms(lambda: mm.matmul(a, b))
        plain = time_ms(lambda: ref.matmul_ref(a, b))
        lib = time_ms(lambda: torch.matmul(a, b))
        hus, lib_hus = host_us(lambda: mm.matmul(a, b)), host_us(lambda: torch.matmul(a, b))
        bms, by = bound_ms((m * k + k * n + m * n) * 2, 2.0 * m * n * k)
        print(f"  time ({m},{k})x({k},{n}): kernel {ms:.4f} ms (host {hus:.1f} "
              f"us/call), plain {plain:.4f} ms, torch.matmul {lib:.4f} ms (host "
              f"{lib_hus:.1f} us/call), bound {bms:.4f} ms ({by})")
        cases.append(dict(shape=[m, k, n], ms=ms, plain_ms=plain, library_ms=lib,
                          bound_ms=bms, bound_by=by, host_us=hus,
                          library_host_us=lib_hus))
    sweep_matmul_geometry(gen)
    first = cases[0]
    return dict(name="matmul", route="cuda", source="src/repro_torch/csrc/matmul.cu",
                replaces="src/repro/kernels/matmul_polytops.py:60",
                max_abs_err=worst, cases=cases,
                **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")})


# (b, c, kv_len, q_offset, h, hkv, d): first granite's serving chunk (one
# slot, b = 1, at offsets 768 and 512), then the ragged chunks granite's
# traffic sends (page 128), qwen3-moe's full chunk (32 heads over 4 kv
# heads, head dim 128), and the b = 4 cases of earlier runs; then
# qwen3-moe's ragged chunks and b = 4; then the same chunks at gemma3's
# global-layer heads (8 over 4 kv heads, head dim 256), and its chunk at
# offset 1280 over a 1536-row prefix (past the local window); then
# seamless-m4t's decoder (16 heads over 16 kv heads, head dim 64: no
# grouping), its full and ragged serving chunks and its 512-row prefill;
# then qwen2-vl's (28 heads over 4 kv heads, head dim 128: groups of 7),
# the same chunks and its 768-row prefill (256 stub rows and 512 text)
GRANITE_HEADS = (32, 8, 64)
QWEN3_HEADS = (32, 4, 128)
GEMMA3_HEADS = (8, 4, 256)
SEAMLESS_HEADS = (16, 16, 64)
QWEN2VL_HEADS = (28, 4, 128)
FLASH_QWEN3_CASE = (1, 256, 1024, 768, *QWEN3_HEADS)
FLASH_GEMMA3_CASE = (1, 256, 1024, 768, *GEMMA3_HEADS)
FLASH_SEAMLESS_CASE = (1, 256, 1024, 768, *SEAMLESS_HEADS)
FLASH_CASES = [(1, 256, 1024, 768, *GRANITE_HEADS), (1, 256, 768, 512, *GRANITE_HEADS),
               (1, 44, 384, 256, *GRANITE_HEADS), (1, 128, 640, 512, *GRANITE_HEADS),
               (1, 132, 1024, 768, *GRANITE_HEADS), (1, 232, 1024, 768, *GRANITE_HEADS),
               FLASH_QWEN3_CASE, (4, 256, 1024, 768, *GRANITE_HEADS),
               (4, 256, 256, 0, *GRANITE_HEADS), (4, 100, 1000, 900, *GRANITE_HEADS),
               (1, 44, 384, 256, *QWEN3_HEADS), (1, 128, 640, 512, *QWEN3_HEADS),
               (1, 132, 1024, 768, *QWEN3_HEADS), (1, 232, 1024, 768, *QWEN3_HEADS),
               (4, 256, 1024, 768, *QWEN3_HEADS),
               FLASH_GEMMA3_CASE, (1, 256, 768, 512, *GEMMA3_HEADS),
               (1, 44, 384, 256, *GEMMA3_HEADS), (1, 128, 640, 512, *GEMMA3_HEADS),
               (1, 132, 1024, 768, *GEMMA3_HEADS), (1, 232, 1024, 768, *GEMMA3_HEADS),
               (4, 256, 1024, 768, *GEMMA3_HEADS), (1, 256, 1536, 1280, *GEMMA3_HEADS),
               FLASH_SEAMLESS_CASE, (1, 44, 384, 256, *SEAMLESS_HEADS),
               (1, 128, 640, 512, *SEAMLESS_HEADS), (1, 132, 1024, 768, *SEAMLESS_HEADS),
               (1, 232, 1024, 768, *SEAMLESS_HEADS), (1, 512, 512, 0, *SEAMLESS_HEADS),
               (1, 256, 1024, 768, *QWEN2VL_HEADS), (1, 44, 384, 256, *QWEN2VL_HEADS),
               (1, 128, 640, 512, *QWEN2VL_HEADS), (1, 132, 1024, 768, *QWEN2VL_HEADS),
               (1, 232, 1024, 768, *QWEN2VL_HEADS), (1, 768, 768, 0, *QWEN2VL_HEADS)]
FLASH_CACHE_LEN = 1600
# (b, s, d_inner, state) of the scan kernels' checks
SCAN_CASES = ((1, SERVE_CHUNK, 8192, 16), (1, 44, 8192, 16), (1, 64, 128, 8))

# the plans phase: every served model's traffic is planned at these chunk
# rows (its ragged chunks, a full one, and the prefills' 512, 768 and
# 4096 rows), each planner must give its operator's order and vector
# iterator, and each plan the tile in PLAN_TILES, the tiles the port's
# kernels were planned with before the scheduler was in the loop
PLAN_ROWS = (44, 128, 132, 232, 256, 512, 768, 4096)
PLAN_ORDERS = {"matmul": (("i", "kk", "j"), "j"), "attention": (("q", "kk", "d"), "d"),
               "mamba_scan": (("t", "d", "n"), "n"), "scan_gate": (("d", "t", "n"), "n")}
SERVED_ARCHS = ("granite_3_2b", "falcon_mamba_7b", "gemma3_4b", "qwen3_moe_30b_a3b",
                "seamless_m4t_large_v2", "qwen2_vl_7b")


def plan_cases() -> list:
    """``(planner, args)`` of every plan the later phases make: the
    matmul cases (K and N padded to 8, as the wrapper pads them), the
    flash cases' (rows, kv rows, head dim), the scan cases (and the
    scan+gate's half chunk), the kernel bench's shapes, and each served
    model's plans (``launch.serve.kernel_plan_shapes`` at PLAN_ROWS)."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import kernel_plan_shapes

    cases = {("matmul", (m, -(-n // 8) * 8, -(-k // 8) * 8)) for m, k, n in MM_CASES}
    cases |= {("attention", (c, kv, d)) for _, c, kv, _, _, _, d in FLASH_CASES}
    for _, s, di, st in SCAN_CASES:
        cases |= {("mamba_scan", (s, di, st)), ("scan_gate", (s, di, st))}
    cases.add(("scan_gate", (SERVE_CHUNK // 2, 8192, 16)))
    # repro_torch.kernels.bench: its smoke and its timings
    cases |= {("matmul", (n, n, n)) for n in (128, 256, 512)}
    cases |= {("attention", (s, s, 64)) for s in (128, 512)}
    cases |= {("mamba_scan", (128, 256, 16)), ("scan_gate", (128, 256, 16))}
    for arch in SERVED_ARCHS:
        cases.update(kernel_plan_shapes(get_arch(arch), SERVE_MAX_LEN, SERVE_CHUNK,
                                        PLAN_ROWS))
    return sorted(cases)


# (planner, args) -> tile, for every plan_cases() entry
PLAN_TILES = {
    ('attention', (44, 384, 64)): {'q': 32, 'kk': 128, 'd': 64},
    ('attention', (44, 384, 128)): {'q': 32, 'kk': 128, 'd': 128},
    ('attention', (44, 384, 256)): {'q': 32, 'kk': 128, 'd': 256},
    ('attention', (44, 1088, 64)): {'q': 32, 'kk': 128, 'd': 64},
    ('attention', (44, 1088, 128)): {'q': 32, 'kk': 128, 'd': 128},
    ('attention', (44, 1088, 256)): {'q': 32, 'kk': 128, 'd': 256},
    ('attention', (100, 1000, 64)): {'q': 64, 'kk': 128, 'd': 64},
    ('attention', (128, 128, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 640, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 640, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (128, 640, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (128, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (128, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (128, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (132, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (132, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (132, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (132, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (132, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (132, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (232, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (232, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (232, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (232, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (232, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (232, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 256, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 768, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 768, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1024, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 1024, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (256, 1024, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (256, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (256, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (256, 1536, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (512, 512, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (512, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (512, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (512, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (768, 768, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (768, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (768, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (768, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (1088, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (1088, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (1088, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('attention', (4096, 1088, 64)): {'q': 128, 'kk': 128, 'd': 64},
    ('attention', (4096, 1088, 128)): {'q': 128, 'kk': 128, 'd': 128},
    ('attention', (4096, 1088, 256)): {'q': 128, 'kk': 128, 'd': 256},
    ('mamba_scan', (44, 8192, 16)): {'t': 44, 'd': 32, 'n': 16},
    ('mamba_scan', (64, 128, 8)): {'t': 64, 'd': 64, 'n': 8},
    ('mamba_scan', (128, 256, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('mamba_scan', (256, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('matmul', (37, 56, 72)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 1024, 8192)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 2048, 8192)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 2560, 10240)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 3584, 18944)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 8192, 1024)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 8192, 2048)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 10240, 2560)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (44, 18944, 3584)): {'i': 64, 'kk': 64, 'j': 128},
    ('matmul', (128, 128, 128)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (128, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (132, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (200, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (232, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 256, 256)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2048, 8160)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (256, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 512, 512)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (512, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (768, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (1024, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (2048, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (2560, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (3584, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 1024, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 2048, 8192)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 2560, 10240)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 3584, 18944)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 8192, 1024)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 8192, 2048)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 10240, 2560)): {'i': 128, 'kk': 64, 'j': 128},
    ('matmul', (4096, 18944, 3584)): {'i': 128, 'kk': 64, 'j': 128},
    ('scan_gate', (44, 8192, 16)): {'t': 44, 'd': 32, 'n': 16},
    ('scan_gate', (64, 128, 8)): {'t': 64, 'd': 64, 'n': 8},
    ('scan_gate', (128, 256, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (128, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (132, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (232, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (256, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (512, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (768, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
    ('scan_gate', (4096, 8192, 16)): {'t': 128, 'd': 32, 'n': 16},
}


def sweep_matmul_geometry(gen: torch.Generator) -> None:
    """The serving shapes at every K split and ring depth the kernel
    takes, beside the plan's choice (``plan.matmul_launch_geometry``):
    the evidence for that choice on this card.  Launched through the
    library directly, so the wrapper's launch count does not move."""
    from repro_torch.kernels import build
    from repro_torch.plan import matmul_launch_geometry, plan_matmul

    lib = build.load_library()
    for m, k, n in MM_CASES[:2]:
        a = torch.randn((m, k), generator=gen, device="cuda").to(torch.bfloat16)
        b = (torch.randn((k, n), generator=gen, device="cuda")
             * k ** -0.5).to(torch.bfloat16)
        c = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
        tile = plan_matmul(m, n, k).tile
        geo = matmul_launch_geometry(m, n, k)
        tiles = -(-m // tile["i"]) * -(-n // tile["j"])
        ws = torch.empty(4 * tiles * tile["i"] * tile["j"], device="cuda")
        counters = torch.zeros(tiles, dtype=torch.int32, device="cuda")
        times = []
        for split in (1, 2, 4):
            if (k // tile["kk"]) % split:
                continue
            for stages in (3, 4, 5):
                def run():
                    build.check(lib.repro_matmul_bf16(
                        a.data_ptr(), b.data_ptr(), c.data_ptr(), ws.data_ptr(),
                        counters.data_ptr(), m, n, k, tile["i"], tile["j"],
                        tile["kk"], split, stages, build.stream_ptr(a.device)),
                        "matmul geometry sweep")
                times.append(f"split {split} stages {stages} {time_ms(run):.4f}")
        print(f"  geometry sweep ({m},{k})x({k},{n}), plan split {geo['split']} "
              f"stages {geo['stages']}, ms: {'; '.join(times)}")


def flash_operands(gen: torch.Generator, b, c, kv_len, h, hkv, d):
    """q, and k/v as page-aligned prefixes of a KV cache, read in place as
    the serving path reads them."""
    q = torch.randn((b, c, h, d), generator=gen, device="cuda").to(torch.bfloat16)
    kc = torch.randn((b, FLASH_CACHE_LEN, hkv, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    vc = torch.randn((b, FLASH_CACHE_LEN, hkv, d), generator=gen,
                     device="cuda").to(torch.bfloat16)
    return q, kc[:, :kv_len], vc[:, :kv_len]


def phase_flash(gen: torch.Generator) -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.plan import attention_launch_geometry

    print("[kernels] flash attention (csrc/flash_attention.cu) vs "
          "ref.flash_attention_ref")
    cases = []
    worst = 0.0
    for i, (b, c, kv_len, off, h, hkv, d) in enumerate(FLASH_CASES):
        q, k, v = flash_operands(gen, b, c, kv_len, h, hkv, d)
        geo = attention_launch_geometry(c, kv_len, d, b, h, hkv)
        got = fa.flash_attention(q, k, v, causal=True, q_offset=off)
        again = fa.flash_attention(q, k, v, causal=True, q_offset=off)
        torch.cuda.synchronize()
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off)
        worst = max(worst, compare(
            f"b·h={b}·{h} hkv={hkv} d={d} c={c} kv_len={kv_len} q_offset={off} "
            f"rows={geo['rows']} stages={geo['stages']} blocks={geo['blocks']}",
            got, want, FA_TOL))
        same = torch.equal(got, again)
        # the descriptor from device scalars, and q as one slot of a
        # batched cache (the serving chunk's launch), against the int
        # offset's launch
        off_t = torch.tensor(off, dtype=torch.int32, device="cuda")
        row_t = torch.tensor(1, dtype=torch.int32, device="cuda")
        kc, vc = (torch.randn((b + 2, kv_len, hkv, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(2))
        kc[1:1 + b], vc[1:1 + b] = k, v
        dev_same = torch.equal(fa.flash_attention(q, k, v, q_offset=off_t), got)
        slot_same = torch.equal(fa.flash_attention(q, kc, vc, q_offset=off_t, kv_row=row_t),
                                got)
        torch.cuda.synchronize()
        print(f"    two launches bit-identical: {same}; device q_offset: {dev_same}; "
              f"as batch row 1 of {b + 2} with device q_offset and kv_row: {slot_same}")
        require(same and dev_same and slot_same,
                f"flash b={b} c={c} kv_len={kv_len} d={d}: launches differ")
        rows = off + torch.arange(c)
        pairs = int(torch.clamp(rows + 1, max=kv_len).sum()) * b * h
        mask = (off + torch.arange(c, device="cuda")[:, None]
                >= torch.arange(kv_len, device="cuda")[None, :])
        qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
        ms = time_ms(lambda: fa.flash_attention(q, k, v, q_offset=off))
        plain = time_ms(lambda: ref.flash_attention_ref(q, k, v, q_offset=off))
        lib_fn = lambda: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask, enable_gqa=True)
        lib = time_ms(lib_fn)
        hus = host_us(lambda: fa.flash_attention(q, k, v, q_offset=off))
        lib_hus = host_us(lib_fn)
        nbytes = (2 * q.numel() + 2 * b * kv_len * hkv * d) * 2
        bms, by = bound_ms(nbytes, 4.0 * d * pairs)
        print(f"  time b={b} h={h}/{hkv} d={d} c={c} kv_len={kv_len} q_offset={off}: "
              f"kernel {ms:.4f} ms (host {hus:.1f} us/call), plain {plain:.4f} ms, "
              f"scaled_dot_product_attention {lib:.4f} ms (host {lib_hus:.1f} "
              f"us/call), bound {bms:.4f} ms ({by})")
        if i == 0 or FLASH_CASES[i] in (FLASH_GEMMA3_CASE, FLASH_SEAMLESS_CASE):
            sdpa_backends(qt, kt, vt, mask)
        cases.append(dict(shape=[b, h, hkv, d, c, kv_len, off], ms=ms, plain_ms=plain,
                          library_ms=lib, bound_ms=bms, bound_by=by, host_us=hus,
                          library_host_us=lib_hus))
    # the kernel's non-causal route (no model path takes it): correctness only
    q, k, v = flash_operands(gen, 1, 128, 640, *GRANITE_HEADS)
    got = fa.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    worst = max(worst, compare("non-causal b·h=1·32 c=128 kv_len=640", got,
                               ref.flash_attention_ref(q, k, v, causal=False), FA_TOL))
    sweep_flash_geometry(gen)
    first = cases[0]
    return dict(name="flash_attention", route="cuda",
                source="src/repro_torch/csrc/flash_attention.cu",
                replaces="src/repro/kernels/flash_attention.py:96",
                max_abs_err=worst, cases=cases,
                **{k: first[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by",
                                         "library_ms")})


def sdpa_backends(qt, kt, vt, mask) -> None:
    """Which backend ``scaled_dot_product_attention`` picks for the
    boolean-mask GQA call that ``library_ms`` times, and each backend's
    time when it is forced (``sdpa_kernel``), or why it refuses."""
    import warnings

    from torch.nn.attention import SDPBackend, sdpa_kernel

    choice = SDPBackend(torch._fused_sdp_choice(qt, kt, vt, attn_mask=mask,
                                                enable_gqa=True)).name
    parts = []
    for be in (SDPBackend.FLASH_ATTENTION, SDPBackend.EFFICIENT_ATTENTION,
               SDPBackend.CUDNN_ATTENTION, SDPBackend.MATH):
        def fn(be=be):
            with sdpa_kernel(be):
                return F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask,
                                                      enable_gqa=True)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            try:
                fn()
                torch.cuda.synchronize()
            except RuntimeError:
                # PyTorch warns once per backend it rules out; keep the
                # reasons, not the headers or the backends disabled by
                # the forcing itself
                why = [" ".join(str(w.message).split()).split(" (Triggered internally")[0]
                       for w in caught]
                why = [w[:160] for w in why
                       if not w.endswith("because:") and "runtime disabled" not in w]
                parts.append(f"{be.name} refuses ({' | '.join(why) or 'no reason given'})")
                continue
        parts.append(f"{be.name} {time_ms(fn, cover=be != SDPBackend.MATH):.4f} ms")
    print(f"  scaled_dot_product_attention backend for the default call: {choice}; "
          f"forced: {'; '.join(parts)}")


def sweep_flash_geometry(gen: torch.Generator) -> None:
    """The first serving shape, the qwen3-shape chunk and gemma3's chunk
    at every ring depth that fits a block's shared memory, beside the
    plan's choice (``plan.attention_launch_geometry``): the evidence for
    that choice on this card.  Each depth is held against the plain
    version and to the same bits on two launches.  Launched through
    ``flash_attention.launch``, so the wrapper's launch count does not
    move."""
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    from repro_torch.plan import (SMEM_BYTES, attention_launch_geometry,
                                  attention_launch_smem)

    for b, c, kv_len, off, h, hkv, d in (FLASH_CASES[0], FLASH_QWEN3_CASE,
                                         FLASH_GEMMA3_CASE):
        q, k, v = flash_operands(gen, b, c, kv_len, h, hkv, d)
        want = ref.flash_attention_ref(q, k, v, causal=True, q_offset=off).float()
        geo = attention_launch_geometry(c, kv_len, d, b, h, hkv)
        times = []
        for stages in (2, 3, 4):
            if attention_launch_smem(d, stages) > SMEM_BYTES:
                continue
            out = torch.empty_like(q)
            again = torch.empty_like(q)

            def run(o=out, stages=stages):
                fa.launch(q, k, v, o, off, True, stages)
            run()
            run(again)
            torch.cuda.synchronize()
            err = (out.float() - want).abs()
            require(bool((err <= FA_TOL["atol"] + FA_TOL["rtol"] * want.abs()).all()),
                    f"flash sweep d {d} stages {stages}: max_abs_err "
                    f"{float(err.max()):.3e} outside FA_TOL")
            require(torch.equal(out, again),
                    f"flash sweep d {d} stages {stages}: two launches differ")
            times.append(f"stages {stages} {time_ms(run):.4f}")
        print(f"  geometry sweep b·h {b}·{h} d {d} c {c} kv_len {kv_len} q_offset {off} "
              f"(every point within FA_TOL, bit-identical on two launches), plan "
              f"stages {geo['stages']}, ms: {'; '.join(times)}")


def ssm_operands(gen: torch.Generator, b: int, s: int, di: int, st: int,
                 x_dtype: torch.dtype) -> dict:
    """Scan operands made as ``model/ssm.py::_ssm_inputs`` makes them:
    dt = softplus(·) > 0, A = -(1..st), a_bar = exp(dt·A) in (0, 1),
    b_bar = dt·B·x; c, x and z standard normal, d_skip ones."""
    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda")

    xs = randn(b, s, di).to(x_dtype)
    dt = F.softplus(randn(b, s, di) * 0.5 - 1.0)
    A = -torch.arange(1, st + 1, device="cuda", dtype=torch.float32)
    a_bar = torch.exp(dt[..., None] * A)
    b_bar = (dt[..., None] * randn(b, s, 1, st)) * xs.float()[..., None]
    return dict(a_bar=a_bar, b_bar=b_bar, c=randn(b, s, st), x_skip=xs,
                d_skip=torch.ones(di, device="cuda"), z=randn(b, s, di).to(x_dtype))


def _rows(ops: dict, lo: int, hi: int) -> dict:
    return {k: (v if k == "d_skip" else v[:, lo:hi]) for k, v in ops.items()}


def _scan_bound(ops: dict, out_bytes: int, gate: bool):
    """Bytes: every input read once, every output written once.
    Operations: per (t, d, n) the recurrence's multiply-add and the
    contraction's multiply-add; per (t, d) with the gate, the skip's
    multiply-add, the SiLU (exp, add, divide) and the gate's multiply."""
    b, s, di, st = ops["a_bar"].shape
    nbytes = sum(t.numel() * t.element_size() for t in ops.values()
                 if t is not None) + out_bytes
    flops = 4.0 * b * s * di * st + (6.0 * b * s * di if gate else 0.0)
    return bound_ms(nbytes, flops, PEAK_F32)


def phase_scan_gate(gen: torch.Generator) -> dict:
    from repro_torch.kernels import ref
    from repro_torch.kernels import scan_gate as sg
    from repro_torch.plan import plan_scan_gate

    print("[kernels] scan_gate (csrc/scan_gate.cu) vs ref.scan_gate_ref")
    b, s, di, st = 1, SERVE_CHUNK, 8192, 16
    worst = 0.0

    def check(name, ops, h0, o_tol):
        got = sg.scan_gate(**ops, h0=h0)
        torch.cuda.synchronize()
        want = ref.scan_gate_ref(**ops, h0=h0)
        tile = plan_scan_gate(ops["a_bar"].shape[1], *ops["a_bar"].shape[2:]).tile
        err = compare(f"{name} o {tuple(got[0].shape)} {got[0].dtype} tiles={tile}",
                      got[0], want[0], o_tol)
        err = max(err, compare(f"{name} h_last", got[1], want[1], SCAN_TOL))
        return got, err

    # the chunk before supplies h0, as the engine's carry does
    prev = ssm_operands(gen, b, s, di, st, torch.bfloat16)
    h0 = ref.scan_gate_ref(**prev)[1]
    ops = ssm_operands(gen, b, s, di, st, torch.bfloat16)
    (o_whole, h_whole), e = check(f"serving chunk b={b} s={s} di={di} st={st} "
                                  "with h0", ops, h0, SCAN_BF16_TOL)
    worst = max(worst, e)
    _, e = check("ragged last chunk s=44 with h0", _rows(ops, 0, 44), h0,
                 SCAN_BF16_TOL)
    worst = max(worst, e)
    # split in half: the second half, carried through h0, against the
    # plain version of the whole chunk
    m = s // 2
    _, h1 = sg.scan_gate(**_rows(ops, 0, m), h0=h0)
    o2, h2 = sg.scan_gate(**_rows(ops, m, s), h0=h1)
    torch.cuda.synchronize()
    o_want, h_want = ref.scan_gate_ref(**ops, h0=h0)
    worst = max(worst, compare("chunk carry: second half o vs whole",
                               o2, o_want[:, m:], SCAN_BF16_TOL))
    worst = max(worst, compare("chunk carry: h_last vs whole", h2, h_want,
                               SCAN_TOL))
    print(f"  chunk carry bit-identical to the kernel's whole run: o "
          f"{torch.equal(o2, o_whole[:, m:])}, h_last {torch.equal(h2, h_whole)}")
    for shape in ((1, 64, 128, 8), (b, s, di, st)):
        _, e = check(f"all f32 {shape}", ssm_operands(gen, *shape, torch.float32),
                     None, SCAN_TOL)
        worst = max(worst, e)

    ms = time_ms(lambda: sg.scan_gate(**ops, h0=h0))
    hus = host_us(lambda: sg.scan_gate(**ops, h0=h0))
    plain = time_ms(lambda: ref.scan_gate_ref(**ops, h0=h0), iters=5, cover=False)
    bms, by = _scan_bound(dict(ops, h0=h0),
                          o_whole.numel() * 2 + h_whole.numel() * 4, gate=True)
    print(f"  time b={b} s={s} di={di} st={st}: kernel {ms:.4f} ms (host "
          f"{hus:.1f} us/call), plain {plain:.4f} ms (a host loop over time), "
          f"library call none (no single PyTorch call computes it), bound "
          f"{bms:.4f} ms ({by})")
    return dict(name="scan_gate", route="cuda",
                source="src/repro_torch/csrc/scan_gate.cu",
                replaces="src/repro/kernels/scan_gate.py:85", ms=ms,
                plain_ms=plain, bound_ms=bms, bound_by=by, library_ms=None,
                max_abs_err=worst)


def phase_selective_scan(gen: torch.Generator) -> dict:
    from repro_torch.kernels import mamba_scan as msc
    from repro_torch.kernels import ref
    from repro_torch.plan import plan_mamba_scan

    print("[kernels] selective_scan (csrc/scan_gate.cu) vs ref.selective_scan_ref")
    worst = 0.0
    rec = None
    for shape in SCAN_CASES:
        ops = ssm_operands(gen, *shape, torch.float32)
        abc = {k: ops[k] for k in ("a_bar", "b_bar", "c")}
        got = msc.selective_scan(**abc)
        torch.cuda.synchronize()
        tile = plan_mamba_scan(*shape[1:]).tile
        worst = max(worst, compare(f"{shape} tiles={tile}", got,
                                   ref.selective_scan_ref(**abc), SCAN_TOL))
        if rec is None:
            ms = time_ms(lambda: msc.selective_scan(**abc))
            hus = host_us(lambda: msc.selective_scan(**abc))
            plain = time_ms(lambda: ref.selective_scan_ref(**abc), iters=5,
                            cover=False)
            bms, by = _scan_bound(abc, got.numel() * 4, gate=False)
            print(f"  time {shape}: kernel {ms:.4f} ms (host {hus:.1f} us/call), "
                  f"plain {plain:.4f} ms (a host loop over time), library call "
                  f"none, bound {bms:.4f} ms ({by})")
            rec = dict(name="selective_scan", route="cuda",
                       source="src/repro_torch/csrc/scan_gate.cu",
                       replaces="src/repro/kernels/mamba_scan.py:64", ms=ms,
                       plain_ms=plain, bound_ms=bms, bound_by=by,
                       library_ms=None)
    rec["max_abs_err"] = worst
    return rec


def phase_bench() -> None:
    """The port's kernel bench on the card: its smoke gate must count no
    failure; then its timings (``repro_torch.kernels.bench``)."""
    from repro_torch.kernels import bench

    print("[kernels] repro_torch.kernels.bench --smoke")
    failures = bench.smoke()
    require(failures == 0, f"kernel bench smoke: {failures} failures")
    print("[kernels] repro_torch.kernels.bench timings")
    bench.run()


def kernel_modules() -> dict:
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import mamba_scan as msc
    from repro_torch.kernels import matmul_polytops as mm
    from repro_torch.kernels import scan_gate as sg
    return {"matmul": mm, "flash_attention": fa, "scan_gate": sg,
            "selective_scan": msc}


def collect_previous_phase() -> str:
    """Free the previous phase's engine and weights; say what stays
    allocated on the card (kernel A's per-stream split-K scratch, cached
    flash descriptors, the L2 flush buffer), which the next phase's peak
    memory includes."""
    gc.collect()
    torch.cuda.empty_cache()
    return (f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB carried over from "
            f"earlier phases")


def describe(cfg) -> str:
    if cfg.family == "ssm":
        return (f"{cfg.n_layers} Mamba layers, d_model {cfg.d_model}, d_inner "
                f"{cfg.d_inner}, ssm_state {cfg.ssm_state}, dt_rank {cfg.dt_rank_}, "
                f"conv {cfg.conv_width}")
    text = (f"{cfg.n_layers} layers, d_model {cfg.d_model}, {cfg.n_heads} heads / "
            f"{cfg.n_kv_heads} kv, head_dim {cfg.hd}{', qk_norm' if cfg.qk_norm else ''}")
    if cfg.n_experts:
        n_moe = sum(cfg.is_moe_layer(i) for i in range(cfg.n_layers))
        text += (f", {cfg.n_experts} experts top-{cfg.top_k} of expert d_ff {cfg.d_ff} "
                 f"on {n_moe} layers{' with a shared expert' if cfg.shared_expert else ''}")
    else:
        text += f", d_ff {cfg.d_ff}"
    if cfg.sliding_window:
        n_global = sum(cfg.is_global_attn_layer(i) for i in range(cfg.n_layers))
        text += (f", window {cfg.sliding_window} on {cfg.n_layers - n_global} local "
                 f"layers, {n_global} global")
    if cfg.enc_layers:
        text += (f", an encoder of {cfg.enc_layers} layers over {cfg.frontend_len} stub "
                 f"frames read by every decoder layer's cross attention")
    return text


def phase_serve(gpu: str, arch: str, path_kernels, relative_logits: bool = False,
                check_offsets=(SERVE_CHUNK,)) -> dict:
    """Serve SERVE_PLENS through ``arch`` at full width, twice through one
    engine: every tick eager, then (after ``reset``) every decode and
    chunk tick a CUDA graph replay, the main path, whose greedy tokens
    must equal the eager run's.  Returns the launch count of every kernel in the graph run.
    ``path_kernels``: the kernels the path must have launched;
    ``relative_logits``: hold the chunk step's kernels-vs-plain logits to
    bounds relative to the plain path's own distance from f32 (see
    LOGIT_VS_F32); ``check_offsets``: the chunks whose logits
    ``check_chunk_step`` compares."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch.serve import ContinuousEngine
    from repro_torch.model import transformer as T
    from repro_torch.model.layers import make_generator
    from repro_torch.tree import leaves

    cfg = get_arch(arch)
    max_len = SERVE_MAX_LEN
    # the traffic's plans, before any timed run: its first eager tick and
    # its first capture of each key then plan nothing
    t0 = time.perf_counter()
    plans = warm_through_daemon(cfg, max_len, [n % SERVE_CHUNK for n in SERVE_PLENS])
    print(f"[serve] {cfg.name}: {len(plans)} kernel plans of its traffic warmed in "
          f"{time.perf_counter() - t0:.3f} s (host), none degraded: "
          f"{not any(p.degraded for p in plans)}")
    require(not any(p.degraded for p in plans), f"{cfg.name}: a kernel plan degraded")
    carried = collect_previous_phase()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device="cuda")
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params))
    print(f"[serve] {cfg.name}: {describe(cfg)}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n_params / 1e9:.3f} B parameters, init {time.perf_counter() - t0:.1f} s; "
          f"{carried}")

    gen = make_generator(1, torch.device("cuda"))
    prompts = [torch.randint(2, cfg.vocab, (1, n), generator=gen, device="cuda")
               for n in SERVE_PLENS]
    # the comparison run first, every tick as eager ops; then the main
    # path, every decode and chunk tick a graph replay, after a reset of
    # the same engine
    eng = ContinuousEngine(cfg, params, SERVE_SLOTS, max_len, chunk=SERVE_CHUNK,
                           use_kernels=True, max_new=SERVE_GEN, cuda_graphs=False)
    eager = serve_traffic(eng, cfg, prompts, path_kernels, "eager ticks")
    eng.reset()
    eng.cuda_graphs = True
    graphs = serve_traffic(eng, cfg, prompts, path_kernels, "graph ticks")
    same = [a == b for a, b in zip(eager["tokens"], graphs["tokens"])]
    print(f"  graph run's greedy tokens equal to the eager run's: {sum(same)} of "
          f"{len(same)} requests")
    require(all(same), f"{cfg.name}: the graph run's tokens differ from the eager run's "
                       f"in requests {[i for i, ok in enumerate(same) if not ok]}")
    require(graphs["launches"] == eager["launches"],
            f"launches differ: eager {eager['launches']}, graphs {graphs['launches']}")
    pool = eng.graph_pool_bytes()
    chunk_s = eng.chunk_capture_seconds
    print(f"  decode graphs: {len(eng.graphs)} captured (keys, kv buckets or 0 for any: "
          f"{sorted(eng.graphs)}) in {eng.capture_seconds - chunk_s:.3f} s; chunk graphs: "
          f"{len(eng.chunk_graphs)} captured (keys, (c, kv bucket or 0 for any): "
          f"{sorted(eng.chunk_graphs)}) in {chunk_s:.3f} s; shared pool "
          f"{pool / 2**20:.1f} MiB; serve wall eager {eager['dt']:.3f} s, graphs "
          f"{graphs['dt']:.3f} s ({graphs['dt'] - eng.capture_seconds:.3f} s without "
          f"the captures); generated tok/s eager {eager['tok_s']:.1f}, graphs "
          f"{graphs['tok_s']:.1f}")
    print(f"  card: {gpu}")

    # a longer prompt (drawn after the served ones) where the checked
    # chunks reach past the served prompts
    check_len = max(check_offsets) + SERVE_CHUNK
    toks = prompts[0] if check_len <= SERVE_PLENS[0] else torch.randint(
        2, cfg.vocab, (1, check_len), generator=gen, device="cuda")
    check_chunk_step(cfg, params, toks, max(max_len, check_len + 64), relative_logits,
                     check_offsets)
    profile_steps(cfg, params, max_len, eng)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {cfg.name} phase peak device memory {peak:.2f} GiB")
    return graphs["launches"]


def serve_traffic(eng, cfg, prompts, path_kernels, label: str) -> dict:
    """Serve ``prompts`` through ``eng`` with every kernel's launch count
    set to 0 just before and read just after; check the requests and the
    counts.  Returns the tokens, wall, tok/s and launches."""
    from repro_torch.launch.serve import Request
    from repro_torch.model import transformer as T

    reqs = [Request(i, p) for i, p in enumerate(prompts)]
    for r in reqs:
        eng.submit(r)
    torch.cuda.synchronize()

    def replays():
        return [sum(g.replays for g in graphs.values())
                for graphs in (eng.graphs, eng.chunk_graphs)]
    replays_before = replays()
    mods = kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    t0 = time.perf_counter()
    ticks = eng.run()
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    n_replays = [b - a for a, b in zip(replays_before, replays())]

    require(all(r.done for r in reqs), "a request did not retire")
    require([len(r.generated) for r in reqs] == [SERVE_GEN] * len(reqs),
            f"token counts {[len(r.generated) for r in reqs]}")
    require(all(0 <= t < cfg.vocab for r in reqs for t in r.generated),
            "token id out of range")
    want_replays = [eng.ticks_decode, eng.ticks_prefill] if eng.cuda_graphs else [0, 0]
    require(n_replays == want_replays,
            f"{label}: (decode, chunk) replays {n_replays}, expected {want_replays}: "
            f"{'a tick ran as eager ops' if eng.cuda_graphs else 'a graph replayed'}")
    require(all(launches[k] > 0 for k in path_kernels),
            f"a kernel was not launched on the {cfg.name} path: {launches}")
    require(all(n == 0 for k, n in launches.items() if k not in path_kernels),
            f"a kernel off the {cfg.name} path was launched: {launches}")
    if "scan_gate" in path_kernels:
        # every chunk of this traffic has >= min_scan_seq rows
        want = cfg.n_layers * eng.ticks_prefill
        require(launches["scan_gate"] == want,
                f"scan_gate launches {launches['scan_gate']}, expected {want} "
                f"({cfg.n_layers} layers x {eng.ticks_prefill} chunk ticks)")
    if "flash_attention" in path_kernels:
        # every chunk of this traffic has >= min_attn_q rows; windowed
        # layers take the plain path, as the reference's do
        full = sum(spec.mixer == "attn" and spec.window == 0 for spec in T.layer_specs(cfg))
        want = full * eng.ticks_prefill
        require(launches["flash_attention"] == want,
                f"flash launches {launches['flash_attention']}, expected {want} "
                f"({full} full-attention layers x {eng.ticks_prefill} chunk ticks)")
    if "matmul" in path_kernels:
        # full chunks clear min_matmul_rows; ragged ones take plain matmuls
        full_chunks = sum(n // SERVE_CHUNK for n in SERVE_PLENS)
        want = full_chunks * cfg.n_layers * 3
        require(launches["matmul"] == want,
                f"matmul launches {launches['matmul']}, expected {want} ({full_chunks} full "
                f"chunks x {cfg.n_layers} layers x 3)")
    ntok = SERVE_GEN * len(reqs)
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  {label}: {len(reqs)} requests, prompts {list(SERVE_PLENS)}, {ntok} new "
          f"tokens in {dt:.3f} s: {ntok / dt:.1f} generated tok/s, "
          f"{(sum(SERVE_PLENS) + ntok) / dt:.1f} total tok/s")
    print(f"  ticks {ticks} (decode {eng.ticks_decode}, prefill "
          f"{eng.ticks_prefill}, overlap {eng.ticks_overlap}; graph replays, decode / "
          f"chunk: {n_replays[0]} / {n_replays[1]}), overlap ratio "
          f"{eng.overlap_ratio():.3f}, page {eng.page}, peak memory "
          f"{peak:.2f} GiB, launches {launches}")
    print(f"  first tokens: {[r.generated[:4] for r in reqs[:3]]}")
    return dict(tokens=[r.generated for r in reqs], dt=dt, tok_s=ntok / dt,
                launches=launches)


PROFILE_LENS = (700, 300, 900, 512)
PROFILE_KV = 1024


def profile_steps(cfg, params, max_len, eng) -> None:
    """Where a tick's time goes: host wall time (synchronized) against
    the device's busy time (sum of kernel times from ``torch.profiler``)
    for one prefill chunk and one decode step with the kernels on, both
    eager; then, through the serve engine ``eng`` at the same slot
    lengths, one chunk tick as eager ops and as a graph replay, and one
    decode tick and a 16-step ``_decode_k`` loop as graph replays, with
    the device span between CUDA events beside a replay's busy time.
    Each engine row starts from the same state and puts it back after.
    Last, one replayed decode tick's logits against one eager tick's from
    the same state, and :func:`check_chunk_replay`."""
    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode
    from repro_torch.model.layers import make_generator

    dev = torch.device("cuda")
    gen = make_generator(2, dev)
    cache = T.init_cache(cfg, SERVE_SLOTS, max_len, dev)
    chunk = torch.randint(2, cfg.vocab, (1, SERVE_CHUNK), generator=gen, device=dev)
    tok = torch.randint(2, cfg.vocab, (SERVE_SLOTS, 1), generator=gen, device=dev)
    lens = torch.tensor(PROFILE_LENS, device=dev)
    act = torch.ones(SERVE_SLOTS, dtype=torch.bool, device=dev)
    eng.reset()
    eng.toks.copy_(tok)
    eng.lens.copy_(lens)
    eng._active.fill_(True)
    kv = PROFILE_KV

    def chunk_tick(graphs: bool):
        def run():
            eng.cuda_graphs = graphs
            eng._chunk_tick(chunk, 512, 1, False, 768)
        return run
    steps = {
        "chunk step (256 rows at offset 512, kv 768)": (lambda: T.chunk_step(
            params, cfg, chunk, T.cache_slot_view(cache, 1), 512, 768), 5, False),
        "chunk tick, eager (engine: 256 rows at offset 512 of slot 1, kv 768)": (
            chunk_tick(False), 5, False),
        "chunk tick, graph replay (the same)": (chunk_tick(True), 5, True),
        f"decode step (4 slots, kv {kv})": (lambda: T.serve_decode_step(
            params, cfg, tok, cache, lens, act, kv), 5, False),
        f"decode step, graph replay (4 slots, kv {kv})": (
            lambda: eng._decode_tick(kv), 5, True),
        # 16 steps x (1 + 2 + 2 + 2) calls from PROFILE_LENS stay under kv
        f"16-step decode loop, graph replay (4 slots, kv {kv})": (
            lambda: eng._decode_k(kv, 16), 2, True),
    }
    with kernel_mode(enabled=True):
        for name, (fn, reps, graph) in steps.items():
            with eng._state_kept():
                profile_step(name, fn, reps, graph)
        with eng._state_kept():
            eng._decode_step(kv)
            eager = (eng.logits.float(), eng.nxt.clone())
        with eng._state_kept():
            eng._decode_tick(kv)
            replay = (eng.logits.float(), eng.nxt.clone())
        torch.cuda.synchronize()
        diff = float((eager[0] - replay[0]).abs().max())
        print(f"  one decode tick at kv {kv} from the same state, replayed graph vs eager "
              f"ops: logits {tuple(eager[0].shape)} max_abs_diff={diff:.3e}, next tokens "
              f"equal: {torch.equal(eager[1], replay[1])}")
        check_chunk_replay(cfg, eng, gen)


def check_chunk_replay(cfg, eng, gen) -> None:
    """One chunk graph, 128 rows at kv bucket 1024, replayed at offsets
    800 and 896 of slot 2 (the second the prompt's last chunk), each
    held bit for bit against an eager chunk tick from the same state:
    the last row's logits, the slot's new KV rows, lengths, tokens, token
    buffer and positions, and every Mamba layer's conv and SSM state.
    Before each run the chunk's KV rows are zeroed, so the replay has to
    write them itself; the rows before the chunk and the slot's Mamba
    states hold random values."""
    slot, c, kv = 2, 128, 1024
    dev = torch.device("cuda")
    toks = torch.randint(2, cfg.vocab, (1, c), generator=gen, device=dev)
    for lc in eng.cache:
        for t in lc.values():
            t[slot].normal_(generator=gen)
    key = (c, kv if eng._attends else 0)
    replays = eng.chunk_graphs[key].replays if key in eng.chunk_graphs else 0
    same = []
    for off, last in ((800, False), (896, True)):
        runs = []
        for graphs in (False, True):
            with eng._state_kept():
                for lc in eng.cache:
                    if "k" in lc:
                        lc["k"][slot, off:off + c].zero_()
                        lc["v"][slot, off:off + c].zero_()
                eng.cuda_graphs = graphs
                eng._chunk_tick(toks, off, slot, last, kv)
                runs.append([eng.chunk_logits.clone(), eng.lens.clone(), eng.toks.clone(),
                             eng.buf.clone(), eng.pos.clone()]
                            + [lc[n][slot, off:off + c].clone() if n in ("k", "v")
                               else lc[n][slot].clone() for lc in eng.cache for n in lc])
        torch.cuda.synchronize()
        same.append(all(torch.equal(a, b) for a, b in zip(*runs)))
    n = eng.chunk_graphs[key].replays - replays
    what = "conv and SSM states" if not eng._attends else "KV rows"
    print(f"  chunk graph {key} replayed at offsets 800 and 896 of slot {slot} ({n} "
          f"replays of one graph): last-row logits, lens/toks/buf/pos and the slot's "
          f"{what} bit-identical to an eager chunk tick from the same state: {same}")
    require(n == 2 and all(same), f"chunk graph {key} at two offsets: replays {n}, "
                                  f"bit-identical to eager {same}")


def profile_step(name: str, fn, reps: int, graph: bool):
    """Print ``fn``'s host wall and device busy per call, with its largest
    device items; returns (wall, busy) in ms (busy 0 where the profiler
    saw none)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    # kernel records only: a CPU op also carries the device time of the
    # kernels it launched, which would count them twice
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / reps / 1e3
    # the events' span stands beside a replay's busy time in case the
    # profiler does not see the kernels inside a graph
    require(busy > 0 or graph, f"{name}: the profiler saw no device time")
    span = ""
    if graph:
        # a replay is queued in microseconds, so the events bracket the
        # graph's kernels back to back
        s, e = _event(), _event()
        s.record()
        for _ in range(reps):
            fn()
        e.record()
        torch.cuda.synchronize()
        span = f", device span {s.elapsed_time(e) / reps:.2f} ms"
    top = sorted(events, key=lambda e: e.self_device_time_total, reverse=True)[:6]
    tops = "; ".join(f"{e.key[:48]} {e.self_device_time_total / reps / 1e3:.3f} ms"
                     f" x{e.count // reps}" for e in top)
    ours = "; ".join(
        f"{_kernel_name(e.key)} {e.self_device_time_total / reps / 1e3:.3f} ms"
        f" x{e.count // reps}" for e in events if "repro::" in e.key)
    seen = (f"device busy {busy:.2f} ms ({busy / wall:.1%}), idle {1 - busy / wall:.1%}"
            if busy > 0 else "device busy not seen by the profiler")
    print(f"  {name}: wall {wall:.2f} ms, {seen}{span}; top: {tops}; "
          f"csrc kernels: {ours or 'none'}")
    return wall, busy


def _kernel_name(key: str) -> str:
    """``void repro::(anonymous namespace)::matmul_kernel<2>(...)`` →
    ``matmul_kernel<2>``."""
    name = key[key.index("repro::"):].replace("(anonymous namespace)::", "")
    return name.split("(")[0].split("::")[-1]


def check_chunk_step(cfg, params, toks, max_len, relative: bool,
                     offsets=(SERVE_CHUNK,)) -> None:
    """The prompt's chunks from offset 0 up to the last of ``offsets``
    through ``chunk_step`` three ways — with the kernels, with plain torch
    ops, and with plain ops on f32 copies of the weights — each chunk
    from the cache the one before returned, and the logits of the chunk
    at each of ``offsets`` compared.  For a model with experts, also the
    number of (token, k) expert picks in which the legs differ there, and
    a fourth run with the kernels that takes the plain run's picks in
    every layer of every chunk: its distance from the plain run is the
    kernels' own, with no routing flip in it."""
    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode

    def run(cfg_, params_, kernels, replay=None):
        cache = T.init_cache(cfg_, 1, max_len, "cuda")
        logits, picks = {}, {}
        with kernel_mode(enabled=kernels):
            for off in range(0, max(offsets) + 1, SERVE_CHUNK):
                with routed(replay[off] if replay else None) as picks[off]:
                    lg, cache = T.chunk_step(params_, cfg_, toks[:, off:off + SERVE_CHUNK],
                                             cache, off, off + SERVE_CHUNK)
                # a Mamba state may be a view of the whole chunk's f32 states
                cache = [{n: t.clone() for n, t in lc.items()} if "ssm" in lc else lc
                         for lc in cache]
                if off in offsets:
                    logits[off] = lg.float()
                del lg
        return logits, picks

    (kerns, kpicks), (plains, ppicks) = run(cfg, params, True), run(cfg, params, False)
    f32_params = {k: F32Layers(v) if isinstance(v, list) else v.float()
                  for k, v in params.items()}
    f32s, fpicks = run(cfg.scaled(dtype="float32"), f32_params, False)
    held = run(cfg, params, True, replay=ppicks)[0] if cfg.n_experts else None
    torch.cuda.synchronize()
    for off in offsets:
        if cfg.n_experts:
            e = cfg.n_experts
            total = sum(ids.numel() for ids in ppicks[off])
            print(f"  expert picks at offset {off}: of {total} (token, k) picks, "
                  f"{pick_flips(kpicks[off], ppicks[off], e)} differ between the kernels "
                  f"and plain runs, {pick_flips(ppicks[off], fpicks[off], e)} between "
                  f"plain and f32, {pick_flips(kpicks[off], fpicks[off], e)} between "
                  f"kernels and f32; with the plain run's picks, kernels vs plain "
                  f"rms_rel={rms(held[off] - plains[off]) / rms(plains[off]):.3e} "
                  f"max_abs_err={float((held[off] - plains[off]).abs().max()):.3e}")
        compare_logits(f"chunk_step logits {tuple(kerns[off].shape)} at offset {off}",
                       kerns[off], plains[off], f32s[off], relative)


class F32Layers:
    """``params["layers"]`` for the f32 leg: each layer is cast to f32
    when the walk reaches it, so one layer's f32 copy is alive at a time."""

    def __init__(self, layers):
        self.layers = layers

    def __iter__(self):
        from repro_torch.tree import map_tree
        return (map_tree(torch.Tensor.float, lp) for lp in self.layers)


@contextmanager
def routed(replay=None):
    """Collect the expert ids (t, k) of every MoE call inside the block
    (``mlp.route`` wrapped).  With ``replay``, such a list from another
    run, the i-th call takes the i-th picks instead, with gates
    renormalised from its own router's probabilities."""
    from repro_torch.model import mlp as MLP

    route, log = MLP.route, []

    def wrapped(p, cfg, xt):
        probs, gates, ids = route(p, cfg, xt)
        if replay:
            ids = replay[len(log)]
            gates = probs.gather(-1, ids)
            gates = gates / gates.sum(-1, keepdim=True).clamp(min=1e-9)
        log.append(ids)
        return probs, gates, ids
    MLP.route = wrapped
    try:
        yield log
    finally:
        MLP.route = route


def pick_flips(a, b, e: int) -> int:
    """(token, k) picks in layer list ``a`` that ``b`` does not make (each
    entry the (..., k) expert ids of one MoE call)."""
    def per_token(ids):
        return F.one_hot(ids.reshape(-1, ids.shape[-1]), e).sum(1)
    return sum(int((per_token(x) > per_token(y)).sum()) for x, y in zip(a, b))


def compare_logits(what: str, kern, plain, f32, relative: bool) -> None:
    """Logits with the kernels against the plain bf16 path and against the
    f32 run (see LOGIT_RMS_TOL and LOGIT_VS_F32)."""
    require(bool(torch.isfinite(kern).all()), f"{what}: non-finite logits")

    rel = rms(kern - plain) / rms(plain)
    worst = float((kern - plain).abs().max())
    e_kern, e_plain = rms(kern - f32) / rms(f32), rms(plain - f32) / rms(f32)
    worst_plain = float((plain - f32).abs().max())
    agree = float((kern.argmax(-1) == plain.argmax(-1)).float().mean())
    if relative:
        rms_tol, max_tol = LOGIT_VS_F32 * e_plain, LOGIT_VS_F32 * worst_plain
    else:
        rms_tol, max_tol = LOGIT_RMS_TOL, LOGIT_MAX_TOL
    ok = rel <= rms_tol and worst <= max_tol and e_kern <= LOGIT_VS_F32 * e_plain
    print(f"  {what}, kernels vs plain bf16: rms_rel={rel:.3e} (tol {rms_tol:.3e}) max_abs_err="
          f"{worst:.3e} (tol {max_tol:.3e}); vs f32: kernels rms_rel="
          f"{e_kern:.3e}, plain rms_rel={e_plain:.3e} (tol {LOGIT_VS_F32}x), "
          f"plain max_abs_err={worst_plain:.3e}; argmax agreement {agree:.4f} "
          f"{'PASS' if ok else 'FAIL'}")
    require(ok, f"{what}: the kernels disagree with the plain path")


def rms(x) -> float:
    return float(x.pow(2).mean().sqrt())


ENCDEC_ARCH = "seamless_m4t_large_v2"
ENCDEC_PARAMS_B = 2.036          # jax.eval_shape of the reference's init_params
ENCDEC_PROMPT = 512
ENCDEC_STEPS = 16


def counted(fn):
    """``fn()`` with every kernel's launch count set to 0 just before and
    read just after: (its result, the counts)."""
    mods = kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {name: mod.LAUNCHES for name, mod in mods.items()}


def model_work(cfg, frames: int, seq: int, kv: int, stub: int = 0):
    """Operations and bytes of a model's path, as the port runs it: (bf16
    FLOPs, f32 FLOPs, bytes) of an encoder-decoder's encoder over
    ``frames`` stub frames (zeros without an encoder), and of the decoder
    over ``seq`` new rows that attend causally to ``kv`` rows in all
    (``seq == kv`` for the prefill; one token over the whole cache for a
    decode step, whose plain attention reads every row) and, with cross
    attention, across to memory; ``stub`` rows of a vlm's vision stub go
    through ``frontend_proj`` first (they are among the ``seq`` rows).
    The weight products run on the tensor cores in bf16; the plain
    attention (``_sdpa``: the encoder's, the cross attention, the decode
    step's) runs its two einsums in f32, kernel B its causal pairs in
    bf16.  Bytes: each weight read once, the stub, memory and the logits'
    rows once."""
    d, f, hq, hkv = cfg.d_model, cfg.d_ff, cfg.n_heads * cfg.hd, cfg.n_kv_heads * cfg.hd
    layer_w = d * (2 * hq + 2 * hkv) + 3 * d * f                 # attention + MLP
    proj = lambda rows: 2 * rows * d * (2 * hq + 2 * hkv)        # noqa: E731
    enc = (cfg.enc_layers * (proj(frames) + 6 * frames * d * f) + 2 * frames * d * d,
           cfg.enc_layers * 4 * frames * frames * hq,
           2 * (cfg.enc_layers * layer_w + d * d + 2 * frames * d) if cfg.enc_layers else 0)
    # cross attention: q, o; memory's k, v (and their weights, read once)
    cross = 2 * seq * d * 2 * hq + 2 * frames * d * 2 * hkv if cfg.cross_attention else 0
    cross_w = d * (2 * hq + 2 * hkv) if cfg.cross_attention else 0
    if seq == kv:                  # prefill: kernel B's causal pairs
        attn_bf16, attn_f32 = 4 * cfg.hd * cfg.n_heads * seq * (seq + 1) // 2, 0
    else:                          # decode: plain attention over the cache
        attn_bf16, attn_f32 = 0, 4 * seq * kv * hq
    dec_bf16 = (cfg.n_layers * (proj(seq) + cross + 6 * seq * d * f + attn_bf16)
                + 2 * d * cfg.vocab + 2 * stub * d * d)
    dec_f32 = cfg.n_layers * (attn_f32 + 4 * seq * frames * hq)
    dec_bytes = 2 * (cfg.n_layers * (layer_w + cross_w + frames * d + 2 * kv * hkv)
                     + d * cfg.vocab + cfg.vocab + (d * d + stub * d if stub else 0))
    return enc, (dec_bf16, dec_f32, dec_bytes)


def phase_encdec(gpu: str) -> dict:
    """Phase 7 (a) (see the module docstring): the encoder-decoder's own
    path at full width.  Returns the kernel launches of its prefill and
    decode run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode
    from repro_torch.model.layers import make_generator
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import leaves, map_tree

    cfg = get_arch(ENCDEC_ARCH)
    carried = collect_previous_phase()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params)) / 1e9
    print(f"[encdec] {cfg.name}: {describe(cfg)}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n_params:.3f} B parameters, init {time.perf_counter() - t0:.1f} s, peak "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; {carried}")
    require(abs(n_params - ENCDEC_PARAMS_B) <= 0.001,
            f"{n_params:.4f} B parameters, expected {ENCDEC_PARAMS_B}")

    gen = make_generator(1, dev)
    frames, plen = cfg.frontend_len, ENCDEC_PROMPT
    enc = torch.randn((1, frames, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    prompt = torch.randint(2, cfg.vocab, (1, plen), generator=gen, device=dev)
    batch = {"tokens": prompt, "enc_frontend": enc}
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)
    prefill_f32 = make_prefill_step(cfg.scaled(dtype="float32"))

    with kernel_mode(enabled=True):
        prefill_step(params, batch)                       # warm-up
        (logits, pre), launches = counted(lambda: prefill_step(params, batch))
        # memory as prefill computes it, for the decode steps
        with torch.no_grad():
            memory, mem_launches = counted(lambda: T.encode(params, cfg, enc))
    n_enc, n_dec = cfg.enc_layers, cfg.n_layers
    want = {"matmul": 3 * (n_enc + n_dec), "flash_attention": n_dec, "scan_gate": 0,
            "selective_scan": 0}
    print(f"  prefill, {frames} stub frames and a {plen}-token prompt, kernels on: "
          f"launches {launches} (expected {want}: the SwiGLU MLP's three products in "
          f"every layer, {frames} and {plen} rows; kernel B in every decoder layer; the "
          f"encoder's and the cross attention are plain, as in the reference)")
    require(launches == want, f"prefill launches {launches}, expected {want}")
    require(mem_launches["matmul"] == 3 * n_enc, f"encoder launches {mem_launches}")
    print(f"  memory for the decode steps (transformer.encode, a second encoder pass "
          f"beside the prefill's): launches {mem_launches}, added to the kernels line")

    # 16 greedy decode steps with memory from the merged prefill cache
    max_len = plen + ENCDEC_STEPS
    cache = T.merge_cache_slot(T.init_cache(cfg, 1, max_len, dev), pre, 0)
    tok = logits.argmax(-1)[:, None]
    toks, step_logits = [tok], []

    def decode():
        nonlocal cache, tok
        for i in range(ENCDEC_STEPS):
            lg, cache = serve_step(params, {"token": tok, "cache": cache,
                                            "cache_len": plen + i, "memory": memory})
            step_logits.append(lg.float())
            tok = lg.argmax(-1)[:, None]
            toks.append(tok)
    with kernel_mode(enabled=True):
        _, dec_launches = counted(decode)
    require(all(n == 0 for n in dec_launches.values()),
            f"a kernel launched in a decode step: {dec_launches}")
    generated = torch.cat(toks, 1)
    require(bool(((generated >= 0) & (generated < cfg.vocab)).all()), "token id out of range")
    print(f"  {ENCDEC_STEPS} greedy decode steps with memory (make_serve_step): no kernel "
          f"launch (one row: below min_matmul_rows; decode attention is plain); tokens "
          f"{generated[0, :8].tolist()}...")

    # prefill logits: kernels against the plain bf16 path and an f32 run
    with torch.no_grad(), kernel_mode(enabled=False):
        plain, _ = prefill_step(params, batch)
        f32 = map_tree(torch.Tensor.float, params)
        ref32, _ = prefill_f32(f32, {"tokens": prompt, "enc_frontend": enc.float()})
        del f32
    compare_logits(f"prefill logits {tuple(logits.shape)}", logits.float(), plain.float(),
                   ref32.float(), relative=False)
    # teacher forcing: one forward over the prompt and the fed tokens,
    # plain, against the prefill's and each decode step's logits
    with torch.no_grad(), kernel_mode(enabled=False):
        full, _ = T.forward(params, cfg, torch.cat([prompt, generated[:, :-1]], 1),
                            enc_frontend=enc)
    full = full[0, plen - 1:].float()
    stepped = torch.cat([logits.float()] + step_logits, 0)
    rel = rms(stepped - full) / rms(full)
    worst = float((stepped - full).abs().max())
    agree = float((stepped.argmax(-1) == full.argmax(-1)).float().mean())
    ok = rel <= LOGIT_RMS_TOL and worst <= LOGIT_MAX_TOL
    print(f"  teacher-forced forward over {plen + ENCDEC_STEPS} tokens against the prefill "
          f"and {ENCDEC_STEPS} decode steps' logits {tuple(stepped.shape)}: rms_rel={rel:.3e} "
          f"(tol {LOGIT_RMS_TOL}) max_abs_err={worst:.3e} (tol {LOGIT_MAX_TOL}); argmax "
          f"agreement {agree:.4f} {'PASS' if ok else 'FAIL'}")
    require(ok, "decode steps with memory disagree with the teacher-forced forward")

    # where the time goes: the encoder alone, the whole prefill, a decode step
    enc_w, dec_w = model_work(cfg, frames, plen, plen)
    _, step_w = model_work(cfg, frames, 1, max_len)
    with torch.no_grad(), kernel_mode(enabled=True):
        e_wall, e_busy = profile_step(f"encoder ({frames} frames: frontend_proj, "
                                      f"{n_enc} layers, enc_final_ln)",
                                      lambda: T.encode(params, cfg, enc), 3, False)
        p_wall, p_busy = profile_step(f"prefill (encoder and {plen}-token decoder)",
                                      lambda: prefill_step(params, batch), 3, False)
        step_cache = T.init_cache(cfg, 1, max_len, dev)
        s_wall, s_busy = profile_step(
            f"decode step with memory (cache_len {plen}, kv {max_len})",
            lambda: serve_step(params, {"token": tok, "cache": step_cache,
                                        "cache_len": plen, "memory": memory}), 5, False)
    e_bound, d_bound, s_bound = (work_bound(w) for w in (enc_w, dec_w, step_w))
    print(f"  prefill wall {p_wall:.2f} ms, busy {p_busy:.2f} ms: encoder wall {e_wall:.2f} "
          f"/ busy {e_busy:.2f} ms against a bound of {e_bound:.2f} ms "
          f"({enc_w[0] / 1e12:.2f} TFLOP bf16, {enc_w[1] / 1e12:.2f} TFLOP f32); decoder "
          f"(prefill less encoder) wall {p_wall - e_wall:.2f} / busy {p_busy - e_busy:.2f} "
          f"ms against {d_bound:.2f} ms ({dec_w[0] / 1e12:.2f} TFLOP bf16, "
          f"{dec_w[1] / 1e12:.2f} TFLOP f32); decode step wall {s_wall:.2f} / busy "
          f"{s_busy:.2f} ms against {s_bound:.2f} ms ({step_w[2] / 1e9:.2f} GB, "
          f"{step_w[0] / 1e12:.2f} TFLOP bf16 recomputing memory's k/v); phase peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: {gpu}")
    return {k: launches[k] + mem_launches[k] + dec_launches[k] for k in launches}


VLM_ARCH = "qwen2_vl_7b"
VLM_PARAMS_B = 7.628             # jax.eval_shape of the reference's init_params
VLM_PROMPT = 512
VLM_STEPS = 16


def phase_vlm(gpu: str) -> dict:
    """Phase 8 (a) (see the module docstring): the vlm's own path at full
    width.  Returns the kernel launches of its prefill and decode run."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.model import transformer as T
    from repro_torch.model.kernel_mode import kernel_mode
    from repro_torch.model.layers import make_generator
    from repro_torch.train.steps import make_prefill_step, make_serve_step
    from repro_torch.tree import leaves, map_tree

    cfg = get_arch(VLM_ARCH)
    carried = collect_previous_phase()
    torch.cuda.reset_peak_memory_stats()
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    params = T.init_params(cfg, seed=0, device=dev)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in leaves(params)) / 1e9
    print(f"[vlm] {cfg.name}: {describe(cfg)}, M-RoPE, a {cfg.frontend_len}-row vision "
          f"stub, vocab {cfg.vocab}, {cfg.dtype}: {n_params:.3f} B parameters, init "
          f"{time.perf_counter() - t0:.1f} s; {carried}")
    require(abs(n_params - VLM_PARAMS_B) <= 0.001,
            f"{n_params:.4f} B parameters, expected {VLM_PARAMS_B}")

    gen = make_generator(1, dev)
    fl, plen = cfg.frontend_len, VLM_PROMPT
    rows = fl + plen
    stub = torch.randn((1, fl, cfg.d_model), generator=gen, device=dev).to(torch.bfloat16)
    prompt = torch.randint(2, cfg.vocab, (1, plen), generator=gen, device=dev)
    batch = {"tokens": prompt, "frontend": stub}
    prefill_step, serve_step = make_prefill_step(cfg), make_serve_step(cfg)

    with kernel_mode(enabled=True):
        prefill_step(params, batch)                       # warm-up
        (logits, pre), launches = counted(lambda: prefill_step(params, batch))
    want = {"matmul": 3 * cfg.n_layers, "flash_attention": cfg.n_layers, "scan_gate": 0,
            "selective_scan": 0}
    print(f"  prefill, a {fl}-row stub and a {plen}-token prompt ({rows} rows), kernels "
          f"on: launches {launches} (expected {want}: the SwiGLU MLP's three products "
          f"and kernel B in every layer)")
    require(launches == want, f"prefill launches {launches}, expected {want}")

    # greedy decode steps from the merged prefill cache, at M-RoPE (L, L, L)
    max_len = rows + VLM_STEPS

    def decode(pre_cache, first, fed=None):
        cache = T.merge_cache_slot(T.init_cache(cfg, 1, max_len, dev), pre_cache, 0)
        tok, toks, out = first, [first], []
        for i in range(VLM_STEPS):
            lg, cache = serve_step(params, {"token": tok, "cache": cache,
                                            "cache_len": rows + i})
            out.append(lg.float())
            tok = lg.argmax(-1)[:, None] if fed is None else fed[:, i + 1:i + 2]
            toks.append(tok)
        return torch.cat(out, 0), torch.cat(toks, 1)
    first = logits.argmax(-1)[:, None]
    with kernel_mode(enabled=True):
        (step_logits, generated), dec_launches = counted(lambda: decode(pre, first))
    require(all(n == 0 for n in dec_launches.values()),
            f"a kernel launched in a decode step: {dec_launches}")
    require(bool(((generated >= 0) & (generated < cfg.vocab)).all()), "token id out of range")
    print(f"  {VLM_STEPS} greedy decode steps (make_serve_step, M-RoPE (L, L, L)): no kernel "
          f"launch (one row: below min_matmul_rows; decode attention is plain); tokens "
          f"{generated[0, :8].tolist()}...")

    # the prefill's logits: kernels against the plain bf16 path and an f32
    # run; the decode steps against plain ones fed the same tokens from the
    # plain prefill's cache
    with torch.no_grad(), kernel_mode(enabled=False):
        plain, plain_pre = prefill_step(params, batch)
        plain_steps, _ = decode(plain_pre, first, fed=generated)
        del plain_pre
        f32 = map_tree(torch.Tensor.float, params)
        ref32, _ = make_prefill_step(cfg.scaled(dtype="float32"))(
            f32, {"tokens": prompt, "frontend": stub.float()})
        del f32
    compare_logits(f"prefill logits {tuple(logits.shape)}", logits.float(), plain.float(),
                   ref32.float(), relative=False)
    rel = rms(step_logits - plain_steps) / rms(plain_steps)
    worst = float((step_logits - plain_steps).abs().max())
    agree = float((step_logits.argmax(-1) == plain_steps.argmax(-1)).float().mean())
    ok = rel <= LOGIT_RMS_TOL and worst <= LOGIT_MAX_TOL
    print(f"  {VLM_STEPS} decode steps' logits {tuple(step_logits.shape)} from the kernels' "
          f"prefill cache vs plain bf16 from the plain one, fed the same tokens: rms_rel="
          f"{rel:.3e} (tol {LOGIT_RMS_TOL}) max_abs_err={worst:.3e} (tol {LOGIT_MAX_TOL}); "
          f"argmax agreement {agree:.4f} {'PASS' if ok else 'FAIL'}")
    require(ok, "the decode steps after the kernels' prefill disagree with the plain path")

    # where the time goes: the whole prefill and one decode step
    _, pre_w = model_work(cfg, 0, rows, rows, stub=fl)
    _, step_w = model_work(cfg, 0, 1, max_len)
    with torch.no_grad(), kernel_mode(enabled=True):
        p_wall, p_busy = profile_step(f"prefill ({fl} stub rows and a {plen}-token prompt)",
                                      lambda: prefill_step(params, batch), 3, False)
        step_cache = T.init_cache(cfg, 1, max_len, dev)
        s_wall, s_busy = profile_step(
            f"decode step (cache_len {rows}, kv {max_len})",
            lambda: serve_step(params, {"token": first, "cache": step_cache,
                                        "cache_len": rows}), 5, False)
    p_bound, s_bound = work_bound(pre_w), work_bound(step_w)
    print(f"  prefill wall {p_wall:.2f} / busy {p_busy:.2f} ms against a bound of "
          f"{p_bound:.2f} ms ({pre_w[0] / 1e12:.2f} TFLOP bf16, {pre_w[2] / 1e9:.2f} GB); "
          f"decode step wall {s_wall:.2f} / busy {s_busy:.2f} ms against {s_bound:.2f} ms "
          f"({step_w[2] / 1e9:.2f} GB, {step_w[1] / 1e9:.2f} GFLOP f32 attention); phase "
          f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; card: "
          f"{gpu}")
    return {k: launches[k] + dec_launches[k] for k in launches}


TRAIN_STEPS = 8
TRAIN_BATCH, TRAIN_SEQ = 8, 256


def phase_train(gpu: str) -> None:
    """Phase 9 (see the module docstring)."""
    print(f"[train] {collect_previous_phase()}")
    mods = kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    train_parity()
    train_full(gpu)
    train_restore()
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    print(f"  kernel launches in the train phase: {launches}")
    require(all(n == 0 for n in launches.values()),
            f"a kernel was launched on the training path: {launches}")


def _rel(a: float, b: float) -> float:
    return abs(a - b) / max(abs(b), 1e-30)


def train_parity() -> None:
    """(a) Two f32 train steps on the card and on the CPU from the same
    weights (drawn on the CPU, copied to the card) and the same batches.
    Elementwise parameters are not compared: Adam's first step moves each
    by about lr·sign(g), and entries with g ≈ 0 may take either sign."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves, map_tree

    cfg = get_arch("granite_3_2b").scaled(n_layers=2, dtype="float32")
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=2)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=128, global_batch=2, seed=0))
    t0 = time.perf_counter()
    cpu = T.init_params(cfg, seed=0, device="cpu")
    runs = {}
    for dev, params in (("cuda", map_tree(lambda t: t.to("cuda"), cpu)), ("cpu", cpu)):
        for t in leaves(params):
            t.requires_grad_(True)
        step, state = make_train_step(cfg, opt, 1), adamw.init(params)
        out = []
        for s in range(2):
            batch = {k: torch.from_numpy(v).to(dev, torch.long)
                     for k, v in data.batch(s).items()}
            _, _, m = step(params, state, batch)
            out.append((float(m["loss"]), float(m["grad_norm"])))
        runs[dev] = out
        del params, state, step
    (l1, g1), (l2, _) = runs["cuda"]
    (c1, h1), (c2, _) = runs["cpu"]
    e1, eg, e2 = _rel(l1, c1), _rel(g1, h1), _rel(l2, c2)
    ok = e1 <= 1e-4 and eg <= 1e-3 and e2 <= 1e-3
    print(f"[train] (a) f32 parity, {cfg.name} at full width, 2 layers, batch 2, seq "
          f"128, card vs CPU: step 1 loss {l1:.7f} vs {c1:.7f} (rel {e1:.2e}, tol 1e-4), "
          f"grad_norm {g1:.7f} vs {h1:.7f} (rel {eg:.2e}, tol 1e-3); step 2 loss "
          f"{l2:.7f} vs {c2:.7f} (rel {e2:.2e}, tol 1e-3) {'PASS' if ok else 'FAIL'} "
          f"({time.perf_counter() - t0:.1f} s)")
    require(ok, "train step on the card disagrees with the CPU")


@contextmanager
def timed_updates(marks: list):
    """Record a CUDA event before and after every ``adamw.update`` inside
    the block, appended to ``marks`` as pairs."""
    from repro_torch.optim import adamw

    update = adamw.update

    def timed(*args, **kw):
        s, e = _event(), _event()
        s.record()
        out = update(*args, **kw)
        e.record()
        marks.append((s, e))
        return out
    adamw.update = timed
    try:
        yield
    finally:
        adamw.update = update


def train_full(gpu: str) -> None:
    """(b) The ``Trainer`` on ``granite_3_2b`` at full width and depth."""
    from repro_torch.configs.registry import get_arch
    from repro_torch.model import transformer as T
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainConfig
    from repro_torch.tree import leaves

    cfg = get_arch("granite_3_2b")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    T.REMAT = "full"
    tr = Trainer(TrainConfig(arch=cfg, total_steps=TRAIN_STEPS, global_batch=TRAIN_BATCH,
                             seq_len=TRAIN_SEQ, log_every=1, device="cuda",
                             opt=AdamWConfig(lr=3e-4, warmup_steps=2,
                                             total_steps=TRAIN_STEPS)))
    torch.cuda.synchronize()
    params = leaves(tr.params)
    n = sum(p.numel() for p in params)
    # AdamW's bytes: each parameter read and written, its gradient read by
    # the norm and by the update, m and v read and written (f32)
    upd_bytes = sum(p.numel() * (4 * p.element_size() + 16) for p in params)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    print(f"[train] (b) {cfg.name}: {describe(cfg)}, vocab {cfg.vocab}, {cfg.dtype}: "
          f"{n / 1e9:.3f} B parameters, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}, "
          f"REMAT={T.REMAT}, init {time.perf_counter() - t0:.1f} s")

    walls, fb, upd = [], [], []
    for step in range(TRAIN_STEPS):
        marks = []
        start = _event()
        t1 = time.perf_counter()
        start.record()
        with timed_updates(marks):
            tr.run_step(step)
        walls.append(time.perf_counter() - t1)        # run_step reads the metrics
        fb.append(start.elapsed_time(marks[0][0]))
        upd.append(marks[0][0].elapsed_time(marks[0][1]))
    peak = torch.cuda.max_memory_allocated() / 2**30
    losses = [h["loss"] for h in tr.history]
    norms = [h["grad_norm"] for h in tr.history]
    finite = all(map(math.isfinite, losses + norms))
    wall, fb_ms, upd_ms = (statistics.median(x[1:]) for x in (walls, fb, upd))
    upd_bound, _ = bound_ms(upd_bytes, 0.0)
    mfu = 6.0 * n * tokens / wall / PEAK_BF16
    print(f"  losses {[round(x, 4) for x in losses]}, grad norms "
          f"{[round(x, 3) for x in norms]}")
    print(f"  medians over steps 2-{TRAIN_STEPS}: step wall {wall * 1e3:.1f} ms, "
          f"{tokens / wall:.0f} tokens/s, model FLOPs share {mfu:.1%} (6·N·tokens over "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s); forward+backward {fb_ms:.1f} ms, AdamW update "
          f"{upd_ms:.1f} ms against a bound of {upd_bound:.1f} ms ({upd_bytes / 1e9:.1f} GB "
          f"at {PEAK_BYTES / 1e12:.2f} TB/s); peak device memory {peak:.2f} GiB; card: {gpu}")
    profile_train_step(tr, TRAIN_STEPS, wall * 1e3)
    require(finite, f"non-finite loss or grad norm: {losses} {norms}")
    require(losses[-1] <= losses[0] - 0.05,
            f"the loss did not fall by 0.05 over {TRAIN_STEPS} steps: {losses}")

    T.REMAT = "none"
    torch.cuda.reset_peak_memory_stats()
    walls = []
    for step in range(TRAIN_STEPS, TRAIN_STEPS + 2):
        t1 = time.perf_counter()
        tr.run_step(step)
        walls.append(time.perf_counter() - t1)
    T.REMAT = "full"
    print(f"  REMAT=none: step walls {[round(w * 1e3, 1) for w in walls]} ms, peak "
          f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    require(all(map(math.isfinite, [h["loss"] for h in tr.history[-2:]])),
            "non-finite loss with REMAT=none")


def profile_train_step(tr, step: int, wall_ms: float) -> None:
    """One more train step under ``torch.profiler``: device busy (the sum
    of kernel times) against the profiled step's wall and against
    ``wall_ms``, the unprofiled steps' median; the largest kernels, and
    the aten ops whose kernels take the most device time."""
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        tr.run_step(step)
        wall = (time.perf_counter() - t0) * 1e3
    avgs = prof.key_averages()
    events = [e for e in avgs if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in events) / 1e3
    require(busy > 0, "train step: the profiler saw no device time")

    def top(evs):
        evs = sorted(evs, key=lambda e: e.self_device_time_total, reverse=True)[:8]
        return "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.1f} ms x{e.count}"
                         for e in evs)
    ops = [e for e in avgs if e.device_type == DeviceType.CPU
           and e.self_device_time_total > 0]
    print(f"  one profiled step: wall {wall:.1f} ms, device busy {busy:.1f} ms "
          f"({busy / wall:.1%} of it; {busy / wall_ms:.1%} of the unprofiled median "
          f"wall {wall_ms:.1f} ms), {sum(e.count for e in events)} kernels")
    print(f"    top kernels: {top(events)}")
    print(f"    top aten ops by their kernels' time: {top(ops)}")


def train_restore() -> None:
    """(c) Save after two steps, restore into a fresh ``Trainer``, take the
    third step: against three steps without the interruption."""
    import shutil

    from repro_torch.configs.registry import get_arch
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainConfig
    from repro_torch.tree import flatten

    ckpt = os.path.join(ROOT, "build", "chip_smoke_ckpt")
    shutil.rmtree(ckpt, ignore_errors=True)
    cfg = get_arch("granite_3_2b").scaled(n_layers=2)

    def trainer(**kw):
        return Trainer(TrainConfig(arch=cfg, total_steps=3, global_batch=TRAIN_BATCH,
                                   seq_len=TRAIN_SEQ, log_every=100, device="cuda",
                                   opt=AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=8),
                                   **kw))
    whole = trainer()
    for s in range(3):
        whole.run_step(s)
    want = whole.history[-1]
    first = trainer(ckpt_dir=ckpt)
    for s in range(2):
        first.run_step(s)
    t0 = time.perf_counter()
    first.save(2)
    save_s = time.perf_counter() - t0
    del first
    second = trainer(ckpt_dir=ckpt)
    t0 = time.perf_counter()
    second.restore()
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    got = second.run_step(2)
    fw, fs = flatten(whole.params), flatten(second.params)
    same_params = all(torch.equal(fw[k], fs[k]) for k in fw)
    size = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs_ in os.walk(ckpt)
               for f in fs_)
    shutil.rmtree(ckpt, ignore_errors=True)
    e_loss, e_norm = _rel(got["loss"], want["loss"]), _rel(got["grad_norm"], want["grad_norm"])
    ok = e_loss <= 1e-6 and e_norm <= 1e-6
    print(f"[train] (c) restore, {cfg.name} at full width, 2 layers, bf16: step 3 after "
          f"save/restore loss {got['loss']!r} vs {want['loss']!r} (rel {e_loss:.1e}), "
          f"grad_norm {got['grad_norm']!r} vs {want['grad_norm']!r} (rel {e_norm:.1e}), "
          f"tol 1e-6 {'PASS' if ok else 'FAIL'}; metrics bit-identical {got == want}, "
          f"parameters after the step bit-identical {same_params}; checkpoint "
          f"{size / 1e9:.2f} GB, save {save_s:.1f} s, restore {restore_s:.1f} s")
    require(ok, "the restored run's third step differs from the uninterrupted one")


DIST_STEPS = 4
# phase 10 (b): the port's dry-run CLI on these cells (arch, shape, flags)
DRYRUN_CELLS = (("qwen3_0_6b", "decode_32k", ()),
                ("granite_3_2b", "train_4k", ("--single-pod-only",)))
DRYRUN_DIR = os.path.join(ROOT, "artifacts", "dryrun_torch")
DRYRUN_TIMEOUT_S = 900


@contextmanager
def dryrun_cli():
    """Phase 10 (b)'s dry runs: the port's CLI (``python -m
    repro_torch.launch.dryrun``) as subprocesses, one per row of
    ``DRYRUN_CELLS``, started when the card phases begin (they run on
    fake process groups, on one host core each, and need no card) and
    read in phase 10.  Yields their (arch, shape, flags, process, log
    path); stops any still running on the way out."""
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    runs = []
    try:
        for arch, shape, flags in DRYRUN_CELLS:
            path = os.path.join(ROOT, "build", f"chip_smoke_dryrun_{arch}__{shape}.log")
            with open(path, "w") as log:
                proc = subprocess.Popen(
                    [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch", arch,
                     "--shape", shape, *flags], cwd=ROOT, stdout=log,
                    stderr=subprocess.STDOUT, env=schedd_env(OMP_NUM_THREADS="1"))
            runs.append((arch, shape, flags, proc, path))
        yield runs
    finally:
        for *_, proc, _ in runs:
            if proc.poll() is None:
                proc.kill()
                proc.wait(timeout=10)


def phase_dist(gpu: str, dryruns) -> None:
    """Phase 10 (see the module docstring)."""
    print(f"[dist] {collect_previous_phase()}")
    mods = kernel_modules()
    for mod in mods.values():
        mod.LAUNCHES = 0
    step_flops = dist_step(gpu)
    dist_dryrun(dryruns)
    dist_roofline(step_flops, gpu)
    launches = {name: mod.LAUNCHES for name, mod in mods.items()}
    require(all(n == 0 for n in launches.values()),
            f"a kernel was launched in the distributed phase: {launches}")


def _free_port() -> int:
    import socket
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        return sk.getsockname()[1]


def dist_step(gpu: str) -> float:
    """(a) Granite's full-width bf16 train step (phase 9's batch, sequence
    and remat) on a one-rank NCCL group's 1×1 mesh, parameters, AdamW
    state and batch DTensors placed by ``param_pspecs`` and
    ``batch_pspec``, against the unsharded step from the same weights and
    batches.  Returns the per-device FLOPs of one sharded step
    (``dryrun.DeviceCounter``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.configs.registry import get_arch
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import mesh as M
    from repro_torch.launch.dryrun import DeviceCounter
    from repro_torch.model import sharding as S
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import leaves

    cfg = get_arch("granite_3_2b")
    T.REMAT = "full"
    opt = adamw.AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=TRAIN_STEPS)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=TRAIN_SEQ,
                                  global_batch=TRAIN_BATCH, seed=0))
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in data.batch(s).items()} for s in range(DIST_STEPS)]

    def run(mesh):
        """DIST_STEPS steps from seed-0 weights, then one more under the
        per-device counter: (walls, metrics, peak GiB, FLOPs)."""
        torch.cuda.reset_peak_memory_stats()
        params = T.init_params(cfg, seed=0, device="cuda")
        place = lambda b: b  # noqa: E731
        if mesh is not None:
            params = M.distribute(params, M.param_pspecs(params, cfg, mesh), mesh)
            rows = S.spec_to_placements(M.batch_pspec(mesh, TRAIN_BATCH),
                                        mesh.mesh_dim_names)
            place = lambda b: {k: distribute_tensor(v, mesh, rows)  # noqa: E731
                               for k, v in b.items()}
        for t in leaves(params):
            t.requires_grad_(True)
        state, step = adamw.init(params), make_train_step(cfg, opt, 1)
        walls, metrics = [], []
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            _, _, m = step(params, state, place(b))
            metrics.append({k: float(v) for k, v in m.items()})     # reads the card
            walls.append(time.perf_counter() - t0)
        with DeviceCounter() as cnt:
            step(params, state, place(batches[0]))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        del params, state, step
        gc.collect()
        torch.cuda.empty_cache()
        return walls, metrics, peak, cnt.flops

    t0 = time.perf_counter()
    plain = run(None)
    torch.cuda.set_device(0)
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data", "model"))
        S.set_logical_rules(mesh, M.logical_rules(cfg, mesh, batch=TRAIN_BATCH))
        S.set_param_handlers(*M.make_param_handlers(cfg, mesh))
        S.set_moe_groups(M.axis_size(mesh, M.dp_axes(mesh)))
        sharded = run(mesh)
    finally:
        S.clear_logical_rules()
        S.clear_param_handlers()
        dist.destroy_process_group()
    (w0, m0, peak0, _), (w1, m1, peak1, flops) = plain, sharded
    errs = [(_rel(b["loss"], a["loss"]), _rel(b["grad_norm"], a["grad_norm"]))
            for a, b in zip(m0, m1)]
    ok = errs[0][0] <= 1e-4 and all(e[1] <= 1e-3 for e in errs) \
        and all(e[0] <= 1e-3 for e in errs[1:])
    bits = [a == b for a, b in zip(m0, m1)]
    print(f"[dist] (a) {cfg.name} at full width, bf16, batch {TRAIN_BATCH} x seq "
          f"{TRAIN_SEQ}, REMAT={T.REMAT}, {DIST_STEPS} train steps unsharded and on a "
          f"one-rank NCCL group's 1x1 (data, model) mesh from the same weights "
          f"({time.perf_counter() - t0:.1f} s)")
    for i, (a, b) in enumerate(zip(m0, m1)):
        print(f"  step {i + 1}: loss {a['loss']!r} vs {b['loss']!r} (rel {errs[i][0]:.1e}), "
              f"grad_norm {a['grad_norm']!r} vs {b['grad_norm']!r} (rel {errs[i][1]:.1e}); "
              f"bit-identical {bits[i]}")
    print(f"  tolerances as phase 9's (loss 1e-4 at step 1, 1e-3 after; grad norm "
          f"1e-3): {'PASS' if ok else 'FAIL'}; all steps bit-identical {all(bits)}")
    print(f"  step wall, median of steps 2-{DIST_STEPS}: unsharded "
          f"{statistics.median(w0[1:]) * 1e3:.1f} ms, DTensor "
          f"{statistics.median(w1[1:]) * 1e3:.1f} ms (DTensor's host cost: "
          f"{statistics.median(w1[1:]) / statistics.median(w0[1:]):.2f}x); first steps "
          f"{w0[0] * 1e3:.1f} / {w1[0] * 1e3:.1f} ms; peak device memory {peak0:.2f} / "
          f"{peak1:.2f} GiB; card: {gpu}")
    print("  a one-rank mesh runs no collective across ranks: this checks the "
          "placements and DTensor's dispatch on the card, not the collectives "
          "(tests/test_torch_dist.py holds those on four gloo ranks)")
    require(ok, "the sharded train step disagrees with the unsharded one")
    return flops


def dist_dryrun(dryruns) -> None:
    """(b) The dry-run subprocesses started by :func:`dryrun_cli`."""
    for arch, shape, flags, proc, path in dryruns:
        t0 = time.perf_counter()
        try:
            rc = proc.wait(timeout=DRYRUN_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines() if ln.startswith("[dryrun]")]
        require(rc == 0, f"dry run {arch} {shape} exited with {rc}: {lines}")
        meshes = [(False, 256)] if "--single-pod-only" in flags else [(False, 256),
                                                                       (True, 512)]
        print(f"[dist] (b) python -m repro_torch.launch.dryrun --arch {arch} --shape "
              f"{shape} {' '.join(flags)}: waited {time.perf_counter() - t0:.1f} s")
        for multi, devices in meshes:
            mesh = "pod2x16x16" if multi else "pod16x16"
            with open(os.path.join(DRYRUN_DIR,
                                   f"{arch}__{shape}__{mesh}__baseline.json")) as f:
                d = json.load(f)
            require(d["ok"] and d["devices"] == devices,
                    f"dry run {arch} {shape} {mesh}: {d.get('error')}")
            rf, mem = d["roofline"], d["memory"]
            print(f"  {mesh}: ok, {d['devices']} devices, {mem['bytes_per_device'] / 2**30:.2f}"
                  f" GiB per device (arguments {mem['arguments'] / 2**30:.2f}, temp "
                  f"{mem['temp'] / 2**30:.2f}), {d['cost']['flops']:.4g} FLOPs and "
                  f"{d['cost']['bytes_accessed']:.4g} bytes (unfused) per device, "
                  f"{d['collectives']['weighted_bytes']:.4g} weighted collective bytes; "
                  f"terms compute {rf['compute_s']:.4g} s, memory {rf['memory_s']:.4g} s, "
                  f"collective {rf['collective_s']:.4g} s: bottleneck {rf['bottleneck']}; "
                  f"model_flops_frac {rf['model_flops_frac']:.3f}; run {d['run_s']} s on "
                  f"the host")


def dist_roofline(step_flops: float, gpu: str) -> None:
    """(c) ``roofline.model_flops`` of granite's (a) step against the FLOPs
    the step ran on the card: the reference's ``model_flops_frac``."""
    from repro_torch.configs.registry import ShapeConfig, get_arch
    from repro_torch.launch.roofline import model_flops

    cfg = get_arch("granite_3_2b")
    mf = model_flops(cfg, ShapeConfig("phase10", TRAIN_SEQ, TRAIN_BATCH, "train"))
    require(step_flops > 0, "the counter saw no FLOPs in the train step")
    print(f"[dist] (c) model_flops (6 N_active D) of {cfg.name} at batch {TRAIN_BATCH} x "
          f"seq {TRAIN_SEQ}: {mf:.5g}; FLOPs of one (a) step on the card (matmul and "
          f"attention products, remat's recompute included): {step_flops:.5g}; "
          f"model_flops_frac {mf / step_flops:.4f} (1 device); card: {gpu}")


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
        # the daemon stops before the last lines are printed
        with schedd_daemon() as sock:
            records = run_phases(gpu, sock)
    except SmokeFailure as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        return 1
    keys = ("name", "route", "source", "replaces", "launches", "max_abs_err",
            "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "cases")
    print(json.dumps({"kernels": [{k: r[k] for k in keys if k in r}
                                  for r in records]}))
    print(gpu_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def run_phases(gpu: str, sock: str) -> list:
    """Phases 0-10 with the daemon at ``sock``; returns the kernel records
    with their launches on the main path."""
    plans = phase_plans(gpu)
    phase_schedd(gpu, sock, plans)
    phase_autotune(gpu, sock)
    # every later plan asks the daemon first
    os.environ["POLYTOPS_TORCH_SCHEDD_SOCK"] = sock
    with dryrun_cli() as dryruns:
        return card_phases(gpu, dryruns)


def card_phases(gpu: str, dryruns) -> list:
    """Phases 1-10, with phase 10 (b)'s dry runs going on beside them."""
    phase_build()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    records = [phase_matmul(gen), phase_flash(gen), phase_scan_gate(gen),
               phase_selective_scan(gen)]
    phase_bench()
    # each path's counts, read around its own serve run
    granite = phase_serve(gpu, "granite_3_2b", ("matmul", "flash_attention"))
    falcon = phase_serve(gpu, "falcon_mamba_7b", ("scan_gate",),
                         relative_logits=True)
    gemma3 = phase_serve(gpu, "gemma3_4b", ("matmul", "flash_attention"),
                         check_offsets=(SERVE_CHUNK, 1280))
    qwen3_moe = phase_serve(gpu, "qwen3_moe_30b_a3b", ("flash_attention",))
    encdec = phase_encdec(gpu)
    seamless = phase_serve(gpu, ENCDEC_ARCH, ("matmul", "flash_attention"))
    vlm = phase_vlm(gpu)
    qwen2_vl = phase_serve(gpu, VLM_ARCH, ("matmul", "flash_attention"))
    phase_train(gpu)
    phase_dist(gpu, dryruns)
    for rec in records:
        rec["launches"] = sum(run[rec["name"]] for run in (granite, falcon, gemma3,
                                                           qwen3_moe, encdec, seamless,
                                                           vlm, qwen2_vl))
    return records


if __name__ == "__main__":
    sys.exit(main())
