"""The training driver: the port's train step (``train/steps.py``
``make_train_step``, as ``Trainer.run_step`` runs it: one metrics read a
step) with the port's AdamW and the mix's ``remat``, on weights and rows
drawn from the seed.

Set-up builds the one step object and runs its first ``checked_steps``
steps through it, on rows that all differ, and keeps what the check
compares: each step's loss, the first gradient as the optimizer got it
(from AdamW's first moment after one step, m / (1 - b1)) and, after the
last, each parameter's change from its drawn value.  The window then
continues the same object, step after step, until ``--seconds`` have
passed; it spans whole steps.  The check, once the program's state is
freed, runs the reference over the same rows from the same weights."""
from __future__ import annotations

import time
from typing import Any, Dict

from . import traffic, weights
from .cell import Cell, arch_config
from .trace import Slice, span

SALT_ROWS = 23


def rows(mix: Dict[str, Any], vocab: int, seed: int, step: int, device):
    """Step ``step``'s batch: (tokens, labels), each (batch, seq), drawn from
    the seed on the device."""
    import torch
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.torch_seed(seed, SALT_ROWS, step))
    t = torch.randint(2, vocab, (mix["batch"], mix["seq"] + 1), generator=gen, device=device)
    return t[:, :-1], t[:, 1:]


def norms(ts) -> list:
    import torch
    return torch.stack([t.detach().float().norm() for t in ts]).tolist()


def run(cell: Cell, seed: int, seconds: float, trace: bool, device, t0: float, log
        ) -> Dict[str, Any]:
    import torch
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    mix, cfg = cell.mix, cell.config
    arch = arch_config(cfg)
    T.REMAT = mix["remat"]
    params = weights.make(cfg, seed, device, leaves=True)
    flat = weights.leaves(params)
    for p in flat:
        p.requires_grad_(True)
    opt = adamw.AdamWConfig(**mix["opt"])
    state = adamw.init(params)
    step_fn = make_train_step(arch, opt, mix["n_micro"])

    def one(i: int) -> Dict[str, float]:
        nonlocal params, state
        tok, lab = rows(mix, cfg["vocab_size"], seed, i, device)
        params, state, m = step_fn(params, state, {"tokens": tok, "labels": lab})
        with span("read"):
            return dict(zip(m, torch.stack(list(m.values())).tolist()))

    losses, grads = [], None
    for i in range(mix["checked_steps"]):
        losses.append(one(i)["loss"])
        if i == 0:
            grads = norms(mm / (1 - opt.b1) for mm in weights.leaves(state.m))
    start = weights.make(cfg, seed, device)
    change = norms(p.detach().float() - q.float()
                   for p, q in zip(weights.leaves(params), weights.leaves(start)))
    del start
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    setup_s = time.perf_counter() - t0

    steps, failed = [], 0
    i = mix["checked_steps"]
    first = time.perf_counter()
    while True:
        a = time.perf_counter()
        with span("step"):
            m = one(i)
        b = time.perf_counter()
        failed += not all(x == x and abs(x) != float("inf") for x in m.values())
        steps.append((a, b))
        i += 1
        if b - first >= seconds:
            break
    tslice = Slice(device) if trace else None
    if tslice is not None:
        # the profiler slows what runs after its first start, so the traced
        # steps follow the window
        tslice.prime()
        tslice.start()
        for _ in range(mix["trace_steps"]):
            with span("step"):
                one(i)
            i += 1
        tslice.stop()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    rec = {"kind": "train", "seed": seed, "setup_s": setup_s, "window": (first, steps[-1][1]),
           "steps": steps, "step_tokens": mix["batch"] * mix["seq"], "attempted": len(steps),
           "failed": failed, "memory_peak_bytes": peak, "config": cfg, "mix": mix,
           "losses": losses, "grad_norms": grads, "change_norms": change,
           "leaf_names": weights.leaf_names(params),
           "trace": tslice.reduce() if tslice is not None else None}
    del params, state, step_fn, flat
    if device.type == "cuda":
        torch.cuda.empty_cache()
    return rec


def summary(rec) -> str:
    w0, w1 = rec["window"]
    walls = sorted(b - a for a, b in rec["steps"])
    return (f"window {w1 - w0:.3f} s: {len(rec['steps'])} steps of {rec['step_tokens']} tokens, "
            f"median step {walls[len(walls) // 2]:.4f} s; checked losses {rec['losses']}; "
            f"peak {rec['memory_peak_bytes'] / 2**30:.2f} GiB")


def gaps(prog, ref, keep) -> list:
    """Each kept leaf's gap between the program's norm and the reference's,
    against the larger of the leaf's reference norm and the median leaf's
    (None for a leaf left out)."""
    import statistics
    med = statistics.median(ref)
    return [abs(p - r) / max(r, med) if k else None for p, r, k in zip(prog, ref, keep)]


def worst(g: list, names: list) -> tuple:
    """The largest of ``g`` and the name of its leaf."""
    i = max((i for i, v in enumerate(g) if v is not None), key=lambda i: g[i])
    return g[i], names[i]


def readings(rec, ref) -> Dict[str, Any]:
    """Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out: AdamW moves them by rounding alone.  The worst
    leaf of each number is named beside it."""
    import statistics
    med = statistics.median(ref["grad_norms"])
    keep = [g >= 1e-3 * med for g in ref["grad_norms"]]
    names = rec.get("leaf_names") or [str(i) for i in range(len(keep))]
    grad, grad_at = worst(gaps(rec["grad_norms"], ref["grad_norms"], keep), names)
    change, change_at = worst(gaps(rec["change_norms"], ref["change_norms"], keep), names)
    return {"loss_gap": max(abs(a - b) / abs(b) for a, b in zip(rec["losses"], ref["losses"])),
            "grad_gap": grad, "change_gap": change, "grad_worst": grad_at,
            "change_worst": change_at, "left_out": keep.count(False)}


def reference_run(rec, seed: int, device, n_steps: int, prec: str = "f32") -> Dict[str, Any]:
    """The reference's first ``n_steps`` steps from the same weights and rows
    (with ``prec`` fp8: the control)."""
    from reference.common import Prec, exact_f32
    from reference.train import leaves as ref_leaves
    from reference.train import steps as ref_steps

    cfg, mix = rec["config"], rec["mix"]
    drawn = weights.make(cfg, seed, device)
    store = drawn["embed"].dtype
    p32 = _to_f32(drawn)
    del drawn
    for p in ref_leaves(p32):
        p.requires_grad_(True)
    batches = [rows(mix, cfg["vocab_size"], seed, i, device) for i in range(n_steps)]
    start = [p.detach().clone() for p in ref_leaves(p32)]
    with exact_f32():
        out = ref_steps(p32, cfg, mix["opt"], batches, store, Prec(prec))
    out["change_norms"] = norms(p.detach() - q for p, q in zip(ref_leaves(p32), start))
    return out


def _to_f32(tree):
    import torch
    if isinstance(tree, torch.Tensor):
        return tree.detach().float().clone()
    if isinstance(tree, dict):
        return {k: _to_f32(v) for k, v in tree.items()}
    return [_to_f32(v) for v in tree]


def check(rec, cell, seed: int, device, log) -> Dict[str, Any]:
    t = time.perf_counter()
    n = rec["mix"]["checked_steps"]
    ref = reference_run(rec, seed, device, n)
    out = readings(rec, ref)
    log(f"check: program losses {rec['losses']}, reference {ref['losses']}; {out} "
        f"in {time.perf_counter() - t:.1f} s")
    return out
