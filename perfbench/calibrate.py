#!/usr/bin/env python3
"""Readings for the limits of ``correct`` on the card; the benchmark's own
runs never run this.

    python3 perfbench/calibrate.py --cell granite_3_2b.docqa --seeds 1,2,3 \\
        [--control 1,2] [--seconds 8] [--slots N] [--fault F] [--out FILE]

One process builds the cell's server once and, for each seed, draws that
seed's weights into the same tensors and its traffic, runs the ramp and a
window of ``--seconds``, and reads the served sample against the reference
(the program's reading, ``logit_gap``) and, on the ``--control`` seeds,
the control: the reference with fp8 products in the program's place, read
at the same positions (``control_gap``).  ``--slots`` serves the mix with
that many slots and as many clients, to read what a larger batch costs.
A training cell runs each seed's set-up steps and the reference after them,
with ``--fault`` planted in the port's step."""
from __future__ import annotations

import argparse
import json
import sys
import time

import run as entry


def metrics_of(rec) -> dict:
    """The serving readings of a record, for the calibration lines."""
    from harness.runner import reader
    names = ("itl_p99_ms", "tok_s", "mfu.docqa", "batch_mean.docqa")
    return {n: reader(n)(rec) for n in names}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cell", required=True, help="<config>.<traffic>")
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", default="")
    ap.add_argument("--seconds", type=float, default=8.0)
    ap.add_argument("--slots", type=int, default=0)
    ap.add_argument("--out", default="")
    ap.add_argument("--fault", default="", choices=("",) + FAULTS)
    args = ap.parse_args(argv)
    entry.environment()
    import torch

    from harness import cell as C
    from harness import check
    from harness.serving import Server

    if not torch.cuda.is_available():
        print("no card", file=sys.stderr)
        return 2
    torch.set_num_threads(4)
    dev = torch.device("cuda")
    conf, traffic = args.cell.split(".", 1)
    cell = C.make(conf, traffic)
    seeds = [int(s) for s in args.seeds.split(",")]
    control = {int(s) for s in args.control.split(",") if s}
    out = open(args.out, "a") if args.out else None
    if cell.mix["kind"] == "train":
        return train(cell, seeds, control, args, dev, out)
    if args.slots:
        cell.mix.update(slots=args.slots, clients=args.slots)
    srv = None
    for seed in seeds:
        t0 = time.perf_counter()
        if srv is None:
            srv = Server(cell, seed, dev, t0, entry.log)
        else:
            srv.reseed(seed)
        rec = srv.drive(args.seconds)
        row = {"cell": args.cell, "seed": seed, "slots": cell.mix["slots"],
               "setup_s": srv.setup_s, "metrics": metrics_of(rec),
               "memory_peak_bytes": rec["memory_peak_bytes"]}
        n = check.limits(args.cell).get("requests", cell.mix["check_requests"])
        row.update(check.serve(rec, seed, dev, n, control=seed in control))
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


FAULTS = ("half_batch", "state_unchanged")


def plant(fault: str) -> None:
    """Break the port's train step underneath: the loss over the first half
    of the batch's rows alone, or an optimizer step that leaves the
    parameters as they were."""
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    if fault == "half_batch":
        real = T.lm_loss

        def half(params, cfg, tokens, labels, *a, **kw):
            h = max(tokens.shape[0] // 2, 1)
            return real(params, cfg, tokens[:h], labels[:h], *a, **kw)
        T.lm_loss = half
    elif fault == "state_unchanged":
        real_update = adamw.update

        def frozen(cfg, grads, state, params):
            import torch
            keep = [p.detach().clone() for p in adamw.leaves(params)]
            out = real_update(cfg, grads, state, params)
            with torch.no_grad():
                for p, k in zip(adamw.leaves(params), keep):
                    p.copy_(k)
            return out
        adamw.update = frozen


def train(cell, seeds, control, args, dev, out) -> int:
    from harness import training
    if args.fault:
        plant(args.fault)
    for seed in seeds:
        t0 = time.perf_counter()
        rec = training.run(cell, seed, args.seconds, False, dev, t0, entry.log)
        ref = training.reference_run(rec, seed, dev, rec["mix"]["checked_steps"])
        row = {"cell": args.cell, "seed": seed, "fault": args.fault, "setup_s": rec["setup_s"],
               "summary": training.summary(rec), **training.readings(rec, ref)}
        if seed in control:
            ctl = training.reference_run(rec, seed, dev, rec["mix"]["checked_steps"], "fp8")
            ctl["leaf_names"] = rec["leaf_names"]
            row.update({f"control_{k}": v for k, v in training.readings(ctl, ref).items()})
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            out.write(line + "\n")
            out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
