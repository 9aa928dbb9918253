"""Whether what the timed path produced is right, against the plain
reference, once the window has closed and the engine is freed.

Serving: a sample drawn from the seed of the requests the window finished,
the longest among them, some hundreds of served tokens.
The reference runs once over each prompt with its served tokens, and the
number compared is the widest gap by which a served token's logit lies
below the reference's best at its position, in units of that row's
standard deviation (the engine samples greedily, so a sound run reads
rounding alone).  The limits are the cell's own file in ``limits/``, with
the readings each was set from, and the sample's size (``requests``)."""
from __future__ import annotations

import json
from typing import Any, Dict, List

from . import traffic
from .cell import BENCH_DIR


def limits(cell_name: str) -> Dict[str, Any]:
    path = BENCH_DIR / "limits" / f"{cell_name}.json"
    return json.loads(path.read_text()) if path.exists() else {}


def sample(rec, seed: int, n: int) -> List[Any]:
    w0, w1 = rec["window"]
    fin = [lv for lv in rec["done"] if lv.done_t is not None and w0 <= lv.done_t <= w1]
    if not fin:
        return []
    gen = traffic.rng(seed, traffic.SALT_CHECK)
    longest = max(fin, key=lambda lv: (lv.spec.plen + len(lv.req.generated), lv.spec.idx))
    others = [lv for lv in fin if lv is not longest]
    return [longest] + [others[i] for i in gen.permutation(len(others))[:n - 1]]


def served_logits(cfg, params, seqs, precs):
    """For each (prompt (plen,), served tokens (n,)) the reference's logits
    at the n positions that chose them, once per precision in ``precs``:
    a list (per precision) of lists of (n, vocab) f32."""
    import torch

    from reference import model
    from reference.common import Prec, exact_f32

    mod = model(cfg["reference"])
    full = [torch.cat([p, s[:-1]]) for p, s in seqs]
    rows = [list(range(p.shape[0] - 1, p.shape[0] - 1 + s.shape[0])) for p, s in seqs]
    out = []
    with exact_f32(), torch.no_grad():
        for kind in precs:
            prec = Prec(kind)
            if hasattr(mod, "batch_logits"):
                width = max(f.shape[0] for f in full)
                toks = torch.stack([torch.nn.functional.pad(f, (0, width - f.shape[0]))
                                    for f in full])
                out.append(mod.batch_logits(params, cfg, toks, rows, prec))
            else:
                out.append([mod.logits(params, cfg, f, r, prec) for f, r in zip(full, rows)])
    return out


def serve(rec, seed: int, device, n_requests: int, control: bool = False) -> Dict[str, Any]:
    """The served sample's readings: ``logit_gap`` (the widest gap over the
    sample), the tokens compared, the share equal to the reference's
    choice; with ``control`` also the control's gap (the reference in fp8
    in the program's place, read at the same positions)."""
    import torch

    from reference.common import gaps

    pick = sample(rec, seed, n_requests)
    if not pick:
        return {"requests": 0, "tokens": 0}
    seqs = [(lv.req.prompt[0].to(device),
             torch.tensor(lv.req.generated, dtype=torch.long, device=device)) for lv in pick]
    logits = served_logits(rec["config"], rec["params"], seqs,
                           ("f32", "fp8") if control else ("f32",))
    ref = logits[0]
    g = torch.cat([gaps(lg, s) for lg, (_, s) in zip(ref, seqs)])
    agree = torch.cat([(lg.argmax(-1) == s) for lg, (_, s) in zip(ref, seqs)])
    out = {"requests": len(pick), "tokens": int(g.numel()),
           "logit_gap": float(g.max()), "agree": float(agree.float().mean()),
           "longest": max(lv.spec.plen + len(lv.req.generated) for lv in pick)}
    if control:
        c = torch.cat([gaps(lg, l8.argmax(-1)) for lg, l8 in zip(ref, logits[1])])
        out["control_gap"] = float(c.max())
    return out


def judge(readings: Dict[str, Any], lim: Dict[str, Any]) -> Dict[str, Any]:
    """Each compared number beside its limit; ``ok`` where every number is
    at or under its limit (a number with no limit, or not read, fails)."""
    checks = {}
    for name, spec in lim.items():
        if not isinstance(spec, dict):
            continue
        val = readings.get(name)
        checks[name] = {"value": val, "limit": spec["limit"],
                        "ok": val is not None and val <= spec["limit"]}
    if not checks:
        checks["limits"] = {"value": None, "limit": None, "ok": False}
    return checks
