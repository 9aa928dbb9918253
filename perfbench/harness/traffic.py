"""The one traffic generator: it reads a mix file's parameters and the
run's seed, and nothing of the program.

A mix fixes tables of sizes, drawn once from the mix's own ``table_seed``:
``round`` prompt lengths, output lengths and (open loop) gaps between
arrivals.  The request sequence is made of rounds, each holding every
entry of each table once, so every seed serves the same sizes and the same
work per round, in another order.  Within a round the order is
stratified: each table is cut into ``strata`` bands of sorted values, and
every run of ``strata`` requests takes one value from each band, so any
prefix of the sequence carries nearly the same work.  ``--seed`` draws the
orders and every token id.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, List

import numpy as np

SALT_ORDER, SALT_TOKENS, SALT_CHECK = 11, 13, 17


def rng(*key: int) -> np.random.Generator:
    """A numpy generator from a key of whole numbers of any size."""
    return np.random.Generator(np.random.PCG64(np.random.SeedSequence([int(k) for k in key])))


def torch_seed(*key: int) -> int:
    """A 63-bit seed for a ``torch.Generator`` from a key."""
    return int(np.random.SeedSequence([int(k) for k in key]).generate_state(2, np.uint32)
               .astype(np.uint64).view(np.uint64)[0] >> np.uint64(1))


def draw_table(spec: Dict[str, Any], n: int, gen: np.random.Generator) -> List[int]:
    """``n`` whole sizes from ``spec`` (lognormal with ``median`` and
    ``sigma``, clipped to ``min``..``max``), sorted."""
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown distribution {spec['dist']!r}")
    x = gen.lognormal(math.log(spec["median"]), spec["sigma"], n)
    return sorted(int(v) for v in np.clip(np.rint(x), spec["min"], spec["max"]))


def gap_table(rate: float, cv: float, n: int, gen: np.random.Generator) -> List[float]:
    """``n`` gaps between arrivals, gamma with the given coefficient of
    variation (1: Poisson arrivals), scaled to a mean of exactly 1/rate."""
    shape = 1.0 / (cv * cv)
    g = gen.gamma(shape, 1.0, n)
    return sorted(float(v) for v in g / g.mean() / rate)


def stratified(values: List, strata: int, gen: np.random.Generator) -> List:
    """``values`` (sorted, a multiple of ``strata`` long) in an order where
    each run of ``strata`` entries holds one value of each band."""
    m = len(values) // strata
    if m * strata != len(values):
        raise ValueError(f"a table of {len(values)} does not cut into {strata} bands")
    bands = [list(gen.permutation(values[i * m:(i + 1) * m])) for i in range(strata)]
    out: List = []
    for j in range(m):
        out += [bands[i][j] for i in gen.permutation(strata)]
    return out


@dataclass
class Spec:
    """One request of the sequence: its prompt and output lengths, and in an
    open loop its arrival offset (seconds from the start of traffic)."""
    idx: int
    plen: int
    new: int
    at: float = 0.0


class Tables:
    """A mix's fixed tables."""

    def __init__(self, mix: Dict[str, Any]):
        n = mix["round"]
        gen = rng(mix["table_seed"])
        self.prompt = draw_table(mix["prompt"], n, gen)
        self.output = draw_table(mix["output"], n, gen)
        self.gaps = (gap_table(mix["rate"], mix.get("cv", 1.0), n, gen)
                     if mix["loop"] == "open" else [0.0] * n)


def sequence(mix: Dict[str, Any], seed: int) -> List[Spec]:
    """The run's request sequence: ``rounds`` rounds of the mix's tables."""
    tables = Tables(mix)
    strata = mix["strata"]
    specs: List[Spec] = []
    t = 0.0
    for r in range(mix["rounds"]):
        gen = rng(seed, SALT_ORDER, r)
        plens = stratified(tables.prompt, strata, gen)
        news = stratified(tables.output, strata, gen)
        gaps = stratified(tables.gaps, strata, gen)
        for p, n, g in zip(plens, news, gaps):
            t += g
            specs.append(Spec(len(specs), int(p), int(n), t))
    return specs


def tokens(specs: List[Spec], vocab: int, seed: int, device):
    """Every prompt's token ids, drawn on ``device`` in one call, as (1, plen)
    views.  Ids 0 and 1 are left out, as the port's own traffic does."""
    import torch

    gen = torch.Generator(device=device)
    gen.manual_seed(torch_seed(seed, SALT_TOKENS))
    total = sum(s.plen for s in specs)
    flat = torch.randint(2, vocab, (total,), generator=gen, device=device)
    out, at = [], 0
    for s in specs:
        out.append(flat[at:at + s.plen].view(1, s.plen))
        at += s.plen
    return out
