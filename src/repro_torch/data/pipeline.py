"""Deterministic synthetic LM data pipeline.

Design goals (scaled-down versions of what a 1000-node fleet needs):
* **Determinism & resumability**: batch(step) is a pure function of
  (seed, step) — restoring a checkpoint at step k replays the exact
  stream with no data state beyond the step counter.
* **Shardability**: per-host slicing by (host_id, n_hosts) so each host
  materializes only its rows (single-host here, but the API is the
  multi-host one).
* **Document structure**: synthetic "documents" with EOS boundaries and
  a skewed unigram distribution — enough signal for a train-loss-drops
  integration test, and packing behaves like real data.

A copy of ``src/repro/data/pipeline.py``: the port imports nothing of ``repro``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Iterator

import numpy as np


@dataclass
class DataConfig:
    vocab: int
    seq_len: int
    global_batch: int
    seed: int = 0
    eos_id: int = 1
    mean_doc_len: int = 64
    host_id: int = 0
    n_hosts: int = 1


class SyntheticLM:
    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        assert cfg.global_batch % cfg.n_hosts == 0

    def _rng(self, step: int, row: int) -> np.random.Generator:
        return np.random.default_rng(
            np.random.SeedSequence([self.cfg.seed, step, row]))

    def _row(self, step: int, row: int) -> np.ndarray:
        cfg = self.cfg
        rng = self._rng(step, row)
        out = np.empty(cfg.seq_len + 1, np.int32)
        pos = 0
        while pos < cfg.seq_len + 1:
            dlen = int(rng.exponential(cfg.mean_doc_len)) + 8
            # skewed unigram over a per-doc "topic" slice of the vocab
            topic = int(rng.integers(0, max(cfg.vocab // 64, 1)))
            lo = 2 + topic * 61 % max(cfg.vocab - 64, 2)
            doc = (lo + rng.zipf(1.5, size=dlen) % 61).astype(np.int32)
            doc = np.clip(doc, 2, cfg.vocab - 1)
            doc[-1] = cfg.eos_id
            take = min(dlen, cfg.seq_len + 1 - pos)
            out[pos:pos + take] = doc[:take]
            pos += take
        return out

    def batch(self, step: int) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        per_host = cfg.global_batch // cfg.n_hosts
        rows = [self._row(step, cfg.host_id * per_host + r)
                for r in range(per_host)]
        arr = np.stack(rows)
        return {"tokens": arr[:, :-1], "labels": arr[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
