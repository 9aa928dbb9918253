"""A run with the timed path broken underneath comes out not correct.

Each case drives the rest of a run (set-up, ramp, window, the check and
its limit: the cell's own file in ``limits/``) on the CPU at a small size,
past the harness's look for a card, once sound and once for each fault a
serving cell can have: a token altered where it is produced, a step that
returns its state unchanged (the prefill chunk's cache and SSM state never
written), and half of the batch (the lower slots, which admission fills
first) left out of the decode tick."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import tiny  # noqa: E402
from harness import check, runner  # noqa: E402
from harness.cell import Cell, benchmark, load  # noqa: E402

# every serving cell with limits, at the small configuration of its kind
CELLS = {w["name"]: cell.config["reference"] for w in benchmark()["workloads"]
         for cell in [load(w["name"])]
         if cell.mix["kind"] == "serve" and (HERE / "limits" / f"{w['name']}.json").exists()}


def token_altered(T, monkeypatch):
    real = T.serve_decode_step

    def step(*a, **kw):
        logits, cache = real(*a, **kw)
        return logits.roll(1, -1), cache
    monkeypatch.setattr(T, "serve_decode_step", step)


def state_unchanged(T, monkeypatch):
    real = T.chunk_step

    def step(params, cfg, tokens, cache, offset, kv_len):
        scratch = [{k: (v.clone() if isinstance(v, torch.Tensor) and k != "slot" else v)
                    for k, v in lc.items()} for lc in cache]
        logits, _ = real(params, cfg, tokens, scratch, offset, kv_len)
        return logits, cache
    monkeypatch.setattr(T, "chunk_step", step)


def half_batch(T, monkeypatch):
    real = T.serve_decode_step

    def step(params, cfg, token, cache, lengths, active, kv_len):
        logits, cache = real(params, cfg, token, cache, lengths, active, kv_len)
        half = logits.shape[0] // 2
        return torch.cat([torch.zeros_like(logits[:half]), logits[half:]]), cache
    monkeypatch.setattr(T, "serve_decode_step", step)


FAULTS = {"sound": None, "token_altered": token_altered, "state_unchanged": state_unchanged,
          "half_batch": half_batch}


@pytest.mark.skipif(not CELLS, reason="no cell has limits yet")
@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", sorted(CELLS) or ["none"])
def test_fault_comes_out_not_correct(name, fault, monkeypatch):
    from repro_torch.model import transformer as T

    torch.set_num_threads(1)
    if FAULTS[fault] is not None:
        FAULTS[fault](T, monkeypatch)
    cell = Cell(name, tiny.config(CELLS[name]), tiny.mix(), 1, "tiny", "closed")
    res = runner.execute(cell, 2**33 + 41, 0.8, False, torch.device("cpu"),
                         time.perf_counter(), lambda m: None,
                         [{"name": "tok_s", "unit": "tokens/s"}], [])
    assert res["checks"]["logit_gap"]["limit"] == check.limits(name)["logit_gap"]["limit"]
    assert res["correct"] is (fault == "sound"), res["checks"]
