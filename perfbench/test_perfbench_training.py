"""The training cell's driver and reference on the CPU at a small size: in
float32 the port's steps and the reference's agree to rounding; a
sound run passes the cell's limits (in float32: bf16 rounding at this size
is not the full-size cell's), and a run with the step broken underneath
(its state left unchanged, half of the batch left out) does not."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import tiny  # noqa: E402
from harness import check, runner, training  # noqa: E402
from harness.cell import Cell  # noqa: E402

CELL = "granite_3_2b.train"
HAS_LIMITS = (HERE / "limits" / f"{CELL}.json").exists()


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_reference_follows_the_port_in_f32():
    cell = Cell("tiny.train", tiny.config("dense_gqa", "float32"), tiny.train_mix(), 1,
                "tiny", "train")
    rec = training.run(cell, 5, 0.2, False, torch.device("cpu"), time.perf_counter(),
                       lambda m: None)
    ref = training.reference_run(rec, 5, torch.device("cpu"), 3)
    got = training.readings(rec, ref)
    assert got["loss_gap"] < 1e-5 and got["grad_gap"] < 1e-4 and got["change_gap"] < 1e-4
    ctl = training.reference_run(rec, 5, torch.device("cpu"), 3, "fp8")
    assert training.readings(ctl, ref)["grad_gap"] > 10 * got["grad_gap"]


def test_leaf_gap_rule():
    # the median leaf's reference gradient is 1: a leaf of 0.0005 (under 1/1000
    # of it) is left out of both gaps, however far the program's is; a small
    # leaf's gap is taken against the median (0.2 / 1, not 0.2 / 0.3)
    ref = {"losses": [2.0], "grad_norms": [1.0, 2.0, 5.0, 0.3, 0.0005],
           "change_norms": [1.0, 1.0, 1.0, 1.0, 1.0]}
    rec = {"losses": [2.0], "grad_norms": [1.1, 2.0, 5.0, 0.5, 1.0],
           "change_norms": [1.0, 1.0, 1.0, 1.05, 3.0]}
    got = training.readings(rec, ref)
    assert got["grad_gap"] == pytest.approx(0.2) and got["left_out"] == 1
    assert got["change_gap"] == pytest.approx(0.05) and got["loss_gap"] == 0


def state_unchanged(monkeypatch):
    from repro_torch.optim import adamw
    real = adamw.update

    def frozen(cfg, grads, state, params):
        keep = [p.detach().clone() for p in adamw.leaves(params)]
        out = real(cfg, grads, state, params)
        with torch.no_grad():
            for p, k in zip(adamw.leaves(params), keep):
                p.copy_(k)
        return out
    monkeypatch.setattr(adamw, "update", frozen)


def half_batch(monkeypatch):
    from repro_torch.model import transformer as T
    real = T.lm_loss

    def half(params, cfg, tokens, labels, *a, **kw):
        h = max(tokens.shape[0] // 2, 1)
        return real(params, cfg, tokens[:h], labels[:h], *a, **kw)
    monkeypatch.setattr(T, "lm_loss", half)


FAULTS = {"sound": None, "state_unchanged": state_unchanged, "half_batch": half_batch}


@pytest.mark.skipif(not HAS_LIMITS, reason="the training cell has no limits")
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_comes_out_not_correct(fault, monkeypatch):
    if FAULTS[fault] is not None:
        FAULTS[fault](monkeypatch)
    # f32 weights: at this size bf16 rounding alone is not the full-size cell's, so the
    # sound run is held to the cell's limits in f32 and the faults must fail them
    mix = dict(tiny.train_mix(), batch=4)
    cell = Cell(CELL, tiny.config("dense_gqa", "float32"), mix, 1, "tiny", "train")
    res = runner.execute(cell, 2**33 + 3, 0.2, False, torch.device("cpu"), time.perf_counter(),
                         lambda m: None, [{"name": "train_tok_s", "unit": "tokens/s"}], [])
    assert set(res["checks"]) == set(check.limits(CELL))
    assert res["correct"] is (fault == "sound"), res["checks"]
