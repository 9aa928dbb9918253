"""The port's training runtime on the CPU: the counterparts of the
reference's ``tests/test_train.py`` cases (loss decreases, checkpoint
round trip with keep-N, preemption and restore), the fault monitor's
cases run against both packages' ``fault`` modules, the synthetic data
stream array-equal to the reference's, a restore that continues bit for
bit, and the launcher.
"""
from __future__ import annotations

import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.data import pipeline as JPIPE
from repro.train import fault as JFAULT
from repro_torch.configs.registry import get_arch
from repro_torch.data import pipeline as TPIPE
from repro_torch.launch import train as TLAUNCH
from repro_torch.model import transformer as T
from repro_torch.optim import adamw
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import checkpoint as CKPT
from repro_torch.train import fault as TFAULT
from repro_torch.train.loop import Trainer, TrainConfig
from repro_torch.tree import flatten

torch.set_num_threads(1)

FAULTS = pytest.mark.parametrize("FAULT", [JFAULT, TFAULT], ids=["repro", "repro_torch"])


def tiny_cfg(**kw):
    arch = get_arch("granite_3_2b").smoke()
    base = dict(arch=arch, total_steps=25, global_batch=4, seq_len=64,
                ckpt_every=10, log_every=100, device="cpu",
                opt=AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=25))
    return TrainConfig(**{**base, **kw})


def assert_trees_equal(a, b):
    fa, fb = flatten(a), flatten(b)
    assert list(fa) == list(fb)
    for k in fa:
        assert fa[k].dtype == fb[k].dtype, k
        assert torch.equal(fa[k].detach(), fb[k].detach()), k


def test_loss_decreases():
    tr = Trainer(tiny_cfg())
    tr.fit()
    losses = [h["loss"] for h in tr.history]
    assert losses[-1] < losses[0] - 0.05, losses


def test_checkpoint_roundtrip():
    cfg = tiny_cfg().arch
    with tempfile.TemporaryDirectory() as td:
        params = T.init_params(cfg, seed=0, device="cpu")
        opt = adamw.init(params)
        opt.step.fill_(3)
        for t in flatten(opt.m).values():
            t.normal_()
        CKPT.save(td, 7, params, opt)
        assert CKPT.latest_step(td) == 7
        meta = (Path(td) / "step_00000007" / "meta.json").read_text()
        assert '"embed": "bfloat16"' in meta
        p2, o2, meta = CKPT.restore(td, device="cpu")
        assert meta["step"] == 7
        assert_trees_equal(params, p2)
        assert_trees_equal({"step": opt.step, "m": opt.m, "v": opt.v},
                           {"step": o2.step, "m": o2.m, "v": o2.v})
        assert isinstance(p2["layers"], list) and isinstance(o2, adamw.AdamWState)
        # idempotent: a second save of step 7 leaves the first one
        before = (Path(td) / "step_00000007" / "params.npz").stat().st_mtime_ns
        CKPT.save(td, 7, T.init_params(cfg, seed=1, device="cpu"), opt)
        assert (Path(td) / "step_00000007" / "params.npz").stat().st_mtime_ns == before
        # keep-N garbage collection
        for s in (8, 9, 10, 11):
            CKPT.save(td, s, params, opt, keep=2)
        steps = sorted(int(p.name.split("_")[1]) for p in Path(td).iterdir())
        assert steps == [10, 11]


def test_restore_without_checkpoint_raises():
    with tempfile.TemporaryDirectory() as td:
        assert CKPT.latest_step(Path(td) / "none") is None
        with pytest.raises(FileNotFoundError):
            CKPT.restore(td, device="cpu")


def test_preemption_restore():
    with tempfile.TemporaryDirectory() as td:
        tr = Trainer(tiny_cfg(ckpt_dir=td, total_steps=22, ckpt_every=5))
        orig = tr.run_step
        fired = {}

        def flaky(step):
            if step == 12 and "f" not in fired:
                fired["f"] = True
                raise TFAULT.Preemption("simulated")
            return orig(step)

        tr.run_step = flaky
        out = tr.fit()
        assert out["restarts"] == 1
        assert out["final_step"] == 22
        assert CKPT.latest_step(td) == 22


def test_restore_continues_bit_identically():
    """Two steps, save, restore into a fresh trainer, third step: the same
    loss, gradient norm, parameters and optimizer state as three steps
    without the interruption."""
    whole = Trainer(tiny_cfg())
    for s in range(3):
        whole.run_step(s)
    with tempfile.TemporaryDirectory() as td:
        first = Trainer(tiny_cfg(ckpt_dir=td))
        for s in range(2):
            first.run_step(s)
        first.save(2)
        second = Trainer(tiny_cfg(ckpt_dir=td))
        with torch.no_grad():       # restore must replace every weight
            for t in flatten(second.params).values():
                t.zero_()
        assert second.restore() == 2
        assert all(t.requires_grad for t in flatten(second.params).values())
        m = second.run_step(2)
    assert m == whole.history[-1]
    assert_trees_equal(second.params, whole.params)
    assert_trees_equal(second.opt_state.m, whole.opt_state.m)
    assert_trees_equal(second.opt_state.v, whole.opt_state.v)
    assert int(second.opt_state.step) == int(whole.opt_state.step) == 3


@pytest.mark.parametrize("cfg", [
    dict(vocab=100, seq_len=32, global_batch=4, seed=7),
    dict(vocab=512, seq_len=64, global_batch=4, seed=0),
    dict(vocab=49155, seq_len=256, global_batch=2, seed=3, host_id=1, n_hosts=2),
])
def test_synthetic_batches_equal_reference(cfg):
    mine = TPIPE.SyntheticLM(TPIPE.DataConfig(**cfg))
    theirs = JPIPE.SyntheticLM(JPIPE.DataConfig(**cfg))
    for step in (0, 3, 11):
        a, b = mine.batch(step), theirs.batch(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])


def test_launcher_smoke_on_cpu(capsys):
    """The launcher's smoke run at test_loss_decreases' size.  Its default
    learning rate warms up over AdamWConfig's 100 steps, as the
    reference's does, so 25 steps at 3e-4 barely move the loss (in either
    package); at 3e-3 the warmup reaches 7.5e-4 and the loss falls."""
    out = TLAUNCH.main(["--arch", "granite_3_2b", "--smoke", "--device", "cpu",
                        "--steps", "25", "--batch", "4", "--seq", "64",
                        "--lr", "3e-3"])
    assert out["final_step"] == 25 and out["restarts"] == 0
    printed = capsys.readouterr().out
    first = float(printed.split("step=0 loss=")[1].split()[0])
    assert out["last_metrics"]["loss"] < first - 0.05, (first, out)
    assert "done:" in printed


def test_launcher_checkpoints(tmp_path):
    args = ["--smoke", "--device", "cpu", "--steps", "4", "--batch", "2",
            "--seq", "16", "--ckpt", str(tmp_path), "--ckpt-every", "2"]
    TLAUNCH.main(args)
    assert CKPT.latest_step(tmp_path) == 4
    # a rerun restores step 4 and has nothing left to do
    assert TLAUNCH.main(args)["final_step"] == 4


# -- the fault monitor, both packages ------------------------------------------

@FAULTS
def test_straggler_monitor(FAULT):
    mon = FAULT.StragglerMonitor(threshold=2.0)
    assert not mon.observe(0, 1.0)
    assert not mon.observe(1, 1.1)
    assert mon.observe(2, 5.0)
    assert mon.flagged == [2]


@FAULTS
def test_restart_storm_exhausts_budget(FAULT):
    calls = {"n": 0}

    def doomed(step):
        calls["n"] += 1
        raise FAULT.Preemption(f"storm {calls['n']}")

    policy = FAULT.FaultPolicy(max_restarts=3)
    with pytest.raises(RuntimeError, match="exceeded max_restarts=3") as ei:
        FAULT.run_resilient(doomed, 0, 10, restore_fn=lambda: 0,
                            save_fn=lambda s: None, policy=policy,
                            log_fn=lambda m: None)
    assert isinstance(ei.value.__cause__, FAULT.Preemption)
    assert calls["n"] == policy.max_restarts + 1


@FAULTS
def test_checkpoint_cadence_and_rewind(FAULT):
    saved, executed = [], []

    def step_fn(step):
        executed.append(step)
        if step == 7 and executed.count(7) == 1:
            raise FAULT.Preemption("simulated")
        return {"step": step}

    policy = FAULT.FaultPolicy(max_restarts=2, checkpoint_every=3)
    out = FAULT.run_resilient(step_fn, 0, 10,
                              restore_fn=lambda: saved[-1],
                              save_fn=saved.append, policy=policy,
                              log_fn=lambda m: None)
    assert saved == [3, 6, 9]
    assert executed == [0, 1, 2, 3, 4, 5, 6, 7, 6, 7, 8, 9]
    assert out["restarts"] == 1 and out["final_step"] == 10
    assert out["last_metrics"] == {"step": 9}


@FAULTS
def test_straggler_ewma_math(FAULT):
    mon = FAULT.StragglerMonitor(alpha=0.5, threshold=2.0)
    assert not mon.observe(0, 1.0)
    assert mon.ewma == 1.0
    assert not mon.observe(1, 2.0)
    assert mon.ewma == pytest.approx(1.5)
    assert mon.observe(2, 3.1)
    assert mon.ewma == pytest.approx(2.3)
    assert not mon.observe(3, 3.1)
    assert mon.flagged == [2]
