"""End-to-end training driver with the PyTorch port: ~100M-parameter dense
model, synthetic data, checkpoint/restart, straggler monitoring.

    PYTHONPATH=src python examples/train_100m_torch.py                  # full (~100M), on the card
    PYTHONPATH=src python examples/train_100m_torch.py --smoke --device cpu

The port's counterpart of ``examples/train_100m.py``.  The full run is
sized for the card; ``--smoke`` runs in about a minute on the CPU and
drives the same code path.  ``--simulate-preemption`` raises a simulated
node loss at step 12: the trainer restores the last checkpoint and goes
on.
"""
import argparse
import os
import sys
import tempfile

sys.path.insert(0, "src")

from repro_torch.configs.registry import get_arch  # noqa: E402
from repro_torch.optim.adamw import AdamWConfig  # noqa: E402
from repro_torch.train import fault as FAULT  # noqa: E402
from repro_torch.train.loop import Trainer, TrainConfig  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--ckpt", default=os.path.join(tempfile.gettempdir(),
                                                   "repro_torch_train_100m"))
    ap.add_argument("--simulate-preemption", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    base = get_arch("qwen3_0_6b")
    if args.smoke:
        arch = base.smoke()
        cfg = TrainConfig(arch=arch, total_steps=args.steps or 40,
                          global_batch=4, seq_len=64, ckpt_dir=args.ckpt,
                          ckpt_every=10, log_every=5, device=args.device,
                          opt=AdamWConfig(lr=1e-3, warmup_steps=10,
                                          total_steps=40))
    else:
        # ~100M: 12 layers × d512 × ff2048 + 152k vocab embeddings
        arch = base.scaled(n_layers=12, d_model=512, n_heads=8, n_kv_heads=4,
                           d_ff=2048, head_dim=64)
        cfg = TrainConfig(arch=arch, total_steps=args.steps or 300,
                          global_batch=8, seq_len=512, ckpt_dir=args.ckpt,
                          ckpt_every=50, log_every=10, device=args.device,
                          opt=AdamWConfig(lr=6e-4, warmup_steps=30,
                                          total_steps=300))

    trainer = Trainer(cfg)
    if args.simulate_preemption:
        orig = trainer.run_step

        def flaky(step):
            if step == 12 and not getattr(flaky, "fired", False):
                flaky.fired = True
                raise FAULT.Preemption("simulated node loss")
            return orig(step)

        trainer.run_step = flaky
    out = trainer.fit()
    losses = [h["loss"] for h in trainer.history]
    print(f"\nsteps={out['final_step']} restarts={out['restarts']} "
          f"stragglers={len(out['stragglers'])}")
    print(f"loss: first={losses[0]:.4f} last={losses[-1]:.4f} "
          f"(decreased: {losses[-1] < losses[0]})")
    trainer.close()
    return out, losses


if __name__ == "__main__":
    main()
