"""Training launcher of the port.

    PYTHONPATH=src python -m repro_torch.launch.train --arch granite_3_2b \
        --steps 100 --batch 8 --seq 256 [--ckpt DIR] [--smoke] [--device cpu]

Ports ``src/repro/launch/train.py`` with its flags, plus ``--device``
(the card by default; ``--device cpu`` runs on the CPU) and ``--seed``.
``--smoke`` reduces the arch.  The reference's ``--mesh`` and
``--multi-pod`` come with the distributed path.
"""
from __future__ import annotations

import argparse

from ..configs.registry import get_arch
from ..optim.adamw import AdamWConfig
from ..train.loop import Trainer, TrainConfig


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3_0_6b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--n-micro", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    arch = get_arch(args.arch)
    if args.smoke:
        arch = arch.smoke()
    cfg = TrainConfig(
        arch=arch, total_steps=args.steps, global_batch=args.batch,
        seq_len=args.seq, n_micro=args.n_micro, seed=args.seed,
        ckpt_dir=args.ckpt, ckpt_every=args.ckpt_every,
        opt=AdamWConfig(lr=args.lr, total_steps=args.steps),
        device=args.device,
    )
    trainer = Trainer(cfg)
    out = trainer.fit()
    print(f"done: {out}")
    trainer.close()
    return out


if __name__ == "__main__":
    main()
