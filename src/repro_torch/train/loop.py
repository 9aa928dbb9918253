"""Training orchestrator: data, steps, checkpoints, fault hooks.

Ports ``src/repro/train/loop.py`` (``TrainConfig``, ``Trainer``) on one
device, the card unless ``TrainConfig.device`` says otherwise.  The
production mesh (the reference's ``use_mesh``, ``multi_pod``) and its
``grad_compress`` field come with the distributed path.  As in the
reference, the trainer leaves the kernel mode as it finds it (off by
default): no hand-written kernel has a backward, and the kernel wrappers
refuse inputs that require grad.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..configs.registry import ArchConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..model import transformer as T
from ..model.layers import device_of
from ..optim import adamw
from ..tree import leaves
from . import checkpoint as CKPT
from . import fault as FAULT
from . import steps as STEPS


@dataclass
class TrainConfig:
    arch: ArchConfig
    total_steps: int = 100
    global_batch: int = 8
    seq_len: int = 128
    n_micro: int = 1
    seed: int = 0
    ckpt_dir: Optional[str] = None
    ckpt_every: int = 50
    log_every: int = 10
    opt: adamw.AdamWConfig = field(default_factory=adamw.AdamWConfig)
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.arch = cfg.arch
        self.device = device_of(cfg.device)
        self.data = SyntheticLM(DataConfig(
            vocab=self.arch.vocab, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed))
        self.params = self._trainable(
            T.init_params(self.arch, seed=cfg.seed, device=self.device))
        self.opt_state = adamw.init(self.params)
        self.step_fn = STEPS.make_train_step(self.arch, cfg.opt, cfg.n_micro)
        self.step = 0
        self.history: list = []

    @staticmethod
    def _trainable(params):
        for p in leaves(params):
            p.requires_grad_(True)
        return params

    # -- checkpointing ----------------------------------------------------
    def save(self, step: int):
        if self.cfg.ckpt_dir:
            CKPT.save(self.cfg.ckpt_dir, step, self.params, self.opt_state,
                      extra={"arch": self.arch.name})

    def restore(self) -> int:
        if not self.cfg.ckpt_dir:
            return 0
        latest = CKPT.latest_step(self.cfg.ckpt_dir)
        if latest is None:
            return 0
        self.params = self.opt_state = None       # free the old state first
        params, self.opt_state, meta = CKPT.restore(self.cfg.ckpt_dir,
                                                    device=self.device)
        self.params = self._trainable(params)
        self.step = meta["step"]
        return self.step

    # -- main loop ----------------------------------------------------------
    def run_step(self, step: int) -> Dict[str, float]:
        batch = {k: torch.from_numpy(v).to(self.device, torch.long)
                 for k, v in self.data.batch(step).items()}
        # a vlm's vision stub and an encoder's stub frames: zeros, bf16, as
        # in the reference
        stub = (self.cfg.global_batch, self.arch.frontend_len, self.arch.d_model)
        if self.arch.family == "vlm":
            batch["frontend"] = torch.zeros(stub, dtype=torch.bfloat16, device=self.device)
        if self.arch.enc_layers:
            batch["enc_frontend"] = torch.zeros(stub, dtype=torch.bfloat16,
                                                device=self.device)
        self.params, self.opt_state, metrics = self.step_fn(
            self.params, self.opt_state, batch)
        # one device read per step, as the reference's float() of each metric
        m = dict(zip(metrics, torch.stack(list(metrics.values())).tolist()))
        self.history.append(m)
        if step % self.cfg.log_every == 0:
            print(f"[train] step={step} loss={m['loss']:.4f} "
                  f"lr={m['lr']:.2e} gnorm={m['grad_norm']:.3f}", flush=True)
        return m

    def fit(self) -> Dict:
        start = self.restore()
        policy = FAULT.FaultPolicy(checkpoint_every=self.cfg.ckpt_every)
        out = FAULT.run_resilient(
            self.run_step, start, self.cfg.total_steps,
            restore_fn=self.restore, save_fn=self.save, policy=policy)
        if self.cfg.ckpt_dir:
            self.save(self.cfg.total_steps)
        return out

    def close(self):
        """Drop the parameters and optimizer state.  The reference clears
        its mesh rules here; one device has none."""
        self.params = self.opt_state = None
