"""Training orchestrator: mesh, data, steps, checkpoints, fault hooks.

Ports ``src/repro/train/loop.py`` (``TrainConfig``, ``Trainer``), on the
card unless ``TrainConfig.device`` says otherwise.  With ``use_mesh``
the trainer builds the production mesh (``launch/mesh.py``; the process
group must already hold its 256 or 512 ranks), installs its logical
rules, FSDP handlers and MoE routing groups, and places parameters,
AdamW state and each batch as DTensors by ``param_pspecs`` and
``batch_pspec``; :meth:`Trainer.close` clears all of it.
``grad_compress`` is carried as in the reference, which never reads it.
As in the reference, the trainer leaves the kernel mode as it finds it
(off by default): no hand-written kernel has a backward, and the kernel
wrappers refuse inputs that require grad.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

import torch

from ..configs.registry import ArchConfig
from ..data.pipeline import DataConfig, SyntheticLM
from ..model import transformer as T
from ..model.layers import device_of
from ..model.sharding import (clear_logical_rules, clear_param_handlers,
                              set_logical_rules, set_moe_groups,
                              set_param_handlers, spec_to_placements)
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
    use_mesh: bool = False          # production mesh (dry-run topology)
    multi_pod: bool = False
    grad_compress: bool = False
    device: str = "cuda"


class Trainer:
    def __init__(self, cfg: TrainConfig):
        self.cfg = cfg
        self.arch = cfg.arch
        self.device = device_of(cfg.device)
        self.mesh = None
        if cfg.use_mesh:
            from ..launch import mesh as M
            self.mesh = M.make_production_mesh(multi_pod=cfg.multi_pod,
                                               device_type=self.device.type)
            rules = M.logical_rules(self.arch, self.mesh, batch=cfg.global_batch)
            set_logical_rules(self.mesh, rules)
            gf, gr = M.make_param_handlers(self.arch, self.mesh)
            set_param_handlers(gf, gr)
            set_moe_groups(M.axis_size(self.mesh, M.dp_axes(self.mesh)))
        self.data = SyntheticLM(DataConfig(
            vocab=self.arch.vocab, seq_len=cfg.seq_len,
            global_batch=cfg.global_batch, seed=cfg.seed))
        self.params = self._trainable(self._place(
            T.init_params(self.arch, seed=cfg.seed, device=self.device)))
        self.opt_state = adamw.init(self.params)
        self.step_fn = STEPS.make_train_step(self.arch, cfg.opt, cfg.n_micro)
        self.step = 0
        self.history: list = []

    def _place(self, params):
        """``params`` (or a tree of their structure) as DTensors placed by
        ``param_pspecs`` on the mesh; as they are without one."""
        if self.mesh is None:
            return params
        from ..launch import mesh as M
        return M.distribute(params, M.param_pspecs(params, self.arch, self.mesh),
                            self.mesh)

    def _batch(self, batch: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """The batch rows over the data-parallel axes (``batch_pspec``)."""
        if self.mesh is None:
            return batch
        from torch.distributed.tensor import distribute_tensor

        from ..launch import mesh as M
        rows = spec_to_placements(M.batch_pspec(self.mesh, self.cfg.global_batch),
                                  self.mesh.mesh_dim_names)
        return {k: distribute_tensor(v, self.mesh, rows) for k, v in batch.items()}

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
        params, opt_state, meta = CKPT.restore(self.cfg.ckpt_dir, device=self.device)
        self.opt_state = adamw.AdamWState(opt_state.step, self._place(opt_state.m),
                                          self._place(opt_state.v))
        self.params = self._trainable(self._place(params))
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
            self.params, self.opt_state, self._batch(batch))
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
        """Drop the parameters and optimizer state, and clear the mesh's
        rules, handlers and routing groups."""
        self.params = self.opt_state = None
        clear_logical_rules()
        clear_param_handlers()
