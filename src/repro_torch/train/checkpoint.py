"""Fault-tolerant checkpointing: atomic, versioned, placed on restore.

Ports ``src/repro/train/checkpoint.py`` with its guarantees:

* **Atomic**: written to ``step_K.tmp/`` then ``os.replace``d into
  ``step_K/``: a crash mid-save never corrupts the latest checkpoint.
* **Keep-N**: older checkpoints are removed after a successful save.
* **Idempotent**: saving a step that is already checkpointed does
  nothing.
* **Host arrays**: leaves are numpy arrays in ``params.npz`` and
  ``opt.npz``, keyed by their tree path (:func:`repro_torch.tree.flatten`);
  bf16 leaves are stored as their ``uint16`` bits, with every leaf's
  dtype in ``meta.json``.  :func:`restore` puts every leaf on the device
  it is given.

The reference also pickles JAX's tree definitions; here the structure is
rebuilt from the leaf keys, so no pickle is read.
"""
from __future__ import annotations

import json
import os
import shutil
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..model.layers import device_of
from ..model.sharding import full
from ..optim.adamw import AdamWState
from ..tree import flatten, unflatten


def _to_host(tree) -> Tuple[Dict[str, np.ndarray], Dict[str, str]]:
    flat, dtypes = {}, {}
    for key, t in flatten(tree).items():
        t = full(t).detach().cpu()        # a DTensor's global value
        dtypes[key] = str(t.dtype).removeprefix("torch.")
        if t.dtype == torch.bfloat16:      # numpy has no bf16: keep the bits
            flat[key] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            flat[key] = t.numpy()
    return flat, dtypes


def _from_host(npz, dtypes: Dict[str, str], device: torch.device):
    flat = {}
    for key in npz.files:
        arr = npz[key]
        if dtypes[key] == "bfloat16":
            t = torch.from_numpy(arr.view(np.int16)).view(torch.bfloat16)
        else:
            t = torch.from_numpy(arr)
        flat[key] = t.to(device)
    return unflatten(flat)


def save(ckpt_dir, step: int, params, opt_state: AdamWState,
         extra: Optional[Dict] = None, keep: int = 3) -> Path:
    ckpt_dir = Path(ckpt_dir)
    ckpt_dir.mkdir(parents=True, exist_ok=True)
    final = ckpt_dir / f"step_{step:08d}"
    if final.exists():
        return final          # idempotent: step already checkpointed
    tmp = ckpt_dir / f"step_{step:08d}.tmp"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    p_flat, p_dt = _to_host(params)
    o_flat, o_dt = _to_host(opt_state._asdict())
    np.savez(tmp / "params.npz", **p_flat)
    np.savez(tmp / "opt.npz", **o_flat)
    meta = {"step": step, "time": time.time(),
            "dtypes": {"params": p_dt, "opt": o_dt}, **(extra or {})}
    (tmp / "meta.json").write_text(json.dumps(meta))
    os.replace(tmp, final)
    ckpts = sorted(p for p in ckpt_dir.iterdir()
                   if p.name.startswith("step_") and not p.name.endswith(".tmp"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old, ignore_errors=True)
    return final


def latest_step(ckpt_dir) -> Optional[int]:
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return None
    steps = [int(p.name.split("_")[1]) for p in ckpt_dir.iterdir()
             if p.name.startswith("step_") and not p.name.endswith(".tmp")]
    return max(steps) if steps else None


def restore(ckpt_dir, step: Optional[int] = None, device="cuda"
            ) -> Tuple[Any, AdamWState, Dict]:
    """Load checkpoint ``step`` (the latest when None) with every leaf on
    ``device``.  Returns (params, opt_state, meta)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    dev = device_of(device)
    meta = json.loads((d / "meta.json").read_text())
    with np.load(d / "params.npz") as p_npz, np.load(d / "opt.npz") as o_npz:
        params = _from_host(p_npz, meta["dtypes"]["params"], dev)
        opt = _from_host(o_npz, meta["dtypes"]["opt"], dev)
    return params, AdamWState(opt["step"], opt["m"], opt["v"]), meta
