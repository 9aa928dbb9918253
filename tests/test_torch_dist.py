"""The port's sharded path on a real process group: four ``gloo``
processes on the CPU, one 2×2 DeviceMesh ("data", "model").

Each case runs in a subprocess that spawns the four ranks (so this
process never starts a group).  Every rank builds the same weights and
batches from seeds; rank 0 reports.  Against the port's unsharded run
on the same inputs, in f32:

* granite, qwen3-moe and falcon-mamba at smoke (FSDP on, so the
  per-layer gather and the gradient pinning run too; MoE in 2 routing
  groups in both runs), and granite with one KV head (q's heads split
  over "model", k and v whole: each rank reads its group's KV head):
  the forward's logits, and one train step of two micro-batches: loss,
  gradient norm and every updated parameter, within 1e-5;
* ``Trainer(use_mesh=True)`` with ``make_production_mesh`` patched to
  return the 2×2 mesh: three steps' losses and gradient norms within
  1e-5 of the unsharded trainer's, and ``close()`` clears the rules;
* the FSDP handlers' placements: ``gather_fn`` leaves a layer's
  parameters sharded over "model" only, ``grad_fn`` pins gradients to
  the parameters' placements.

A one-card run cannot show any of this: the collectives need ranks.
"""
from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
TOL = 1e-5

WORKER = r"""
import json, sys, traceback
import torch, torch.distributed as dist, torch.multiprocessing as mp


def setup(rank, port):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=4)
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh("cpu", (2, 2), mesh_dim_names=("data", "model"))


def step_case(rank, mesh, arch, out):
    from torch.distributed.tensor import DTensor, Shard, distribute_tensor
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as M
    from repro_torch.model import sharding as S
    from repro_torch.model import transformer as T
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    from repro_torch.tree import flatten, leaves

    arch, _, kv = arch.partition("/kv")
    cfg = get_arch(arch).smoke().scaled(dtype="float32", fsdp=True)
    if kv:          # fewer KV heads than the "model" axis has ranks
        cfg = cfg.scaled(n_kv_heads=int(kv))
    b, s = 4, 16
    gen = torch.Generator().manual_seed(1)
    tok = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    lab = torch.randint(0, cfg.vocab, (b, s), generator=gen)
    opt = adamw.AdamWConfig(lr=1e-4, warmup_steps=1)
    S.set_moe_groups(2)

    def run(params, batch):
        for t in leaves(params):
            t.requires_grad_(True)
        with torch.no_grad(), S.sharded():
            logits, _ = T.forward(params, cfg, batch["tokens"])
        _, _, m = make_train_step(cfg, opt, 2)(params, adamw.init(params), batch)
        return S.full(logits), m, params

    want, m0, p0 = run(T.init_params(cfg, seed=0, device="cpu"),
                       {"tokens": tok, "labels": lab})
    S.set_logical_rules(mesh, M.logical_rules(cfg, mesh, batch=b))
    gather_fn, grad_fn = M.make_param_handlers(cfg, mesh)
    S.set_param_handlers(gather_fn, grad_fn)
    S.set_moe_groups(2)
    p1 = T.init_params(cfg, seed=0, device="cpu")
    specs = M.param_pspecs(p1, cfg, mesh)
    p1 = M.distribute(p1, specs, mesh)
    rows = S.spec_to_placements(M.batch_pspec(mesh, b), mesh.mesh_dim_names)
    batch = {k: distribute_tensor(v, mesh, rows) for k, v in (("tokens", tok), ("labels", lab))}
    got, m1, p1 = run(p1, batch)

    # the handlers: a layer gathered over "data", gradients pinned back
    layer = p1["layers"][0]
    gathered = flatten(gather_fn(layer))
    data_dim = mesh.mesh_dim_names.index("data")
    handlers = {
        "gather_keeps_model_only": all(
            not isinstance(t.placements[data_dim], Shard) for t in gathered.values()),
        "gather_model_placements": all(
            g.placements[1 - data_dim] == t.placements[1 - data_dim]
            for g, t in zip(gathered.values(), flatten(layer).values())),
        "some_param_fsdp_sharded": any(
            isinstance(t.placements[data_dim], Shard) for t in leaves(p1)),
    }
    grads = grad_fn(M.map_specs(lambda s_, t: t.detach().redistribute(
        mesh, [torch.distributed.tensor.Replicate()] * 2), specs, p1))
    handlers["grad_pins_param_placements"] = all(
        g.placements == t.placements for g, t in zip(leaves(grads), leaves(p1)))
    perr = max((S.full(a.detach()) - c.detach()).abs().max().item()
               for a, c in zip(leaves(p1), leaves(p0)))
    if rank == 0:
        json.dump({"logits": (got - want).abs().max().item(),
                   "loss": [m0["loss"].item(), m1["loss"].item()],
                   "grad_norm": [m0["grad_norm"].item(), m1["grad_norm"].item()],
                   "params": perr, "handlers": handlers,
                   "dtensor": isinstance(p1["embed"], DTensor)}, open(out, "w"))


def trainer_case(rank, mesh, arch, out):
    from repro_torch.configs.registry import get_arch
    from repro_torch.launch import mesh as M
    from repro_torch.model import sharding as S
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.train.loop import Trainer, TrainConfig

    cfg = get_arch(arch).smoke().scaled(dtype="float32", fsdp=True)

    def history(use_mesh):
        tr = Trainer(TrainConfig(arch=cfg, total_steps=3, global_batch=4, seq_len=16,
                                 log_every=100, device="cpu", use_mesh=use_mesh,
                                 opt=AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=3)))
        on_mesh = S.current_mesh() is mesh
        for step in range(3):
            tr.run_step(step)
        tr.close()
        return tr.history, on_mesh

    want, _ = history(False)
    M.make_production_mesh = lambda **kw: mesh
    got, on_mesh = history(True)
    if rank == 0:
        json.dump({"want": want, "got": got, "on_mesh": on_mesh,
                   "cleared": S.current_mesh() is None}, open(out, "w"))


def worker(rank, port, case, arch, out):
    try:
        mesh = setup(rank, port)
        {"step": step_case, "trainer": trainer_case}[case](rank, mesh, arch, out)
        dist.destroy_process_group()
    except Exception:
        traceback.print_exc()
        raise


if __name__ == "__main__":
    port, case, arch, out = int(sys.argv[1]), sys.argv[2], sys.argv[3], sys.argv[4]
    mp.spawn(worker, args=(port, case, arch, out), nprocs=4)
"""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(tmp_path, case: str, arch: str) -> dict:
    script, out = tmp_path / "worker.py", tmp_path / "out.json"
    script.write_text(WORKER)
    proc = subprocess.run([sys.executable, str(script), str(free_port()), case, arch,
                           str(out)], env=dict(os.environ, PYTHONPATH=SRC),
                          capture_output=True, text=True, timeout=420)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(out.read_text())


@pytest.mark.parametrize("arch", ["granite_3_2b", "granite_3_2b/kv1", "qwen3_moe_30b_a3b",
                                  "falcon_mamba_7b"])
def test_sharded_forward_and_train_step_match_unsharded(tmp_path, arch):
    got = run_ranks(tmp_path, "step", arch)
    assert got["dtensor"]
    assert got["logits"] <= TOL
    (l0, l1), (g0, g1) = got["loss"], got["grad_norm"]
    assert abs(l1 - l0) <= TOL and abs(g1 - g0) <= TOL
    assert got["params"] <= TOL
    assert got["handlers"] == {"gather_keeps_model_only": True,
                               "gather_model_placements": True,
                               "some_param_fsdp_sharded": True,
                               "grad_pins_param_placements": True}


def test_trainer_on_the_mesh_matches_unsharded(tmp_path):
    got = run_ranks(tmp_path, "trainer", "granite_3_2b")
    assert got["on_mesh"] and got["cleared"]
    assert len(got["got"]) == len(got["want"]) == 3
    for m1, m0 in zip(got["got"], got["want"]):
        assert abs(m1["loss"] - m0["loss"]) <= TOL
        assert abs(m1["grad_norm"] - m0["grad_norm"]) <= TOL
        assert m1["lr"] == m0["lr"]
