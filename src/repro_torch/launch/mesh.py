"""Mesh construction + sharding policy for the production topology.

Ports ``src/repro/launch/mesh.py`` on ``torch.distributed``'s DeviceMesh:

Single pod:  (data=16, model=16)          — 256 devices
Multi pod:   (pod=2, data=16, model=16)   — 512 devices

DP runs over ('pod','data'); TP/EP/vocab over 'model'.  Parameters of
large archs additionally shard over 'data' (FSDP/ZeRO-3); optimizer
states inherit parameter specs (ZeRO-1 falls out for free).

The policy is written as the reference's PartitionSpecs
(:class:`repro_torch.model.sharding.P`), so the two compare entry for
entry; :func:`shardings_for` turns them into DTensor placements and
:func:`distribute` places real tensors.  The reference stacks each
pattern slot's layers under ``slots`` with a leading layer axis, which
its specs leave unsharded; the port keeps one tree per layer
(``params["layers"][l]``, ``cache[l]``), so a layer's spec here is the
reference's stacked spec without its leading None.

Everything here is a function of the mesh: importing this module starts
no process group.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from ..configs.registry import ArchConfig
from ..model.sharding import P, spec_to_placements
from ..tree import map_with_path


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The production DeviceMesh over the default process group, which
    must already hold exactly its 256 (512 with ``multi_pod``) ranks: the
    dry run's is a fake one (``launch/dryrun.py``)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"the production mesh {shape} needs a process group of "
                           f"{n} ranks: call torch.distributed.init_process_group first")
    if dist.get_world_size() != n:
        raise RuntimeError(f"the production mesh {shape} needs {n} ranks, the process "
                           f"group has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=axes)


def mesh_shape(mesh) -> Dict[str, int]:
    """Axis name -> size, as the reference's ``mesh.shape``."""
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


def axis_size(mesh, name) -> int:
    if name is None:
        return 1
    shape = mesh_shape(mesh)
    if isinstance(name, (tuple, list)):
        out = 1
        for n in name:
            out *= shape[n]
        return out
    return shape[name]


def logical_rules(cfg: ArchConfig, mesh, *, batch: int, seq_shard: bool = False
                  ) -> Dict[str, Any]:
    """Logical activation axis -> mesh axes for this arch."""
    shape = mesh_shape(mesh)
    model_n = shape["model"]
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    rules: Dict[str, Any] = {
        "batch": dp if batch % dp_n == 0 else
                 ("data" if batch % shape["data"] == 0 else None),
        "seq": "model" if seq_shard else None,
        "heads": "model" if cfg.n_heads % model_n == 0 else None,
        "kv_heads": "model" if cfg.n_kv_heads % model_n == 0 else None,
        "ffn": "model" if (cfg.d_ff and cfg.d_ff % model_n == 0)
               or (cfg.family in ("ssm", "hybrid") and cfg.d_inner % model_n == 0)
               else None,
        "experts": "model" if cfg.n_experts and cfg.n_experts % model_n == 0 else None,
        "vocab": "model" if cfg.vocab % model_n == 0 else None,
    }
    return rules


# ---------------------------------------------------------------------------
# parameter shardings (by tree path name conventions)
# ---------------------------------------------------------------------------

def _param_spec(path: str, leaf, cfg: ArchConfig, mesh) -> P:
    model_n = mesh_shape(mesh)["model"]
    # FSDP shards over the full DP domain (pod×data in multi-pod): more
    # shards and the batch sharding's device order
    data_ax = dp_axes(mesh) if cfg.fsdp else None
    heads_ok = cfg.n_heads % model_n == 0
    ff_ok = cfg.d_ff % model_n == 0 if cfg.d_ff else False
    di_ok = cfg.d_inner % model_n == 0
    exp_ok = cfg.n_experts % model_n == 0 if cfg.n_experts else False
    vocab_ok = cfg.vocab % model_n == 0

    def maybe(ax_ok, ax="model"):
        return ax if ax_ok else None

    name = path.split("/")[-1]
    ndim = leaf.ndim
    spec: Tuple = (None,) * ndim
    if name in ("embed", "lm_head"):
        spec = (maybe(vocab_ok), data_ax)
    elif name == "frontend_proj":
        spec = (data_ax, None)
    elif name == "wq":
        spec = (data_ax, maybe(heads_ok))
    elif name in ("wk", "wv"):
        kv_ok = cfg.n_kv_heads % model_n == 0
        spec = (data_ax, maybe(kv_ok))
    elif name == "wo":
        spec = (maybe(heads_ok), data_ax)
    elif name in ("w_gate", "w_up"):
        if "ffn" in path and cfg.n_experts and ndim == 3:   # MoE experts
            spec = (maybe(exp_ok), data_ax, None)
        else:
            spec = (data_ax, maybe(ff_ok))
    elif name == "w_down":
        if "ffn" in path and cfg.n_experts and ndim == 3:
            spec = (maybe(exp_ok), None, data_ax)
        else:
            spec = (maybe(ff_ok), data_ax)
    elif name == "router":
        spec = (None, maybe(exp_ok))
    elif name == "in_proj":
        spec = (data_ax, maybe(di_ok))
    elif name == "out_proj":
        spec = (maybe(di_ok), data_ax)
    elif name == "x_proj":
        spec = (maybe(di_ok), None)
    elif name == "dt_proj":
        spec = (None, maybe(di_ok))
    elif name in ("conv_w",):
        spec = (None, maybe(di_ok))
    elif name in ("a_log", "d_skip", "conv_b", "dt_bias"):
        spec = (maybe(di_ok),) + (None,) * (ndim - 1)
    else:   # norms & misc: replicated
        spec = (None,) * ndim
    spec = spec[:ndim] + (None,) * (ndim - len(spec))
    return P(*spec)


def param_pspecs(params, cfg: ArchConfig, mesh):
    """Tree of :class:`P` matching the port's ``params`` (or its AdamW m,
    v): the reference's per-leaf policy, each layer as one slice of the
    reference's stack."""
    return map_with_path(lambda path, leaf: _param_spec(path, leaf, cfg, mesh), params)


def map_specs(fn, specs, *rest):
    """``fn`` over a tree of specs (leaves :class:`P`) and trees of its
    structure."""
    if isinstance(specs, P):
        return fn(specs, *rest)
    if isinstance(specs, dict):
        return {k: map_specs(fn, v, *(r[k] for r in rest)) for k, v in specs.items()}
    return [map_specs(fn, *vs) for vs in zip(specs, *rest)]


def shardings_for(tree_specs, mesh):
    """DTensor placements (a list per leaf) of a tree of specs."""
    return map_specs(lambda s: spec_to_placements(s, mesh.mesh_dim_names), tree_specs)


def distribute(tree, tree_specs, mesh):
    """Real tensors of ``tree`` as DTensors placed by ``tree_specs``
    (``distribute_tensor``; a leaf that requires grad gives a DTensor leaf
    that does)."""
    from torch.distributed.tensor import distribute_tensor
    return map_specs(lambda s, t: distribute_tensor(
        t, mesh, spec_to_placements(s, mesh.mesh_dim_names)), tree_specs, tree)


def make_param_handlers(cfg: ArchConfig, mesh):
    """(gather_fn, grad_fn) for FSDP: see model.sharding.set_param_handlers.

    gather_fn redistributes one layer's parameter tree to TP-only
    placements (data axis dropped) — the path names match, since a
    layer's tree holds the same names below the layer.  grad_fn pins a
    gradient tree of the parameters' structure to the FSDP placements."""
    if not cfg.fsdp:
        return None, None
    tp_cfg = cfg.scaled(fsdp=False)
    names = mesh.mesh_dim_names

    def gather_fn(tree):
        return map_with_path(
            lambda path, leaf: leaf.redistribute(
                mesh, spec_to_placements(_param_spec(path, leaf, tp_cfg, mesh), names)),
            tree)

    def grad_fn(tree):
        return map_specs(lambda s, leaf: leaf.redistribute(
            mesh, spec_to_placements(s, names)), param_pspecs(tree, cfg, mesh), tree)

    return gather_fn, grad_fn


# ---------------------------------------------------------------------------
# cache shardings (decode)
# ---------------------------------------------------------------------------

def cache_pspecs(cache, cfg: ArchConfig, mesh, batch: int):
    """KV caches: batch over DP when divisible; otherwise shard the
    sequence axis over 'model' (long-context decode, flash-decoding
    style distributed softmax). Mamba states: d_inner over 'model'."""
    dp = dp_axes(mesh)
    dp_n = axis_size(mesh, dp)
    model_n = mesh_shape(mesh)["model"]
    batch_ax = dp if batch % dp_n == 0 else None
    kv_ok = cfg.n_kv_heads % model_n == 0
    di_ok = cfg.d_inner % model_n == 0

    def spec_for(path, leaf):
        name = path.split("/")[-1]
        nd = leaf.ndim
        if name in ("k", "v"):
            # (b, S, hkv, hd): prefer head sharding; else shard S on model
            if kv_ok:
                spec = (batch_ax, None, "model", None)
            else:
                spec = (batch_ax, "model", None, None)
        elif name == "conv":
            spec = (batch_ax, None, "model" if di_ok else None)
        elif name == "ssm":
            spec = (batch_ax, "model" if di_ok else None, None)
        else:
            spec = (None,) * nd
        spec = tuple(spec)[:nd] + (None,) * (nd - len(spec))
        return P(*spec)

    return map_with_path(spec_for, cache)


def batch_pspec(mesh, batch: int) -> P:
    dp = dp_axes(mesh)
    if batch % axis_size(mesh, dp) == 0:
        return P(dp)
    if batch % mesh_shape(mesh)["data"] == 0:
        return P("data")
    return P(None)
