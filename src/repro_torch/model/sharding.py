"""Logical-axis activation sharding on DeviceMesh and DTensor.

Ports ``src/repro/model/sharding.py``.  Models annotate activations with
*logical* axis names; the launcher installs a mapping from them to mesh
axes (``launch/mesh.py``'s ``logical_rules``).  Outside a mesh, or on a
tensor that is not a DTensor (every single-device run), the annotations
are the identity.

A sharding is written as the reference writes it, a PartitionSpec: one
entry per tensor dim, each a mesh axis name, a tuple of names (the dim
split over those mesh axes, the first outermost) or None.  :class:`P`
is that tuple, so the port's specs compare directly with the
reference's.  DTensor describes the same sharding the other way round,
one placement per mesh dim (``Shard(d)`` or ``Replicate()``):
:func:`spec_to_placements` and :func:`placements_to_spec` convert.
Where the reference's ``with_sharding_constraint`` lets XLA move the
data, :func:`shard_activation` calls ``redistribute``.

The MoE routing groups (:func:`set_moe_groups`) and the FSDP handlers
(:func:`set_param_handlers`) are thread-local state, as in the
reference.
"""
from __future__ import annotations

import contextlib
import threading
from typing import Dict, List, Optional, Sequence, Tuple

_state = threading.local()


class P(tuple):
    """A PartitionSpec: ``P("data", None)``, ``P(("pod", "data"), "model")``.
    A one-name tuple entry is stored as the name, as JAX's is."""

    def __new__(cls, *axes):
        return super().__new__(cls, (
            a[0] if isinstance(a, (tuple, list)) and len(a) == 1
            else tuple(a) if isinstance(a, list) else a for a in axes))

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def _names(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, (tuple, list)) else (entry,)


def spec_to_placements(spec: Sequence, mesh_dim_names: Sequence[str]) -> list:
    """DTensor placements (one per mesh dim) of a PartitionSpec.  A tensor
    dim over several mesh axes must name them in the mesh's order, the
    order in which DTensor nests the shards of one dim."""
    from torch.distributed.tensor import Replicate, Shard

    names = list(mesh_dim_names)
    placements: List = [Replicate()] * len(names)
    for dim, entry in enumerate(spec):
        axes = [names.index(a) for a in _names(entry)]
        if axes != sorted(axes):
            raise ValueError(f"spec {spec}: dim {dim} names mesh axes out of the "
                             f"mesh's order {tuple(names)}")
        for m in axes:
            placements[m] = Shard(dim)
    return placements


def placements_to_spec(placements: Sequence, mesh_dim_names: Sequence[str],
                       ndim: int) -> P:
    """The PartitionSpec of DTensor ``placements`` over a tensor of
    ``ndim`` dims: one mesh axis as its name, several as a tuple, none as
    None.  A partial placement has no spec and raises."""
    from torch.distributed.tensor import Replicate, Shard

    spec: List[List[str]] = [[] for _ in range(ndim)]
    for name, pl in zip(mesh_dim_names, placements):
        if isinstance(pl, Shard):
            spec[pl.dim % ndim].append(name)
        elif not isinstance(pl, Replicate):
            raise ValueError(f"placement {pl} on mesh axis {name!r} has no PartitionSpec")
    return P(*(None if not s else s[0] if len(s) == 1 else tuple(s) for s in spec))


def set_logical_rules(mesh, rules: Dict[str, Optional[object]]):
    """rules: logical name -> mesh axis (str | tuple | None)."""
    _state.mesh = mesh
    _state.rules = dict(rules)


def clear_logical_rules():
    _state.mesh = None
    _state.rules = None


def current_mesh():
    """The mesh the launcher installed, or None."""
    return getattr(_state, "mesh", None)


def sharded():
    """The context the model's steps run in: on a mesh, DTensor's implicit
    replication, so the plain tensors the model builds beside its
    DTensors (positions, masks, rope angles, counters) act as replicated;
    a null context otherwise."""
    if current_mesh() is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


def full(x):
    """A DTensor's global value as a plain tensor; any other x as it is."""
    from torch.distributed.tensor import DTensor
    return x.full_tensor() if isinstance(x, DTensor) else x


def is_dtensor(x) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def contiguous_stride(shape) -> tuple:
    stride = [1] * len(shape)
    for i in range(len(shape) - 2, -1, -1):
        stride[i] = stride[i + 1] * shape[i + 1]
    return tuple(stride)


def one_hot(idx, n: int, like=None):
    """``F.one_hot(idx, n)``.  For a DTensor ``idx`` each rank builds only
    its own rows (DTensor's ``one_hot`` starts from a new tensor of the
    whole global shape on every rank), placed as ``idx`` with the classes
    whole; with ``like``, a DTensor of the result's shape, placed as
    ``like``, each rank holding only its part of the classes too."""
    import torch
    if not is_dtensor(idx):
        return torch.nn.functional.one_hot(idx.long(), n)
    from torch.distributed.tensor import DTensor, Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    mesh = idx.device_mesh
    placements = list(like.placements if like is not None else idx.placements)
    shape = torch.Size(tuple(idx.shape) + (n,))
    local, off = compute_local_shape_and_global_offset(shape, mesh, placements)
    rows = [Replicate() if isinstance(pl, Shard) and pl.dim == idx.ndim else pl
            for pl in placements]
    ids = idx.redistribute(mesh, rows).to_local().long()
    classes = torch.arange(off[-1], off[-1] + local[-1], device=ids.device)
    return DTensor.from_local((classes == ids[..., None]).long(), mesh, placements,
                              run_check=False, shape=shape,
                              stride=contiguous_stride(shape))


def topk_last(x, k: int):
    """``torch.topk(x, k, dim=-1)``.  For a DTensor each rank picks from
    its own rows, the last dim gathered whole first: DTensor's topk rule
    leaves k out of its cache key, so two calls with different k over the
    same shapes (two MoE models in one process) would share one cached
    output shape."""
    import torch
    if not is_dtensor(x):
        return torch.topk(x, k, dim=-1)
    from torch.distributed.tensor import DTensor
    x = unshard(x, -1)
    vals, idx = torch.topk(x.to_local(), k, dim=-1)
    shape = torch.Size(tuple(x.shape[:-1]) + (k,))
    return tuple(DTensor.from_local(t, x.device_mesh, x.placements, run_check=False,
                                    shape=shape, stride=contiguous_stride(shape))
                 for t in (vals, idx))


def reduced(x):
    """``x`` with any pending partial sum reduced (replicated over those
    mesh axes), for an op that some DTensor versions cannot apply to a
    partial (each caller names its op); any other x as it is."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    if not isinstance(x, DTensor) or not any(isinstance(pl, Partial) for pl in x.placements):
        return x
    return x.redistribute(x.device_mesh, [Replicate() if isinstance(pl, Partial) else pl
                                          for pl in x.placements])


def one_axis_per_dim(x):
    """``x`` with each tensor dim split over one mesh axis at most: a dim
    split over several (the multi-pod batch over "pod" and "data") keeps
    its innermost axis and is gathered over the others, for an op whose
    DTensor strategy cannot take such a split on every version (each
    caller names its op); any other x as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    placements = list(x.placements)
    for m, pl in enumerate(placements):
        if isinstance(pl, Shard) and any(p == pl for p in placements[m + 1:]):
            placements[m] = Replicate()
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def unshard(x, *dims: int):
    """``x`` with ``dims`` whole on every rank, for an op whose DTensor
    strategy cannot take them sharded (each caller names its op); any
    other x as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(x, DTensor):
        return x
    dims = {d % x.ndim for d in dims}
    placements = [Replicate() if isinstance(pl, Shard) and pl.dim in dims else pl
                  for pl in x.placements]
    if placements == list(x.placements):
        return x
    return x.redistribute(x.device_mesh, placements)


def placed_like(x, ref):
    """``x`` at ``ref``'s placements when both are DTensors (a gradient
    that autograd left partial, a pending sum, is reduced); any other x
    as it is."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor) or not isinstance(ref, DTensor) \
            or x.placements == ref.placements:
        return x
    return x.redistribute(ref.device_mesh, ref.placements)


def write_at(t, dim: int, index: int, value):
    """``t.select(dim, index).copy_(value)``.  On a DTensor ``t`` (a cache
    split along ``dim`` too) only the shard holding row ``index`` writes,
    from ``value`` placed as that row of ``t``: what the reference's
    ``dynamic_update_slice`` does per shard.  DTensor's own select would
    gather the whole of ``dim`` and write into the gathered copy."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(t, DTensor):
        t.select(dim, index).copy_(value)
        return t
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    shape, off = compute_local_shape_and_global_offset(t.shape, t.device_mesh,
                                                       t.placements)
    row = [Replicate() if not isinstance(pl, Shard) or pl.dim == dim
           else Shard(pl.dim - (pl.dim > dim)) for pl in t.placements]
    local = value.redistribute(t.device_mesh, row).to_local()
    if off[dim] <= index < off[dim] + shape[dim]:
        t.to_local().select(dim, index - off[dim]).copy_(local)
    return t


def logical_spec(logical_axes: Sequence[Optional[str]], ndim: int) -> P:
    """The PartitionSpec the installed rules give ``logical_axes``;
    trailing dims default to unsharded."""
    rules = getattr(_state, "rules", None) or {}
    spec = [None if ax is None else rules.get(ax) for ax in logical_axes]
    return P(*(spec[:ndim] + [None] * (ndim - len(spec))))


def shard_activation(x, logical_axes: Sequence[Optional[str]]):
    mesh = current_mesh()
    if mesh is None or getattr(_state, "rules", None) is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    spec = logical_spec(logical_axes, x.ndim)
    placements = spec_to_placements(spec, mesh.mesh_dim_names)
    if tuple(x.placements) == tuple(placements):
        return x
    return x.redistribute(mesh, placements)


def set_moe_groups(n: int):
    """Number of routing groups for MoE dispatch (= DP shard count).
    Grouped routing keeps dispatch tensors linear in tokens-per-shard;
    the group axis maps to the 'batch' logical rule."""
    _state.moe_groups = n


def moe_groups() -> int:
    return getattr(_state, "moe_groups", None) or 1


def set_param_handlers(gather_fn=None, grad_fn=None):
    """Install FSDP handlers: ``gather_fn(tree)`` redistributes one
    layer's parameters to their compute (TP-only) placements inside the
    layer loop, so only that layer is gathered over the data axis at a
    time; ``grad_fn(tree)`` pins gradients back to the full (FSDP)
    placements, so each micro-step reduce-scatters instead of keeping
    full gradients live."""
    _state.gather_fn = gather_fn
    _state.grad_fn = grad_fn


def clear_param_handlers():
    _state.gather_fn = None
    _state.grad_fn = None
    _state.moe_groups = None


def gather_params_for_compute(tree):
    fn = getattr(_state, "gather_fn", None)
    return fn(tree) if fn is not None else tree


def constrain_grads(tree):
    fn = getattr(_state, "grad_fn", None)
    return fn(tree) if fn is not None else tree
