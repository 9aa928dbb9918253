"""Multi-pod dry run: every (arch × shape × mesh) cell's step, run once on
a fake process group with nothing allocated.

Ports ``src/repro/launch/dryrun.py``.  The reference lowers and compiles
each cell for 256 or 512 host devices and reads XLA's memory and cost
analyses.  Here rank 0 of a ``fake`` process group of 256 (16×16) or 512
(2×16×16) ranks builds the production mesh (``launch/mesh.py``), and
parameters, AdamW state, batch and cache are DTensors over ``meta``
local tensors, of the shapes the port's own ``init_params`` and
``init_cache`` give and placed by ``param_pspecs``, ``batch_pspec`` and
``cache_pspecs``.  The cell's train, prefill or serve step then runs
once: every op runs on rank 0's local shards, on no device, and the
collectives DTensor issues go to the fake group.  Under the run,
:class:`DeviceCounter` sees the local ops below DTensor (it returns
``NotImplemented`` for DTensor arguments, as ``CommDebugMode`` does) and
counts, per device:

* FLOPs: ``torch.utils.flop_counter``'s formulas (matmuls, attention,
  convolutions; elementwise ops count none) on the local shapes.
  ``FlopCounterMode`` would count the global op, since it runs above
  DTensor; the shape propagation DTensor runs on fake tensors is skipped;
* bytes accessed: each local op's operands and results, unfused (XLA's
  count is after fusion, so this one is higher); views move nothing;
* collective bytes: each functional collective's result, by kind, beside
  ``CommDebugMode``'s counts (:func:`roofline.collective_bytes_from_comm`);
* temp memory: the peak of live local tensors the step allocated, each
  tracked from its creation to the release of its Python object (which
  autograd keeps alive while it saves it).

The port's layer loop is Python, so every layer is counted and no
P/2P extrapolation probes are needed.  Results go to
``artifacts/dryrun_torch/<arch>__<shape>__<mesh>__<variant>.json`` with
the reference's keys.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen3_8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod-only]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback
import weakref
from collections import defaultdict
from pathlib import Path
from typing import Any, Dict, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from ..configs.registry import (ARCH_IDS, SHAPES, ArchConfig, ShapeConfig,
                                get_arch, runnable_cells)
from ..model import transformer as T
from ..model.layers import dtype_of
from ..model.sharding import (P, clear_logical_rules, clear_param_handlers,
                              contiguous_stride, set_logical_rules, set_moe_groups,
                              set_param_handlers, spec_to_placements)
from ..optim import adamw
from ..train import steps as STEPS
from ..tree import leaves
from . import mesh as M
from .roofline import (active_params, collective_bytes_from_comm, collective_kind,
                       roofline_terms)

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

# §Perf variants: module-level model knobs applied around the run.
# 'baseline' is the paper-faithful configuration recorded first.
VARIANTS: Dict[str, Dict[str, Any]] = {
    "baseline": {},
    "chunked_attn": {"attn_chunk": 512},
    "chunked_attn_256": {"attn_chunk": 256},
    "remat_dots": {"remat": "dots"},
    "chunked_remat_dots": {"attn_chunk": 512, "remat": "dots"},
    "no_remat": {"remat": "none"},
    # serving: drop tensor-parallel sharding (params replicated, DP only)
    # — removes the per-layer all-reduce chain for tiny per-token compute
    "tp_off": {"tp_off": True},
    "tp_off_chunked": {"tp_off": True, "attn_chunk": 512},
    # decode: one-hot embed = local shard matmul + tiny AR instead of
    # all-gathering the whole vocab-sharded table per step
    "onehot_embed": {"embed_mode": "onehot"},
    # decode: keep TP but drop FSDP — weights stay resident (sharded
    # 1/16 on 'model'), no per-layer data-axis all-gather per token step
    "no_fsdp": {"fsdp_off": True},
    "no_fsdp_onehot": {"fsdp_off": True, "embed_mode": "onehot"},
    # train: fewer microbatches → fewer FSDP param re-gathers
    "micro_half": {"n_micro_div": 2},
    "micro_quarter": {"n_micro_div": 4},
}

MESH_NAMES = {False: "pod16x16", True: "pod2x16x16"}


class _variant_ctx:
    def __init__(self, name: str):
        self.knobs = VARIANTS[name]

    def __enter__(self):
        from ..model import attention as A
        from ..model import layers as L
        self.prev = (A.ATTN_CHUNK, T.REMAT, L.EMBED_MODE)
        A.ATTN_CHUNK = self.knobs.get("attn_chunk", 0)
        T.REMAT = self.knobs.get("remat", "full")
        L.EMBED_MODE = self.knobs.get("embed_mode", "take")
        return self

    def __exit__(self, *exc):
        from ..model import attention as A
        from ..model import layers as L
        A.ATTN_CHUNK, T.REMAT, L.EMBED_MODE = self.prev
        return False


# ---------------------------------------------------------------------------
# per-device counts below DTensor
# ---------------------------------------------------------------------------

def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _tensors(tree):
    return [x for x in leaves(tree) if isinstance(x, torch.Tensor)]


class DeviceCounter(TorchDispatchMode):
    """Per-device FLOPs, bytes accessed, collective bytes and live-memory
    peak of the local ops below DTensor (see the module docstring)."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self.registry = flop_registry
        self.flops = 0
        self.bytes_accessed = 0
        self.coll_bytes: Dict[str, int] = defaultdict(int)
        self.live = 0
        self.peak = 0

    def _free(self, n: int):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor desugar to local ops first
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if any(isinstance(x, FakeTensor) for x in ins + outs):
            return out                   # DTensor's shape propagation
        kind = collective_kind(func)
        if kind:
            self.coll_bytes[kind] += sum(map(_nbytes, outs))
        if func.namespace == "_c10d_functional":
            return out                   # waits and autograd wrappers move nothing
        packet = func._overloadpacket
        if packet in self.registry:
            self.flops += self.registry[packet](*args, **kwargs, out_val=out)
        # the schema tells views (aliased, not written) and in-place or
        # out= results (aliased, written) from new tensors
        alias = [r.alias_info for r in func._schema.returns]
        if (alias and all(a is not None and not a.is_write for a in alias)
                or func is torch.ops.aten._unsafe_view.default):
            return out                   # views move no bytes
        self.bytes_accessed += sum(map(_nbytes, ins)) + sum(map(_nbytes, outs))
        if all(a is None for a in alias):
            for o in outs:
                n = _nbytes(o)
                self.live += n
                weakref.finalize(o, self._free, n)
            self.peak = max(self.peak, self.live)
        return out


# ---------------------------------------------------------------------------
# inputs as DTensors over meta local tensors
# ---------------------------------------------------------------------------

def _meta_dtensor(shape, dtype: torch.dtype, mesh, spec: P, requires_grad: bool = False):
    """A DTensor of global ``shape`` placed by ``spec``, its local shard a
    ``meta`` tensor: no storage anywhere."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
    placements = spec_to_placements(spec, mesh.mesh_dim_names)
    shape = torch.Size(shape)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, placements)
    t = DTensor.from_local(torch.empty(local, dtype=dtype, device="meta"), mesh,
                           placements, run_check=False, shape=shape,
                           stride=contiguous_stride(shape))
    return t.requires_grad_() if requires_grad else t


def _abstract(fn):
    """``fn()``'s tensors as fake tensors: their shapes and dtypes, with
    nothing allocated."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        return fn()


def input_specs(cfg: ArchConfig, shape: ShapeConfig) -> Dict[str, Any]:
    """Fake-tensor stand-ins for every step input (no allocation): tokens
    and labels, a vlm's vision stub, an encoder's stub frames; for decode
    one token, a full-length cache and the encoder's memory."""
    gb, seq = shape.global_batch, shape.seq_len
    stub = (gb, cfg.frontend_len, cfg.d_model)

    def build():
        if shape.kind in ("train", "prefill"):
            text_len = seq - (cfg.frontend_len if cfg.family == "vlm" else 0)
            batch = {"tokens": torch.zeros((gb, text_len), dtype=torch.long)}
            if shape.kind == "train":
                batch["labels"] = torch.zeros((gb, text_len), dtype=torch.long)
            if cfg.family == "vlm":
                batch["frontend"] = torch.zeros(stub, dtype=torch.bfloat16)
            if cfg.enc_layers:
                batch["enc_frontend"] = torch.zeros(stub, dtype=torch.bfloat16)
            return batch
        batch = {"token": torch.zeros((gb, 1), dtype=torch.long),
                 "cache": T.init_cache(cfg, gb, seq, device="cpu")}
        if cfg.enc_layers:
            batch["memory"] = torch.zeros(stub, dtype=dtype_of(cfg.dtype))
        return batch
    return _abstract(build)


def batch_pspecs(cfg: ArchConfig, shape: ShapeConfig, batch, mesh):
    bspec = M.batch_pspec(mesh, shape.global_batch)
    specs: Dict[str, Any] = {}
    for name in batch:
        if name in ("tokens", "labels", "token"):
            specs[name] = bspec
        elif name in ("frontend", "enc_frontend", "memory"):
            specs[name] = P(bspec[0] if len(bspec) else None, None, None)
        elif name == "cache":
            specs[name] = M.cache_pspecs(batch["cache"], cfg, mesh, shape.global_batch)
    return specs


def _place(tree, specs, mesh, requires_grad: bool = False):
    return M.map_specs(lambda s, t: _meta_dtensor(t.shape, t.dtype, mesh, s, requires_grad),
                       specs, tree)


def lower_cell(arch_id: str, shape_name: str, multi_pod: bool,
               n_micro: Optional[int] = None, variant: str = "baseline",
               cfg: Optional[ArchConfig] = None):
    """The cell's production mesh and ``run(counted)``, which builds the
    step's inputs as meta DTensors and runs the step once inside the
    context ``counted()``, returning (step inputs, step outputs).  The
    variant's knobs and the mesh's rules are installed around both."""
    cfg = cfg or get_arch(arch_id)
    shape = SHAPES[shape_name]
    mesh = M.make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    knobs = VARIANTS.get(variant, {})
    tp_off = knobs.get("tp_off", False)
    rules = M.logical_rules(cfg, mesh, batch=shape.global_batch)
    if tp_off:
        rules = {k: (v if k == "batch" else None) for k, v in rules.items()}
        cfg = cfg.scaled(fsdp=False)
    elif knobs.get("fsdp_off"):
        cfg = cfg.scaled(fsdp=False)
    dp_n = M.axis_size(mesh, M.dp_axes(mesh))
    params_shape = _abstract(lambda: T.init_params(cfg, device="cpu"))
    pspecs = M.param_pspecs(params_shape, cfg, mesh)
    if tp_off:
        pspecs = M.map_specs(lambda s: P(), pspecs)
    batch_shape = input_specs(cfg, shape)
    bspecs = batch_pspecs(cfg, shape, batch_shape, mesh)
    if tp_off:
        dp_set = {"data", "pod"}

        def keep_dp(s):
            return P(*[ax if (ax in dp_set or (isinstance(ax, tuple) and set(ax) <= dp_set))
                       else None for ax in s])
        bspecs = M.map_specs(keep_dp, bspecs)

    def run(counted):
        set_logical_rules(mesh, rules)
        set_param_handlers(*M.make_param_handlers(cfg, mesh))
        set_moe_groups(dp_n)
        try:
            with _variant_ctx(variant):
                train = shape.kind == "train"
                params = _place(params_shape, pspecs, mesh, requires_grad=train)
                batch = _place(batch_shape, bspecs, mesh)
                if train:
                    nm = n_micro or max(shape.global_batch // dp_n, 1)
                    nm = max(nm // knobs.get("n_micro_div", 1), 1)
                    args = (params, adamw.init(params), batch)
                    step = STEPS.make_train_step(cfg, adamw.AdamWConfig(), nm)
                elif shape.kind == "prefill":
                    args, step = (params, batch), STEPS.make_prefill_step(cfg)
                else:
                    # decode at the cache's last row: one token over a full cache
                    batch["cache_len"] = shape.seq_len - 1
                    args, step = (params, batch), STEPS.make_serve_step(cfg)
                with counted():
                    return args, step(*args)
        finally:
            clear_logical_rules()
            clear_param_handlers()

    return mesh, run


def active_params_total(cfg: ArchConfig) -> float:
    """All parameters (not just active) — for optimizer flop estimates."""
    total = active_params(cfg)
    if cfg.n_experts:
        per_expert = 3 * cfg.d_model * cfg.d_ff
        n_moe_layers = sum(1 for i in range(cfg.n_layers) if cfg.is_moe_layer(i))
        total += per_expert * (cfg.n_experts - cfg.top_k) * n_moe_layers
    return total


def _local_bytes(tree) -> int:
    """Bytes of the local shards of the DTensors (and any plain tensor) in
    ``tree``, each storage once."""
    from torch.distributed.tensor import DTensor
    seen, total = set(), 0
    for t in _tensors(tree):
        loc = t._local_tensor if isinstance(t, DTensor) else t
        if id(loc) not in seen:
            seen.add(id(loc))
            total += _nbytes(loc)
    return total


def _aliased(args, outs) -> int:
    """Bytes of the outputs that are inputs updated in place."""
    from torch.distributed.tensor import DTensor
    ins = {id(t._local_tensor if isinstance(t, DTensor) else t) for t in _tensors(args)}
    return _local_bytes([t for t in _tensors(outs)
                         if id(t._local_tensor if isinstance(t, DTensor) else t) in ins])


def run_cell(arch_id: str, shape_name: str, multi_pod: bool,
             save: bool = True, variant: str = "baseline",
             cfg: Optional[ArchConfig] = None,
             n_micro: Optional[int] = None) -> Dict[str, Any]:
    """One cell's record (see the module docstring); ``cfg`` and
    ``n_micro`` override the arch's config and the train step's
    micro-batch count, as in :func:`lower_cell`."""
    from torch.distributed.tensor.debug import CommDebugMode

    mesh_name = MESH_NAMES[multi_pod]
    t0 = time.time()
    out: Dict[str, Any] = {
        "arch": arch_id, "shape": shape_name, "mesh": mesh_name,
        "variant": variant, "ok": False,
    }
    try:
        cfg = cfg or get_arch(arch_id)
        shape = SHAPES[shape_name]
        mesh, run = lower_cell(arch_id, shape_name, multi_pod, n_micro=n_micro,
                               variant=variant, cfg=cfg)
        t_lower = time.time() - t0
        comm, cnt = CommDebugMode(), DeviceCounter()

        @contextlib.contextmanager
        def counted():
            with comm, cnt:
                yield
        args, result = run(counted)
        t_run = time.time() - t0 - t_lower
        n_dev = mesh.mesh.numel()
        arguments, output = _local_bytes(args), _local_bytes(result)
        aliased = _aliased(args, result)
        del args, result
        cost = {"flops": float(cnt.flops), "bytes accessed": float(cnt.bytes_accessed)}
        coll = collective_bytes_from_comm(comm, cnt.coll_bytes)
        rf = roofline_terms(cfg, shape, cost, coll, n_dev)
        out.update(
            ok=True,
            lower_s=round(t_lower, 1),
            run_s=round(t_run, 1),
            devices=n_dev,
            memory={
                "bytes_per_device": cnt.peak + arguments + output - aliased,
                "temp": cnt.peak,
                "arguments": arguments,
                "output": output,
                "aliased": aliased,
            },
            cost={"flops": cost["flops"], "bytes_accessed": cost["bytes accessed"]},
            collectives=coll,
            roofline=rf,
        )
    except Exception as e:
        out["error"] = f"{type(e).__name__}: {e}"
        out["traceback"] = traceback.format_exc()[-4000:]
    if save:
        ART.mkdir(parents=True, exist_ok=True)
        (ART / f"{arch_id}__{shape_name}__{mesh_name}__{variant}.json").write_text(
            json.dumps(out, indent=1, default=str))
    return out


def init_fake_group(world_size: int) -> None:
    """Rank 0 of a ``fake`` process group of ``world_size`` ranks (any
    group already initialised in this process is destroyed first)."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod-only", action="store_true")
    ap.add_argument("--multi-pod-only", action="store_true")
    ap.add_argument("--variant", default="baseline")
    ap.add_argument("--skip-existing", action="store_true")
    args = ap.parse_args(argv)

    meshes = [False, True]
    if args.multi_pod or args.multi_pod_only:
        meshes = [True]
    elif args.single_pod_only:
        meshes = [False]
    if args.all:
        pairs = runnable_cells()
    else:
        archs = [args.arch] if args.arch else ARCH_IDS
        shapes = [args.shape] if args.shape else list(SHAPES)
        pairs = [(a, s) for a in archs for s in shapes
                 if (a, s) in runnable_cells()]

    results = []
    # one fake group per mesh: its world is the mesh's size
    for mp in meshes:
        init_fake_group(512 if mp else 256)
        for a, s in pairs:
            mesh_name = MESH_NAMES[mp]
            art = ART / f"{a}__{s}__{mesh_name}__{args.variant}.json"
            if args.skip_existing and art.exists():
                prev = json.loads(art.read_text())
                if prev.get("ok"):
                    print(f"[dryrun] {a} × {s} × {mesh_name}: SKIP (exists)", flush=True)
                    results.append(prev)
                    continue
            r = run_cell(a, s, mp, variant=args.variant)
            results.append(r)
            status = "OK" if r["ok"] else f"FAIL ({r.get('error', '?')[:120]})"
            extra = ""
            if r["ok"]:
                gb = r["memory"]["bytes_per_device"] / 2**30
                bt = r["roofline"]["bottleneck"]
                extra = (f" mem/dev={gb:.2f}GiB bottleneck={bt} "
                         f"flops/dev={r['cost']['flops']:.4g} run={r['run_s']}s")
            print(f"[dryrun] {a} × {s} × {'2x16x16' if mp else '16x16'}: {status}{extra}",
                  flush=True)
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()
    return results


if __name__ == "__main__":
    main()
