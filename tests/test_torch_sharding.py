"""The port's sharding policy (``repro_torch.model.sharding``,
``repro_torch.launch.mesh``) against the reference's.

The reference's ``logical_rules``, ``param_pspecs``, ``cache_pspecs`` and
``batch_pspec`` run here on ``jax.sharding.AbstractMesh``es of the
production shapes (16×16 and 2×16×16) over ``jax.eval_shape`` trees; the
port's run in a subprocess on DeviceMeshes over fake process groups of
256 and 512 ranks, over fake-tensor trees from its own ``init_params``
and ``init_cache``.  The reference stacks each pattern slot's layers with
a leading layer axis (its specs lead with None there); the port keeps
one tree per layer, so stacked slot ``s`` at repeat ``r`` is the port's
layer ``r·period + s`` (``repro_torch.bridge``'s map) and its spec loses
that None.  Then MoE routed in G = 4 groups against the reference's at
the same G, in f32.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AbstractMesh, PartitionSpec

from repro.configs.registry import ARCH_IDS, get_arch as jax_get_arch
from repro.launch import mesh as JM
from repro.model import mlp as JMLP
from repro.model import sharding as JS
from repro.model import transformer as JT
from repro_torch import bridge
from repro_torch.configs.registry import get_arch
from repro_torch.model import mlp as TMLP
from repro_torch.model import sharding as S
from repro_torch.model import transformer as TT

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
SRC = str(ROOT / "src")
BATCHES = (256, 128, 32, 8, 1)
CACHE_BATCHES = (128, 1)
MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}


# ---------------------------------------------------------------------------
# the converter
# ---------------------------------------------------------------------------

def test_spec_to_placements_and_back():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    cases = [
        (S.P(("pod", "data"), "model"), [Shard(0), Shard(0), Shard(1)]),
        (S.P("model", None, ("pod", "data")), [Shard(2), Shard(2), Shard(0)]),
        (S.P(None, "data"), [Replicate(), Shard(1), Replicate()]),
        (S.P(), [Replicate()] * 3),
    ]
    for spec, placements in cases:
        assert S.spec_to_placements(spec, names) == placements
        back = S.placements_to_spec(placements, names, max(len(spec), 1))
        assert tuple(back) == tuple(spec) + (None,) * (len(back) - len(spec))
    # a spec naming one mesh axis is the name, as JAX stores it
    assert S.P(("data",), "model") == ("data", "model") == tuple(PartitionSpec(("data",), "model"))
    assert S.spec_to_placements(S.P(("data",)), ("data", "model")) == [Shard(0), Replicate()]
    with pytest.raises(ValueError):       # DTensor nests a dim's shards in mesh order
        S.spec_to_placements(S.P(("data", "pod")), names)
    from torch.distributed.tensor import Partial
    with pytest.raises(ValueError):
        S.placements_to_spec([Partial(), Replicate()], ("data", "model"), 2)


def test_annotations_are_identity_off_the_mesh():
    x = torch.randn(2, 3, 4)
    S.set_logical_rules(None, {"batch": "data"})
    try:
        assert S.shard_activation(x, ("batch", None, None)) is x
    finally:
        S.clear_logical_rules()
    assert S.shard_activation(x, ("batch",)) is x
    assert S.gather_params_for_compute(x) is x and S.constrain_grads(x) is x
    assert S.moe_groups() == 1


# ---------------------------------------------------------------------------
# the production policy, port (subprocess) against reference
# ---------------------------------------------------------------------------

PORT_SCRIPT = """
import json, sys, torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.configs.registry import ARCH_IDS, get_arch
from repro_torch.launch import mesh as M
from repro_torch.model import transformer as T
from repro_torch.model.sharding import P
def flatten(tree, prefix=""):
    if isinstance(tree, P):
        return {prefix: list(tree)}
    items = tree.items() if isinstance(tree, dict) else enumerate(tree)
    out = {}
    for k, v in items:
        out.update(flatten(v, f"{prefix}/{k}" if prefix else str(k)))
    return out
batches, cache_batches = json.loads(sys.argv[1]), json.loads(sys.argv[2])
out = {}
for name, multi in (("pod16x16", False), ("pod2x16x16", True)):
    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=512 if multi else 256)
    mesh = M.make_production_mesh(multi_pod=multi, device_type="cpu")
    got = {"batch_pspec": {b: M.batch_pspec(mesh, b) for b in batches}, "archs": {}}
    for arch in ARCH_IDS:
        cfg = get_arch(arch)
        with FakeTensorMode():
            params = T.init_params(cfg, device="cpu")
            caches = {b: T.init_cache(cfg, b, 64, device="cpu") for b in cache_batches}
        got["archs"][arch] = {
            "rules": {b: M.logical_rules(cfg, mesh, batch=b) for b in batches},
            "params": flatten(M.param_pspecs(params, cfg, mesh)),
            "caches": {b: flatten(M.cache_pspecs(c, cfg, mesh, b))
                       for b, c in caches.items()},
        }
    out[name] = got
    dist.destroy_process_group()
print(json.dumps(out))
"""


@functools.lru_cache(maxsize=1)
def port_policy() -> dict:
    out = subprocess.run([sys.executable, "-c", PORT_SCRIPT, json.dumps(BATCHES),
                          json.dumps(CACHE_BATCHES)],
                         env=dict(os.environ, PYTHONPATH=SRC), capture_output=True,
                         text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def norm(x):
    """Specs and rules as JSON gives them back (tuples as lists)."""
    if isinstance(x, PartitionSpec):
        x = tuple(x)
    return json.loads(json.dumps(x))


def _key(k) -> str:
    return str(getattr(k, "key", getattr(k, "idx", k)))


def reference_per_layer(specs, cfg) -> dict:
    """The reference's spec tree keyed by the port's paths: stacked slot
    ``s`` repeat ``r`` → ``layers/{r·period+s}`` without the leading
    None, tail ``i`` → ``layers/{repeats·period+i}``; ``encoder`` →
    ``enc_layers``; caches (a ``{"slots", "tail"}`` tree) → ``{l}/…``."""
    out = {}
    flat, _ = jax.tree_util.tree_flatten_with_path(
        specs, is_leaf=lambda x: isinstance(x, PartitionSpec))
    for path, spec in flat:
        keys = [_key(k) for k in path]
        spec = tuple(spec)
        if "slots" in keys or "tail" in keys:
            i = keys.index("slots") if "slots" in keys else keys.index("tail")
            role = "encoder" if keys[:i] == ["encoder"] else "decoder"
            period = JT.pattern_period(cfg, role)
            n = cfg.enc_layers if role == "encoder" else cfg.n_layers
            repeats = n // period
            prefix = {"decoder": ["layers"], "encoder": ["enc_layers"], "": []}[
                "/".join(keys[:i])]
            pos, rest = int(keys[i + 1]), keys[i + 2:]
            if keys[i] == "slots":
                assert spec[0] is None            # the layer axis is never sharded
                layers = [(r * period + pos, spec[1:]) for r in range(repeats)]
            else:
                layers = [(repeats * period + pos, spec)]
            for layer, s in layers:
                out["/".join(prefix + [str(layer)] + rest)] = norm(s)
        else:
            out["/".join(keys)] = norm(spec)
    return out


@pytest.mark.parametrize("mesh_name", list(MESHES))
def test_batch_pspec_equals_reference(mesh_name):
    am = AbstractMesh(*MESHES[mesh_name])
    got = port_policy()[mesh_name]["batch_pspec"]
    assert got == {str(b): norm(JM.batch_pspec(am, b)) for b in BATCHES}


@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_rules_and_param_and_cache_specs_equal_reference(arch, mesh_name):
    am = AbstractMesh(*MESHES[mesh_name])
    cfg = jax_get_arch(arch)
    got = port_policy()[mesh_name]["archs"][arch]
    assert got["rules"] == {str(b): norm(JM.logical_rules(cfg, am, batch=b))
                            for b in BATCHES}
    params = jax.eval_shape(lambda: JT.init_params(jax.random.PRNGKey(0), cfg))
    want = reference_per_layer(JM.param_pspecs(params, cfg, am), cfg)
    assert got["params"] == want
    for b in CACHE_BATCHES:
        cache = jax.eval_shape(lambda: JT.init_cache(cfg, b, 64))
        assert got["caches"][str(b)] == reference_per_layer(
            JM.cache_pspecs(cache, cfg, am, b), cfg)


# ---------------------------------------------------------------------------
# MoE routed in groups
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=2)
def moe_setup(arch):
    jcfg = jax_get_arch(arch).smoke().scaled(dtype="float32")
    tcfg = get_arch(arch).smoke().scaled(dtype="float32")
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = bridge.params_from_numpy(jax.tree.map(np.asarray, jp), tcfg, "cpu")
    layer = next(i for i in range(tcfg.n_layers) if tcfg.is_moe_layer(i))
    period = TT.pattern_period(tcfg)
    slot = jp["decoder"]["slots"][layer % period]["ffn"]
    return (jcfg, jax.tree.map(lambda a: a[layer // period], slot),
            tcfg, tp["layers"][layer]["ffn"])


@pytest.mark.parametrize("groups", [4, 3])
@pytest.mark.parametrize("arch", ["qwen3_moe_30b_a3b", "llama4_scout_17b_a16e"])
def test_grouped_moe_matches_reference(arch, groups):
    """At G = 4 each group of 8 tokens has its own capacity of 4 seats, so
    picks are dropped where they would not be in one group of 32 (the
    output differs from G = 1); G = 3 does not divide 32 tokens and
    falls back to one group in both packages."""
    jcfg, jp, tcfg, tp = moe_setup(arch)
    x = np.random.RandomState(11).standard_normal((2, 16, 64)).astype(np.float32)
    JS.set_moe_groups(groups)
    S.set_moe_groups(groups)
    try:
        want, jaux = JMLP.moe(jp, jcfg, jnp.asarray(x))
        got, taux = TMLP.moe(tp, tcfg, torch.from_numpy(x))
    finally:
        JS.clear_param_handlers()
        S.clear_param_handlers()
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    np.testing.assert_allclose(float(taux), float(jaux), rtol=0, atol=1e-5)
    one, _ = TMLP.moe(tp, tcfg, torch.from_numpy(x))
    if groups == 3:
        assert torch.equal(one, got)
    elif arch == "qwen3_moe_30b_a3b":
        assert not torch.equal(one, got)
