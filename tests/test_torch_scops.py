"""The port's SCoP suites (``repro_torch.core.scops_polybench`` and
``scops_npu``) against the reference's.

Every builder of both suites, at its default ``SIZE``, must give a SCoP
whose structural fingerprint (``schedcache.scop_fingerprint``), scalars,
parameters, ``c_init`` strings and ``np_init`` arrays equal the
reference's, the arrays drawn from the same seeded numpy generator; the
NPU suite's three scheduler configurations and its Table I sizes equal
the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

from repro.core import scops_npu as jnpu
from repro.core import scops_polybench as jpb
from repro.core.cbackend import array_extents as j_extents
from repro.core.schedcache import scop_fingerprint as j_fingerprint
from repro_torch.core import scops_npu as tnpu
from repro_torch.core import scops_polybench as tpb
from repro_torch.core.cbackend import array_extents as t_extents
from repro_torch.core.schedcache import scop_fingerprint as t_fingerprint
from repro_torch.core.scop import Scop

NPU = ("make_trsml", "make_trsmu", "make_lu16")
BUILDERS = ([("polybench", k) for k in sorted(jpb.REGISTRY)]
            + [("npu", k) for k in NPU])


def build(suite: str, name: str):
    if suite == "polybench":
        return jpb.REGISTRY[name](), tpb.REGISTRY[name]()
    return getattr(jnpu, name)(), getattr(tnpu, name)()


def test_registry_and_sizes_equal():
    assert list(tpb.REGISTRY) == list(jpb.REGISTRY)
    assert tpb.SIZE == jpb.SIZE
    assert list(tpb.all_kernels()) == list(jpb.all_kernels())
    assert tnpu.V == jnpu.V
    assert tnpu.TABLE1_SIZES == jnpu.TABLE1_SIZES


@pytest.mark.parametrize("suite,name", BUILDERS)
def test_builder_equals_the_reference(suite, name):
    ref, port = build(suite, name)
    assert type(port) is Scop
    assert t_fingerprint(port) == j_fingerprint(ref)
    assert (port.name, port.params, port.scalars) == (ref.name, ref.params, ref.scalars)
    assert dict(port.arrays) == dict(ref.arrays)
    assert port.c_init == ref.c_init
    assert sorted(port.np_init) == sorted(ref.np_init)
    assert t_extents(port) == j_extents(ref)
    ext = t_extents(port)
    for a in port.np_init:
        shape = tuple(max(d, 1) for d in ext[a])
        want = ref.np_init[a](shape, np.random.default_rng(7))
        got = port.np_init[a](shape, np.random.default_rng(7))
        np.testing.assert_array_equal(got, want)
        assert port.np_init[a].__module__ == "repro_torch.core.scops_polybench"


@pytest.mark.parametrize("name", ["directive_config", "autovec_config"])
def test_npu_configs_equal(name):
    assert getattr(tnpu, name)().to_json() == getattr(jnpu, name)().to_json()


def test_npu_baseline_strategy_equal():
    """The isl-style baseline's dynamic strategy callback answers every
    (dim, parallel_failed) state as the reference's does."""
    from types import SimpleNamespace

    jcfg, tcfg = jnpu.baseline_config(), tnpu.baseline_config()
    assert tcfg.name == jcfg.name
    for dim in range(4):
        for failed in (False, True):
            state = SimpleNamespace(dim=dim, parallel_failed=failed)
            j, t = jcfg.strategy(state), tcfg.strategy(state)
            assert (t.cost_functions, t.require_parallel) == \
                (j.cost_functions, j.require_parallel)


@pytest.mark.parametrize("sizes", [(16, 16, 32), (16, 48, 16)])
def test_npu_table1_shapes_equal(sizes):
    for name in ("make_trsml", "make_trsmu"):
        ref, port = getattr(jnpu, name)(*sizes), getattr(tnpu, name)(*sizes)
        assert t_fingerprint(port) == j_fingerprint(ref)
