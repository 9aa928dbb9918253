"""The port's kernel modules on the CPU: plain versions against the JAX
package's Pallas kernels (interpret mode), dispatch, and plans.

The CUDA kernels themselves run only on the card (``chip_smoke.py``
holds them against these plain versions there).  Here the plain
versions are held to the Pallas kernels at the shapes of
``python -m repro.kernels.bench --smoke`` and its f32 tolerance of 1e-4
(``bench.py:102,120``), including the chunked-prefill ``q_offset`` case
and GQA; the wrappers must route CPU tensors to the plain version and
refuse to launch a kernel on them.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import akg
from repro.kernels import ops as jops
from repro_torch import plan as tplan
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import matmul_polytops as mm

torch.set_num_threads(1)

TOL = dict(rtol=1e-4, atol=1e-4)


def rnd(seed, shape, scale=1.0):
    return (np.random.RandomState(seed).standard_normal(shape)
            * scale).astype(np.float32)


def test_matmul_plain_matches_pallas():
    a, b = rnd(0, (128, 128)), rnd(1, (128, 128))
    want = jops.matmul(jnp.asarray(a), jnp.asarray(b), interpret=True)
    got = ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_matmul_plain_ragged_and_bf16():
    a, b = rnd(2, (37, 70)), rnd(3, (70, 50))
    got = ref.matmul_ref(torch.from_numpy(a).bfloat16(),
                         torch.from_numpy(b).bfloat16())
    assert got.dtype == torch.bfloat16 and got.shape == (37, 50)
    want = (torch.from_numpy(a).bfloat16().float()
            @ torch.from_numpy(b).bfloat16().float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(),
                               rtol=1e-2, atol=1e-2)


def _flash_inputs(b, sq, sk, h, hkv, d, seed):
    return (rnd(seed, (b, sq, h, d), 0.3), rnd(seed + 1, (b, sk, hkv, d), 0.3),
            rnd(seed + 2, (b, sk, hkv, d)))


@pytest.mark.parametrize("b,sq,sk,h,hkv,d,q_offset", [
    (1, 128, 128, 2, 2, 64, 0),      # bench.py --smoke flash case
    (2, 64, 64, 4, 2, 32, 0),        # GQA
    (1, 32, 128, 2, 2, 64, 64),      # prefill chunk at offset 64, page-bound kv
    (2, 16, 48, 4, 2, 16, 16),       # smoke serving chunk, GQA, offset
    (1, 64, 128, 2, 1, 256, 64),     # head dim 256 (gemma3), GQA, offset
])
def test_flash_plain_matches_pallas(b, sq, sk, h, hkv, d, q_offset):
    q, k, v = _flash_inputs(b, sq, sk, h, hkv, d, seed=4)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=True, q_offset=jnp.int32(q_offset),
                                interpret=True)
    got = ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                              torch.from_numpy(v), causal=True,
                              q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_attention_ref_noncausal_and_layout():
    q, k, v = _flash_inputs(1, 64, 64, 2, 2, 32, seed=7)
    want = jops.flash_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                causal=False, interpret=True)
    got = ref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_cuda_wrappers_refuse_cpu_tensors():
    """No fallback: the kernel wrappers launch on CUDA or raise, and
    nothing is built or launched for a CPU tensor."""
    a = torch.zeros((16, 16), dtype=torch.bfloat16)
    q = torch.zeros((1, 16, 2, 16), dtype=torch.bfloat16)
    before = (mm.LAUNCHES, fa.LAUNCHES)
    with pytest.raises(ValueError):
        mm.matmul(a, a)
    with pytest.raises(ValueError):
        fa.flash_attention(q, q, q)
    assert (mm.LAUNCHES, fa.LAUNCHES) == before
    assert build._LIB is None


def test_ops_dispatch_cpu_to_plain_versions():
    a, b = torch.from_numpy(rnd(8, (8, 16))), torch.from_numpy(rnd(9, (16, 8)))
    assert torch.equal(ops.matmul(a, b), ref.matmul_ref(a, b))
    q, k, v = (torch.from_numpy(x) for x in _flash_inputs(1, 8, 16, 2, 1, 16, 10))
    assert torch.equal(ops.flash_attention(q, k, v, q_offset=8),
                       ref.flash_attention_ref(q, k, v, q_offset=8))
    with pytest.raises(ValueError):
        ops.matmul(a.to("meta"), b.to("meta"))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

MATMUL_SHAPES = [(16, 128, 64), (16, 64, 128), (128, 128, 128),
                 (256, 8192, 2048), (256, 2048, 8192), (200, 8192, 2048),
                 (256, 10240, 2560), (256, 2560, 10240)]   # gemma3's MLP
ATTN_SHAPES = [(16, 48, 16), (8, 32, 16), (128, 128, 64), (256, 4096, 64),
               (256, 1088, 64), (256, 1024, 64)]


@pytest.mark.parametrize("m,n,k", MATMUL_SHAPES)
def test_plan_matmul_order_matches_reference_and_fits_hopper(m, n, k):
    want, got = akg.plan_matmul(m, n, k), tplan.plan_matmul(m, n, k)
    assert got.loop_order == want.loop_order
    assert got.vector_iter == want.vector_iter
    t = got.tile
    assert set(t) == {"i", "j", "kk"}         # the reference's keys only
    assert all(v % tplan.EDGE == 0 for v in t.values())
    assert t["i"] in tplan.MATMUL_I and t["j"] in tplan.MATMUL_J
    assert t["i"] % 64 == 0 and t["j"] % 8 == 0 and t["j"] <= 256
    assert t["kk"] == 64                       # one 128-byte swizzle row
    assert (t["i"], t["j"], t["kk"]) in tplan.MATMUL_TILES
    assert tplan.matmul_smem_bytes(t) <= tplan.SMEM_BYTES
    assert t["i"] * t["j"] * 4 <= tplan.ACC_BYTES


# (m, n, k): the two serving shapes, a ragged one, chip_smoke's smallest
# (K and N padded to 8) and its split-remainder case
GEOMETRY_SHAPES = MATMUL_SHAPES + [(37, 56, 72), (256, 2048, 8160),
                                   (1, 8, 8), (4096, 4096, 4096)]


@pytest.mark.parametrize("m,n,k", GEOMETRY_SHAPES)
def test_matmul_launch_geometry_fits_hopper(m, n, k):
    tile = tplan.plan_matmul(m, n, k).tile
    geo = tplan.matmul_launch_geometry(m, n, k)
    ktiles = -(-k // tile["kk"])
    tiles = -(-m // tile["i"]) * -(-n // tile["j"])
    assert geo["split"] in tplan.MATMUL_SPLITS
    assert ktiles % geo["split"] == 0           # the split divides the k tiles
    assert geo["split"] == 1 or ktiles // geo["split"] >= tplan.MATMUL_MIN_KTILES
    assert geo["split"] == 1 or geo["blocks"] <= tplan.SMS
    assert geo["blocks"] == tiles * geo["split"]
    assert 3 <= geo["stages"] <= 5
    # the ring and the staged f32 tile over it fit 227 KB
    ring = tplan.matmul_ring_bytes(tile, geo["stages"])
    epi = tplan.matmul_epilogue_bytes(tile)
    assert epi <= ring
    assert geo["smem"] == tplan.matmul_smem_bytes(tile, geo["stages"])
    assert geo["smem"] <= tplan.SMEM_BYTES
    want_ws = geo["split"] * tiles * tile["i"] * tile["j"]
    assert geo["workspace"] == (want_ws if geo["split"] > 1 else 0)


@pytest.mark.parametrize("m,n,k,split", [(256, 8192, 2048, 1),    # gate/up
                                         (256, 2048, 8192, 4)])   # down
def test_matmul_geometry_fills_the_card_at_serving_shapes(m, n, k, split):
    geo = tplan.matmul_launch_geometry(m, n, k)
    assert geo["blocks"] >= 120 and geo["split"] == split


@pytest.mark.parametrize("m,n,k,split,blocks", [(256, 10240, 2560, 1, 160),   # gate/up
                                                (256, 2560, 10240, 2, 80)])   # down
def test_matmul_geometry_at_gemma3_mlp_shapes(m, n, k, split, blocks):
    """gemma3's full chunk: gate/up fills the card with 160 tiles unsplit;
    the down projection's 40 tiles split K in two (a split of 4 would
    make 160 blocks, past one wave), each split keeping 80 k tiles."""
    geo = tplan.matmul_launch_geometry(m, n, k)
    assert (geo["split"], geo["blocks"]) == (split, blocks)
    assert geo["stages"] == tplan.MATMUL_STAGES
    assert geo["smem"] <= tplan.SMEM_BYTES


@pytest.mark.parametrize("m,k,n", [(37, 70, 50), (200, 2048, 8192)])
def test_matmul_pad_operands_keeps_the_product(m, k, n):
    """The wrapper's alignment padding: the padded operands' product,
    sliced to N columns, is the product of the originals."""
    a = torch.from_numpy(rnd(20, (m, k))).bfloat16()
    b = torch.from_numpy(rnd(21, (k, n), k ** -0.5)).bfloat16()
    a_p, b_p = mm.pad_operands(a, b)
    assert a_p.shape == (m, -(-k // 8) * 8) and b_p.shape == (a_p.shape[1], -(-n // 8) * 8)
    assert a_p.data_ptr() % 16 == 0 and b_p.data_ptr() % 16 == 0
    if k % 8 == 0 and n % 8 == 0:
        assert a_p is a and b_p is b                 # nothing copied
    assert torch.equal(ref.matmul_ref(a_p, b_p)[:, :n], ref.matmul_ref(a, b))


def test_matmul_pad_operands_realigns_an_offset_view():
    """A contiguous view 2 bytes into its storage is copied to an aligned
    base; an aligned operand is passed through."""
    base = torch.from_numpy(rnd(22, (1 + 16 * 8,))).bfloat16()
    a = base[1:].reshape(16, 8)
    b = torch.from_numpy(rnd(23, (8, 24))).bfloat16()
    assert a.is_contiguous() and a.data_ptr() % 16 != 0
    a_p, b_p = mm.pad_operands(a, b)
    assert a_p.data_ptr() % 16 == 0 and torch.equal(a_p, a)
    assert b_p is b


@pytest.mark.parametrize("sq,sk,d", ATTN_SHAPES)
def test_plan_attention_order_matches_reference_and_fits_hopper(sq, sk, d):
    want, got = akg.plan_attention(sq, sk, d), tplan.plan_attention(sq, sk, d)
    assert got.loop_order == want.loop_order
    assert got.vector_iter == want.vector_iter
    t = got.tile
    assert t["d"] == d
    assert t["q"] in tplan.POW2 and t["kk"] in tplan.POW2
    assert t["q"] <= 128 and t["kk"] <= 128
    assert tplan.attention_smem_bytes(t) <= tplan.SMEM_BYTES


def test_plan_full_width_tiles():
    assert tplan.plan_matmul(256, 8192, 2048).tile == {"i": 128, "kk": 64,
                                                       "j": 128}
    assert tplan.plan_attention(256, 4096, 64).tile == {"q": 128, "kk": 128,
                                                        "d": 64}


# ---------------------------------------------------------------------------
# flash launch geometry
# ---------------------------------------------------------------------------

# the chunk rows and page-aligned kv prefixes the serving traffic sends
# (chunk 256, page 128), at one slot and at four: granite's (head dim 64,
# 32 heads over 8), the qwen3 shape (128, 32 over 4) and gemma3's global
# layers (256, 8 over 4)
FLASH_HEADS = {64: (32, 8), 128: (32, 4), 256: (8, 4)}
FLASH_GEOMETRY = [(c, kv, d, b) for c in (44, 128, 132, 232, 256)
                  for kv in (384, 640, 768, 1024) for d in (64, 128, 256)
                  for b in (1, 4)]


@pytest.mark.parametrize("c,kv,d,b", FLASH_GEOMETRY)
def test_attention_launch_geometry_fits_hopper(c, kv, d, b):
    h, hkv = FLASH_HEADS[d]
    geo = tplan.attention_launch_geometry(c, kv, d, b, h, hkv)
    assert geo["rows"] == tplan.ATTN_ROWS and geo["bk"] == tplan.attention_bk(d)
    assert geo["smem"] == tplan.attention_launch_smem(d, geo["stages"])
    assert geo["smem"] <= tplan.SMEM_BYTES          # fits 227 KB
    assert geo["stages"] >= 2                       # loads overlap compute
    assert geo["blocks"] == b * h * -(-c // geo["rows"])


@pytest.mark.parametrize("kv,d", [(1024, 64), (768, 64), (1024, 128)])
def test_attention_geometry_fills_the_card_at_one_slot(kv, d):
    """The serving chunk at one slot (b·h 1·32, c 256) launches at least
    128 blocks on the 132 SMs."""
    geo = tplan.attention_launch_geometry(256, kv, d, 1, 32, 8 if d == 64 else 4)
    assert geo["blocks"] >= 128


@pytest.mark.parametrize("stages,fits", [(2, True), (3, True), (4, False)])
def test_attention_geometry_at_head_dim_256(stages, fits):
    """d 256 takes 64-row kv tiles: a K+V slot is 64 KB, so three slots fit
    227 KB beside the 32 KB swizzled Q tile (four do not), and the plan
    takes three.  gemma3's chunk at one slot (b·h 1·8) is 32 blocks."""
    assert tplan.attention_bk(256) == 64
    assert (tplan.attention_launch_smem(256, stages) <= tplan.SMEM_BYTES) == fits
    assert tplan.attention_launch_smem(256, stages) == (
        tplan.ATTN_ALIGN + stages * 2 * 64 * 256 * 2 + 64 * 256 * 2 + 16 * stages)
    geo = tplan.attention_launch_geometry(256, 1024, 256, 1, 8, 4)
    assert (geo["stages"], geo["blocks"], geo["bk"]) == (3, 32, 64)


@pytest.mark.parametrize("d", [16, 32])
def test_attention_geometry_refuses_unbuilt_head_dims(d):
    with pytest.raises(ValueError):
        tplan.attention_launch_geometry(256, 1024, d, 1, 32, 8)
