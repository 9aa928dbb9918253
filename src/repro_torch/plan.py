"""The card's side of the kernel plans: constants, shared-memory formulas
and launch geometry of the kernels in ``csrc/``.

The plans themselves come from the port's PolyTOPS scheduler:
:mod:`repro_torch.core.akg` builds each operator's SCoP, schedules it
(tensor style, through the degradation ladder and the schedule cache;
the fused scan+gate ranks its legal schedule bases first), builds the
schedule tree and lowers it to a :class:`KernelPlan` — loop order and
vector iterator from the tree, tiles fitted to the card.  This module
re-exports ``KernelPlan`` and the ``plan_*`` functions, so callers plan
through it.

What the tiles are fitted to, besides a block's shared memory:

* every edge is a multiple of 16 (bf16 tensor-core fragments are 16 deep);
* matmul (``csrc/matmul.cu``, TMA and wgmma): ``i`` a multiple of 64 (one
  consumer warpgroup per 64 rows; the kernel is built for 64 and 128),
  ``j`` a multiple of 8 up to 256 (wgmma's n; built for 128), ``kk`` = 64
  (one 128-byte swizzle row of bf16); the f32 accumulator tile stays
  ≤ 64 KB of registers.  The split of K and the depth of the load ring
  are launch geometry of the card, not part of the tile:
  :func:`matmul_launch_geometry`;
* attention: ``d`` whole (a thread's row of the output spans the head),
  ``q`` and ``kk`` powers of two in [16, 128]; Q, K and V tiles fit
  shared memory.  The serving engine sizes its KV pages by ``kk``.  How
  ``csrc/flash_attention.cu`` (TMA and wgmma) launches on the card — 64
  query rows per block, 128 kv rows per tile (64 at head dim 256, where
  a 128-row K and V slot would leave no room for a second one) and the
  depth of the load ring — is launch geometry:
  :func:`attention_launch_geometry`;
* the two scans (:func:`scan_tile`): ``n`` whole (the state lanes of one
  channel are neighbouring threads of one warp and reduce by shuffles),
  ``d`` fills a thread block of ``SCAN_THREADS`` threads (one thread per
  ``h[d, n]``) and ``t`` is the number of time steps whose ``c`` rows the
  block stages in shared memory at a time (at most 128).
"""
from __future__ import annotations

import functools
from typing import Dict

from .core.akg import (KernelPlan, plan_attention, plan_mamba_scan,  # noqa: F401
                       plan_matmul, plan_scan_gate)

SMEM_BYTES = 227 * 1024        # shared memory one block may use on H100
ACC_BYTES = 64 * 1024          # f32 accumulator tile a block keeps in registers
EDGE = 16                      # bf16 tensor-core fragment depth
PAD = 8                        # shared-memory row padding (elements) in csrc/
SMS = 132                      # streaming multiprocessors of an H100 SXM
MATMUL_I = (64, 128)           # consumer warpgroups × 64 rows
MATMUL_J = (128,)              # wgmma n
MATMUL_KK = 64                 # one 128-byte swizzle row of bf16
#: (i, j, kk) tiles ``csrc/matmul.cu`` is instantiated for
MATMUL_TILES = frozenset((i, j, MATMUL_KK) for i in MATMUL_I for j in MATMUL_J)
MATMUL_SPLITS = (1, 2, 4)      # K splits
MATMUL_MIN_KTILES = 4          # k tiles each split keeps at least
MATMUL_STAGES = 5              # depth of the TMA load ring
MATMUL_ALIGN = 1024            # the ring's alignment slack (swizzle atom)
MATMUL_EPI_PAD = 8             # f32 row padding of the staged tile
POW2 = (16, 32, 64, 128)
ATTN_ROWS = 64                 # query rows of a block: one consumer warpgroup
ATTN_HEAD_DIMS = (64, 128, 256)  # head dims csrc/flash_attention.cu is built for
ATTN_STAGES = 3                # depth of the K/V load ring
ATTN_ALIGN = 1024              # the ring's alignment slack (swizzle atom)
SCAN_THREADS = 512             # threads of a scan block: d tile × state
WARP = 32


def matmul_ring_bytes(tile: Dict[str, int], stages: int = MATMUL_STAGES) -> int:
    """Shared memory of the load ring: ``stages`` bf16 A and B tiles."""
    i, j, kk = tile["i"], tile["j"], tile["kk"]
    return stages * (i * kk + kk * j) * 2


def matmul_epilogue_bytes(tile: Dict[str, int]) -> int:
    """The f32 tile the epilogue stages over the ring."""
    return tile["i"] * (tile["j"] + MATMUL_EPI_PAD) * 4


def matmul_smem_bytes(tile: Dict[str, int], stages: int = MATMUL_STAGES) -> int:
    """Dynamic shared memory of one block (``Geometry::smem_bytes`` in
    ``csrc/matmul.cu``): the alignment slack, the ring or the staged f32
    tile over it, whichever is larger, two mbarriers per stage and a
    flag."""
    return (MATMUL_ALIGN + max(matmul_ring_bytes(tile, stages),
                               matmul_epilogue_bytes(tile)) + 16 * stages + 16)


def attention_smem_bytes(tile: Dict[str, int],
                         bytes_per_elem: int = 2) -> int:
    q, kk, d = tile["q"], tile["kk"], tile["d"]
    return (q + 2 * kk) * (d + PAD) * bytes_per_elem


@functools.lru_cache(maxsize=64)
def matmul_launch_geometry(m: int, n: int, k: int) -> Dict[str, int]:
    """How ``csrc/matmul.cu`` launches the planned tile on an H100.

    ``split``: the largest K split in :data:`MATMUL_SPLITS` that keeps
    the grid within one wave of :data:`SMS` blocks (one block per SM),
    divides the k tiles and leaves each split at least
    :data:`MATMUL_MIN_KTILES` of them.  ``stages``: the ring depth,
    :data:`MATMUL_STAGES` or fewer if a block's shared memory would not
    fit.  Also returns ``blocks``, ``smem`` (bytes per block) and
    ``workspace`` (f32 elements of the split partials, 0 without a
    split).
    """
    tile = plan_matmul(m, n, k).tile
    tiles = -(-m // tile["i"]) * -(-n // tile["j"])
    ktiles = -(-k // tile["kk"])
    split = max(s for s in MATMUL_SPLITS
                if s == 1 or (tiles * s <= SMS and ktiles % s == 0
                              and ktiles // s >= MATMUL_MIN_KTILES))
    stages = MATMUL_STAGES
    while matmul_smem_bytes(tile, stages) > SMEM_BYTES and stages > 1:
        stages -= 1
    workspace = split * tiles * tile["i"] * tile["j"] if split > 1 else 0
    return {"split": split, "stages": stages, "blocks": tiles * split,
            "smem": matmul_smem_bytes(tile, stages), "workspace": workspace}


def attention_bk(d: int) -> int:
    """Kv rows per flash tile, the n of S = Q·Kᵀ (``Geometry::BK``): 128,
    or 64 at head dims above 128, where one K and V slot of 128 rows is
    128 KB."""
    return 64 if d > 128 else 128


def attention_launch_smem(d: int, stages: int) -> int:
    """Dynamic shared memory of one flash block (``Geometry::smem_bytes``
    in ``csrc/flash_attention.cu``): the alignment slack, ``stages`` slots
    of a bf16 K and V tile, the Q rows (padded at d ≤ 128, where they
    are staged for register fragments; swizzled, unpadded above, where
    wgmma reads them in place) and two mbarriers per stage."""
    q_row = d if d > 128 else d + PAD
    return (ATTN_ALIGN + stages * 2 * attention_bk(d) * d * 2 + ATTN_ROWS * q_row * 2
            + 16 * stages)


@functools.lru_cache(maxsize=256)
def attention_launch_geometry(sq: int, sk: int, d: int, b: int, h: int,
                              hkv: int) -> Dict[str, int]:
    """How ``csrc/flash_attention.cu`` launches causal attention of ``sq``
    query rows over ``sk`` kv rows, ``b``·``h`` heads (``hkv`` kv heads),
    head dim ``d``, on an H100: one block per :data:`ATTN_ROWS` query rows
    of a head (128 blocks for one slot's 256-row chunk at 32 heads, 32 at
    gemma3's 8), each walking its kv tiles of :func:`attention_bk` rows.
    ``stages``: the ring depth, :data:`ATTN_STAGES` or fewer if a block's
    shared memory would not fit, but at least 2 (the kernel holds one
    tile's V while the next tile's K arrives; ``chip_smoke.py``'s
    geometry sweep times each depth).  Also returns ``rows``, ``bk``,
    ``blocks`` and ``smem`` (bytes per block).  Raises ``ValueError`` for
    a head dim the kernel is not built for.
    """
    if d not in ATTN_HEAD_DIMS or h % hkv:
        raise ValueError(f"flash kernel: head dim {d} (built for "
                         f"{ATTN_HEAD_DIMS}), heads {h}/{hkv}")
    stages = ATTN_STAGES
    while attention_launch_smem(d, stages) > SMEM_BYTES and stages > 2:
        stages -= 1
    return {"rows": ATTN_ROWS, "bk": attention_bk(d), "stages": stages,
            "blocks": b * h * -(-sq // ATTN_ROWS),
            "smem": attention_launch_smem(d, stages)}


def scan_tile(seq: int, d_inner: int, state: int) -> Dict[str, int]:
    """The scan kernels' tile, their thread block: ``n`` whole; ``d`` so
    that d·n threads fill a block (rounded up to whole warps when
    ``d_inner`` is small; the kernel masks channels past ``d_inner``);
    ``t`` as the reference's tile fit starts it, at most 128."""
    per_warp = max(WARP // state, 1)
    d = min(max(SCAN_THREADS // state, 1), -(-d_inner // per_warp) * per_warp)
    return {"t": max(min(seq, 128), 1), "d": d, "n": state}
