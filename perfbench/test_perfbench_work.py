"""FLOP, byte and roofline counts against values worked by hand at
granite's and falcon's published widths."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import work  # noqa: E402


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def test_peaks_are_the_data_sheet():
    pk = work.peaks()
    assert (pk["bf16_flops"], pk["f32_flops"], pk["hbm_bytes_per_s"]) == (989e12, 67e12, 3.35e12)


@pytest.mark.parametrize("name, params", [
    # 40 × (2048·2048 + 2·2048·512 + 2048·2048 + 3·2048·8192) + 49155·2048
    ("granite_3_2b", 2_533_365_760),
    # 64 × (4096·16384 + 8192·288 + 256·8192 + 8192·4096) + 65024·4096
    ("falcon_mamba_7b", 6_994_001_920),
])
def test_matmul_params(name, params):
    assert work.matmul_params(config(name)) == params


def test_attention_flops():
    g = config("granite_3_2b")
    # 4 rows from 0: 1 + 2 + 3 + 4 keys; 4 · 32 heads · 64 · 10 · 40 layers
    assert work.attn_flops(g, 0, 4) == 3_276_800
    # one decode row at position 999 reads 1000 keys
    assert work.attn_flops(g, 999, 1) == 4 * 32 * 64 * 1000 * 40
    assert work.attn_flops(config("falcon_mamba_7b"), 0, 4096) == 0
    assert work.forward_flops(g, 0, 1) == 2 * 2_533_365_760 + 4 * 32 * 64 * 40
    assert work.train_flops(g, 2, 4096) == 3 * 2 * work.forward_flops(g, 0, 4096)


def test_kernel_a_bound():
    # (256, 2048)·(2048, 8192): 2·(256·2048 + 2048·8192 + 256·8192) bytes over 3.35 TB/s
    # (11.58 µs) beats 2·256·2048·8192 FLOPs over 989 TFLOP/s (8.69 µs)
    assert work.matmul_bound_s(256, 2048, 8192) == pytest.approx(38_797_312 / 3.35e12)
    assert work.matmul_bound_s(256, 8192, 2048) == work.matmul_bound_s(256, 2048, 8192)
    # a large square product is bound by operations
    assert work.matmul_bound_s(8192, 8192, 8192) == pytest.approx(2 * 8192**3 / 989e12)


def test_kernel_c_bound():
    # a_bar, b_bar (256, 8192, 16) and C (256, 16) f32, x, z, out (256, 8192) bf16,
    # D (8192) f32, h0 and h_last (8192, 16) f32: 282 116 096 bytes
    assert work.scan_gate_bound_s(256, 8192, 16) == pytest.approx(282_116_096 / 3.35e12)
