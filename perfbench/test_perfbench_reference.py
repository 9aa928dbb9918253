"""The reference at a small size on the CPU, held against the port's plain
path on the same weights in float32: the full forward, and the engine's
chunked prefill and decode ticks as the harness drives and checks them."""
from __future__ import annotations

import sys
import time
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import tiny  # noqa: E402
import kinds  # noqa: E402
from harness import check, weights  # noqa: E402
from harness.cell import Cell, arch_config  # noqa: E402
from harness.serving import Server  # noqa: E402
from reference import model  # noqa: E402
from reference.common import Prec  # noqa: E402

KINDS = kinds.names()


@pytest.fixture(autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind", KINDS)
def test_reference_matches_the_port_forward(kind):
    from repro_torch.model import transformer as T

    cfg = tiny.config(kind, "float32")
    params = weights.make(cfg, 11, "cpu")
    toks = torch.randint(2, 512, (70,), generator=torch.Generator().manual_seed(3))
    want, _ = T.forward(params, arch_config(cfg), toks[None])
    rows = list(range(70))
    got = model(kind).logits(params, cfg, toks, rows)
    torch.testing.assert_close(got, want[0], atol=2e-5, rtol=2e-5)
    if hasattr(model(kind), "batch_logits"):
        # the batched form, with a shorter sequence padded on the right
        two = torch.stack([toks, torch.cat([toks[:50], toks[:20]])])
        a, b = model(kind).batch_logits(params, cfg, two, [rows, list(range(50))])
        torch.testing.assert_close(a, want[0], atol=2e-5, rtol=2e-5)
        torch.testing.assert_close(b, want[0, :50], atol=2e-5, rtol=2e-5)


@pytest.mark.parametrize("kind", KINDS)
def test_engine_served_tokens_agree_with_the_reference(kind):
    """f32 weights through the engine (chunked prefill over several chunks,
    decode ticks, state carried): every served token is the reference's
    choice, up to f32 rounding."""
    cfg = tiny.config(kind, "float32")
    srv = Server(Cell("tiny", cfg, tiny.mix(), 1, "tiny", "closed"), 21, torch.device("cpu"),
                 time.perf_counter(), lambda m: None)
    rec = srv.drive(0.6)
    got = check.serve(rec, 21, torch.device("cpu"), 3, control=True)
    assert got["requests"] == 3 and got["tokens"] > 10
    assert got["logit_gap"] < 1e-4 and got["agree"] == 1.0
    # the fp8 control reads well above rounding at the same positions
    assert got["control_gap"] > 1e-2


def test_fp8_rounding():
    from reference.common import fp8
    x = torch.tensor([[1.0, 0.3, -448.0], [2.0, 0.0, 1e-3]])
    y = fp8(x, -1)
    assert torch.equal(y[0, 2], torch.tensor(-448.0))
    assert torch.allclose(y, x, rtol=0.07, atol=2e-3)
    assert Prec("fp8").mm(x, torch.eye(3)).shape == (2, 3)
