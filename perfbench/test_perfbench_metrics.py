"""Each metric reader on a hand-made record and trace."""
from __future__ import annotations

import json
import sys
from pathlib import Path
from types import SimpleNamespace as NS

import pytest

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

from harness import runner, trace, work  # noqa: E402


def config(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())


def live(plen, due, times, done=None):
    return NS(spec=NS(plen=plen, new=len(times), idx=0), due=due, times=times,
              done_t=done, req=NS(generated=[0] * len(times)))


def serve_rec(cfg="granite_3_2b", tr=None, traced=()):
    reqs = [live(1000, 9.0, [10.5, 10.6, 10.8], 10.8),
            live(2000, 12.0, [12.2, 12.3, 25.0]),
            live(3000, 19.0, [21.0])]
    return {"kind": "serve", "window": (10.0, 20.0), "requests": reqs, "done": reqs[:1],
            "ticks": [(9.5, 10.5, False, [(0, 1000)]), (10.5, 10.6, False, []),
                      (11.0, 12.2, False, [(0, 2000)]), (19.9, 20.3, False, [(0, 3000)])],
            "at_open": {"ticks_decode": 5, "capture_s": 1.0, "keys": 40},
            "at_close": {"ticks_decode": 8, "capture_s": 1.75, "keys": 43},
            "setup_s": 31.5, "plan_s": 1.25, "config": config(cfg),
            "mix": {"chunk": 256}, "trace": tr, "trace_ticks": list(traced)}


def read(name, rec):
    return runner.reader(name)(rec)


def test_latency_and_rate_readers():
    rec = serve_rec()
    # gaps with both ends in the window: 100, 200 (first) and 100 (second)
    assert read("itl_p99_ms", rec) == pytest.approx(100 + 0.98 * 100)
    # prompts 1000 + 2000 prefilled by ticks that ended in the window, and 5
    # tokens, over 10 s
    assert read("tok_s", rec) == pytest.approx(300.5)
    assert read("setup_s", rec) == 31.5 and read("plan_s", rec) == 1.25
    # 3 tokens decoded (5 generated, 2 first) over 3 decode ticks
    assert read("batch_mean.docqa", rec) == pytest.approx(1.0)
    assert read("train_tok_s", rec) is None


def test_prefill_accounting_per_tick():
    from harness.serving import prefill_chunks
    # slot 0 advanced a chunk, slot 1 took a new request (its position fell) and
    # prefilled 100 rows of it, slot 2 decoded
    assert prefill_chunks([256, 3000, 700], [512, 100, 700]) == [(256, 256), (0, 100)]
    assert prefill_chunks(None, [1]) is None
    rec = serve_rec()
    rec["ticks"] = [(9.5, 10.5, False, [(0, 256)]), (10.5, 10.6, False, [(256, 256)]),
                    (19.9, 20.3, False, [(512, 256)])]
    # the last tick ends outside the window
    assert read("tok_s", rec) == pytest.approx((512 + 5) / 10)
    g = rec["config"]
    flops = work.forward_flops(g, 0, 256) + work.forward_flops(g, 256, 256) \
        + work.forward_flops(g, 1000, 1) \
        + work.forward_flops(g, 1001, 1) + work.forward_flops(g, 2000, 1)
    assert read("mfu.docqa", rec) == pytest.approx(100 * flops / (0.7 * 989e12))


def test_mfu_reader():
    rec = serve_rec()
    g = rec["config"]
    flops = (work.forward_flops(g, 0, 1000) + work.forward_flops(g, 1000, 1)
             + work.forward_flops(g, 1001, 1) + work.forward_flops(g, 0, 2000)
             + work.forward_flops(g, 2000, 1))
    # tick walls inside the window: 0.5 + 0.1 + 1.2 + 0.1 s
    assert read("mfu.docqa", rec) == pytest.approx(100 * flops / (1.9 * 989e12))


def test_no_prefill_positions_no_rate():
    rec = serve_rec()
    rec["ticks"] = [(10.5, 10.6, False, None)]
    assert read("tok_s", rec) is None and read("mfu.docqa", rec) is None
    assert read("batch_mean.docqa", rec) is None


def test_trace_readers():
    dev = [(0, 100, "void repro::(anonymous namespace)::matmul_kernel<2>(CUtensorMap)"),
           (100, 300, "void repro::(anonymous namespace)::matmul_kernel<2>(CUtensorMap)"),
           (500, 900, "ampere_bf16_s16816gemm"),
           (950, 1000, "void repro::(anonymous namespace)::scan_kernel(float const*)")]
    spans = [(0, 1000, "bench.slice"), (0, 450, "bench.tick"), (450, 480, "bench.stamp"),
             (480, 1000, "bench.tick")]
    red = trace.reduce_events(dev, spans, [False, True])
    assert red["busy_s"] == pytest.approx(750e-6) and red["window_s"] == pytest.approx(1e-3)
    assert red["kernels"]["matmul_kernel<2>"] == (2, pytest.approx(300e-6))
    # idle 300-500 in the first tick and 900-950 in the second, which captured
    assert red["idle"] == {"tick": pytest.approx(200e-6), "tick+capture": pytest.approx(50e-6)}
    bd = trace.breakdown(red)
    assert bd["device_ops"][0][0] == "ampere_bf16_s16816gemm"
    rec = serve_rec(tr=red)
    assert read("idle_share.docqa", rec) == pytest.approx(25.0)
    each = work.matmul_bound_s(256, 2048, 8192)
    assert read("matmul_roofline.docqa", rec) == pytest.approx(100 * 2 * each / 300e-6)
    assert read("scan_gate_roofline.docqa", rec) is None
    fal = serve_rec("falcon_mamba_7b", tr=dict(red, kernels={"scan_kernel": (128, 0.02)}),
                    traced=[(0, 1, False, [(0, 256)]), (1, 2, False, []),
                            (2, 3, False, [(256, 100)]), (3, 4, False, [(0, 10)])])
    least = 64 * (work.scan_gate_bound_s(256, 8192, 16) + work.scan_gate_bound_s(100, 8192, 16))
    assert read("scan_gate_roofline.docqa", fal) == pytest.approx(100 * least / 0.02)
    assert read("matmul_roofline.docqa", fal) is None


def test_readers_find_nothing_where_nothing_is():
    rec = serve_rec()
    for name in ("idle_share.docqa", "matmul_roofline.docqa", "scan_gate_roofline.docqa"):
        assert read(name, rec) is None


def test_every_listed_metric_has_a_reader():
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(runner.reader(m["name"]))
