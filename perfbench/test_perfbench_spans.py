"""The readers of the program's own spans and stamps: on hand-made tracer
sessions and requests, where they find nothing (a program without the
tracer or the stamps), and through a small traced run of each kind on
the CPU."""
from __future__ import annotations

import sys
import time
from pathlib import Path
from types import SimpleNamespace as NS

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import tiny  # noqa: E402
from harness import runner, spans  # noqa: E402
from harness.cell import Cell  # noqa: E402

SERVE = ("decode_ms.docqa", "chunk_ms.docqa", "host_gap.docqa", "prefill_wait_ms.docqa")
TRAIN = ("fwd_ms.train", "bwd_ms.train", "adamw_ms.train")


def read(name, rec):
    return runner.reader(name)(rec)


def sp(i, name, parent, t0, t1, dev=None, **attrs):
    s = {"id": i, "name": name, "parent": parent, "t0": t0, "t1": t1, "attrs": attrs}
    if dev is not None:
        s["d0"], s["d1"] = dev
    return s


def serve_session():
    """Two traced ticks after a window that closed at 20 s, and one tick
    of the window (which the readers leave out)."""
    return {"dropped": 0, "gaps": {}, "spans": [
        sp(0, "serve.tick", -1, 19.0, 19.5, kind="decode"),
        sp(1, "serve.decode", 0, 19.1, 19.2, (19.1, 19.4), rows=2, kv=128),
        sp(2, "serve.tick", -1, 21.0, 21.1, kind="mixed"),
        sp(3, "serve.admit", 2, 21.0, 21.001, (21.000, 21.002), rid=9, slot=1),
        sp(4, "serve.decode", 2, 21.002, 21.003, (21.002, 21.022), rows=2, kv=128),
        sp(5, "serve.stage", 2, 21.003, 21.004, (21.022, 21.023), rid=9),
        sp(6, "serve.chunk", 2, 21.004, 21.005, (21.023, 21.053), rid=9, rows=256, kv=512),
        sp(7, "serve.wait", 2, 21.005, 21.054),
        sp(8, "serve.tick", -1, 21.06, 21.1, kind="chunk"),
        sp(9, "serve.stage", 8, 21.06, 21.061, (21.06, 21.061), rid=9),
        sp(10, "serve.chunk", 8, 21.061, 21.062, (21.061, 21.081), rid=9, rows=100,
           kv=512),
        sp(11, "serve.decode", 8, 21.062, 21.063, (21.062, 21.102), rows=3, kv=256)]}


def train_session():
    def step(base, i, f, b, a):
        return [sp(base, "train.step", -1, i, i + 1),
                sp(base + 1, "train.forward", base, i, i + .1, (i, i + f), micro=0),
                sp(base + 2, "train.backward", base, i + .1, i + .2, (i + f, i + f + b),
                   micro=0),
                sp(base + 3, "train.adamw", base, i + .2, i + .3, (i + .8, i + .8 + a))]
    return {"dropped": 0, "gaps": {}, "spans": step(0, 5.0, .1, .2, .05)
            + step(4, 11.0, .3, .6, .07) + step(8, 13.0, .5, .8, .09)
            + step(12, 15.0, .4, .7, .11)}


def serve_rec():
    def live(admit, prefill):
        return NS(req=NS(t_admit=admit, t_prefill=prefill))
    return {"kind": "serve", "window": (10.0, 20.0), "mix": {"chunk": 256},
            "requests": [live(9.0, 10.5), live(11.0, 11.2), live(12.0, 15.0),
                         live(19.0, 20.5), live(19.5, 0.0)]}


def train_rec():
    return {"kind": "train", "window": (1.0, 10.0)}


def test_serving_readers_on_a_hand_made_session(monkeypatch):
    monkeypatch.setattr(spans, "session", serve_session)
    rec = serve_rec()
    # the traced decodes: 20 and 40 ms (the window's 300 ms is left out)
    assert read("decode_ms.docqa", rec) == pytest.approx(30.0)
    # the chunk of the mix's 256 rows, not the 100-row tail
    assert read("chunk_ms.docqa", rec) == pytest.approx(30.0)
    # ticks from 21.0 to 21.1; device busy 21.000-21.053 and 21.06-21.1
    assert read("host_gap.docqa", rec) == pytest.approx(100 * 0.007 / 0.1)
    # first chunks launched in the window: 1500, 200 and 3000 ms after admission
    assert read("prefill_wait_ms.docqa", rec) == pytest.approx(1500.0)
    for name in TRAIN:
        assert read(name, rec) is None


def test_training_readers_on_a_hand_made_session(monkeypatch):
    monkeypatch.setattr(spans, "session", train_session)
    rec = train_rec()
    # the three steps after the window (the one at 5 s is in it)
    assert read("fwd_ms.train", rec) == pytest.approx(400.0)
    assert read("bwd_ms.train", rec) == pytest.approx(700.0)
    assert read("adamw_ms.train", rec) == pytest.approx(90.0)
    for name in SERVE:
        assert read(name, rec) is None


def test_readers_find_nothing_without_the_program_s_spans(monkeypatch):
    monkeypatch.setattr(spans, "session", lambda: None)
    for name in SERVE[:3]:
        assert read(name, serve_rec()) is None
    for name in TRAIN:
        assert read(name, train_rec()) is None
    # requests without the admission and prefill stamps
    rec = dict(serve_rec(), requests=[NS(req=NS(t_submit=1.0))])
    assert read("prefill_wait_ms.docqa", rec) is None
    # a session with no tick after the window
    monkeypatch.setattr(spans, "session", lambda: {"spans": serve_session()["spans"][:2]})
    assert all(read(name, serve_rec()) is None for name in SERVE[:3])


@pytest.mark.parametrize("kind", ["dense_gqa", "mamba1", "train"])
def test_a_tiny_traced_run_reads_every_metric(kind):
    torch.set_num_threads(1)
    if kind == "train":
        cell = Cell("tiny.train", tiny.config("dense_gqa", "float32"), tiny.train_mix(), 1,
                    "tiny", "train")
        names = TRAIN
    else:
        cell = Cell("tiny.closed", tiny.config(kind), tiny.mix(), 1, "tiny", "closed")
        names = SERVE
    res = runner.execute(cell, 2**33 + 7, 0.5, True, torch.device("cpu"),
                         time.perf_counter(), lambda m: None, [],
                         [{"name": n, "unit": "ms"} for n in names])
    got = {n: res["metrics"][n]["value"] for n in names}
    assert all(v >= 0 for v in got.values()), got
    if kind != "train":
        assert got["host_gap.docqa"] < 100
