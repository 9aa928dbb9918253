"""The port's tracer (``repro_torch.spans``) and the spans of the serving
engine and the train step, on the CPU.

Recording is off by default and on inside ``recording()`` or while a
``torch.profiler`` session runs; each stretch of recording is a session
of its own, kept in a bounded buffer.  In the engine the tick spans'
kinds follow its tick counters, the chunk spans' rows add up to the
prompts, a request's spans carry its ``rid`` under its ticks, and its
stamps run in order.  No span enters the profiler's trace.  On the CPU a
span's device interval is its host interval."""
from __future__ import annotations

import json
from collections import Counter, defaultdict
from contextlib import nullcontext

import pytest
import torch
from torch.profiler import profile

from repro_torch import spans
from repro_torch.configs.registry import get_arch
from repro_torch.launch import serve as tserve
from repro_torch.model import transformer as T
from repro_torch.optim import adamw
from repro_torch.spans import Tracer
from repro_torch.train.steps import make_train_step
from repro_torch.tree import leaves

torch.set_num_threads(1)

CPU = torch.device("cpu")
ARCHS = {"granite_3_2b": get_arch("granite_3_2b").smoke().scaled(dtype="float32"),
         "falcon_mamba_7b": get_arch("falcon_mamba_7b").smoke().scaled(dtype="float32")}
PLENS = [19, 7, 33, 12, 26]


def names(session):
    return [s["name"] for s in session["spans"]]


def test_off_records_nothing():
    t = Tracer()
    assert not t.on()
    with t.span("a", CPU, rows=3) as sp:
        sp.set(kind="x")
    assert t.last_session() is None


def test_recording_and_the_profiler_each_record_a_session():
    t = Tracer()
    with t.recording():
        assert t.on()
        with t.span("a"):
            pass
    assert names(t.last_session()) == ["a"]
    with t.span("off"):
        pass
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert t.on()
        with t.span("b"):
            pass
        with t.span("c", CPU):
            pass
    got = t.last_session()
    assert names(got) == ["b", "c"]
    b, c = got["spans"]
    assert "d0" not in b and (c["d0"], c["d1"]) == (c["t0"], c["t1"])
    # a span after the profiler stopped ends the session; the next one
    # starts afresh
    with t.span("off"):
        pass
    assert names(t.last_session()) == ["b", "c"]
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        with t.span("d"):
            pass
    assert names(t.last_session()) == ["d"]


def test_parents_nest_and_attributes_stick():
    t = Tracer()
    with t.recording():
        with t.span("root", kind="a") as r:
            with t.span("child", CPU, rid=7):
                with t.span("leaf", rid=7):
                    pass
            with t.span("sibling"):
                pass
            r.set(kind="b")
        with t.span("root2"):
            pass
    got = {s["name"]: s for s in t.last_session()["spans"]}
    assert got["root"]["parent"] == got["root2"]["parent"] == -1
    assert got["child"]["parent"] == got["sibling"]["parent"] == got["root"]["id"]
    assert got["leaf"]["parent"] == got["child"]["id"]
    assert got["root"]["attrs"] == {"kind": "b"} and got["leaf"]["attrs"] == {"rid": 7}
    assert got["root"]["t0"] <= got["child"]["t0"] <= got["leaf"]["t0"] \
        <= got["leaf"]["t1"] <= got["child"]["t1"] <= got["sibling"]["t0"] <= got["root"]["t1"]


def test_buffer_stays_within_its_bound():
    t = Tracer(cap=5)
    with t.recording():
        for i in range(4):
            with t.span("outer", i=i):
                with t.span("inner", i=i):
                    pass
    got = t.last_session()
    assert len(got["spans"]) == 5 and got["dropped"] == 3
    assert [(s["name"], s["parent"]) for s in got["spans"]] == [
        ("outer", -1), ("inner", 0), ("outer", -1), ("inner", 2), ("outer", -1)]
    with t.recording():
        with t.span("again"):
            pass
    assert t.last_session()["dropped"] == 0


def test_gaps_are_labelled_by_the_innermost_host_span():
    def sp(i, name, parent, t0, t1, dev=None):
        s = {"id": i, "name": name, "parent": parent, "t0": t0, "t1": t1, "attrs": {}}
        if dev:
            s["d0"], s["d1"] = dev
        return s
    got = spans.label_gaps([
        sp(0, "tick", -1, 0.0, 10.0), sp(1, "replay", 0, 1.0, 2.0, (1.5, 4.0)),
        sp(2, "wait", 0, 2.0, 6.0), sp(3, "tick", -1, 12.0, 15.0),
        sp(4, "replay", 3, 12.0, 13.0, (12.0, 14.0))])
    # 0-1 in the tick, 1-1.5 in the replay's host span, 4-6 waiting, 6-10 in
    # the tick, 10-12 outside both ticks, 14-15 in the second
    assert got == {"tick": pytest.approx(1.0 + 4.0 + 1.0), "replay": pytest.approx(0.5),
                   "wait": pytest.approx(2.0), spans.OUTSIDE: pytest.approx(2.0)}


# ---------------------------------------------------------------------------
# the engine
# ---------------------------------------------------------------------------

def engine(arch, sync, graphs=False, batch=2, gen=5):
    cfg = ARCHS[arch]
    eng = tserve.ContinuousEngine(cfg, T.init_params(cfg, seed=0, device=CPU), batch, 64,
                                  chunk=8, max_new=gen, page=16, sync=sync)
    if graphs:
        # the graph path as the CPU can have it: a replay reruns the body
        class Graph:
            def __init__(self, kv, c):
                self.kv, self.c = kv, c

            def replay(self):
                eng._step(self.kv, self.c)
        eng._side_stream = nullcontext
        eng._record = lambda kv, c: Graph(kv, c)
        eng._cuda_graphs = True
    return eng


def served(eng, context=None):
    vocab = eng.cfg.vocab
    reqs = [tserve.Request(i, torch.randint(2, vocab, (1, n),
                                            generator=torch.Generator().manual_seed(i)))
            for i, n in enumerate(PLENS)]
    with context or spans.recording():
        for r in reqs:
            eng.submit(r)
        eng.run()
    return reqs, spans.last_session()


@pytest.mark.parametrize("sync", [False, True])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_tick_spans_follow_the_engine_counters(arch, sync):
    eng = engine(arch, sync)
    reqs, got = served(eng)
    by_id = {s["id"]: s for s in got["spans"]}
    ticks = [s for s in got["spans"] if s["name"] == "serve.tick"]
    kinds = Counter(s["attrs"]["kind"] for s in ticks)
    # a decode_k tick counts its k decode steps, each a decode span under it
    decodes = Counter(s["parent"] for s in got["spans"] if s["name"] == "serve.decode")
    k_steps = sum(decodes[s["id"]] for s in ticks if s["attrs"]["kind"] == "decode_k")
    assert kinds["idle"] == 1                       # run() stops at a tick with no work
    assert len(ticks) - 1 - kinds["decode_k"] + k_steps == eng.ticks
    assert kinds["decode"] + kinds["mixed"] + k_steps == eng.ticks_decode
    assert kinds["chunk"] + kinds["mixed"] == eng.ticks_prefill
    assert kinds["mixed"] == eng.ticks_overlap
    assert (kinds["decode_k"] > 0) is (not sync)
    # every chunk's rows, by request, add up to its prompt
    rows = defaultdict(int)
    for s in got["spans"]:
        if s["name"] == "serve.chunk":
            rows[s["attrs"]["rid"]] += s["attrs"]["rows"]
    assert dict(rows) == {r.rid: r.prompt.shape[1] for r in reqs}
    # a request's spans carry its rid, each under a tick
    for r in reqs:
        mine = [s for s in got["spans"] if s["attrs"].get("rid") == r.rid]
        assert Counter(s["name"] for s in mine)["serve.admit"] == 1
        assert Counter(s["name"] for s in mine)["serve.retire"] == 1
        assert {s["name"] for s in mine} == {"serve.admit", "serve.stage", "serve.chunk",
                                             "serve.retire"}
        for s in mine:
            top = s
            while top["parent"] != -1:
                top = by_id[top["parent"]]
            assert top["name"] == "serve.tick" and top["t0"] <= s["t0"] <= s["t1"] <= top["t1"]
    # on the CPU every device interval is its span's host interval
    dev = [s for s in got["spans"] if "d0" in s]
    assert {s["name"] for s in dev} == {"serve.admit", "serve.stage", "serve.chunk",
                                        "serve.decode"}
    assert all((s["d0"], s["d1"]) == (s["t0"], s["t1"]) for s in dev)
    assert ("serve.wait" in names(got)) is sync


@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_request_stamps_run_in_order(arch):
    reqs, _ = served(engine(arch, True), nullcontext())
    for r in reqs:
        assert len(r.token_times) == len(r.generated) == 5
        assert 0 < r.t_submit <= r.t_admit <= r.t_prefill <= r.token_times[0]
        assert r.token_times == sorted(r.token_times)
        assert not hasattr(r, "t_first")


def test_replay_spans_follow_the_captures():
    """On the graph path a capture is a span of its own beside the replay
    span that follows it, and every replay is a decode or chunk span."""
    eng = engine("granite_3_2b", True, graphs=True)
    _, got = served(eng)
    caps = [s for s in got["spans"] if s["name"] == "serve.capture"]
    assert len(caps) == len(eng.graphs) + len(eng.chunk_graphs) > 0
    replays = sum(g.replays for g in [*eng.graphs.values(), *eng.chunk_graphs.values()])
    assert replays == sum(1 for s in got["spans"] if s["name"] in ("serve.decode", "serve.chunk"))
    by_id = {s["id"]: s for s in got["spans"]}
    for s in caps:
        assert by_id[s["parent"]]["name"] == "serve.tick"
        after = [x for x in got["spans"] if x["parent"] == s["parent"] and x["t0"] >= s["t1"]]
        assert after[0]["name"] in ("serve.decode", "serve.chunk")


def test_no_span_enters_the_profilers_trace():
    eng = engine("granite_3_2b", True)
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        reqs, got = served(eng, nullcontext())
    assert {"serve.tick", "serve.admit", "serve.chunk", "serve.decode",
            "serve.wait"} <= set(names(got))
    assert not [e.name for e in prof.events() if e.name.startswith(("serve.", "train."))]
    assert all(r.done for r in reqs)


def test_train_step_phases():
    cfg = ARCHS["granite_3_2b"]
    params = T.init_params(cfg, seed=0, device=CPU)
    for p in leaves(params):
        p.requires_grad_(True)
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=0)
    state = adamw.init(params)
    step = make_train_step(cfg, opt, 2)
    tok = torch.randint(2, cfg.vocab, (4, 17), generator=torch.Generator().manual_seed(0))
    batch = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    with profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(2):
            params, state, _ = step(params, state, batch)
    got = spans.last_session()["spans"]
    assert not [e.name for e in prof.events() if e.name.startswith("train.")]
    steps = [s for s in got if s["name"] == "train.step"]
    assert len(steps) == 2 and all(s["parent"] == -1 for s in steps)
    for st in steps:
        kids = [s for s in got if s["parent"] == st["id"]]
        assert [(s["name"], s["attrs"].get("micro")) for s in kids] == [
            ("train.forward", 0), ("train.backward", 0), ("train.forward", 1),
            ("train.backward", 1), ("train.adamw", None)]
        assert all(st["t0"] <= s["d0"] <= s["d1"] <= st["t1"] for s in kids)


def test_serve_cli_writes_a_chrome_trace(tmp_path, capsys):
    path = tmp_path / "trace.json"
    tserve.main(["--smoke", "--device", "cpu", "--batch", "2", "--prompt-len", "9",
                 "--gen", "3", "--chunk", "8", "--trace", str(path)])
    assert f"written to {path}" in capsys.readouterr().out
    trace = json.loads(path.read_text())
    ev = [e for e in trace["traceEvents"] if e["ph"] == "X"]
    host = Counter(e["name"] for e in ev if e["tid"] == 0)
    device = Counter(e["name"] for e in ev if e["tid"] == 1)
    assert host["serve.tick"] >= 3 and host["serve.chunk"] == 4
    assert device["serve.chunk"] == 4 and "serve.tick" not in device
    assert all(e["dur"] >= 0 and e["ts"] >= 0 for e in ev)
    assert set(trace["otherData"]) == {"dropped", "gaps_s"}
