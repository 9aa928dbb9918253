"""The kinds of model (``kinds/``): each module gives the harness what it
knows of its kind, and a new kind is added as modules alone.

The weights, FLOP counts and roofline readings of the two kinds are pinned
to the values the harness gave before it read them from ``kinds/``: the
same draws in the same order, the same integer counts, the same formulas
on the same widths."""
from __future__ import annotations

import hashlib
import json
import sys
import time
import types
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import kinds  # noqa: E402
import reference  # noqa: E402
import tiny  # noqa: E402
from harness import check, runner, weights, work  # noqa: E402
from harness.cell import Cell, arch_config, as_run  # noqa: E402
from harness.serving import Server  # noqa: E402

INTERFACE = ("port_keys", "layers", "matmul_params", "attention", "mlp_widths", "scan_widths",
             "tiny")

# SHA-256 over every leaf of weights.make(tiny.config(kind, dtype), 11, "cpu"):
# its name, dtype, shape and bytes, in the tree's order
DIGESTS = {
    ("dense_gqa", "bfloat16"): "239b14942c1984ec8a6ceac4ab1959a1df457574244e1eb579e82813f663dc7b",
    ("dense_gqa", "float32"): "1d6e1882392453c4d1eef5db4d20a99f1580b02f7d5faf0a82582a249c48acfb",
    ("mamba1", "bfloat16"): "e002ad4be601eb31f4ebae68e8156d636af5196c71ad90b3b3fb1dbe4f5dd59d",
    ("mamba1", "float32"): "f3ace6434f62e32029a5d0e5affc0011cfd4b0793296624c6244ba536ade4db3",
}

# matmul_params, forward_flops(1000, 256), forward_flops(3000, 1), train_flops(2, 4096)
FLOPS = {
    "granite_3_2b": (2533365760, 1391748710400.0, 6050099200.0, 141016694784000.0),
    "falcon_mamba_7b": (6994001920, 3580928983040.0, 13988003840.0, 343769182371840.0),
}

# (matmul_roofline.docqa, scan_gate_roofline.docqa) on the record of ``traced_rec``
ROOFLINES = {
    "granite_3_2b": (33.89645023662177, None),
    "falcon_mamba_7b": (None, 35.93625643052344),
}


def digest(tree) -> str:
    h = hashlib.sha256()
    for name, t in zip(weights.leaf_names(tree), weights.leaves(tree)):
        t = t.detach().cpu().contiguous()
        h.update(f"{name} {t.dtype} {tuple(t.shape)}\n".encode())
        h.update(t.view(torch.uint8).numpy().tobytes())
    return h.hexdigest()


def config(name):
    return as_run(json.loads((HERE / "configs" / f"{name}.json").read_text()))


def traced_rec(cfg):
    """A traced slice: A's and C's launches, and four ticks' prefilled rows."""
    ticks = [(0, 1, False, [(0, 256)]), (1, 2, False, []), (2, 3, False, [(256, 100), (0, 7)]),
             (3, 4, False, [(0, 10)])]
    L = cfg["num_hidden_layers"]
    return {"config": cfg, "mix": {"chunk": 256}, "trace_ticks": ticks,
            "trace": {"kernels": {"matmul_kernel<2>": (120, 0.0041),
                                  "scan_kernel": (2 * L, 0.0213)}}}


@pytest.fixture
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("kind, dtype", sorted(DIGESTS))
def test_weights_are_drawn_as_before(kind, dtype):
    assert digest(weights.make(tiny.config(kind, dtype), 11, "cpu")) == DIGESTS[kind, dtype]


@pytest.mark.parametrize("name", sorted(FLOPS))
def test_flop_counts_are_as_before(name):
    cfg = config(name)
    got = (work.matmul_params(cfg), work.forward_flops(cfg, 1000, 256),
           work.forward_flops(cfg, 3000, 1), work.train_flops(cfg, 2, 4096))
    assert got == FLOPS[name]


@pytest.mark.parametrize("name", sorted(ROOFLINES))
def test_roofline_readers_read_as_before(name):
    rec = traced_rec(config(name))
    got = tuple(runner.reader(m)(rec) for m in ("matmul_roofline.docqa",
                                                "scan_gate_roofline.docqa"))
    assert got == ROOFLINES[name]


@pytest.mark.parametrize("kind", kinds.names())
def test_every_kind_gives_the_interface(kind):
    mod = kinds.kind(kind)
    assert all(callable(getattr(mod, f, None)) for f in INTERFACE)
    for dtype in ("bfloat16", "float32"):
        cfg = mod.tiny(dtype)
        assert cfg["reference"] == kind and cfg["torch_dtype"] == dtype
        assert tiny.config(kind, dtype) == cfg
    arch = arch_config(cfg)                       # raises where the port's keys disagree
    assert set(mod.port_keys(arch)) <= set(cfg)
    tree = weights.make(cfg, 1, "cpu")
    assert len(tree["layers"]) == cfg["num_hidden_layers"]
    assert 0 < mod.matmul_params(cfg) < sum(t.numel() for t in weights.leaves(tree))
    layers, heads, hd = mod.attention(cfg)
    assert (layers == heads == hd == 0) or min(layers, heads, hd) > 0
    for widths in (mod.mlp_widths(cfg), mod.scan_widths(cfg)):
        assert widths is None or all(w > 0 for w in widths)
    assert callable(reference.model(kind).logits)


def probe_modules():
    """A kind ``probe`` as module objects alone: dense_gqa's functions under
    another name, in ``kinds`` and in ``reference``."""
    dense, dense_ref = kinds.kind("dense_gqa"), reference.model("dense_gqa")
    kind = types.ModuleType("kinds.probe")
    vars(kind).update({k: v for k, v in vars(dense).items() if not k.startswith("__")})
    kind.tiny = lambda dtype: {**dense.tiny(dtype), "reference": "probe"}
    ref = types.ModuleType("reference.probe")
    vars(ref).update({k: v for k, v in vars(dense_ref).items() if not k.startswith("__")})
    return {"kinds.probe": kind, "reference.probe": ref}


def test_a_kind_added_as_modules_alone(monkeypatch, few_threads):
    for name, mod in probe_modules().items():
        monkeypatch.setitem(sys.modules, name, mod)
    assert "probe" not in kinds.names()            # no file of perfbench/ was added
    cfg = tiny.config("probe", "float32")
    assert cfg["reference"] == "probe"
    dense = tiny.config("dense_gqa", "float32")
    assert digest(weights.make(cfg, 11, "cpu")) == DIGESTS["dense_gqa", "float32"]
    assert work.forward_flops(cfg, 30, 8) == work.forward_flops(dense, 30, 8)
    rec = traced_rec(cfg)
    assert runner.reader("matmul_roofline.docqa")(rec) \
        == runner.reader("matmul_roofline.docqa")(traced_rec(dense))
    # a closed-loop cell of it, served by the engine and checked against its reference
    srv = Server(Cell("tiny", cfg, tiny.mix(), 1, "tiny", "closed"), 21, torch.device("cpu"),
                 time.perf_counter(), lambda m: None)
    got = check.serve(srv.drive(0.6), 21, torch.device("cpu"), 3, control=True)
    assert got["requests"] == 3 and got["tokens"] > 10
    assert got["logit_gap"] < 1e-4 and got["agree"] == 1.0
    assert got["control_gap"] > 1e-2


def test_an_unknown_kind_names_the_files_to_add(few_threads):
    files = r"kinds/no_such_kind\.py.*reference/no_such_kind\.py"
    with pytest.raises(ValueError, match=files):
        tiny.config("no_such_kind")
    cfg = {**tiny.config("dense_gqa", "float32"), "reference": "no_such_kind"}
    with pytest.raises(ValueError, match=files):
        Server(Cell("tiny", cfg, tiny.mix(), 1, "tiny", "closed"), 21, torch.device("cpu"),
               time.perf_counter(), lambda m: None)
    with pytest.raises(ValueError, match=files):
        weights.make(cfg, 1, "cpu")
    with pytest.raises(ValueError, match=files):
        work.matmul_params(cfg)
