"""A cell by name: its entry in BENCHMARK.json, its configuration file and
its traffic mix, all found by name, so a cell is added with data alone."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Any, Dict

from kinds import kind

BENCH_DIR = Path(__file__).resolve().parents[1]
ROOT = BENCH_DIR.parent


@dataclass
class Cell:
    name: str
    config: Dict[str, Any]       # the configuration file, as run (see as_run)
    mix: Dict[str, Any]          # the traffic mix file
    chips: int
    config_name: str
    traffic: str


def benchmark() -> Dict[str, Any]:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def as_run(config: Dict[str, Any]) -> Dict[str, Any]:
    """A configuration file's keys as the port runs them: the published
    top-level keys, with those under ``runs_as`` (which the port cannot be
    given) at the values it runs."""
    return {**config, **config.get("runs_as", {})}


def load(name: str) -> Cell:
    bench = benchmark()
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json: {sorted(work)}")
    w = work[name]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
    config = as_run(json.loads((ROOT / conf["file"]).read_text()))
    mix = json.loads((BENCH_DIR / "mixes" / f"{w['traffic']}.json").read_text())
    return Cell(name, config, mix, int(w["chips"]), w["config"], w["traffic"])


def make(config_name: str, traffic: str, chips: int = 1) -> Cell:
    """A cell of a configuration file and a mix file that BENCHMARK.json
    need not list yet (``<config>.<traffic>``)."""
    config = as_run(json.loads((BENCH_DIR / "configs" / f"{config_name}.json").read_text()))
    mix = json.loads((BENCH_DIR / "mixes" / f"{traffic}.json").read_text())
    return Cell(f"{config_name}.{traffic}", config, mix, chips, config_name, traffic)


def end_to_end(name: str) -> list:
    """The end-to-end metrics that cell ``name`` reports."""
    return [m for m in benchmark()["end_to_end"]
            if "workloads" not in m or name in m["workloads"]]


def per_layer(name: str) -> list:
    return [m for m in benchmark()["per_layer"]
            if "workloads" not in m or name in m["workloads"]]


def arch_config(config: Dict[str, Any]):
    """The port's ``ArchConfig`` of a configuration file: its ``port`` keys,
    checked against the widths the reference reads from the top level (the
    five every kind has, and those its kind names)."""
    from repro_torch.configs.registry import ArchConfig

    arch = ArchConfig(**config["port"])
    top = {"hidden_size": arch.d_model, "num_hidden_layers": arch.n_layers,
           "vocab_size": arch.vocab, "torch_dtype": arch.dtype,
           "tie_word_embeddings": arch.tie_embeddings}
    top.update(kind(config["reference"]).port_keys(arch))
    bad = {k: (config.get(k), v) for k, v in top.items() if config.get(k) != v}
    if bad:
        raise ValueError(f"{config['port']['name']}: the port's keys disagree with the "
                         f"configuration (file, port): {bad}")
    return arch
