"""The configuration files: their top-level keys are the published config,
the keys under ``runs_as`` are published keys that the port runs at other
values, and the port's own keys agree with the configuration as run."""
from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent / "src")]

import tiny  # noqa: E402
import kinds  # noqa: E402
from harness import weights  # noqa: E402
from harness.cell import arch_config, as_run  # noqa: E402

CONFIGS = sorted(p.stem for p in (HERE / "configs").glob("*.json"))


@pytest.mark.parametrize("name", CONFIGS)
def test_runs_as_names_published_keys(name):
    raw = json.loads((HERE / "configs" / f"{name}.json").read_text())
    assert set(raw.get("runs_as", {})) <= set(raw) - {"runs_as", "port"}
    run = as_run(raw)
    assert all(run[k] == v for k, v in raw.get("runs_as", {}).items())
    arch = arch_config(run)          # raises where the port's keys disagree
    assert arch.tie_embeddings == raw["tie_word_embeddings"]


@pytest.mark.parametrize("kind", kinds.names())
def test_leaf_names_follow_the_leaves(kind):
    cfg = tiny.config(kind, "float32")
    tree = weights.make(cfg, 3, "cpu")
    names, leaves = weights.leaf_names(tree), weights.leaves(tree)
    assert len(names) == len(leaves) == len(set(names))
    assert names[0] == "embed" and ("lm_head" in names) is (not cfg["tie_word_embeddings"])
    first = next(iter(tree["layers"][1]["mixer"]))        # wq, in_proj
    assert torch.equal(leaves[names.index(f"layers.1.mixer.{first}")],
                       tree["layers"][1]["mixer"][first])
