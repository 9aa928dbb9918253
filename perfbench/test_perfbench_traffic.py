"""The traffic generator: the same seed draws the same requests, every seed
the same sizes per round, the docqa corpus fixed across seeds."""
from __future__ import annotations

import json
import sys
from collections import Counter
from pathlib import Path

import pytest
import torch

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))

import tiny  # noqa: E402
from harness import traffic  # noqa: E402

# the serving mixes in mixes/, and a small open loop of the generator's own
MIXES = sorted(p.stem for p in (HERE / "mixes").glob("*.json")
               if json.loads(p.read_text())["kind"] == "serve") + ["tiny.open"]


def mix(name):
    if name == "tiny.open":
        return tiny.mix("open")
    return json.loads((HERE / "mixes" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_requests(name):
    m = mix(name)
    a = traffic.sequence(m, 2**33 + 17)
    b = traffic.sequence(m, 2**33 + 17)
    assert [(s.plen, s.new, s.at) for s in a] == [(s.plen, s.new, s.at) for s in b]
    c = traffic.sequence(m, 5)
    assert [(s.plen, s.new) for s in a] != [(s.plen, s.new) for s in c]


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_serves_the_same_sizes_per_round(name):
    m = mix(name)
    k = m["round"]
    for seed in (0, 1, 2**40 + 3):
        seq = traffic.sequence(m, seed)
        assert len(seq) == k * m["rounds"]
        for r in range(m["rounds"]):
            part = seq[r * k:(r + 1) * k]
            t = traffic.Tables(m)
            assert Counter(s.plen for s in part) == Counter(t.prompt)
            assert Counter(s.new for s in part) == Counter(t.output)
        assert all(m["prompt"]["min"] <= s.plen <= m["prompt"]["max"] for s in seq)
        assert all(s.plen + s.new <= m["max_len"] for s in seq)


@pytest.mark.parametrize("name", MIXES)
def test_stratified_prefixes_carry_even_work(name):
    m = mix(name)
    t = traffic.Tables(m)
    bands = m["strata"]
    edges = [t.prompt[i * (m["round"] // bands)] for i in range(bands)] + [10**9]
    for seed in (3, 4):
        seq = traffic.sequence(m, seed)
        for lo in range(0, m["round"], bands):
            got = sorted(s.plen for s in seq[lo:lo + bands])
            assert all(edges[i] <= got[i] <= edges[i + 1] for i in range(bands))


def test_docqa_corpus_is_fixed_across_seeds():
    m = mix("docqa")
    corpus = traffic.Tables(m).prompt
    assert len(corpus) == 24
    assert all(1024 <= p <= 3840 for p in corpus)
    for seed in (1, 99, 2**35):
        assert set(s.plen for s in traffic.sequence(m, seed)) == set(corpus)


def test_open_loop_gaps_keep_the_rate():
    m = mix("tiny.open")
    t = traffic.Tables(m)
    assert abs(sum(t.gaps) / len(t.gaps) - 1 / m["rate"]) < 1e-9
    seq = traffic.sequence(m, 8)
    assert all(b.at > a.at for a, b in zip(seq, seq[1:]))


def test_tokens_drawn_from_the_seed():
    m = dict(mix("docqa"), rounds=1)
    seq = traffic.sequence(m, 12)
    a = traffic.tokens(seq, 49155, 12, torch.device("cpu"))
    b = traffic.tokens(seq, 49155, 12, torch.device("cpu"))
    c = traffic.tokens(seq, 49155, 13, torch.device("cpu"))
    assert all(torch.equal(x, y) for x, y in zip(a, b))
    assert not torch.equal(a[0], c[0])
    assert [x.shape[1] for x in a] == [s.plen for s in seq]
    assert int(min(x.min() for x in a)) >= 2 and int(max(x.max() for x in a)) < 49155


def test_seeds_past_32_bits():
    assert traffic.torch_seed(2**31 + 5, 1) != traffic.torch_seed(2**31 + 6, 1)
    assert 0 <= traffic.torch_seed(2**62, 3) < 2**63
