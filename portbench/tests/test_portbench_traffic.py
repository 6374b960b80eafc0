"""The traffic generator: the same seed gives the same bits, lengths keep
to their bounds, and every seed gets the same sizes in another order."""
import json
from pathlib import Path

import pytest

from portbench.traffic import generator as g

MIXES = sorted(p.stem for p in Path(g.HERE).glob("*.json"))


def _draw(mix, seed, n=200):
    t = g.Traffic(mix, seed, vocab=1000)
    return t.firsts() + [t.next() for _ in range(n)]


@pytest.mark.parametrize("name", MIXES)
def test_same_seed_same_traffic(name):
    mix = g.load(name)
    a, b = _draw(mix, 2**31 + 5), _draw(mix, 2**31 + 5)
    assert [(s.prompt, s.max_new) for s in a] == \
        [(s.prompt, s.max_new) for s in b]
    c = _draw(mix, 2**31 + 6)
    assert [s.prompt for s in a] != [s.prompt for s in c]


@pytest.mark.parametrize("name", MIXES)
def test_lengths_within_bounds(name):
    mix = g.load(name)
    for s in _draw(mix, 123)[len(_draw(mix, 123)) - 200:]:
        assert mix["prompt"]["lo"] <= len(s.prompt) <= mix["prompt"]["hi"]
        assert mix["output"]["lo"] <= s.max_new <= mix["output"]["hi"]
        assert all(0 <= t < 1000 for t in s.prompt)


@pytest.mark.parametrize("name", MIXES)
def test_every_seed_the_same_sizes(name):
    mix = g.load(name)
    n = mix["block"] * 2
    draws = [_draw(mix, seed, n)[-n:] for seed in (1, 2, 3)]
    prompts = [sorted(len(s.prompt) for s in d) for d in draws]
    outputs = [sorted(s.max_new for s in d) for d in draws]
    assert prompts[0] == prompts[1] == prompts[2]
    assert outputs[0] == outputs[1] == outputs[2]
    assert [len(s.prompt) for s in draws[0]] != \
        [len(s.prompt) for s in draws[1]]


def test_warm_phase_leaves_the_same_outputs_for_every_seed():
    mix = g.load("long_decode")
    left = [sorted(s.max_new for s in g.Traffic(mix, seed, 1000).firsts())
            for seed in (7, 8)]
    assert left[0] == left[1]
    assert left[0][0] < mix["output"]["lo"] / 4    # one finishes early
    for s in g.Traffic(mix, 9, 1000).firsts():
        assert len(s.prompt) + s.max_new <= g.Traffic(mix, 9, 1).longest()


def test_bounded_pareto_quantiles():
    d = {"dist": "bounded_pareto", "alpha": 1.2, "lo": 32, "hi": 256}
    assert g.quantile(d, 0.0) == 32
    assert g.quantile(d, 0.999999) == 256
    assert 50 <= g.quantile(d, 0.5) <= 60          # median about 56
    u = {"dist": "uniform", "lo": 10, "hi": 13}
    assert [g.quantile(u, x) for x in (0.0, 0.3, 0.6, 0.99)] == \
        [10, 11, 12, 13]


def test_mix_files_are_plain_parameters():
    for name in MIXES:
        mix = json.loads((Path(g.HERE) / f"{name}.json").read_text())
        assert mix["loop"] == "closed"
