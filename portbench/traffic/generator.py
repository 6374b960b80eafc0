"""The one general traffic generator: it reads a mix's parameters from
``portbench/traffic/<mix>.json`` and makes its requests from the seed.

A mix is a closed loop of ``clients`` (``"loop": "closed"``): each client
sends its next request when its last one returns. Lengths are drawn from
``uniform`` or ``bounded_pareto`` distributions. Every seed gets the same
sizes, in another order: each block of ``block`` requests takes the
lengths at the block's evenly spaced quantiles of the distribution,
shuffled by the seed; the token ids are uniform over the vocabulary. So a seed changes which
request is long and the ids, not the work a run offers.

``warm_phase``: each client's first request is one whose
output is already under way, at an evenly spaced share of it, its served
part folded into the prompt, so that the clients finish one by one as in a
steady deployment and not together.
"""
from __future__ import annotations

import dataclasses
import json
import math
from pathlib import Path

import numpy as np

from portbench.arith import bounded_pareto

HERE = Path(__file__).resolve().parent
STREAM = 1                         # the seed's draw of the requests


def load(name: str) -> dict:
    path = HERE / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    mix = json.loads(path.read_text())
    if mix.get("loop") != "closed":
        raise ValueError(f"traffic mix {name!r}: only closed loops are "
                         "generated")
    return mix


def quantile(dist: dict, u: float) -> int:
    if dist["dist"] == "uniform":
        x = dist["lo"] + u * (dist["hi"] + 1 - dist["lo"])
        return min(int(x), dist["hi"])
    if dist["dist"] == "bounded_pareto":
        return min(round(bounded_pareto(u, dist["alpha"], dist["lo"],
                                        dist["hi"])), dist["hi"])
    raise ValueError(f"unknown length distribution {dist['dist']!r}")


@dataclasses.dataclass
class Spec:
    prompt: list
    max_new: int


class Traffic:
    """The requests of one mix and seed, drawn in order."""

    def __init__(self, mix: dict, seed: int, vocab: int):
        self.mix, self.vocab = mix, vocab
        self.rng = np.random.default_rng([seed, STREAM])
        self.block = mix.get("block", 64)
        self._sizes: list = []

    def _size(self) -> tuple:
        if not self._sizes:
            u = (np.arange(self.block) + 0.5) / self.block
            p = [quantile(self.mix["prompt"], x) for x in u]
            o = [quantile(self.mix["output"], x) for x in u]
            self.rng.shuffle(p)
            self.rng.shuffle(o)
            self._sizes = list(zip(p, o))[::-1]
        return self._sizes.pop()

    def _ids(self, n: int) -> list:
        return self.rng.integers(0, self.vocab, n).tolist()

    def next(self) -> Spec:
        """The next request."""
        p, o = self._size()
        return Spec(self._ids(p), o)

    def firsts(self) -> list:
        """Each client's first request. With
        ``warm_phase`` each is one under way: the client whose request has
        the k-th shortest output has served share (k + 0.5) / clients of it
        (ties in order of clients), so with ``block`` equal to ``clients``
        every seed starts from the same outputs left."""
        specs = [self.next() for _ in range(self.mix["clients"])]
        if not self.mix.get("warm_phase"):
            return specs
        n = len(specs)
        order = sorted(range(n), key=lambda c: (specs[c].max_new, c))
        out = list(specs)
        for k, c in enumerate(order):
            s = specs[c]
            done = math.floor((k + 0.5) / n * s.max_new)
            out[c] = Spec(s.prompt + self._ids(done), s.max_new - done)
        return out

    def longest(self) -> int:
        """Prompt plus output of the longest request the mix can send."""
        return self.mix["prompt"]["hi"] + self.mix["output"]["hi"]
