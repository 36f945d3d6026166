"""The one traffic generator: it reads a mix's parameters from its file.

A ``train`` mix is a closed loop of steps, each on a fresh [batch, seq_len]
block of tokens with its targets shifted by one. A ``prefill`` mix is a
closed loop of one client whose requests run in rounds: each round sends
the same set of prompt lengths, the quantiles of the mix's distribution, in
a new order drawn from the seed. So every seed does the same work in another
order, and a window that ends at the end of a round holds whole rounds.
"""

from __future__ import annotations

import math
import random
import statistics
from typing import List

import torch

from benchmark.lib import weights


def round_up(x: float, multiple: int) -> int:
    return int(math.ceil(x / multiple) * multiple)


def prefill_lengths(mix: dict) -> List[int]:
    """The prompt lengths of one round, ascending: ``per_round`` quantiles
    at (i + 0.5) / per_round of the lognormal, rounded up to ``multiple``
    and clipped to [min, max]."""
    spec = mix["lengths"]
    if spec["dist"] != "lognormal":
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    n = spec["per_round"]
    unit = statistics.NormalDist()
    out = []
    for i in range(n):
        x = spec["median"] * math.exp(spec["sigma"]
                                      * unit.inv_cdf((i + 0.5) / n))
        out.append(min(spec["max"], max(spec["min"],
                                        round_up(x, spec["multiple"]))))
    return sorted(out)


def checked_step(mix: dict, seed: int) -> int:
    """Which untraced step of a training window is checked (counted from
    0), drawn from the seed in the mix's ``checked_step`` range."""
    span = mix["checked_step"]
    rng = random.Random(weights.seed_for(seed, "check.window_step"))
    return rng.randint(span["min"], span["max"])


def round_order(seed: int, round_index: int, n: int) -> List[int]:
    """The order of one round's requests."""
    order = list(range(n))
    random.Random(weights.seed_for(seed, f"round{round_index}")).shuffle(
        order)
    return order


class TrainFeed:
    """Fresh token blocks for the steps, from one generator on the device."""

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.shape = (mix["batch"], mix["seq_len"] + 1)
        self.vocab = vocab
        self.gen = weights.generator(seed, "train.tokens", device)
        self.device = device

    def next(self):
        x = torch.randint(0, self.vocab, self.shape, generator=self.gen,
                          device=self.device)
        return x[:, :-1], x[:, 1:]


class PrefillFeed:
    """The prompts of the requests. A pool of token rows is drawn once;
    request ``i`` of a round of lengths takes ``prompts_per_request``
    consecutive rows of it, cut to its length."""

    ROWS = 64

    def __init__(self, mix: dict, vocab: int, seed: int, device):
        self.lengths = prefill_lengths(mix)
        self.b = mix["prompts_per_request"]
        self.seed = seed
        self.pool = weights.token_rows(seed, "prefill.tokens", self.ROWS,
                                       max(self.lengths), vocab, device)

    def tokens(self, request: int, length: int) -> torch.Tensor:
        """[b, length] tokens of the ``request``-th request of the run."""
        rows = [(request * self.b + j) % self.ROWS for j in range(self.b)]
        return self.pool[rows, :length]

    def rounds(self):
        """(request number, length) forever, round after round; a round
        ends where ``request number % per_round == per_round - 1``."""
        n, r = len(self.lengths), 0
        while True:
            for j, i in enumerate(round_order(self.seed, r, n)):
                yield r * n + j, self.lengths[i]
            r += 1
