"""The comparisons that decide ``correct``.

Training: the program's first three steps, run by the window's own step on
the window's own feed, against the reference's three steps from the same
weights and tokens. Three numbers:

- ``loss_gap``: the largest |program loss - reference loss| of the steps;
- ``grad_gap``: the first gradient as SGD applied it, ||p1 - p0|| / lr a
  leaf, by the worst leaf;
- ``change_gap``: ||p3 - p0|| a leaf after the three steps, by the worst
  leaf.

And one step of the measured window, drawn from the seed, taken as it ran:
the program's state before it, its batch, its loss and each leaf's change.
The reference follows it from that state (the program's own: the steps
before it are the window's) with one step of its own:

- ``window_loss_gap``: |program loss - reference loss| of that step;
- ``window_grad_gap``: its gradient as SGD applied it, ||p' - p|| / lr a
  leaf, by the worst leaf.

A leaf's gap is |program norm - reference norm| over the larger of the
reference's norm of that leaf and of the median leaf. Leaves whose
reference gradient is under a thousandth of the median leaf's count in
neither.

Prefill: the served token of a position is the program's largest logit;
``max_gap`` is the widest gap, over every position of a sample of the
window's requests, by which the reference's logit of that token lies below
the reference's largest.

Each number passes at or under its limit in ``benchmark/limits/<cell>.json``.
"""

from __future__ import annotations

import dataclasses
import random
import statistics
from typing import Dict, List, Sequence, Tuple

import torch

from benchmark.lib import weights
from benchmark.reference import opt

SMALL_LEAF = 1e-3


@dataclasses.dataclass
class TrainReadings:
    losses: List[float]
    grad: Dict[str, float]    # ||p1 - p0|| / lr a leaf
    change: Dict[str, float]  # ||p3 - p0|| a leaf


def reference_train(d: weights.Dims, seed: int,
                    batches: Sequence[Tuple[torch.Tensor, torch.Tensor]],
                    device, precision: str = "f32"
                    ) -> Tuple[TrainReadings, Dict[str, float]]:
    """The reference's steps over ``batches`` from the seed's weights: its
    readings, and its exact first gradient's norm a leaf."""
    params = weights.make_params(d, seed, device)
    losses, grad, exact = [], {}, {}
    with opt.exact_f32():
        for i, (tokens, targets) in enumerate(batches):
            loss, grads = opt.loss_and_grads(params, tokens, targets,
                                             d.n_heads, precision)
            losses.append(loss)
            if i == 0:
                exact = {k: float(torch.linalg.vector_norm(
                    g, dtype=torch.float64))
                    for k, g in weights.leaves(grads)}
            opt.sgd(params, grads, d.lr)
            del grads
            if i == 0:
                grad = {k: v / d.lr for k, v in
                        weights.change_norms(d, seed, params).items()}
        change = weights.change_norms(d, seed, params)
    return TrainReadings(losses, grad, change), exact


@dataclasses.dataclass
class WindowStep:
    """One step of the window as it ran."""
    before: dict               # the program's parameters before the step
    tokens: torch.Tensor
    targets: torch.Tensor
    loss: float
    norms: torch.Tensor        # weights.step_norms of the step


def window_gaps(d: weights.Dims, taken: WindowStep) -> Dict[str, float]:
    """The reference's step from the program's state before the window's
    checked step, against that step."""
    names = [k for k, _ in weights.leaves(taken.before)]
    got = dict(zip(names, taken.norms.tolist()))
    with opt.exact_f32():
        loss, grads = opt.loss_and_grads(taken.before, taken.tokens,
                                         taken.targets, d.n_heads)
        ref, exact = {}, {}
        for (k, p), (_, g) in zip(weights.leaves(taken.before),
                                  weights.leaves(grads)):
            exact[k] = float(torch.linalg.vector_norm(g, dtype=torch.float64))
            ref[k] = float(torch.linalg.vector_norm(
                (p - d.lr * g) - p, dtype=torch.float64)) / d.lr
    del grads
    return {"window_loss_gap": abs(taken.loss - loss),
            "window_grad_gap": leaf_gap(got, ref,
                                        counted_leaves(exact))[0]}


def counted_leaves(exact_grad: Dict[str, float]) -> List[str]:
    med = statistics.median(exact_grad.values())
    return [k for k, v in exact_grad.items() if v >= SMALL_LEAF * med]


def leaf_gap(got: Dict[str, float], ref: Dict[str, float],
             keep: List[str]) -> Tuple[float, str]:
    """(worst leaf's gap, its name)."""
    med = statistics.median(ref[k] for k in keep)
    return max((abs(got[k] - ref[k]) / max(ref[k], med), k) for k in keep)


def train_gaps(got: TrainReadings, ref: TrainReadings,
               keep: List[str]) -> Dict[str, float]:
    return {
        "loss_gap": max(abs(a - b) for a, b in zip(got.losses, ref.losses)),
        "grad_gap": leaf_gap(got.grad, ref.grad, keep)[0],
        "change_gap": leaf_gap(got.change, ref.change, keep)[0],
    }


def check_sample(records: List[dict], seed: int, count: int) -> List[dict]:
    """The requests compared: the longest (most tokens), and others drawn
    from the seed, ``count`` in all."""
    longest = max(range(len(records)),
                  key=lambda i: records[i]["tokens"].numel())
    rest = [i for i in range(len(records)) if i != longest]
    rng = random.Random(weights.seed_for(seed, "check.sample"))
    picked = [longest] + rng.sample(rest, min(count - 1, len(rest)))
    return [records[i] for i in sorted(picked)]


def served_gap(ref_logits: torch.Tensor, served: torch.Tensor) -> float:
    """Widest gap between the reference's best logit and its logit of the
    served token, over all positions."""
    best = ref_logits.amax(dim=-1)
    got = ref_logits.gather(-1, served[..., None])[..., 0]
    return float((best - got).amax())


def reference_prefill(d: weights.Dims, seed: int, sample: List[dict],
                      device) -> float:
    """``max_gap`` of the program's served tokens over the sample."""
    params = weights.make_params(d, seed, device)
    gap = 0.0
    with torch.no_grad(), opt.exact_f32():
        for rec in sample:
            ref = opt.forward_logits(params, rec["tokens"], d.n_heads)
            gap = max(gap, served_gap(ref, rec["served"]))
            del ref
    return gap


def judge(numbers: Dict[str, float], limits: dict
          ) -> Tuple[bool, Dict[str, dict]]:
    """(every number at or under its limit, {name: {value, limit}}). A
    number that is not finite fails."""
    checks, ok = {}, True
    for name, value in numbers.items():
        limit = limits[name]["limit"]
        checks[name] = {"value": value, "limit": limit}
        ok = ok and value == value and value <= limit
    return ok, checks


def launch_miss(expected: Dict[str, int], counted: Dict[str, int]) -> int:
    """Launches of the flash kernels that differ from one a layer and
    call, summed over the kernels."""
    return sum(abs(expected[k] - counted[k]) for k in expected)
