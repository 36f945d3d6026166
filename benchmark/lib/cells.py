"""The two drivers, one a kind of traffic: set-up, the measured window, the
traced part of it, and the check that decides ``correct``.

The program under test is ``ompi_tpu_torch``: a training cell drives the
``step`` of ``models.transformer.make_train_step`` on the card, a prefill
cell ``models.transformer.forward``. The module is looked up at each call,
so a test can plant a fault in it. Everything else here (weights, tokens,
clocks, the reference) is the benchmark's own.
"""

from __future__ import annotations

import gc
import math
import statistics
import time
from typing import Callable, Dict, List

import torch

from benchmark.lib import check, flops, traffic, trace, weights

KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")


def _program():
    from ompi_tpu_torch.models import transformer
    from ompi_tpu_torch.ops import flash_attention
    return transformer, flash_attention


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _launches() -> Dict[str, int]:
    fa = _program()[1]
    return {"flash_fwd": fa.KERNEL_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES}


def _since(before: Dict[str, int]) -> Dict[str, int]:
    return {k: v - before[k] for k, v in _launches().items()}


def _config(d: weights.Dims):
    return _program()[0].Config(vocab=d.vocab, d_model=d.d_model,
                                n_heads=d.n_heads, n_layers=d.n_layers,
                                d_ff=d.d_ff, seq_len=d.seq_len, lr=d.lr)


def _free(device) -> None:
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


class Window:
    """The measured loop: ``call()`` once per step or request until
    ``seconds`` have passed and ``at_end()`` holds. With ``traced``, first
    that many calls run under torch.profiler between two synchronisations;
    the measured loop starts when the profiler has finished. On the card
    the profiler traces the device's activity alone (see ``trace``), so the
    traced calls pay little more host time than the measured ones."""

    def __init__(self, device, seconds: float, traced: int):
        self.device, self.seconds, self.traced = device, seconds, traced
        self.prof = None

    def run(self, call: Callable[[], None], at_end: Callable[[], bool]):
        """Returns the number of measured (untraced) calls."""
        if self.traced:
            from torch.profiler import ProfilerActivity, profile, \
                record_function
            cuda = torch.device(self.device).type == "cuda"
            acts = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
            with profile(activities=acts) as self.prof:
                with record_function(trace.WINDOW):
                    _sync(self.device)
                    for _ in range(self.traced):
                        call()
                    _sync(self.device)
        self.t0 = time.perf_counter()
        done = 0
        while done == 0 or not (time.perf_counter() - self.t0 >= self.seconds
                                and at_end()):
            call()
            done += 1
        _sync(self.device)
        self.t1 = time.perf_counter()
        return done

    @property
    def elapsed(self) -> float:
        return self.t1 - self.t0


def _device_info(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": torch.cuda.max_memory_allocated(device)}


def _traced(win: Window, kind: str, d: weights.Dims, work: List[dict],
            rest: List[dict], device_name: str) -> trace.Traced:
    return trace.from_profiler(win.prof, work=work, rest_work=rest,
                               rest_s=win.elapsed, kind=kind, dims=d,
                               peak=flops.peak(device_name))


def run_train(cell, seed: int, seconds: float, traced: bool,
              device) -> dict:
    """A training cell: a closed loop of steps."""
    tfm = _program()[0]
    d, mix = weights.dims_of(cell.config), cell.traffic
    B, T = mix["batch"], mix["seq_len"]
    cfg = _config(d)
    feed = traffic.TrainFeed(mix, d.vocab, seed, device)
    params = weights.make_params(d, seed, device)
    step, place = tfm.make_train_step(cfg, device)
    first = feed.next()
    params, _, _ = place(params, *first)

    # the first steps: the window's own step and feed; the reference
    # follows them
    before = _launches()
    batches, losses, grad = [], [], {}
    for i in range(mix["first_steps"]):
        tokens, targets = first if i == 0 else feed.next()
        batches.append((tokens, targets))
        losses.append(float(step(params, tokens, targets)[0]))
        if i == 0:
            grad = {k: v / d.lr for k, v in
                    weights.change_norms(d, seed, params).items()}
    got = check.TrainReadings(losses, grad,
                              weights.change_norms(d, seed, params))
    _sync(device)
    first_launches = _since(before)

    n_traced = mix["traced_steps"] if traced else 0
    win = Window(device, seconds, n_traced)
    window_losses = []
    # the window's checked step, counted over all its calls; the window
    # runs at least through it
    check_at = n_traced + traffic.checked_step(mix, seed)
    taken = {}

    def call():
        tokens, targets = feed.next()
        at = len(window_losses) == check_at
        if at:
            taken.update(before=weights.clone_tree(params), tokens=tokens,
                         targets=targets)
        window_losses.append(float(step(params, tokens, targets)[0]))
        if at:
            taken["norms"] = weights.step_norms(taken["before"], params,
                                                d.lr)

    before = _launches()
    setup_end = time.perf_counter()
    steps = win.run(call, lambda: len(window_losses) > check_at)
    launches = _since(before)
    result = {"setup_end": setup_end, "attempted": n_traced + steps,
              "failed": sum(not math.isfinite(x) for x in window_losses),
              "device": _device_info(device),
              "e2e": {"train_tokens_per_s": steps * B * T / win.elapsed}}
    if traced:
        one = {"batch": B, "seq": T}
        result["traced"] = _traced(win, "train", d, [one] * n_traced,
                                   [one] * steps, result["device"]["kind"])

    del params, step, place
    _free(device)
    numbers = check.window_gaps(d, check.WindowStep(
        loss=window_losses[check_at], **taken))
    taken.clear()
    _free(device)
    ref, exact = check.reference_train(d, seed, batches, device)
    keep = check.counted_leaves(exact)
    numbers.update(check.train_gaps(got, ref, keep))
    if torch.device(device).type == "cuda":
        per_step = {k: d.n_layers for k in KERNELS}
        expected = {k: n * (mix["first_steps"] + n_traced + steps)
                    for k, n in per_step.items()}
        counted = {k: first_launches[k] + launches[k] for k in KERNELS}
        numbers["flash_launch_miss"] = check.launch_miss(expected, counted)
    result["numbers"] = numbers
    return result


def run_prefill(cell, seed: int, seconds: float, traced: bool,
                device) -> dict:
    """A prefill cell: one client, one request after another."""
    tfm = _program()[0]
    d, mix = weights.dims_of(cell.config), cell.traffic
    cfg = _config(d)
    feed = traffic.PrefillFeed(mix, d.vocab, seed, device)
    params = weights.make_params(d, seed, device)

    def serve(request: int, length: int):
        tokens = feed.tokens(request, length)
        best, served = tfm.forward(params, tokens, cfg).max(dim=-1)
        return tokens, best, served

    for length in sorted(set(feed.lengths)):  # every shape of the mix
        serve(0, length)
    _sync(device)

    n = len(feed.lengths)
    rounds = feed.rounds()
    records: List[dict] = []

    def call():
        request, length = next(rounds)
        t0 = time.perf_counter()
        tokens, best, served = serve(request, length)
        _sync(device)
        records.append({"latency": time.perf_counter() - t0,
                        "tokens": tokens, "best": best, "served": served})

    n_traced = n if traced else 0
    win = Window(device, seconds, n_traced)
    before = _launches()
    setup_end = time.perf_counter()
    win.run(call, lambda: len(records) % n == 0)
    launches = _since(before)
    measured = records[n_traced:]
    lat = sorted(r["latency"] for r in measured)
    prompt_tokens = sum(r["tokens"].numel() for r in measured)
    result = {
        "setup_end": setup_end, "attempted": len(records),
        "failed": sum(not bool(torch.isfinite(r["best"]).all())
                      for r in records),
        "device": _device_info(device),
        "e2e": {"prefill_tokens_per_s": prompt_tokens / win.elapsed,
                "prefill_p95_ms": 1e3 * statistics.quantiles(
                    lat, n=20, method="inclusive")[18]},
    }
    if traced:
        work = [{"batch": r["tokens"].shape[0], "seq": r["tokens"].shape[1]}
                for r in records]
        result["traced"] = _traced(win, "prefill", d, work[:n_traced],
                                   work[n_traced:], result["device"]["kind"])

    del params
    _free(device)
    sample = check.check_sample(records, seed, mix["check_requests"])
    numbers = {"max_gap": check.reference_prefill(d, seed, sample, device)}
    if torch.device(device).type == "cuda":
        expected = {"flash_fwd": d.n_layers * len(records), "flash_dq": 0,
                    "flash_dkv": 0}
        numbers["flash_launch_miss"] = check.launch_miss(expected, launches)
    result["numbers"] = numbers
    return result


DRIVERS = {"train": run_train, "prefill": run_prefill}
