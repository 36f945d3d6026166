"""The port's benchmark: collective sweeps, the verb layer's dispatch tax,
the quantized-allreduce sweep and the training step's MFU.

    python -m ompi_tpu_torch.tools.bench [--device cpu]

The counterpart of the repo's ``bench.py`` (its timing primitives, the
sweeps, ``bench_dispatch_tax``, ``bench_quant_sweep``, ``bench_mfu`` with
``_mfu_ablations`` and ``main``): each leg keeps that leg's sizes, row keys
and headline. Detail goes to stderr and ``BENCH_DETAIL_TORCH.json``, the
headline line to stdout. What differs, and why:

- Timing. ``bench.py`` chains K dependent ops in one compiled program, syncs
  with a scalar readback and subtracts the fixed round trip of its device
  link (``_rtt``), because that link returned from ``block_until_ready``
  before the work ran. A CUDA card has no such link: ``device_ms`` records
  CUDA events around ``iters`` calls back to back (one stream runs them in
  order, so no chain is needed) and takes the median of the rounds; on the
  CPU it reads the host clock. No round trip is subtracted.
- One card holds every rank of ``mesh_world(8)`` and its verbs do real work
  in its memory, so the sweeps run there, not on a virtual CPU mesh in a
  subprocess (``bench.py``'s ``_cpu_mesh_sweep``). ``fraction`` is then the
  verb layer against one plain PyTorch expression with the same result on
  the same memory (``raw_*``), whose output is compared with the verb's.
- The legs that drive process mode (``bench_plan_cache``, ``bench_p2p`` to
  ``bench_host_paths``) are not here: the port has no process mode. The
  dispatch tax goes into the spc counters ``dispatch_<verb>_layer_overhead_ns``
  as ``bench.py:306-317`` writes it; the metrics gauges ``bench.py``
  mirrors its results into wait for the metrics registry, which is process
  mode.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import sys
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ompi_tpu_torch import quant  # noqa: F401 registers the quant_* vars
from ompi_tpu_torch.coll.mesh import cache_key
from ompi_tpu_torch.core.op import SUM
from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.mca.var import get_var, set_var
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.ops import flash_attention as fa
from ompi_tpu_torch.ops.softmax_xent import softmax_xent_sum
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.quant.codec import make_codec
from ompi_tpu_torch.runtime import spc

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# peak dense bf16 FLOP/s by torch.cuda.get_device_name; a card not listed
# has no peak here, and then no mfu is reported
PEAK_FLOPS = {"NVIDIA H100 80GB HBM3": PEAK_BF16_FLOPS}

WORLD = 8
SWEEP_BYTES = (1 << 10, 1 << 15, 1 << 20, 1 << 24, 1 << 26)  # f32 a rank
VERB_BYTES = 1 << 24  # bcast, allgather, alltoall: 16 MB in total
QUANT_BYTES = (1 << 16, 1 << 20, 1 << 24)  # f32 a rank
PROLOGUE_CALLS = 50000
# the flagship model step on the card, and the small one elsewhere
# (bench.py:555-564): batch 36 and 12 steps, or batch 2 and 2 steps
FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
                seq_len=1024)
SMALL = dict(vocab=1024, d_model=128, n_heads=8, n_layers=2, d_ff=512,
             seq_len=128)
MFU_BATCH, MFU_KSTEPS = {"cuda": 36, "cpu": 2}, {"cuda": 12, "cpu": 2}


# ------------------------------------------------------------------ timers
def time_ms(fn: Callable, iters: int = 10, warmup: int = 2,
            device: DeviceLike = "cuda") -> float:
    """Mean time of one call of ``fn`` over ``iters`` calls back to back,
    after ``warmup`` calls: CUDA events on the card; the host clock on the
    CPU, where every op has ended when it returns."""
    for _ in range(warmup):
        fn()
    if torch.device(device).type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return 1e3 * (time.perf_counter() - t0) / iters
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def host_ms(fn: Callable, iters: int = 20) -> float:
    """Host time of one call of ``fn`` by the host clock, with the card
    running behind it: for a kernel's wrapper, its checks, allocations,
    tensor maps and launch."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return 1e3 * (t1 - t0) / iters


def device_ms(fn: Callable, iters: int = 10, rounds: int = 3,
              device: DeviceLike = "cuda") -> float:
    """The median over ``rounds`` of ``time_ms(fn, iters)``, after one
    warm-up call."""
    fn()
    return statistics.median(time_ms(fn, iters, 0, device)
                             for _ in range(rounds))


def paired_ms(fn_a: Callable, fn_b: Callable, x: torch.Tensor, iters: int,
              rounds: int = 3, b_arg: Optional[torch.Tensor] = None):
    """(ms of ``fn_a(x)``, ms of ``fn_b(b_arg or x)``): ``iters`` calls back
    to back a round, the two interleaved round by round so that drift hits
    both alike; medians of the rounds (``bench.py`` ``_chained_pair``)."""
    xb = x if b_arg is None else b_arg
    fn_a(x)
    fn_b(xb)
    ta, tb = [], []
    for _ in range(rounds):
        ta.append(time_ms(lambda: fn_a(x), iters, 0, x.device))
        tb.append(time_ms(lambda: fn_b(xb), iters, 0, xb.device))
    return statistics.median(ta), statistics.median(tb)


def floor_us(fn: Callable, arg: torch.Tensor, iters: int = 60) -> float:
    """The least host time of dispatching ``fn(arg)`` over ``iters`` calls,
    us; the device queue is drained after each call, outside the timed
    region (``bench.py:267-281``)."""
    best = float("inf")
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(arg)
        best = min(best, time.perf_counter() - t0)
        if arg.is_cuda:
            torch.cuda.synchronize()
    return best * 1e6


def device_name(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def peak_for(name: str) -> Optional[float]:
    """Peak dense bf16 FLOP/s of the device named ``name``
    (``torch.cuda.get_device_name``), or None where it is not known."""
    return PEAK_FLOPS.get(name)


def train_flops(params, cfg: tfm.Config, tokens: int) -> float:
    """``bench_mfu``'s count: 6*N per token (forward 2N, backward 4N) plus
    12*L*T*D per token for attention (``bench.py:596-600``)."""
    n = sum(p.numel() for p in tfm.param_leaves(params))
    return (6.0 * n + 12.0 * cfg.n_layers * cfg.seq_len * cfg.d_model) \
        * tokens


# ------------------------------------------------- the verbs' raw twins
# One plain PyTorch expression a verb, with the verb's [W, ...] result, each
# row in its own storage (the bytes the verb writes)
def raw_allreduce(x):
    return x.sum(0, keepdim=True).expand_as(x).contiguous()


def raw_bcast(x, root: int = 0):
    return x[root:root + 1].expand_as(x).contiguous()


def raw_allgather(x):
    return x.unsqueeze(0).expand((x.shape[0],) + tuple(x.shape)).contiguous()


def raw_alltoall(x):
    return x.transpose(0, 1).contiguous()


def _same(got, want, what: str, sums=None) -> None:
    """The verb's result against its raw twin's: bit-exact, or for a world
    float SUM within 1e-6 of the summed magnitudes ``sums``."""
    if got.shape != want.shape or got.dtype != want.dtype:
        raise RuntimeError(f"{what}: {tuple(got.shape)} {got.dtype} vs "
                           f"{tuple(want.shape)} {want.dtype}")
    ok = bool(((got - want).abs() <= 1e-6 * sums).all()) if sums is not None \
        else torch.equal(got, want)
    if not ok:
        raise RuntimeError(f"{what}: the verb's result differs from its raw "
                           f"counterpart's")


def _randn(shape, device: torch.device, seed: int = 0) -> torch.Tensor:
    gen = torch.Generator(device).manual_seed(seed)
    return torch.randn(shape, device=device, generator=gen)


# --------------------------------------------------------------- the legs
def bench_allreduce_sweep(world, n: int, sizes=SWEEP_BYTES):
    """The f32 SUM allreduce at 1 KB to 64 MB a rank, the verb against
    ``raw_allreduce`` (``bench.py:124-151``): bus GB/s (factor 2(n-1)/n)
    and ``fraction`` = raw time / verb time."""
    bus = 2.0 * (n - 1) / n if n > 1 else 1.0
    out = []
    for nbytes in sizes:
        per_rank = max(nbytes // 4, 1)
        x = _randn((n, per_rank), world.device)
        _same(world.allreduce(x), raw_allreduce(x),
              f"allreduce {per_rank * 4} B a rank", x.abs().sum(0))
        iters = 300 if nbytes <= (1 << 15) else \
            60 if nbytes <= (1 << 20) else 12
        t_ours, t_raw = paired_ms(world.allreduce, raw_allreduce, x, iters)
        out.append({
            "bytes": per_rank * 4,
            "ours_gbps": bus * per_rank * 4 / t_ours / 1e6,
            "raw_gbps": bus * per_rank * 4 / t_raw / 1e6,
            "fraction": t_raw / t_ours,
        })
        del x
    return out


def bench_verbs(world, n: int, total_bytes: int = VERB_BYTES):
    """bcast, allgather and alltoall at 16 MB in total, each against its raw
    counterpart, whose result it must equal bit for bit
    (``bench.py:462-505``)."""
    per_rank = max(total_bytes // 4 // n, 1)
    x = _randn((n, per_rank), world.device)
    chunks = _randn((n, n, max(per_rank // n, 1)), world.device, 1)
    legs = {"bcast": (lambda a: world.bcast(a, 0), raw_bcast, x),
            "allgather": (world.allgather, raw_allgather, x),
            "alltoall": (world.alltoall, raw_alltoall, chunks)}
    res = {}
    for name, (ours, raw, arg) in legs.items():
        _same(ours(arg), raw(arg), f"{name} {total_bytes} B in total")
        t_ours, t_raw = paired_ms(ours, raw, arg, 10)
        res[f"{name}_16MB_total"] = {"ours_s": t_ours / 1e3,
                                     "raw_s": t_raw / 1e3,
                                     "fraction": t_raw / t_ours}
    return res


def bench_quant_sweep(world, n: int, sizes=QUANT_BYTES):
    """The quantized allreduce (``coll/quant.py``, under the live
    ``quant_mode``, ``quant_bits`` and ``quant_block``) against the fp32 one
    at 64 KB, 1 MB and 16 MB a rank (``bench.py:154-232``). Each leg has its
    own comm, built while ``quant_enable`` is set (with ``quant_min_bytes``
    4096) or not: a comm reads the settings when it is built. Both settings
    are restored in ``finally``. ``max_err_vs_bound`` below 1 says the
    quantized result kept the codec's closed-form bound; on one card
    ``fraction`` well below 1 is expected: no wire byte is saved there."""
    saved_enable = get_var("quant", "enable")
    saved_min_bytes = get_var("quant", "min_bytes")
    set_var("quant", "enable", True)
    set_var("quant", "min_bytes", 4096)
    try:
        qworld = mesh_world(n, world.device, axis_name="mpi_quant")
        qprov = qworld.coll.providers.get("allreduce")
        if qprov != "quant":
            return [{"skipped": f"quant path unavailable "
                                f"(allreduce provider={qprov!r})"}]
        if world.coll.providers.get("allreduce") == "quant":
            set_var("quant", "enable", False)
            world = mesh_world(n, world.device, axis_name="mpi_fp32")
            set_var("quant", "enable", True)
        codec = make_codec(get_var("quant", "mode"), get_var("quant", "bits"),
                           get_var("quant", "block"))
        rng = np.random.RandomState(0)
        out = []
        for nbytes in sizes:
            per_rank = max(nbytes // 4, 1)
            xs = (rng.randn(n, per_rank) * 3).astype(np.float32)
            x, xq = world.shard(xs), qworld.shard(xs)
            res = qworld.allreduce(xq)[0].cpu().double().numpy()
            err = np.abs(res - xs.astype(np.float64).sum(axis=0))
            bound = codec.error_bound(xs)
            rel = float(np.max(err / np.maximum(bound, 1e-300)))
            iters = 60 if nbytes <= (1 << 20) else 12
            t_fp32, t_q = paired_ms(world.allreduce, qworld.allreduce, x,
                                    iters, b_arg=xq)
            out.append({"bytes": per_rank * 4, "fp32_s": t_fp32 / 1e3,
                        "quant_s": t_q / 1e3, "fraction": t_fp32 / t_q,
                        "max_err_vs_bound": rel})
            del x, xq
        return out
    finally:
        set_var("quant", "enable", saved_enable)
        set_var("quant", "min_bytes", saved_min_bytes)


def bench_dispatch_tax(world):
    """The verb layer's host cost a call (``bench.py:235-361``): each
    verb's dispatch floor against its own cached callable
    (``comm._cache``) called directly, and ``prologue_us``, the layer alone
    with every cached callable replaced by a stub for ``PROLOGUE_CALLS``
    calls. The cache is restored in ``finally``. Each verb's layer overhead
    is also written to the spc counter ``dispatch_<verb>_layer_overhead_ns``
    (``bench.py:306-317``), readable through ``all_pvars()``, MPI_T and the
    info tool."""
    n, dev = world.world_size, world.device
    x = torch.ones((n, 8192), device=dev)
    chunks = torch.ones((n, n, 64), device=dev)
    # verb: (call, argument, its callable's cache key, the callable's
    # arguments after the payload)
    verbs = {
        "allreduce": (world.allreduce, x,
                      world.coll.get("allreduce").__self__.allreduce_key(SUM),
                      ()),
        "scan": (world.scan, x, cache_key("scan", SUM, (False,)), ()),
        "exscan": (world.exscan, x, cache_key("scan", SUM, (True,)), ()),
        "gather": (lambda a: world.gather(a, 0), x, cache_key("allgather"),
                   ()),
        "scatter": (lambda a: world.scatter(a, 0), chunks,
                    cache_key("scatter"), (0,)),
        "alltoall": (world.alltoall, chunks, cache_key("alltoall"), ()),
    }
    for fn, arg, _, _ in verbs.values():
        for _ in range(5):
            fn(arg)
    for _ in range(5):
        raw_allreduce(x)
    if dev.type == "cuda":
        torch.cuda.synchronize()

    d_raw = floor_us(raw_allreduce, x)
    sweep = {}
    for name, (fn, arg, key, extra) in verbs.items():
        d = floor_us(fn, arg)
        d_direct = floor_us(lambda a, f=world._cache[key], e=extra: f(a, *e),
                            arg)
        sweep[name] = {"us": d, "layer_overhead_us": d - d_direct}
        # ns, so that the integer counter keeps sub-us resolution; the
        # delta is recorded so that a re-run replaces the reading
        cname = f"dispatch_{name}_layer_overhead_ns"
        target = max(int(round((d - d_direct) * 1000)), 0)
        spc.record(cname, target - spc.get(cname))
    d_ours = sweep["allreduce"]["us"]

    saved = dict(world._cache)
    try:
        sentinel = object()
        stub = lambda *a: sentinel  # noqa: E731
        for _, _, key, _ in verbs.values():
            world._cache[key] = stub
        t0 = time.perf_counter()
        for _ in range(PROLOGUE_CALLS):
            world.allreduce(x)
        t_verb = (time.perf_counter() - t0) / PROLOGUE_CALLS
        t0 = time.perf_counter()
        for _ in range(PROLOGUE_CALLS):
            stub(x)
        t_stub = (time.perf_counter() - t0) / PROLOGUE_CALLS
    finally:
        world._cache.clear()
        world._cache.update(saved)
    return {"ours_us": d_ours, "raw_us": d_raw, "overhead_us": d_ours - d_raw,
            "prologue_us": (t_verb - t_stub) * 1e6, "verb_sweep": sweep}


# -------------------------------------------------------- the model step
def launch_counts() -> Dict[str, int]:
    """The flash kernels' launch counters."""
    return {"flash_fwd": fa.KERNEL_LAUNCHES, "flash_dq": fa.DQ_LAUNCHES,
            "flash_dkv": fa.DKV_LAUNCHES}


def identity_attention(q, k, v, *args, **kwargs):
    """Attention ablated: (q + k + v) in q's dtype."""
    return (q + k + v).to(q.dtype)


def dense_attention(q, k, v, *args, **kwargs):
    """Causal attention in plain PyTorch on 'bhtd' blocks: bf16 products
    (f32 accumulation, bf16 scores), the softmax in f32, bf16 P.V
    (``tools/profile_mfu.py``'s ``dense_ring``)."""
    T, D = q.shape[2], q.shape[3]
    bf = torch.bfloat16
    s = (q.to(bf) @ k.to(bf).transpose(-1, -2)).float() / float(D) ** 0.5
    mask = torch.ones((T, T), dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, -1e30), dim=-1)
    return (p.to(bf) @ v.to(bf)).to(q.dtype)


ATTENTION = {"identity": identity_attention, "dense": dense_attention}


@contextlib.contextmanager
def attention(mode: str):
    """Within the block, ``models.transformer.ring_attention`` (the name
    ``features_local`` calls) is ``mode``'s attention: "flash" keeps it,
    "identity" and "dense" replace it. Restored in ``finally``."""
    saved = tfm.ring_attention
    if mode != "flash":
        tfm.ring_attention = ATTENTION[mode]
    try:
        yield
    finally:
        tfm.ring_attention = saved


def make_step(cfg: tfm.Config, loss: Callable, attn: str = "flash",
              train: bool = True) -> Callable:
    """``step(params, tokens, targets) -> (loss, params)``: ``loss(params,
    tokens, targets)`` under ``attention(attn)``, its gradients and SGD in
    place, as ``make_train_step`` does; with ``train`` False the forward
    and loss alone."""

    def step(params, tokens, targets):
        leaves = tfm.param_leaves(params)
        if not train:
            with torch.no_grad(), attention(attn):
                return loss(params, tokens, targets), params
        for p in leaves:
            p.requires_grad_(True)
        try:
            with attention(attn):
                value = loss(params, tokens, targets)
            grads = torch.autograd.grad(value, leaves)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        with torch.no_grad():
            for p, g in zip(leaves, grads):
                p.sub_(cfg.lr * g)
        return value.detach(), params

    return step


def chunked_ce(cfg: tfm.Config, denom: float) -> Callable:
    """The training loss of ``make_train_step``: the chunked softmax
    cross-entropy over the tied embedding, its mean over ``denom``
    tokens."""
    return lambda p, tk, tg: softmax_xent_sum(
        tfm.features_local(p, tk, cfg), p["embed"], tg, 128) / denom


def sum_loss(cfg: tfm.Config, denom: float) -> Callable:
    """The ablated loss: the logits times 1e-6, summed; keeps the vocab
    product, drops the cross-entropy."""
    return lambda p, tk, tg: (tfm.forward(p, tk, cfg) * 1e-6).sum() / denom


def timed_steps(step: Callable, params, tokens, targets, ksteps: int,
                device: torch.device):
    """A warm-up step, then ``ksteps`` steps back to back by the host clock
    up to a synchronize after the last (SGD in place makes each step depend
    on the one before). Returns (seconds a step, the warm-up step's loss,
    the kernel launches of the timed steps)."""
    first = float(step(params, tokens, targets)[0])
    if device.type == "cuda":
        torch.cuda.synchronize()
    before = launch_counts()
    t0 = time.perf_counter()
    for _ in range(ksteps):
        step(params, tokens, targets)
    if device.type == "cuda":
        torch.cuda.synchronize()
    t_step = (time.perf_counter() - t0) / ksteps
    after = launch_counts()
    return t_step, first, {k: after[k] - before[k] for k in after}


def model_batch(cfg: tfm.Config, batch: int, device: torch.device):
    """``bench.py``'s tokens (``RandomState(0)``) and targets (the tokens
    rolled by one) on ``device``."""
    toks = np.random.RandomState(0).randint(0, cfg.vocab,
                                            size=(batch, cfg.seq_len))
    return (torch.from_numpy(toks).to(device),
            torch.from_numpy(np.roll(toks, -1, axis=1)).to(device))


def bench_mfu(device: DeviceLike = None, params=None, cfg=None,
              batch: Optional[int] = None, ksteps: Optional[int] = None):
    """The training step's time and MFU, and where it goes
    (``bench.py:527-680``). On the card the flagship at batch 36, 12 steps;
    on the CPU the small config at batch 2, 2 steps. ``params`` (the JAX
    layout, as ``params_from_jax`` gives it) default to ``init_params``
    with seed 0; the steps update them in place. ``first_loss`` is the loss
    of the first step, ``launches`` each kernel's launches in the timed
    full steps, ``peak_bytes`` the card's peak allocated memory over them
    (None on the CPU)."""
    dev = resolve_device(device)
    kind = dev.type if dev.type == "cuda" else "cpu"
    cfg = cfg or tfm.Config(**(FLAGSHIP if kind == "cuda" else SMALL))
    batch = batch or MFU_BATCH[kind]
    ksteps = ksteps or MFU_KSTEPS[kind]
    name = device_name(dev)
    peak = peak_for(name)
    if params is None:
        params = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    toks, tgts = model_batch(cfg, batch, dev)
    step, place = tfm.make_train_step(cfg, dev)
    params, toks, tgts = place(params, toks, tgts)
    if kind == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    t_step, first, counts = timed_steps(step, params, toks, tgts, ksteps, dev)
    peak_bytes = torch.cuda.max_memory_allocated(dev) if kind == "cuda" \
        else None

    n_params = sum(p.numel() for p in tfm.param_leaves(params))
    tokens = batch * cfg.seq_len
    flops = train_flops(params, cfg, tokens)
    out = {
        "device": name,
        "config": dataclasses.asdict(cfg),
        "batch": batch,
        "ksteps": ksteps,
        "params_M": n_params / 1e6,
        "n_params": n_params,
        "flops_per_step": flops,
        "step_s": t_step,
        "tokens_per_s": tokens / t_step,
        "tflops_per_s": flops / t_step / 1e12,
        "first_loss": first,
        "launches": counts,
        "peak_bytes": peak_bytes,
    }
    if peak:
        out["mfu"] = flops / t_step / peak
    out["ablations"] = _mfu_ablations(cfg, batch, ksteps, params, toks, tgts,
                                      t_step, dev)
    return out


def _mfu_ablations(cfg, batch, ksteps, params, toks, tgts, t_full, dev):
    """Where the step's time goes (``bench.py:610-680``): the step with the
    sum loss in place of the cross-entropy, and with identity attention,
    each timed as the full step; the deltas localize the two costs. Also
    each variant's kernel launches in its timed steps."""
    denom = float(batch * cfg.seq_len)
    t_noce, _, n_noce = timed_steps(make_step(cfg, sum_loss(cfg, denom)),
                                    params, toks, tgts, ksteps, dev)
    t_noattn, _, n_noattn = timed_steps(
        make_step(cfg, chunked_ce(cfg, denom), "identity"), params, toks,
        tgts, ksteps, dev)
    ce_s, attn_s = max(t_full - t_noce, 0.0), max(t_full - t_noattn, 0.0)
    return {"full_ms": t_full * 1e3, "ce_loss_ms": ce_s * 1e3,
            "attention_ms": attn_s * 1e3,
            "other_ms": (t_full - ce_s - attn_s) * 1e3,
            "sum_loss_step_ms": t_noce * 1e3,
            "identity_attention_step_ms": t_noattn * 1e3,
            "sum_loss_launches": n_noce,
            "identity_attention_launches": n_noattn}


# ------------------------------------------------------------------- main
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="the device to run on: the card (cuda, the "
                         "default) or cpu")
    dev = resolve_device(ap.parse_args(argv).device)
    name = device_name(dev)
    world = mesh_world(WORLD, dev)
    detail = {
        "devices": [name],
        "collective_device": f"{name} (mesh_world({WORLD}) on one device)",
        "allreduce_sweep": bench_allreduce_sweep(world, WORLD),
        "quant_allreduce_sweep": bench_quant_sweep(world, WORLD),
        "verbs": bench_verbs(world, WORLD),
        "dispatch_tax": bench_dispatch_tax(world),
        "model_step": bench_mfu(dev),
    }
    print(json.dumps(detail, indent=1), file=sys.stderr)
    try:
        with open("BENCH_DETAIL_TORCH.json", "w") as f:
            json.dump(detail, f, indent=1)
    except OSError:
        pass

    # headline: the 64 MB allreduce's fraction of its raw counterpart
    top = detail["allreduce_sweep"][-1]
    step = detail["model_step"]
    print(json.dumps({
        "metric": "allreduce_busbw_fraction_of_raw_sum "
                  f"(64MB f32, {detail['collective_device']}, ours "
                  f"{top['ours_gbps']:.3f} vs raw {top['raw_gbps']:.3f} "
                  f"GB/s; mfu={step.get('mfu', 'n/a')} on {step['device']})",
        "value": top["fraction"],
        "unit": "fraction",
        "vs_baseline": top["fraction"] / 0.80,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
