#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (ompi_tpu_torch) on one NVIDIA card.

Run from the root of a checkout, with no arguments:

    python3 chip_smoke.py
    python3 chip_smoke.py --profile   # and where the forward's time goes

Phases, each of which ends the run with a non-zero exit if it fails:

1. the card's name and power limit (nvidia-smi);
2. build every CUDA kernel of the port from ``ompi_tpu_torch/csrc``;
3. each kernel against its plain PyTorch version on the card, at the shapes
   the model gives it, with times for the kernel, the plain version, the
   PyTorch library call for the same function, and the card's bound;
4. the main path: the flagship transformer forward at full width
   (vocab 32768, d_model 1024, 8 heads, 8 layers, d_ff 4096, seq 1024,
   batch 8, random weights from a seed) answering 3 requests, with the
   kernel launch counts read around it and the logits held against the
   same forward on the plain attention path; then ``ompi_tpu_torch.entry``
   on the card, held the same way;
5. with ``--profile``: the flagship forward under ``torch.profiler``, each
   kernel's device time per request and the device's busy share;
6. one JSON line describing every kernel, then the device JSON line last.

Without a CUDA device, or outside a checkout, it exits non-zero before
printing any result.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np
import torch

# H100 SXM data-sheet peaks (dense): bf16 tensor cores and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12

FLAGSHIP = dict(vocab=32768, d_model=1024, n_heads=8, n_layers=8, d_ff=4096,
                seq_len=1024)
BATCH = 8
REQUESTS = 3
RELATIONS = {"causal": (False, True), "full": (True, False),
             "none": (False, False)}
OUT_TOL, LSE_TOL, LOGITS_TOL = 2e-2, 1e-2, 5e-2


def require(cond: bool, what: str) -> None:
    if not cond:
        print(f"chip_smoke: FAILED: {what}", file=sys.stderr, flush=True)
        sys.exit(1)


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``iters`` calls, by CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def qkv(shape, seed, dtype):
    rng = np.random.RandomState(seed)
    return tuple(torch.from_numpy(rng.standard_normal(shape).astype(
        np.float32)).to("cuda", dtype) for _ in range(3))


def check_flash(fa, shape, layout, dtype, seed):
    """Kernel against plain version for the three relations; returns the
    largest errors on out and on the lse of attended rows."""
    q, k, v = qkv(shape, seed, dtype)
    errs = []
    for rel, (kf, kt) in RELATIONS.items():
        o_k, l_k = fa.flash_block(q, k, v, kf, kt, layout=layout)
        o_p, l_p = fa.flash_block_reference(q, k, v, kf, kt, layout=layout)
        torch.cuda.synchronize()
        require(bool(torch.isfinite(o_k).all()), f"flash_fwd {rel} finite")
        if rel == "none":
            require(bool((o_k == 0).all()) and bool(
                (l_k == np.float32(fa.NEG_BIG)).all()),
                f"flash_fwd none block: out 0, lse -1e30 ({layout})")
            continue
        e_out = float((o_k - o_p).abs().max())
        e_lse = float((l_k - l_p).abs().max())
        print(f"flash_fwd {rel:6s} {layout} {tuple(shape)} {dtype}: "
              f"max|out err| {e_out:.3e}  max|lse err| {e_lse:.3e}",
              flush=True)
        require(e_out <= OUT_TOL and e_lse <= LSE_TOL,
                f"flash_fwd {rel} {layout} within {OUT_TOL}/{LSE_TOL}")
        errs.append(e_out)
    return max(errs)


def flash_bound_ms(B, H, T, D, in_bytes):
    """Least time for the causal block: q/k/v read once, f32 out and lse
    written once; flops of the two products over the visible pairs."""
    pairs = B * H * T * (T + 1) / 2
    flops = 4.0 * D * pairs
    nbytes = 3 * B * H * T * D * in_bytes + B * H * T * (D + 1) * 4
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops > t_bytes
                                       else "bytes")


def profile_forward(tfm, params, tokens, cfg, card) -> None:
    """Each kernel's device time per request over REQUESTS forwards, and
    the device's busy share of the wall time, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(REQUESTS):
            tfm.forward(params, tokens, cfg)
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = sorted((e for e in prof.key_averages()
                      if e.device_type == DeviceType.CUDA),
                     key=lambda e: e.device_time_total, reverse=True)
    busy_ms = sum(e.device_time_total for e in kernels) / 1e3
    print(f"profile: {cfg}, batch {BATCH}, {REQUESTS} requests on {card}")
    for e in kernels[:15]:
        print(f"{e.device_time_total / 1e3 / REQUESTS:10.4f} ms/request"
              f"  x{e.count // REQUESTS:<4d} {e.key[:100]}")
    print(f"profile: wall {wall_ms / REQUESTS:.3f} ms/request, device "
          f"{busy_ms / REQUESTS:.3f} ms/request, busy share "
          f"{busy_ms / wall_ms:.3f}, {len(kernels)} kernels", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile the flagship forward's kernels")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from ompi_tpu_torch import entry as entry_mod
    from ompi_tpu_torch.models import transformer as tfm
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, "nvidia-smi reads the card")
    card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    print(f"python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    logs = _build.build()
    for name, log in logs.items():
        print(f"--- nvcc {name}\n{log.strip()}", flush=True)
    print(f"build: {time.perf_counter() - t0:.1f} s for {len(logs)} "
          f"kernel(s)", flush=True)

    # 3. kernel against plain version
    B, H, T, D = BATCH, FLAGSHIP["n_heads"], FLAGSHIP["seq_len"], \
        FLAGSHIP["d_model"] // FLAGSHIP["n_heads"]
    err = check_flash(fa, (B, H, T, D), "bhtd", torch.bfloat16, 0)
    check_flash(fa, (B, H, T, D), "bhtd", torch.float32, 1)
    check_flash(fa, (4, 256, 8, 32), "bthd", torch.bfloat16, 2)
    check_flash(fa, (4, 8, 256, 32), "bhtd", torch.bfloat16, 4)

    q, k, v = qkv((B, H, T, D), 3, torch.bfloat16)
    ms = time_ms(lambda: fa.flash_block(q, k, v, False, True, layout="bhtd"))
    plain_ms = time_ms(lambda: fa.flash_block_reference(
        q, k, v, False, True, layout="bhtd"))
    library_ms = time_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
        q, k, v, is_causal=True))
    bound_ms, bound_by = flash_bound_ms(B, H, T, D, 2)
    print(f"flash_fwd causal {(B, H, T, D)} bf16: kernel {ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}) on {card}", flush=True)
    del q, k, v

    # 4. the main path
    cfg = tfm.Config(**FLAGSHIP)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), "cuda")
    rng = np.random.RandomState(0)
    batches = [torch.from_numpy(rng.randint(
        0, cfg.vocab, size=(BATCH, cfg.seq_len))).to("cuda")
        for _ in range(REQUESTS)]

    def serve(tokens):
        return tfm.forward(params, tokens, cfg)

    serve(batches[0])  # warm-up: cuBLAS handles, allocator
    torch.cuda.synchronize()
    fa.KERNEL_LAUNCHES = 0
    times, first = [], None
    for tokens in batches:
        t0 = time.perf_counter()
        logits = serve(tokens)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
        require(tuple(logits.shape) == (BATCH, cfg.seq_len, cfg.vocab),
                f"logits shape {tuple(logits.shape)}")
        require(bool(torch.isfinite(logits).all()), "logits finite")
        if first is None:
            first = logits
        del logits
    launches = fa.KERNEL_LAUNCHES
    require(launches == REQUESTS * cfg.n_layers,
            f"flash_fwd launched {launches} times on the main path, "
            f"expected {REQUESTS * cfg.n_layers}")
    plain = tfm.forward(params, batches[0], cfg, use_flash=False)
    logits_err = float((first - plain).abs().max())
    require(bool(torch.allclose(first, plain, atol=LOGITS_TOL,
                                rtol=LOGITS_TOL)),
            f"logits vs plain attention path: max abs err {logits_err}")
    fwd_ms = 1e3 * sum(times) / len(times)
    print(f"forward {cfg} batch {BATCH}: {fwd_ms:.3f} ms/request "
          f"({', '.join(f'{1e3 * t:.3f}' for t in times)}), "
          f"{BATCH * cfg.seq_len / (fwd_ms / 1e3):.1f} tokens/s, "
          f"flash_fwd launches {launches}, max|logits - plain| "
          f"{logits_err:.3e} on {card}", flush=True)

    # the user's entry point, on the card
    fn, fn_args = entry_mod.entry("cuda")
    ecfg = entry_mod.ENTRY_CONFIG
    fa.KERNEL_LAUNCHES = 0
    e_logits = fn(*fn_args)
    torch.cuda.synchronize()
    e_launches = fa.KERNEL_LAUNCHES
    require(e_launches == ecfg.n_layers,
            f"entry(): flash_fwd launched {e_launches} times, expected "
            f"{ecfg.n_layers}")
    require(bool(torch.isfinite(e_logits).all()), "entry() logits finite")
    e_plain = tfm.forward(*fn_args, ecfg, use_flash=False)
    e_err = float((e_logits - e_plain).abs().max())
    require(bool(torch.allclose(e_logits, e_plain, atol=LOGITS_TOL,
                                rtol=LOGITS_TOL)),
            f"entry() logits vs plain attention path: max abs err {e_err}")
    print(f"entry() {ecfg}: logits {tuple(e_logits.shape)}, flash_fwd "
          f"launches {e_launches}, max|logits - plain| {e_err:.3e}",
          flush=True)
    del e_logits, e_plain, fn_args

    # 5. where the time goes
    if args.profile:
        profile_forward(tfm, params, batches[0], cfg, card)

    # 6. results
    print(json.dumps({"kernels": [{
        "name": "flash_fwd", "route": "cuda",
        "source": "ompi_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "ompi_tpu/ops/flash_attention.py:101",
        "launches": launches, "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bound_ms, "bound_by": bound_by,
        "library_ms": library_ms}]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
