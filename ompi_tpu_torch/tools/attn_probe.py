"""Probes for the step's MFU: flash attention alone, and the training step
with and without recomputation, with the card's peak memory.

    python -m ompi_tpu_torch.tools.attn_probe [--device cpu] [flash|step|all]

The counterpart of the repo's ``tools/attn_probe.py``, on the card at its
shapes: ``flash_block`` forward and forward+backward (the backward with the
output as its cotangent) at [32, 16, 1024, 64] bf16 causal 'bhtd', then
the flagship step at 16 heads (head dim 64), batch 32, with ``remat`` False
and True. Each is ``bench``'s timing of ``k`` calls or steps.

``peak`` is ``torch.cuda.max_memory_allocated`` over the step's timed run
after ``reset_peak_memory_stats``: all the memory the step held at once,
its parameters and inputs included. It is not the quantity the JAX tool
prints (XLA's ``temp_size_in_bytes``, the compiled program's scratch).
The CPU run, at a tiny shape, reports none.
"""

from __future__ import annotations

import argparse
import dataclasses
from typing import Optional, Tuple

import torch

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.ops.flash_attention import flash_block
from ompi_tpu_torch.tools import bench

SHAPE = {"cuda": (32, 16, 1024, 64), "cpu": (1, 2, 64, 16)}
STEP = {"cuda": dict(bench.FLAGSHIP, n_heads=16),
        "cpu": dict(bench.SMALL, n_heads=8)}
K = 8


def main(device: DeviceLike = None, which: str = "all",
         shape: Optional[Tuple[int, int, int, int]] = None,
         cfg: Optional[tfm.Config] = None, k: int = K) -> dict:
    """Prints one row a probe and returns them: label -> {ms, and TF/s or
    mfu and peak bytes}."""
    dev = resolve_device(device)
    kind = "cuda" if dev.type == "cuda" else "cpu"
    B, H, T, D = shape or SHAPE[kind]
    name = bench.device_name(dev)
    peak = bench.peak_for(name)
    print(f"attn_probe on {name}, {k} calls or steps a probe", flush=True)
    rows = {}

    if which in ("all", "flash"):
        gen = torch.Generator(dev).manual_seed(0)
        q, k_, v = (torch.randn((B, H, T, D), device=dev, generator=gen)
                    .to(torch.bfloat16) for _ in range(3))

        def one(q_, kk, vv):
            return flash_block(q_, kk, vv, False, True, layout="bhtd")[0]

        def vjp():
            xs = [x.detach().requires_grad_() for x in (q, k_, v)]
            o = one(*xs)
            return torch.autograd.grad(o, xs, o.detach())

        fl = 2 * 2 * (T * T // 2) * D * B * H  # causal forward
        for label, fn, flops in (("flash fwd", lambda: one(q, k_, v), fl),
                                 ("flash fwd+bwd", vjp, fl * 3.5)):
            ms = bench.device_ms(fn, k, 3, dev)
            rows[label] = {"ms": ms, "tflops": flops / ms / 1e9}
            print(f"{label:18s} [{B}, {H}, {T}, {D}] {ms:9.4f} ms  "
                  f"{flops / ms / 1e9:8.2f} TF/s", flush=True)

    if which in ("all", "step"):
        base = cfg or tfm.Config(**STEP[kind])
        batch = B
        for remat in (False, True):
            c = dataclasses.replace(base, remat=remat)
            params = tfm.init_params(c, torch.Generator().manual_seed(0), dev)
            toks, tgts = bench.model_batch(c, batch, dev)
            step, _ = tfm.make_train_step(c, dev)
            if kind == "cuda":
                torch.cuda.reset_peak_memory_stats(dev)
            t, _, _ = bench.timed_steps(step, params, toks, tgts, k, dev)
            mem = torch.cuda.max_memory_allocated(dev) if kind == "cuda" \
                else None
            fl = bench.train_flops(params, c, batch * c.seq_len)
            mfu = fl / t / peak if peak else None
            label = f"step remat={remat}"
            rows[label] = {"ms": t * 1e3, "mfu": mfu, "peak_bytes": mem}
            print(f"{label:18s} batch {batch}: {t * 1e3:9.3f} ms  mfu="
                  f"{'n/a' if mfu is None else f'{mfu:.4f}'}  peak="
                  f"{'n/a' if mem is None else f'{mem / 2**30:.2f} GiB'}",
                  flush=True)
            del params
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("which", nargs="?", default="all",
                    choices=("all", "flash", "step"))
    args = ap.parse_args()
    main(args.device, args.which)
