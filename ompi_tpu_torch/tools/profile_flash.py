"""Flash attention at one layer's attention of the head-dim-64 model
([32, 16, 1024, 64] 'bhtd', causal), against its alternatives.

    python -m ompi_tpu_torch.tools.profile_flash [--device cpu]

The counterpart of the repo's ``tools/profile_flash.py`` (``main``,
``in_situ`` and ``from_einsum``, here all in one run). Each row is
``bench.device_ms`` of ``reps`` calls back to back, with its TF/s and its
share of the card's peak (``bench.peak_for``; none on the CPU):

- "ours": the port's ``flash_block``, which launches the Hopper kernels on
  the card (each row records their launches) and takes their plain
  versions on the CPU; forward, and forward with the gradients of q, k, v;
- "sdpa": ``torch.nn.functional.scaled_dot_product_attention``, the
  library's kernel, a comparison row only (no path of the port calls it);
- "dense": plain PyTorch attention with bf16 scores
  (``bench.dense_attention``);
- "in-situ": ``ring_attention`` at sp = 1, the model's call, with the
  gradient of q alone and of all three;
- "einsum-fed": q, k and v as the model's bf16 products of one input, then
  ``flash_block``, with the gradients of the input and the weights.

q, k and v are bf16, as the model gives them (the kernels read bf16 only).
Flops count the causal half: 2 products of T*T/2*D a (batch, head) forward,
2.5 times that backward; the dense rows count the whole square.
"""

from __future__ import annotations

import argparse
from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.ops.flash_attention import flash_block
from ompi_tpu_torch.ops.mxu import einsum_bf16
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.tools import bench

SHAPE = {"cuda": (32, 16, 1024, 64), "cpu": (1, 2, 64, 16)}
REPS = 16


def _grads(fn, *xs):
    """The gradients of sum(fn(*xs) * 1e-3) in each of ``xs``."""
    xs = [x.detach().requires_grad_() for x in xs]
    return torch.autograd.grad((fn(*xs).float() * 1e-3).sum(), xs)


def main(device: DeviceLike = None,
         shape: Optional[Tuple[int, int, int, int]] = None,
         reps: int = REPS) -> dict:
    """Prints one row a variant and returns them: label -> {ms, tflops,
    eff (None without a known peak), launches}."""
    dev = resolve_device(device)
    B, H, T, D = shape or SHAPE["cuda" if dev.type == "cuda" else "cpu"]
    peak = bench.peak_for(bench.device_name(dev))
    gen = torch.Generator(dev).manual_seed(0)
    q, k, v = (torch.randn((B, H, T, D), device=dev, generator=gen)
               .to(torch.bfloat16) for _ in range(3))
    fwd_flops = B * H * 2 * T * T * D
    bwd_flops = fwd_flops * 2.5
    print(f"profile_flash [{B}, {H}, {T}, {D}] bf16 causal 'bhtd' on "
          f"{bench.device_name(dev)}, {reps} calls a round", flush=True)
    rows = {}

    def timed(label, fn, flops):
        before = bench.launch_counts()
        ms = bench.device_ms(fn, reps, 3, dev)
        after = bench.launch_counts()
        tflops = flops / ms / 1e9
        eff = tflops * 1e12 / peak if peak else None
        rows[label] = {"ms": ms, "tflops": tflops, "eff": eff,
                       "launches": {n: after[n] - before[n] for n in after}}
        print(f"{label:34s} {ms:9.4f} ms  {tflops:8.2f} TF/s  eff="
              f"{'n/a' if eff is None else f'{eff:.3f}'}", flush=True)

    def ours(q_, k_, v_):
        return flash_block(q_, k_, v_, False, True, layout="bhtd")[0]

    def sdpa(q_, k_, v_):
        return F.scaled_dot_product_attention(q_, k_, v_, is_causal=True)

    def in_situ(q_, k_, v_):
        return ring_attention(q_, k_, v_, "sp", 1, causal=True,
                              mxu_dtype=torch.bfloat16, chunk=T,
                              layout="bhtd")

    timed("ours flash fwd", lambda: ours(q, k, v), fwd_flops)
    timed("ours flash fwd+bwd", lambda: _grads(ours, q, k, v),
          fwd_flops + bwd_flops)
    timed("sdpa fwd (library)", lambda: sdpa(q, k, v), fwd_flops)
    timed("sdpa fwd+bwd (library)", lambda: _grads(sdpa, q, k, v),
          fwd_flops + bwd_flops)
    timed("dense fwd", lambda: bench.dense_attention(q, k, v),
          fwd_flops * 2)
    timed("dense fwd+bwd", lambda: _grads(bench.dense_attention, q, k, v),
          (fwd_flops + bwd_flops) * 2)
    timed("in-situ ring(sp=1) fwd+bwd(dq)",
          lambda: _grads(lambda q_: in_situ(q_, k, v), q),
          fwd_flops + bwd_flops)
    timed("in-situ ring(sp=1) fwd+bwd(all)", lambda: _grads(in_situ, q, k, v),
          fwd_flops + bwd_flops)

    # the model's layout: q, k, v as bf16 products of one [B, T, H*D] input
    h = torch.randn((B, T, H * D), device=dev, generator=gen)
    w = torch.randn((H * D, H, 3 * D), device=dev, generator=gen) * 0.03

    def einsum_fed(h_, w_):
        q_, k_, v_ = (einsum_bf16("btd,dhf->bhtf", h_, part)
                      for part in w_.split(D, dim=-1))
        return ours(q_, k_, v_)

    proj = 3 * 3 * 2 * B * T * (H * D) * D
    timed("einsum-fed flash fwd+bwd", lambda: _grads(einsum_fed, h, w),
          fwd_flops + bwd_flops + proj)
    if peak:
        print(f"{'ideal (attention; projections)':34s} "
              f"{(fwd_flops + bwd_flops) / peak * 1e3:9.4f} ms; "
              f"{proj / peak * 1e3:.4f} ms", flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    main(ap.parse_args().device)
