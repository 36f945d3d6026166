"""Where the flagship training step spends its time: the step and four
ablations of it, each timed as ``bench.bench_mfu`` times a step.

    python -m ompi_tpu_torch.tools.profile_mfu [--device cpu] [--ksteps 8]

The counterpart of the repo's ``tools/profile_mfu.py``: the flagship
(vocab 32768, d_model 1024, 8 heads, 8 layers, d_ff 4096, seq 1024) at
batch 32 on the card, ``bench``'s small config at batch 2 on the CPU. Its
loss is the whole-logits cross-entropy (log-sum-exp minus the gold logit),
as that tool's is. The variants:

- full step (flash attention, cross-entropy);
- the sum of the logits times 1e-6 in place of the cross-entropy;
- identity attention, (q + k + v), and dense plain-PyTorch attention in
  place of flash attention: ``bench.attention`` replaces
  ``models.transformer.ring_attention``, the name the model calls;
- the forward and loss alone.

Each prints its ms a step and its MFU against ``bench.peak_for`` (none on
the CPU), then the step's least time at that peak.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.tools import bench

BATCH = {"cuda": 32, "cpu": 2}
KSTEPS = 8


def full_ce(cfg: tfm.Config, denom: float):
    """The whole-logits cross-entropy, its mean over ``denom`` tokens."""

    def loss(p, tk, tg):
        logits = tfm.forward(p, tk, cfg)
        top = logits.amax(-1, keepdim=True)
        logz = torch.log(torch.exp(logits - top).sum(-1)) + top[..., 0]
        gold = logits.gather(-1, tg[..., None].long())[..., 0]
        return (logz - gold).sum() / denom

    return loss


def main(device: DeviceLike = None, cfg: Optional[tfm.Config] = None,
         batch: Optional[int] = None, ksteps: int = KSTEPS) -> dict:
    """Prints one row a variant and returns them: label -> {ms, mfu (None
    without a known peak), launches (of the timed steps)}."""
    dev = resolve_device(device)
    kind = "cuda" if dev.type == "cuda" else "cpu"
    cfg = cfg or tfm.Config(**(bench.FLAGSHIP if kind == "cuda"
                               else bench.SMALL))
    batch = batch or BATCH[kind]
    name = bench.device_name(dev)
    peak = bench.peak_for(name)
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    toks, tgts = bench.model_batch(cfg, batch, dev)
    flops = bench.train_flops(params, cfg, batch * cfg.seq_len)
    denom = float(batch * cfg.seq_len)
    print(f"profile_mfu {cfg} batch {batch}, {ksteps} steps a variant on "
          f"{name}", flush=True)
    variants = {
        "full step (flash, CE)": bench.make_step(cfg, full_ce(cfg, denom)),
        "no-CE loss (sum of logits)": bench.make_step(
            cfg, bench.sum_loss(cfg, denom)),
        "identity attention": bench.make_step(cfg, full_ce(cfg, denom),
                                              "identity"),
        "dense attention": bench.make_step(cfg, full_ce(cfg, denom), "dense"),
        "forward only": bench.make_step(cfg, full_ce(cfg, denom),
                                        train=False),
    }
    rows = {}
    for label, step in variants.items():
        t, _, launches = bench.timed_steps(step, params, toks, tgts, ksteps,
                                           dev)
        mfu = flops / t / peak if peak else None
        rows[label] = {"ms": t * 1e3, "mfu": mfu, "launches": launches}
        print(f"{label:32s} step={t * 1e3:9.3f} ms  mfu="
              f"{'n/a' if mfu is None else f'{mfu:.4f}'}  launches "
              f"{launches}", flush=True)
    if peak:
        print(f"ideal matmul-bound step: {flops / peak * 1e3:.3f} ms",
              flush=True)
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="cuda (the default) or cpu")
    ap.add_argument("--ksteps", type=int, default=KSTEPS)
    args = ap.parse_args()
    main(args.device, ksteps=args.ksteps)
