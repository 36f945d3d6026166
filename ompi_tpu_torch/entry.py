"""Entry point: the port of ``__graft_entry__.entry()``."""

from __future__ import annotations

import torch

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.models import transformer as tfm

ENTRY_CONFIG = tfm.Config(vocab=8192, d_model=256, n_heads=8, n_layers=2,
                          d_ff=1024, seq_len=256)


def entry(device: DeviceLike = None):
    """Return (fn, example_args) for a single-card forward step of the
    flagship transformer at the JAX entry's configuration. Runs on ``cuda``
    unless ``device`` names another; raises where CUDA is absent."""
    dev = resolve_device(device)
    cfg = ENTRY_CONFIG
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0), dev)
    tokens = torch.zeros((4, cfg.seq_len), dtype=torch.int64, device=dev)

    def fn(params, tokens):
        return tfm.forward(params, tokens, cfg)

    return fn, (params, tokens)
