"""Entry points: the port of ``__graft_entry__``.

- ``entry()``: the single-card forward of the flagship transformer.
- ``dryrun_multichip(n)``: one full dp x sp x tp training step over an
  n-rank world.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.models import transformer as tfm
from ompi_tpu_torch.parallel import axes
from ompi_tpu_torch.parallel.launch import run_world

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


def _factor(n: int):
    """n -> (dp, sp, tp) using every rank, preferring real multi-axis
    layouts when n allows (the JAX ``_factor``)."""
    tp = 2 if n % 2 == 0 else 1
    sp = 2 if (n // tp) % 2 == 0 else 1
    dp = n // (tp * sp)
    return dp, sp, tp


def dryrun_config(n: int, device: DeviceLike = None) -> tfm.Config:
    """The dry run's model for ``n`` ranks: the JAX ``dryrun_multichip``
    configuration (vocab 64, d_model 32, max(8, tp) heads, 2 layers,
    d_ff 64, seq_len 8*sp) on every device. Its head dim of 4 and shards
    of 8 rows are under the Hopper kernels' tile (``flash_supported``), so
    the dry run asks for the plain attention path by name (``_dryrun_rank``),
    as JAX's gate takes its lax path there."""
    resolve_device(device)
    _, sp, tp = _factor(n)
    return tfm.Config(vocab=64, d_model=32, n_heads=max(8, tp), n_layers=2,
                      d_ff=64, seq_len=8 * sp)


def _dryrun_rank(cfg: tfm.Config, tokens: np.ndarray,
                 targets: np.ndarray) -> float:
    mesh = axes.current_mesh()
    dims = (mesh.shape["dp"], mesh.shape["sp"], mesh.shape["tp"])
    params = tfm.init_params(cfg, torch.Generator().manual_seed(0),
                             mesh.device)
    # head dim 4 is under the flash kernels' tile: the plain attention
    # path, asked for by name (on the card the default raises there)
    step, place = tfm.make_train_step(cfg, mesh.device, *dims,
                                      use_flash=False)
    loss, _ = step(*place(params, tokens, targets))
    return float(loss)


def dryrun_multichip(n_devices: int, device: DeviceLike = None) -> float:
    """The FULL training step (tensor-parallel products with their
    allreduces, ring attention over 'sp', the gradient allreduce over
    ("dp", "sp"), SGD) over an ``n_devices``-rank (dp, sp, tp) world
    (``_factor``), one step on the batch of the JAX dry run (2 * dp rows of
    tokens from numpy seed 0). Returns the loss. Runs on the card unless
    ``device`` names the CPU (gloo ranks); raises where CUDA is absent."""
    dev = resolve_device(device)
    dims = _factor(n_devices)
    cfg = dryrun_config(n_devices, dev)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, cfg.vocab,
                       size=(2 * dims[0], cfg.seq_len)).astype(np.int64)
    tgts = np.roll(toks, -1, axis=1)
    losses = run_world(_dryrun_rank, n_devices, dev.type, cfg, toks, tgts,
                       shape=dims)
    return losses[0]
