"""Flagship causal-LM transformer: the port of ompi_tpu/models/transformer.py,
forward only, on one card.

Parameters keep the JAX package's layout (no transposes), so
``params_from_jax`` is a dtype/device copy of the JAX ``init_params`` tree:

- ``embed`` [V, D], ``pos`` [S, D], ``ln_f`` [D];
- per block ``ln1``/``ln2`` [D], ``qkv`` [D, H, 3*hd] (q, k, v sliced per
  head), ``wo`` [D, D] (read as [H, hd, D]), ``w1`` [D, F], ``w2`` [F, D].

Numerics follow the JAX forward: bias-free layer norm with eps 1e-6; bf16
products with f32 accumulation; bf16 q/k/v, bf16 attention output and bf16
ReLU; f32 residual stream; tied-embedding f32 logits.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Optional

import numpy as np
import torch

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.ops.mxu import contract_f32, einsum_bf16
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.ops.softmax_xent import logits_matmul
from ompi_tpu_torch.parallel import axes


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 512
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads


def init_params(cfg: Config, generator: torch.Generator,
                device: DeviceLike = None) -> Dict[str, Any]:
    """Random weights in the JAX layout and scales (normal / sqrt(fan_in),
    unit layer-norm gains). ``generator`` is a CPU generator: values are
    drawn on the CPU and then moved, so a seed gives the same weights on
    every device."""
    dev = resolve_device(device)

    def normal(*shape, fan_in):
        x = torch.randn(shape, generator=generator, dtype=torch.float32)
        return (x / math.sqrt(fan_in)).to(dev)

    ones = lambda: torch.ones(cfg.d_model, dtype=torch.float32, device=dev)
    D, F = cfg.d_model, cfg.d_ff
    params: Dict[str, Any] = {
        "embed": normal(cfg.vocab, D, fan_in=D),
        "pos": normal(cfg.seq_len, D, fan_in=D),
        "ln_f": ones(),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "ln1": ones(),
            "qkv": normal(D, cfg.n_heads, 3 * cfg.head_dim, fan_in=D),
            "wo": normal(D, D, fan_in=D),
            "ln2": ones(),
            "w1": normal(D, F, fan_in=D),
            "w2": normal(F, D, fan_in=F),
        })
    return params


def params_from_jax(tree, device: DeviceLike = None):
    """The JAX ``init_params`` tree (leaves as numpy arrays) as f32 tensors
    on ``device``, same structure and layout."""
    dev = resolve_device(device)
    if isinstance(tree, dict):
        return {k: params_from_jax(v, dev) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_jax(v, dev) for v in tree]
    return torch.from_numpy(np.array(tree, dtype=np.float32)).to(dev)


def _ln(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=-1, keepdim=True)
    x = x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)
    return x * g


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 matmul with f32 accumulation and output."""
    return contract_f32("btd,df->btf", a, w)


def features_local(params, tokens: torch.Tensor, cfg: Config,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Forward up to the final layer norm: features [B, T, D] f32.

    This is the JAX ``features_local(..., in_mesh=True)`` at dp = sp = tp = 1:
    attention is ring attention over the 'sp' axis in the kernel's 'bhtd'
    layout, and the row-parallel outputs pass through the 'tp' allreduce
    (identities at size 1). ``use_flash`` is ``ring_attention``'s: None lets
    it pick the Hopper kernel on the card; False forces the plain path.
    """
    T = tokens.shape[1]
    hd = cfg.head_dim
    pos_idx = axes.rank("sp") * T + torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()] + params["pos"][pos_idx][None]

    for blk in params["blocks"]:
        h = _ln(x, blk["ln1"])
        hb = h.to(torch.bfloat16)
        wb = blk["qkv"].to(torch.bfloat16)  # [D, H, 3*hd]
        q = einsum_bf16("btd,dhf->bhtf", hb, wb[..., :hd])
        k = einsum_bf16("btd,dhf->bhtf", hb, wb[..., hd:2 * hd])
        v = einsum_bf16("btd,dhf->bhtf", hb, wb[..., 2 * hd:])
        att = ring_attention(q, k, v, "sp", 1, mxu_dtype=torch.bfloat16,
                             chunk=T, use_flash=use_flash, layout="bhtd")
        wo = blk["wo"].reshape(cfg.n_heads, hd, cfg.d_model)
        x = x + axes.allreduce(contract_f32("bhtf,hfd->btd", att, wo), "tp")

        h2 = _ln(x, blk["ln2"])
        ff1 = torch.clamp_min(
            einsum_bf16("btd,df->btf", h2.to(torch.bfloat16), blk["w1"]), 0)
        x = x + axes.allreduce(_mm(ff1, blk["w2"]), "tp")

    return _ln(x, params["ln_f"])


def forward(params, tokens: torch.Tensor, cfg: Config,
            use_flash: Optional[bool] = None) -> torch.Tensor:
    """Single-card forward to logits [B, T, vocab] f32.

    It differs from the JAX ``forward()`` on purpose: that one runs the
    out-of-mesh branch, whose dense reference attention never reaches a
    kernel. Here the forward follows the in-mesh branch (the one
    ``bench_mfu`` runs on a 1x1x1 mesh), so that attention goes through the
    flash kernel on the card.
    """
    x = features_local(params, tokens, cfg, use_flash=use_flash)
    return logits_matmul(x, params["embed"])
