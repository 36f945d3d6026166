"""Vocabulary projection: the port of ompi_tpu/ops/softmax_xent.py's
``logits_matmul``. The chunked loss and its backward come with training."""

from __future__ import annotations

import torch

from ompi_tpu_torch.ops.mxu import contract_f32


def logits_matmul(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, D] x [V, D] -> [B, T, V] f32 logits from bf16 operands."""
    return contract_f32("btd,vd->btv", xc, w)
