"""bf16 matrix products with f32 accumulation: the port of ompi_tpu/ops/mxu.py.

``contract_f32`` is the einsum with bf16 operands and an f32 result that the
JAX package writes as ``einsum(..., preferred_element_type=float32)``;
``einsum_bf16`` rounds that result to bf16 once, as ``mxu.einsum_bf16``'s
forward does. A plain bf16 ``torch.matmul`` would differ: it returns bf16,
and cuBLAS may reduce in bf16 along the way.

On the card the product is one ``torch.mm`` with ``out_dtype=float32``
(bf16 tensor cores, f32 accumulation and output). On the CPU, where that
overload has no kernel, the bf16 operands are widened to f32 first, which
gives the same products exactly and sums them in f32.

The custom backward of ``einsum_bf16`` comes with the training slice.
"""

from __future__ import annotations

import functools
import math
from typing import List, Tuple

import torch


@functools.lru_cache(maxsize=None)
def _plan(pattern: str) -> Tuple[str, str, str, List[str], List[str], List[str]]:
    ins, out = pattern.replace(" ", "").split("->")
    a, b = ins.split(",")
    if "." in pattern or any(c in b and c in out for c in a):
        raise ValueError(f"contract_f32 takes no ellipsis and no batch "
                         f"dims: {pattern!r}")
    con = [c for c in a if c in b]
    free_a = [c for c in a if c not in con]
    free_b = [c for c in b if c not in con]
    if sorted(free_a + free_b) != sorted(out):
        raise ValueError(f"bad contraction {pattern!r}")
    return a, b, out, con, free_a, free_b


def _mm_f32(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[M, K] x [K, N], bf16 operands -> f32 [M, N] with f32 accumulation."""
    if a.is_cuda:
        return torch.mm(a, b, out_dtype=torch.float32)
    return a.float() @ b.float()


def contract_f32(pattern: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(pattern, x, w)`` of the bf16-rounded operands, accumulated and
    returned in f32. Every index shared by ``x`` and ``w`` is contracted."""
    a, b, out, con, free_a, free_b = _plan(pattern)
    size = dict(zip(a, x.shape))
    size.update(zip(b, w.shape))
    k = math.prod(size[c] for c in con)
    x2 = x.to(torch.bfloat16).permute(
        [a.index(c) for c in free_a + con]).reshape(-1, k)
    w2 = w.to(torch.bfloat16).permute(
        [b.index(c) for c in con + free_b]).reshape(k, -1)
    y = _mm_f32(x2, w2).reshape([size[c] for c in free_a + free_b])
    return y.permute([(free_a + free_b).index(c) for c in out])


def einsum_bf16(pattern: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``contract_f32`` rounded once to a contiguous bf16 tensor."""
    return contract_f32(pattern, a, b).to(
        torch.bfloat16, memory_format=torch.contiguous_format)
