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

That overload has no derivative, so both functions are
``torch.autograd.Function``s (``_Contract``). Each saves its bf16 operands;
its backward is the two transposed products, again bf16 operands (the
cotangent rounded to bf16) with f32 accumulation, and each operand's
cotangent comes back rounded to bf16 and then in that operand's dtype, as
JAX's AD through the bf16 cast and the f32-accumulating einsum gives it.
``einsum_bf16``'s output is bf16, so only the half-size operands and
output live across the backward, as ``mxu._mm_fwd``/``_mm_bwd`` arrange.
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


def _einsum_f32(pattern: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(pattern, x, w)`` of bf16 ``x`` and ``w`` as one ``_mm_f32``."""
    a, b, out, con, free_a, free_b = _plan(pattern)
    size = dict(zip(a, x.shape))
    size.update(zip(b, w.shape))
    k = math.prod(size[c] for c in con)
    x2 = x.permute([a.index(c) for c in free_a + con]).reshape(-1, k)
    w2 = w.permute([b.index(c) for c in con + free_b]).reshape(k, -1)
    y = _mm_f32(x2, w2).reshape([size[c] for c in free_a + free_b])
    return y.permute([(free_a + free_b).index(c) for c in out])


class _Contract(torch.autograd.Function):
    """``_einsum_f32`` of the bf16-rounded operands, returned in
    ``out_dtype``, with the transposed products as its backward."""

    @staticmethod
    def forward(ctx, pattern, x, w, out_dtype):
        xb, wb = x.to(torch.bfloat16), w.to(torch.bfloat16)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            ctx.save_for_backward(xb, wb)
            ctx.args = (pattern, x.dtype, w.dtype)
        y = _einsum_f32(pattern, xb, wb)
        if out_dtype == torch.float32:
            return y
        return y.to(out_dtype, memory_format=torch.contiguous_format)

    @staticmethod
    def backward(ctx, g):
        xb, wb = ctx.saved_tensors
        pattern, x_dtype, w_dtype = ctx.args
        a, b, out, _, _, _ = _plan(pattern)
        gb = g.to(torch.bfloat16)
        dx = dw = None
        if ctx.needs_input_grad[1]:
            dx = _einsum_f32(f"{out},{b}->{a}", gb, wb).to(
                torch.bfloat16).to(x_dtype)
        if ctx.needs_input_grad[2]:
            dw = _einsum_f32(f"{a},{out}->{b}", xb, gb).to(
                torch.bfloat16).to(w_dtype)
        return None, dx, dw, None


def contract_f32(pattern: str, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``einsum(pattern, x, w)`` of the bf16-rounded operands, accumulated and
    returned in f32. Every index shared by ``x`` and ``w`` is contracted.
    Differentiable in ``x`` and ``w``."""
    return _Contract.apply(pattern, x, w, torch.float32)


def einsum_bf16(pattern: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``contract_f32`` rounded once to a contiguous bf16 tensor; its
    backward accumulates in f32."""
    return _Contract.apply(pattern, a, b, torch.bfloat16)
