"""Chunked softmax cross-entropy: the port of ompi_tpu/ops/softmax_xent.py.

The naive causal-LM loss would hold the whole [B, T, V] f32 logits tensor
(1.07 GB at the flagship shape, batch 8) and let autograd keep it across
the backward. ``softmax_xent_sum`` streams the vocabulary projection in
sequence chunks instead, with an explicit recompute in its backward
(``torch.autograd.Function``, the JAX ``custom_vjp``): the forward keeps
only the per-row logsumexp ([B, T] f32); the backward re-scores each chunk
and feeds the (softmax - onehot) rows, in bf16, straight into the dx and dw
products. Live logits stay at [B, chunk, V].

No kernel of the JAX package is involved: the products are plain bf16
matmuls with f32 accumulation (``ops.mxu.contract_f32``).
"""

from __future__ import annotations

from typing import Sequence

import torch

from ompi_tpu_torch.ops.mxu import contract_f32
from ompi_tpu_torch.parallel import axes


def _chunk_count(T: int, chunk_t: int) -> int:
    """The chunk length: ``chunk_t`` halved until it divides T."""
    c = min(chunk_t, T)
    while T % c:
        c //= 2
    return max(c, 1)


def logits_matmul(xc: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, T, D] x [V, D] -> [B, T, V] f32 logits from bf16 operands."""
    return contract_f32("btd,vd->btv", xc, w)


def _lse(logits: torch.Tensor) -> torch.Tensor:
    m = logits.amax(dim=-1)
    return m + torch.log(torch.exp(logits - m[..., None]).sum(dim=-1))


class _SoftmaxXent(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x, w, targets, chunk_t, psum_axes):
        B, T, D = x.shape
        tc = _chunk_count(T, chunk_t)
        targets = targets.long()
        total = torch.zeros((), dtype=torch.float32, device=x.device)
        lses = []
        for c0 in range(0, T, tc):
            xb, tb = x[:, c0:c0 + tc], targets[:, c0:c0 + tc]
            lse = _lse(logits_matmul(xb, w))  # [B, tc]
            # the gold logit from the gathered embedding row (a [B, tc, D]
            # gather and a rowwise dot of bf16 values summed in f32), not a
            # gather over the [B, tc, V] logits
            gold = (xb.to(torch.bfloat16).float()
                    * w[tb].to(torch.bfloat16).float()).sum(dim=-1)
            total = total + (lse - gold).sum()
            lses.append(lse)
        ctx.save_for_backward(x, w, targets, torch.cat(lses, dim=1))
        ctx.args = (tc, tuple(psum_axes))
        return total

    @staticmethod
    def backward(ctx, g):
        x, w, targets, lses = ctx.saved_tensors
        tc, psum_axes = ctx.args
        T = x.shape[1]
        dw = torch.zeros(w.shape, dtype=torch.float32, device=w.device)
        dx = torch.empty(x.shape, dtype=torch.float32, device=x.device)
        for c0 in range(0, T, tc):
            xb, tb = x[:, c0:c0 + tc], targets[:, c0:c0 + tc]
            p = torch.exp(logits_matmul(xb, w) - lses[:, c0:c0 + tc, None])
            # softmax - onehot, rounded to bf16 for both products
            d = p.scatter_add_(-1, tb[..., None], torch.full(
                tb[..., None].shape, -1.0, device=p.device)).to(torch.bfloat16)
            dx[:, c0:c0 + tc] = contract_f32("btv,vd->btd", d, w)
            dw += contract_f32("btv,btd->vd", d, xb)
        gf = g.float()
        dw = gf * dw
        dx = gf * dx
        # w is replicated over the axes x is sharded on: its cotangent is
        # the sum over those shards (identities at size 1)
        for axis in psum_axes:
            dw = axes.allreduce(dw, axis)
        return dx.to(x.dtype), dw.to(w.dtype), None, None, None


def softmax_xent_sum(x: torch.Tensor, w: torch.Tensor, targets: torch.Tensor,
                     chunk_t: int = 128,
                     psum_axes: Sequence[str] = ()) -> torch.Tensor:
    """sum over (b, t) of [logsumexp_v(x . w^T) - (x . w^T)[target]].

    x: [B, T, D] features (products run bf16 with f32 accumulation),
    w: [V, D] output embedding, targets: [B, T] int. Returns an f32 scalar,
    differentiable in x and w. ``chunk_t`` bounds the live logits to
    [B, chunk_t, V]. ``psum_axes`` names the axes over which the caller has
    sharded x while w is replicated: w's cotangent is allreduced over them
    here. A caller that allreduces every gradient itself passes none.
    """
    return _SoftmaxXent.apply(x, w, targets, chunk_t, tuple(psum_axes))


def reference_xent_sum(x: torch.Tensor, w: torch.Tensor,
                       targets: torch.Tensor) -> torch.Tensor:
    """Dense O(B*T*V) f32 reference, for tests."""
    logits = torch.einsum("btd,vd->btv", x.float(), w.float())
    gold = torch.take_along_dim(logits, targets.long()[..., None],
                                dim=-1)[..., 0]
    return (_lse(logits) - gold).sum()
