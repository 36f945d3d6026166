"""The plain reference of the OPT-shaped model the port runs: forward,
loss, gradients and the SGD update, in float32, written from the model's
description alone.

The block is OPT's pre-LN decoder block (Zhang et al., arXiv:2205.01068)
with the port's departures, which the configuration files list: no biases,
LayerNorm eps 1e-6, learned positions read from row 0, a language-model
head tied to the token embedding, plain SGD. Weights come in the port's
layout: ``qkv`` [D, H, 3*hd] holds each head's q, k and v side by side,
``wo`` [D, D] takes the heads' outputs concatenated.

Products are float32 with TF32 off (``exact_f32``); attention is dense
and causal, computed in blocks of query rows; the loss and the gradients
are taken one sequence at a time. With ``precision="fp8"`` every product's
operands are rounded to float8 e4m3 under a per-tensor scale (and so is the
cotangent that flows back through them): that is the control, the reference
one precision step below the program's bf16 products.

It imports torch and nothing else.
"""

from __future__ import annotations

import contextlib
import math

import torch

E4M3_MAX = 448.0
QUERY_BLOCK = 512
LN_EPS = 1e-6


def _fp8(x: torch.Tensor) -> torch.Tensor:
    scale = E4M3_MAX / x.detach().abs().amax().clamp_min(1e-30)
    return (x * scale).to(torch.float8_e4m3fn).to(x.dtype) / scale


class _Fp8(torch.autograd.Function):

    @staticmethod
    def forward(ctx, x):
        return _fp8(x)

    @staticmethod
    def backward(ctx, g):
        return _fp8(g)


def _operand(x: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "f32":
        return x
    if precision == "fp8":
        return _Fp8.apply(x)
    raise ValueError(f"unknown precision {precision!r}")


def _mm(a: torch.Tensor, b: torch.Tensor, precision: str) -> torch.Tensor:
    return torch.matmul(_operand(a, precision), _operand(b, precision))


@contextlib.contextmanager
def exact_f32():
    """float32 products without TF32 while the block runs."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def layer_norm(x: torch.Tensor, gain: torch.Tensor) -> torch.Tensor:
    mean = x.mean(dim=-1, keepdim=True)
    var = ((x - mean) ** 2).mean(dim=-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + LN_EPS) * gain


def causal_attention(q, k, v, precision: str) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd) + causal mask) v over [b, H, T, hd], a block
    of query rows at a time against the keys it may see."""
    T, hd = q.shape[2], q.shape[3]
    out = []
    for s in range(0, T, QUERY_BLOCK):
        e = min(s + QUERY_BLOCK, T)
        scores = _mm(q[:, :, s:e], k[:, :, :e].transpose(-1, -2),
                     precision) / math.sqrt(hd)
        seen = (torch.arange(s, e, device=q.device)[:, None]
                >= torch.arange(e, device=q.device)[None, :])
        probs = torch.softmax(scores.masked_fill(~seen, float("-inf")), -1)
        out.append(_mm(probs, v[:, :, :e], precision))
    return torch.cat(out, dim=2)


def decoder_block(x: torch.Tensor, blk: dict, n_heads: int,
                  precision: str) -> torch.Tensor:
    b, T, D = x.shape
    hd = D // n_heads
    h = layer_norm(x, blk["ln1"])
    qkv = _mm(h, blk["qkv"].reshape(D, 3 * D), precision)
    qkv = qkv.reshape(b, T, n_heads, 3 * hd).permute(0, 2, 1, 3)
    q, k, v = qkv.split(hd, dim=-1)
    att = causal_attention(q, k, v, precision)
    att = att.permute(0, 2, 1, 3).reshape(b, T, D)
    x = x + _mm(att, blk["wo"], precision)
    h = layer_norm(x, blk["ln2"])
    return x + _mm(torch.relu(_mm(h, blk["w1"], precision)), blk["w2"],
                   precision)


def forward_logits(params: dict, tokens: torch.Tensor, n_heads: int,
                   precision: str = "f32") -> torch.Tensor:
    """[b, T, V] float32 logits at every position of [b, T] tokens."""
    T = tokens.shape[1]
    x = params["embed"][tokens] + params["pos"][:T]
    for blk in params["blocks"]:
        x = decoder_block(x, blk, n_heads, precision)
    x = layer_norm(x, params["ln_f"])
    return _mm(x, params["embed"].t(), precision)


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, list):
        return [t for item in tree for t in _leaves(item)]
    return [tree]


def _like(tree, values):
    """A tree shaped like ``tree`` whose leaves are ``values`` in
    ``_leaves`` order."""
    it = iter(values)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    return build(tree)


def loss_and_grads(params: dict, tokens: torch.Tensor,
                   targets: torch.Tensor, n_heads: int,
                   precision: str = "f32"):
    """(mean next-token cross-entropy over all B*T tokens, its gradient
    as a tree shaped like ``params``), one sequence at a time."""
    leaves = _leaves(params)
    for p in leaves:
        p.grad = None
        p.requires_grad_(True)
    B, T = tokens.shape
    total = torch.zeros((), dtype=torch.float64, device=tokens.device)
    try:
        for r in range(B):
            logits = forward_logits(params, tokens[r:r + 1], n_heads,
                                    precision)[0]
            gold = logits.gather(-1, targets[r][:, None])[:, 0]
            loss = (torch.logsumexp(logits, dim=-1) - gold).sum() / (B * T)
            loss.backward()
            total += loss.detach()
        grads = [p.grad for p in leaves]
    finally:
        for p in leaves:
            p.requires_grad_(False)
            p.grad = None
    return float(total), _like(params, grads)


def sgd(params: dict, grads: dict, lr: float) -> None:
    """p -= lr * g, in place."""
    with torch.no_grad():
        for p, g in zip(_leaves(params), _leaves(grads)):
            p.sub_(lr * g)
