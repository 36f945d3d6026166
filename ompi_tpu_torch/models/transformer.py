"""Flagship causal-LM transformer: the port of ompi_tpu/models/transformer.py,
forward and training step, on one card or over a (dp, sp, tp) mesh of ranks
(``parallel.axes``), laid out Megatron-style as in the JAX package:

- tp: q/k/v and w1 column-parallel, wo and w2 row-parallel with an
  allreduce of the partial outputs (attention heads split over tp);
- sp: the sequence split; attention is ring attention over 'sp';
- dp: the batch split; gradients allreduced over ("dp", "sp").

Parameters keep the JAX package's layout (no transposes), so
``params_from_jax`` is a dtype/device copy of the JAX ``init_params`` tree:

- ``embed`` [V, D], ``pos`` [S, D], ``ln_f`` [D];
- per block ``ln1``/``ln2`` [D], ``qkv`` [D, H, 3*hd] (q, k, v sliced per
  head), ``wo`` [D, D] (read as [H, hd, D]), ``w1`` [D, F], ``w2`` [F, D].

Numerics follow the JAX forward: bias-free layer norm with eps 1e-6; bf16
products with f32 accumulation; bf16 q/k/v, bf16 attention output and bf16
ReLU; f32 residual stream; tied-embedding f32 logits. Training follows
``make_train_step``: the chunked softmax cross-entropy over the tied
embedding, its mean over the tokens, and plain SGD.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.ops.mxu import contract_f32, einsum_bf16
from ompi_tpu_torch.ops.ring_attention import ring_attention
from ompi_tpu_torch.ops.softmax_xent import logits_matmul, softmax_xent_sum
from ompi_tpu_torch.parallel import axes


@dataclasses.dataclass(frozen=True)
class Config:
    vocab: int = 512
    d_model: int = 128
    n_heads: int = 8
    n_layers: int = 2
    d_ff: int = 512
    seq_len: int = 128
    lr: float = 1e-2
    # recompute each block's activations in the backward
    # (torch.utils.checkpoint, the JAX jax.checkpoint): more flops for
    # O(layers) less device memory
    remat: bool = False

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
    return _map(tree, lambda x: torch.from_numpy(
        np.array(x, dtype=np.float32)).to(dev))


def _map(tree, fn, *rest):
    """``fn`` applied to every leaf of a tree of dicts and lists (a tuple is
    a leaf: a partition spec), with the matching leaves of the trees
    ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: _map(v, fn, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map(v, fn, *(r[i] for r in rest))
                for i, v in enumerate(tree)]
    return fn(tree, *rest)


def param_specs(cfg: Config):
    """The Megatron sharding plan, the JAX ``param_specs`` with each
    ``PartitionSpec`` as a tuple of axis names (None: not split); ``()`` is
    replicated. Only tp splits a parameter: every parameter is replicated
    over dp and sp."""
    block = {
        "ln1": (), "ln2": (),
        "qkv": (None, "tp", None),  # heads split (column parallel)
        "wo": ("tp", None),         # row parallel -> allreduce
        "w1": (None, "tp"),         # column parallel
        "w2": ("tp", None),         # row parallel -> allreduce
    }
    return {"embed": (), "pos": (), "ln_f": (),
            "blocks": [dict(block) for _ in range(cfg.n_layers)]}


def _shard(x: torch.Tensor, spec) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            n = axes.size(axis)
            if x.shape[dim] % n:
                raise ValueError(f"dim {dim} of {tuple(x.shape)} does not "
                                 f"split {n} ways over {axis!r}")
            m = x.shape[dim] // n
            x = x.narrow(dim, axes.rank(axis) * m, m)
    return x.contiguous()


def _gather(x: torch.Tensor, spec) -> torch.Tensor:
    for dim, axis in enumerate(spec):
        if axis is not None:
            x = axes.allgather(x, axis, concat_dim=dim)
    return x


def shard_params(params, specs):
    """This rank's slice of the full parameter tree under ``specs``
    (``param_specs``) on the current mesh: each named dim split evenly, in
    axis order."""
    return _map(params, _shard, specs)


def gather_params(local, specs):
    """The full tree back from every rank's slice: an allgather along each
    dim ``specs`` splits (every rank must call it)."""
    with torch.no_grad():
        return _map(local, _gather, specs)


def _ln(x: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    x = x - x.mean(dim=-1, keepdim=True)
    x = x / torch.sqrt((x * x).mean(dim=-1, keepdim=True) + 1e-6)
    return x * g


def _mm(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """bf16 matmul with f32 accumulation and output."""
    return contract_f32("btd,df->btf", a, w)


def features_local(params, tokens: torch.Tensor, cfg: Config,
                   use_flash: Optional[bool] = None) -> torch.Tensor:
    """Forward on this rank's shards up to the final layer norm: features
    [B, T, D] f32.

    This is the JAX ``features_local(..., in_mesh=True)``, with tp and sp
    the current mesh's sizes (1 without a mesh): tokens are this rank's
    [B/dp, S/sp] block; the tp-split weights arrive as this rank's slices
    (``shard_params``), so a rank holds n_heads / tp heads; attention is
    ring attention over 'sp' in the kernel's 'bhtd' layout; the
    row-parallel outputs pass through the 'tp' allreduce, and the inputs of
    the column-parallel products through ``axes.copy_to(.., "tp")``, the
    "f" operator that JAX's AD inserts by itself. ``use_flash`` is
    ``ring_attention``'s: None lets it pick the Hopper kernels on the card;
    False forces the plain path. With ``cfg.remat`` each block is
    recomputed in the backward, its collectives included.
    """
    T = tokens.shape[1]
    hd = cfg.head_dim
    sp = axes.size("sp")
    pos_idx = axes.rank("sp") * T + torch.arange(T, device=tokens.device)
    x = params["embed"][tokens.long()] + params["pos"][pos_idx][None]

    def block(x, blk):
        h = axes.copy_to(_ln(x, blk["ln1"]), "tp")
        hb = h.to(torch.bfloat16)
        wb = blk["qkv"].to(torch.bfloat16)  # local [D, H/tp, 3*hd]
        q = einsum_bf16("btd,dhf->bhtf", hb, wb[..., :hd])
        k = einsum_bf16("btd,dhf->bhtf", hb, wb[..., hd:2 * hd])
        v = einsum_bf16("btd,dhf->bhtf", hb, wb[..., 2 * hd:])
        att = ring_attention(q, k, v, "sp", sp, mxu_dtype=torch.bfloat16,
                             chunk=T, use_flash=use_flash, layout="bhtd")
        wo = blk["wo"].reshape(wb.shape[1], hd, cfg.d_model)
        x = x + axes.allreduce(contract_f32("bhtf,hfd->btd", att, wo), "tp")

        h2 = axes.copy_to(_ln(x, blk["ln2"]), "tp")
        ff1 = torch.clamp_min(
            einsum_bf16("btd,df->btf", h2.to(torch.bfloat16), blk["w1"]), 0)
        return x + axes.allreduce(_mm(ff1, blk["w2"]), "tp")

    for blk in params["blocks"]:
        if cfg.remat:
            x = checkpoint(block, x, blk, use_reentrant=False)
        else:
            x = block(x, blk)

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


def _loss_local(params, tokens: torch.Tensor, targets: torch.Tensor,
                cfg: Config, denom: float,
                use_flash: Optional[bool] = None) -> torch.Tensor:
    """The mean next-token loss of one shard: the chunked softmax
    cross-entropy over the tied embedding (chunks of 128 positions), over
    ``denom`` tokens.

    psum_axes is empty: the step allreduces every gradient itself, embed's
    included, so the loss must not sum embed's cotangent a second time.
    """
    x = features_local(params, tokens, cfg, use_flash=use_flash)
    return softmax_xent_sum(x, params["embed"], targets, 128) / denom


def param_leaves(params) -> List[Any]:
    """The leaves in the order of ``jax.tree.leaves`` (dict keys sorted,
    lists in order; a tuple is a leaf)."""
    if isinstance(params, dict):
        return [t for key in sorted(params) for t in param_leaves(params[key])]
    if isinstance(params, list):
        return [t for item in params for t in param_leaves(item)]
    return [params]


def loss_and_grads(params, tokens: torch.Tensor, targets: torch.Tensor,
                   cfg: Config, use_flash: Optional[bool] = None
                   ) -> Tuple[torch.Tensor, List[torch.Tensor]]:
    """(loss, the gradient of every parameter in ``param_leaves`` order) of
    this rank's token block; the parameters are left as they were. The
    loss is this block's share of the mean over the global batch (its sum
    over B*T*dp*sp tokens), and the gradients are this rank's part: their
    sum over ("dp", "sp") is the whole."""
    B, T = tokens.shape
    denom = float(B * T * axes.size(("dp", "sp")))
    leaves = param_leaves(params)
    wanted = [p.requires_grad for p in leaves]
    try:
        for p in leaves:
            p.requires_grad_(True)
        loss = _loss_local(params, tokens, targets, cfg, denom, use_flash)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p, w in zip(leaves, wanted):
            p.requires_grad_(w)
    return loss.detach(), list(grads)


def allreduce_grads(grads: List[torch.Tensor]) -> List[torch.Tensor]:
    """Every gradient summed over ("dp", "sp"), by one allreduce of all of
    them flattened into one buffer (one wire crossing, not one a leaf)."""
    if axes.size(("dp", "sp")) == 1:
        return list(grads)
    flat = axes.allreduce(torch.cat([g.reshape(-1) for g in grads]),
                          ("dp", "sp"))
    return [f.view_as(g) for f, g in
            zip(flat.split([g.numel() for g in grads]), grads)]


def make_train_step(cfg: Config, device: DeviceLike = None, dp: int = 1,
                    sp: int = 1, tp: int = 1,
                    use_flash: Optional[bool] = None
                    ) -> Tuple[Callable, Callable]:
    """The full training step over the current (dp, sp, tp) mesh: forward,
    backward, the gradient allreduce and the SGD update. Returns
    ``(step, place)`` as the JAX ``make_train_step`` does. ``dp``, ``sp``
    and ``tp`` must be the current mesh's sizes (all 1 without a mesh).

    ``place(params, tokens, targets)`` takes the full parameter tree and the
    global [B, S] batch and returns this rank's parameter slice
    (``shard_params``) and its ("dp", "sp") token block, on ``device`` (the
    card unless the caller asks for the CPU). ``step(params, tokens,
    targets)`` returns ``(loss, params)``: the mean loss over the global
    batch (the local losses summed over ("dp", "sp"), as JAX does), and the
    same parameter tensors after ``p -= lr * g``, which is applied IN PLACE
    under ``torch.no_grad()`` (JAX returns new arrays; the port saves a
    copy of every parameter). Attention takes the Hopper kernels on the
    card and the chunked plain path on the CPU; ``use_flash`` is
    ``ring_attention``'s (False asks for the plain path on the card).

    Gradient reduction: parameters are replicated over dp and sp, so each
    gradient is summed over those axes exactly once, here, by one allreduce
    over ("dp", "sp") (``allreduce_grads``); nothing is summed over tp,
    whose sums are in the model (``copy_to``). The JAX step gets the dp/sp
    sum from shard_map's AD, and its loss psums embed's cotangent itself;
    ``_loss_local`` passes no ``psum_axes`` to the loss, so embed is not
    counted twice.
    """
    layout = {"dp": dp, "sp": sp, "tp": tp}
    have = {a: axes.size(a) for a in layout}
    if layout != have:
        raise ValueError(f"make_train_step for {layout} on a mesh of {have}")
    dev = resolve_device(device)
    specs = param_specs(cfg)

    def place(params, tokens, targets):
        def block(t):
            t = torch.as_tensor(t)
            B, S = t.shape
            if B % dp or S % sp:
                raise ValueError(f"batch {tuple(t.shape)} does not split "
                                 f"over dp={dp}, sp={sp}")
            b, s = B // dp, S // sp
            return t[axes.rank("dp") * b:(axes.rank("dp") + 1) * b,
                     axes.rank("sp") * s:(axes.rank("sp") + 1) * s].to(dev)

        local = shard_params(params, specs)
        return _map(local, lambda t: t.to(dev)), block(tokens), block(targets)

    def step(params, tokens, targets):
        loss, grads = loss_and_grads(params, tokens, targets, cfg,
                                     use_flash)
        with torch.no_grad():
            for p, g in zip(param_leaves(params), allreduce_grads(grads)):
                p.sub_(cfg.lr * g)
        return axes.allreduce(loss, ("dp", "sp")), params

    return step, place
