"""Ring attention: the port of ompi_tpu/ops/ring_attention.py.

A sequence of length S is sharded S/sp per rank along the ``sp`` mesh axis.
K/V blocks rotate around the ring (``axes.shift``, point-to-point sends over
``torch.distributed``) while each rank's Q block merges the block pairs'
normalized partials in (out, lse) space, the flash-style log-sum-exp
combine. A ring of one (``sp == 1``) is one block pair and no merge.

Causality across blocks: the block from ring index ``kv_idx`` is attended
fully when ``kv_idx < my``, with the causal triangle when ``kv_idx == my``
and not at all when ``kv_idx > my``; a rank knows its index, so the
relation is a Python bool. Every ring step runs its block pair, "none"
blocks included, as the JAX ring does.

Each block pair goes through the Hopper flash kernel
(``ops/flash_attention.py``) whenever the tensors lie on the card; the
default route consults ``flash_supported`` (the JAX gate's static shape
check) and raises on a shape the kernels refuse, rather than running plain
attention on the card unasked. A caller that wants the plain path on the
card asks for it by name (``use_flash=False``). CPU tensors take the
chunked plain path, as the JAX package takes its lax path off a TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ompi_tpu_torch.ops.flash_attention import (flash_block,
                                               flash_supported)
from ompi_tpu_torch.parallel import axes

NEG_BIG = -1e30


def _bhq_to_bqh1(x: torch.Tensor) -> torch.Tensor:
    """[B, H, T] -> [B, T, H, 1] for broadcasting against [B, T, H, D]."""
    return x.transpose(1, 2)[..., None]


def _block_attend(q, k, v, keep_full, keep_tri, sm_scale, mxu_dtype,
                  chunk: int):
    """One Q-block x KV-block partial attention, chunked over the KV dim:
    (numerator [B, Tq, H, D], row_max [B, H, Tq], row_sum [B, H, Tq]).
    With ``mxu_dtype=torch.bfloat16`` the matmul operands are rounded to
    bf16 and accumulated in f32, as the JAX path's MXU dots are."""
    B, Tq, H, D = q.shape
    Tk = k.shape[1]
    chunk = min(chunk, Tk)
    while Tk % chunk:
        chunk //= 2
    md = mxu_dtype or torch.float32
    dev = q.device
    kf = torch.as_tensor(keep_full, dtype=torch.bool, device=dev)
    kt = torch.as_tensor(keep_tri, dtype=torch.bool, device=dev)
    qm = q.to(md).float()
    rows = torch.arange(Tq, device=dev)[:, None]
    acc = torch.zeros((B, Tq, H, D), dtype=torch.float32, device=dev)
    m = torch.full((B, H, Tq), -math.inf, dtype=torch.float32, device=dev)
    den = torch.zeros((B, H, Tq), dtype=torch.float32, device=dev)
    for c0 in range(0, Tk, chunk):
        k_c = k[:, c0:c0 + chunk].to(md).float()
        v_c = v[:, c0:c0 + chunk].to(md).float()
        s = torch.einsum("bqhd,bkhd->bhqk", qm, k_c) * sm_scale
        cols = c0 + torch.arange(chunk, device=dev)[None, :]
        keep = kf | (kt & (cols <= rows))  # [Tq, chunk]
        s = torch.where(keep, s, -math.inf)
        m_new = torch.maximum(m, s.amax(dim=-1))
        safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
        p = torch.where(keep, torch.exp(s - safe[..., None]), 0.0)
        num_p = torch.einsum("bhqk,bkhd->bqhd", p.to(md).float(), v_c)
        alpha = torch.exp(torch.where(torch.isneginf(m), -math.inf, m - safe))
        acc = acc * _bhq_to_bqh1(alpha) + num_p
        den = den * alpha + p.sum(dim=-1)
        m = m_new
    return acc, m, den


def _chunked_block(q, k, v, keep_full, keep_tri, sm_scale, mxu_dtype,
                   chunk: int):
    """(out, lse) through the chunked plain path (the JAX ``_lax_block``),
    sharing the flash contract: normalized out [B, Tq, H, D] f32 and
    lse [B, H, Tq] f32 with the -1e30 empty sentinel. Its denominator floor
    is 1e-9, as in the JAX path."""
    acc, m, den = _block_attend(q, k, v, keep_full, keep_tri, sm_scale,
                                mxu_dtype, chunk)
    out = acc / torch.clamp_min(_bhq_to_bqh1(den), 1e-9)
    lse = torch.where(den > 0.0,
                      torch.where(torch.isneginf(m), NEG_BIG, m)
                      + torch.log(torch.clamp_min(den, 1e-9)),
                      NEG_BIG)
    return out, lse


def _one_block(q, k, v, keep_full, keep_tri, sm_scale, mxu_dtype, chunk,
               use_flash, layout):
    """One Q-shard x KV-shard block pair -> (out in the input layout f32,
    lse [B, H, Tq] f32), through the flash route or the chunked path."""
    if use_flash:
        return flash_block(q, k, v, keep_full, keep_tri, sm_scale,
                           layout=layout)
    if layout == "bhtd":
        # the chunked path is bthd-native; transpose at the boundary
        tr = lambda x: x.transpose(1, 2)
        o, lse = _chunked_block(tr(q), tr(k), tr(v), keep_full, keep_tri,
                                sm_scale, mxu_dtype, chunk)
        return tr(o), lse
    return _chunked_block(q, k, v, keep_full, keep_tri, sm_scale, mxu_dtype,
                          chunk)


def flash_default(device_type: str, q_shape, k_shape,
                  layout: str = "bthd") -> bool:
    """The default route of a block pair: the Hopper kernels on the card,
    the chunked plain path off it. On the card a shape that
    ``flash_supported`` refuses raises: the kernels run or the call fails,
    and the plain path runs there only where the caller names it."""
    if device_type != "cuda":
        return False
    if not flash_supported(q_shape, k_shape, layout):
        raise ValueError(
            f"the flash kernels do not take q{tuple(q_shape)} "
            f"k{tuple(k_shape)} ({layout}; see flash_supported); pass "
            "use_flash=False to run plain attention on the card")
    return True


def use_flash_default(q: torch.Tensor, k: torch.Tensor,
                      layout: str = "bthd") -> bool:
    """``flash_default`` for the block pair (q, k)."""
    return flash_default(q.device.type, q.shape, k.shape, layout)


def ring_attention(q, k, v, axis_name: str, sp_size: int,
                   sm_scale: Optional[float] = None, causal: bool = True,
                   mxu_dtype: Optional[torch.dtype] = None, chunk: int = 512,
                   use_flash: Optional[bool] = None, layout: str = "bthd"):
    """Sequence-parallel attention over the ``axis_name`` ring of
    ``sp_size`` ranks.

    q, k, v: this rank's shards, [B, S/sp, H, D] ('bthd') or
    [B, H, S/sp, D] ('bhtd', the layout the model emits). Returns the local
    output shard in the input layout and dtype. ``use_flash`` None takes the
    Hopper kernels for CUDA tensors, raising on a shape they refuse, and the
    chunked path for CPU tensors (``use_flash_default``); True on CPU
    tensors takes the kernels' plain versions; False takes the chunked path
    on either device. ``mxu_dtype`` and ``chunk`` are the chunked path's.
    """
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = use_flash_default(q, k, layout)
    block = lambda k_blk, v_blk, kf, kt: _one_block(
        q, k_blk, v_blk, kf, kt, sm_scale, mxu_dtype, chunk, use_flash,
        layout)
    if sp_size == 1:
        # degenerate ring: one block pair, already normalized, no merge
        o, _ = block(k, v, not causal, causal)
        return o.to(q.dtype)
    if sp_size != axes.size(axis_name):
        raise ValueError(f"sp_size {sp_size} but the mesh's {axis_name!r} "
                         f"axis has {axes.size(axis_name)} ranks")

    def lift(x):
        """[B, H, T] row stats broadcast against the output layout."""
        return x[..., None] if layout == "bhtd" else _bhq_to_bqh1(x)

    my = axes.rank(axis_name)
    B, H = q.shape[0], q.shape[1 if layout == "bhtd" else 2]
    T = q.shape[2 if layout == "bhtd" else 1]
    out = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    lse = torch.full((B, H, T), NEG_BIG, dtype=torch.float32,
                     device=q.device)
    k_blk, v_blk = k, v
    for step in range(sp_size):
        kv_idx = (my - step) % sp_size  # whose block this rank holds
        if causal:
            keep_full, keep_tri = kv_idx < my, kv_idx == my
        else:
            keep_full, keep_tri = True, False
        o_p, lse_p = block(k_blk, v_blk, keep_full, keep_tri)
        # log-sum-exp merge of normalized partials (all finite: the -1e30
        # sentinel keeps the exps and their gradients NaN-free)
        lse_new = torch.logaddexp(lse, lse_p)
        out = (out * lift(torch.exp(lse - lse_new))
               + o_p * lift(torch.exp(lse_p - lse_new)))
        lse = lse_new
        if step != sp_size - 1:
            k_blk = axes.shift(k_blk, axis_name)
            v_blk = axes.shift(v_blk, axis_name)
    return out.to(q.dtype)


def ring_attention_sharded(q, k, v, axis_name: str = "sp",
                           causal: bool = True, **kwargs):
    """Whole-sequence entry: every rank passes the global q, k, v
    ([B, S, H, D], or [B, H, S, D] with ``layout='bhtd'``), takes its shard
    of the sequence along ``axis_name`` and gets back the global output,
    gathered over the axis. Keyword arguments go to ``ring_attention``."""
    sp = axes.size(axis_name)
    tdim = 2 if kwargs.get("layout", "bthd") == "bhtd" else 1
    if q.shape[tdim] % sp:
        raise ValueError(f"sequence {q.shape[tdim]} does not split {sp} "
                         f"ways over {axis_name!r}")
    n = q.shape[tdim] // sp
    local = [x.narrow(tdim, axes.rank(axis_name) * n, n).contiguous()
             for x in (q, k, v)]
    out = ring_attention(*local, axis_name, sp, causal=causal, **kwargs)
    return axes.allgather(out, axis_name, concat_dim=tdim)


def reference_attention(q, k, v, causal: bool = True):
    """Dense O(S^2) attention in f32 over [B, S, H, D], for tests."""
    B, S, H, D = q.shape
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) / math.sqrt(D)
    if causal:
        mask = torch.tril(torch.ones((S, S), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask, s, -math.inf)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", p, v.float()).to(q.dtype)
