"""Ring attention: the port of ompi_tpu/ops/ring_attention.py, ring of one.

A sequence sharded over an ``sp`` axis would rotate K/V around the ring and
merge the block pairs in (out, lse) space. This slice ports the ``sp == 1``
case, one block pair, which is what the single-card forward runs; the ring
over ``torch.distributed`` (sp > 1) comes with the multi-rank slice.

The block pair goes through the Hopper flash kernel
(``ops/flash_attention.py``) whenever the tensors lie on the card; a shape
the kernel cannot take raises there rather than running plain attention on
the card. CPU tensors take the chunked plain path, as the JAX package takes
its lax path off a TPU.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from ompi_tpu_torch.ops.flash_attention import flash_block

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


def use_flash_default(q: torch.Tensor) -> bool:
    """The Hopper kernel for tensors on the card, the chunked plain path for
    CPU tensors. Unlike the JAX gate this does not consult
    ``flash_supported``: on the card the kernel runs or raises."""
    return q.is_cuda


def ring_attention(q, k, v, axis_name: str, sp_size: int,
                   sm_scale: Optional[float] = None, causal: bool = True,
                   mxu_dtype: Optional[torch.dtype] = None, chunk: int = 512,
                   use_flash: Optional[bool] = None, layout: str = "bthd"):
    """Sequence-parallel causal attention over the ``axis_name`` ring.

    q, k, v: [B, T, H, D] ('bthd') or [B, H, T, D] ('bhtd', the layout the
    model emits). Returns the output in the input layout and dtype. Only a
    ring of one (``sp_size == 1``) is ported so far.
    """
    if sp_size != 1:
        raise NotImplementedError(
            "ring attention over sp > 1 arrives with the multi-rank slice "
            "of the port (ROADMAP.md, queue A)")
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if use_flash is None:
        use_flash = use_flash_default(q)
    # degenerate ring: one block pair, already normalized, no merge
    if use_flash:
        o, _ = flash_block(q, k, v, not causal, causal, sm_scale,
                           layout=layout)
    elif layout == "bhtd":
        # the chunked path is bthd-native; transpose at the boundary
        tr = lambda x: x.transpose(1, 2)
        o, _ = _chunked_block(tr(q), tr(k), tr(v), not causal, causal,
                              sm_scale, mxu_dtype, chunk)
        o = tr(o)
    else:
        o, _ = _chunked_block(q, k, v, not causal, causal, sm_scale,
                              mxu_dtype, chunk)
    return o.to(q.dtype)


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
