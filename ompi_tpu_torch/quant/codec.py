"""Block-scaled quantization: the chunk layout, the wire sizes and the
closed-form error bound.

The port's copy of the part of ``ompi_tpu/quant/codec.py`` that the mesh
path uses (``chunk_layout`` ``:56-63``, the sizing ``:115-123``,
``error_bound`` ``:258-310``), in numpy, so that the bound can be checked
where JAX is absent. The quantize and dequantize steps of the mesh path
are tensor ops in ``coll/quant.py``; the reference's host ``encode`` and
``decode`` (and the int4 packing) belong to process mode and are not
ported.

A float vector is cut into blocks of ``block`` elements; each block carries
one f32 scale derived from its amax, and the elements travel as int8 or
float8_e4m3fn. One quantize/dequantize round trip of a block with amax
``A`` errs at most ``A * eps`` an element, ``eps`` = 1/254 (int8) or 2**-4
(fp8, amax scaled to 224). The quantized allreduce quantizes every rank's
contribution once and the reduced block once more, so::

    |allreduce_quant - allreduce_exact|  <=  S * eps * (2 + eps) + slack

with ``S`` the sum over ranks of the block amax and ``slack = S * 4 *
(W + 2) * finfo(out_dtype).eps``. Non-finite blocks have an infinite bound.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

__all__ = ["BlockCodec", "make_codec", "chunk_layout"]


def chunk_layout(count: int, world: int, block: int) -> Tuple[int, int]:
    """(per, padded): ``count`` elements pad up to ``padded = per * world``
    with ``per`` a multiple of ``block``; chunk ``j`` (for rank ``j``) is
    ``padded[j*per:(j+1)*per]``."""
    per = -(-max(count, 1) // world)
    per = -(-per // block) * block
    return per, per * world


def _work_dtype(dtype) -> np.dtype:
    return np.dtype(np.float64 if np.dtype(dtype) == np.float64
                    else np.float32)


class BlockCodec:
    """One (mode, bits, block) codec: ``mode`` is ``int8`` or ``fp8``;
    ``bits`` is 8, or 4 (int mode), which sizes the reference's packed
    nibbles; the mesh path quantizes only at 8 bits (``negotiate``)."""

    def __init__(self, mode: str = "int8", bits: int = 8, block: int = 64):
        if mode not in ("int8", "fp8"):
            raise ValueError(f"unknown quant mode {mode!r}")
        if bits not in (8, 4):
            raise ValueError(f"unsupported quant bits {bits}")
        if mode == "fp8" and bits != 8:
            raise ValueError("fp8 requires bits=8")
        if block < 1:
            raise ValueError(f"quant block must be >= 1, got {block}")
        self.mode = mode
        self.bits = bits
        self.block = int(block)
        if mode == "fp8":
            self.qmax = 448.0           # e4m3fn finite max (sentinel code)
            self.eps = 2.0 ** -4
        else:
            self.qmax = (1 << (bits - 1)) - 1   # 127 / 7
            self.eps = 0.5 / self.qmax
        # fp8 scaling target: amax -> 224 keeps every rounded value in the
        # normal range (< 448), so the relative-eps bound holds
        self._fp8_target = 224.0
        divisor = self._fp8_target if mode == "fp8" else self.qmax
        # below this amax the error is that of the smallest normal f32
        # scale, above the ceiling an f32 scale cannot carry the block
        self._amax_floor = float(np.finfo(np.float32).tiny) * divisor
        self._amax_ceiling = float(np.finfo(np.float32).max) * divisor

    # ------------------------------------------------------------ sizing
    def nblocks(self, n: int) -> int:
        return -(-n // self.block)

    def payload_nbytes(self, n: int) -> int:
        return -(-n // 2) if self.bits == 4 else n

    def wire_nbytes(self, n: int) -> int:
        """Encoded size of an n-element vector (scales + payload)."""
        return 4 * self.nblocks(n) + self.payload_nbytes(n)

    def ratio(self, n: int, itemsize: int = 4) -> float:
        """Full-precision bytes / quantized wire bytes."""
        return (n * itemsize) / self.wire_nbytes(n)

    # ------------------------------------------------------ error bounds
    def _slack(self, world: int, out_dtype) -> float:
        return 4.0 * (world + 2) * float(np.finfo(np.dtype(out_dtype)).eps)

    def _blocks(self, x: np.ndarray) -> np.ndarray:
        nb = self.nblocks(x.size)
        padded = np.zeros(nb * self.block, dtype=_work_dtype(x.dtype))
        padded[:x.size] = np.asarray(x, dtype=padded.dtype).reshape(-1)
        return padded.reshape(nb, self.block)

    def error_bound(self, x: np.ndarray, out_dtype=None) -> np.ndarray:
        """Closed-form worst-case absolute error, per element, in f64.

        - 1-D ``x``: one round trip of ``x``, ``A' * (eps + slack)`` with
          ``A'`` the element's block amax floored at ``_amax_floor``;
        - 2-D ``x`` of shape [world, n] (the ranks' contributions): the
          quantized allreduce, ``S' * (eps * (2 + eps) + slack)`` with
          ``S'`` the sum over ranks of the floored block amax under
          ``chunk_layout``'s chunking.

        Non-finite blocks, and blocks past the f32 scale range, get an
        infinite bound."""
        x = np.asarray(x)
        od = np.dtype(out_dtype) if out_dtype is not None else \
            (x.dtype if x.dtype.kind == "f" else np.dtype(np.float32))
        if x.ndim == 1:
            amax = np.max(np.abs(self._blocks(x)), axis=1).astype(np.float64)
            eff = np.where(amax > 0,
                           np.maximum(amax, self._amax_floor), 0.0)
            bound = eff * (self.eps + self._slack(1, od))
            bound = np.where(np.isfinite(amax)
                             & (eff <= self._amax_ceiling), bound, np.inf)
            return np.repeat(bound, self.block)[: x.size].astype(np.float64)
        if x.ndim != 2:
            raise ValueError("error_bound wants a vector or a "
                             "[world, n] stack")
        world, n = x.shape
        per, padded = chunk_layout(n, world, self.block)
        a = np.zeros((world, padded), dtype=np.float64)
        a[:, :n] = np.abs(x.astype(np.float64, copy=False))
        # [world(src), world(chunk), blocks a chunk]
        amax = a.reshape(world, world, per // self.block,
                         self.block).max(axis=-1)
        eff = np.where(amax > 0, np.maximum(amax, self._amax_floor), 0.0)
        S = eff.sum(axis=0)
        bound = S * (self.eps * (2.0 + self.eps) + self._slack(world, od))
        bound = np.where(np.isfinite(amax.sum(axis=0))
                         & (S <= self._amax_ceiling), bound, np.inf)
        return np.repeat(bound.reshape(-1), self.block)[:n]

    def quant_step(self, y: np.ndarray) -> np.ndarray:
        """One quantization step of each element of a quantized
        allreduce's result ``y`` (1-D, in the chunk layout's blocks): the
        distance between two adjacent codes of the element's block, in f64.
        A block's largest code is 127 (int8) or 224 (fp8), so its scale is
        its amax over that; int8 codes are a unit apart, fp8 codes by the
        e4m3 spacing at the code (2**(e - 3) for a code in [2**e, 2**(e+1)),
        2**-9 below 2**-6), the spacing above a code at the bottom of its
        binade: the derived scale is an ulp off, so a code of 2**e may read
        a hair under it. Non-finite blocks get an infinite step."""
        y = np.asarray(y, dtype=np.float64).reshape(-1)
        blocks = self._blocks(y)
        top = self._fp8_target if self.mode == "fp8" else self.qmax
        scale = np.abs(blocks).max(axis=1) / top
        per_el = np.repeat(scale, self.block)[: y.size]
        if self.mode != "fp8":
            return np.where(np.isfinite(per_el), per_el, np.inf)
        with np.errstate(divide="ignore", invalid="ignore"):
            code = np.where(per_el > 0, np.abs(y) / per_el, 0.0)
            # e4m3 codes below 2**e are at most 2**e * 15/16, so a margin
            # of 2**-8 in log2 lifts only a code read a hair under 2**e
            e = np.floor(np.log2(np.maximum(code, 2.0 ** -6)) + 2.0 ** -8)
        return np.where(np.isfinite(per_el), 2.0 ** (e - 3) * per_el,
                        np.inf)


def make_codec(mode: str, bits: int, block: int) -> BlockCodec:
    return BlockCodec(mode, bits, block)
