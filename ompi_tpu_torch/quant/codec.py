"""Block-scaled quantization codecs with closed-form error bounds.

The port of ``ompi_tpu/quant/codec.py``: the chunk layout, the wire sizes,
the error bound, and the host codec of process mode (``encode``,
``decode``, ``reduce_encoded``, ``simulate_allreduce``), whose bytes equal
the reference's, so that ranks of the two packages exchange codes in one
quantized collective. The mesh path quantizes with tensor ops in
``coll/quant.py``.

A float vector is cut into blocks of ``block`` elements; each block carries
one f32 scale derived from its amax, and the elements ride the wire as
int8, packed int4, or float8_e4m3fn. Rounding is round-to-nearest-even
(``np.rint``; fp8 codes by ``_e4m3fn_codes``, the cast ``ml_dtypes``
makes), so a fixed (world, block, bits, mode)
config reproduces bitwise. Wire layout of one encoded vector of ``n``
elements::

    [nblocks * f32 little-endian scales][quantized payload]

``nblocks = ceil(n / block)``; the payload is ``n`` bytes (int8/fp8) or
``ceil(n/2)`` bytes (int4 nibbles, low nibble first). Non-finite blocks
carry the ``+inf`` scale sentinel and the code points {+inf, -inf, nan,
other}; their finite values decode to 0.

One quantize/dequantize round trip of a block with amax ``A`` errs at most
``A * eps`` an element, ``eps`` = 1/254 (int8), 1/14 (int4) or 2**-4 (fp8,
amax scaled to 224). The quantized allreduce quantizes every rank's
contribution once and the reduced block once more, so::

    |allreduce_quant - allreduce_exact|  <=  S * eps * (2 + eps) + slack

with ``S`` the sum over ranks of the block amax and ``slack = S * 4 *
(W + 2) * finfo(out_dtype).eps``. Block scales are clamped to >= f32 tiny
and <= f32 max (``A`` floored and capped alike in the bound). Non-finite
blocks have an infinite bound.
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


_E4M3_MIN_NORMAL = 2.0 ** -6
_E4M3_NAN = 0x7F


def _e4m3fn_codes(t: np.ndarray) -> np.ndarray:
    """float8_e4m3fn codes (uint8) of a float array, as the reference's
    ``ml_dtypes`` cast gives them: the value rounded to f32 (an f64 input
    is rounded twice, as there), then to nearest e4m3fn, ties to even.
    Signed zeros keep their sign; magnitudes that round past 448, inf and
    nan give the nan code."""
    with np.errstate(over="ignore"):  # past f32 range: inf, the nan code
        x = np.asarray(t, dtype=np.float32).astype(np.float64).reshape(-1)
    sign = np.where(np.signbit(x), 0x80, 0).astype(np.uint8)
    a = np.abs(x)
    fin = np.isfinite(a)
    a = np.where(fin, a, 0.0)
    _, e = np.frexp(a)                     # a = m * 2**e, m in [0.5, 1)
    binade = np.maximum(e - 1, -6)         # subnormals share 2**-6's step
    step = np.ldexp(1.0, binade - 3)       # 3 mantissa bits
    r = np.rint(a / step) * step           # exact: step is a power of 2
    _, e2 = np.frexp(r)
    normal = r >= _E4M3_MIN_NORMAL
    exp_r = np.where(normal, e2 - 1, 0)
    mant = np.where(normal, np.ldexp(r, -exp_r) * 8.0 - 8.0, 0.0)
    code_n = (exp_r + 7) * 8 + mant
    code_s = r * 512.0                     # subnormal: r / 2**-9
    code = np.where(normal, code_n, code_s)
    code = np.where(fin & (r <= 448.0), code, _E4M3_NAN)
    return code.astype(np.uint8) | sign


def _e4m3fn_table() -> np.ndarray:
    """The f64 value of each of the 256 float8_e4m3fn codes."""
    c = np.arange(256)
    exp = (c >> 3) & 0xF
    mant = c & 7
    mag = np.where(exp == 0, mant * 2.0 ** -9,
                   np.ldexp(1.0 + mant / 8.0, exp - 7))
    mag = np.where((c & 0x7F) == _E4M3_NAN, np.nan, mag)
    return np.where(c & 0x80, -mag, mag)


_E4M3FN_VALUES = _e4m3fn_table()


class BlockCodec:
    """One (mode, bits, block) codec: ``mode`` is ``int8`` or ``fp8``;
    ``bits`` is 8, or 4 for packed-nibble int quantization (process mode;
    the mesh path quantizes only at 8 bits, ``negotiate``)."""

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

    def encode(self, x: np.ndarray) -> np.ndarray:
        """Quantize a 1-D float vector into one contiguous uint8 wire
        payload (round to nearest even), the reference's bytes."""
        blocks = self._blocks(x)
        nb = blocks.shape[0]
        amax = np.max(np.abs(blocks), axis=1)  # nan propagates
        finite = np.isfinite(amax)
        scale = np.ones(nb, dtype=np.float32)
        # the f64-amax-past-f32-range divide overflows to inf by design
        # (clamped to f32 max right below)
        with np.errstate(divide="ignore", invalid="ignore",
                         over="ignore"):
            np.divide(amax,
                      self._fp8_target if self.mode == "fp8" else self.qmax,
                      out=scale, where=finite & (amax > 0),
                      casting="unsafe")
        # clamp to the smallest normal f32 (a tiny-denormal amax underflows
        # amax/qmax to 0) and to the largest (an f64 block past f32 range
        # would read as the non-finite sentinel)
        np.maximum(scale, np.finfo(np.float32).tiny, out=scale,
                   where=finite & (amax > 0))
        np.minimum(scale, np.finfo(np.float32).max, out=scale,
                   where=finite & (amax > 0))
        scale[~finite] = np.inf  # sentinel: block carries non-finite data

        if self.mode == "fp8":
            q = np.zeros(blocks.shape, dtype=np.uint8)
            if finite.any():
                t = blocks[finite] / scale[finite, None]
                q[finite] = _e4m3fn_codes(t).reshape(t.shape)
            if not finite.all():
                xb = blocks[~finite]
                qb = np.zeros(xb.shape, dtype=np.uint8)
                qb[xb == np.inf] = 0x7E       # 448 = +inf code point
                qb[xb == -np.inf] = 0xFE      # -448
                qb[np.isnan(xb)] = _E4M3_NAN
                q[~finite] = qb
            payload = q.reshape(-1)
        else:
            q = np.zeros(blocks.shape, dtype=np.int8)
            if finite.any():
                t = blocks[finite] / scale[finite, None]
                q[finite] = np.clip(np.rint(t), -self.qmax,
                                    self.qmax).astype(np.int8)
            if not finite.all():
                xb = blocks[~finite]
                qb = np.zeros(xb.shape, dtype=np.int8)
                qb[xb == np.inf] = int(self.qmax)
                qb[xb == -np.inf] = -int(self.qmax)
                qb[np.isnan(xb)] = -int(self.qmax) - 1  # nan code point
                q[~finite] = qb
            if self.bits == 4:
                flat = q.reshape(-1)[: x.size]
                nibbles = (flat.astype(np.int16) + 8).astype(np.uint8)
                if nibbles.size % 2:
                    nibbles = np.concatenate(
                        [nibbles, np.full(1, 8, np.uint8)])
                pairs = nibbles.reshape(-1, 2)
                payload = (pairs[:, 0] | (pairs[:, 1] << 4)).astype(np.uint8)
            else:
                payload = np.ascontiguousarray(q).view(np.uint8).reshape(-1)
        payload = payload[: self.payload_nbytes(x.size)]
        out = np.empty(self.wire_nbytes(x.size), dtype=np.uint8)
        out[: 4 * nb] = scale.astype("<f4").view(np.uint8)
        out[4 * nb:] = payload
        return out

    def decode(self, payload: np.ndarray, n: int,
               dtype=np.float32) -> np.ndarray:
        """Dequantize ``n`` elements from one wire payload into the work
        dtype of ``dtype`` (f64 in, f64 math; anything else f32)."""
        nb = self.nblocks(n)
        raw = np.frombuffer(bytes(payload), dtype=np.uint8)
        scale = raw[: 4 * nb].view("<f4").astype(np.float32)
        body = raw[4 * nb: 4 * nb + self.payload_nbytes(n)]
        wdt = _work_dtype(dtype)
        if self.mode == "fp8":
            q = _E4M3FN_VALUES[body].astype(wdt)
        elif self.bits == 4:
            lo = (body & 0x0F).astype(np.int16) - 8
            hi = (body >> 4).astype(np.int16) - 8
            q = np.empty(body.size * 2, dtype=np.int16)
            q[0::2] = lo
            q[1::2] = hi
            q = q[:n].astype(wdt)
        else:
            q = body.view(np.int8).astype(wdt)
        q = q[:n]
        pad = nb * self.block - n
        if pad:
            q = np.concatenate([q, np.zeros(pad, dtype=wdt)])
        blocks = q.reshape(nb, self.block)
        bad = np.isinf(scale)
        with np.errstate(invalid="ignore"):
            out = blocks * scale[:, None].astype(wdt)
        if bad.any():
            qb = blocks[bad]
            ob = np.zeros(qb.shape, dtype=wdt)
            ob[qb == self.qmax] = np.inf
            ob[qb == -self.qmax] = -np.inf
            if self.mode == "fp8":
                ob[np.isnan(qb)] = np.nan
            else:
                ob[qb == -self.qmax - 1] = np.nan
            out[bad] = ob
        return out.reshape(-1)[:n]

    def reduce_encoded(self, encoded, per: int, dtype=np.float32):
        """Sum decoded chunks in ascending rank order (the canonical
        accumulation order: process-mode ranks and the offline simulator
        share it, so results agree bitwise)."""
        acc = self.decode(encoded[0], per, dtype)
        # sentinel blocks legitimately reduce inf + (-inf) -> nan
        with np.errstate(invalid="ignore"):
            for e in encoded[1:]:
                acc = acc + self.decode(e, per, dtype)
        return acc

    def simulate_allreduce(self, xs: np.ndarray) -> np.ndarray:
        """Offline oracle of the quantized allreduce: quantize every rank's
        chunk, reduce in rank order, requantize, dequantize — the wire
        schedule, bitwise."""
        xs = np.asarray(xs)
        world, n = xs.shape
        per, padded = chunk_layout(n, world, self.block)
        wdt = _work_dtype(xs.dtype)
        buf = np.zeros((world, padded), dtype=wdt)
        buf[:, :n] = xs
        out = np.empty(padded, dtype=wdt)
        for c in range(world):
            enc = [self.encode(buf[r, c * per:(c + 1) * per])
                   for r in range(world)]
            red = self.reduce_encoded(enc, per, wdt)
            out[c * per:(c + 1) * per] = self.decode(
                self.encode(red), per, wdt)
        return out[:n].astype(xs.dtype if xs.dtype.kind == "f" else wdt)

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
