"""SPSC shared-memory ring: ctypes binding + layout-compatible Python
path.

The port of ``ompi_tpu/native/ring.py``. The memory layout is defined by
sm_ring.cpp (RingHdr: head@0, tail@64, capacity@128, magic@136, data@192;
frames [u64 len][bytes] aligned to 8, WRAP sentinel = 2^64-1), the
reference's byte for byte. The Python path reads/writes the exact same
layout, so a native ring and a Python ring (of either package) share one
segment — aligned 8-byte loads/stores are atomic on x86_64, which stands
in for the C++ acquire/release pairs.

One difference from the reference: ``use_native=True`` means the native
ring. If the library does not build or load, ``SmRing`` raises
``NativeBuildError`` with the compiler's output instead of falling back to
Python without a word (``ompi_tpu/native/ring.py:41-45``). The Python ring
runs only where the caller asks for it (``use_native=False``, the sm
btl's ``btl_sm_use_native=0``).
"""

from __future__ import annotations

import ctypes
import struct
from typing import Optional

import numpy as np

HDR_BYTES = 192
MAGIC = 0x534D52494E470002
WRAP = (1 << 64) - 1

_U64 = struct.Struct("<Q")


def _align8(v: int) -> int:
    return (v + 7) & ~7


class SmRing:
    """One ring living at ``offset`` inside a writable buffer (mmap)."""

    def __init__(self, mm, offset: int, nbytes: int, use_native: bool = True):
        self.mm = mm
        self.offset = offset
        self.nbytes = nbytes
        self._view = memoryview(mm)[offset : offset + nbytes]
        self.lib = None
        if use_native:
            from ompi_tpu_torch.native import get_lib

            self.lib = get_lib()  # raises NativeBuildError, never None
            self._base = ctypes.addressof(
                ctypes.c_char.from_buffer(mm, offset))
        # scratch buffer for native pops (one per ring, reused)
        self._scratch = np.empty(nbytes, dtype=np.uint8)
        # capacity is a pure function of nbytes (both init paths compute
        # (nbytes - HDR_BYTES) & ~7) — cache it so senders can pre-screen
        # can-never-fit frames without a per-send ctypes call
        self._cap = (nbytes - HDR_BYTES) & ~7

    def can_fit(self, length: int) -> bool:
        """Whether a frame with len(hdr)+len(payload) == ``length`` can
        EVER fit (the exact complement of push()'s -1 condition)."""
        return _align8(8 + length) + 8 <= self._cap

    # ------------------------------------------------------------ lifecycle
    def init(self) -> None:
        if self.lib is not None:
            if self.lib.smr_init(self._base, self.nbytes) != 0:
                raise ValueError("ring too small")
            return
        if self.nbytes < HDR_BYTES + 1024:
            raise ValueError("ring too small")
        v = self._view
        _U64.pack_into(v, 0, 0)      # head
        _U64.pack_into(v, 64, 0)     # tail
        _U64.pack_into(v, 128, (self.nbytes - HDR_BYTES) & ~7)  # capacity
        _U64.pack_into(v, 136, MAGIC)

    @property
    def capacity(self) -> int:
        if self.lib is not None:
            return self.lib.smr_capacity(self._base)
        return _U64.unpack_from(self._view, 128)[0]

    def used(self) -> int:
        if self.lib is not None:
            return self.lib.smr_used(self._base)
        v = self._view
        return _U64.unpack_from(v, 0)[0] - _U64.unpack_from(v, 64)[0]

    # ----------------------------------------------------------------- push
    def push(self, hdr: bytes, payload) -> int:
        """1 = pushed, 0 = full (retry later), -1 = can never fit."""
        if not isinstance(payload, (bytes, bytearray)):
            # a strided ndarray is gathered before its bytes are viewed
            # (the reference views first, and raises ValueError)
            payload = (
                np.frombuffer(memoryview(payload).cast("B"), np.uint8)
                if not isinstance(payload, np.ndarray)
                else np.ascontiguousarray(payload).reshape(-1).view(np.uint8))
        if self.lib is not None:
            if isinstance(payload, np.ndarray):
                pl = payload.ctypes.data
                plen = payload.nbytes
            else:
                pl = payload
                plen = len(payload)
            return self.lib.smr_push2(self._base, hdr, len(hdr), pl, plen)
        return self._py_push(hdr, bytes(payload))

    def _py_push(self, hdr: bytes, payload: bytes) -> int:
        v = self._view
        cap = _U64.unpack_from(v, 128)[0]
        length = len(hdr) + len(payload)
        need = _align8(8 + length)
        if need + 8 > cap:
            return -1
        head = _U64.unpack_from(v, 0)[0]
        tail = _U64.unpack_from(v, 64)[0]
        pos = head % cap
        to_end = cap - pos
        skip = to_end if to_end < need else 0
        if (head + skip + need) - tail > cap:
            return 0
        if skip:
            _U64.pack_into(v, HDR_BYTES + pos, WRAP)
            pos = 0
        _U64.pack_into(v, HDR_BYTES + pos, length)
        v[HDR_BYTES + pos + 8 : HDR_BYTES + pos + 8 + len(hdr)] = hdr
        if payload:
            start = HDR_BYTES + pos + 8 + len(hdr)
            v[start : start + len(payload)] = payload
        _U64.pack_into(v, 0, head + skip + need)  # publish
        return 1

    # ------------------------------------------------------------------ pop
    def pop(self) -> Optional[bytes]:
        """One frame as bytes, or None when empty."""
        if self.lib is not None:
            n = self.lib.smr_pop(self._base, self._scratch.ctypes.data,
                                 self._scratch.nbytes)
            if n < 0:
                raise RuntimeError("sm ring corrupt or scratch too small")
            if n == 0:
                return None
            return self._scratch[:n].tobytes()
        return self._py_pop()

    # ------------------------------------------------- zero-copy consume
    # peek() hands out a view INTO the ring; the frame's bytes stay valid
    # until advance(). This is the single-copy receive path (reference:
    # btl/sm hands the pml a pointer into the fifo segment) — the consumer
    # unpacks straight from shared memory into the posted buffer. With the
    # native lib, the cursor loads/stores carry real acquire/release
    # semantics; the Python path relies on x86-TSO ordering of aligned
    # stores (correct on x86_64 only — weakly-ordered hosts should run
    # the native ring).
    def peek(self) -> Optional[memoryview]:
        if self.lib is not None:
            pos = ctypes.c_uint64()
            n = self.lib.smr_peek(self._base, ctypes.byref(pos))
            if n < 0:
                raise RuntimeError("sm ring corrupt")
            if n == 0:
                return None
            self._peeked = n
            start = HDR_BYTES + pos.value + 8
            return self._view[start : start + n]
        v = self._view
        cap = _U64.unpack_from(v, 128)[0]
        tail = _U64.unpack_from(v, 64)[0]
        head = _U64.unpack_from(v, 0)[0]
        if head == tail:
            return None
        pos = tail % cap
        length = _U64.unpack_from(v, HDR_BYTES + pos)[0]
        if length == WRAP:
            tail += cap - pos
            _U64.pack_into(v, 64, tail)  # consume the sentinel now
            pos = 0
            if head == tail:
                return None
            length = _U64.unpack_from(v, HDR_BYTES)[0]
        if length > cap:
            raise RuntimeError(
                f"sm ring corrupt: len={length:#x} pos={pos} head={head} "
                f"tail={tail} cap={cap}")
        self._peeked = length
        self._peek_tail = tail
        return v[HDR_BYTES + pos + 8 : HDR_BYTES + pos + 8 + length]

    def advance(self) -> None:
        """Release the frame returned by the last peek()."""
        if self.lib is not None:
            self.lib.smr_advance(self._base, self._peeked)
            return
        _U64.pack_into(self._view, 64,
                       self._peek_tail + _align8(8 + self._peeked))

    def _py_pop(self) -> Optional[bytes]:
        v = self._view
        cap = _U64.unpack_from(v, 128)[0]
        tail = _U64.unpack_from(v, 64)[0]
        head = _U64.unpack_from(v, 0)[0]
        if head == tail:
            return None
        pos = tail % cap
        length = _U64.unpack_from(v, HDR_BYTES + pos)[0]
        if length == WRAP:
            tail += cap - pos
            pos = 0
            if head == tail:
                _U64.pack_into(v, 64, tail)
                return None
            length = _U64.unpack_from(v, HDR_BYTES)[0]
        if length > cap:
            raise RuntimeError(
                f"sm ring corrupt: len={length:#x} pos={pos} head={head} "
                f"tail={tail} cap={cap}")
        out = bytes(v[HDR_BYTES + pos + 8 : HDR_BYTES + pos + 8 + length])
        _U64.pack_into(v, 64, tail + _align8(8 + length))
        return out
