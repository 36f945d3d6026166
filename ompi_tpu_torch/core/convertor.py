"""Pack/unpack convertor.

The port of ``ompi_tpu/core/convertor.py`` (reference:
opal/datatype/opal_convertor.c:245 opal_convertor_pack,
opal_convertor.h:259,277 prepare_for_send/recv and the position/resume
contract, opal_convertor_set_position, that the pipelined rendezvous
protocol depends on).

Packing is a vectorized numpy gather over the datatype's committed byte
map, or, from ``_NATIVE_MIN_BYTES`` of packed payload up, the native runs
engine (``native/convertor.cpp``: memcpy over the coalesced runs, no 8x
index array). The numpy gather is the engine's plain version. Unlike the
reference, a native engine that does not build raises
(``native.NativeBuildError``) instead of falling back to numpy. The
convertor is a small stateful cursor over the packed stream so transports
can drain a message in arbitrary fragment sizes.

Buffers are ndarrays, buffer-protocol objects or CPU ``torch.Tensor``s,
viewed as bytes without a copy. A CUDA tensor is refused: device data
never flows through the engine; stage it with
``accelerator.stage_to_host`` first.
"""

from __future__ import annotations

import numpy as np
import torch

from ompi_tpu_torch.core.datatype import Datatype
from ompi_tpu_torch.core.errors import MPIError, ERR_BUFFER, ERR_TRUNCATE


def _as_byte_view(buf) -> np.ndarray:
    """View an ndarray, a buffer-protocol object or a CPU tensor as a flat
    uint8 array WITHOUT copying (a non-contiguous one is flattened into a
    copy, as ``ndarray.reshape`` does)."""
    if isinstance(buf, np.ndarray):
        return buf.reshape(-1).view(np.uint8)
    if isinstance(buf, torch.Tensor):
        if buf.device.type != "cpu":
            raise TypeError(
                f"a {buf.device.type} tensor cannot be packed: device data "
                "never flows through the datatype engine; stage it to the "
                "host with accelerator.stage_to_host first")
        return buf.detach().reshape(-1).view(torch.uint8).numpy()
    mv = memoryview(buf)
    if mv.ndim != 1 or mv.format not in ("B", "b", "c"):
        mv = mv.cast("B")
    return np.frombuffer(mv, dtype=np.uint8)


# native runs engine (opal_pack_general.c analog): plain memcpy over the
# datatype's coalesced runs, no 8x index-matrix materialization. Worth
# the two ctypes array handoffs above this payload size; numpy below it.
_NATIVE_MIN_BYTES = 4096


def _runs_arrays(datatype: Datatype):
    arrs = getattr(datatype, "_run_arrays", None)
    if arrs is None:
        runs = datatype._compute_runs()
        arrs = (np.array([o for o, _ in runs], np.int64),
                np.array([n for _, n in runs], np.int64))
        datatype._run_arrays = arrs
    return arrs


def _native_lib():
    from ompi_tpu_torch.native import get_lib

    return get_lib()


def _gather_index(count: int, datatype: Datatype) -> np.ndarray:
    """Source-byte offset of every packed byte: element origins x the
    per-element byte map (the numpy path's 8x index array)."""
    bm = datatype._compute_byte_map()
    origins = np.arange(count, dtype=np.int64) * datatype.extent
    return (origins[:, None] + bm[None, :]).reshape(-1)


def pack(buf, count: int, datatype: Datatype) -> np.ndarray:
    """Pack `count` elements of `datatype` from `buf` into a dense uint8
    array (the wire format). Contiguous fast path is a zero-copy view when
    possible; large derived types run the native runs engine."""
    src = _as_byte_view(buf)
    need = (count - 1) * datatype.extent + datatype.true_lb + datatype.true_extent
    if count and src.nbytes < need:
        raise MPIError(ERR_BUFFER,
                       f"buffer too small: {src.nbytes} < {need}")
    if datatype.is_contiguous:
        return src[: count * datatype.size]
    total = count * datatype.size
    if total >= _NATIVE_MIN_BYTES and src.flags.c_contiguous:
        lib = _native_lib()
        off, ln = _runs_arrays(datatype)
        out = np.empty(total, np.uint8)
        lib.ompi_tpu_pack_runs(
            src.ctypes.data, out.ctypes.data,
            off.ctypes.data, ln.ctypes.data,
            len(off), count, datatype.extent)
        return out
    return src[_gather_index(count, datatype)]


def unpack(packed, buf, count: int, datatype: Datatype) -> None:
    """Scatter the dense wire stream back into `buf` honoring the typemap."""
    dst = _as_byte_view(buf)
    src = _as_byte_view(packed)
    total = count * datatype.size
    if src.nbytes < total:
        raise MPIError(ERR_TRUNCATE,
                       f"packed stream {src.nbytes} < expected {total}")
    if datatype.is_contiguous:
        dst[:total] = src[:total]
        return
    # checked before either path: the native scatter would write past
    # an undersized buffer, where the reference checks nothing
    need = (count - 1) * datatype.extent + datatype.true_lb \
        + datatype.true_extent
    if count and dst.nbytes < need:
        raise MPIError(ERR_BUFFER, f"buffer too small: {dst.nbytes} < {need}")
    if total >= _NATIVE_MIN_BYTES and src.flags.c_contiguous and \
            dst.flags.c_contiguous and dst.flags.writeable:
        lib = _native_lib()
        off, ln = _runs_arrays(datatype)
        lib.ompi_tpu_unpack_runs(
            src.ctypes.data, dst.ctypes.data,
            off.ctypes.data, ln.ctypes.data,
            len(off), count, datatype.extent)
        return
    dst[_gather_index(count, datatype)] = src[:total]


class Convertor:
    """Stateful fragment-at-a-time cursor (reference prepare/pack/position
    contract). One convertor per in-flight message."""

    def __init__(self, buf, count: int, datatype: Datatype, for_send: bool):
        self.buf = buf
        self.count = count
        self.datatype = datatype
        self.for_send = for_send
        self.packed_size = count * datatype.size
        self.position = 0
        self._bytes = _as_byte_view(buf)

    @property
    def remaining(self) -> int:
        return self.packed_size - self.position

    def set_position(self, pos: int) -> None:
        """Reposition mid-stream (reference: opal_convertor_set_position,
        required by the RDMA/rendezvous pipeline's out-of-order
        fragments)."""
        if pos < 0 or pos > self.packed_size:
            raise MPIError(ERR_BUFFER, f"position {pos} out of range")
        self.position = pos

    def _stream_index(self, start: int, n: int) -> np.ndarray:
        """Map packed-stream bytes [start, start+n) to source-byte offsets."""
        dt = self.datatype
        p = np.arange(start, start + n, dtype=np.int64)
        bm = dt._compute_byte_map()
        return (p // dt.size) * dt.extent + bm[p % dt.size]

    def pack_frag(self, max_bytes: int) -> np.ndarray:
        """Next fragment of the packed stream. Contiguous fast path: a
        BORROWED view of the caller's buffer, stable only until the
        transport's send returns (the window a buffered send completes
        in). Non-contiguous types gather into a fresh (owned) array."""
        n = min(max_bytes, self.remaining)
        dt = self.datatype
        if dt.is_contiguous:
            out = self._bytes[self.position : self.position + n]
        else:
            out = self._bytes[self._stream_index(self.position, n)]
        self.position += n  # mpiracer: disable=cross-thread-race — a convertor is owned by exactly one in-flight request; the pump lock / engine lock at the call sites serialize per-message use
        return out

    def unpack_frag(self, data) -> int:
        # `data` may be a borrowed view of a transport pool block:
        # _as_byte_view wraps it without a copy, and the scatter below is
        # the message's one landing copy into the posted buffer
        src = _as_byte_view(data)
        n = min(src.nbytes, self.remaining)
        dt = self.datatype
        if dt.is_contiguous:
            self._bytes[self.position : self.position + n] = src[:n]
        else:
            self._bytes[self._stream_index(self.position, n)] = src[:n]
        self.position += n  # mpiracer: disable=cross-thread-race — same single-owner contract as pack_frag
        return n
