"""MPI_Pack/Unpack and the external32 canonical data representation.

The port of ``ompi_tpu/core/external32.py`` (reference:
ompi/datatype/ompi_datatype_external32.c, the canonical big-endian
representation every MPI must provide for file and message portability,
and opal/datatype/opal_copy_functions_heterogeneous.c, the kernels that
byteswap per predefined type, not per byte run: a complex number swaps
each component, not the whole 16 bytes).

Built on the byte-map engine of core/convertor.py: native Pack/Unpack
reuse it directly; the external32 variants walk the typemap ENTRIES in
DECLARATION order (the canonical stream follows the typemap as declared,
which for a struct with out-of-order displacements differs from the byte
map's displacement-sorted wire format), so each field is gathered,
endian-converted as a unit, and placed at its canonical offset. Every
predefined type has an external32 size equal to its native size (IEEE
floats, two's-complement ints), so conversion is pure byte reordering.
``BFLOAT16`` (uint16 storage) swaps as one 2-byte field, as the
reference's ``ml_dtypes`` bfloat16 does.
"""

from __future__ import annotations

import numpy as np

from ompi_tpu_torch.core.convertor import (
    _as_byte_view,
    pack as _native_pack,
    unpack as _native_unpack,
)
from ompi_tpu_torch.core.datatype import Datatype
from ompi_tpu_torch.core.errors import (
    MPIError,
    ERR_ARG,
    ERR_BUFFER,
    ERR_TRUNCATE,
)

_LITTLE = np.little_endian


def _check_rep(datarep: str) -> None:
    if datarep != "external32":
        raise MPIError(ERR_ARG,
                       f"unsupported data representation {datarep!r} "
                       "(only 'external32')")


def _entries(dt: Datatype):
    """(packed_offset, disp, np.dtype) per typemap entry, in typemap
    DECLARATION order — external32 streams fields as declared, so other
    MPI implementations decode them identically."""
    out = []
    pos = 0
    for d, disp in dt.typemap:
        out.append((pos, disp, d))
        pos += d.itemsize
    return out


def _check_data_extent(view: np.ndarray, count: int, dt: Datatype,
                       what: str) -> None:
    """The data buffer must span count elements of the datatype's
    extent (same rule as convertor.pack) — undersized buffers raise
    MPIError, not a raw numpy IndexError."""
    need = (count - 1) * dt.extent + dt.true_lb + dt.true_extent
    if count and view.nbytes < need:
        raise MPIError(ERR_BUFFER,
                       f"{what} too small: {view.nbytes} < {need}")


def _swap_fields(block: np.ndarray, d: np.dtype) -> np.ndarray:
    """Reverse each field's bytes (little <-> big endian). block is
    [count, itemsize] uint8. Complex types swap each real/imag
    component separately (the heterogeneous-kernel rule)."""
    if d.itemsize == 1 or not _LITTLE:
        return block
    n = block.shape[0]
    if d.kind == "c":
        half = d.itemsize // 2
        return block.reshape(n, 2, half)[:, :, ::-1].reshape(
            n, d.itemsize)
    return block[:, ::-1]


def pack_external_size(datarep: str, count: int, datatype: Datatype) -> int:
    """MPI_Pack_external_size: bytes `count` elements occupy in the
    canonical representation."""
    _check_rep(datarep)
    return count * datatype.size


def pack_external(datarep: str, inbuf, count: int, datatype: Datatype,
                  outbuf, position: int = 0) -> int:
    """MPI_Pack_external: append `count` elements in canonical
    big-endian form to `outbuf` at `position`; returns the new
    position."""
    _check_rep(datarep)
    src = _as_byte_view(inbuf)
    dst = _as_byte_view(outbuf)
    _check_data_extent(src, count, datatype, "inbuf")
    total = count * datatype.size
    if position + total > dst.nbytes:
        raise MPIError(ERR_BUFFER,
                       f"outbuf too small: {dst.nbytes} < "
                       f"{position + total}")
    if count == 0:
        return position
    entries = _entries(datatype)
    if len(entries) == 1 and datatype.is_contiguous:
        # contiguous single-field fast path: one strided byte reversal,
        # no index matrices (they cost 8-16x the payload in temporaries)
        _, _, d = entries[0]
        block = _swap_fields(
            src[: total].reshape(count, d.itemsize), d)
        dst[position: position + total] = block.reshape(-1)
        return position + total
    elem = np.arange(count, dtype=np.int64)
    for pos, disp, d in entries:
        isz = d.itemsize
        gather = (elem[:, None] * datatype.extent + disp
                  + np.arange(isz, dtype=np.int64)[None, :])
        block = _swap_fields(src[gather.reshape(-1)].reshape(count, isz),
                             d)
        place = (position + elem[:, None] * datatype.size + pos
                 + np.arange(isz, dtype=np.int64)[None, :])
        dst[place.reshape(-1)] = block.reshape(-1)
    return position + total


def unpack_external(datarep: str, inbuf, position: int, outbuf,
                    count: int, datatype: Datatype) -> int:
    """MPI_Unpack_external: read `count` canonical elements from
    `inbuf` at `position` into `outbuf`; returns the new position."""
    _check_rep(datarep)
    src = _as_byte_view(inbuf)
    dst = _as_byte_view(outbuf)
    _check_data_extent(dst, count, datatype, "outbuf")
    total = count * datatype.size
    if position + total > src.nbytes:
        raise MPIError(ERR_TRUNCATE,
                       f"packed stream {src.nbytes} < expected "
                       f"{position + total}")
    if count == 0:
        return position
    entries = _entries(datatype)
    if len(entries) == 1 and datatype.is_contiguous:
        _, _, d = entries[0]
        block = _swap_fields(
            src[position: position + total].reshape(count, d.itemsize), d)
        dst[: total] = block.reshape(-1)
        return position + total
    elem = np.arange(count, dtype=np.int64)
    for pos, disp, d in entries:
        isz = d.itemsize
        take = (position + elem[:, None] * datatype.size + pos
                + np.arange(isz, dtype=np.int64)[None, :])
        block = _swap_fields(src[take.reshape(-1)].reshape(count, isz), d)
        place = (elem[:, None] * datatype.extent + disp
                 + np.arange(isz, dtype=np.int64)[None, :])
        dst[place.reshape(-1)] = block.reshape(-1)
    return position + total


# ------------------------------------------------- native Pack / Unpack
def pack_size(count: int, datatype: Datatype) -> int:
    """MPI_Pack_size (native representation: exact, no slack needed)."""
    return count * datatype.size


def mpi_pack(inbuf, count: int, datatype: Datatype, outbuf,
             position: int = 0) -> int:
    """MPI_Pack: append `count` native-representation elements."""
    dst = _as_byte_view(outbuf)
    data = _native_pack(inbuf, count, datatype)
    if position + data.nbytes > dst.nbytes:
        raise MPIError(ERR_BUFFER,
                       f"outbuf too small: {dst.nbytes} < "
                       f"{position + data.nbytes}")
    dst[position: position + data.nbytes] = data
    return position + data.nbytes


def mpi_unpack(inbuf, position: int, outbuf, count: int,
               datatype: Datatype) -> int:
    """MPI_Unpack: scatter `count` native elements from `inbuf`."""
    src = _as_byte_view(inbuf)
    total = count * datatype.size
    if position + total > src.nbytes:
        raise MPIError(ERR_TRUNCATE,
                       f"packed stream {src.nbytes} < expected "
                       f"{position + total}")
    _native_unpack(src[position: position + total], outbuf, count,
                   datatype)
    return position + total
