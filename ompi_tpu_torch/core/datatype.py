"""MPI datatype engine.

The port of ``ompi_tpu/core/datatype.py`` (reference: opal/datatype, the
type description and convertor engine, and ompi/datatype, the MPI-level
constructors):

- A datatype is a **typemap**: a list of (numpy dtype, byte displacement)
  pairs plus (lb, extent). Predefined types are single-entry typemaps.
- At ``Commit()`` the typemap is flattened into a **byte map** (an int64
  array of source-byte offsets for one element) and a coalesced **run
  list** of contiguous (offset, length) extents. Packing N elements is a
  single vectorized gather, or the native runs engine
  (``native/convertor.cpp``) above a size threshold.
- Contiguous types pack with one slice (the reference's
  OPAL_DATATYPE_FLAG_CONTIGUOUS fast path).
- Partial packing falls out of the byte map: packed-stream byte p maps to
  source byte (p // size) * extent + byte_map[p % size].

Device-resident data never flows through this engine: a CUDA tensor is
staged to the host first (``accelerator.stage_to_host``). The engine
serves the host path (the process-mode wire format, MPI-IO,
heterogeneous users).

bf16: ``BFLOAT16`` is a 2-byte type stored as numpy ``uint16`` (numpy has
no bf16), named ``MPI_BFLOAT16``. The reference builds it from
``ml_dtypes`` and, where that import fails, makes it ``FLOAT16``, another
number format under the same name; the port needs no ``ml_dtypes`` and
never aliases the two. Its packed and external32 bytes equal the
reference's.
"""

from __future__ import annotations

import threading
from typing import List, Optional, Sequence, Tuple

import numpy as np

import torch

from ompi_tpu_torch.core.errors import MPIError, ERR_TYPE, ERR_ARG

# One typemap entry: (numpy dtype, byte displacement from element origin)
TypemapEntry = Tuple[np.dtype, int]

_next_id_lock = threading.Lock()
_next_id = 0


def _alloc_id() -> int:
    global _next_id
    with _next_id_lock:
        _next_id += 1
        return _next_id


class Datatype:
    """An MPI datatype (reference: ompi/datatype/ompi_datatype.h)."""

    def __init__(
        self,
        typemap: Sequence[TypemapEntry],
        lb: int = 0,
        extent: Optional[int] = None,
        name: str = "",
        np_dtype: Optional[np.dtype] = None,
    ):
        self.id = _alloc_id()
        self.typemap: List[TypemapEntry] = [
            (np.dtype(d), int(disp)) for d, disp in typemap
        ]
        self.name = name
        # size = true data bytes per element (reference: opal_datatype size)
        self.size = sum(d.itemsize for d, _ in self.typemap)
        if self.typemap:
            true_lb = min(disp for _, disp in self.typemap)
            true_ub = max(disp + d.itemsize for d, disp in self.typemap)
        else:
            true_lb = true_ub = 0
        self.true_lb = true_lb
        self.true_extent = true_ub - true_lb
        self.lb = int(lb)
        self.extent = int(extent) if extent is not None else true_ub - self.lb
        # Predefined scalar types carry their numpy dtype (bf16: its uint16
        # storage) for the zero-copy fast paths of contiguous host buffers.
        self.np_dtype = np.dtype(np_dtype) if np_dtype is not None else None
        self.committed = False
        self._byte_map: Optional[np.ndarray] = None
        self._runs: Optional[List[Tuple[int, int]]] = None
        # construction metadata for Get_envelope/Get_contents
        # (reference: ompi_datatype_get_args.c); None = predefined/NAMED
        self._contents: Optional[tuple] = None

    # ------------------------------------------------------------------ info
    @property
    def is_contiguous(self) -> bool:
        """True if `count` elements pack as one memcpy (no holes and
        extent == size)."""
        if not self.typemap:
            return True
        if self.size != self.extent or self.lb != 0:
            return False
        runs = self._compute_runs()
        return len(runs) == 1 and runs[0] == (0, self.size)

    def Get_size(self) -> int:
        return self.size

    def Get_extent(self) -> Tuple[int, int]:
        return self.lb, self.extent

    def Get_true_extent(self) -> Tuple[int, int]:
        return self.true_lb, self.true_extent

    def __repr__(self) -> str:
        return f"Datatype({self.name or self.id}, size={self.size}, extent={self.extent})"

    # ------------------------------------------------------------ commit/map
    def _compute_runs(self) -> List[Tuple[int, int]]:
        """Coalesced contiguous (offset, length) byte runs of one element."""
        if self._runs is not None:
            return self._runs
        spans = sorted(
            (disp, d.itemsize) for d, disp in self.typemap
        )
        runs: List[Tuple[int, int]] = []
        for off, ln in spans:
            if runs and runs[-1][0] + runs[-1][1] == off:
                runs[-1] = (runs[-1][0], runs[-1][1] + ln)
            else:
                runs.append((off, ln))
        self._runs = runs
        return runs

    def _compute_byte_map(self) -> np.ndarray:
        """int64[size] array: packed byte i of one element comes from source
        byte byte_map[i] (relative to element origin)."""
        if self._byte_map is None:
            parts = [
                np.arange(off, off + ln, dtype=np.int64)
                for off, ln in self._compute_runs()
            ]
            self._byte_map = (
                np.concatenate(parts) if parts else np.zeros(0, np.int64)
            )
        return self._byte_map

    def Get_envelope(self):
        """(num_integers, num_addresses, num_datatypes, combiner) —
        MPI_Type_get_envelope (reference: ompi_datatype_get_args.c)."""
        if self._contents is None:
            return 0, 0, 0, "NAMED"
        comb, ints, addrs, dts = self._contents
        return len(ints), len(addrs), len(dts), comb

    def Get_contents(self):
        """(integers, addresses, datatypes) the constructor was called
        with — MPI_Type_get_contents; errors on NAMED types per MPI."""
        if self._contents is None:
            raise MPIError(ERR_ARG,
                           "Get_contents on a predefined (NAMED) type")
        comb, ints, addrs, dts = self._contents
        return list(ints), list(addrs), list(dts)

    def _with_contents(self, comb, ints=(), addrs=(), dts=()):
        self._contents = (comb, list(ints), list(addrs), list(dts))
        return self

    def Commit(self) -> "Datatype":
        self._compute_byte_map()
        self.committed = True
        return self

    def Free(self) -> None:
        self.committed = False
        self._byte_map = None
        self._runs = None

    # ---------------------------------------------------------- constructors
    # Reference: ompi/datatype/ompi_datatype_create_*.c
    def Create_contiguous(self, count: int) -> "Datatype":
        tm = [
            (d, disp + i * self.extent)
            for i in range(count)
            for d, disp in self.typemap
        ]
        return Datatype(
            tm,
            lb=self.lb,
            extent=self.extent * count,
            name=f"contig({count})x{self.name}",
            np_dtype=self.np_dtype if self.is_contiguous else None,
        )._with_contents("CONTIGUOUS", [count], [], [self])

    def Create_vector(self, count: int, blocklength: int, stride: int) -> "Datatype":
        """stride in units of this type's extent (MPI_Type_vector)."""
        t = self.Create_hvector(count, blocklength, stride * self.extent)
        return t._with_contents("VECTOR", [count, blocklength, stride],
                                [], [self])

    def Create_hvector(self, count: int, blocklength: int, stride_bytes: int) -> "Datatype":
        tm = []
        for i in range(count):
            base = i * stride_bytes
            for j in range(blocklength):
                for d, disp in self.typemap:
                    tm.append((d, base + j * self.extent + disp))
        ub = (count - 1) * stride_bytes + blocklength * self.extent
        return Datatype(tm, lb=0, extent=ub,
                        name=f"vector{count}x{blocklength}")._with_contents(
            "HVECTOR", [count, blocklength], [stride_bytes], [self])

    def Create_indexed(
        self, blocklengths: Sequence[int], displacements: Sequence[int]
    ) -> "Datatype":
        """displacements in units of this type's extent (MPI_Type_indexed)."""
        t = self.Create_hindexed(
            blocklengths, [d * self.extent for d in displacements]
        )
        return t._with_contents(
            "INDEXED",
            [len(blocklengths)] + list(blocklengths) + list(displacements),
            [], [self])

    def Create_hindexed(
        self, blocklengths: Sequence[int], displacements_bytes: Sequence[int]
    ) -> "Datatype":
        if len(blocklengths) != len(displacements_bytes):
            raise MPIError(ERR_ARG, "blocklengths/displacements length mismatch")
        tm = []
        ub = 0
        for bl, db in zip(blocklengths, displacements_bytes):
            for j in range(bl):
                for d, disp in self.typemap:
                    tm.append((d, db + j * self.extent + disp))
            ub = max(ub, db + bl * self.extent)
        return Datatype(tm, lb=0, extent=ub, name="hindexed")._with_contents(
            "HINDEXED", [len(blocklengths)] + list(blocklengths),
            list(displacements_bytes), [self])

    @staticmethod
    def Create_struct(
        blocklengths: Sequence[int],
        displacements_bytes: Sequence[int],
        types: Sequence["Datatype"],
    ) -> "Datatype":
        if not (len(blocklengths) == len(displacements_bytes) == len(types)):
            raise MPIError(ERR_ARG, "struct argument length mismatch")
        tm = []
        ub = 0
        lb = None
        for bl, db, t in zip(blocklengths, displacements_bytes, types):
            for j in range(bl):
                for d, disp in t.typemap:
                    tm.append((d, db + j * t.extent + disp))
            ub = max(ub, db + bl * t.extent)
            lb = db if lb is None else min(lb, db)
        return Datatype(tm, lb=lb or 0, extent=ub - (lb or 0),
                        name="struct")._with_contents(
            "STRUCT", [len(blocklengths)] + list(blocklengths),
            list(displacements_bytes), list(types))

    def Create_subarray(
        self,
        sizes: Sequence[int],
        subsizes: Sequence[int],
        starts: Sequence[int],
        order: str = "C",
    ) -> "Datatype":
        """n-dim subarray (MPI_Type_create_subarray), used heavily by MPI-IO."""
        if not (len(sizes) == len(subsizes) == len(starts)):
            raise MPIError(ERR_ARG, "subarray argument length mismatch")
        if order != "C":
            sizes, subsizes, starts = sizes[::-1], subsizes[::-1], starts[::-1]
        # Flattened element offsets of the subarray inside the full array.
        idx = np.zeros((), np.int64)
        for sz, ssz, st in zip(sizes, subsizes, starts):
            idx = idx[..., None] * sz + (st + np.arange(ssz, dtype=np.int64))
        offsets = idx.reshape(-1)
        tm = [
            (d, int(o) * self.extent + disp)
            for o in offsets
            for d, disp in self.typemap
        ]
        total = int(np.prod(np.asarray(sizes, dtype=np.int64)))
        return Datatype(tm, lb=0, extent=total * self.extent,
                        name="subarray")._with_contents(
            "SUBARRAY",
            [len(sizes)] + list(sizes) + list(subsizes) + list(starts),
            [], [self])

    def Create_resized(self, lb: int, extent: int) -> "Datatype":
        return Datatype(self.typemap, lb=lb, extent=extent,
                        name=f"resized:{self.name}",
                        np_dtype=self.np_dtype)._with_contents(
            "RESIZED", [], [lb, extent], [self])

    def Dup(self) -> "Datatype":
        t = Datatype(self.typemap, lb=self.lb, extent=self.extent,
                     name=self.name, np_dtype=self.np_dtype)
        # MPI_Type_dup always reports COMBINER_DUP — including dups of
        # predefined types (reference: ompi_datatype_get_args.c records
        # DUP args unconditionally)
        return t._with_contents("DUP", [], [], [self])


# --------------------------------------------------------------- predefined
def _predef(np_dtype, name: str) -> Datatype:
    d = np.dtype(np_dtype)
    t = Datatype([(d, 0)], lb=0, extent=d.itemsize, name=name, np_dtype=d)
    t.Commit()
    return t


BYTE = _predef(np.uint8, "MPI_BYTE")
CHAR = _predef(np.int8, "MPI_CHAR")
BOOL = _predef(np.bool_, "MPI_C_BOOL")
INT8 = _predef(np.int8, "MPI_INT8_T")
INT16 = _predef(np.int16, "MPI_INT16_T")
INT32 = _predef(np.int32, "MPI_INT32_T")
INT64 = _predef(np.int64, "MPI_INT64_T")
UINT8 = _predef(np.uint8, "MPI_UINT8_T")
UINT16 = _predef(np.uint16, "MPI_UINT16_T")
UINT32 = _predef(np.uint32, "MPI_UINT32_T")
UINT64 = _predef(np.uint64, "MPI_UINT64_T")
FLOAT16 = _predef(np.float16, "MPI_FLOAT16")
FLOAT32 = _predef(np.float32, "MPI_FLOAT")
FLOAT64 = _predef(np.float64, "MPI_DOUBLE")
COMPLEX64 = _predef(np.complex64, "MPI_C_FLOAT_COMPLEX")
COMPLEX128 = _predef(np.complex128, "MPI_C_DOUBLE_COMPLEX")

# bfloat16 as a first-class predefined type (the reference has no bf16;
# shortfloat ext is the closest analog: ompi/mpiext/shortfloat). numpy has
# no bf16, so its storage is uint16: the same bytes, and external32 swaps
# it as one 2-byte field, as it does ml_dtypes' bfloat16.
BFLOAT16 = _predef(np.uint16, "MPI_BFLOAT16")

# C-style aliases
INT = INT32
LONG = INT64
FLOAT = FLOAT32
DOUBLE = FLOAT64

# MINLOC/MAXLOC pair types (reference: ompi_datatype_create pair types)
FLOAT_INT = Datatype.Create_struct(
    [1, 1], [0, 4], [FLOAT32, INT32]
).Commit()
FLOAT_INT.name = "MPI_FLOAT_INT"
DOUBLE_INT = Datatype.Create_struct(
    [1, 1], [0, 8], [FLOAT64, INT32]
).Commit()
DOUBLE_INT.name = "MPI_DOUBLE_INT"
INT_INT = Datatype.Create_struct([1, 1], [0, 4], [INT32, INT32]).Commit()
INT_INT.name = "MPI_2INT"

_BY_NP: dict = {}
for _t in (BOOL, INT8, INT16, INT32, INT64, UINT8, UINT16, UINT32, UINT64,
           FLOAT16, FLOAT32, FLOAT64, COMPLEX64, COMPLEX128):
    _BY_NP.setdefault(np.dtype(_t.np_dtype), _t)

_BY_TORCH = {
    torch.bool: BOOL, torch.int8: INT8, torch.int16: INT16,
    torch.int32: INT32, torch.int64: INT64, torch.uint8: UINT8,
    torch.float16: FLOAT16, torch.bfloat16: BFLOAT16,
    torch.float32: FLOAT32, torch.float64: FLOAT64,
    torch.complex64: COMPLEX64, torch.complex128: COMPLEX128,
}
# the unsigned wider types, where this torch has them (2.3 and later)
for _name, _t in (("uint16", UINT16), ("uint32", UINT32),
                  ("uint64", UINT64)):
    if hasattr(torch, _name):
        _BY_TORCH[getattr(torch, _name)] = _t


def from_numpy_dtype(dt) -> Datatype:
    """Map a numpy or torch dtype to the predefined MPI datatype. A numpy
    dtype named ``bfloat16`` of 2 bytes (``ml_dtypes.bfloat16``) and
    ``torch.bfloat16`` map to ``BFLOAT16``; ``uint16`` stays ``UINT16``."""
    if isinstance(dt, torch.dtype):
        t = _BY_TORCH.get(dt)
        if t is None:
            raise MPIError(ERR_TYPE, f"no MPI datatype for torch dtype {dt}")
        return t
    d = np.dtype(dt)
    if d.name == "bfloat16" and d.itemsize == 2:
        return BFLOAT16
    t = _BY_NP.get(d)
    if t is None:
        raise MPIError(ERR_TYPE, f"no MPI datatype for numpy dtype {d}")
    return t
