"""MPI_Status.

The port of ``ompi_tpu/core/status.py`` (reference: the status fields of
ompi/request plus MPI_Get_count semantics, ompi/mpi/c/get_count.c.in).
``_nbytes`` holds received wire bytes; ``Get_count`` divides by the
datatype size, returning UNDEFINED when the byte count is not a whole
number of elements.
"""

from __future__ import annotations

UNDEFINED = -32766


class Status:
    __slots__ = ("source", "tag", "error", "_nbytes", "cancelled")

    def __init__(self):
        self.source = UNDEFINED
        self.tag = UNDEFINED
        self.error = 0
        self._nbytes = 0
        self.cancelled = False

    def Get_source(self) -> int:
        return self.source

    def Get_tag(self) -> int:
        return self.tag

    def Get_error(self) -> int:
        return self.error

    def Get_count(self, datatype) -> int:
        if datatype.size == 0:
            return 0
        if self._nbytes % datatype.size:
            return UNDEFINED
        return self._nbytes // datatype.size

    def Get_elements(self, datatype) -> int:
        """Count of *basic* elements received (may be a partial datatype)."""
        if not datatype.typemap:
            return 0
        full, rem = divmod(self._nbytes, datatype.size)
        n = full * len(datatype.typemap)
        # walk the typemap for the trailing partial element
        for d, _ in datatype.typemap:
            if rem < d.itemsize:
                break
            rem -= d.itemsize
            n += 1
        return n

    def Is_cancelled(self) -> bool:
        return self.cancelled

    def __repr__(self) -> str:
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"error={self.error}, nbytes={self._nbytes})")
