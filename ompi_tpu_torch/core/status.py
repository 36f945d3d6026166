"""MPI_Status: the fields that the mesh-mode requests set.

The port's copy of the part of ``ompi_tpu/core/status.py`` that requests
fill in. The reference's ``Get_count`` and ``Get_elements`` read a
datatype's size; the port has no datatype layer (its payloads are tensors,
which carry their own dtype), so they are not copied.
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

    def Is_cancelled(self) -> bool:
        return self.cancelled

    def __repr__(self) -> str:
        return (f"Status(source={self.source}, tag={self.tag}, "
                f"error={self.error}, nbytes={self._nbytes})")
