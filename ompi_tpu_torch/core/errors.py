"""MPI error classes, the exception type and the error handlers.

The port's copy of the part of ``ompi_tpu/core/errors.py`` that the
mesh-mode communicator, its requests, the mesh window, the multi-slice
comm, the checkpointer and MPI_T raise or carry. Error classes are
the stable integers of ``mpi.h``; the verbs raise ``MPIError`` with the
class.
"""

from __future__ import annotations

from typing import Callable

SUCCESS = 0
ERR_RANK = 6
ERR_REQUEST = 7
ERR_GROUP = 9
ERR_OP = 10
ERR_TOPOLOGY = 11
ERR_ARG = 13
ERR_OTHER = 16
ERR_INTERN = 17
ERR_PENDING = 19
ERR_FILE = 27
ERR_WIN = 45
ERR_UNSUPPORTED_OPERATION = 63
# ULFM (MPIX_ERR_REVOKED): an operation on a revoked communicator
ERR_REVOKED = 77

_ERROR_STRINGS = {
    SUCCESS: "MPI_SUCCESS: no error",
    ERR_RANK: "MPI_ERR_RANK: invalid rank",
    ERR_REQUEST: "MPI_ERR_REQUEST: invalid request",
    ERR_GROUP: "MPI_ERR_GROUP: invalid group",
    ERR_OP: "MPI_ERR_OP: invalid reduce operation",
    ERR_TOPOLOGY: "MPI_ERR_TOPOLOGY: invalid communicator topology",
    ERR_ARG: "MPI_ERR_ARG: invalid argument",
    ERR_OTHER: "MPI_ERR_OTHER: known error not in list",
    ERR_INTERN: "MPI_ERR_INTERN: internal error",
    ERR_PENDING: "MPI_ERR_PENDING: pending request",
    ERR_FILE: "MPI_ERR_FILE: invalid file handle",
    ERR_WIN: "MPI_ERR_WIN: invalid window",
    ERR_UNSUPPORTED_OPERATION: "MPI_ERR_UNSUPPORTED_OPERATION",
    ERR_REVOKED: "MPIX_ERR_REVOKED: communicator revoked",
}


def Error_string(code: int) -> str:
    return _ERROR_STRINGS.get(code, f"MPI error class {code}")


class MPIError(Exception):
    def __init__(self, code: int, detail: str = ""):
        self.code = code
        msg = Error_string(code)
        if detail:
            msg = f"{msg} ({detail})"
        super().__init__(msg)


class Errhandler:
    """MPI errhandler object: ``fn(comm_like, code, detail)`` decides how an
    error surfaces."""

    def __init__(self, fn: Callable, name: str = "user"):
        self.fn = fn
        self.name = name

    def invoke(self, obj, code: int, detail: str = "") -> int:
        return self.fn(obj, code, detail)


def _fatal(obj, code: int, detail: str = "") -> int:
    raise MPIError(code, detail)


def _ret(obj, code: int, detail: str = "") -> int:
    return code


ERRORS_ARE_FATAL = Errhandler(_fatal, "MPI_ERRORS_ARE_FATAL")
ERRORS_RETURN = Errhandler(_ret, "MPI_ERRORS_RETURN")
