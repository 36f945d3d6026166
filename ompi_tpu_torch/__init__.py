"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu, for NVIDIA Hopper.

The package mirrors ``ompi_tpu``'s layout (``ops/``, ``models/``,
``parallel/``) and holds to its numerics, but imports nothing of it and
nothing of JAX: what it needs from the JAX package it keeps as its own copy.
Every Pallas kernel of the JAX package becomes a hand-written Hopper kernel
here (``csrc/``), built with ``nvcc`` on first use and bound with ``ctypes``;
beside each kernel sits its plain PyTorch version, which a wrapper takes only
for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).

The typed-buffer names of ``ompi_tpu`` are exported here as there:
``Datatype``, the predefined types and their aliases, ``Info``, and
``Pack``/``Unpack``/``Pack_size`` with their external32 forms.
"""

from ompi_tpu_torch.version import __version__
from ompi_tpu_torch.device import resolve_device
from ompi_tpu_torch.core.datatype import (
    Datatype,
    BYTE,
    CHAR,
    INT8,
    INT16,
    INT32,
    INT64,
    UINT8,
    UINT16,
    UINT32,
    UINT64,
    FLOAT16,
    BFLOAT16,
    FLOAT32,
    FLOAT64,
    COMPLEX64,
    COMPLEX128,
    BOOL,
    INT,
    LONG,
    FLOAT,
    DOUBLE,
)
from ompi_tpu_torch.core.info import Info
from ompi_tpu_torch.core.external32 import (
    mpi_pack as Pack,
    mpi_unpack as Unpack,
    pack_size as Pack_size,
    pack_external as Pack_external,
    unpack_external as Unpack_external,
    pack_external_size as Pack_external_size,
)

__all__ = [
    "__version__", "resolve_device", "Datatype", "BYTE", "CHAR", "INT8",
    "INT16", "INT32", "INT64", "UINT8", "UINT16", "UINT32", "UINT64",
    "FLOAT16", "BFLOAT16", "FLOAT32", "FLOAT64", "COMPLEX64", "COMPLEX128",
    "BOOL", "INT", "LONG", "FLOAT", "DOUBLE", "Info", "Pack", "Unpack",
    "Pack_size", "Pack_external", "Unpack_external", "Pack_external_size"]
