"""Native (C++) components of the port and their ctypes bindings.

The port of the loader of ``ompi_tpu/native/__init__.py``: ``compile_so``
and a ``get_lib`` that binds the shared-memory ring of the sm btl
(``sm_ring.cpp``: the ``smr_*`` symbols, driven by ``native/ring.py``) and
the datatype engine's runs engine (``convertor.cpp``:
``ompi_tpu_pack_runs`` and ``ompi_tpu_unpack_runs``). Both sources build
into one library.

The library is built with the system ``g++`` at first use into
``build/ompi_tpu_torch/`` at the root of the checkout, named by a digest
of its sources and flags (as ``ops/_build.py`` names the CUDA kernels), so
an edited source is rebuilt and an unchanged one reused. Nothing is built
when a module is imported.

Unlike the reference, a failed build or load raises ``NativeBuildError``
with the compiler's output: nothing falls back quietly. The convertor
takes its numpy path only below ``_NATIVE_MIN_BYTES``, where the reference
takes it too; the ring takes its Python path only where the caller asks
for it (``btl_sm_use_native=0``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional, Sequence

from ompi_tpu_torch.ops._build import BUILD_DIR

_HERE = Path(__file__).resolve().parent
SOURCES = (_HERE / "sm_ring.cpp", _HERE / "convertor.cpp")
CXX = ("g++", "-O2", "-shared", "-fPIC", "-std=c++17")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


class NativeBuildError(RuntimeError):
    """The native library did not build or load. The message holds the
    command and the compiler's output."""


def compile_so(cmd_prefix: Sequence[str], srcs: Sequence, dest,
               timeout: float = 180) -> Path:
    """Race-safe on-demand compile: build to a private temp file in
    dest's directory, then rename it into place (last writer wins; equal
    content makes the race harmless). Returns dest; raises
    ``NativeBuildError`` with the command and its output."""
    dest = Path(dest)
    try:
        dest.parent.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=dest.parent)
        os.close(fd)
    except OSError as e:
        raise NativeBuildError(f"cannot write {dest.parent}: {e}") from e
    cmd = [*cmd_prefix, *map(str, srcs), "-o", tmp]
    try:
        try:
            proc = subprocess.run(cmd, capture_output=True, text=True,
                                  timeout=timeout)
        except (subprocess.SubprocessError, OSError) as e:
            raise NativeBuildError(
                f"native build failed: {' '.join(cmd)}: {e}") from e
        if proc.returncode:
            raise NativeBuildError(
                f"native build failed (exit {proc.returncode}): "
                f"{' '.join(cmd)}\n{proc.stdout}{proc.stderr}".rstrip())
        os.replace(tmp, dest)
        return dest
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def library_path() -> Path:
    """Where the library of the current sources and flags lives."""
    h = hashlib.sha256(" ".join(CXX).encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libompi_tpu_native-{h.hexdigest()[:16]}.so"


def get_lib() -> ctypes.CDLL:
    """The native library, built first if needed. Raises
    ``NativeBuildError`` if it does not build or load."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not path.exists():
            compile_so(CXX, SOURCES, path, timeout=120)
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as e:
            raise NativeBuildError(f"cannot load {path}: {e}") from e
        lib.smr_header_bytes.restype = ctypes.c_uint64
        lib.smr_init.restype = ctypes.c_int
        lib.smr_init.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.smr_capacity.restype = ctypes.c_uint64
        lib.smr_capacity.argtypes = [ctypes.c_void_p]
        lib.smr_push2.restype = ctypes.c_int
        lib.smr_push2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_uint64, ctypes.c_void_p,
                                  ctypes.c_uint64]
        lib.smr_pop.restype = ctypes.c_int64
        lib.smr_pop.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                ctypes.c_uint64]
        lib.smr_peek.restype = ctypes.c_int64
        lib.smr_peek.argtypes = [ctypes.c_void_p,
                                 ctypes.POINTER(ctypes.c_uint64)]
        lib.smr_advance.restype = None
        lib.smr_advance.argtypes = [ctypes.c_void_p, ctypes.c_uint64]
        lib.smr_used.restype = ctypes.c_uint64
        lib.smr_used.argtypes = [ctypes.c_void_p]
        for fn in (lib.ompi_tpu_pack_runs, lib.ompi_tpu_unpack_runs):
            fn.restype = None
            fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_void_p, ctypes.c_void_p,
                           ctypes.c_int64, ctypes.c_int64, ctypes.c_int64]
        _lib = lib
        return _lib
