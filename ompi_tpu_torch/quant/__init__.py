"""Quantized collectives: the settings and the counters.

The port of the part of ``ompi_tpu/quant/__init__.py`` that mesh mode
reads. The JAX package registers the six settings as MCA variables
(``quant_enable`` and the rest) and the counters as MPI_T pvars; the port
has no variable system yet, so they are module attributes with the
reference's defaults, read when a communicator is built (``negotiate``)
and bumped by the quantized allreduce (``coll/quant.py``). The tcp
compression counters belong to process mode and are not ported.
"""

from __future__ import annotations

import threading
from typing import Dict

# block-scaled quantized allreduce of float payloads of at least min_bytes
# a rank, on communicators built while enable is set
enable = False
bits = 8          # 8 (int8/fp8); the reference's packed int4 is process mode
block = 64        # elements a scaling block (one f32 scale each)
min_bytes = 65536
mode = "int8"     # "int8" or "fp8" (float8_e4m3fn)
strict = False    # a mismatch raises instead of falling back (process mode)

_lock = threading.Lock()
_counts: Dict[str, int] = {
    "colls": 0,        # collectives that took the quantized path
    "bytes_wire": 0,   # quantized payload bytes sent
    "bytes_saved": 0,  # full-precision bytes minus bytes_wire
}


def note_coll(verb: str, raw_bytes: int, wire_bytes: int) -> None:
    """One quantized collective ran: ``raw_bytes`` is what the
    full-precision schedule would have sent, ``wire_bytes`` what the
    quantized one sent."""
    with _lock:
        _counts["colls"] += 1
        _counts["bytes_wire"] += int(wire_bytes)
        _counts["bytes_saved"] += max(int(raw_bytes) - int(wire_bytes), 0)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0
