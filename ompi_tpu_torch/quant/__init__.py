"""Quantized collectives: the settings and the counters.

The port of ``ompi_tpu/quant/__init__.py``'s settings and counters: the six
``quant_*`` variables (``:40-75``), read when a communicator is built
(``negotiate``), and the three counters with their pvars (``:92-101``),
bumped by the quantized collectives of both modes (``coll/quant.py``),
which also record ``spc`` ``quant_<verb>`` and, with metrics on, the
``quant_wire_pct`` histogram; and the tcp btl's compression counters
(``note_wire``, ``:122-135``), read by its ``btl_tcp_compress_ratio`` and
``btl_tcp_compress_saved_bytes`` pvars.
"""

from __future__ import annotations

import threading
from typing import Dict

from ompi_tpu_torch.mca.var import register_pvar, register_var
from ompi_tpu_torch.runtime import spc

_enable_var = register_var(
    "quant", "enable", False,
    help="Enable block-scaled quantized collectives (allreduce, "
         "reduce_scatter_block, allgather) for float payloads at or "
         "above quant_min_bytes. Negotiated per communicator: every "
         "member must enable with matching bits/block/mode, else all "
         "ranks fall back to full precision together", level=3)
_bits_var = register_var(
    "quant", "bits", 8,
    help="Quantized payload width in bits per element: 8 (int8/fp8) "
         "or 4 (packed int4; int mode only)", level=4,
    enum_values=(8, 4))
_block_var = register_var(
    "quant", "block", 64,
    help="Elements per scaling block (one f32 amax-derived scale is "
         "carried per block; larger blocks compress better, smaller "
         "blocks bound error tighter)", level=4)
_min_bytes_var = register_var(
    "quant", "min_bytes", 65536,
    help="Payload bytes below which quantization is skipped and the "
         "collective rides the full-precision path (quantization "
         "overhead beats the wire saving on small messages)", level=4)
_mode_var = register_var(
    "quant", "mode", "int8",
    help="Codec family: int8 (symmetric round-to-nearest-even "
         "integers) or fp8 (float8_e4m3fn)", level=4,
    enum_values=("int8", "fp8"))
_strict_var = register_var(
    "quant", "strict", False,
    help="On negotiation mismatch, raise MPIError on quant-eligible "
         "collectives (symmetrically, on every rank) instead of "
         "silently falling back to full precision", level=5)


_lock = threading.Lock()
_counts: Dict[str, int] = {
    "colls": 0,        # collectives that took the quantized path
    "bytes_wire": 0,   # quantized payload bytes sent
    "bytes_saved": 0,  # full-precision bytes minus bytes_wire
    "wire_raw": 0,     # tcp-compressed frames: payload bytes pre-zlib
    "wire_comp": 0,    # tcp-compressed frames: payload bytes on wire
    "wire_frames": 0,  # tcp frames that went out compressed
}

register_pvar("quant", "colls", lambda: _counts["colls"],
              help="Collectives that took the quantized path on this "
                   "rank")
register_pvar("quant", "bytes_saved", lambda: _counts["bytes_saved"],
              help="Payload bytes NOT moved thanks to quantization "
                   "(full-precision wire bytes minus quantized wire "
                   "bytes, summed over this rank's sends)")
register_pvar("quant", "bytes_wire", lambda: _counts["bytes_wire"],
              help="Quantized payload bytes this rank actually sent")


def note_coll(verb: str, raw_bytes: int, wire_bytes: int) -> None:
    """One quantized collective ran: ``raw_bytes`` is what the
    full-precision schedule would have sent, ``wire_bytes`` what the
    quantized one sent."""
    from ompi_tpu_torch.runtime import metrics as _metrics

    with _lock:
        _counts["colls"] += 1
        _counts["bytes_wire"] += int(wire_bytes)
        _counts["bytes_saved"] += max(int(raw_bytes) - int(wire_bytes), 0)
    spc.record("quant_" + verb)
    if _metrics._enable_var._value and raw_bytes > 0:
        _metrics.observe("quant_wire_pct", 100.0 * wire_bytes / raw_bytes,
                         verb=verb)


def note_wire(raw_bytes: int, comp_bytes: int) -> None:
    """One tcp frame went out zlib-compressed (the btl/tcp.py hook): the
    payload was ``raw_bytes`` and ``comp_bytes`` hit the wire."""
    from ompi_tpu_torch.runtime import metrics as _metrics

    with _lock:
        _counts["wire_raw"] += int(raw_bytes)
        _counts["wire_comp"] += int(comp_bytes)
        _counts["wire_frames"] += 1
    spc.record("btl_tcp_compressed_frames")
    if _metrics._enable_var._value and raw_bytes > 0:
        _metrics.observe("btl_tcp_compress_pct",
                         100.0 * comp_bytes / raw_bytes)


def counters() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def reset_counters() -> None:
    with _lock:
        for k in _counts:
            _counts[k] = 0
