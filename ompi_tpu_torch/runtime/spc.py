"""SPC, the software performance counters.

The port of ``ompi_tpu/runtime/spc.py`` (reference: ompi/runtime/ompi_spc.c,
SPC_RECORD in every binding, the counters exported as MPI_T pvars). Counters
are named dynamically and recorded at the communicator's verb layer; they
surface as ``spc_<name>`` pvars (``mca/var.py`` ``all_pvars``). The
``spc_enable`` variable gates recording; ``suppressed()`` keeps the
library's internal traffic out of the counters.
"""

from __future__ import annotations

import contextlib
import sys
import threading
import time
from collections import defaultdict
from typing import Dict

from ompi_tpu_torch.mca.var import register_var

# record() reads the Var's _value on every call, so set_var stays live
_enable_var = register_var("spc", "enable", True,
                           help="Record software performance counters "
                                "(reference: mpi_spc_attach)", level=4)

_lock = threading.Lock()
_counters: Dict[str, int] = defaultdict(int)


class _Suppress(threading.local):
    depth = 0  # a thread that never suppressed reads the class default


_suppress = _Suppress()
# the threads inside suppressed(), so that record() reads the thread-local
# only while some thread suppresses (a thread-local read costs about twice
# a global's)
_nsuppress = 0


@contextlib.contextmanager
def suppressed():
    """Record nothing in this thread within the block: library-internal
    traffic must not show as the user's."""
    global _nsuppress
    depth = _suppress.depth
    _suppress.depth = depth + 1
    if not depth:
        with _lock:
            _nsuppress += 1
    try:
        yield
    finally:
        _suppress.depth = depth
        if not depth:
            with _lock:
                _nsuppress -= 1


def _enabled() -> bool:
    return _enable_var._value and not (_nsuppress and _suppress.depth)


def record(name: str, value: int = 1) -> None:
    """SPC_RECORD. On every verb's path, so the gate is inlined: one
    attribute load off the live Var, and the thread's suppress depth only
    while some thread suppresses. No lock: under the
    GIL a racing add can at worst lose a count, the trade the reference's
    non-atomic SPC_RECORD makes."""
    if _enable_var._value and not (_nsuppress and _suppress.depth):
        _counters[name] += value


def record_bytes(name: str, nbytes: int) -> None:
    if not _enabled():
        return
    with _lock:
        _counters[name + "_count"] += 1
        _counters[name + "_bytes"] += int(nbytes)


def record_max(name: str, value: int) -> None:
    """High-water mark (reference: the SPC watermark counters)."""
    if not _enabled():
        return
    with _lock:
        if value > _counters[name + "_hwm"]:
            _counters[name + "_hwm"] = int(value)


class timer:
    """Accumulates wall microseconds into ``<name>_time_us``. Reentrant:
    each nesting level keeps its own start."""

    __slots__ = ("name", "_starts")

    def __init__(self, name: str):
        self.name = name
        self._starts = []

    def __enter__(self):
        self._starts.append(time.perf_counter_ns() if _enabled() else 0)
        return self

    def __exit__(self, *exc):
        t0 = self._starts.pop()
        if t0:
            us = (time.perf_counter_ns() - t0) // 1000
            with _lock:
                _counters[self.name + "_time_us"] += us
        return False


def snapshot() -> Dict[str, int]:
    with _lock:
        return dict(_counters)


def get(name: str) -> int:
    with _lock:
        return _counters.get(name, 0)


def reset() -> None:
    with _lock:
        _counters.clear()


def dump(file=None) -> None:
    """Human-readable dump of every counter."""
    out = file or sys.stderr
    snap = snapshot()
    if not snap:
        print("spc: no counters recorded", file=out)
        return
    width = max(len(k) for k in snap)
    for k in sorted(snap):
        print(f"spc: {k:<{width}} {snap[k]}", file=out)
