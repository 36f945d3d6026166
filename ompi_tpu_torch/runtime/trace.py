"""Cross-layer trace spans, exported as Chrome-trace JSON.

The port of ``ompi_tpu/runtime/trace.py``:

- spans: an instrumented layer wraps its section in
  ``with trace.span("comm.allreduce", cat="comm")``, nested begin/end
  events ("ph" B/E) with the rank (pid), thread (tid), category and args;
- each thread records into its own ring (no lock on the recording path);
  a wrapped ring overwrites its oldest events and counts them dropped
  (``trace_dropped_events``), and the export warns of it;
- one attribute load gates it: sites guard with ``if trace.enabled():``;
- a span's begin and end are also the MPI_T events ``trace_span_begin``
  and ``trace_span_end``, fired only where a tool subscribed to them;
- ``export`` writes ``trace-rank<N>.json`` under ``trace_dir``, and the
  process exports what it recorded at exit.

A span times the host: on the card a verb only enqueues its kernels, so a
span around it measures the dispatch, as the reference's does under JAX's
asynchronous dispatch. Nothing here waits for the device.

Enable with ``OMPI_TPU_MCA_trace_enable=1`` or
``set_var("trace", "enable", True)``.
"""

from __future__ import annotations

import atexit
import os
import tempfile
import threading
import time
from typing import Any, Dict, List, Optional, Tuple

from ompi_tpu_torch import mpit as _mpit
from ompi_tpu_torch.mca.var import register_pvar, register_var
from ompi_tpu_torch.utils.show_help import register_topic, show_help

register_topic(
    "trace", "ring-overflow",
    "The trace ring buffers wrapped: {dropped} events were overwritten\n"
    "before export (oldest first) — the exported timeline is TRUNCATED\n"
    "at its old end. Raise --mca trace_buffer_events (currently {cap}\n"
    "events per thread) or trace a shorter window. The exact count is\n"
    "also in the export's otherData.dropped_events field and the\n"
    "trace_dropped_events pvar.")

_enable_var = register_var(
    "trace", "enable", False,
    help="Record cross-layer spans into per-thread ring buffers and "
         "export Chrome-trace JSON at finalize", level=3)
_dir_var = register_var(
    "trace", "dir", "", typ=str,
    help="Directory for the per-rank trace-rank<N>.json export. Empty "
         "(default) = a per-job subdir of the system temp dir "
         "(ompi-tpu-trace-<launcher pid>)", level=3)
_cap_var = register_var(
    "trace", "buffer_events", 65536,
    help="Ring-buffer capacity (events) per thread; the oldest events "
         "are overwritten (and counted dropped) when a ring wraps",
    level=5)


def enabled() -> bool:
    """One attribute load off the live Var."""
    return _enable_var._value


def now() -> int:
    """The trace clock: monotonic ns."""
    return time.monotonic_ns()


# ------------------------------------------------------------------ rings
class _Ring:
    __slots__ = ("buf", "cap", "pos", "full", "dropped", "tid")

    def __init__(self, cap: int, tid: int):
        self.buf: List[Optional[tuple]] = [None] * cap
        self.cap = cap
        self.pos = 0
        self.full = False
        self.dropped = 0
        self.tid = tid


_reg_lock = threading.Lock()
_rings: List[_Ring] = []
_tls = threading.local()


def _ring() -> _Ring:
    r = getattr(_tls, "ring", None)
    if r is None:
        r = _Ring(max(int(_cap_var._value), 16), threading.get_ident())
        with _reg_lock:
            _rings.append(r)
        _tls.ring = r
    return r


def _record(ph: str, name: str, cat: str, ts: int,
            args: Optional[Dict[str, Any]]) -> None:
    """Append one event to this thread's ring (a list store, no lock)."""
    r = _ring()
    buf = r.buf
    pos = r.pos
    if pos >= len(buf):  # a concurrent reset() shrank the ring
        pos = 0
    if r.full:
        r.dropped += 1
    buf[pos] = (ph, ts, name, cat, args)
    pos += 1
    if pos >= len(buf):
        r.full = True
        pos = 0
    r.pos = pos


# ------------------------------------------------------------------ spans
class span:
    """``with trace.span(name, cat=..., **args)``: a B event at enter, an E
    at exit, each mirrored on the MPI_T event stream. Sites guard with
    ``if trace.enabled():``; the span itself records unconditionally, so a
    disable inside it cannot break the B/E pairing."""

    __slots__ = ("name", "cat", "args")

    def __init__(self, name: str, cat: str = "", **args: Any):
        self.name = name
        self.cat = cat
        self.args = args or None

    def __enter__(self):
        _record("B", self.name, self.cat, time.monotonic_ns(), self.args)
        _emit_mpit("span_begin", self.name, self.cat)
        return self

    def __exit__(self, *exc):
        _record("E", self.name, self.cat, time.monotonic_ns(), None)
        _emit_mpit("span_end", self.name, self.cat)
        return False


def step(n: int) -> span:
    """``with trace.step(n):`` brackets one training or serving step."""
    return span("trace.step", cat="step", step=int(n))


def record_span(name: str, t0: int, t1: int, cat: str = "",
                **args: Any) -> None:
    """A span after the fact, from saved ``now()`` timestamps."""
    _record("B", name, cat, t0, args or None)
    _record("E", name, cat, t1, None)
    _emit_mpit("span_begin", name, cat)
    _emit_mpit("span_end", name, cat)


def instant(name: str, cat: str = "", **args: Any) -> None:
    """A point event ("ph" i)."""
    _record("i", name, cat, time.monotonic_ns(), args or None)


def counter(name: str, value, cat: str = "") -> None:
    """A counter track ("ph" C)."""
    _record("C", name, cat, time.monotonic_ns(), {name: value})


def wrap_span(name: str, cat: str, fn):
    """``fn`` wrapped in a span, for tables that hand the function out."""

    def traced(*a, **kw):
        with span(name, cat):
            return fn(*a, **kw)

    return traced


def _emit_mpit(kind: str, name: str, cat: str) -> None:
    # an unlocked probe first: emit() takes the process-wide event lock
    # even with no subscriber, which would serialize every span
    if _mpit._event_handles.get("trace_" + kind):
        _mpit.emit("trace", kind, name=name, cat=cat)


# ----------------------------------------------------------------- export
def _rank() -> int:
    try:
        base = int(os.environ.get("OMPI_TPU_BASE", "0"))
        return base + int(os.environ.get("OMPI_TPU_RANK", "0"))
    except ValueError:
        return 0


def _collect() -> List[Tuple[int, tuple]]:
    """(tid, event) pairs of every ring, oldest first within a ring."""
    with _reg_lock:
        rings = list(_rings)
    out = []
    for r in rings:
        evs = (r.buf[r.pos:] + r.buf[:r.pos]) if r.full else r.buf[:r.pos]
        out.extend((r.tid, ev) for ev in evs if ev is not None)
    return out


def _sanitize(events: List[Dict[str, Any]]) -> List[Dict[str, Any]]:
    """Well-formed B/E pairs a (pid, tid): an E whose B was overwritten is
    dropped, a B whose E is missing is closed at the last timestamp."""
    events.sort(key=lambda e: e["ts"])
    out: List[Dict[str, Any]] = []
    stacks: Dict[tuple, List[Dict[str, Any]]] = {}
    last_ts = 0.0
    for ev in events:
        last_ts = max(last_ts, ev["ts"])
        ph = ev["ph"]
        if ph not in ("B", "E"):
            out.append(ev)
            continue
        stack = stacks.setdefault((ev["pid"], ev["tid"]), [])
        if ph == "B":
            stack.append(ev)
            out.append(ev)
        elif stack and stack[-1]["name"] == ev["name"]:
            stack.pop()
            out.append(ev)
    for stack in stacks.values():
        for b in reversed(stack):  # innermost closes first
            out.append({"name": b["name"], "cat": b["cat"], "ph": "E",
                        "ts": last_ts, "pid": b["pid"], "tid": b["tid"]})
    return out


def default_trace_dir() -> str:
    """Where exports land with ``trace_dir`` unset: a per-job directory
    of the system temp dir, keyed by the launcher's pid (or this
    process's)."""
    job = os.environ.get("OMPI_TPU_LAUNCHER_PID") or str(os.getpid())
    return os.path.join(tempfile.gettempdir(), f"ompi-tpu-trace-{job}")


def export(path: Optional[str] = None) -> str:
    """Write everything recorded so far as Chrome-trace JSON (traceEvents
    and metadata); returns the path."""
    rank = _rank()
    if path is None:
        base = _dir_var._value or default_trace_dir()
        try:
            os.makedirs(base, exist_ok=True)
        except OSError:
            base = "."
        path = os.path.join(base, f"trace-rank{rank}.json")
    events = []
    for tid, (ph, ts, name, cat, args) in _collect():
        ev: Dict[str, Any] = {"name": name, "cat": cat or "default",
                              "ph": ph, "ts": ts / 1000.0,
                              "pid": rank, "tid": tid}
        if args:
            ev["args"] = args
        events.append(ev)
    events = _sanitize(events)
    with _reg_lock:
        tids = sorted({r.tid for r in _rings})
        dropped = sum(r.dropped for r in _rings)
    meta: List[Dict[str, Any]] = [{
        "name": "process_name", "ph": "M", "pid": rank,
        "args": {"name": f"rank {rank}"}}]
    for tid in tids:
        meta.append({"name": "thread_name", "ph": "M", "pid": rank,
                     "tid": tid, "args": {"name": f"thread-{tid}"}})
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms",
           "otherData": {"rank": rank, "dropped_events": dropped,
                         "clock": "monotonic_ns"}}
    from ompi_tpu_torch.utils.fsio import atomic_write_json

    # default=str: span args are arbitrary caller values
    return atomic_write_json(path, doc, default=str)


def snapshot() -> List[Tuple[int, tuple]]:
    """The raw (tid, event) view."""
    return _collect()


def dropped_events() -> int:
    with _reg_lock:
        return sum(r.dropped for r in _rings)


def _warn_overflow() -> int:
    """The ring-overflow message where events were lost; returns how many."""
    d = dropped_events()
    if d:
        show_help("trace", "ring-overflow", dropped=d,
                  cap=int(_cap_var._value))
    return d


def buffered_events() -> int:
    with _reg_lock:
        return sum(r.cap if r.full else r.pos for r in _rings)


def reset() -> None:
    """Clear every ring, resized to the current ``trace_buffer_events``.
    The rings stay registered, so threads keep their handle."""
    cap = max(int(_cap_var._value), 16)
    with _reg_lock:
        for r in _rings:
            r.cap = cap
            r.buf = [None] * cap
            r.pos = 0
            r.full = False
            r.dropped = 0


register_pvar("trace", "dropped_events", dropped_events,
              help="Events lost to ring-buffer wrap across all threads")
register_pvar("trace", "buffered_events", buffered_events,
              help="Events currently held in the trace ring buffers")

_exported = False


def _maybe_export() -> None:
    """The exit hook: export once, if anything was recorded (a tool may
    have traced a window and turned tracing off again)."""
    global _exported
    if _exported or not buffered_events():
        return
    _exported = True
    try:
        _warn_overflow()
    except Exception:
        pass
    try:
        export()
    except Exception:
        import traceback

        traceback.print_exc()


from ompi_tpu_torch.hook import register_hook  # noqa: E402

register_hook("finalize_bottom", _maybe_export)
# mesh mode has no Finalize: exit is its export path
atexit.register(_maybe_export)
