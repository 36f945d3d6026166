"""Central progress engine.

The port of ``ompi_tpu/runtime/progress.py``. Reference:
opal/runtime/opal_progress.c:216-230, a registered-callback array polled
in a loop; low-priority callbacks (libevent) only every 8th call. Same
contract: transports register a ``fn() -> int`` (number of events they
handled); ``progress()`` polls them all. Blocking request waits drive
this loop (``core/request.py`` binds to it at import of this module).

Process mode can additionally run a dedicated progress *thread* (MCA var
``runtime_progress_thread``) so blocked Python code still progresses, the
analog of the reference's async-progress option.

Idle blocking (the libevent block-when-idle discipline): when the
IdleBackoff goes cold, ``progress_until`` and the ProgressThread PARK in
poll() over the fds the transports export (``set_idle_sources``) plus a
self-pipe wakeup, instead of spinning a core. Any inbound frame wakes the
parked loop at fd latency; local producers (a send that left a backlog,
a system-plane post, a request completion) ``poke()`` the pipe so nothing
waits out a backoff interval. A transport that polls memory instead of
fds (the sm rings) keeps the caller on the blind-sleep interval, while
fd-only transport sets park for up to ``runtime_idle_block_us``.
"""

from __future__ import annotations

import itertools
import os as _os
import select as _select
import threading
from typing import Callable, List, Optional

from ompi_tpu_torch.core import request as _request
from ompi_tpu_torch.mca.var import register_var, register_pvar
from ompi_tpu_torch.runtime import trace as _trace

_callbacks: List[Callable[[], int]] = []
_low_priority: List[Callable[[], int]] = []
_lock = threading.Lock()
# low-priority cadence counter. itertools.count, NOT a bare int += 1:
# the app thread's wait loops and the ProgressThread both call
# progress(), and the unlocked read-modify-write raced — two threads
# could observe the same value so the every-8th low-priority slot
# (watchdog scans, sanitizer polls) double-fired or skipped a beat.
# next() on a C-level iterator is atomic under the GIL.
_call_count = itertools.count(1)

register_var(
    "runtime", "progress_thread", True,
    help="Run a dedicated progress thread in process mode", level=4,
)
_idle_var = register_var(
    "runtime", "idle_block_us", 50000,
    help="Max microseconds an idle progress loop parks in select() "
         "over the transports' exported fds + the self-pipe wakeup "
         "once its backoff goes cold (the libevent block-when-idle "
         "analog). Poll-only transports (sm rings) cap the park at "
         "the caller's legacy sleep interval regardless. 0 restores "
         "the pure sleep backoff", level=5,
)

# --------------------------------------------------------- idle blocking
# transports' exported fd sources: each entry is a fn() -> (rfds, wfds),
# or None for a live transport that can only be POLLED (sm rings) and
# therefore caps how long anyone may park. Installed by wireup, cleared
# at shutdown.
_idle_sources: List[Optional[Callable]] = []
_wakeup: List[Optional[int]] = [None, None]  # self-pipe (r, w), lazy
_wake_lock = threading.Lock()
_parked = [0]       # threads currently inside the idle select
_idle_blocks = [0]  # pvar: completed parks

register_pvar("runtime", "progress_idle_blocks",
              lambda: _idle_blocks[0],
              help="Times an idle progress loop parked in select() "
                   "instead of spin/sleep polling")


def set_idle_sources(srcs: List[Optional[Callable]]) -> None:
    """Install the live transports' fd exporters (wireup). ``None``
    entries flag poll-only transports; they bound the park interval."""
    global _idle_sources
    _idle_sources = list(srcs)


def _wakeup_fd() -> int:
    if _wakeup[0] is None:
        with _wake_lock:
            if _wakeup[0] is None:
                r, w = _os.pipe()
                _os.set_blocking(r, False)
                _os.set_blocking(w, False)
                _wakeup[1] = w  # writer first: poke() checks [0]
                _wakeup[0] = r
    return _wakeup[0]


def _poke_now() -> None:
    _wakeup_fd()
    try:
        _os.write(_wakeup[1], b"\0")
    except (OSError, TypeError):
        pass  # pipe full: a wakeup is already pending


def poke() -> None:
    """Wake any thread parked in the idle select. Cheap when nobody is
    parked — one list load and a branch — so producers (local sends,
    system-plane posts, request completions) can call it per event."""
    if _parked[0]:
        _poke_now()


def idle_block(max_wait: float, base: float,
               recheck: Optional[Callable[[], bool]] = None) -> bool:
    """Park in select() for up to min(max_wait, runtime_idle_block_us)
    seconds. When the cvar is 0 or a poll-only transport is live, a
    plain ``base``-second sleep happens instead (the legacy backoff —
    same latency bound, cheaper than fd exports at that cadence).
    ``recheck`` closes the lost-wakeup race: it runs after this thread
    becomes visible to poke() and cancels the park if the condition
    already holds. Returns True when the loop actually parked in
    select."""
    import time

    cap = _idle_var._value / 1e6
    if max_wait <= 0:
        return False
    if cap <= 0:
        time.sleep(min(base, max_wait))
        return False
    # a poll-only transport (sm rings) means no fd set can see all
    # traffic, so the park may not exceed the caller's legacy poll
    # interval — and at that sub-millisecond cadence the blind sleep
    # is CHEAPER than building fd lists + a poll syscall per park
    # (measured load on oversubscribed hosts). fd-parking is reserved
    # for fd-complete (DCN) transport sets.
    if any(fn is None for fn in _idle_sources):
        time.sleep(min(base, max_wait))
        return False
    # become poke-visible BEFORE snapshotting fds: a producer whose
    # event lands mid-snapshot (a send queueing a backlog on a conn
    # whose write interest we would miss) must find _parked set so its
    # poke puts a byte in the pipe and the poll returns immediately —
    # increment-first closes that lost-wakeup window
    with _wake_lock:
        _parked[0] += 1
    try:
        if recheck is not None and recheck():
            return False
        wake_r = _wakeup_fd()
        # select.poll, NOT select.select: fds >= FD_SETSIZE (1024 —
        # easily exceeded by a large world's conns) make select raise
        # on every call, which would silently degrade every park.
        # (A closed-raced fd yields a POLLNVAL wake, not an error.)
        masks = {wake_r: _select.POLLIN}
        ok = True
        try:
            for fn in list(_idle_sources):
                r, w = fn()
                for fd in r:
                    if fd >= 0:
                        masks[fd] = masks.get(fd, 0) | _select.POLLIN
                for fd in w:
                    if fd >= 0:
                        masks[fd] = masks.get(fd, 0) | _select.POLLOUT
        except Exception:
            # an exporter (or a racing close) broke mid-snapshot: fall
            # back to the legacy interval so untracked traffic can't
            # stall a long park
            ok = False
        try:
            poller = _select.poll()
            for fd, m in masks.items():
                poller.register(fd, m)
            timeout = min(max_wait, cap if ok else min(cap, base))
            ready = poller.poll(max(timeout, 0) * 1000.0)
        except (OSError, ValueError, OverflowError):
            time.sleep(min(base, max_wait))  # NEVER busy-spin the loop
            return False
    finally:
        with _wake_lock:
            _parked[0] -= 1
    # pvar bump under the wake lock: the app thread (progress_until)
    # and the ProgressThread both park here, and an unlocked += would
    # lose updates. Once per completed park, nowhere near the hot path,
    # so the lock is free.
    with _wake_lock:
        _idle_blocks[0] += 1
    if any(fd == wake_r for fd, _ev in ready):
        try:
            _os.read(wake_r, 4096)  # drain coalesced pokes
        except OSError:
            pass
    return True


_request._bind_wakeup(poke)


def register_progress(fn: Callable[[], int], low_priority: bool = False) -> None:
    """Reference: opal_progress_register (opal_progress.c:416)."""
    with _lock:
        (_low_priority if low_priority else _callbacks).append(fn)


def unregister_progress(fn: Callable[[], int]) -> None:
    with _lock:
        for lst in (_callbacks, _low_priority):
            if fn in lst:
                lst.remove(fn)


def progress() -> int:
    """Poll all registered callbacks once; low-priority every 8th call
    (the reference's event-library yield cadence). Under tracing, only
    iterations that actually handled events become spans (recorded
    retroactively) — an idle spin loop would flood the ring with noise."""
    tracing = _trace.enabled()
    t0 = _trace.now() if tracing else 0
    n = 0
    for fn in list(_callbacks):
        n += fn()
    if next(_call_count) % 8 == 0:
        for fn in list(_low_priority):
            n += fn()
    if tracing and n:
        _trace.record_span("runtime.progress", t0, _trace.now(),
                           cat="runtime", events=n)
    return n


import time as _time


def progress_until(pred: Callable[[], bool],
                   timeout: float | None = None) -> bool:
    """Drive progress() until ``pred()`` holds, yielding per the shared
    IdleBackoff discipline. Every blocking wait outside Request.Wait must
    funnel through here — a pure ``while: progress()`` spin starves the
    peer rank on one-core hosts (r2 lesson; reference: the single
    opal_progress() loop all waits share, opal_progress.c:216). Once the
    backoff goes cold the wait PARKS in select over the transports' fds
    (idle_block) — a frame or a poke wakes it immediately, and the park
    is always capped by the remaining deadline so timeouts hold."""
    if pred():
        return True
    deadline = None if timeout is None else _time.monotonic() + timeout

    def _idle_wait(base: float) -> None:
        rem = float("inf") if deadline is None \
            else deadline - _time.monotonic()
        idle_block(min(rem, 3600.0), base, recheck=pred)

    backoff = _request.IdleBackoff()
    while True:
        made = progress()
        if pred():
            return True
        if deadline is not None and _time.monotonic() > deadline:
            return False
        backoff.step(made, _idle_wait)


_request._bind_progress(progress)


class ProgressThread:
    """Optional dedicated progress thread."""

    def __init__(self, interval: float = 0.0002):
        self.interval = interval
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._run, name="ompi-tpu-progress", daemon=True
        )
        self._thread.start()

    def _run(self) -> None:
        try:
            self._run_loop()
        except BaseException:
            # an unhandled exception killing the progress thread ends
            # async progress for the whole job — and if the job is then
            # aborted/killed, atexit never runs and the flight-recorder
            # ring dies with it. Export the evidence before the thread
            # goes down (re-entrancy-guarded, never raises).
            from ompi_tpu_torch.utils.output import get_logger

            get_logger("runtime.progress").exception(
                "progress thread died")
            _trace.export_on_fatal()
            raise

    def _run_loop(self) -> None:
        import time

        idle = 0
        while not self._stop.is_set():
            try:
                made = progress()
            except Exception:
                # a transport bug must not silently kill async progress
                from ompi_tpu_torch.utils.output import get_logger

                get_logger("runtime.progress").exception(
                    "progress callback raised")
                made = 0
            if made > 0:
                idle = 0
            elif idle < 1000:
                # stay hot but yield the GIL between polls, so incoming
                # traffic sees microsecond wake latency while app threads
                # still run (reference: async progress threads busy-poll)
                idle += 1
                time.sleep(0)
            else:
                # deep idle: PARK in poll() instead of interval polling
                # — a blocked rank used to burn a core here (and starve
                # the peer on one-core hosts). Inbound frames wake via
                # their fds, local producers via poke(), stop() pokes
                # unconditionally; poll-only transport sets (sm) make
                # this the legacy interval sleep instead. Every
                # non-waking idle_block path sleeps internally — no
                # extra wait here, or deep-idle latency would double
                idle_block(3600.0, self.interval,
                           recheck=self._stop.is_set)

    def stop(self) -> None:
        self._stop.set()
        # unconditional poke (not the _parked-gated one): the thread may
        # be between its stop-check and the park — the pipe byte makes
        # that select return immediately either way
        _poke_now()
        if self._thread is not None:
            self._thread.join(timeout=1.0)
            self._thread = None


# ---------------------------------------------------------- stall forensics
def _fx_debug_state() -> dict:
    """Forensics provider (runtime/forensics contract): park state and
    wake sources — is anyone still driving progress, and can a frame
    wake it. Registered with forensics as ``runtime.progress`` below."""
    with _wake_lock:
        parked = _parked[0]
        blocks = _idle_blocks[0]
    with _lock:
        ncb = len(_callbacks)
        nlow = len(_low_priority)
    srcs = list(_idle_sources)
    return {
        "parked_threads": parked,
        "idle_blocks": blocks,
        "callbacks": ncb,
        "low_priority_callbacks": nlow,
        "idle_sources": len(srcs),
        "poll_only_transport": any(fn is None for fn in srcs),
        "idle_block_us": int(_idle_var._value),
        "wakeup_pipe_armed": _wakeup[0] is not None,
    }


from ompi_tpu_torch.runtime import forensics as _forensics  # noqa: E402

_forensics.register_provider("runtime.progress", _fx_debug_state)
