"""Request lifecycle and completion.

The port of ``ompi_tpu/core/request.py`` (reference: ompi/request).
Requests complete through a completion flag (request.h:451-478
ompi_request_wait_completion) while the caller drives the progress engine
(req_wait.c:35,225 default_wait/wait_all): ``Wait`` spins
``runtime/progress.py`` until the flag flips; transports flip it from a
progress callback or a progress thread. Where nothing is bound (mesh mode
without the progress engine) a wait polls ``is_complete`` under the
shared ``IdleBackoff`` discipline.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

import os

from ompi_tpu_torch.core.errors import MPIError, ERR_PENDING
from ompi_tpu_torch.core.status import Status

# Wait-loop policy: on a multicore host blocking waits spin hot (the
# reference busy-polls in ompi_request_wait_completion); on a single core
# spinning just burns the peer's timeslice, so yield immediately. Use the
# AFFINITY mask, not cpu_count: a rank pinned to one core of a big host
# is effectively single-core.
try:
    _MULTICORE = len(os.sched_getaffinity(0)) > 1
except AttributeError:  # non-Linux
    _MULTICORE = (os.cpu_count() or 1) > 1


class IdleBackoff:
    """The ONE wait-loop yield discipline every blocking wait shares
    (Request.Wait, Waitany, progress_until): busy-poll while events flow,
    yield the GIL once briefly idle, back off to millisecond waits under
    sustained idleness. A pure spin starves the peer rank on one-core
    hosts (reference: ompi_request_wait_completion's busy-poll, tempered
    by opal's yield_when_idle)."""

    __slots__ = ("_idle_since",)

    def __init__(self):
        self._idle_since = None

    def step(self, made_progress: bool, idle_wait=None) -> None:
        """Call once per loop iteration after no-completion was observed;
        ``idle_wait`` (seconds -> None) replaces the deep-idle sleep with
        a condition-variable wait where one is available."""
        if made_progress:
            self._idle_since = None
            return
        now = time.monotonic()
        if self._idle_since is None:
            self._idle_since = now
        idle = now - self._idle_since
        if idle >= 0.002:
            (idle_wait or time.sleep)(0.001)
        elif _MULTICORE and idle < 0.0003:
            pass  # pure spin: yields cost ~100us under load
        else:
            time.sleep(0)  # single core: hand the CPU to the peer


class Request:
    """A pending communication. Subclasses (pml send/recv, coll, grequest)
    arrange for ``_set_complete`` to be called, or override
    ``is_complete`` (the mesh-mode ``DeviceRequest`` queries a CUDA
    event)."""

    def __init__(self):
        self.status = Status()
        self._complete = threading.Event()
        self._error: int = 0
        self._error_reported = False
        self._on_complete: List[Callable[["Request"], None]] = []
        self._cb_lock = threading.Lock()
        self.persistent = False
        if _san_new is not None:  # sanitizer request-leak tracking
            _san_new(self)

    # ------------------------------------------------------------ completion
    def _set_complete(self, error: int = 0) -> None:
        self._error = error
        # each completion is a fresh activation (persistent requests
        # cycle): the error, if any, is raisable exactly once again
        self._error_reported = False
        self.status.error = error
        if _san_done is not None:
            _san_done(self)
        if _fx_note is not None:  # forensics stall-sentinel tick
            _fx_note(self)
        # Flip the flag and snapshot callbacks under the registration lock:
        # a registration racing on another thread either lands in the
        # snapshot or observes the flag and self-fires — never lost
        # (reference: the sync-object CAS of request.h:451).
        with self._cb_lock:
            self._complete.set()
            cbs = list(self._on_complete)
            self._on_complete.clear()
        for cb in cbs:
            cb(self)
        _completion_cond_notify()

    def add_completion_callback(self, cb: Callable[["Request"], None]) -> None:
        with self._cb_lock:
            if not self._complete.is_set():
                self._on_complete.append(cb)
                return
        cb(self)

    @property
    def is_complete(self) -> bool:
        return self._complete.is_set()

    # ------------------------------------------------------------- MPI verbs
    def Test(self, status: Optional[Status] = None) -> bool:
        _progress_once()
        if self._complete.is_set():
            self._finish(status)
            return True
        return False

    def Wait(self, status: Optional[Status] = None, timeout: Optional[float] = None) -> None:
        """Block until complete, driving progress (reference: request.h:451
        hot loop over opal_progress)."""
        deadline = None if timeout is None else time.monotonic() + timeout
        backoff = IdleBackoff()
        # sanitizer wait-for-graph edge: register this blocked wait so
        # the deadlock detector can chase probes through it (one global
        # load + branch when the sanitizer is off)
        watch = _san_wait(self) if _san_wait is not None else None
        try:
            while not self._complete.is_set():
                made_progress = _progress_once()
                if self._complete.is_set():
                    break
                if deadline is not None and time.monotonic() > deadline:
                    raise MPIError(ERR_PENDING, "Wait timed out")
                if watch is not None:
                    watch.poll()
                backoff.step(made_progress, _completion_cond_wait)
        finally:
            if watch is not None:
                watch.close()
        self._finish(status)

    def _finish(self, status: Optional[Status]) -> None:
        """Deliver completion to the caller. Idempotent per completion:
        a stored error is raised exactly ONCE per activation — multi-wait
        verbs (Waitsome/Waitany then Waitall) legitimately finish the
        same request twice, and a double raise abandoned the remaining
        done requests mid-loop (the Waitsome bug)."""
        if status is not None:
            status.source = self.status.source
            status.tag = self.status.tag
            status.error = self.status.error
            status._nbytes = self.status._nbytes
            status.cancelled = self.status.cancelled
        if self._error and not self._error_reported:
            self._error_reported = True
            raise MPIError(self._error)

    def Cancel(self) -> None:
        """Best-effort cancel (reference: requests may decline)."""
        pass

    def Free(self) -> None:
        pass

    # ----------------------------------------------------------- multi-wait
    @staticmethod
    def Waitall(requests: Sequence["Request"],
                statuses: Optional[List[Status]] = None) -> None:
        for i, r in enumerate(requests):
            st = statuses[i] if statuses is not None else None
            r.Wait(st)

    @staticmethod
    def Waitany(requests: Sequence["Request"],
                status: Optional[Status] = None) -> int:
        if not requests:
            return -1
        backoff = IdleBackoff()
        while True:
            for i, r in enumerate(requests):
                if r.is_complete:
                    r._finish(status)
                    return i
            backoff.step(_progress_once(), _completion_cond_wait)

    @staticmethod
    def Waitsome(requests: Sequence["Request"]) -> List[int]:
        """Wait until at least one request completes; finish and return
        the indices of ALL completed entries. Errors are collected and
        the first one raised only after every done entry is finished
        (MPI_Waitsome's ERR_IN_STATUS shape: one failure must not
        abandon the other completions)."""
        if not requests:
            return []
        backoff = IdleBackoff()
        while not any(r.is_complete for r in requests):
            backoff.step(_progress_once(), _completion_cond_wait)
        done = [i for i, r in enumerate(requests) if r.is_complete]
        first_error: Optional[MPIError] = None
        for i in done:
            try:
                requests[i]._finish(None)
            except MPIError as e:
                if first_error is None:
                    first_error = e
        if first_error is not None:
            raise first_error
        return done

    @staticmethod
    def Startall(requests: Sequence["Request"]) -> None:
        """Start every persistent request (MPI_Startall); lives on the
        base class so mixed persistent-request kinds share one entry."""
        for r in requests:
            r.Start()

    @staticmethod
    def Testall(requests: Sequence["Request"]) -> bool:
        _progress_once()
        return all(r.is_complete for r in requests)

    @staticmethod
    def Testany(requests: Sequence["Request"]) -> Tuple[int, bool]:
        _progress_once()
        for i, r in enumerate(requests):
            if r.is_complete:
                r._finish(None)
                return i, True
        return -1, False


class CompletedRequest(Request):
    """A request complete at creation (``ibarrier``: the barrier has run by
    the time it returns)."""

    def __init__(self, nbytes: int = 0, source: int = -1, tag: int = -1):
        super().__init__()
        self.status.source = source
        self.status.tag = tag
        self.status._nbytes = nbytes
        self._set_complete(0)


class Grequest(Request):
    """Generalized request (reference: ompi/request/grequest.c)."""

    def __init__(self, query_fn=None, free_fn=None, cancel_fn=None):
        super().__init__()
        self._query_fn = query_fn
        self._free_fn = free_fn
        self._cancel_fn = cancel_fn

    def Complete(self) -> None:
        if self._query_fn is not None:
            self._query_fn(self.status)
        self._set_complete(0)

    def Cancel(self) -> None:
        if self._cancel_fn is not None:
            self._cancel_fn(self._complete.is_set())
            self.status.cancelled = True

    def Free(self) -> None:
        if self._free_fn is not None:
            self._free_fn()


class Prequest(Request):
    """Persistent request (MPI_Send_init / MPI_Recv_init; reference:
    part/persist builds partitioned comm on these)."""

    def __init__(self, start_fn: Callable[["Prequest"], None]):
        super().__init__()
        self.persistent = True
        self._start_fn = start_fn
        self._complete.set()  # inactive == complete per MPI semantics

    def Start(self) -> "Prequest":
        self._complete.clear()
        self.status = Status()
        self._start_fn(self)
        return self


# ---------------------------------------------------------------- progress
# Wired to the runtime progress engine lazily so core stays import-light.
_progress_fn: Optional[Callable[[], int]] = None
_completion_cond = threading.Condition()

# Sanitizer hooks, bound lazily by runtime/sanitizer.py install() (same
# pattern as _bind_progress — core must not import the runtime). All three default to None so the disabled path costs one global load and
# a branch; _san_new fires per Request construction, _san_done per
# completion, _san_wait wraps blocked Waits for the deadlock detector.
_san_new: Optional[Callable[["Request"], None]] = None
_san_done: Optional[Callable[["Request"], None]] = None
_san_wait = None  # Request -> watch object with poll()/close(), or None

# Stall-sentinel completion tick, bound by runtime/forensics.py only while
# forensics_enable is set (rebound live on cvar writes) — the disabled path
# is this one global load per completion.
_fx_note: Optional[Callable[["Request"], None]] = None


def _bind_sanitizer(new, done, wait) -> None:
    global _san_new, _san_done, _san_wait
    _san_new, _san_done, _san_wait = new, done, wait


def _bind_progress(fn: Callable[[], int]) -> None:
    global _progress_fn
    _progress_fn = fn


# Idle-block wakeup, bound lazily by runtime/progress.py (same
# core-must-not-import-runtime pattern as _bind_progress): a request
# completing must wake any wait parked in the progress engine's idle
# select, or a pred that flips off-transport could sleep out the full
# park interval. The bound fn is the _parked-gated poke — one list load
# and a branch when nobody is parked.
_wakeup_fn: Optional[Callable[[], None]] = None


def _bind_wakeup(fn: Callable[[], None]) -> None:
    global _wakeup_fn
    _wakeup_fn = fn


def _progress_once() -> int:
    if _progress_fn is None:
        return 0
    return _progress_fn()


def _completion_cond_notify() -> None:
    with _completion_cond:
        _completion_cond.notify_all()
    if _wakeup_fn is not None:
        _wakeup_fn()


def _completion_cond_wait(timeout: float) -> None:
    with _completion_cond:
        _completion_cond.wait(timeout)
