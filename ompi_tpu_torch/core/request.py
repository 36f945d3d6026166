"""Request lifecycle and completion.

The port of ``ompi_tpu/core/request.py:64-246``. A request completes when
its completion flag is set: at creation for ``CompletedRequest``, and when
the device has run the work for the mesh-mode requests (``coll/sched.py``
``DeviceRequest``, whose ``is_complete`` queries a CUDA event). The port
has no progress engine, sanitizer or stall forensics, so a wait only polls
``is_complete``: it spins for a moment, then sleeps a millisecond between
polls.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, List, Optional, Sequence, Tuple

from ompi_tpu_torch.core.errors import MPIError, ERR_PENDING
from ompi_tpu_torch.core.status import Status

# a waiting host spins this long before it sleeps between polls
_SPIN_S = 0.002


def _idle(since: float) -> None:
    """One idle turn of a wait loop that began at ``since``."""
    time.sleep(0.001 if time.monotonic() - since >= _SPIN_S else 0)


class Request:
    """A pending operation. Subclasses arrange for ``_set_complete`` to be
    called, or override ``is_complete``."""

    def __init__(self):
        self.status = Status()
        self._complete = threading.Event()
        self._error = 0
        self._error_reported = False
        self._on_complete: List[Callable[["Request"], None]] = []
        self._cb_lock = threading.Lock()
        self.persistent = False

    # ------------------------------------------------------------ completion
    def _set_complete(self, error: int = 0) -> None:
        self._error = error
        # each completion is a fresh activation (persistent requests
        # cycle): its error, if any, is raised exactly once again
        self._error_reported = False
        self.status.error = error
        # flip the flag and take the callbacks under the registration lock:
        # a registration racing on another thread either lands in the
        # snapshot or sees the flag and fires itself, never neither
        with self._cb_lock:
            self._complete.set()
            cbs = list(self._on_complete)
            self._on_complete.clear()
        for cb in cbs:
            cb(self)

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
        if self._complete.is_set():
            self._finish(status)
            return True
        return False

    def Wait(self, status: Optional[Status] = None,
             timeout: Optional[float] = None) -> None:
        """Block until complete; past ``timeout`` seconds raise
        ``ERR_PENDING``."""
        t0 = time.monotonic()
        while not self._complete.is_set():
            if timeout is not None and time.monotonic() - t0 > timeout:
                raise MPIError(ERR_PENDING, "Wait timed out")
            _idle(t0)
        self._finish(status)

    def _finish(self, status: Optional[Status]) -> None:
        """Deliver completion to the caller. A stored error is raised once
        an activation: the multi-wait verbs may finish a request twice."""
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
        """Best-effort cancel: a request may decline, and these all do."""

    def Free(self) -> None:
        pass

    # ----------------------------------------------------------- multi-wait
    @staticmethod
    def Waitall(requests: Sequence["Request"],
                statuses: Optional[List[Status]] = None) -> None:
        for i, r in enumerate(requests):
            r.Wait(statuses[i] if statuses is not None else None)

    @staticmethod
    def Waitany(requests: Sequence["Request"],
                status: Optional[Status] = None) -> int:
        if not requests:
            return -1
        t0 = time.monotonic()
        while True:
            for i, r in enumerate(requests):
                if r.is_complete:
                    r._finish(status)
                    return i
            _idle(t0)

    @staticmethod
    def Waitsome(requests: Sequence["Request"]) -> List[int]:
        """Wait until one request completes; finish and return the indices
        of every complete one. The first error is raised only after every
        complete request is finished."""
        if not requests:
            return []
        t0 = time.monotonic()
        while not any(r.is_complete for r in requests):
            _idle(t0)
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
        """Start every persistent request (MPI_Startall)."""
        for r in requests:
            r.Start()

    @staticmethod
    def Testall(requests: Sequence["Request"]) -> bool:
        return all(r.is_complete for r in requests)

    @staticmethod
    def Testany(requests: Sequence["Request"]) -> Tuple[int, bool]:
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
