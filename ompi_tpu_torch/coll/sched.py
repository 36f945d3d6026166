"""coll/sched — the requests of the mesh-mode nonblocking and persistent
collectives.

The port of ``ompi_tpu/coll/sched.py:767-892`` (``JaxRequest``,
``MeshPersistentRequest``); the process-mode round schedules are not
ported. A mesh-mode verb only enqueues its tensor ops on the current CUDA
stream and returns, so a nonblocking verb is the blocking one plus a CUDA
event recorded right after it: the request is complete when the event is
(``Event.query``), and ``Wait`` is ``Event.synchronize``. That holds only
while the verb's callable never waits for the device itself (no ``.item()``,
``bool`` of a tensor, ``nonzero`` or copy to the host), which
``chip_smoke.py`` phase 4f checks under ``torch.cuda.set_sync_debug_mode``.

On the CPU torch runs each op before it returns, so a request whose result
lies on the CPU is complete when the verb returns: it records no event.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import torch

from ompi_tpu_torch.coll import persist as _persist
from ompi_tpu_torch.core.errors import MPIError, ERR_PENDING, ERR_REQUEST
from ompi_tpu_torch.core.request import Request, _idle
from ompi_tpu_torch.runtime import trace as _trace


def record_event(t) -> Optional[torch.cuda.Event]:
    """A CUDA event recorded on the current stream of ``t``'s card, after
    the work that produces ``t``; None for a CPU tensor (already done)."""
    if isinstance(t, torch.Tensor) and t.is_cuda:
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(t.device))
        return ev
    return None


class DeviceRequest(Request):
    """A mesh-mode nonblocking collective: the verb has been enqueued on the
    device; the request completes when the device has run it. ``result``
    holds the output tensor."""

    def __init__(self, result):
        super().__init__()
        self.result = result
        self._event = record_event(result)

    def Start(self):
        raise MPIError(ERR_REQUEST, "not a persistent request")

    @property
    def is_complete(self) -> bool:
        return (self._complete.is_set() or self._event is None
                or self._event.query())

    def Test(self, status=None) -> bool:
        if self.is_complete:
            if not self._complete.is_set():
                self._set_complete(0)
            self._finish(status)
            return True
        return False

    def Wait(self, status=None, timeout: Optional[float] = None) -> None:
        """Block until the device has run the verb; past ``timeout``
        seconds raise ``ERR_PENDING``."""
        if timeout is None:
            if not self._complete.is_set() and self._event is not None:
                self._event.synchronize()
        else:
            t0 = time.monotonic()
            while not self.is_complete:
                if time.monotonic() - t0 > timeout:
                    raise MPIError(ERR_PENDING, "Wait timed out")
                _idle(t0)
        if not self._complete.is_set():
            self._set_complete(0)
        self._finish(status)


class MeshPersistentRequest(DeviceRequest):
    """A persistent mesh collective (``allreduce_init`` and the rest on
    ``MeshComm``).

    Init ran the verb once, which built and cached its callable; with
    ``coll_persist_enable`` the comm froze that callable into ``dispatch``,
    so ``Start`` calls it with no coll-table or cache lookup; either way a
    Start records its verb (``verb``) once, as the verb would. ``Start(x)`` runs
    on a fresh operand (the reference re-reads the buffer at Start; tensors
    are passed instead), ``Start()`` on the last one given (at first the
    init-time operand). ``result`` holds the latest Start's output.

    ``donate`` (armed by ``coll_persist_donate``) runs on a fresh operand and
    writes the result into the operand's storage where the output has its
    shape and dtype, so ``result`` is that operand: the JAX package donates
    the operand's buffer to XLA, which deletes it. The init-time operand is
    never donated, so operand-less restarts stay valid."""

    def __init__(self, comm, dispatch: Callable, x, verb: str = "",
                 frozen: bool = False, donate: Optional[Callable] = None):
        Request.__init__(self)
        self.persistent = True
        self._comm = comm
        self.verb = verb
        self._dispatch = dispatch
        self._x = x
        self._frozen = frozen
        self._donate = donate
        self._active = False
        self.result = None
        self._event = None
        self._complete.set()  # inactive == complete

    def Start(self, x=None) -> "MeshPersistentRequest":
        if self._active:
            raise MPIError(
                ERR_REQUEST,
                f"Start on still-active persistent mesh collective on "
                f"{self._comm.name}: complete it with Wait/Test first")
        self._comm._check_usable()  # a revoked comm must not dispatch
        if _trace.enabled():
            # the replay boundary (reference: coll/persist.py:477-481)
            _trace.instant("coll.persist.start", cat="coll", verb=self.verb,
                           provider=getattr(self._comm.coll, "providers",
                                            {}).get(self.verb))
        t0 = time.perf_counter()
        # dispatch before any state changes: a failed dispatch leaves the
        # request inactive with its operand and result as they were
        if x is not None and self._donate is not None and x is not self._x:
            result = self._donate(x)
        else:
            result = self._dispatch(self._x if x is None else x)
            if x is not None:
                self._x = x
        _persist.starts += 1
        _persist.replay_us += (time.perf_counter() - t0) * 1e6
        self._active = True
        self._complete.clear()
        self._error = 0
        self.result = result
        self._event = record_event(result)
        return self

    def _finish(self, status) -> None:
        self._active = False
        super()._finish(status)
