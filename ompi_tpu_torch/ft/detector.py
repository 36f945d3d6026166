"""Failure detector.

The port of ``ompi_tpu/ft/detector.py``: the suspicion map,
``known_failed``, the MPI_T event, the link journal and the forensics
provider run now; the ring heartbeat runs over the btl of process mode.

Reference: ompi/communicator/ft/comm_ft_detector.c (728 LoC) — a ring
heartbeat: each process observes its ring predecessor; a missed-heartbeat
timeout marks the peer failed and the propagator broadcasts the failure.
Process mode runs the heartbeat over the btl (started by wireup when
``ft_enable`` is set); mesh mode has a single controller, so failure
handling reduces to the device runtime's error propagation.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Callable, Dict, List, Optional, Set

from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.utils.output import get_logger

register_var("ft", "enable", False,
             help="Enable the ULFM heartbeat failure detector", level=3)
register_var("ft", "heartbeat_period", 0.2,
             help="Seconds between heartbeats (reference: the detector's "
                  "period MCA var)", level=6)
register_var("ft", "heartbeat_timeout", 2.0,
             help="Seconds without heartbeat before declaring failure",
             level=6)

HEARTBEAT_TAG = -4243
FAILURE_PROP_TAG = -4245

_failed: Set[int] = set()
_failed_lock = threading.Lock()
_callbacks: List[Callable[[int], None]] = []
_propagator: Optional[Callable[[int], None]] = None
_log = get_logger("ft.detector")
_live_hb = [None]  # weakref to the running HeartbeatDetector, if any

# degrade/restore edge journal: how the link was PERFORMING when it
# died/healed (btl/tcp passes its linkmodel snapshot at the edge) —
# forensics debug_state + the mpidiag LINK verdict read it. Bounded;
# one entry per state EDGE (the link timer re-notes every tick while
# an outage is open, which must not flood the journal).
_link_events: deque = deque(maxlen=32)
_link_state: Dict[int, str] = {}  # rank -> "degraded" | "restored"


def _fx_debug_state() -> dict:
    """Stall-forensics provider (runtime/forensics contract): the
    confirmed-failure set plus the ring observer's suspicion state —
    who this rank watches, how stale that edge is vs the timeout."""
    out: dict = {"known_failed": sorted(known_failed())}
    ref = _live_hb[0]
    det = ref() if ref is not None else None
    if det is not None:
        age = time.monotonic() - det.last_seen
        timeout = float(get_var("ft", "heartbeat_timeout"))
        out["heartbeat"] = {
            "rank": det.rank, "observed": det.observed,
            "target": det.target,
            "last_seen_age_s": round(age, 3),
            "timeout_s": timeout,
            "suspect": bool(det.observed != det.rank
                            and age > timeout / 2.0),
        }
    with _failed_lock:
        events = list(_link_events)
    if events:
        now = time.monotonic()
        out["link_events"] = [
            {"rank": ev["rank"], "event": ev["event"],
             "age_s": round(now - ev["t"], 3), "link": ev["link"]}
            for ev in events]
    return out


def known_failed() -> Set[int]:
    with _failed_lock:
        return set(_failed)


def set_propagator(fn: Callable[[int], None]) -> None:
    """Install the failure-notice flood (reference: the reliable
    broadcast of comm_ft_propagator.c). Detection is local — the ring
    observer and a tcp EOF each see a death from one vantage point; the
    flood re-forwards every *newly learned* failure to all peers, so any
    connected component of live ranks converges (dedup = the _failed
    set)."""
    global _propagator
    _propagator = fn


def mark_failed(rank: int) -> None:
    with _failed_lock:
        if rank in _failed:
            return
        _failed.add(rank)
    _log.warning("rank %d declared FAILED", rank)
    from ompi_tpu_torch.mpit import emit  # MPI_T event (mpit.py)

    emit("ft", "proc_failed", rank=rank)
    if _propagator is not None:
        try:
            _propagator(rank)
        except Exception:
            _log.warning("failure propagation failed", exc_info=True)
    for cb in list(_callbacks):
        cb(rank)


def on_failure(cb: Callable[[int], None]) -> None:
    """Register a failure observer (reference: the PMIx event handlers
    registered at instance.c init)."""
    _callbacks.append(cb)  # mpiracer: disable=cross-thread-race — GIL-atomic append at registration time; mark_failed iterates a list() snapshot


def _note_link_event(rank: int, event: str, link: Optional[dict]) -> None:
    """Journal one degrade/restore state EDGE with the link's last
    performance snapshot (dedup: the tick-driven re-notes of an open
    outage don't re-journal)."""
    with _failed_lock:
        if _link_state.get(rank) == event:
            if link is not None:
                # a tick-driven re-note raced ahead of the entry call
                # that carries the snapshot: backfill it
                for ev in reversed(_link_events):
                    if ev["rank"] == rank and ev["event"] == event:
                        if ev["link"] is None:
                            ev["link"] = link
                        break
            return
        _link_state[rank] = event
        _link_events.append({"t": time.monotonic(), "rank": rank,
                             "event": event, "link": link})


def note_link_degraded(rank: int, link: Optional[dict] = None) -> None:
    """Link-reliability grace seam (btl/tcp LINK_DEGRADED): while the
    tcp link layer is inside its bounded redial window for ``rank``,
    the heartbeat silence the outage itself causes must not convert
    into a confirmed death — refresh the observed edge's clock so the
    ring observer charges staleness from NOW, not from before the
    blip. Called at degrade entry and on every link-timer tick while
    the window is open, so a long redial keeps its grace; the link
    layer's own escalation (budget blown -> mark_failed) keeps death
    detection bounded by btl_tcp_link_deadline_s. ``link`` (degrade
    entry only) is the edge's last linkmodel snapshot — srtt/goodput/
    loss at the moment the wire died — journaled for forensics and
    the mpidiag LINK verdict."""
    _note_link_event(rank, "degraded", link)
    ref = _live_hb[0]
    det = ref() if ref is not None else None
    if det is not None and det.observed == rank:
        det.last_seen = time.monotonic()


def note_link_restored(rank: int, link: Optional[dict] = None) -> None:
    """Link healed (resync complete): reset the observed edge's
    staleness so the outage tail is not charged against the next
    heartbeat-timeout window, and journal how the healed link is
    performing."""
    _note_link_event(rank, "restored", link)
    ref = _live_hb[0]
    det = ref() if ref is not None else None
    if det is not None and det.observed == rank:
        det.last_seen = time.monotonic()


class HeartbeatDetector:
    """Ring heartbeat: rank r observes (r-1) mod n and pings (r+1) mod n
    (reference topology: comm_ft_detector.c ring observation)."""

    def __init__(self, pml, my_rank: int, size: int):
        self.pml = pml
        self.rank = my_rank
        self.size = size
        self.observed = (my_rank - 1) % size
        self.target = (my_rank + 1) % size
        self.last_seen = time.monotonic()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        if self.size < 2:
            return
        import weakref

        _live_hb[0] = weakref.ref(self)  # forensics suspicion view
        self._thread = threading.Thread(target=self._run, daemon=True,
                                        name="ompi-tpu-ft-detector")
        self._thread.start()

    def note_heartbeat(self, src: int) -> None:
        if src == self.observed:
            self.last_seen = time.monotonic()

    def _run(self) -> None:
        import numpy as np
        from ompi_tpu_torch.core.datatype import INT64

        period = get_var("ft", "heartbeat_period")
        timeout = get_var("ft", "heartbeat_timeout")
        beat = np.array([self.rank], dtype=np.int64)
        while not self._stop.is_set():
            # heal the TARGET side too: when my successor dies, the next
            # living successor must start receiving my heartbeats, or it
            # will falsely declare ME dead once it heals its observer
            # edge toward me (reference: the detector rebuilds both ring
            # edges, comm_ft_detector.c)
            failed = known_failed()
            while self.target in failed and self.target != self.rank:
                self.target = (self.target + 1) % self.size
            try:
                self.pml.isend(beat, 1, INT64, self.target,
                               HEARTBEAT_TAG, 0)
            except Exception:
                pass
            if (self.observed != self.rank
                    and time.monotonic() - self.last_seen > timeout):
                mark_failed(self.observed)
                # re-route around the failure (ring heals: observe next
                # living predecessor — reference: detector ring repair)
                nxt = (self.observed - 1) % self.size
                while nxt in known_failed() and nxt != self.rank:
                    nxt = (nxt - 1) % self.size
                self.observed = nxt
                self.last_seen = time.monotonic()
            self._stop.wait(period)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=1.0)


def _reset_for_testing() -> None:
    with _failed_lock:
        _failed.clear()
        _link_events.clear()
        _link_state.clear()
    _callbacks.clear()


from ompi_tpu_torch.runtime import forensics as _forensics  # noqa: E402

_forensics.register_provider("ft.detector", _fx_debug_state)
