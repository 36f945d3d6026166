"""Runtime MPI semantics sanitizer.

The port of ``ompi_tpu/runtime/sanitizer.py``. Request-leak tracking
covers every request, the mesh-mode ``DeviceRequest`` of the i-verbs
included; the deadlock probes and the shipped collective entries cross
ranks over the system plane of process mode.

Tests exercise the happy path; the bugs that survive them are semantic —
a request allocated and forgotten, two ranks blocked sending to each
other, collective sequences that diverge per rank, a receiver posting
the wrong datatype. The reference ecosystem catches these with external
checkers (MUST, Marmot, the mpi_param_check builds); here the checks
ride inside the runtime, gated by the same live-Var discipline every
other diagnostic subsystem uses (runtime/spc.py, runtime/trace.py), so
the disabled path costs one attribute load per hook.

Four violation classes:

- **request-leak** (at finalize): requests allocated but never
  completed/freed. Level >= 2 attaches the creation backtrace captured
  at allocation time.
- **deadlock**: a wait-for-graph cycle across ranks, found with
  Chandy–Misra–Haas edge-chasing probes over the pml system plane
  (tag -4400): a Wait blocked past ``sanitizer_deadlock_timeout``
  probes the rank it waits on; blocked ranks forward the probe along
  their own blocked edge; a probe arriving back at its initiator is a
  cycle. The cycle is reported through show_help on every member and —
  at level >= 2 — the blocked requests complete with ERR_SANITIZER so
  the hung Wait raises instead of spinning forever (procmode tests see
  a report, not a timeout).
- **coll-order**: per-communicator collective call-order matching.
  Every collective records a ``verb(signature)`` string; non-root ranks
  ship theirs to the communicator root, which diffs sequences per call
  index — rank-divergent sequences (the classic "rank 0 calls Bcast,
  rank 1 calls Reduce" hang) are caught at the verb layer, before any
  transport or device lowering runs.
- **p2p-mismatch** (in pml matching): a delivered message whose byte
  count does not divide into the posted receive datatype — a sender/
  receiver datatype or count disagreement that plain truncation checks
  miss.

Violations always bump the ``sanitizer_violations`` pvar + per-class
SPC counters and fire the MPI_T ``sanitizer_violation`` event; level 1 additionally renders show_help, level >= 2 raises
``MPIError(ERR_SANITIZER)`` (or completes the affected request with it
when detection happens on a progress thread, where a raise would be
swallowed by the thread's error guard).

Enable with ``--mca sanitizer_enable 1`` (or
``OMPI_TPU_MCA_sanitizer_enable=1`` / ``sanitizer.enable()``).
"""

from __future__ import annotations

import json
import threading
import time
import traceback
from typing import Dict, List, Optional, Tuple

import torch

from ompi_tpu_torch.core.errors import MPIError, ERR_SANITIZER
from ompi_tpu_torch.mca.var import register_var, register_pvar, set_var
from ompi_tpu_torch.mpit import register_event_type
from ompi_tpu_torch.utils.show_help import register_topic, show_help

_enable_var = register_var(
    "sanitizer", "enable", False,
    help="Run the MPI semantics sanitizer (request leaks, cross-rank "
         "deadlock cycles, collective call-order divergence, pt2pt "
         "datatype/count mismatches)", level=3)
_level_var = register_var(
    "sanitizer", "level", 1,
    help="1 = report violations (MPI_T sanitizer_violation event, "
         "sanitizer_* counters, show_help); 2+ = also raise "
         "MPIError(ERR_SANITIZER) / fail the affected request, and "
         "capture request-creation backtraces", level=3)
_timeout_var = register_var(
    "sanitizer", "deadlock_timeout", 3.0, float,
    help="Seconds a Wait may block before the deadlock detector sends "
         "a wait-for-graph probe to the peer it waits on", level=5)

# probe/verdict plane: clear of osc (-4300) and ft (-4242..-4245)
SAN_TAG = -4400


def enabled() -> bool:
    """One attribute load off the live Var (spc/trace discipline)."""
    return _enable_var._value


def _level() -> int:
    return int(_level_var._value)


# -------------------------------------------------------------- violations
_lock = threading.Lock()
_counts: Dict[str, int] = {}

register_event_type("sanitizer", "violation",
                    "The runtime sanitizer detected an MPI semantics "
                    "violation (kind + detail in the payload)")
register_pvar("sanitizer", "violations",
              lambda: sum(_counts.values()),
              help="Total MPI semantics violations the sanitizer "
                   "detected (per-class detail in spc_sanitizer_*)")

register_topic(
    "sanitizer", "request-leak",
    "The MPI sanitizer found requests that were allocated but never\n"
    "completed, waited, or freed before finalize:\n{detail}")
register_topic(
    "sanitizer", "deadlock",
    "The MPI sanitizer detected a wait-for-graph DEADLOCK cycle:\n"
    "    {detail}\n"
    "Each rank above is blocked in Wait on the next; no progress is\n"
    "possible. At sanitizer_level >= 2 the blocked requests fail with\n"
    "MPIX_ERR_SANITIZER instead of hanging.")
register_topic(
    "sanitizer", "coll-order",
    "The MPI sanitizer detected rank-divergent collective sequences:\n"
    "{detail}\nMPI requires every member of a communicator to call the\n"
    "same collectives in the same order.")
register_topic(
    "sanitizer", "p2p-mismatch",
    "The MPI sanitizer detected a point-to-point datatype/count\n"
    "mismatch:\n{detail}")


def violation_counts() -> Dict[str, int]:
    with _lock:
        return dict(_counts)


def _violation(kind: str, detail: str, fatal: Optional[bool] = None,
               **data) -> None:
    """Common reporting funnel. ``fatal=None`` follows the level cvar;
    pass False from progress-thread contexts (a raise there would be
    swallowed by the thread's error guard — complete the affected
    request with ERR_SANITIZER instead)."""
    from ompi_tpu_torch import mpit
    from ompi_tpu_torch.runtime import spc

    with _lock:
        _counts[kind] = _counts.get(kind, 0) + 1
    spc.record("sanitizer_" + kind.replace("-", "_"))
    mpit.emit("sanitizer", "violation", kind=kind, detail=detail, **data)
    show_help("sanitizer", kind, once=False, detail=detail)
    if fatal if fatal is not None else _level() >= 2:
        raise MPIError(ERR_SANITIZER, f"{kind}: {detail}")


# ------------------------------------------------------ request-leak check
_tracked: Dict[int, Tuple[object, Optional[str]]] = {}


def _track_new(req) -> None:
    if not _enable_var._value:
        return
    bt = None
    if _level() >= 2:
        # drop the last two frames (this hook + Request.__init__): the
        # leak report should point at the allocating verb
        bt = "".join(traceback.format_stack(limit=14)[:-2])
    with _lock:
        _tracked[id(req)] = (req, bt)


def _track_done(req) -> None:
    if _tracked:
        with _lock:
            _tracked.pop(id(req), None)


def _describe_request(req, bt: Optional[str]) -> str:
    peer = getattr(req, "dst", None)
    kind = "send to" if peer is not None else "recv from"
    if peer is None:
        peer = getattr(req, "src", None)
    where = f" ({kind} rank {peer}, tag {getattr(req, 'tag', '?')})" \
        if peer is not None else ""
    line = f"  - {type(req).__name__}{where}: never completed"
    if bt:
        line += "\n    allocated at:\n" + "".join(
            "      " + ln for ln in bt.splitlines(True)[-6:])
    return line


def check_leaks() -> List[Tuple[object, Optional[str]]]:
    """Requests allocated but never completed (tests call this directly;
    the finalize hook reports through the violation funnel). Uses the
    ``is_complete`` property, not the raw event: mesh-mode DeviceRequests
    complete on a CUDA event without anyone flipping the event."""
    with _lock:
        items = list(_tracked.values())
    out = []
    for r, bt in items:
        if getattr(r, "persistent", False):
            continue  # persistent requests are long-lived by design
        try:
            done = r.is_complete
        except Exception:
            done = True  # a broken probe must not fabricate a leak
        if not done:
            out.append((r, bt))
    return out


def _finalize_check() -> None:
    if not _enable_var._value:
        return
    leaks = check_leaks()
    if not leaks:
        return
    shown = "\n".join(_describe_request(r, bt) for r, bt in leaks[:16])
    more = len(leaks) - 16
    if more > 0:
        shown += f"\n  ... and {more} more"
    # fatal=False even at level >= 2: this runs inside the finalize_top
    # hook chain — a raise here would abort Finalize mid-teardown
    # (skipping the exit fence, release_instance, and the trace export)
    # and the atexit re-entry would double-report; the report + event +
    # counters ARE the deliverable for an ending process
    _violation("request-leak",
               f"{len(leaks)} leaked request(s):\n{shown}",
               fatal=False, count=len(leaks))


# ------------------------------------------------------- deadlock detector
class _WaitWatch:
    """One blocked Wait = one wait-for edge. ``poll()`` runs from the
    waiting thread's spin loop; past the timeout it launches (and
    periodically relaunches) a CMH probe toward the peer."""

    __slots__ = ("req", "peer", "pml", "rank", "next_probe", "interval")

    def __init__(self, req, peer: int, pml, interval: float):
        self.req = req
        self.peer = peer
        self.pml = pml
        self.rank = pml.my_rank
        self.interval = interval
        self.next_probe = time.monotonic() + interval

    def poll(self) -> None:
        now = time.monotonic()
        if now < self.next_probe:
            return
        self.next_probe = now + self.interval
        # the probe names its originating edge (wid): a probe that
        # comes home only proves a cycle if THIS edge is still blocked
        # — "initiator has some other blocked wait" is not a deadlock
        _send_system(self.pml, self.peer,
                     {"k": "probe", "init": self.rank, "wid": id(self),
                      "path": [self.rank]})

    def close(self) -> None:
        with _lock:
            _blocked.pop(id(self), None)


_blocked: Dict[int, _WaitWatch] = {}
_reported_cycles: Dict[tuple, float] = {}  # cycle key -> report time


def _bind_world_handler() -> None:
    """init_bottom hook: bind the system handler BEFORE any user code
    runs — a peer's first shipped coll entry or probe arriving before
    lazy registration would be silently dropped, skewing every
    subsequent call index by one (observed as phantom divergence)."""
    from ompi_tpu_torch.pml.base import world_pml

    if not _enable_var._value:
        return
    pml = world_pml()
    if pml is not None:
        _plane.ensure(pml)


def _send_system(pml, dst: int, obj: dict) -> None:
    """Probe/verdict frame on the sanitizer plane (the shared
    fire-and-forget helper in pml/base, tagged -4400)."""
    _plane.send(pml, dst, obj)


def wait_watch(req):
    """Build the wait-for edge for a blocking Wait, or None when the
    request has no single peer (collectives, ANY_SOURCE, mesh mode)."""
    if not _enable_var._value:
        return None
    peer = getattr(req, "dst", None)
    if peer is None:
        peer = getattr(req, "src", None)
    if peer is None or peer < 0:
        return None
    from ompi_tpu_torch.pml.base import world_pml

    pml = world_pml()
    if pml is None or peer == pml.my_rank:
        return None
    _plane.ensure(pml)
    w = _WaitWatch(req, int(peer), pml,
                   max(float(_timeout_var._value), 0.05))
    with _lock:
        _blocked[id(w)] = w
    return w


def _on_system(hdr, payload) -> None:
    """Probe/verdict/coll-entry dispatch (runs from whatever thread the
    transport delivers on — report, never raise)."""
    try:
        msg = json.loads(bytes(payload))
    except ValueError:
        return
    from ompi_tpu_torch.pml.base import world_pml

    kind = msg.get("k")
    pml = world_pml()
    if pml is None:
        return
    me = pml.my_rank
    if kind == "probe":
        with _lock:
            watches = list(_blocked.values())
        if msg["init"] == me:
            # the cycle is real only if the ORIGINATING edge is still
            # blocked — a stale probe from a Wait that since completed
            # must not condemn an unrelated healthy wait
            if any(id(w) == msg.get("wid") for w in watches):
                _deadlock_detected(pml, list(msg["path"]) + [me])
            return
        if me in msg["path"]:
            return  # already chased through this rank
        fwd = list(msg["path"]) + [me]
        seen_peers = set()
        for w in watches:  # chase EVERY blocked edge (threads may hold
            if w.peer in seen_peers:  # several; any one can close the
                continue              # cycle)
            seen_peers.add(w.peer)
            _send_system(pml, w.peer,
                         {"k": "probe", "init": msg["init"],
                          "wid": msg.get("wid"), "path": fwd})
    elif kind == "dead":
        _deadlock_detected(None, list(msg["cycle"]))
    elif kind == "coll":
        div = _tracker.record(int(msg["cid"]), int(msg["rank"]),
                              str(msg["sig"]))
        if div is not None:
            idx, ref_rank, ref_sig = div
            detail = (f"  collective #{idx} on cid={msg['cid']}: rank "
                      f"{msg['rank']} called {msg['sig']} but rank "
                      f"{ref_rank} called {ref_sig}")
            _violation("coll-order", detail, fatal=False)
            # enforce on the divergent rank: its NEXT collective call —
            # a synchronous verb-layer context — raises at level >= 2
            # (this handler may run on a progress thread, where a raise
            # would be swallowed). Route by WORLD rank: msg['rank'] is
            # comm-local and lands on the wrong process for sub-comms.
            _send_system(pml, int(msg.get("wrank", msg["rank"])),
                         {"k": "coll-poison", "cid": int(msg["cid"]),
                          "detail": detail})
    elif kind == "coll-poison":
        with _lock:
            _poisoned[int(msg["cid"])] = str(msg["detail"])
    elif kind == "p2p-nack":
        # receiver failed a mismatched rendezvous before the CTS: the
        # sender's pending request must fail too, or its Wait would
        # spin forever on a handshake that will never continue
        sreq = getattr(pml, "_pending_sends", {}).pop(
            int(msg["msgid"]), None)
        if sreq is not None and not sreq._complete.is_set():
            sreq._set_complete(ERR_SANITIZER)


from ompi_tpu_torch.pml.base import SystemPlane as _SystemPlane  # noqa: E402

# the sanitizer probe/verdict plane: tag -4400, handler above (the
# shared weakref rebind discipline lives in pml/base.SystemPlane)
_plane = _SystemPlane(SAN_TAG, _on_system)


def bind_plane(pml) -> None:
    """Wireup hook: bind the -4400 handler before the pre-activation
    fence (world_pml() is still None inside wireup, so the init_bottom
    hook can't cover this window — a fast peer's first shipped coll
    entry would be dropped and every later call index would be off by
    one, reported as phantom divergence)."""
    if _enable_var._value:
        _plane.ensure(pml)


def _deadlock_detected(pml, cycle: List[int]) -> None:
    """Report a cycle once per episode, tell the other members, and
    (level >= 2) fail the locally-blocked requests whose wait-for edge
    lies ON the cycle — an unrelated healthy wait (another thread
    blocked on a rank outside the cycle) must survive."""
    members = set(cycle)
    key = tuple(sorted(members))
    now = time.monotonic()
    # time-bounded dedup: one episode reports once (own probe + peer
    # verdicts race in), but a LATER distinct deadlock among the same
    # ranks — after the first one was broken and retried — must report
    # and break again
    horizon = max(2 * float(_timeout_var._value), 5.0)
    with _lock:
        last = _reported_cycles.get(key)
        if last is not None and now - last < horizon:
            return
        _reported_cycles[key] = now
        watches = list(_blocked.values())
    if pml is not None:  # the detecting rank propagates the verdict
        for r in members:
            if r != pml.my_rank:
                _send_system(pml, r, {"k": "dead", "cycle": list(cycle)})
    _violation("deadlock",
               " -> ".join(str(r) for r in cycle),
               fatal=False, cycle=list(cycle))
    # stall forensics: a confirmed wait-for cycle is exactly the moment
    # the per-subsystem queue state is evidence — dump before level-2
    # breaks the cycle and the blocked requests vanish
    from ompi_tpu_torch.runtime import forensics as _forensics

    if _forensics._enable_var._value:
        _forensics.trigger(
            "sanitizer-deadlock: cycle "
            + " -> ".join(str(r) for r in cycle))
    if _level() >= 2:
        for w in watches:
            if w.peer in members and not w.req._complete.is_set():
                w.req._set_complete(ERR_SANITIZER)


# --------------------------------------------------- collective call order
class CollTracker:
    """Per-communicator collective sequence matcher: the first rank to
    reach call index i on a cid sets the reference signature; any other
    rank recording a different signature at the same index has diverged.
    Bounded: reference entries older than ``window`` call indices are
    pruned (divergence is only detectable near the frontier anyway)."""

    window = 4096

    def __init__(self):
        self._ref: Dict[Tuple[int, int], Tuple[int, str]] = {}
        self._next: Dict[Tuple[int, int], int] = {}
        self._hi: Dict[int, int] = {}
        self._diverged: set = set()  # (cid, rank) already reported

    def record(self, cid: int, rank: int,
               sig: str) -> Optional[Tuple[int, int, str]]:
        """Returns (index, reference_rank, reference_sig) on divergence,
        else None. Once a (cid, rank) stream diverges it is reported
        ONCE — every later index trivially mismatches too, and a banner
        cascade would bury the first (real) divergence point."""
        with _lock:
            i = self._next.get((cid, rank), 0)
            self._next[(cid, rank)] = i + 1
            if (cid, rank) in self._diverged:
                return None
            ref = self._ref.get((cid, i))
            if ref is None:
                self._ref[(cid, i)] = (rank, sig)
                hi = self._hi.get(cid, -1)
                if i > hi:
                    self._hi[cid] = i
                    old = i - self.window
                    if old >= 0:
                        self._ref.pop((cid, old), None)
                return None
            if ref[0] != rank and ref[1] != sig:
                self._diverged.add((cid, rank))
                return (i, ref[0], ref[1])
            return None

    def clear(self) -> None:
        with _lock:
            self._ref.clear()
            self._next.clear()
            self._hi.clear()
            self._diverged.clear()


_tracker = CollTracker()
# cid -> divergence detail delivered by the comm root's verdict; the
# divergent rank raises it from its next (synchronous) collective call
_poisoned: Dict[int, str] = {}


# Verbs whose FULL argument list (buffers included) must match on every
# rank. Rooted and v-variant collectives are excluded on purpose: their
# buffer shapes are legitimately rank-asymmetric (gather's recvbuf is
# only significant at the root, allgatherv send counts differ per rank,
# alltoallv counts match pairwise, not globally) — for those only the
# rank-invariant scalars (verb, op, root, datatypes, count arrays)
# enter the signature.
_SYMMETRIC_VERBS = frozenset(
    v for base in ("barrier", "bcast", "allreduce", "allgather",
                   "alltoall", "reduce_scatter_block", "scan", "exscan",
                   "neighbor_allgather", "neighbor_alltoall")
    for v in (base, "i" + base))


def _buf_sig(a) -> str:
    if isinstance(a, torch.Tensor):
        # the ndarray's spelling, so that a rank passing a tensor signs
        # like one passing the same ndarray: torch's dtype prints as
        # "torch.float32" and its ``size`` is a method
        return f"{str(a.dtype).removeprefix('torch.')}x{a.numel()}"
    dtype = getattr(a, "dtype", None)
    if dtype is not None:
        return f"{dtype}x{getattr(a, 'size', '?')}"
    if isinstance(a, (list, tuple)):
        return "[" + ",".join(_buf_sig(x) for x in a) + "]"
    name = getattr(a, "name", None)  # Op, Datatype
    if isinstance(name, str) and name:
        return name
    if isinstance(a, (int, float, str)) or a is None:
        return repr(a)
    if isinstance(a, (bytes, bytearray, memoryview)):
        return f"bytesx{len(a)}"
    return type(a).__name__


def _scalar_sig(a) -> str:
    """Rank-invariant projection for asymmetric verbs: keep scalars,
    op/datatype names, and pure count/displacement sequences; collapse
    buffers (whose shapes legally differ per rank) to '_'."""
    name = getattr(a, "name", None)
    if isinstance(name, str) and name:
        return name
    if isinstance(a, (bool, int, float, str)) or a is None:
        return repr(a)
    if isinstance(a, (list, tuple)) and \
            all(isinstance(x, (bool, int, float)) for x in a):
        return "[" + ",".join(repr(x) for x in a) + "]"
    return "_"


def _signature(verb: str, args) -> str:
    part = _buf_sig if verb in _SYMMETRIC_VERBS else _scalar_sig
    return f"{verb}({', '.join(part(a) for a in args)})"


def on_collective(comm, verb: str, sig: str) -> None:
    """Record one collective invocation; raises on locally-detectable
    divergence at level >= 2, ships the entry to the communicator root
    for cross-rank matching in process mode."""
    from ompi_tpu_torch.runtime import spc

    if getattr(spc._suppress, "depth", 0):
        return  # library-internal collective (CID agreement, fences)
    cid = comm.cid
    with _lock:
        poisoned = _poisoned.pop(cid, None)
    if poisoned is not None and _level() >= 2:
        # the comm root condemned this rank's sequence; surface it here,
        # in the verb layer — a synchronous context where a raise
        # reaches the application (the verdict itself arrived on a
        # progress thread)
        raise MPIError(ERR_SANITIZER, f"coll-order:\n{poisoned}")
    rank = int(getattr(comm, "rank", 0))
    div = _tracker.record(cid, rank, sig)
    if div is not None:
        idx, ref_rank, ref_sig = div
        _violation(
            "coll-order",
            f"  collective #{idx} on {getattr(comm, 'name', cid)}: rank "
            f"{rank} called {sig} but rank {ref_rank} called {ref_sig}")
    pml = getattr(comm, "pml", None)
    if pml is None or comm.size <= 1:
        return
    _plane.ensure(pml)    # the root must listen too (normally bound at
    root_world = comm.group.world_rank(0)  # init_bottom; this is the
    if root_world == pml.my_rank:          # late-enable fallback)
        return  # the root's own entries were recorded locally above
    _send_system(pml, root_world,
                 {"k": "coll", "cid": cid, "rank": rank,
                  "wrank": pml.my_rank, "sig": sig})


def wrap_coll(comm, verb: str, fn):
    """Interpose signature capture on a resolved collective slot (the
    ProcComm._coll hook; mesh mode is single-controller, so its one call
    covers every rank and cannot diverge)."""

    def checked(*args, **kw):
        on_collective(comm, verb, _signature(verb, args[1:]))
        return fn(*args, **kw)

    return checked


# ------------------------------------------------------ p2p datatype check
def check_p2p(req, hdr, pml=None) -> bool:
    """Called from pml delivery (ob1._deliver_matched) under the enable
    guard. Returns False when delivery must stop because the request was
    failed (level >= 2). For a rendezvous match the abort also NACKs the
    sender over the system plane — stopping delivery there skips the CTS
    the sender's Wait is blocked on, and without the nack the sanitizer
    would convert a diagnosable mismatch into a one-sided hang."""
    dt = getattr(req, "datatype", None)
    size = getattr(dt, "size", 0)
    if not size or hdr.nbytes % size == 0:
        return True
    detail = (f"  {hdr.nbytes}-byte message from rank {hdr.src} "
              f"(tag {hdr.tag}) does not divide into the posted "
              f"datatype {getattr(dt, 'name', None) or dt!r} "
              f"(size {size}): sender/receiver datatype or count "
              "mismatch")
    _violation("p2p-mismatch", detail, fatal=False,
               src=hdr.src, tag=hdr.tag, nbytes=hdr.nbytes)
    if _level() >= 2:
        from ompi_tpu_torch.pml.base import RNDV_RTS

        if hdr.kind == RNDV_RTS and pml is not None and hdr.msgid:
            _send_system(pml, hdr.src,
                         {"k": "p2p-nack", "msgid": int(hdr.msgid)})
        req.status._nbytes = 0
        req._set_complete(ERR_SANITIZER)
        return False
    return True


# ----------------------------------------------------- install / lifecycle
_installed = False


def install() -> None:
    """Bind the request-lifecycle hooks (idempotent). Import stays
    side-effect-light; only an enabled sanitizer pays the hook costs."""
    global _installed
    if _installed:
        return
    _installed = True
    from ompi_tpu_torch.core import request as _request

    _request._bind_sanitizer(_track_new, _track_done, wait_watch)


def uninstall() -> None:
    global _installed
    if not _installed:
        return
    _installed = False
    _plane.reset()
    from ompi_tpu_torch.core import request as _request

    _request._bind_sanitizer(None, None, None)


def enable(level: Optional[int] = None) -> None:
    """Programmatic enable (tests, tools): flip the cvars and install."""
    set_var("sanitizer", "enable", True)
    if level is not None:
        set_var("sanitizer", "level", int(level))
    install()


def disable() -> None:
    set_var("sanitizer", "enable", False)
    uninstall()
    reset_for_testing()


def reset_for_testing() -> None:
    with _lock:
        _tracked.clear()
        _counts.clear()
        _blocked.clear()
        _reported_cycles.clear()
        _poisoned.clear()
    _tracker.clear()


def _maybe_install() -> None:
    if _enable_var._value:
        install()


from ompi_tpu_torch.hook import register_hook  # noqa: E402

register_hook("init_top", _maybe_install)
register_hook("init_bottom", _bind_world_handler)
register_hook("finalize_top", _finalize_check)
# env-enabled jobs (mpirun --mca sanitizer_enable 1) install at import so
# requests created before Init (wireup, lazy COMM_WORLD) are tracked too
_maybe_install()
