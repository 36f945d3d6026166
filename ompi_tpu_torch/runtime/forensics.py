"""Stall forensics: per-subsystem flight-recorder introspection.

The port of ``ompi_tpu/runtime/forensics.py``. Providers, the stall
sentinel, dumps, triggers and SIGUSR1 run now, over whatever the port
registers (``runtime.progress`` and ``ft.detector`` among them); the
completion tick counts every request, the mesh-mode ``DeviceRequest`` of
the i-verbs included. Peer dump requests cross ranks over the system
plane of process mode.

The observability plane so far answers "how fast" (trace spans, latency
histograms, straggler EWMAs) but not "why is it stuck": a hung job's only
artifact was a timeout, with no record of which queue, which peer, or
which in-flight frame was the blocking edge. This module is the uniform
introspection contract that fixes that:

- **Providers** — every stateful subsystem registers a ``debug_state()``
  provider (``register_provider``): a zero-arg callable returning a
  JSON-serializable, *bounded* dict snapshotted lock-consistently.
  Registration is rebind-by-name (the ``metrics.register_sampler``
  discipline), so a restarted subsystem reports the live instance.
  Providers ship with pml/ob1 (queues, seq planes, gap detection),
  btl/tcp (per-conn state, shaped queue depths, oldest-frame age),
  coll/sched + coll/persist (in-flight round batches, held pool
  blocks), ft/detector + ft/era (suspicion map, agreement rounds), and
  runtime/progress (park state, wake sources).
- **Stall sentinel** — a low-priority progress callback (armed only
  when ``forensics_enable`` is set — the disabled path of every hook in
  this plane is one live-Var attribute load, per house discipline) that
  latches when *pending work exists* (the registered pending probes see
  queued requests) *but no completion has occurred* for
  ``forensics_stall_threshold_ms``. A latch dumps the local state as
  ``stall-rank<N>.json`` (atomic rename, under ``metrics_dir`` — the
  snapshot directory tools already watch), requests peer dumps over the
  pre-fence-bound LATENCY system tag ``FORENSICS_TAG`` (local dump is
  written FIRST, so a dead wire still yields rank-local evidence), and
  fires the usual pvar / MPI_T-event / trace-instant mirror. The latch
  re-arms on the next completion.
- **On-demand dumps** — ``comm.Dump_state()`` (works even with the
  sentinel disabled), and SIGUSR1 when the plane is enabled.
- **Auto triggers** — the existing failure verdicts (sanitizer deadlock
  cycle, ob1 peer-timeout watchdog conversion, era agreement timeout)
  call :func:`trigger` so known hang classes produce evidence instead
  of bare timeouts.
- **tools/mpidiag.py** merges the per-rank dumps and walks waiting-on
  edges — each rank's oldest blocked receive matched against the peer's
  send-side queue state — to name the blocking edge in one line, or the
  cycle when edges loop.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ompi_tpu_torch.mca.var import register_var, register_pvar, watch_var
from ompi_tpu_torch.mpit import register_event_type
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.utils.show_help import register_topic, show_help

# peer-dump-request plane: clear of revoke/heartbeat/era/flood
# (-4242..-4245), osc (-4300), sanitizer (-4400), metrics (-4500),
# diskless (-4600), hier (-4700). Classified LATENCY by the default
# qos_tag_map: a dump request racing the very backlog it is diagnosing
# must not queue behind it.
FORENSICS_TAG = -4800

#: bound on every list a provider emits (each clipped list carries an
#: ``omitted`` count) — a dump of a pathological queue must stay a few
#: KB of evidence, not a second copy of the backlog
CAP = 64

_enable_var = register_var(
    "forensics", "enable", False,
    help="Arm the stall sentinel: when pending work exists but no "
         "request completion has occurred for "
         "forensics_stall_threshold_ms, dump per-subsystem "
         "debug_state() as stall-rank<N>.json (under metrics_dir), "
         "request peer dumps over the forensics system tag, and fire "
         "the pvar/MPI_T/trace mirror. Also installs the SIGUSR1 "
         "on-demand dump handler. Disabled path is one attribute load "
         "per hook; comm.Dump_state() works regardless", level=3)
_thresh_var = register_var(
    "forensics", "stall_threshold_ms", 5000.0, float,
    help="Milliseconds of no-completion-while-work-is-pending before "
         "the stall sentinel latches and dumps forensics state", level=4)

register_topic(
    "forensics", "stall",
    "The stall sentinel LATCHED on this rank: pending work exists but\n"
    "no request has completed for {age:.1f}s (threshold\n"
    "{thresh:.1f}s). Local state dumped to {path}; peer dumps were\n"
    "requested. Merge and walk the waiting-on edges with:\n"
    "  python tools/mpidiag.py --dir {dir}")

register_event_type("forensics", "stall",
                    "The stall sentinel latched: pending work with no "
                    "completion past the threshold (age_s in payload)")
register_event_type("forensics", "dump",
                    "A forensics state dump was written (reason in the "
                    "payload)")


def enabled() -> bool:
    """One attribute load off the live Var (spc/trace discipline)."""
    return bool(_enable_var._value)


# ---------------------------------------------------------------- registry
_lock = threading.Lock()
_providers: Dict[str, Callable[[], Optional[dict]]] = {}
_pending_probes: Dict[str, Callable[[], int]] = {}


def register_provider(name: str, fn: Callable[[], Optional[dict]]) -> None:
    """Bind one subsystem's ``debug_state()`` reader. Re-registration
    rebinds (tests build several pml/btl instances per process; the
    LIVE one must win) — the register_sampler discipline. ``fn`` runs
    only at dump time; it must return a JSON-serializable dict with
    every list bounded to :data:`CAP` items (via :func:`clip` or an
    explicit slice with an ``omitted`` count), or None when its
    subject is gone."""
    with _lock:
        _providers[name] = fn


def register_pending_probe(name: str, fn: Callable[[], int]) -> None:
    """Bind a CHEAP pending-work counter (a few len() calls at most):
    the sentinel polls every probe each low-priority progress round, so
    this is the one piece of the contract that runs while healthy."""
    with _lock:
        _pending_probes[name] = fn


def register_weak_provider(name: str, obj,
                           alive: Optional[Callable[[Any], bool]] = None
                           ) -> None:
    """The per-instance registration idiom in one place: bind ``obj``'s
    ``debug_state()`` through a weakref so the registry never pins a
    dead subsystem (tests build several pml/btl/era instances per
    process; rebind-by-name means the newest wins) — a collected
    instance, or one ``alive`` rejects (e.g. a closed transport), reads
    as absent, never as an error."""
    import weakref

    ref = weakref.ref(obj)

    def _fx_state(_ref=ref):
        o = _ref()
        if o is None or (alive is not None and not alive(o)):
            return None
        return o.debug_state()

    register_provider(name, _fx_state)


def clip(seq, cap: int = CAP) -> List[Any]:
    """Bounded-list helper for providers: at most ``cap`` items from
    any iterable (a dict yields its keys). Keyed structures that need
    an ``omitted`` count alongside slice explicitly instead."""
    import itertools

    return list(itertools.islice(iter(seq), cap))


def _pending_readings() -> Dict[str, Any]:
    """Every pending-work probe's instantaneous reading, per-probe
    guarded: the dump answers "was anything in flight?" without the
    reader re-deriving it from each subsystem's queue lists (the
    probes are the SAME counters the sentinel polls, so a dump and
    the sentinel verdict it explains can never disagree about what
    counted as pending)."""
    with _lock:
        probes = dict(_pending_probes)
    out: Dict[str, Any] = {}
    for name, fn in sorted(probes.items()):
        try:
            out[name] = fn()
        except Exception as e:  # one sick probe must not sink the dump
            out[name] = f"error: {type(e).__name__}: {e}"
    return out


def debug_state() -> Dict[str, Any]:
    """The uniform introspection surface: every provider's snapshot in
    one JSON-serializable document. A broken provider contributes an
    ``{"error": ...}`` stub instead of sinking the whole dump — the
    dump path runs exactly when the process is least healthy."""
    with _lock:
        providers = dict(_providers)
    out: Dict[str, Any] = {}
    for name, fn in sorted(providers.items()):
        try:
            state = fn()
        except Exception as e:  # never let one subsystem sink the dump
            state = {"error": f"{type(e).__name__}: {e}"}
        if state is not None:
            out[name] = state
    return out


# ---------------------------------------------------------------- counters
# completion ticks from core/request._set_complete (bound lazily below,
# the sanitizer _san_done idiom — the disabled path in request.py is one
# global load)
_completions = [0]  # mpiracer: relaxed-counter — completion ticks from app + progress threads; a lost increment delays re-arm by one completion, which the next tick fixes
_trips = [0]
_dumps = [0]
_dump_seq = [0]

register_pvar("forensics", "stall_trips", lambda: _trips[0],
              help="Times the stall sentinel latched on this rank "
                   "(pending work, no completion past the threshold)")
register_pvar("forensics", "dumps", lambda: _dumps[0],
              help="Forensics state dumps written by this rank "
                   "(sentinel, peer requests, on-demand, auto "
                   "triggers)")
register_pvar("forensics", "stall_latched",
              lambda: int(_sentinel.latched),
              help="1 while the stall sentinel is latched (re-arms on "
                   "the next request completion)")
register_pvar("forensics", "last_completion_age_s",
              lambda: round(_sentinel.age(), 3),
              help="Seconds since the sentinel last observed a request "
                   "completion (0.0 when the sentinel is not armed)")


# _SYSTEM_TAG_BASE (tags at or below it are framework system planes)
# is imported from its pml/base single source of truth in the bottom
# import block, keeping this module's top free of pml imports;
# note_completion resolves the global at call time, long after the
# bottom import has bound it.


def note_completion(req=None) -> None:
    """One request completed (core/request binding; the call site is
    the already-heavy completion path, not the per-verb prologue).

    System-plane requests (tag <= -4000) do NOT tick: heartbeats
    complete every ft_heartbeat_period (200ms default), era/revoke
    chatter and the plane's own peer dump requests complete inline —
    none of it is *application* progress, and counting it would keep
    the sentinel permanently re-armed on every FT job (exactly the
    era-stall soak class this plane exists to diagnose)."""
    if req is not None and \
            getattr(req, "tag", 0) <= _SYSTEM_TAG_BASE:
        return
    _completions[0] += 1


# ----------------------------------------------------------------- sentinel
class _Sentinel:
    """Latches when pending work exists but no completion has occurred
    for the threshold. All state is guarded by ``_slock``: the app
    thread's wait loops and the ProgressThread both drive the
    low-priority progress slot that polls this."""

    def __init__(self):
        self._slock = threading.Lock()
        self.armed = False
        self.latched = False
        self._last_comp = -1
        self._last_change = 0.0
        self._polls_since_change = 0
        self._next_probe = 0.0
        self._last_poll = 0.0

    def reset_clock(self) -> None:
        """Refresh the idle clock (and re-arm after a runtime
        ``disarm``). Re-enabling the plane after a disabled stretch
        must call this: the completion tick was unbound the whole
        time, so the clock is stale by the entire window and the
        first poll that finds pending work would latch a healthy job
        instantly."""
        with self._slock:
            self.armed = True
            self._last_comp = _completions[0]
            self._last_change = time.monotonic()
            self._polls_since_change = 0
            self._next_probe = 0.0
            self._last_poll = 0.0

    def disarm(self) -> None:
        """The plane was disabled at runtime: a latched verdict must
        not outlive it — the tick is unbound, so nothing could ever
        clear the latch, and the stall pvars/sampler would report a
        latched stall with an unboundedly climbing age on a healthy
        job for the rest of the run."""
        with self._slock:
            self.armed = False
            self.latched = False
            self._polls_since_change = 0

    def age(self) -> float:
        with self._slock:
            if not self.armed or self._last_comp < 0:
                return 0.0
            return max(0.0, time.monotonic() - self._last_change)

    def state(self) -> Dict[str, Any]:
        with self._slock:
            return {
                "armed": self.armed,
                "latched": self.latched,
                "since_last_completion_s": round(
                    time.monotonic() - self._last_change, 3)
                if self._last_comp >= 0 else 0.0,
                "polls_since_completion": self._polls_since_change,
                "completions": _completions[0],
            }

    def poll(self) -> int:
        now = time.monotonic()
        comp = _completions[0]
        with self._slock:
            last_poll, self._last_poll = self._last_poll, now
            if comp != self._last_comp:
                self._last_comp = comp
                self._last_change = now
                self._polls_since_change = 0
                self.latched = False  # re-arm: the stall broke
                return 0
            thr_s = float(_thresh_var._value) / 1000.0
            interval = min(max(thr_s / 8.0, 0.01), 1.0)
            # the sentinel can only measure time it was WATCHING: with
            # no progress driver (runtime_progress_thread 0) nothing
            # polls while the app computes outside MPI, so the clock
            # goes threshold-stale and the first poll after fresh work
            # posted would latch a healthy job instantly — a poll gap
            # far beyond the probe cadence is unobserved idle, not
            # stall time (idle-block parks cap at ~500ms, well inside
            # the 1s floor)
            if last_poll and now - last_poll > max(4.0 * interval, 1.0):
                self._last_change = now
                self._polls_since_change = 0
                return 0
            # time-gate the pending probes (the _watchdog_poll
            # cadence pattern): they run CONTINUOUSLY below — not only
            # past the threshold — so the idle clock is never more
            # than one probe interval stale when fresh work appears
            # (a threshold-stale clock latched ~immediately on the
            # first operation after an idle stretch)
            if now < self._next_probe:
                return 0
            self._next_probe = now + interval
            self._polls_since_change += 1
            if self.latched:
                return 0
        pending = _work_pending()  # outside _slock: probes take their
        #                            own subsystem locks
        fire_age = None
        with self._slock:
            # re-read the LIVE counter: a completion that ticked while
            # the probes held contended subsystem locks is invisible to
            # the entry snapshot (`comp`), and _last_comp only advances
            # in the fold above — the stale compare latched anyway
            if _completions[0] != self._last_comp or self.latched:
                return 0  # raced a completion or another latch
            if not pending:
                # idle, not stalled: keep the clock fresh so a stall
                # that starts later is measured from its own onset
                self._last_change = now
                self._polls_since_change = 0
                return 0
            age = now - self._last_change
            if age * 1000.0 < float(_thresh_var._value):
                return 0
            self.latched = True
            _trips[0] += 1
            fire_age = age
        self._fire(fire_age)
        return 0

    def _fire(self, age: float) -> None:
        from ompi_tpu_torch import mpit
        from ompi_tpu_torch.runtime import spc

        spc.record("forensics_stall_trip")
        mpit.emit("forensics", "stall", age_s=age)
        if _trace.enabled():
            _trace.instant("forensics.stall", cat="forensics",
                           age_s=age)
        path = dump(reason=f"stall-sentinel (no completion for "
                           f"{age:.1f}s)")
        _request_all_peer_dumps("stall-sentinel")
        show_help("forensics", "stall", once=False, age=age,
                  thresh=float(_thresh_var._value) / 1000.0,
                  path=path or "<unwritable>",
                  dir=os.path.dirname(path) if path else "<metrics_dir>")


_sentinel = _Sentinel()


def _work_pending() -> bool:
    with _lock:
        probes = dict(_pending_probes)
    for fn in probes.values():
        try:
            if fn() > 0:
                return True
        except Exception:
            continue
    return False


def _sentinel_poll() -> int:
    if not _enable_var._value:
        return 0
    return _sentinel.poll()


_armed = [False]


def arm_sentinel() -> None:
    """Register the sentinel's low-priority progress slot (idempotent).
    Called from wireup's bind and the init_bottom hook — only when the
    plane is enabled, so a disabled job never pays the callback."""
    with _lock:
        if _armed[0]:
            return
        _armed[0] = True
    from ompi_tpu_torch.runtime.progress import register_progress

    with _sentinel._slock:
        _sentinel.armed = True
        _sentinel._last_change = time.monotonic()
        _sentinel._last_comp = _completions[0]
        _sentinel._next_probe = 0.0
    register_progress(_sentinel_poll, low_priority=True)


# -------------------------------------------------------------------- dump
def _rank() -> int:
    return _trace._rank()


def _dump_dir() -> str:
    from ompi_tpu_torch.runtime import metrics as _metrics

    base = _metrics._dir_var._value or _metrics.default_snapshot_dir()
    try:
        os.makedirs(base, exist_ok=True)
    except OSError:
        base = "."
    return base


_dump_lock = threading.Lock()
_last_dump_ts = [0.0]


def dump(reason: str = "on-demand", path: Optional[str] = None,
         min_interval: float = 0.0) -> Optional[str]:
    """Write the full ``debug_state()`` as ``stall-rank<N>.json``
    (atomic rename — a concurrent mpidiag never reads a torn file) and
    return the path. ``min_interval`` > 0 rate-limits repeat dumps (the
    peer-request path: a flapping sentinel on one rank must not turn
    every peer into a disk-writing loop). Never raises."""
    # bounded acquire, not `with`: the SIGUSR1 handler runs on the main
    # thread between bytecodes — if the main thread is already inside a
    # dump when the signal lands, a blocking acquire of this
    # non-reentrant lock would self-deadlock the process it is supposed
    # to be diagnosing
    if not _dump_lock.acquire(timeout=2.0):
        return None
    try:
        try:
            now = time.monotonic()
            if min_interval > 0 and \
                    now - _last_dump_ts[0] < min_interval:
                return None
            _dump_seq[0] += 1  # mpiracer: disable=lock-discipline — _dump_lock IS held: bounded manual acquire above (signal-handler self-deadlock guard), released in the inner finally
            seq = _dump_seq[0]
        finally:
            _dump_lock.release()
        doc = {
            "schema": 1,
            "rank": _rank(),
            "seq": seq,
            "reason": reason,
            "ts_ns": time.monotonic_ns(),  # mpisync-alignable clock
            "wall_time": time.time(),
            "stall": _sentinel.state(),
            "pending": _pending_readings(),
            "subsystems": debug_state(),
        }
        if path is None:
            path = os.path.join(_dump_dir(),
                                f"stall-rank{_rank()}.json")
        from ompi_tpu_torch.utils.fsio import atomic_write_json

        atomic_write_json(path, doc, default=str)
        # stamp the rate limit only AFTER the write lands: a failed
        # dump (disk-full blip) must not suppress a retry within
        # min_interval that would have succeeded
        if _dump_lock.acquire(timeout=2.0):
            try:
                _last_dump_ts[0] = now  # mpiracer: disable=lock-discipline — _dump_lock IS held: bounded manual acquire on the line above (same signal-handler self-deadlock guard as the seq bump)
            finally:
                _dump_lock.release()
        _dumps[0] += 1  # mpiracer: disable=cross-thread-race — diagnostic floor: dumps are seconds apart and a lost count only underreports the pvar
        from ompi_tpu_torch import mpit

        mpit.emit("forensics", "dump", reason=reason, path=path)
        if _trace.enabled():
            _trace.instant("forensics.dump", cat="forensics",
                           reason=reason)
        return path
    except Exception:
        return None  # evidence is best-effort; never take the job down


# -------------------------------------------------- peer dump requests
def _on_system(hdr, payload) -> None:
    """Peer dump request (runs on whatever thread the transport
    delivers on — dump and return, never raise)."""
    try:
        msg = json.loads(bytes(payload))
    except ValueError:
        return
    if msg.get("k") == "dump_req":
        thr = max(float(_thresh_var._value) / 2000.0, 0.1)
        dump(reason=f"peer-request: {msg.get('reason', '?')} on rank "
                    f"{msg.get('from', '?')}",
             min_interval=thr)


from ompi_tpu_torch.pml.base import (  # noqa: E402
    SYSTEM_TAG_BASE as _SYSTEM_TAG_BASE,
    SystemPlane as _SystemPlane,
)

# the forensics dump-request plane: tag -4800, handler above (the
# shared weakref rebind discipline lives in pml/base.SystemPlane)
_plane = _SystemPlane(FORENSICS_TAG, _on_system)


def bind_plane(pml) -> None:
    """Wireup hook: bind the -4800 handler on the not-yet-published pml
    BEFORE the pre-activation fence (the mpiracer handler-fence rule —
    a fast peer's sentinel can latch and request a dump the moment the
    fence releases it). The handler binds UNCONDITIONALLY — a peer's
    ``Dump_state()`` must reach this rank even when its own sentinel is
    disabled (on-demand dumps are debug verbs, not sentinel machinery);
    only the sentinel itself is gated on the cvar."""
    _plane.ensure(pml)
    if _enable_var._value:
        arm_sentinel()


def request_peer_dumps(pml, peers, reason: str) -> None:
    """Fire-and-forget dump requests toward ``peers`` (world ranks).
    The caller writes its OWN dump first — a dead wire toward every
    peer still leaves rank-local evidence (the local-only fallback).
    The requests ride the system plane (tag -4800), so their inline
    eager completions never tick the sentinel's counter — a latched
    sentinel cannot read its own diagnostics as "the stall broke"."""
    _plane.ensure(pml)
    for peer in peers:
        if peer == pml.my_rank:
            continue
        try:
            _plane.send(pml, peer,
                        {"k": "dump_req", "reason": reason,
                         "from": pml.my_rank})
        except Exception:
            pass  # that edge is down: its rank keeps its local dump


def _request_all_peer_dumps(reason: str) -> None:
    from ompi_tpu_torch.pml.base import world_comm

    world = world_comm()
    pml = None if world is None else world.pml
    if pml is None or world is None:
        return
    request_peer_dumps(pml, list(world.group.ranks), reason)


_trigger_ts = [0.0]


def trigger(reason: str) -> Optional[str]:
    """Auto-trigger entry for the existing failure verdicts (sanitizer
    deadlock cycle, ob1 watchdog conversion, era agreement timeout,
    btl/tcp link escalation after a failed reconnect-and-replay):
    dump locally FIRST, then request peer dumps — unconditionally, so
    a rank whose own disk is unwritable still harvests every peer's
    evidence (only the rate limit, which means peers were asked
    moments ago, skips them)."""
    thr = max(float(_thresh_var._value) / 2000.0, 0.1)
    now = time.monotonic()
    with _lock:
        if now - _trigger_ts[0] < thr:
            return None  # this episode already dumped + asked peers
        _trigger_ts[0] = now
    path = dump(reason=reason)  # best-effort local evidence first
    _request_all_peer_dumps(reason)
    return path


# ------------------------------------------------------------- on demand
_sig_installed = [False]


def install_sigusr1() -> None:
    """SIGUSR1 = on-demand dump (idempotent; main thread only — a
    worker-thread init leaves the signal untouched)."""
    with _lock:
        if _sig_installed[0]:
            return
        _sig_installed[0] = True
    import signal

    def _handler(_signum, _frame):
        # dump from a helper thread, NOT inline: the handler runs on
        # the main thread between bytecodes, and the providers take
        # non-reentrant locks (engine.lock, conn.wlock, ...) the
        # interrupted frame may already hold — an inline dump would
        # self-deadlock the process it is diagnosing. A sibling thread
        # just waits its turn for those locks (and if they are held
        # forever, the dump blocks instead of the whole process).
        threading.Thread(target=dump, kwargs={"reason": "SIGUSR1"},
                         name="forensics-sigusr1", daemon=True).start()

    try:
        signal.signal(signal.SIGUSR1, _handler)
    except ValueError:
        with _lock:
            _sig_installed[0] = False  # not the main thread


def _init_bottom() -> None:
    """Singleton / general init hook: the wireup bind covers process
    mode pre-fence; this covers everything else. The dump-request
    handler binds regardless of the cvar (peer Dump_state must land);
    the sentinel and the SIGUSR1 handler arm only when enabled."""
    from ompi_tpu_torch.pml.base import world_pml

    pml = world_pml()
    if pml is not None:
        _plane.ensure(pml)
    if not _enable_var._value:
        return
    arm_sentinel()
    install_sigusr1()


# mpitop's stall column reads this sampler row out of the metrics
# snapshots (pvar fallback for snapshots written before it existed)
def register_stall_sampler() -> None:
    """(Re)bind the stall sampler into the metrics registry — called at
    import; tests that reset the registry re-call it."""
    from ompi_tpu_torch.runtime import metrics as _metrics

    _metrics.register_sampler(
        "forensics_stall",
        lambda: {"latched": int(_sentinel.latched),
                 "age_s": round(_sentinel.age(), 3),
                 "trips": _trips[0],
                 "dumps": _dumps[0]})


register_stall_sampler()


# ------------------------------------------------- request-hook binding
def _rebind_request_hook(_var=None) -> None:
    """Bind/unbind the completion tick into core/request so the
    disabled path there stays one global load (the sanitizer _san_done
    idiom). Watch the cvar: a tool flipping forensics_enable through an
    MPI_T cvar handle on a live (possibly already-wedging) job arms the
    WHOLE automatic plane — tick, sentinel poll, SIGUSR1 — not just the
    counter; all three arms are idempotent."""
    from ompi_tpu_torch.core import request as _request

    if _enable_var._value:
        was_live = _request._fx_note is not None
        _request._fx_note = note_completion
        arm_sentinel()
        if not was_live:
            # the tick was dead: the idle clock is stale by the whole
            # disabled window and would latch on the first pending op
            _sentinel.reset_clock()
        install_sigusr1()
    else:
        _request._fx_note = None
        _sentinel.disarm()


watch_var("forensics", "enable", _rebind_request_hook)
_rebind_request_hook()

from ompi_tpu_torch.hook import register_hook  # noqa: E402

register_hook("init_bottom", _init_bottom)


def reset_for_testing() -> None:
    with _sentinel._slock:
        _sentinel.latched = False
        _sentinel._last_comp = -1
        _sentinel._polls_since_change = 0
        _sentinel._next_probe = 0.0
    _trips[0] = 0
    _dumps[0] = 0
    with _dump_lock:
        _dump_seq[0] = 0
        _last_dump_ts[0] = 0.0
    with _lock:
        _trigger_ts[0] = 0.0
    _plane.reset()
    register_stall_sampler()
