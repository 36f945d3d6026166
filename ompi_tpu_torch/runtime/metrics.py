"""Live metrics plane: histograms, gauges, EWMAs, straggler detection.

The port of ``ompi_tpu/runtime/metrics.py``. The registry, the straggler
tracker, ``snapshot`` (spc counters and every pvar, the mesh-mode cache
pvars included), the Prometheus render, the JSON export and the opt-in
localhost HTTP endpoint run now; the port's bench mirrors its results into
the gauges. Entry stamps cross ranks over the -4500 system plane of
process mode; a mesh-mode comm has no pml and stamps nothing.

The trace plane gives post-mortem spans (Chrome-trace export at finalize);
this module is the *live* telemetry layer a production system scrapes
while the job runs. Reference points: Open MPI's MPI_T pvar sessions +
SPC counters (ompi_spc.c) and the pml/monitoring communication matrix;
the design follows the collective-imbalance literature (HiCCL, arxiv
2508.13397): in production the dominant pathology is a rank entering
collectives late — a *straggler* — not raw bandwidth, so skew detection
is the first-class citizen here.

Pieces:

- **Registry** — log2-bucketed latency :class:`Histogram`\\ s, gauges,
  and rolling :class:`EWMA` windows, all name+label keyed, fronting the
  existing spc counters and pvars behind ONE sampling surface
  (:func:`snapshot`). Recording helpers are cheap, but the hot-path
  contract is the established one-live-Var-load discipline: call sites
  guard on ``metrics.enabled()`` / ``_enable_var._value`` (see
  runtime/spc.py, runtime/trace.py; mpilint's hot-guard rule covers the
  metrics hooks).
- **Straggler detection** — every rank stamps collective entry at the
  verb-layer dispatch (`ProcComm._coll`); non-root ranks ship the stamp
  to the communicator root over a dedicated system-tag plane
  (``METRICS_TAG`` = -4500, the sanitizer -4400 idiom). The root
  aggregates per call index: skew = entry_ts - median(entry_ts) (the
  late MINORITY — a min baseline would flag every rank the straggler
  transitively dragged late), folded into a per-(cid, rank) EWMA. An
  EWMA crossing
  ``metrics_straggler_threshold_us`` fires — on the laggard rank, where
  an operator tails the logs — show_help, the
  ``metrics_straggler_trips`` pvar, the ``metrics_straggler_trip``
  MPI_T event, and a trace instant. Same-host ranks share
  CLOCK_MONOTONIC so cross-process stamps compare directly; multi-host
  alignment rides the mpisync offsets (tools/trace_merge.py).
- **Export** — :func:`render_prometheus` renders the whole surface in
  the Prometheus/OpenMetrics text format (tools/promexport.py is the
  file-based CLI + validator), :func:`export_json` writes a
  ``metrics-rank<N>.json`` snapshot (at finalize always; periodically
  when ``metrics_snapshot_period`` > 0 for tools/mpitop.py), and an
  optional localhost-only HTTP endpoint (``metrics_http_port``, off by
  default) serves ``/metrics`` and ``/json`` live.

Enable with ``--mca metrics_enable 1`` (or
``OMPI_TPU_MCA_metrics_enable=1`` / ``set_var("metrics", "enable",
True)``). The disabled path costs one attribute load per hook.
"""

from __future__ import annotations

import json
import math
import os
import re
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Tuple

from ompi_tpu_torch.mca.var import register_var, register_pvar
from ompi_tpu_torch.mpit import register_event_type
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.utils.show_help import register_topic, show_help

_enable_var = register_var(
    "metrics", "enable", False,
    help="Record live metrics (latency histograms, collective entry "
         "stamps, straggler detection) and export a JSON snapshot at "
         "finalize; disabled path is one attribute load per hook",
    level=3)
_thresh_var = register_var(
    "metrics", "straggler_threshold_us", 10000.0, float,
    help="Collective entry-skew EWMA (microseconds) past which a rank "
         "is flagged as a straggler (show_help + "
         "metrics_straggler_trips pvar + trace instant on the laggard)",
    level=4)
_min_samples_var = register_var(
    "metrics", "straggler_min_samples", 5,
    help="Collective rounds a rank's skew EWMA must cover before it "
         "may trip (warmup guard against first-round wireup noise)",
    level=7)
_alpha_var = register_var(
    "metrics", "ewma_alpha", 0.3, float,
    help="Smoothing factor for the rolling EWMA windows (weight of the "
         "newest sample)", level=7)
_buckets_var = register_var(
    "metrics", "hist_buckets", 24,
    help="Log2 histogram sizing: finite bucket upper edges 1us, 2us, "
         "4us ... 2^(N-1)us, plus the +Inf overflow bucket", level=5)
_dir_var = register_var(
    "metrics", "dir", "", typ=str,
    help="Directory for the per-rank metrics-rank<N>.json snapshot. "
         "Empty (default) = a per-job subdir of the system temp dir "
         "(ompi-tpu-metrics-<launcher pid>) — NOT the CWD, which "
         "littered repo checkouts with per-rank snapshots every "
         "procmode run. tools/mpitop.py finds the newest such dir by "
         "default; point this somewhere durable to keep snapshots",
    level=5)
_http_var = register_var(
    "metrics", "http_port", 0,
    help="Serve /metrics (Prometheus text) and /json on "
         "127.0.0.1:<port>; 0 (default) = no HTTP endpoint", level=4)
_period_var = register_var(
    "metrics", "snapshot_period", 0.0, float,
    help="Rewrite metrics-rank<N>.json every N seconds while the job "
         "runs (tools/mpitop.py consumes these); 0 = finalize-only",
    level=5)

# stamp/verdict plane: clear of sanitizer (-4400), osc (-4300), and the
# ft heartbeat/era/revoke tags (-4242..-4245)
METRICS_TAG = -4500


def enabled() -> bool:
    """One attribute load off the live Var (spc/trace discipline)."""
    return _enable_var._value


# ---------------------------------------------------------------- registry
_lock = threading.Lock()
LabelKey = Tuple[str, Tuple[Tuple[str, str], ...]]


def _key(name: str, labels: Dict[str, Any]) -> LabelKey:
    return (name, tuple(sorted((k, str(v)) for k, v in labels.items())))


class Histogram:
    """Log2-bucketed latency histogram: finite buckets with upper edges
    1, 2, 4 ... 2^(n-1) microseconds plus a +Inf overflow bucket —
    exactly the Prometheus histogram shape (cumulative at render time,
    per-bucket here). A value lands in the first bucket whose edge
    covers it: ``observe(3)`` goes to le=4 (bit_length)."""

    __slots__ = ("name", "labels", "counts", "sum", "count")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...],
                 nbuckets: int):
        self.name = name
        self.labels = labels
        self.counts = [0] * (max(nbuckets, 1) + 1)  # [-1] = +Inf
        self.sum = 0.0
        self.count = 0

    def observe(self, value_us: float) -> None:
        # tightest covering edge: v lands in the first bucket with
        # value <= le — ceil, not int(): 4.7 belongs in le=8, and
        # truncation would file it under le=4, breaking the cumulative
        # invariant; (v-1).bit_length() keeps exact powers of two in
        # their own bucket instead of one up
        v = math.ceil(value_us)
        i = (v - 1).bit_length() if v > 0 else 0
        with _lock:
            self.counts[min(i, len(self.counts) - 1)] += 1
            self.sum += float(value_us)
            self.count += 1

    def edges(self) -> List[float]:
        return [float(1 << i) for i in range(len(self.counts) - 1)] \
            + [math.inf]

    def quantile(self, q: float) -> float:
        """Upper-edge estimate of the q-quantile (0 < q <= 1)."""
        with _lock:
            total = self.count
            counts = list(self.counts)
        if not total:
            return 0.0
        target = q * total
        seen = 0
        for i, c in enumerate(counts):
            seen += c
            if seen >= target:
                # the overflow bucket has no finite upper edge — report
                # inf rather than fabricating 2^nbuckets (an operator
                # reading a 16.8s "p99" for a 60s tail tunes wrong)
                return float(1 << i) if i < len(counts) - 1 else math.inf
        return math.inf


class EWMA:
    """Rolling exponentially-weighted window: one float of state, the
    newest sample weighted by ``metrics_ewma_alpha``."""

    __slots__ = ("name", "labels", "value", "n")

    def __init__(self, name: str, labels: Tuple[Tuple[str, str], ...]):
        self.name = name
        self.labels = labels
        self.value: Optional[float] = None
        self.n = 0

    def update(self, sample: float, alpha: Optional[float] = None) -> float:
        a = float(_alpha_var._value) if alpha is None else alpha
        with _lock:
            self.value = sample if self.value is None \
                else a * sample + (1.0 - a) * self.value
            self.n += 1
            return self.value


_hists: Dict[LabelKey, Histogram] = {}
_gauges: Dict[LabelKey, float] = {}
_ewmas: Dict[LabelKey, EWMA] = {}
_samplers: Dict[str, Callable[[], Any]] = {}


def histogram(name: str, **labels: Any) -> Histogram:
    k = _key(name, labels)
    h = _hists.get(k)
    if h is None:
        with _lock:
            h = _hists.setdefault(
                k, Histogram(name, k[1], int(_buckets_var._value)))
    return h


def observe(name: str, value_us: float, **labels: Any) -> None:
    """Record one latency observation (call sites on hot paths guard on
    ``enabled()`` — one attribute load when the plane is off)."""
    histogram(name, **labels).observe(value_us)


def gauge_set(name: str, value: float, **labels: Any) -> None:
    with _lock:
        _gauges[_key(name, labels)] = float(value)


def gauge_get(name: str, **labels: Any) -> Optional[float]:
    with _lock:
        return _gauges.get(_key(name, labels))


def ewma(name: str, **labels: Any) -> EWMA:
    k = _key(name, labels)
    e = _ewmas.get(k)
    if e is None:
        with _lock:
            e = _ewmas.setdefault(k, EWMA(name, k[1]))
    return e


def ewma_update(name: str, sample: float, **labels: Any) -> float:
    return ewma(name, **labels).update(sample)


def register_sampler(name: str, fn: Callable[[], Any]) -> None:
    """Bind a zero-arg reader merged into every snapshot (the
    pml/monitoring comm-matrix hook). Re-registration rebinds — the
    pvar-reader-rebind discipline — so a restarted provider reports the
    LIVE instance."""
    with _lock:
        _samplers[name] = fn


# --------------------------------------------------- straggler detection
_trips = [0]

register_pvar("metrics", "straggler_trips", lambda: _trips[0],
              help="Collective-imbalance trips on THIS rank: its entry "
                   "skew EWMA crossed metrics_straggler_threshold_us")
register_event_type("metrics", "straggler_trip",
                    "This rank's collective entry-skew EWMA crossed the "
                    "straggler threshold (skew/ewma us in the payload)")
register_topic(
    "metrics", "straggler",
    "The metrics plane flagged THIS rank as a collective STRAGGLER:\n"
    "{detail}\nEvery peer on the communicator waits for the slowest\n"
    "entrant; sustained skew here is lost time on every other rank.\n"
    "Look for imbalanced input shards, background load, or a slow\n"
    "link on this host (metrics_straggler_threshold_us tunes the\n"
    "trip point).")


class StragglerTracker:
    """Comm-root skew aggregation: per (cid, call index) rows of entry
    stamps; a complete row (every member present) folds each rank's
    skew-vs-median into a per-(cid, rank) EWMA. Crossing the
    threshold trips ONCE per episode (latched until the EWMA decays
    below half the threshold — a banner per collective would bury the
    signal). Bounded: at most ``window`` pending rows per cid survive a
    dead or silent rank."""

    window = 256

    def __init__(self):
        self._rows: Dict[Tuple[int, int], Dict[int, Tuple[int, int]]] = {}
        self._nsamp: Dict[Tuple[int, int], int] = {}
        self._tripped: set = set()

    def record(self, cid: int, idx: int, rank: int, ts_us: int,
               wrank: int, size: int) -> List[Tuple[int, int, float, float]]:
        """Returns [(rank, wrank, skew_us, ewma_us)] trips fired by this
        stamp (empty until the row is complete and a threshold crossed)."""
        trips: List[Tuple[int, int, float, float]] = []
        with _lock:
            row = self._rows.setdefault((cid, idx), {})
            row[rank] = (int(ts_us), int(wrank))
            if len(row) < size:
                if len(self._rows) > self.window:
                    # evict the LONGEST-PENDING row (dict insertion
                    # order), not min((cid, idx)) — a silent rank on one
                    # comm must shed ITS stale rows, not starve another
                    # comm's actively-filling ones
                    oldest = next(iter(self._rows))
                    if oldest != (cid, idx):
                        self._rows.pop(oldest, None)
                return trips
            self._rows.pop((cid, idx), None)
            # baseline = LOWER-MEDIAN entry time, not the earliest: a
            # straggler drags its peers' exits (they wait on its
            # contribution), so min-relative skew bleeds ~the full lag
            # into every rank that transitively waited and flags
            # innocents. Only the late MINORITY shows positive skew
            # against the median — the actual straggler definition.
            # (2-rank comms degenerate to min, the only baseline there.)
            ts_sorted = sorted(t for t, _ in row.values())
            base = ts_sorted[(len(ts_sorted) - 1) // 2]
            members = sorted(row.items())
        thr = float(_thresh_var._value)
        need = int(_min_samples_var._value)
        for r, (t, w) in members:
            skew = float(max(t - base, 0))
            # label by WORLD rank: mpitop and dashboards key this
            # against world ranks, and a subcomm's local rank 0 would
            # otherwise pin its skew on the wrong host's row
            v = ewma_update("coll_entry_skew_us", skew,
                            cid=cid, rank=w)
            key = (cid, r)
            with _lock:
                n = self._nsamp.get(key, 0) + 1
                self._nsamp[key] = n
                if n >= need and v > thr and key not in self._tripped:
                    self._tripped.add(key)
                    trips.append((r, w, skew, v))
                elif v < thr / 2.0:
                    self._tripped.discard(key)
        return trips

    def forget(self, cid: int) -> None:
        """Release one communicator's aggregation state (rows, sample
        counts, trip latches) — called when a stamp arrives for a comm
        that no longer exists."""
        with _lock:
            for key in [k for k in self._rows if k[0] == cid]:
                del self._rows[key]
            for key in [k for k in self._nsamp if k[0] == cid]:
                del self._nsamp[key]
            self._tripped = {k for k in self._tripped if k[0] != cid}

    def clear(self) -> None:
        with _lock:
            self._rows.clear()
            self._nsamp.clear()
            self._tripped.clear()


_tracker = StragglerTracker()
_idx: Dict[int, int] = {}  # cid -> my local collective call index


def _bind_world_handler() -> None:
    """init_bottom hook: bind the system handler before user code runs
    so a peer's first stamp can't be dropped by lazy registration."""
    from ompi_tpu_torch.pml.base import world_pml

    if not _enable_var._value:
        return
    pml = world_pml()
    if pml is not None:
        _plane.ensure(pml)


def on_coll_entry(comm, verb: str) -> None:
    """Entry stamp for one collective dispatch (ProcComm._coll /
    _pcoll Start). Call sites guard on ``_enable_var._value``; mesh-mode
    comms (no pml, single controller — nothing to skew against) and
    library-internal collectives are skipped."""
    from ompi_tpu_torch.runtime import spc

    if getattr(spc._suppress, "depth", 0):
        return  # CID agreement, window fences: not user collectives
    pml = getattr(comm, "pml", None)
    if pml is None or comm.size <= 1:
        return
    ts_us = time.monotonic_ns() // 1000
    cid = comm.cid
    with _lock:
        i = _idx.get(cid, 0)
        _idx[cid] = i + 1
    rank = int(getattr(comm, "rank", 0))
    if _trace.enabled():
        # the (cid, call_index) stamp in the trace: tools/mpicrit.py
        # names "blocked on rank R <verb> entry" by matching the walk's
        # wait segment against the nearest preceding coll.entry
        _trace.instant("coll.entry", cat="coll", cid=cid, idx=i,
                       verb=verb)
    _plane.ensure(pml)
    root_world = comm.group.world_rank(0)
    if root_world == pml.my_rank:
        _root_record(pml, cid, i, rank, ts_us, pml.my_rank)
    else:
        _plane.send(pml, root_world,
                    {"k": "stamp", "cid": cid, "idx": i, "rank": rank,
                     "wrank": pml.my_rank, "ts": ts_us})


def _root_record(pml, cid: int, idx: int, rank: int, ts_us: int,
                 wrank: int) -> None:
    """Fold one stamp into the tracker (root side); route any trips to
    their laggards."""
    from ompi_tpu_torch.comm.communicator import lookup_comm

    comm = lookup_comm(cid)
    if comm is None:
        _forget_cid(cid)  # the comm died: reclaim its aggregation
        return            # state instead of leaking it per dead cid
    for r, w, skew, v in _tracker.record(cid, idx, rank, ts_us, wrank,
                                         comm.size):
        detail = (f"  rank {r} on {getattr(comm, 'name', cid)} "
                  f"(cid={cid}) entered collective #{idx} "
                  f"{skew:.0f}us after the median rank; skew EWMA "
                  f"{v:.0f}us > threshold "
                  f"{float(_thresh_var._value):.0f}us")
        # cross-reference the laggard's link health (linkmodel, when
        # armed): "rank R is slow" reads very differently when the
        # root's own wire to R is the degraded part
        from ompi_tpu_torch.runtime import linkmodel as _linkmodel

        if _linkmodel._enable_var._value and w != pml.my_rank:
            try:
                lk = _linkmodel.describe_edge(w)
            except Exception:
                lk = None  # telemetry must never poison the verdict
            if lk is not None:
                detail += f"\n  root's {lk}"
        if w == pml.my_rank:
            _trip_local(cid, skew, v, detail)
        else:
            _plane.send(pml, w,
                        {"k": "straggler", "cid": cid, "skew": skew,
                         "ewma": v, "detail": detail})


# other planes keying live state by cid (coll/hier's decide engine)
# register here so one Free/vanish sweep reclaims every layer's state
_forget_hooks: List[Callable[[int], None]] = []


def register_forget_hook(fn: Callable[[int], None]) -> None:
    """Run ``fn(cid)`` whenever per-comm metrics state is reclaimed
    (ProcComm.Free on every rank; the root's late-stamp lookup miss)."""
    with _lock:
        _forget_hooks.append(fn)


def _forget_cid(cid: int) -> None:
    """Drop every piece of per-comm straggler state (tracker rows and
    latches, the local call-index counter, the per-member skew EWMAs)
    for a freed or vanished communicator — comm-churny jobs (per-step
    Split/Free) must not leak one entry per cid ever created.
    ProcComm.Free calls this on every rank; the root's late-stamp path
    (lookup_comm miss) catches comms that died without a local Free."""
    _tracker.forget(cid)
    want = ("cid", str(cid))
    with _lock:
        _idx.pop(cid, None)
        for key in [k for k in _ewmas if want in k[1]]:
            del _ewmas[key]
        hooks = list(_forget_hooks)
    for fn in hooks:
        try:
            fn(cid)
        except Exception:
            pass  # a broken hook must not poison Free/late-stamp paths


def _on_system(hdr, payload) -> None:
    """Stamp/verdict dispatch (runs on whatever thread the transport
    delivers on — record and report, never raise)."""
    try:
        msg = json.loads(bytes(payload))
    except ValueError:
        return
    kind = msg.get("k")
    if kind == "stamp":
        from ompi_tpu_torch.pml.base import world_pml

        pml = world_pml()
        if pml is not None:
            _root_record(pml, int(msg["cid"]), int(msg["idx"]),
                         int(msg["rank"]), int(msg["ts"]),
                         int(msg["wrank"]))
    elif kind == "straggler":
        _trip_local(int(msg["cid"]), float(msg["skew"]),
                    float(msg["ewma"]), str(msg["detail"]))


from ompi_tpu_torch.pml.base import SystemPlane as _SystemPlane  # noqa: E402

# the metrics stamp/verdict plane: tag -4500, handler above (the shared
# weakref rebind discipline lives in pml/base.SystemPlane)
_plane = _SystemPlane(METRICS_TAG, _on_system)


def bind_plane(pml) -> None:
    """Wireup hook: bind the -4500 handler on the not-yet-published pml
    BEFORE the pre-activation fence. The init_bottom hook
    (_bind_world_handler) reads world_pml(), which is still None at
    that point in wireup — and a fast peer's first collective entry
    stamp can arrive the moment the fence releases it, before this
    rank's init_bottom runs (the diskless flake class; mpiracer
    handler-fence)."""
    if _enable_var._value:
        _plane.ensure(pml)


def _trip_local(cid: int, skew_us: float, ewma_us: float,
                detail: str) -> None:
    """The laggard-side trip: pvar + spc + MPI_T event + show_help + a
    trace instant, all on the rank being flagged (the operator tailing
    THIS rank's log is the one who can fix it)."""
    from ompi_tpu_torch import mpit
    from ompi_tpu_torch.runtime import spc

    _trips[0] += 1
    spc.record("metrics_straggler_trip")
    mpit.emit("metrics", "straggler_trip", cid=cid, skew_us=skew_us,
              ewma_us=ewma_us)
    show_help("metrics", "straggler", once=False, detail=detail)
    if _trace.enabled():
        _trace.instant("metrics.straggler", cat="metrics", cid=cid,
                       skew_us=skew_us, ewma_us=ewma_us)


# ------------------------------------------------- critical-path breakdown
# Live per-step attribution (critpath_{compute,wire,wait,defer}_us
# histograms + the critpath_bound sampler): fed by serve/harness's
# coarse on-rank timer per step, and by anything replaying
# tools/mpicrit.py's offline walk back into the registry. The live feed
# is an approximation (it cannot see cross-rank edges); mpicrit over
# the merged traces is the ground truth.
_critpath: Dict[str, Any] = {
    "steps": 0, "category": "", "rank": -1,
    "compute_us": 0.0, "wire_us": 0.0, "wait_us": 0.0, "defer_us": 0.0,
}

register_pvar("metrics", "critpath_steps",
              lambda: _critpath["steps"],
              help="Steps with a critical-path breakdown recorded "
                   "(note_critpath calls; serve/harness feeds one per "
                   "served step when metrics are on)")
register_pvar("metrics", "critpath_bound_rank",
              lambda: _critpath["rank"],
              help="Rank the most recent step's critical path ran "
                   "through (-1 before the first breakdown; the live "
                   "harness feed reports its own world rank)")
register_pvar("metrics", "critpath_bound_category",
              lambda: _critpath["category"],
              help="Dominant category of the most recent step's "
                   "critical path: compute / wire / wait / defer "
                   "(string pvar — JSON snapshot only)")


def note_critpath(compute_us: float, wire_us: float, wait_us: float,
                  defer_us: float, rank: int) -> None:
    """Fold one step's critical-path breakdown into the live plane:
    per-category latency histograms plus the critpath_bound sampler /
    pvars naming the dominant category and bound rank. Call sites
    guard on ``enabled()`` (auto-derived hook contract)."""
    vals = {"compute": float(compute_us), "wire": float(wire_us),
            "wait": float(wait_us), "defer": float(defer_us)}
    for cat, v in vals.items():
        observe(f"critpath_{cat}_us", v)
    bound = max(vals, key=lambda c: vals[c])
    with _lock:
        _critpath["steps"] += 1
        _critpath["category"] = bound
        _critpath["rank"] = int(rank)
        for cat, v in vals.items():
            _critpath[cat + "_us"] = v


register_sampler("critpath_bound", lambda: dict(_critpath))


# ---------------------------------------------------------------- snapshot
def _rank() -> int:
    """Launcher rank identity for the export filename — one shared
    helper (trace.py owns the env read + its lint suppression)."""
    return _trace._rank()


def snapshot() -> Dict[str, Any]:
    """The ONE sampling surface: spc counters, every registered pvar,
    and the registry's gauges/histograms/EWMAs/samplers in a single
    JSON-serializable document."""
    from ompi_tpu_torch.mca.var import all_pvars
    from ompi_tpu_torch.runtime import spc

    out: Dict[str, Any] = {
        "rank": _rank(),
        "ts_ns": time.monotonic_ns(),
        "counters": spc.snapshot(),
    }
    pvars: Dict[str, Any] = {}
    for name, pv in all_pvars().items():
        if name.startswith("spc_"):
            continue  # the lazy spc mirrors: counters already carry them
        try:
            pvars[name] = pv.value
        except Exception:
            pass  # a broken reader must not sink the whole snapshot
    out["pvars"] = pvars
    with _lock:
        out["gauges"] = [
            {"name": n, "labels": dict(lbl), "value": v}
            for (n, lbl), v in _gauges.items()]
        # histogram fields read under the SAME lock observe() updates
        # them under: a mid-observe snapshot must not render buckets
        # whose le="+Inf" cumulative disagrees with _count
        out["histograms"] = [
            {"name": h.name, "labels": dict(h.labels),
             "buckets": list(h.counts),
             "le": [e if e != math.inf else "+Inf" for e in h.edges()],
             "sum": h.sum, "count": h.count}
            for h in _hists.values()]
        out["ewmas"] = [
            {"name": e.name, "labels": dict(e.labels), "value": e.value,
             "n": e.n}
            for e in _ewmas.values() if e.value is not None]
        samplers = dict(_samplers)
    sampled: Dict[str, Any] = {}
    errors: Dict[str, str] = {}
    for name, fn in samplers.items():
        try:
            sampled[name] = fn()
        except Exception as e:
            # a broken sampler must not sink the snapshot, but it must
            # not vanish either: a missing key reads as "never
            # registered" to mpitop, hiding the regression. Record the
            # failure so the consumer can tell absent from broken.
            errors[name] = f"{type(e).__name__}: {e}"
    out["samplers"] = sampled
    if errors:
        out["sampler_errors"] = errors
    return out


def default_snapshot_dir() -> str:
    """Where snapshots land when ``metrics_dir`` is unset: a per-JOB
    subdir of the system temp dir. Keyed by the launcher pid (every
    rank of one mpirun shares it, so tools/mpitop.py can merge the rank
    files) — NOT flat tempdir, where two concurrent jobs on one host
    would overwrite each other's metrics-rank0.json; singletons key by
    their own pid."""
    import tempfile

    job = os.environ.get("OMPI_TPU_LAUNCHER_PID") or str(os.getpid())  # mpilint: disable=raw-environ — launcher/job identity (the wireup pdeathsig key), not config
    return os.path.join(tempfile.gettempdir(), f"ompi-tpu-metrics-{job}")


def export_json(path: Optional[str] = None) -> str:
    """Write the snapshot as metrics-rank<N>.json; returns the path.
    Atomic rename so tools/mpitop.py never reads a torn file."""
    if path is None:
        base = _dir_var._value or default_snapshot_dir()
        try:
            os.makedirs(base, exist_ok=True)
        except OSError:
            base = "."  # unwritable temp dir: last-resort CWD
        path = os.path.join(base, f"metrics-rank{_rank()}.json")
    # unique tmp per writer (utils/fsio): the periodic writer thread
    # and the finalize/atexit export may race, and a shared tmp name
    # would let one writer's fd interleave into the other's renamed
    # final file
    from ompi_tpu_torch.utils.fsio import atomic_write_json

    return atomic_write_json(path, snapshot(), default=str)


# ------------------------------------------------------- prometheus render
_NAME_RE = re.compile(r"[^a-zA-Z0-9_:]")


def _prom_name(raw: str) -> str:
    name = _NAME_RE.sub("_", raw)
    if not name or name[0].isdigit():
        name = "_" + name
    return name


def _prom_labels(labels: Dict[str, Any]) -> str:
    if not labels:
        return ""
    parts = []
    for k in sorted(labels):
        v = str(labels[k]).replace("\\", r"\\").replace('"', r"\"") \
            .replace("\n", r"\n")
        parts.append(f'{_prom_name(str(k))}="{v}"')
    return "{" + ",".join(parts) + "}"


def _prom_num(v: Any) -> str:
    f = float(v)
    if f == math.inf:
        return "+Inf"
    if f == -math.inf:
        return "-Inf"
    return repr(f)


class _Family:
    __slots__ = ("name", "typ", "help", "lines")

    def __init__(self, name: str, typ: str, help_: str):
        self.name = name
        self.typ = typ
        self.help = help_
        self.lines: List[str] = []


def render_prometheus(snaps: Optional[List[Dict[str, Any]]] = None) -> str:
    """Prometheus/OpenMetrics text exposition of one or more snapshots
    (default: the live registry). Every sample carries a ``rank`` label
    so multi-rank merges (tools/promexport.py) stay collision-free;
    family HELP/TYPE headers render once, samples grouped per family —
    the promtool text-format grammar rules the unit tests encode."""
    if snaps is None:
        snaps = [snapshot()]
    fams: Dict[str, _Family] = {}

    def fam(name: str, typ: str, help_: str) -> _Family:
        f = fams.get(name)
        if f is None:
            f = fams[name] = _Family(name, typ, help_)
        return f

    for snap in snaps:
        base = {"rank": snap.get("rank", 0)}
        for cname, v in sorted(snap.get("counters", {}).items()):
            f = fam("ompi_spc_" + _prom_name(cname), "counter",
                    f"SPC counter {cname}")
            f.lines.append(f"{f.name}{_prom_labels(base)} {_prom_num(v)}")
        for pname, v in sorted(snap.get("pvars", {}).items()):
            if isinstance(v, bool):
                v = int(v)
            if not isinstance(v, (int, float)):
                continue  # structured pvars are JSON-only
            f = fam("ompi_pvar_" + _prom_name(pname), "gauge",
                    f"MPI_T pvar {pname}")
            f.lines.append(f"{f.name}{_prom_labels(base)} {_prom_num(v)}")
        def with_origin(labels: Dict[str, Any]) -> Dict[str, Any]:
            # the exporting rank attributes the sample — unless the
            # series already carries a semantic `rank` label (the
            # straggler EWMAs name their SUBJECT rank; the comm root
            # exports every member's series and overwriting would
            # collapse them into duplicate samples)
            lbl = dict(labels)
            lbl.setdefault("rank", base["rank"])
            return lbl

        for g in snap.get("gauges", []):
            f = fam("ompi_metrics_" + _prom_name(g["name"]), "gauge",
                    f"metrics gauge {g['name']}")
            f.lines.append(
                f"{f.name}{_prom_labels(with_origin(g.get('labels', {})))}"
                f" {_prom_num(g['value'])}")
        for e in snap.get("ewmas", []):
            f = fam("ompi_metrics_" + _prom_name(e["name"]) + "_ewma",
                    "gauge", f"rolling EWMA of {e['name']}")
            f.lines.append(
                f"{f.name}{_prom_labels(with_origin(e.get('labels', {})))}"
                f" {_prom_num(e['value'])}")
        for h in snap.get("histograms", []):
            f = fam("ompi_metrics_" + _prom_name(h["name"]), "histogram",
                    f"metrics histogram {h['name']} (microseconds)")
            lbl = with_origin(h.get("labels", {}))
            cum = 0
            for edge, c in zip(h["le"], h["buckets"]):
                cum += c
                ble = dict(lbl, le=edge if edge == "+Inf"
                           else _prom_num(edge))
                f.lines.append(f"{f.name}_bucket{_prom_labels(ble)} "
                               f"{_prom_num(cum)}")
            f.lines.append(f"{f.name}_sum{_prom_labels(lbl)} "
                           f"{_prom_num(h['sum'])}")
            f.lines.append(f"{f.name}_count{_prom_labels(lbl)} "
                           f"{_prom_num(h['count'])}")
        for mname, rows in sorted(snap.get("samplers", {}).items()):
            if mname.endswith("_by_class") and isinstance(rows, dict):
                # generic by-class sampler (the btl_tcp shape queue
                # gauges): one gauge family, each key a class label —
                # promexport --check validates it like any family
                f = fam("ompi_metrics_" + _prom_name(mname), "gauge",
                        f"per-class sampler {mname}")
                for cls_name in sorted(rows):
                    v = rows[cls_name]
                    if not isinstance(v, (int, float)) or \
                            isinstance(v, bool):
                        continue
                    lbl = dict(base)
                    lbl["class"] = cls_name
                    f.lines.append(
                        f"{f.name}{_prom_labels(lbl)} {_prom_num(v)}")
                continue
            if mname != "pml_comm_matrix" or not isinstance(rows, list):
                continue
            msgs = fam("ompi_pml_peer_messages", "counter",
                       "pml/monitoring per-peer message count")
            byts = fam("ompi_pml_peer_bytes", "counter",
                       "pml/monitoring per-peer byte count")
            for row in rows:
                lbl = dict(base, src=row["src"], dst=row["dst"])
                msgs.lines.append(f"{msgs.name}{_prom_labels(lbl)} "
                                  f"{_prom_num(row['msgs'])}")
                byts.lines.append(f"{byts.name}{_prom_labels(lbl)} "
                                  f"{_prom_num(row['bytes'])}")
    out: List[str] = []
    for name in sorted(fams):
        f = fams[name]
        out.append(f"# HELP {f.name} {f.help}")
        out.append(f"# TYPE {f.name} {f.typ}")
        out.extend(f.lines)
    return "\n".join(out) + "\n" if out else ""


# ------------------------------------------------------------- http + jobs
_http_server = None
_writer_started = False


def start_http(port: Optional[int] = None) -> int:
    """Serve /metrics (text format 0.0.4) and /json on localhost.
    Returns the bound port (useful with port=0). Idempotent."""
    global _http_server
    if _http_server is not None:
        return _http_server.server_address[1]
    import http.server

    class _Handler(http.server.BaseHTTPRequestHandler):
        def do_GET(self):  # noqa: N802 (http.server API)
            if self.path.startswith("/json"):
                body = json.dumps(snapshot(), default=str).encode()
                ctype = "application/json"
            else:
                body = render_prometheus().encode()
                ctype = "text/plain; version=0.0.4; charset=utf-8"
            self.send_response(200)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def log_message(self, *args):
            pass  # scrapes must not spam rank stderr

    bind = int(_http_var._value) if port is None else int(port)
    srv = http.server.ThreadingHTTPServer(("127.0.0.1", bind), _Handler)
    t = threading.Thread(target=srv.serve_forever,
                         name="metrics-http", daemon=True)
    t.start()
    _http_server = srv
    return srv.server_address[1]


def stop_http() -> None:
    global _http_server
    srv = _http_server
    _http_server = None
    if srv is not None:
        srv.shutdown()
        srv.server_close()


def _start_jobs() -> None:
    """init_bottom hook: the opt-in HTTP endpoint and the periodic
    snapshot writer (both off by default)."""
    global _writer_started
    if not _enable_var._value:
        return
    if int(_http_var._value) > 0:
        try:
            start_http()
        except OSError as e:
            from ompi_tpu_torch.utils.output import get_logger

            get_logger("metrics").warning(
                "metrics_http_port %s unavailable: %s",
                _http_var._value, e)
    period = float(_period_var._value)
    if period > 0 and not _writer_started:
        _writer_started = True

        def loop():
            while True:
                time.sleep(period)
                if not _enable_var._value:
                    continue
                try:
                    export_json()
                except OSError:
                    pass

        threading.Thread(target=loop, name="metrics-writer",
                         daemon=True).start()


_exported = False


def _maybe_export() -> None:
    """Finalize/exit hook: one JSON snapshot per rank whenever the
    plane is enabled (the trace.py export discipline)."""
    global _exported
    if _exported or not _enable_var._value:
        return
    _exported = True
    try:
        export_json()
    except Exception:
        import traceback

        traceback.print_exc()  # never poison finalize/atexit


def reset_for_testing() -> None:
    global _exported
    with _lock:
        _hists.clear()
        _gauges.clear()
        _ewmas.clear()
        _samplers.clear()
        _idx.clear()
        _critpath.update(steps=0, category="", rank=-1, compute_us=0.0,
                         wire_us=0.0, wait_us=0.0, defer_us=0.0)
    _tracker.clear()
    _trips[0] = 0
    _exported = False
    _plane.reset()
    register_sampler("critpath_bound", lambda: dict(_critpath))


from ompi_tpu_torch.hook import register_hook  # noqa: E402

register_hook("init_bottom", _bind_world_handler)
register_hook("init_bottom", _start_jobs)
register_hook("finalize_bottom", _maybe_export)

import atexit  # noqa: E402

# mesh-mode scripts never call Finalize — atexit is their export path
# (registered at import, before state.py's atexit Finalize: LIFO order
# runs Finalize-time counters into the snapshot first)
atexit.register(_maybe_export)
