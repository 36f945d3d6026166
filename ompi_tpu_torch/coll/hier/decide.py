"""Decision engine of coll/hier: static tables and self-tuning plan selection.

The port of ``ompi_tpu/coll/hier/decide.py``, with the same variables, tag,
JSON report frames and agreed-index sync, so that ranks of the two packages
fold each other's reports and switch plans together.

It starts from tuned-style static tables (the topology nontrivial, the
payload at or above ``coll_hier_min_bytes``, the op commutative) and then
**self-tunes** from observed latency: every composed call's per-stage wall
times ship to the communicator root over a system-tag plane (tag -4700;
the metrics -4500 idiom), where they fold into the metrics registry's EWMAs
(``hier_plan_us`` per active plan, ``hier_stage_us`` per stage). When the
active plan's EWMA degrades past ``coll_hier_retune_factor`` x its own
post-warmup baseline, the root latches a pending switch — once per
episode, with hysteresis, so selection cannot flap per call.

The switch is applied on an agreed collective index: every
``coll_hier_rescore_interval``-th call on a (cid, verb), all members run a
suppressed flat bcast of the root's verdict and apply it before executing,
so every member switches plans on the same call — never a torn
composition. Each applied switch pops the verb's frozen plan
(coll/hier/plan.py) on every member, bumps the ``hier_retunes`` pvar, and
fires a show_help and a trace instant on the root.

A deterministic stage-delay hook (``coll_hier_inject_*``) degrades exactly
one stage after exactly N calls: the process-mode proof that the re-score
trips once and lands everywhere on the same index.
"""

from __future__ import annotations

import json
import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from ompi_tpu_torch.coll import hier as _hier
from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.runtime import metrics as _metrics
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.utils.show_help import register_topic, show_help

register_var("coll_hier", "enable", True,
             help="Hierarchical collective composition on multi-node "
                  "communicators (intra-host / intra-slice / cross-host "
                  "stages; HiCCL direction)", level=4)
register_var("coll_hier", "fake_nodes", 0,
             help="Pretend the comm spans N nodes (round-robin by rank) "
                  "— the single-host test hook, like coll_han_fake_nodes "
                  "but scoped to the composer", level=7)
register_var("coll_hier", "fake_slices", 0,
             help="Group the (fake or real) nodes round-robin into N "
                  "slices: exercises the three-level host/slice/cross "
                  "composition on one machine", level=7)
register_var("coll_hier", "min_bytes", 0,
             help="Static table: payloads below this run the flat chain "
                  "(the composed pipeline's extra stage latency only "
                  "pays off once bandwidth dominates)", level=5)
_selftune_var = register_var(
    "coll_hier", "selftune", True,
    help="Self-tune plan selection from observed per-stage latency "
         "EWMAs (root-folded; switches land on an agreed collective "
         "index)", level=4)
register_var("coll_hier", "rescore_interval", 32,
             help="Collective calls per (comm, verb) between plan-sync "
                  "points — the agreed indices where a pending re-score "
                  "is applied by every member together", level=6)
register_var("coll_hier", "retune_factor", 3.0, float,
             help="Re-score trip point: the active plan's latency EWMA "
                  "exceeding factor x its own post-warmup baseline "
                  "latches a switch to the alternative (re-arms below "
                  "half the trip ratio — straggler-style hysteresis)",
             level=6)
register_var("coll_hier", "min_samples", 8,
             help="Root-folded samples per (comm, verb, plan) before "
                  "the baseline latches and re-scoring may trip "
                  "(warmup guard against wireup/compile noise)", level=7)
register_var("coll_hier", "retune_min_us", 500.0, float,
             help="Absolute floor on the EWMA-over-baseline excess "
                  "before a re-score may trip: on microsecond-scale "
                  "baselines a bare ratio test would fire on scheduler "
                  "jitter", level=7)
register_var("coll_hier", "inject_stage", "", typ=str,
             help="TEST HOOK: stage-name prefix (e.g. 'cross') whose "
                  "execution is delayed on every rank running it",
             level=9)
register_var("coll_hier", "inject_delay_ms", 0.0, float,
             help="TEST HOOK: injected per-call delay for "
                  "coll_hier_inject_stage", level=9)
register_var("coll_hier", "inject_after", 0,
             help="TEST HOOK: injection starts after this many calls "
                  "on the (comm, verb)", level=9)


# verdict/report plane: clear of metrics (-4500) and diskless (-4600)
HIER_TAG = -4700

register_topic(
    "hier", "retune",
    "The hierarchical-collective decision engine re-scored a plan:\n"
    "{detail}\nThe switch is applied by every member on the same\n"
    "collective index (coll_hier_rescore_interval boundaries); tune\n"
    "coll_hier_retune_factor / coll_hier_min_samples if this trips on\n"
    "benign load transients.")

_PLAN_CODES = {"hier": 0, "flat": 1}
_PLAN_NAMES = {v: k for k, v in _PLAN_CODES.items()}


class VerbState:
    """Per-(cid, verb) selection state. Every member holds one (idx,
    active plan, switch log, pre-bound stage plans); the root-only
    folding fields drive the re-score."""

    __slots__ = ("cid", "verb", "idx", "active", "switch_log", "bound",
                 # root-only folding state
                 "root_active", "pending", "latched", "nsamp",
                 "baseline", "trips")

    def __init__(self, cid: int, verb: str, active: str):
        self.cid = cid
        self.verb = verb
        self.idx = 0
        self.active = active
        self.switch_log: List[int] = []
        self.bound: Dict[Tuple, object] = {}  # (dtype, count-class) -> StagePlan
        self.root_active = active
        self.pending: Optional[str] = None
        self.latched = False
        self.nsamp: Dict[str, int] = {}
        self.baseline: Dict[str, float] = {}
        self.trips = 0


_states: Dict[Tuple[int, str], VerbState] = {}
# guards the root-side fold/latch state: _fold runs on the transport
# thread for shipped reports AND on the app thread for the root's own
# samples, and sync() consumes st.pending on the app thread — unlocked
# interleavings could lose samples, double-latch, or drop a verdict
# (the metrics-plane tracker keeps the same discipline)
_fold_lock = threading.Lock()


def _clear_bound(_var=None) -> None:
    """cvar-write hook: the pre-bound stage plans froze the decision
    knobs (min_bytes), so a runtime write flushes them alongside the
    frozen dispatch plans."""
    for st in _states.values():
        st.bound.clear()


from ompi_tpu_torch.mca.var import watch_var as _watch_var  # noqa: E402

_watch_var("coll_hier", "min_bytes", _clear_bound)


def state_for(comm, verb: str) -> VerbState:
    key = (comm.cid, verb)
    st = _states.get(key)
    if st is None:
        st = _states[key] = VerbState(comm.cid, verb, "hier")
    return st


def _forget_cid(cid: int) -> None:
    """Reclaim one communicator's selection state (metrics registers
    this as a forget hook, so comm-churny jobs don't leak a VerbState
    per cid ever created; the labeled EWMAs are reclaimed by the
    metrics plane's own cid sweep)."""
    for key in [k for k in _states if k[0] == cid]:
        del _states[key]


_metrics.register_forget_hook(_forget_cid)


def domain_map_for(comm):
    """The comm's locality hierarchy, identical on every member:
    fake-topology cvars first (the single-host test hook), then the
    modex node identity han already derives. None = decline."""
    from ompi_tpu_torch.coll.han import HanCollComponent
    from ompi_tpu_torch.runtime.topology import domain_map

    fake = int(get_var("coll_hier", "fake_nodes"))
    slices = int(get_var("coll_hier", "fake_slices"))
    if fake > 1:
        if fake >= comm.size:
            return None  # no node would hold 2+ ranks
        return domain_map([r % fake for r in range(comm.size)], slices)
    node_of = HanCollComponent._modex_node_map(comm)
    if node_of is None:
        return None
    return domain_map(node_of, slices)


def tuning() -> bool:
    """One live-Var attribute load: is self-tuning observation on?"""
    return _selftune_var._value


def sync_due(idx: int) -> bool:
    if not _selftune_var._value or idx == 0:
        return False
    return idx % max(int(get_var("coll_hier", "rescore_interval")), 1) == 0


def inject_delay_ms(stage: str, call_idx: int) -> float:
    """TEST HOOK — deterministic stage degradation for the chaos
    proof. Zero-cost when unset (one cvar read on the composed path)."""
    pref = get_var("coll_hier", "inject_stage")
    if not pref or not stage.startswith(pref):
        return 0.0
    if call_idx <= int(get_var("coll_hier", "inject_after")):
        return 0.0
    return float(get_var("coll_hier", "inject_delay_ms"))


# ----------------------------------------------------------- report/fold
def report(comm, st: VerbState, plan: str, tot_us: float,
           stages: Dict[str, float]) -> None:
    """Ship one composed call's timings to the comm root (the root
    folds its own synchronously — its sample alone can latch a trip, so
    a delayed stage is caught even if peer reports lag in transit)."""
    pml = getattr(comm, "pml", None)
    if pml is None or comm.size <= 1:
        return
    # the ROOT must bind the -4700 handler too: system frames have no
    # unexpected queue, so an unbound tag silently drops every peer's
    # report and re-scoring would see only the root's own samples
    _plane.ensure(pml)
    root_world = comm.group.world_rank(0)
    if root_world == pml.my_rank:
        _fold(st, plan, tot_us, stages)
        return
    _plane.send(pml, root_world,
                {"k": "hier", "cid": st.cid, "verb": st.verb,
                 "plan": plan, "tot": tot_us, "stages": stages})


def _fold(st: VerbState, plan: str, tot_us: float,
          stages: Dict[str, float]) -> None:
    """Root-side fold of one sample into the metrics-plane EWMAs +
    the latched re-score check."""
    v = _metrics.ewma_update("hier_plan_us", tot_us,
                             cid=st.cid, verb=st.verb, plan=plan)
    for name, us in (stages or {}).items():
        _metrics.ewma_update("hier_stage_us", us,
                             cid=st.cid, verb=st.verb, stage=name)
    tripped = None
    with _fold_lock:
        if plan != st.root_active:
            return  # stale report from before an applied switch
        n = st.nsamp.get(plan, 0) + 1
        st.nsamp[plan] = n
        if n < int(get_var("coll_hier", "min_samples")):
            return
        base = st.baseline.get(plan)
        if base is None:
            # post-warmup baseline: the EWMA has absorbed the worst of
            # the wireup/subcomm-construction noise by now
            st.baseline[plan] = max(v, 1e-3)
            return
        factor = float(get_var("coll_hier", "retune_factor"))
        if v < base:
            # the baseline tracks the plan's observed FLOOR: the first
            # composed call pays subcomm construction, so the EWMA
            # enters warmup high and decays — comparing against a
            # snapshot of that transient would hide real degradations
            # behind it
            st.baseline[plan] = base = max(v, 1e-3)
        if not st.latched and v > factor * base \
                and v - base > float(get_var("coll_hier",
                                             "retune_min_us")):
            st.latched = True
            st.trips += 1
            st.pending = "flat" if plan == "hier" else "hier"
            tripped = (st.pending, base, factor)
        elif st.latched and st.pending is None \
                and v < factor * base / 2.0:
            st.latched = False  # hysteresis re-arm for a later episode
    if tripped is not None:
        to, base, factor = tripped
        worst = max(stages.items(), key=lambda kv: kv[1])[0] \
            if stages else "?"
        detail = (f"  {st.verb} on cid={st.cid}: '{plan}' latency EWMA "
                  f"{v:.0f}us > {factor:g} x baseline {base:.0f}us "
                  f"(slowest stage: {worst}) -> switching to "
                  f"'{to}' at the next sync index")
        show_help("hier", "retune", once=False, detail=detail)
        if _trace.enabled():
            _trace.instant("hier.retune", cat="coll", cid=st.cid,
                           verb=st.verb, ewma_us=v, baseline_us=base)


def _on_system(hdr, payload) -> None:
    """Report dispatch (transport thread: record, never raise)."""
    try:
        msg = json.loads(bytes(payload))
    except ValueError:
        return
    if msg.get("k") != "hier":
        return
    st = _states.get((int(msg["cid"]), str(msg["verb"])))
    if st is None:
        return  # comm already freed: drop the straggling report
    _fold(st, str(msg["plan"]), float(msg["tot"]),
          {str(k): float(v) for k, v in (msg.get("stages") or {}).items()})


from ompi_tpu_torch.pml.base import SystemPlane as _SystemPlane  # noqa: E402

_plane = _SystemPlane(HIER_TAG, _on_system)


def bind_plane(pml) -> None:
    """Wireup hook: bind the -4700 handler before the pre-activation
    fence. The lazy ensure in report() runs when THIS rank finishes a
    composed call — a peer that finished the same collective earlier
    has already shipped its stage report, and an unbound tag drops it
    (re-scoring would then see only a subset of samples). Unconditional:
    an unused handler is one dict slot, and hier selection is a
    per-communicator decision this plane must not depend on."""
    _plane.ensure(pml)


def link_floor_bytes() -> int:
    """Measured composition floor from the fabric telemetry
    (runtime/linkmodel): the worst bandwidth-delay product across this
    rank's links. The stage tables fold it into min_bytes when plans
    bind — the observability half of the egress-bandwidth model
    (ROADMAP item 4): below one wire-RTT of payload the composed
    pipeline's extra cross-link stage latency cannot pay for itself.
    Returns 0 (no floor) when the linkmodel plane is off or has no
    samples yet."""
    from ompi_tpu_torch.runtime import linkmodel as _linkmodel

    if not _linkmodel._enable_var._value:
        return 0
    try:
        return _linkmodel.cross_floor_bytes()
    except Exception:
        return 0  # telemetry must never fail a collective


# ------------------------------------------------------------- plan sync
def sync(comm, st: VerbState, idx: int) -> None:
    """The agreed-index plan agreement: the root publishes its active
    plan; every member applies it BEFORE executing this call. Rides
    the flat bcast with spc suppressed — it must not recurse into the
    composition being re-scored, and it is library-internal traffic."""
    from ompi_tpu_torch.coll.basic import flat_module
    from ompi_tpu_torch.coll.hier import plan as _plan
    from ompi_tpu_torch.runtime import spc

    if comm.rank == 0:
        with _fold_lock:  # a racing transport-thread fold must not
            if st.pending is not None:  # latch between read and clear
                st.root_active = st.pending
                st.pending = None
    payload = np.array([_PLAN_CODES.get(st.root_active, 0)],
                       dtype=np.int64)
    with spc.suppressed():
        flat_module().bcast(comm, payload, 0)
    new = _PLAN_NAMES[int(payload[0])]
    if new != st.active:
        st.active = new
        st.switch_log.append(idx)  # the call index everyone shares
        st.bound.clear()              # stage plans re-bind to the choice
        _hier._retunes[0] += 1
        _plan.invalidate_comm(comm, st.verb)  # frozen-plan re-score seam
