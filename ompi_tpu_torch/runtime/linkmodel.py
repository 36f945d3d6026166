"""Fabric link telemetry: per-link RTT / goodput / loss estimation.

The port of ``ompi_tpu/runtime/linkmodel.py``: the registry, the
estimators folded from a conn's counters, the verdicts, the snapshot
sampler and the probe round. Its source of rows (the reliable conns) and
the -4900 probe's wire are the tcp btl of process mode.

The reliability envelope (btl/tcp.py) already retains every sent
frame with its send instant and releases it on the peer's cumulative
ack — which makes passive link measurement essentially free, the way
TCP itself estimates RTT off its own ack clock:

- **SRTT / RTTVAR** — Jacobson/Karn on the conn: the ack that releases
  a retained frame yields ``now - sent_ts``; samples whose frame was
  ever RETRANSMITTED are discarded (Karn's algorithm — an ack after a
  retransmission is ambiguous about which copy it acknowledges). The
  estimator state lives on the conn (btl/tcp keeps it hot for the
  RTT-adaptive retransmit timer even when this plane is off); this
  module is the registry/export/consumer layer over it.
- **delivered goodput** — EWMA over ACKED wire bytes per (peer, QoS
  class), folded on a slow cadence. Acked, not enqueued: a shaped
  deferral or a retained-while-degraded backlog inflates enqueue rates
  but moves nothing — goodput must read what the peer provably holds.
- **loss/corruption rate** — from the PER-CONN retransmit / crc_error /
  dedup counters (the global pvars can't attribute a storm to an edge),
  with DIRECTIONAL attribution: NACK-evidenced retransmits charge the
  outbound edge's ``loss_ppm`` (a CRC reject at the peer NACKs and
  forces a retransmit here, so one-way corruption lands on the faulted
  direction only), while the conn's own crc/dedup counts describe
  inbound frames and surface as ``rx_loss_ppm``. Timeout retransmits
  stay OUT of the rate (still visible as ``retx_n``) — they may just
  mean a slow ack, and their ambient ratio on a busy host dwarfs any
  sane loss threshold.
- **queue delay** — oldest shaped-frame age (already tracked for
  forensics), surfaced per edge.

Idle links get an OPT-IN active probe (``linkmodel_probe_ms``): a tiny
LATENCY-class echo on the -4900 system plane. The probe frame rides the
normal reliable envelope, so its RTT sample flows through the SAME
passive estimator (and Karn filtering) as data traffic — the probe only
guarantees the estimators stay warm on edges the application is not
currently exercising.

Consumers: coll/hier's decide engine folds the measured cross-link
bandwidth-delay product into its stage tables (link_floor_bytes), the
metrics straggler tracker cross-references a laggard's link health
before naming the rank, ft/detector snapshots edge stats into its
degrade/restore verdicts, and tools/mpinet.py renders the N x N fabric
weathermap from the per-rank snapshots this module exports.

Disabled path: one live-Var attribute load per hook (the spc / trace /
metrics guard discipline).
"""

from __future__ import annotations

# instrumentation-plane member: mpilint module-scan marker for the
# derived INSTR_IMPL set
MPILINT_INSTR_IMPL = True

import json
import threading
import time
from typing import Any, Callable, Dict, List, Optional

from ompi_tpu_torch.mca.var import register_var, register_pvar
from ompi_tpu_torch.runtime import metrics as _metrics

_enable_var = register_var(
    "linkmodel", "enable", False,
    help="Per-link fabric telemetry: passive SRTT/RTTVAR, delivered "
         "goodput and loss_ppm per (peer, QoS class) off the "
         "btl_tcp reliability envelope's ack clock, exported into the "
         "metrics snapshot (tools/mpinet.py weathermap). Disabled "
         "path is one attribute load per hook; the conn-level "
         "estimators that feed btl_tcp_retx_adaptive run regardless",
    level=4)
_probe_var = register_var(
    "linkmodel", "probe_ms", 0.0, float,
    help="Active-probe cadence for IDLE links (milliseconds between "
         "probe rounds; 0 = passive only). Each round sends a tiny "
         "LATENCY-class echo on the -4900 system plane to every "
         "established peer whose link carried no new frame since the "
         "last round — the echo rides the reliability envelope, so "
         "its RTT folds through the same Karn-filtered estimator as "
         "data traffic", level=6)
_rtt_degraded_var = register_var(
    "linkmodel", "rtt_degraded_us", 50000.0, float,
    help="SRTT past which an edge reads as DEGRADED in the mpinet "
         "--check / mpidiag / straggler cross-reference verdicts",
    level=6)
_loss_degraded_var = register_var(
    "linkmodel", "loss_degraded_ppm", 5000.0, float,
    help="loss_ppm (NACK-evidenced retransmits per million frames "
         "sent — CRC rejects at the peer NACK into this rate; timeout "
         "retransmits don't count) past which an edge reads as "
         "DEGRADED in the verdict consumers", level=6)

# probe plane: clear of revoke/heartbeat/era/flood (-4242..-4245), osc
# (-4300), sanitizer (-4400), metrics (-4500), diskless (-4600), hier
# (-4700) and forensics (-4800)
LINKPROBE_TAG = -4900


def enabled() -> bool:
    """One attribute load off the live Var (spc/trace discipline)."""
    return _enable_var._value


# ------------------------------------------------------------ the registry
_ALPHA = 0.3           # goodput EWMA smoothing (the metrics default)
_FOLD_MIN_S = 0.05     # rate folds below this dt would amplify noise
_CLS_NAMES = ("normal", "latency", "bulk")  # index == qos class int


class LinkModel:
    """Folded estimate for one directed edge (this rank -> peer)."""

    __slots__ = ("peer", "srtt_us", "rttvar_us", "rtt_samples",
                 "goodput_bps", "loss_ppm", "rx_loss_ppm",
                 "tx_frames", "retx_n", "nack_retx_n",
                 "queue_delay_us", "state",
                 "_prev_acked", "_prev_ts", "_probe_txseq")

    def __init__(self, peer: int):
        self.peer = peer
        self.srtt_us = 0.0
        self.rttvar_us = 0.0
        self.rtt_samples = 0
        self.goodput_bps = [0.0, 0.0, 0.0]   # by qos class int
        self.loss_ppm = 0.0
        self.rx_loss_ppm = 0.0
        self.tx_frames = 0
        self.retx_n = 0
        self.nack_retx_n = 0
        self.queue_delay_us = 0.0
        self.state = "est"
        self._prev_acked: Optional[List[int]] = None
        self._prev_ts = 0.0
        self._probe_txseq = -1

    def row(self, src: int) -> Dict[str, Any]:
        return {
            "src": src,
            "dst": self.peer,
            "srtt_us": round(self.srtt_us, 1),
            "rttvar_us": round(self.rttvar_us, 1),
            "rtt_samples": self.rtt_samples,
            "goodput_bps": {_CLS_NAMES[c]: round(self.goodput_bps[c], 1)
                            for c in range(3)},
            "loss_ppm": round(self.loss_ppm, 1),
            "rx_loss_ppm": round(self.rx_loss_ppm, 1),
            "tx_frames": self.tx_frames,
            "retx_n": self.retx_n,
            "nack_retx_n": self.nack_retx_n,
            "queue_delay_us": round(self.queue_delay_us, 1),
            "state": self.state,
        }


_lock = threading.Lock()
_models: Dict[int, LinkModel] = {}
_source: Optional[Callable[[], List[dict]]] = None
_last_fold = [0.0]
_rtt_ctr = [0]      # total accepted RTT samples (probe + passive)
_probe_ctr = [0]

register_pvar("linkmodel", "rtt_samples", lambda: _rtt_ctr[0],
              help="Karn-accepted RTT samples folded into the per-link "
                   "estimators (passive ack-clock + probe echoes)")
register_pvar("linkmodel", "probes_sent", lambda: _probe_ctr[0],
              help="Idle-link echo probes sent on the -4900 plane "
                   "(linkmodel_probe_ms cadence)")
register_pvar("linkmodel", "edges", lambda: len(_models),
              help="Directed edges with a live LinkModel estimate")
register_pvar("linkmodel", "srtt_max_us",
              lambda: max([m.srtt_us for m in _models.values()] or [0.0]),
              help="Worst smoothed RTT across this rank's edges "
                   "(tools/mpitop.py RTT column pvar fallback)")
register_pvar("linkmodel", "goodput_bps",
              lambda: sum(sum(m.goodput_bps) for m in _models.values()),
              help="Summed delivered-goodput EWMA across this rank's "
                   "edges and QoS classes (tools/mpitop.py GBPS "
                   "column pvar fallback)")


def register_source(fn: Callable[[], List[dict]]) -> None:
    """btl/tcp registers its per-conn stats walker here (one row per
    live reliable conn; see tcp._linkmodel_rows). Rebind-by-name isn't
    needed — there is exactly one tcp module — but re-registration is
    idempotent for the test-reset path."""
    global _source
    _source = fn


def _rank() -> int:
    return _metrics._rank()


def note_rtt_sample(peer: int, sample_s: float) -> None:
    """One Karn-accepted RTT sample (btl/tcp's ack-release hook; call
    sites guard on ``_enable_var._value``). Feeds the labeled histogram
    — the smoothed estimate itself is folded from the conn state."""
    _rtt_ctr[0] += 1  # mpiracer: relaxed-counter — progress-thread bump, pvar readers tolerate a stale view
    if _metrics._enable_var._value:
        _metrics.observe("btl_tcp_link_rtt_us", sample_s * 1e6,
                         src=_rank(), dst=peer)


def _fold(now: Optional[float] = None, force: bool = False) -> None:
    """Pull the per-conn stats rows and fold rates/estimates into the
    registry + metrics gauges. Rate-limited: callers (sampler reads,
    probe rounds, consumer queries) may fire much faster than a rate
    fold can tolerate."""
    if _quiesced[0]:
        return
    src_fn = _source
    if src_fn is None:
        return
    if now is None:
        now = time.monotonic()
    with _lock:
        if not force and now - _last_fold[0] < _FOLD_MIN_S:
            return
        _last_fold[0] = now
        rows = src_fn()
        my = _rank()
        for r in rows:
            peer = r["peer"]
            m = _models.get(peer)
            if m is None:
                m = _models[peer] = LinkModel(peer)
            m.srtt_us = r["srtt"] * 1e6
            m.rttvar_us = r["rttvar"] * 1e6
            m.rtt_samples = r["rtt_n"]
            m.state = r["state"]
            m.queue_delay_us = r["queue_age_s"] * 1e6
            acked = r["acked_b"]
            if m._prev_acked is not None:
                dt = now - m._prev_ts
                if dt >= _FOLD_MIN_S:
                    for c in range(3):
                        inst = (acked[c] - m._prev_acked[c]) * 8.0 / dt
                        m.goodput_bps[c] += _ALPHA * (inst -
                                                      m.goodput_bps[c])
                    m._prev_acked = list(acked)
                    m._prev_ts = now
            else:
                m._prev_acked = list(acked)
                m._prev_ts = now
            # directional attribution: NACK-evidenced retransmits are
            # proof of loss on THIS edge (me -> peer) — a CRC reject
            # at the peer NACKs and forces a retransmit here, so
            # corruption lands in the sender's directed rate. Timeout
            # retransmits stay OUT of the rate (visible in retx_n):
            # they may just mean a slow ack, and on busy hosts their
            # ambient ratio dwarfs any sane loss threshold. The conn's
            # OWN crc/dedup counters describe inbound frames (the
            # peer -> me edge) and fold into rx_loss_ppm instead —
            # blaming them on the outbound edge would flag both
            # directions for a one-way fault.
            m.loss_ppm = (1e6 * r["nack_retx_n"]
                          / max(r["tx_frames"], 1))
            m.rx_loss_ppm = (1e6 * (r["crc_errs"] + r["dedup_n"])
                             / max(r["rx_frames"], 1))
            m.tx_frames = r["tx_frames"]
            m.retx_n = r["retx_n"]
            m.nack_retx_n = r["nack_retx_n"]
            if _metrics._enable_var._value:
                if m.rtt_samples:
                    _metrics.gauge_set("btl_tcp_link_srtt_us",
                                       round(m.srtt_us, 1),
                                       src=my, dst=peer)
                _metrics.gauge_set("btl_tcp_link_loss_ppm",
                                   round(m.loss_ppm, 1), src=my,
                                   dst=peer)
                for c in range(3):
                    if m.goodput_bps[c]:
                        _metrics.gauge_set(
                            "btl_tcp_link_goodput_bps",
                            round(m.goodput_bps[c], 1), src=my,
                            dst=peer, cls=_CLS_NAMES[c])
        # edges whose conn vanished from the walk are RETAINED with
        # their last folded estimates: the finalize/atexit snapshot
        # export folds after the btl tears its conns down, and
        # dropping them here would erase every measurement from the
        # one export the offline tools (mpinet/mpicrit) read


# ------------------------------------------------------------- consumers
def edges() -> List[Dict[str, Any]]:
    """Folded per-edge rows (this rank as src) — the snapshot sampler,
    tools, and tests all read this shape."""
    _fold()
    my = _rank()
    with _lock:
        return [m.row(my) for _, m in sorted(_models.items())]


def edge(peer: int) -> Optional[Dict[str, Any]]:
    """The folded estimate for this rank's edge to ``peer``, or None
    (no reliable conn / telemetry off / never measured)."""
    _fold()
    with _lock:
        m = _models.get(peer)
        return None if m is None else m.row(_rank())


_LOSS_MIN_EVENTS = 3    # one NACK storm's go-back-N burst is not a rate
_LOSS_MIN_FRAMES = 32   # ppm over a handful of frames is noise, not rate


def degraded(row: Dict[str, Any]) -> bool:
    """The shared edge-health verdict (mpinet --check, the straggler
    cross-reference, mpidiag): RTT or loss past the cvar thresholds,
    or the link itself mid-outage. loss_ppm only counts NACK-evidenced
    retransmits, so it is already noise-free on a healthy fabric; the
    statistical floor on top keeps a single corruption blip (one
    NACK's go-back-N resend burst on a near-idle edge) from reading as
    a sustained loss rate."""
    if row.get("state") not in (None, "est"):
        return True
    if row.get("rtt_samples") and \
            row.get("srtt_us", 0.0) > float(_rtt_degraded_var._value):
        return True
    return (row.get("loss_ppm", 0.0) > float(_loss_degraded_var._value)
            and row.get("nack_retx_n", _LOSS_MIN_EVENTS)
            >= _LOSS_MIN_EVENTS
            and row.get("tx_frames", _LOSS_MIN_FRAMES)
            >= _LOSS_MIN_FRAMES)


def describe_edge(peer: int) -> Optional[str]:
    """One human line about this rank's link to ``peer`` — the
    straggler tracker appends it to its verdict so 'rank R is slow'
    distinguishes a degraded wire from a slow rank."""
    row = edge(peer)
    if row is None or not row.get("rtt_samples"):
        return None
    health = "DEGRADED" if degraded(row) else "healthy"
    bps = sum(row["goodput_bps"].values())
    return (f"link ->{peer} {health}: srtt {row['srtt_us'] / 1000.0:.1f}ms"
            f" goodput {bps / 1e9:.3f}Gbps loss {row['loss_ppm']:.0f}ppm")


def cross_floor_bytes() -> int:
    """Measured bandwidth-delay product, maxed across this rank's
    edges: coll/hier's decide engine folds it into the stage tables as
    a min_bytes floor (a composed pipeline pays ~one extra cross-link
    RTT per stage, so composition pays off only once the payload
    dwarfs what the wire holds in one RTT)."""
    if not _enable_var._value:
        return 0
    _fold()
    bdp = 0
    with _lock:
        for m in _models.values():
            if not m.rtt_samples:
                continue
            bps = sum(m.goodput_bps)
            bdp = max(bdp, int(bps / 8.0 * m.srtt_us / 1e6))
    return bdp


# ------------------------------------------------------- snapshot sampler
def _sample() -> Dict[str, Any]:
    return {"edges": edges(), "probes_sent": _probe_ctr[0],
            "rtt_samples": _rtt_ctr[0]}


def register_linkmodel_sampler() -> None:
    """(Re)bind the weathermap sampler into the metrics registry —
    called at import; tests that reset the registry re-call it
    (tcp.register_link_sampler discipline)."""
    _metrics.register_sampler("btl_tcp_linkmodel", _sample)


register_linkmodel_sampler()


# ---------------------------------------------------------- active probe
def _on_probe(hdr, payload) -> None:
    """-4900 echo handler (transport thread: respond, never raise). A
    ping is answered with a pong — the pong is reverse-direction DATA,
    so its envelope piggybacks the cumulative ack that closes the
    ping's RTT sample without waiting out the periodic ack timer, and
    the pong's own ack warms the reverse edge symmetrically."""
    try:
        msg = json.loads(bytes(payload))
    except ValueError:
        return
    if msg.get("op") != "ping":
        return  # pong: the envelope ack already did the measuring
    from ompi_tpu_torch.pml.base import world_pml

    pml = world_pml()
    if pml is not None:
        _plane.send(pml, int(msg["src"]), {"op": "pong",
                                           "n": int(msg.get("n", 0))})


from ompi_tpu_torch.pml.base import SystemPlane as _SystemPlane  # noqa: E402

_plane = _SystemPlane(LINKPROBE_TAG, _on_probe)


def probe_round(now: float, pml) -> List[int]:
    """One probe round: ping every established peer whose conn sent no
    new frame since the last round (tx_seq unchanged — links with live
    traffic are already measured passively for free). Returns the
    probed peers (the unit-test seam)."""
    src_fn = _source
    if src_fn is None:
        return []
    probed: List[int] = []
    with _lock:
        for r in src_fn():
            if r["state"] != "est":
                continue
            peer = r["peer"]
            m = _models.get(peer)
            if m is None:
                m = _models[peer] = LinkModel(peer)
            if m._probe_txseq == r["tx_frames"]:
                probed.append(peer)
            m._probe_txseq = r["tx_frames"]
    for peer in probed:
        _plane.send(pml, peer, {"op": "ping", "src": pml.my_rank,
                                "n": _probe_ctr[0]})
        _probe_ctr[0] += 1
    return probed


_probe_next = [0.0]
_armed = [False]
_quiesced = [False]


def _probe_poll() -> int:
    """Low-priority progress slot (forensics-sentinel discipline):
    nonblocking, self-gated on the enable Var and the opt-in cadence."""
    if _quiesced[0] or not _enable_var._value:
        return 0
    period = float(_probe_var._value)
    if period <= 0:
        return 0
    now = time.monotonic()
    if now < _probe_next[0]:
        return 0
    _probe_next[0] = now + period / 1000.0
    from ompi_tpu_torch.pml.base import world_pml

    pml = world_pml()
    if pml is None:
        return 0
    return 1 if probe_round(now, pml) else 0


def bind_plane(pml) -> None:
    """Wireup hook: bind the -4900 echo handler on the not-yet-
    published pml BEFORE the pre-activation fence (mpiracer
    handler-fence — a fast peer's first probe must not hit an unbound
    tag), and arm the opt-in prober's progress slot."""
    if _enable_var._value:
        _plane.ensure(pml)
        with _lock:
            if _armed[0]:
                return
            _armed[0] = True
        from ompi_tpu_torch.runtime.progress import register_progress

        register_progress(_probe_poll, low_priority=True)


def quiesce() -> None:
    """Finalize hook, called BEFORE the exit fence: no peer leaves the
    fence (and starts closing sockets) until every rank has entered
    it, so this forced fold sees the fabric's last healthy instant —
    then the registry freezes. Past the fence, peers close their
    sockets at staggered times and every conn transits its redial/
    degraded shutdown states; folding THOSE would export shutdown
    mechanics as fabric weather, and ``mpinet --check`` would flag
    healthy edges."""
    if _quiesced[0]:
        return
    _fold(force=True)
    _quiesced[0] = True


def reset_for_testing() -> None:
    """Drop every folded estimate and counter (unit-test isolation)."""
    with _lock:
        _models.clear()
        _last_fold[0] = 0.0
    # relaxed slots (single-writer progress-thread state, never read
    # under _lock) — resetting them inside the lock would teach the
    # race analysis a lock-ownership discipline the hot paths don't
    # (and shouldn't) follow
    _probe_next[0] = 0.0
    _rtt_ctr[0] = 0
    _probe_ctr[0] = 0
    _quiesced[0] = False
    _plane.reset()
