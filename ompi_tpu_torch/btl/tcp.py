"""TCP transport.

The port of ``ompi_tpu/btl/tcp.py``, whole: the same cvars, pvars,
handshake capability words, length-word flag bits, reliability envelope,
control frames and CRC trailer, so a port btl and a JAX-package btl talk
to each other on one socket. Payloads are ``bytes``, ndarrays,
buffer-protocol objects or CPU ``torch.Tensor``s (viewed as bytes without
a copy by ``btl.base.host_bytes``); a tensor off the CPU raises
``TypeError`` — stage it with ``accelerator.stage_to_host`` first.

Reference: opal/mca/btl/tcp (5,240 LoC — libevent-driven endpoints with
multi-link striping). Redesign: one non-blocking listener + lazy outgoing
connections, drained by the central progress engine (selectors-based; the
GIL releases in select so the progress thread is cheap). This is the DCN
path of the framework — device bulk data rides the mesh path instead, so
the TCP btl optimizes for control/pt2pt traffic, not peak bandwidth.

Frame format: [u32 total_len][header HDR_SIZE bytes][payload]. One frame
per pml message/fragment; TCP ordering per connection preserves MPI
ordering per peer (the reference's per-peer seq numbers guard reordering
across *multiple* btls; with one link per peer ordering is structural).

Zero-copy datapath (the opal convertor / btl writev discipline): a send
is a vector [length word, header, payload view] pushed with
``socket.sendmsg`` — no frame materialization, no eager-payload copy.
Only bytes the kernel would not take are copied, into an owned
write-queue entry (a deque of buffers drained by vectored I/O — the
reference's pending-frag list, minus the O(n^2) bytes-concat the old
``wbuf += frame`` paid under backlog). The receive side ``recv_into``s
a pooled block per connection and hands the pml *slices* of it; a copy
happens only at the pml delivery boundary when a payload must outlive
the block (unexpected-queue stash, system-plane blobs). The remaining
copies are measured, not estimated: ``btl_tcp_bytes_copied`` /
``btl_tcp_writev_calls`` / ``btl_tcp_wire_bytes`` pvars, and
``btl_tcp_copy_mode=1`` re-materializes the legacy copies so bench can
A/B the tax in one process.

Priority-aware traffic shaping (``btl_tcp_shape_enable``): each
connection's send backlog becomes three QoS-class sub-queues
(LATENCY / NORMAL / BULK, read from bits 6-7 of the pml kind byte —
see qos.py) drained by a weighted-deficit scheduler with a
starvation bound (``btl_tcp_shape_max_defer_bytes``), so a background
checkpoint blob can no longer head-of-line-block a 4KB allreduce for
its full serialization time. FIFO still holds WITHIN a class (the
pml's per-(peer, class) sequence planes depend on it); preemption
happens between frames — the pml segments oversized blobs into
sub-frames so the yield granularity is ``btl_tcp_shape_segment_bytes``.
The legacy single-FIFO drain stays verbatim behind shape_enable=0 (the
A/B baseline), and the win is measured from the ``btl_tcp_shape_*``
pvars (queued-bytes-by-class gauges, preemption counts) plus the
metrics-plane per-class deferral histogram.

On-wire compression (``btl_tcp_compress`` = zlib level 1-9, 0 = off):
large rendezvous payloads (>= ``btl_tcp_compress_min_bytes``) go out
zlib-deflated with the top bit of the length word flagging the frame;
the header stays plaintext so frame parsing is unchanged. The framing
is negotiated per connection during the rank handshake — a capability
bit meaning "I can DECODE flagged frames" rides the connector's rank
word (advertised unconditionally by this build, so engagement never
depends on which side dialed first) and the acceptor answers with an
ack word. A peer launched with ``btl_tcp_compress`` unset still
decodes. Forward-compat scope: a build WITHOUT this framing is safe as
the CONNECTOR (its bare rank word parses unchanged here, it never
advertises, and no flagged frame or ack is ever emitted toward it);
dialing such a build is NOT supported — its acceptor would parse the
capability bit as part of the rank. All ranks of one job run one
build, so the one-directional guarantee covers the real topology.

Link reliability (``btl_tcp_reliable``, default ON): a negotiated
per-connection reliability envelope turns wire faults from instant
link death into bounded self-healing. Every data frame on an engaged
link carries a link sequence number, a piggybacked cumulative ack and
a CRC32 trailer; sent frames are RETAINED (bounded by
``btl_tcp_retx_window_bytes``) until the peer's cumulative ack covers
them, a CRC mismatch NACKs a retransmission instead of desyncing or
killing the stream, and the receiver dedups by sequence so pml
delivery stays exactly-once under retransmit overlap. A failed
ESTABLISHED connection degrades instead of dying: outbound frames
keep accumulating in the retransmit window while the lower rank
redials on the utils/backoff schedule (``btl_tcp_link_retries`` /
``btl_tcp_link_backoff_ms`` / ``btl_tcp_link_deadline_s``); the
resync handshake on the fresh socket exchanges cumulative acks and
replays the unacked tail, invisible to the pml. Escalation — redial
budget blown, detector-confirmed death, or resync disagreement —
falls through to the pre-reliability failure path (mark_failed, dead
conn, pml failover/dead-letter) unchanged. The legacy wire format
stays bit-identical behind ``btl_tcp_reliable=0`` (the A/B baseline);
an engaged build caps frames at 512 MiB so the per-frame envelope and
control flag bits can never alias length bits (see the framing guard
in send()).
"""

from __future__ import annotations

# instrumentation-bearing framework code on the wire path (per-class
# deferral observations, preemption counters) with no note_* hooks of
# its own — the mpilint module-scan marker keeps it in the derived
# INSTR_IMPL set (span-ctx exemption) without hand-list extension
MPILINT_INSTR_IMPL = True

import errno
import itertools
import os
import selectors
import socket
import struct
import threading
import time
import weakref
import zlib
from collections import deque
from typing import Callable, Dict, List, Optional, Tuple

from ompi_tpu_torch import qos as _qos
from ompi_tpu_torch.btl.base import Btl, btl_framework, host_bytes
from ompi_tpu_torch.ft import inject as _inject
from ompi_tpu_torch.runtime import forensics as _forensics
from ompi_tpu_torch.runtime import linkmodel as _linkmodel
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import (register_var, register_pvar, get_var,
                              watch_var)
from ompi_tpu_torch.pml.base import HDR_SIZE, QOS_SHIFT
from ompi_tpu_torch.runtime import metrics as _metrics
from ompi_tpu_torch.runtime import mpool as _mpool
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.utils import backoff as _backoff
from ompi_tpu_torch.utils.output import get_logger

register_var("btl_tcp", "eager_limit", 1 << 20,
             help="TCP eager/rendezvous threshold in bytes", level=4)
register_var("btl_tcp", "retries", 18,
             help="Bounded connection-establishment retries before the "
                  "connect fails up to the pml failover path "
                  "(reference: btl_tcp_retries_on_connect... the "
                  "endpoint complete-connect retry loop). The default "
                  "schedule (with btl_tcp_backoff_ms doubling to its "
                  "2s cap) spans the 30s total deadline, so a peer "
                  "that takes the whole pre-retry 30s window to come "
                  "up still connects", level=5)
register_var("btl_tcp", "backoff_ms", 25.0,
             help="Base delay between connect retries; doubles per "
                  "attempt (capped at 2s) with +-50% jitter so a "
                  "restarted peer isn't reconnect-stormed by every "
                  "rank at once", level=5)
# empty = auto: loopback for single-host jobs, all-interfaces bound +
# best non-loopback address advertised when the launcher flags a
# multi-host job (OMPI_TPU_MULTIHOST) — reference: btl_tcp_if_include
register_var("btl_tcp", "bind_host", "",
             help="Interface to bind/advertise (empty=auto; "
                  "reference: btl_tcp_if_*)",
             level=4)
_compress_var = register_var(
    "btl_tcp", "compress", 0,
    help="zlib level (1-9) for on-wire payload compression of frames "
         "at or above btl_tcp_compress_min_bytes; 0 (default) = off. "
         "Negotiated per connection during the rank handshake, so a "
         "non-compressing peer interops (it simply never receives a "
         "compressed frame)", level=4)
_compress_min_var = register_var(
    "btl_tcp", "compress_min_bytes", 1 << 16,
    help="Payload bytes below which frames are never compressed (the "
         "deflate cost beats the wire saving on small/eager traffic; "
         "the default targets rendezvous DATA fragments)", level=5)
_vecs_var = register_var(
    "btl_tcp", "writev_max_vecs", 64,
    help="Max iovecs handed to one sendmsg() when draining the "
         "vectored write queue (IOV_MAX guard; reference: the btl "
         "writev scatter-gather of opal's tcp frag lists)", level=5)
_copy_mode_var = register_var(
    "btl_tcp", "copy_mode", 0,
    help="1 = legacy copying datapath: materialize the eager-payload "
         "copy, the frame concat, the per-recv 1 MiB allocation + "
         "rbuf concat, and the receive parse copies the zero-copy "
         "vectored path eliminates. A/B baseline for bench.py's p2p "
         "section — the copies feed btl_tcp_bytes_copied either way, "
         "so copies-per-wire-byte is measured, not estimated", level=9)

# ------------------------------------------------- priority traffic shaping
# btl_tcp_shape_enable / shape_segment_bytes live in qos.py
# (the pml shares them: it stamps the class and segments system blobs);
# the scheduler knobs below are this transport's own.
_quantum_var = register_var(
    "btl_tcp", "shape_quantum_bytes", 1 << 16,
    help="Base quantum of the weighted-deficit drain: each scheduling "
         "round grants every backlogged class quantum * weight bytes "
         "of deficit; a class sends while its deficit covers its head "
         "frame. Smaller = tighter interleave, more scheduling work "
         "per byte", level=6)
_weights_var = register_var(
    "btl_tcp", "shape_weights", "8,4,1", typ=str,
    help="Deficit weights 'latency,normal,bulk' for the shaped drain "
         "(floor 1 each): the steady-state wire-byte ratio between "
         "backlogged classes", level=6)
_max_defer_var = register_var(
    "btl_tcp", "shape_max_defer_bytes", 4 << 20,
    help="Starvation bound: once other classes have sent this many "
         "bytes past a backlogged class's head frame, that class is "
         "served next regardless of deficit — BULK always progresses. "
         "0 disables the bound (pure weighted-deficit)", level=6)
_sndbuf_var = register_var(
    "btl_tcp", "sndbuf", 0,
    help="SO_SNDBUF for every tcp connection (reference: "
         "btl_tcp_sndbuf); 0 (default) = kernel default/autotuning. "
         "Bytes the kernel has accepted are beyond any send "
         "scheduler's reach, so with traffic shaping a bounded send "
         "buffer keeps scheduling authority at the btl's per-class "
         "queues instead of a deep autotuned kernel backlog", level=5)
_rcvbuf_var = register_var(
    "btl_tcp", "rcvbuf", 0,
    help="SO_RCVBUF for every tcp connection, applied before "
         "connect/listen so the TCP window scale reflects it "
         "(reference: btl_tcp_rcvbuf); 0 (default) = kernel default. "
         "Together with btl_tcp_sndbuf this bounds per-connection "
         "in-flight bytes — the A/B harness uses it to pin a "
         "deterministic wire bandwidth on loopback", level=5)

# ------------------------------------------------------ link reliability
_reliable_var = register_var(
    "btl_tcp", "reliable", 1,
    help="Self-healing links: CRC32-verified, ack'd-retransmit framing "
         "with transparent reconnect-and-replay when an ESTABLISHED "
         "connection fails. Negotiated per connection at the rank "
         "handshake — both sides must advertise; a reliable=0 peer "
         "interops at plain framing. 0 = legacy wire format, "
         "bit-identical to the pre-reliability build (the A/B "
         "baseline; btl_tcp_copy_mode=1 bench runs should also set 0 — "
         "legacy-datapath frames bypass the envelope and are not "
         "retained). With reliability on, one frame tops out at "
         "512 MiB instead of 2 GiB: length-word bits 29/30 become the "
         "envelope/control flags (see the framing guard in send())",
    level=4)
_retx_window_var = register_var(
    "btl_tcp", "retx_window_bytes", 8 << 20,
    help="Retained-frame budget per reliable connection: sent frames "
         "are kept for retransmission until cumulatively acked. On a "
         "HEALTHY link overflow evicts the oldest retained frame "
         "(tracked — a later resync that needs it escalates as "
         "disagreement); while DEGRADED the window is the replay "
         "guarantee, so overflow escalates to the failure path",
    level=5)
_retx_timeout_var = register_var(
    "btl_tcp", "retx_timeout_ms", 200.0, float,
    help="Oldest-unacked age past which the link timer retransmits the "
         "retained tail (the per-strike timeout grows; 3 strikes with "
         "no ack progress degrade the link — a half-open connection "
         "heals through redial, not blind retransmission). Also paces "
         "the receiver's periodic cumulative ack (at half this)",
    level=5)
_link_retries_var = register_var(
    "btl_tcp", "link_retries", 18,
    help="Redial attempts for a DEGRADED link before the redialer "
         "gives up (btl_tcp_link_deadline_s still bounds the total "
         "outage — both budgets bind, the utils/backoff contract)",
    level=5)
_link_backoff_var = register_var(
    "btl_tcp", "link_backoff_ms", 25.0, float,
    help="Base redial backoff for a DEGRADED link; doubles per attempt "
         "(2s cap) with +-50% jitter — the btl_tcp_backoff_ms schedule "
         "reused from utils/backoff", level=5)
_link_deadline_var = register_var(
    "btl_tcp", "link_deadline_s", 10.0, float,
    help="Total outage budget for a DEGRADED link: past it the link "
         "escalates to the pre-reliability failure path (mark_failed, "
         "dead conn, pml failover/dead-letter). Also bounds how long "
         "the outage refreshes the ft detector's heartbeat staleness "
         "on the peer's behalf", level=5)
_retx_adaptive_var = register_var(
    "btl_tcp", "retx_adaptive", 1,
    help="RTT-adaptive retransmit timer: once a conn holds >= "
         "btl_tcp_rtt_min_samples Karn-accepted RTT samples its "
         "effective timeout is min(btl_tcp_retx_timeout_ms, "
         "max(25ms floor, srtt + 4*rttvar)) — the fixed cvar becomes "
         "the CEILING, so a fast link retransmits in a few RTTs "
         "instead of waiting out a wan-sized constant while a slow "
         "link inflates past the constant and stops striking "
         "spuriously. 0 = fixed timer everywhere (the A/B baseline)",
    level=5)
_rtt_min_samples_var = register_var(
    "btl_tcp", "rtt_min_samples", 8,
    help="Karn-accepted RTT samples a conn must fold before the "
         "adaptive retransmit timer trusts its srtt/rttvar (below "
         "this the fixed btl_tcp_retx_timeout_ms applies)", level=6)

# adaptive-timer floor: below this the strike loop would outpace ack
# coalescing (receivers ack at timeout/2 or 8-frames/1MB, whichever
# first) and read its own batching as loss
_RETX_FLOOR_S = 0.025

# shaped-path counters + live queued-bytes-by-class gauges (plain int
# bumps like _ctr; the by-class gauges take _qlock because different
# conns bump them under different wlocks)
_shape_ctr = {"preempt": 0, "enqueued": 0}  # mpiracer: relaxed-counter — datapath bump discipline: single-op GIL adds, loss tolerated (the by-class gauges that need consistency take _qlock)
_qbytes = [0, 0, 0]   # queued bytes by class (qos.NORMAL/LATENCY/BULK)
_qpeak = [0, 0, 0]
_qlock = threading.Lock()

register_pvar("btl_tcp", "shape_queued_normal",
              lambda: _qbytes[_qos.NORMAL],
              help="Bytes currently queued in NORMAL-class send "
                   "sub-queues across all shaped connections")
register_pvar("btl_tcp", "shape_queued_latency",
              lambda: _qbytes[_qos.LATENCY],
              help="Bytes currently queued in LATENCY-class send "
                   "sub-queues across all shaped connections")
register_pvar("btl_tcp", "shape_queued_bulk",
              lambda: _qbytes[_qos.BULK],
              help="Bytes currently queued in BULK-class send "
                   "sub-queues across all shaped connections")
register_pvar("btl_tcp", "shape_peak_queued_normal",
              lambda: _qpeak[_qos.NORMAL],
              help="High-water mark of NORMAL-class queued bytes")
register_pvar("btl_tcp", "shape_peak_queued_latency",
              lambda: _qpeak[_qos.LATENCY],
              help="High-water mark of LATENCY-class queued bytes")
register_pvar("btl_tcp", "shape_peak_queued_bulk",
              lambda: _qpeak[_qos.BULK],
              help="High-water mark of BULK-class queued bytes")
register_pvar("btl_tcp", "shape_preemptions",
              lambda: _shape_ctr["preempt"],
              help="Frames the shaped drain served ahead of an "
                   "earlier-enqueued frame of another class (the "
                   "out-of-FIFO services the per-class scheduler "
                   "exists to make)")
register_pvar("btl_tcp", "shape_enqueued",
              lambda: _shape_ctr["enqueued"],
              help="Frames that took the shaped (backlogged) queue "
                   "path instead of the zero-copy direct send")

# mpitop/promexport read the by-class queue gauges as one sampler row
def register_shape_sampler() -> None:
    """(Re)bind the by-class queue sampler into the metrics registry —
    called at import; tests that reset the registry re-call it."""
    _metrics.register_sampler(
        "btl_tcp_shape_queued_bytes_by_class",
        lambda: {"latency": _qbytes[_qos.LATENCY],
                 "normal": _qbytes[_qos.NORMAL],
                 "bulk": _qbytes[_qos.BULK],
                 "peak_latency": _qpeak[_qos.LATENCY],
                 "peak_normal": _qpeak[_qos.NORMAL],
                 "peak_bulk": _qpeak[_qos.BULK]})


register_shape_sampler()

# strict-priority service preference inside one deficit round
_SERVICE_ORDER = (_qos.LATENCY, _qos.NORMAL, _qos.BULK)

_weights_memo: Optional[List[int]] = None


def _parse_weights(_var=None) -> None:
    global _weights_memo
    _weights_memo = None


watch_var("btl_tcp", "shape_weights", _parse_weights)


def _weights() -> List[int]:
    """[w_by_class_int]: cvar order is latency,normal,bulk; class ints
    are NORMAL=0/LATENCY=1/BULK=2. Floor 1 so every class drains."""
    global _weights_memo
    w = _weights_memo
    if w is None:
        parts = str(_weights_var._value).split(",")
        try:
            lat, norm, bulk = (max(int(p), 1) for p in parts[:3])
        except (ValueError, TypeError):
            lat, norm, bulk = 8, 4, 1
        w = [1, 1, 1]
        w[_qos.LATENCY], w[_qos.NORMAL], w[_qos.BULK] = lat, norm, bulk
        _weights_memo = w
    return w

# datapath counters (plain int bumps — no instrumentation framework on
# the per-frame path), exported as pvars below
_ctr = {"copied": 0, "writev": 0, "wire": 0}  # mpiracer: relaxed-counter — per-frame datapath counters; a lock per sendmsg would tax the wire path the zero-copy work just paid down

register_pvar("btl_tcp", "bytes_copied",
              lambda: _ctr["copied"],
              help="Payload/frame bytes the tcp datapath had to copy "
                   "(write-queue ownership under backpressure, rx "
                   "compaction/grow, legacy copy_mode re-adds)")
register_pvar("btl_tcp", "writev_calls",
              lambda: _ctr["writev"],
              help="Vectored sendmsg() syscalls issued by the write "
                   "path")
register_pvar("btl_tcp", "wire_bytes",
              lambda: _ctr["wire"],
              help="Frame bytes moved through the sockets (tx + rx), "
                   "the denominator of copies-per-wire-byte")

# link-reliability counters (same relaxed bump discipline as _ctr)
_lctr = {"recoveries": 0, "retransmits": 0, "crc_errors": 0,
         "dedup": 0, "released": 0}  # mpiracer: relaxed-counter — datapath/timer bumps from app + progress threads; pvar readers tolerate a stale view

register_pvar("btl_tcp", "link_recoveries",
              lambda: _lctr["recoveries"],
              help="Degraded links healed by reconnect-and-replay "
                   "(resync completed — the pml never saw the outage)")
register_pvar("btl_tcp", "retransmits",
              lambda: _lctr["retransmits"],
              help="Retained frames retransmitted (NACK, retransmit "
                   "timeout, or resync replay)")
register_pvar("btl_tcp", "crc_errors",
              lambda: _lctr["crc_errors"],
              help="Inbound reliable frames whose CRC32 check failed — "
                   "each NACKed a retransmission instead of desyncing "
                   "or killing the link")
register_pvar("btl_tcp", "link_dedup_frames",
              lambda: _lctr["dedup"],
              help="Inbound reliable frames discarded as duplicates by "
                   "link sequence (retransmit overlap — the receiver's "
                   "exactly-once guarantee to the pml)")
register_pvar("btl_tcp", "retx_released",
              lambda: _lctr["released"],
              help="Retained frames evicted UNACKED by window overflow "
                   "on a healthy link (a later resync that needs one "
                   "escalates as disagreement)")

# live transports for the link rollup (weak: test-built instances must
# not be pinned by the observability plane)
_live_btls: "weakref.WeakSet" = weakref.WeakSet()


def _link_rollup() -> dict:
    """Degraded-link / retained-frame rollup across live transports:
    mpitop's LNK column and the stall sentinel's pending probe. Reads
    are lock-free diagnostic snapshots — one torn sample skews one
    reading, never the link state itself."""
    degraded = frames = nbytes = 0
    for btl in list(_live_btls):
        if btl._closed:
            continue
        with btl._conn_lock:
            conns = list(btl.conns.values())
        for c in conns:
            if not c.rel or c.dead is not None:
                continue
            if c.state != "est":
                degraded += 1
            frames += len(c.retx)  # mpiracer: disable=cross-thread-race — lock-free diagnostic snapshot, see docstring
            nbytes += c.retx_bytes  # mpiracer: disable=cross-thread-race — lock-free diagnostic snapshot, see docstring
    return {"degraded_links": degraded, "retx_frames": frames,
            "retx_bytes": nbytes}


def register_link_sampler() -> None:
    """(Re)bind the link-health sampler (mpitop's LNK column) — called
    at import; tests that reset the metrics registry re-call it."""
    _metrics.register_sampler(
        "btl_tcp_link",
        lambda: dict(_link_rollup(),
                     recoveries=_lctr["recoveries"],
                     retransmits=_lctr["retransmits"],
                     crc_errors=_lctr["crc_errors"]))


register_link_sampler()


def _linkmodel_rows() -> list:
    """Per-conn estimator rows for the fabric-telemetry registry
    (runtime/linkmodel.py pulls these on its fold cadence). Lock-free
    diagnostic snapshot like _link_rollup: a torn read skews one fold,
    never the conn."""
    rows = []
    for btl in list(_live_btls):
        if btl._closed:
            continue
        with btl._conn_lock:
            conns = list(btl.conns.values())
        for c in conns:
            if not c.rel or c.dead is not None:
                continue
            oldest = 0.0
            try:  # mpiracer: disable=cross-thread-race — lock-free diagnostic snapshot, see docstring
                if c.retx:
                    oldest = max(
                        0.0, time.monotonic() - min(
                            ts for _, _, ts, _ in c.retx.values()))
            except (RuntimeError, ValueError):
                pass  # dict mutated mid-walk: skip the age this fold
            rows.append({
                "peer": c.peer,
                "state": c.state,
                "srtt": c.srtt,
                "rttvar": c.rttvar,
                "rtt_n": c.rtt_n,
                "acked_b": list(c.acked_b),
                "tx_frames": c.tx_seq,
                "rx_frames": c.rx_frames,
                "retx_n": c.retx_n,
                "nack_retx_n": c.nack_retx_n,
                "crc_errs": c.crc_errs,
                "dedup_n": c.dedup_n,
                "queue_age_s": oldest,
            })
    return rows


_linkmodel.register_source(_linkmodel_rows)

# a DEGRADED link is pending work (its retained frames complete only
# through heal-or-escalate): the stall sentinel must read a wedged heal
# as a stall — whose dump then carries the per-conn link evidence the
# btl.tcp provider exports — not as an idle process
_forensics.register_pending_probe(
    "btl.tcp.link", lambda: _link_rollup()["degraded_links"])

_LEN = struct.Struct("<I")

# receive staging block: sized for a full default rendezvous DATA frame
# (pml_frag_size 1 MiB + framing) so the common bulk frame fits without
# growing, shared by every TcpBtl through one mpool.BufferPool
_RX_BLOCK = (1 << 20) + (1 << 12)
_rx_pool = _mpool.BufferPool(_RX_BLOCK)

# rank-handshake capability bits + frame compression flag: compression
# rides the top bit of its u32 word (ranks and frame lengths stay
# < 2^30); the QoS bit advertises "my pml masks class bits from the
# kind byte and keys its sequence planes per (peer, class)" — every
# build with this code does, so like the compress bit it is advertised
# unconditionally and acked unconditionally. Shaping toward a peer
# that never acks (an older build) is documented-unsupported: its pml
# would reject class-stamped kind bytes, exactly like dialing a
# pre-compress acceptor.
_CAP_COMPRESS = 1 << 31
_CAP_QOS = 1 << 30
# link reliability: "my frames toward you will carry the reliability
# envelope, and I parse flagged frames from you" (gated on
# btl_tcp_reliable, unlike the unconditional decode-capability bits
# above — reliability changes MY wire format, not just my parser)
_CAP_RELIABLE = 1 << 29
# redial marker: this connection RESUMES an existing reliable link
# (the acceptor adopts the socket into the surviving conn and answers
# with a RESYNC exchange instead of building a fresh endpoint)
_CAP_RESYNC = 1 << 28
_ZFLAG = 1 << 31
_LEN_MASK = _ZFLAG - 1
# per-frame flags on a reliable link, interpreted only on connections
# whose handshake engaged reliability (rel_rx): bit 30 marks a
# link-control frame, bit 29 a reliability-enveloped data frame. A
# legacy (unflagged) frame stays parseable mid-stream — the
# copy_mode=1 datapath and the connector's pre-ack traffic ride it.
_LFLAG = 1 << 30
_RFLAG = 1 << 29
# reliable builds cap EVERY outbound frame here (512 MiB) so a legacy
# frame's length bits can never alias _LFLAG/_RFLAG on a reliable
# receiver — see the framing guard in send()
_RLEN_MASK = _RFLAG - 1
# acceptor's handshake ack: magic in the high byte + capability bits
_ZACK_MAGIC = 0x5A << 24
_ZACK_ACCEPT = 1
_ZACK_QOS = 2
_ZACK_RELIABLE = 4
_ZACK_WORDS = frozenset(
    _ZACK_MAGIC | a | q | r
    for a in (0, _ZACK_ACCEPT)
    for q in (0, _ZACK_QOS)
    for r in (0, _ZACK_RELIABLE))

# reliable data envelope, after the length word:
#   [u32 link seq][u32 cum ack][u32 crc32][hdr HDR_SIZE][payload]
# crc32 covers seq+ack+hdr+payload (the whole envelope: a corrupted
# piggyback ack must fail the check too). The frame is IMMUTABLE once
# built — retransmits resend it verbatim; the stale piggyback ack is
# harmless because acks are monotonic and the receiver takes the max.
_RELHDR = struct.Struct("<IIII")  # len|flags, seq, cum_ack, crc32
_RELSA = struct.Struct("<II")     # the crc'd seq+ack prefix
# link-control frame: [u32 _LFLAG|len][u32 crc32][u8 type][u32 a][u32 b]
#   ACK(cum_ack, 0)  NACK(rx_floor, 0)  RESYNC(rx_floor, tx_next)
# a control frame failing ITS crc is silently dropped (acks/nacks are
# re-generated by the timers; a lost RESYNC re-triggers redial)
_LCTL = struct.Struct("<BII")
_CTL_ACK, _CTL_NACK, _CTL_RESYNC = 1, 2, 3
_CTL_LEN = 4 + _LCTL.size  # crc word + body


def _compress_counters():
    """Wire-compression counters live in the quant plane (one
    observable subsystem for both reduced-precision paths)."""
    from ompi_tpu_torch import quant

    return quant.counters()


register_pvar("btl_tcp", "compress_ratio",
              lambda: (lambda c: round(c["wire_raw"] / c["wire_comp"], 4)
                       if c["wire_comp"] else 0.0)(_compress_counters()),
              help="Cumulative raw/compressed payload-byte ratio over "
                   "frames that went out zlib-compressed")
register_pvar("btl_tcp", "compress_saved_bytes",
              lambda: (lambda c: c["wire_raw"] - c["wire_comp"])(
                  _compress_counters()),
              help="Payload bytes kept off the wire by tcp compression")


def _apply_bufs(sock: socket.socket) -> None:
    """SO_SNDBUF/SO_RCVBUF bounds (btl_tcp_sndbuf/rcvbuf, 0 = kernel
    default) — called before connect/listen so TCP window scaling
    honors them."""
    snd = int(_sndbuf_var._value)
    rcv = int(_rcvbuf_var._value)
    try:
        if snd > 0:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_SNDBUF, snd)
        if rcv > 0:
            sock.setsockopt(socket.SOL_SOCKET, socket.SO_RCVBUF, rcv)
    except OSError:
        pass


def _corrupt_wire_copy(vecs: List) -> List:
    """Chaos harness (ft_inject ``corrupt``): flip one bit in a COPY of
    the frame's last vector (payload when present, else header) — the
    retained envelope stays clean, so retransmissions converge instead
    of resending the corruption forever. The length word (vecs[0]) is
    never touched: framing desync is outside this fault model — the
    injection corrupts CONTENT, not structure (a corrupted length word
    cannot be survived by any per-frame check; see the module doc)."""
    out = [bytes(v) for v in vecs]
    tail = bytearray(out[-1])  # mpilint: disable=hot-copy — fault-injection only (cold path); the copy is the point: the RETAINED envelope must stay clean so retransmits heal
    if tail:
        tail[len(tail) // 2] ^= 0x01
    out[-1] = bytes(tail)
    return out


class _Conn:
    __slots__ = ("sock", "rxb", "rstart", "rend", "wq", "wbuf", "rbuf",
                 "wlock", "peer", "dead", "peer_z", "await_ack",
                 "wqs", "cur", "cur_cls", "deficit", "defer", "peer_q",
                 "eseq", "last_rx", "last_tx",
                 # link reliability (btl_tcp_reliable)
                 "rel", "rel_rx", "state", "tx_seq", "tx_acked",
                 "tx_released", "retx", "retx_bytes", "rx_floor",
                 "rx_seen", "unacked_n", "unacked_b", "last_ack_tx",
                 "retx_strikes", "last_retx_t", "degraded_at",
                 "redial_deadline", "redial_n", "reconnects",
                 "crc_errs", "last_crc", "esc_eof",
                 # link telemetry (runtime/linkmodel.py + adaptive retx)
                 "srtt", "rttvar", "rtt_n", "karn", "acked_b",
                 "retx_n", "nack_retx_n", "dedup_n", "rx_frames")

    def __init__(self, sock: socket.socket, peer: Optional[int] = None):
        self.sock = sock
        # legacy concat queues, used ONLY under btl_tcp_copy_mode=1
        # (the bench A/B baseline) — empty otherwise
        self.wbuf = bytearray()
        self.rbuf = bytearray()
        # receive staging: a pooled block filled by recv_into, with the
        # unparsed span at [rstart, rend). Acquired lazily on first
        # drain, returned to the pool when the conn unregisters.
        self.rxb: Optional[bytearray] = None
        self.rstart = 0
        self.rend = 0
        # pending outbound buffers, drained by vectored sendmsg
        # (reference: btl/tcp's per-endpoint pending frag list flushed
        # on write-ready events). Entries are OWNED bytes-likes — a
        # borrowed payload view is copied exactly once, at the moment
        # the kernel declines it (buffered-send semantics: the caller
        # may reuse its buffer the instant send() returns).
        self.wq: deque = deque()
        # RLock: _conn_failed runs both under wlock (from _flush_locked)
        # and without it (from _drain's read-error path)
        self.wlock = threading.RLock()
        self.peer = peer
        self.dead: Optional[OSError] = None
        # negotiated at handshake: True once the peer advertised it
        # understands (and accepts) zlib-flagged frames on this link
        self.peer_z = False
        # connector side: an ack word is due before frame traffic; it is
        # consumed ASYNCHRONOUSLY by _drain (a blocking wait here could
        # deadlock two polling-only ranks dialing each other — each
        # stuck in its own handshake, neither accepting)
        self.await_ack = False
        # traffic shaping (btl_tcp_shape_enable): per-class send
        # sub-queues of (enqueue seq, nbytes, owned vec list, enq ts),
        # allocated lazily so unshaped conns pay one None slot; `cur`
        # is the partially-written frame that must finish before the
        # scheduler may switch class (TCP frames are contiguous on the
        # wire — preemption happens BETWEEN frames, which is why
        # oversized blobs are segmented upstream)
        self.wqs: Optional[tuple] = None
        self.cur: Optional[list] = None
        self.cur_cls = 0
        self.deficit = [0, 0, 0]
        self.defer = [0, 0, 0]
        # negotiated at handshake: peer masks QoS class bits and keys
        # its seq planes per class (every build with this code)
        self.peer_q = False
        self.eseq = 0
        # last wire activity (monotonic), stamped only while the
        # forensics plane is armed — dump evidence for "is this link
        # moving at all", not a live gauge
        self.last_rx: Optional[float] = None
        self.last_tx: Optional[float] = None
        # ---- link reliability (btl_tcp_reliable, handshake-engaged)
        # rel: WE envelope outbound frames; rel_rx: we interpret the
        # per-frame _RFLAG/_LFLAG bits on rx. The acceptor sets both at
        # accept; the connector on ack arrival — the split covers the
        # connector's pre-ack legacy frames interleaving on an engaged
        # acceptor (per-frame flags keep both parseable mid-stream).
        self.rel = False
        self.rel_rx = False
        # "est" | "degraded"; death stays in `dead` (the legacy field
        # every existing check keys off)
        self.state = "est"
        self.tx_seq = 0        # last link seq assigned to a sent frame
        self.tx_acked = 0      # highest cumulative ack from the peer
        self.tx_released = 0   # highest seq evicted from the window UNACKED
        # retained sent frames: seq -> (wire bytes, vec list, sent ts,
        # qos class); insertion-ordered = seq-ordered (seqs ascend)
        self.retx: Dict[int, tuple] = {}
        self.retx_bytes = 0
        self.rx_floor = 0      # contiguous inbound seqs delivered
        self.rx_seen: set = set()  # out-of-order seqs above the floor
        self.unacked_n = 0     # rx frames since our last cumulative ack
        self.unacked_b = 0
        self.last_ack_tx = 0.0
        self.retx_strikes = 0  # consecutive retx timeouts w/o ack progress
        self.last_retx_t = 0.0  # NACK-retransmit rate limit clock
        self.degraded_at = 0.0
        self.redial_deadline = 0.0
        self.redial_n = 0      # attempts in the CURRENT outage
        self.reconnects = 0    # lifetime successful resyncs
        self.crc_errs = 0
        self.last_crc: Optional[float] = None
        # was the interrupt that degraded this link an EOF? Escalation
        # preserves the pre-reliability semantics: EOF marked the peer
        # failed only under ft_enable; write errors unconditionally
        self.esc_eof = False
        # ---- link telemetry: Jacobson/Karn RTT off the ack clock
        # (always-on when reliable — the adaptive retransmit timer
        # needs it even with the linkmodel plane off), per-class acked
        # wire bytes (goodput = DELIVERED, not enqueued), and per-conn
        # loss attribution counters (the _lctr globals can't pin a
        # storm on an edge)
        self.srtt = 0.0
        self.rttvar = 0.0
        self.rtt_n = 0
        self.karn: set = set()  # seqs retransmitted: never RTT-sampled
        self.acked_b = [0, 0, 0]   # cumulative acked wire bytes by class
        self.retx_n = 0        # frames this conn retransmitted
        self.nack_retx_n = 0   # ...of which the peer NACKed (CRC reject
        # at the receiver: EVIDENCED wire corruption, unlike a timeout
        # retransmit, which may just be a slow ack)
        self.dedup_n = 0       # inbound duplicates this conn discarded
        self.rx_frames = 0     # reliable frames this conn delivered


class TcpBtl(Btl):
    bandwidth = 1  # stripe weight (reference: opal btl_bandwidth)

    NAME = "tcp"
    # fd-driven: the progress engine may park in select over idle_fds()
    # instead of polling this transport
    NEEDS_POLL = False

    def __init__(self, deliver: Callable[[bytes, bytes], None], my_rank: int):
        super().__init__(deliver)
        self.eager_limit = get_var("btl_tcp", "eager_limit")
        self.my_rank = my_rank
        self.log = get_logger("btl.tcp")
        host = get_var("btl_tcp", "bind_host")
        if not host:
            if os.environ.get("OMPI_TPU_MULTIHOST"):  # mpilint: disable=raw-environ — launcher topology hint, not MCA config
                host = "0.0.0.0"
            else:
                host = "127.0.0.1"
        bind = host
        if host == "0.0.0.0":
            # listen everywhere, advertise the best-scored non-loopback
            # address in the modex card (reference: opal/mca/reachable —
            # the endpoint blob carries routable addresses, see
            # ifaces.best_local_addr)
            from ompi_tpu_torch.runtime.ifaces import best_local_addr

            host = best_local_addr() or "127.0.0.1"
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        # buffer bounds inherit to accepted sockets; RCVBUF must be
        # set before listen so the window scale factor reflects it
        _apply_bufs(self.listener)
        self.listener.bind((bind, 0))
        self.listener.listen(64)
        self.listener.setblocking(False)
        self.host = host
        self.port = self.listener.getsockname()[1]
        self.peers: Dict[int, str] = {}
        self.conns: Dict[int, _Conn] = {}  # peer rank -> connection
        self._conn_lock = threading.Lock()
        self.sel = selectors.DefaultSelector()
        self.sel.register(self.listener, selectors.EVENT_READ,
                          ("accept", None))
        self._sel_lock = threading.Lock()
        # single-drainer: exactly one thread runs the event loop at a time
        # (the app thread's wait-loop and the progress thread both call
        # progress(); concurrent drains would interleave frame parsing)
        self._progress_lock = threading.Lock()
        self._closed = False
        # link-reliability timer pass (acks, retransmit timeouts,
        # degraded-link deadlines) runs from progress() on this cadence
        self._rel_next = 0.0
        _live_btls.add(self)  # link sampler / pending-probe rollup
        # stall-forensics provider (rebind-by-name: the live transport
        # wins; weakly bound so test-built instances don't pin)
        _forensics.register_weak_provider(
            "btl.tcp", self, alive=lambda btl: not btl._closed)

    # -------------------------------------------------- stall forensics
    def debug_state(self) -> dict:
        """Forensics provider: per-connection dial/established/dead
        state, per-class shaped queue depths with the oldest frame's
        age, the partially-written frame, partial-frame reassembly
        residue, and the last wire rx/tx stamps (populated while the
        forensics plane is armed). Each conn is snapshotted under its
        own wlock — the same lock every WRITE-queue mutation holds; the
        rx parser's span fields belong to the progress thread and are
        read lock-free and clamped."""
        now = time.monotonic()
        with self._conn_lock:
            conns = dict(self.conns)
        out = []
        for peer, conn in sorted(conns.items())[:_forensics.CAP]:
            # single reads + clamp: the rx parser advances these on the
            # progress thread outside wlock, and a torn pair (rend read
            # before a compaction, rstart after) must not record a
            # negative partial-frame size as evidence
            r0, r1 = conn.rstart, conn.rend  # mpiracer: disable=cross-thread-race — lock-free diagnostic snapshot, clamped below; taking the progress side's lock here could block a dump behind the wedged loop it is diagnosing
            with conn.wlock:
                ent: dict = {
                    "peer": peer,
                    "state": ("dead" if conn.dead is not None else
                              "degraded" if conn.state == "degraded"
                              else
                              "dialing" if conn.await_ack else
                              "established"),
                    "dead_reason": str(conn.dead) if conn.dead else None,
                    "wq_frames": len(conn.wq),
                    "wq_bytes": sum(len(b) for b in conn.wq),
                    "legacy_wbuf_bytes": len(conn.wbuf),
                    "rx_partial_bytes": max(0, r1 - r0),
                    "last_rx_age_s": None if conn.last_rx is None
                    else round(now - conn.last_rx, 3),
                    "last_tx_age_s": None if conn.last_tx is None
                    else round(now - conn.last_tx, 3),
                }
                if conn.rel or conn.rel_rx:
                    # per-link reliability evidence (mpidiag's LINK
                    # blame verdict reads this)
                    link: dict = {
                        "tx_seq": conn.tx_seq,
                        "tx_acked": conn.tx_acked,
                        "tx_released": conn.tx_released,
                        "retx_frames": len(conn.retx),
                        "retx_bytes": conn.retx_bytes,
                        "rx_floor": conn.rx_floor,
                        "rx_ooo": len(conn.rx_seen),
                        "reconnects": conn.reconnects,
                        "crc_errors": conn.crc_errs,
                        "last_crc_age_s": None if conn.last_crc is None
                        else round(now - conn.last_crc, 3),
                        # fabric telemetry (runtime/linkmodel.py):
                        # mpidiag's wire-bound verdict splits on these
                        "srtt_us": round(conn.srtt * 1e6, 1)
                        if conn.rtt_n else None,
                        "rttvar_us": round(conn.rttvar * 1e6, 1)
                        if conn.rtt_n else None,
                        "rtt_samples": conn.rtt_n,
                        "acked_bytes_by_class": {
                            _qos.NAMES[c]: conn.acked_b[c]
                            for c in range(3)},
                        # directional (linkmodel discipline): loss_ppm
                        # charges the outbound edge, and only counts
                        # NACK-evidenced retransmits (a CRC reject at
                        # the peer) — a timeout retransmit may just be
                        # a slow ack; the conn's own crc/dedup counts
                        # describe inbound frames
                        "loss_ppm": round(
                            1e6 * conn.nack_retx_n
                            / max(conn.tx_seq, 1), 1),
                        "rx_loss_ppm": round(
                            1e6 * (conn.crc_errs + conn.dedup_n)
                            / max(conn.rx_frames, 1), 1),
                    }
                    if conn.retx:
                        oldest = next(iter(conn.retx.values()))
                        link["retx_oldest_age_s"] = round(
                            now - oldest[2], 3)
                    if conn.state == "degraded":
                        link["degraded_s"] = round(
                            now - conn.degraded_at, 3)
                        link["redial_attempts"] = conn.redial_n
                        link["redial_budget"] = int(
                            _link_retries_var._value)
                        link["deadline_in_s"] = round(
                            conn.redial_deadline - now, 3)
                    ent["link"] = link
                if conn.cur is not None:
                    ent["in_progress_frame"] = {
                        "cls": _qos.NAMES.get(conn.cur_cls,
                                              conn.cur_cls),
                        "bytes_left": sum(len(v) for v in conn.cur)}
                if conn.wqs is not None:
                    shaped = {}
                    for c in _SERVICE_ORDER:
                        dq = conn.wqs[c]
                        if not dq:
                            continue
                        shaped[_qos.NAMES[c]] = {
                            "frames": len(dq),
                            "bytes": sum(e[1] for e in dq),
                            "oldest_age_s": round(now - dq[0][3], 3),
                            "deferred_bytes": conn.defer[c]}
                    if shaped:
                        ent["shaped_queues"] = shaped
            out.append(ent)
        return {
            "rank": self.my_rank,
            "listen": f"{self.host}:{self.port}",
            "closed": self._closed,
            "conns": out,
            "conns_omitted": max(0, len(conns) - len(out)),
            "queued_by_class": {"latency": _qbytes[_qos.LATENCY],
                                "normal": _qbytes[_qos.NORMAL],
                                "bulk": _qbytes[_qos.BULK]},
        }

    # ------------------------------------------------------------- wiring
    def set_peers(self, peers: Dict[int, str]) -> None:
        self.peers = dict(peers)

    def _connect(self, peer: int) -> _Conn:
        addr = self.peers[peer]
        host, port = addr.rsplit(":", 1)
        # multi-homed hosts: dial from the best-weighted local interface
        # for this peer (reference: opal/mca/reachable weighted scoring)
        from ompi_tpu_torch.runtime.ifaces import pick_source

        try:
            src = pick_source(socket.gethostbyname(host))
        except OSError:
            src = None
        # Bounded establishment retry with exponential backoff + jitter
        # (reference: the endpoint connect retry of btl/tcp): a peer
        # mid-restart or briefly overloaded must not fail the link on
        # the first ECONNREFUSED, and a herd of ranks redialing must
        # not synchronize. BOTH bounds apply — attempt count AND a 30s
        # total deadline (the pre-retry behavior): a SYN-blackholed
        # peer burning full per-attempt timeouts must not stretch the
        # failure to attempts * timeout. Exhaustion raises to the pml
        # failover path. The schedule itself (doubling, 2s cap, ±50%
        # jitter, deadline clamp) lives in utils/backoff — the link
        # redial reuses it verbatim.
        sched = _backoff.Schedule(
            base_s=float(get_var("btl_tcp", "backoff_ms")) / 1000.0,
            cap_s=2.0,
            retries=int(get_var("btl_tcp", "retries")),
            deadline_s=30.0)
        while True:
            left = sched.remaining()
            try:
                # manual socket (vs create_connection) so the
                # btl_tcp_sndbuf/rcvbuf bounds are applied BEFORE the
                # handshake — the window scale is negotiated at SYN
                s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
                try:
                    _apply_bufs(s)
                    s.settimeout(max(min(10.0, left), 1.0))
                    if src:
                        s.bind((src, 0))
                    s.connect((host, int(port)))
                except BaseException:
                    s.close()  # a failed attempt must not leak the fd
                    raise
                s.settimeout(None)
                break
            except OSError as e:
                delay = sched.next_delay()
                if delay is None:
                    self.log.error(
                        "connect to rank %s (%s) failed after %d "
                        "attempts: %s", peer, addr, sched.attempt + 1, e)
                    raise
                from ompi_tpu_torch.runtime import spc

                spc.record("btl_tcp_connect_retries")
                time.sleep(delay)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        conn = _Conn(s, peer)
        # identify ourselves so the acceptor can map conn -> rank. The
        # capability bit means "I can DECODE zlib-flagged frames" (every
        # build with this code can), NOT "I will compress" — advertising
        # it unconditionally keeps engagement symmetric: whether a
        # compress-enabled peer may flag frames to us must not depend on
        # which side happened to dial first (gating the bit on our own
        # compress level silently disabled the feature whenever the
        # compress=0 side connected first). The acceptor answers with an
        # ack word, consumed asynchronously by _drain — sends stay
        # uncompressed on this link until it lands, so a peer that never
        # acks (a build without this framing) simply keeps the link at
        # plain framing. The QoS capability bit rides along identically
        # (shaped per-class scheduling engages only after the peer acks
        # it — frames sent before the ack drain FIFO). The RELIABLE bit
        # is the one capability gated on its cvar rather than advertised
        # unconditionally: engaging it changes OUR wire format, so
        # btl_tcp_reliable=0 must keep the link bit-identical legacy.
        caps = _CAP_COMPRESS | _CAP_QOS
        if _reliable_var._value:
            caps |= _CAP_RELIABLE
        s.sendall(_LEN.pack(self.my_rank | caps))
        conn.await_ack = True
        s.setblocking(False)
        with self._sel_lock:
            self.sel.register(s, selectors.EVENT_READ, ("peer", conn))
        return conn

    def _get_conn(self, peer: int) -> _Conn:
        with self._conn_lock:
            conn = self.conns.get(peer)
            if conn is None:
                conn = self._connect(peer)
                self.conns[peer] = conn
            return conn

    # --------------------------------------------------------------- send
    def send(self, peer: int, header: bytes, payload) -> None:
        """Vectored zero-copy enqueue: the frame is pushed as
        [length word, header, payload view] via sendmsg with NO
        intermediate materialization; only bytes the kernel declines
        are copied into the owned write queue (buffered-send semantics
        — the caller may reuse its buffer the moment we return). Never
        blocks the caller on a full socket — the head-to-head
        large-send deadlock the reference's pending-frag design exists
        to avoid."""
        payload = host_bytes(payload)  # a CPU tensor as its bytes
        if isinstance(payload, bytes):
            mv = payload  # immutable: safe to queue without owning
        else:
            mv = memoryview(payload)
            if mv.ndim != 1 or mv.format != "B" or not mv.c_contiguous:
                try:
                    mv = mv.cast("B")
                except TypeError:
                    # non-contiguous source: ownership copy is forced
                    _ctr["copied"] += mv.nbytes
                    mv = bytes(mv)  # mpilint: disable=hot-copy — non-contiguous buffers cannot be viewed flat
        nbytes = len(mv)
        if HDR_SIZE + nbytes > _LEN_MASK:
            # absolute cap, checked BEFORE the conn lookup: an
            # oversized frame must raise loudly even toward a peer
            # this btl has no address for yet
            from ompi_tpu_torch.core.errors import MPIError, ERR_OTHER

            raise MPIError(
                ERR_OTHER,
                f"tcp frame of {HDR_SIZE + nbytes} bytes exceeds "
                f"the {_LEN_MASK}-byte framing limit")
        conn = self._get_conn(peer)
        limit = _RLEN_MASK if (conn.rel or _reliable_var._value) \
            else _LEN_MASK
        if HDR_SIZE + nbytes > limit:
            # bit 31 of the length word carries the compression flag,
            # so one legacy frame tops out at 2 GiB; with link
            # reliability on (negotiated on this conn, or merely
            # enabled — a peer may engage rel_rx before our handshake
            # ack lands) bits 30/29 become the control/envelope flags
            # too, halving twice to 512 MiB. Beyond the cap the
            # receiver would mask a wrong length AND misparse the flag
            # bits — fail loudly here instead (callers shipping blobs
            # that large must split them)
            from ompi_tpu_torch.core.errors import MPIError, ERR_OTHER

            raise MPIError(
                ERR_OTHER,
                f"tcp frame of {HDR_SIZE + nbytes} bytes exceeds "
                f"the {limit}-byte framing limit")
        drop = dup = corrupt = False
        sent_at = None
        if _inject._enable_var._value:  # chaos wire hook (ft/inject.py)
            # an injected delay() sleeps INLINE right here, before the
            # envelope stamps its retention instant — stamp the send
            # instant first so the chaos latency lands inside the RTT
            # sample, exactly as a slow wire would
            sent_at = time.monotonic()
            verdict = _inject.wire_send(self.my_rank, peer)
            if verdict:
                if verdict & _inject.SEVER:
                    err = ConnectionResetError(
                        "link severed by ft_inject_plan")
                    if conn.rel and verdict & _inject.TRANSIENT:
                        # recoverable outage: the link DEGRADES — this
                        # frame is retained below and replayed at
                        # resync (the self-healing under test)
                        self._conn_failed(conn, err)
                    elif conn.rel:
                        # permanent sever on a reliable link: skip the
                        # degrade window, straight to the legacy death
                        self._link_escalate(conn, err)
                    else:
                        self._conn_failed(conn, err)
                    # legacy/escalated: the dead-check below raises
                if verdict & _inject.DROP:
                    if not conn.rel:
                        return  # legacy drop: the frame just vanishes
                    # reliable drop: retain but skip the transmit — the
                    # retransmit timer heals the hole
                    drop = True
                dup = bool(verdict & _inject.DUP)
                corrupt = bool(verdict & _inject.CORRUPT)
        zflag = 0
        level = int(_compress_var._value)  # one live-Var load when off
        if level > 0 and conn.peer_z and \
                nbytes >= int(_compress_min_var._value):
            z = zlib.compress(mv, level)
            if len(z) < nbytes:  # incompressible data stays raw
                from ompi_tpu_torch import quant as _quant

                _quant.note_wire(nbytes, len(z))
                mv = z
                nbytes = len(z)
                zflag = _ZFLAG
        lenw = _LEN.pack((HDR_SIZE + nbytes) | zflag)
        if nbytes:
            vecs: List = [lenw, header, mv]
        else:
            vecs = [lenw, header]
        if corrupt and not conn.rel:
            # historical hazard, preserved for the A/B contrast: a
            # corrupted legacy frame is delivered as garbage (or kills
            # the link, if compressed) — there is no CRC to catch it.
            # Only a wire COPY is corrupted; the caller's buffer stays
            # clean either way.
            vecs = _corrupt_wire_copy(vecs)
            if len(vecs) > 2:
                mv = vecs[2]
            else:
                header = vecs[1]
        if dup and not conn.rel:
            vecs = vecs + vecs
        with conn.wlock:
            # dead-check under wlock: _conn_failed flips dead/clears the
            # write queue under the same lock, so a frame can't slip
            # past the check into a cleared queue
            if conn.dead is not None:
                self._raise_dead(conn)
            if _copy_mode_var._value:
                # legacy A/B datapath: bypasses the reliability
                # envelope by design — per-frame flags keep an engaged
                # peer's parser happy, but these frames are NOT
                # retained (the reliable cvar help tells copy_mode
                # bench runs to set reliable=0)
                self._send_legacy(conn, lenw, header, mv, dup)
                return
            if conn.rel:
                cls = header[0] >> QOS_SHIFT
                txv = self._rel_envelope(conn, header, mv, nbytes,
                                         zflag, cls, sent_at)
                self._evict_window(conn)
                if conn.dead is not None:
                    # window overflow while degraded escalated inline
                    self._raise_dead(conn)
                if drop or conn.state != "est":
                    # retained, not transmitted: a degraded link
                    # replays at resync; an injected drop heals via
                    # the retransmit timer
                    return
                wire = _corrupt_wire_copy(txv) if corrupt else list(txv)
                if dup:
                    wire += list(txv)
                self._rel_transmit(conn, wire, cls)
            elif _qos._enable_var._value and conn.peer_q:
                # shaped path: per-class sub-queues drained by the
                # weighted-deficit scheduler (poke below still runs —
                # a backlog may have been queued)
                self._send_shaped(conn, vecs, header[0] >> QOS_SHIFT)
            else:
                if conn.cur is not None or \
                        (conn.wqs is not None and any(conn.wqs)):
                    # shaped residue after a shape_enable flip: older
                    # frames must hit the wire first
                    self._fold_shaped_residue(conn)
                if conn.wbuf:
                    # legacy residue after a copy_mode flip: older
                    # frames must hit the wire first
                    conn.wq.append(bytes(conn.wbuf))
                    conn.wbuf.clear()
                backlog = bool(conn.wq)
                if not backlog:
                    # fast path: push straight from the caller's buffer
                    vecs = self._try_send(conn, vecs)
                    if not vecs:
                        return  # fully on the wire (or conn failed): 0 copies
                # backpressure: own the unsent remainder — the ONE copy
                # the zero-copy path ever pays, and only for bytes the
                # kernel would not take now
                for v in vecs:
                    if isinstance(v, memoryview):
                        _ctr["copied"] += len(v)
                        v = bytes(v)
                    conn.wq.append(v)
                if backlog:
                    self._flush_locked(conn)
                else:
                    self._want_write(conn, True)
        # a backlog was (or may still be) queued: wake a progress loop
        # parked in the idle select so the flush doesn't wait out the
        # park interval — the park's write-fd list was computed before
        # this conn wanted write
        from ompi_tpu_torch.runtime import progress as _progress

        _progress.poke()

    def _fold_wq_legacy(self, conn: _Conn) -> None:
        """Vectored residue after a copy_mode flip: fold the deque into
        the legacy concat queue, oldest first. Caller holds wlock."""
        while conn.wq:
            conn.wbuf += conn.wq.popleft()  # mpilint: disable=hot-copy — mode-flip bridge into the legacy A/B queue

    def _send_legacy(self, conn: _Conn, lenw: bytes, header: bytes,
                     mv, dup: bool) -> None:
        """The pre-vectored datapath, verbatim (btl_tcp_copy_mode=1,
        the bench A/B baseline): unconditional eager-payload copy,
        frame concat, bytes-concat queue append, byte-wise flush. The
        copies feed btl_tcp_bytes_copied so copies-per-wire-byte is
        MEASURED on the real legacy code, not modeled. Caller holds
        conn.wlock and has done the dead-check."""
        if conn.cur is not None or \
                (conn.wqs is not None and any(conn.wqs)):
            # shaped residue after a copy_mode flip: a partially-written
            # shaped frame MUST finish (and older shaped frames must
            # drain) before legacy bytes hit the wire, or the stream
            # desyncs / same-class frames overtake their seqs
            self._fold_shaped_residue(conn)
        payload = bytes(mv)  # the old eager copy  # mpilint: disable=hot-copy — legacy A/B path reproduces the old copies on purpose
        frame = lenw + header + payload
        _ctr["copied"] += len(payload) + len(frame)
        self._fold_wq_legacy(conn)
        conn.wbuf += frame  # mpilint: disable=hot-copy — legacy A/B path reproduces the old concat queue on purpose
        _ctr["copied"] += len(frame)
        if dup:
            conn.wbuf += frame  # mpilint: disable=hot-copy — legacy A/B path
            _ctr["copied"] += len(frame)
        self._flush_legacy(conn)

    def _flush_legacy(self, conn: _Conn) -> None:
        """The pre-vectored flush: byte-wise send + O(n) front-trim of
        the concat queue (O(n^2) across a backlog — the measured tax).
        Caller holds conn.wlock."""
        if conn.cur is not None or \
                (conn.wqs is not None and any(conn.wqs)):
            # shaped residue after a copy_mode flip: ordered first
            self._fold_shaped_residue(conn)
        self._fold_wq_legacy(conn)
        while conn.wbuf:
            try:
                sent = conn.sock.send(conn.wbuf)
            except socket.error as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    self._want_write(conn, True)
                    return
                self._conn_failed(conn, e)
                return
            if sent <= 0:
                self._want_write(conn, True)
                return
            _ctr["wire"] += sent
            if _forensics._enable_var._value:  # last-tx dump evidence
                conn.last_tx = time.monotonic()
            del conn.wbuf[:sent]
        self._want_write(conn, False)

    def _try_send(self, conn: _Conn, vecs: List) -> List:
        """Vectored push of ``vecs`` until the socket blocks; returns
        the unsent remainder as views (the caller owns copying them).
        Caller holds conn.wlock. On a fatal error the conn is failed
        and [] returned — the bytes are lost and the NEXT send to this
        peer raises (same contract as the old flush path)."""
        max_vecs = int(_vecs_var._value)
        while vecs:
            try:
                sent = conn.sock.sendmsg(vecs[:max_vecs])
            except socket.error as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    return vecs
                # Fatal send error: queued (and eagerly-completed) bytes
                # are lost. Surface it — mark the conn dead, tell the
                # failure detector, fail future sends.
                self._conn_failed(conn, e)
                return []
            if sent <= 0:
                return vecs
            _ctr["writev"] += 1
            _ctr["wire"] += sent
            if _forensics._enable_var._value:  # last-tx dump evidence
                conn.last_tx = time.monotonic()
            while sent:
                l0 = len(vecs[0])
                if sent >= l0:
                    sent -= l0
                    vecs.pop(0)
                else:
                    # O(1) partial-consume: slice the view, no copy
                    vecs[0] = memoryview(vecs[0])[sent:]
                    sent = 0
        return vecs

    def _raise_dead(self, conn: _Conn) -> None:
        """Raise the dead-conn error for a send. ULFM class when the
        failure detector confirmed the peer's death — user recovery
        code keys off this code."""
        from ompi_tpu_torch.core.errors import (MPIError, ERR_OTHER,
                                          ERR_PROC_FAILED)
        from ompi_tpu_torch.ft.detector import known_failed

        code = ERR_PROC_FAILED if conn.peer in known_failed() \
            else ERR_OTHER
        raise MPIError(
            code,
            f"connection to rank {conn.peer} is dead: {conn.dead}")

    # --------------------------------------------------- link reliability
    # btl_tcp_reliable=1 (handshake-engaged): every data frame out of
    # send() is wrapped in the _RELHDR envelope and RETAINED until the
    # peer's cumulative ack covers it; the receive side verifies CRC,
    # dedups by link seq and NACKs holes; a failed ESTABLISHED conn
    # degrades (redial + resync + replay) instead of dying. The methods
    # below are that whole state machine.
    def _rel_envelope(self, conn: _Conn, header, mv, nbytes: int,
                      zflag: int, cls: int,
                      sent_at: Optional[float] = None) -> List:
        """Build + RETAIN one immutable reliable envelope; returns its
        vec list. Caller holds conn.wlock (seq assignment must be
        atomic with transmit order). Ownership copies happen here: the
        retained frame must outlive the caller's buffer no matter what
        the kernel takes now, so this path trades the zero-copy fast
        path's deferred copy for an up-front one (charged to
        btl_tcp_bytes_copied — the A/B delta vs reliable=0 measures
        the reliability tax honestly)."""
        if not isinstance(header, bytes):
            header = bytes(header)
        if isinstance(mv, memoryview):
            _ctr["copied"] += nbytes
            mv = bytes(mv)  # mpilint: disable=hot-copy — retention ownership: the retransmit window outlives the caller's buffer
        conn.tx_seq += 1
        seq = conn.tx_seq
        ack = conn.rx_floor
        # CRC over the WHOLE envelope after the length word (seq, ack,
        # header, payload): a corrupted piggyback ack must fail the
        # check too, not silently release retained frames
        crc = zlib.crc32(header, zlib.crc32(_RELSA.pack(seq, ack)))
        if nbytes:
            crc = zlib.crc32(mv, crc)
        head = _RELHDR.pack((12 + HDR_SIZE + nbytes) | zflag | _RFLAG,
                            seq, ack, crc & 0xFFFFFFFF)
        vecs: List = [head, header, mv] if nbytes else [head, header]
        wire = 4 + 12 + HDR_SIZE + nbytes
        # sent_at: send() pre-stamps before the chaos inject hook (an
        # injected delay() sleeps inline there, and that latency must
        # land inside the RTT sample like a slow wire's would)
        conn.retx[seq] = (wire, vecs,
                          time.monotonic() if sent_at is None
                          else sent_at, cls)
        conn.retx_bytes += wire
        return vecs

    def _evict_window(self, conn: _Conn) -> None:
        """Bound the retained-frame window (btl_tcp_retx_window_bytes).
        Healthy link: evict oldest unacked, remembering the high-water
        released seq — a later resync that needs it escalates as
        disagreement. Degraded link: the window IS the replay
        guarantee, so overflow escalates now. Caller holds wlock."""
        window = int(_retx_window_var._value)
        if conn.retx_bytes <= window:
            return
        if conn.state != "est":
            self._link_escalate(conn, OSError(
                f"retransmit window overflow ({conn.retx_bytes} bytes "
                f"retained) while link degraded"))
            return
        while conn.retx_bytes > window and len(conn.retx) > 1:
            seq = next(iter(conn.retx))
            nb = conn.retx.pop(seq)[0]
            conn.karn.discard(seq)
            conn.retx_bytes -= nb
            if seq > conn.tx_released:
                conn.tx_released = seq
            _lctr["released"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view

    def _rel_transmit(self, conn: _Conn, vecs: List, cls: int) -> None:
        """Route one already-OWNED frame (envelope, control, or
        retransmit) to the wire through the same scheduling the data
        path uses — shaped per-class when QoS is engaged (control
        frames ride LATENCY), plain FIFO otherwise. Folding into the
        plain queue while a shaped backlog exists would destroy the
        scheduler's ordering, hence the mirror of send()'s routing.
        Caller holds conn.wlock and has done the dead-check."""
        if _qos._enable_var._value and conn.peer_q:
            self._send_shaped(conn, vecs, cls)
            return
        if conn.cur is not None or \
                (conn.wqs is not None and any(conn.wqs)):
            # shaped residue after a shape_enable flip: ordered first
            self._fold_shaped_residue(conn)
        if conn.wbuf:
            conn.wq.append(bytes(conn.wbuf))
            conn.wbuf.clear()
        backlog = bool(conn.wq)
        if not backlog:
            vecs = self._try_send(conn, vecs)
            if not vecs:
                return
        for v in vecs:
            if isinstance(v, memoryview):
                v = bytes(v)
            conn.wq.append(v)
        if backlog:
            self._flush_locked(conn)
        else:
            self._want_write(conn, True)

    def _send_ctrl(self, conn: _Conn, typ: int, a: int, b: int) -> None:
        """Emit one link-control frame (ACK/NACK/RESYNC). Dropped
        silently on a dead or degraded link — control state is
        re-derived after resync, and control frames are never
        retained."""
        with conn.wlock:
            if conn.dead is not None or conn.state != "est":
                return
            body = _LCTL.pack(typ, a & 0xFFFFFFFF, b & 0xFFFFFFFF)
            frame = _RELSA.pack(_LFLAG | _CTL_LEN,
                                zlib.crc32(body) & 0xFFFFFFFF) + body
            self._rel_transmit(conn, [frame], _qos.LATENCY)

    def _rel_send_ack(self, conn: _Conn) -> None:
        """Cumulative ack (cadence or timer). Runs only under the
        progress engine's single-drainer exclusivity — the unacked
        counters are touched by no other thread."""
        conn.unacked_n = 0
        conn.unacked_b = 0
        conn.last_ack_tx = time.monotonic()
        self._send_ctrl(conn, _CTL_ACK, conn.rx_floor, 0)

    def _rel_ack_rx(self, conn: _Conn, ackv: int) -> None:
        """Cumulative-ack bookkeeping (piggyback, ACK, NACK and RESYNC
        floors all funnel here): release retained frames at or below
        ``ackv``. The lock-free pre-check keeps the per-frame rx cost
        at one compare when the ack is stale."""
        if ackv <= conn.tx_acked:  # mpiracer: disable=cross-thread-race — monotonic-int pre-check; the locked re-check below decides
            return
        sample = None
        with conn.wlock:
            if ackv <= conn.tx_acked:
                return
            conn.tx_acked = ackv
            retx = conn.retx
            now = time.monotonic()
            for seq in [s for s in retx if s <= ackv]:
                wire, _vecs, ts, cls = retx.pop(seq)
                conn.retx_bytes -= wire
                conn.acked_b[cls] += wire  # DELIVERED bytes: goodput
                if seq in conn.karn:
                    # Karn: an ack after a retransmission is ambiguous
                    # about which copy it acknowledges — never sample
                    conn.karn.discard(seq)
                else:
                    # one cumulative ack releases a batch; the
                    # youngest released frame carries the least
                    # ack-coalescing delay, so it is the sample
                    sample = now - ts
            conn.retx_strikes = 0  # ack progress resets the timer
            if sample is not None and sample >= 0.0:
                # Jacobson/Karn fold (RFC 6298 constants), kept on the
                # conn: the adaptive retransmit timer reads it even
                # with the linkmodel plane off
                if conn.rtt_n == 0:
                    conn.srtt = sample
                    conn.rttvar = sample / 2.0
                else:
                    d = sample - conn.srtt
                    conn.srtt += 0.125 * d
                    conn.rttvar += 0.25 * (abs(d) - conn.rttvar)
                conn.rtt_n += 1
        if sample is not None and sample >= 0.0 \
                and _linkmodel._enable_var._value:
            _linkmodel.note_rtt_sample(conn.peer, sample)

    def _rel_retransmit(self, conn: _Conn) -> None:
        """NACK service: retransmit every retained frame in seq order
        (sender-side go-back-N — the receiver's dedup makes overlap
        free and the window bound keeps the tail small). Rate-limited:
        a burst of NACKs from one corruption storm must not multiply
        the resend."""
        now = time.monotonic()
        with conn.wlock:
            if conn.dead is not None or conn.state != "est" \
                    or not conn.retx:
                return
            if now - conn.last_retx_t < 0.02:
                return  # this storm already triggered a resend
            conn.last_retx_t = now
            for seq in list(conn.retx):
                if conn.dead is not None or conn.state != "est":
                    break  # a transmit failure degraded us mid-loop
                nb, vecs, _ts, cls = conn.retx[seq]
                conn.retx[seq] = (nb, vecs, now, cls)  # re-age
                conn.karn.add(seq)  # Karn: never RTT-sample this seq
                conn.retx_n += 1
                conn.nack_retx_n += 1
                _lctr["retransmits"] += 1
                self._rel_transmit(conn, list(vecs), cls)

    def _rel_ctrl_rx(self, conn: _Conn, body) -> None:
        """Parse one link-control frame body:
        [u32 crc32][u8 type][u32 a][u32 b]. A control frame failing
        its own CRC is silently dropped (counted): acks and nacks
        regenerate on the timers, and a lost RESYNC re-triggers the
        redial."""
        if len(body) != _CTL_LEN:
            conn.crc_errs += 1
            conn.last_crc = time.monotonic()
            _lctr["crc_errors"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view
            return
        crc = _LEN.unpack_from(body, 0)[0]
        if zlib.crc32(body[4:]) & 0xFFFFFFFF != crc:
            conn.crc_errs += 1
            conn.last_crc = time.monotonic()
            _lctr["crc_errors"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view
            return
        typ, a, b = _LCTL.unpack_from(body, 4)
        if typ == _CTL_ACK:
            self._rel_ack_rx(conn, a)
        elif typ == _CTL_NACK:
            self._rel_ack_rx(conn, a)  # the floor is a cumulative ack
            self._rel_retransmit(conn)
        elif typ == _CTL_RESYNC:
            self._rel_resync_rx(conn, a, b)

    def _resync_frame(self, conn: _Conn) -> bytes:
        """RESYNC control frame: my cumulative rx floor (an ack for
        everything I hold) + the next seq I will send. The reads are
        lock-free on purpose — a slightly stale floor only makes the
        peer replay more, which the dedup absorbs."""
        body = _LCTL.pack(
            _CTL_RESYNC,
            conn.rx_floor & 0xFFFFFFFF,  # mpiracer: disable=cross-thread-race — stale floor over-replays, dedup absorbs (see docstring)
            (conn.tx_seq + 1) & 0xFFFFFFFF)  # mpiracer: disable=cross-thread-race — see docstring
        return _RELSA.pack(_LFLAG | _CTL_LEN,
                           zlib.crc32(body) & 0xFFFFFFFF) + body

    def _rel_resync_rx(self, conn: _Conn, peer_floor: int,
                       peer_tx_next: int) -> None:
        """Resync exchange on a (re)connected reliable link: the peer
        reports its cumulative rx floor (acking everything it has) and
        the next seq it will send. Agreement → release the acked tail,
        replay everything still retained, back to ESTABLISHED — the
        pml never saw the outage. Disagreement — the peer needs a
        frame the healthy-link window already evicted, or it resumes
        below our delivered floor (a restarted peer) — is
        unrecoverable stream damage: escalate to the legacy failure
        path."""
        esc: Optional[OSError] = None
        restored = False
        with conn.wlock:
            if conn.dead is not None or not conn.rel:
                return
            self._rel_ack_rx(conn, peer_floor)
            if peer_floor < conn.tx_released:
                esc = OSError(
                    f"resync disagreement: peer acked {peer_floor} "
                    f"but unacked frames through {conn.tx_released} "
                    f"were already evicted from the window")
            elif peer_tx_next and peer_tx_next - 1 < conn.rx_floor:
                esc = OSError(
                    f"resync disagreement: peer resumes at seq "
                    f"{peer_tx_next} below our delivered floor "
                    f"{conn.rx_floor} (restarted peer?)")
            else:
                was_degraded = conn.state == "degraded"
                redials = conn.redial_n
                conn.state = "est"
                conn.esc_eof = False
                conn.retx_strikes = 0
                conn.last_retx_t = 0.0
                conn.redial_n = 0
                # queued wire copies raced the old socket and are
                # stale; every frame that matters is in retx
                conn.wq.clear()
                conn.wbuf.clear()
                self._drop_shaped(conn)
                now = time.monotonic()
                replayed = len(conn.retx)
                for seq in list(conn.retx):
                    if conn.dead is not None or conn.state != "est":
                        break  # transmit failure re-degraded us
                    nb, vecs, _ts, cls = conn.retx[seq]
                    conn.retx[seq] = (nb, vecs, now, cls)
                    conn.karn.add(seq)  # replay = retransmit: no sample
                    conn.retx_n += 1
                    _lctr["retransmits"] += 1
                    self._rel_transmit(conn, list(vecs), cls)
                self._rel_send_ack(conn)
                if was_degraded and conn.state == "est":
                    restored = True
                    _lctr["recoveries"] += 1
                    outage = now - conn.degraded_at
                    if _metrics._enable_var._value:
                        _metrics.observe("btl_tcp_link_outage_us",
                                         outage * 1e6)
                    if _trace.enabled():
                        _trace.instant("btl_tcp.link_restored",
                                       cat="btl", peer=conn.peer,
                                       outage_s=round(outage, 4))
                    self.log.warning(
                        "link to rank %s restored after %.3fs "
                        "(%d redial(s), %d frame(s) replayed)",
                        conn.peer, outage, redials, replayed)
        if esc is not None:
            self._link_escalate(conn, esc)
            return
        if restored:
            from ompi_tpu_torch.ft.detector import note_link_restored

            note_link_restored(conn.peer,
                               link=self._conn_link_stats(conn))
            cb = self.link_restored_cb
            if cb is not None:
                # pml dead-letter replay seam (wireup binds it): frames
                # the pml stashed while this link looked dead go back
                # on the wire now
                try:
                    cb(conn.peer)
                except Exception:
                    self.log.exception("link_restored callback failed")

    def _conn_failed(self, conn: _Conn, err: OSError,
                     eof: bool = False) -> None:
        """A connection died under traffic. On a reliability-engaged
        ESTABLISHED link this is an INTERRUPT — degrade and redial;
        the pml never hears about it unless healing fails
        (_link_escalate). Everything else takes the legacy path: drop
        the conn, surface the loss (reference: btl/tcp endpoint error
        → pml error callback; here the ULFM detector is the
        propagation plane)."""
        if conn.rel and conn.dead is None and not self._closed:
            if conn.state == "degraded":
                return  # already healing; the redialer/timer owns it
            self._link_interrupt(conn, err, eof)
            return
        with conn.wlock:
            conn.dead = err
            conn.wq.clear()
            conn.wbuf.clear()
            self._drop_shaped(conn)
        self.log.error("i/o with rank %s failed: %s", conn.peer, err)
        self._unregister(conn)
        # The dead conn stays in self.conns: bytes already queued (and
        # eagerly completed) were lost, so silently reconnecting would hide
        # a hole in the message stream — subsequent sends raise instead.
        # mark_failed stays UNCONDITIONAL here (unlike the EOF path): the
        # exit-fence abandon predicate and the failure flood both key off
        # known_failed() even in non-FT jobs. The pml's request-failing
        # sweep is what gates on ft_enable — without the detector armed a
        # single-rail write error must not fail requests a healthy
        # fallback rail can still re-drive.
        if conn.peer is not None:
            from ompi_tpu_torch.ft.detector import mark_failed

            mark_failed(conn.peer)

    def _conn_link_stats(self, conn: _Conn) -> dict:
        """How the link was performing at a degrade/restore edge — the
        ft detector carries this into its forensics debug_state and
        the mpidiag LINK line (lock-free diagnostic snapshot)."""
        st = {  # mpiracer: disable=cross-thread-race — lock-free diagnostic snapshot, see docstring
            "srtt_us": round(conn.srtt * 1e6, 1) if conn.rtt_n else None,
            "rtt_samples": conn.rtt_n,
            "loss_ppm": round(1e6 * conn.nack_retx_n
                              / max(conn.tx_seq, 1), 1),
            "goodput_bps": None,
        }
        if _linkmodel._enable_var._value:
            row = _linkmodel.edge(conn.peer)
            if row is not None:
                st["goodput_bps"] = round(
                    sum(row["goodput_bps"].values()), 1)
        return st

    def _link_interrupt(self, conn: _Conn, err: OSError,
                        eof: bool) -> None:
        """Enter LINK_DEGRADED: close the broken socket but KEEP the
        conn (dead stays None — sends keep landing in the retransmit
        window), then start the bounded redial. The LOWER rank
        redials — one dialer per edge, or both sides race fresh
        sockets at each other and half-adopt two; the higher rank runs
        a liveness PROBE loop instead (so a dead peer is noticed in
        ~3 refused connects, not at the deadline) and waits for the
        acceptor-side adoption. Escalation is the progress timer's
        job, never the redial thread's."""
        with conn.wlock:
            if conn.dead is not None or conn.state == "degraded":
                return
            conn.state = "degraded"
            conn.esc_eof = bool(eof)
            now = time.monotonic()
            conn.degraded_at = now
            conn.redial_deadline = now + float(_link_deadline_var._value)
            conn.redial_n = 0
            # queued wire copies fold away: every enveloped frame is
            # already retained, replay happens from the window
            conn.wq.clear()
            conn.wbuf.clear()
            self._drop_shaped(conn)
        self._unregister(conn)  # closes the socket; conn STAYS in conns
        self.log.warning(
            "link to rank %s degraded (%s): redialing, budget %d "
            "attempts / %.1fs", conn.peer, err,
            int(_link_retries_var._value),
            float(_link_deadline_var._value))
        if _trace.enabled():
            _trace.instant("btl_tcp.link_degraded", cat="btl",
                           peer=conn.peer, err=str(err))
        from ompi_tpu_torch.ft.detector import note_link_degraded

        note_link_degraded(conn.peer, link=self._conn_link_stats(conn))
        if conn.peer is not None:
            t = threading.Thread(
                target=self._redial_loop,
                args=(conn, conn.degraded_at), daemon=True,
                name=f"ompi-tpu-tcp-redial-{conn.peer}")
            t.start()

    def _redial_loop(self, conn: _Conn, epoch: float) -> None:
        """Redial/probe daemon for one outage of one degraded link
        (``epoch`` is the outage's degraded_at stamp — a later outage
        starts its own thread and this one stands down). The
        utils/backoff schedule bounds it; ESCALATION is not this
        thread's job — the progress timer owns the deadline (a wedged
        progress engine must not leave escalation racing finalize).
        Consecutive connection-refused attempts collapse the deadline:
        a transiently severed WIRE times out or resets, but a DEAD
        PROCESS refuses — waiting out the full outage budget for a
        closed listener would stretch real failure detection by the
        whole grace window."""
        dialer = self.my_rank < conn.peer
        sched = _backoff.Schedule(
            base_s=float(_link_backoff_var._value) / 1000.0,
            cap_s=2.0,
            retries=int(_link_retries_var._value),
            deadline_s=float(_link_deadline_var._value))
        refused = 0
        while not (self._closed or conn.dead is not None
                   or conn.state != "degraded"
                   or conn.degraded_at != epoch):
            try:
                if dialer:
                    if self._redial_once(conn, epoch):
                        return
                else:
                    self._probe_once(conn)
            except ConnectionRefusedError:
                refused += 1
                if refused >= 3:
                    # mpiracer: disable=cross-thread-race — monotonic clamp read by the timer tick
                    conn.redial_deadline = min(conn.redial_deadline,
                                               time.monotonic())
                    return  # the timer escalates on its next pass
            except OSError:
                refused = 0
            conn.redial_n += 1  # mpiracer: disable=cross-thread-race — diagnostic counter, single-writer (this thread)
            if not sched.sleep():
                return  # budget spent; the timer escalates at deadline

    def _redial_once(self, conn: _Conn, epoch: float) -> bool:
        """One redial attempt (lower rank): blocking dial + resync
        handshake, then adopt the fresh socket under wlock. True =
        adopted, or the outage resolved some other way; False/raise =
        retry."""
        peer = conn.peer
        if _inject._enable_var._value and \
                _inject.link_down(self.my_rank, peer):
            raise OSError("link down (ft_inject_plan outage window)")
        addr = self.peers.get(peer)
        if addr is None:
            return False  # no address card; the deadline escalates
        host, port = addr.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            _apply_bufs(s)
            s.settimeout(2.0)
            s.connect((host, int(port)))
            s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
            caps = (_CAP_COMPRESS | _CAP_QOS | _CAP_RELIABLE
                    | _CAP_RESYNC)
            s.sendall(_LEN.pack(self.my_rank | caps))
            s.sendall(self._resync_frame(conn))
            s.settimeout(None)
        except BaseException:
            s.close()  # a failed attempt must not leak the fd
            raise
        with conn.wlock:
            if self._closed or conn.dead is not None \
                    or conn.state != "degraded" \
                    or conn.degraded_at != epoch:
                s.close()
                return True  # outage resolved some other way
            s.setblocking(False)
            conn.sock = s
            conn.await_ack = True  # fresh socket, fresh ack word
            conn.rstart = conn.rend = 0
            conn.rbuf.clear()
            conn.reconnects += 1
        with self._sel_lock:
            try:
                self.sel.register(s, selectors.EVENT_READ,
                                  ("peer", conn))
            except (KeyError, ValueError, RuntimeError):
                return True  # selector closed: finalize race
        from ompi_tpu_torch.runtime import progress as _progress

        _progress.poke()
        return True

    def _probe_once(self, conn: _Conn) -> None:
        """One liveness probe (higher rank — the acceptor side of the
        redial): connect to the peer's listener and close. Success
        proves the PROCESS is alive (the real resync arrives through
        our acceptor when the peer's dialer gets through); refusal
        propagates to the loop's fast-escalate counter. The accepting
        side sees a 0-byte handshake and drops the socket."""
        if _inject._enable_var._value and \
                _inject.link_down(self.my_rank, conn.peer):
            raise OSError("link down (ft_inject_plan outage window)")
        addr = self.peers.get(conn.peer)
        if addr is None:
            return
        host, port = addr.rsplit(":", 1)
        s = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            s.settimeout(2.0)
            s.connect((host, int(port)))
        finally:
            s.close()

    def _link_escalate(self, conn: _Conn, err: OSError) -> None:
        """Healing failed (redial budget blown, detector-confirmed
        death, resync disagreement, permanent injected sever): fall
        through to the pre-reliability failure contract — dead conn,
        failure detector, pml failover/dead-letter. One deliberate
        nuance: mark_failed honors the EOF gate the original interrupt
        carried. An EOF in a non-FT job never marked the peer failed
        before reliability existed, and escalating a degraded-EOF link
        must not change that; write errors stay unconditional."""
        with conn.wlock:
            if conn.dead is not None:
                return
            conn.dead = err
            eof = conn.esc_eof
            conn.wq.clear()
            conn.wbuf.clear()
            self._drop_shaped(conn)
            conn.retx.clear()
            conn.retx_bytes = 0
            conn.rx_seen.clear()
        self.log.error(
            "link to rank %s failed permanently (%.3fs degraded): %s",
            conn.peer,
            (time.monotonic() - conn.degraded_at)
            if conn.degraded_at else 0.0, err)
        self._unregister(conn)
        if _trace.enabled():
            _trace.instant("btl_tcp.link_escalated", cat="btl",
                           peer=conn.peer, err=str(err))
        if _forensics._enable_var._value:
            # cross-rank dump at the verdict moment, while the
            # evidence (retx depths, redial counts, peer vantage
            # points) is still warm
            _forensics.trigger(
                f"btl_tcp link to rank {conn.peer} escalated: {err}")
        if conn.peer is not None:
            from ompi_tpu_torch.ft.detector import mark_failed

            if not eof or get_var("ft", "enable"):
                mark_failed(conn.peer)

    def _conn_timeout(self, conn: _Conn, ceiling_s: float) -> float:
        """Effective retransmit timeout for one conn. With the
        RTT-adaptive timer on (btl_tcp_retx_adaptive, default) and
        enough Karn-accepted samples folded, the classic
        srtt + 4*rttvar RTO applies — floored so ack coalescing never
        reads as loss, and CEILINGED by btl_tcp_retx_timeout_ms: a
        fast link retransmits in a few RTTs instead of waiting out a
        wan-sized constant, a slow link inflates toward the cvar and
        stops striking spuriously."""
        if _retx_adaptive_var._value \
                and conn.rtt_n >= int(_rtt_min_samples_var._value):
            return min(ceiling_s,
                       max(_RETX_FLOOR_S,
                           conn.srtt + 4.0 * conn.rttvar))
        return ceiling_s

    def _rel_tick(self, now: float) -> int:
        """Link-reliability timer pass (~25ms cadence from progress):
        periodic cumulative acks, retransmit timeouts with strike
        escalation to DEGRADED, and the degraded-link deadline /
        detector checks. Escalation runs HERE, on the progress thread,
        never on a redial thread."""
        with self._conn_lock:
            conns = [c for c in self.conns.values()
                     if c.rel and c.dead is None]
        if not conns:
            return 0
        from ompi_tpu_torch.ft.detector import (known_failed,
                                          note_link_degraded)

        work = 0
        ceiling = max(float(_retx_timeout_var._value), 1.0) / 1000.0
        failed = None
        for conn in conns:
            timeout = self._conn_timeout(conn, ceiling)
            if conn.state != "est":
                # degraded: keep the detector's grace fresh while the
                # window is open, enforce the outage budget
                note_link_degraded(conn.peer)
                if failed is None:
                    failed = known_failed()
                if conn.peer in failed:
                    self._link_escalate(conn, OSError(
                        "peer declared failed during link outage"))
                elif now > conn.redial_deadline:
                    self._link_escalate(conn, OSError(
                        f"link redial budget exhausted "
                        f"({conn.redial_n} attempts, "
                        f"{float(_link_deadline_var._value):.1f}s "
                        f"deadline)"))
                work += 1
                continue
            if (conn.unacked_n or conn.unacked_b) \
                    and now - conn.last_ack_tx > timeout / 2.0:
                self._rel_send_ack(conn)
                work += 1
            if not conn.retx:
                continue
            with conn.wlock:
                if conn.dead is not None or conn.state != "est" \
                        or not conn.retx:
                    continue
                oldest = next(iter(conn.retx.values()))[2]
                if now - oldest <= timeout * (1 + conn.retx_strikes):
                    continue
                if conn.wbuf or conn.wq or (conn.wqs is not None
                                            and any(conn.wqs)):
                    # Local backpressure, not peer silence: the oldest
                    # retained frame may still be queued behind this
                    # conn's own backlog (a bulk storm over small
                    # socket buffers holds megabytes locally), and a
                    # frame that never reached the wire cannot have
                    # been acked yet. Striking here would degrade a
                    # healthy-but-busy link, and the go-back-N resend
                    # would dump the retained tail on top of the very
                    # backlog that stalled it. A dead peer behind a
                    # full queue still fails fast — the drain's write
                    # raises — and the detector heartbeat covers the
                    # half-open case.
                    continue
                conn.retx_strikes += 1
                silent = (conn.last_rx is None
                          or now - conn.last_rx > timeout * 2.0)
                if conn.retx_strikes > 3 and silent:
                    # acks stopped AND the wire went quiet: a
                    # half-open link heals through redial, not blind
                    # retransmission. Inbound bytes veto the verdict —
                    # a peer mid-HOL-stall (its acks serialized behind
                    # a jumbo frame in its own legacy FIFO) is slow,
                    # not dead, and tearing the link down would lose
                    # the very frames the stall was about to deliver.
                    self._conn_failed(conn, OSError(
                        f"no ack progress after {conn.retx_strikes} "
                        f"retransmit timeouts"))
                    work += 1
                    continue
                rnow = time.monotonic()
                conn.last_retx_t = rnow
                for seq in list(conn.retx):
                    if conn.dead is not None or conn.state != "est":
                        break  # transmit failure degraded us mid-loop
                    nb, vecs, _ts, cls = conn.retx[seq]
                    conn.retx[seq] = (nb, vecs, rnow, cls)
                    conn.karn.add(seq)  # Karn: never RTT-sample this seq
                    conn.retx_n += 1
                    _lctr["retransmits"] += 1
                    self._rel_transmit(conn, list(vecs), cls)
                work += 1
        return work

    # ------------------------------------------------- shaped send path
    # btl_tcp_shape_enable=1: every connection drains three class
    # sub-queues (LATENCY/NORMAL/BULK, read from bits 6-7 of the pml
    # kind byte) with a weighted-deficit scheduler instead of one FIFO.
    # FIFO holds WITHIN a class (the pml's per-(peer, class) seq planes
    # depend on it); across classes the scheduler reorders on purpose —
    # that is the whole point. A partially-written frame always
    # finishes first (TCP frames are contiguous on the wire), so the
    # preemption granularity is one frame — which is why the pml
    # segments oversized blobs before they get here.
    def _send_shaped(self, conn: _Conn, vecs: List, cls: int) -> None:
        """Shaped enqueue/send of one frame. Caller holds conn.wlock
        and has done the dead-check."""
        if conn.wqs is None:
            conn.wqs = (deque(), deque(), deque())
        if conn.wbuf:
            # legacy residue after a copy_mode flip: ordered first
            conn.wq.append(bytes(conn.wbuf))
            conn.wbuf.clear()
        if conn.wq:
            # pre-shaping FIFO residue (mode flip, or frames queued
            # before the peer's QoS ack landed): it must hit the wire
            # before any shaped frame. If a partial shaped frame is
            # already mid-write it is older still — append after it.
            if conn.cur is None:
                conn.cur = list(conn.wq)
                conn.cur_cls = _qos.NORMAL
            else:
                conn.cur.extend(conn.wq)
            conn.wq.clear()
        if conn.cur is None and not any(conn.wqs):
            # fast path: push straight from the caller's buffer
            total = sum(len(v) for v in vecs)
            vecs = self._try_send(conn, vecs)
            if not vecs:
                return  # fully on the wire (or conn failed): 0 copies
            # backpressure: own the unsent remainder. A frame with
            # bytes already on the wire is the unpreemptible
            # in-progress frame; one the kernel took NOTHING of is
            # still schedulable — queue it so a LATENCY arrival can
            # jump ahead of an untouched bulk frame.
            cur = []
            left = 0
            for v in vecs:
                left += len(v)
                if isinstance(v, memoryview):
                    _ctr["copied"] += len(v)
                    v = bytes(v)
                cur.append(v)
            if left < total:
                conn.cur = cur
                conn.cur_cls = cls
            else:
                conn.eseq += 1
                conn.wqs[cls].append(
                    (conn.eseq, left, cur, time.monotonic()))
                _shape_ctr["enqueued"] += 1
                with _qlock:
                    _qbytes[cls] += left
                    if _qbytes[cls] > _qpeak[cls]:
                        _qpeak[cls] = _qbytes[cls]
            self._want_write(conn, True)
            return
        # backlog: own the frame into its class sub-queue, then give
        # the scheduler a drain pass (a LATENCY arrival may preempt
        # the queued bulk right now instead of at the next progress)
        nb = 0
        owned = []
        for v in vecs:
            if isinstance(v, memoryview):
                _ctr["copied"] += len(v)
                v = bytes(v)
            owned.append(v)
            nb += len(v)
        conn.eseq += 1
        conn.wqs[cls].append((conn.eseq, nb, owned, time.monotonic()))
        _shape_ctr["enqueued"] += 1
        with _qlock:
            _qbytes[cls] += nb
            if _qbytes[cls] > _qpeak[cls]:
                _qpeak[cls] = _qbytes[cls]
        if cls == _qos.BULK:
            # background enqueue: do NOT drain synchronously — a bulk
            # producer in a tight ship loop would otherwise spend its
            # own timeslice pushing the whole backlog through sendmsg,
            # starving the latency-critical threads the shaper exists
            # to protect. The progress engine drains it (the trailing
            # poke in send() wakes a parked loop).
            self._want_write(conn, True)
        else:
            self._flush_shaped(conn)

    def _flush_shaped(self, conn: _Conn) -> None:
        """Drain the shaped sub-queues: finish the in-progress frame,
        then repeatedly let the deficit scheduler pick the next class.
        Caller holds conn.wlock.

        The drain is BUDGETED per call: a fast kernel (loopback) would
        otherwise accept an entire multi-blob backlog in one loop while
        this thread holds conn.wlock — and a LATENCY frame born on the
        app thread mid-drain would block on the lock for the whole
        serialization, re-creating exactly the head-of-line blocking
        the scheduler exists to remove. Stopping every ~16 quanta
        releases the lock (the yield point between sendmsg calls); the
        selector's write interest re-enters the drain immediately."""
        budget = 16 * max(int(_quantum_var._value), 1)
        sent = 0
        while True:
            if conn.cur is not None:
                before = sum(len(v) for v in conn.cur)
                rem = self._try_send(conn, conn.cur)
                if conn.dead is not None or conn.state != "est":
                    # a fatal send inside _try_send killed OR degraded
                    # the conn (the interrupt cleared cur/wqs inline —
                    # same thread, RLock): nothing left to drain
                    return
                if rem:
                    conn.cur = rem  # socket full mid-frame: resume later
                    self._want_write(conn, True)
                    return
                sent += before
                conn.cur = None
            if sent >= budget:
                # yield point: backlog remains, the lock must breathe
                self._want_write(conn, True)
                return
            cls = self._pick_class(conn)
            if cls is None:
                self._want_write(conn, False)
                return
            wqs = conn.wqs
            # peek-try-commit: a frame the kernel takes NOTHING of
            # stays at its queue head, still schedulable — committing
            # it to `cur` would let an untouched frame block a later
            # preemption for no wire progress
            eseq, nb, owned, ts = wqs[cls][0]
            rem = self._try_send(conn, list(owned))
            if conn.dead is not None or conn.state != "est":
                # killed or degraded mid-send: the queues were cleared
                # under this same RLock — touching wqs[cls] again
                # would IndexError on the emptied deque
                return
            if rem and sum(len(v) for v in rem) == nb:
                self._want_write(conn, True)
                return
            wqs[cls].popleft()
            # preemption = serving ahead of an earlier-enqueued frame
            # of another class (the out-of-FIFO service the per-class
            # scheduler exists to make)
            older = [wqs[c][0][0] for c in _SERVICE_ORDER
                     if c != cls and wqs[c]]
            if older and min(older) < eseq:
                _shape_ctr["preempt"] += 1
            with _qlock:
                _qbytes[cls] -= nb
            if conn.deficit[cls] >= nb:
                # only deficit-granted serves spend credit: a grant
                # that bypassed the deficit check (sole backlogged
                # class, starvation bound) must not drive the counter
                # negative, or a class that ran alone for a while
                # starts a later contention epoch in deep debt and
                # starves against its own weight (classic DRR never
                # goes negative)
                conn.deficit[cls] -= nb
            if not wqs[cls]:
                conn.deficit[cls] = 0  # classic DRR: empty resets
            conn.defer[cls] = 0
            for c in _SERVICE_ORDER:
                if c != cls and wqs[c]:
                    conn.defer[c] += nb
            if _metrics._enable_var._value:
                # per-frame deferral histogram (time queued by class)
                _metrics.observe("btl_tcp_shape_defer_us",
                                 (time.monotonic() - ts) * 1e6,
                                 cls=_qos.NAMES[cls])
            if rem:
                conn.cur = rem  # frame started: must finish first
                conn.cur_cls = cls
                self._want_write(conn, True)
                return
            sent += nb

    def _pick_class(self, conn: _Conn) -> Optional[int]:
        """Next class to serve: the starvation bound first (a class
        past btl_tcp_shape_max_defer_bytes of deferral wins outright —
        BULK always progresses), then weighted-deficit round-robin in
        LATENCY > NORMAL > BULK preference order. Caller holds wlock."""
        wqs = conn.wqs
        nonempty = [c for c in _SERVICE_ORDER if wqs[c]]
        if not nonempty:
            return None
        if len(nonempty) == 1:
            return nonempty[0]
        md = int(_max_defer_var._value)
        if md > 0:
            starved = [c for c in nonempty if conn.defer[c] >= md]
            if starved:
                return max(starved, key=lambda c: conn.defer[c])
        q = max(int(_quantum_var._value), 1)
        w = _weights()
        while True:
            for c in nonempty:
                if conn.deficit[c] >= wqs[c][0][1]:
                    return c
            for c in nonempty:
                conn.deficit[c] += q * w[c]

    def _fold_shaped_residue(self, conn: _Conn) -> None:
        """Shaped residue after a shape_enable flip: fold the partial
        frame and every class sub-queue into the legacy FIFO, oldest
        class-order (cross-class order is arbitrary by construction —
        the shaper had already unordered them). Caller holds wlock."""
        frames: List = []
        if conn.cur is not None:
            frames.extend(conn.cur)
            conn.cur = None
        if conn.wqs is not None:
            for c in _SERVICE_ORDER:
                dq = conn.wqs[c]
                while dq:
                    _eseq, nb, owned, _ts = dq.popleft()
                    frames.extend(owned)
                    with _qlock:
                        _qbytes[c] -= nb
        conn.wq.extendleft(reversed(frames))

    def _drop_shaped(self, conn: _Conn) -> None:
        """Dead conn: release the shaped queues and settle the by-class
        gauges. Caller holds conn.wlock."""
        conn.cur = None
        if conn.wqs is not None:
            for c in _SERVICE_ORDER:
                dq = conn.wqs[c]
                while dq:
                    _eseq, nb, _owned, _ts = dq.popleft()
                    with _qlock:
                        _qbytes[c] -= nb

    def _flush_locked(self, conn: _Conn) -> None:
        """Drain the owned write queue with vectored sends; caller
        holds conn.wlock."""
        if conn.cur is not None or \
                (conn.wqs is not None and any(conn.wqs)):
            # shaped residue after a shape_enable flip: ordered first
            self._fold_shaped_residue(conn)
        if conn.wbuf:
            # legacy residue after a copy_mode flip: ordered first
            conn.wq.appendleft(bytes(conn.wbuf))
            conn.wbuf.clear()
        wq = conn.wq
        max_vecs = int(_vecs_var._value)
        while wq:
            try:
                sent = conn.sock.sendmsg(
                    list(itertools.islice(wq, max_vecs)))
            except socket.error as e:
                if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                    self._want_write(conn, True)
                    return
                self._conn_failed(conn, e)
                return
            if sent <= 0:
                self._want_write(conn, True)
                return
            _ctr["writev"] += 1
            _ctr["wire"] += sent
            if _forensics._enable_var._value:  # last-tx dump evidence
                conn.last_tx = time.monotonic()
            while sent:
                l0 = len(wq[0])
                if sent >= l0:
                    sent -= l0
                    wq.popleft()
                else:
                    # partial first buffer: O(1) reslice over the OWNED
                    # bytes (the deque keeps them alive) — the old
                    # bytearray queue paid an O(n) del wbuf[:sent] here,
                    # O(n^2) across a backlog
                    wq[0] = memoryview(wq[0])[sent:]
                    sent = 0
        self._want_write(conn, False)

    def _want_write(self, conn: _Conn, on: bool) -> None:
        ev = selectors.EVENT_READ | (selectors.EVENT_WRITE if on else 0)
        with self._sel_lock:
            try:
                self.sel.modify(conn.sock, ev, ("peer", conn))
            except (KeyError, ValueError):
                pass

    # ----------------------------------------------------------- progress
    def idle_fds(self) -> Tuple[list, list]:
        """Export (read-fds, write-interest-fds) for the progress
        engine's idle-blocking select: the listener plus every live
        conn, and — so a parked loop resumes flushing — every conn
        with queued writes. A socket closing between export and the
        select is handled by the caller (select raises, treated as a
        wake)."""
        rfds: list = []
        wfds: list = []
        if self._closed:
            return rfds, wfds
        with self._sel_lock:
            try:
                keys = list(self.sel.get_map().values())
            except RuntimeError:  # selector closed by a finalize race
                return rfds, wfds
        for key in keys:
            rfds.append(key.fd)
            if key.events & selectors.EVENT_WRITE:
                wfds.append(key.fd)
        return rfds, wfds

    def progress(self) -> int:
        """Drain ready sockets; called from the progress engine
        (reference: btl progress fns registered at opal_progress.c:416)."""
        if self._closed:
            return 0
        if not self._progress_lock.acquire(blocking=False):
            return 0
        try:
            try:
                with self._sel_lock:
                    events = self.sel.select(timeout=0)
            except OSError:
                return 0
            n = 0
            for key, mask in events:
                kind, conn = key.data
                if kind == "accept":
                    n += self._accept()
                    continue
                if mask & selectors.EVENT_WRITE:
                    with conn.wlock:
                        if _copy_mode_var._value:
                            self._flush_legacy(conn)
                        elif conn.cur is not None or \
                                (conn.wqs is not None and any(conn.wqs)):
                            # shaped backlog pending (regardless of the
                            # cvar's CURRENT value: a flip mid-backlog
                            # must still drain what the shaper queued)
                            self._flush_shaped(conn)
                        else:
                            self._flush_locked(conn)
                if mask & selectors.EVENT_READ:
                    n += self._drain(conn)
            # link-reliability timers (acks, retransmit timeouts,
            # degraded-link deadlines) ride the progress cadence; the
            # _rel_next gate keeps the idle cost at one clock read
            now = time.monotonic()
            if now >= self._rel_next:
                self._rel_next = now + 0.025
                n += self._rel_tick(now)
            return n
        finally:
            self._progress_lock.release()

    def _accept(self) -> int:
        try:
            s, _ = self.listener.accept()
        except OSError:
            return 0
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        # first 4 bytes: peer rank
        s.setblocking(True)
        raw = b""
        while len(raw) < 4:
            chunk = s.recv(4 - len(raw))
            if not chunk:
                return 0
            raw += chunk
        word = _LEN.unpack(raw)[0]
        _ALLCAPS = (_CAP_COMPRESS | _CAP_QOS | _CAP_RELIABLE
                    | _CAP_RESYNC)
        peer = word & ~_ALLCAPS
        if word & _CAP_RESYNC:
            # not a fresh endpoint: a redial resuming an existing
            # reliable link — adopt the socket into the surviving conn
            return self._adopt_redial(s, peer)
        conn = _Conn(s, peer)
        if word & _ALLCAPS:
            # the connector understands zlib-flagged frames / QoS class
            # bits; answer with our ack so it knows we do too (decoding
            # is always available in this build — acceptance is
            # unconditional, per advertised capability). The RELIABLE
            # bit is the exception: engaging it changes OUR wire
            # format, so it follows this side's cvar.
            ack = _ZACK_MAGIC
            if word & _CAP_COMPRESS:
                conn.peer_z = True
                ack |= _ZACK_ACCEPT
            if word & _CAP_QOS:
                conn.peer_q = True
                ack |= _ZACK_QOS
            if word & _CAP_RELIABLE and _reliable_var._value:
                # engage both directions now: every frame we send from
                # here on is enveloped, and TCP ordering puts our ack
                # word ahead of all of them on the peer's side
                conn.rel = conn.rel_rx = True
                ack |= _ZACK_RELIABLE
            try:
                s.sendall(_LEN.pack(ack))
            except OSError:
                # the dialer died mid-handshake; under the connect
                # retry it will redial — close or each attempt leaks a fd
                try:
                    s.close()
                except OSError:
                    pass
                return 0
        s.setblocking(False)
        with self._conn_lock:
            # keep one canonical conn per peer for sending; both sides may
            # connect simultaneously — every conn gets drained regardless
            self.conns.setdefault(peer, conn)
        with self._sel_lock:
            self.sel.register(s, selectors.EVENT_READ, ("peer", conn))
        return 1

    def _adopt_redial(self, s: socket.socket, peer: int) -> int:
        """Acceptor side of reconnect-and-replay: a _CAP_RESYNC dial
        RESUMES an existing reliable conn. Answer the handshake ack +
        our own RESYNC frame, retire whatever socket the conn held and
        swap the fresh one in under wlock; the normal drain then
        parses the dialer's RESYNC (the replay trigger) off the new
        socket. Refused — socket closed — when there is nothing to
        resume; the dialer's next attempt or its deadline handles
        that."""
        with self._conn_lock:
            conn = self.conns.get(peer)
        if conn is None or not conn.rel or conn.dead is not None \
                or self._closed:
            try:
                s.close()
            except OSError:
                pass
            return 0
        ack = _ZACK_MAGIC | _ZACK_RELIABLE
        if conn.peer_z:
            ack |= _ZACK_ACCEPT
        if conn.peer_q:
            ack |= _ZACK_QOS
        with conn.wlock:
            old = conn.sock
            try:
                s.sendall(_LEN.pack(ack))
                s.sendall(self._resync_frame(conn))
            except OSError:
                try:
                    s.close()
                except OSError:
                    pass
                return 0
            # retire the old socket (already closed if this side had
            # degraded too; a half-open survivor otherwise)
            with self._sel_lock:
                try:
                    self.sel.unregister(old)
                except (KeyError, ValueError):
                    pass
            try:
                old.close()
            except OSError:
                pass
            s.setblocking(False)
            conn.sock = s
            conn.await_ack = False  # acceptor: we SENT the ack word
            # the old socket's partial rx frame is gone with it — the
            # peer's replay covers whatever the tail cut off
            conn.rstart = conn.rend = 0
            conn.rbuf.clear()
            conn.reconnects += 1
        with self._sel_lock:
            try:
                self.sel.register(s, selectors.EVENT_READ,
                                  ("peer", conn))
            except (KeyError, ValueError, RuntimeError):
                return 0  # selector closed: finalize race
        return 1

    def _drain(self, conn: _Conn) -> int:
        if _copy_mode_var._value and not conn.rel_rx:
            # reliability-engaged conns stay on the pooled parser even
            # under copy_mode: the legacy parser cannot interpret the
            # per-frame envelope/control flags
            return self._drain_legacy(conn)
        # pooled receive staging: recv_into this conn's reusable block
        # (one pool hit) instead of a fresh 1 MiB allocation per recv —
        # a 4-byte ack used to cost a megabyte of garbage plus an rbuf
        # concat. Frames are then SLICED out of the block; anything
        # that must outlive it is copied at the pml delivery boundary.
        if conn.rbuf:
            # legacy residue after a copy_mode flip: replay it through
            # the block so frame parsing stays continuous
            self._adopt_legacy_rbuf(conn)
        buf = conn.rxb
        if buf is None:
            buf = conn.rxb = _rx_pool.acquire()  # owns: rxb
            conn.rstart = conn.rend = 0
        if conn.rend == len(buf):
            # no room left: slide the parked partial frame to the
            # front, or grow into a private (unpooled) buffer when one
            # frame is bigger than the block — bounded boundary copies,
            # both charged to btl_tcp_bytes_copied
            pending = conn.rend - conn.rstart
            if conn.rstart > 0:
                buf[:pending] = buf[conn.rstart:conn.rend]
            else:
                total = 0
                if pending >= 4:
                    word = _LEN.unpack_from(buf, 0)[0]
                    # an enveloped or control frame's length lies under
                    # its flag bits (the reference masks with _LEN_MASK
                    # alone and grows every jumbo reliable frame's buffer
                    # past 512 MiB)
                    total = word & (
                        _RLEN_MASK if conn.rel_rx and word & (_RFLAG | _LFLAG)
                        else _LEN_MASK)
                nbuf = bytearray(max(4 + total, 2 * len(buf)))
                nbuf[:pending] = buf
                # only a pool-sized block goes back: regrowing an
                # ALREADY-grown buffer (a second jumbo outgrowing the
                # first, or legacy-residue adoption that exactly filled
                # its grown buffer) used to release the private
                # bytearray here, spuriously decrementing the pool's
                # outstanding count for a block it never handed out
                if len(buf) == _RX_BLOCK:
                    _rx_pool.release(buf)
                conn.rxb = buf = nbuf
            _ctr["copied"] += pending
            conn.rstart, conn.rend = 0, pending
        try:
            n_in = conn.sock.recv_into(memoryview(buf)[conn.rend:])
        except socket.error as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return 0
            self._conn_failed(conn, e)
            return 0
        if not n_in:
            if conn.rel and conn.dead is None and not self._closed:
                # reliable link: EOF on an established conn INTERRUPTS
                # (degrade + redial) — a severed wire manifests as EOF
                # on the passive side, and this is its heal path. A
                # real peer death redials into a refused listener and
                # fast-escalates; escalation's EOF gate preserves the
                # pre-reliability semantics below (mark_failed only
                # under ft_enable).
                self._conn_failed(
                    conn, ConnectionResetError("closed by peer"),
                    eof=True)
                return 0
            # EOF: could be a peer crash OR a clean peer Finalize — mark
            # the conn dead so later sends raise instead of vanishing.
            # With the ULFM detector armed (ft_enable) the EOF is also
            # reported as a failure vantage point — in an FT job a peer
            # that stops talking IS failed (its heartbeats stop too, so
            # the flood only arrives sooner); without ft_enable a clean
            # shutdown must not raise failure events, so detection stays
            # local.
            if conn.dead is None:
                conn.dead = ConnectionResetError("closed by peer")
            if conn.peer is not None:
                from ompi_tpu_torch.ft.detector import mark_failed

                if get_var("ft", "enable"):
                    mark_failed(conn.peer)
            self._unregister(conn)
            return 0
        _ctr["wire"] += n_in
        if _forensics._enable_var._value or conn.rel:
            # forensics: last-rx dump evidence. Reliable link: inbound
            # liveness — _rel_tick refuses to escalate ack-progress
            # strikes into DEGRADED while bytes are still arriving
            conn.last_rx = time.monotonic()
        conn.rend += n_in
        n = 0
        mv = memoryview(buf)  # borrows: rxb
        off = conn.rstart
        end = conn.rend
        if conn.await_ack and end - off >= 4:
            # the compress-handshake ack leads every frame on a dialed
            # link. Match the FULL word (magic byte + reserved-zero
            # bits + accept bit), not just the high byte: a non-acking
            # peer's first frame could legally be ~1.41 GiB long under
            # the 2 GiB cap, and a high-byte-only match would eat its
            # length word and desync the whole stream
            word = _LEN.unpack_from(buf, off)[0]
            conn.await_ack = False
            if word in _ZACK_WORDS:
                conn.peer_z = bool(word & _ZACK_ACCEPT)
                conn.peer_q = bool(word & _ZACK_QOS)
                if word & _ZACK_RELIABLE:
                    # both sides advertised: envelope from here on (the
                    # frames we sent pre-ack went out legacy-framed —
                    # per-frame flags keep both parseable)
                    conn.rel = conn.rel_rx = True
                off += 4
        while end - off >= 4:
            word = _LEN.unpack_from(buf, off)[0]
            if conn.rel_rx and word & _LFLAG:
                # link-control frame (ACK/NACK/RESYNC)
                total = word & _RLEN_MASK
                if end - off - 4 < total:
                    break
                self._rel_ctrl_rx(conn, mv[off + 4:off + 4 + total])
                off = off + 4 + total
                if conn.dead is not None:
                    # a resync disagreement escalated mid-parse; the
                    # block was discarded with the conn
                    return n
                continue
            if conn.rel_rx and word & _RFLAG:
                # reliability-enveloped data frame:
                # [len|flags][seq][cum_ack][crc32][hdr][payload]
                total = word & _RLEN_MASK
                if end - off - 4 < total:
                    break
                start = off + 4
                off = start + total
                if total < 12 + HDR_SIZE:
                    # structurally impossible envelope: treat like a
                    # CRC failure — drop and NACK
                    conn.crc_errs += 1
                    conn.last_crc = time.monotonic()
                    _lctr["crc_errors"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view
                    self._send_ctrl(conn, _CTL_NACK, conn.rx_floor, 0)
                    continue
                seq, ackv, crc = struct.unpack_from("<III", buf, start)
                hdr = mv[start + 12:start + 12 + HDR_SIZE]
                payload = mv[start + 12 + HDR_SIZE:start + total]
                c = zlib.crc32(mv[start:start + 8])
                c = zlib.crc32(hdr, c)
                c = zlib.crc32(payload, c)
                if c & 0xFFFFFFFF != crc:
                    # CRC mismatch: drop THIS frame only (framing is
                    # intact — the length word is outside the fault
                    # model) and NACK a retransmission. Before the
                    # envelope this was a desynced stream or a
                    # poisoned pml delivery.
                    conn.crc_errs += 1
                    conn.last_crc = time.monotonic()
                    _lctr["crc_errors"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view
                    self._send_ctrl(conn, _CTL_NACK, conn.rx_floor, 0)
                    continue
                self._rel_ack_rx(conn, ackv)
                if seq <= conn.rx_floor or seq in conn.rx_seen:
                    # duplicate (retransmit overlap): drop, but count
                    # toward the ack cadence — the sender needs the
                    # ack to stop resending
                    _lctr["dedup"] += 1  # mpiracer: disable=cross-thread-race — relaxed counter, same discipline as _ctr; pvar readers tolerate a stale view
                    conn.dedup_n += 1
                    conn.unacked_n += 1
                    if conn.unacked_n >= 8 or \
                            conn.unacked_b >= 1 << 20:
                        self._rel_send_ack(conn)
                    continue
                if seq == conn.rx_floor + 1:
                    conn.rx_floor = seq
                    while conn.rx_floor + 1 in conn.rx_seen:
                        conn.rx_seen.discard(conn.rx_floor + 1)
                        conn.rx_floor += 1
                else:
                    # a gap (CRC-dropped or reordered-by-replay frame
                    # in flight): deliver NOW anyway — the pml's
                    # per-(peer, class) seq planes own ordering; the
                    # link layer owns only exactly-once
                    conn.rx_seen.add(seq)
                conn.rx_frames += 1
                conn.unacked_n += 1
                conn.unacked_b += total
                if _copy_mode_var._value:
                    # legacy A/B discipline on an enveloped link: the
                    # legacy parser cannot read envelope flags, so the
                    # pooled parser reproduces its per-frame parse copy
                    # here — copy_mode=1 keeps measuring the copying
                    # baseline on reliable conns too
                    hdr = bytes(hdr)  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
                    payload = bytes(payload)  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
                    _ctr["copied"] += len(hdr) + len(payload)
                if word & _ZFLAG:
                    try:
                        payload = zlib.decompress(payload)
                    except zlib.error as e:
                        # the CRC passed, so this is not wire noise —
                        # it is a torn negotiation or our bug; the
                        # legacy contract (fail the link) applies
                        self.log.exception("corrupt compressed frame")
                        conn.rstart = off
                        self._conn_failed(conn, OSError(
                            f"corrupt compressed frame from rank "
                            f"{conn.peer}: {e}"))
                        return n
                try:
                    self.deliver(hdr, payload)  # mpiown: disable=escaping-view — synchronous over this block; ob1's _owned gate copies any payload that must survive it
                except Exception:
                    self.log.exception(
                        "frame handler failed (frame dropped)")
                n += 1
                if conn.unacked_n >= 8 or conn.unacked_b >= 1 << 20:
                    self._rel_send_ack(conn)
                continue
            total = word & _LEN_MASK
            if end - off - 4 < total:
                break
            start = off + 4
            # zero-copy parse: header and payload are views over the
            # pool block, valid for the synchronous deliver below; the
            # pml copies at its boundary when a payload must survive it
            hdr = mv[start:start + HDR_SIZE]
            payload = mv[start + HDR_SIZE:start + total]
            off = start + total
            if _copy_mode_var._value:
                # same legacy A/B parse-copy discipline for the
                # plain-framed frames a reliable conn carries (the
                # pre-negotiation tail)
                hdr = bytes(hdr)  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
                payload = bytes(payload)  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
                _ctr["copied"] += total
            if word & _ZFLAG:
                # negotiated framing: only a handshake-capable peer ever
                # sets the flag, so this build always knows how to undo
                # it. A decompress failure means stream integrity is
                # gone — silently dropping the frame would leave the
                # pml's per-peer sequence waiting forever on a hole, so
                # fail the LINK and let the pml's failover/dead-letter
                # machinery take over (same contract as a read error)
                try:
                    payload = zlib.decompress(payload)
                except zlib.error as e:
                    self.log.exception("corrupt compressed frame")
                    conn.rstart = off
                    self._conn_failed(conn, OSError(
                        f"corrupt compressed frame from rank "
                        f"{conn.peer}: {e}"))
                    return n
            # A frame handler may itself send (ob1 replies with CTS/DATA
            # from inside deliver); if that send hits a dead peer the
            # MPIError must not escape — it would skip the cursor
            # advance below (re-delivering frames) and kill the
            # progress thread.
            try:
                self.deliver(hdr, payload)  # mpiown: disable=escaping-view — the deliver is synchronous over this block; ob1's _owned gate copies any payload that must survive it
            except Exception:
                self.log.exception("frame handler failed (frame dropped)")
            n += 1
        if off >= end:
            # block fully parsed: reset the cursors — no memmove, and a
            # buffer grown for a jumbo frame is dropped so the conn
            # reacquires a pooled block on the next drain
            conn.rstart = conn.rend = 0
            if len(buf) != _RX_BLOCK:
                conn.rxb = None
        else:
            conn.rstart = off
        return n

    def _adopt_legacy_rbuf(self, conn: _Conn) -> None:
        """Move legacy rbuf residue (a copy_mode flip mid-stream) into
        the pooled block, growing it if needed. Runs under the drain's
        single-drainer exclusivity."""
        pending = len(conn.rbuf)
        if conn.rxb is None:
            conn.rxb = _rx_pool.acquire()  # owns: rxb
            conn.rstart = conn.rend = 0
        live = conn.rend - conn.rstart
        if live + pending > len(conn.rxb):
            nbuf = bytearray(max(live + pending, 2 * len(conn.rxb)))
            nbuf[:live] = conn.rxb[conn.rstart:conn.rend]
            if len(conn.rxb) == _RX_BLOCK:
                _rx_pool.release(conn.rxb)
            conn.rxb = nbuf
            conn.rstart, conn.rend = 0, live
        elif conn.rend + pending > len(conn.rxb):
            conn.rxb[:live] = conn.rxb[conn.rstart:conn.rend]
            conn.rstart, conn.rend = 0, live
        conn.rxb[conn.rend:conn.rend + pending] = conn.rbuf
        conn.rend += pending
        _ctr["copied"] += pending
        conn.rbuf.clear()

    def _drain_legacy(self, conn: _Conn) -> int:
        """The pre-vectored read path, verbatim (btl_tcp_copy_mode=1,
        the bench A/B baseline): a fresh 1 MiB allocation per recv, an
        rbuf concat, and per-frame header/payload parse copies — all
        charged to btl_tcp_bytes_copied so the legacy copy tax is
        measured on the real legacy code."""
        if conn.rxb is not None and conn.rend > conn.rstart:
            # vectored residue after a copy_mode flip
            conn.rbuf += memoryview(conn.rxb)[conn.rstart:conn.rend]  # mpilint: disable=hot-copy — legacy A/B path adopts the pooled residue
            _ctr["copied"] += conn.rend - conn.rstart
        if conn.rxb is not None:
            if len(conn.rxb) == _RX_BLOCK:
                _rx_pool.discard(conn.rxb)  # mpiracer: disable=cross-thread-race — BufferPool serializes internally (_plock); discard never recycles, so the racing drain keeps sole ownership
            conn.rxb = None
            conn.rstart = conn.rend = 0
        try:
            data = conn.sock.recv(1 << 20)
        except socket.error as e:
            if e.errno in (errno.EAGAIN, errno.EWOULDBLOCK):
                return 0
            self._conn_failed(conn, e)
            return 0
        if not data:
            if conn.dead is None:
                conn.dead = ConnectionResetError("closed by peer")
            if conn.peer is not None:
                from ompi_tpu_torch.ft.detector import mark_failed

                if get_var("ft", "enable"):
                    mark_failed(conn.peer)
            self._unregister(conn)
            return 0
        _ctr["wire"] += len(data)
        if _forensics._enable_var._value:  # last-rx dump evidence
            conn.last_rx = time.monotonic()
        conn.rbuf += data  # mpilint: disable=hot-copy — legacy A/B path reproduces the old rbuf concat on purpose
        _ctr["copied"] += len(data)
        n = 0
        buf = conn.rbuf
        off = 0
        if conn.await_ack and len(buf) >= 4:
            word = _LEN.unpack_from(buf, 0)[0]
            conn.await_ack = False
            if word in _ZACK_WORDS:
                conn.peer_z = bool(word & _ZACK_ACCEPT)
                conn.peer_q = bool(word & _ZACK_QOS)
                if word & _ZACK_RELIABLE:
                    # engaged mid-copy_mode: the NEXT drain dispatches
                    # to the pooled parser (it alone reads the
                    # per-frame envelope flags)
                    conn.rel = conn.rel_rx = True
                off = 4
        while len(buf) - off >= 4:
            word = _LEN.unpack_from(buf, off)[0]
            total = word & _LEN_MASK
            if len(buf) - off - 4 < total:
                break
            start = off + 4
            hdr = bytes(buf[start:start + HDR_SIZE])  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
            payload = bytes(buf[start + HDR_SIZE:start + total])  # mpilint: disable=hot-copy — legacy A/B path reproduces the old parse copy on purpose
            _ctr["copied"] += total
            off += 4 + total
            if word & _ZFLAG:
                try:
                    payload = zlib.decompress(payload)
                except zlib.error as e:
                    self.log.exception("corrupt compressed frame")
                    self._conn_failed(conn, OSError(
                        f"corrupt compressed frame from rank "
                        f"{conn.peer}: {e}"))
                    return n
            try:
                self.deliver(hdr, payload)
            except Exception:
                self.log.exception("frame handler failed (frame dropped)")
            n += 1
        if off:
            del buf[:off]
        return n

    def _unregister(self, conn: _Conn) -> None:
        with self._sel_lock:
            try:
                self.sel.unregister(conn.sock)
            except (KeyError, ValueError):
                pass
        try:
            conn.sock.close()
        except OSError:
            pass
        # drop the receive block. discard, NOT release: _unregister can
        # run from the app thread's _conn_failed while the progress
        # thread is mid-_drain on this very block — recycling it would
        # hand live memory to the next acquire. (A buffer grown past
        # the pool size was never pooled; its accounting was settled at
        # grow time.)
        if conn.rxb is not None:
            if len(conn.rxb) == _RX_BLOCK:
                _rx_pool.discard(conn.rxb)  # mpiracer: disable=cross-thread-race — BufferPool serializes internally (_plock); discard never recycles, so the mid-drain reader keeps sole ownership
            conn.rxb = None
            conn.rstart = conn.rend = 0

    def finalize(self) -> None:
        # Graceful link close: exiting while this side's last frames
        # sit unacked in retx turns a recoverable wire fault (a CRC
        # reject awaiting retransmit, a dropped frame riding the retx
        # timer) into permanent loss — the peer's Finalize fence then
        # waits on a frame nobody will ever resend. The progress
        # thread is already stopped when the btl finalizes, so pump
        # the datapath directly until every established link drains
        # or the bound expires. Degraded/dead links are excluded: an
        # outage budget must not stall a clean exit.
        deadline = time.monotonic() + 2.0
        while time.monotonic() < deadline:
            with self._conn_lock:
                pending = [c for c in self.conns.values()
                           if c.rel and c.dead is None
                           and c.state == "est" and c.retx]
            if not pending:
                break
            self.progress()
            time.sleep(0.001)
        self._closed = True
        with self._sel_lock:
            try:
                self.sel.unregister(self.listener)
            except (KeyError, ValueError):
                pass
        try:
            self.listener.close()
        except OSError:
            pass
        with self._conn_lock:
            conns = list(self.conns.values())
            self.conns.clear()
        for conn in conns:
            if conn.rel:
                # stand the link state machine down: a degraded conn's
                # redial thread exits on dead, and a post-finalize send
                # raises instead of interrupting into a fresh redial
                with conn.wlock:
                    if conn.dead is None:
                        conn.dead = OSError("btl finalized")
            self._unregister(conn)
        with self._sel_lock:
            try:
                self.sel.close()
            except OSError:
                pass


class TcpBtlComponent(Component):
    NAME = "tcp"
    PRIORITY = 20

    def query(self, deliver=None, my_rank=None, **ctx):
        if deliver is None or my_rank is None:
            return None
        return TcpBtl(deliver, my_rank)


btl_framework.register(TcpBtlComponent())
