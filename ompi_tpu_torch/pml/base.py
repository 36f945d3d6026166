"""PML base: wire headers, matching engine, send/recv requests.

The port of ``ompi_tpu/pml/base.py``. ``world_pml`` reads the world slot
of ``runtime/state.py``, which comes with the first runnable process mode;
until then there is no world and it returns None, as the reference does
before Init. The wire format is byte-compatible with the reference's.

Reference contracts:
- protocol set: ompi/mca/pml/ob1/pml_ob1_hdr.h:43-52 (MATCH, RNDV, RGET,
  ACK, FRAG, FIN ...) — we keep EAGER(=MATCH), RNDV RTS/CTS/DATA.
- matching: pml_ob1_recvfrag.c:938 `match_one` — posted-receive queue vs
  unexpected-fragment queue, FIFO per source, wildcard source/tag.
- fn-table contract: ompi/mca/pml/pml.h:536-572.

The matching engine is shared by every BTL; one instance per process. A
single engine lock suffices (transports deliver from a progress thread; the
hot path is short and the GIL serializes Python anyway — the analog of the
reference's opal_using_threads() coarse mode).
"""

from __future__ import annotations

import struct
import sys
import threading
from collections import deque
from typing import Dict, List, Optional, Tuple

from ompi_tpu_torch.core.convertor import Convertor
from ompi_tpu_torch.core.datatype import Datatype
from ompi_tpu_torch.core.request import Request
from ompi_tpu_torch.runtime import trace as _trace

ANY_SOURCE = -1
ANY_TAG = -1

# User-traffic classification shared by every interposition PML
# (pml/monitoring, pml/v): plane-bit cids (collective schedules, nbc,
# partitioned, dpm, ft — any cid bit >= 2^25) and system tags
# (heartbeats, osc active messages, revoke floods, tag <= -4000) are
# library-internal, not application pt2pt.
_PLANE_MASK = ~((1 << 25) - 1)
SYSTEM_TAG_BASE = -4000


def user_traffic(tag: int, cid: int) -> bool:
    return (cid & _PLANE_MASK) == 0 and tag > SYSTEM_TAG_BASE


def send_system(pml, dst: int, obj: dict, tag: int) -> None:
    """Fire-and-forget diagnostic frame on the system plane (bypasses
    matching; suppressed from SPC so counters stay user-only). Shared
    by every diagnostic subsystem with its own tag (sanitizer -4400,
    metrics -4500, diskless checkpoint replication -4600) — the
    diagnostic plane must never take the application down. With
    traffic shaping on (``btl_tcp_shape_enable``) the pml classifies
    the frame by its tag (``qos_tag_map``) and segments oversized
    payloads into preemptible BULK sub-frames, so a background blob
    shipped through here cannot head-of-line-block latency traffic."""
    import json

    from ompi_tpu_torch.core.datatype import BYTE
    from ompi_tpu_torch.runtime import spc

    payload = json.dumps(obj).encode()
    try:
        with spc.suppressed():
            pml.isend(payload, len(payload), BYTE, dst, tag, 0)
    except Exception:
        pass
    # a diagnostic post must not wait out an idle park: wake any loop
    # blocked in the progress engine's select (no-op when none is)
    from ompi_tpu_torch.runtime import progress as _progress

    _progress.poke()


def world_comm():
    """The world communicator of process mode, or None before Init and
    after teardown. Read through ``sys.modules``: ``runtime/state.py``
    imports this module, never the reverse, and while it is not imported
    there is no world."""
    state = sys.modules.get("ompi_tpu_torch.runtime.state")
    return None if state is None else state._world


def world_pml():
    """The world communicator's pml, or None before Init/after teardown
    (shared by the diagnostic planes' handler binding)."""
    w = world_comm()
    return None if w is None else w.pml


class SystemPlane:
    """One diagnostic system-plane binding: a tag plus its handler,
    (re)bound onto whatever pml is live. Identity is a weakref, not
    id(): a finalize/re-Init cycle can allocate the new pml at the
    freed old pml's address, and a stale id match would silently skip
    registration for the whole second epoch."""

    __slots__ = ("tag", "handler", "_pml_ref")

    def __init__(self, tag: int, handler):
        self.tag = tag
        self.handler = handler
        self._pml_ref = None

    def ensure(self, pml) -> None:
        import weakref

        if self._pml_ref is None or self._pml_ref() is not pml:
            pml.register_system_handler(self.tag, self.handler)
            self._pml_ref = weakref.ref(pml)

    def reset(self) -> None:
        self._pml_ref = None

    def send(self, pml, dst: int, obj: dict) -> None:
        send_system(pml, dst, obj, self.tag)

# Header kinds (reference: pml_ob1_hdr.h type enum — FIN and ACK are the
# analogs of MCA_PML_OB1_HDR_TYPE_FIN / _ACK)
EAGER = 1
RNDV_RTS = 2
RNDV_CTS = 3
RNDV_DATA = 4
RNDV_FIN = 5   # single-copy (cma) delivery complete — no DATA stream
RNDV_ACK = 6   # receiver flow-control credit: hdr.nbytes = bytes landed

_HDR = struct.Struct("<BiiqQQQQ")  # kind, src, cid, tag, seq, nbytes, offset, msgid
HDR_SIZE = _HDR.size

# QoS class (qos.py) rides bits 6-7 of the kind byte — the
# header's one spare bit-field (kinds stop at 6). NORMAL encodes as 0,
# so an unshaped job's frames are bit-identical to the pre-QoS format;
# the receive side reads the class back to key its per-(peer, class)
# sequence planes (the mirror of the sender's per-class wire order)
# and the tcp btl reads header[0] >> 6 to pick a send sub-queue.
QOS_SHIFT = 6
KIND_MASK = (1 << QOS_SHIFT) - 1


def pack_header(kind: int, src: int, cid: int, tag: int, seq: int,
                nbytes: int, offset: int, msgid: int,
                qos: int = 0) -> bytes:
    return _HDR.pack(kind | (qos << QOS_SHIFT), src, cid, tag, seq,
                     nbytes, offset, msgid)


class Header:
    __slots__ = ("kind", "src", "cid", "tag", "seq", "nbytes", "offset",
                 "msgid", "qos")

    def __init__(self, raw: bytes):
        (kind_byte, self.src, self.cid, self.tag, self.seq,
         self.nbytes, self.offset, self.msgid) = _HDR.unpack(raw)
        self.kind = kind_byte & KIND_MASK
        self.qos = kind_byte >> QOS_SHIFT


def edge_args(hdr: Header, dst: int) -> dict:
    """Trace-span args forming one side of a cross-rank causal edge.

    The correlation tuple is already unique on the wire — EAGER/RTS
    frames by ``(src, dst, cid, tag, seq)`` per QoS class (the match-
    plane continuity gate depends on exactly that), DATA/CTS/FIN/ACK by
    ``(msgid, offset)`` — so send-side and deliver-side spans that both
    record it can be joined OFFLINE into happens-before edges
    (tools/mpicrit.py) with no wire-format change. Keep the two sides
    symmetric: a field dropped on one side silently orphans every edge
    of that kind, which is why tools/trace_lint.py's ``edge-key`` rule
    gates both span shapes."""
    return {"kind": hdr.kind, "src": hdr.src, "dst": dst,
            "cid": hdr.cid, "tag": hdr.tag, "seq": hdr.seq,
            "msgid": hdr.msgid, "offset": hdr.offset,
            "nbytes": hdr.nbytes, "qos": hdr.qos}


class SendRequest(Request):
    def __init__(self, dst: int, tag: int, cid: int, nbytes: int):
        super().__init__()
        self.dst = dst
        self.tag = tag
        self.cid = cid
        self.nbytes = nbytes
        self.convertor: Optional[Convertor] = None
        self.msgid = 0


class RecvRequest(Request):
    def __init__(self, buf, count: int, datatype: Datatype,
                 src: int, tag: int, cid: int):
        super().__init__()
        self.buf = buf
        self.count = count
        self.datatype = datatype
        self.src = src  # may be ANY_SOURCE
        self.tag = tag  # may be ANY_TAG
        self.cid = cid
        self.convertor: Optional[Convertor] = None
        self.matched = False

    def matches(self, hdr: Header) -> bool:
        # ANY_TAG only matches user tags (>= 0): system-plane traffic
        # (osc/ft notices) uses negative tags and must never satisfy a
        # wildcard user receive. Collective and partitioned traffic is
        # isolated by dedicated CID planes instead (COLL_CID_BIT in
        # coll/basic.py, PART_CID_BIT in pml/partitioned.py) — both guards
        # are load-bearing; don't collapse one into the other.
        return (
            hdr.cid == self.cid
            and (self.src == ANY_SOURCE or self.src == hdr.src)
            and (hdr.tag >= 0 if self.tag == ANY_TAG
                 else self.tag == hdr.tag)
        )


class UnexpectedFrag:
    """An eager message or RTS that arrived before its receive was posted
    (reference: the unexpected queue of match_one)."""

    __slots__ = ("hdr", "payload", "_aseq")

    def __init__(self, hdr: Header, payload: Optional[bytes]):
        self.hdr = hdr
        self.payload = payload


class MatchingEngine:
    """Posted-recv and unexpected queues with MPI matching semantics.

    Hash-bucketed (reference: the vectorized custom match engines of
    ompi/mca/pml/ob1/custommatch/ — the linear list scan of the base
    engine is a scale wall at hundreds of pending requests): fully-
    specified receives and every incoming fragment live in
    (cid, src, tag)-keyed deques, so an arrival matches in O(1);
    wildcard receives (ANY_SOURCE / ANY_TAG) ride a separate ordered
    overflow list. MPI's ordering rule — an arrival matches the
    EARLIEST-posted eligible receive, a receive matches the earliest-
    arrived eligible fragment — is kept across the two structures with
    monotonic posting / arrival sequence numbers: a bucket hit still
    loses to an older matching wildcard, and vice versa.
    """

    def __init__(self):
        self.lock = threading.RLock()
        self._posted_exact: Dict[Tuple[int, int, int], deque] = {}
        self._posted_wild: List[RecvRequest] = []
        self._unexpected: Dict[Tuple[int, int, int], deque] = {}
        self._pseq = 0  # posting order
        self._aseq = 0  # arrival order
        self._n_posted = 0
        self._n_unexpected = 0

    # ------------------------------------------------------------ counters
    @property
    def n_posted(self) -> int:
        return self._n_posted

    @property
    def n_unexpected(self) -> int:
        return self._n_unexpected

    def _depth(self, name: str, value: int) -> None:
        """Perfetto counter track mirroring the queue-depth pvars —
        recorded on BOTH edges so drains render, one site per name."""
        if _trace.enabled():
            _trace.counter(name, value, cat="pml")

    # Called with lock held -----------------------------------------------
    def post(self, req: RecvRequest) -> None:  # locked-by: self.lock
        req._pseq = self._pseq
        self._pseq += 1
        self._n_posted += 1
        self._depth("pml.posted_queue", self._n_posted)
        if req.src == ANY_SOURCE or req.tag == ANY_TAG:
            self._posted_wild.append(req)
        else:
            self._posted_exact.setdefault(
                (req.cid, req.src, req.tag), deque()).append(req)

    def cancel_posted(self, req: RecvRequest) -> bool:  # locked-by: self.lock
        """Remove a still-pending posted receive; False if already
        matched/absent."""
        if req.matched:
            return False
        if req.src == ANY_SOURCE or req.tag == ANY_TAG:
            try:
                self._posted_wild.remove(req)
            except ValueError:
                return False
        else:
            q = self._posted_exact.get((req.cid, req.src, req.tag))
            if q is None or req not in q:
                return False
            q.remove(req)
            if not q:
                del self._posted_exact[(req.cid, req.src, req.tag)]
        self._n_posted -= 1
        self._depth("pml.posted_queue", self._n_posted)
        return True

    def match_posted(self, hdr: Header) -> Optional[RecvRequest]:  # locked-by: self.lock
        q = self._posted_exact.get((hdr.cid, hdr.src, hdr.tag))
        exact = q[0] if q else None
        wild = None
        for cand in self._posted_wild:
            if cand.matches(hdr):
                wild = cand
                break
        req = None
        if exact is not None and (wild is None
                                  or exact._pseq < wild._pseq):
            req = q.popleft()
            if not q:
                del self._posted_exact[(hdr.cid, hdr.src, hdr.tag)]
        elif wild is not None:
            req = wild
            self._posted_wild.remove(wild)
        if req is None:
            return None
        self._n_posted -= 1
        self._depth("pml.posted_queue", self._n_posted)
        req.matched = True
        req.status.source = hdr.src
        req.status.tag = hdr.tag
        return req

    def add_unexpected(self, frag: UnexpectedFrag) -> None:  # locked-by: self.lock
        frag._aseq = self._aseq
        self._aseq += 1
        self._n_unexpected += 1
        self._depth("pml.unexpected_queue", self._n_unexpected)
        h = frag.hdr
        self._unexpected.setdefault((h.cid, h.src, h.tag),
                                    deque()).append(frag)

    def match_unexpected(self, req: RecvRequest,  # locked-by: self.lock
                         remove: bool = True) -> Optional[UnexpectedFrag]:
        """Earliest-arrived fragment matching ``req`` (which may carry
        wildcards — fragments never do)."""
        if req.src != ANY_SOURCE and req.tag != ANY_TAG:
            key = (req.cid, req.src, req.tag)
            q = self._unexpected.get(key)
            if not q:
                return None
            frag = q.popleft() if remove else q[0]
            if remove:
                if not q:
                    del self._unexpected[key]
                self._n_unexpected -= 1
                self._depth("pml.unexpected_queue", self._n_unexpected)
            return frag
        best_key = None
        best = None
        for key, q in self._unexpected.items():
            head = q[0]
            if (best is None or head._aseq < best._aseq) and \
                    req.matches(head.hdr):
                best, best_key = head, key
        if best is None:
            return None
        if remove:
            q = self._unexpected[best_key]
            q.popleft()
            if not q:
                del self._unexpected[best_key]
            self._n_unexpected -= 1
            self._depth("pml.unexpected_queue", self._n_unexpected)
        return best

    def _drain_posted(self, want_key, want_wild) -> List[RecvRequest]:  # locked-by: self.lock
        """Shared removal+accounting body of the two failure drains:
        pop every ``_posted_exact`` bucket whose (cid, src, tag) key
        ``want_key`` accepts and every wildcard receive ``want_wild``
        accepts, mark them matched (a late cancel_posted must no-op),
        and settle the depth counter once. Call with the engine lock
        held (it is an RLock; the pml's failure callbacks hold it)."""
        out: List[RecvRequest] = []
        for key in [k for k in self._posted_exact if want_key(k)]:
            out.extend(self._posted_exact.pop(key))
        doomed_wild = [req for req in self._posted_wild
                       if want_wild(req)]
        for req in doomed_wild:
            self._posted_wild.remove(req)
        out.extend(doomed_wild)
        for req in out:
            req.matched = True
            self._n_posted -= 1
        if out:
            self._depth("pml.posted_queue", self._n_posted)
        return out

    def drain_posted_for_src(self, src: int) -> List[RecvRequest]:  # locked-by: self.lock
        """Remove every posted receive NAMING ``src`` (the ULFM
        peer-death drain: the pml completes them with ERR_PROC_FAILED) —
        both the fully-specified bucket entries and named-source ANY_TAG
        receives parked on the wildcard list. Only ANY_SOURCE receives
        stay posted — a live sender may still match them, which is
        exactly the MPI_ERR_PROC_FAILED_PENDING nuance."""
        return self._drain_posted(lambda k: k[1] == src,
                                  lambda req: req.src == src)

    def drain_posted_for_cids(self, cids) -> List[RecvRequest]:  # locked-by: self.lock
        """Remove every posted receive on one of the ``cids`` planes
        (the ULFM revoke drain: the pml completes them with
        ERR_REVOKED). Unlike the peer-death drain, ANY_SOURCE receives
        go too — revocation dooms the whole communicator, so there is
        no live sender left whose match should be awaited (MPI 4.x
        MPI_Comm_revoke semantics: pending operations on the revoked
        communicator complete raising an exception)."""
        return self._drain_posted(lambda k: k[0] in cids,
                                  lambda req: req.cid in cids)

    def find_unexpected(self, src: int, tag: int, cid: int) -> Optional[UnexpectedFrag]:
        probe = RecvRequest(None, 0, None, src, tag, cid)  # matcher only
        return self.match_unexpected(probe, remove=False)

    def debug_state(self, now: float, cap: int = 64) -> dict:  # locked-by: self.lock
        """Forensics snapshot of the matching queues (runtime/forensics
        introspection contract): per-key posted/unexpected depths with
        the oldest entry's posting/arrival order and age, clipped to
        ``cap`` keys. Call with the engine lock held — the pml's
        provider wraps this so the queues and the protocol dicts are
        one consistent cut."""

        def born(req) -> Optional[float]:
            t = getattr(req, "_fx_born", None)
            return None if t is None else round(now - t, 3)

        posted = []
        for (cid, src, tag), q in self._posted_exact.items():
            if len(posted) >= cap:
                break
            posted.append({"cid": cid, "src": src, "tag": tag,
                           "n": len(q), "oldest_pseq": q[0]._pseq,
                           "oldest_age_s": born(q[0])})
        wild = [{"cid": r.cid, "src": r.src, "tag": r.tag,
                 "pseq": r._pseq, "age_s": born(r)}
                for r in self._posted_wild[:cap]]
        unexpected = []
        for (cid, src, tag), q in self._unexpected.items():
            if len(unexpected) >= cap:
                break
            unexpected.append({"cid": cid, "src": src, "tag": tag,
                               "n": len(q), "oldest_aseq": q[0]._aseq,
                               "nbytes": q[0].hdr.nbytes})
        return {
            "n_posted": self._n_posted,
            "n_unexpected": self._n_unexpected,
            "posted": posted,
            "posted_omitted": max(0, len(self._posted_exact)
                                  - len(posted)),
            "posted_wild": wild,
            "unexpected": unexpected,
            "unexpected_omitted": max(0, len(self._unexpected)
                                      - len(unexpected)),
        }
