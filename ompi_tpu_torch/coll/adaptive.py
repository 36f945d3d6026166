"""coll/adapt — event-driven segment-pipelined tree collectives.

The port of ``ompi_tpu/coll/adaptive.py`` (reference: ompi/mca/coll/adapt,
coll_adapt_ibcast.c / coll_adapt_ireduce.c), with the same tree, segment
tags (``_TAG_BASE - i``) and segment sizes, so that ranks of the two
packages pipeline one tree in one job. bcast/reduce run as SEGMENTED
binomial trees where every segment moves the moment it is available,
driven by request-completion callbacks rather than round barriers: an
inner node starts forwarding segment 0 to its subtree while segment 1 is
still in flight from its parent. Disabled by default, as in the reference
(``coll_adapt_enable``).

- the event engine is the framework's request-completion callbacks
  (core/request.py ``add_completion_callback`` — fired from the progress
  thread or from polled progress);
- per-segment views of one contiguous staging buffer;
- reduce takes commutative ops only (children's segments combine in
  ARRIVAL order) and delegates non-commutative and heterogeneous cases to
  the basic linear algorithm. Typed combines go through coll/basic's
  ``_reduce_typed`` (numpy for numpy's dtypes, torch for bf16).
"""

from __future__ import annotations

import threading
from typing import Any, List, Optional

import numpy as np

from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.coll.basic import (
    BasicColl,
    _ccid,
    _reduce_typed,
    _typed_view,
)
from ompi_tpu_torch.comm.communicator import parse_buffer
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.convertor import pack as cv_pack, unpack as cv_unpack
from ompi_tpu_torch.core.datatype import BYTE
from ompi_tpu_torch.core.errors import MPIError
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.runtime.progress import progress_until

register_var("coll_adapt", "enable", False,
             help="Event-driven segment-pipelined tree bcast/reduce "
                  "(reference: ompi/mca/coll/adapt, disabled by default "
                  "there too)", level=5)
register_var("coll_adapt", "segsize", 1 << 16,
             help="Pipeline segment size in bytes (reference: "
                  "coll_adapt_ibcast_segment_size)", level=6)

_TAG_BASE = -1000  # per-segment tags: _TAG_BASE - seg_index (coll plane)
_MAX_SEGS = 2048   # tag budget; larger messages grow the segment size


def _tree(rank: int, n: int, root: int):
    """Binomial tree in root-rotated coordinates: returns (parent,
    children) as comm ranks. parent(v) clears v's lowest set bit;
    children(v) set one bit below it (reference: the in-order binomial
    of coll_base_topo)."""
    v = (rank - root) % n
    if v == 0:
        parent = None
        low = 1
        while low < n:
            low <<= 1
    else:
        low = v & -v
        parent = (v & (v - 1))
    children = []
    k = 1
    while k < low:
        c = v | k
        if c < n and c != v:
            children.append(c)
        k <<= 1
    to_rank = lambda u: (u + root) % n
    return (None if parent is None else to_rank(parent)), \
        [to_rank(c) for c in children]


def _segments(nbytes: int, item: int = 1) -> List[tuple]:
    """(offset, length) pipeline segments: the configured size rounded
    to the ``item`` granule (element-typed reduces must not split an
    element), doubled while the tag budget would overflow."""
    seg = max(int(get_var("coll_adapt", "segsize")) // item, 1) * item
    while nbytes > seg * _MAX_SEGS:
        seg *= 2
    return [(off, min(seg, nbytes - off))
            for off in range(0, nbytes, seg)] or [(0, 0)]


class AdaptColl(CollModule):
    """Segment-pipelined binomial bcast/reduce."""

    def __init__(self):
        self._flat = BasicColl()

    # ---------------------------------------------------------------- bcast
    def bcast(self, comm, buf, root: int) -> None:
        obj, count, dt = parse_buffer(buf)
        nbytes = count * dt.size
        n, r = comm.size, comm.rank
        if nbytes == 0 or n == 1:
            return
        parent, children = _tree(r, n, root)
        cid = _ccid(comm)
        if r == root:
            packed = np.ascontiguousarray(cv_pack(obj, count, dt)
                                          ).view(np.uint8).reshape(-1)
        else:
            packed = np.empty(nbytes, np.uint8)
        segs = _segments(nbytes)
        fwd: List[Any] = []
        fwd_err: List[MPIError] = []
        fwd_lock = threading.Lock()

        def forward(i: int) -> None:
            off, ln = segs[i]
            view = packed[off: off + ln]
            for c in children:
                try:
                    q = comm.pml.isend(view, ln, BYTE,
                                       comm.group.world_rank(c),
                                       _TAG_BASE - i, cid)
                except MPIError as e:
                    # callback context: record, don't throw into the
                    # progress thread (the waiter re-raises)
                    with fwd_lock:
                        fwd_err.append(e)
                    return
                with fwd_lock:
                    fwd.append(q)

        if r == root:
            # the root has every segment: the whole pipeline is enqueued
            # at once, per child in segment order
            for i in range(len(segs)):
                forward(i)
            rreqs: List[Any] = []
        else:
            rreqs = []
            pw = comm.group.world_rank(parent)
            for i, (off, ln) in enumerate(segs):
                req = comm.pml.irecv(packed[off: off + ln], ln, BYTE,
                                     pw, _TAG_BASE - i, cid)
                if children:
                    # EVENT-DRIVEN forward: the progress thread fires
                    # this the moment segment i lands — no waiting for
                    # later segments (the adapt property)
                    req.add_completion_callback(
                        lambda _q, i=i: forward(i))
                rreqs.append(req)
        for q in rreqs:
            q.Wait()
        # a recv's Wait can return BEFORE its completion callback posted
        # the forwards (the event flips first) — drain by EXPECTED post
        # count, not by the current snapshot, or the node exits with
        # segment sends unposted and a later same-tag send can overtake
        expected = len(children) * len(segs)

        def fwd_done() -> bool:
            with fwd_lock:
                if fwd_err:
                    return True
                return len(fwd) == expected and \
                    all(q.is_complete for q in fwd)

        progress_until(fwd_done)
        if fwd_err:
            raise fwd_err[0]
        if r != root:
            cv_unpack(packed, obj, count, dt)

    # --------------------------------------------------------------- reduce
    def reduce(self, comm, sendbuf, recvbuf, op: _op.Op,
               root: int) -> None:
        obj_s, count, dt = parse_buffer(
            recvbuf if sendbuf is None else sendbuf)
        nbytes = count * dt.size
        n, r = comm.size, comm.rank
        if nbytes == 0 or n == 1:
            if r == root and sendbuf is not None:
                obj_r, rcount, rdt = parse_buffer(recvbuf)
                cv_unpack(np.ascontiguousarray(
                    cv_pack(obj_s, count, dt)).view(np.uint8
                                                    ).reshape(-1),
                          obj_r, rcount, rdt)
            return
        if not op.commutative:
            # arrival-order combining needs commutativity (reference:
            # adapt ireduce has the same constraint)
            return self._flat.reduce(comm, sendbuf, recvbuf, op, root)
        acc = np.ascontiguousarray(cv_pack(obj_s, count, dt)
                                   ).view(np.uint8).reshape(-1).copy()
        try:
            _typed_view(acc[: dt.size], dt)
        except MPIError:
            return self._flat.reduce(comm, sendbuf, recvbuf, op, root)
        parent, children = _tree(r, n, root)
        cid = _ccid(comm)
        # element-granular segments: the typed combine must not split
        # an element across a segment boundary
        item = _typed_view(acc[: dt.size], dt).dtype.itemsize
        segs = _segments(nbytes, item)
        lock = threading.Lock()
        remaining = [len(children)] * len(segs)
        up: List[Any] = []
        up_err: List[MPIError] = []
        done = threading.Event()
        n_pending = [len(segs)]
        pw = None if parent is None else comm.group.world_rank(parent)

        def seg_ready(i: int) -> None:
            """All children contributed segment i: push it upward (or,
            at the root, count it complete)."""
            off, ln = segs[i]
            if pw is not None:
                try:
                    q = comm.pml.isend(acc[off: off + ln], ln, BYTE, pw,
                                       _TAG_BASE - i, cid)
                except MPIError as e:
                    # callback context: record and unblock the waiter
                    # (which re-raises) instead of throwing into the
                    # progress thread
                    with lock:
                        up_err.append(e)
                        done.set()
                    return
            with lock:
                if pw is not None:
                    up.append(q)
                n_pending[0] -= 1
                if n_pending[0] == 0:
                    done.set()

        if not children:
            for i in range(len(segs)):
                seg_ready(i)
        else:
            # ONE contiguous staging buffer per child (views per
            # segment) — per-(child, segment) allocations would peak at
            # n_children x message_size of scattered buffers
            for c in children:
                cw = comm.group.world_rank(c)
                stage = np.empty(nbytes, np.uint8)
                for i, (off, ln) in enumerate(segs):
                    tmp = stage[off: off + ln]
                    req = comm.pml.irecv(tmp, ln, BYTE, cw,
                                         _TAG_BASE - i, cid)

                    def landed(_q, i=i, tmp=tmp, off=off, ln=ln):
                        # combine in ARRIVAL order under the lock
                        # (commutative ops only — checked above)
                        with lock:
                            a = _typed_view(acc[off: off + ln], dt)
                            b = _typed_view(tmp, dt)
                            a[...] = _reduce_typed(op, a, b)
                            remaining[i] -= 1
                            fire = remaining[i] == 0
                        if fire:
                            seg_ready(i)

                    req.add_completion_callback(landed)
        progress_until(done.is_set)
        if up_err:
            raise up_err[0]

        # `up` is complete-by-construction when done fires (sends append
        # under the lock before the last n_pending decrement), but their
        # DELIVERY may still be in flight — drain them
        def up_done() -> bool:
            with lock:
                return all(q.is_complete for q in up)

        progress_until(up_done)
        if r == root:
            obj_r, rcount, rdt = parse_buffer(recvbuf)
            cv_unpack(acc, obj_r, rcount, rdt)


class AdaptCollComponent(Component):
    NAME = "adapt"
    PRIORITY = 48  # above tuned(30)/han(45), below coll/sm(50): on one
    # node the segment collectives win; adapt targets deep trees

    def query(self, comm=None, **ctx: Any) -> Optional[AdaptColl]:
        from ompi_tpu_torch.comm.communicator import ProcComm

        if not get_var("coll_adapt", "enable"):
            return None
        if not isinstance(comm, ProcComm) or comm.size < 2:
            return None
        return AdaptColl()


coll_framework.register(AdaptCollComponent())
