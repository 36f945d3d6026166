"""coll/sm — single-segment shared-memory collectives (coll/xhc analog).

The port of ``ompi_tpu/coll/smcoll.py`` (reference: ompi/mca/coll/xhc,
coll_xhc_allreduce.c) with the reference's segment byte for byte — the
header (``2*n*8 + 64``, page-aligned), the slot and result offsets, the
ticket arithmetic and the element-slice split — so that ranks of the two
packages share one segment in one job. When every member of a
communicator lives on one node, collectives are segment-resident memcpys
plus flag rotation, not per-message pml frames. This component claims the
all-local ProcComms at a priority above tuned/han; every other slot falls
through the per-slot table as usual.

Design (flat xhc, sized for the <=16-rank single-host shape):

- ONE mmap segment per communicator, created lazily inside the first
  collective by rank 0 and announced over the pml (tag ``_TAG_BOOT``).
- Synchronization is monotonic TICKETS: every rank derives the same ticket
  sequence from the (identical) sequence of collective calls, so flags
  never reset and reuse is guarded by comparing per-rank counters against
  the ticket that last used a buffer. arrive[i]/ack[i] live in their own
  cache lines.
- bcast: root streams the payload through two chunk-sized halves (double
  buffering); readers spin on the published ticket.
- allreduce: contributions land in per-rank slots; each rank reduces its
  contiguous ELEMENT SLICE across all slots (ascending rank order) into
  the result area; after a flag phase every rank copies the full reduced
  chunk out. bf16 reduces per slice through coll/basic's
  ``_reduce_typed`` (f32 rounded to nearest even).

Memory model: flag-after-data ordering relies on total store order (x86)
plus the GIL serializing each rank's numpy stores; on weaker architectures
a real fence would be needed (the reference uses opal_atomic_wmb() at
exactly these two points), so the component declines there. Every segment
write is a numpy store on the segment's views (never a tensor copy, which
may run on several threads), and the flags are int64 views.
"""

from __future__ import annotations

import mmap
import time
from typing import Any, Optional

import numpy as np

from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.coll.basic import (
    BasicColl,
    _ccid,
    _reduce_typed,
    _typed_view,
    _wire,
)
from ompi_tpu_torch.comm.communicator import parse_buffer
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.convertor import pack as cv_pack, unpack as cv_unpack
from ompi_tpu_torch.core.datatype import BYTE
from ompi_tpu_torch.core.errors import MPIError, ERR_INTERN
from ompi_tpu_torch.core.request import _MULTICORE
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.runtime.progress import progress

register_var("coll_sm", "enable", True,
             help="Shared-memory collectives for all-local communicators "
                  "(reference: ompi/mca/coll/xhc)", level=4)
register_var("coll_sm", "chunk_bytes", 1 << 20,
             help="Segment chunk size: bcast double-buffers 2 chunks, "
                  "allreduce stages one chunk per rank", level=6)

_TAG_BOOT = -31  # segment announcement (coll cid plane; -30 is TAG_TUNED)
_SPIN_TIMEOUT = 120.0


class SmColl(CollModule):
    """Segment-resident barrier/bcast/allreduce for one-node comms."""

    def __init__(self):
        self._flat = BasicColl()
        self._mm: Optional[mmap.mmap] = None
        self._seg = None
        self._flags: Optional[np.ndarray] = None  # int64 header view
        self._ticket = 0
        self._half_ticket = [0, 0]  # last ticket using each bcast half
        self._path = None

    # ----------------------------------------------------------- bootstrap
    def _segment(self, comm):
        """Map the comm's segment, creating+announcing it on first use."""
        if self._mm is not None:
            return
        n = comm.size
        chunk = int(get_var("coll_sm", "chunk_bytes"))
        hdr = 2 * n * 8 + 64          # arrive[n] + ack[n] lines + pub line
        hdr = (hdr + 4095) & ~4095    # page-align the data area
        size = hdr + n * chunk + 2 * chunk
        from ompi_tpu_torch.runtime import mpool

        with spc.suppressed():
            if comm.rank == 0:
                self._seg = mpool.create_segment(
                    size, prefix=f"ompi_tpu_collsm_{comm.cid}_")
                msg = self._seg.path.encode()
                payload = np.frombuffer(msg, np.uint8)
                reqs = [comm.pml.isend(payload, len(msg), BYTE,
                                       comm.group.world_rank(r),
                                       _TAG_BOOT, _ccid(comm))
                        for r in range(1, n)]
                for q in reqs:
                    q.Wait()
                self._path = self._seg.path
            else:
                # PATH_MAX-sized: a long TMPDIR mkstemp path must not
                # truncate the announcement
                buf = np.empty(4096, np.uint8)
                req = comm.pml.irecv(buf, 4096, BYTE,
                                     comm.group.world_rank(0),
                                     _TAG_BOOT, _ccid(comm))
                req.Wait()
                path = bytes(buf[: req.status._nbytes]).decode()
                self._seg = mpool.attach_segment(path, size)
            # all mapped before the creator unlinks (the file then frees
            # itself when the last process exits, crash included)
            self._flat.barrier(comm)
            if comm.rank == 0:
                self._seg.unlink()
        self._mm = self._seg.mm
        self._n = n
        self._chunk = chunk
        self._hdr = hdr
        self._flags = self._seg.view(0, (hdr // 8) * 8, np.int64)
        self._data = self._seg.view(hdr, size - hdr)

    # arrive[i] at flag index 8*i; ack[i] at 8*(n+i); pub at 8*2n
    def _spin(self, cond) -> None:
        """Wait for a segment flag condition. Multicore: tight spin
        (peers make progress in parallel; the condition resolves in
        microseconds), polling the progress engine occasionally. Single
        core: yield the CPU EVERY miss — a spinning rank burns the
        whole scheduler quantum the peer needs to arrive (this host's
        1-core CI showed 7ms flat barriers under a 256-spin cadence)."""
        deadline = time.monotonic() + _SPIN_TIMEOUT
        spins = 0
        while not cond():
            spins += 1
            if _MULTICORE:
                if spins & 1023 == 0:
                    progress()  # keep unrelated transports moving
                    if time.monotonic() > deadline:
                        raise MPIError(ERR_INTERN,
                                       "coll/sm: peer never arrived "
                                       "(flag spin timed out)")
            else:
                progress()
                time.sleep(0)  # hand the CPU to the peer
                if spins & 255 == 0 and time.monotonic() > deadline:
                    raise MPIError(ERR_INTERN,
                                   "coll/sm: peer never arrived "
                                   "(flag spin timed out)")

    def _phase(self, comm, t) -> None:
        """Flat all-see-all flag round: publish my arrival, wait for
        everyone's."""
        f, n, r = self._flags, self._n, comm.rank
        f[8 * r] = t
        arrive = f[0: 8 * n: 8]  # strided view: one vectorized compare
        self._spin(lambda: bool((arrive >= t).all()))

    # --------------------------------------------------------- collectives
    def barrier(self, comm) -> None:
        self._segment(comm)
        self._ticket += 1
        self._phase(comm, self._ticket)

    def bcast(self, comm, buf, root: int) -> None:
        self._segment(comm)
        obj, count, dt = parse_buffer(buf)
        nbytes = count * dt.size
        if nbytes == 0:
            return
        n, r = self._n, comm.rank
        f = self._flags
        data = self._data
        base = self._n * self._chunk  # bcast halves after the slots
        if r == root:
            packed = np.ascontiguousarray(cv_pack(obj, count, dt)
                                          ).view(np.uint8).reshape(-1)
        else:
            packed = np.empty(nbytes, np.uint8)
        for k, off in enumerate(range(0, nbytes, self._chunk)):
            ln = min(self._chunk, nbytes - off)
            half = k & 1
            hoff = base + half * self._chunk
            self._ticket += 1
            t = self._ticket
            if r == root:
                # reuse guard: everyone acked this half's previous use
                prev = self._half_ticket[half]
                acks = f[8 * n: 16 * n: 8]
                self._spin(lambda: bool((acks >= prev).all()))
                data[hoff: hoff + ln] = packed[off: off + ln]
                f[8 * 2 * n] = t          # publish AFTER the payload
                f[8 * (n + r)] = t        # root's own ack
            else:
                self._spin(lambda: f[8 * 2 * n] >= t)
                packed[off: off + ln] = data[hoff: hoff + ln]
                f[8 * (n + r)] = t
            self._half_ticket[half] = t
        if r != root:
            cv_unpack(packed, obj, count, dt)

    def allreduce(self, comm, sendbuf, recvbuf, op: _op.Op) -> None:
        self._segment(comm)
        src_buf = recvbuf if sendbuf is None else sendbuf  # IN_PLACE
        obj_s, count, dt = parse_buffer(src_buf)
        obj_r, rcount, rdt = parse_buffer(recvbuf)
        nbytes = count * dt.size
        if nbytes == 0:
            return
        packed = np.ascontiguousarray(cv_pack(obj_s, count, dt)
                                      ).view(np.uint8).reshape(-1)
        try:
            probe = _typed_view(packed[:dt.size], dt)
        except MPIError:
            # heterogeneous derived type: no typed segment view possible
            return self._flat.allreduce(comm, sendbuf, recvbuf, op)
        item = probe.dtype.itemsize
        n, r = self._n, comm.rank
        data = self._data
        out = np.empty(nbytes, np.uint8)
        # chunk on element boundaries
        chunk = max((self._chunk // item) * item, item)
        res_off = n * self._chunk  # result area (bcast half A)
        f = self._flags
        for off in range(0, nbytes, chunk):
            ln = min(chunk, nbytes - off)
            t1 = self._ticket + 1
            t2 = self._ticket + 2
            self._ticket += 2
            slot = r * self._chunk
            data[slot: slot + ln] = packed[off: off + ln]
            self._phase(comm, t1)       # all contributions visible
            # my element slice of this chunk, reduced in rank order
            nelem = ln // item
            q, rem = divmod(nelem, n)
            lo = (r * q + min(r, rem)) * item
            hi = lo + (q + (1 if r < rem else 0)) * item
            if hi > lo:
                acc = _typed_view(data[lo: hi].copy(), dt)  # rank-0 slot
                for j in range(1, n):
                    b = _typed_view(data[j * self._chunk + lo:
                                         j * self._chunk + hi].copy(), dt)
                    acc = _reduce_typed(op, acc, b)
                # a numpy store on the segment view, finished before the
                # flag store of the phase below
                data[res_off + lo: res_off + hi] = _wire(acc)
            self._phase(comm, t2)       # full reduced chunk visible
            out[off: off + ln] = data[res_off: res_off + ln]
            # no third phase: any later slot/result write happens only
            # after a subsequent _phase or ack-guard, which transitively
            # requires every rank to have passed this copy-out. The ack
            # below hands that guard to bcast's half-A reuse check.
            f[8 * (n + r)] = t2
            self._half_ticket[0] = t2
        cv_unpack(out, obj_r, rcount, rdt)

    def reduce(self, comm, sendbuf, recvbuf, op: _op.Op, root: int) -> None:
        """Segment allreduce, result kept at the root only (free
        strengthening — one extra local copy vs the pml fan-in)."""
        if comm.rank == root:
            return self.allreduce(comm, sendbuf, recvbuf, op)
        obj_s, count, dt = parse_buffer(
            recvbuf if sendbuf is None else sendbuf)
        scratch = np.empty(count * dt.size, np.uint8)  # discarded
        self.allreduce(comm, sendbuf if sendbuf is not None else recvbuf,
                       scratch, op)

    # ------------------------------------------- layout verbs (acoll set)
    # Reference: ompi/mca/coll/acoll (5,610 LoC) extends the xhc verb set
    # with single-node allgather/gather/scatter/alltoall. Same slot
    # protocol as allreduce: contributions land in per-rank slots, one
    # phase makes them visible, copy-out, one phase guards slot reuse.
    def _slot_rounds(self, comm, nbytes: int):
        """Yield (offset, length, t1, t2) chunk rounds over the per-rank
        slots; tickets derive from the shared call sequence."""
        for off in range(0, nbytes, self._chunk):
            t1 = self._ticket + 1
            t2 = self._ticket + 2
            self._ticket += 2
            yield off, min(self._chunk, nbytes - off), t1, t2

    def allgather(self, comm, sendbuf, recvbuf) -> None:
        self._segment(comm)
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt)
                                     ).view(np.uint8).reshape(-1)
        nb = block.nbytes
        if nb == 0:
            return
        n, r = self._n, comm.rank
        data = self._data
        out = np.empty(n * nb, np.uint8)
        slot = r * self._chunk
        for off, ln, t1, t2 in self._slot_rounds(comm, nb):
            data[slot: slot + ln] = block[off: off + ln]
            self._phase(comm, t1)       # all contributions visible
            for j in range(n):
                out[j * nb + off: j * nb + off + ln] = \
                    data[j * self._chunk: j * self._chunk + ln]
            self._phase(comm, t2)       # all copied: slots reusable
        spc.record_bytes("collsm_allgather", n * nb)
        cv_unpack(out, robj, rcount, rdt)

    def gather(self, comm, sendbuf, recvbuf, root: int) -> None:
        self._segment(comm)
        sobj, scount, sdt = parse_buffer(sendbuf)
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt)
                                     ).view(np.uint8).reshape(-1)
        nb = block.nbytes
        if nb == 0:
            return
        n, r = self._n, comm.rank
        data = self._data
        out = np.empty(n * nb, np.uint8) if r == root else None
        slot = r * self._chunk
        for off, ln, t1, t2 in self._slot_rounds(comm, nb):
            data[slot: slot + ln] = block[off: off + ln]
            self._phase(comm, t1)
            if r == root:
                for j in range(n):
                    out[j * nb + off: j * nb + off + ln] = \
                        data[j * self._chunk: j * self._chunk + ln]
            self._phase(comm, t2)
        if r == root:
            robj, rcount, rdt = parse_buffer(recvbuf)
            spc.record_bytes("collsm_gather", n * nb)
            cv_unpack(out, robj, rcount, rdt)

    def scatter(self, comm, sendbuf, recvbuf, root: int) -> None:
        self._segment(comm)
        robj, rcount, rdt = parse_buffer(recvbuf)
        nb = rcount * rdt.size
        if nb == 0:
            return
        n, r = self._n, comm.rank
        data = self._data
        packed = None
        if r == root:
            sobj, scount, sdt = parse_buffer(sendbuf)
            packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt)
                                          ).view(np.uint8).reshape(-1)
        out = np.empty(nb, np.uint8)
        slot = r * self._chunk
        for off, ln, t1, t2 in self._slot_rounds(comm, nb):
            if r == root:
                # root deals piece i of each rank into slot i
                for i in range(n):
                    data[i * self._chunk: i * self._chunk + ln] = \
                        packed[i * nb + off: i * nb + off + ln]
            self._phase(comm, t1)
            out[off: off + ln] = data[slot: slot + ln]
            self._phase(comm, t2)
        spc.record_bytes("collsm_scatter", nb)
        cv_unpack(out, robj, rcount, rdt)

    def alltoall(self, comm, sendbuf, recvbuf) -> None:
        self._segment(comm)
        if self._chunk < comm.size:
            # a slot can't hold even 1 byte per destination: the n
            # sub-block layout below would overflow into the next slot
            return self._flat.alltoall(comm, sendbuf, recvbuf)
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt)
                                      ).view(np.uint8).reshape(-1)
        n, r = self._n, comm.rank
        sz, rem = divmod(packed.nbytes, n)  # per-destination block
        if rem:
            # indivisible packed size: the sub-block layout below would
            # floor the remainder away and deliver uninitialized tail
            # bytes — delegate whole, like the chunk-too-small fallback
            # above (symmetric: alltoall counts match across
            # ranks, so every rank takes this branch together)
            return self._flat.alltoall(comm, sendbuf, recvbuf)
        if sz == 0:
            return
        data = self._data
        out = np.empty(packed.nbytes, np.uint8)
        slot = r * self._chunk
        per = max(self._chunk // n, 1)  # block bytes movable per round
        for off in range(0, sz, per):
            ln = min(per, sz - off)
            t1 = self._ticket + 1
            t2 = self._ticket + 2
            self._ticket += 2
            # my slot carries n sub-blocks: sub-block d goes to rank d
            for d in range(n):
                data[slot + d * ln: slot + (d + 1) * ln] = \
                    packed[d * sz + off: d * sz + off + ln]
            self._phase(comm, t1)
            # block from source s = s's sub-block addressed to me
            for s in range(n):
                out[s * sz + off: s * sz + off + ln] = \
                    data[s * self._chunk + r * ln:
                         s * self._chunk + (r + 1) * ln]
            self._phase(comm, t2)
        spc.record_bytes("collsm_alltoall", packed.nbytes)
        cv_unpack(out, robj, rcount, rdt)

    def __del__(self):  # pragma: no cover
        try:
            if self._seg is not None:
                self._seg.close()
        except Exception:
            pass


class SmCollComponent(Component):
    NAME = "sm"
    PRIORITY = 50  # above tuned(30)/han(45), below self(75) — the
    # reference runs xhc above tuned for all-local comms the same way

    def query(self, comm=None, **ctx: Any) -> Optional[SmColl]:
        import platform

        from ompi_tpu_torch.comm.communicator import ProcComm

        if not get_var("coll_sm", "enable"):
            return None
        if platform.machine() not in ("x86_64", "AMD64"):
            # the flag protocol relies on total store order (see module
            # docstring); on weak-memory hosts fall through to the pml
            # path rather than risk a flag outrunning its payload
            return None
        if not isinstance(comm, ProcComm) or comm.size < 2:
            return None
        if int(get_var("coll_han", "fake_nodes")) > 1:
            return None  # the fake multi-node hierarchy must win
        from ompi_tpu_torch.coll.han import HanCollComponent

        node_of = HanCollComponent._modex_node_map(comm)
        if node_of is None or len(set(node_of)) != 1:
            return None
        return SmColl()


coll_framework.register(SmCollComponent())
