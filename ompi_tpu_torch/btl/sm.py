"""Shared-memory transport — the default same-host data path.

The port of ``ompi_tpu/btl/sm.py``: the same segment header
(``_SEG_HDR``), ring layout, frame flags and overflow files, so a segment
made by either package is read by the other.

Reference: opal/mca/btl/sm (2,690 LoC): each process owns a shared
segment; senders write into per-peer FIFOs inside the *receiver's*
segment (btl_sm_sendi.c), so delivery is a single copy and the receiver
polls only its own memory. Redesign notes:

- The FIFO is the lock-free SPSC byte ring of native/sm_ring.cpp (C++
  data plane via ctypes, Python path with identical layout) — the
  fastbox small-message path and the FIFO collapse into one ring, since
  the ring already moves small frames with one memcpy + one atomic
  store each way. ``btl_sm_use_native=1`` means the native ring: a
  library that does not build raises ``NativeBuildError``; the Python
  ring runs only under ``btl_sm_use_native=0``.
- Single-copy "smsc" analog: there is no second copy to elide — the
  sender gathers header+payload straight into the ring, and the receiver
  hands the popped frame to the PML, which unpacks straight into the
  posted buffer.
- Full-ring backpressure mirrors btl/tcp's pending-frag queue: send()
  never blocks; unflushed frames drain from progress().
- Payloads may be CPU tensors, viewed as bytes without a copy; a tensor
  off the CPU raises ``TypeError`` (``btl.base.host_bytes``).
- ``finalize`` also removes the overflow files this btl wrote that no
  peer consumed, and a failed ring build leaves no segment behind.

Business card (modex): ``btl.sm.seg`` = segment path, ``btl.sm.node`` =
boot id (same-kernel check — the reference uses PMIx locality flags).
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import threading
from collections import deque
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from ompi_tpu_torch.btl.base import Btl, btl_framework, host_bytes
from ompi_tpu_torch.core.errors import MPIError, ERR_OTHER
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.native.ring import SmRing, HDR_BYTES
from ompi_tpu_torch.pml.base import HDR_SIZE
from ompi_tpu_torch.utils.output import get_logger

register_var("btl_sm", "ring_bytes", 1 << 22,
             help="Per-sender ring size in the receiver's segment", level=4)
register_var("btl_sm", "eager_limit", 1 << 16,
             help="SM eager/rendezvous threshold in bytes", level=4)
register_var("btl_sm", "fail_after", -1,
             help="Fault injection for the bml failover tests: sends "
                  "start raising after N successful ones (-1 = off)",
             level=9)
register_var("btl_sm", "use_native", 1,
             help="Use the C++ ring data plane (0 = Python ring)",
             level=7)

_SEG_MAGIC = 0x534D5345474D4E54
_SEG_HDR = struct.Struct("<QQQ")  # magic, nranks, ring_bytes


def node_id() -> str:
    """Identity of this kernel instance (reference: PMIx locality)."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:
        import socket

        return socket.gethostname()


class SmBtl(Btl):
    # relative stripe weight for multi-btl rendezvous scheduling
    # (reference: opal btl_bandwidth; shared memory >> loopback tcp)
    bandwidth = 8

    NAME = "sm"

    def __init__(self, deliver: Callable[[bytes, bytes], None],
                 my_rank: int, n_ranks: int,
                 local_rank: Optional[int] = None):
        super().__init__(deliver)
        self.my_rank = my_rank            # universe rank (identity)
        # ring index inside same-job peers' segments (job-local; dynamic
        # processes from other jobs ride tcp instead — see wireup)
        self.local_rank = my_rank if local_rank is None else local_rank
        self.n_ranks = n_ranks
        self.eager_limit = get_var("btl_sm", "eager_limit")
        self.ring_bytes = int(get_var("btl_sm", "ring_bytes"))
        self.use_native = bool(get_var("btl_sm", "use_native"))
        self.fail_after = int(get_var("btl_sm", "fail_after"))
        self._sends_done = 0  # mpiracer: relaxed-counter — fault-injection trigger only (fail_after >= 0 in chaos runs); a lost bump shifts the injected failure by one op
        self.log = get_logger("btl.sm")

        # My segment: one inbound ring slot per potential sender, indexed
        # by world rank. The file is SPARSE (ftruncate, no write-out):
        # tmpfs only materializes pages that are touched, so the physical
        # footprint is one header page per ring plus whatever same-node
        # peers actually fill — proportional to ranks-per-node even though
        # the virtual size is proportional to world size (the reference
        # instead indexes by node-local rank from PMIx locality; world-rank
        # indexing keeps senders offset-computable without a handshake).
        shm_dir = "/dev/shm" if os.path.isdir("/dev/shm") else None
        fd, self.seg_path = tempfile.mkstemp(
            prefix=f"ompi_tpu_sm_r{my_rank}_", suffix=".seg", dir=shm_dir)
        seg_bytes = 64 + n_ranks * self.ring_bytes
        os.ftruncate(fd, seg_bytes)
        self.seg_mm = mmap.mmap(fd, seg_bytes)
        os.close(fd)
        _SEG_HDR.pack_into(self.seg_mm, 0, _SEG_MAGIC, n_ranks,
                           self.ring_bytes)
        self.inbound = []
        try:
            for r in range(n_ranks):
                ring = SmRing(self.seg_mm, 64 + r * self.ring_bytes,
                              self.ring_bytes, use_native=self.use_native)
                ring.init()
                self.inbound.append(ring)
        except BaseException:
            # a native ring that does not build raises: leave no segment
            self.inbound.clear()
            self._close_segment()
            raise
        # spill files this btl wrote: finalize removes those nobody read
        self._spills: set = set()

        # peer state: world rank -> (mmap, ring-into-peer)
        self.peers: Dict[int, str] = {}
        self._out: Dict[int, Tuple[mmap.mmap, SmRing]] = {}
        self._pending: Dict[int, deque] = {}
        self._out_lock = threading.Lock()
        self._progress_lock = threading.Lock()
        self._closed = False

    # ------------------------------------------------------------- wiring
    def set_peers(self, peers: Dict[int, str]) -> None:
        """peer world-rank -> segment path (from the modex)."""
        self.peers = dict(peers)

    def _attach(self, peer: int) -> SmRing:  # locked-by: self._out_lock
        path = self.peers[peer]
        fd = os.open(path, os.O_RDWR)
        try:
            mm = mmap.mmap(fd, os.fstat(fd).st_size)
        finally:
            os.close(fd)
        magic, nranks, ring_bytes = _SEG_HDR.unpack_from(mm, 0)
        if magic != _SEG_MAGIC or self.local_rank >= nranks:
            raise RuntimeError(f"bad sm segment {path}")
        ring = SmRing(mm, 64 + self.local_rank * ring_bytes, ring_bytes,
                      use_native=self.use_native)
        self._out[peer] = (mm, ring)
        return ring

    def _out_ring(self, peer: int) -> SmRing:
        with self._out_lock:
            ent = self._out.get(peer)
            if ent is None:
                return self._attach(peer)
            return ent[1]

    # --------------------------------------------------------------- send
    # Frame layout inside the ring: [u64 flags][pml header][payload].
    # flags=0: payload inline. flags=1: overflow — the payload lives in a
    # side file (path in the frame body); the system-tag plane (osc active
    # messages) ships unbounded single frames, which must never fail just
    # because they exceed the ring (reference: btl/sm falls back to
    # single-copy smsc for what the fifo can't hold).
    _INLINE = struct.pack("<Q", 0)
    _OVERFLOW = struct.pack("<Q", 1)

    def send(self, peer: int, header: bytes, payload) -> None:
        if self.fail_after >= 0:  # fault injection (off = -1, no cost)
            self._sends_done += 1
            if self._sends_done > self.fail_after:
                raise MPIError(ERR_OTHER,
                               "btl/sm fault injection: channel down")
        payload = host_bytes(payload)
        ring = self._out_ring(peer)
        plen = (payload.nbytes if hasattr(payload, "nbytes")
                else len(payload) if isinstance(payload, (bytes, bytearray))
                else memoryview(payload).nbytes)
        with self._out_lock:
            pend = self._pending.setdefault(peer, deque())
            # A frame that can NEVER fit inline must spill regardless of
            # queue state: queued inline it would make _flush() spin on
            # push()==-1 forever and wedge this peer's channel.
            if not ring.can_fit(8 + len(header) + plen):
                self._send_overflow(ring, pend, peer, header, payload)
                return
            if not pend:
                rc = ring.push(self._INLINE + header, payload)
                if rc == 1:
                    return
                if rc < 0:  # unreachable after the pre-screen; keep safe
                    self._send_overflow(ring, pend, peer, header, payload)
                    return
            # ring full: queue, preserve per-peer order (the tcp write-
            # queue pattern). Ownership boundary: the caller may reuse
            # its buffer once send() returns, so queued payloads must
            # be owned — same one-copy-under-backpressure contract as
            # tcp's write queue.
            if not isinstance(payload, (bytes, bytearray)):
                if hasattr(payload, "tobytes"):
                    payload = payload.tobytes()
                else:
                    payload = bytes(memoryview(payload).cast("B"))  # mpilint: disable=hot-copy — ownership copy at the queue boundary (buffered-send semantics)
            pend.append((self._INLINE + header, payload))

    def drain_pending(self, peer: int):
        """Hand undelivered queued frames for ``peer`` to the bml
        failover re-drive (pml._send_frame). Overflow markers are
        reconstituted into real payloads — the replacement transport
        knows nothing of the spill-file convention."""
        with self._out_lock:
            pend = self._pending.pop(peer, None)
        out = []
        if not pend:
            return out
        for flagged, payload in pend:
            flag, hdr = flagged[:8], flagged[8:]
            if flag == self._OVERFLOW:
                path = bytes(payload).decode()
                try:
                    with open(path, "rb") as f:
                        data = f.read()
                    os.unlink(path)
                except OSError:
                    continue
                out.append((hdr, data))
            else:
                out.append((hdr, payload))
        return out

    def _spill(self, payload) -> bytes:
        """Write payload to a side file; return the path (marker body)."""
        fd, path = tempfile.mkstemp(
            prefix=f"ompi_tpu_ovf_r{self.my_rank}_",
            dir=os.path.dirname(self.seg_path) or None)
        if isinstance(payload, np.ndarray):
            # a strided view (of a tensor or an array) has no flat buffer
            payload = np.ascontiguousarray(payload).reshape(-1).view(np.uint8)
        with os.fdopen(fd, "wb") as f:
            f.write(payload if isinstance(payload, (bytes, bytearray))
                    else memoryview(payload).cast("B"))
        self._spills.add(path)
        return path.encode()

    def _send_overflow(self, ring, pend, peer: int, header: bytes,
                       payload) -> None:
        """Caller holds _out_lock. Spill an over-ring-size payload to a
        side file; the tiny marker frame keeps per-peer ordering."""
        marker = self._spill(payload)
        if pend or ring.push(self._OVERFLOW + header, marker) != 1:
            pend.append((self._OVERFLOW + header, marker))

    def _flush(self) -> int:
        n = 0
        with self._out_lock:
            for peer, pend in self._pending.items():
                ring = self._out.get(peer)
                if ring is None:
                    continue
                ring = ring[1]
                while pend:
                    hdr, payload = pend[0]
                    rc = ring.push(hdr, payload)
                    if rc == 1:
                        pend.popleft()
                        n += 1
                        continue
                    if rc < 0 and hdr[:8] == self._INLINE:
                        # belt-and-braces: convert in place so the channel
                        # stays live instead of wedging (ordering kept).
                        # Only INLINE frames convert, and only once — a
                        # still-failing push (e.g. corrupt ring magic)
                        # must stall here, not spin spawning spill files.
                        pend[0] = (self._OVERFLOW + hdr[8:],
                                   self._spill(payload))
                        continue
                    break  # rc == 0 (full) or unconvertible: retry later
        return n

    # ----------------------------------------------------------- progress
    def progress(self) -> int:
        if self._closed:
            return 0
        if not self._progress_lock.acquire(blocking=False):
            return 0
        try:
            n = self._flush()
            for ring in self.inbound:
                while True:
                    frame = ring.peek()  # zero-copy view into the ring
                    if frame is None:
                        break
                    try:
                        flags = struct.unpack_from("<Q", frame, 0)[0]
                        hdr = bytes(frame[8 : 8 + HDR_SIZE])  # mpilint: disable=hot-copy — 49-byte header outlives ring.advance(); the slot is recycled under it
                        if flags == 1:  # overflow: body is the spill path
                            path = bytes(frame[8 + HDR_SIZE :]).decode()  # mpilint: disable=hot-copy — tiny spill-file path, consumed before the slot recycles
                            with open(path, "rb") as f:
                                payload = f.read()
                            os.unlink(path)
                            self.deliver(hdr, payload)
                        else:
                            # matched receives unpack straight from shared
                            # memory; the pml copies only on the unexpected
                            # path (single-copy delivery, btl_sm_sendi.c)
                            self.deliver(hdr, frame[8 + HDR_SIZE :])
                    except Exception:
                        self.log.exception(
                            "frame handler failed (frame dropped)")
                    finally:
                        ring.advance()
                    n += 1
            return n
        finally:
            self._progress_lock.release()

    def finalize(self) -> None:
        self._closed = True
        with self._out_lock:
            for mm, _ in self._out.values():
                try:
                    mm.close()
                except (BufferError, ValueError):
                    pass
            self._out.clear()
            self._pending.clear()
            spills, self._spills = self._spills, set()
        # spill files the peer never consumed (it unlinks those it reads);
        # the reference leaves them in /dev/shm
        for path in spills:
            try:
                os.unlink(path)
            except OSError:
                pass
        self._close_segment()

    def _close_segment(self) -> None:
        try:
            self.seg_mm.close()
        except (BufferError, ValueError):
            pass  # ctypes from_buffer holds an export; the OS reclaims
        try:
            os.unlink(self.seg_path)
        except OSError:
            pass


class SmBtlComponent(Component):
    NAME = "sm"
    PRIORITY = 30  # above tcp (20): same-host peers prefer shared memory

    def query(self, deliver=None, my_rank=None, n_ranks=None,
              local_rank=None, **ctx):
        if deliver is None or my_rank is None or n_ranks is None:
            return None
        try:
            return SmBtl(deliver, my_rank, n_ranks, local_rank)
        except OSError:
            return None


btl_framework.register(SmBtlComponent())
