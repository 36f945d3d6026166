"""mpool/rcache — shared-segment pool and registration cache.

The port of ``ompi_tpu/runtime/mpool.py``, whole.

Reference: opal/mca/mpool (memory pools handing out registered regions)
+ opal/mca/rcache (the registration cache that makes repeated
lookups of the same region free). On these hosts there are no NIC
registrations; what IS repeatedly created, mapped, sliced, and torn
down are /dev/shm mmap segments — by btl/sm (rings), coll/sm (segment
collectives), and osc (shared windows). This module owns that dance:

- ``create_segment`` / ``attach_segment``: one place for the
  mkstemp-ftruncate-mmap (resp. open-mmap) sequence with fd hygiene on
  every failure path.
- ``Segment.view(offset, nbytes[, dtype])``: the rcache analog — numpy
  views over a mapped region are memoized per (offset, nbytes, dtype),
  so hot paths re-resolving the same slot pay a dict hit instead of a
  frombuffer construction.
- a live-segment registry exported as pvars (mpool_segments,
  mpool_bytes) for observability, mirroring the reference's rcache
  stats.

Unlink discipline stays with the callers (they know when every peer
has attached); ``Segment.close`` drops cached views first so the map
actually releases unless user code still holds one.
"""

from __future__ import annotations

import mmap
import os
import tempfile
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from ompi_tpu_torch.mca.var import register_pvar

_lock = threading.Lock()
_live: Dict[int, "Segment"] = {}
_next_id = [1]


class Segment:
    """One mapped shared-memory region with a view registration cache."""

    def __init__(self, mm: mmap.mmap, path: str, size: int, owner: bool):
        self.mm = mm
        self.path = path
        self.size = size
        self.owner = owner
        self._views: Dict[Tuple[int, int, str], np.ndarray] = {}
        with _lock:
            self.sid = _next_id[0]
            _next_id[0] += 1
            _live[self.sid] = self

    # --------------------------------------------------------- rcache
    def view(self, offset: int = 0, nbytes: Optional[int] = None,
             dtype=np.uint8) -> np.ndarray:
        """Memoized numpy view of [offset, offset+nbytes) as ``dtype``
        (the rcache hit path: repeated lookups are one dict access)."""
        if nbytes is None:
            nbytes = self.size - offset
        dt = np.dtype(dtype)
        key = (int(offset), int(nbytes), dt.str)
        v = self._views.get(key)
        if v is None:
            if offset < 0 or offset + nbytes > self.size:
                raise ValueError(
                    f"view [{offset}, {offset + nbytes}) outside the "
                    f"{self.size}-byte segment")
            if nbytes % dt.itemsize:
                raise ValueError(
                    f"view of {nbytes} bytes is not a whole number of "
                    f"{dt} elements")
            count = nbytes // dt.itemsize
            v = np.frombuffer(self.mm, dt, count, offset=offset)
            self._views[key] = v
        return v

    # ------------------------------------------------------ lifecycle
    def unlink(self) -> None:
        """Remove the backing file (creator calls this once every peer
        attached; the kernel frees the memory with the last unmap)."""
        if self.path:
            try:
                os.unlink(self.path)
            except OSError:
                pass
            self.path = ""

    def close(self) -> None:
        with _lock:
            _live.pop(self.sid, None)
        self._views.clear()
        try:
            self.mm.close()
        except BufferError:
            pass  # external views still exported: freed at GC


def create_segment(size: int, prefix: str = "ompi_tpu_seg_") -> Segment:
    """Create + map a new shared segment (the mpool alloc path).
    Raises OSError on resource exhaustion — fds are closed on every
    path."""
    d = "/dev/shm" if os.path.isdir("/dev/shm") else None
    fd = -1
    path = ""
    try:
        fd, path = tempfile.mkstemp(prefix=prefix, dir=d)
        os.ftruncate(fd, size)
        mm = mmap.mmap(fd, size)
    except OSError:
        if path:
            try:
                os.unlink(path)
            except OSError:
                pass
        raise
    finally:
        if fd >= 0:
            os.close(fd)
    return Segment(mm, path, size, owner=True)


def attach_segment(path: str, size: int) -> Segment:
    """Map a peer's segment (the mpool attach path)."""
    fd = -1
    try:
        fd = os.open(path, os.O_RDWR)
        mm = mmap.mmap(fd, size)
    finally:
        if fd >= 0:
            os.close(fd)
    return Segment(mm, path, size, owner=False)


def stats() -> Tuple[int, int]:
    with _lock:
        segs = list(_live.values())
    return len(segs), sum(s.size for s in segs)


register_pvar("mpool", "segments", lambda: stats()[0],
              help="Live shared-memory segments (rcache stats analog)")
register_pvar("mpool", "bytes", lambda: stats()[1],
              help="Bytes mapped across live shared segments")


# --------------------------------------------------------------- BufferPool
# Host-memory staging pool (reference: the mpool "default" allocator that
# hands out registered eager/max frags, btl.h's per-size free lists).
# Transports that would otherwise allocate a fresh receive buffer per
# event (btl/tcp's old 1 MiB-per-recv) acquire a reusable block here
# instead; the registry/pvar discipline mirrors the segment rcache above.
_pools: Dict[int, "BufferPool"] = {}


class BufferPool:
    """Reusable fixed-size ``bytearray`` blocks.

    ``acquire`` pops a free block (or allocates on a miss); ``release``
    returns it for reuse, keeping at most ``max_free`` parked. Blocks of
    the wrong size (a caller grew one for a jumbo frame) are rejected at
    release so the pool's accounting stays exact. Thread-safe: a btl's
    progress thread and the app thread's opportunistic drains both hit
    the pool.
    """

    def __init__(self, block_size: int, max_free: int = 16):
        self.block_size = int(block_size)
        self.max_free = int(max_free)
        self._free: list = []
        self._plock = threading.Lock()
        self.outstanding = 0
        self.hits = 0
        self.misses = 0
        with _lock:
            self.pid = _next_id[0]
            _next_id[0] += 1
            _pools[self.pid] = self

    def acquire(self) -> bytearray:
        return self.acquire_pair()[0]

    def acquire_pair(self) -> Tuple[bytearray, bool]:
        """(block, served_from_free_list) — callers that keep their own
        hit accounting (the coll round engine's coll_round_pool_hits
        pvar) need the verdict atomically with the pop, not a racy
        before/after read of ``hits``."""
        with self._plock:
            self.outstanding += 1
            if self._free:
                self.hits += 1
                return self._free.pop(), True
            self.misses += 1
        return bytearray(self.block_size), False

    def release(self, block) -> None:
        """Recycle a block. Only call when the caller can prove sole
        ownership — a recycled block is handed to the next acquire.
        Parking is gated on an actual settle: a release with nothing
        outstanding (a double-settle reaching the runtime despite the
        static gate) must not park the same object twice and hand one
        block to two acquirers."""
        with self._plock:
            if self.outstanding > 0:
                self.outstanding -= 1
                if len(block) == self.block_size and \
                        len(self._free) < self.max_free:
                    self._free.append(block)

    def discard(self, block) -> None:
        """Account a block as gone WITHOUT recycling it: teardown paths
        that may race a concurrent reader (a conn dying under an
        in-flight drain) must not let the pool hand the block to
        someone else."""
        with self._plock:
            if self.outstanding > 0:
                self.outstanding -= 1

    def close(self) -> None:
        with _lock:
            _pools.pop(self.pid, None)
        with self._plock:
            self._free.clear()


# size-classed shared pools (reference: the per-size free lists of
# btl.h's eager/max frag mpools): callers with variable block sizes —
# the coll round engine's recv staging — round up to a power-of-two
# class and share one pool per class, so an 8-rank ring and a 4-rank
# ring of similar payloads recycle each other's blocks.
_CLASS_MIN = 256
_CLASS_MAX = 1 << 26  # above this a pooled block would pin real memory
# parked-memory budget per class: free lists keep at most this many
# BYTES (not blocks), so a burst of jumbo-class recvs can't pin
# max_free * 64 MiB of idle memory for process lifetime — the big
# classes park 1-2 blocks, the small ones the full max_free
_CLASS_PARK_BYTES = 1 << 25
_class_pools: Dict[int, "BufferPool"] = {}


def size_class(nbytes: int) -> Optional[int]:
    """Power-of-two class for ``nbytes``, or None when pooling would be
    counterproductive (zero-byte tokens; jumbo blocks past _CLASS_MAX
    that would sit parked forever)."""
    if nbytes <= 0 or nbytes > _CLASS_MAX:
        return None
    return max(_CLASS_MIN, 1 << (nbytes - 1).bit_length())


def class_pool(nbytes: int, max_free: int = 8) -> Optional[BufferPool]:
    """The shared BufferPool for ``nbytes``'s size class (created on
    first use), or None when the size is unpoolable. ``max_free`` is
    capped by the per-class _CLASS_PARK_BYTES budget and only takes
    effect for the caller that creates the class — later callers share
    the existing pool as-is."""
    cls = size_class(nbytes)
    if cls is None:
        return None
    pool = _class_pools.get(cls)
    if pool is None:
        # constructed outside _lock (BufferPool.__init__ takes it);
        # racing creators are resolved by setdefault — the loser
        # unregisters its orphan
        fresh = BufferPool(cls, max_free=max(
            1, min(max_free, _CLASS_PARK_BYTES // cls)))
        with _lock:
            pool = _class_pools.setdefault(cls, fresh)
        if pool is not fresh:
            fresh.close()
    return pool


def pool_stats() -> Tuple[int, int, int, int]:
    """(blocks live, bytes held, hits, misses) across every BufferPool."""
    with _lock:
        pools = list(_pools.values())
    blocks = bytes_ = hits = misses = 0
    for p in pools:
        with p._plock:
            n = p.outstanding + len(p._free)
            blocks += n
            bytes_ += n * p.block_size
            hits += p.hits
            misses += p.misses
    return blocks, bytes_, hits, misses


register_pvar("mpool", "pool_blocks", lambda: pool_stats()[0],
              help="bytearray blocks held by BufferPools (in use + free)")
register_pvar("mpool", "pool_bytes", lambda: pool_stats()[1],
              help="Bytes across every BufferPool block")
register_pvar("mpool", "pool_hits", lambda: pool_stats()[2],
              help="BufferPool acquires served from the free list")
register_pvar("mpool", "pool_misses", lambda: pool_stats()[3],
              help="BufferPool acquires that had to allocate")
