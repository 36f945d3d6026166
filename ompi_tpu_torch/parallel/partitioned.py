"""Mesh-mode partitioned communication (MPI-4 Psend/Precv on ``MeshComm``).

The port of ``ompi_tpu/parallel/partitioned.py`` (reference:
ompi/mca/part/part.h:163,227). A partitioned transfer is a segmented
permutation of rows:

- the buffer is ``[W, K, ...]``: rank rows, and K split into ``partitions``
  segments;
- ``Pready(p)`` enqueues segment p's ``comm.permute`` at once and records a
  CUDA event after it;
- ``Parrived(p)`` queries that event;
- ``Wait`` joins the permuted segments back into ``[W, K, ...]``.

On one CUDA stream the segments run in the order they were made ready and
do not overlap one another. The controller holds both ends, so one request
serves the Psend/Precv pair. On the CPU a segment is done when ``Pready``
returns.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch

from ompi_tpu_torch.coll.sched import record_event
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG, ERR_PENDING


class MeshPartitionedRequest:
    """A persistent partitioned transfer over a mesh communicator."""

    def __init__(self, comm, x, perm: Sequence[Tuple[int, int]],
                 partitions: int):
        if partitions <= 0:
            raise MPIError(ERR_ARG, "partitions must be positive")
        if x.dim() < 2 or x.shape[1] % partitions:
            raise MPIError(
                ERR_ARG,
                f"buffer [W, K, ...] needs K divisible by partitions: "
                f"{tuple(x.shape)} vs {partitions}")
        self.comm = comm
        self.perm = tuple((int(s), int(d)) for s, d in perm)
        self.partitions = partitions
        self._seg = x.shape[1] // partitions
        self._x = x
        self._parts: List[Optional[torch.Tensor]] = [None] * partitions
        self._events: List[Optional[torch.cuda.Event]] = [None] * partitions
        self.result = None

    # ------------------------------------------------------ MPI verbs
    def Start(self) -> "MeshPartitionedRequest":
        """Re-arm (persistent semantics): no partition is ready."""
        self._parts = [None] * self.partitions
        self._events = [None] * self.partitions
        self.result = None
        return self

    def _check(self, partition: int) -> int:
        p = int(partition)
        if not 0 <= p < self.partitions:
            raise MPIError(ERR_ARG, f"partition {p} out of range")
        return p

    def Pready(self, partition: int) -> None:
        """Enqueue partition ``partition``'s segment of the permutation; any
        order."""
        p = self._check(partition)
        if self._parts[p] is not None:
            raise MPIError(ERR_ARG, f"partition {p} already ready")
        lo = p * self._seg
        self._parts[p] = self.comm.permute(
            self._x[:, lo: lo + self._seg], self.perm)
        self._events[p] = record_event(self._parts[p])

    def Pready_range(self, lo: int, hi: int) -> None:
        for p in range(int(lo), int(hi) + 1):
            self.Pready(p)

    def Parrived(self, partition: int) -> bool:
        """Has partition ``partition`` completed on the device?"""
        p = self._check(partition)
        if self._parts[p] is None:
            return False
        ev = self._events[p]
        return ev is None or ev.query()

    def Wait(self) -> torch.Tensor:
        """Complete the whole transfer: every partition must have been made
        ready; returns (and stores) the permuted ``[W, K, ...]`` tensor."""
        missing = [i for i, r in enumerate(self._parts) if r is None]
        if missing:
            raise MPIError(
                ERR_PENDING,
                f"Wait before Pready of partitions {missing[:8]}")
        out = torch.cat(self._parts, 1)
        ev = record_event(out)
        if ev is not None:
            ev.synchronize()
        self.result = out
        return out

    def Test(self) -> bool:
        return all(self.Parrived(i) for i in range(self.partitions))

    def Free(self) -> None:
        self._parts = [None] * self.partitions
        self._events = [None] * self.partitions
        self._x = None
        self.result = None
