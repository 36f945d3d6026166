"""Mesh-mode one-sided communication: an RMA window over the rank dim.

The port of ``ompi_tpu/osc/window.py:930-1150`` (``MeshWin``) and of the
constants it needs (``:42-43``, ``:50``). The host-mode ``Win`` and its wire
protocol are process mode and are not ported.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import torch

from ompi_tpu_torch.coll.sched import DeviceRequest
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.errors import MPIError, ERR_RANK, ERR_WIN

__all__ = ["MeshWin", "LOCK_EXCLUSIVE", "LOCK_SHARED", "MODE_NOSUCCEED"]

LOCK_EXCLUSIVE = 1
LOCK_SHARED = 2

# the MPI_Win_fence assertion that ends the last epoch (mpi.h value); the
# window ignores every other assertion, as the reference's does
MODE_NOSUCCEED = 16384


class MeshWin:
    """Mesh-mode window: controller-level RMA on a ``[world, ...]`` tensor
    on the comm's device.

    The single controller owns every rank's memory, so Put, Get and
    Accumulate are tensor updates. What the class adds is the epoch
    discipline of the host-mode window (reference: the access/exposure
    epoch rules of osc_rdma_active_target.c / passive_target.c):

    - every RMA verb needs an epoch covering its target (a fence, a Start
      group holding it, or a lock on it); misuse raises ``ERR_WIN``;
    - the R-verbs return requests that complete when the device has run
      the transfer (a CUDA event after it, ``coll/sched.py``);
    - Fence, Complete, Wait, Unlock, Unlock_all and the Flushes wait for the
      device, where the reference calls ``block_until_ready``;
    - locks track shared/exclusive state per target: with one controller
      there is no contention, but a double lock or an unlock without a
      lock is a program bug and is caught.

    The window is updated in place, so a transfer moves only its row. JAX
    arrays are immutable; a torch row is a view of the window, so ``Get``
    and the old values of ``Fetch_and_op`` and ``Compare_and_swap`` are
    copies: a later Put does not change them.
    """

    def __init__(self, comm, shape_per_rank, dtype=torch.float32):
        self.comm = comm
        self.array = torch.zeros((comm.world_size,) + tuple(shape_per_rank),
                                 dtype=dtype, device=comm.device)
        self._fence_open = False
        self._access_group: Optional[List[int]] = None
        self._exposure_group: Optional[List[int]] = None
        self._locks: Dict[int, int] = {}  # target -> lock type
        self._lock_all = False

    # ------------------------------------------------------ epoch guard
    def _check_target(self, target: int) -> None:
        # torch reads a negative index from the end: it must not alias
        if not 0 <= target < self.comm.world_size:
            raise MPIError(ERR_RANK, f"target {target} out of range")

    def _check_epoch(self, target: int) -> None:
        self._check_target(target)
        if self._fence_open or self._lock_all:
            return
        if self._access_group is not None and target in self._access_group:
            return
        if target in self._locks:
            return
        raise MPIError(ERR_WIN,
                       f"RMA to {target} outside any epoch (need Fence, "
                       "Start including it, or Lock on it)")

    def _check_index(self, index: int) -> None:
        if not 0 <= index < self.array.shape[1]:
            raise MPIError(ERR_RANK,
                           f"element index {index} out of range")

    def _data(self, data) -> torch.Tensor:
        """``data`` in the window's dtype on its device: JAX casts an
        update to the array's dtype before it applies it. A Python number
        is filled on the device, so an atomic's operand costs no host copy
        (which would wait for the device)."""
        if isinstance(data, (bool, int, float)):
            return torch.full((), data, dtype=self.array.dtype,
                              device=self.array.device)
        return torch.as_tensor(data).to(self.array.device, self.array.dtype)

    def _sync(self) -> None:
        if self.array.is_cuda:
            torch.cuda.synchronize(self.array.device)

    # ------------------------------------------------------- RMA verbs
    def Put(self, data, target: int) -> None:
        self._check_epoch(target)
        self.array[target] = self._data(data)

    def Get(self, target: int) -> torch.Tensor:
        self._check_epoch(target)
        return self.array[target].clone()

    def Accumulate(self, data, target: int, op: _op.Op = _op.SUM) -> None:
        self._check_epoch(target)
        if op is _op.SUM:
            self.array[target] += self._data(data)
        else:
            self.array[target] = op.combine(self.array[target],
                                            self._data(data))

    def Rput(self, data, target: int) -> DeviceRequest:
        self.Put(data, target)
        return DeviceRequest(self.array)

    def Rget(self, target: int) -> DeviceRequest:
        """A request whose ``result`` is the fetched row."""
        return DeviceRequest(self.Get(target))

    def Raccumulate(self, data, target: int,
                    op: _op.Op = _op.SUM) -> DeviceRequest:
        self.Accumulate(data, target, op)
        return DeviceRequest(self.array)

    def Fetch_and_op(self, value, target: int, index: int = 0,
                     op: _op.Op = _op.SUM) -> torch.Tensor:
        """Atomic under the single controller: returns the old element."""
        self._check_epoch(target)
        self._check_index(index)
        old = self.array[target, index].clone()
        if op is _op.SUM:
            self.array[target, index] += self._data(value)
        else:
            self.array[target, index] = op.combine(old, self._data(value))
        return old

    def Compare_and_swap(self, compare, value, target: int,
                         index: int = 0) -> torch.Tensor:
        self._check_epoch(target)
        self._check_index(index)
        old = self.array[target, index].clone()
        self.array[target, index] = torch.where(
            old == self._data(compare), self._data(value), old)
        return old

    # --------------------------------------------------- fence epochs
    def Fence(self, assertion: int = 0) -> None:
        """End the previous fence epoch and start the next (successive
        fences delimit epochs); waits for the device and synchronizes the
        mesh. ``MODE_NOSUCCEED`` on the closing fence ends the last
        epoch."""
        self._sync()
        self.comm.barrier()
        self._fence_open = not (assertion & MODE_NOSUCCEED)

    # ----------------------------------------------------- PSCW epochs
    def Start(self, targets) -> None:
        if self._access_group is not None:
            raise MPIError(ERR_WIN, "Start inside an access epoch")
        self._access_group = [int(t) for t in targets]

    def Complete(self) -> None:
        if self._access_group is None:
            raise MPIError(ERR_WIN, "Complete without Start")
        self._sync()
        self._access_group = None

    def Post(self, origins) -> None:
        if self._exposure_group is not None:
            raise MPIError(ERR_WIN, "Post inside an exposure epoch")
        self._exposure_group = [int(o) for o in origins]

    def Wait(self) -> None:
        if self._exposure_group is None:
            raise MPIError(ERR_WIN, "Wait without Post")
        # one controller: the origins' Completes ran in program order; the
        # device is the only thing to wait for
        self._sync()
        self._exposure_group = None

    def Test(self) -> bool:
        """Nonblocking Wait: whether the device has run every transfer."""
        if self._exposure_group is None:
            raise MPIError(ERR_WIN, "Test without Post")
        ready = DeviceRequest(self.array).is_complete
        if ready:
            self._exposure_group = None
        return ready

    # -------------------------------------------------- passive target
    def Lock(self, target: int, lock_type: int = LOCK_EXCLUSIVE) -> None:
        self._check_target(target)
        if self._lock_all:
            raise MPIError(ERR_WIN,
                           "Lock while Lock_all holds (MPI-4 §12.5.3)")
        if target in self._locks:
            raise MPIError(ERR_WIN, f"already holding lock on {target}")
        self._locks[target] = lock_type

    def Unlock(self, target: int) -> None:
        if target not in self._locks:
            raise MPIError(ERR_WIN, f"Unlock without Lock on {target}")
        self._sync()  # the epoch ends when its transfers have
        del self._locks[target]

    def Lock_all(self) -> None:
        if self._lock_all:
            raise MPIError(ERR_WIN, "Lock_all inside Lock_all")
        if self._locks:
            raise MPIError(ERR_WIN,
                           "Lock_all while per-target locks held "
                           "(MPI-4 §12.5.3)")
        self._lock_all = True

    def Unlock_all(self) -> None:
        if not self._lock_all:
            raise MPIError(ERR_WIN, "Unlock_all without Lock_all")
        self._sync()
        self._lock_all = False

    # ------------------------------------------------------ completion
    def Flush(self, target: Optional[int] = None) -> None:
        """Remote completion is the device's under one controller."""
        self._sync()

    Flush_all = Flush
    Flush_local = Flush
    Flush_local_all = Flush

    def Sync(self) -> None:
        """Memory-model sync (no separate public/private copies here)."""
