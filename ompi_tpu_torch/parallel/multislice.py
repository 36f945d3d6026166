"""Multi-slice mesh collectives: a slice-local verb, then a bridge hop.

The port of ``ompi_tpu/parallel/multislice.py``. Each process is one slice
controller holding a ``MeshComm`` of ``D`` ranks on its device; the slices
are joined by a bridge, a gloo process group over the controllers (where
the reference has a process-mode ``ProcComm`` over the tcp btl). A
two-level allreduce is

    slice-local verb of the mesh comm
    -> the leaders' rows exchanged over the bridge, staged through host
       memory (the reference's DCN hop)
    -> the combined row placed on every rank of the slice

which is han's node-reduce / leader-allreduce / node-bcast split with
"node" = slice (reference: ompi/mca/coll/han, coll_han_subcomms.c).

gloo reduces only SUM, PRODUCT, MIN, MAX, BAND, BOR and BXOR, and no bool
tensor; every other op (the logical ops, MINLOC/MAXLOC, REPLACE, NO_OP,
user ops) gathers the leaders' rows and folds them in slice order with
``op.combine``, as ``coll/mesh.py`` folds a world's rows.

Launch: ``parallel/launch.run_world(fn, n_slices, device)`` starts the
controllers; ``MultiSliceComm(slice_comm)`` in each makes the bridge.

The slice verbs count in ``spc`` as the user's; the bridge hops are
internal traffic and run under ``spc.suppressed()``, where the reference
places them (``ompi_tpu/parallel/multislice.py:79-193``).
"""

from __future__ import annotations

import atexit
import logging
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import torch
import torch.distributed as dist

from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG, ERR_INTERN
from ompi_tpu_torch.core.request import Request
from ompi_tpu_torch.hook import register_hook
from ompi_tpu_torch.parallel.mesh import MeshComm
from ompi_tpu_torch.runtime import spc

__all__ = ["MultiSliceComm"]

_GLOO_OPS = {"MPI_SUM": dist.ReduceOp.SUM, "MPI_PROD": dist.ReduceOp.PRODUCT,
             "MPI_MAX": dist.ReduceOp.MAX, "MPI_MIN": dist.ReduceOp.MIN,
             "MPI_BAND": dist.ReduceOp.BAND, "MPI_BOR": dist.ReduceOp.BOR,
             "MPI_BXOR": dist.ReduceOp.BXOR}


class _FutureRequest(Request):
    """A request that the bridge's worker thread completes; ``result``
    holds the verb's output."""

    result = None


class MultiSliceComm:
    """A communicator over ``n_slices`` slices, each a ``MeshComm`` of the
    same size on its controller's device."""

    def __init__(self, slice_comm: MeshComm,
                 bridge: Optional[dist.ProcessGroup] = None):
        """``bridge``: a gloo group over the controllers, one rank a slice;
        by default a new one over the whole ``torch.distributed`` world,
        which every controller must then build together."""
        if slice_comm.groups is not None:
            raise MPIError(ERR_ARG,
                           "multi-slice spans whole-mesh slice comms")
        self.slice = slice_comm
        self.bridge = bridge if bridge is not None else \
            dist.new_group(backend="gloo")
        self._pool: Optional[ThreadPoolExecutor] = None

    @property
    def n_slices(self) -> int:
        return dist.get_world_size(self.bridge)

    @property
    def slice_id(self) -> int:
        return dist.get_rank(self.bridge)

    @property
    def world_size(self) -> int:
        """Ranks over all slices (every slice has the same size)."""
        return self.slice.world_size * self.n_slices

    # ------------------------------------------------------- collectives
    def _host_exchange(self, row: torch.Tensor, op: _op.Op) -> torch.Tensor:
        """The leaders' host rows combined over the bridge, as ``op``."""
        red = _GLOO_OPS.get(op.name)
        if red is not None and row.dtype != torch.bool:
            out = row.clone()
            with spc.suppressed():
                dist.all_reduce(out, red, group=self.bridge)
            return out
        rows = self._gather_rows(row)
        v = [(r != 0).to(torch.int32) if op.logical else r for r in rows]
        acc = v[0]
        for r in v[1:]:
            acc = op.combine(acc, r)
        return acc.to(row.dtype)

    def _gather_rows(self, row: torch.Tensor):
        rows = [torch.empty_like(row) for _ in range(self.n_slices)]
        with spc.suppressed():
            dist.all_gather(rows, row, group=self.bridge)
        return rows

    def _replicate(self, row: torch.Tensor) -> torch.Tensor:
        """One host row as the slice's ``[D, ...]`` buffer: the row
        crosses to the device once and is expanded there, never made D
        times in host memory."""
        r = row.to(self.slice.device)
        return r.expand((self.slice.world_size,) + tuple(r.shape)) \
            .contiguous()

    def _do_allreduce(self, x, op: _op.Op = _op.SUM):
        """[D, ...] a slice -> every rank of every slice holds the global
        reduction."""
        local = self.slice.allreduce(x, op)           # slice total
        combined = self._host_exchange(local[0].cpu(), op)
        return self._replicate(combined)

    def _do_bcast(self, x, root_slice: int = 0, root: int = 0):
        """Row ``root`` of slice ``root_slice`` to every rank of every
        slice."""
        if self.slice_id == root_slice:
            row = self.slice.bcast(x, root)[0].cpu()
        else:
            row = torch.empty_like(x[0], device="cpu")  # filled by bcast
        with spc.suppressed():
            dist.broadcast(row, dist.get_global_rank(self.bridge,
                                                     root_slice),
                           group=self.bridge)
        return self._replicate(row)

    def _do_allgather(self, x):
        """[D, ...] a slice -> [D, S*D, ...]: every rank holds all S*D
        contributions, slice-major (slice id, rank in the slice)."""
        block = self.slice.allgather(x)[0].cpu()  # [D, ...] this slice's
        flat = torch.cat(self._gather_rows(block))
        return self._replicate(flat)

    def _do_reduce_scatter(self, x, op: _op.Op = _op.SUM):
        """[D, S*D, ...] -> [D, ...]: rank d of slice s holds the global
        reduction of block s*D + d."""
        rows = self.slice.allreduce(x, op)[0].cpu()
        if rows.dim() < 1 or rows.shape[0] != self.world_size:
            raise MPIError(
                ERR_ARG,
                f"reduce_scatter needs leading dim {self.world_size}")
        combined = self._host_exchange(rows, op)
        D = self.slice.world_size
        mine = combined[self.slice_id * D:(self.slice_id + 1) * D]
        return self.slice.shard(mine)

    def _do_alltoall(self, x):
        """[D, W, ...] a slice (W = world_size chunks a rank) -> [D, W, ...]:
        chunk j of world rank i lands as chunk i of world rank j. The
        slice-to-slice blocks ride one bridge alltoall; the transpose
        within a block is the controller's, which holds the slice's rows."""
        D, S = self.slice.world_size, self.n_slices
        if x.dim() < 2 or x.shape[0] != D or x.shape[1] != self.world_size:
            raise MPIError(
                ERR_ARG,
                f"alltoall expects [slice_devices={D}, "
                f"world={self.world_size}, ...], got {tuple(x.shape)}")
        rest = tuple(x.shape[2:])
        # the block for slice t: my rows' chunks t*D..(t+1)*D
        send = x.cpu().reshape((D, S, D) + rest).transpose(0, 1).contiguous()
        recv = torch.empty_like(send)  # [S, D (source), D (mine), ...]
        with spc.suppressed():
            dist.all_to_all_single(recv, send, group=self.bridge)
        # out[d_mine, s*D + d_src] = recv[s, d_src, d_mine]
        out = recv.permute((2, 0, 1) + tuple(range(3, recv.dim())))
        return self.slice.shard(out.reshape(x.shape))

    def _do_barrier(self) -> None:
        self.slice.barrier()
        with spc.suppressed():
            dist.barrier(group=self.bridge)

    # ------------------------------------------ nonblocking (MPI_I*)
    # The bridge hop blocks the host, so an I-verb runs the whole two-level
    # schedule on a worker thread and its request completes when the
    # result is placed. One worker: bridge collectives match across
    # controllers by program order, and a second thread could reorder two
    # in flight. The blocking verbs queue behind the same worker, so one
    # issued while an I-verb is in flight cannot overtake it.
    def _ireq(self, fn, *args) -> _FutureRequest:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="multislice-nbc")
            # reaped at finalize_top, as the reference does; mesh mode has
            # no Finalize, so at exit as well
            register_hook("finalize_top", self._stop_pool)
            atexit.register(self._pool.shutdown, wait=False)
        req = _FutureRequest()

        def run():
            try:
                req.result = fn(*args)
                req._set_complete(0)
            except MPIError as e:
                req._set_complete(e.code)
            except Exception:  # noqa: BLE001 — a lost error would leave
                # Wait() spinning forever
                logging.getLogger("ompi_tpu_torch.multislice").exception(
                    "nonblocking multislice verb failed")
                req._set_complete(ERR_INTERN)

        self._pool.submit(run)
        return req

    def iallreduce(self, x, op: _op.Op = _op.SUM):
        return self._ireq(self._do_allreduce, x, op)

    def ibcast(self, x, root_slice: int = 0, root: int = 0):
        return self._ireq(self._do_bcast, x, root_slice, root)

    def iallgather(self, x):
        return self._ireq(self._do_allgather, x)

    def ialltoall(self, x):
        return self._ireq(self._do_alltoall, x)

    def ireduce_scatter(self, x, op: _op.Op = _op.SUM):
        return self._ireq(self._do_reduce_scatter, x, op)

    def ibarrier(self):
        return self._ireq(self._do_barrier)

    def _ordered(self, fn, *args):
        """A blocking verb through the worker's queue."""
        req = self._ireq(fn, *args)
        req.Wait()
        return req.result

    def allreduce(self, x, op: _op.Op = _op.SUM):
        return self._ordered(self._do_allreduce, x, op)

    def bcast(self, x, root_slice: int = 0, root: int = 0):
        return self._ordered(self._do_bcast, x, root_slice, root)

    def allgather(self, x):
        return self._ordered(self._do_allgather, x)

    def reduce_scatter(self, x, op: _op.Op = _op.SUM):
        return self._ordered(self._do_reduce_scatter, x, op)

    def alltoall(self, x):
        return self._ordered(self._do_alltoall, x)

    def barrier(self) -> None:
        self._ordered(self._do_barrier)

    def _stop_pool(self) -> None:
        if self._pool is not None:
            self._pool.shutdown(wait=False)

    def Free(self) -> None:
        """Stop the worker thread (the reference stops it at the
        ``finalize_top`` hook; mesh mode has no Finalize)."""
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            atexit.unregister(self._pool.shutdown)
            self._pool = None

    Allreduce = allreduce
    Bcast = bcast
    Allgather = allgather
    Alltoall = alltoall
    Barrier = barrier
    Iallreduce = iallreduce
    Ibcast = ibcast
    Iallgather = iallgather
    Ialltoall = ialltoall
    Ibarrier = ibarrier
