"""coll/basic — host collectives over the PML for process-mode comms.

The port of ``ompi_tpu/coll/basic.py`` (reference: ompi/mca/coll/basic,
the fallback linear algorithms, plus selected schedules from coll/base:
binomial bcast coll_base_bcast.c, dissemination barrier, ring allgather
coll_base_allgather.c), with the same algorithms, tags and CID plane, so
that ranks of the two packages can share a collective.

All payloads move as packed wire bytes (the convertor handles arbitrary
datatypes), so every algorithm is datatype-agnostic. Reductions view the
packed stream with the datatype's element dtype and apply the op in rank
order: numpy's ufuncs for the predefined ops on the dtypes numpy has (the
reference's ``np_reduce`` table), torch's elementwise op for bf16 (which
numpy lacks: f32 arithmetic rounded to nearest even, as ``ml_dtypes``
rounds) and for user ops (the port's user ops take tensors), and a
structured pair view for MINLOC/MAXLOC.

Tag/context discipline: collective traffic runs in a separate context-id
plane (cid | COLL_CID_BIT) with per-op negative tags — the reference
separates collective from pt2pt traffic the same way (hidden coll context
ids; MCA_COLL_BASE_TAG_* constants).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch

from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.comm.communicator import parse_buffer
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.convertor import (
    _as_byte_view as _as_bytes,
    pack as cv_pack,
    unpack as cv_unpack,
)
from ompi_tpu_torch.core.datatype import BFLOAT16, BYTE, Datatype
from ompi_tpu_torch.core.errors import (
    MPIError,
    ERR_OP,
    ERR_UNSUPPORTED_OPERATION,
)
from ompi_tpu_torch.mca.component import Component

COLL_CID_BIT = 1 << 30

TAG_BARRIER = -10
TAG_BCAST = -11
TAG_REDUCE = -12
TAG_ALLGATHER = -13
TAG_ALLTOALL = -14
TAG_SCATTER = -15
TAG_GATHER = -16
TAG_SCAN = -17


def _ccid(comm) -> int:
    return comm.cid | COLL_CID_BIT


def _isend(comm, data: np.ndarray, dst: int, tag: int):
    return comm.pml.isend(data, data.nbytes, BYTE,
                          comm.group.world_rank(dst), tag, _ccid(comm))


def _irecv(comm, nbytes: int, src: int, tag: int):
    buf = np.empty(nbytes, dtype=np.uint8)
    req = comm.pml.irecv(buf, nbytes, BYTE,
                         comm.group.world_rank(src), tag, _ccid(comm))
    return buf, req


def _sendrecv(comm, data: np.ndarray, dst: int, nbytes: int, src: int,
              tag: int) -> np.ndarray:
    rbuf, rreq = _irecv(comm, nbytes, src, tag)
    sreq = _isend(comm, data, dst, tag)
    sreq.Wait()
    rreq.Wait()
    return rbuf


def _minloc(a, b):
    """Elementwise on structured (value, index) pairs; ties take the lower
    index, per MPI_MINLOC."""
    take_b = (b["f0"] < a["f0"]) | ((b["f0"] == a["f0"]) & (b["f1"] < a["f1"]))
    out = np.array(a, copy=True)
    out[take_b] = b[take_b]
    return out


def _maxloc(a, b):
    take_b = (b["f0"] > a["f0"]) | ((b["f0"] == a["f0"]) & (b["f1"] < a["f1"]))
    out = np.array(a, copy=True)
    out[take_b] = b[take_b]
    return out


# the host kernels of the predefined ops (the reference's Op.np_reduce)
_NP_REDUCE = {
    _op.SUM: np.add, _op.PROD: np.multiply, _op.MAX: np.maximum,
    _op.MIN: np.minimum, _op.LAND: np.logical_and, _op.LOR: np.logical_or,
    _op.LXOR: np.logical_xor, _op.BAND: np.bitwise_and,
    _op.BOR: np.bitwise_or, _op.BXOR: np.bitwise_xor,
    _op.MINLOC: _minloc, _op.MAXLOC: _maxloc,
    _op.REPLACE: lambda a, b: b, _op.NO_OP: lambda a, b: a,
}


def _typed_view(raw: np.ndarray, dt: Datatype):
    """View packed bytes with the datatype's element dtype for reductions:
    an ndarray, or a CPU tensor for bf16 (numpy has no bf16; its storage
    is uint16)."""
    if dt is BFLOAT16:
        return torch.from_numpy(raw).view(torch.bfloat16)
    if dt.np_dtype is not None:
        return raw.view(dt.np_dtype)
    kinds = {d for d, _ in dt.typemap}
    if len(kinds) == 1:
        return raw.view(next(iter(kinds)))
    if len(dt.typemap) == 2:  # value/index pair types (MINLOC/MAXLOC)
        f0, f1 = dt.typemap[0][0], dt.typemap[1][0]
        pair = np.dtype([("f0", f0), ("f1", f1)])
        return raw.view(pair)
    raise MPIError(ERR_UNSUPPORTED_OPERATION,
                   "reduction on heterogeneous derived datatype")


def _reduce_typed(op: _op.Op, a, b):
    """``a (op) b`` with the operand dtype restored: logical ops return
    bools, but MPI keeps the integer type (reference: op kernels are typed
    per dtype) — without the cast the byte view downstream shrinks to 1
    byte/element and unpack truncates. A predefined op on an ndarray runs
    its numpy kernel; a tensor (bf16) or a user op runs the op's torch
    combine."""
    fn = _NP_REDUCE.get(op)
    if fn is not None and isinstance(a, np.ndarray):
        out = fn(a, b)
        return out.astype(a.dtype) if out.dtype != a.dtype else out
    if isinstance(a, np.ndarray) and a.dtype.names:  # a pair view
        raise MPIError(ERR_OP, f"{op.name} on a value/index pair type")
    ta = a if isinstance(a, torch.Tensor) else torch.from_numpy(a)
    tb = b if isinstance(b, torch.Tensor) else torch.from_numpy(b)
    out = op.combine(ta, tb)
    return out.to(ta.dtype) if out.dtype != ta.dtype else out


def _wire(acc) -> np.ndarray:
    """A reduction's result as contiguous packed bytes."""
    if isinstance(acc, torch.Tensor):
        t = acc.contiguous()
        if t.dtype == torch.bfloat16:
            t = t.view(torch.int16)
        return t.numpy().view(np.uint8)
    return np.ascontiguousarray(acc).view(np.uint8)


class BasicColl(CollModule):
    # -------------------------------------------------------------- barrier
    def barrier(self, comm) -> None:
        """Dissemination barrier: ceil(log2 n) zero-byte rounds
        (reference: the recursive-doubling barrier of coll/base)."""
        n, r = comm.size, comm.rank
        d = 1
        token = np.zeros(0, dtype=np.uint8)
        while d < n:
            dst = (r + d) % n
            src = (r - d) % n
            _sendrecv(comm, token, dst, 0, src, TAG_BARRIER)
            d <<= 1

    # ---------------------------------------------------------------- bcast
    def bcast(self, comm, buf, root: int) -> None:
        """Binomial tree (reference: coll_base_bcast.c binomial)."""
        n, r = comm.size, comm.rank
        obj, count, dt = parse_buffer(buf)
        nbytes = count * dt.size
        vrank = (r - root) % n
        data: Optional[np.ndarray] = None
        if vrank == 0:
            data = np.ascontiguousarray(cv_pack(obj, count, dt))
        mask = 1
        while mask < n:
            if vrank & mask:
                src = (vrank - mask + root) % n
                rbuf, rreq = _irecv(comm, nbytes, src, TAG_BCAST)
                rreq.Wait()
                data = rbuf
                break
            mask <<= 1
        mask >>= 1
        reqs = []
        while mask > 0:
            if vrank + mask < n and not (vrank & mask):
                dst = (vrank + mask + root) % n
                reqs.append(_isend(comm, data, dst, TAG_BCAST))
            mask >>= 1
        for q in reqs:
            q.Wait()
        if vrank != 0:
            cv_unpack(data, obj, count, dt)

    # --------------------------------------------------------------- reduce
    def reduce(self, comm, sendbuf, recvbuf, op: _op.Op, root: int) -> None:
        """Linear fan-in applying op in ascending rank order (correct for
        non-commutative ops — reference: coll/basic linear reduce)."""
        n, r = comm.size, comm.rank
        src_buf = recvbuf if sendbuf is None else sendbuf  # IN_PLACE
        obj, count, dt = parse_buffer(src_buf)
        packed = np.ascontiguousarray(cv_pack(obj, count, dt))
        if r != root:
            _isend(comm, packed, root, TAG_REDUCE).Wait()
            return
        contributions: List[Optional[np.ndarray]] = [None] * n
        contributions[r] = packed
        pend = []
        for i in range(n):
            if i != root:
                rbuf, rreq = _irecv(comm, packed.nbytes, i, TAG_REDUCE)
                pend.append(rreq)
                contributions[i] = rbuf
        for q in pend:
            q.Wait()
        acc = _typed_view(contributions[0].copy(), dt)
        for i in range(1, n):
            acc = _reduce_typed(op, acc, _typed_view(contributions[i], dt))
        robj, rcount, rdt = parse_buffer(recvbuf)
        cv_unpack(_wire(acc), robj, rcount, rdt)

    def allreduce(self, comm, sendbuf, recvbuf, op: _op.Op) -> None:
        """reduce + bcast (reference: coll/basic; tuned schedules replace
        this for large sizes)."""
        self.reduce(comm, sendbuf, recvbuf, op, 0)
        self.bcast(comm, recvbuf, 0)

    # ------------------------------------------------------------ allgather
    def allgather(self, comm, sendbuf, recvbuf) -> None:
        """Ring (reference: coll_base_allgather.c ring): n-1 rounds, each
        forwarding the block received last round."""
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        nb = block.nbytes
        out = np.empty(n * nb, dtype=np.uint8)
        out[r * nb : (r + 1) * nb] = block
        cur = block
        for d in range(1, n):
            cur = _sendrecv(comm, cur, (r + 1) % n, nb, (r - 1) % n,
                            TAG_ALLGATHER)
            out[((r - d) % n) * nb : ((r - d) % n + 1) * nb] = cur
        cv_unpack(out, robj, rcount, rdt)

    def allgatherv(self, comm, sendbuf, recvbuf, counts, displs) -> None:
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        counts = list(counts)
        if displs is None:
            displs = np.cumsum([0] + counts[:-1]).tolist()
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        esz = rdt.size
        out = np.zeros(rcount * esz, dtype=np.uint8)
        out[displs[r] * esz : displs[r] * esz + block.nbytes] = block
        cur = block
        for d in range(1, n):
            src_rank = (r - d) % n
            cur = _sendrecv(comm, cur, (r + 1) % n, counts[src_rank] * esz,
                            (r - 1) % n, TAG_ALLGATHER)
            off = displs[src_rank] * esz
            out[off : off + cur.nbytes] = cur
        cv_unpack(out, robj, rcount, rdt)

    # --------------------------------------------------------- gather/scatter
    def gather(self, comm, sendbuf, recvbuf, root: int) -> None:
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        if r != root:
            _isend(comm, block, root, TAG_GATHER).Wait()
            return
        robj, rcount, rdt = parse_buffer(recvbuf)
        nb = block.nbytes
        out = np.empty(n * nb, dtype=np.uint8)
        out[r * nb : (r + 1) * nb] = block
        pend = []
        for i in range(n):
            if i != root:
                rb, rq = _irecv(comm, nb, i, TAG_GATHER)
                pend.append((i, rb, rq))
        for i, rb, rq in pend:
            rq.Wait()
            out[i * nb : (i + 1) * nb] = rb
        cv_unpack(out, robj, rcount, rdt)

    def gatherv(self, comm, sendbuf, recvbuf, counts, displs,
                root: int) -> None:
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        block = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        if r != root:
            _isend(comm, block, root, TAG_GATHER).Wait()
            return
        robj, rcount, rdt = parse_buffer(recvbuf)
        counts = list(counts)
        if displs is None:
            displs = np.cumsum([0] + counts[:-1]).tolist()
        esz = rdt.size
        out = np.zeros(rcount * esz, dtype=np.uint8)
        out[displs[r] * esz : displs[r] * esz + block.nbytes] = block
        pend = []
        for i in range(n):
            if i != root:
                rb, rq = _irecv(comm, counts[i] * esz, i, TAG_GATHER)
                pend.append((i, rb, rq))
        for i, rb, rq in pend:
            rq.Wait()
            out[displs[i] * esz : displs[i] * esz + rb.nbytes] = rb
        cv_unpack(out, robj, rcount, rdt)

    def scatter(self, comm, sendbuf, recvbuf, root: int) -> None:
        n, r = comm.size, comm.rank
        robj, rcount, rdt = parse_buffer(recvbuf)
        nb = rcount * rdt.size
        if r == root:
            sobj, scount, sdt = parse_buffer(sendbuf)
            packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
            reqs = []
            for i in range(n):
                chunk = packed[i * nb : (i + 1) * nb]
                if i == root:
                    cv_unpack(chunk, robj, rcount, rdt)
                else:
                    reqs.append(_isend(comm, np.ascontiguousarray(chunk),
                                       i, TAG_SCATTER))
            for q in reqs:
                q.Wait()
        else:
            rb, rq = _irecv(comm, nb, root, TAG_SCATTER)
            rq.Wait()
            cv_unpack(rb, robj, rcount, rdt)

    def scatterv(self, comm, sendbuf, recvbuf, counts, displs,
                 root: int) -> None:
        n, r = comm.size, comm.rank
        robj, rcount, rdt = parse_buffer(recvbuf)
        if r == root:
            sobj, scount, sdt = parse_buffer(sendbuf)
            counts = list(counts)
            if displs is None:
                displs = np.cumsum([0] + counts[:-1]).tolist()
            packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
            esz = sdt.size
            reqs = []
            for i in range(n):
                chunk = packed[displs[i] * esz : (displs[i] + counts[i]) * esz]
                if i == root:
                    cv_unpack(chunk, robj, rcount, rdt)
                else:
                    reqs.append(_isend(comm, np.ascontiguousarray(chunk),
                                       i, TAG_SCATTER))
            for q in reqs:
                q.Wait()
        else:
            rb, rq = _irecv(comm, rcount * rdt.size, root, TAG_SCATTER)
            rq.Wait()
            cv_unpack(rb, robj, rcount, rdt)

    # ------------------------------------------------------------- alltoall
    def alltoall(self, comm, sendbuf, recvbuf) -> None:
        """Pairwise ring exchange (reference: coll_base_alltoall.c)."""
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        nb = packed.nbytes // n
        out = np.empty(packed.nbytes, dtype=np.uint8)
        out[r * nb : (r + 1) * nb] = packed[r * nb : (r + 1) * nb]
        for d in range(1, n):
            dst = (r + d) % n
            src = (r - d) % n
            chunk = np.ascontiguousarray(packed[dst * nb : (dst + 1) * nb])
            got = _sendrecv(comm, chunk, dst, nb, src, TAG_ALLTOALL)
            out[src * nb : (src + 1) * nb] = got
        cv_unpack(out, robj, rcount, rdt)

    def alltoallv(self, comm, sendbuf, recvbuf, sendcounts, sdispls,
                  recvcounts, rdispls) -> None:
        n, r = comm.size, comm.rank
        sobj, scount, sdt = parse_buffer(sendbuf)
        robj, rcount, rdt = parse_buffer(recvbuf)
        packed = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        se, re_ = sdt.size, rdt.size
        out = np.zeros(rcount * re_, dtype=np.uint8)
        own_s = packed[sdispls[r] * se : (sdispls[r] + sendcounts[r]) * se]
        out[rdispls[r] * re_ : rdispls[r] * re_ + own_s.nbytes] = own_s
        for d in range(1, n):
            dst = (r + d) % n
            src = (r - d) % n
            chunk = np.ascontiguousarray(
                packed[sdispls[dst] * se : (sdispls[dst] + sendcounts[dst]) * se])
            got = _sendrecv(comm, chunk, dst, recvcounts[src] * re_, src,
                            TAG_ALLTOALL)
            out[rdispls[src] * re_ : rdispls[src] * re_ + got.nbytes] = got
        cv_unpack(out, robj, rcount, rdt)

    def alltoallw(self, comm, sendbuf, recvbuf, sendcounts, sdispls,
                  sendtypes, recvcounts, rdispls, recvtypes) -> None:
        """MPI_Alltoallw: per-peer counts, BYTE displacements, and
        datatypes (the fully general exchange — reference:
        coll_basic_alltoallw.c; displacements are in bytes per the MPI
        spec, unlike alltoallv's element units)."""
        n, r = comm.size, comm.rank
        sobj, _, _ = parse_buffer(sendbuf)
        robj, _, _ = parse_buffer(recvbuf)
        sview = _as_bytes(sobj)
        rview = _as_bytes(robj)

        def _seg_len(dt, cnt: int) -> int:
            # full footprint incl. a leading true_lb gap (the convertor
            # gathers up to true_lb + true_extent - 1 on element 0)
            return max((cnt - 1) * dt.extent + dt.true_lb
                       + dt.true_extent, 0)

        def pack_block(dst: int) -> np.ndarray:
            dt = sendtypes[dst]
            cnt = sendcounts[dst]
            seg = sview[sdispls[dst] : sdispls[dst] + _seg_len(dt, cnt)]
            return np.ascontiguousarray(cv_pack(seg, cnt, dt))

        def unpack_block(src: int, data: np.ndarray) -> None:
            dt = recvtypes[src]
            cnt = recvcounts[src]
            seg = rview[rdispls[src] : rdispls[src] + _seg_len(dt, cnt)]
            cv_unpack(data, seg, cnt, dt)

        unpack_block(r, pack_block(r))
        for d in range(1, n):
            dst = (r + d) % n
            src = (r - d) % n
            got = _sendrecv(comm, pack_block(dst), dst,
                            recvcounts[src] * recvtypes[src].size, src,
                            TAG_ALLTOALL)
            unpack_block(src, got)

    # -------------------------------------------------------- reduce_scatter
    def reduce_scatter_block(self, comm, sendbuf, recvbuf,
                             op: _op.Op) -> None:
        n = comm.size
        robj, rcount, rdt = parse_buffer(recvbuf)
        tmp_obj = np.empty(rcount * n * max(rdt.extent, 1), dtype=np.uint8)
        tmp = [tmp_obj, rcount * n, rdt]
        self.reduce(comm, sendbuf, tmp, op, 0)
        self.scatter(comm, tmp, recvbuf, 0)

    def reduce_scatter(self, comm, sendbuf, recvbuf, recvcounts,
                       op: _op.Op) -> None:
        n, r = comm.size, comm.rank
        robj, rcount, rdt = parse_buffer(recvbuf)
        total = int(sum(recvcounts))
        tmp_obj = np.empty(total * max(rdt.extent, 1), dtype=np.uint8)
        tmp = [tmp_obj, total, rdt]
        self.reduce(comm, sendbuf, tmp, op, 0)
        self.scatterv(comm, tmp, recvbuf, recvcounts, None, 0)

    # ------------------------------------------------------------ scan/exscan
    def scan(self, comm, sendbuf, recvbuf, op: _op.Op) -> None:
        """Linear pipeline (reference: coll/basic scan — rank order is
        required for non-commutative correctness)."""
        n, r = comm.size, comm.rank
        src_buf = recvbuf if sendbuf is None else sendbuf
        obj, count, dt = parse_buffer(src_buf)
        packed = np.ascontiguousarray(cv_pack(obj, count, dt))
        if r > 0:
            rb, rq = _irecv(comm, packed.nbytes, r - 1, TAG_SCAN)
            rq.Wait()
            acc = _reduce_typed(op, _typed_view(rb, dt),
                                _typed_view(packed.copy(), dt))
        else:
            acc = _typed_view(packed.copy(), dt)
        acc_bytes = _wire(acc)
        if r < n - 1:
            _isend(comm, acc_bytes, r + 1, TAG_SCAN).Wait()
        robj, rcount, rdt = parse_buffer(recvbuf)
        cv_unpack(acc_bytes, robj, rcount, rdt)

    def exscan(self, comm, sendbuf, recvbuf, op: _op.Op) -> None:
        n, r = comm.size, comm.rank
        src_buf = recvbuf if sendbuf is None else sendbuf
        obj, count, dt = parse_buffer(src_buf)
        packed = np.ascontiguousarray(cv_pack(obj, count, dt))
        prefix: Optional[np.ndarray] = None
        if r > 0:
            rb, rq = _irecv(comm, packed.nbytes, r - 1, TAG_SCAN)
            rq.Wait()
            prefix = rb
        if r < n - 1:
            if prefix is None:
                nxt = packed
            else:
                nxt = _wire(_reduce_typed(op, _typed_view(prefix.copy(), dt),
                                          _typed_view(packed, dt)))
            _isend(comm, nxt, r + 1, TAG_SCAN).Wait()
        if prefix is not None:
            robj, rcount, rdt = parse_buffer(recvbuf)
            cv_unpack(prefix, robj, rcount, rdt)


_flat_singleton: Optional[BasicColl] = None


def flat_module() -> BasicColl:
    """The one shared, stateless ``BasicColl``: where han, hier and
    hier's decision engine send re-entrant or agreement traffic."""
    global _flat_singleton
    if _flat_singleton is None:
        _flat_singleton = BasicColl()
    return _flat_singleton


class BasicCollComponent(Component):
    NAME = "basic"
    PRIORITY = 10  # fallback (reference: coll/basic priority 10)

    _module: Optional[BasicColl] = None

    def query(self, comm=None, **ctx):
        from ompi_tpu_torch.comm.communicator import ProcComm

        if isinstance(comm, ProcComm):
            if BasicCollComponent._module is None:
                BasicCollComponent._module = BasicColl()
            return BasicCollComponent._module
        return None


coll_framework.register(BasicCollComponent())
