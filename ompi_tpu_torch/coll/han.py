"""coll/han — hierarchical two-level collectives.

The port of ``ompi_tpu/coll/han.py`` (reference: ompi/mca/coll/han — each
collective split into an intra-node phase over the fast local transport and
an inter-node phase between per-node leaders, with the sub-communicators
built lazily on first use, coll_han_subcomms.c), with the same variable,
priority, tag and Split order, so that ranks of the two packages build the
same sub-communicators with the same CIDs in one job.

A "node" is the set of peers reached over self/sm; the leader ("up") phase
rides tcp. Mesh-mode comms never take this component.

Decision rule (reference: the coll_han component query): at least two
nodes and at least one node with two or more ranks — otherwise the
two-level split degenerates and the flat algorithms win. The node map
comes from the modex cards alone, identical on every member: a mixed
han/flat selection deadlocks the first collective.
"""

from __future__ import annotations

import threading
import weakref
from typing import Any, List, Optional

import numpy as np
import torch

from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.comm.communicator import UNDEFINED
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_var, get_var
from ompi_tpu_torch.runtime import spc

# while han builds its own sub-communicators, their coll selection must not
# pick han again (under fake topologies the round-robin map could otherwise
# recurse a level per Split)
_building = threading.local()

# per-process cache of universe rank -> node identity (world-static)
_node_sid_cache: dict = {}

# the one HanColl of a comm: han's query and coll/hier's composer share it,
# and with it one lazily built (low, up) pair (weak values: the comm's coll
# table holds the module through its bound slots)
_shared_modules: "weakref.WeakValueDictionary" = weakref.WeakValueDictionary()


def shared_han(comm, node_of: "List[int]") -> "HanColl":
    """The one HanColl (and its leader sub-communicators) of this comm.
    Node ids are normalized to first-seen order before the identity check:
    han's modex map carries first-seen-rank ids ([0,0,2,2]) where hier's
    DomainMap has 0..k-1 ([0,0,1,1]) for the same layout."""
    first: dict = {}
    norm = [first.setdefault(n, len(first)) for n in node_of]
    key = comm.cid
    m = _shared_modules.get(key)
    if m is None or m._node_of != norm:
        m = HanColl(norm)
        _shared_modules[key] = m
    return m


register_var("coll_han", "fake_nodes", 0,
             help="Pretend the comm spans N nodes (round-robin by rank) — "
                  "the single-host test hook for the hierarchy "
                  "(reference analog: han's topology override vars)",
             level=7)


def _copy_of(obj):
    """A copy of a buffer object (ndarray, byte buffer or CPU tensor)."""
    if isinstance(obj, torch.Tensor):
        return obj.clone()
    return np.array(np.asarray(obj), copy=True)


class HanColl(CollModule):
    """Two-level allreduce/bcast/reduce/barrier over lazily built (low, up)
    sub-communicators."""

    def __init__(self, node_of: List[int]):
        # the full node map, identical on every member (modex or the fake
        # topology variable)
        self._node_of = node_of
        self._low = None
        self._up = None       # leaders comm (None on non-leaders)
        self._built = False
        leaders = sorted(min(r for r, n in enumerate(node_of) if n == node)
                         for node in set(node_of))
        self._up_rank_of_node = {node_of[ld]: i
                                 for i, ld in enumerate(leaders)}
        self._leader_of_node = {node_of[ld]: ld for ld in leaders}
        members: dict = {}
        for r, n in enumerate(node_of):
            members.setdefault(n, []).append(r)
        self._low_rank = {r: members[n].index(r)
                          for r, n in enumerate(node_of)}

    # ------------------------------------------------------------ subcomms
    def _subcomms(self, comm):
        """Build (low, up) on first use, inside the first collective, which
        is the same on every member (reference: coll_han_subcomms.c)."""
        if not self._built:
            _building.active = True
            try:
                with spc.suppressed():
                    node = self._node_of[comm.rank]
                    low = comm.Split(node, comm.rank)
                    is_leader = low.Get_rank() == 0
                    up = comm.Split(0 if is_leader else UNDEFINED,
                                    comm.rank)
            finally:
                _building.active = False
            self._low, self._up = low, up
            self._built = True
        return self._low, self._up

    def _up_root(self, comm, root_node: int) -> int:
        """The up-comm rank of root_node's leader (leaders ordered by comm
        rank; each node's leader is its lowest comm rank)."""
        return self._up_rank_of_node[root_node]

    # ---------------------------------------------------------- collectives
    @staticmethod
    def _flat():
        """The flat path of re-entrant calls: the Splits inside _subcomms
        run parent-comm collectives that dispatch back into han's slots."""
        from ompi_tpu_torch.coll.basic import flat_module

        return flat_module()

    def allreduce(self, comm, sendbuf, recvbuf, op: _op.Op = _op.SUM) -> None:
        """low reduce -> leaders allreduce -> low bcast. Non-commutative ops
        take the flat path: the split regroups contributions out of rank
        order."""
        if getattr(_building, "active", False) or not op.commutative:
            return self._flat().allreduce(comm, sendbuf, recvbuf, op)
        from ompi_tpu_torch.comm.communicator import parse_buffer

        low, up = self._subcomms(comm)
        with spc.suppressed():
            low.Reduce(sendbuf, recvbuf, op=op, root=0)
            if up is not None:
                robj, rcount, rdt = parse_buffer(recvbuf)
                up.Allreduce([_copy_of(robj), rcount, rdt], recvbuf, op=op)
            low.Bcast(recvbuf, root=0)

    # coll-plane tag of the leader->root hand-off in a rooted reduce
    _TAG_REDUCE_HANDOFF = -70

    def reduce(self, comm, sendbuf, recvbuf, op: _op.Op = _op.SUM,
               root: int = 0) -> None:
        """Rooted two-level reduce (recvbuf significant only at root), with
        a leader->root hand-off when the root is not its node's leader."""
        if getattr(_building, "active", False) or not op.commutative \
                or sendbuf is None:
            # flat path for non-commutative ops and MPI_IN_PLACE (the
            # staging below needs a real send descriptor)
            return self._flat().reduce(comm, sendbuf, recvbuf, op, root)
        from ompi_tpu_torch.coll.basic import COLL_CID_BIT
        from ompi_tpu_torch.comm.communicator import parse_buffer
        from ompi_tpu_torch.core.convertor import _as_byte_view

        low, up = self._subcomms(comm)
        sobj, scount, sdt = parse_buffer(sendbuf)
        if not sdt.is_contiguous:
            # the packed staging buffer is not a valid unpacked buffer for
            # derived datatypes (extent > size)
            return self._flat().reduce(comm, sendbuf, recvbuf, op, root)
        tmp = np.zeros(scount * sdt.size, np.uint8)
        tview = [tmp, scount, sdt]
        with spc.suppressed():
            low.Reduce(sendbuf, tview, op=op, root=0)
            root_up = self._up_rank_of_node[self._node_of[root]]
            if up is not None:
                tmp2 = np.zeros_like(tmp)
                up.Reduce(tview, [tmp2, scount, sdt], op=op, root=root_up)
                tmp = tmp2
        # hand the result from the root node's leader to the root
        leader_is_root = (self._low_rank[root] == 0)
        cid = comm.cid | COLL_CID_BIT
        if comm.rank == root:
            robj, rcount, rdt = parse_buffer(recvbuf)
            if leader_is_root and up is not None:
                _as_byte_view(robj)[: scount * sdt.size] = tmp
            else:
                leader = self._leader_of_node[self._node_of[root]]
                comm.pml.irecv(robj, rcount, rdt,
                               comm._world_rank(leader),
                               self._TAG_REDUCE_HANDOFF, cid).Wait()
        if (not leader_is_root
                and comm.rank == self._leader_of_node[self._node_of[root]]):
            comm.pml.isend(tmp, scount, sdt, comm._world_rank(root),
                           self._TAG_REDUCE_HANDOFF, cid).Wait()

    def bcast(self, comm, buf, root: int = 0) -> None:
        if getattr(_building, "active", False):
            return self._flat().bcast(comm, buf, root)
        low, up = self._subcomms(comm)
        root_node = self._node_of[root]
        my_node = self._node_of[comm.rank]
        with spc.suppressed():
            if my_node == root_node:
                # within the root's node first, so that its leader holds
                # the data for the up phase
                low.Bcast(buf, root=self._low_rank_of(comm, root))
            if up is not None:
                up.Bcast(buf, root=self._up_root(comm, root_node))
            if my_node != root_node:
                low.Bcast(buf, root=0)

    def _low_rank_of(self, comm, root: int) -> int:
        return self._low_rank[root]

    def barrier(self, comm) -> None:
        if getattr(_building, "active", False):
            return self._flat().barrier(comm)
        low, up = self._subcomms(comm)
        with spc.suppressed():
            low.Barrier()
            if up is not None:
                up.Barrier()
            low.Barrier()


class HanCollComponent(Component):
    NAME = "han"
    PRIORITY = 45  # above tuned/basic; below mesh/self

    def query(self, comm=None, **ctx: Any) -> Optional[HanColl]:
        from ompi_tpu_torch.comm.communicator import ProcComm

        if getattr(_building, "active", False):
            return None  # never stack han inside its own subcomms
        if not isinstance(comm, ProcComm) or comm.size < 3:
            return None
        fake = int(get_var("coll_han", "fake_nodes"))
        if fake > 1:
            if fake >= comm.size:
                return None  # no node would hold 2+ ranks
            return shared_han(comm, [r % fake for r in range(comm.size)])
        node_of = self._modex_node_map(comm)
        if node_of is None:
            return None
        n_nodes = len(set(node_of))
        biggest = max(node_of.count(n) for n in set(node_of))
        if n_nodes >= 2 and biggest >= 2:
            return shared_han(comm, node_of)
        return None

    @staticmethod
    def _modex_node_map(comm) -> Optional[List[int]]:
        """Node id per comm rank from the modex ``btl.sm.node`` cards: the
        same store on every member, so the selection (and the map) agrees
        everywhere. Per-rank endpoint heuristics would not: lazily wired
        cross-job endpoints differ between members."""
        from ompi_tpu_torch.runtime import wireup

        ctx = wireup._ctx
        if ctx is None:
            return None
        modex = ctx["modex"]
        raw = []
        for r in range(comm.size):
            w = comm._world_rank(r)
            sid = _node_sid_cache.get(w)
            if sid is None:
                try:
                    # post-fence, a missing card never appears: don't wait
                    sid = str(modex.get(w, "btl.sm.node", timeout=0.0))
                    # only real cards are cached: a transient miss must
                    # not freeze a wrong identity for the process's life
                    _node_sid_cache[w] = sid
                except Exception:
                    sid = f"solo-{w}"  # no sm: its own node (uncached)
            raw.append(sid)
        first: dict = {}
        return [first.setdefault(sid, r) for r, sid in enumerate(raw)]


coll_framework.register(HanCollComponent())
