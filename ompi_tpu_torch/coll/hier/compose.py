"""Per-domain stage composition of process-mode collectives (coll/hier).

The port of ``ompi_tpu/coll/hier/compose.py``, with the same stages, Split
order, priority and delegation, so that ranks of the two packages compose
alike in one job. Directions: HiCCL (arxiv 2408.05962) — collectives
decomposed into per-domain stages beat flat algorithms once a comm spans
locality boundaries — and the multi-process-per-GPU allreduce split (arxiv
2508.13397): reduce toward the fast-domain leader, exchange between
leaders over the slow domain, fan back out:

- **host** stage — the all-local sub-communicator (han's ``low``), whose
  own coll table picks coll/sm segment collectives;
- **slice** stage — leaders of the same slice, present only when the
  topology carries slice identity (``coll_hier_fake_slices``);
- **cross** stage — slice/node leaders over tcp.

Sub-communicators are han's lazily built (low, up) pairs resolved through
:func:`coll.han.shared_han` — one shared module (and one Split) per comm
even when han and hier are both selected; the slice level nests the same
machinery on the up comm.

Composed verbs: allreduce, bcast, allgather, reduce_scatter_block.
Ineligible calls (non-commutative ops, IN_PLACE where the staging needs a
real send descriptor, payloads under ``coll_hier_min_bytes``) walk the
table's fallback chain (``CollTable.next_after``) to whatever would own
the slot had hier not been selected. Every composed call runs under the
decide engine: per-stage wall times feed the self-tuning re-score, and the
active plan ("hier"/"flat") is applied on agreed call indices.
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from ompi_tpu_torch.coll import han as _han
from ompi_tpu_torch.coll import hier as _hier
from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.coll.hier import decide as _decide
from ompi_tpu_torch.comm.communicator import parse_buffer
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.datatype import BYTE
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import get_var
from ompi_tpu_torch.runtime import metrics as _metrics
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.runtime import trace as _trace

_EMPTY = np.empty(0, np.uint8)

_COMPOSED = ("allreduce", "bcast", "allgather", "reduce_scatter_block")


def _flat_mod():
    """Re-entrancy fallback: the Splits inside subcomm construction run
    parent-comm collectives that dispatch back into hier's own slots
    (the han _building discipline)."""
    from ompi_tpu_torch.coll.basic import flat_module

    return flat_module()


class _Stager:
    """Per-call stage runner: wall-times each stage when the decide
    engine observes (selftune) or the metrics plane is on, applies the
    deterministic chaos-delay injection, and wraps stages in trace
    spans when tracing. The fully-disabled path is two attribute loads
    per call and a plain thunk call per stage."""

    __slots__ = ("verb", "idx", "observe", "mx", "timings", "t0")

    def __init__(self, verb: str, idx: int):
        self.verb = verb
        self.idx = idx
        self.observe = _decide.tuning()
        self.mx = _metrics._enable_var._value
        self.timings: Dict[str, float] = {}
        self.t0 = time.perf_counter() if (self.observe or self.mx) else 0.0

    def run(self, name: str, thunk):
        d = _decide.inject_delay_ms(name, self.idx)
        if d:
            time.sleep(d / 1000.0)
        timed = self.observe or self.mx
        s0 = time.perf_counter() if timed else 0.0
        if _trace.enabled():
            with _trace.span(f"coll.hier.{self.verb}.{name}", cat="coll"):
                thunk()
        else:
            thunk()
        if timed:
            us = (time.perf_counter() - s0) * 1e6
            self.timings[name] = round(us, 1)
            if self.mx:
                _hier.note_stage(self.verb, name, us)

    def total_us(self) -> float:
        return (time.perf_counter() - self.t0) * 1e6


class _StagePlan:
    """Pre-bound per-(verb, dtype, count-class) composition state — the
    CollPlan's inner keying. Frozen at first dispatch: the dtype-level
    eligibility verdict and the node-grouped<->rank-ordered permutation
    template (allgather) live here so the steady state does no
    re-derivation."""

    __slots__ = ("eligible", "order", "min_bytes")

    def __init__(self, eligible: bool, order=None, min_bytes: int = 0):
        self.eligible = eligible
        self.order = order
        self.min_bytes = min_bytes


class HierColl(CollModule):
    """Stage-composed allreduce/bcast/allgather/reduce_scatter_block on
    the (host, slice, cross) domain hierarchy."""

    def __init__(self, comm, dm):
        self._dm = dm
        self._han = _han.shared_han(comm, list(dm.node_of))
        self._up_mod = None      # nested han over the leaders (3-level)
        self._up_checked = False

    # ----------------------------------------------------------- helpers
    def _subcomms(self, comm):
        return self._han._subcomms(comm)

    def _up_module(self, up):
        """The slice-level module over the leaders comm, built once: a
        nested shared_han over the up comm whose 'node' identity is the
        slice id — the same lazily-built subcomm machinery, no third
        cache."""
        if not self._up_checked:
            self._up_checked = True
            dm = self._dm
            if dm.n_slices >= 2 and up is not None:
                leaders = sorted(min(dm.members_of_node(n))
                                 for n in range(dm.n_nodes))
                up_map = [dm.slice_of_rank(ld) for ld in leaders]
                counts: Dict[int, int] = {}
                for s in up_map:
                    counts[s] = counts.get(s, 0) + 1
                if len(counts) >= 2 and max(counts.values()) >= 2:
                    self._up_mod = _han.shared_han(up, up_map)
        return self._up_mod

    def _delegate(self, comm, verb: str):
        """The module that would own this slot had hier not been
        selected (full-chain delegation: a conditional runner-up like
        quant never bounces back into hier)."""
        return comm.coll.next_after(verb, "hier")

    def _enter(self, comm, verb: str):
        """Per-call preamble shared by every composed slot: bump the
        (cid, verb) call index and run the agreed-index plan sync."""
        st = _decide.state_for(comm, verb)
        i = st.idx
        st.idx = i + 1
        if _decide.sync_due(i):
            _decide.sync(comm, st, i)
        return st, i

    def _run_flat(self, comm, st, verb: str, timed: bool, call):
        """Execute the fallback chain; when the flat PLAN is the active
        selection (not an eligibility bailout) its latency feeds the
        decide engine so a degraded flat path can re-score back."""
        fn = self._delegate(comm, verb)
        if timed and _decide.tuning():
            t0 = time.perf_counter()
            out = call(fn)
            _decide.report(comm, st, "flat",
                           (time.perf_counter() - t0) * 1e6, {})
            return out
        return call(fn)

    def _finish(self, comm, st, sg: _Stager) -> None:
        if sg.observe:
            _decide.report(comm, st, "hier", sg.total_us(), sg.timings)

    def _stage_plan(self, st, verb: str, dt, commutative: bool,
                    in_place: bool) -> _StagePlan:
        key = (verb, getattr(dt, "np_dtype", None), commutative, in_place)
        sp = st.bound.get(key)
        if sp is None:
            eligible = commutative and not in_place
            order = None
            if eligible and verb == "allgather":
                dm = self._dm
                order = [m for n in range(dm.n_nodes)
                         for m in dm.members_of_node(n)]
            # the static min_bytes table is floored by the MEASURED
            # bandwidth-delay product of this rank's cross links
            # (linkmodel, when armed): a composed pipeline pays ~one
            # extra cross-link RTT per stage, so composition pays off
            # only once the payload dwarfs what the wire holds in one
            # RTT. Frozen per (verb, dtype, flags) like min_bytes — the
            # plan, not the hot path, reads the telemetry.
            sp = _StagePlan(eligible, order,
                            max(int(get_var("coll_hier", "min_bytes")),
                                _decide.link_floor_bytes()))
            st.bound[key] = sp
        return sp

    # --------------------------------------------------------- allreduce
    def allreduce(self, comm, sendbuf, recvbuf, op: _op.Op = _op.SUM) -> None:
        if getattr(_han._building, "active", False):
            return _flat_mod().allreduce(comm, sendbuf, recvbuf, op)
        st, i = self._enter(comm, "allreduce")
        robj, rcount, rdt = parse_buffer(recvbuf)
        sp = self._stage_plan(st, "allreduce", rdt, op.commutative, False)
        nbytes = rcount * rdt.size
        if not sp.eligible or nbytes < sp.min_bytes:
            fn = self._delegate(comm, "allreduce")
            return fn(comm, sendbuf, recvbuf, op)
        if st.active != "hier":
            return self._run_flat(
                comm, st, "allreduce", True,
                lambda fn: fn(comm, sendbuf, recvbuf, op))
        low, up = self._subcomms(comm)
        sg = _Stager("allreduce", i)
        with spc.suppressed():
            sg.run("host.reduce",
                   lambda: low.Reduce(sendbuf, recvbuf, op=op, root=0))
            if up is not None:
                self._up_allreduce(sg, up, robj, recvbuf, rcount, rdt, op)
            sg.run("host.bcast", lambda: low.Bcast(recvbuf, root=0))
        self._finish(comm, st, sg)

    def _up_allreduce(self, sg, up, robj, recvbuf, rcount, rdt, op) -> None:
        """The leader phase: flat over the up comm in the two-level
        shape, or reduce-to-slice-leader / cross-slice-allreduce /
        slice-bcast when the topology carries slices."""
        uh = self._up_module(up)
        spec = [_han._copy_of(robj), rcount, rdt]
        if uh is None:
            sg.run("cross.allreduce",
                   lambda: up.Allreduce(spec, recvbuf, op=op))
            return
        mid, top = uh._subcomms(up)
        sg.run("slice.reduce",
               lambda: mid.Reduce(spec, recvbuf, op=op, root=0))
        if top is not None:
            def cross():
                top.Allreduce([_han._copy_of(robj), rcount, rdt], recvbuf,
                              op=op)

            sg.run("cross.allreduce", cross)
        sg.run("slice.bcast", lambda: mid.Bcast(recvbuf, root=0))

    # ------------------------------------------------------------- bcast
    def bcast(self, comm, buf, root: int = 0) -> None:
        if getattr(_han._building, "active", False):
            return _flat_mod().bcast(comm, buf, root)
        st, i = self._enter(comm, "bcast")
        if st.active != "hier":
            return self._run_flat(comm, st, "bcast", True,
                                  lambda fn: fn(comm, buf, root))
        low, up = self._subcomms(comm)
        dm = self._dm
        root_node = dm.node_of[root]
        my_node = dm.node_of[comm.rank]
        sg = _Stager("bcast", i)
        with spc.suppressed():
            if my_node == root_node:
                # distribute within the root's node first so its leader
                # holds the data for the leader phase
                sg.run("host.bcast_in",
                       lambda: low.Bcast(buf,
                                         root=self._han._low_rank[root]))
            if up is not None:
                uh = self._up_module(up)
                ur = self._han._up_rank_of_node[root_node]
                if uh is None:
                    sg.run("cross.bcast",
                           lambda: up.Bcast(buf, root=ur))
                else:
                    # the nested module runs slice-in / cross / slice-out
                    sg.run("cross.bcast",
                           lambda: uh.bcast(up, buf, ur))
            if my_node != root_node:
                sg.run("host.bcast", lambda: low.Bcast(buf, root=0))
        self._finish(comm, st, sg)

    # --------------------------------------------------------- allgather
    def allgather(self, comm, sendbuf, recvbuf) -> None:
        if getattr(_han._building, "active", False):
            return _flat_mod().allgather(comm, sendbuf, recvbuf)
        st, i = self._enter(comm, "allgather")
        robj, rcount, rdt = parse_buffer(recvbuf)
        sp = self._stage_plan(st, "allgather", rdt, True, sendbuf is None)
        nbytes = rcount * rdt.size
        if not sp.eligible or nbytes < sp.min_bytes:
            fn = self._delegate(comm, "allgather")
            return fn(comm, sendbuf, recvbuf)
        if st.active != "hier":
            return self._run_flat(comm, st, "allgather", True,
                                  lambda fn: fn(comm, sendbuf, recvbuf))
        from ompi_tpu_torch.core.convertor import pack as cv_pack, \
            unpack as cv_unpack

        dm = self._dm
        n = comm.size
        sobj, scount, sdt = parse_buffer(sendbuf)
        blk = np.ascontiguousarray(cv_pack(sobj, scount, sdt))
        nb = blk.nbytes
        low, up = self._subcomms(comm)
        nlocal = low.Get_size()
        nodebuf = np.empty(nlocal * nb, np.uint8) if up is not None \
            else _EMPTY
        allbuf = np.empty(n * nb, np.uint8)
        sg = _Stager("allgather", i)
        with spc.suppressed():
            # host: gather the node's blocks at its leader (low-rank
            # order == ascending comm rank within the node)
            sg.run("host.gather",
                   lambda: low.Gather([blk, nb, BYTE],
                                      [nodebuf, nlocal * nb, BYTE],
                                      root=0))
            if up is not None:
                counts = [len(dm.members_of_node(node)) * nb
                          for node in range(dm.n_nodes)]
                sg.run("cross.allgatherv",
                       lambda: up.Allgatherv(
                           [nodebuf, nlocal * nb, BYTE],
                           [allbuf, n * nb, BYTE], counts))
            # host: every member receives the node-grouped surface
            sg.run("host.bcast",
                   lambda: low.Bcast([allbuf, n * nb, BYTE], root=0))
        # node-grouped -> comm-rank order via the pre-bound permutation
        out = np.empty(n * nb, np.uint8)
        for pos, m in enumerate(sp.order):
            out[m * nb:(m + 1) * nb] = allbuf[pos * nb:(pos + 1) * nb]
        cv_unpack(out, robj, rcount, rdt)
        self._finish(comm, st, sg)

    # ----------------------------------------------- reduce_scatter_block
    def reduce_scatter_block(self, comm, sendbuf, recvbuf,
                             op: _op.Op = _op.SUM) -> None:
        if getattr(_han._building, "active", False):
            return _flat_mod().reduce_scatter_block(comm, sendbuf,
                                                    recvbuf, op)
        st, i = self._enter(comm, "reduce_scatter_block")
        robj, rcount, rdt = parse_buffer(recvbuf)
        # contiguity gate: the block slicing below addresses the reduced
        # vector as packed bytes, which is only the unpacked layout for
        # contiguous datatypes (the han.reduce staging rule)
        sp = self._stage_plan(st, "reduce_scatter_block", rdt,
                              op.commutative and rdt.is_contiguous,
                              sendbuf is None)
        n = comm.size
        if not sp.eligible or n * rcount * rdt.size < sp.min_bytes:
            fn = self._delegate(comm, "reduce_scatter_block")
            return fn(comm, sendbuf, recvbuf, op)
        if st.active != "hier":
            return self._run_flat(
                comm, st, "reduce_scatter_block", True,
                lambda fn: fn(comm, sendbuf, recvbuf, op))
        from ompi_tpu_torch.core.convertor import unpack as cv_unpack

        dm = self._dm
        total = n * rcount
        low, up = self._subcomms(comm)
        tmp = np.empty(total * rdt.size, np.uint8)
        sg = _Stager("reduce_scatter_block", i)
        with spc.suppressed():
            # host: reduce the full vector onto the node leader
            sg.run("host.reduce",
                   lambda: low.Reduce(sendbuf, [tmp, total, rdt],
                                      op=op, root=0))
            if up is not None:
                def cross():
                    t2 = tmp.copy()
                    up.Allreduce([t2, total, rdt], [tmp, total, rdt],
                                 op=op)

                sg.run("cross.allreduce", cross)
            # host: leader scatters each member its own block (node
            # members in low-rank order == ascending comm rank)
            if up is not None:
                members = dm.members_of_node(dm.node_of[comm.rank])
                nb = rcount * rdt.size
                sendv = np.empty(len(members) * nb, np.uint8)
                for j, m in enumerate(members):
                    sendv[j * nb:(j + 1) * nb] = tmp[m * nb:(m + 1) * nb]
                sg.run("host.scatter",
                       lambda: low.Scatter(
                           [sendv, len(members) * rcount, rdt],
                           recvbuf, root=0))
            else:
                sg.run("host.scatter",
                       lambda: low.Scatter([_EMPTY, 0, rdt], recvbuf,
                                           root=0))
        self._finish(comm, st, sg)


class HierCollComponent(Component):
    NAME = "hier"
    PRIORITY = 55  # above smcoll(50)/adaptive(48)/han(45): owns the
    # composed slots on multi-domain comms; below self(75)/mesh/quant

    def query(self, comm=None, **ctx: Any) -> Optional[HierColl]:
        from ompi_tpu_torch.comm.communicator import ProcComm

        if getattr(_han._building, "active", False):
            return None  # never stack hier inside its own subcomms
        if not isinstance(comm, ProcComm) or comm.size < 3:
            return None
        if not get_var("coll_hier", "enable"):
            return None
        dm = _decide.domain_map_for(comm)
        if dm is None or not dm.nontrivial:
            return None
        return HierColl(comm, dm)


coll_framework.register(HierCollComponent())
