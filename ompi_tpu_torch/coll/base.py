"""The coll framework: a communicator's table of collectives, by selection.

The port of ``ompi_tpu/coll/base.py`` (reference: ompi/mca/coll,
coll_base_comm_select.c:216). ``select_coll(comm)`` queries every
registered component for the communicator and fills a ``CollTable`` slot
by slot from the modules in priority order: the first module that has a
slot's method takes it, the others queue behind it as its fallbacks.
"""

from __future__ import annotations

from ompi_tpu_torch.mca.component import framework

coll_framework = framework("coll", "Collective operations")

# the slots (reference: coll.h:545-620, blocking, neighbourhood and
# nonblocking)
COLL_OPS = (
    "allgather", "allgatherv", "allreduce", "alltoall", "alltoallv",
    "alltoallw", "barrier", "bcast", "exscan", "gather", "gatherv",
    "reduce", "reduce_scatter", "reduce_scatter_block", "scan", "scatter",
    "scatterv",
    "neighbor_allgather", "neighbor_alltoall",
    "ibarrier", "ibcast", "ireduce", "iallreduce", "iallgather",
    "iallgatherv", "ialltoall", "ialltoallv", "igather", "igatherv",
    "iscatter", "iscatterv", "ireduce_scatter_block", "iscan", "iexscan",
)


class CollModule:
    """Base of the modules a coll component returns: they implement the
    slots they can serve for the queried communicator."""

    def enable(self, comm) -> None:
        pass


class CollTable:
    """A communicator's collectives (reference: comm->c_coll)."""

    def __init__(self):
        self.slots = {}
        self.providers = {}  # op -> the component name that won it
        # op -> the modules' methods below the winner, in priority order,
        # and their component names (reference: the whole priority-ordered
        # module list the comm keeps)
        self.fallbacks = {}
        self.fallback_providers = {}

    def get(self, op: str):
        fn = self.slots.get(op)
        if fn is None:
            raise NotImplementedError(
                f"no collective module provides '{op}' for this "
                "communicator")
        return fn

    def next_after(self, op: str, name: str):
        """The method of the module ranked right below component ``name``
        in this slot's chain: where a conditional component (quant, hier)
        sends a call it declines. A caller not in the chain (the winner)
        gets the first fallback. ``KeyError`` when nothing ranks below the
        caller (coll/basic provides every op, so that is a broken
        invariant)."""
        names = self.fallback_providers.get(op, [])
        fns = self.fallbacks.get(op, [])
        if name in names:
            # one module per component in a slot, so the next entry is it
            i = names.index(name) + 1
            if i < len(fns):
                return fns[i]
            raise KeyError(
                f"no module ranks below '{name}' for slot '{op}'")
        if not fns:
            raise KeyError(f"no fallback chain recorded for slot '{op}'")
        return fns[0]


def select_coll(comm) -> CollTable:
    """The comm's table: the highest-priority module wins each slot."""
    from ompi_tpu_torch.runtime import trace as _trace

    if _trace.enabled():
        with _trace.span("coll.select", cat="coll",
                         comm=getattr(comm, "name", "")):
            return _select_coll(comm)
    return _select_coll(comm)


def _select_coll(comm) -> CollTable:
    table = CollTable()
    for _, name, module in coll_framework.select_all(comm=comm):
        module.enable(comm)
        for op in COLL_OPS:
            fn = getattr(module, op, None)
            if fn is None:
                continue
            if op in table.slots:
                table.fallbacks.setdefault(op, []).append(fn)
                table.fallback_providers.setdefault(op, []).append(name)
            else:
                table.slots[op] = fn
                table.providers[op] = name
    return table
