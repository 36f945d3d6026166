"""Mesh-mode communicators: MPI_COMM_WORLD as the rank dim of one tensor.

The port of ``ompi_tpu/parallel/mesh.py``. The model is single-controller,
as in the JAX package: the controller holds every rank; a distributed
buffer is one tensor whose leading dim is the rank dim, held on the
communicator's device (``cuda`` unless the caller names another).
Sub-communicators (Split / Create_group) are a partition of all positions
into groups; every collective acts within each group at once, and one comm
object *is* every colour's communicator, observed from the controller.
Positions outside any group (Create_group non-members, UNDEFINED colours)
are padded as singleton groups, which keep their own data.

The collectives are those of the modules ``coll/base.py`` selects for the
comm when it is built (``MeshColl`` of ``coll/mesh.py``, and the quantized
allreduce of ``coll/quant.py`` where its verdict is active). Each verb's
first call per cache key resolves its callable into the comm's ``_cache``;
a later call is a lookup in the coll table and one in the cache, then the
tensor ops. (The JAX package keeps a second, "fast" table in front of its
cache to skip re-checks and ``jit`` lookups; here the callables are generic
over shape and dtype, so it could save at most the gap between a verb's
host time and its cached callable's, which ``chip_smoke.py`` phase 4d
prints.) That one lookup path carries what the reference's two carry: the
verb's spc counter and its ``comm.<verb>`` trace span, once a call.

Beside the blocking verbs: the nonblocking ones (``iallreduce`` and the
rest, whose requests complete on a CUDA event), the persistent ones
(``allreduce_init`` and the rest, which freeze the cached callable into
the request), partitioned transfers (``Psend_init``) and ``reshard``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ompi_tpu_torch.coll import mesh as _mesh
from ompi_tpu_torch.coll import persist as _persist
from ompi_tpu_torch.coll import quant as _quant_coll  # noqa: F401 registers
from ompi_tpu_torch.coll.base import select_coll
from ompi_tpu_torch.coll.mesh import cache_key
from ompi_tpu_torch.coll.sched import DeviceRequest, MeshPersistentRequest
from ompi_tpu_torch.comm.communicator import UNDEFINED, Intracomm
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.errors import (
    MPIError,
    ERR_ARG,
    ERR_RANK,
    ERR_UNSUPPORTED_OPERATION,
)
from ompi_tpu_torch.core.group import Group
from ompi_tpu_torch.core.request import CompletedRequest
from ompi_tpu_torch.device import DeviceLike, resolve_device
from ompi_tpu_torch.parallel.partitioned import MeshPartitionedRequest
from ompi_tpu_torch.reshard.exec import mesh_reshard
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.runtime import trace as _tr

__all__ = ["MeshComm", "UNDEFINED", "mesh_world"]

# the trace gate, one attribute load of the live Var on every verb
_tracing = _tr._enable_var

_next_mesh_cid = [100]


class MeshComm(Intracomm):
    """A communicator (or a colour family of communicators) over the rank
    dim of tensors on one device.

    ``groups`` is None for the world comm, else a partition of all
    positions; collectives act within each group independently.
    """

    def __init__(self, world_size: int, device: torch.device,
                 axis: str = "mpi_world",
                 groups: Optional[Tuple[Tuple[int, ...], ...]] = None,
                 name: str = ""):
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.axis = axis
        if groups is not None:
            groups = tuple(tuple(int(r) for r in g) for g in groups)
            flat = sorted(r for g in groups for r in g)
            if flat != list(range(self.world_size)):
                raise MPIError(
                    ERR_ARG,
                    "groups must partition all mesh positions "
                    "(pad non-members as singleton groups)",
                )
        self.groups = groups
        # pos_map[position] = rank within its group; singleton_mask marks
        # padding groups excluded from schedules
        pos = np.arange(self.world_size, dtype=np.int32)
        single = np.zeros(self.world_size, dtype=bool)
        if groups is not None:
            for g in groups:
                for p, r in enumerate(g):
                    pos[r] = p
                    single[r] = len(g) == 1
        self.pos_map = pos
        self.singleton_mask = single
        cid = _next_mesh_cid[0]
        _next_mesh_cid[0] += 1
        super().__init__(Group(range(self.world_size)), cid,
                         name or f"mesh-comm-{cid}")
        # cache key -> resolved callable, filled by MeshColl on a miss
        self._cache = {}
        # every new comm is selected anew: the quantized allreduce takes
        # the slot where quant_enable is set and the comm is the whole axis
        self.coll = select_coll(self)

    # ------------------------------------------------------------- queries
    @property
    def size(self) -> int:
        """Group size: uniform across non-singleton colours (singletons are
        padding); raises if real colours differ in size."""
        if self.groups is None:
            return self.world_size
        sizes = {len(g) for g in self.groups if len(g) > 1}
        if not sizes:
            return 1
        if len(sizes) != 1:
            raise MPIError(
                ERR_UNSUPPORTED_OPERATION,
                "non-uniform color sizes: split into uniform colors or "
                "query per-color via .groups",
            )
        return next(iter(sizes))

    def Get_rank(self):
        raise MPIError(
            ERR_UNSUPPORTED_OPERATION,
            "the mesh-mode controller holds all ranks; a rank's data is "
            "row r of the rank dim")

    def _check_root(self, root: int) -> None:
        # a root is a group-local position; groups smaller than root + 1
        # have no such member and their rows get zeros
        if self.groups is None:
            limit = self.world_size
        else:
            limit = max((len(g) for g in self.groups), default=1)
        if not 0 <= root < limit:
            raise MPIError(ERR_RANK, f"root {root} out of range")

    # ------------------------------------------------------------ placement
    def sharding(self) -> torch.device:
        """Where the comm's distributed buffers live: one tensor on this
        device, rank dim first."""
        return self.device

    def shard(self, x) -> torch.Tensor:
        """A [world, ...] numpy array or tensor as a tensor on the comm's
        device (numpy input is copied; its dtype is kept)."""
        t = x.to(self.device) if isinstance(x, torch.Tensor) \
            else torch.tensor(np.asarray(x), device=self.device)
        if t.dim() < 1 or t.shape[0] != self.world_size:
            raise MPIError(ERR_ARG, f"a distributed buffer is [world="
                                    f"{self.world_size}, ...], got "
                                    f"{tuple(t.shape)}")
        return t

    # ------------------------------------------- functional collectives
    # Each verb is one lookup in the coll table and one in the comm's cache
    # of resolved callables (``MeshColl._cached``); the callables check the
    # payload's contracts themselves on every call. The lookup records the
    # verb's spc counter and, when tracing, wraps the slot in its
    # ``comm.<verb>`` span (reference: ``parallel/mesh.py:152-174``).
    def _slot(self, name: str, root: Optional[int] = None):
        self._check_usable()
        if root is not None:
            self._check_root(root)
        spc.record(name)
        try:
            fn = self.coll.slots[name]
        except KeyError:
            fn = self.coll.get(name)  # raises: no module has the slot
        if _tracing._value:
            return _tr.wrap_span("comm." + name, "comm", fn)
        return fn

    def _hot(self, verb: str, fn, *args):
        """A frozen callable's call: the verb's spc counter, a cache hit and
        the ``comm.<verb>`` span, as the reference's fast path counts them
        (``parallel/mesh.py:163-174``)."""
        spc.record(verb)
        _mesh.stats.hits += 1
        if _tracing._value:
            with _tr.span("comm." + verb, cat="comm"):
                return fn(*args)
        return fn(*args)

    def allreduce(self, x, op: _op.Op = _op.SUM):
        return self._slot("allreduce")(self, x, op)

    def reduce(self, x, op: _op.Op = _op.SUM, root: int = 0):
        return self._slot("reduce", root)(self, x, op, root)

    def bcast(self, x, root: int = 0):
        return self._slot("bcast", root)(self, x, root)

    def allgather(self, x):
        return self._slot("allgather")(self, x)

    def alltoall(self, x):
        return self._slot("alltoall")(self, x)

    def reduce_scatter(self, x, op: _op.Op = _op.SUM):
        return self._slot("reduce_scatter_block")(self, x, op)

    def scan(self, x, op: _op.Op = _op.SUM):
        return self._slot("scan")(self, x, op)

    def exscan(self, x, op: _op.Op = _op.SUM):
        return self._slot("exscan")(self, x, op)

    def barrier(self) -> None:
        self._slot("barrier")(self)

    def gather(self, x, root: int = 0):
        return self._slot("gather", root)(self, x, root)

    def scatter(self, x, root: int = 0):
        return self._slot("scatter", root)(self, x, root)

    # MPI-style aliases
    Allreduce = allreduce
    Bcast = bcast
    Allgather = allgather
    Alltoall = alltoall
    Barrier = barrier

    # ------------------------------------ nonblocking collectives (MPI_I*)
    # A verb enqueues its tensor ops on the current CUDA stream and returns
    # before the device runs them; the I* verb surfaces that as a request
    # whose ``result`` holds the output tensor and which completes when the
    # device has run the verb (``coll/sched.py`` ``DeviceRequest``).
    def iallreduce(self, x, op: _op.Op = _op.SUM):
        return DeviceRequest(self.allreduce(x, op))

    def ibcast(self, x, root: int = 0):
        return DeviceRequest(self.bcast(x, root))

    def ireduce(self, x, op: _op.Op = _op.SUM, root: int = 0):
        return DeviceRequest(self.reduce(x, op, root))

    def iallgather(self, x):
        return DeviceRequest(self.allgather(x))

    def ialltoall(self, x):
        return DeviceRequest(self.alltoall(x))

    def ireduce_scatter(self, x, op: _op.Op = _op.SUM):
        return DeviceRequest(self.reduce_scatter(x, op))

    def ibarrier(self):
        """The barrier waits for the device, so it is complete when it
        returns."""
        self.barrier()
        return CompletedRequest()

    # ------------------------------------ persistent collectives (X_init)
    # Init runs the verb once, which builds and caches its callable; with
    # ``coll_persist_enable`` it then freezes that callable into the
    # request, so a Start is the callable alone (``_hot``: its counter and
    # span, no coll-table or cache lookup). The comm's usability is still
    # checked at every Start. With ``coll_persist_donate`` a Start with a
    # fresh operand writes the result into it (reference:
    # ompi/mca/coll/coll.h:545-620).
    def _pcoll_init(self, verb: str, x, *args, key=None, bind=()):
        fn = getattr(self, verb)
        fn(x, *args)  # warm-up: the callable is built and cached now
        frozen = None
        if key is not None and _persist._enable_var._value:
            f = self._cache[key]
            frozen = (lambda a, _f=f, _b=bind: _f(a, *_b)) if bind else f
        slot = "reduce_scatter_block" if verb == "reduce_scatter" else verb
        donate = None
        if frozen is not None:
            _persist.plans += 1
            dispatch = (lambda a, _f=frozen, _v=slot:  # noqa: E731
                        self._hot(_v, _f, a))
            if _persist._donate_var._value:
                donate = (lambda a, _f=frozen, _v=slot:  # noqa: E731
                          self._hot(_v, _donated, _f, a))
        else:
            dispatch = lambda a: fn(a, *args)  # noqa: E731
        return MeshPersistentRequest(self, dispatch, x, verb=slot,
                                     frozen=frozen is not None,
                                     donate=donate)

    @staticmethod
    def _op_key(op: _op.Op, key):
        """The cache key to freeze for an op verb, or None: pair ops
        (MINLOC/MAXLOC) keep the per-Start verb, as in the reference."""
        return None if op.is_pair else key

    def allreduce_init(self, x, op: _op.Op = _op.SUM):
        # the key of the callable the allreduce slot runs: the quantized
        # one on a quant-selected comm, as the reference's fast table holds
        key = self.coll.get("allreduce").__self__.allreduce_key(op)
        return self._pcoll_init("allreduce", x, op,
                                key=self._op_key(op, key))

    def bcast_init(self, x, root: int = 0):
        return self._pcoll_init("bcast", x, root, key=cache_key("bcast"),
                                bind=(root,))

    def reduce_init(self, x, op: _op.Op = _op.SUM, root: int = 0):
        # the mesh reduce is the plain allreduce on every row: its callable
        return self._pcoll_init("reduce", x, op, root, key=self._op_key(
            op, cache_key("allreduce", op)))

    def allgather_init(self, x):
        return self._pcoll_init("allgather", x, key=cache_key("allgather"))

    def alltoall_init(self, x):
        return self._pcoll_init("alltoall", x, key=cache_key("alltoall"))

    def reduce_scatter_init(self, x, op: _op.Op = _op.SUM):
        return self._pcoll_init("reduce_scatter", x, op, key=self._op_key(
            op, cache_key("reduce_scatter_block", op)))

    def scan_init(self, x, op: _op.Op = _op.SUM):
        return self._pcoll_init("scan", x, op, key=self._op_key(
            op, cache_key("scan", op, (False,))))

    def exscan_init(self, x, op: _op.Op = _op.SUM):
        return self._pcoll_init("exscan", x, op, key=self._op_key(
            op, cache_key("scan", op, (True,))))

    Allreduce_init = allreduce_init
    Bcast_init = bcast_init
    Reduce_init = reduce_init
    Allgather_init = allgather_init
    Alltoall_init = alltoall_init
    Reduce_scatter_init = reduce_scatter_init
    Reduce_scatter_block_init = reduce_scatter_init  # ProcComm's spelling
    Scan_init = scan_init
    Exscan_init = exscan_init

    # ---------------------------------------- partitioned pt2pt (MPI-4)
    def Psend_init(self, x, perm: Sequence[Tuple[int, int]],
                   partitions: int) -> MeshPartitionedRequest:
        """Partitioned transfer of a ``[W, K, ...]`` buffer: K split into
        ``partitions`` segments, each permuted when it is made ready
        (reference: part.h:163; see ``parallel/partitioned.py``)."""
        return MeshPartitionedRequest(self, x, perm, partitions)

    # the controller holds both ends: one request serves the pair
    Precv_init = Psend_init

    # ------------------------------------------------------------- pt2pt
    def permute(self, x, perm: Sequence[Tuple[int, int]]):
        """Tag-free point-to-point: move rows along (src, dst) pairs of comm
        (group-local) ranks, in every group at once."""
        if self.groups is None:
            global_perm = tuple((int(s), int(d)) for s, d in perm)
        else:
            # singleton padding groups have no in-group peers to permute
            global_perm = tuple(
                (g[int(s)], g[int(d)])
                for g in self.groups
                if len(g) > 1
                for s, d in perm
            )
        self._check_usable()
        # permute is no coll slot: the mesh module's own (reference:
        # ``parallel/mesh.py:550-589``, counted and spanned the same way)
        spc.record("permute")
        fn = _mesh.module.permute
        if _tracing._value:
            fn = _tr.wrap_span("comm.permute", "comm", fn)
        return fn(self, x, global_perm)

    def shift(self, x, steps: int = 1):
        """Ring shift by ``steps`` within each group (MPI_Sendrecv around a
        ring)."""
        n = self.size
        perm = tuple((i, (i + steps) % n) for i in range(n))
        return self.permute(x, perm)

    # ---------------------------------------------------------- resharding
    def reshard(self, x, src_spec, dst_spec):
        """Redistribute the ``[W, *local]`` buffer between layouts by one
        verb: allgather, alltoall or local slicing (``reshard/exec.py``
        ``mesh_reshard``). Each call derives the lowering anew."""
        return mesh_reshard(self, x, src_spec, dst_spec)

    # ------------------------------------------------------------ topology
    # Cart coordinates are a row-major reshape of the rank dim; shifts are
    # permutations of its rows, periodic dims wrap around.
    def Create_cart(self, dims, periods=None, reorder=False) -> "MeshComm":
        from ompi_tpu_torch.topo import CartTopo

        topo = CartTopo(dims, periods if periods is not None
                        else [False] * len(dims))
        if self.groups is not None:
            raise MPIError(ERR_UNSUPPORTED_OPERATION,
                           "create the cart from the whole-axis comm")
        if topo.size != self.world_size:
            raise MPIError(
                ERR_ARG,
                f"mesh cart must cover the whole axis: prod(dims)="
                f"{topo.size} != {self.world_size} positions")
        new = MeshComm(self.world_size, self.device, self.axis, None,
                       name=f"{self.name}-cart")
        new.topo = topo
        from ompi_tpu_torch.topo import _reselect_coll

        _reselect_coll(new)
        return new

    def Get_topo(self):
        """(dims, periods, None): the controller holds every rank, so there is
        no calling-process coords entry."""
        t = self._cart()
        return t.dims, t.periods, None

    def Get_coords(self, rank: int):
        return self._cart().coords(rank)

    def cart_shift(self, x, direction: int, disp: int = 1):
        """Data-level MPI_Cart_shift: every row moves ``disp`` steps along
        ``direction``; rows shifted in from non-periodic edges are zero."""
        if self.groups is not None:
            raise MPIError(ERR_UNSUPPORTED_OPERATION,
                           "cart topologies cover the whole mesh axis")
        t = self._cart()
        pairs = []
        for r in range(self.world_size):
            _, dst = t.shift(r, direction, disp)
            if dst >= 0:
                pairs.append((r, dst))
        return self.permute(x, tuple(pairs))

    def Sub(self, remain_dims) -> "MeshComm":
        """MPI_Cart_sub: one Split materializing every sub-cart colour."""
        from ompi_tpu_torch.topo import attach_sub_cart

        t = self._cart()
        colors, keys = t.sub_colors(remain_dims)
        sub = self.Split(colors, keys)
        attach_sub_cart(sub, t, remain_dims)
        return sub

    def neighbor_allgather(self, x):
        """[W, ...] -> [W, K, ...]: slot k holds the k-th cart neighbour's
        row (zeros off non-periodic edges)."""
        return self._slot("neighbor_allgather")(self, x)

    def neighbor_alltoall(self, x):
        """[W, K, ...] -> [W, K, ...]: block k goes to neighbour k."""
        return self._slot("neighbor_alltoall")(self, x)

    Neighbor_allgather = neighbor_allgather
    Neighbor_alltoall = neighbor_alltoall

    # ------------------------------------------------------ comm management
    def Dup(self) -> "MeshComm":
        new = MeshComm(self.world_size, self.device, self.axis, self.groups,
                       name=f"{self.name}-dup")
        self._copy_attrs_to(new)
        return new

    def Split(self, colors: Sequence[int],
              keys: Optional[Sequence[int]] = None) -> "MeshComm":
        """MPI_Comm_split, controller-level: ``colors[i]`` / ``keys[i]`` are
        rank i's arguments; all colours are materialized at once as the
        groups partition of the returned comm."""
        if len(colors) != self.world_size:
            raise MPIError(ERR_ARG, "need one color per mesh position")
        keys = list(keys) if keys is not None else [0] * self.world_size
        by_color = {}
        for r, (c, k) in enumerate(zip(colors, keys)):
            by_color.setdefault(c, []).append((k, r))
        groups: List[Tuple[int, ...]] = []
        for c, members in sorted(by_color.items(),
                                 key=lambda kv: (kv[0] == UNDEFINED, kv[0])):
            members.sort()
            if c == UNDEFINED:
                groups.extend((r,) for _, r in members)  # singleton padding
            else:
                groups.append(tuple(r for _, r in members))
        return MeshComm(self.world_size, self.device, self.axis,
                        tuple(groups), name=f"{self.name}-split")

    def Create_group(self, ranks: Sequence[int]) -> "MeshComm":
        """Sub-communicator of a rank subset; non-members are padded as
        singleton groups and keep their own data."""
        member = set(int(r) for r in ranks)
        groups = [tuple(int(r) for r in ranks)]
        groups.extend((r,) for r in range(self.world_size) if r not in member)
        return MeshComm(self.world_size, self.device, self.axis,
                        tuple(groups), name=f"{self.name}-sub")

    def Free(self) -> None:
        self._delete_all_attrs()
        self._freed = True
        self._cache.clear()
        self.coll = None


def _donated(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn(x)``, written into ``x``'s storage where it has ``x``'s shape
    and dtype; else ``fn(x)`` as it is, ``x`` untouched. XLA likewise reuses
    a donated buffer only for an output of its shape and dtype."""
    out = fn(x)
    if out.shape == x.shape and out.dtype == x.dtype:
        return x.copy_(out)
    return out


def mesh_world(world_size: int = 8, device: DeviceLike = None,
               axis_name: str = "mpi_world") -> MeshComm:
    """The mesh-mode MPI_COMM_WORLD of ``world_size`` ranks, on ``cuda``
    unless ``device`` names another; raises where CUDA is absent. (The JAX
    package takes the size from its devices; here one card holds every
    rank, so the size is an argument.)"""
    return MeshComm(world_size, resolve_device(device), axis_name,
                    name="MESH_COMM_WORLD")
