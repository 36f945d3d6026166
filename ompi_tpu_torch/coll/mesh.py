"""coll/mesh — the mesh-mode communicator's collectives as tensor ops over
its rank dim.

The port of ``ompi_tpu/coll/xla.py:57-690``. There each verb is one
``shard_map`` program of XLA collectives; here a distributed buffer is one
tensor ``[W, ...]`` on the comm's device, row ``r`` rank ``r``'s block, and
each verb resolves once per cache key to a callable of tensor ops over the
whole rank dim. Building it puts the index tensors of every permutation
round and the per-row masks on the device; a call is then the tensor ops
alone. Callables read dtype and shape at call time, so one entry serves
every payload, as one ``jit`` entry retraces in the JAX package.

How the XLA collectives map:

- ``lax.ppermute(x, perm)`` is ``_Perm``: row ``dst`` takes row ``src``,
  and a row that no pair targets gets zeros, as ``ppermute`` gives it.
- ``lax.axis_index``-based selections are masks over the rank dim.
- Rounds (log2 G, G - 1 or K of them) loop in Python; ranks never do.
- A world SUM/MAX/MIN is one reduction over dim 0. Every other verb and op
  keeps the reference's data flow, which decides the result: the 'gather'
  ops fold the rows in rank order, the grouped schedules combine in their
  round order, and bcast and scatter are a masked SUM in which the root's
  value meets the other members' +0 (so -0.0 arrives as +0.0).
- Results are real ``[W, ...]`` tensors, every row in its own storage.

Singleton groups (the padding of Create_group non-members and UNDEFINED
colours) are masked out of every schedule and keep their own data.
MINLOC/MAXLOC reduce ``[..., 2]`` (value, index) pair tensors.
"""

from __future__ import annotations

import math
import time
from typing import Optional, Sequence, Tuple

import torch

from ompi_tpu_torch.coll.base import CollModule, coll_framework
from ompi_tpu_torch.core import op as _op
from ompi_tpu_torch.core.errors import (MPIError, ERR_ARG,
                                        ERR_UNSUPPORTED_OPERATION)
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_pvar
from ompi_tpu_torch.runtime import trace as _trace


class _CacheStats:
    """Cache telemetry of ``MeshColl._cached``, the ``coll_mesh_*`` pvars:
    hits count resolved-callable reuse, misses the builds, and compile_ns
    the time of each build and its first call."""

    __slots__ = ("hits", "misses", "compile_ns")

    def __init__(self):
        self.hits = 0
        self.misses = 0
        self.compile_ns = 0


stats = _CacheStats()
# the trace gate, one attribute load of the live Var on every dispatch
_tracing = _trace._enable_var

register_pvar("coll_mesh", "cache_hits", lambda: stats.hits,
              help="Collective dispatches served by a cached callable")
register_pvar("coll_mesh", "cache_misses", lambda: stats.misses,
              help="Collective dispatches that had to build their callable")
register_pvar("coll_mesh", "compile_time_us",
              lambda: stats.compile_ns // 1000,
              help="Cumulative build and first-call time across cache "
                   "misses")


def _check_device_op(op: _op.Op, x=None) -> None:
    """MINLOC/MAXLOC reduce (value, index) pairs: a trailing dim of 2,
    ``x[..., 0]`` values and ``x[..., 1]`` indices."""
    if op.is_pair and (x is None or x.dim() < 1 or x.shape[-1] != 2):
        raise MPIError(
            ERR_UNSUPPORTED_OPERATION,
            f"device {op.name} reduces pair tensors: shape [..., 2] with "
            "(value, index) in the last dim")


def _check_blocks(x, n: int, verb: str, what: str) -> None:
    """The ``[world, n, ...]`` contract of the block verbs, held on every
    call."""
    if x.dim() < 2 or x.shape[1] != n:
        raise MPIError(ERR_ARG, f"{verb} expects [world, {what}={n}, ...], "
                                f"got {tuple(x.shape)}")


# --------------------------------------------------------------- schedules
def _shift_perm(groups, d: int) -> Tuple[Tuple[int, int], ...]:
    """Ring shift by +d within each (non-singleton) group."""
    out = []
    for g in groups:
        n = len(g)
        if n < 2:
            continue
        out.extend((g[i], g[(i + d) % n]) for i in range(n))
    return tuple(out)


def _xor_perm(groups, bit: int) -> Tuple[Tuple[int, int], ...]:
    """Recursive-doubling partner exchange within each group."""
    out = []
    for g in groups:
        if len(g) < 2:
            continue
        out.extend((g[i], g[i ^ bit]) for i in range(len(g)))
    return tuple(out)


def cache_key(verb: str, op: Optional[_op.Op] = None, extra: Tuple = ()):
    """Cache key layout: the verb, the op's uid, then what else the
    callable depends on."""
    key = (verb,)
    if op is not None:
        key += (op.uid,)
    return key + tuple(extra)


def _rows(m: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A per-row tensor ([W] or [W, G]) viewed to broadcast against x."""
    return m.view(tuple(m.shape) + (1,) * (x.dim() - m.dim()))


def _stack(r: torch.Tensor, n: int) -> torch.Tensor:
    """[n, *r.shape], each row a copy of r in its own storage."""
    out = r.new_empty((n,) + tuple(r.shape))
    out.copy_(r)
    return out


def _owned(t: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """t, copied where it is (a view of) the input x: REPLACE and NO_OP
    hand back an operand."""
    if t.untyped_storage().data_ptr() == x.untyped_storage().data_ptr():
        return t.clone()
    return t


def _mask(values, device) -> Optional[torch.Tensor]:
    """A bool mask on the device, or None where no entry is set."""
    t = torch.tensor(values, dtype=torch.bool)
    return t.to(device) if bool(t.any()) else None


def _zero_fill(out: torch.Tensor, hole: Optional[torch.Tensor]):
    if hole is not None:
        out.masked_fill_(_rows(hole, out), 0)
    return out


class _Perm:
    """``lax.ppermute`` over the rank dim: row ``d`` takes row ``s`` for
    every pair (s, d); a row that no pair targets gets zeros."""

    __slots__ = ("src", "hole")

    def __init__(self, pairs, world: int, device):
        src, hit = list(range(world)), [False] * world
        for s, d in pairs:
            src[d], hit[d] = s, True
        self.src = torch.tensor(src, dtype=torch.long, device=device)
        self.hole = _mask([not h for h in hit], device)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return _zero_fill(x.index_select(0, self.src), self.hole)


def _plus_zero(out: torch.Tensor, keep: Optional[torch.Tensor],
               keep_all: bool) -> torch.Tensor:
    """The masked SUM of bcast and scatter: the root's value plus the other
    members' +0, except on the rows of one-member groups, which keep their
    own value. Changes only -0.0 (to +0.0) and only in floats."""
    if keep_all or not (out.is_floating_point() or out.is_complex()):
        return out
    if keep is None:
        return out.add_(0)
    return torch.where(_rows(keep, out), out, out + 0)


def _as_int(b: torch.Tensor) -> torch.Tensor:
    """Bools ride the reductions as int32."""
    return b.to(torch.int32) if b.dtype == torch.bool else b


class _FirstCall:
    """A new cache entry until its first call has run: that call is timed
    into ``stats.compile_ns`` (with the build) under the
    ``coll.mesh.compile`` span, then the entry becomes the callable."""

    __slots__ = ("raw", "comm", "key", "built_ns")

    def __init__(self, raw, comm, key, built_ns: int):
        self.raw, self.comm, self.key = raw, comm, key
        self.built_ns = built_ns

    def __call__(self, *args):
        t0 = time.perf_counter_ns()
        if _tracing._value:
            with _trace.span("coll.mesh.compile", cat="coll",
                             verb=str(self.key[0])):
                out = self.raw(*args)
        else:
            out = self.raw(*args)
        stats.compile_ns += self.built_ns + time.perf_counter_ns() - t0
        self.comm._cache[self.key] = self.raw
        return out


class MeshColl(CollModule):
    """Collectives for ``MeshComm``; one callable per cache key, cached on
    the communicator."""

    # ------------------------------------------------------------ plumbing
    def _cached(self, comm, key, build):
        """The key's callable. A miss builds it and caches a one-shot
        ``_FirstCall`` that times its first call and then puts the callable
        itself in the cache, as the reference's ``first_call`` does
        (``coll/xla.py:139-171``)."""
        fn = comm._cache.get(key)
        if fn is None:
            stats.misses += 1
            t0 = time.perf_counter_ns()
            raw = build()
            fn = _FirstCall(raw, comm, key, time.perf_counter_ns() - t0)
            comm._cache[key] = fn
        elif fn.__class__ is not _FirstCall:
            # a wrapper still pending (its first call raised) is a retry of
            # the build, not a hit
            stats.hits += 1
        return fn

    def _dispatch(self, comm, key, build, *args):
        """Resolve (or build) the callable and run it, under the
        ``coll.mesh.dispatch`` span when tracing."""
        fn = self._cached(comm, key, build)
        if _tracing._value:
            with _trace.span("coll.mesh.dispatch", cat="coll",
                             verb=str(key[0])):
                return fn(*args)
        return fn(*args)

    @staticmethod
    def _groups(comm):
        """The comm's groups, the world as one group."""
        return comm.groups if comm.groups is not None \
            else (tuple(range(comm.world_size)),)

    @staticmethod
    def _masks(comm):
        """(pos_map long, singleton_mask bool) on the comm's device."""
        return (torch.tensor(comm.pos_map, dtype=torch.long,
                             device=comm.device),
                torch.tensor(comm.singleton_mask, device=comm.device))

    @staticmethod
    def _group_sizes(comm):
        """Per-row group size."""
        gs = [0] * comm.world_size
        for g in MeshColl._groups(comm):
            for r in g:
                gs[r] = len(g)
        return gs

    # ------------------------------------------- grouped allreduce schedule
    def _grouped_allreduce_body(self, comm, op: _op.Op):
        """body(block) -> block: in-group allreduce by permutation rounds.
        Uniform power-of-two colours take recursive doubling; everything
        else (non-uniform colour sizes included) a masked ring of max group
        size - 1 rounds, each row accumulating only for its own group's
        size - 1 rounds while values rotate on around the smaller rings."""
        groups, W, dev = comm.groups, comm.world_size, comm.device
        _, single = self._masks(comm)
        sizes = {len(g) for g in groups if len(g) > 1}
        max_g = max(sizes) if sizes else 1
        pow2 = len(sizes) <= 1 and max_g >= 2 and (max_g & (max_g - 1)) == 0
        if pow2:
            perms = [_Perm(_xor_perm(groups, 1 << k), W, dev)
                     for k in range(int(math.log2(max_g)))]
        else:
            ring = _Perm(_shift_perm(groups, 1), W, dev)
            gsize = self._group_sizes(comm)
            active = [torch.tensor([d < n - 1 for n in gsize], device=dev)
                      for d in range(max(max_g - 1, 0))]

        def body(b_in):
            b = (b_in != 0).to(torch.int32) if op.logical else b_in
            acc = b
            if pow2:
                # reference: coll_base_allreduce.c:134 recursive doubling
                for perm in perms:
                    acc = op.combine(acc, perm(acc))
            else:
                # reference: coll_base_allreduce.c:345 ring, with a per-row
                # round mask for non-uniform group sizes
                cur = b
                for mask in active:
                    cur = ring(cur)
                    acc = torch.where(_rows(mask, acc), op.combine(acc, cur),
                                      acc)
            out = torch.where(_rows(single, b), b, acc.to(b.dtype))
            return out.to(b_in.dtype)

        return body

    # ---------------------------------------------------------- collectives
    def _allreduce_body(self, comm, op: _op.Op):
        if comm.groups is not None:
            return self._grouped_allreduce_body(comm, op)
        kind = op.kind

        def body(b):
            # logical ops reduce truthiness, not values
            v = (b != 0).to(torch.int32) if op.logical else _as_int(b)
            if kind == "sum":
                r = v.sum(0, dtype=v.dtype)
            elif kind == "max":
                r = v.amax(0)
            elif kind == "min":
                r = v.amin(0)
            else:
                r = v[0]
                for i in range(1, v.shape[0]):
                    r = op.combine(r, v[i])
            return _stack(r.to(b.dtype), b.shape[0])

        return body

    @staticmethod
    def allreduce_key(op: _op.Op):
        """The cache key of ``allreduce``'s callable."""
        return cache_key("allreduce", op)

    def allreduce(self, comm, x, op: _op.Op = _op.SUM):
        def build():
            body = self._allreduce_body(comm, op)

            def fn(b):
                _check_device_op(op, b)
                return body(b)

            return fn

        return self._dispatch(comm, self.allreduce_key(op), build, x)

    def reduce(self, comm, x, op: _op.Op = _op.SUM, root: int = 0):
        """MPI defines only the root row; every group row gets the
        reduction (a legal strengthening, and the reference's). It is this
        module's allreduce, never the comm's slot: on a quant-selected comm
        reduce stays exact."""
        return self.allreduce(comm, x, op)

    def _rooted(self, comm):
        """Per root position r: (src [W], zero [W] or None). Row w of a
        group with a member at position r reads that member's row; the rows
        of a group without one get zeros; one-member groups read their own
        row. Also keep (the rows of one-member groups, or None) and
        keep_all."""
        W, dev = comm.world_size, comm.device
        groups = self._groups(comm)
        tables = []
        for r in range(max(len(g) for g in groups)):
            src, zero = list(range(W)), [False] * W
            for g in groups:
                if len(g) == 1:
                    continue
                for m in g:
                    if r < len(g):
                        src[m] = g[r]
                    else:
                        zero[m] = True
            tables.append((torch.tensor(src, dtype=torch.long, device=dev),
                           _mask(zero, dev)))
        keep = [n == 1 for n in self._group_sizes(comm)]
        return tables, _mask(keep, dev), all(keep)

    def bcast(self, comm, x, root: int = 0):
        def build():
            tables, keep, keep_all = self._rooted(comm)

            def fn(b, r):
                src, zero = tables[r]
                out = _as_int(b).index_select(0, src)
                out = _zero_fill(_plus_zero(out, keep, keep_all), zero)
                return out.to(b.dtype)

            return fn

        return self._dispatch(comm, cache_key("bcast"), build, x, root)

    def allgather(self, comm, x):
        """[W, ...] -> [W, G, ...]: each row becomes its group's stacked
        contributions. A singleton row holds its own row in slot 0 and
        zeros after it (the ring's ppermute gives it nothing)."""

        def build():
            W, G = comm.world_size, comm.size
            if comm.groups is None:
                return lambda b: _stack(b, W)
            src = [[w] * G for w in range(W)]
            hole = [[False] * G for _ in range(W)]
            for g in comm.groups:
                for m in g:
                    if len(g) == 1:
                        hole[m] = [j > 0 for j in range(G)]
                    else:
                        src[m] = list(g)
            src = torch.tensor(src, dtype=torch.long, device=comm.device)
            hole = _mask(hole, comm.device)
            return lambda b: _zero_fill(b[src], hole)

        return self._dispatch(comm, cache_key("allgather"), build, x)

    def alltoall(self, comm, x):
        """[W, G, ...] -> [W, G, ...]: chunk j of group rank i goes to chunk
        i of group rank j (MPI_Alltoall)."""

        def build():
            W, G = comm.world_size, comm.size
            if comm.groups is None:
                def fn(b):
                    _check_blocks(b, G, "alltoall", "group_size")
                    return b.transpose(0, 1).clone(
                        memory_format=torch.contiguous_format)

                return fn
            rows = [[w] * G for w in range(W)]
            cols = [[0] * G for _ in range(W)]
            hole = [[False] * G for _ in range(W)]
            for g in comm.groups:
                for p, m in enumerate(g):
                    if len(g) == 1:
                        hole[m] = [j > 0 for j in range(G)]
                    else:
                        rows[m], cols[m] = list(g), [p] * G
            rows, cols = (torch.tensor(t, dtype=torch.long,
                                       device=comm.device)
                          for t in (rows, cols))
            hole = _mask(hole, comm.device)

            def fn(b):
                _check_blocks(b, G, "alltoall", "group_size")
                return _zero_fill(b[rows, cols], hole)

            return fn

        return self._dispatch(comm, cache_key("alltoall"), build, x)

    def reduce_scatter_block(self, comm, x, op: _op.Op = _op.SUM):
        """[W, G, ...] -> [W, ...]: reduce across the group elementwise;
        group rank p keeps chunk p (MPI_Reduce_scatter_block)."""

        def build():
            G = comm.size
            if comm.groups is None and op.kind == "sum":
                def body(b):
                    return b.sum(0, dtype=b.dtype)
            elif comm.groups is None:
                def body(b):
                    acc = b[0]
                    for i in range(1, b.shape[0]):
                        acc = op.combine(acc, b[i])
                    return _owned(acc, b)
            else:
                red_body = self._grouped_allreduce_body(comm, op)
                pos, _ = self._masks(comm)
                ar = torch.arange(comm.world_size, device=comm.device)

                def body(b):
                    return red_body(b)[ar, pos]

            def fn(b):
                _check_blocks(b, G, "reduce_scatter", "group_size")
                _check_device_op(op, b)
                return body(b)

            return fn

        return self._dispatch(comm, cache_key("reduce_scatter_block", op),
                              build, x)

    def scan(self, comm, x, op: _op.Op = _op.SUM, exclusive: bool = False):
        """Prefix reduction across group ranks by Hillis-Steele doubling:
        log2 G masked shift rounds, each row combining (earlier, own)."""

        def build():
            W, dev = comm.world_size, comm.device
            groups = self._groups(comm)
            pos, single = self._masks(comm)
            # rounds sized by the largest group; the pos >= d mask is
            # group-local, so non-uniform colours idle early
            max_g = max(len(g) for g in groups)
            rounds = [(_Perm(_shift_perm(groups, 1 << k), W, dev),
                       pos >= (1 << k))
                      for k in range(int(math.ceil(math.log2(max_g))))]
            first, at_zero = _Perm(_shift_perm(groups, 1), W, dev), pos == 0

            def fn(b):
                _check_device_op(op, b)
                acc = b
                for perm, later in rounds:
                    acc = torch.where(_rows(later, acc),
                                      op.combine(perm(acc), acc), acc)
                if exclusive:
                    acc = torch.where(_rows(at_zero, b), torch.zeros_like(b),
                                      first(acc))
                return torch.where(_rows(single, b), b, acc).to(b.dtype)

            return fn

        return self._dispatch(comm, cache_key("scan", op, (exclusive,)),
                              build, x)

    def exscan(self, comm, x, op: _op.Op = _op.SUM):
        return self.scan(comm, x, op, exclusive=True)

    def barrier(self, comm) -> None:
        """Whole-comm sync: a tiny sum on the device, then wait for the
        device."""

        def build():
            ones = torch.ones((comm.world_size, 1), dtype=torch.int32,
                              device=comm.device)

            def fn():
                ones.sum(0)
                if ones.is_cuda:
                    torch.cuda.synchronize(ones.device)

            return fn

        self._dispatch(comm, cache_key("barrier"), build)

    # --------------------------------------------- layout ("root") movers
    def gather(self, comm, x, root: int = 0):
        """[W, ...] -> [W, G, ...]: the gather on every row, the same legal
        strengthening as reduce -> allreduce."""
        return self.allgather(comm, x)

    def scatter(self, comm, x, root: int = 0):
        """[W, G, ...] -> [W, ...]: group rank p receives ROOT's chunk p."""

        def build():
            G = comm.size
            tables, keep, keep_all = self._rooted(comm)
            pos, _ = self._masks(comm)

            def fn(b, r):
                _check_blocks(b, G, "scatter", "group_size")
                src, zero = tables[r]
                out = _as_int(b)[src, pos]
                out = _zero_fill(_plus_zero(out, keep, keep_all), zero)
                return out.to(b.dtype)

            return fn

        return self._dispatch(comm, cache_key("scatter"), build, x, root)

    # ---------------------------------------------- neighborhood collectives
    # Cart order: per dim, the negative then the positive neighbour; a
    # neighbour off a non-periodic edge delivers zeros (MPI_PROC_NULL).
    @staticmethod
    def _cart(comm):
        from ompi_tpu_torch.topo import CartTopo

        t = comm.topo
        if not isinstance(t, CartTopo) or comm.groups is not None:
            raise MPIError(
                ERR_UNSUPPORTED_OPERATION,
                "mesh neighbor collectives need a cartesian topology over "
                "the whole rank dim")
        return t

    def _cart_neighbors(self, comm):
        """(src [W, K], hole [W, K] or None): row w's k-th neighbour, and
        where it has none."""
        t = self._cart(comm)
        nbrs = [t.neighbors(me) for me in range(comm.world_size)]
        src = [[nb if nb >= 0 else me for nb in row]
               for me, row in enumerate(nbrs)]
        return (torch.tensor(src, dtype=torch.long, device=comm.device),
                _mask([[nb < 0 for nb in row] for row in nbrs], comm.device))

    def neighbor_allgather(self, comm, x):
        """[W, ...] -> [W, K, ...]: slot k holds the k-th neighbour's row."""
        self._cart(comm)

        def build():
            src, hole = self._cart_neighbors(comm)
            return lambda b: _zero_fill(b[src], hole)

        return self._dispatch(comm, cache_key("neighbor_allgather"), build, x)

    def neighbor_alltoall(self, comm, x):
        """[W, K, ...] -> [W, K, ...]: block k goes to neighbour k; block k
        arrives from neighbour k, which sent its opposite-direction block
        along the same edge."""
        self._cart(comm)

        def build():
            src, hole = self._cart_neighbors(comm)
            K = src.shape[1]
            opp = torch.tensor([2 * (k // 2) + 1 - k % 2 for k in range(K)],
                               dtype=torch.long, device=comm.device)

            def fn(b):
                _check_blocks(b, K, "neighbor_alltoall", "K")
                return _zero_fill(b[src, opp], hole)

            return fn

        return self._dispatch(comm, cache_key("neighbor_alltoall"), build, x)

    # ------------------------------------------------------------- pt2pt
    def permute(self, comm, x, perm: Sequence[Tuple[int, int]]):
        """Rows move along (src, dst) pairs of global positions; a row no
        pair targets gets zeros. Sources and destinations are each
        unique."""
        perm = tuple((int(s), int(d)) for s, d in perm)

        def build():
            W = comm.world_size
            srcs, dsts = [s for s, _ in perm], [d for _, d in perm]
            if (len(set(srcs)) != len(srcs) or len(set(dsts)) != len(dsts)
                    or not all(0 <= r < W for r in srcs + dsts)):
                raise MPIError(ERR_ARG, f"permute pairs {perm} need unique "
                                        f"sources and destinations in "
                                        f"[0, {W})")
            return _Perm(perm, W, comm.device)

        return self._dispatch(comm, cache_key("permute", extra=(perm,)),
                              build, x)


module = MeshColl()


class MeshCollComponent(Component):
    """The port of ``XlaCollComponent`` (``coll/xla.py:805-819``): the
    module of every ``MeshComm``."""

    NAME = "mesh"
    PRIORITY = 100

    def query(self, comm=None, **ctx):
        from ompi_tpu_torch.parallel.mesh import MeshComm

        return module if isinstance(comm, MeshComm) else None


coll_framework.register(MeshCollComponent())
