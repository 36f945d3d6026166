"""Cartesian process topologies.

The port of the part of ``ompi_tpu/topo/__init__.py`` that the mesh-mode
communicator uses (reference: ompi/mca/topo base cart math,
topo_base_cart_*.c, and MPI_Dims_create): ``Dims_create``, ``CartTopo``
and ``attach_sub_cart``. Cart coordinates are a row-major reshape of the
rank dim; a cart shift is a permutation of its rows, periodic dims wrap
around. Graph topologies are not ported.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ompi_tpu_torch.comm.communicator import PROC_NULL
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG

# MPI topology type constant (reference: mpi.h MPI_CART)
CART = 1


def Dims_create(nnodes: int, ndims: int,
                dims: Optional[Sequence[int]] = None) -> List[int]:
    """MPI_Dims_create: balanced factorization of nnodes over ndims,
    honoring pre-set (nonzero) entries, result non-increasing
    (reference: ompi/mpi/c/dims_create.c.in's assignnodes/factor)."""
    out = list(dims) if dims is not None else [0] * ndims
    if len(out) != ndims:
        raise MPIError(ERR_ARG, "dims length != ndims")
    fixed = 1
    free_idx = [i for i, d in enumerate(out) if d == 0]
    for d in out:
        if d < 0:
            raise MPIError(ERR_ARG, f"negative dim {d}")
        fixed *= d or 1
    if not free_idx:
        if fixed != nnodes:
            raise MPIError(ERR_ARG, f"dims product {fixed} != {nnodes}")
        return out
    rem, r = divmod(nnodes, fixed)
    if r:
        raise MPIError(ERR_ARG,
                       f"{nnodes} not divisible by fixed dims {fixed}")
    # prime-factorize rem, then greedily multiply onto the smallest bucket
    factors = []
    n, p = rem, 2
    while p * p <= n:
        while n % p == 0:
            factors.append(p)
            n //= p
        p += 1
    if n > 1:
        factors.append(n)
    buckets = [1] * len(free_idx)
    for f in sorted(factors, reverse=True):
        buckets[buckets.index(min(buckets))] *= f
    buckets.sort(reverse=True)
    for i, b in zip(free_idx, buckets):
        out[i] = b
    return out


class CartTopo:
    """Cartesian topology descriptor attached to a communicator
    (reference: mca_topo_base_comm_cart_2_2_0_t)."""

    kind = CART

    def __init__(self, dims: Sequence[int], periods: Sequence[bool]):
        self.dims = [int(d) for d in dims]
        self.periods = [bool(p) for p in periods]
        if len(self.dims) != len(self.periods):
            raise MPIError(ERR_ARG, "dims/periods length mismatch")
        if any(d <= 0 for d in self.dims):
            raise MPIError(ERR_ARG, f"bad dims {self.dims}")
        self.ndims = len(self.dims)
        self.size = int(np.prod(self.dims)) if self.dims else 1

    # ------------------------------------------------------ coordinate math
    def rank(self, coords: Sequence[int]) -> int:
        """Row-major coords -> rank, wrapping periodic dims (reference:
        topo_base_cart_rank.c)."""
        r = 0
        for d, (c, n, per) in enumerate(zip(coords, self.dims,
                                            self.periods)):
            c = int(c)
            if per:
                c %= n
            elif not 0 <= c < n:
                raise MPIError(ERR_ARG,
                               f"coord {c} out of range for dim {d}")
            r = r * n + c
        return r

    def coords(self, rank: int) -> List[int]:
        """rank -> row-major coords (reference: topo_base_cart_coords.c)."""
        if not 0 <= rank < self.size:
            raise MPIError(ERR_ARG, f"rank {rank} out of cart range")
        out = []
        for n in reversed(self.dims):
            out.append(rank % n)
            rank //= n
        return out[::-1]

    def shift(self, rank: int, direction: int, disp: int) -> Tuple[int, int]:
        """(source, dest) for a shift along `direction` by `disp`
        (reference: topo_base_cart_shift.c); PROC_NULL off non-periodic
        edges."""
        c = self.coords(rank)

        def move(sign: int) -> int:
            cc = list(c)
            cc[direction] += sign * disp
            n = self.dims[direction]
            if self.periods[direction]:
                cc[direction] %= n
            elif not 0 <= cc[direction] < n:
                return PROC_NULL
            return self.rank(cc)

        return move(-1), move(+1)

    def neighbors(self, rank: int) -> List[int]:
        """Neighbor order for cart neighborhood collectives: for each
        dimension, (negative-displacement peer, positive peer) —
        reference: the ordering mandated by MPI-3 §7.6 and implemented in
        mca_topo_base_neighbor_count."""
        out = []
        for d in range(self.ndims):
            src, dst = self.shift(rank, d, 1)
            out.extend((src, dst))
        return out

    def sub_colors(self, remain: Sequence[bool]) -> Tuple[List[int], List[int]]:
        """(colors, keys) for Cart_sub: color = coords over dropped dims,
        key = linear rank over kept dims (reference: topo_base_cart_sub.c)."""
        if len(remain) != self.ndims:
            raise MPIError(ERR_ARG,
                           f"remain_dims has {len(remain)} entries for a "
                           f"{self.ndims}-dim cart")
        colors, keys = [], []
        for r in range(self.size):
            c = self.coords(r)
            color = key = 0
            for d in range(self.ndims):
                if remain[d]:
                    key = key * self.dims[d] + c[d]
                else:
                    color = color * self.dims[d] + c[d]
            colors.append(color)
            keys.append(key)
        return colors, keys


def attach_sub_cart(sub, topo: CartTopo, remain) -> None:
    """Attach the kept-dims cart to a Cart_sub result."""
    remain = [bool(r) for r in remain]
    if len(remain) != topo.ndims:
        raise MPIError(ERR_ARG,
                       f"remain_dims has {len(remain)} entries for a "
                       f"{topo.ndims}-dim cart")
    kept = [d for d, keep in zip(topo.dims, remain) if keep]
    kept_p = [p for p, keep in zip(topo.periods, remain) if keep]
    sub.topo = CartTopo(kept or [1], kept_p or [False])
    _reselect_coll(sub)


def _reselect_coll(comm) -> None:
    """The topology is attached after construction: select the comm's
    collectives again so that a topology-aware component can claim its
    slots (reference: ``ompi_tpu/topo/__init__.py:273-280``)."""
    from ompi_tpu_torch.coll.base import select_coll

    comm.coll = select_coll(comm)
