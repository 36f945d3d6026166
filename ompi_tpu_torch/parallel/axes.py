"""In-mesh collective verbs: the port of ompi_tpu/parallel/axes.py on
``torch.distributed``.

The model calls these verbs by axis name where the JAX package calls them
inside ``shard_map``, so its code keeps the same shape. The axes are those
of a (dp, sp, tp) mesh of processes: global rank ``r`` sits at
``r = (d * sp + s) * tp + t``, the device order of the JAX
``Mesh(devices.reshape(dp, sp, tp))``. ``init_mesh`` builds one process
group per axis and one for the axis tuple ``("dp", "sp")``, every rank
creating every group in the same order, and makes the mesh current. Without
a current mesh every axis has size 1, every rank is 0 and every verb is the
identity, so a single-card run needs no ``torch.distributed`` at all.

An axis tuple names the product of its axes, indexed row-major in the order
given; it must list its axes in mesh order.

Gradients follow JAX's AD under ``shard_map`` (``torch.autograd.Function``
where JAX differentiates the verb):

- ``allreduce`` sum and mean: the backward is the identity (JAX's ``psum``
  transposes to ``pvary``: the result is replicated, so each rank's
  cotangent already is the whole of it); max and min have no gradient;
- ``copy_to``: identity forward, sum over the axis backward (the
  tensor-parallel "f" operator, which JAX's AD inserts by itself);
- ``allgather`` and ``reduce_scatter`` are each other's backward;
  ``alltoall``'s backward swaps its split and concat dims; ``permute`` and
  ``shift`` send the cotangent back along the inverse permutation;
  ``bcast``'s backward is the sum over the axis, delivered to the root.

Transport: the world's own backend, which its launcher chooses once from
the ranks' devices (``transport``; ``parallel.launch`` compares every
rank's device UUID): gloo for CPU tensors, nccl where every rank has a card
of its own, and gloo where ranks share a card. NCCL takes no two ranks on
one device, and gloo carries no point-to-point verb on CUDA tensors, so in
that last case every verb copies its CUDA tensor to the host, runs there
and copies the result back (``_to_wire``), which also synchronises the
stream.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import math
from typing import Dict, Iterator, Optional, Sequence, Tuple, Union

import torch
import torch.distributed as dist

from ompi_tpu_torch.device import resolve_device

AxisName = Union[str, Tuple[str, ...]]
AXES = ("dp", "sp", "tp")
# the axis tuples that get a process group besides the single axes
TUPLES = (("dp", "sp"),)
_OPS = ("sum", "max", "min", "mean")


def transport(device_type: str, device_ids: Sequence[str]) -> str:
    """The backend of a world whose ranks hold their tensors on
    ``device_type`` ("cpu" or "cuda"), rank r on the device named
    ``device_ids[r]`` (a card's UUID): gloo on the CPU, nccl where no two
    ranks share a card, gloo (staged through host memory) where some do."""
    if device_type == "cpu":
        return "gloo"
    return "nccl" if len(set(device_ids)) == len(device_ids) else "gloo"


@dataclasses.dataclass
class Mesh:
    """A (dp, sp, tp) mesh over the current ``torch.distributed`` world."""

    shape: Dict[str, int]
    coords: Dict[str, int]
    device: torch.device
    backend: str
    # groups by axis tuple; absent for a tuple of size 1
    groups: Dict[Tuple[str, ...], dist.ProcessGroup]

    @property
    def staged(self) -> bool:
        """Whether CUDA tensors cross the wire through host memory."""
        return self.device.type == "cuda" and self.backend == "gloo"


_MESH: Optional[Mesh] = None


def init_mesh(dp: int, sp: int, tp: int,
              device: Union[str, torch.device, None] = None) -> Mesh:
    """Build the (dp, sp, tp) mesh over the initialised world and make it
    current. Every rank must call it with the same arguments. ``device`` is
    where this rank's tensors live: ``cuda`` unless the caller names another,
    and an error where CUDA is absent (``device.resolve_device``); every
    group takes the world's backend."""
    global _MESH
    world = dist.get_world_size()
    if dp * sp * tp != world:
        raise ValueError(f"mesh {dp}x{sp}x{tp} does not cover a world of "
                         f"{world} ranks")
    device = resolve_device(device)
    backend = dist.get_backend()
    shape = dict(zip(AXES, (dp, sp, tp)))
    r = dist.get_rank()
    coords = {"dp": r // (sp * tp), "sp": r // tp % sp, "tp": r % tp}
    groups = {}
    for axes in [(a,) for a in AXES] + list(TUPLES):
        if math.prod(shape[a] for a in axes) == 1:
            continue
        rest = [a for a in AXES if a not in axes]
        for fixed in itertools.product(*(range(shape[a]) for a in rest)):
            at = dict(zip(rest, fixed))
            members = sorted(_global_rank({**at, **dict(zip(axes, c))}, shape)
                             for c in itertools.product(
                                 *(range(shape[a]) for a in axes)))
            group = dist.new_group(members, backend=backend)
            if r in members:
                groups[axes] = group
    _MESH = Mesh(shape, coords, device, backend, groups)
    return _MESH


def _global_rank(coords: Dict[str, int], shape: Dict[str, int]) -> int:
    return (coords["dp"] * shape["sp"] + coords["sp"]) * shape["tp"] \
        + coords["tp"]


def current_mesh() -> Optional[Mesh]:
    return _MESH


@contextlib.contextmanager
def use_mesh(mesh: Optional[Mesh]) -> Iterator[Optional[Mesh]]:
    """Make ``mesh`` current inside the block (``None``: every axis of size
    1, as on one card) and restore the one before after it."""
    global _MESH
    before, _MESH = _MESH, mesh
    try:
        yield mesh
    finally:
        _MESH = before


def _axes(axis: AxisName) -> Tuple[str, ...]:
    axes = (axis,) if isinstance(axis, str) else tuple(axis)
    if not axes or any(a not in AXES for a in axes):
        raise ValueError(f"unknown mesh axis {axis!r}; axes are {AXES}")
    if list(axes) != [a for a in AXES if a in axes]:
        raise ValueError(f"axis tuple {axis!r} must list its axes in mesh "
                         f"order {AXES}")
    return axes


def size(axis: AxisName) -> int:
    """MPI_Comm_size along an axis (1 without a mesh)."""
    axes = _axes(axis)
    return 1 if _MESH is None else math.prod(_MESH.shape[a] for a in axes)


def rank(axis: AxisName) -> int:
    """MPI_Comm_rank along an axis: row-major over the axes of a tuple (0
    without a mesh)."""
    idx = 0
    for a in _axes(axis):
        if _MESH is not None:
            idx = idx * _MESH.shape[a] + _MESH.coords[a]
    return idx


def _group(axis: AxisName) -> dist.ProcessGroup:
    axes = _axes(axis)
    try:
        return _MESH.groups[axes]
    except KeyError:
        raise ValueError(f"the mesh has no process group for {axis!r}; "
                         f"axis tuples with one: {TUPLES}") from None


# ---------------------------------------------------------------- the wire


def _to_wire(x: torch.Tensor) -> torch.Tensor:
    """A fresh contiguous copy of ``x`` that a collective may overwrite, in
    host memory where the mesh stages CUDA tensors."""
    if _MESH.staged and x.is_cuda:
        return x.detach().to("cpu", memory_format=torch.contiguous_format)
    return x.detach().clone(memory_format=torch.contiguous_format)


def _from_wire(y: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return y.to(like.device)


def _peer(group: dist.ProcessGroup, idx: int) -> int:
    """The global rank of index ``idx`` of ``group``."""
    return dist.get_global_rank(group, idx)


_REDUCE = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
           "min": dist.ReduceOp.MIN}


def _allreduce(x, axis, op="sum"):
    buf = _to_wire(x)
    dist.all_reduce(buf, op=_REDUCE[op], group=_group(axis))
    return _from_wire(buf, x)


def _allgather(x, axis, dim, tiled):
    buf = _to_wire(x)
    parts = [torch.empty_like(buf) for _ in range(size(axis))]
    dist.all_gather(parts, buf, group=_group(axis))
    out = torch.cat(parts, dim) if tiled else torch.stack(parts, dim)
    return _from_wire(out, x)


# reduce_scatter_single replaces reduce_scatter_tensor in newer releases
_REDUCE_SCATTER = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def _reduce_scatter(x, axis, dim, tiled):
    n = size(axis)
    if not tiled and x.shape[dim] != n:
        raise ValueError(f"untiled reduce_scatter needs dim {dim} of size "
                         f"{n}, got {tuple(x.shape)}")
    if x.shape[dim] % n:
        raise ValueError(f"reduce_scatter: dim {dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    buf = _to_wire(x.movedim(dim, 0))
    out = buf.new_empty((buf.shape[0] // n, *buf.shape[1:]))
    _REDUCE_SCATTER(out, buf, group=_group(axis))
    out = _from_wire(out, x).movedim(0, dim)
    return out if tiled else out.squeeze(dim)


def _alltoall(x, axis, split_dim, concat_dim):
    n = size(axis)
    if x.shape[split_dim] % n:
        raise ValueError(f"alltoall: dim {split_dim} of {tuple(x.shape)} "
                         f"does not split {n} ways")
    chunks = x.movedim(split_dim, 0)
    chunks = chunks.reshape(n, chunks.shape[0] // n, *chunks.shape[1:])
    buf = _to_wire(chunks)
    out = torch.empty_like(buf)
    dist.all_to_all_single(out, buf, group=_group(axis))
    out = _from_wire(out, x)
    return torch.cat([p.movedim(0, split_dim) for p in out.unbind(0)],
                     concat_dim)


def _bcast(x, axis, root):
    group = _group(axis)
    buf = _to_wire(x)
    dist.broadcast(buf, src=_peer(group, root), group=group)
    return _from_wire(buf, x)


def _permute(x, axis, perm):
    group, me = _group(axis), rank(axis)
    dst = [d for s, d in perm if s == me]
    src = [s for s, d in perm if d == me]
    buf = _to_wire(x)
    out = torch.zeros_like(buf)  # a rank nobody sends to receives zeros
    ops = []
    if dst and dst[0] == me:
        out.copy_(buf)
    elif dst:
        ops.append(dist.P2POp(dist.isend, buf, _peer(group, dst[0]), group))
    if src and src[0] != me:
        ops.append(dist.P2POp(dist.irecv, out, _peer(group, src[0]), group))
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return _from_wire(out, x)


# ------------------------------------------------------- autograd Functions


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _allreduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _NoGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, op):
        ctx.op = op
        return _allreduce(x, axis, op)

    @staticmethod
    def backward(ctx, g):
        raise RuntimeError(f"allreduce(op={ctx.op!r}) has no gradient, as "
                           f"lax.p{ctx.op} has none")


class _CopyTo(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _allreduce(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, tiled):
        ctx.args = (axis, dim, tiled)
        return _allgather(x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _reduce_scatter(g, *ctx.args), None, None, None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim, tiled):
        ctx.args = (axis, dim, tiled)
        return _reduce_scatter(x, axis, dim, tiled)

    @staticmethod
    def backward(ctx, g):
        return _allgather(g, *ctx.args), None, None, None


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, split_dim, concat_dim):
        ctx.args = (axis, concat_dim, split_dim)
        return _alltoall(x, axis, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        return _alltoall(g, *ctx.args), None, None, None


class _Bcast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, root):
        ctx.args = (axis, root)
        return _bcast(x, axis, root)

    @staticmethod
    def backward(ctx, g):
        axis, root = ctx.args
        total = _allreduce(g, axis)
        return (total if rank(axis) == root else torch.zeros_like(g)), \
            None, None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.args = (axis, tuple((d, s) for s, d in perm))
        return _permute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, *ctx.args), None, None


# ------------------------------------------------------------------ verbs


def allreduce(x: torch.Tensor, axis: AxisName, op: str = "sum"):
    """MPI_Allreduce over an axis. op: sum|max|min|mean."""
    if op not in _OPS:
        raise ValueError(f"unsupported in-mesh op {op!r}")
    n = size(axis)
    if n == 1:
        return x
    if op == "sum":
        return _AllReduceSum.apply(x, axis)
    if op == "mean":
        return _AllReduceSum.apply(x, axis) / n
    return _NoGrad.apply(x, axis, op)


def reduce_scatter(x: torch.Tensor, axis: AxisName, scatter_dim: int = 0,
                   tiled: bool = True):
    """MPI_Reduce_scatter_block (``psum_scatter``): the sum over the axis,
    of which this rank keeps its block of ``scatter_dim`` (tiled) or its
    index of it (untiled, the dim must have the axis's size)."""
    if size(axis) == 1:
        return x if tiled else x.squeeze(scatter_dim)
    return _ReduceScatter.apply(x, axis, scatter_dim, tiled)


def allgather(x: torch.Tensor, axis: AxisName, concat_dim: int = 0,
              tiled: bool = True):
    """MPI_Allgather (``all_gather``): every rank's ``x`` in axis order,
    concatenated along ``concat_dim`` (tiled) or stacked on a new dim
    there."""
    if size(axis) == 1:
        return x if tiled else x.unsqueeze(concat_dim)
    return _AllGather.apply(x, axis, concat_dim, tiled)


def alltoall(x: torch.Tensor, axis: AxisName, split_dim: int,
             concat_dim: int):
    """MPI_Alltoall (``all_to_all``, tiled): block j of ``split_dim`` goes
    to index j of the axis; the blocks received are concatenated along
    ``concat_dim`` in the senders' order."""
    if size(axis) == 1:
        return x
    return _AllToAll.apply(x, axis, split_dim, concat_dim)


def bcast(x: torch.Tensor, axis: AxisName, root: int = 0):
    """MPI_Bcast: every rank takes the value of index ``root``."""
    if size(axis) == 1:
        return x
    return _Bcast.apply(x, axis, root)


def permute(x: torch.Tensor, axis: AxisName,
            perm: Sequence[Tuple[int, int]]):
    """Tag-free point-to-point (``ppermute``): each (src, dst) pair sends
    src's ``x`` to dst; an index that no pair sends to gets zeros."""
    perm = [(int(s), int(d)) for s, d in perm]
    for side in (0, 1):
        ends = [p[side] for p in perm]
        if len(set(ends)) != len(ends):
            raise ValueError(f"permute: {perm} repeats a source or a "
                             f"destination")
    if size(axis) == 1:
        return x if (0, 0) in perm else torch.zeros_like(x)
    return _Permute.apply(x, axis, tuple(perm))


def shift(x: torch.Tensor, axis: AxisName, delta: int = 1):
    """Ring shift by +delta along the axis: index i sends to i + delta."""
    n = size(axis)
    return permute(x, axis, [(i, (i + delta) % n) for i in range(n)])


def copy_to(x: torch.Tensor, axis: AxisName):
    """Identity forward, allreduce backward: the tensor-parallel "f"
    operator, put before every product whose weight is split over ``axis``
    while its input is replicated there."""
    if size(axis) == 1:
        return x
    return _CopyTo.apply(x, axis)

