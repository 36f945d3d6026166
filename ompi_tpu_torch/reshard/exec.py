"""Reshard executor, mesh mode: move a distributed buffer between layouts
with one collective.

The port of the mesh lowering of ``ompi_tpu/reshard/exec.py:434-504``
(``_one_sharded_dim``, ``_merge_axes``, ``mesh_reshard``). A layout is a
spec with one entry per array dim, 0 where the dim is sharded over the rank
dim and None where it is not, at most one sharded dim. The plan compiler
and the process-mode lowerings of the JAX package are not ported: mesh
mode needs none of them.
"""

from __future__ import annotations

from typing import Optional

import torch

from ompi_tpu_torch.core.errors import (MPIError, ERR_ARG,
                                        ERR_UNSUPPORTED_OPERATION)


def _one_sharded_dim(spec) -> Optional[int]:
    dims = [d for d, s in enumerate(spec) if s is not None]
    if len(dims) > 1:
        raise MPIError(
            ERR_UNSUPPORTED_OPERATION,
            "mesh reshard supports one sharded dim per layout "
            f"(spec {tuple(spec)})")
    return dims[0] if dims else None


def _merge_axes(x: torch.Tensor, ax: int) -> torch.Tensor:
    """Merge the adjacent axes (ax, ax + 1) of ``x``."""
    shape = x.shape[:ax] + (x.shape[ax] * x.shape[ax + 1],) \
        + x.shape[ax + 2:]
    return x.reshape(shape)


def mesh_reshard(comm, x: torch.Tensor, src_spec, dst_spec) -> torch.Tensor:
    """``x`` is the mesh-mode distributed buffer ``[W, *local]``, row r
    rank r's shard of the global array under ``src_spec``. Returns the
    ``[W, *local']`` buffer under ``dst_spec``, by one verb: allgather
    (shard -> replicate), alltoall (the sharded dim moves to another array
    dim), or each row slicing its own block (replicate -> shard). The same
    spec on both sides returns ``x`` itself."""
    if getattr(comm, "groups", None) is not None:
        raise MPIError(ERR_UNSUPPORTED_OPERATION,
                       "mesh reshard runs on the whole-axis comm "
                       "(Split colors hold different layouts)")
    W = comm.size
    a = _one_sharded_dim(src_spec)
    b = _one_sharded_dim(dst_spec)
    if len(src_spec) != len(dst_spec):
        raise MPIError(ERR_ARG, "src/dst specs must have equal rank")
    if a == b:
        return x
    gshape = list(x.shape[1:])
    if a is not None:
        gshape[a] *= W
    for d in (a, b):
        if d is not None and gshape[d] % W != 0:
            raise MPIError(
                ERR_ARG,
                f"mesh reshard needs dim {d} ({gshape[d]}) divisible "
                f"by {W}")
    if a is None:
        # replicate -> shard: every row slices its own block (no comm)
        cb = gshape[b] // W
        z = x.reshape(x.shape[:b + 1] + (W, cb) + x.shape[b + 2:])
        z = torch.movedim(z, b + 1, 1)  # [W, W, ...]
        idx = torch.arange(W, device=x.device).reshape(
            (W, 1) + (1,) * (z.dim() - 2))
        return torch.take_along_dim(z, idx, dim=1)[:, 0]
    if b is None:
        # shard -> replicate: allgather, reassembled along a
        y = comm.allgather(x)               # [W, W, *local]
        y = torch.movedim(y, 1, a + 1)      # gathered index left of a-chunk
        return _merge_axes(y, a + 1)
    # shard dim a -> shard dim b: the resharding alltoall
    cb = gshape[b] // W
    z = x.reshape(x.shape[:b + 1] + (W, cb) + x.shape[b + 2:])
    z = torch.movedim(z, b + 1, 1)          # [W, W(block for dst), ...]
    r = comm.alltoall(z)                    # [W, W(from src), ...]
    # the a-chunk sits at axis a + 2; put the gather axis just left of it
    # and merge: global a index = src rank * chunk + offset
    r = torch.movedim(r, 1, a + 1)
    return _merge_axes(r, a + 1)
