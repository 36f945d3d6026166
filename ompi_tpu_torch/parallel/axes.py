"""In-mesh collective verbs: the port of ompi_tpu/parallel/axes.py, for a
mesh whose every axis has size 1.

The model calls these verbs by axis name where the JAX package calls them
inside ``shard_map``, so its code keeps the same shape. At size 1 each verb
is an identity and every rank is 0. Groups of ``torch.distributed`` for axes
of size > 1 come with the multi-rank slice of the port.
"""

from __future__ import annotations

from typing import Tuple, Union

import torch

AxisName = Union[str, Tuple[str, ...]]
_OPS = ("sum", "max", "min", "mean")


def rank(axis: AxisName) -> int:
    """MPI_Comm_rank along an axis of size 1."""
    return 0


def size(axis: AxisName) -> int:
    """MPI_Comm_size along an axis (always 1 in this slice)."""
    return 1


def allreduce(x: torch.Tensor, axis: AxisName, op: str = "sum") -> torch.Tensor:
    """MPI_Allreduce over an axis of size 1: the input itself."""
    if op not in _OPS:
        raise ValueError(f"unsupported in-mesh op {op!r}")
    return x
