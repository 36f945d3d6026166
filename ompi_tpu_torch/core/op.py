"""MPI reduction operations on tensors.

The port of ``ompi_tpu/core/op.py:28-158``. Every op carries

- ``combine(a, b)``: the elementwise device combine, a torch function in
  place of the JAX package's ``jnp`` table, used by the sequential folds
  and the grouped schedules of ``coll/mesh.py``;
- ``kind``: how ``coll/mesh.py`` reduces it over the world comm's rank dim:
  'sum' / 'max' / 'min' as one reduction over dim 0, 'gather' (prod,
  logical/bitwise, loc pairs, user ops) as a fold of the rows in rank order.

LAND and LOR are 'min' and 'max' over truthiness (``logical``): MPI_LAND on
integers is not a numeric min.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ompi_tpu_torch.core.errors import MPIError, ERR_OP

_op_counter = [0]

# ops whose device operands are (value, index) pair tensors ([..., 2])
PAIR_OPS = ("MPI_MINLOC", "MPI_MAXLOC")


def _minloc(a, b):
    """(value, index) pairs in the last dim; ties take the lower index."""
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av < bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


def _maxloc(a, b):
    av, ai = a[..., 0], a[..., 1]
    bv, bi = b[..., 0], b[..., 1]
    take_a = (av > bv) | ((av == bv) & (ai <= bi))
    return torch.stack([torch.where(take_a, av, bv),
                        torch.where(take_a, ai, bi)], dim=-1)


_TORCH_EQUIV = {
    "MPI_MINLOC": _minloc,
    "MPI_MAXLOC": _maxloc,
    "MPI_SUM": torch.add,
    "MPI_PROD": torch.mul,
    "MPI_MAX": torch.maximum,
    "MPI_MIN": torch.minimum,
    "MPI_LAND": torch.logical_and,
    "MPI_LOR": torch.logical_or,
    "MPI_LXOR": torch.logical_xor,
    "MPI_BAND": torch.bitwise_and,
    "MPI_BOR": torch.bitwise_or,
    "MPI_BXOR": torch.bitwise_xor,
    "MPI_REPLACE": lambda a, b: b,
    "MPI_NO_OP": lambda a, b: a,
}


class Op:
    def __init__(self, name: str, kind: str = "gather",
                 combine: Optional[Callable] = None,
                 commutative: bool = True, logical: bool = False):
        self.name = name
        self.kind = kind  # 'sum' | 'max' | 'min' | 'gather'
        self._combine = combine if combine is not None \
            else _TORCH_EQUIV.get(name)
        self.commutative = commutative
        # logical ops reduce truthiness: operands become {0, 1} first
        self.logical = logical
        # unique id: the communicators' caches key on it, so two distinct
        # user ops never share an entry, even with the same name
        _op_counter[0] += 1
        self.uid = _op_counter[0]
        self.is_pair = name in PAIR_OPS

    def combine(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """Elementwise a (op) b."""
        if self._combine is None:
            raise MPIError(ERR_OP, f"op {self.name} has no device combine")
        return self._combine(a, b)

    @staticmethod
    def Create(fn: Callable, commute: bool = True, name: str = "user") -> "Op":
        """User-defined op (MPI_Op_create): ``fn(a, b)`` elementwise on
        tensors."""
        return Op(name, "gather", fn, commutative=commute)

    def __repr__(self) -> str:
        return f"Op({self.name})"


SUM = Op("MPI_SUM", "sum")
PROD = Op("MPI_PROD")
MAX = Op("MPI_MAX", "max")
MIN = Op("MPI_MIN", "min")
LAND = Op("MPI_LAND", "min", logical=True)
LOR = Op("MPI_LOR", "max", logical=True)
LXOR = Op("MPI_LXOR", logical=True)
BAND = Op("MPI_BAND")
BOR = Op("MPI_BOR")
BXOR = Op("MPI_BXOR")
MINLOC = Op("MPI_MINLOC")
MAXLOC = Op("MPI_MAXLOC")
REPLACE = Op("MPI_REPLACE", commutative=False)
NO_OP = Op("MPI_NO_OP", commutative=False)
