"""MPI process groups — pure set/ordering math.

The port's copy of ``ompi_tpu/core/group.py`` (reference: ompi/group). A
group is an ordered tuple of *world ranks*; communicators are built from
groups. All the MPI group operations (union/intersection/difference/incl/
excl/range) are implemented directly on the tuples.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

from ompi_tpu_torch.core.errors import MPIError, ERR_RANK, ERR_GROUP

# Comparison results (reference: mpi.h.in MPI_IDENT/SIMILAR/UNEQUAL)
IDENT = 0
SIMILAR = 1
UNEQUAL = 2


class Group:
    def __init__(self, world_ranks: Sequence[int]):
        self.ranks: Tuple[int, ...] = tuple(int(r) for r in world_ranks)
        if len(set(self.ranks)) != len(self.ranks):
            raise MPIError(ERR_GROUP, "duplicate ranks in group")

    @property
    def size(self) -> int:
        return len(self.ranks)

    def Get_size(self) -> int:
        return self.size

    def rank_of(self, world_rank: int) -> int:
        """Group rank of a world rank, or -1 (MPI_UNDEFINED analog)."""
        try:
            return self.ranks.index(world_rank)
        except ValueError:
            return -1

    def world_rank(self, group_rank: int) -> int:
        if not 0 <= group_rank < self.size:
            raise MPIError(ERR_RANK, f"group rank {group_rank} out of range")
        return self.ranks[group_rank]

    # ------------------------------------------------------------- set ops
    def Union(self, other: "Group") -> "Group":
        extra = [r for r in other.ranks if r not in set(self.ranks)]
        return Group(self.ranks + tuple(extra))

    def Intersection(self, other: "Group") -> "Group":
        o = set(other.ranks)
        return Group([r for r in self.ranks if r in o])

    def Difference(self, other: "Group") -> "Group":
        o = set(other.ranks)
        return Group([r for r in self.ranks if r not in o])

    def Incl(self, ranks: Sequence[int]) -> "Group":
        return Group([self.world_rank(r) for r in ranks])

    def Excl(self, ranks: Sequence[int]) -> "Group":
        banned = set(ranks)
        return Group(
            [wr for i, wr in enumerate(self.ranks) if i not in banned]
        )

    @staticmethod
    def _expand_ranges(ranges: Sequence[Tuple[int, int, int]]) -> List[int]:
        out: List[int] = []
        for first, last, stride in ranges:
            if stride == 0:
                raise MPIError(ERR_RANK, "zero stride in range")
            r = first
            if stride > 0:
                while r <= last:
                    out.append(r)
                    r += stride
            else:
                while r >= last:
                    out.append(r)
                    r += stride
        return out

    def Range_incl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        return self.Incl(self._expand_ranges(ranges))

    def Range_excl(self, ranges: Sequence[Tuple[int, int, int]]) -> "Group":
        return self.Excl(self._expand_ranges(ranges))

    def Translate_ranks(
        self, ranks: Sequence[int], other: "Group"
    ) -> List[int]:
        return [other.rank_of(self.world_rank(r)) for r in ranks]

    def Compare(self, other: "Group") -> int:
        if self.ranks == other.ranks:
            return IDENT
        if set(self.ranks) == set(other.ranks):
            return SIMILAR
        return UNEQUAL

    def __eq__(self, other) -> bool:
        return isinstance(other, Group) and self.ranks == other.ranks

    def __hash__(self) -> int:
        return hash(self.ranks)

    def __repr__(self) -> str:
        return f"Group{self.ranks}"
