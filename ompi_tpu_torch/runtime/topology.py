"""Host hardware topology and rank binding (the hwloc analog).

The port of ``ompi_tpu/runtime/topology.py`` (reference: opal/mca/hwloc and
prte's rank-binding policies). Discovery reads the Linux sysfs NUMA and cpu
inventory directly; the accelerator inventory is the CUDA devices torch
sees; binding partitions the ALLOWED cpuset (the affinity mask we
inherited, not the machine's raw core list) round-robin across ranks, the
--bind-to core policy the reference launcher applies.

Enable launcher-side binding with ``--mca topo_bind_ranks 1`` (the wireup
of process mode calls ``maybe_bind``).
"""

from __future__ import annotations

import dataclasses
import glob
import os
from typing import Dict, List, Optional

import torch

from ompi_tpu_torch.mca.var import register_var, get_var

register_var("topo", "bind_ranks", False,
             help="Bind each launched rank to its share of the allowed "
                  "cpuset (reference: prte --bind-to core)", level=4)


def accelerators() -> List[dict]:
    """The CUDA devices torch sees, each ``{id, kind, coords}``: ``kind`` is
    the device name and ``coords`` None (a card has no torus coordinates);
    ``[]`` without a card."""
    if not torch.cuda.is_available():
        return []
    return [{"id": i, "kind": torch.cuda.get_device_name(i), "coords": None}
            for i in range(torch.cuda.device_count())]


def _parse_cpulist(text: str) -> List[int]:
    """'0-3,8,10-11' -> [0,1,2,3,8,10,11] (sysfs cpulist format)."""
    cpus: List[int] = []
    for part in text.strip().split(","):
        if not part:
            continue
        if "-" in part:
            lo, hi = part.split("-")
            cpus.extend(range(int(lo), int(hi) + 1))
        else:
            cpus.append(int(part))
    return cpus


@dataclasses.dataclass
class NumaNode:
    id: int
    cpus: List[int]
    mem_kb: int


@dataclasses.dataclass
class HostTopology:
    allowed_cpus: List[int]          # our affinity mask (what we may use)
    numa: List[NumaNode]
    total_mem_kb: int

    @property
    def ncpus(self) -> int:
        return len(self.allowed_cpus)

    def numa_of_cpu(self, cpu: int) -> int:
        for node in self.numa:
            if cpu in node.cpus:
                return node.id
        return -1

    def accelerators(self) -> List[dict]:
        """The hwloc osdev analog: the host's CUDA devices
        (:func:`accelerators`)."""
        return accelerators()

    def summary(self) -> str:
        lines = [f"cpus(allowed): {self.ncpus}   "
                 f"mem: {self.total_mem_kb // 1024} MB   "
                 f"numa nodes: {len(self.numa)}"]
        for node in self.numa:
            allowed = sorted(set(node.cpus) & set(self.allowed_cpus))
            lines.append(f"  numa{node.id}: cpus={allowed} "
                         f"mem={node.mem_kb // 1024}MB")
        return "\n".join(lines)


def discover() -> HostTopology:
    """Read the sysfs inventory (reference: hwloc's linux backend)."""
    try:
        allowed = sorted(os.sched_getaffinity(0))
    except AttributeError:  # non-Linux
        allowed = list(range(os.cpu_count() or 1))
    numa: List[NumaNode] = []
    for path in sorted(glob.glob("/sys/devices/system/node/node[0-9]*")):
        nid = int(os.path.basename(path)[4:])
        try:
            cpus = _parse_cpulist(open(f"{path}/cpulist").read())
        except OSError:
            cpus = []
        mem_kb = 0
        try:
            for line in open(f"{path}/meminfo"):
                if "MemTotal" in line:
                    mem_kb = int(line.split()[-2])
                    break
        except OSError:
            pass
        numa.append(NumaNode(nid, cpus, mem_kb))
    total = 0
    try:
        for line in open("/proc/meminfo"):
            if line.startswith("MemTotal"):
                total = int(line.split()[1])
                break
    except OSError:
        pass
    if not numa:  # single implicit node
        numa = [NumaNode(0, allowed, total)]
    return HostTopology(allowed, numa, total)


def rank_cpuset(rank: int, size: int,
                topo: Optional[HostTopology] = None) -> List[int]:
    """The cpus rank ``rank`` of ``size`` should bind to: a contiguous
    slice of the allowed set, every rank nonempty (oversubscription
    wraps round-robin — the reference's overload-allowed mode)."""
    topo = topo or discover()
    cpus = topo.allowed_cpus
    if size <= 0 or not cpus:
        return cpus
    if size >= len(cpus):
        return [cpus[rank % len(cpus)]]
    per = len(cpus) // size
    extra = len(cpus) % size
    start = rank * per + min(rank, extra)
    return cpus[start: start + per + (1 if rank < extra else 0)]


def bind_rank(rank: int, size: int) -> List[int]:
    """Apply the binding (sched_setaffinity); returns the cpuset."""
    cpus = rank_cpuset(rank, size)
    try:
        os.sched_setaffinity(0, cpus)
    except (AttributeError, OSError):
        pass
    return cpus


def maybe_bind(rank: int, size: int) -> Optional[List[int]]:
    """Wireup hook: bind when topo_bind_ranks is set."""
    if not get_var("topo", "bind_ranks"):
        return None
    return bind_rank(rank, size)


# ---------------------------------------------------- collective domains
@dataclasses.dataclass(frozen=True)
class DomainMap:
    """Per-communicator locality hierarchy for the hierarchical
    collective composer (coll/hier): host (sm/CMA domain) within slice
    within world. Built from the modex node identity (the SAME cards on
    every member, so every rank derives the SAME map — per-rank
    heuristics would tear the composition) plus an optional slice
    grouping; ids are normalized to 0..k-1 in first-seen comm-rank order
    so leader/offset math is stable."""

    node_of: tuple          # node id per comm rank (normalized)
    slice_of_node: tuple    # slice id per node id (normalized)

    @property
    def n_nodes(self) -> int:
        return len(self.slice_of_node)

    @property
    def n_slices(self) -> int:
        return len(set(self.slice_of_node)) if self.slice_of_node else 0

    @property
    def biggest_node(self) -> int:
        counts: Dict[int, int] = {}
        for n in self.node_of:
            counts[n] = counts.get(n, 0) + 1
        return max(counts.values()) if counts else 0

    @property
    def nontrivial(self) -> bool:
        """The han decision rule: >=2 nodes AND >=2 ranks on some node —
        otherwise the per-domain split degenerates and flat wins."""
        return self.n_nodes >= 2 and self.biggest_node >= 2

    def slice_of_rank(self, rank: int) -> int:
        return self.slice_of_node[self.node_of[rank]]

    def members_of_node(self, node: int) -> List[int]:
        return [r for r, n in enumerate(self.node_of) if n == node]


def domain_map(raw_node_ids, fake_slices: int = 0) -> DomainMap:
    """Normalize raw per-rank node identities (modex card strings or
    fake round-robin ints) into a :class:`DomainMap`. ``fake_slices``
    groups nodes round-robin into that many slices (the single-host
    test hook for the three-level composition); 0/1 puts every node in
    one slice — the two-level degenerate case."""
    first: Dict = {}
    node_of = tuple(first.setdefault(sid, len(first))
                    for sid in raw_node_ids)
    n_nodes = len(first)
    k = int(fake_slices)
    if k > 1:
        slice_of_node = tuple(n % min(k, n_nodes) for n in range(n_nodes))
    else:
        slice_of_node = tuple(0 for _ in range(n_nodes))
    return DomainMap(node_of, slice_of_node)
