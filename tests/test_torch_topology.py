"""The port's host topology (``runtime/topology.py``) against the JAX
package's, on the CPU: every case of ``tests/test_topology.py`` that launches
no ranks, run on both packages from the same inputs, with equal outputs.

``test_mpisync_three_ranks`` launches ranks and waits for process mode.
"""

import os

import pytest

from ompi_tpu.runtime import topology as J
from ompi_tpu_torch.runtime import topology as T
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture


def _as_tuple(topo):
    return (topo.allowed_cpus, [(n.id, n.cpus, n.mem_kb) for n in topo.numa],
            topo.total_mem_kb)


def test_discover_matches_this_host_and_the_reference():
    t, j = T.discover(), J.discover()
    assert t.ncpus >= 1
    assert t.total_mem_kb > 0
    assert t.numa and t.numa[0].cpus
    assert t.numa_of_cpu(t.allowed_cpus[0]) >= 0
    assert "cpus(allowed)" in t.summary()
    assert _as_tuple(t) == _as_tuple(j)
    assert t.summary() == j.summary()
    assert t.allowed_cpus == sorted(os.sched_getaffinity(0))


@pytest.mark.parametrize("text", ["0-3,8,10-11", "", "5", "0-0", "1,3,5-7\n",
                                  "0-63", ",2,"])
def test_parse_cpulist(text):
    assert T._parse_cpulist(text) == J._parse_cpulist(text)
    if text == "0-3,8,10-11":
        assert T._parse_cpulist(text) == [0, 1, 2, 3, 8, 10, 11]


@pytest.mark.parametrize("ncpus,size", [(8, 4), (8, 16), (8, 8), (7, 3),
                                        (1, 4), (13, 5), (0, 2), (4, 0)])
def test_rank_cpuset_partition(ncpus, size):
    tt = T.HostTopology(list(range(ncpus)), [], 0)
    jt = J.HostTopology(list(range(ncpus)), [], 0)
    sets = [T.rank_cpuset(r, size, tt) for r in range(max(size, 1))]
    assert sets == [J.rank_cpuset(r, size, jt) for r in range(max(size, 1))]
    if ncpus and size:
        assert all(sets)  # never empty
        if size <= ncpus:
            assert sorted(c for s in sets for c in s) == list(range(ncpus))
    if (ncpus, size) == (8, 4):
        assert [len(s) for s in sets] == [2, 2, 2, 2]


def test_bind_rank_applies_affinity():
    before = os.sched_getaffinity(0)
    try:
        got = T.bind_rank(0, len(before))
        assert os.sched_getaffinity(0) == set(got)
        assert got == J.rank_cpuset(0, len(before))
    finally:
        os.sched_setaffinity(0, before)


def test_maybe_bind_follows_the_variable(mca):
    assert T.maybe_bind(0, 2) is None  # topo_bind_ranks off by default
    before = os.sched_getaffinity(0)
    mca.port("topo", "bind_ranks", True)
    try:
        assert T.maybe_bind(0, 1) == sorted(before)
    finally:
        os.sched_setaffinity(0, before)


@pytest.mark.parametrize("raw,fake", [
    ((0, 0, 1, 1), 0), (("a", "b", "a", "c"), 2), ((5, 5, 5), 0),
    ((0, 1, 2, 3, 4, 5), 3), (("h0",), 1), ((), 0), ((1, 0, 1, 0), 4)])
def test_domain_map(raw, fake):
    t, j = T.domain_map(raw, fake), J.domain_map(raw, fake)
    assert (t.node_of, t.slice_of_node) == (j.node_of, j.slice_of_node)
    for prop in ("n_nodes", "n_slices", "biggest_node", "nontrivial"):
        assert getattr(t, prop) == getattr(j, prop), prop
    for r in range(len(raw)):
        assert t.slice_of_rank(r) == j.slice_of_rank(r)
    for n in range(t.n_nodes):
        assert t.members_of_node(n) == j.members_of_node(n)


def test_accelerators_are_the_cards_torch_sees():
    import torch

    acc = T.discover().accelerators()
    assert acc == T.accelerators()
    if not torch.cuda.is_available():
        assert acc == []
