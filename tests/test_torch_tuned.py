"""The port's ``coll/tuned`` against the JAX package's.

- Every case of ``tests/test_tuned_rules.py`` on a renamed copy (the rules
  file's format, the most-specific-rule choice, the mtime cache, the
  per-rule ``segsize`` reaching the ring, a non-commutative op refusing a
  dynamic binomial reduce).
- ``dynamic_choice`` equal to the reference's over a grid of (collective,
  comm size, bytes) and two rules files, each package reading the same
  file through the same variables.
- The fixed decision: for each (collective, comm size, bytes, op) of a
  grid, with the rules off and on, the algorithm each package's
  ``TunedColl`` hands to the round engine (or to coll/basic) is the same,
  and so is the segment count of the segmented ring.
- ``check_tuned.py`` in a job of JAX-package and port ranks, and the
  process-mode selection (each slot's winner and fallbacks on six kinds
  of comm) equal between a JAX-package rank and a port rank of one job,
  under the pin of ``coll_coll``; and at the default selection, with
  ``coll_hier_fake_nodes=2``, ``coll_han_fake_nodes=2`` (hier off),
  ``coll_adapt_enable=1`` and ``quant_enable=1``.
"""

import importlib
import os
import types

import numpy as np
import pytest

from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture
from tests.test_torch_procmode_fixture import (
    JAX,
    PORT,
    REPO,
    mixed_program,
    passed,
    renamed,
    run_mpi,
    run_renamed_tests,
)

PIN = (("coll_coll", "^sm,adapt,han,hier,quant"),)

RULES = {
    "layered": """
# coll  comm_min  msg_min  algo [params]
allreduce 2 0       recursive_doubling
allreduce 2 8192    ring
allreduce 4 65536   ring_segmented segsize=16384
allreduce 16 1048576 ring_segmented segsize=262144
allgather 2 0       bruck
allgather 3 32768   ring
alltoall 2 0        pairwise
alltoall 5 4096     basic
reduce 2 0          binomial
reduce 8 1000000    linear
""",
    "sparse": """
allreduce 3 100 linear
allreduce 3 100 ring              # a tie: the first rule wins
allgather 4 0 ring
reduce 2 4096 linear
alltoall 2 0 warp_drive          # unknown: skipped
allreduce 2 0 ring segsize=9     # a param the algorithm ignores: skipped
""",
}
COLLS = ("allreduce", "allgather", "alltoall", "reduce", "bcast")
SIZES = (1, 2, 3, 4, 5, 8, 16, 32)
BYTES = (0, 1, 100, 4095, 4096, 8192, 8193, 32768, 65536, 1 << 20,
         (1 << 20) + 1, 64 << 20)


def _mods(pkg):
    m = lambda name: importlib.import_module(f"{pkg}.{name}")  # noqa: E731
    return types.SimpleNamespace(tuned=m("coll.tuned"), alg=m("coll.algorithms"),
                                 op=m("core.op"), basic=m("coll.basic"))


def test_tuned_rules_cases_on_the_port(tmp_path):
    r = run_renamed_tests("test_tuned_rules.py", tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == 9, r.stdout


@pytest.mark.parametrize("rules", sorted(RULES))
def test_dynamic_choice_equals_the_reference(mca, tmp_path, rules):
    path = tmp_path / "rules.conf"
    path.write_text(RULES[rules])
    mca.both("coll_tuned", "use_dynamic_rules", True)
    mca.both("coll_tuned", "dynamic_rules_filename", str(path))
    j, t = _mods(JAX).tuned, _mods(PORT).tuned
    seen = set()
    for coll in COLLS:
        for size in SIZES:
            for nbytes in BYTES:
                want = j.dynamic_choice(coll, size, nbytes)
                assert t.dynamic_choice(coll, size, nbytes) == want, \
                    (coll, size, nbytes)
                seen.add(want[0] if want else None)
    assert t._load_rules(str(path)) == j._load_rules(str(path))
    assert len(seen) >= 3  # the grid reaches several rules


class _Bail(Exception):
    pass


class _FakeComm:
    rank = 0

    def __init__(self, size):
        self.size = size


def _decision(monkeypatch, pkg, verb, size, nbytes, commutative):
    """The name of the algorithm ``pkg``'s TunedColl picks (and its
    ``nseg``), stopping the schedule before it sends a byte."""
    ns = _mods(pkg)
    seen = {}

    def record(name):
        def fake(*a, **kw):
            seen["algo"] = name
            seen["nseg"] = kw.get("nseg", 1)
            raise _Bail
        return fake

    for name in ("allreduce_recursive_doubling", "allreduce_ring",
                 "allgather_ring", "allgather_bruck", "alltoall_pairwise",
                 "reduce_binomial", "reduce_linear"):
        monkeypatch.setattr(ns.alg, name, record(name))
    basic = ns.tuned.TunedColl._basic()
    for name in ("allreduce", "alltoall"):
        monkeypatch.setattr(basic, name, record("basic." + name))
    op = ns.op.SUM if commutative else ns.op.Op.Create(
        lambda a, b: a, commute=False, name="first")
    buf = np.zeros(nbytes, np.uint8)
    mod = ns.tuned.TunedColl()
    call = {"allreduce": lambda: mod.allreduce(_FakeComm(size), buf, buf, op),
            "allgather": lambda: mod.allgather(_FakeComm(size), buf, buf),
            "alltoall": lambda: mod.alltoall(_FakeComm(size), buf, buf),
            "reduce": lambda: mod.reduce(_FakeComm(size), buf, buf, op, 0)}
    try:
        call[verb]()
    except _Bail:
        pass
    return seen.get("algo"), seen.get("nseg")


@pytest.mark.parametrize("rules", [None, "layered"])
@pytest.mark.parametrize("verb", ["allreduce", "allgather", "alltoall",
                                  "reduce"])
def test_fixed_and_dynamic_decisions_equal_the_reference(
        mca, monkeypatch, tmp_path, verb, rules):
    if rules is not None:
        path = tmp_path / "rules.conf"
        path.write_text(RULES[rules])
        mca.both("coll_tuned", "use_dynamic_rules", True)
        mca.both("coll_tuned", "dynamic_rules_filename", str(path))
    algos = set()
    for size in (2, 3, 4, 8, 16):
        for nbytes in (8, 4096, 8192, 8200, 65536, 4 << 20, 5 << 20):
            for commutative in (True, False):
                want = _decision(monkeypatch, JAX, verb, size, nbytes,
                                 commutative)
                got = _decision(monkeypatch, PORT, verb, size, nbytes,
                                commutative)
                assert got == want, (size, nbytes, commutative)
                algos.add(want[0])
    assert None not in algos, algos
    # every verb but alltoall without rules reaches two algorithms
    assert len(algos) >= 2 or (verb, rules) == ("alltoall", None), algos


def test_mixed_check_tuned_3_ranks(tmp_path):
    """Even ranks the JAX package, odd ranks the port: the forced
    algorithms of ``check_tuned.py`` meet on one wire and agree."""
    r = run_mpi(3, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode", "check_tuned.py"),
                renamed("check_tuned.py", tmp_path), mca=PIN, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("TUNED-OK") == 3


PROVIDERS = '''\
import json
import {pkg}
from {pkg} import COMM_WORLD as W

r, n = W.Get_rank(), W.Get_size()
comms = {{"world": W, "dup": W.Dup(), "split": W.Split(r % 2, r),
          "cart": W.Create_cart([n], [True]),
          "graph": W.Create_graph([1, 2], [1, 0]),
          "distgraph": W.Create_dist_graph_adjacent([(r + 1) % n],
                                                    [(r - 1) % n])}}
out = {{k: [c.coll.providers, c.coll.fallback_providers]
        for k, c in comms.items() if c is not None}}
print(f"PROVIDERS {{r}} " + json.dumps(out, sort_keys=True), flush=True)
{pkg}.Finalize()
'''


def test_process_mode_providers_equal_the_reference(tmp_path):
    """Each slot's winner and its fallbacks, for world, Dup, Split, cart,
    graph and dist-graph comms of a job whose rank 0 runs the JAX package
    and rank 1 the port, under the pin mixed jobs use: tuned (30), nbc
    (20), neighbor (40) over basic (10), equal on both ranks."""
    import json

    progs = {}
    for pkg in (JAX, PORT):
        progs[pkg] = tmp_path / f"providers_{pkg}.py"
        progs[pkg].write_text(PROVIDERS.format(pkg=pkg))
    r = run_mpi(2, mixed_program(tmp_path), progs[JAX], progs[PORT],
                mca=PIN)
    assert r.returncode == 0, r.stdout + r.stderr
    got = {}
    dec = json.JSONDecoder()
    for rank in (0, 1):
        i = r.stdout.index(f"PROVIDERS {rank} ") + len(f"PROVIDERS {rank} ")
        got[rank] = dec.raw_decode(r.stdout, i)[0]
    assert got[1] == got[0]
    world = got[1]["world"][0]
    assert (world["allreduce"], world["iallreduce"], world["bcast"]) == \
        ("tuned", "nbc", "basic")
    assert got[1]["cart"][0]["neighbor_allgather"] == "neighbor"
    assert got[1]["graph"][0]["neighbor_alltoall"] == "neighbor"


SETTINGS = '''\
import json
import platform
import {pkg}
from {pkg} import COMM_WORLD as W
from {pkg}.mca.var import get_var, set_var

# each setting on a Dup of the world (the world keeps the launch's)
SETS = {{"hier_fake_nodes_2": [("coll_hier", "fake_nodes", 2)],
         "han_fake_nodes_2": [("coll_han", "fake_nodes", 2),
                              ("coll_hier", "enable", False)],
         "adapt_enable": [("coll_adapt", "enable", True)]}}
r = W.Get_rank()
out = {{"world": [W.coll.providers, W.coll.fallback_providers],
        "machine": platform.machine()}}
for name, sets in SETS.items():
    saved = [(fw, v, get_var(fw, v)) for fw, v, _ in sets]
    for fw, v, value in sets:
        set_var(fw, v, value)
    c = W.Dup()
    out[name] = [c.coll.providers, c.coll.fallback_providers]
    for fw, v, value in saved:
        set_var(fw, v, value)
print(f"PROVIDERS {{r}} " + json.dumps(out, sort_keys=True), flush=True)
{pkg}.Finalize()
'''


@pytest.mark.parametrize("launch", ["default", "quant_enable"])
def test_process_mode_providers_at_each_setting_equal_the_reference(
        tmp_path, launch):
    """A 4-rank job at the default selection (even ranks the JAX package,
    odd ranks the port): each slot's winner and its fallbacks for the
    world and for Dups under ``coll_hier_fake_nodes=2``, under
    ``coll_han_fake_nodes=2`` with ``coll_hier_enable=0`` and under
    ``coll_adapt_enable=1``, equal on every rank; and the same in a job
    launched with ``quant_enable=1``."""
    import json

    progs = {}
    for pkg in (JAX, PORT):
        progs[pkg] = tmp_path / f"settings_{pkg}.py"
        progs[pkg].write_text(SETTINGS.format(pkg=pkg))
    mca = (("quant_enable", "1"),) if launch == "quant_enable" else ()
    r = run_mpi(4, mixed_program(tmp_path), progs[JAX], progs[PORT],
                mca=mca, timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    got = {}
    dec = json.JSONDecoder()
    for rank in range(4):
        i = r.stdout.index(f"PROVIDERS {rank} ") + len(f"PROVIDERS {rank} ")
        got[rank] = dec.raw_decode(r.stdout, i)[0]
    assert got[0] == got[1] == got[2] == got[3]
    world, hier, han = (got[1][k][0] for k in (
        "world", "hier_fake_nodes_2", "han_fake_nodes_2"))
    sm = "sm" if got[1]["machine"] in ("x86_64", "AMD64") else "tuned"
    quant = launch == "quant_enable"
    assert world["allreduce"] == ("quant" if quant else sm)
    assert world["bcast"] == sm
    assert (hier["allreduce"], hier["bcast"]) == (
        "quant" if quant else "hier", "hier")
    assert (han["allreduce"], han["barrier"]) == (
        "quant" if quant else "han", "han")
    assert "adapt" in got[1]["adapt_enable"][1]["bcast"]
