"""The port's coll/han and coll/hier (the composer and its decision engine)
against the JAX package's cases.

- ``tests/test_han.py`` (4 cases) and ``tests/test_hier.py`` (16 cases) on
  renamed copies, each in a pytest of its own: han under 2 and 3 fake
  nodes, hier's plan cache, fallback chain, domain maps and decision
  tables, the composed verbs bitwise equal to the flat chain on 2 fake
  nodes and on 4 nodes in 2 slices, and the self-tuning re-score switching
  once, on the same call index on every rank, in 5 episodes.
- ``check_han.py`` and ``check_hier.py`` in jobs of JAX-package and port
  ranks at the default selection with the fake-node variables their JAX
  tests pass: the two packages build the same sub-communicators with the
  same CIDs, fold each other's stage reports on the -4700 plane and switch
  plans together.
- A write to each ``coll_hier_*`` variable that the frozen dispatch plans
  watch bumps the plan epoch, now that the port registers them.
"""

import os

import pytest

from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture
from tests.test_torch_procmode_fixture import (
    REPO,
    mixed_program,
    passed,
    renamed,
    run_mpi,
    run_renamed_tests,
)

# tests/test_hier.py's knob sets, and those of its chaos proof
CORRECT = (("coll_hier_fake_nodes", "2"), ("coll_hier_selftune", "0"))
CHAOS = (("coll_hier_fake_nodes", "2"),
         ("coll_hier_rescore_interval", "8"),
         ("coll_hier_min_samples", "4"),
         ("coll_hier_retune_factor", "3.0"),
         ("coll_hier_retune_min_us", "100000"),
         ("coll_hier_inject_stage", "cross"),
         ("coll_hier_inject_delay_ms", "150"),
         ("coll_hier_inject_after", "12"))


@pytest.mark.parametrize("test_file,count", [("test_han.py", 4),
                                             ("test_hier.py", 16)])
def test_cases_on_the_port(tmp_path, test_file, count):
    r = run_renamed_tests(test_file, tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == count, r.stdout


def _mixed(tmp_path, np_, script, *args, mca=(), timeout=180):
    return run_mpi(np_, mixed_program(tmp_path),
                   os.path.join(REPO, "tests", "procmode", script),
                   renamed(script, tmp_path), *args, mca=mca,
                   timeout=timeout)


@pytest.mark.parametrize("np_", [4, 5])
def test_mixed_check_han(tmp_path, np_):
    r = _mixed(tmp_path, np_, "check_han.py",
               mca=(("coll_han_fake_nodes", "2"),))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("HAN-OK") == np_


@pytest.mark.parametrize("mode,np_,mca,tag", [
    ("correctness", 4, CORRECT, "HIER-OK"),
    ("chaos", 4, CHAOS, "CHAOS-OK"),
])
def test_mixed_check_hier(tmp_path, mode, np_, mca, tag):
    r = _mixed(tmp_path, np_, "check_hier.py", mode, mca=mca, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(tag) == np_
    if mode == "chaos":
        assert r.stdout.count("episodes=5") == np_


@pytest.mark.parametrize("name", [
    "enable", "selftune", "min_bytes", "rescore_interval", "retune_factor",
    "retune_min_us", "min_samples", "fake_nodes", "fake_slices"])
def test_each_watched_hier_variable_bumps_the_plan_epoch(mca, name):
    from ompi_tpu_torch.coll.hier import decide  # noqa: F401 registers
    from ompi_tpu_torch.coll.hier import plan
    from ompi_tpu_torch.mca.var import all_vars

    v = all_vars()[f"coll_hier_{name}"]
    e0 = plan.epoch()
    mca.port("coll_hier", name, v._value)
    assert plan.epoch() == e0 + 1
