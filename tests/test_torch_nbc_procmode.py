"""The port's nonblocking collectives (``coll/nbc.py`` over the round
engine) in process mode, against the JAX package's cases.

- The process-mode cases of ``tests/test_nbc.py`` on a renamed copy:
  ``check_nbc.py`` at 2, 3 and 4 ranks (every i-verb, overlapping
  schedules on one comm completed by ``Waitall``, a non-commutative user
  op), ``check_tuned.py`` at 4 and 3 ranks (each forced algorithm and the
  segmented ring), and the NBC and partitioned CID planes kept apart on a
  singleton.
- ``check_nbc.py`` in jobs of JAX-package and port ranks at 4 and 3 ranks
  (the even ranks' schedules and the odd ranks' meet on one tag plane).
"""

import os

import pytest

from tests.test_torch_procmode_fixture import (
    REPO,
    mixed_program,
    passed,
    renamed,
    run_mpi,
    run_renamed_tests,
)

NO_MESH = (("from ompi_tpu_torch.parallel import mesh_world",
            "mesh_world = None  # the mesh cases: tests/test_torch_nbc.py"),)


def test_nbc_procmode_cases_on_the_port(tmp_path):
    r = run_renamed_tests("test_nbc.py", tmp_path,
                          "procmode or tuned or planes", NO_MESH)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == 6, r.stdout


@pytest.mark.parametrize("np_", [4, 3])
def test_mixed_check_nbc(tmp_path, np_):
    r = run_mpi(np_, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode", "check_nbc.py"),
                renamed("check_nbc.py", tmp_path))
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("NBC-OK") == np_
