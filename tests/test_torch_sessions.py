"""The port's MPI-4 sessions (``runtime/session.py``) against the JAX
package's.

- Both cases of ``tests/test_sessions.py`` on a renamed copy of
  ``check_sessions.py``: a sessions-only program (no ``Init``: the
  session brings the instance up; ``mpi://WORLD`` and ``mpix://NODE``
  psets, a comm from a group, an Allreduce, ``Free`` then
  ``Session.Finalize``), and a session outliving ``Finalize``.
- The sessions-only program in a job of JAX-package and port ranks: the
  CID a string tag derives is the same in both packages, so the comm's
  first Allreduce meets on one plane.
- The objects of a session on a singleton: psets, ``Get_pset_info``,
  tracking through Dup and Split, and ``Finalize`` refusing while a
  derived comm lives, printed by both packages and equal.
"""

import json
import os

from tests.test_torch_procmode_fixture import (
    JAX,
    PORT,
    REPO,
    mixed_program,
    passed,
    renamed,
    run_mpi,
    run_py,
    run_renamed_tests,
)


def test_sessions_cases_on_the_port(tmp_path):
    r = run_renamed_tests("test_sessions.py", tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == 2, r.stdout


def test_mixed_sessions_only_program(tmp_path):
    r = run_mpi(3, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode", "check_sessions.py"),
                renamed("check_sessions.py", tmp_path), "sessions_only")
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("SESS-OK") == 3


SESSION = '''\
import json
import numpy as np
from {pkg}.core.errors import MPIError
from {pkg}.runtime.session import Session

s = Session.Init()
out = {{"psets": [s.Get_nth_pset(i) for i in range(s.Get_num_psets())]}}
out["info"] = {{p: dict(s.Get_pset_info(p).items()) for p in out["psets"]}}
comm = s.Comm_create_from_group(s.Group_from_pset("mpi://WORLD"), tag="t")
out["cid"] = comm.cid
dup = comm.Dup()
sub = dup.Split(0, 0)
got = np.zeros(1)
sub.Allreduce(np.array([2.5]), got)
out["sum"] = got.tolist()
try:
    s.Finalize()
    out["finalize_live"] = "no error"
except MPIError as e:
    out["finalize_live"] = [e.code, str(e).split(" (")[0]]
for c in (sub, dup, comm):
    c.Free()
s.Finalize()
try:
    s.Get_num_psets()
except MPIError as e:
    out["after"] = e.code
print("SESSION " + json.dumps(out, sort_keys=True))
'''


def test_session_objects_equal_the_reference(tmp_path):
    got = {}
    for pkg in (JAX, PORT):
        prog = tmp_path / f"session_{pkg}.py"
        prog.write_text(SESSION.format(pkg=pkg))
        r = run_py([prog])
        assert r.returncode == 0, r.stdout + r.stderr
        got[pkg] = json.loads(r.stdout.split("SESSION ", 1)[1])
    assert got[PORT] == got[JAX]
    assert got[PORT]["psets"] == ["mpi://WORLD", "mpi://SELF", "mpix://NODE"]
    assert got[PORT]["sum"] == [2.5]
    assert got[PORT]["finalize_live"][0] == 72  # MPI_ERR_SESSION
