"""The port's coll/sm (segment collectives) and coll/adapt (event-driven
pipelined trees) against the JAX package's cases.

- ``tests/test_smcoll.py`` (2 cases) and ``tests/test_adapt.py`` (4) on
  renamed copies, each in a pytest of its own: sm serving every layout
  verb of an all-local world (the timing ratios stay unasserted, as in the
  JAX file outside its soak gate), an alltoall whose size does not divide
  delegating whole, adapt's tree and segments, adapt at 4 ranks and at 3
  without the progress thread.
- ``check_smcoll.py`` and ``check_adapt.py`` in jobs of JAX-package and
  port ranks at the default selection: the ranks of both packages map one
  segment and meet on its tickets (the header, slot and result offsets
  are the reference's), and pipeline one tree on the per-segment tags.
- The segment layout of a port rank equals a JAX rank's for each comm
  size and chunk.
"""

import os

import numpy as np
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


@pytest.mark.parametrize("test_file,count", [("test_smcoll.py", 2),
                                             ("test_adapt.py", 4)])
def test_cases_on_the_port(tmp_path, test_file, count):
    r = run_renamed_tests(test_file, tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == count, r.stdout


@pytest.mark.parametrize("script,np_,mca,tag", [
    ("check_smcoll.py", 4, (), "SMCOLL-OK"),
    ("check_adapt.py", 4, (("coll_adapt_enable", "1"),
                           ("coll_sm_enable", "0")), "ADAPT-OK"),
])
def test_mixed_jobs_at_the_default_selection(tmp_path, script, np_, mca,
                                             tag):
    r = run_mpi(np_, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode", script),
                renamed(script, tmp_path), mca=mca, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(tag) == np_


class _Seg:
    """A stand-in segment, in process memory."""

    def __init__(self, size):
        self.mm = bytearray(size)
        self.size = size

    def view(self, offset, nbytes, dtype=np.uint8):
        dt = np.dtype(dtype)
        return np.frombuffer(self.mm, dt, nbytes // dt.itemsize, offset)


class _Req:
    def __init__(self, n):
        self.status = type("S", (), {"_nbytes": n})()

    def Wait(self):
        pass


class _Pml:
    """Delivers the announced segment path to the attaching rank."""

    def irecv(self, buf, count, dt, src, tag, cid):
        path = np.frombuffer(b"/dev/shm/seg", np.uint8)
        buf[:path.size] = path
        return _Req(path.size)


class _Comm:
    def __init__(self, n):
        self.size, self.rank, self.cid = n, 1, 7
        self.pml = _Pml()
        self.group = type("G", (), {"world_rank": lambda _, r: r})()


@pytest.mark.parametrize("n", [2, 3, 4, 7, 16])
@pytest.mark.parametrize("chunk", [4096, 1 << 20])
def test_segment_layout_equals_the_reference(mca, monkeypatch, n, chunk):
    """The size a non-root rank maps, the header bytes and the flag and
    data views, on both packages."""
    from ompi_tpu.coll import smcoll as jsm
    from ompi_tpu.runtime import mpool as jmpool
    from ompi_tpu_torch.coll import smcoll as tsm
    from ompi_tpu_torch.runtime import mpool as tmpool

    layouts = []
    for sm, mpool, side in ((jsm, jmpool, mca.jax), (tsm, tmpool, mca.port)):
        side("coll_sm", "chunk_bytes", chunk)
        seen = []

        def attach(path, size, seen=seen):
            seen.append((path, size))
            return _Seg(size)

        monkeypatch.setattr(mpool, "attach_segment", attach)
        mod = sm.SmColl()
        mod._flat = type("F", (), {"barrier": lambda _, c: None})()
        mod._segment(_Comm(n))
        layouts.append((seen, mod._hdr, mod._flags.shape, mod._data.shape,
                        mod._chunk, mod._n))
        mod._seg = None
    assert layouts[0] == layouts[1]
    assert layouts[0][1] == (2 * n * 8 + 64 + 4095) & ~4095
