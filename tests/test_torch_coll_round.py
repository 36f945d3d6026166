"""The port's round engine (``coll/sched.py``) and host algorithms
(``coll/algorithms.py``) against the JAX package's.

- Every case of ``tests/test_coll_round.py`` on a renamed copy: the
  pooled-receive ownership (recycle on completion or ``Round.free``,
  discard on failure, the pool's counts asserted after the wait, never a
  timing), windowing in ``run_blocking`` and ``NbcRequest``, borrowed
  sends, the legacy engine, the variables and pvars, and the two
  process-mode jobs of ``check_coll_round.py`` (4 ranks; 3 over tcp
  under delay and duplication).
- Rank for rank: each algorithm runs on n ranks (threads over a loopback
  pml) in each package from the same seeded inputs, and every rank's
  received bytes are equal between the packages, bit for bit — f32, f64,
  int32 and bf16 (ml_dtypes in the JAX package, a torch tensor in the
  port), commutative and rank-ordered ops.
- ``check_coll_round.py`` in a job of JAX-package and port ranks.
- The buffer kinds: receives land in place in CPU tensors, ndarrays and
  a ``DeviceBuffer``'s host tensor, never in a read-only staged copy;
  bf16 sends are borrowed through their int16 storage.
"""

import contextlib
import importlib
import os
import threading
import types
import zlib
from collections import deque

import numpy as np
import pytest
import torch

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

# the selection tests/test_coll_round.py:410-413 launches check_coll_round.py
# under: the script measures the round engine's copies, which coll/sm's
# segment Allreduce never makes
ROUND_ENGINE = (("coll_coll", "^sm,adapt,han,hier,quant"),)
TAG, CID = -77, 9101


def test_coll_round_cases_on_the_port(tmp_path):
    r = run_renamed_tests("test_coll_round.py", tmp_path)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == 14, r.stdout


def test_mixed_check_coll_round_4_ranks(tmp_path):
    r = run_mpi(4, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode",
                             "check_coll_round.py"),
                renamed("check_coll_round.py", tmp_path),
                mca=ROUND_ENGINE, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("COLLROUND-OK") == 4
    assert r.stdout.count("COLLROUND-EQ") == 4


# ------------------------------------------------ rank for rank, in-process
class _Router:
    def __init__(self):
        self.lock = threading.Lock()
        self.mail = {}
        self.wait = {}


class _Pml:
    """Loopback pml: a send copies its bytes (the wire), a receive lands
    in the posted view; requests of the package under test."""

    def __init__(self, router, rank, request_cls):
        self.router, self.rank, self.Request = router, rank, request_cls

    def isend(self, data, nbytes, dt, dst, tag, cid, qos=None):
        req = self.Request()
        payload = np.ascontiguousarray(data).tobytes()
        key = (dst, self.rank, tag, cid)
        with self.router.lock:
            q = self.router.wait.get(key)
            deliver = q.popleft() if q else None
            if deliver is None:
                self.router.mail.setdefault(key, deque()).append(payload)
        if deliver is not None:
            rreq, view = deliver
            view[:len(payload)] = np.frombuffer(payload, np.uint8)
            rreq._set_complete(0)
        req._set_complete(0)
        return req

    def irecv(self, buf, nbytes, dt, src, tag, cid):
        req = self.Request()
        view = np.asarray(buf).view(np.uint8)[:nbytes]
        key = (self.rank, src, tag, cid)
        with self.router.lock:
            q = self.router.mail.get(key)
            payload = q.popleft() if q else None
            if payload is None:
                self.router.wait.setdefault(key, deque()).append((req, view))
        if payload is not None:
            view[:len(payload)] = np.frombuffer(payload, np.uint8)
            req._set_complete(0)
        return req


class _Group:
    def world_rank(self, x):
        return x


class _Comm:
    def __init__(self, router, rank, size, request_cls):
        self.rank, self.size, self.cid = rank, size, CID
        self.pml = _Pml(router, rank, request_cls)
        self.group = _Group()


def _pkg(name):
    m = lambda s: importlib.import_module(f"{name}.{s}")  # noqa: E731
    return types.SimpleNamespace(name=name, alg=m("coll.algorithms"),
                                 sched=m("coll.sched"), op=m("core.op"),
                                 mpool=m("runtime.mpool"),
                                 Request=m("core.request").Request)


@contextlib.contextmanager
def _private_pools(mpool):
    """Serve the round engine's receive blocks from pools of this test's
    own, closed at the end: the process-wide size-class pools (whose free
    lists other tests of the worker count) stay as they were."""
    pools, lock = {}, threading.Lock()

    def class_pool(nbytes, max_free=8):
        cls = mpool.size_class(nbytes)
        if cls is None:
            return None
        with lock:
            if cls not in pools:
                pools[cls] = mpool.BufferPool(cls, max_free=max_free)
            return pools[cls]

    saved = mpool.class_pool
    mpool.class_pool = class_pool
    try:
        yield
    finally:
        mpool.class_pool = saved
        for pool in pools.values():
            pool.close()


def _inputs(dtype, n, count, seed):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        if dtype == "int32":
            out.append(rng.integers(-1000, 1000, count).astype(np.int32))
        else:
            v = (rng.standard_normal(count) * 100).astype(np.float64)
            out.append(v if dtype == "float64" else v.astype(np.float32))
    return out


def _as(pkg, x, bf16):
    """A buffer of the package's own kind: bf16 as ml_dtypes in the JAX
    package, a CPU tensor in the port (numpy has no bf16)."""
    if not bf16:
        return x.copy()
    if pkg.name == JAX:
        import ml_dtypes

        return x.astype(ml_dtypes.bfloat16)
    return torch.from_numpy(x.copy()).to(torch.bfloat16)


def _zeros_like(x, count=None):
    n = x.shape[0] if count is None else count
    if isinstance(x, torch.Tensor):
        return torch.zeros(n, dtype=x.dtype)
    return np.zeros(n, dtype=x.dtype)


def _bytes(x):
    if isinstance(x, torch.Tensor):  # bf16, through its int16 storage
        return x.view(torch.int16).numpy().tobytes()
    return np.ascontiguousarray(x).view(np.uint8).tobytes()


def _run(pkg, algo, n, inputs, bf16, op_name, nseg=1):
    router = _Router()
    comms = [_Comm(router, r, n, pkg.Request) for r in range(n)]
    if op_name == "first":
        op = pkg.op.Op.Create(lambda a, b: a, commute=False, name="first")
    else:
        op = getattr(pkg.op, op_name)
    outs, gens = [], []
    for r, c in enumerate(comms):
        x = _as(pkg, inputs[r], bf16)
        count = x.shape[0]
        if algo == "allreduce_ring":
            out = _zeros_like(x)
            g = pkg.alg.allreduce_ring(c, x, out, op, nseg=nseg)
        elif algo == "allreduce_recursive_doubling":
            out = _zeros_like(x)
            g = pkg.alg.allreduce_recursive_doubling(c, x, out, op)
        elif algo in ("reduce_binomial", "reduce_linear"):
            out = _zeros_like(x)
            g = getattr(pkg.alg, algo)(c, x, out, op, 1 % n)
        elif algo == "bcast_binomial":
            out = x
            g = pkg.alg.bcast_binomial(c, out, n - 1)
        elif algo in ("allgather_ring", "allgather_bruck"):
            out = _zeros_like(x, count * n)
            g = getattr(pkg.alg, algo)(c, x, out)
        elif algo == "alltoall_pairwise":
            out = _zeros_like(x)
            g = pkg.alg.alltoall_pairwise(c, x, out)
        elif algo in ("scan_linear", "exscan_linear"):
            out = _zeros_like(x)
            g = getattr(pkg.alg, algo)(c, x, out, op)
        elif algo == "reduce_scatter_block_sched":
            out = _zeros_like(x, count // n)
            g = pkg.alg.reduce_scatter_block_sched(c, x, out, op)
        outs.append(out)
        gens.append(g)
    errs = []

    def drive(c, g):
        try:
            pkg.sched.run_blocking(c, g, TAG, CID)
        except BaseException as e:  # noqa: BLE001 - reported below
            errs.append(e)

    ts = [threading.Thread(target=drive, args=(c, g))
          for c, g in zip(comms, gens)]
    with _private_pools(pkg.mpool):
        for t in ts:
            t.start()
        for t in ts:
            t.join(30)
    assert not errs, errs
    return [_bytes(o) for o in outs]


CASES = [
    ("allreduce_ring", 4, "SUM", 1), ("allreduce_ring", 3, "SUM", 3),
    ("allreduce_ring", 5, "MAX", 2),
    ("allreduce_recursive_doubling", 4, "SUM", 1),
    ("allreduce_recursive_doubling", 3, "PROD", 1),
    ("allreduce_recursive_doubling", 6, "SUM", 1),
    ("reduce_binomial", 5, "SUM", 1), ("reduce_linear", 3, "first", 1),
    ("reduce_linear", 4, "SUM", 1), ("bcast_binomial", 5, "SUM", 1),
    ("allgather_ring", 3, "SUM", 1), ("allgather_bruck", 5, "SUM", 1),
    ("alltoall_pairwise", 4, "SUM", 1), ("scan_linear", 4, "SUM", 1),
    ("exscan_linear", 3, "SUM", 1), ("scan_linear", 3, "first", 1),
    ("reduce_scatter_block_sched", 4, "SUM", 1),
    ("reduce_scatter_block_sched", 3, "first", 1),
]


@pytest.mark.parametrize("dtype", ["float32", "float64", "int32", "bf16"])
@pytest.mark.parametrize("algo,n,op,nseg", CASES,
                         ids=[f"{a}-{n}-{o}-{s}" for a, n, o, s in CASES])
def test_algorithm_bytes_equal_the_reference_rank_for_rank(algo, n, op,
                                                           nseg, dtype):
    if dtype == "int32" and op == "PROD":
        op = "SUM"
    count = 4 * n * 12 + (0 if "scatter" in algo or "alltoall" in algo
                          else 5)
    inputs = _inputs("float32" if dtype == "bf16" else dtype, n, count,
                     seed=zlib.crc32(f"{algo}{n}{op}{dtype}".encode()))
    bf16 = dtype == "bf16"
    want = _run(_pkg(JAX), algo, n, inputs, bf16, op, nseg)
    got = _run(_pkg(PORT), algo, n, inputs, bf16, op, nseg)
    assert got == want


def test_rank_for_rank_cases_leave_each_package_pool_as_they_found_it():
    """A 4-rank ring of 3000-byte blocks runs on each package's round
    engine, receiving into the 4096-byte class: the process-wide class
    pools of both packages (their free lists, outstanding blocks, hits and
    misses) are as they were, so the JAX package's
    ``test_pooled_recv_recycles_on_completion`` in the same worker counts
    only its own blocks."""
    def state(mpool):
        p = mpool._class_pools.get(4096)
        return None if p is None else (len(p._free), p.outstanding,
                                       p.hits, p.misses)

    pkgs = (_pkg(JAX), _pkg(PORT))
    before = [state(pkg.mpool) for pkg in pkgs]
    inputs = _inputs("float32", 4, 3000, seed=3000)
    outs = [_run(pkg, "allreduce_ring", 4, inputs, False, "SUM")
            for pkg in pkgs]
    assert outs[0] == outs[1]
    assert [state(pkg.mpool) for pkg in pkgs] == before


# ------------------------------------------------------------ buffer kinds
def test_direct_view_lands_in_host_memory_only():
    """A receive lands in place in a CPU tensor, an ndarray and a
    ``DeviceBuffer``'s host tensor; a read-only buffer (what a CUDA
    tensor stages to) and a non-contiguous one stage instead; a CPU
    tensor's send bytes are borrowed, bf16 through its int16 storage."""
    from ompi_tpu_torch.accelerator import DeviceBuffer
    from ompi_tpu_torch.coll import algorithms as alg
    from ompi_tpu_torch.coll import sched

    t = torch.zeros(6, dtype=torch.float32)
    v = alg._direct_view(t)
    v[:4] = 7
    assert v.nbytes == 24 and t.view(torch.uint8)[:4].tolist() == [7] * 4
    db = DeviceBuffer((3,), torch.bfloat16)
    v = alg._direct_view(db)
    v[:] = 0xFF
    assert v.nbytes == 6 and torch.isnan(db.host).all()
    a = np.zeros(4, np.int32)
    assert alg._direct_view(a).nbytes == 16
    ro = np.zeros(4, np.int32)
    ro.flags.writeable = False
    assert alg._direct_view(ro) is None
    assert alg._direct_view(torch.zeros(8)[::2]) is None
    bf = torch.arange(4, dtype=torch.bfloat16)
    cp0 = sched._ctr["copied"]
    raw = sched.flat_bytes(bf)
    assert raw.nbytes == 8 and sched._ctr["copied"] == cp0
    assert raw.tobytes() == bf.view(torch.int16).numpy().tobytes()
    sched.flat_bytes(torch.zeros(8)[::2])  # strided: one counted copy
    assert sched._ctr["copied"] == cp0 + 16
