"""The port's nonblocking, persistent and partitioned mesh verbs against the
JAX package's, on the CPU.

The mesh cases of ``tests/test_nbc.py:51-80``, ``tests/test_persistent_coll
.py:42-93``, ``tests/test_persist.py:389-429`` and every case of
``tests/test_mesh_partitioned.py`` have a counterpart here: the same numpy
input goes through JAX ``mesh_world(jax.devices()[:8])`` on the conftest's
8-device CPU mesh and through the port's ``mesh_world(8, "cpu")``, and each
case also keeps the reference test's own check. Then every i-verb and every
``*_init`` verb on the world and on Split(r % 2), and the request surface
the reference cases do not reach.

Tolerances: bit for bit (``assert_array_equal``, dtype included), except a
float SUM over the whole world (allreduce, reduce, reduce_scatter), which
agrees within 1e-6 of the sum of the magnitudes it adds.

Donation: JAX deletes a donated operand (``is_deleted()``); a tensor cannot
be deleted, so the port writes the result into the operand's storage
(``result.data_ptr() == x.data_ptr()``) exactly where JAX deletes it.
"""

import numpy as np
import pytest
import torch

import jax

from ompi_tpu.coll.sched import MeshPersistentRequest as JaxPersistentRequest
from ompi_tpu.core import op as jop
from ompi_tpu.core.request import Request as JaxRequest
from ompi_tpu.mca.var import set_var
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu_torch.coll import persist as tpersist
from ompi_tpu_torch.coll.sched import DeviceRequest, MeshPersistentRequest
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core.errors import (MPIError, ERR_ARG, ERR_PENDING,
                                        ERR_REQUEST, ERR_REVOKED)
from ompi_tpu_torch.core.request import CompletedRequest, Request
from ompi_tpu_torch.core.status import Status
from ompi_tpu_torch.parallel.mesh import MeshComm, mesh_world
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

W = 8
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    import ompi_tpu.coll.persist  # noqa: F401  (registers coll_persist_*)

    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


@pytest.fixture
def jax_persist():
    """Set the JAX package's coll_persist variables; restored after."""
    yield lambda name, value: set_var("coll_persist", name, value)
    set_var("coll_persist", "enable", 1)
    set_var("coll_persist", "donate", 0)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def same(got, want, sum_of=None):
    """The port's result held to JAX's: bit for bit (sign bits of zeros
    too), or with ``sum_of`` (the summed input) within SUM_RTOL of its
    magnitudes. Returns the port's result as numpy."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape and got.dtype == want.dtype
    if sum_of is None:
        np.testing.assert_array_equal(got, want)
        if got.dtype.kind == "f":
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    else:
        tol = SUM_RTOL * np.abs(sum_of).sum(0)
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    return got


def _op(c, name):
    """The op called ``name`` of the package that comm ``c`` belongs to."""
    return getattr(top if isinstance(c, MeshComm) else jop, name)


def _ranked(k=0):
    base = np.arange(4, dtype=np.float32) + k
    return np.stack([base + r for r in range(W)])


def _blocks(k=0):
    """[W, W, 3] per-rank blocks for the block verbs."""
    return np.arange(W * W * 3, dtype=np.float32).reshape(W, W, 3) + k


# --------------------------------------------- tests/test_nbc.py, mesh mode
def test_mesh_iallreduce(worlds):
    jc, tc = worlds
    jr, tr = (c.iallreduce(c.shard(_ranked())) for c in worlds)
    jr.Wait()
    tr.Wait()
    got = same(tr.result, jr.result, sum_of=_ranked())
    np.testing.assert_allclose(got, np.stack([_ranked().sum(0)] * W))


def test_mesh_i_overlap_waitall(worlds):
    xr = np.stack([np.arange(W, dtype=np.float32) + r for r in range(W)])
    reqs = {}
    for c, waitall in zip(worlds, (JaxRequest.Waitall, Request.Waitall)):
        x = c.shard(_ranked())
        reqs[c] = [c.iallreduce(x), c.iallgather(x),
                   c.ireduce_scatter(c.shard(xr))]
        waitall(reqs[c])
    jreqs, treqs = reqs.values()
    got = same(treqs[0].result, jreqs[0].result, sum_of=_ranked())
    np.testing.assert_allclose(got, np.stack([_ranked().sum(0)] * W))
    ag = same(treqs[1].result, jreqs[1].result)
    assert ag.shape == (W, W, 4)
    np.testing.assert_allclose(ag[0], _ranked())
    same(treqs[2].result, jreqs[2].result, sum_of=xr)


def test_mesh_ibcast_test_polls(worlds):
    out = []
    for c in worlds:
        req = c.ibcast(c.shard(_ranked()), root=2)
        while not req.Test():
            pass
        out.append(req.result)
    got = same(out[1], out[0])
    np.testing.assert_allclose(got, np.stack([_ranked()[2]] * W))


# every i-verb: (id, verb, its arguments after x for comm c, input, world
# float SUM)
I_VERBS = [
    ("iallreduce", "allreduce", lambda c: (), _ranked, True),
    ("iallreduce_max", "allreduce", lambda c: (_op(c, "MAX"),), _ranked,
     False),
    ("ibcast", "bcast", lambda c: (3,), _ranked, False),
    ("ireduce", "reduce", lambda c: (_op(c, "SUM"), 1), _ranked, True),
    ("ireduce_prod", "reduce", lambda c: (_op(c, "PROD"), 2), _ranked,
     False),
    ("iallgather", "allgather", lambda c: (), _ranked, False),
    ("ialltoall", "alltoall", lambda c: (), _blocks, False),
    ("ireduce_scatter", "reduce_scatter", lambda c: (), _blocks, True),
    ("ireduce_scatter_min", "reduce_scatter", lambda c: (_op(c, "MIN"),),
     _blocks, False),
]


def _split_blocks(k=0):
    """[W, 4, 3]: the block verbs' input on a comm of 4-member colours."""
    return _blocks(k)[:, :4]


@pytest.mark.parametrize("layout", ["world", "split"])
@pytest.mark.parametrize("case", I_VERBS, ids=[c[0] for c in I_VERBS])
def test_i_verb_matches_jax_and_the_blocking_verb(worlds, case, layout):
    _, verb, args, data, sums = case
    comms = worlds if layout == "world" else tuple(
        c.Split([r % 2 for r in range(W)]) for c in worlds)
    x = data() if data is _ranked or layout == "world" else _split_blocks()
    results = []
    for c in comms:
        req = getattr(c, "i" + verb)(c.shard(x), *args(c))
        req.Wait()
        results.append(req.result)
    same(results[1], results[0],
         sum_of=x if sums and layout == "world" else None)
    tc = comms[1]
    # the request holds what the blocking verb gives, bit for bit
    assert torch.equal(results[1], getattr(tc, verb)(tc.shard(x), *args(tc)))


def test_ibarrier_is_complete_when_it_returns(worlds):
    jr, tr = (c.ibarrier() for c in worlds)
    assert isinstance(tr, CompletedRequest)
    assert jr.is_complete and tr.is_complete and tr.Test()
    tr.Wait()
    with pytest.raises(MPIError) as e:
        worlds[1].iallreduce(worlds[1].shard(_ranked())).Start()
    assert e.value.code == ERR_REQUEST


# ------------------------------ tests/test_persistent_coll.py, mesh mode
def test_mesh_allreduce_init_restart(worlds):
    reqs = [c.allreduce_init(c.shard(_ranked())) for c in worlds]
    assert all(r.persistent and r.is_complete for r in reqs)  # inactive
    for k in (0, 3, 7):
        for c, r in zip(worlds, reqs):
            r.Start(c.shard(_ranked(k)))
            r.Wait()
        got = same(reqs[1].result, reqs[0].result, sum_of=_ranked(k))
        np.testing.assert_allclose(got, np.stack([_ranked(k).sum(0)] * W))


def test_mesh_init_reuses_init_operand(worlds):
    out = []
    for c in worlds:
        req = c.allgather_init(c.shard(_ranked(2)))
        req.Start()  # no operand: run on the init-time one
        req.Wait()
        out.append(req.result)
    got = same(out[1], out[0])
    np.testing.assert_allclose(got[0], _ranked(2))


def test_mesh_double_start_raises(worlds):
    out = []
    for c in worlds:
        req = c.bcast_init(c.shard(_ranked()), root=1)
        req.Start()
        with pytest.raises(Exception) as e:
            req.Start()
        assert "MPIError" in type(e.value).__name__
        req.Wait()
        out.append(req.result)
    got = same(out[1], out[0])
    np.testing.assert_allclose(got, np.stack([_ranked()[1]] * W))


def test_mesh_reduce_scatter_init(worlds):
    xr = np.stack([np.arange(W, dtype=np.float32) + r for r in range(W)])
    out = []
    for c in worlds:
        req = c.reduce_scatter_init(c.shard(xr))
        req.Start()
        req.Wait()
        out.append(req.result)
    got = same(out[1], out[0], sum_of=xr)
    expect = np.asarray([sum(i + r for r in range(W)) for i in range(W)],
                        np.float32)
    np.testing.assert_allclose(got.reshape(-1), expect)


def test_mesh_startall(worlds):
    chunks = np.arange(W * W, dtype=np.float32).reshape(W, W)
    out = []
    for c, cls in zip(worlds, (JaxPersistentRequest, MeshPersistentRequest)):
        a = c.allreduce_init(c.shard(_ranked()))
        b = c.alltoall_init(c.shard(chunks))
        cls.Startall([a, b])
        a.Wait()
        b.Wait()
        out.append((a.result, b.result))
    got = same(out[1][0], out[0][0], sum_of=_ranked())
    np.testing.assert_allclose(got, np.stack([_ranked().sum(0)] * W))
    same(out[1][1], out[0][1])


# every *_init verb: (name, fn(comm, x), input, world float SUM)
INIT_VERBS = [
    ("allreduce_init", lambda c, x: c.allreduce_init(x), _ranked, True),
    ("allreduce_init_prod",
     lambda c, x: c.Allreduce_init(x, _op(c, "PROD")), _ranked, False),
    ("bcast_init", lambda c, x: c.Bcast_init(x, 2), _ranked, False),
    ("reduce_init", lambda c, x: c.reduce_init(x, root=3), _ranked, True),
    ("reduce_init_max", lambda c, x: c.Reduce_init(x, _op(c, "MAX")),
     _ranked, False),
    ("allgather_init", lambda c, x: c.Allgather_init(x), _ranked, False),
    ("alltoall_init", lambda c, x: c.Alltoall_init(x), _blocks, False),
    ("reduce_scatter_init", lambda c, x: c.Reduce_scatter_init(x),
     _blocks, True),
    ("reduce_scatter_block_init",
     lambda c, x: c.Reduce_scatter_block_init(x, _op(c, "MAX")),
     _blocks, False),
    ("scan_init", lambda c, x: c.Scan_init(x), _ranked, False),
    ("scan_init_prod", lambda c, x: c.scan_init(x, _op(c, "PROD")),
     _ranked, False),
    ("exscan_init", lambda c, x: c.Exscan_init(x), _ranked, False),
    ("exscan_init_min", lambda c, x: c.exscan_init(x, _op(c, "MIN")),
     _ranked, False),
]


@pytest.mark.parametrize("layout", ["world", "split"])
@pytest.mark.parametrize("case", INIT_VERBS, ids=[c[0] for c in INIT_VERBS])
def test_init_verb_matches_jax_over_restarts(worlds, case, layout):
    """Init, then a Start on the init operand and two on fresh ones: each
    result held to JAX's."""
    name, fn, data, sums = case
    comms = worlds if layout == "world" else tuple(
        c.Split([r % 2 for r in range(W)]) for c in worlds)
    make = data if data is _ranked or layout == "world" else _split_blocks
    reqs = [fn(c, c.shard(make(0))) for c in comms]
    assert reqs[1]._frozen
    for k in (None, 1, 5):
        for c, r in zip(comms, reqs):
            r.Start(None if k is None else c.shard(make(k)))
            r.Wait()
        same(reqs[1].result, reqs[0].result,
             sum_of=make(k or 0) if sums and layout == "world" else None)


# -------------------------------------------- tests/test_persist.py, mesh
def test_mesh_init_freezes_executable(worlds):
    jc, tc = worlds
    plans = tpersist.plans
    reqs = [c.allreduce_init(c.shard(_ranked())) for c in worlds]
    assert all(r.persistent and r._frozen for r in reqs)
    assert tpersist.plans == plans + 1
    starts = tpersist.starts
    for k in (0, 5):
        for c, r in zip(worlds, reqs):
            r.Start(c.shard(_ranked(k)))
            r.Wait()
        got = same(reqs[1].result, reqs[0].result, sum_of=_ranked(k))
        np.testing.assert_allclose(got, np.stack([_ranked(k).sum(0)] * W))
    assert tpersist.starts == starts + 2 and tpersist.replay_us > 0


def test_mesh_init_respects_enable_0(worlds, jax_persist, mca):
    jax_persist("enable", 0)
    mca.port("coll_persist", "enable", 0)
    out = []
    for c in worlds:
        req = c.allgather_init(c.shard(_ranked(3)))
        assert not req._frozen  # every Start calls the verb
        req.Start()
        req.Wait()
        out.append(req.result)
    got = same(out[1], out[0])
    np.testing.assert_allclose(got[0], _ranked(3))


def test_mesh_donated_start_consumes_operand(worlds, jax_persist, mca):
    jax_persist("donate", 1)
    mca.port("coll_persist", "donate", 1)
    jc, tc = worlds
    jx0, tx0 = jc.shard(_ranked(1)), tc.shard(_ranked(1))
    jreq, treq = jc.allreduce_init(jx0), tc.allreduce_init(tx0)
    assert jreq._donate is not None and treq._donate is not None
    jfresh, tfresh = jc.shard(_ranked(4)), tc.shard(_ranked(4))
    jreq.Start(jfresh)
    jreq.Wait()
    treq.Start(tfresh)
    treq.Wait()
    got = same(treq.result, jreq.result, sum_of=_ranked(4))
    np.testing.assert_allclose(got, np.stack([_ranked(4).sum(0)] * W))
    assert jfresh.is_deleted()  # donated: XLA reused the buffer
    assert treq.result.data_ptr() == tfresh.data_ptr()  # the port's reading
    for r in (jreq, treq):
        r.Start()  # an operand-less restart runs the undonated init x
        r.Wait()
    same(treq.result, jreq.result, sum_of=_ranked(1))
    np.testing.assert_allclose(_np(treq.result),
                               np.stack([_ranked(1).sum(0)] * W))
    jreq.Start(jx0)  # the init operand itself is never donated
    jreq.Wait()
    treq.Start(tx0)
    treq.Wait()
    assert not jx0.is_deleted()
    assert treq.result.data_ptr() != tx0.data_ptr()
    np.testing.assert_array_equal(tx0.numpy(), _ranked(1))
    for r in (jreq, treq):
        r.Start()
        r.Wait()
    np.testing.assert_allclose(_np(treq.result),
                               np.stack([_ranked(1).sum(0)] * W))


DONATE_VERBS = ["allreduce", "reduce", "bcast", "scan", "exscan",
                "alltoall", "allgather", "reduce_scatter"]


@pytest.mark.parametrize("verb", DONATE_VERBS)
def test_donation_follows_jax_on_the_cpu(worlds, jax_persist, mca, verb):
    """Where JAX deletes the donated operand (an output of its shape and
    dtype), the port's result lives in the operand's storage; where JAX
    keeps it (allgather, reduce_scatter), the port leaves it untouched."""
    jax_persist("donate", 1)
    mca.port("coll_persist", "donate", 1)
    make = _blocks if verb in ("alltoall", "reduce_scatter") else _ranked
    jc, tc = worlds
    jreq = getattr(jc, verb + "_init")(jc.shard(make(0)))
    treq = getattr(tc, verb + "_init")(tc.shard(make(0)))
    jfresh, tfresh = jc.shard(make(2)), tc.shard(make(2))
    jreq.Start(jfresh)
    jreq.Wait()
    treq.Start(tfresh)
    treq.Wait()
    sums = verb in ("allreduce", "reduce", "reduce_scatter")
    same(treq.result, jreq.result, sum_of=make(2) if sums else None)
    consumed = treq.result.data_ptr() == tfresh.data_ptr()
    assert consumed == jfresh.is_deleted()
    if not consumed:
        np.testing.assert_array_equal(tfresh.numpy(), make(2))


def test_pair_ops_keep_the_per_start_verb(worlds):
    pairs = np.stack([np.stack([np.arange(3) % 2 + r % 3,
                                np.full(3, r)], -1) for r in range(W)]
                     ).astype(np.float32)
    out = []
    for c in worlds:
        req = c.allreduce_init(c.shard(pairs), _op(c, "MINLOC"))
        assert not req._frozen
        req.Start()
        req.Wait()
        out.append(req.result)
    same(out[1], out[0])
    tc = worlds[1]
    req = tc.allreduce_init(tc.shard(pairs), top.MAXLOC)
    with pytest.raises(MPIError):  # the pair contract, checked at Start
        req.Start(tc.shard(_ranked()))


def test_start_on_a_revoked_comm_raises(worlds):
    d = worlds[1].Dup()
    req = d.allreduce_init(d.shard(_ranked()))
    d.Revoke()
    with pytest.raises(MPIError) as e:
        req.Start()
    assert e.value.code == ERR_REVOKED and not req._active


def test_a_failed_start_leaves_the_request_as_it_was(worlds):
    tc = worlds[1]
    req = tc.alltoall_init(tc.shard(_blocks()))
    req.Start()
    req.Wait()
    before = req.result
    with pytest.raises(MPIError) as e:
        req.Start(tc.shard(_ranked()))  # not [W, G, ...]
    assert e.value.code == ERR_ARG
    assert not req._active and req.result is before and req.is_complete
    req.Start()  # the init operand is still bound
    req.Wait()
    np.testing.assert_array_equal(req.result.numpy(),
                                  _blocks().transpose(1, 0, 2))


# ---------------------------------------- tests/test_mesh_partitioned.py
def _buf(parts=4, seg=2, k=3):
    return np.arange(W * parts * seg * k, dtype=np.float32).reshape(
        W, parts * seg, k)


def test_out_of_order_pready_and_wait(worlds):
    x = _buf()
    perm = tuple((i, (i + 1) % W) for i in range(W))  # ring shift
    out = []
    for c in worlds:
        req = c.Psend_init(c.shard(x), perm, 4)
        for p in (2, 0, 3, 1):  # any ready order
            req.Pready(p)
        out.append(req.Wait())
        assert req.Test()
    got = same(out[1], out[0])
    assert got.shape == x.shape
    np.testing.assert_array_equal(got, np.roll(x, 1, axis=0))


def test_parrived_and_restart(worlds):
    x = _buf()
    perm = tuple((i, (i - 1) % W) for i in range(W))
    outs = []
    for c in worlds:
        req = c.Precv_init(c.shard(x), perm, 4)
        assert not req.Parrived(0)
        req.Pready(1)
        req.Pready_range(2, 3)
        assert req.Parrived(2) and not req.Test()
        with pytest.raises(Exception) as e:
            req.Wait()  # partition 0 never readied
        assert "MPIError" in type(e.value).__name__
        req.Pready(0)
        out1 = req.Wait()
        req.Start()  # persistent: re-arm, the same schedule again
        assert not req.Parrived(2)
        for p in range(4):
            req.Pready(p)
        out2 = req.Wait()
        np.testing.assert_array_equal(_np(out1), _np(out2))
        outs.append(out2)
    same(outs[1], outs[0])


def test_validation(worlds):
    x = _buf()
    perm = ((0, 1), (1, 0))
    for c in worlds:
        with pytest.raises(Exception) as e:
            c.Psend_init(c.shard(x), perm, 3)  # 8 % 3 != 0
        assert "MPIError" in type(e.value).__name__
        req = c.Psend_init(c.shard(x), perm, 4)
        req.Pready(1)
        for bad in (1, 9):  # double ready; out of range
            with pytest.raises(Exception) as e:
                req.Pready(bad)
            assert "MPIError" in type(e.value).__name__
    tc = worlds[1]
    req = tc.Psend_init(tc.shard(x), perm, 4)
    with pytest.raises(MPIError) as e:
        req.Wait()
    assert e.value.code == ERR_PENDING


@pytest.mark.parametrize("parts", [1, 2, 8])
def test_partitions_are_one_permute(worlds, parts):
    """Any partition count gives the one permute of the whole buffer; the
    segments are non-contiguous views of it."""
    x = _buf(parts=8, seg=1, k=5)
    perm = ((0, 3), (3, 5), (5, 0), (2, 7))  # rows 1, 2, 4, 6 get zeros
    out = []
    for c in worlds:
        req = c.Psend_init(c.shard(x), perm, parts)
        req.Pready_range(0, parts - 1)
        out.append(req.Wait())
    got = same(out[1], out[0])
    np.testing.assert_array_equal(
        got, worlds[1].permute(worlds[1].shard(x), perm).numpy())


# ----------------------------------------------------------- the requests
def test_request_waits_and_tests():
    pending, done = Request(), CompletedRequest(nbytes=8, source=3, tag=4)
    assert not pending.Test() and done.Test()
    st = Status()
    done.Wait(st)
    assert (st.Get_source(), st.Get_tag(), st._nbytes) == (3, 4, 8)
    with pytest.raises(MPIError) as e:
        pending.Wait(timeout=0.01)
    assert e.value.code == ERR_PENDING
    assert Request.Testany([pending, done]) == (1, True)
    assert Request.Testany([pending]) == (-1, False)
    assert not Request.Testall([pending, done]) and Request.Testall([done])
    assert Request.Waitany([pending, done]) == 1 and Request.Waitany([]) == -1
    assert Request.Waitsome([pending, done]) == [1]
    seen = []
    pending.add_completion_callback(seen.append)
    assert not seen
    pending._set_complete(0)
    assert seen == [pending]
    done.add_completion_callback(seen.append)  # fires at once
    assert seen == [pending, done]


def test_waitsome_finishes_every_done_request_before_raising():
    bad, good = Request(), Request()
    bad._set_complete(ERR_ARG)
    good._set_complete(0)
    with pytest.raises(MPIError) as e:
        Request.Waitsome([bad, good])
    assert e.value.code == ERR_ARG
    assert Request.Waitsome([bad, good]) == [0, 1]  # raised once only


def test_device_request_on_the_cpu_is_complete_when_returned(worlds):
    req = worlds[1].iallreduce(worlds[1].shard(_ranked()))
    assert isinstance(req, DeviceRequest)
    assert req._event is None and req.is_complete
    req.Wait(timeout=0.01)
    assert req.Test()


# ----------------------------------------- the persist variables and pvars
from ompi_tpu.runtime import spc as jspc  # noqa: E402
from ompi_tpu_torch.mca.var import all_pvars as tall_pvars  # noqa: E402
from ompi_tpu_torch.runtime import spc as tspc  # noqa: E402
from ompi_tpu_torch.runtime import trace as ttrace  # noqa: E402


@pytest.mark.parametrize("name", ["enable", "donate"])
def test_persist_settings_are_vars(name):
    from ompi_tpu.mca.var import all_vars as jall_vars
    from ompi_tpu_torch.mca.var import all_vars as tall_vars

    t = tall_vars()["coll_persist_" + name]
    j = jall_vars()["coll_persist_" + name]
    assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    assert not hasattr(tpersist, name)  # no module attribute stands in


@pytest.mark.parametrize("enable", [1, 0])
def test_starts_count_their_verb_once_as_jax(worlds, jax_persist, mca,
                                             enable):
    """A Start records its verb once, frozen or not; the persist pvars read
    the counters."""
    jax_persist("enable", enable)
    mca.port("coll_persist", "enable", enable)
    jspc.reset()
    tspc.reset()
    plans = tall_pvars()["persist_plans"].value
    for c in worlds:
        req = c.reduce_scatter_init(c.shard(_blocks(0)))
        for k in (1, 2, 3):
            req.Start(c.shard(_blocks(k)))
            req.Wait()
    assert tspc.snapshot() == jspc.snapshot() == {"reduce_scatter_block": 4}
    pv = tall_pvars()
    assert pv["persist_plans"].value == plans + enable
    assert (pv["persist_starts"].value, pv["persist_replay_us"].value) == \
        (tpersist.starts, tpersist.replay_us)


def test_start_marks_the_replay_in_the_trace(worlds, mca):
    mca.port("trace", "enable", True)
    ttrace.reset()
    try:
        tc = worlds[1]
        req = tc.allreduce_init(tc.shard(_ranked()))
        req.Start()
        req.Wait()
        marks = [e for _, e in ttrace.snapshot() if e[0] == "i"]
    finally:
        ttrace.reset()
    assert [(e[2], e[4]) for e in marks] == [
        ("coll.persist.start", {"verb": "allreduce", "provider": "mesh"})]
