"""The port's MPI semantics sanitizer (``runtime/sanitizer.py``) against the
JAX package's, on the CPU.

The cases of ``tests/test_sanitizer.py`` that launch no ranks, on both
packages from the same inputs; the process-mode requests the reference
leaks through ``COMM_SELF.Irecv`` are ``pml/base`` receive requests here,
the same class the ob1 pml posts. Leak lists, their reports, signatures,
tracker verdicts, the system plane's replies and the violation counts are
equal.

The port's own cases: ``_buf_sig`` signs a tensor as the ndarray of the
same dtype and size (every dtype the port's datatype engine maps, bf16 as
``ml_dtypes`` names it); the request hooks are bound exactly while the
sanitizer is installed; a mesh-mode i-verb's ``DeviceRequest`` is tracked
until it completes.

Waiting for ob1 (A.14.5): the signatures recorded by real process-mode
collectives, the p2p checks inside ob1's delivery, and the two process-mode
runs (the send-send deadlock cycle and the rendezvous nack).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from ompi_tpu.core import datatype as jdt
from ompi_tpu.core import errors as jerr
from ompi_tpu.core import op as jop
from ompi_tpu.core import request as jreq
from ompi_tpu.mca import var as jvar
from ompi_tpu.pml import base as jbase
from ompi_tpu.runtime import sanitizer as J
from ompi_tpu_torch.core import datatype as tdt
from ompi_tpu_torch.core import errors as terr
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core import request as treq
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.pml import base as tbase
from ompi_tpu_torch.runtime import sanitizer as T

PKGS = {"port": (T, tvar, tbase, tdt, terr, treq),
        "jax": (J, jvar, jbase, jdt, jerr, jreq)}


@pytest.fixture
def san():
    """Both sanitizers enabled at level 1, fully reset around the test."""
    for m in (T, J):
        m.reset_for_testing()
        m.enable(level=1)
    try:
        yield
    finally:
        for m, v, *_ in PKGS.values():
            m.disable()
            v.set_var("sanitizer", "level", 1)


def _recv(pkg, src=0, tag=4242, nelem=4, dt="FLOAT32"):
    _, _, base, dtm, _, _ = PKGS[pkg]
    return base.RecvRequest(np.zeros(nelem, np.float32), nelem,
                            getattr(dtm, dt), src, tag, 0)


# ---------------------------------------------------------- gating basics
def test_cvars_and_pvar_registered():
    for name in ("sanitizer_enable", "sanitizer_level",
                 "sanitizer_deadlock_timeout"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    assert tvar.all_vars()["sanitizer_enable"].default is False
    assert "sanitizer_violations" in tvar.all_pvars()
    assert T.SAN_TAG == J.SAN_TAG == -4400
    assert terr.ERR_SANITIZER == jerr.ERR_SANITIZER
    assert terr.Error_string(terr.ERR_SANITIZER) == \
        jerr.Error_string(jerr.ERR_SANITIZER)


def test_disabled_by_default_and_hooks_unbound():
    assert tvar.get_var("sanitizer", "enable") is False
    assert not T._installed
    assert treq._san_new is None and treq._san_done is None
    assert treq._san_wait is None


def test_install_binds_and_uninstall_unbinds_the_request_hooks():
    T.install()
    try:
        assert (treq._san_new, treq._san_done, treq._san_wait) == \
            (T._track_new, T._track_done, T.wait_watch)
        T.install()  # idempotent
    finally:
        T.uninstall()
    assert treq._san_new is None and treq._san_wait is None


def test_info_cli_lists_sanitizer_vars(capsys):
    from ompi_tpu_torch.tools.info import main as info_main

    info_main(["--param", "sanitizer", "--pvars"])
    out = capsys.readouterr().out
    assert "sanitizer_enable" in out and "sanitizer_violations" in out


# ----------------------------------------------------------- request leaks
def test_leaked_request_detected_and_counted(san, capfd):
    out = {}
    for pkg in PKGS:
        m = PKGS[pkg][0]
        req = _recv(pkg)
        leaks = [r for r, _bt in m.check_leaks()]
        assert req in leaks
        report = m._describe_request(req, None)
        m._finalize_check()
        counts = m.violation_counts()
        req._set_complete(0)
        out[pkg] = (len(leaks), report, counts,
                    req in [r for r, _ in m.check_leaks()])
    assert out["port"] == out["jax"]
    assert out["port"][2] == {"request-leak": 1} and not out["port"][3]
    assert "recv from rank 0, tag 4242" in out["port"][1]
    assert capfd.readouterr().err.count("never completed") == 2


def test_send_request_report(san):
    reports = [m._describe_request(base.SendRequest(3, 9, 0, 64), None)
               for m, _, base, *_ in PKGS.values()]
    assert reports[0] == reports[1] == \
        "  - SendRequest (send to rank 3, tag 9): never completed"


def test_leak_backtrace_captured_at_level2(san):
    for pkg in PKGS:
        m, v = PKGS[pkg][:2]
        v.set_var("sanitizer", "level", 2)
        req = _recv(pkg, tag=4243)
        leaks = dict((id(r), bt) for r, bt in m.check_leaks())
        assert "test_torch_sanitizer" in (leaks[id(req)] or "")
        assert "allocated at:" in m._describe_request(req, leaks[id(req)])
        req._set_complete(0)


def test_finalize_leak_check_reports_without_raising(san):
    for pkg in PKGS:
        m, v = PKGS[pkg][:2]
        v.set_var("sanitizer", "level", 2)
        reqs = [_recv(pkg, tag=t) for t in range(20)]
        m._finalize_check()  # must not raise, even at level 2
        assert m.violation_counts() == {"request-leak": 1}
        for r in reqs:
            r._set_complete(0)


def test_persistent_and_completed_requests_are_not_leaks(san):
    from ompi_tpu_torch.parallel.mesh import mesh_world

    for pkg in PKGS:
        m = PKGS[pkg][0]
        done = _recv(pkg, tag=7)
        done._set_complete(0)
        persistent = _recv(pkg, tag=8)
        persistent.persistent = True
        assert m.check_leaks() == []
        persistent._set_complete(0)
    w = mesh_world(4, "cpu")
    x = w.shard(np.ones((4, 3), np.float32))
    req = w.iallreduce(x)  # on the CPU: complete when the verb returns
    init = w.allreduce_init(x)  # persistent: long-lived by design
    assert id(req) in T._tracked and id(init) in T._tracked
    assert T.check_leaks() == []
    req.Wait()
    assert id(req) not in T._tracked


def test_a_pending_device_request_is_named_with_its_backtrace(san):
    """The check phase 4k makes on the card: a ``DeviceRequest`` whose
    event has not completed is a leak until its Wait."""
    from ompi_tpu_torch.coll.sched import DeviceRequest

    class _Pending:
        done = False

        def query(self):
            return self.done

        def synchronize(self):
            self.done = True

    tvar.set_var("sanitizer", "level", 2)
    waited = DeviceRequest(torch.zeros(2))
    pending = DeviceRequest(torch.zeros(2))
    ev = pending._event = _Pending()
    waited.Wait()
    leaks = T.check_leaks()
    assert [r for r, _ in leaks] == [pending]
    assert "test_torch_sanitizer" in leaks[0][1]
    pending.Wait()
    assert ev.done and T.check_leaks() == []


# ----------------------------------------------------- collective ordering
SEQS = [
    [(0, "bcast(float32x4, 0)"), (1, "bcast(float32x4, 0)"),
     (0, "reduce(float32x8)"), (1, "allreduce(float32x8)"),
     (1, "bcast(x)"), (2, "reduce(float32x8)"), (2, "gather(_)")],
    [(0, "bcast(a)"), (0, "reduce(b)"), (1, "bcast(a)"), (1, "reduce(b)")],
    [(r, f"allreduce(int64x{i})") for i in range(5) for r in range(3)],
]


@pytest.mark.parametrize("seq", SEQS)
def test_coll_tracker_verdicts_equal(seq):
    def run(m):
        t = m.CollTracker()
        return [t.record(9, r, sig) for r, sig in seq]

    assert run(T) == run(J)
    if seq is SEQS[0]:
        assert run(T)[3] == (1, 0, "reduce(float32x8)")


def test_coll_tracker_prunes_beyond_its_window(monkeypatch):
    for m in (T, J):
        monkeypatch.setattr(m.CollTracker, "window", 4)
    out = []
    for m in (T, J):
        t = m.CollTracker()
        for i in range(10):
            t.record(3, 0, f"s{i}")
        out.append(sorted(t._ref))
    assert out[0] == out[1] == [(3, i) for i in range(6, 10)]


def test_root_verdict_poisons_divergent_rank(san):
    for pkg in PKGS:
        m, v, _, _, err, _ = PKGS[pkg]
        v.set_var("sanitizer", "level", 2)
        with m._lock:
            m._poisoned[881] = "  collective #3: seeded divergence"
        comm = SimpleNamespace(cid=881, rank=1, name="fake", pml=None)
        with pytest.raises(err.MPIError) as ei:
            m.on_collective(comm, "bcast", "bcast(float32x4, 0)")
        assert ei.value.code == err.ERR_SANITIZER
        m.on_collective(comm, "bcast", "bcast(float32x4, 0)")


def test_on_collective_raises_at_level2(san):
    for pkg in PKGS:
        m, v, _, _, err, _ = PKGS[pkg]
        v.set_var("sanitizer", "level", 2)
        r0 = SimpleNamespace(cid=991, rank=0, name="fake", pml=None)
        r1 = SimpleNamespace(cid=991, rank=1, name="fake", pml=None)
        m.on_collective(r0, "bcast", "bcast(float32x4, 0)")
        m.on_collective(r1, "bcast", "bcast(float32x4, 0)")
        m.on_collective(r0, "reduce", "reduce(float32x4)")
        with pytest.raises(err.MPIError) as ei:
            m.on_collective(r1, "bcast", "bcast(float32x4, 0)")
        assert ei.value.code == err.ERR_SANITIZER
        assert m.violation_counts() == {"coll-order": 1}


def test_library_internal_collectives_are_not_recorded(san):
    from ompi_tpu_torch.runtime import spc

    comm = SimpleNamespace(cid=5, rank=0, name="fake", pml=None, size=2)
    with spc.suppressed():
        T.on_collective(comm, "allreduce", "allreduce(x)")
    assert T._tracker._next == {}


def test_wrap_coll_records_the_signature_of_a_mesh_verb(san):
    from ompi_tpu_torch.parallel.mesh import mesh_world

    w = mesh_world(2, "cpu")
    x = w.shard(np.ones((2, 3), np.float32))
    checked = T.wrap_coll(w, "allreduce",
                          lambda self, a, op=None: w.allreduce(a))
    out = checked(w, x)
    assert float(out[0, 0]) == 2.0
    assert T._tracker._ref[(w.cid, 0)] == (0, "allreduce(float32x6)")


def _arrays(lib):
    """The same buffers as ndarrays (lib ``np``) or CPU tensors."""
    a = np.arange(6, dtype=np.int64).reshape(2, 3)
    b = np.zeros(4, np.float32)
    if lib == "torch":
        return torch.from_numpy(a), torch.from_numpy(b)
    return a, b


def _arg_sets(a, b, op, dt):
    return [
        ("allreduce", (a, a, op)),
        ("iallreduce", (b, b, op)),
        ("bcast", ([a, 6, dt], 0)),
        ("gather", (b, a, 1)),
        ("allgatherv", (b, a, [1, 2, 3], [0, 1, 3])),
        ("alltoall", ((b, a), None, "x", 2.5, b"abcd", bytearray(3))),
        ("scan", (memoryview(b"xy"), object())),
        ("reduce", (a, b, op, 0)),
        ("barrier", ()),
    ]


@pytest.mark.parametrize("i", range(9))
@pytest.mark.parametrize("lib", ["np", "torch"])
def test_signatures_equal(i, lib):
    ta, tb = _arrays(lib)
    ja, jb = _arrays("np")
    verb, targs = _arg_sets(ta, tb, top.MAX, tdt.INT64)[i]
    _, jargs = _arg_sets(ja, jb, jop.MAX, jdt.INT64)[i]
    tsig = T._signature(verb, targs)
    jsig = J._signature(verb, jargs)
    assert tsig == jsig
    if verb == "allreduce":
        assert tsig == "allreduce(int64x6, int64x6, MPI_MAX)"
    if verb == "gather":
        assert tsig == "gather(_, _, 1)"


@pytest.mark.parametrize("dtype", sorted(tdt._BY_TORCH, key=str), ids=str)
@pytest.mark.parametrize("shape", [(1024,), (2, 3, 4), (0,), ()])
def test_buf_sig_signs_a_tensor_as_its_ndarray(dtype, shape):
    import ml_dtypes

    t = torch.zeros(shape, dtype=dtype)
    name = str(dtype).removeprefix("torch.")
    npdt = ml_dtypes.bfloat16 if dtype == torch.bfloat16 else np.dtype(name)
    a = np.zeros(shape, npdt)
    assert T._buf_sig(t) == J._buf_sig(a) == T._buf_sig(a)
    if shape == (1024,) and dtype == torch.float32:
        assert T._buf_sig(t) == "float32x1024"
    if dtype == torch.bfloat16:
        assert T._buf_sig(t).startswith("bfloat16x")


def test_deadlock_kill_is_scoped_to_cycle_members(san):
    for pkg in PKGS:
        m, v, _, _, err, req = PKGS[pkg]
        v.set_var("sanitizer", "level", 2)
        fake_pml = SimpleNamespace(my_rank=0)
        in_cycle, outside = req.Request(), req.Request()
        w1 = m._WaitWatch(in_cycle, 1, fake_pml, 10.0)
        w2 = m._WaitWatch(outside, 2, fake_pml, 10.0)
        with m._lock:
            m._blocked[id(w1)] = w1
            m._blocked[id(w2)] = w2
        try:
            m._deadlock_detected(None, [0, 1, 0])
            m._deadlock_detected(None, [1, 0, 1])  # the same episode
            assert in_cycle._complete.is_set()
            assert in_cycle._error == err.ERR_SANITIZER
            assert not outside._complete.is_set()
            assert m.violation_counts() == {"deadlock": 1}
        finally:
            w1.close()
            w2.close()
            outside._set_complete(0)


def test_wait_watch_needs_a_peer_and_a_world(san):
    for pkg in PKGS:
        m, _, base = PKGS[pkg][:3]
        assert m.wait_watch(SimpleNamespace()) is None  # no single peer
        assert m.wait_watch(SimpleNamespace(src=-1)) is None  # ANY_SOURCE


class _SysPml:
    my_rank = 0

    def __init__(self):
        self.sent = []
        self._pending_sends = {}

    def register_system_handler(self, tag, fn):
        pass

    def isend(self, buf, count, dt, dst, tag, cid, qos=None):
        self.sent.append((dst, tag, json.loads(bytes(buf))))


def _system_plane(pkg, monkeypatch):
    m, _, base, _, err, req = PKGS[pkg]
    pml = _SysPml()
    monkeypatch.setattr(base, "world_pml", lambda: pml)
    w = m._WaitWatch(req.Request(), 1, pml, 10.0)
    with m._lock:
        m._blocked[id(w)] = w
    sreq = base.SendRequest(3, 1, 0, 64)
    pml._pending_sends[55] = sreq
    msgs = [{"k": "probe", "init": 2, "wid": 7, "path": [2]},
            {"k": "probe", "init": 0, "wid": 1, "path": [0, 1]},
            {"k": "probe", "init": 3, "wid": 1, "path": [3, 0]},
            {"k": "coll", "cid": 4, "rank": 0, "wrank": 0, "sig": "bcast(a)"},
            {"k": "coll", "cid": 4, "rank": 1, "wrank": 5, "sig": "reduce(b)"},
            {"k": "coll-poison", "cid": 4, "detail": "seeded"},
            {"k": "p2p-nack", "msgid": 55},
            {"k": "nope"}]
    for msg in msgs:
        m._on_system(None, json.dumps(msg).encode())
    m._on_system(None, b"not json")
    w.close()
    return (pml.sent, m.violation_counts(), dict(m._poisoned),
            sreq._error, 55 in pml._pending_sends)


def test_system_plane_handler_replies_equal(san, monkeypatch):
    t = _system_plane("port", monkeypatch)
    j = _system_plane("jax", monkeypatch)
    assert t == j
    sent, counts, poisoned, err, pending = t
    assert [(d, s["k"]) for d, _, s in sent] == [(1, "probe"),
                                                 (5, "coll-poison")]
    assert counts == {"coll-order": 1} and poisoned == {4: "seeded"}
    assert err == terr.ERR_SANITIZER and not pending


def test_world_handler_binds_nothing_before_process_mode(san):
    T._bind_world_handler()
    assert T._plane._pml_ref is None


# ----------------------------------------------------- p2p dtype mismatch
def _p2p(pkg, nbytes, level, kind="EAGER", msgid=0):
    m, v, base, dtm, err, _ = PKGS[pkg]
    v.set_var("sanitizer", "level", level)
    pml = _SysPml()
    req = _recv(pkg, nelem=2)
    hdr = base.Header(base.pack_header(getattr(base, kind), 3, 0, 7, 1,
                                       nbytes, 0, msgid))
    ok = m.check_p2p(req, hdr, pml)
    return (ok, req.is_complete, req._error, m.violation_counts(),
            pml.sent)


@pytest.mark.parametrize("nbytes,level,kind", [
    (3, 1, "EAGER"), (7, 2, "EAGER"), (8, 1, "EAGER"), (16, 2, "EAGER"),
    (6, 2, "RNDV_RTS"), (0, 2, "EAGER")])
def test_p2p_mismatch(san, nbytes, level, kind):
    t = _p2p("port", nbytes, level, kind, msgid=9)
    j = _p2p("jax", nbytes, level, kind, msgid=9)
    assert t == j
    if nbytes % 4:
        assert t[3] == {"p2p-mismatch": 1}
        assert t[0] == (level < 2)
        if kind == "RNDV_RTS":
            assert t[4] == [(3, T.SAN_TAG, {"k": "p2p-nack", "msgid": 9})]
    else:
        assert t[:4] == (True, False, 0, {})


def test_violation_fires_mpit_event(san):
    from ompi_tpu_torch import mpit

    mpit.init_thread()
    seen = []
    try:
        h = mpit.event_handle_alloc(
            mpit.event_get_index("sanitizer_violation"),
            lambda inst: seen.append(inst.data))
        with pytest.raises(terr.MPIError):
            T._violation("p2p-mismatch", "unit-seeded", fatal=True)
        h.free()
    finally:
        mpit.finalize()
    assert seen == [{"kind": "p2p-mismatch", "detail": "unit-seeded"}]
    assert tvar.all_pvars()["sanitizer_violations"].value == 1
