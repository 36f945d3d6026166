"""The port's stall forensics (``runtime/forensics.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_forensics.py`` that launch no ranks and need no
ob1, tcp btl, era or ``mpidiag``, on both packages from the same inputs.
Pending work is a registered pending probe (the role ob1's queues play in
the reference): the sentinel latches, dumps and re-arms alike in both; the
dump documents hold the same keys and providers' states; rate limits,
triggers and the completion tick agree. Thresholds are the reference's own,
set through the cvars, with its timeouts: no case asserts a speed.

The port's own cases: ``runtime.progress`` is a provider;
``core/request.py``'s ``_fx_note`` is bound exactly while
``forensics_enable`` is set; a mesh-mode i-verb's request ticks the
completion counter when it completes.

With the tcp btl (A.14.4), on both packages: the legacy wire paths stamp
the rx/tx evidence of the ``btl.tcp`` provider, whose dump clamps a torn
rx span; the live transport is that provider and its degraded-link
rollup is the ``btl.tcp.link`` pending probe.

Waiting for ob1 (A.14.5): every case that posts a process-mode Irecv, the
ob1 and sched/era providers' clipping, the watchdog dump and the two
process-mode proofs; for the tools (A.14.10): ``mpidiag`` and ``mpitop``'s
stall column.
"""

import json
import os
import time

import numpy as np
import pytest

import ompi_tpu.ft.detector  # noqa: F401 registers the ft.detector provider
import ompi_tpu_torch.ft.detector  # noqa: F401 (as above)
from ompi_tpu.core import request as jreq
from ompi_tpu.mca import var as jvar
from ompi_tpu.runtime import forensics as J
from ompi_tpu.runtime import progress as jprog
from ompi_tpu_torch.core import request as treq
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.runtime import forensics as T
from ompi_tpu_torch.runtime import progress as tprog
from tests.test_torch_btl_fixture import (  # noqa: F401 fixtures
    P, btl_clean)
from tests.test_torch_mca_fixture import mca_watched  # noqa: F401 fixture

PKGS = {"port": (T, tvar, tprog, treq), "jax": (J, jvar, jprog, jreq)}


@pytest.fixture(autouse=True)
def clean():
    for m in (T, J):
        m.reset_for_testing()
    yield
    for m, v, prog, _ in PKGS.values():
        v.set_var("forensics", "enable", False)
        with m._lock:
            for name in [n for n in m._providers if n.startswith("test.")]:
                del m._providers[name]
            for name in [n for n in m._pending_probes
                         if n.startswith("test.")]:
                del m._pending_probes[name]
        m.reset_for_testing()


# -------------------------------------------------- introspection contract
def test_port_providers_and_their_state_keys():
    state = T.debug_state()
    json.dumps(state)
    assert {"runtime.progress", "ft.detector"} <= set(state)
    jstate = J.debug_state()
    assert sorted(state["runtime.progress"]) == \
        sorted(jstate["runtime.progress"])
    # the detector's keys grow with its state (a heartbeat, link events),
    # which earlier tests in this process may have left in either package
    assert "known_failed" in state["ft.detector"]
    assert "known_failed" in jstate["ft.detector"]


def test_runtime_progress_is_the_registered_provider():
    assert T._providers["runtime.progress"] is tprog._fx_debug_state


@pytest.mark.parametrize("kind", ["broken", "rebind", "none"])
def test_provider_edge_cases(kind):
    out = []
    for m in (T, J):
        if kind == "broken":
            m.register_provider("test.x", lambda: 1 / 0)
        elif kind == "rebind":
            m.register_provider("test.x", lambda: {"v": 1})
            m.register_provider("test.x", lambda: {"v": 2})
        else:
            m.register_provider("test.x", lambda: None)
        out.append(m.debug_state().get("test.x"))
    assert out[0] == out[1]
    assert out[0] == {"broken": {"error": "ZeroDivisionError: division by "
                                          "zero"},
                      "rebind": {"v": 2}, "none": None}[kind]


def test_weak_provider_reads_absent_once_collected_or_dead():
    class Sub:
        alive = True

        def debug_state(self):
            return {"n": 3}

    for m in (T, J):
        o = Sub()
        m.register_weak_provider("test.weak", o, alive=lambda s: s.alive)
        assert m.debug_state()["test.weak"] == {"n": 3}
        o.alive = False
        assert "test.weak" not in m.debug_state()
        o.alive = True
        del o
        assert "test.weak" not in m.debug_state()


@pytest.mark.parametrize("make", [
    lambda: list(range(200)), lambda: [], lambda: iter(range(200)),
    lambda: {i: i for i in range(70)}, lambda: "abc"],
    ids=["list", "empty", "iterator", "dict", "str"])
def test_clip_bounds(make):
    t, j = T.clip(make()), J.clip(make())
    assert t == j and len(t) <= T.CAP == J.CAP
    assert t == list(make())[:T.CAP]


def test_pending_readings_guard_each_probe():
    for m in (T, J):
        m.register_pending_probe("test.ok", lambda: 3)
        m.register_pending_probe("test.sick", lambda: 1 / 0)
    t = {k: v for k, v in T._pending_readings().items()
         if k.startswith("test.")}
    j = {k: v for k, v in J._pending_readings().items()
         if k.startswith("test.")}
    assert t == j == {"test.ok": 3, "test.sick": "error: ZeroDivisionError: "
                                                "division by zero"}


# ----------------------------------------------------------- the sentinel
def _latch(pkg, tmp_path, mca_watched, thresh_ms):
    m, v, prog, _ = PKGS[pkg]
    d = tmp_path / pkg
    d.mkdir()
    getattr(mca_watched, pkg)("metrics", "dir", str(d))
    getattr(mca_watched, pkg)("forensics", "stall_threshold_ms", thresh_ms)
    getattr(mca_watched, pkg)("forensics", "enable", True)
    m.arm_sentinel()
    trips0 = m._trips[0]
    pending = [1]
    m.register_pending_probe("test.pending", lambda: pending[0])
    assert prog.progress_until(lambda: m._sentinel.latched, timeout=8.0)
    latched = (m._trips[0] - trips0,
               int(v.all_pvars()["forensics_stall_latched"].value))
    doc = json.loads((d / "stall-rank0.json").read_text())
    # a completion re-arms the latch
    m.note_completion()
    pending[0] = 0
    assert prog.progress_until(lambda: not m._sentinel.latched, timeout=8.0)
    return latched, doc, int(v.all_pvars()["forensics_stall_latched"].value)


def test_sentinel_latches_dumps_and_rearms(tmp_path, mca_watched):
    t = _latch("port", tmp_path, mca_watched, 60.0)
    j = _latch("jax", tmp_path, mca_watched, 60.0)
    assert t[0] == j[0] == (1, 1)
    assert t[2] == j[2] == 0
    tdoc, jdoc = t[1], j[1]
    assert sorted(tdoc) == sorted(jdoc)
    assert "stall-sentinel" in tdoc["reason"]
    assert tdoc["stall"]["latched"] and jdoc["stall"]["latched"]
    assert sorted(tdoc["stall"]) == sorted(jdoc["stall"])
    assert tdoc["pending"]["test.pending"] == jdoc["pending"]["test.pending"]
    assert "runtime.progress" in tdoc["subsystems"]


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_sentinel_idle_is_not_a_stall(pkg, tmp_path, mca_watched):
    m, _, prog, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    getattr(mca_watched, pkg)("forensics", "stall_threshold_ms", 40.0)
    getattr(mca_watched, pkg)("forensics", "enable", True)
    m.arm_sentinel()
    m.register_pending_probe("test.pending", lambda: 0)
    trips0 = m._trips[0]
    deadline = time.monotonic() + 0.5
    while time.monotonic() < deadline:
        prog.progress_until(lambda: False, timeout=0.05)
    assert m._trips[0] == trips0
    assert not m._sentinel.latched


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_undriven_poll_gap_is_idle_not_stall(pkg, tmp_path, mca_watched):
    m, _, prog, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    getattr(mca_watched, pkg)("forensics", "stall_threshold_ms", 400.0)
    getattr(mca_watched, pkg)("forensics", "enable", True)
    m.arm_sentinel()
    trips0 = m._trips[0]
    s = m._sentinel
    pending = [0]
    m.register_pending_probe("test.pending", lambda: pending[0])
    s.poll()
    with s._slock:
        s._last_change -= 10.0
        s._last_poll -= 10.0
        s._next_probe = 0.0
    pending[0] = 1
    s.poll()  # the first poll after the gap: idle, not a latch
    assert not s.latched and m._trips[0] == trips0
    assert prog.progress_until(lambda: s.latched, timeout=8.0)


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_completion_during_pending_probe_blocks_the_latch(
        pkg, tmp_path, mca_watched, monkeypatch):
    m, _, _, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    getattr(mca_watched, pkg)("forensics", "stall_threshold_ms", 40.0)
    getattr(mca_watched, pkg)("forensics", "enable", True)
    m.arm_sentinel()
    trips0 = m._trips[0]
    with m._sentinel._slock:
        m._sentinel._last_comp = m._completions[0]
        m._sentinel._last_change = time.monotonic() - 99.0
        m._sentinel._next_probe = 0.0
        m._sentinel._last_poll = 0.0
        m._sentinel.latched = False

    def pending_and_tick():
        m._completions[0] += 1  # a request completes mid-probe
        return True

    monkeypatch.setattr(m, "_work_pending", pending_and_tick)
    assert m._sentinel.poll() == 0
    assert not m._sentinel.latched and m._trips[0] == trips0
    monkeypatch.setattr(m, "_work_pending", lambda: True)
    assert m._sentinel.poll() == 0
    assert not m._sentinel.latched


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_runtime_cvar_flip_arms_the_whole_plane(pkg, mca_watched,
                                                monkeypatch):
    m, _, _, req = PKGS[pkg]
    getattr(mca_watched, pkg)("forensics", "enable", False)
    armed = []
    monkeypatch.setattr(m, "arm_sentinel", lambda: armed.append("s"))
    monkeypatch.setattr(m, "install_sigusr1", lambda: armed.append("sig"))
    assert req._fx_note is None
    getattr(mca_watched, pkg)("forensics", "enable", True)
    assert armed == ["s", "sig"]
    assert req._fx_note is m.note_completion
    getattr(mca_watched, pkg)("forensics", "enable", False)
    assert req._fx_note is None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_runtime_disable_clears_the_latch(pkg, tmp_path, mca_watched):
    m, v, _, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    getattr(mca_watched, pkg)("forensics", "enable", True)
    m.arm_sentinel()
    with m._sentinel._slock:
        m._sentinel.latched = True
        m._sentinel._last_comp = m._completions[0]
        m._sentinel._last_change = time.monotonic() - 99.0
    getattr(mca_watched, pkg)("forensics", "enable", False)
    assert not m._sentinel.latched
    assert int(v.all_pvars()["forensics_stall_latched"].value) == 0
    assert m._sentinel.age() == 0.0
    getattr(mca_watched, pkg)("forensics", "enable", True)
    assert m._sentinel.armed and not m._sentinel.latched
    assert m._sentinel.age() < 1.0


def test_fx_note_is_bound_only_while_the_plane_is_on(mca_watched):
    assert treq._fx_note is None
    mca_watched.port("forensics", "enable", True)
    assert treq._fx_note is T.note_completion
    mca_watched.restore()
    assert treq._fx_note is None


def test_a_mesh_iverb_request_ticks_the_completion_counter(mca_watched):
    """A mesh-mode i-verb's ``DeviceRequest`` completes through
    ``Request._set_complete``, so each Wait ticks the sentinel's counter
    once (the card does the same, phase 4k)."""
    from ompi_tpu_torch.parallel.mesh import mesh_world

    mca_watched.port("forensics", "enable", True)
    w = mesh_world(4, "cpu")
    x = w.shard(np.arange(8, dtype=np.float32).reshape(4, 2))
    base = T._completions[0]
    reqs = [w.iallreduce(x) for _ in range(3)]
    for r in reqs:
        r.Wait()
    assert T._completions[0] == base + 3
    assert float(reqs[0].result[0, 0]) == 12.0


# ----------------------------------------------------------------- dumps
def test_dump_state_verb_works_with_the_plane_disabled(tmp_path,
                                                       mca_watched):
    from ompi_tpu_torch.parallel.mesh import mesh_world

    mca_watched.port("metrics", "dir", str(tmp_path))
    assert not T.enabled()
    path = mesh_world(2, "cpu").Dump_state(reason="unit")
    assert path == str(tmp_path / "stall-rank0.json")
    doc = json.loads(open(path).read())
    assert doc["reason"] == "unit" and doc["schema"] == 1
    assert {"runtime.progress", "ft.detector"} <= set(doc["subsystems"])
    assert tvar.all_pvars()["forensics_dumps"].value == 1


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_dump_rate_limit(pkg, tmp_path, mca_watched):
    m, _, _, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    assert m.dump(reason="first") is not None
    assert m.dump(reason="second", min_interval=30.0) is None
    assert m.dump(reason="third") is not None  # unlimited path
    assert m._dumps[0] == m._dump_seq[0] == 2  # a limited call takes no seq


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_failed_dump_does_not_suppress_rate_limited_retry(
        pkg, tmp_path, mca_watched, monkeypatch):
    m, _, _, _ = PKGS[pkg]
    fsio = __import__({"port": "ompi_tpu_torch", "jax": "ompi_tpu"}[pkg]
                      + ".utils.fsio", fromlist=["x"])
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    real = fsio.atomic_write_json
    fail = [True]

    def flaky(path, doc, **kw):
        if fail[0]:
            raise OSError("disk full")
        return real(path, doc, **kw)

    monkeypatch.setattr(fsio, "atomic_write_json", flaky)
    assert m.dump(reason="failed", min_interval=30.0) is None
    fail[0] = False
    assert m.dump(reason="retry", min_interval=30.0) is not None
    doc = json.loads((tmp_path / "stall-rank0.json").read_text())
    assert doc["reason"] == "retry"
    assert m.dump(reason="third", min_interval=30.0) is None


@pytest.mark.parametrize("pkg", ["port", "jax"])
def test_trigger_requests_peers_even_when_local_dump_fails(
        pkg, tmp_path, mca_watched, monkeypatch):
    m, _, _, _ = PKGS[pkg]
    getattr(mca_watched, pkg)("metrics", "dir", str(tmp_path))
    asked = []
    monkeypatch.setattr(m, "_request_all_peer_dumps",
                        lambda reason: asked.append(reason))
    monkeypatch.setattr(m, "dump", lambda **kw: None)  # the write fails
    assert m.trigger("era-timeout: unit") is None
    assert asked == ["era-timeout: unit"]
    assert m.trigger("era-timeout: unit again") is None
    assert len(asked) == 1


def test_trigger_without_a_world_dumps_locally(tmp_path, mca_watched):
    mca_watched.port("metrics", "dir", str(tmp_path))
    assert T.trigger("unit") == str(tmp_path / "stall-rank0.json")
    assert T.trigger("unit again") is None  # the episode's rate limit


def test_peer_dump_handler_dumps_with_a_rate_limit(tmp_path, mca_watched):
    mca_watched.port("metrics", "dir", str(tmp_path))
    msg = json.dumps({"k": "dump_req", "reason": "stall", "from": 3})
    T._on_system(None, msg.encode())
    T._on_system(None, msg.encode())  # inside the rate limit
    T._on_system(None, b"not json")
    doc = json.loads((tmp_path / "stall-rank0.json").read_text())
    assert doc["reason"] == "peer-request: stall on rank 3"
    assert T._dumps[0] == 1


def test_request_peer_dumps_skips_self_and_dead_edges():
    class Pml:
        my_rank = 1

        def __init__(self):
            self.sent = []

        def register_system_handler(self, tag, fn):
            self.handler = (tag, fn)

        def isend(self, buf, count, dt, dst, tag, cid, qos=None):
            if dst == 2:
                raise OSError("down")
            self.sent.append((dst, tag, json.loads(bytes(buf))))

    out = []
    for m in (T, J):
        pml = Pml()
        m.request_peer_dumps(pml, [0, 1, 2, 3], "unit")
        out.append((pml.handler[0], pml.sent))
        m._plane.reset()
    assert out[0] == out[1]
    assert [d for d, _, _ in out[0][1]] == [0, 3]


def test_system_plane_completions_do_not_tick():
    class _Req:
        def __init__(self, tag):
            self.tag = tag

    for m in (T, J):
        base = m._completions[0]
        m.note_completion(_Req(-4243))   # heartbeat
        m.note_completion(_Req(-4244))   # era
        m.note_completion(_Req(m.FORENSICS_TAG))
        assert m._completions[0] == base
        m.note_completion(_Req(7))       # user traffic ticks
        m.note_completion(None)          # tagless ticks
        m.note_completion(treq.Request())  # a request with no tag
        assert m._completions[0] == base + 3


def test_stall_sampler_and_pvars(mca_watched):
    from ompi_tpu.runtime import metrics as JM
    from ompi_tpu_torch.runtime import metrics as TM

    for m in (T, J):
        m.register_stall_sampler()
    t = TM.snapshot()["samplers"]["forensics_stall"]
    j = JM.snapshot()["samplers"]["forensics_stall"]
    assert t == j == {"latched": 0, "age_s": 0.0, "trips": 0, "dumps": 0}
    for name in ("forensics_stall_trips", "forensics_dumps",
                 "forensics_stall_latched",
                 "forensics_last_completion_age_s"):
        assert name in tvar.all_pvars(), name


def test_atomic_write_json_cleans_up_failed_tmp(tmp_path):
    from ompi_tpu_torch.utils.fsio import atomic_write_json

    p = tmp_path / "out.json"
    assert atomic_write_json(str(p), {"a": 1}) == str(p)

    class Unserializable:
        pass

    with pytest.raises(TypeError):
        atomic_write_json(str(p), {"a": Unserializable()})
    assert json.loads(p.read_text()) == {"a": 1}
    assert os.listdir(tmp_path) == ["out.json"]


def test_cvars_registered_and_the_plane_is_off_by_default():
    for name in ("forensics_enable", "forensics_stall_threshold_ms"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    assert T.FORENSICS_TAG == J.FORENSICS_TAG == -4800


# ------------------------------------------------- the tcp btl's evidence

def test_legacy_wire_paths_stamp_rx_tx_evidence(P):
    P.set("forensics", "enable", True)
    P.set("btl_tcp", "copy_mode", 1)
    got = []
    a = P.tcp.TcpBtl(lambda h, p: got.append(bytes(p)), my_rank=0)
    b = P.tcp.TcpBtl(lambda h, p: got.append(bytes(p)), my_rank=1)
    try:
        a.set_peers({1: f"127.0.0.1:{b.port}"})
        b.set_peers({0: f"127.0.0.1:{a.port}"})
        hdr = P.pml.pack_header(1, 0, 0, 5, 1, 5, 0, 0)
        a.send(1, hdr, np.frombuffer(b"hello", np.uint8))
        deadline = time.monotonic() + 10
        while not got and time.monotonic() < deadline:
            a.progress()
            b.progress()
        assert got == [b"hello"]
        assert any(c["last_tx_age_s"] is not None
                   for c in a.debug_state()["conns"])
        assert any(c["last_rx_age_s"] is not None
                   for c in b.debug_state()["conns"])
        conn = next(iter(b.conns.values()))
        r0, r1 = conn.rstart, conn.rend
        conn.rstart, conn.rend = 5000, 100
        try:
            assert all(c["rx_partial_bytes"] >= 0
                       for c in b.debug_state()["conns"])
        finally:
            conn.rstart, conn.rend = r0, r1
    finally:
        a.finalize()
        b.finalize()


def test_the_live_tcp_btl_is_the_provider_and_probe(P):
    fx = P.forensics
    btl = P.tcp.TcpBtl(lambda h, p: None, my_rank=4)
    try:
        state = fx.debug_state()["btl.tcp"]
        json.dumps(state)
        assert state["rank"] == 4 and state["conns"] == []
        assert sorted(state) == sorted(btl.debug_state())
        assert fx._pending_probes["btl.tcp.link"]() == 0
    finally:
        btl.finalize()
    assert "btl.tcp" not in fx.debug_state()  # weakly bound: gone
