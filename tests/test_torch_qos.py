"""The port's QoS classes (``qos.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_qos.py`` that launch no ranks and need no tcp btl
or ob1 pml, on both packages from the same inputs: the header bits, the tag
map (default, rewritten, malformed), the recovery planes, the
per-communicator override with its derived planes and Dup inheritance,
``resolve`` and the pvars. Classes and the stamped counts are equal.

With the tcp btl (A.14.4), the shaped send path on both packages (the
``P`` fixture of ``tests/test_torch_btl_fixture.py``): a LATENCY frame
preempting queued BULK, the starvation bound, the unpreemptible partial
frame, the weighted-deficit ratio, a shape flip draining FIFO, gauges
settled by a failed conn, and the handshake's QoS capability. Over the same
fake socket the two packages put the same bytes on the wire.

Waiting for ob1 (A.14.5): segmentation and reassembly, per-class sequence
planes, the round engine's plane and the two process-mode runs; the
Prometheus cell of the shape sampler waits for the tools (A.14.10).
"""

import errno
import socket
import struct
import time

import pytest

from ompi_tpu import qos as jq
from ompi_tpu.comm import communicator as jcomm
from ompi_tpu.core.group import Group as JGroup
from ompi_tpu.mca import var as jvar
from ompi_tpu.pml import base as jbase
from ompi_tpu_torch import qos as tq
from ompi_tpu_torch.comm import communicator as tcomm
from ompi_tpu_torch.core.group import Group as TGroup
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.pml import base as tbase
from tests.test_torch_btl_fixture import (  # noqa: F401 fixtures
    P, btl_clean, load)
from tests.test_torch_mca_fixture import (  # noqa: F401 fixture
    VarSetter,
    mca_watched,
)

NBC_CID_BIT = 1 << 28
COLL_CID_BIT = 1 << 30
PART_CID_BIT = 1 << 29
RESPAWN_STATE_TAG = 4242
RESHARD_TAG = 4300

TAGS = [-4600, -4500, -4243, -4242, -4244, -4245, -4800, -4900, -4400,
        -4300, -4000, -3999, -1, 0, 5, 4242, 4243, 4244, 4300]
CIDS = [0, 7, 123, 7 | NBC_CID_BIT, 7 | COLL_CID_BIT, 7 | PART_CID_BIT]


@pytest.fixture(autouse=True)
def clean():
    jq.reset_for_testing()
    tq.reset_for_testing()
    yield
    jq.reset_for_testing()
    tq.reset_for_testing()


def _classify_all(mod):
    return [mod.classify(tag, cid) for tag in TAGS for cid in CIDS]


def _stamped(var):
    return {c: var.all_pvars()[f"qos_stamped_{c}"].value
            for c in ("normal", "latency", "bulk")}


def test_constants_agree():
    for name in ("NORMAL", "LATENCY", "BULK", "NAMES", "_SYSTEM_TAG_BASE",
                 "_PLANE_SHIFT", "_CID_MASK"):
        assert getattr(tq, name) == getattr(jq, name), name
    assert tq._SYSTEM_TAG_BASE == tbase.SYSTEM_TAG_BASE


@pytest.mark.parametrize("cls", [0, 1, 2])
def test_header_qos_bits_roundtrip(cls):
    raw = tbase.pack_header(tbase.EAGER, 3, 17, 7, 5, 10, 2, 9, qos=cls)
    assert raw == jbase.pack_header(jbase.EAGER, 3, 17, 7, 5, 10, 2, 9,
                                    qos=cls)
    h = tbase.Header(raw)
    assert (h.kind, h.qos) == (tbase.EAGER, cls)
    assert tbase.pack_header(tbase.EAGER, 1, 0, 0, 1, 0, 0, 0) == \
        tbase.pack_header(tbase.EAGER, 1, 0, 0, 1, 0, 0, 0, qos=0)


@pytest.mark.parametrize("tag_map", [
    None,  # the default map
    "-4600:bulk,-4500:bulk,-4242:latency,-4243:latency,-4244:latency,"
    "-4245:latency",  # the reference's test map
    "-4400:bulk",
    "4244:latency, -4500 : normal,,",
    "-4600:bulk,bogus,-4500:turbo,7:LATENCY",  # malformed entries skipped
    "",
])
def test_classify_grid_and_counters_equal(tag_map, mca_watched):
    if tag_map is not None:
        mca_watched.both("qos", "tag_map", tag_map)
    tq.reset_for_testing()
    jq.reset_for_testing()
    got = _classify_all(tq)
    assert got == _classify_all(jq)
    assert _stamped(tvar) == _stamped(jvar)
    assert sum(_stamped(tvar).values()) == len(got)
    if tag_map is None:
        assert tq.classify(-4600, 0) == tq.BULK      # diskless ckpt
        assert tq.classify(-4500, 0) == tq.BULK      # metrics shipping
        assert tq.classify(-4243, 0) == tq.LATENCY   # heartbeats
        assert tq.classify(-4400, 0) == tq.NORMAL    # unlisted system tag
        assert tq.classify(RESPAWN_STATE_TAG, 0) == tq.BULK
        assert tq.classify(RESHARD_TAG, 0) == tq.BULK
        assert tq.classify(-4800, 0) == tq.LATENCY   # forensics dumps
        assert tq.classify(-4900, 0) == tq.LATENCY   # link probes
        # positive-tag entries apply only on the plane-free user cid
        assert tq.classify(RESPAWN_STATE_TAG, 7 | NBC_CID_BIT) == tq.NORMAL


@pytest.mark.parametrize("tag_map", [
    "-4600:bulk,-4500:bulk,-4242:latency,-4243:latency,-4244:latency,"
    "-4245:latency", "-4400:bulk", ""])
def test_a_tag_map_case_leaves_the_jax_map_as_it_found_it(tag_map):
    """The classify grid's setting and its restore through the watchers:
    after it, the JAX package's map value and its cached class of the link
    probe tag (``tests/test_linkmodel.py::test_probe_tag_classifies_latency``
    reads it) are what they were before."""
    from ompi_tpu.runtime.linkmodel import LINKPROBE_TAG

    def state():
        return jvar.all_vars()["qos_tag_map"]._value, \
            jq._tag_class(LINKPROBE_TAG)

    before = state()
    setter = VarSetter(watched=True)
    try:
        setter.both("qos", "tag_map", tag_map)
        assert _classify_all(tq) == _classify_all(jq)
    finally:
        setter.restore()
    assert state() == before


def test_tag_map_cvar_rewrite_takes_effect(mca_watched):
    mca_watched.both("qos", "tag_map", "-4400:bulk")
    for mod in (tq, jq):
        assert mod.classify(-4400, 0) == mod.BULK
        assert mod.classify(-4600, 0) == mod.NORMAL  # replaced, not merged
    mca_watched.both("qos", "tag_map", "-4600:latency")
    assert tq.classify(-4600, 0) == jq.classify(-4600, 0) == tq.LATENCY


@pytest.mark.parametrize("cls", ["latency", "normal", "bulk", "LATENCY",
                                 0, 1, 2, "turbo", 7, -1, "3"])
def test_resolve(cls):
    try:
        want = jq.resolve(cls)
    except ValueError:
        with pytest.raises(ValueError):
            tq.resolve(cls)
        return
    assert tq.resolve(cls) == want


def _override_sequence(comm_mod, group_cls, mod):
    """The steps of the reference's override cases on one package; every
    classification is recorded."""
    out = []
    comm = comm_mod.Communicator(group_cls([0]), 611, name="qos-test")
    comm_mod._live_comms[611] = comm
    try:
        out.append(mod.classify(5, 611))
        comm.Set_qos_class("bulk")
        out.append(comm.Get_qos_class())
        out += [mod.classify(5, 611), mod.classify(5, 611 | NBC_CID_BIT),
                mod.classify(5, 611 | COLL_CID_BIT)]
        dup = comm_mod.Communicator(group_cls([0]), 612, name="qos-dup")
        comm._copy_attrs_to(dup)
        comm_mod._live_comms[612] = dup
        out.append(mod.classify(5, 612))
        comm.Set_qos_class("latency")
        out.append(mod.classify(5, 611))
        # a mapped recovery tag beats the comm's class
        out.append(mod.classify(RESPAWN_STATE_TAG, 611))
        comm.Delete_attr(mod.comm_keyval())
        out += [mod.classify(5, 611), mod.get_comm_class(comm),
                comm.Get_qos_class()]
    finally:
        comm_mod._live_comms.pop(611, None)
        comm_mod._live_comms.pop(612, None)
    return out


def test_comm_attr_override_and_derived_planes():
    got = _override_sequence(tcomm, TGroup, tq)
    assert got == _override_sequence(jcomm, JGroup, jq)
    assert got == [tq.NORMAL, "bulk", tq.BULK, tq.BULK, tq.BULK, tq.BULK,
                   tq.LATENCY, tq.BULK, tq.NORMAL, tq.NORMAL, "normal"]


def test_the_registry_is_empty_so_every_comm_classifies_normal():
    """Only a process-mode comm registers itself (``ProcComm.__init__``);
    until process mode is ported, a mesh-mode comm is never found and its
    traffic classifies NORMAL, as in the reference."""
    from ompi_tpu_torch.parallel.mesh import mesh_world

    w = mesh_world(2, "cpu")
    assert tcomm.lookup_comm(w.cid) is None
    assert len(tcomm._live_comms) == 0
    assert tq.classify(5, w.cid) == tq.NORMAL


def test_segment_and_reassembly_counters():
    for mod, var in ((tq, tvar), (jq, jvar)):
        mod.note_segments(4)
        mod.note_reassembled()
    for name in ("qos_segments", "qos_reassembled"):
        assert tvar.all_pvars()[name].value == \
            jvar.all_pvars()[name].value
    assert tvar.all_pvars()["qos_segments"].value == 4


def test_enabled_and_segment_bytes_follow_the_variables(mca_watched):
    assert tq.enabled() is jq.enabled() is False
    assert tq.segment_bytes() == jq.segment_bytes() == 262144
    mca_watched.both("btl_tcp", "shape_enable", 1)
    mca_watched.both("btl_tcp", "shape_segment_bytes", 4096)
    assert tq.enabled() is jq.enabled() is True
    assert tq.segment_bytes() == jq.segment_bytes() == 4096


def test_cvar_pvar_registration():
    for name in ("btl_tcp_shape_enable", "btl_tcp_shape_segment_bytes",
                 "qos_tag_map"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    for name in ("qos_stamped_normal", "qos_stamped_latency",
                 "qos_stamped_bulk", "qos_segments", "qos_reassembled"):
        assert name in tvar.all_pvars(), name


# ------------------------------------------------- the shaped tcp path

class _FakeSock:
    """Accepts ``budget`` bytes per flush window, then EAGAIN."""

    def __init__(self):
        self.wire = bytearray()
        self.budget = 0

    def sendmsg(self, vecs):
        take = min(self.budget, sum(len(v) for v in vecs))
        if take == 0:
            e = socket.error()
            e.errno = errno.EAGAIN
            raise e
        left = take
        for v in vecs:
            nb = min(len(v), left)
            self.wire += (bytes(v[:nb]) if isinstance(v, memoryview)
                          else bytes(v)[:nb])
            left -= nb
            if left == 0:
                break
        self.budget -= take
        return take

    def close(self):
        pass


def _wire_classes(P, wire: bytes):
    off = 0
    order = []
    while off < len(wire):
        total = struct.unpack_from("<I", wire, off)[0] & ((1 << 31) - 1)
        order.append(P.pml.Header(wire[off + 4:off + 4 + P.pml.HDR_SIZE]).qos)
        off += 4 + total
    return order


def _shaped_pair(P):
    btl = P.tcp.TcpBtl(lambda h, p: None, my_rank=0)
    conn = P.tcp._Conn(_FakeSock(), peer=1)
    conn.peer_q = True
    btl.conns[1] = conn
    btl.peers = {1: "x:0"}
    return btl, conn


def _frame(P, tag, seq, cls, payload):
    return (P.pml.pack_header(P.pml.EAGER, 0, 0, tag, seq, len(payload), 0,
                              0, qos=cls), payload)


def _pv(P, name):
    return P.var.all_pvars()[name].value


def _latency_preempts(P):
    P.set("btl_tcp", "shape_enable", 1)
    btl, conn = _shaped_pair(P)
    before = _pv(P, "btl_tcp_shape_preemptions")
    for i in range(5):
        btl.send(1, *_frame(P, 7, i + 1, P.qos.BULK, bytes(200)))
    assert _pv(P, "btl_tcp_shape_queued_bulk") > 0
    btl.send(1, *_frame(P, 8, 1, P.qos.LATENCY, b"URGENT"))
    with conn.wlock:
        conn.sock.budget = 10 ** 9
        btl._flush_shaped(conn)
    order = _wire_classes(P, bytes(conn.sock.wire))
    assert order[0] == P.qos.LATENCY and order[1:] == [P.qos.BULK] * 5
    assert _pv(P, "btl_tcp_shape_preemptions") > before
    assert _pv(P, "btl_tcp_shape_queued_bulk") == 0
    assert _pv(P, "btl_tcp_shape_queued_latency") == 0
    assert _pv(P, "btl_tcp_shape_peak_queued_bulk") > 0
    btl.finalize()
    return bytes(conn.sock.wire)


def test_latency_preempts_queued_bulk(P):
    _latency_preempts(P)


def test_the_shaped_wire_equals_the_references(btl_clean):
    """The same sends through the same fake socket put the same bytes on
    the wire in both packages."""
    wires = []
    for name, setter in (("jax", btl_clean.jax), ("torch", btl_clean.port)):
        M = load(name)
        M.set = setter
        wires.append(_latency_preempts(M))
    assert wires[0] == wires[1]


def test_starvation_bound_serves_bulk(P):
    P.set("btl_tcp", "shape_enable", 1)
    P.set("btl_tcp", "shape_max_defer_bytes", 2048)
    btl, conn = _shaped_pair(P)
    btl.send(1, *_frame(P, 7, 100, P.qos.BULK, bytes(300)))
    for i in range(40):
        btl.send(1, *_frame(P, 8, 101 + i, P.qos.LATENCY, bytes(300)))
    for _ in range(200):
        with conn.wlock:
            conn.sock.budget = max(conn.sock.budget, 400)
            btl._flush_shaped(conn)
            if conn.cur is None and not any(conn.wqs):
                break
    order = _wire_classes(P, bytes(conn.sock.wire))
    bulk_pos = order.index(P.qos.BULK)
    fsz = 4 + P.pml.HDR_SIZE + 300
    assert 0 < bulk_pos < len(order) - 1
    assert bulk_pos * fsz <= 2048 + 2 * fsz
    btl.finalize()


def test_partial_frame_finishes_before_preemption(P):
    P.set("btl_tcp", "shape_enable", 1)
    btl, conn = _shaped_pair(P)
    conn.sock.budget = 100  # partial: frame is 4+49+300 bytes
    btl.send(1, *_frame(P, 9, 1, P.qos.BULK, bytes(300)))
    btl.send(1, *_frame(P, 9, 2, P.qos.LATENCY, bytes(10)))
    for _ in range(50):
        with conn.wlock:
            conn.sock.budget = max(conn.sock.budget, 200)
            btl._flush_shaped(conn)
            if conn.cur is None and not any(conn.wqs):
                break
    assert _wire_classes(P, bytes(conn.sock.wire)) == \
        [P.qos.BULK, P.qos.LATENCY]
    btl.finalize()


def test_weighted_deficit_ratio(P):
    P.set("btl_tcp", "shape_enable", 1)
    P.set("btl_tcp", "shape_weights", "4,2,1")
    P.set("btl_tcp", "shape_quantum_bytes", 512)
    P.set("btl_tcp", "shape_max_defer_bytes", 0)  # pure DRR
    btl, conn = _shaped_pair(P)
    for i in range(60):
        btl.send(1, *_frame(P, 7, i + 1, P.qos.BULK, bytes(300)))
    for i in range(60):
        btl.send(1, *_frame(P, 8, i + 1, P.qos.LATENCY, bytes(300)))
    with conn.wlock:
        conn.sock.budget = 40 * (4 + P.pml.HDR_SIZE + 300)
        btl._flush_shaped(conn)
    order = _wire_classes(P, bytes(conn.sock.wire))
    lat = sum(1 for c in order if c == P.qos.LATENCY)
    bulk = sum(1 for c in order if c == P.qos.BULK)
    assert bulk > 0, "pure DRR still serves the light class"
    assert 2.0 <= lat / bulk <= 8.0, (lat, bulk)
    btl.finalize()


def test_shape_flip_residue_drains_fifo(P):
    P.set("btl_tcp", "shape_enable", 1)
    btl, conn = _shaped_pair(P)
    for i in range(3):
        btl.send(1, *_frame(P, 7, i + 1, P.qos.BULK, bytes(100)))
    P.set("btl_tcp", "shape_enable", 0)
    btl.send(1, *_frame(P, 7, 4, P.qos.NORMAL, bytes(100)))
    with conn.wlock:
        conn.sock.budget = 10 ** 9
        btl._flush_locked(conn)
    order = _wire_classes(P, bytes(conn.sock.wire))
    assert len(order) == 4
    assert order[:3] == [P.qos.BULK] * 3
    assert _pv(P, "btl_tcp_shape_queued_bulk") == 0
    btl.finalize()


def test_conn_failure_settles_gauges(P):
    P.set("btl_tcp", "shape_enable", 1)
    btl, conn = _shaped_pair(P)
    for i in range(4):
        btl.send(1, *_frame(P, 7, i + 1, P.qos.BULK, bytes(500)))
    assert _pv(P, "btl_tcp_shape_queued_bulk") > 0
    btl._conn_failed(conn, OSError("boom"))
    assert _pv(P, "btl_tcp_shape_queued_bulk") == 0
    assert conn.cur is None
    btl.finalize()


def test_handshake_negotiates_qos_capability(P):
    got = []
    a = P.tcp.TcpBtl(lambda h, p: None, my_rank=0)
    b = P.tcp.TcpBtl(lambda h, p: got.append((bytes(h), bytes(p))),
                     my_rank=1)
    a.set_peers({1: f"127.0.0.1:{b.port}"})
    b.set_peers({0: f"127.0.0.1:{a.port}"})
    try:
        a.send(1, *_frame(P, 7, 1, P.qos.NORMAL, b"ping"))
        deadline = time.time() + 10
        while len(got) < 1 and time.time() < deadline:
            a.progress()
            b.progress()
        assert got, "frame never delivered"
        conn_a = a.conns[1]
        while conn_a.await_ack and time.time() < deadline:
            a.progress()
            b.progress()
        assert conn_a.peer_q and conn_a.peer_z
        assert b.conns[0].peer_q
    finally:
        a.finalize()
        b.finalize()


def test_btl_shape_cvars_and_pvars_registered(P):
    cvars = P.var.all_vars()
    for name in ("btl_tcp_shape_enable", "btl_tcp_shape_segment_bytes",
                 "btl_tcp_shape_quantum_bytes", "btl_tcp_shape_weights",
                 "btl_tcp_shape_max_defer_bytes", "qos_tag_map"):
        assert name in cvars, name
    for name in ("btl_tcp_shape_queued_latency",
                 "btl_tcp_shape_queued_normal", "btl_tcp_shape_queued_bulk",
                 "btl_tcp_shape_preemptions", "btl_tcp_shape_enqueued"):
        assert name in P.var.all_pvars(), name
    assert "btl_tcp_shape_queued_bytes_by_class" in P.metrics._samplers
