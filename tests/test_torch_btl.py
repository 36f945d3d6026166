"""The port's byte transfer layer (``btl/base.py``, ``self_btl.py``,
``tcp.py``) against the JAX package's, on the CPU.

Each case of the reference runs on both packages (the ``P`` fixture of
``tests/test_torch_btl_fixture.py``), so each counts twice:

- ``tests/test_link.py``'s loopback state machines (``:154-370``):
  negotiation and the ack drain, the legacy wire format, CRC reject and
  NACK retransmit, link-sequence dedup, the retransmit timer healing a
  drop, degrade, redial, resync and replay, a degraded link read as
  pending work;
- ``tests/test_datapath.py``'s ``tcp_pair`` cases (``:47-135``), the
  registered variables, the info tool's listing and the idle contract;
- ``tests/test_quant.py``'s five in-process tcp compression cases
  (``:524-685``).

Then what shows that the two packages speak one wire: the constants of the
framing, the bytes a connector puts on the wire and the ack word an
acceptor answers, equal between the packages for every capability
combination; and a JAX ``TcpBtl`` and a port ``TcpBtl`` exchanging frames
both ways under reliable, legacy and compressed framing, with mixed
capabilities negotiating down, a corrupted stream healing across the two,
and a degraded link redialed and replayed across the two.

The port's payload rule: CPU tensors are sent as their bytes without a
copy; a tensor off the CPU (a meta tensor here, a CUDA tensor on the card)
is refused with a ``TypeError`` by every btl.

Procmode cases (``run_mpi``) wait for ob1 and ``mpirun`` (A.14.5).
"""

import socket
import struct
import time

import numpy as np
import pytest
import torch

from tests.test_torch_btl_fixture import (  # noqa: F401 fixtures
    P, btl_clean, load, pump, tcp_pair)

JX, TX = load("jax"), load("torch")
HDR = TX.pml.pack_header(1, 7, 0, 3, 1, 4, 0, 0)
assert HDR == JX.pml.pack_header(1, 7, 0, 3, 1, 4, 0, 0)
HDR_SIZE = TX.pml.HDR_SIZE


def _finalize(*btls):
    for b in btls:
        b.finalize()


# ------------------------------------------------- link state machines
def test_reliable_negotiation_roundtrip_and_ack_drain(P):
    P.set("btl_tcp", "reliable", 1)
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        b.send(0, HDR, b"warmup")
        pump([a, b], lambda: len(got_a) == 1)
        conn_b = b.conns[0]
        assert conn_b.rel
        for i in range(20):
            b.send(0, HDR, b"ping-%03d" % i)
        pump([a, b], lambda: len(got_a) == 21)
        assert conn_b.tx_seq == 20
        assert sorted(p for _, p in got_a[1:]) == \
            [b"ping-%03d" % i for i in range(20)]
        pump([a, b], lambda: not conn_b.retx, timeout=3.0)
        assert conn_b.tx_acked == 20
    finally:
        _finalize(a, b)


def test_reliable_off_negotiates_legacy(P):
    P.set("btl_tcp", "reliable", 0)
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        for i in range(5):
            b.send(0, HDR, b"leg-%d" % i)
        pump([a, b], lambda: len(got_a) == 5)
        conn_b = b.conns[0]
        assert not conn_b.rel and conn_b.tx_seq == 0 and not conn_b.retx
    finally:
        _finalize(a, b)


def _listener():
    ls = socket.socket()
    ls.bind(("127.0.0.1", 0))
    ls.listen(1)
    return ls


def _read(s, n):
    blob = b""
    while len(blob) < n:
        chunk = s.recv(n - len(blob))
        if not chunk:
            break
        blob += chunk
    return blob


def test_legacy_wire_format_is_bit_identical(P):
    P.set("btl_tcp", "reliable", 0)
    ls = _listener()
    btl = P.tcp.TcpBtl(lambda h, p: None, my_rank=3)
    btl.set_peers({1: f"127.0.0.1:{ls.getsockname()[1]}"})
    try:
        payload = bytes(range(64))
        btl.send(1, HDR, payload)
        s, _ = ls.accept()
        s.settimeout(5.0)
        blob = _read(s, 4 + 4 + HDR_SIZE + len(payload))
        word = struct.unpack("<I", blob[:4])[0]
        assert word & (1 << 29) == 0, hex(word)  # _CAP_RELIABLE clear
        s.sendall(struct.pack("<I", 1 | next(iter(P.tcp._ZACK_WORDS))))
        assert blob[4:] == struct.pack("<I", HDR_SIZE + len(payload)) \
            + HDR + payload
        s.close()
    finally:
        btl.finalize()
        ls.close()


def test_injected_corrupt_is_crc_rejected_and_retransmitted(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "retx_timeout_ms", 60.0)
    crc0 = P.pvar("btl_tcp_crc_errors")
    retx0 = P.pvar("btl_tcp_retransmits")
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        b.send(0, HDR, b"warmup")
        pump([a, b], lambda: len(got_a) == 1)
        P.inject.install("corrupt(7,0,nth=2)")
        for i in range(8):
            b.send(0, HDR, b"crc-%03d" % i)
        pump([a, b], lambda: len(got_a) == 9)
        assert sorted(p for _, p in got_a[1:]) == \
            [b"crc-%03d" % i for i in range(8)]
        assert P.pvar("btl_tcp_crc_errors") >= crc0 + 2
        assert P.pvar("btl_tcp_retransmits") >= retx0 + 1
        assert b.conns[0].dead is None and a.conns[7].dead is None
    finally:
        _finalize(a, b)


def test_injected_dup_is_deduped_by_link_seq(P):
    P.set("btl_tcp", "reliable", 1)
    dedup0 = P.pvar("btl_tcp_link_dedup_frames")
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        b.send(0, HDR, b"warmup")
        pump([a, b], lambda: len(got_a) == 1)
        P.inject.install("dup(7,0,nth=2)")
        for i in range(10):
            b.send(0, HDR, b"dup-%03d" % i)
        pump([a, b], lambda: len(got_a) == 11)
        for _ in range(50):
            a.progress()
            b.progress()
            time.sleep(0.001)
        assert sorted(p for _, p in got_a[1:]) == \
            [b"dup-%03d" % i for i in range(10)]
        assert P.pvar("btl_tcp_link_dedup_frames") >= dedup0 + 4
    finally:
        _finalize(a, b)


def test_injected_drop_healed_by_retransmit_timer(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "retx_timeout_ms", 50.0)
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        b.send(0, HDR, b"warmup")
        pump([a, b], lambda: len(got_a) == 1)
        P.inject.install("drop(7,0,nth=3)")
        for i in range(9):
            b.send(0, HDR, b"drp-%03d" % i)
        pump([a, b], lambda: len(got_a) == 10)
        assert sorted(p for _, p in got_a[1:]) == \
            [b"drp-%03d" % i for i in range(9)]
    finally:
        _finalize(a, b)


def test_degrade_redial_resync_replays_exactly_once(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "link_backoff_ms", 10.0)
    rec0 = P.pvar("btl_tcp_link_recoveries")
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        a.send(7, HDR, b"warmup")
        pump([a, b], lambda: len(got_b) == 1)
        conn = a.conns[7]
        a._conn_failed(conn, OSError("test sever"))
        assert conn.state == "degraded"
        for i in range(10):
            a.send(7, HDR, b"heal-%03d" % i)  # retained, not sent
        pump([a, b], lambda: len(got_b) == 11, timeout=10.0)
        assert conn.state == "est" and conn.reconnects == 1
        assert [p for _, p in got_b] == \
            [b"warmup"] + [b"heal-%03d" % i for i in range(10)]
        assert P.pvar("btl_tcp_link_recoveries") >= rec0 + 1
        b.send(0, HDR, b"back")
        pump([a, b], lambda: len(got_a) == 1)
    finally:
        _finalize(a, b)


def test_degraded_link_reads_as_pending_work(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "link_backoff_ms", 1000.0)  # stay degraded
    got_a, got_b = [], []
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    try:
        a.send(7, HDR, b"warmup")
        pump([a, b], lambda: len(got_b) == 1)
        conn = a.conns[7]
        a._conn_failed(conn, OSError("test sever"))
        a.send(7, HDR, b"retained")
        roll = P.tcp._link_rollup()
        assert roll["degraded_links"] >= 1
        assert roll["retx_frames"] >= 1
        ent = next(e for e in a.debug_state()["conns"]
                   if e["peer"] == 7)
        assert ent["state"] == "degraded"
        assert ent["link"]["redial_budget"] >= 1
        assert "degraded_s" in ent["link"]
        # the stall sentinel's probe reads the same rollup
        assert P.forensics._pending_probes["btl.tcp.link"]() >= 1
    finally:
        _finalize(a, b)


# ------------------------------------------------------------ datapath
@pytest.fixture
def pair(P):
    got = []
    a = P.tcp.TcpBtl(lambda h, p: got.append((bytes(h), bytes(p))),
                     my_rank=0)
    b = P.tcp.TcpBtl(lambda h, p: got.append((bytes(h), bytes(p))),
                     my_rank=1)
    a.set_peers({1: f"127.0.0.1:{b.port}"})
    b.set_peers({0: f"127.0.0.1:{a.port}"})
    try:
        yield P, a, b, got
    finally:
        P.set("btl_tcp", "copy_mode", 0)
        _finalize(a, b)


DHDR = TX.pml.pack_header(1, 0, 0, 5, 1, 5, 0, 0)


def test_small_send_is_zero_copy(pair):
    P, a, b, got = pair
    ctr = P.tcp._ctr
    payload = np.frombuffer(b"hello", np.uint8)
    c0, w0 = ctr["copied"], ctr["writev"]
    a.send(1, DHDR, payload)
    pump([a, b], lambda: got)
    assert got[0][1] == b"hello"
    assert ctr["copied"] == c0
    assert ctr["writev"] == w0 + 1


def test_backlog_copies_once_and_stays_exact(pair):
    P, a, b, got = pair
    payload = np.arange(1 << 20, dtype=np.uint8) % 199
    expect = payload.tobytes()
    c0 = P.tcp._ctr["copied"]
    scratch = payload.copy()
    for _ in range(24):  # no draining: forces EAGAIN queueing
        a.send(1, DHDR, scratch)
    scratch[:] = 0  # the caller reuses its buffer: queued bytes are owned
    pump([a, b], lambda: len(got) >= 24, timeout=30)
    assert len(got) == 24
    assert all(g[1] == expect for g in got)
    assert P.tcp._ctr["copied"] > c0


def test_rx_jumbo_frame_grows_past_pool_block(pair):
    P, a, b, got = pair
    big = (np.arange(3 << 20, dtype=np.int64) % 251).astype(np.uint8)
    a.send(1, DHDR, big)
    pump([a, b], lambda: got, timeout=30)
    assert got[0][1] == big.tobytes()


def test_noncontiguous_payload_falls_back_to_copy(pair):
    P, a, b, got = pair
    arr = np.arange(64, dtype=np.uint8)[::2]
    c0 = P.tcp._ctr["copied"]
    a.send(1, DHDR, arr)
    pump([a, b], lambda: got)
    assert got[0][1] == arr.tobytes()
    assert P.tcp._ctr["copied"] == c0 + arr.nbytes


def test_copy_mode_ab_is_measured_and_worse(pair):
    P, a, b, got = pair
    ctr = P.tcp._ctr
    payload = np.zeros(1 << 16, np.uint8)

    def leg():
        base = len(got)
        c0, w0 = ctr["copied"], ctr["wire"]
        for _ in range(8):
            a.send(1, DHDR, payload)
        pump([a, b], lambda: len(got) >= base + 8, timeout=30)
        return (ctr["copied"] - c0) / max(ctr["wire"] - w0, 1)

    P.set("btl_tcp", "copy_mode", 0)
    zero = leg()
    P.set("btl_tcp", "copy_mode", 1)
    legacy = leg()
    assert legacy >= 2.0 * max(zero, 1e-9), (zero, legacy)
    assert legacy > 0.9


def test_copy_mode_flip_mid_stream_bridges_residue(pair):
    P, a, b, got = pair
    payload = np.arange(1 << 18, dtype=np.uint8) % 97
    expect = payload.tobytes()
    for i in range(12):
        P.set("btl_tcp", "copy_mode", i % 2)
        a.send(1, DHDR, payload)
    P.set("btl_tcp", "copy_mode", 0)
    pump([a, b], lambda: len(got) >= 12, timeout=30)
    assert len(got) == 12 and all(g[1] == expect for g in got)


def test_datapath_cvars_and_pvars_registered(P):
    vars_ = P.var.all_vars()
    for name in ("btl_tcp_writev_max_vecs", "btl_tcp_copy_mode",
                 "runtime_idle_block_us"):
        assert name in vars_, name
    assert vars_["btl_tcp_copy_mode"].default == 0
    assert vars_["runtime_idle_block_us"].default == 50000
    pvars = P.var.all_pvars()
    for name in ("btl_tcp_bytes_copied", "btl_tcp_writev_calls",
                 "btl_tcp_wire_bytes", "runtime_progress_idle_blocks",
                 "mpool_pool_blocks", "mpool_pool_bytes",
                 "mpool_pool_hits", "mpool_pool_misses"):
        assert name in pvars, name


def test_btl_vars_equal_the_references():
    """Every btl variable and pvar of the reference exists in the port
    with the same default, type, level and enum."""
    names = [n for n in JX.var.all_vars()
             if n.startswith(("btl_tcp_", "btl_sm_", "btl_btl"))]
    assert len(names) > 20
    tv = TX.var.all_vars()
    for n in names:
        j, t = JX.var.all_vars()[n], tv[n]
        assert (t.default, t.typ, t.level, t.enum_values) == \
            (j.default, j.typ, j.level, j.enum_values), n
    jp = {n for n in JX.var.all_pvars() if n.startswith("btl_tcp_")}
    tp = {n for n in TX.var.all_pvars() if n.startswith("btl_tcp_")}
    assert jp == tp and len(tp) >= 18


def test_info_cli_lists_datapath_surface(P, capsys):
    P.info.main(["--level", "9", "--param", "btl_tcp"])
    out = capsys.readouterr().out
    assert "btl_tcp_writev_max_vecs" in out
    assert "btl_tcp_copy_mode" in out
    P.info.main(["--level", "9", "--param", "runtime"])
    out = capsys.readouterr().out
    assert "runtime_idle_block_us" in out


def test_btl_idle_contract(P):
    assert P.base.Btl.NEEDS_POLL is True
    assert P.sm.SmBtl.NEEDS_POLL is True
    assert P.self_btl.SelfBtl.NEEDS_POLL is False
    assert P.tcp.TcpBtl.NEEDS_POLL is False
    b = P.tcp.TcpBtl(lambda h, p: None, my_rank=0)
    try:
        rfds, wfds = b.idle_fds()
        assert b.listener.fileno() in rfds and wfds == []
    finally:
        b.finalize()
        assert b.idle_fds() == ([], [])


def test_components_select_in_the_references_order(P):
    """self (100) over sm (30) over tcp (20); without context each
    component declines."""
    fw = P.base.btl_framework
    comps = {n: c.PRIORITY for n, c in fw.components.items()}
    assert comps == {"self": 100, "sm": 30, "tcp": 20}
    assert all(c.query() is None for c in fw.components.values())
    got = []
    s = fw.components["self"].query(deliver=lambda h, p: got.append(p))
    s.send(0, HDR, b"inline")
    assert got == [b"inline"]


# ------------------------------------------------------- compression
HZ = TX.pml.pack_header(1, 0, 0, 7, 0, 0, 0, 0)


def test_tcp_compress_roundtrip_and_negotiation(P):
    P.reset_quant()
    P.set("btl_tcp", "compress", 6)
    P.set("btl_tcp", "compress_min_bytes", 1024)
    got = {"a": [], "b": []}
    a = P.tcp.TcpBtl(lambda h, p: got["a"].append(bytes(p)), my_rank=90)
    b = P.tcp.TcpBtl(lambda h, p: got["b"].append(bytes(p)), my_rank=91)
    a.set_peers({91: f"{b.host}:{b.port}"})
    b.set_peers({90: f"{a.host}:{a.port}"})
    try:
        compressible = bytes(np.zeros(150000, np.uint8))
        incompressible = np.random.RandomState(0).bytes(150000)
        small = b"x" * 64
        a.send(91, HZ, compressible)        # pre-ack: raw framing
        pump([a, b], lambda: len(got["b"]) >= 1)
        a.send(91, HZ, compressible)        # post-ack: compressed
        a.send(91, HZ, incompressible)      # stays raw (no win)
        a.send(91, HZ, small)               # under the floor
        pump([a, b], lambda: len(got["b"]) >= 4)
        assert got["b"] == [compressible, compressible,
                            incompressible, small]
        b.send(90, HZ, compressible)        # the acceptor compresses
        pump([a, b], lambda: len(got["a"]) >= 1)
        assert got["a"] == [compressible]
        c = P.quant.counters()
        assert c["wire_frames"] == 2
        assert c["wire_comp"] < c["wire_raw"] // 50
        assert P.pvar("btl_tcp_compress_ratio") > 1.0
        assert P.pvar("btl_tcp_compress_saved_bytes") > 0
    finally:
        P.reset_quant()
        _finalize(a, b)


def test_tcp_compress_direction_independent(P):
    P.reset_quant()
    P.set("btl_tcp", "compress", 0)       # the DIALER stays at 0
    P.set("btl_tcp", "compress_min_bytes", 1024)
    got = {"e": [], "f": []}
    e = P.tcp.TcpBtl(lambda h, p: got["e"].append(bytes(p)), my_rank=86)
    f = P.tcp.TcpBtl(lambda h, p: got["f"].append(bytes(p)), my_rank=87)
    e.set_peers({87: f"{f.host}:{f.port}"})
    f.set_peers({86: f"{e.host}:{e.port}"})
    payload = bytes(np.zeros(150000, np.uint8))
    try:
        f.send(86, HZ, b"hello")            # f dials e FIRST
        pump([e, f], lambda: len(got["e"]) >= 1)
        P.set("btl_tcp", "compress", 6)     # e compresses over the
        e.send(87, HZ, payload)             # accepted (f-dialed) conn
        pump([e, f], lambda: len(got["f"]) >= 1)
        assert got["f"] == [payload]
        assert P.quant.counters()["wire_frames"] == 1
    finally:
        P.reset_quant()
        _finalize(e, f)


def test_tcp_frame_size_guard(P):
    class Huge(bytes):
        def __len__(self):
            return P.tcp._LEN_MASK + 1

    b = P.tcp.TcpBtl(lambda h, p: None, my_rank=96)
    try:
        with pytest.raises(P.errors.MPIError, match="framing limit"):
            b.send(97, HZ, Huge())
    finally:
        b.finalize()


def test_tcp_corrupt_compressed_frame_fails_link(P):
    P.set("btl_tcp", "compress", 6)
    got = []
    b = P.tcp.TcpBtl(lambda h, p: got.append(bytes(p)), my_rank=95)
    s = None
    try:
        s = socket.create_connection((b.host, b.port))
        s.sendall(struct.pack("<I", 94 | P.tcp._CAP_COMPRESS))
        pump([b], lambda: 94 in b.conns)
        assert s.recv(4)  # the acceptor's capability ack
        garbage = b"\x00not-zlib-data" * 16
        s.sendall(struct.pack(
            "<I", (HDR_SIZE + len(garbage)) | P.tcp._ZFLAG) + HZ + garbage)
        pump([b], lambda: b.conns[94].dead is not None)
        assert got == []
    finally:
        if s is not None:
            s.close()
        b.finalize()


def test_tcp_noncompressing_peer_interops(P):
    P.reset_quant()
    P.set("btl_tcp", "compress", 0)
    got = {"c": []}
    c = P.tcp.TcpBtl(lambda h, p: got["c"].append(bytes(p)), my_rank=92)
    d = P.tcp.TcpBtl(lambda h, p: None, my_rank=93)
    d.set_peers({92: f"{c.host}:{c.port}"})
    try:
        payload = bytes(np.zeros(150000, np.uint8))
        d.send(92, HZ, payload)
        pump([c, d], lambda: len(got["c"]) >= 1)
        assert got["c"] == [payload]
        assert P.quant.counters()["wire_frames"] == 0
    finally:
        _finalize(c, d)


# ------------------------------------------------------ tensor payloads
def _port_pair():
    got = []
    a = TX.tcp.TcpBtl(lambda h, p: got.append(bytes(p)), my_rank=0)
    b = TX.tcp.TcpBtl(lambda h, p: got.append(bytes(p)), my_rank=1)
    a.set_peers({1: f"127.0.0.1:{b.port}"})
    b.set_peers({0: f"127.0.0.1:{a.port}"})
    return a, b, got


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.int8, torch.float64, torch.bool])
def test_cpu_tensor_is_sent_as_its_bytes_without_a_copy(dtype, btl_clean):
    g = torch.Generator().manual_seed(5)
    t = (torch.randn(4096, generator=g) * 50).to(dtype)
    a, b, got = _port_pair()
    try:
        c0, w0 = TX.tcp._ctr["copied"], TX.tcp._ctr["writev"]
        a.send(1, DHDR, t)
        pump([a, b], lambda: got)
        assert TX.tcp._ctr["copied"] == c0
        assert TX.tcp._ctr["writev"] == w0 + 1
        assert got[0] == t.view(torch.uint8).numpy().tobytes()
    finally:
        _finalize(a, b)


def test_strided_tensor_is_owned_with_one_counted_copy(btl_clean):
    t = torch.arange(64, dtype=torch.int32)[::2]
    a, b, got = _port_pair()
    try:
        c0 = TX.tcp._ctr["copied"]
        a.send(1, DHDR, t)
        pump([a, b], lambda: got)
        assert got[0] == t.contiguous().numpy().tobytes()
        assert TX.tcp._ctr["copied"] == c0 + t.numel() * 4
    finally:
        _finalize(a, b)


def _off_cpu_tensors():
    out = [torch.empty(16, device="meta")]
    if torch.cuda.is_available():
        out.append(torch.zeros(16, device="cuda"))
    return out


@pytest.mark.parametrize("which", ["tcp", "sm", "self"])
def test_a_tensor_off_the_cpu_is_refused_by_every_btl(which, btl_clean):
    if which == "tcp":
        btl = TX.tcp.TcpBtl(lambda h, p: None, my_rank=0)
    elif which == "sm":
        btl = TX.sm.SmBtl(lambda h, p: None, my_rank=0, n_ranks=2)
    else:
        btl = TX.self_btl.SelfBtl(lambda h, p: None)
    try:
        for t in _off_cpu_tensors():
            with pytest.raises(TypeError, match="stage_to_host"):
                btl.send(1, DHDR, t)
        if which == "tcp":
            assert not btl.conns  # refused before any connection
    finally:
        btl.finalize()


def test_host_bytes_views_every_dtype_without_a_copy():
    for dtype in (torch.float32, torch.bfloat16, torch.float16, torch.int64,
                  torch.uint8, torch.bool, torch.complex64):
        t = torch.zeros(6, 5, dtype=dtype)
        v = TX.base.host_bytes(t)
        assert v.dtype == np.uint8 and v.nbytes == t.numel() * t.element_size()
        v[0] = 1  # a view: the write lands in the tensor
        assert t.view(-1).view(torch.uint8)[0] == 1
    arr = np.arange(4)
    assert TX.base.host_bytes(arr) is arr and TX.base.host_bytes(b"x") == b"x"


# ------------------------------------------------ one wire, two packages
WIRE_CONSTANTS = ["_CAP_COMPRESS", "_CAP_QOS", "_CAP_RELIABLE", "_CAP_RESYNC",
                  "_ZFLAG", "_LEN_MASK", "_LFLAG", "_RFLAG", "_RLEN_MASK",
                  "_ZACK_MAGIC", "_ZACK_ACCEPT", "_ZACK_QOS", "_ZACK_RELIABLE",
                  "_ZACK_WORDS", "_CTL_ACK", "_CTL_NACK", "_CTL_RESYNC",
                  "_CTL_LEN", "_RX_BLOCK", "_RETX_FLOOR_S", "_SERVICE_ORDER"]


@pytest.mark.parametrize("name", WIRE_CONSTANTS)
def test_wire_constants_are_the_references(name):
    assert getattr(TX.tcp, name) == getattr(JX.tcp, name)


def test_wire_structs_are_the_references():
    for name in ("_LEN", "_RELHDR", "_RELSA", "_LCTL"):
        assert getattr(TX.tcp, name).format == getattr(JX.tcp, name).format
    assert TX.pml.HDR_SIZE == JX.pml.HDR_SIZE
    assert TX.pml.QOS_SHIFT == JX.pml.QOS_SHIFT


def _connector_bytes(M, reliable, compress, payloads, ack_word):
    """What a connector of package ``M`` puts on the wire: its capability
    word and the frames of ``payloads`` before an ack, then (after the
    acceptor's ``ack_word``) the frames of ``payloads`` again."""
    ls = _listener()
    btl = M.tcp.TcpBtl(lambda h, p: None, my_rank=5)
    btl.set_peers({2: f"127.0.0.1:{ls.getsockname()[1]}"})
    try:
        M.var.set_var("btl_tcp", "reliable", reliable)
        M.var.set_var("btl_tcp", "compress", compress)
        M.var.set_var("btl_tcp", "compress_min_bytes", 1024)
        for p in payloads:
            btl.send(2, HDR, p)
        s, _ = ls.accept()
        s.settimeout(5.0)
        pre = _read(s, 4 + sum(4 + HDR_SIZE + len(p) for p in payloads))
        s.sendall(struct.pack("<I", ack_word))
        conn = btl.conns[2]
        pump([btl], lambda: not conn.await_ack)
        for p in payloads:
            btl.send(2, HDR, p)
        s.setblocking(False)
        post = b""
        t0 = time.monotonic()
        while time.monotonic() - t0 < 0.5:
            btl.progress()
            try:
                chunk = s.recv(1 << 20)
                if chunk:
                    post += chunk
                    t0 = time.monotonic()
            except BlockingIOError:
                time.sleep(0.005)
        s.close()
        return pre, post
    finally:
        btl.finalize()
        ls.close()


ACK_ALL = 0x5A << 24 | 1 | 2 | 4


@pytest.mark.parametrize("reliable,compress,ack", [
    (0, 0, 0x5A << 24 | 1 | 2),     # legacy framing, acked caps
    (1, 0, ACK_ALL),                # reliable: envelopes with CRC after ack
    (1, 6, ACK_ALL),                # reliable and compressed
    (0, 6, 0x5A << 24 | 1 | 2),     # legacy, compressed
    (1, 6, 0x5A << 24),             # an acceptor that engages nothing
])
def test_connector_wire_bytes_equal_the_references(reliable, compress, ack,
                                                   btl_clean):
    for fw, name in (("btl_tcp", "reliable"), ("btl_tcp", "compress"),
                     ("btl_tcp", "compress_min_bytes")):
        btl_clean.both(fw, name, JX.var.get_var(fw, name))
    # no acks come back: keep the retransmit timer out of the capture
    btl_clean.both("btl_tcp", "retx_timeout_ms", 60000.0)
    payloads = [b"tiny", bytes(np.zeros(150000, np.uint8)),
                np.random.RandomState(1).bytes(5000)]
    j = _connector_bytes(JX, reliable, compress, payloads, ack)
    t = _connector_bytes(TX, reliable, compress, payloads, ack)
    assert j == t
    word = struct.unpack("<I", t[0][:4])[0]
    assert bool(word & TX.tcp._CAP_RELIABLE) == bool(reliable)
    assert len(t[1]) > 0


@pytest.mark.parametrize("reliable", [0, 1])
@pytest.mark.parametrize("caps", range(8))
def test_acceptor_ack_word_equals_the_references(reliable, caps, btl_clean):
    btl_clean.both("btl_tcp", "reliable", reliable)
    word = 9
    for bit, cap in zip((1, 2, 4), ("_CAP_COMPRESS", "_CAP_QOS",
                                    "_CAP_RELIABLE")):
        if caps & bit:
            word |= getattr(TX.tcp, cap)
    acks = []
    for M in (JX, TX):
        btl = M.tcp.TcpBtl(lambda h, p: None, my_rank=1)
        s = socket.create_connection((btl.host, btl.port))
        try:
            s.settimeout(5.0)
            s.sendall(struct.pack("<I", word))
            pump([btl], lambda: 9 in btl.conns)
            conn = btl.conns[9]
            acks.append((_read(s, 4) if caps else b"", conn.peer_z,
                         conn.peer_q, conn.rel, conn.rel_rx))
        finally:
            s.close()
            btl.finalize()
    assert acks[0] == acks[1]


def test_resync_frame_equals_the_references():
    frames = []
    for M in (JX, TX):
        btl = M.tcp.TcpBtl(lambda h, p: None, my_rank=0)
        try:
            conn = M.tcp._Conn(socket.socket(), peer=3)
            conn.rx_floor, conn.tx_seq = 1234, 98765
            frames.append(btl._resync_frame(conn))
            conn.sock.close()
        finally:
            btl.finalize()
    assert frames[0] == frames[1]


MODES = {"reliable": {"reliable": 1},
         "legacy": {"reliable": 0},
         "compressed": {"reliable": 1, "compress": 6,
                        "compress_min_bytes": 1024}}


def _payloads(seed):
    rng = np.random.RandomState(seed)
    return [b"", b"x" * 17, rng.bytes(4096),
            bytes(np.zeros(150000, np.uint8)),
            (np.arange(3 << 20, dtype=np.int64) % 251).astype(np.uint8)
            .tobytes()]


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("dialer", ["jax", "torch"])
def test_interop_both_directions(mode, dialer, btl_clean):
    for name, value in MODES[mode].items():
        btl_clean.both("btl_tcp", name, value)
    JX.reset_quant()
    TX.reset_quant()
    A, B = (JX, TX) if dialer == "jax" else (TX, JX)
    got_a, got_b = [], []
    a, b = tcp_pair(A.tcp, B.tcp, got_a, got_b)
    try:
        pay = _payloads(3)
        a.send(7, HDR, b"hello")        # a dials b
        pump([a, b], lambda: len(got_b) == 1)
        ca = a.conns[7]
        pump([a, b], lambda: not ca.await_ack)
        for p in pay:
            a.send(7, HDR, p)
            b.send(0, HDR, p)
        pump([a, b], lambda: len(got_b) == 1 + len(pay)
             and len(got_a) == len(pay), timeout=30)
        assert [p for _, p in got_b] == [b"hello"] + pay
        assert [p for _, p in got_a] == pay
        assert all(h == HDR for h, _ in got_a + got_b)
        cb = b.conns[0]
        want_rel = bool(MODES[mode]["reliable"])
        assert (ca.rel, cb.rel, ca.peer_z, cb.peer_z, ca.peer_q,
                cb.peer_q) == (want_rel, want_rel, True, True, True, True)
        if want_rel:
            pump([a, b], lambda: not ca.retx and not cb.retx, timeout=5)
            assert ca.tx_acked == ca.tx_seq and cb.tx_acked == cb.tx_seq
        if mode == "compressed":
            # each side flagged its zeros frame (and a's second one)
            assert JX.quant.counters()["wire_frames"] >= 1
            assert TX.quant.counters()["wire_frames"] >= 1
    finally:
        JX.reset_quant()
        TX.reset_quant()
        _finalize(a, b)


@pytest.mark.parametrize("legacy_side", ["jax", "torch"])
@pytest.mark.parametrize("dialer", ["jax", "torch"])
def test_interop_mixed_capabilities_negotiate_down(legacy_side, dialer,
                                                   btl_clean):
    """One package at reliable=0 and no compression, the other reliable
    and compressing: the pair runs plain framing; the compressing side
    still flags frames (the other decodes them), whichever side dials."""
    J_, T_ = (0, 1) if legacy_side == "jax" else (1, 0)
    btl_clean.jax("btl_tcp", "reliable", J_)
    btl_clean.port("btl_tcp", "reliable", T_)
    btl_clean.jax("btl_tcp", "compress", 6 * J_)
    btl_clean.port("btl_tcp", "compress", 6 * T_)
    btl_clean.both("btl_tcp", "compress_min_bytes", 1024)
    JX.reset_quant()
    TX.reset_quant()
    A, B = (JX, TX) if dialer == "jax" else (TX, JX)
    got_a, got_b = [], []
    a, b = tcp_pair(A.tcp, B.tcp, got_a, got_b)
    try:
        a.send(7, HDR, b"hello")
        pump([a, b], lambda: len(got_b) == 1)
        ca, cb = a.conns[7], b.conns[0]
        pump([a, b], lambda: not ca.await_ack)
        zeros = bytes(np.zeros(150000, np.uint8))
        for _ in range(3):
            a.send(7, HDR, zeros)
            b.send(0, HDR, zeros)
        pump([a, b], lambda: len(got_b) == 4 and len(got_a) == 3)
        assert all(p == zeros for _, p in got_a + got_b[1:])
        assert not (ca.rel or cb.rel or ca.rel_rx or cb.rel_rx)
        compressing = JX if legacy_side == "torch" else TX
        plain = TX if compressing is JX else JX
        assert compressing.quant.counters()["wire_frames"] == 3
        assert plain.quant.counters()["wire_frames"] == 0
    finally:
        JX.reset_quant()
        TX.reset_quant()
        _finalize(a, b)


@pytest.mark.parametrize("sender", ["jax", "torch"])
def test_interop_corrupt_stream_heals_across_packages(sender, btl_clean):
    """Every 2nd frame of one package is bit-flipped on the wire: the
    other package's CRC rejects it, its NACK makes the sender retransmit,
    and the stream arrives exact."""
    btl_clean.both("btl_tcp", "reliable", 1)
    btl_clean.both("btl_tcp", "retx_timeout_ms", 60.0)
    S, R = (JX, TX) if sender == "jax" else (TX, JX)
    got_a, got_b = [], []
    a, b = tcp_pair(R.tcp, S.tcp, got_a, got_b)  # b (rank 7) sends
    try:
        crc0 = R.pvar("btl_tcp_crc_errors")
        retx0 = S.pvar("btl_tcp_retransmits")
        b.send(0, HDR, b"warmup")
        pump([a, b], lambda: len(got_a) == 1)
        S.inject.install("corrupt(7,0,nth=2)")
        pay = [np.random.RandomState(i).bytes(3000) for i in range(8)]
        for p in pay:
            b.send(0, HDR, p)
        pump([a, b], lambda: len(got_a) == 9)
        assert sorted(p for _, p in got_a[1:]) == sorted(pay)
        assert R.pvar("btl_tcp_crc_errors") >= crc0 + 2
        assert S.pvar("btl_tcp_retransmits") >= retx0 + 1
        assert b.conns[0].dead is None and a.conns[7].dead is None
    finally:
        S.inject.uninstall()
        _finalize(a, b)


@pytest.mark.parametrize("redialer", ["jax", "torch"])
def test_interop_degraded_link_redials_and_replays(redialer, btl_clean):
    """The lower rank of one package redials the other package's
    acceptor: the resync exchange replays the retained tail, delivered
    exactly once."""
    btl_clean.both("btl_tcp", "reliable", 1)
    btl_clean.both("btl_tcp", "link_backoff_ms", 10.0)
    A, B = (JX, TX) if redialer == "jax" else (TX, JX)
    got_a, got_b = [], []
    a, b = tcp_pair(A.tcp, B.tcp, got_a, got_b)
    try:
        a.send(7, HDR, b"warmup")
        pump([a, b], lambda: len(got_b) == 1)
        conn = a.conns[7]
        a._conn_failed(conn, OSError("test sever"))
        assert conn.state == "degraded"
        for i in range(10):
            a.send(7, HDR, b"heal-%03d" % i)
        pump([a, b], lambda: len(got_b) == 11, timeout=10.0)
        assert conn.state == "est" and conn.reconnects == 1
        assert [p for _, p in got_b] == \
            [b"warmup"] + [b"heal-%03d" % i for i in range(10)]
        b.send(0, HDR, b"back")
        pump([a, b], lambda: len(got_a) == 1)
    finally:
        _finalize(a, b)


@pytest.mark.parametrize("sender", ["jax", "torch"])
def test_a_jumbo_reliable_frame_grows_the_rx_buffer_to_its_size(sender,
                                                                btl_clean):
    """An 8 MB enveloped frame grows the port's receive buffer to about
    its size; the reference's masks the length word with ``_LEN_MASK``
    alone, reads the envelope flag as length and allocates past 512 MiB
    (ROADMAP C). Either package may send it: the frame is the same."""
    btl_clean.both("btl_tcp", "reliable", 1)
    S = JX if sender == "jax" else TX
    sizes = {}
    for R in (JX, TX):
        seen = []
        a = S.tcp.TcpBtl(lambda h, p: None, my_rank=0)
        b = R.tcp.TcpBtl(lambda h, p: seen.append(
            (len(p), len(p.obj) if isinstance(p, memoryview) else 0)),
            my_rank=1)
        a.set_peers({1: f"127.0.0.1:{b.port}"})
        b.set_peers({0: f"127.0.0.1:{a.port}"})
        try:
            a.send(1, HDR, b"warmup")
            pump([a, b], lambda: seen and not a.conns[1].await_ack)
            assert a.conns[1].rel
            a.send(1, HDR, bytes(8 << 20))
            pump([a, b], lambda: len(seen) == 2, timeout=30)
            sizes[R.name] = seen[1]
        finally:
            _finalize(a, b)
    assert sizes["torch"][0] == sizes["jax"][0] == 8 << 20
    assert sizes["torch"][1] < 3 * (8 << 20)
    assert sizes["jax"][1] > 512 << 20
