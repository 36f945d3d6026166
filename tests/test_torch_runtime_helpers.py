"""The port's pools, single copy, launcher, interface and modex helpers
against the JAX package's, on the CPU.

Every case runs on both packages (the ``P`` fixture), so each counts
twice:

- ``tests/test_mpool.py`` (3) and the pool cases of
  ``tests/test_datapath.py`` (park budget, discard, settle once);
- the three cases of ``tests/test_smsc.py`` that launch no ranks, and the
  ``smsc_enable`` variable;
- the six cases of ``tests/test_multihost.py`` that launch no job
  (``test_parse_hostfile`` to ``test_remote_command_marshals_contract``),
  plus ``spawn_rank`` of a script locally and through the ``fake`` launch
  agent (which runs the command with a scrubbed environment);
- ``tests/test_ifaces.py`` (4). ``best_local_addr`` asks the kernel for a
  route with a UDP ``connect``; here ``socket.socket`` is a subclass whose
  ``connect`` only records its argument, so no route lookup is made, and
  both packages see the same route, a loopback route, and none;
- modex: each package's ``ModexClient`` against each package's
  ``ModexServer``: put, get (a missing key times out), the name-service
  rank -1, fence, spawn, abort and a bad op give the same results all four
  ways, and a raw request line gets the same reply bytes from both
  servers.
"""

import importlib
import json
import os
import socket
import subprocess
import sys
import threading
import types

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = ["ompi_tpu", "ompi_tpu_torch"]


def _load(root):
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        root=root, mpool=mod("runtime.mpool"), smsc=mod("runtime.smsc"),
        plm=mod("runtime.plm"), ifaces=mod("runtime.ifaces"),
        modex=mod("runtime.modex"), var=mod("mca.var"))


@pytest.fixture(params=PKGS)
def P(request):
    return _load(request.param)


# ------------------------------------------------------------------ mpool
def test_create_view_cache_and_close(P):
    mpool = P.mpool
    seg = mpool.create_segment(8192)
    n0, b0 = mpool.stats()
    assert n0 >= 1 and b0 >= 8192
    v1 = seg.view(0, 4096)
    assert seg.view(0, 4096) is v1  # rcache hit: same registration object
    v3 = seg.view(4096, 4096, np.int64)
    assert v3.dtype == np.int64 and v3.size == 512
    v1[:4] = [1, 2, 3, 4]
    assert bytes(seg.view(0, 4)) == b"\x01\x02\x03\x04"
    with pytest.raises(ValueError):
        seg.view(4096, 8192)  # outside the segment
    path = seg.path
    assert os.path.exists(path)
    seg.unlink()
    assert not os.path.exists(path)
    del v1, v3
    seg.close()
    assert mpool.stats()[0] == n0 - 1


def test_attach_shares_memory(P):
    seg = P.mpool.create_segment(4096)
    peer = P.mpool.attach_segment(seg.path, 4096)
    seg.view(0, 16)[:] = 7
    assert np.all(peer.view(0, 16) == 7)
    seg.unlink()
    peer.close()
    seg.close()


def test_attach_missing_raises(P):
    with pytest.raises(OSError):
        P.mpool.attach_segment("/dev/shm/ompi_tpu_does_not_exist", 4096)


def test_class_pool_park_budget_caps_big_classes(P):
    mpool = P.mpool
    cls = 1 << 23  # 8 MiB class: the budget parks 4, not 8
    pool = mpool.class_pool(cls)
    assert pool.max_free == max(1, min(8, mpool._CLASS_PARK_BYTES // cls)) \
        == 4
    blocks = [pool.acquire() for _ in range(6)]
    for b in blocks:
        pool.release(b)
    assert len(pool._free) == pool.max_free
    assert pool.outstanding == 0
    pool._free.clear()  # do not pin 32 MiB across the rest of the run
    assert mpool.size_class(0) is None and mpool.size_class(1) == 256
    assert mpool.size_class(1000) == 1024
    assert mpool.size_class(mpool._CLASS_MAX + 1) is None


def test_pool_discard_accounts_without_recycling(P):
    pool = P.mpool.BufferPool(4096, max_free=4)
    try:
        pv = P.var.all_pvars()
        blocks0 = pv["mpool_pool_blocks"].value
        bytes0 = pv["mpool_pool_bytes"].value
        blk = pool.acquire()
        assert pv["mpool_pool_blocks"].value == blocks0 + 1
        assert pv["mpool_pool_bytes"].value == bytes0 + 4096
        pool.discard(blk)
        assert pv["mpool_pool_blocks"].value == blocks0
        assert pv["mpool_pool_bytes"].value == bytes0
        assert pool._free == []
        nxt, hit = pool.acquire_pair()
        assert hit is False and nxt is not blk
        pool.release(nxt)
    finally:
        pool.close()


def test_acquire_pair_settles_exactly_once(P):
    pool = P.mpool.BufferPool(1024, max_free=4)
    try:
        a, hit_a = pool.acquire_pair()
        assert hit_a is False and pool.misses == 1 and pool.outstanding == 1
        pool.release(a)
        assert pool.outstanding == 0 and len(pool._free) == 1
        pool.release(a)  # a second settle must not park the block twice
        assert pool.outstanding == 0 and len(pool._free) == 1
        b, hit_b = pool.acquire_pair()
        assert hit_b is True and pool.hits == 1 and b is a
        pool.discard(b)
        assert pool.outstanding == 0
    finally:
        pool.close()


def test_mpool_pvars_registered(P):
    pv = P.var.all_pvars()
    for name in ("mpool_segments", "mpool_bytes", "mpool_pool_blocks",
                 "mpool_pool_bytes", "mpool_pool_hits", "mpool_pool_misses"):
        assert name in pv, name
        assert pv[name].value >= 0


# ------------------------------------------------------------------- smsc
def test_self_roundtrip(P):
    smsc = P.smsc
    if not smsc.available():
        pytest.skip("cma unavailable on this kernel")
    src = np.arange(1000, dtype=np.float32)
    dst = np.zeros_like(src)
    smsc.copy_from(os.getpid(), src.ctypes.data, dst)
    np.testing.assert_array_equal(src, dst)
    dst2 = np.zeros_like(src)
    smsc.copy_to(os.getpid(), dst2.ctypes.data, src)
    np.testing.assert_array_equal(src, dst2)


def test_buffer_handle_rules(P):
    a = np.zeros((4, 4), np.float64)
    pid, addr, nbytes = P.smsc.buffer_handle(a)
    assert pid == os.getpid() and addr == a.ctypes.data and nbytes == 128
    assert P.smsc.buffer_handle(a[:, 1]) is None      # non-contiguous
    assert P.smsc.buffer_handle(np.zeros(0)) is None  # empty


def test_bad_pid_raises(P):
    if not P.smsc.available():
        pytest.skip("cma unavailable on this kernel")
    dst = np.zeros(16, np.uint8)
    with pytest.raises(OSError):
        P.smsc.copy_from(2**22 - 3, dst.ctypes.data, dst)  # no such pid


def test_smsc_variable_and_help():
    from ompi_tpu.mca.var import all_vars as jvars
    from ompi_tpu_torch.mca.var import all_vars as tvars
    from ompi_tpu_torch.runtime import smsc  # noqa: F401 registers it

    j, t = jvars()["smsc_enable"], tvars()["smsc_enable"]
    assert (t.default, t.typ, t.level, t.help) == \
        (j.default, j.typ, j.level, j.help)


# -------------------------------------------------------------------- plm
def test_parse_hostfile(P, tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("# cluster\n"
                  "node1 slots=2\n"
                  "node2\n"
                  "\n"
                  "node3 slots=3  # trailing comment\n")
    plm = P.plm
    assert plm.parse_hostfile(str(hf)) == [
        plm.HostSpec("node1", 2), plm.HostSpec("node2", 1),
        plm.HostSpec("node3", 3)]


def test_parse_hostfile_bad_slots(P, tmp_path):
    hf = tmp_path / "hosts"
    hf.write_text("node1 slots=x\n")
    with pytest.raises(ValueError):
        P.plm.parse_hostfile(str(hf))
    hf.write_text("node1 slot=2\n")  # a typo'd keyword is refused too
    with pytest.raises(ValueError, match="unrecognized"):
        P.plm.parse_hostfile(str(hf))


def test_parse_host_list(P):
    plm = P.plm
    assert plm.parse_host_list("a:2,b") == [plm.HostSpec("a", 2),
                                            plm.HostSpec("b", 1)]


def test_assign_ranks_fill_and_wrap(P):
    hosts = [P.plm.HostSpec("a", 2), P.plm.HostSpec("b", 1)]
    assert P.plm.assign_ranks(hosts, 3) == ["a", "a", "b"]
    assert P.plm.assign_ranks(hosts, 5) == ["a", "a", "b", "a", "a"]


def test_is_local(P):
    assert P.plm.is_local("localhost")
    assert P.plm.is_local("127.0.0.1")
    assert not P.plm.is_local("definitely-not-this-host")


def test_remote_command_marshals_contract(P):
    env = {"OMPI_TPU_RANK": "3", "OMPI_TPU_MODEX": "10.0.0.1:5000",
           "PYTHONPATH": "/x:/y", "HOME": "/home/u", "SECRET": "no"}
    cmd = P.plm.remote_command(env, "prog.py", ["--a", "b c"], "/work")
    assert "OMPI_TPU_RANK=3" in cmd and "PYTHONPATH=/x:/y" in cmd
    assert "HOME" not in cmd and "SECRET" not in cmd
    assert cmd.startswith("cd /work && exec env ")
    assert "'b c'" in cmd


def test_remote_commands_agree_across_packages():
    from ompi_tpu.runtime import plm as J
    from ompi_tpu_torch.runtime import plm as T

    env = {"OMPI_TPU_RANK": "1", "JAX_PLATFORMS": "cpu", "TMPDIR": "/t x",
           "PYTHONPATH": "/p", "OTHER": "1"}
    for prog, args in (("prog.py", ["a", "b c"]), ("sh", ["-c", "echo"]),
                       ("./not-there", [])):
        assert T.remote_command(env, prog, args, "/w d") == \
            J.remote_command(env, prog, args, "/w d")
    assert T._FORWARD_ENV == J._FORWARD_ENV
    assert T.agent_argv("ssh -p 22") == J.agent_argv("ssh -p 22")
    assert T.agent_argv("fake")[-1] == "ompi_tpu_torch.tools.fake_rsh"


def _probe_script(tmp_path):
    script = tmp_path / "probe.py"
    script.write_text(
        "import json, os, sys\n"
        "keys = ('OMPI_TPU_RANK', 'OMPI_TPU_LAUNCHER_PID', 'LEAKED')\n"
        "out = {k: os.environ.get(k) for k in keys}\n"
        "out['argv'] = sys.argv[1:]\n"
        "open(sys.argv[1], 'w').write(json.dumps(out))\n")
    return script


@pytest.mark.parametrize("host", [None, "fakenode0"])
def test_spawn_rank_local_and_through_the_fake_agent(P, tmp_path, host):
    """A local rank is forked with the launcher's pid; a remote one gets
    only what the command line marshals (the fake agent scrubs the
    rest)."""
    script = _probe_script(tmp_path)
    out = tmp_path / "out.json"
    env = dict(os.environ, OMPI_TPU_RANK="5", LEAKED="yes",
               PYTHONPATH=ROOT)
    proc = P.plm.spawn_rank(host, "fake", env, str(script),
                            [str(out), "x y"], str(tmp_path))
    assert proc.wait(timeout=60) == 0
    got = json.loads(out.read_text())
    assert got["OMPI_TPU_RANK"] == "5" and got["argv"] == [str(out), "x y"]
    if host is None:
        assert got["OMPI_TPU_LAUNCHER_PID"] == str(os.getpid())
        assert got["LEAKED"] == "yes"
    else:
        assert got["OMPI_TPU_LAUNCHER_PID"] is None
        assert got["LEAKED"] is None


# ----------------------------------------------------------------- ifaces
def test_list_interfaces_sees_loopback(P):
    lst = P.ifaces.list_interfaces()
    assert lst, "no interfaces discovered"
    lo = [i for i in lst if i.loopback]
    assert lo and lo[0].addr.startswith("127."), lst


def test_weight_ordering(P):
    ifaces = P.ifaces
    lo = ifaces.Iface("lo", "127.0.0.1", "255.0.0.0", True, True)
    eth = ifaces.Iface("eth0", "10.1.2.3", "255.255.255.0", True, False)
    down = ifaces.Iface("eth1", "10.9.9.9", "255.255.255.0", False, False)
    assert ifaces.weight(eth, "10.1.2.50") > ifaces.weight(eth, "8.8.8.8")
    assert ifaces.weight(lo, "127.0.0.1") > 0
    assert ifaces.weight(lo, "10.1.2.50") == 0
    assert ifaces.weight(eth, "127.0.0.1") == 0
    assert ifaces.weight(down, "10.9.9.1") < 0


def test_pick_source_loopback_peer(P):
    src = P.ifaces.pick_source("127.0.0.1")
    assert src is None or src.startswith("127."), src


class _Route:
    """``socket.socket`` whose ``connect`` records its argument and makes
    no call to the kernel; ``getsockname`` answers the route's source."""

    def __init__(self, source):
        self.source, self.dialled = source, []
        route = self

        class Sock(socket.socket):
            def connect(self, addr):
                route.dialled.append(addr)
                if route.source is None:
                    raise OSError(101, "Network is unreachable")

            def getsockname(self):
                return (route.source, 40000)

        self.cls = Sock


@pytest.mark.parametrize("source", ["10.20.30.40", "127.0.0.1", None])
def test_best_local_addr_resolves(P, monkeypatch, source):
    route = _Route(source)
    monkeypatch.setattr(socket, "socket", route.cls)
    addr = P.ifaces.best_local_addr()
    assert addr is not None
    socket.inet_aton(addr)  # parseable IPv4
    assert route.dialled == [("203.0.113.1", 9)]
    if source == "10.20.30.40":
        assert addr == source
    else:  # no usable route: the first up interface, physical first
        ups = [i for i in P.ifaces.list_interfaces() if i.up]
        assert addr in {i.addr for i in ups}


def test_interfaces_agree_across_packages():
    from ompi_tpu.runtime import ifaces as J
    from ompi_tpu_torch.runtime import ifaces as T

    assert [tuple(i) for i in T.list_interfaces()] == \
        [tuple(i) for i in J.list_interfaces()]
    for peer in ("127.0.0.1", "10.1.2.50", "192.0.2.7", "8.8.8.8"):
        assert T.pick_source(peer) == J.pick_source(peer)


# ------------------------------------------------------------------ modex
def _modex_exchange(server_mod, client_mod):
    """One scripted exchange; returns what every call gave."""
    srv = server_mod.ModexServer(2)
    out = []
    c0 = c1 = None
    try:
        c0 = client_mod.ModexClient(srv.address, 0, 2, timeout=10)
        c1 = client_mod.ModexClient(srv.address, 1, 2, timeout=10)
        c0.put("card", {"host": "h0", "port": 1})
        c1.put("card", [1, 2.5, None])
        c0.put("svc", "addr:9", rank=-1)  # the name-service channel
        out += [c1.get(0, "card"), c0.get(1, "card"), c1.get(-1, "svc")]
        try:
            c0.get(1, "missing", timeout=0.05)
        except TimeoutError as e:
            out.append(("timeout", str(e)))
        t = threading.Thread(target=c1.fence)
        t.start()
        c0.fence()
        t.join(timeout=10)
        out.append(("fenced", not t.is_alive()))
        out.append(c0.spawn(3))
        out.append(c1.spawn(2))
        try:
            c0._rpc({"op": "nope"})
        except RuntimeError as e:
            out.append(("bad op", str(e)))
        c0.abort("boom")
        try:
            c1.fence()
        except RuntimeError as e:
            out.append(("after abort", str(e)))
    finally:
        for c in (c0, c1):
            if c is not None:
                c.close()
        srv.close()
    return out


@pytest.mark.parametrize("server", PKGS)
@pytest.mark.parametrize("client", PKGS)
def test_modex_clients_and_servers_interoperate(server, client):
    got = _modex_exchange(_load(server).modex, _load(client).modex)
    assert got == [
        {"host": "h0", "port": 1}, [1, 2.5, None], "addr:9",
        ("timeout", "modex key (1, missing) never appeared"),
        ("fenced", True), (1, 2), (2, 5),
        ("bad op", "bad op 'nope'"),
        ("after abort", "job aborted: boom")]


def test_modex_servers_reply_with_the_same_bytes():
    requests = [{"op": "put", "rank": 0, "key": "k", "val": {"a": [1]}},
                {"op": "get", "rank": 0, "key": "k"},
                {"op": "get", "rank": 3, "key": "k"},
                {"op": "spawn", "nprocs": 0},
                {"op": "spawn", "nprocs": 4},
                {"op": "fence", "rank": 0, "job": 9},
                {"op": "fence", "rank": 0, "job": 0},
                {"op": "what"}]
    replies = {}
    for root in PKGS:
        srv = _load(root).modex.ModexServer(1)
        try:
            with socket.create_connection((srv.host, srv.port),
                                          timeout=10) as s:
                f = s.makefile("rwb")
                lines = []
                for r in requests:
                    f.write(json.dumps(r).encode() + b"\n")
                    f.flush()
                    lines.append(f.readline())
        finally:
            srv.close()
        replies[root] = lines
    assert replies["ompi_tpu"] == replies["ompi_tpu_torch"]
    assert replies["ompi_tpu_torch"][1] == b'{"val": {"a": [1]}}\n'
