"""Fixtures and helpers of the port's btl parity tests (this file holds no
test): ``P``, one namespace of the btl modules and the planes they call,
of the JAX package or of the port, so that each case runs on both; a
loopback pump that raises at its deadline; and the clean-up that puts
back every variable a case set (through ``set_var``, so that watchers
run), disarms fault injection and settles the tcp btls' by-class queue
gauges in both packages, so that nothing leaks into the next test of the
same worker.
"""

import importlib
import time
import types

import pytest

from tests.test_torch_mca_fixture import VarSetter

PKGS = {"jax": "ompi_tpu", "torch": "ompi_tpu_torch"}


def load(name: str) -> types.SimpleNamespace:
    root = PKGS[name]
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    ns = types.SimpleNamespace(
        name=name, root=root, tcp=mod("btl.tcp"), sm=mod("btl.sm"),
        self_btl=mod("btl.self_btl"), base=mod("btl.base"),
        ring=mod("native.ring"), native=mod("native"),
        inject=mod("ft.inject"), var=mod("mca.var"), pml=mod("pml.base"),
        quant=mod("quant"), qos=mod("qos"), linkmodel=mod("runtime.linkmodel"),
        metrics=mod("runtime.metrics"), forensics=mod("runtime.forensics"),
        progress=mod("runtime.progress"), spc=mod("runtime.spc"),
        mpool=mod("runtime.mpool"), errors=mod("core.errors"),
        info=mod("tools.info"))
    ns.reset_quant = (ns.quant._reset_for_testing if name == "jax"
                      else ns.quant.reset_counters)
    ns.pvar = lambda n: ns.var.all_pvars()[n].value
    return ns


def settle_shape_gauges() -> None:
    """Zero both packages' by-class queue gauges (a case that died with
    frames queued must not leave them counted)."""
    for name in PKGS:
        tcp = load(name).tcp
        for i in range(3):
            tcp._qbytes[i] = 0
            tcp._qpeak[i] = 0


@pytest.fixture
def btl_clean():
    """Every variable set through the returned setter is put back, fault
    injection is disarmed in both packages and the shape gauges settled."""
    setter = VarSetter(watched=True)
    try:
        yield setter
    finally:
        setter.restore()
        for name in PKGS:
            load(name).inject.uninstall()
        settle_shape_gauges()


@pytest.fixture(params=sorted(PKGS))
def P(request, btl_clean):
    """The package under test, with ``P.set(fw, name, value)`` setting its
    variable for the case's duration."""
    ns = load(request.param)
    ns.set = btl_clean.jax if ns.name == "jax" else btl_clean.port
    return ns


def pump(btls, until, timeout=8.0):
    """Progress ``btls`` until ``until()``; raise at the deadline."""
    t0 = time.monotonic()
    while not until():
        for b in btls:
            b.progress()
        if time.monotonic() - t0 > timeout:
            raise TimeoutError("loopback pump timed out")
        time.sleep(0.001)


def tcp_pair(tcp_a, tcp_b, got_a, got_b, rank_a=0, rank_b=7):
    """Two live TcpBtls (of either package) with both addresses known,
    delivering owned copies of their frames into ``got_a``/``got_b``."""
    a = tcp_a.TcpBtl(lambda h, p: got_a.append((bytes(h), bytes(p))),
                     my_rank=rank_a)
    b = tcp_b.TcpBtl(lambda h, p: got_b.append((bytes(h), bytes(p))),
                     my_rank=rank_b)
    b.set_peers({rank_a: f"127.0.0.1:{a.port}"})
    a.set_peers({rank_b: f"127.0.0.1:{b.port}"})
    return a, b
