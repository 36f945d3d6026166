"""The port's pml base (``ompi_tpu_torch/pml/base.py``) against the JAX
package's, on the CPU.

- The matching cases of ``tests/test_core_objects.py`` (wildcard against
  exact ordering, the earliest unexpected arrival, 10k pending posts) run
  on both packages (the ``P`` fixture), with the failure drains, cancel
  and the queue counters.
- The wire header is byte-compatible: the same fields pack to the same
  bytes in both packages, each decodes the other's, and the QoS bits ride
  the kind byte.
- ``user_traffic``, ``edge_args``, ``send_system`` and ``SystemPlane`` on
  a stand-in pml behave alike.
"""

import importlib
import sys
import time
import types

import numpy as np
import pytest

from ompi_tpu.pml import base as jb
from ompi_tpu_torch.pml import base as tb


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def P(request):
    return importlib.import_module(request.param + ".pml.base")


def _hdr(P, src, tag, cid, seq=0):
    return P.Header(P.pack_header(P.EAGER, src, cid, tag, seq, 0, 0, 0))


# ----------------------------------------- tests/test_core_objects.py cases
def test_match_ordering_wildcard_vs_exact(P):
    """An arrival matches the EARLIEST-posted eligible receive, even
    across the exact-bucket/wildcard split."""
    eng = P.MatchingEngine()
    wild = P.RecvRequest(None, 0, None, P.ANY_SOURCE, 7, 0)   # posted first
    exact = P.RecvRequest(None, 0, None, 3, 7, 0)             # second
    eng.post(wild)
    eng.post(exact)
    assert eng.match_posted(_hdr(P, 3, 7, 0)) is wild         # older wins
    assert eng.match_posted(_hdr(P, 3, 7, 0)) is exact
    assert eng.match_posted(_hdr(P, 3, 7, 0)) is None

    # reversed posting order: the exact bucket wins
    exact2 = P.RecvRequest(None, 0, None, 5, 1, 0)
    wild2 = P.RecvRequest(None, 0, None, P.ANY_SOURCE, P.ANY_TAG, 0)
    eng.post(exact2)
    eng.post(wild2)
    assert eng.match_posted(_hdr(P, 5, 1, 0)) is exact2
    assert eng.match_posted(_hdr(P, 5, 1, 0)) is wild2


def test_unexpected_wildcard_takes_earliest_arrival(P):
    eng = P.MatchingEngine()
    eng.add_unexpected(P.UnexpectedFrag(_hdr(P, 2, 9, 0), b"second-src"))
    eng.add_unexpected(P.UnexpectedFrag(_hdr(P, 1, 9, 0), b"later"))
    probe = P.RecvRequest(None, 0, None, P.ANY_SOURCE, 9, 0)
    assert eng.match_unexpected(probe).hdr.src == 2           # earliest
    assert eng.match_unexpected(probe).hdr.src == 1
    assert eng.match_unexpected(probe) is None
    assert eng.n_unexpected == 0


def test_matching_scales_to_10k_pending_posts(P):
    """10k fully-specified pending receives: each arrival matches in
    O(1)."""
    eng = P.MatchingEngine()
    N = 10_000
    for i in range(N):
        eng.post(P.RecvRequest(None, 0, None, i % 97, i, 0))
    assert eng.n_posted == N
    t0 = time.perf_counter()
    for i in range(N):
        got = eng.match_posted(_hdr(P, i % 97, i, 0))
        assert got is not None and got.tag == i
    dt = time.perf_counter() - t0
    assert eng.n_posted == 0
    assert dt < 5.0, f"matching degraded: {dt:.1f}s for {N} matches"


# ------------------------------------------------------ more of the engine
def test_any_tag_never_matches_a_system_tag(P):
    eng = P.MatchingEngine()
    req = P.RecvRequest(None, 0, None, P.ANY_SOURCE, P.ANY_TAG, 0)
    eng.post(req)
    assert eng.match_posted(_hdr(P, 0, P.SYSTEM_TAG_BASE - 1, 0)) is None
    assert eng.match_posted(_hdr(P, 0, 3, 1)) is None   # another cid
    got = eng.match_posted(_hdr(P, 4, 3, 0))
    assert got is req and req.matched
    assert (req.status.source, req.status.tag) == (4, 3)


def test_cancel_posted_and_find_unexpected(P):
    eng = P.MatchingEngine()
    a = P.RecvRequest(None, 0, None, 1, 5, 0)
    w = P.RecvRequest(None, 0, None, P.ANY_SOURCE, 5, 0)
    eng.post(a)
    eng.post(w)
    assert eng.cancel_posted(a) and eng.cancel_posted(w)
    assert not eng.cancel_posted(a)
    assert eng.n_posted == 0
    eng.add_unexpected(P.UnexpectedFrag(_hdr(P, 1, 5, 0), b"x"))
    assert eng.find_unexpected(P.ANY_SOURCE, 5, 0).payload == b"x"
    assert eng.n_unexpected == 1  # a probe does not remove


def test_failure_drains(P):
    eng = P.MatchingEngine()
    reqs = {
        "named": P.RecvRequest(None, 0, None, 2, 1, 0),
        "named_any_tag": P.RecvRequest(None, 0, None, 2, P.ANY_TAG, 0),
        "any_source": P.RecvRequest(None, 0, None, P.ANY_SOURCE, 1, 0),
        "other_cid": P.RecvRequest(None, 0, None, 3, 1, 7),
    }
    for r in reqs.values():
        eng.post(r)
    dead = eng.drain_posted_for_src(2)
    assert {id(r) for r in dead} == {id(reqs["named"]),
                                     id(reqs["named_any_tag"])}
    assert all(r.matched for r in dead) and eng.n_posted == 2
    revoked = eng.drain_posted_for_cids({0})
    assert revoked == [reqs["any_source"]] and eng.n_posted == 1
    state = eng.debug_state(time.monotonic())
    assert state["n_posted"] == 1 and state["posted"][0]["cid"] == 7


# ------------------------------------------------------------- wire format
FIELDS = [(tb.EAGER, 0, 0, 5, 1, 5, 0, 0, 0),
          (tb.RNDV_RTS, 3, 1 << 25, -4400, 99, 1 << 40, 7, 12345, 2),
          (tb.RNDV_ACK, 7, 2, 0, (1 << 63) - 1, 8, 1 << 33, 1, 3),
          (tb.RNDV_FIN, 1, 0, -1, 0, 0, 0, (1 << 64) - 1, 1)]


@pytest.mark.parametrize("fields", FIELDS)
def test_headers_are_byte_compatible(fields):
    *f, qos = fields
    raw = tb.pack_header(*f, qos=qos)
    assert raw == jb.pack_header(*f, qos=qos)
    assert len(raw) == tb.HDR_SIZE == jb.HDR_SIZE
    for dec in (tb.Header(raw), jb.Header(raw)):
        assert (dec.kind, dec.src, dec.cid, dec.tag, dec.seq, dec.nbytes,
                dec.offset, dec.msgid, dec.qos) == (*f, qos)
    assert tb.edge_args(tb.Header(raw), 4) == jb.edge_args(jb.Header(raw), 4)


def test_constants_agree():
    for name in ("ANY_SOURCE", "ANY_TAG", "SYSTEM_TAG_BASE", "EAGER",
                 "RNDV_RTS", "RNDV_CTS", "RNDV_DATA", "RNDV_FIN", "RNDV_ACK",
                 "HDR_SIZE", "QOS_SHIFT", "KIND_MASK"):
        assert getattr(tb, name) == getattr(jb, name), name
    # world_pml reads runtime/state.py's world, which comes with process
    # mode: until then there is none, as in the reference before Init
    assert "ompi_tpu_torch.runtime.state" not in sys.modules
    assert tb.world_pml() is None and tb.world_comm() is None


@pytest.mark.parametrize("tag,cid", [(0, 0), (5, 3), (-1, 0), (-3999, 0),
                                     (-4000, 0), (-4600, 0), (3, 1 << 25),
                                     (0, (1 << 25) - 1), (0, 1 << 30)])
def test_user_traffic_agrees(tag, cid):
    assert tb.user_traffic(tag, cid) == jb.user_traffic(tag, cid)


# --------------------------------------------------------- the system plane
class _StubPml:
    """Records isend calls and handler registrations."""

    def __init__(self, fail=False):
        self.sent, self.handlers, self.fail = [], {}, fail

    def isend(self, buf, count, datatype, dst, tag, cid):
        if self.fail:
            raise RuntimeError("link down")
        self.sent.append((bytes(buf), count, datatype.name, dst, tag, cid))

    def register_system_handler(self, tag, handler):
        self.handlers[tag] = handler


def test_send_system_and_system_plane(P):
    spc = importlib.import_module(
        P.__name__.replace("pml.base", "runtime.spc"))
    pml = _StubPml()
    before = spc.snapshot()
    P.send_system(pml, 3, {"k": [1, 2]}, -4500)
    assert pml.sent == [(b'{"k": [1, 2]}', 13, "MPI_BYTE", 3, -4500, 0)]
    assert spc.snapshot() == before  # suppressed from the user counters
    P.send_system(_StubPml(fail=True), 1, {}, -4500)  # never raises

    handler = lambda *a: None  # noqa: E731
    plane = P.SystemPlane(-4600, handler)
    plane.ensure(pml)
    plane.ensure(pml)  # same pml: registered once
    assert pml.handlers == {-4600: handler}
    other = _StubPml()
    plane.ensure(other)
    assert other.handlers == {-4600: handler}
    plane.send(other, 2, {"x": 1})
    assert other.sent[0][3:] == (2, -4600, 0)
    plane.reset()
    fresh = _StubPml()
    plane.ensure(fresh)
    assert fresh.handlers


def test_send_and_recv_requests_carry_their_fields(P):
    s = P.SendRequest(dst=3, tag=4, cid=5, nbytes=64)
    assert (s.dst, s.tag, s.cid, s.nbytes, s.convertor, s.msgid) == \
        (3, 4, 5, 64, None, 0)
    dt = importlib.import_module(
        P.__name__.replace("pml.base", "core.datatype"))
    buf = np.zeros(4, np.float32)
    r = P.RecvRequest(buf, 4, dt.FLOAT32, 2, 9, 0)
    assert r.matches(_hdr(P, 2, 9, 0)) and not r.matches(_hdr(P, 1, 9, 0))
    assert not r.is_complete and r.buf is buf
