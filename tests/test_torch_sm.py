"""The port's shared-memory transport (``btl/sm.py``, ``native/ring.py``,
``native/sm_ring.cpp``) against the JAX package's, on the CPU.

- ``tests/test_sm.py``'s unit cases (``:30-150``) on both packages, each on
  the native ring and on the Python ring: the build, round trip, empty and
  oversize, fill then full, the wraparound stress, the native/Python cross
  on one ring, an ndarray payload and the oversized frame behind a
  backlog (which spills to an overflow file).
- Across the packages, one segment: a ring of one package and a ring of
  the other, native or Python on either side, move frames both ways; a
  port ``SmBtl`` and a JAX ``SmBtl`` deliver to each other, inline and
  through the overflow path. The segment header, the ring layout and the
  frame flags are the reference's.
- The port's own rules: ``SmRing(use_native=True)`` raises
  ``NativeBuildError`` with the compiler's output when the compiler is
  broken (the reference falls back to Python); CPU tensors are sent as
  their bytes; ``finalize`` unlinks the segment and every overflow file;
  ``btl_sm_fail_after`` and the ``node_id`` locality key behave as the
  reference's.

Procmode cases (``:157-193``) wait for ob1 and ``mpirun`` (A.14.5).
"""

import mmap
import os
import random

import numpy as np
import pytest
import torch

from tests.test_torch_btl_fixture import (  # noqa: F401 fixtures
    P, btl_clean, load, pump)

JX, TX = load("jax"), load("torch")
HDR_PML = TX.pml.HDR_SIZE
IMPLS = [True, False]


def _ring(M, use_native, nbytes=1 << 16):
    mm = mmap.mmap(-1, nbytes)
    r = M.ring.SmRing(mm, 0, nbytes, use_native=use_native)
    r.init()
    return r


@pytest.fixture(params=IMPLS, ids=["native", "python"])
def ring(P, request):
    return _ring(P, request.param)


def test_native_library_builds(P):
    assert P.native.get_lib() is not None
    assert hasattr(P.native.get_lib(), "smr_push2")


def test_ring_roundtrip(ring):
    assert ring.push(b"HDRX", b"payload") == 1
    assert ring.used() > 0
    assert ring.pop() == b"HDRXpayload"
    assert ring.pop() is None
    assert ring.used() == 0


def test_ring_empty_and_oversize(ring):
    assert ring.pop() is None
    assert ring.push(b"", b"x" * (1 << 17)) == -1  # can never fit
    cap = ring.capacity
    assert ring.push(b"", b"x" * (cap - 15)) == -1  # need+8 > cap


def test_ring_fill_then_full(ring):
    blob = b"y" * 1000
    pushed = 0
    while ring.push(b"HH", blob) == 1:
        pushed += 1
    assert pushed > 50
    assert ring.push(b"HH", blob) == 0  # full, retryable
    for _ in range(pushed):
        assert ring.pop() == b"HH" + blob
    assert ring.pop() is None


def _stress(ring, seed=7):
    rng = random.Random(seed)
    sent, got = [], []
    for i in range(4000):
        data = bytes([i % 256]) * rng.randrange(1, 3000)
        if ring.push(b"ZZ", data) == 1:
            sent.append(b"ZZ" + data)
        else:
            f = ring.pop()
            assert f is not None
            got.append(f)
        if rng.random() < 0.3:
            f = ring.pop()
            if f is not None:
                got.append(f)
    while (f := ring.pop()) is not None:
        got.append(f)
    return sent, got


def test_ring_wraparound_stress(ring):
    sent, got = _stress(ring)
    assert got == sent


def test_ring_cross_implementation(P):
    mm = mmap.mmap(-1, 1 << 14)
    py = P.ring.SmRing(mm, 0, 1 << 14, use_native=False)
    py.init()
    cc = P.ring.SmRing(mm, 0, 1 << 14, use_native=True)
    for i in range(200):
        py.push(b"AB", bytes([i]) * 97)
        f = cc.pop()
        if f is not None:
            assert f[:2] == b"AB"
    while cc.pop() is not None:
        pass
    assert cc.push(b"XY", b"z" * 513) == 1
    assert py.pop() == b"XY" + b"z" * 513


def test_ring_numpy_payload(ring):
    arr = np.arange(100, dtype=np.float64)
    assert ring.push(b"NP", arr) == 1
    f = ring.pop()
    np.testing.assert_array_equal(np.frombuffer(f[2:], np.float64), arr)


def test_ring_memory_equals_the_references_after_the_same_pushes():
    """The same pushes leave the same bytes in a ring of either package,
    native or Python: the layout is the reference's, byte for byte."""
    images = []
    for M in (JX, TX):
        for native in IMPLS:
            r = _ring(M, native, 1 << 13)
            rng = random.Random(11)
            for i in range(300):
                if r.push(b"K", bytes([i % 256]) * rng.randrange(1, 700)) != 1:
                    r.pop()
            images.append(bytes(r.mm))
    assert all(img == images[0] for img in images)


@pytest.mark.parametrize("producer", ["jax", "torch"])
@pytest.mark.parametrize("p_native", IMPLS, ids=["pn", "pp"])
@pytest.mark.parametrize("c_native", IMPLS, ids=["cn", "cp"])
def test_one_segment_two_packages(producer, p_native, c_native):
    """A producer of one package and a consumer of the other share one
    ring in one segment, native or Python on either side, through the
    wraparound stress and the zero-copy peek/advance."""
    A, B = (JX, TX) if producer == "jax" else (TX, JX)
    mm = mmap.mmap(-1, 1 << 15)
    prod = A.ring.SmRing(mm, 0, 1 << 15, use_native=p_native)
    prod.init()
    cons = B.ring.SmRing(mm, 0, 1 << 15, use_native=c_native)
    rng = random.Random(3)
    sent, got = [], []
    for i in range(3000):
        data = bytes([i % 256]) * rng.randrange(1, 2500)
        if prod.push(b"QQ", data) == 1:
            sent.append(b"QQ" + data)
        if rng.random() < 0.5:
            v = cons.peek()
            if v is not None:
                got.append(bytes(v))
                cons.advance()
    while (f := cons.pop()) is not None:
        got.append(f)
    assert got == sent


# ----------------------------------------------------------- the sm btl
def _sm_pair(A, B, got, n_ranks=2):
    a = A.sm.SmBtl(lambda h, p: None, my_rank=0, n_ranks=n_ranks)
    b = B.sm.SmBtl(lambda h, p: got.append((bytes(h), bytes(p))),
                   my_rank=1, n_ranks=n_ranks)
    a.set_peers({1: b.seg_path})
    b.set_peers({0: a.seg_path})
    return a, b


@pytest.mark.parametrize("native", IMPLS, ids=["native", "python"])
def test_sm_oversized_frame_with_backlog(P, native):
    P.set("btl_sm", "ring_bytes", 4096)
    P.set("btl_sm", "use_native", int(native))
    got = []
    a, b = _sm_pair(P, P, got)
    try:
        small = b"s" * 512
        hdr = b"H" * HDR_PML
        for _ in range(16):
            a.send(1, hdr, small)
        assert a._pending[1], "expected a backlog for this test"
        big = b"B" * 16384  # can never fit a 4KB ring
        a.send(1, hdr, big)
        tail = b"t" * 100
        a.send(1, hdr, tail)
        pump([a, b], lambda: len(got) == 18)
        payloads = [p for _, p in got]
        assert payloads[:16] == [small] * 16
        assert payloads[16] == big  # ordered, via overflow spill
        assert payloads[17] == tail
    finally:
        a.finalize()
        b.finalize()


def test_segment_constants_are_the_references():
    assert TX.sm._SEG_MAGIC == JX.sm._SEG_MAGIC
    assert TX.sm._SEG_HDR.format == JX.sm._SEG_HDR.format
    assert (TX.sm.SmBtl._INLINE, TX.sm.SmBtl._OVERFLOW) == \
        (JX.sm.SmBtl._INLINE, JX.sm.SmBtl._OVERFLOW)
    for name in ("HDR_BYTES", "MAGIC", "WRAP"):
        assert getattr(TX.ring, name) == getattr(JX.ring, name)
    assert TX.sm.node_id() == JX.sm.node_id()
    assert TX.sm.SmBtlComponent.PRIORITY == JX.sm.SmBtlComponent.PRIORITY
    assert TX.sm.SmBtl.bandwidth == JX.sm.SmBtl.bandwidth


@pytest.mark.parametrize("sender", ["jax", "torch"])
@pytest.mark.parametrize("s_native", IMPLS, ids=["sn", "sp"])
@pytest.mark.parametrize("r_native", IMPLS, ids=["rn", "rp"])
def test_sm_btls_of_both_packages_share_segments(sender, s_native, r_native,
                                                btl_clean):
    """A JAX SmBtl and a port SmBtl, native or Python rings on either
    side: inline frames, a backlog and an overflow spill arrive in order,
    both ways."""
    btl_clean.both("btl_sm", "ring_bytes", 1 << 14)
    btl_clean.jax("btl_sm", "use_native",
                  int(s_native if sender == "jax" else r_native))
    btl_clean.port("btl_sm", "use_native",
                   int(r_native if sender == "jax" else s_native))
    A, B = (JX, TX) if sender == "jax" else (TX, JX)
    got_b, got_a = [], []
    a = A.sm.SmBtl(lambda h, p: got_a.append(bytes(p)), my_rank=0, n_ranks=2)
    b = B.sm.SmBtl(lambda h, p: got_b.append(bytes(p)), my_rank=1, n_ranks=2)
    a.set_peers({1: b.seg_path})
    b.set_peers({0: a.seg_path})
    try:
        rng = np.random.RandomState(9)
        pay = [rng.bytes(int(n)) for n in rng.randint(1, 3000, 40)]
        pay.append(rng.bytes(1 << 16))  # can never fit: the overflow file
        pay.append(b"last")
        hdr = b"\x01" * HDR_PML
        for p in pay:
            a.send(1, hdr, p)
            b.send(0, hdr, p)
        pump([a, b], lambda: len(got_b) == len(pay) and
             len(got_a) == len(pay), timeout=20)
        assert got_b == pay and got_a == pay
    finally:
        a.finalize()
        b.finalize()


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.int8])
def test_cpu_tensor_payloads_arrive_as_their_bytes(dtype, btl_clean):
    btl_clean.port("btl_sm", "ring_bytes", 1 << 15)
    g = torch.Generator().manual_seed(2)
    small = (torch.randn(512, generator=g) * 40).to(dtype)
    big = (torch.randn(1 << 15, generator=g) * 40).to(dtype)  # overflow
    got = []
    a, b = _sm_pair(TX, TX, got)
    try:
        for t in (small, big, small[::2]):
            a.send(1, b"H" * HDR_PML, t)
        pump([a, b], lambda: len(got) == 3)
        want = [t.contiguous().view(torch.uint8).numpy().tobytes()
                for t in (small, big, small[::2])]
        assert [p for _, p in got] == want
    finally:
        a.finalize()
        b.finalize()


def test_finalize_unlinks_the_segment_and_overflow_files(P):
    P.set("btl_sm", "ring_bytes", 4096)
    got = []
    a, b = _sm_pair(P, P, got)
    seg_dir = os.path.dirname(a.seg_path)
    prefix = "ompi_tpu_ovf_r0_"
    before = {f for f in os.listdir(seg_dir) if f.startswith(prefix)}
    # fill the ring, then queue two spills that b never drains
    for _ in range(16):
        a.send(1, b"H" * HDR_PML, b"s" * 512)
    a.send(1, b"H" * HDR_PML, b"B" * 16384)
    a.send(1, b"H" * HDR_PML, b"C" * 16384)
    spills = {f for f in os.listdir(seg_dir) if f.startswith(prefix)} - before
    assert len(spills) == 2
    paths = [a.seg_path, b.seg_path]
    a.finalize()
    b.finalize()
    assert not any(os.path.exists(p) for p in paths)
    if P.name == "torch":
        # the port also removes spill files nobody consumed
        left = {f for f in os.listdir(seg_dir) if f.startswith(prefix)}
        assert not (left & spills)
    else:
        for f in spills:
            os.unlink(os.path.join(seg_dir, f))


def test_fail_after_injection_raises_after_n_sends(P):
    P.set("btl_sm", "fail_after", 3)
    got = []
    a, b = _sm_pair(P, P, got)
    try:
        for _ in range(3):
            a.send(1, b"H" * HDR_PML, b"ok")
        with pytest.raises(P.errors.MPIError, match="fault injection"):
            a.send(1, b"H" * HDR_PML, b"no")
        pump([a, b], lambda: len(got) == 3)
    finally:
        a.finalize()
        b.finalize()


def test_drain_pending_reconstitutes_overflow_payloads(P):
    P.set("btl_sm", "ring_bytes", 4096)
    got = []
    a, b = _sm_pair(P, P, got)
    try:
        for _ in range(16):
            a.send(1, b"H" * HDR_PML, b"s" * 512)
        big = bytes(range(256)) * 64
        a.send(1, b"H" * HDR_PML, big)
        out = a.drain_pending(1)
        assert out[-1] == (b"H" * HDR_PML, big)
        assert all(h == b"H" * HDR_PML for h, _ in out)
    finally:
        a.finalize()
        b.finalize()


# ------------------------------------------------ the native build raises
def test_native_ring_raises_when_the_build_fails(monkeypatch):
    monkeypatch.setattr(TX.native, "CXX", ("g++", "-fno-such-option-here",
                                           "-shared", "-fPIC"))
    monkeypatch.setattr(TX.native, "_lib", None)
    mm = mmap.mmap(-1, 1 << 14)
    with pytest.raises(TX.native.NativeBuildError,
                       match="fno-such-option-here"):
        TX.ring.SmRing(mm, 0, 1 << 14, use_native=True)
    # the Python ring is the caller's explicit choice, and still runs
    r = TX.ring.SmRing(mm, 0, 1 << 14, use_native=False)
    r.init()
    assert r.push(b"A", b"b") == 1 and r.pop() == b"Ab"
    assert TX.native._lib is None


def test_sm_btl_raises_when_the_build_fails(monkeypatch, btl_clean):
    monkeypatch.setattr(TX.native, "CXX", ("false",))
    monkeypatch.setattr(TX.native, "_lib", None)
    btl_clean.port("btl_sm", "use_native", 1)
    with pytest.raises(TX.native.NativeBuildError, match=r"exit 1.*false"):
        TX.sm.SmBtl(lambda h, p: None, my_rank=0, n_ranks=2)
    # the component does not turn a failed build into a Python ring
    with pytest.raises(TX.native.NativeBuildError):
        TX.sm.SmBtlComponent().query(deliver=lambda h, p: None, my_rank=0,
                                     n_ranks=2)


def test_a_strided_array_is_gathered_where_the_reference_raises(btl_clean):
    """A strided ndarray of 2-byte elements: the port's ring gathers it;
    the reference's ring views it as bytes first and raises ValueError
    (ROADMAP C)."""
    arr = np.arange(512, dtype=np.int16)[::2]
    r = _ring(TX, True)
    assert r.push(b"S", arr) == 1 and r.pop() == b"S" + arr.tobytes()
    with pytest.raises(ValueError, match="contiguous"):
        _ring(JX, True).push(b"S", arr)


def test_importing_the_btls_builds_nothing():
    """A fresh interpreter imports every btl module and the ring without
    building or loading the native library."""
    import subprocess
    import sys

    code = ("import ompi_tpu_torch.btl.sm, ompi_tpu_torch.btl.tcp, "
            "ompi_tpu_torch.btl.self_btl, ompi_tpu_torch.native.ring\n"
            "from ompi_tpu_torch import native\n"
            "from ompi_tpu_torch.ops import _build\n"
            "print(native._lib is None, _build.load.cache_info().currsize)\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True", "0"]
