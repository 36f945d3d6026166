"""The port's requests, progress engine, backoff, peruse and Info against
the JAX package's, on the CPU.

Every case runs on both packages (the ``P`` fixture), so each counts
twice:

- the request cases of ``tests/test_core_objects.py`` (completion, the
  multi-waits, raise-once errors, ``Grequest``, ``Prequest``) and
  ``test_info``;
- ``tests/test_backoff.py``'s six cases;
- the idle-block cases of ``tests/test_datapath.py``, twice: over the tcp
  btl pair they drive in the reference (``tcp_idle_env``), and over a
  socketpair stand-in whose progress function drains the read end and
  whose idle source exports that fd, both packages on the same stand-in
  (``idle_env``). The parked
  ``progress_until`` woken by a frame and by ``poke``, the timeout under a
  long cap, the poll-only cap, the disabled idle block, a
  ``ProgressThread`` that parks and stops fast, the exact low-priority
  cadence under threads, a request completion waking a parked ``Wait``,
  and the registered variables;
- ``tests/test_observability.py::test_peruse_events``, on the event API
  itself (the communicator that fires the events comes later).

Variables a test sets are put back (``tests/test_torch_mca_fixture.py``).
"""

import importlib
import random
import socket
import threading
import time
import types

import pytest

from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

PKGS = {"jax": "ompi_tpu", "torch": "ompi_tpu_torch"}


def _load(name):
    root = PKGS[name]
    mod = lambda m: importlib.import_module(f"{root}.{m}")  # noqa: E731
    return types.SimpleNamespace(
        name=name, request=mod("core.request"), info=mod("core.info"),
        errors=mod("core.errors"), status=mod("core.status"),
        datatype=mod("core.datatype"), progress=mod("runtime.progress"),
        var=mod("mca.var"), backoff=mod("utils.backoff"),
        peruse=mod("runtime.peruse"))


@pytest.fixture(params=sorted(PKGS))
def P(request):
    return _load(request.param)


def _set(mca, P, fw, name, value):  # noqa: F811
    (mca.jax if P.name == "jax" else mca.port)(fw, name, value)


def _blocks(P):
    return P.var.all_pvars()["runtime_progress_idle_blocks"].value


# ------------------------------------------------------------ requests
def test_completed_request(P):
    r = P.request.CompletedRequest(nbytes=16, source=2, tag=9)
    assert r.Test()
    st = P.status.Status()
    r.Wait(st)
    assert st.source == 2 and st.tag == 9
    assert st.Get_count(P.datatype.FLOAT32) == 4


def test_request_wait_with_async_completion(P):
    r = P.request.Request()
    threading.Timer(0.02, lambda: r._set_complete(0)).start()
    r.Wait(timeout=5.0)
    assert r.is_complete


def test_waitall_waitany(P):
    Request = P.request.Request
    rs = [Request() for _ in range(3)]
    rs[1]._set_complete(0)
    assert Request.Waitany(rs) == 1
    for r in rs:
        r._set_complete(0)
    Request.Waitall(rs)
    assert Request.Testall(rs)


def test_waitsome_returns_all_done_entries(P):
    Request = P.request.Request
    rs = [Request() for _ in range(4)]
    rs[0]._set_complete(0)
    rs[2]._set_complete(0)
    assert Request.Waitsome(rs) == [0, 2]
    r = Request()
    threading.Timer(0.02, lambda: r._set_complete(0)).start()
    assert Request.Waitsome([r, Request()]) == [0]
    assert Request.Waitsome([]) == []


def test_waitsome_error_completes_all_done_before_raising(P):
    Request = P.request.Request
    rs = [Request() for _ in range(3)]
    rs[0]._set_complete(P.errors.ERR_INTERN)  # failing entry first
    rs[1]._set_complete(0)
    rs[2]._set_complete(0)
    with pytest.raises(P.errors.MPIError):
        Request.Waitsome(rs)
    assert Request.Waitsome(rs) == [0, 1, 2]


def test_finish_raises_error_exactly_once_per_completion(P):
    r = P.request.Request()
    r._set_complete(P.errors.ERR_INTERN)
    with pytest.raises(P.errors.MPIError):
        r.Wait()
    r.Wait()  # an error already reported does not re-raise
    r._set_complete(P.errors.ERR_INTERN)  # a new completion re-arms it
    with pytest.raises(P.errors.MPIError):
        r.Wait()


def test_wait_timeout_raises_pending(P):
    with pytest.raises(P.errors.MPIError) as e:
        P.request.Request().Wait(timeout=0.05)
    assert e.value.code == P.errors.ERR_PENDING


def test_grequest(P):
    r = P.request.Grequest()
    assert not r.is_complete
    r.Complete()
    assert r.Test()


def test_grequest_query_cancel_free(P):
    seen = []
    r = P.request.Grequest(
        query_fn=lambda st: setattr(st, "tag", 42),
        free_fn=lambda: seen.append("free"),
        cancel_fn=lambda done: seen.append(("cancel", done)))
    r.Cancel()
    assert r.status.cancelled
    r.Complete()
    st = P.status.Status()
    r.Wait(st)
    r.Free()
    assert st.tag == 42 and st.cancelled
    assert seen == [("cancel", False), "free"]


def test_persistent_request(P):
    fired = []
    p = P.request.Prequest(lambda req: (fired.append(1), req._set_complete(0)))
    assert p.is_complete  # inactive
    p.Start()
    p.Wait()
    p.Start()
    p.Wait()
    assert len(fired) == 2


def test_startall_starts_each_persistent_request(P):
    fired = []
    ps = [P.request.Prequest(lambda req, i=i: (fired.append(i),
                                              req._set_complete(0)))
          for i in range(3)]
    P.request.Request.Startall(ps)
    P.request.Request.Waitall(ps)
    assert fired == [0, 1, 2] and all(p.persistent for p in ps)


def test_info(P):
    i = P.info.Info({"a": "1"})
    i.Set("b", "2")
    assert i.Get("b") == "2"
    assert i.Get_nkeys() == 2
    seen = []
    i.subscribe(lambda k, v: seen.append((k, v)))
    i.Set("c", "3")
    assert seen == [("c", "3")]
    d = i.Dup()
    i.Delete("a")
    assert d.Get("a") == "1" and i.Get("a") is None
    assert i.Get_nthkey(0) == "b" and "c" in i and dict(i.items()) == {
        "b": "2", "c": "3"}


# ------------------------------------------------------------ backoff
class _FixedRng(random.Random):
    """random() always returns the constructed value (jitter pinning)."""

    def __init__(self, value):
        super().__init__(0)
        self._value = value

    def random(self):
        return self._value


def test_doubling_under_cap_no_jitter(P):
    s = P.backoff.Schedule(base_s=0.1, cap_s=1.0, jitter=0.0)
    delays = [s.next_delay() for _ in range(6)]
    assert delays == pytest.approx([0.1, 0.2, 0.4, 0.8, 1.0, 1.0])


def test_jitter_bounds_and_determinism(P):
    Schedule = P.backoff.Schedule
    lo = Schedule(base_s=1.0, cap_s=8.0, jitter=0.5, rng=_FixedRng(0.0))
    hi = Schedule(base_s=1.0, cap_s=8.0, jitter=0.5,
                  rng=_FixedRng(1.0 - 1e-12))
    assert lo.next_delay() == pytest.approx(0.5)
    assert hi.next_delay() == pytest.approx(1.5, rel=1e-6)
    a = Schedule(base_s=0.5, jitter=0.5, rng=random.Random(7)).next_delay()
    b = Schedule(base_s=0.5, jitter=0.5, rng=random.Random(7)).next_delay()
    assert a == b


def test_retry_budget_binds(P):
    s = P.backoff.Schedule(base_s=0.0, retries=3, jitter=0.0)
    assert [s.next_delay() is not None for _ in range(4)] == \
        [True, True, True, False]
    assert s.exhausted()
    assert s.sleep() is False


def test_deadline_budget_binds(P):
    s = P.backoff.Schedule(base_s=0.0, deadline_s=-1.0, jitter=0.0)
    assert s.expired() and s.exhausted()
    assert s.next_delay() is None


def test_deadline_clamps_delay(P):
    s = P.backoff.Schedule(base_s=100.0, cap_s=100.0, deadline_s=0.05,
                           jitter=0.0)
    d = s.next_delay()
    assert d is not None and d <= 0.05


def test_unbounded_schedule_never_exhausts_and_clamps_exponent(P):
    s = P.backoff.Schedule(base_s=1e-9, cap_s=0.25, jitter=0.0)
    s.attempt = 10_000
    assert not s.exhausted()
    assert s.remaining() == float("inf")
    assert s.next_delay() == pytest.approx(0.25)


def test_seeded_schedules_agree_across_packages():
    from ompi_tpu.utils.backoff import Schedule as J
    from ompi_tpu_torch.utils.backoff import Schedule as T

    j = J(0.01, cap_s=0.5, retries=12, jitter=0.5, rng=random.Random(3))
    t = T(0.01, cap_s=0.5, retries=12, jitter=0.5, rng=random.Random(3))
    assert [j.next_delay() for _ in range(14)] == \
        [t.next_delay() for _ in range(14)]


# ---------------------------------------------------------- idle blocking
class SocketSource:
    """A transport stand-in: a socketpair whose progress function drains
    the read end and whose idle source exports that fd (the tcp btl's
    ``progress`` and ``idle_fds``)."""

    def __init__(self):
        self.tx, self.rx = socket.socketpair()
        self.rx.setblocking(False)
        self.got = []

    def progress(self) -> int:
        n = 0
        while True:
            try:
                data = self.rx.recv(4096)
            except BlockingIOError:
                return n
            if not data:
                return n
            self.got.append(data)
            n += 1

    def idle_fds(self):
        return [self.rx.fileno()], []

    def send(self, data: bytes) -> None:
        self.tx.send(data)

    def close(self) -> None:
        self.tx.close()
        self.rx.close()


@pytest.fixture
def idle_env(P):
    src = SocketSource()
    P.progress.register_progress(src.progress)
    P.progress.set_idle_sources([src.idle_fds])
    try:
        yield P, src
    finally:
        P.progress.unregister_progress(src.progress)
        P.progress.set_idle_sources([])
        src.close()


def test_frame_wakes_parked_progress_until(idle_env, mca):  # noqa: F811
    P, src = idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)  # 3 s park cap
    before = _blocks(P)
    t = threading.Timer(0.4, lambda: src.send(b"wake"))
    t.start()
    t0 = time.monotonic()
    ok = P.progress.progress_until(lambda: bool(src.got), timeout=10)
    el = time.monotonic() - t0
    t.join(timeout=5)
    assert ok and src.got[0] == b"wake"
    assert el < 1.5, f"woke in {el:.3f}s: parked past the frame"
    assert _blocks(P) > before


def test_progress_until_timeout_honored_under_long_cap(idle_env, mca):  # noqa: F811
    P, _ = idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    t0 = time.monotonic()
    assert not P.progress.progress_until(lambda: False, timeout=0.3)
    assert 0.25 < time.monotonic() - t0 < 1.5


def test_poke_wakes_parked_wait(idle_env, mca):  # noqa: F811
    P, _ = idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    flag = []

    def poker():
        flag.append(1)
        P.progress.poke()

    t = threading.Timer(0.3, poker)
    t.start()
    t0 = time.monotonic()
    assert P.progress.progress_until(lambda: bool(flag), timeout=10)
    el = time.monotonic() - t0
    t.join(timeout=5)
    assert el < 1.2, el


def test_request_completion_wakes_a_parked_wait(idle_env, mca):  # noqa: F811
    P, _ = idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    r = P.request.Grequest()
    t = threading.Timer(0.3, r.Complete)
    t.start()
    t0 = time.monotonic()
    assert P.progress.progress_until(lambda: r.is_complete, timeout=10)
    el = time.monotonic() - t0
    t.join(timeout=5)
    assert el < 1.2, el


def test_poll_only_source_caps_the_park(idle_env, mca):  # noqa: F811
    P, src = idle_env
    P.progress.set_idle_sources([src.idle_fds, None])
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    before = _blocks(P)
    t0 = time.monotonic()
    P.progress.progress_until(lambda: False, timeout=0.08)
    assert time.monotonic() - t0 < 1.0
    assert _blocks(P) == before  # blind sleeps, never a park


def test_idle_block_disabled_restores_sleep_backoff(idle_env, mca):  # noqa: F811
    P, _ = idle_env
    _set(mca, P, "runtime", "idle_block_us", 0)
    before = _blocks(P)
    P.progress.progress_until(lambda: False, timeout=0.05)
    assert _blocks(P) == before


def test_progress_thread_parks_and_stops_fast(idle_env, mca):  # noqa: F811
    P, _ = idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    before = _blocks(P)
    pt = P.progress.ProgressThread()
    pt.start()
    thread = pt._thread
    time.sleep(0.6)  # the hot window drains, then it must park
    t0 = time.monotonic()
    pt.stop()
    el = time.monotonic() - t0
    assert el < 1.0, f"stop() took {el:.2f}s: the poke missed the park"
    assert not thread.is_alive()
    assert _blocks(P) > before


def test_progress_cadence_is_exact_under_threads(P):
    """The every-8th low-priority cadence is an exact function of the
    counter values drawn, however many threads call progress()."""
    lock = threading.Lock()
    calls = [0]

    def low():
        with lock:
            calls[0] += 1
        return 0

    P.progress.register_progress(low, low_priority=True)
    try:
        c_before = next(P.progress._call_count)
        f0 = calls[0]
        threads = [threading.Thread(
            target=lambda: [P.progress.progress() for _ in range(200)])
            for _ in range(4)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
        fired = calls[0] - f0
        c_after = next(P.progress._call_count)
        expected = (c_after - 1) // 8 - c_before // 8
        assert abs(fired - expected) <= 2, (fired, expected)
        assert fired >= (4 * 200) // 8 - 2
    finally:
        P.progress.unregister_progress(low)


def test_progress_cvars_and_pvars_registered(P):
    vars_ = P.var.all_vars()
    assert vars_["runtime_idle_block_us"].default == 50000
    assert vars_["runtime_progress_thread"].default is True
    assert vars_["runtime_idle_block_us"].level == 5
    assert "runtime_progress_idle_blocks" in P.var.all_pvars()
    assert P.request._progress_fn is P.progress.progress
    assert P.request._wakeup_fn is P.progress.poke
    assert P.request._san_new is None and P.request._fx_note is None


def test_debug_state_keys_agree():
    from ompi_tpu.runtime import progress as J
    from ompi_tpu_torch.runtime import progress as T

    assert sorted(T._fx_debug_state()) == sorted(J._fx_debug_state())


# --------------------------------------- idle blocking over a tcp pair
@pytest.fixture
def tcp_idle_env(P):
    tcp = importlib.import_module(f"{PKGS[P.name]}.btl.tcp")
    pml = importlib.import_module(f"{PKGS[P.name]}.pml.base")
    got = []
    a = tcp.TcpBtl(lambda h, p: got.append((bytes(h), bytes(p))), my_rank=0)
    b = tcp.TcpBtl(lambda h, p: got.append((bytes(h), bytes(p))), my_rank=1)
    a.set_peers({1: f"127.0.0.1:{b.port}"})
    b.set_peers({0: f"127.0.0.1:{a.port}"})
    P.progress.register_progress(a.progress)
    P.progress.register_progress(b.progress)
    P.progress.set_idle_sources([a.idle_fds, b.idle_fds])
    try:
        yield P, a, b, got, pml.pack_header(1, 0, 0, 5, 1, 5, 0, 0)
    finally:
        P.progress.unregister_progress(a.progress)
        P.progress.unregister_progress(b.progress)
        P.progress.set_idle_sources([])
        a.finalize()
        b.finalize()


def test_tcp_frame_wakes_parked_progress_until(tcp_idle_env, mca):  # noqa: F811
    P, a, b, got, hdr = tcp_idle_env
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)  # 3 s park cap
    before = _blocks(P)
    t = threading.Timer(0.4, lambda: a.send(1, hdr, b"wake"))
    t.start()
    t0 = time.monotonic()
    ok = P.progress.progress_until(lambda: bool(got), timeout=10)
    el = time.monotonic() - t0
    t.join(timeout=5)
    assert ok and got[0][1] == b"wake"
    assert el < 1.5, f"woke in {el:.3f}s: parked past the frame"
    assert _blocks(P) > before


def test_tcp_progress_until_timeout_honored_under_long_cap(tcp_idle_env, mca):  # noqa: F811
    P = tcp_idle_env[0]
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    t0 = time.monotonic()
    assert not P.progress.progress_until(lambda: False, timeout=0.3)
    assert 0.25 < time.monotonic() - t0 < 1.5


def test_tcp_poke_wakes_parked_wait(tcp_idle_env, mca):  # noqa: F811
    P = tcp_idle_env[0]
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    flag = []

    def poker():
        flag.append(1)
        P.progress.poke()

    t = threading.Timer(0.3, poker)
    t.start()
    t0 = time.monotonic()
    assert P.progress.progress_until(lambda: bool(flag), timeout=10)
    el = time.monotonic() - t0
    t.join(timeout=5)
    assert el < 1.2, el


def test_tcp_poll_only_source_caps_the_park(tcp_idle_env, mca):  # noqa: F811
    P, a = tcp_idle_env[:2]
    P.progress.set_idle_sources([a.idle_fds, None])
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    t0 = time.monotonic()
    P.progress.progress_until(lambda: False, timeout=0.08)
    assert time.monotonic() - t0 < 1.0


def test_tcp_idle_block_disabled_restores_sleep_backoff(tcp_idle_env, mca):  # noqa: F811
    P = tcp_idle_env[0]
    _set(mca, P, "runtime", "idle_block_us", 0)
    before = _blocks(P)
    P.progress.progress_until(lambda: False, timeout=0.05)
    assert _blocks(P) == before


def test_tcp_progress_thread_parks_and_stops_fast(tcp_idle_env, mca):  # noqa: F811
    P = tcp_idle_env[0]
    _set(mca, P, "runtime", "idle_block_us", 3_000_000)
    before = _blocks(P)
    pt = P.progress.ProgressThread()
    pt.start()
    thread = pt._thread
    time.sleep(0.6)  # the hot window drains, then it must park
    t0 = time.monotonic()
    pt.stop()
    el = time.monotonic() - t0
    assert el < 1.0, f"stop() took {el:.2f}s: the poke missed the park"
    assert not thread.is_alive()
    assert _blocks(P) > before


# ------------------------------------------------------------ peruse
def test_peruse_events(P):
    peruse = P.peruse
    seen = []
    fn = lambda ev, info: seen.append((ev, info))  # noqa: E731
    for ev in peruse.EVENTS:
        peruse.subscribe(ev, fn)
    try:
        assert peruse.enabled
        peruse.fire("send_posted", dst=0, tag=77)
        peruse.fire("recv_posted", src=0, tag=77)
        peruse.fire("request_complete", tag=77)
        peruse.fire("request_complete", tag=77)
        assert [e for e, _ in seen] == ["send_posted", "recv_posted",
                                        "request_complete",
                                        "request_complete"]
        assert seen[0][1] == {"dst": 0, "tag": 77}
    finally:
        for ev in peruse.EVENTS:
            peruse.unsubscribe(ev, fn)
    assert not peruse.enabled
    peruse.fire("send_posted", dst=1)  # no subscriber: nothing recorded
    assert len(seen) == 4


def test_peruse_refuses_an_unknown_event():
    from ompi_tpu_torch.runtime import peruse

    with pytest.raises(ValueError, match="unknown PERUSE event"):
        peruse.subscribe("not_an_event", print)
    assert not peruse.enabled
