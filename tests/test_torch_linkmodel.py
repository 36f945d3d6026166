"""The port's link telemetry (``runtime/linkmodel.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_linkmodel.py`` that need no tcp btl, on both
packages from the same inputs: the probe round over a stand-in source of
conn rows, the echo handler, the self-gated poll, the verdicts, the BDP
floor, the snapshot sampler and the detector's journal; and the estimators
folded from a sequence of conn rows (SRTT/RTTVAR, the goodput EWMA by
class, directional loss ppm), equal between the packages at the same fold
instants.

With the tcp btl (A.14.4), on both packages over real loopback conns (the
``P`` fixture of ``tests/test_torch_btl_fixture.py``): the passive SRTT
samples off the reliable envelope's acks, the ack batch sampling its
youngest frame, Karn's filter on retransmitted frames, the goodput credited
by class, the adaptive retransmit timer's bounds, a drop healed before the
fixed ceiling, no spurious strikes on a slow link, and the disabled path
that never calls the registry. The tcp btls register their conn source
at import, as the reference's does.

Waiting for ob1 (A.14.5): the process-mode runs with ``mpinet``;
``coll/hier``'s floor waits for A.14.6.
"""

import json
import time

import pytest

import ompi_tpu.btl.tcp  # noqa: F401 registers the conn source at import
import ompi_tpu_torch.btl.tcp  # noqa: F401 registers the conn source

from ompi_tpu import qos as jq
from ompi_tpu.mca import var as jvar
from ompi_tpu.pml import base as jbase
from ompi_tpu.runtime import linkmodel as J
from ompi_tpu.runtime import metrics as JM
from ompi_tpu_torch import qos as tq
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.pml import base as tbase
from ompi_tpu_torch.runtime import linkmodel as T
from ompi_tpu_torch.runtime import metrics as TM
from tests.test_torch_btl_fixture import (  # noqa: F401 fixtures
    P, btl_clean, pump, tcp_pair)
from tests.test_torch_mca_fixture import mca_watched  # noqa: F401 fixture


@pytest.fixture(autouse=True)
def lm_on():
    """The plane on around each test, with the registry and source reset
    (each package's source, its tcp btl's row walker, and its metrics
    samplers are put back)."""
    jsrc, jsamplers = J._source, dict(JM._samplers)
    tsrc, tsamplers = T._source, dict(TM._samplers)
    for m, v in ((T, tvar), (J, jvar)):
        v.set_var("linkmodel", "enable", True)
        m.reset_for_testing()
    yield
    for m, v in ((T, tvar), (J, jvar)):
        v.set_var("linkmodel", "enable", False)
        v.set_var("linkmodel", "probe_ms", 0.0)
        m.reset_for_testing()
    T.register_source(tsrc)
    J.register_source(jsrc)
    JM._samplers.update(jsamplers)
    TM._samplers.update(tsamplers)


class _FakePml:
    my_rank = 0

    def __init__(self):
        self.sent = []

    def register_system_handler(self, tag, fn):
        pass

    def isend(self, buf, count, datatype, dst, tag, cid, qos=None):
        self.sent.append((dst, tag, bytes(buf)))


def _row(peer, t, state="est", tx=10, rx=10):
    """One conn's stats row at fold instant ``t`` (the shape the tcp btl's
    walker yields)."""
    return {"peer": peer, "state": state, "srtt": 0.001 * (peer + 1) + t / 100,
            "rttvar": 0.0002 * peer, "rtt_n": int(10 * t) + peer,
            "queue_age_s": 0.0001 * peer, "tx_frames": tx + int(100 * t),
            "rx_frames": rx + int(50 * t),
            "acked_b": [int(1e6 * t * (c + 1) * (peer + 1)) for c in range(3)],
            "nack_retx_n": peer * int(3 * t), "retx_n": peer * int(5 * t),
            "crc_errs": int(t), "dedup_n": peer}


def _folds(m, metrics, instants, peers=(1, 2, 5)):
    rows = {"t": 0.0}
    m.register_source(lambda: [_row(p, rows["t"]) for p in peers])
    out = []
    for t in instants:
        rows["t"] = t
        m._fold(now=1000.0 + t)
        out.append(sorted(
            (p, mm.srtt_us, mm.rttvar_us, mm.rtt_samples,
             tuple(mm.goodput_bps), mm.loss_ppm, mm.rx_loss_ppm,
             mm.tx_frames, mm.retx_n, mm.nack_retx_n, mm.queue_delay_us,
             mm.state) for p, mm in m._models.items()))
    gauges = sorted((g["name"], tuple(sorted(g["labels"].items())),
                     g["value"]) for g in metrics.snapshot()["gauges"])
    return out, gauges


@pytest.mark.parametrize("instants", [
    [0.0, 0.1, 0.2, 0.5, 1.0],
    [0.0, 0.01, 0.02, 0.5],   # folds closer than _FOLD_MIN_S are skipped
    [0.3, 0.3, 0.9, 2.7],
])
@pytest.mark.parametrize("metrics_on", [False, True])
def test_folded_estimates_equal(instants, metrics_on, mca_watched):
    if metrics_on:
        mca_watched.both("metrics", "enable", True)
    TM.reset_for_testing()
    JM.reset_for_testing()
    t = _folds(T, TM, instants)
    j = _folds(J, JM, instants)
    assert t == j
    assert bool(t[1]) == metrics_on  # gauges only with the metrics plane


def test_edges_rows_and_sampler():
    for m in (T, J):
        m.register_source(lambda: [_row(3, 0.25), _row(1, 0.25)])
        m._fold(now=5.0, force=True)
    t, j = T.edges(), J.edges()
    assert t == j and [r["dst"] for r in t] == [1, 3]
    assert set(t[0]) == {"src", "dst", "srtt_us", "rttvar_us", "rtt_samples",
                         "goodput_bps", "loss_ppm", "rx_loss_ppm",
                         "tx_frames", "retx_n", "nack_retx_n",
                         "queue_delay_us", "state"}
    assert T.edge(3) == J.edge(3) and T.edge(9) is None
    assert T.describe_edge(3) == J.describe_edge(3)
    assert "link ->3 healthy" in T.describe_edge(3)
    T.register_linkmodel_sampler()
    lm = TM.snapshot()["samplers"]["btl_tcp_linkmodel"]
    assert set(lm) == {"edges", "probes_sent", "rtt_samples"}
    assert lm["edges"] == t


def test_quiesce_freezes_the_registry():
    rows = [_row(1, 0.1)]
    T.register_source(lambda: list(rows))
    T.quiesce()
    before = T.edges()
    rows[0] = _row(1, 0.9, state="degraded")
    T._fold(force=True)
    assert T.edges() == before
    T.quiesce()  # idempotent


def test_probe_round_pings_idle_links_only():
    out = []
    for m in (T, J):
        rows = [{"peer": 3, "state": "est", "tx_frames": 5},
                {"peer": 4, "state": "degraded", "tx_frames": 9}]
        m.register_source(lambda rows=rows: [dict(r) for r in rows])
        pml = _FakePml()
        rounds = [m.probe_round(time.monotonic(), pml),
                  m.probe_round(time.monotonic(), pml)]
        rows[0]["tx_frames"] = 6  # traffic moved: passive coverage resumed
        rounds.append(m.probe_round(time.monotonic(), pml))
        out.append((rounds, [(d, t, json.loads(p)) for d, t, p in pml.sent]))
    assert out[0] == out[1]
    assert out[0][0] == [[], [3], []]
    assert out[0][1] == [(3, T.LINKPROBE_TAG, {"op": "ping", "src": 0,
                                               "n": 0})]
    assert tvar.all_pvars()["linkmodel_probes_sent"].value == 1


def test_probe_echo_handler_replies_pong(monkeypatch):
    out = []
    for m, base in ((T, tbase), (J, jbase)):
        pml = _FakePml()
        monkeypatch.setattr(base, "world_pml", lambda pml=pml: pml)
        m._on_probe(None, json.dumps({"op": "ping", "src": 5,
                                      "n": 2}).encode())
        m._on_probe(None, json.dumps({"op": "pong", "n": 2}).encode())
        m._on_probe(None, b"not json")  # transport thread: no raise
        out.append([(d, t, json.loads(p)) for d, t, p in pml.sent])
    assert out[0] == out[1] == [(5, T.LINKPROBE_TAG, {"op": "pong", "n": 2})]


def test_probe_echo_without_a_world_sends_nothing():
    assert tbase.world_pml() is None
    T._on_probe(None, json.dumps({"op": "ping", "src": 5}).encode())


def test_probe_poll_disabled_and_cadence(mca_watched):
    calls = []
    T.register_source(lambda: calls.append(1) or [])
    mca_watched.port("linkmodel", "probe_ms", 0.0)
    assert T._probe_poll() == 0
    assert not calls  # opt-in: passive only by default
    mca_watched.port("linkmodel", "enable", False)
    mca_watched.port("linkmodel", "probe_ms", 5.0)
    assert T._probe_poll() == 0
    assert not calls  # disabled plane: the cadence never arms
    mca_watched.port("linkmodel", "enable", True)
    T._probe_next[0] = 0.0
    assert T._probe_poll() == 0  # no world pml: no probe
    assert calls == []
    assert T._probe_next[0] > 0.0


def test_note_rtt_sample_feeds_the_histogram(mca_watched):
    mca_watched.both("metrics", "enable", True)
    for m, mm in ((T, TM), (J, JM)):
        mm.reset_for_testing()
        for s in (0.0001, 0.002, 0.0007):
            m.note_rtt_sample(4, s)
    t = [(h["labels"], h["buckets"], h["count"])
         for h in TM.snapshot()["histograms"]]
    j = [(h["labels"], h["buckets"], h["count"])
         for h in JM.snapshot()["histograms"]]
    assert t == j and t[0][0] == {"src": "0", "dst": "4"}
    assert tvar.all_pvars()["linkmodel_rtt_samples"].value == 3


@pytest.mark.parametrize("row", [
    {"state": "est", "rtt_samples": 9, "srtt_us": 900.0, "loss_ppm": 0.0},
    {"state": "est", "rtt_samples": 9, "srtt_us": 60000.0, "loss_ppm": 0.0},
    {"state": "est", "rtt_samples": 9, "srtt_us": 900.0, "loss_ppm": 9000.0},
    {"state": "degraded", "rtt_samples": 9, "srtt_us": 900.0},
    {"state": "est", "rtt_samples": 0, "srtt_us": 0.0, "loss_ppm": 0.0},
    {"state": "est", "rtt_samples": 9, "srtt_us": 900.0,
     "loss_ppm": 285714.0, "nack_retx_n": 2, "tx_frames": 7},
    {"state": "est", "rtt_samples": 9, "srtt_us": 900.0,
     "loss_ppm": 285714.0, "nack_retx_n": 1, "tx_frames": 100},
    {"state": "est", "rtt_samples": 9, "srtt_us": 900.0,
     "loss_ppm": 90000.0, "nack_retx_n": 9, "tx_frames": 100},
    {},
])
def test_degraded_verdict_thresholds(row):
    assert T.degraded(row) == J.degraded(row)


def test_degraded_thresholds_follow_the_variables(mca_watched):
    row = {"state": "est", "rtt_samples": 9, "srtt_us": 900.0}
    assert not T.degraded(row)
    mca_watched.both("linkmodel", "rtt_degraded_us", 500.0)
    assert T.degraded(row) and J.degraded(row)


def test_cross_floor_bytes_bdp(mca_watched):
    for m in (T, J):
        mm = m.LinkModel(5)
        mm.rtt_samples, mm.srtt_us = 6, 10000.0          # 10ms
        mm.goodput_bps = [8e9, 0.0, 0.0]                # 1 GB/s
        with m._lock:
            m._models[5] = mm
        m.register_source(lambda: [])  # the fold must not clobber it
    assert T.cross_floor_bytes() == J.cross_floor_bytes()
    assert T.cross_floor_bytes() == pytest.approx(10_000_000, rel=0.01)
    mca_watched.port("linkmodel", "enable", False)
    assert T.cross_floor_bytes() == 0  # disabled: no floor


def test_probe_tag_classifies_latency():
    assert tq.classify(T.LINKPROBE_TAG, 0) == jq.classify(J.LINKPROBE_TAG, 0) \
        == tq.LATENCY
    tq.reset_for_testing()
    jq.reset_for_testing()


def test_cvars_pvars_registered():
    for name in ("linkmodel_enable", "linkmodel_probe_ms",
                 "linkmodel_rtt_degraded_us", "linkmodel_loss_degraded_ppm"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    for name in ("linkmodel_rtt_samples", "linkmodel_probes_sent",
                 "linkmodel_edges", "linkmodel_srtt_max_us",
                 "linkmodel_goodput_bps"):
        assert name in tvar.all_pvars(), name


# ------------------------------------------------- over real tcp conns
HDR = tbase.pack_header(1, 7, 0, 3, 1, 4, 0, 0)
HDR_LAT = tbase.pack_header(1, 7, 0, 3, 1, 4, 0, 0, qos=tq.LATENCY)


def _established(P, got_a, got_b):
    """Pair with the 7 -> 0 conn established, enveloped, and drained."""
    a, b = tcp_pair(P.tcp, P.tcp, got_a, got_b)
    b.send(0, HDR, b"warmup")
    pump([a, b], lambda: len(got_a) == 1)
    conn = b.conns[0]
    assert conn.rel
    pump([a, b], lambda: not conn.retx, timeout=3.0)
    return a, b, conn


def _fabricate(conn, ages, karn=()):
    now = time.monotonic()
    seqs = []
    with conn.wlock:
        for i, age in enumerate(ages):
            conn.tx_seq += 1
            conn.retx[conn.tx_seq] = (10, [], now - age, 0)
            conn.retx_bytes += 10
            seqs.append(conn.tx_seq)
            if i in karn:
                conn.karn.add(conn.tx_seq)
    return seqs


def test_passive_srtt_samples_on_ack(P):
    P.set("btl_tcp", "reliable", 1)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        for i in range(4):
            b.send(0, HDR, b"rtt-%d" % i)
            pump([a, b], lambda: not conn.retx, timeout=3.0)
        assert conn.rtt_n >= 1
        assert 0.0 < conn.srtt < 1.0
        assert conn.rttvar >= 0.0
    finally:
        a.finalize()
        b.finalize()


def test_ack_batch_samples_youngest_frame(P):
    P.set("btl_tcp", "reliable", 1)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        n0, srtt0 = conn.rtt_n, conn.srtt
        _fabricate(conn, ages=[0.8, 0.2])
        b._rel_ack_rx(conn, conn.tx_seq)
        assert conn.rtt_n == n0 + 1
        assert conn.srtt < srtt0 + 0.3, (srtt0, conn.srtt)
        assert not conn.retx
    finally:
        a.finalize()
        b.finalize()


def test_karn_filter_rejects_retransmitted_samples(P):
    P.set("btl_tcp", "reliable", 1)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        n0 = conn.rtt_n
        _fabricate(conn, ages=[0.5, 0.1], karn=(1,))
        b._rel_ack_rx(conn, conn.tx_seq)
        assert conn.rtt_n == n0 + 1
        assert conn.srtt > 0.05
        assert not conn.karn
        n1, srtt1, var1 = conn.rtt_n, conn.srtt, conn.rttvar
        _fabricate(conn, ages=[0.9, 0.9], karn=(0, 1))
        b._rel_ack_rx(conn, conn.tx_seq)
        assert (conn.rtt_n, conn.srtt, conn.rttvar) == (n1, srtt1, var1)
        assert not conn.karn
    finally:
        a.finalize()
        b.finalize()


def test_goodput_credits_acked_bytes_per_class(P):
    P.set("btl_tcp", "reliable", 1)
    lm = P.linkmodel
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        lm._fold(force=True)  # arm the per-edge rate baseline
        time.sleep(0.06)      # > _FOLD_MIN_S: the next fold rates a dt
        for i in range(12):
            b.send(0, HDR, b"n" * 256)
            b.send(0, HDR_LAT, b"l" * 64)
        pump([a, b], lambda: not conn.retx, timeout=3.0)
        assert conn.acked_b[P.qos.NORMAL] > conn.acked_b[P.qos.LATENCY] > 0
        assert conn.acked_b[P.qos.BULK] == 0
        lm._fold(force=True)
        row = lm.edge(0)
        assert row is not None
        assert row["goodput_bps"]["normal"] > 0.0
        assert row["goodput_bps"]["latency"] > 0.0
        assert row["goodput_bps"]["bulk"] == 0.0
        assert row["loss_ppm"] == 0.0
    finally:
        a.finalize()
        b.finalize()


def test_conn_timeout_adaptive_bounds(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "retx_adaptive", 1)
    P.set("btl_tcp", "rtt_min_samples", 8)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        conn.srtt, conn.rttvar, conn.rtt_n = 0.002, 0.0005, 7
        assert b._conn_timeout(conn, 0.2) == 0.2
        conn.rtt_n = 8
        assert b._conn_timeout(conn, 0.2) == pytest.approx(0.025)
        conn.srtt, conn.rttvar = 0.060, 0.010
        assert b._conn_timeout(conn, 0.2) == pytest.approx(0.100)
        conn.srtt = 0.500
        assert b._conn_timeout(conn, 0.2) == 0.2
        P.set("btl_tcp", "retx_adaptive", 0)
        conn.srtt, conn.rttvar = 0.002, 0.0005
        assert b._conn_timeout(conn, 0.2) == 0.2
    finally:
        a.finalize()
        b.finalize()


def test_adaptive_timer_heals_drop_before_fixed_ceiling(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "retx_timeout_ms", 4000.0)
    P.set("btl_tcp", "retx_adaptive", 1)
    P.set("btl_tcp", "rtt_min_samples", 4)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        while conn.rtt_n < 4:
            for j in range(8):
                b.send(0, HDR, b"warm-%d" % j)
            pump([a, b], lambda: not conn.retx, timeout=3.0)
        assert conn.srtt < 0.01, conn.srtt
        delivered = len(got_a)
        P.inject.install("drop(7,0,nth=2)")
        t0 = time.monotonic()
        b.send(0, HDR, b"fast-0")
        b.send(0, HDR, b"fast-1")  # dropped: only the timer can heal it
        pump([a, b], lambda: len(got_a) == delivered + 2, timeout=3.5)
        assert time.monotonic() - t0 < 2.0  # the 4 s ceiling never ran
        assert conn.retx_n >= 1
    finally:
        a.finalize()
        b.finalize()


def test_slow_link_no_spurious_strikes(P):
    P.set("btl_tcp", "reliable", 1)
    P.set("btl_tcp", "retx_adaptive", 1)
    P.set("btl_tcp", "rtt_min_samples", 8)
    P.set("btl_tcp", "retx_timeout_ms", 1000.0)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    sent = []
    real_transmit = b._rel_transmit
    try:
        conn.srtt, conn.rttvar, conn.rtt_n = 0.300, 0.010, 20
        _fabricate(conn, ages=[0.1])
        b._rel_transmit = lambda c, vecs, cls: sent.append(cls)
        b._rel_tick(time.monotonic())
        assert not sent and conn.retx_strikes == 0 and conn.retx_n == 0
        conn.srtt, conn.rttvar = 0.001, 0.001
        b._rel_tick(time.monotonic())
        assert sent and conn.retx_strikes == 1 and conn.retx_n == 1
    finally:
        b._rel_transmit = real_transmit
        with conn.wlock:
            conn.retx.clear()
            conn.retx_bytes = 0
        a.finalize()
        b.finalize()


def test_disabled_path_never_calls_registry(P, monkeypatch):
    P.set("linkmodel", "enable", False)
    monkeypatch.setattr(
        P.linkmodel, "note_rtt_sample",
        lambda *a, **k: pytest.fail("registry hook on disabled path"))
    P.set("btl_tcp", "reliable", 1)
    got_a, got_b = [], []
    a, b, conn = _established(P, got_a, got_b)
    try:
        b.send(0, HDR, b"quiet")
        pump([a, b], lambda: not conn.retx, timeout=3.0)
        assert conn.rtt_n >= 1  # the conn estimator still runs
    finally:
        a.finalize()
        b.finalize()


def test_the_tcp_btls_are_the_conn_sources(P):
    assert P.linkmodel._source is P.tcp._linkmodel_rows
    assert "btl_tcp_link" in P.metrics._samplers
