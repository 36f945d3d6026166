"""The port's link telemetry (``runtime/linkmodel.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_linkmodel.py`` that need no tcp btl, on both
packages from the same inputs: the probe round over a stand-in source of
conn rows, the echo handler, the self-gated poll, the verdicts, the BDP
floor, the snapshot sampler and the detector's journal; and the estimators
folded from a sequence of conn rows (SRTT/RTTVAR, the goodput EWMA by
class, directional loss ppm), equal between the packages at the same fold
instants.

Waiting for the btl (A.14.4): the passive SRTT samples off the reliable
envelope's acks, Karn's filter on retransmitted frames, the adaptive
retransmit timer, the disabled-path check over a real conn and the
process-mode runs with ``mpinet``; ``coll/hier``'s floor waits for A.14.6.
"""

import json
import time

import pytest

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
from tests.test_torch_mca_fixture import mca_watched  # noqa: F401 fixture


@pytest.fixture(autouse=True)
def lm_on():
    """The plane on around each test, with the registry and source reset
    (the JAX package's source, its tcp btl's row walker, and its metrics
    samplers are put back)."""
    jsrc, jsamplers = J._source, dict(JM._samplers)
    for m, v in ((T, tvar), (J, jvar)):
        v.set_var("linkmodel", "enable", True)
        m.reset_for_testing()
    yield
    for m, v in ((T, tvar), (J, jvar)):
        v.set_var("linkmodel", "enable", False)
        v.set_var("linkmodel", "probe_ms", 0.0)
        m.reset_for_testing()
    T.register_source(None)
    J.register_source(jsrc)
    JM._samplers.update(jsamplers)


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
