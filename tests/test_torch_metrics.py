"""The port's live metrics plane (``runtime/metrics.py``) against the JAX
package's, on the CPU.

The cases of ``tests/test_metrics.py`` that launch no ranks and need no
``pml/monitoring``, ``promexport`` CLI or ``mpitop``, on both packages from
the same inputs: histogram buckets, EWMA values, gauges, the snapshot
surface, the JSON export, the straggler tracker's trips and skew EWMAs, the
per-comm reclaim, the local trip, critical-path notes and the Prometheus
text, which is equal between the packages (the samplers, the pvars and the
clock masked) and parses under ``tools/promexport.py``'s grammar.

Waiting for ob1 (A.14.5): the stamps a process-mode comm ships over the
-4500 plane, Comm.Free's reclaim, the singleton-world Allreduce and the
process-mode straggler run; for ``pml/monitoring``: its histograms and the
comm-matrix sampler; for the tools (A.14.10): ``promexport`` and ``mpitop``.
"""

import json
import math
import os
import re
import tempfile

import numpy as np
import pytest

from ompi_tpu.mca import var as jvar
from ompi_tpu.runtime import metrics as J
from ompi_tpu.runtime import spc as jspc
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.runtime import metrics as T
from ompi_tpu_torch.runtime import spc as tspc
from tests.test_torch_mca_fixture import mca_watched  # noqa: F401 fixture
from tools.promexport import validate


@pytest.fixture(autouse=True)
def clean():
    """Both registries reset around each test; the samplers the other
    modules of both packages bound (their tcp btls', linkmodel's) are put
    back for the tests that run after these in this worker."""
    jsamplers, tsamplers = dict(J._samplers), dict(T._samplers)
    for m in (T, J):
        m.reset_for_testing()
    yield
    for m, v in ((T, tvar), (J, jvar)):
        v.set_var("metrics", "enable", False)
        m.stop_http()
        m.reset_for_testing()
    J._samplers.update(jsamplers)
    T._samplers.update(tsamplers)


def both(fn):
    return fn(T), fn(J)


# ---------------------------------------------------------------- registry
@pytest.mark.parametrize("values", [
    (0, 1, 2, 3, 1000), (4.7,), (0.5, 1.0, 1.0001, 2 ** 20, 2 ** 23),
    (10 ** 12,), (-3, 0, 7.25, 65536, 65537), ()])
def test_histogram_buckets_and_quantiles(values):
    def run(m):
        h = m.histogram("lat")
        for v in values:
            h.observe(v)
        return (h.counts, h.sum, h.count, h.edges(),
                [h.quantile(q) for q in (0.01, 0.5, 0.9, 0.99, 1.0)])

    t, j = both(run)
    assert t == j
    if values == (0, 1, 2, 3, 1000):
        counts = t[0]
        assert (counts[0], counts[1], counts[2], counts[10]) == (2, 1, 1, 1)
        assert t[4][1] == 2.0
    if values == (10 ** 12,):
        assert t[0][-1] == 1 and t[4][-1] == math.inf


@pytest.mark.parametrize("nbuckets", [1, 4, 24, 40])
def test_histogram_sizing_follows_the_variable(nbuckets, mca_watched):
    mca_watched.both("metrics", "hist_buckets", nbuckets)
    t, j = both(lambda m: m.histogram("sized").edges())
    assert t == j and len(t) == nbuckets + 1


def test_histogram_labels_are_distinct_series():
    for m in (T, J):
        m.observe("lat", 5.0, peer=1)
        m.observe("lat", 7.0, peer=2)
        assert m.histogram("lat", peer=1).count == 1
        assert m.histogram("lat", peer=2).count == 1


@pytest.mark.parametrize("alpha", [None, 0.5, 0.1, 1.0])
def test_ewma_update(alpha):
    samples = [10.0, 20.0, 0.0, 3.5, 1e6, 42.0]
    t, j = both(lambda m: ([m.ewma("w").update(s, alpha=alpha)
                            for s in samples], m.ewma("w").n))
    assert t == j
    if alpha == 0.5:
        assert t[0][:2] == [10.0, 15.0]


def test_gauges():
    for m in (T, J):
        m.gauge_set("g", 1.5)
        m.gauge_set("g", 2.5, verb="allreduce")
        m.gauge_set("g", 3, verb="allreduce", bytes=64)
        assert m.gauge_get("g") == 1.5
        assert m.gauge_get("g", verb="allreduce") == 2.5
        assert m.gauge_get("g", bytes=64, verb="allreduce") == 3.0
        assert m.gauge_get("missing") is None


def _fill(m, spc):
    spc.record("port_parity_counter")
    m.gauge_set("g", 3.0)
    m.gauge_set("bench_prologue_us", 1.94)
    m.gauge_set("bench_layer_overhead_us", 2.5, verb="allreduce")
    m.observe("lat", 2.0, peer=0)
    m.observe("pml_send_latency_us", 3.2, peer=1)
    m.observe("pml_send_latency_us", 900.0, peer=1)
    m.ewma_update("w", 5.0)
    for r in (0, 1, 2):
        m.ewma_update("coll_entry_skew_us", 100.0 * r, cid=0, rank=r)
    m.note_critpath(10.0, 250.5, 3.0, 0.0, rank=2)


def _registry_part(snap):
    return {k: snap[k] for k in ("gauges", "histograms", "ewmas")}


def test_snapshot_is_the_unified_surface():
    _fill(T, tspc)
    _fill(J, jspc)
    snap, jsnap = T.snapshot(), J.snapshot()
    assert snap["counters"] == tspc.snapshot()
    assert snap["counters"]["port_parity_counter"] >= 1
    assert "metrics_straggler_trips" in snap["pvars"]
    assert not any(k.startswith("spc_") for k in snap["pvars"])
    assert {"name": "g", "labels": {}, "value": 3.0} in snap["gauges"]
    assert _registry_part(snap) == _registry_part(jsnap)
    assert snap["samplers"]["critpath_bound"] == \
        jsnap["samplers"]["critpath_bound"]
    assert snap["samplers"]["critpath_bound"]["category"] == "wire"
    json.dumps(snap)
    # the plane's own pvars read alike (others count whatever ran before
    # in this process, which differs between the packages)
    mine = {n: v for n, v in snap["pvars"].items() if n.startswith("metrics_")}
    assert mine == {n: jsnap["pvars"][n] for n in mine}
    assert len(mine) == 4


def test_a_broken_sampler_is_recorded_not_fatal():
    for m in (T, J):
        m.register_sampler("broken", lambda: 1 / 0)
    t, j = T.snapshot(), J.snapshot()
    assert t["sampler_errors"] == j["sampler_errors"] == {
        "broken": "ZeroDivisionError: division by zero"}
    assert "broken" not in t["samplers"]


def test_export_json(tmp_path, mca_watched):
    mca_watched.port("metrics", "dir", str(tmp_path))
    T.gauge_set("g", 1.0)
    path = T.export_json()
    assert os.path.dirname(path) == str(tmp_path)
    assert os.path.basename(path) == "metrics-rank0.json"
    with open(path) as f:
        snap = json.load(f)
    assert snap["rank"] == 0 and "counters" in snap
    assert _registry_part(snap) == _registry_part(T.snapshot())
    assert os.listdir(tmp_path) == ["metrics-rank0.json"]  # no stray tmp


def test_default_snapshot_dir_is_per_job_under_tempdir(monkeypatch):
    monkeypatch.setenv("OMPI_TPU_LAUNCHER_PID", "12345")
    d = T.default_snapshot_dir()
    assert d == J.default_snapshot_dir() == os.path.join(
        tempfile.gettempdir(), "ompi-tpu-metrics-12345")
    monkeypatch.delenv("OMPI_TPU_LAUNCHER_PID")
    assert T.default_snapshot_dir().endswith(f"ompi-tpu-metrics-{os.getpid()}")


def test_export_json_defaults_off_the_cwd(monkeypatch, tmp_path,
                                          mca_watched):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setenv("OMPI_TPU_LAUNCHER_PID", str(os.getpid()))
    mca_watched.port("metrics", "dir", "")
    path = T.export_json()
    assert os.path.dirname(path) == T.default_snapshot_dir()
    assert path.startswith(str(tmp_path)) and os.path.exists(path)


def test_finalize_export_runs_once_and_only_when_enabled(tmp_path,
                                                          mca_watched):
    mca_watched.port("metrics", "dir", str(tmp_path))
    T._maybe_export()
    assert os.listdir(tmp_path) == []  # plane off: nothing written
    mca_watched.port("metrics", "enable", True)
    T._maybe_export()
    T._maybe_export()
    assert os.listdir(tmp_path) == ["metrics-rank0.json"]


# ----------------------------------------------------- straggler detection
def _rounds(m, rounds):
    tr = m.StragglerTracker()
    trips = []
    for idx, stamps in enumerate(rounds):
        for rank, ts, wrank in stamps:
            trips += tr.record(9, idx, rank, ts, wrank, len(stamps))
    ewmas = sorted((tuple(sorted(e["labels"].items())), e["value"], e["n"])
                   for e in m.snapshot()["ewmas"])
    return trips, ewmas


def _laggard(n_rounds, lags, base_step=1_000_000):
    return [[(r, idx * base_step + lag, 10 + r) for r, lag in enumerate(lags)]
            for idx in range(n_rounds)]


@pytest.mark.parametrize("rounds", [
    _laggard(8, [0, 30_000, 300]),
    _laggard(6, [0, 30_000]) + _laggard(6, [0, 0]) + _laggard(1, [0, 30_000]),
    _laggard(12, [0, 9_000, 100, 200]),
    _laggard(4, [0, 50_000, 0]),  # below the warm-up guard
    _laggard(10, [70_000, 0, 10, 20, 30]),
])
def test_straggler_tracker_trips_and_skews_equal(rounds):
    t, j = both(lambda m: _rounds(m, rounds))
    assert t == j
    if rounds == _laggard(8, [0, 30_000, 300]):
        assert [(r, w) for r, w, _s, _v in t[0]] == [(1, 11)]
        assert t[0][0][2] == 29700.0 and t[0][0][3] > 10000.0


def test_straggler_trip_rearms_after_decay():
    rounds = (_laggard(6, [0, 30_000]) + _laggard(6, [0, 0])
              + _laggard(1, [0, 30_000]))
    trips, _ = _rounds(T, rounds)
    assert len(trips) == 2


def test_straggler_threshold_and_warmup_follow_the_variables(mca_watched):
    mca_watched.both("metrics", "straggler_threshold_us", 500.0)
    mca_watched.both("metrics", "straggler_min_samples", 2)
    rounds = _laggard(3, [0, 1_000, 0])
    t, j = both(lambda m: _rounds(m, rounds))
    assert t == j and [(r, w) for r, w, _s, _v in t[0]] == [(1, 11)]


def test_tracker_eviction_sheds_the_stale_comm_not_the_live_one():
    def run(m):
        tr = m.StragglerTracker()
        for idx in range(tr.window + 8):   # cid 7: rank 1 never stamps
            tr.record(7, idx, 0, idx * 1000, 0, 2)
        trips = []
        for idx in range(6):
            base = idx * 1_000_000
            trips += tr.record(0, idx, 0, base, 0, 2)
            trips += tr.record(0, idx, 1, base + 30_000, 1, 2)
        return trips, list(tr._rows)

    t, j = both(run)
    assert t == j
    assert [(r, w) for r, w, _s, _v in t[0]] == [(1, 1)]
    assert len(t[1]) <= T.StragglerTracker.window + 1


def test_dead_cid_state_is_reclaimed():
    hooked = []
    T.register_forget_hook(hooked.append)
    T.register_forget_hook(lambda cid: 1 / 0)  # a broken hook is contained
    for m in (T, J):
        m.ewma_update("coll_entry_skew_us", 9.0, cid=77, rank=1)
        m.ewma_update("coll_entry_skew_us", 4.0, cid=78, rank=1)
        m._idx[77] = 5
        m._tracker._rows[(77, 4)] = {0: (1, 0)}
        m._tracker._nsamp[(77, 1)] = 3
        m._tracker._tripped.add((77, 1))
        m._forget_cid(77)
        assert 77 not in m._idx
        assert not any(k[0] == 77 for k in m._tracker._rows)
        assert not any(k[0] == 77 for k in m._tracker._nsamp)
        assert not any(k[0] == 77 for k in m._tracker._tripped)
    assert hooked == [77]
    t, j = both(lambda m: [e["labels"] for e in m.snapshot()["ewmas"]])
    assert t == j == [{"cid": "78", "rank": "1"}]
    with T._lock:
        T._forget_hooks.clear()


def test_trip_local_counts_and_banner(capfd):
    from ompi_tpu_torch import mpit

    before = int(tvar.all_pvars()["metrics_straggler_trips"].value)
    spc_before = tspc.get("metrics_straggler_trip")
    seen = []
    mpit.init_thread()
    try:
        h = mpit.event_handle_alloc(
            mpit.event_get_index("metrics_straggler_trip"),
            lambda inst: seen.append(inst.data))
        T._trip_local(3, 12345.0, 23456.0, "  rank 9 entered late")
        h.free()
    finally:
        mpit.finalize()
    assert tvar.all_pvars()["metrics_straggler_trips"].value == before + 1
    assert tspc.get("metrics_straggler_trip") == spc_before + 1
    assert seen == [{"cid": 3, "skew_us": 12345.0, "ewma_us": 23456.0}]
    err = capfd.readouterr().err
    assert "STRAGGLER" in err and "rank 9 entered late" in err


def test_coll_entry_is_a_noop_on_a_mesh_comm(mca_watched):
    """A mesh-mode comm has no pml: one controller holds every rank, so
    there is nothing to skew against and no stamp is taken."""
    from ompi_tpu_torch.parallel.mesh import mesh_world

    mca_watched.port("metrics", "enable", True)
    w = mesh_world(4, "cpu")
    T.on_coll_entry(w, "allreduce")
    out = w.allreduce(w.shard(np.ones((4, 2), np.float32)))
    assert float(out[0, 0]) == 4.0
    assert T._tracker._rows == {} and T._idx == {}


def test_world_handler_binds_nothing_before_process_mode(mca_watched):
    mca_watched.port("metrics", "enable", True)
    T._bind_world_handler()  # world_pml() is None: no plane to bind
    assert T._plane._pml_ref is None
    T._start_jobs()  # port 0 and period 0: no endpoint, no writer
    assert T._http_server is None and not T._writer_started


def test_note_critpath_pvars():
    for m in (T, J):
        m.note_critpath(1.0, 2.0, 30.0, 4.0, rank=3)
    for name in ("metrics_critpath_steps", "metrics_critpath_bound_rank",
                 "metrics_critpath_bound_category"):
        assert tvar.all_pvars()[name].value == jvar.all_pvars()[name].value
    assert tvar.all_pvars()["metrics_critpath_bound_category"].value == "wait"


# ------------------------------------------------------ prometheus render
def _render_registry(m, spc, snaps=None):
    _fill(m, spc)
    snap = m.snapshot()
    snap["counters"] = {"port_parity_counter": 1, "allreduce": 5}
    snap["pvars"] = {"p_int": 3, "p_bool": True, "p_float": 0.25,
                     "p_str": "wire", "p_list": [1, 2]}
    snap["samplers"] = {
        "pml_comm_matrix": [{"src": 0, "dst": 1, "msgs": 2, "bytes": 64}],
        "btl_tcp_shape_queued_by_class": {"normal": 1, "bulk": 7,
                                          "latency": True},
        "other": {"x": 1}}
    # a second rank's snapshot: only a comm root exports skew series
    other = dict(snap, rank=1, ewmas=[])
    return m.render_prometheus(snaps(snap, other) if snaps else [snap])


@pytest.mark.parametrize("multi", [False, True])
def test_prometheus_text_equal_and_parses(multi):
    snaps = (lambda a, b: [a, b]) if multi else None
    text = _render_registry(T, tspc, snaps)
    assert text == _render_registry(J, jspc, snaps)
    assert validate(text) == []
    assert 'ompi_metrics_bench_prologue_us{rank="0"} 1.94' in text
    assert ('ompi_metrics_bench_layer_overhead_us'
            '{rank="0",verb="allreduce"} 2.5') in text
    assert 'le="+Inf"' in text
    assert "# TYPE ompi_metrics_pml_send_latency_us histogram" in text
    for r in (1, 2):  # the skew series keep their subject rank
        assert (f'ompi_metrics_coll_entry_skew_us_ewma'
                f'{{cid="0",rank="{r}"}}') in text
    assert 'ompi_pml_peer_bytes{dst="1",rank="0",src="0"} 64.0' in text
    assert "p_str" not in text and "p_list" not in text
    if multi:
        assert 'ompi_metrics_g{rank="1"} 3.0' in text


_SAMPLE = re.compile(r'^([a-zA-Z_:][a-zA-Z0-9_:]*)(\{[^}]*\})? (\S+)$')


def parse_prometheus(text):
    out = {}
    for line in text.splitlines():
        if not line or line.startswith("#"):
            continue
        m = _SAMPLE.match(line)
        assert m, line
        out[(m.group(1), m.group(2) or "")] = float(m.group(3))
    return out


def test_live_render_parses_back_to_the_snapshot(mca_watched):
    """The live registry, pvars and counters included: every sample of the
    render is the snapshot's value (the check phase 4k makes on the card)."""
    _fill(T, tspc)
    snap = T.snapshot()
    text = T.render_prometheus([snap])
    assert validate(text) == []
    samples = parse_prometheus(text)
    for cname, v in snap["counters"].items():
        assert samples[("ompi_spc_" + T._prom_name(cname), '{rank="0"}')] \
            == float(v)
    for pname, v in snap["pvars"].items():
        if isinstance(v, (bool, int, float)):
            assert samples[("ompi_pvar_" + T._prom_name(pname),
                            '{rank="0"}')] == float(v)
    for g in snap["gauges"]:
        lbl = T._prom_labels(dict(g["labels"], rank=0) if "rank" not in
                             g["labels"] else g["labels"])
        assert samples[("ompi_metrics_" + g["name"], lbl)] == g["value"]


def test_validator_rejects_bad_text():
    assert validate("1bad{} 1.0\n")
    assert validate("m 1.0\nm 2.0\n")
    assert validate("# HELP m ok\n# TYPE m gauge\n"
                    'm{a="b"} 1.0\nm{a="c"} 2.0\n') == []


@pytest.mark.parametrize("raw", ["a.b-c", "9lives", "", "ok_name:x", "é"])
def test_prom_names_and_labels(raw):
    assert T._prom_name(raw) == J._prom_name(raw)
    lbl = {"k": raw + '"\\\n', raw or "_": 1}
    assert T._prom_labels(lbl) == J._prom_labels(lbl)
    for v in (1, 2.5, math.inf, -math.inf, True, 0):
        assert T._prom_num(v) == J._prom_num(v)


# ------------------------------------------------------------------ http
def test_http_endpoint_serves_metrics_and_json(mca_watched):
    import urllib.request

    mca_watched.port("metrics", "enable", True)
    T.gauge_set("g", 1.0)
    port = T.start_http(0)  # an ephemeral port on 127.0.0.1
    try:
        assert T.start_http(0) == port  # idempotent
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/metrics", timeout=30) as resp:
            assert resp.status == 200
            body = resp.read().decode()
        assert validate(body) == []
        assert "ompi_metrics_g" in body
        with urllib.request.urlopen(
                f"http://127.0.0.1:{port}/json", timeout=30) as resp:
            snap = json.loads(resp.read())
        assert "counters" in snap and "pvars" in snap
    finally:
        T.stop_http()
    assert T._http_server is None


def test_import_starts_no_thread_and_binds_no_port():
    """With ``metrics_http_port`` and ``metrics_snapshot_period`` at their
    defaults, importing the plane (and forensics, sanitizer and linkmodel
    with it) starts no thread."""
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import threading\n"
            "import ompi_tpu_torch.runtime.metrics as m\n"
            "import ompi_tpu_torch.runtime.forensics\n"
            "import ompi_tpu_torch.runtime.sanitizer\n"
            "import ompi_tpu_torch.runtime.linkmodel\n"
            "import ompi_tpu_torch.hook as h\n"
            "h.run_hooks('init_bottom')\n"
            "print(threading.active_count(), m._http_server)\n")
    env = {k: v for k, v in os.environ.items()
           if not k.startswith("OMPI_TPU_MCA_")}
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=120, cwd=root, env=env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["1", "None"]


def test_metrics_cvars_registered():
    for name in ("metrics_enable", "metrics_straggler_threshold_us",
                 "metrics_straggler_min_samples", "metrics_ewma_alpha",
                 "metrics_hist_buckets", "metrics_dir", "metrics_http_port",
                 "metrics_snapshot_period"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    assert tvar.all_vars()["metrics_http_port"].default == 0
    assert T.METRICS_TAG == J.METRICS_TAG == -4500
