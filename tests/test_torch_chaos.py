"""The port's fault planes (``ft/inject.py``, ``ft/revoke.py``,
``ft/detector.py``) against the JAX package's, on the CPU.

- The chaos harness: the cases of ``tests/test_chaos.py:43-133`` and
  ``:276-298`` on both packages. Parsed plans (their echo), refusals,
  arming, and the verdict sequences of ``wire_send`` and the receive-side
  filter for the same plan and seed are equal, the seeded ``frac`` draws
  bit for bit.
- Revocation: ``:389-425`` with a recording pml in place of ob1 (the calls
  that ``revoke_comm`` makes, and its dedup, are equal), and the notice
  handler through the live-comm registry.
- The detector: ``known_failed``, the failure propagator and observers, the
  link journal and its forensics provider.

Waiting for the btl (A.14.4) and ob1 (A.14.5): the tcp connect retries,
``drain_posted_for_src``, the resilient decorator, the mpilint guard, the
ob1 revoke drain, the recv-side rules over sliced tcp frames and the
process-mode chaos runs.
"""

import time

import numpy as np
import pytest

from ompi_tpu.ft import detector as jdet
from ompi_tpu.ft import inject as jinj
from ompi_tpu.ft import revoke as jrev
from ompi_tpu.mca import var as jvar
from ompi_tpu.pml import base as jbase
from ompi_tpu_torch.ft import detector as tdet
from ompi_tpu_torch.ft import inject as tinj
from ompi_tpu_torch.ft import revoke as trev
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.pml import base as tbase

PLAN = ("kill(1,after=40); drop(0,1,frac=0.5); drop(2,*,nth=3,side=recv);"
        "delay(0,1,ms=15); sever(0,1); dup(0,1,nth=2)")

PLANS = [
    PLAN,
    "preempt(2,after=5,grace_ms=250)",
    "corrupt(0,1,frac=0.25);corrupt(*,3)",
    "sever_transient(0,1,after=3,down_ms=40)",
    "blackhole(1,0,ms=30)",
    "drop(*,*)",
    "dup(1,*,frac=0.7,side=recv); delay(*,2,ms=1,side=recv)",
    "",
    " ; ",
]

BAD = [
    "explode(1)",              # unknown action
    "kill(*)",                 # kill needs a concrete rank
    "drop(1)",                 # missing dst
    "delay(0,1)",              # delay needs ms
    "sever(0,1,side=recv)",    # sever is send-side only
    "drop(0,1,bogus=1)",       # unknown kv
    "kill 1 after 2",          # unparseable
    "blackhole(0,1)",          # blackhole needs ms
    "sever_transient(0,1,down_ms=0)",
    "drop(0,1,side=both)",
    "kill(1,after=2,x=3)",
    "drop(0,nth=2,1)",         # positional after keyword
    "corrupt(0,1,side=recv)",
]


@pytest.fixture(autouse=True)
def clean_inject():
    yield
    tinj.uninstall()
    jinj.uninstall()


def _rules(mod, plan, seed=0):
    return [(repr(r), r.action, r.src, r.dst, r.frac, r.nth, r.ms, r.after,
             r.side) for r in mod.parse_plan(plan, seed)]


@pytest.mark.parametrize("plan", PLANS)
def test_plan_grammar(plan):
    assert _rules(tinj, plan) == _rules(jinj, plan)


def test_plan_grammar_reference_case():
    rules = tinj.parse_plan(PLAN)
    assert [r.action for r in rules] == \
        ["kill", "drop", "drop", "delay", "sever", "dup"]
    assert rules[0].src == 1 and rules[0].after == 40
    assert rules[2].dst is None and rules[2].side == "recv"
    assert rules[3].ms == 15.0


@pytest.mark.parametrize("bad", BAD)
def test_plan_grammar_rejects(bad):
    with pytest.raises(ValueError) as jerr:
        jinj.parse_plan(bad)
    with pytest.raises(ValueError) as terr:
        tinj.parse_plan(bad)
    assert str(terr.value) == str(jerr.value)


def test_install_arms_and_uninstall_disarms():
    assert tinj._enable_var._value is False  # plan cvar empty in-process
    tinj.install("drop(0,1,nth=2)")
    assert tinj._enable_var._value is True
    tinj.uninstall()
    assert tinj._enable_var._value is False


def _verdicts(mod, plan, seed, edges, n):
    mod.install(plan, seed=seed)
    out = [mod.wire_send(s, d) for _ in range(n) for s, d in edges]
    return out, mod.fault_counts()


EDGES = [(0, 1), (0, 2), (1, 0), (2, 1), (3, 3)]


@pytest.mark.parametrize("plan,seed", [
    ("drop(0,1,nth=1);dup(0,2,nth=1)", 0),
    ("drop(0,1,frac=0.5)", 7),
    ("drop(0,1,frac=0.5)", 8),
    ("drop(*,*,frac=0.3);dup(0,*,frac=0.6);corrupt(*,1,frac=0.1)", 12345),
    ("corrupt(0,1,nth=3);dup(2,1,nth=2)", 3),
    ("sever(0,1)", 0),
    ("sever(0,*)", 0),
    ("sever(*,*,after=3)", 0),
    ("sever_transient(0,1,after=2,down_ms=60000)", 0),
    ("drop(0,1,frac=0.5);drop(0,1,frac=0.5)", 2 ** 31 - 1),
])
def test_wire_send_verdicts_equal(plan, seed):
    """The verdict of every frame, for the same plan and seed: the ``frac``
    draws come from ``random.Random(seed ^ crc32(rule))`` in both."""
    got, counts = _verdicts(tinj, plan, seed, EDGES, 40)
    want, jcounts = _verdicts(jinj, plan, seed, EDGES, 40)
    assert got == want
    assert counts == jcounts
    assert tvar.all_pvars()["ft_injected_faults"].value == \
        jvar.all_pvars()["ft_injected_faults"].value == sum(counts.values())


def test_wire_send_verdicts_and_counters():
    tinj.install("drop(0,1,nth=1);dup(0,2,nth=1)")
    assert tinj.wire_send(0, 1) & tinj.DROP
    assert tinj.wire_send(0, 2) & tinj.DUP
    assert tinj.wire_send(1, 0) == 0  # edge filter
    counts = tinj.fault_counts()
    assert counts["drop"] == 1 and counts["dup"] == 1
    assert tvar.all_pvars()["ft_injected_faults"].value >= 2
    assert (tinj.DROP, tinj.DUP, tinj.SEVER, tinj.CORRUPT, tinj.TRANSIENT) \
        == (jinj.DROP, jinj.DUP, jinj.SEVER, jinj.CORRUPT, jinj.TRANSIENT)


def test_sever_fires_exactly_once_and_latches_per_edge():
    tinj.install("sever(0,1)")
    assert tinj.wire_send(0, 1) & tinj.SEVER
    assert tinj.wire_send(0, 1) == 0
    assert tinj.fault_counts()["sever"] == 1
    tinj.install("sever(0,*)")
    assert tinj.wire_send(0, 1) & tinj.SEVER
    assert tinj.wire_send(0, 2) & tinj.SEVER
    assert tinj.wire_send(0, 1) == 0 and tinj.wire_send(0, 2) == 0


@pytest.mark.parametrize("seed", [0, 7, 8, 99])
def test_frac_drops_are_seed_deterministic(seed):
    def schedule(mod, s):
        mod.install("drop(0,1,frac=0.5)", seed=s)
        return [bool(mod.wire_send(0, 1) & mod.DROP) for _ in range(64)]

    a, b = schedule(tinj, seed), schedule(tinj, seed)
    assert a == b == schedule(jinj, seed)
    assert a != schedule(tinj, seed + 1)
    assert any(a) and not all(a)


def test_sever_transient_holds_the_link_down():
    for mod in (tinj, jinj):
        mod.install("sever_transient(0,1,after=1,down_ms=60000)")
        v = mod.wire_send(0, 1)
        assert v == mod.SEVER | mod.TRANSIENT
        assert mod.link_down(1, 0) and mod.link_down(0, 1)
        assert not mod.link_down(0, 2)
    tinj.install("sever_transient(0,1,after=1,down_ms=1)")
    tinj.wire_send(0, 1)
    time.sleep(0.01)
    assert not tinj.link_down(0, 1)  # the window closed


def test_blackhole_drops_for_its_window_and_counts_once():
    tinj.install("blackhole(0,1,ms=60000)")
    assert all(tinj.wire_send(0, 1) & tinj.DROP for _ in range(5))
    assert tinj.wire_send(1, 0) == 0
    assert tinj.fault_counts() == {"blackhole": 1}


def _recv_filter(mod, base, plan, seed, frames):
    mod.install(plan, seed=seed)
    mod.note_rank(0)
    got = []
    deliver = mod.wrap_deliver(lambda h, p: got.append((h[:8], p)))
    for src, payload in frames:
        deliver(base.pack_header(1, src, 0, 3, 1, 4, 0, 0), payload)
    return got, mod.has_recv_rules(), mod.fault_counts()


@pytest.mark.parametrize("plan,seed", [
    ("drop(5,0,nth=1,side=recv)", 0),
    ("drop(*,0,frac=0.5,side=recv);dup(4,0,nth=2,side=recv)", 11),
    ("dup(*,*,frac=0.3,side=recv)", 5),
    ("drop(0,1)", 0),  # a send-side plan: the filter passes everything
])
def test_recv_side_wrap_filters_by_source(plan, seed):
    frames = [(s, f"f{i}".encode()) for i, s in
              enumerate([5, 4, 5, 4, 3, 5, 4, 4, 5, 3] * 3)]
    got = _recv_filter(tinj, tbase, plan, seed, frames)
    assert got == _recv_filter(jinj, jbase, plan, seed, frames)
    if plan == "drop(5,0,nth=1,side=recv)":
        assert all(h[1:5] != (5).to_bytes(4, "little") for h, _ in got[0])


def test_on_op_counts_only_user_tags_and_never_fires_off_the_victim():
    tinj.install("kill(3,after=2)")
    for tag in (-4243, -4000, 5):
        tinj.on_op(1, tag)  # another rank's ops: no count
    tinj.on_op(3, -4243)    # system-plane op: excluded
    tinj.on_op(3, 7)        # one op below the kill threshold
    assert tinj._kill_rules[0].count == 1
    assert tinj.fault_counts() == {}


def test_bad_plan_at_import_raises_with_a_banner():
    """``install()`` at import refuses a plan it cannot honour: the
    module's import raises after the show_help banner, in both packages."""
    import os
    import subprocess
    import sys

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    for pkg in ("ompi_tpu_torch", "ompi_tpu"):
        r = subprocess.run(
            [sys.executable, "-c", f"import {pkg}.ft.inject"],
            env={**os.environ, "JAX_PLATFORMS": "cpu",
                 "OMPI_TPU_MCA_ft_inject_plan": "explode(1)"},
            capture_output=True, text=True, timeout=120, cwd=root)
        assert r.returncode != 0
        assert "could not be parsed" in r.stderr and "ValueError" in r.stderr


def test_cvars_and_pvars_registered():
    for name in ("ft_inject_plan", "ft_inject_seed", "ft_enable",
                 "ft_heartbeat_period", "ft_heartbeat_timeout"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    assert tvar.all_vars()["ft_inject_plan"].default == ""
    assert "ft_injected_faults" in tvar.all_pvars()


def test_info_cli_lists_ft_surface(capsys):
    from ompi_tpu_torch.tools.info import main as info_main

    info_main(["--level", "9", "--param", "ft", "--pvars"])
    out = capsys.readouterr().out
    assert "ft_inject_plan" in out
    assert "ft_injected_faults" in out


# ---------------------------------------------------------------- revoke
class _RecPml:
    """Records what ``revoke_comm`` sends and drains (the ob1 pml's
    ``isend`` and ``revoke_requests``)."""

    def __init__(self, my_rank=0, fail_to=()):
        self.my_rank = my_rank
        self.calls = []
        self._fail_to = set(fail_to)

    def isend(self, buf, count, dt, dst, tag, cid, qos=None):
        if dst in self._fail_to:
            raise OSError("peer gone")
        self.calls.append(("isend", np.asarray(buf).tolist(), count,
                           dt.name, dst, tag, cid))

    def revoke_requests(self, cid):
        self.calls.append(("drain", cid))
        return 0


class _Grp:
    ranks = [0, 2, 5]


def _comm(pml, cid=11):
    class _Comm:
        name = "revoke-unit"
        revoked = False
        group = _Grp()

    c = _Comm()
    c.cid, c.pml = cid, pml
    return c


@pytest.mark.parametrize("my_rank,fail_to", [(0, ()), (2, ()), (0, (5,))])
def test_revoke_comm_floods_drains_and_dedups(my_rank, fail_to):
    out = []
    for mod in (trev, jrev):
        pml = _RecPml(my_rank, fail_to)
        comm = _comm(pml)
        mod.revoke_comm(comm)
        assert comm.revoked
        mod.revoke_comm(comm)  # re-entry: the flag dedups
        out.append(pml.calls)
    assert out[0] == out[1]
    assert out[0][-1] == ("drain", 11)
    assert all(c[5] == trev.REVOKE_TAG for c in out[0][:-1])
    assert trev.REVOKE_TAG == jrev.REVOKE_TAG
    assert trev.FT_CID_BIT == jrev.FT_CID_BIT


def test_revoke_of_a_comm_without_a_pml_is_local():
    from ompi_tpu_torch.parallel.mesh import mesh_world

    w = mesh_world(2, "cpu")
    trev.revoke_comm(w)
    assert w.revoked
    from ompi_tpu_torch.core.errors import MPIError

    with pytest.raises(MPIError):
        w.allreduce(w.shard(np.ones((2, 1), np.float32)))


def test_revoke_notice_reenters_through_the_registry():
    from ompi_tpu_torch.comm import communicator as tcomm

    pml = _RecPml(0)
    comm = _comm(pml, cid=97)
    hdr = tbase.Header(tbase.pack_header(tbase.EAGER, 5, 97,
                                         trev.REVOKE_TAG, 1, 8, 0, 0))
    trev.on_revoke_notice(hdr, b"")  # not registered: ignored
    assert not comm.revoked and pml.calls == []
    tcomm._live_comms[97] = comm
    try:
        trev.on_revoke_notice(hdr, b"")
        assert comm.revoked
        assert [c[4] for c in pml.calls[:-1]] == [2, 5]  # flood to peers
        trev.on_revoke_notice(hdr, b"")  # dedup
        assert len(pml.calls) == 3
    finally:
        tcomm._live_comms.pop(97, None)


# -------------------------------------------------------------- detector
@pytest.fixture
def clean_detectors():
    """Both detectors reset around the test; the JAX package's failure
    observers and propagator (bound by its process-mode Init, which an
    earlier test in this worker may have run) are put back."""
    saved = (list(jdet._callbacks), jdet._propagator)
    for mod in (tdet, jdet):
        mod._reset_for_testing()
        mod.set_propagator(None)
    yield
    for mod in (tdet, jdet):
        mod._reset_for_testing()
        mod.set_propagator(None)
    jdet._callbacks.extend(saved[0])
    jdet.set_propagator(saved[1])


def test_mark_failed_propagates_once_and_notifies(clean_detectors):
    from ompi_tpu_torch import mpit

    seen = {}
    for mod in (tdet, jdet):
        prop, obs = [], []
        mod.set_propagator(prop.append)
        mod.on_failure(obs.append)
        for r in (3, 1, 3, 7, 1):
            mod.mark_failed(r)
        seen[mod] = (sorted(mod.known_failed()), prop, obs,
                     mod._fx_debug_state())
    assert seen[tdet] == seen[jdet]
    assert seen[tdet][1] == [3, 1, 7]
    mpit.init_thread()
    try:
        assert mpit.event_get_index("ft_proc_failed") >= 0
    finally:
        mpit.finalize()


def test_detector_journal_carries_link_snapshot(clean_detectors):
    stats = {"srtt_us": 72000.0, "rtt_samples": 11, "loss_ppm": 8000.0,
             "goodput_bps": 1.5e9}
    out = []
    for mod in (tdet, jdet):
        mod.note_link_degraded(3)  # the tick raced ahead of the snapshot
        mod.note_link_degraded(3, link=stats)  # backfilled
        mod.note_link_degraded(3)  # tick-driven repeat: deduped
        mod.note_link_restored(3, link=dict(stats, loss_ppm=0.0))
        mod.note_link_degraded(4)
        ev = mod._fx_debug_state()["link_events"]
        out.append([(e["rank"], e["event"], e["link"]) for e in ev])
    assert out[0] == out[1]
    assert [e[1] for e in out[0]] == ["degraded", "restored", "degraded"]
    assert out[0][0][2]["srtt_us"] == 72000.0


class _Det:
    """A HeartbeatDetector's observable state, without its thread."""

    def __init__(self, mod, rank, size, age_s):
        self.d = mod.HeartbeatDetector(None, rank, size)
        self.d.last_seen = time.monotonic() - age_s


@pytest.mark.parametrize("rank,size,age_s", [(0, 4, 0.0), (2, 4, 1.5),
                                             (1, 2, 30.0), (0, 1, 9.0)])
def test_forensics_provider_shows_the_suspicion_map(clean_detectors, rank,
                                                    size, age_s):
    import weakref

    out = []
    for mod in (tdet, jdet):
        det = _Det(mod, rank, size, age_s)
        saved, mod._live_hb[0] = mod._live_hb[0], weakref.ref(det.d)
        try:
            hb = mod._fx_debug_state()["heartbeat"]
        finally:
            mod._live_hb[0] = saved
        hb.pop("last_seen_age_s")
        out.append(hb)
    assert out[0] == out[1]
    assert out[0]["observed"] == (rank - 1) % size
    assert out[0]["suspect"] == (size > 1 and age_s > 1.0)


def test_detector_is_a_forensics_provider(clean_detectors):
    from ompi_tpu_torch.runtime import forensics as fx

    assert fx.debug_state()["ft.detector"] == {"known_failed": []}
