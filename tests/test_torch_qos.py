"""The port's QoS classes (``qos.py``) against the JAX package's, on the CPU.

The cases of ``tests/test_qos.py`` that launch no ranks and need no tcp btl
or ob1 pml, on both packages from the same inputs: the header bits, the tag
map (default, rewritten, malformed), the recovery planes, the
per-communicator override with its derived planes and Dup inheritance,
``resolve`` and the pvars. Classes and the stamped counts are equal.

Waiting for the btl (A.14.4) and ob1 (A.14.5): segmentation and
reassembly, per-class sequence planes, the shaped tcp queues, the handshake,
the round engine's plane, the Prometheus cell of the shape sampler and the
two process-mode runs.
"""

import pytest

from ompi_tpu import qos as jq
from ompi_tpu.comm import communicator as jcomm
from ompi_tpu.core.group import Group as JGroup
from ompi_tpu.mca import var as jvar
from ompi_tpu.pml import base as jbase
from ompi_tpu_torch import qos as tq
from ompi_tpu_torch.comm import communicator as tcomm
from ompi_tpu_torch.core.group import Group as TGroup
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.pml import base as tbase
from tests.test_torch_mca_fixture import mca_watched  # noqa: F401 fixture

NBC_CID_BIT = 1 << 28
COLL_CID_BIT = 1 << 30
PART_CID_BIT = 1 << 29
RESPAWN_STATE_TAG = 4242
RESHARD_TAG = 4300

TAGS = [-4600, -4500, -4243, -4242, -4244, -4245, -4800, -4900, -4400,
        -4300, -4000, -3999, -1, 0, 5, 4242, 4243, 4244, 4300]
CIDS = [0, 7, 123, 7 | NBC_CID_BIT, 7 | COLL_CID_BIT, 7 | PART_CID_BIT]


@pytest.fixture(autouse=True)
def clean():
    jq.reset_for_testing()
    tq.reset_for_testing()
    yield
    jq.reset_for_testing()
    tq.reset_for_testing()


def _classify_all(mod):
    return [mod.classify(tag, cid) for tag in TAGS for cid in CIDS]


def _stamped(var):
    return {c: var.all_pvars()[f"qos_stamped_{c}"].value
            for c in ("normal", "latency", "bulk")}


def test_constants_agree():
    for name in ("NORMAL", "LATENCY", "BULK", "NAMES", "_SYSTEM_TAG_BASE",
                 "_PLANE_SHIFT", "_CID_MASK"):
        assert getattr(tq, name) == getattr(jq, name), name
    assert tq._SYSTEM_TAG_BASE == tbase.SYSTEM_TAG_BASE


@pytest.mark.parametrize("cls", [0, 1, 2])
def test_header_qos_bits_roundtrip(cls):
    raw = tbase.pack_header(tbase.EAGER, 3, 17, 7, 5, 10, 2, 9, qos=cls)
    assert raw == jbase.pack_header(jbase.EAGER, 3, 17, 7, 5, 10, 2, 9,
                                    qos=cls)
    h = tbase.Header(raw)
    assert (h.kind, h.qos) == (tbase.EAGER, cls)
    assert tbase.pack_header(tbase.EAGER, 1, 0, 0, 1, 0, 0, 0) == \
        tbase.pack_header(tbase.EAGER, 1, 0, 0, 1, 0, 0, 0, qos=0)


@pytest.mark.parametrize("tag_map", [
    None,  # the default map
    "-4600:bulk,-4500:bulk,-4242:latency,-4243:latency,-4244:latency,"
    "-4245:latency",  # the reference's test map
    "-4400:bulk",
    "4244:latency, -4500 : normal,,",
    "-4600:bulk,bogus,-4500:turbo,7:LATENCY",  # malformed entries skipped
    "",
])
def test_classify_grid_and_counters_equal(tag_map, mca_watched):
    if tag_map is not None:
        mca_watched.both("qos", "tag_map", tag_map)
    tq.reset_for_testing()
    jq.reset_for_testing()
    got = _classify_all(tq)
    assert got == _classify_all(jq)
    assert _stamped(tvar) == _stamped(jvar)
    assert sum(_stamped(tvar).values()) == len(got)
    if tag_map is None:
        assert tq.classify(-4600, 0) == tq.BULK      # diskless ckpt
        assert tq.classify(-4500, 0) == tq.BULK      # metrics shipping
        assert tq.classify(-4243, 0) == tq.LATENCY   # heartbeats
        assert tq.classify(-4400, 0) == tq.NORMAL    # unlisted system tag
        assert tq.classify(RESPAWN_STATE_TAG, 0) == tq.BULK
        assert tq.classify(RESHARD_TAG, 0) == tq.BULK
        assert tq.classify(-4800, 0) == tq.LATENCY   # forensics dumps
        assert tq.classify(-4900, 0) == tq.LATENCY   # link probes
        # positive-tag entries apply only on the plane-free user cid
        assert tq.classify(RESPAWN_STATE_TAG, 7 | NBC_CID_BIT) == tq.NORMAL


def test_tag_map_cvar_rewrite_takes_effect(mca_watched):
    mca_watched.both("qos", "tag_map", "-4400:bulk")
    for mod in (tq, jq):
        assert mod.classify(-4400, 0) == mod.BULK
        assert mod.classify(-4600, 0) == mod.NORMAL  # replaced, not merged
    mca_watched.both("qos", "tag_map", "-4600:latency")
    assert tq.classify(-4600, 0) == jq.classify(-4600, 0) == tq.LATENCY


@pytest.mark.parametrize("cls", ["latency", "normal", "bulk", "LATENCY",
                                 0, 1, 2, "turbo", 7, -1, "3"])
def test_resolve(cls):
    try:
        want = jq.resolve(cls)
    except ValueError:
        with pytest.raises(ValueError):
            tq.resolve(cls)
        return
    assert tq.resolve(cls) == want


def _override_sequence(comm_mod, group_cls, mod):
    """The steps of the reference's override cases on one package; every
    classification is recorded."""
    out = []
    comm = comm_mod.Communicator(group_cls([0]), 611, name="qos-test")
    comm_mod._live_comms[611] = comm
    try:
        out.append(mod.classify(5, 611))
        comm.Set_qos_class("bulk")
        out.append(comm.Get_qos_class())
        out += [mod.classify(5, 611), mod.classify(5, 611 | NBC_CID_BIT),
                mod.classify(5, 611 | COLL_CID_BIT)]
        dup = comm_mod.Communicator(group_cls([0]), 612, name="qos-dup")
        comm._copy_attrs_to(dup)
        comm_mod._live_comms[612] = dup
        out.append(mod.classify(5, 612))
        comm.Set_qos_class("latency")
        out.append(mod.classify(5, 611))
        # a mapped recovery tag beats the comm's class
        out.append(mod.classify(RESPAWN_STATE_TAG, 611))
        comm.Delete_attr(mod.comm_keyval())
        out += [mod.classify(5, 611), mod.get_comm_class(comm),
                comm.Get_qos_class()]
    finally:
        comm_mod._live_comms.pop(611, None)
        comm_mod._live_comms.pop(612, None)
    return out


def test_comm_attr_override_and_derived_planes():
    got = _override_sequence(tcomm, TGroup, tq)
    assert got == _override_sequence(jcomm, JGroup, jq)
    assert got == [tq.NORMAL, "bulk", tq.BULK, tq.BULK, tq.BULK, tq.BULK,
                   tq.LATENCY, tq.BULK, tq.NORMAL, tq.NORMAL, "normal"]


def test_the_registry_is_empty_so_every_comm_classifies_normal():
    """Only a process-mode comm registers itself (``ProcComm.__init__``);
    until process mode is ported, a mesh-mode comm is never found and its
    traffic classifies NORMAL, as in the reference."""
    from ompi_tpu_torch.parallel.mesh import mesh_world

    w = mesh_world(2, "cpu")
    assert tcomm.lookup_comm(w.cid) is None
    assert len(tcomm._live_comms) == 0
    assert tq.classify(5, w.cid) == tq.NORMAL


def test_segment_and_reassembly_counters():
    for mod, var in ((tq, tvar), (jq, jvar)):
        mod.note_segments(4)
        mod.note_reassembled()
    for name in ("qos_segments", "qos_reassembled"):
        assert tvar.all_pvars()[name].value == \
            jvar.all_pvars()[name].value
    assert tvar.all_pvars()["qos_segments"].value == 4


def test_enabled_and_segment_bytes_follow_the_variables(mca_watched):
    assert tq.enabled() is jq.enabled() is False
    assert tq.segment_bytes() == jq.segment_bytes() == 262144
    mca_watched.both("btl_tcp", "shape_enable", 1)
    mca_watched.both("btl_tcp", "shape_segment_bytes", 4096)
    assert tq.enabled() is jq.enabled() is True
    assert tq.segment_bytes() == jq.segment_bytes() == 4096


def test_cvar_pvar_registration():
    for name in ("btl_tcp_shape_enable", "btl_tcp_shape_segment_bytes",
                 "qos_tag_map"):
        t, j = tvar.all_vars()[name], jvar.all_vars()[name]
        assert (t.default, t.typ, t.level) == (j.default, j.typ, j.level)
    for name in ("qos_stamped_normal", "qos_stamped_latency",
                 "qos_stamped_bulk", "qos_segments", "qos_reassembled"):
        assert name in tvar.all_pvars(), name
