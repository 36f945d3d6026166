"""The port's MPI_T surface against the JAX package's, on the CPU:
initialization, cvar, pvar and category enumeration, pvar sessions (read,
reset, stop, start, free) and events."""

import numpy as np
import pytest

from ompi_tpu import mpit as jmpit
from ompi_tpu_torch import mpit
from ompi_tpu_torch.coll import mesh as tcoll
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG, ERR_OTHER
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.runtime import spc
from ompi_tpu_torch.tools import info
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

W = 8


@pytest.fixture
def t():
    info._load_everything()
    mpit.init_thread()
    try:
        yield mpit
    finally:
        mpit.finalize()


def _x(w):
    return w.shard(np.ones((W, 4), np.float32))


def test_init_is_reference_counted():
    with pytest.raises(MPIError) as e:
        mpit.cvar_get_num()
    assert e.value.code == ERR_OTHER
    mpit.init_thread()
    mpit.init_thread()
    mpit.finalize()
    assert mpit.cvar_get_num() > 0
    mpit.finalize()
    with pytest.raises(MPIError):
        mpit.finalize()


def test_cvars_enumerate_every_variable(t):
    names = [t.cvar_get_info(i).name for i in range(t.cvar_get_num())]
    assert names == list(tvar.all_vars())
    i = t.cvar_get_index("quant_mode")
    inf = t.cvar_get_info(i)
    assert (inf.index, inf.name, inf.typ, inf.default, inf.level,
            inf.scope) == (i, "quant_mode", str, "int8", 4, "all")
    with pytest.raises(MPIError) as e:
        t.cvar_get_index("nosuch_var")
    assert e.value.code == ERR_ARG
    with pytest.raises(MPIError):
        t.cvar_get_info(t.cvar_get_num())


def test_cvar_handle_reads_and_writes(t, mca):
    mca.port("trace", "enable", False)  # restored after
    h = t.cvar_handle_alloc(t.cvar_get_index("trace_enable"))
    assert h.read() is False
    h.write("on")
    assert h.read() is True
    assert tvar.all_vars()["trace_enable"].source.name == "SET"


def test_readonly_cvar_refuses_a_write(t, monkeypatch):
    monkeypatch.setattr(tvar, "_registry", dict(tvar._registry))
    tvar.register_var("tmpit", "fixed", 3, scope=tvar.VarScope.READONLY)
    h = t.cvar_handle_alloc(t.cvar_get_index("tmpit_fixed"))
    with pytest.raises(MPIError, match="read-only"):
        h.write(4)
    assert h.read() == 3


def test_pvars_enumerate_registered_and_spc(t):
    spc.record("tmpit_probe", 3)
    names = [t.pvar_get_info(i).name for i in range(t.pvar_get_num())]
    for n in ("coll_mesh_cache_hits", "coll_mesh_cache_misses",
              "coll_mesh_compile_time_us", "persist_plans",
              "persist_starts", "persist_replay_us", "quant_colls",
              "quant_bytes_wire", "quant_bytes_saved",
              "trace_dropped_events", "trace_buffered_events",
              "spc_tmpit_probe"):
        assert n in names, n
    sess = t.PvarSession()
    h = sess.handle_alloc(t.pvar_get_index("spc_tmpit_probe"))
    assert h.read() == spc.get("tmpit_probe") >= 3


def test_session_reads_the_cache_stats(t):
    sess = t.PvarSession()
    hits, misses = (sess.handle_alloc(t.pvar_get_index(f"coll_mesh_{k}"))
                    for k in ("cache_hits", "cache_misses"))
    assert (hits.read(), misses.read()) == (tcoll.stats.hits,
                                            tcoll.stats.misses)
    hits.reset()
    misses.reset()
    w = mesh_world(W, "cpu")
    x = _x(w)
    for _ in range(3):
        w.allreduce(x)
    assert (hits.read(), misses.read()) == (2, 1)
    hits.stop()
    w.allreduce(x)
    assert hits.read() == 2  # frozen while stopped
    hits.start()
    assert hits.read() == 3
    sess.free()
    with pytest.raises(MPIError):
        hits.read()
    with pytest.raises(MPIError):
        sess.handle_alloc(0)


def test_categories_group_by_framework(t):
    cats = [t.category_get_info(i) for i in range(t.category_get_num())]
    by = {c.name: c for c in cats}
    for name in ("quant", "trace", "coll", "coll_persist", "persist",
                 "coll_mesh", "spc", "accelerator", "mca", "comm"):
        assert name in by, name
    q = by["quant"]
    assert (q.num_cvars, q.num_pvars, q.num_events) == (6, 3, 0)
    assert by["trace"].num_events == 2
    i = t.category_get_index("quant")
    assert sorted(t.cvar_get_info(c).name
                  for c in t.category_get_cvars(i)) == sorted(
        "quant_" + n for n in ("enable", "bits", "block", "min_bytes",
                               "mode", "strict"))
    with pytest.raises(MPIError):
        t.category_get_index("nosuch")


def test_event_types_are_the_references(t):
    # the modules that register event types, in both packages
    import ompi_tpu.runtime.forensics  # noqa: F401
    import ompi_tpu.runtime.metrics  # noqa: F401
    import ompi_tpu.runtime.sanitizer  # noqa: F401
    import ompi_tpu_torch.runtime.forensics  # noqa: F401
    import ompi_tpu_torch.runtime.metrics  # noqa: F401
    import ompi_tpu_torch.runtime.sanitizer  # noqa: F401

    jmpit.init_thread()
    try:
        jnames = {jmpit.event_get_info(i).full_name
                  for i in range(jmpit.event_get_num())}
    finally:
        jmpit.finalize()
    names = {t.event_get_info(i).full_name for i in range(t.event_get_num())}
    assert names == {"mca_component_selected", "comm_created",
                     "comm_revoked", "ft_proc_failed", "trace_span_begin",
                     "trace_span_end", "metrics_straggler_trip",
                     "forensics_stall", "forensics_dump",
                     "sanitizer_violation"}
    assert names <= jnames


def test_events_reach_subscribers_and_count_drops(t):
    seen = []
    created = t.event_handle_alloc(t.event_get_index("comm_created"),
                                   lambda e: seen.append(e))
    revoked = t.event_handle_alloc(t.event_get_index("comm_revoked"),
                                   lambda e: 1 / 0)
    try:
        w = mesh_world(W, "cpu")
        w.Revoke()
        w.Revoke()  # revoked once
    finally:
        created.free()
        revoked.free()
    assert [e.data["name"] for e in seen] == ["MESH_COMM_WORLD"]
    assert seen[0].data["size"] == W and seen[0].timestamp > 0
    assert revoked.dropped == 1
    mesh_world(W, "cpu")
    assert len(seen) == 1  # freed handles hear nothing
    with pytest.raises(MPIError):
        t.event_get_index("nosuch_event")
