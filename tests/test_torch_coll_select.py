"""The port's coll selection and spc counters against the JAX package's,
on the CPU.

- ``providers`` and ``fallback_providers`` of the world, Split,
  Create_group, Dup, Cart and Sub comms equal JAX's (``xla`` read as
  ``mesh``), with quant off, with ``quant_enable`` set, with it set under
  ``coll=^quant``, and with ``coll`` naming no component.
- After the same verb sequence, the spc snapshot equals JAX's, and so do
  the deltas of the cache pvars (``coll_mesh_*`` against ``coll_xla_*``).
- A selection emits the MPI_T ``mca component_selected`` event, naming
  the same winner.
"""

import numpy as np
import pytest

import jax

from ompi_tpu import mpit as jmpit
from ompi_tpu.mca.var import all_pvars as jall_pvars
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.runtime import spc as jspc
from ompi_tpu_torch import mpit as tmpit
from ompi_tpu_torch.mca.var import all_pvars as tall_pvars
from ompi_tpu_torch.osc.window import MeshWin
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.runtime import spc as tspc
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

from ompi_tpu.osc.window import MeshWin as JMeshWin

W = 8
_axis = [0]

COMMS = {
    "world": lambda w: w,
    "dup": lambda w: w.Dup(),
    "split": lambda w: w.Split([r % 2 for r in range(W)]),
    "split_undefined": lambda w: w.Split([0, 0, -32766, 1, 1, -32766, 0, 1]),
    "create_group": lambda w: w.Create_group([0, 2, 5]),
    "cart": lambda w: w.Create_cart([2, 4], [True, False]),
    "sub": lambda w: w.Create_cart([2, 4], [True, False]).Sub([False, True]),
}
SETTINGS = {
    "plain": {},
    "quant": {"quant_enable": True},
    "quant_excluded": {"quant_enable": True, "coll_coll": "^quant"},
    "nothing_allowed": {"coll_coll": "nosuch"},
}


def _names(d):
    return {k: (v.replace("xla", "mesh") if isinstance(v, str)
                else [n.replace("xla", "mesh") for n in v])
            for k, v in d.items()}


def _jax_world():
    _axis[0] += 1
    return jax_mesh_world(jax.devices()[:W], axis_name=f"tcs{_axis[0]}")


def _apply(mca, setting):
    for full, value in SETTINGS[setting].items():
        fw, name = full.split("_", 1)
        mca.both(fw, name, value)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
@pytest.mark.parametrize("kind", sorted(COMMS))
def test_providers_equal_jax(mca, kind, setting):
    _apply(mca, setting)
    jc, tc = (COMMS[kind](w) for w in (_jax_world(), mesh_world(W, "cpu")))
    assert tc.coll.providers == _names(jc.coll.providers)
    assert tc.coll.fallback_providers == _names(jc.coll.fallback_providers)
    if setting == "quant" and kind in ("world", "dup", "cart"):
        assert tc.coll.providers["allreduce"] == "quant"
        assert tc.coll.fallbacks["allreduce"] == [
            tc.coll.get("reduce").__self__.allreduce]
    if setting == "nothing_allowed":
        assert tc.coll.providers == {}
        with pytest.raises(NotImplementedError):
            tc.allreduce(tc.shard(np.ones((W, 2), np.float32)))


def _ranked(shape=(4,), k=0):
    base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    return np.stack([base + r + k for r in range(W)])


def sequence(w, win_cls):
    """Every verb kind: blocking, rooted, grouped, topology, nonblocking,
    persistent (frozen and not), partitioned, reshard and the window's
    fence barrier."""
    x, b = w.shard(_ranked()), w.shard(_ranked((W, 2)))
    for _ in range(2):
        w.allreduce(x)
        w.reduce(x, root=1)
        w.bcast(x, 0)
        w.bcast(x, 3)
        w.allgather(x)
        w.alltoall(b)
        w.reduce_scatter(b)
        w.scan(x)
        w.exscan(x)
        w.gather(x, 0)
        w.scatter(b, 2)
        w.barrier()
        w.shift(x, 1)
    w.iallreduce(x).Wait()
    w.ibcast(x, 1).Wait()
    w.ibarrier().Wait()
    for init in (w.allreduce_init, w.allgather_init, w.scan_init):
        req = init(x)
        for k in range(2):
            req.Start(w.shard(_ranked(k=k)))
            req.Wait()
    s = w.Split([r % 2 for r in range(W)])
    s.allreduce(x)
    s.allgather(x)
    c = w.Create_cart([2, 4], [True, True])
    c.neighbor_allgather(x)
    c.cart_shift(x, 0, 1)
    w.reshard(w.shard(_ranked((W, W))), (0, None), (None, 0))
    p = w.Psend_init(b, [(i, (i + 1) % W) for i in range(W)], 2)
    p.Start()
    p.Pready_range(0, 1)
    p.Wait()
    win = win_cls(w, (4,))
    win.Fence()
    win.Put(np.ones(4, np.float32), 3)
    win.Fence()


def _pvars(allp, prefix):
    return {k.replace(prefix, ""): allp()[k].value
            for k in ("cache_hits", "cache_misses")
            for k in [prefix + k]}


@pytest.mark.parametrize("setting", ["plain", "quant", "persist_off"])
def test_spc_snapshot_and_cache_counts_equal_jax(mca, setting):
    if setting == "quant":
        _apply(mca, "quant")
        mca.both("quant", "min_bytes", 16)
    elif setting == "persist_off":
        mca.both("coll_persist", "enable", 0)
    jw, tw = _jax_world(), mesh_world(W, "cpu")
    jspc.reset()
    tspc.reset()
    j0 = _pvars(jall_pvars, "coll_xla_")
    t0 = _pvars(tall_pvars, "coll_mesh_")
    sequence(jw, JMeshWin)
    sequence(tw, MeshWin)
    want, got = jspc.snapshot(), tspc.snapshot()
    assert got == want
    # 2 barriers, the ibarrier and the two fences
    assert got["allreduce"] >= 4 and got["barrier"] == 5
    if setting == "quant":
        assert got["quant_allreduce"] > 0
    jd = {k: v - j0[k] for k, v in _pvars(jall_pvars, "coll_xla_").items()}
    td = {k: v - t0[k] for k, v in _pvars(tall_pvars, "coll_mesh_").items()}
    assert td == jd
    # the spc counters surface as pvars
    assert tall_pvars()["spc_allreduce"].value == got["allreduce"]


def test_suppressed_traffic_is_not_counted():
    tw = mesh_world(W, "cpu")
    x = tw.shard(_ranked())
    tspc.reset()
    with tspc.suppressed():
        tw.allreduce(x)
        with tspc.suppressed():
            tw.barrier()
        tw.bcast(x, 0)
    tw.allreduce(x)
    assert tspc.snapshot() == {"allreduce": 1}


def test_spc_enable_gates_recording(mca):
    tw = mesh_world(W, "cpu")
    tspc.reset()
    mca.port("spc", "enable", False)
    tw.allreduce(tw.shard(_ranked()))
    assert tspc.snapshot() == {}


def test_selection_emits_component_selected(mca):
    seen = {"jax": [], "port": []}
    handles = []
    for pkg, mod in (("jax", jmpit), ("port", tmpit)):
        mod.init_thread()
        handles.append((mod, mod.event_handle_alloc(
            mod.event_get_index("mca_component_selected"),
            lambda e, pkg=pkg: seen[pkg].append(
                (e.data["framework"], e.data["component"])))))
    try:
        mca.both("quant", "enable", True)
        _jax_world().Split([r % 2 for r in range(W)])
        mesh_world(W, "cpu").Split([r % 2 for r in range(W)])
    finally:
        for mod, h in handles:
            h.free()
            mod.finalize()
    assert seen["port"] == [(f, c.replace("xla", "mesh"))
                            for f, c in seen["jax"]]
    assert seen["port"] == [("coll", "quant"), ("coll", "mesh")]


def test_suppression_holds_per_thread_under_contention():
    """Threads that suppress and threads that record at once: nothing
    recorded inside ``suppressed()`` counts, everything outside does (one
    counter a thread, so the relaxed add loses nothing), and the count of
    suppressing threads returns to 0."""
    import sys
    import threading

    n_threads, n = 16, 400
    tspc.reset()
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def work(i):
            for _ in range(n):
                with tspc.suppressed():
                    tspc.record(f"hidden_{i}")
                    with tspc.suppressed():
                        tspc.record(f"hidden_{i}")
                tspc.record(f"seen_{i}")

        threads = [threading.Thread(target=work, args=(i,))
                   for i in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    snap = tspc.snapshot()
    assert snap == {f"seen_{i}": n for i in range(n_threads)}
    assert tspc._nsuppress == 0
