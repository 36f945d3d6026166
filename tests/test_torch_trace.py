"""The port's trace spans against the JAX package's, on the CPU.

One verb sequence runs on JAX ``mesh_world`` (the conftest's 8-device CPU
mesh) and on the port's ``mesh_world(8, "cpu")``, each with its own
package's tracing on; the B/E events of each become a tree of span names
(``coll.xla.*`` read as ``coll.mesh.*``). The trees are equal, but for one
difference of structure (ROADMAP C): the port has no second "fast" table,
so every one of its verb calls passes ``MeshColl._dispatch`` and its
``coll.mesh.dispatch`` span, where JAX's only passes ``XlaColl._dispatch``
on a verb's first call per fast key. The trees are compared with the
dispatch spans taken out, and the dispatch spans are checked apart: one
under every port verb span but a frozen Start's, a subset of those in
JAX's. On a quantized comm the port also opens ``coll.quant.allreduce``
(the span of ``ompi_tpu/coll/quant.py:108-109``), which JAX's mesh path
lacks.

Also: the export passes ``tools/trace_lint.py``, a wrapped ring counts
``trace_dropped_events``, tracing off records nothing, the spans reach
MPI_T, and a process exports at exit.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

import jax

from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.runtime import trace as jtrace
from ompi_tpu_torch import mpit
from ompi_tpu_torch.mca.var import all_pvars
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.runtime import trace as ttrace
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture
from tools.trace_lint import lint_file

W = 8
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_axis = [0]


@pytest.fixture
def tracing(mca):
    mca.both("trace", "enable", True)
    jtrace.reset()
    ttrace.reset()
    try:
        yield mca
    finally:
        jtrace.reset()
        ttrace.reset()


def _tree(mod):
    """The main thread's spans as [(name, [children])]; names of the
    reference's xla component read as the port's."""
    import threading

    me = threading.get_ident()
    root, stack = [], []
    for tid, (ph, _, name, _, _) in mod.snapshot():
        if tid != me or ph not in ("B", "E"):
            continue
        name = name.replace("coll.xla.", "coll.mesh.")
        if ph == "B":
            node = (name, [])
            (stack[-1][1] if stack else root).append(node)
            stack.append(node)
        else:
            assert stack and stack[-1][0] == name, name
            stack.pop()
    assert not stack
    return root


def _without(tree, drop):
    out = []
    for name, kids in tree:
        kids = _without(kids, drop)
        if any(name.startswith(p) for p in drop):
            out.extend(kids)
        else:
            out.append((name, kids))
    return out


def _walk(tree, parent=None):
    for name, kids in tree:
        yield parent, name, kids
        yield from _walk(kids, name)


def _ranked(shape=(4,)):
    base = np.arange(np.prod(shape), dtype=np.float32).reshape(shape)
    return np.stack([base + r for r in range(W)])


def seq_world(w):
    x, b = w.shard(_ranked()), w.shard(_ranked((W, 2)))
    w.allreduce(x)
    w.allreduce(x)
    w.bcast(x, 1)
    w.bcast(x, 1)
    w.reduce(x)
    w.allgather(x)
    w.alltoall(b)
    w.scan(x)
    w.exscan(x)
    w.gather(x, 0)
    w.scatter(b, 0)
    w.reduce_scatter(b)
    w.barrier()
    w.barrier()
    w.shift(x, 1)
    w.shift(x, 1)


def seq_split(w):
    x = w.shard(_ranked())
    s = w.Split([r % 2 for r in range(W)])
    s.allreduce(x)
    s.allreduce(x)
    s.bcast(x, 0)
    s.scan(x)
    g = w.Create_group([0, 2, 5])
    g.allreduce(x)
    g.allgather(x)


def seq_cart(w):
    x = w.shard(_ranked())
    c = w.Create_cart([2, 4], [True, False])
    c.neighbor_allgather(x)
    c.neighbor_allgather(x)
    c.neighbor_alltoall(c.shard(_ranked((4, 2))))
    c.cart_shift(x, 1, 1)
    sub = c.Sub([False, True])
    sub.allreduce(x)


def seq_persistent(w):
    x = w.shard(_ranked())
    p = w.allreduce_init(x)
    for _ in range(3):
        p.Start()
        p.Wait()
    q = w.bcast_init(x, 2)
    q.Start(x)
    q.Wait()


def seq_nonblocking(w):
    x = w.shard(_ranked())
    for fn in (w.iallreduce, w.iallgather, w.iallreduce):
        fn(x).Wait()
    w.ibarrier().Wait()


SEQUENCES = {"world": seq_world, "split": seq_split, "cart": seq_cart,
             "persistent": seq_persistent, "nonblocking": seq_nonblocking}


def _run_both(seq):
    """(JAX tree, port tree) of ``seq`` on fresh worlds built under
    tracing."""
    _axis[0] += 1
    jw = jax_mesh_world(jax.devices()[:W], axis_name=f"ttr{_axis[0]}")
    seq(jw)
    tw = mesh_world(W, "cpu")
    seq(tw)
    return _tree(jtrace), _tree(ttrace)


@pytest.mark.parametrize("name", sorted(SEQUENCES))
def test_span_names_and_nesting_equal_jax(tracing, name):
    jt, tt = _run_both(SEQUENCES[name])
    drop = ("coll.mesh.dispatch",)
    assert _without(tt, drop) == _without(jt, drop)
    # the difference, held: a dispatch span under every port verb span that
    # calls the table (a frozen Start does not), a subset of them in JAX
    t_disp = [p for p, n, _ in _walk(tt) if n == "coll.mesh.dispatch"]
    j_disp = [p for p, n, _ in _walk(jt) if n == "coll.mesh.dispatch"]
    assert all(p is not None and p.startswith("comm.") for p in t_disp)
    assert len(j_disp) <= len(t_disp)
    assert not set(j_disp) - set(t_disp)
    # a compile span only ever inside a dispatch span, in both
    for tree in (jt, tt):
        for parent, n, _ in _walk(tree):
            if n == "coll.mesh.compile":
                assert parent == "coll.mesh.dispatch"


def test_every_port_verb_opens_one_dispatch_span(tracing):
    tw = mesh_world(W, "cpu")
    ttrace.reset()
    seq_world(tw)
    verbs = [(n, kids) for p, n, kids in _walk(_tree(ttrace))
             if p is None and n.startswith("comm.")]
    assert len(verbs) == 16
    for n, kids in verbs:
        assert [k for k, _ in kids] == ["coll.mesh.dispatch"], n


def test_jax_warm_calls_skip_the_dispatch_span(tracing):
    """The reference's side of the difference: its second allreduce is a
    fast-table call with no component dispatch."""
    _axis[0] += 1
    jw = jax_mesh_world(jax.devices()[:W], axis_name=f"ttr{_axis[0]}")
    x = jw.shard(_ranked())
    jtrace.reset()
    jw.allreduce(x)
    jw.allreduce(x)
    calls = _tree(jtrace)
    assert [n for n, _ in calls] == ["comm.allreduce"] * 2
    assert [k for k, _ in calls[0][1]] == ["coll.mesh.dispatch"]
    assert calls[1][1] == []


def test_quantized_comm_adds_the_quant_span(tracing):
    tracing.both("quant", "enable", True)
    tracing.both("quant", "min_bytes", 1024)

    def seq(w):
        x = w.shard(np.random.RandomState(0).randn(W, 1024).astype(
            np.float32))
        w.allreduce(x)
        w.allreduce(x)
        w.reduce(x)

    jt, tt = _run_both(seq)
    drop = ("coll.mesh.dispatch", "coll.quant.")
    assert _without(tt, drop) == _without(jt, drop)
    quant = [p for p, n, _ in _walk(tt) if n == "coll.quant.allreduce"]
    assert quant == ["coll.mesh.compile", "coll.mesh.dispatch"]
    assert not [n for _, n, _ in _walk(jt) if n.startswith("coll.quant")]


def test_export_passes_trace_lint(tracing, tmp_path):
    tw = mesh_world(W, "cpu")
    seq_world(tw)
    seq_persistent(tw)
    path = ttrace.export(str(tmp_path / "trace-rank0.json"))
    assert lint_file(path) == []
    with open(path) as f:
        doc = json.load(f)
    names = {e["name"] for e in doc["traceEvents"]}
    for n in ("comm.allreduce", "coll.mesh.dispatch", "coll.mesh.compile",
              "coll.select", "coll.persist.start"):
        assert n in names, n
    assert doc["otherData"]["dropped_events"] == 0


def test_overflow_counts_dropped_events(tracing, tmp_path, capfd):
    tracing.port("trace", "buffer_events", 64)
    ttrace.reset()
    try:
        for i in range(200):
            with ttrace.span("t.outer", cat="test", i=i):
                with ttrace.span("t.inner", cat="test"):
                    pass
        dropped = ttrace.dropped_events()
        assert dropped == 4 * 200 - 64
        assert all_pvars()["trace_dropped_events"].value == dropped
        path = ttrace.export(str(tmp_path / "overflow.json"))
        assert lint_file(path) == []
        with open(path) as f:
            assert json.load(f)["otherData"]["dropped_events"] == dropped
        assert ttrace._warn_overflow() == dropped
        assert "ring buffers wrapped" in capfd.readouterr().err
    finally:
        tracing.restore()
        ttrace.reset()


def test_tracing_off_records_nothing():
    ttrace.reset()
    assert not ttrace.enabled()
    seq_world(mesh_world(W, "cpu"))
    assert ttrace.snapshot() == [] and ttrace.buffered_events() == 0


def test_spans_reach_mpit_events(tracing):
    mpit.init_thread()
    seen = []
    try:
        hs = [mpit.event_handle_alloc(mpit.event_get_index(f"trace_{k}"),
                                      lambda e: seen.append(
                                          (e.type.name, e.data["name"])))
              for k in ("span_begin", "span_end")]
        tw = mesh_world(W, "cpu")
        tw.allreduce(tw.shard(_ranked()))
        for h in hs:
            h.free()
    finally:
        mpit.finalize()
    assert ("span_begin", "comm.allreduce") in seen
    assert seen[-1] == ("span_end", "comm.allreduce")
    assert len(seen) == 2 * len([e for e in ttrace.snapshot()
                                 if e[1][0] == "B"])


def test_a_process_exports_at_exit(tmp_path):
    code = ("import numpy as np\n"
            "from ompi_tpu_torch.parallel.mesh import mesh_world\n"
            "w = mesh_world(8, 'cpu')\n"
            "w.allreduce(w.shard(np.ones((8, 4), np.float32)))\n")
    env = dict(os.environ, OMPI_TPU_MCA_trace_enable="1",
               OMPI_TPU_MCA_trace_dir=str(tmp_path))
    env.pop("OMPI_TPU_RANK", None)
    env.pop("OMPI_TPU_BASE", None)
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    path = tmp_path / "trace-rank0.json"
    assert lint_file(str(path)) == []
    names = {e["name"] for e in json.loads(path.read_text())["traceEvents"]}
    assert {"comm.allreduce", "coll.mesh.dispatch"} <= names
