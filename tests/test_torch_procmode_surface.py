"""What the port's process mode has and lacks, held to ROADMAP.md.

- the reference's ``ProcComm`` methods that the port lacks, the top-level
  exports it lacks and the init binds it leaves pending (computed from
  both packages' ``runtime/state.py`` and ``wireup.py`` sources) each
  equal the list in ROADMAP.md, so that a later slice shrinks both;
- a launch that needs a pending bind (a spawned child, ``ft_ckpt_enable``)
  raises ``MPIError`` naming it, never running half-wired, and a launch
  with ``quant_enable`` runs; ``ft_ckpt_enable`` is registered with the
  reference's default and help;
- the port's ``mpirun`` leaves the ranks the card the launcher sees (the
  reference's forces its ranks onto the CPU unless ``--with-tpu``; the
  port has no such flag);
- ``parse_buffer`` on tensors: a CPU tensor is the buffer itself, bf16 is
  ``BFLOAT16``, ``stage_to_host`` stages a dtype numpy lacks as its
  storage.
"""

import ast
import importlib
import json
import os
import re
import types
import warnings

import numpy as np
import pytest
import torch

from tests.test_torch_procmode_fixture import (
    JAX,
    PORT,
    REPO,
    run_mpi,
    run_py,
    subprocess_env,
)


def _roadmap_list(label):
    """The ``(name, slice)`` pairs of the ROADMAP paragraph that starts
    with ``label``."""
    text = open(os.path.join(REPO, "ROADMAP.md")).read()
    i = text.index(label)
    para = text[i:text.index("\n\n", i)]
    return sorted(re.findall(r"`([\w.]+)`\s+\((A\.[0-9.]+[ab]?)\)", para))


def _public(obj):
    return {n for n in dir(obj) if not n.startswith("_")
            and not isinstance(getattr(obj, n), types.ModuleType)}


def test_procomm_gap_equals_the_roadmap():
    jc = importlib.import_module(f"{JAX}.comm.communicator").ProcComm
    tc = importlib.import_module(f"{PORT}.comm.communicator").ProcComm
    assert _public(tc) <= _public(jc)
    gap = sorted(_public(jc) - _public(tc))
    listed = _roadmap_list("Absent `ProcComm` methods")
    assert gap == sorted(n for n, _ in listed)
    assert not hasattr(tc, "Agree") and hasattr(tc, "Shrink")
    for name in ("Create_graph", "Create_dist_graph_adjacent",
                 "Get_neighbors", "Neighbor_allgather", "Neighbor_alltoall"):
        assert hasattr(tc, name), name


def test_export_gap_equals_the_roadmap():
    j, t = importlib.import_module(JAX), importlib.import_module(PORT)
    gap = sorted(_public(j) - _public(t))
    assert gap == sorted(n for n, _ in
                         _roadmap_list("Missing top-level exports"))
    for name in ("Init", "Finalize", "Is_initialized", "Is_finalized",
                 "init", "finalize", "get_world", "COMM_WORLD",
                 "COMM_SELF", "MPIError", "ERR_COMM", "ERR_TAG",
                 "ERR_COUNT", "SUM", "MINLOC", "Group", "Status",
                 "Request", "DeviceBuffer", "Communicator", "Intracomm"):
        assert name in t.__all__, name
    for name in ("ERR_COMM", "ERR_COUNT", "ERR_TAG", "ANY_SOURCE", "ROOT"):
        assert getattr(t, name) == getattr(j, name), name


def _is_module(pkg, dotted):
    base = os.path.join(REPO, pkg, *dotted.split("."))
    return os.path.exists(base + ".py") or os.path.isdir(base)


def _binds(pkg):
    """The package modules that ``runtime/state.py`` imports at module
    level and ``runtime/wireup.py``'s ``init_process_mode`` imports."""
    out = set()

    def add(node):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.startswith(pkg + "."):
                    out.add(a.name[len(pkg) + 1:])
        elif isinstance(node, ast.ImportFrom) and node.module and (
                node.module == pkg or node.module.startswith(pkg + ".")):
            mod = node.module[len(pkg) + 1:]
            for a in node.names:
                full = f"{mod}.{a.name}" if mod else a.name
                out.add(full if _is_module(pkg, full) else mod)

    rt = os.path.join(REPO, pkg, "runtime")
    for node in ast.parse(open(os.path.join(rt, "state.py")).read()).body:
        add(node)
    wire = ast.parse(open(os.path.join(rt, "wireup.py")).read())
    init = next(n for n in wire.body if isinstance(n, ast.FunctionDef)
                and n.name == "init_process_mode")
    for node in ast.walk(init):
        add(node)
    return out


def test_pending_binds_equal_the_reference_minus_the_port():
    from ompi_tpu_torch.runtime.wireup import PENDING_BINDS

    pending = _binds(JAX) - _binds(PORT)
    assert sorted(pending) == sorted(n for n, _ in PENDING_BINDS)
    assert sorted(PENDING_BINDS) == _roadmap_list("Pending wireup binds")


def test_ckpt_enable_registered_as_the_reference():
    from ompi_tpu.ft import diskless  # noqa: F401
    from ompi_tpu.mca.var import all_vars as jvars
    from ompi_tpu_torch.mca.var import all_vars as tvars
    from ompi_tpu_torch.runtime import wireup  # noqa: F401

    j, t = jvars()["ft_ckpt_enable"], tvars()["ft_ckpt_enable"]
    assert (t.default, t.typ, t.level, t.help) == (
        j.default, j.typ, j.level, j.help)


REFUSE = '''\
import os
import ompi_tpu_torch as m
from ompi_tpu_torch.mca.var import set_var

def attempt(label):
    try:
        m.Init()
    except m.MPIError as e:
        print(label, "REFUSED", e, flush=True)
    else:
        print(label, "INIT", m.COMM_WORLD.Get_size(), flush=True)

os.environ.update(OMPI_TPU_RANK="0", OMPI_TPU_SIZE="1",
                  OMPI_TPU_MODEX="127.0.0.1:1", OMPI_TPU_BASE="4",
                  OMPI_TPU_JOB="1")
attempt("spawned")
for k in ("OMPI_TPU_RANK", "OMPI_TPU_SIZE", "OMPI_TPU_MODEX",
          "OMPI_TPU_BASE", "OMPI_TPU_JOB"):
    del os.environ[k]
set_var("ft", "ckpt_enable", True)
attempt("ckpt")
set_var("ft", "ckpt_enable", False)
set_var("quant", "enable", True)
attempt("quant")
set_var("quant", "enable", False)
attempt("plain")
'''


def test_unhonourable_launches_raise_naming_what_is_missing(tmp_path):
    """No dial is made: the spawned launch names an unreachable modex and
    is refused before it connects. ``quant_enable`` is honoured: the
    quantized host collectives are bound."""
    prog = tmp_path / "refuse.py"
    prog.write_text(REFUSE)
    r = run_py([prog])
    assert r.returncode == 0, r.stdout + r.stderr
    lines = dict(ln.split(" ", 1) for ln in r.stdout.splitlines())
    assert lines["spawned"].startswith("REFUSED") \
        and "runtime.dpm" in lines["spawned"], r.stdout
    assert lines["ckpt"].startswith("REFUSED") \
        and "ft.diskless" in lines["ckpt"], r.stdout
    assert lines["quant"] == "INIT 1", r.stdout
    assert lines["plain"] == "INIT 1", r.stdout


VIEW = '''\
import json, os, sys
import torch
print("VIEW " + json.dumps({
    "cuda": torch.cuda.is_available(),
    "count": torch.cuda.device_count(),
    "visible": os.environ.get("CUDA_VISIBLE_DEVICES"),
    "jax_platforms": os.environ.get("JAX_PLATFORMS"),
    "rank": os.environ.get("OMPI_TPU_RANK")}), flush=True)
'''


def test_a_port_rank_sees_the_card_the_launcher_sees(tmp_path):
    """Deliberate difference: the reference's mpirun makes its ranks
    host-only (``JAX_PLATFORMS=cpu``) unless ``--with-tpu``; a CUDA card is
    shared between processes, so the port's ranks see what the launcher
    sees, and the port's mpirun has no ``--with-tpu``."""
    prog = tmp_path / "view.py"
    prog.write_text(VIEW)
    env = subprocess_env()
    env["CUDA_VISIBLE_DEVICES"] = os.environ.get("CUDA_VISIBLE_DEVICES",
                                                 "0")
    env.pop("JAX_PLATFORMS", None)
    launcher = json.loads(run_py([prog], env=env).stdout.split("VIEW ")[1])
    r = run_mpi(2, prog, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    views = [json.loads(ln.split("VIEW ")[1])
             for ln in r.stdout.splitlines() if ln.startswith("VIEW ")]
    assert sorted(v.pop("rank") for v in views) == ["0", "1"]
    launcher.pop("rank")
    assert views == [launcher, launcher]
    assert launcher["jax_platforms"] is None
    r = run_py(["-m", "ompi_tpu_torch.tools.mpirun", "-np", "1",
                "--with-tpu", prog], env=env)
    assert r.returncode == 2 and "--with-tpu" in r.stderr


# ------------------------------------------------------------ buffers
def test_parse_buffer_takes_cpu_tensors_without_a_copy():
    from ompi_tpu_torch.comm.communicator import parse_buffer
    from ompi_tpu_torch.core import datatype as dt

    t = torch.arange(6, dtype=torch.float32)
    obj, count, d = parse_buffer(t)
    assert obj is t and count == 6 and d is dt.FLOAT32
    bf = torch.zeros(3, dtype=torch.bfloat16)
    obj, count, d = parse_buffer(bf)
    assert obj is bf and count == 3 and d is dt.BFLOAT16
    obj, count, d = parse_buffer([t, dt.FLOAT32])
    assert obj is t and count == 6
    a = np.zeros(4, np.int32)
    assert parse_buffer(a)[0] is a


def test_stage_to_host_stages_what_numpy_lacks_as_its_storage():
    from ompi_tpu_torch.accelerator import stage_to_host

    bf = torch.tensor([1.5, -2.25, 3.0e8], dtype=torch.bfloat16)
    host = stage_to_host(bf)
    assert host.dtype == np.uint16 and not host.flags.writeable
    back = torch.from_numpy(host.copy()).view(torch.bfloat16)
    assert torch.equal(back, bf)
    if hasattr(torch, "float8_e4m3fn"):
        f8 = torch.tensor([0.5, -1.0], dtype=torch.float8_e4m3fn)
        assert stage_to_host(f8).tobytes() == \
            f8.view(torch.uint8).numpy().tobytes()
    with warnings.catch_warnings():  # quantized tensors are deprecated
        warnings.simplefilter("ignore")
        q = torch.quantize_per_tensor(torch.ones(2), 0.1, 0, torch.quint8)
    with pytest.raises(TypeError):
        stage_to_host(q)


# ------------------------------------------------ coll/basic reductions
@pytest.mark.parametrize("dtype,opname", [
    ("BFLOAT16", "SUM"), ("BFLOAT16", "MAX"), ("BFLOAT16", "PROD"),
    ("FLOAT32", "SUM"), ("FLOAT16", "SUM"), ("INT8", "SUM"),
    ("INT32", "LAND"), ("INT32", "BXOR"), ("UINT64", "MIN"),
    ("FLOAT_INT", "MINLOC"), ("DOUBLE_INT", "MAXLOC")])
def test_basic_reductions_equal_the_reference_on_packed_bytes(dtype, opname):
    """coll/basic folds packed bytes: the port's bf16 (torch, f32 rounded
    to nearest even) equals the reference's ml_dtypes numpy kernel, and
    every other dtype runs the reference's numpy kernel; bytes equal."""
    jb = importlib.import_module(f"{JAX}.coll.basic")
    tb = importlib.import_module(f"{PORT}.coll.basic")
    jdt = getattr(importlib.import_module(f"{JAX}.core.datatype"), dtype)
    tdt = getattr(importlib.import_module(f"{PORT}.core.datatype"), dtype)
    jop = getattr(importlib.import_module(f"{JAX}.core.op"), opname)
    top = getattr(importlib.import_module(f"{PORT}.core.op"), opname)
    assert jdt.size == tdt.size
    rng = np.random.default_rng(3)
    raw = []
    for _ in range(3):
        if dtype in ("BFLOAT16", "FLOAT32", "FLOAT16"):
            vals = (rng.standard_normal(4099) * 300).astype(np.float32)
            vals[:3] = [0.0, -0.0, np.inf]
            if dtype == "BFLOAT16":
                b = (vals.view(np.uint32) >> 16).astype(np.uint16)
            else:
                b = vals.astype(jdt.np_dtype)
            raw.append(np.ascontiguousarray(b).view(np.uint8))
        else:
            raw.append(rng.integers(0, 256, 4099 * jdt.size, dtype=np.uint8))
    jacc = jb._typed_view(raw[0].copy(), jdt)
    tacc = tb._typed_view(raw[0].copy(), tdt)
    for rb in raw[1:]:
        jacc = jb._np_reduce_typed(jop, jacc, jb._typed_view(rb.copy(), jdt))
        tacc = tb._reduce_typed(top, tacc, tb._typed_view(rb.copy(), tdt))
    jbytes = np.ascontiguousarray(jacc).view(np.uint8)
    assert tb._wire(tacc).tobytes() == jbytes.tobytes()


def test_singleton_cases_on_the_port(tmp_path):
    """The eleven cases of ``test_singleton.py`` (a 1-rank world over
    btl/self and coll/self: point-to-point, unexpected messages, probes,
    Sendrecv, collectives, COMM_SELF, Split/Dup, Mprobe/Mrecv, persistent
    requests, a derived datatype), on a renamed copy, in a pytest of its
    own: Init must not run in this process (the registry and world tests
    expect none)."""
    src = open(os.path.join(REPO, "tests", "test_singleton.py")).read()
    copy = tmp_path / "test_port_singleton.py"
    copy.write_text(re.sub(r"\bompi_tpu\b", PORT, src))
    r = run_py(["-m", "pytest", "-q", "--noconftest", "-p",
                "no:cacheprovider", str(copy)], timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert "11 passed" in r.stdout, r.stdout
