"""The port's MCA variables and component selection against the JAX
package's, on the CPU.

- Every variable the two packages share has the same default, type, level
  and enum (the component-named ``accelerator_tpu_mem_bw`` is the port's
  ``accelerator_cuda_mem_bw``).
- The same environment and param-file strings coerce to equal values, from
  the same sources, in both packages: one subprocess imports both under
  one environment.
- Precedence (default < param file < environment < ``set_var``),
  ``watch_var``, the errors for bad values, and the framework's ``a,b`` /
  ``^c`` selection syntax behave alike; a component whose ``query`` raises
  is the one deliberate difference (the port lets it propagate).

Every variable a test sets is put back (``tests/test_torch_mca_fixture.py``).
"""

import json
import os
import subprocess
import sys

import pytest

from ompi_tpu.mca import var as jvar
from ompi_tpu.mca.component import Component as JComponent
from ompi_tpu.mca.component import Framework as JFramework
from ompi_tpu_torch.mca import var as tvar
from ompi_tpu_torch.mca.component import Component as TComponent
from ompi_tpu_torch.mca.component import Framework as TFramework
from ompi_tpu_torch.tools import info as tinfo
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# port name -> JAX name
SHARED = {
    "spc_enable": "spc_enable",
    "trace_enable": "trace_enable",
    "trace_dir": "trace_dir",
    "trace_buffer_events": "trace_buffer_events",
    "quant_enable": "quant_enable",
    "quant_bits": "quant_bits",
    "quant_block": "quant_block",
    "quant_min_bytes": "quant_min_bytes",
    "quant_mode": "quant_mode",
    "quant_strict": "quant_strict",
    "coll_persist_enable": "coll_persist_enable",
    "coll_persist_donate": "coll_persist_donate",
    "coll_coll": "coll_coll",
    "accelerator_accelerator": "accelerator_accelerator",
    "accelerator_cuda_mem_bw": "accelerator_tpu_mem_bw",
}
# the diagnostic and fault planes' variables keep the reference's names
SHARED.update((n, n) for n in [
    "topo_bind_ranks", "qos_tag_map", "btl_tcp_shape_enable",
    "btl_tcp_shape_segment_bytes", "ft_inject_plan", "ft_inject_seed",
    "ft_enable", "ft_heartbeat_period", "ft_heartbeat_timeout",
    "metrics_enable", "metrics_straggler_threshold_us",
    "metrics_straggler_min_samples", "metrics_ewma_alpha",
    "metrics_hist_buckets", "metrics_dir", "metrics_http_port",
    "metrics_snapshot_period", "linkmodel_enable", "linkmodel_probe_ms",
    "linkmodel_rtt_degraded_us", "linkmodel_loss_degraded_ppm",
    "forensics_enable", "forensics_stall_threshold_ms", "sanitizer_enable",
    "sanitizer_level", "sanitizer_deadlock_timeout"])


def _load_jax():
    import ompi_tpu.accelerator  # noqa: F401
    import ompi_tpu.coll.persist  # noqa: F401
    import ompi_tpu.parallel.mesh  # noqa: F401
    import ompi_tpu.quant  # noqa: F401
    import ompi_tpu.runtime.spc  # noqa: F401
    import ompi_tpu.runtime.trace  # noqa: F401
    import ompi_tpu.runtime.topology  # noqa: F401
    import ompi_tpu.qos  # noqa: F401
    import ompi_tpu.ft.inject  # noqa: F401
    import ompi_tpu.ft.detector  # noqa: F401
    import ompi_tpu.runtime.metrics  # noqa: F401
    import ompi_tpu.runtime.linkmodel  # noqa: F401
    import ompi_tpu.runtime.forensics  # noqa: F401
    import ompi_tpu.runtime.sanitizer  # noqa: F401
    import ompi_tpu.runtime.smsc  # noqa: F401


@pytest.fixture(scope="module", autouse=True)
def loaded():
    _load_jax()
    tinfo._load_everything()


@pytest.mark.parametrize("name", sorted(SHARED))
def test_shared_var_has_the_reference_default_type_level_enum(name):
    t, j = tvar.all_vars()[name], jvar.all_vars()[SHARED[name]]
    assert (t.default, t.typ, t.level, t.enum_values, t.scope.value) == \
        (j.default, j.typ, j.level, j.enum_values, j.scope.value)
    assert t.env_name == "OMPI_TPU_MCA_" + name


def test_the_port_registers_no_var_the_reference_lacks():
    jnames = set(jvar.all_vars())
    extra = {n for n in tvar.all_vars() if n not in jnames}
    assert extra == {"accelerator_cuda_mem_bw"}


SPELLINGS = ["1", "true", "yes", "on", "enabled", "0", "false", "no", "off",
             "disabled", " TRUE ", "On", "Disabled", True, False]


@pytest.mark.parametrize("raw", SPELLINGS, ids=repr)
def test_bool_spellings_coerce_alike(raw):
    assert tvar._coerce(raw, bool) == jvar._coerce(raw, bool)


@pytest.mark.parametrize("raw", ["2", "y", "", "truthy"])
def test_bad_bool_raises_in_both(raw):
    for mod in (tvar, jvar):
        with pytest.raises(ValueError, match="cannot parse bool"):
            mod._coerce(raw, bool)


# (variable, the environment's string, the param file's string); the names
# that hold a component name differ by the package's component
ENV_CASES = {
    "quant_enable": ("yes", None),
    "quant_min_bytes": ("4096", "1024"),
    "quant_mode": ("fp8", "int8"),
    "quant_block": (None, "32"),
    "quant_strict": (None, "on"),
    "spc_enable": ("off", None),
    "trace_buffer_events": ("128", None),
    "trace_dir": (None, "/nonexistent/trace"),
    "coll_persist_enable": (None, "0"),
    "coll_persist_donate": ("1", None),
    "coll_coll": ("^quant", None),
}
_SUBPROCESS = r"""
import json, sys
sys.path.insert(0, {root!r})
from ompi_tpu_torch.tools import info
info._load_everything()
import ompi_tpu.accelerator, ompi_tpu.coll.persist, ompi_tpu.parallel.mesh
import ompi_tpu.quant, ompi_tpu.runtime.spc, ompi_tpu.runtime.trace
from ompi_tpu.mca import var as j
from ompi_tpu_torch.mca import var as t
print(json.dumps({{
    pkg: {{n: [v.value, v.source.name] for n, v in mod.all_vars().items()}}
    for pkg, mod in (("jax", j), ("port", t))}}))
"""


@pytest.fixture(scope="module")
def from_the_environment(tmp_path_factory):
    """Both packages' variables, imported under one environment and one
    param file."""
    conf = tmp_path_factory.mktemp("mca") / "params.conf"
    lines = ["# a comment", ""]
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMPI_TPU_PARAM_FILE=str(conf))
    for name, (e, f) in ENV_CASES.items():
        env.pop("OMPI_TPU_MCA_" + name, None)  # the session's own settings
        if e is not None:
            env["OMPI_TPU_MCA_" + name] = e
        if f is not None:
            lines.append(f"{name} = {f}")
    env["OMPI_TPU_MCA_accelerator_cuda_mem_bw"] = "1234"
    env["OMPI_TPU_MCA_accelerator_tpu_mem_bw"] = "1234"
    conf.write_text("\n".join(lines) + "\n")
    out = subprocess.run(
        [sys.executable, "-c", _SUBPROCESS.format(root=ROOT)], env=env,
        capture_output=True, text=True, timeout=240, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.splitlines()[-1])


@pytest.mark.parametrize("name", sorted(ENV_CASES))
def test_env_and_file_strings_coerce_alike(from_the_environment, name):
    jax_vars, port_vars = (from_the_environment[k] for k in ("jax", "port"))
    assert port_vars[name] == jax_vars[name]
    e, f = ENV_CASES[name]
    assert port_vars[name][1] == ("ENV" if e is not None else "FILE")


def test_the_mem_bw_override_follows_the_component(from_the_environment):
    jax_vars, port_vars = (from_the_environment[k] for k in ("jax", "port"))
    assert port_vars["accelerator_cuda_mem_bw"] == \
        jax_vars["accelerator_tpu_mem_bw"] == [1234.0, "ENV"]


# ------------------------------------------------------------ precedence
@pytest.fixture
def fresh(monkeypatch):
    """Each package's registry and param-file cache as they were after."""
    for mod in (tvar, jvar):
        monkeypatch.setattr(mod, "_registry", dict(mod._registry))
        monkeypatch.setattr(mod, "_file_params", {})
    return monkeypatch


@pytest.mark.parametrize("sources", ["default", "file", "env", "set"])
def test_precedence(fresh, sources):
    """default < param file < environment < set_var, in both packages."""
    got = []
    for mod in (tvar, jvar):
        if sources in ("file", "env", "set"):
            fresh.setitem(mod._file_params, "ttest_prec", "2")
        if sources in ("env", "set"):
            fresh.setenv("OMPI_TPU_MCA_ttest_prec", "3")
        v = mod.register_var("ttest", "prec", 1)
        if sources == "set":
            mod.set_var("ttest", "prec", "4")
        got.append((v.value, v.source.name))
    want = {"default": (1, "DEFAULT"), "file": (2, "FILE"),
            "env": (3, "ENV"), "set": (4, "SET")}[sources]
    assert got == [want, want]


def test_watch_var_fires_on_set_only(fresh):
    for mod in (tvar, jvar):
        seen = []
        mod.watch_var("ttest", "watched", lambda v: seen.append(v.value))
        mod.register_var("ttest", "watched", 5)
        assert seen == []  # registration resolves sources silently
        mod.set_var("ttest", "watched", 6)
        mod.set_var("ttest", "watched", "7")
        assert seen == [6, 7]


@pytest.mark.parametrize("what", ["enum", "bool", "int", "conflict",
                                  "unknown"])
def test_bad_values_raise_alike(fresh, what):
    for mod in (tvar, jvar):
        mod.register_var("ttest", "mode", "a", enum_values=("a", "b"))
        mod.register_var("ttest", "flag", False)
        mod.register_var("ttest", "count", 3)
        if what == "enum":
            with pytest.raises(ValueError, match="not in"):
                mod.set_var("ttest", "mode", "c")
            assert mod.get_var("ttest", "mode") == "a"
        elif what == "bool":
            with pytest.raises(ValueError, match="cannot parse bool"):
                mod.set_var("ttest", "flag", "maybe")
        elif what == "int":
            with pytest.raises(ValueError):
                mod.set_var("ttest", "count", "three")
        elif what == "conflict":
            assert mod.register_var("ttest", "count", 3) is \
                mod.all_vars()["ttest_count"]
            with pytest.raises(ValueError, match="conflicting"):
                mod.register_var("ttest", "count", 4)
        else:
            with pytest.raises(KeyError):
                mod.set_var("ttest", "nosuch", 1)


def test_a_bad_env_string_raises_at_registration(fresh):
    fresh.setenv("OMPI_TPU_MCA_ttest_envbad", "lots")
    for mod in (tvar, jvar):
        with pytest.raises(ValueError):
            mod.register_var("ttest", "envbad", 1)


# -------------------------------------------------------------- selection
def _framework(pkg, name, raising=False):
    comp_cls, fw_cls = ((TComponent, TFramework) if pkg == "port"
                        else (JComponent, JFramework))
    fw = fw_cls(name)
    for cname, prio in (("a", 10), ("b", 30), ("c", 20)):
        comp = type(f"C{cname}", (comp_cls,), {
            "NAME": cname, "PRIORITY": prio,
            "query": lambda self, **ctx: self.NAME})()
        fw.register(comp)
    if raising:
        def broken(self, **ctx):
            raise RuntimeError("the device is gone")

        fw.register(type("Cbroken", (comp_cls,), {
            "NAME": "broken", "PRIORITY": 99, "query": broken})())
    return fw


@pytest.mark.parametrize("spec,want", [
    ("", ["b", "c", "a"]), ("a,c", ["c", "a"]), ("^b", ["c", "a"]),
    ("^a,b", ["c"]), ("c", ["c"]), ("nosuch", [])])
def test_selection_syntax_alike(fresh, spec, want):
    for pkg, mod in (("port", tvar), ("jax", jvar)):
        fw = _framework(pkg, f"tsel{len(spec)}")
        mod.set_var(fw.name, fw.name, spec)
        assert [n for _, n, _ in fw.select_all()] == want
        if want:
            assert fw.select_one() == (want[0], want[0])
        else:
            with pytest.raises(RuntimeError, match="no usable component"):
                fw.select_one()


def test_a_raising_query_propagates_in_the_port_only(fresh):
    """The deliberate difference (ROADMAP C): the reference logs and skips
    a component whose query raises; the port lets the exception out."""
    jfw = _framework("jax", "traise", raising=True)
    assert [n for _, n, _ in jfw.select_all()] == ["b", "c", "a"]
    tfw = _framework("port", "traise", raising=True)
    with pytest.raises(RuntimeError, match="the device is gone"):
        tfw.select_all()


# --------------------------------------------------------------- info tool
@pytest.mark.parametrize("argv,has,lacks", [
    (["--all"], ["coll           Collective operations",
                 "quant (priority 110), mesh (priority 100)",
                 "cuda (priority 50), null (priority 0)",
                 "accelerator_cuda_mem_bw", "coll_mesh_cache_hits",
                 "persist_starts"], []),
    ([], ["quant_enable", "coll_persist_enable"],
     ["coll_persist_donate", "performance variables"]),
    (["--param", "quant"], ["quant_mode"], ["trace_enable", "spc_enable"]),
    (["--level", "3", "--pvars"], ["trace_enable", "quant_colls"],
     ["quant_mode"]),
])
def test_info_tool(capsys, argv, has, lacks):
    assert tinfo.main(argv) == 0
    out = capsys.readouterr().out
    assert out.startswith("ompi_tpu_torch: ")
    for s in has:
        assert s in out, s
    for s in lacks:
        assert s not in out, s


def test_info_tool_runs_as_a_module():
    out = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.info", "--all"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "frameworks / components" in out.stdout
    assert "import jax" not in out.stderr


# ------------------------------------------------------------------- hooks
def test_hooks_run_in_registration_order(monkeypatch):
    from ompi_tpu.hook import PHASES as JPHASES
    from ompi_tpu_torch import hook

    assert hook.PHASES == JPHASES
    monkeypatch.setattr(hook, "_hooks", type(hook._hooks)(list))
    ran = []
    hook.register_hook("finalize_top", lambda: ran.append(1))
    hook.register_hook("finalize_top", lambda: ran.append(2))
    hook.register_hook("init_top", lambda: ran.append(0))
    hook.run_hooks("finalize_top")
    assert ran == [1, 2]
    with pytest.raises(ValueError, match="unknown hook phase"):
        hook.register_hook("at_lunch", lambda: None)
