"""Nothing the benchmark runs imports JAX or the JAX package (top-level
module names compared whole: ``ompi_tpu_torch`` is not ``ompi_tpu``), and
the plain reference imports nothing of the program."""

import ast
import json
import subprocess
import sys

import pytest

from toy_cells import ROOT, run_toy, toy_root

from benchmark import run

BENCH = ROOT / "benchmark"
FORBIDDEN = {"jax", "jaxlib", "flax", "ompi_tpu"}


def _imported_tops(path):
    tops = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            tops.add(node.module.split(".")[0])
    return tops


@pytest.mark.parametrize("path", sorted(BENCH.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_tops(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_sources_import_torch_alone(path):
    assert _imported_tops(path) <= {"__future__", "contextlib", "math",
                                    "torch"}


def test_reference_loads_nothing_of_the_program():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import benchmark.reference.opt\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))"
            % str(ROOT))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, check=True)
    tops = set(json.loads(out.stdout.strip().replace("'", '"')))
    assert "ompi_tpu_torch" not in tops and not tops & FORBIDDEN


@pytest.mark.parametrize("cell", ["toy.train", "toy.prefill"])
def test_a_run_loads_neither_jax_nor_the_jax_package(tmp_path, cell):
    # every module the harness, the readers, the reference and the program
    # load in a traced run, listed once the run is over
    proc = run_toy(toy_root(tmp_path), cell, trace=1)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert json.loads(proc.stderr.strip().splitlines()[-1]) == []


def test_the_guard_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "ompi_tpu_torch_lookalike", sys)
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "ompi_tpu.fake", sys)
    assert run.forbidden_modules() == ["ompi_tpu"]
