"""The port's profiling tools and its mesh_allreduce example, on the CPU.

Each tool's ``main(device="cpu")`` runs at a tiny shape through the plain
versions of the kernels and prints one labelled row a variant. The
example's stdout equals the JAX example's (``examples/mesh_allreduce.py``,
run in a subprocess on the 8-device CPU mesh that ``tests/conftest.py``
sets up) line for line, but for the line that names the device: with
``--quant`` too, whose int8 quantized allreduce is bit-exact with JAX's,
so its error, err/bound and wire ratio print alike.
"""

import os
import pathlib
import subprocess
import sys

import pytest

from ompi_tpu_torch import quant  # noqa: F401 registers the quant_* vars
from ompi_tpu_torch.examples import mesh_allreduce as tex
from ompi_tpu_torch.mca.var import get_var as tget_var
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.tools import attn_probe, profile_flash, profile_mfu

ROOT = pathlib.Path(__file__).resolve().parent.parent
TINY = ttfm.Config(vocab=64, d_model=32, n_heads=2, n_layers=1, d_ff=64,
                   seq_len=64)

TOOLS = {
    "profile_flash": (lambda: profile_flash.main("cpu", reps=2), [
        "ours flash fwd", "ours flash fwd+bwd", "sdpa fwd (library)",
        "sdpa fwd+bwd (library)", "dense fwd", "dense fwd+bwd",
        "in-situ ring(sp=1) fwd+bwd(dq)", "in-situ ring(sp=1) fwd+bwd(all)",
        "einsum-fed flash fwd+bwd"]),
    "profile_mfu": (lambda: profile_mfu.main("cpu", cfg=TINY, ksteps=1), [
        "full step (flash, CE)", "no-CE loss (sum of logits)",
        "identity attention", "dense attention", "forward only"]),
    "attn_probe": (lambda: attn_probe.main("cpu", cfg=TINY, k=2), [
        "flash fwd", "flash fwd+bwd", "step remat=False",
        "step remat=True"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_prints_its_rows_on_the_cpu(tool, capsys):
    run, labels = TOOLS[tool]
    rows = run()
    out = capsys.readouterr().out.splitlines()
    assert list(rows) == labels
    assert "on cpu" in out[0]
    for label in labels:
        line = next(x for x in out if x.startswith(label + " "))
        assert " ms" in line
        assert rows[label]["ms"] > 0
        assert rows[label].get("mfu") is None
        assert rows[label].get("eff") is None
        assert rows[label].get("peak_bytes") is None


def test_tools_launch_no_kernel_on_the_cpu():
    rows = profile_flash.main("cpu", reps=1)
    assert all(v == 0 for r in rows.values() for v in r["launches"].values())


@pytest.fixture(scope="module")
def jax_example():
    """stdout of the JAX example, without and with --quant, run at once."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    procs = {q: subprocess.Popen(
        [sys.executable, str(ROOT / "examples" / "mesh_allreduce.py")]
        + (["--quant"] if q else []), stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True, env=env, cwd=str(ROOT))
        for q in (False, True)}
    out = {}
    for q, p in procs.items():
        stdout, stderr = p.communicate(timeout=300)
        assert p.returncode == 0, stderr[-2000:]
        out[q] = stdout.splitlines()
    return out


@pytest.mark.parametrize("quant", [False, True])
def test_example_prints_the_jax_examples_lines(jax_example, quant, capsys):
    saved = tget_var("quant", "enable"), tget_var("quant", "min_bytes")
    assert tex.main(["--device", "cpu"] + (["--quant"] if quant else [])) \
        == 0
    assert (tget_var("quant", "enable"),
            tget_var("quant", "min_bytes")) == saved
    lines = capsys.readouterr().out.splitlines()
    want = jax_example[quant]
    assert lines[0].startswith("mesh world over 8 rank(s) on one device: cpu")
    assert want[0].startswith("mesh world over 8 device(s)")
    assert lines[1:] == want[1:]
    assert any("provider=quant " in x for x in lines) == quant
