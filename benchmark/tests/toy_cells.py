"""A toy configuration, toy traffic and toy cells beside the real ones, in a
copy of the benchmark, for the CPU tests: the harness finds them by name as
it finds a later cell."""

from __future__ import annotations

import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

TOY_CONFIG = {
    "name": "toy",
    "source": "a tiny model of the OPT block, for tests",
    "config": {"hidden_size": 64, "ffn_dim": 128, "num_attention_heads": 4,
               "num_hidden_layers": 2, "vocab_size": 256,
               "max_position_embeddings": 256},
    "reduced": [],
    "assumed": {"lr": 0.01},
}
TOY_TRAFFIC = {
    "toy-train": {"kind": "train", "batch": 4, "seq_len": 64,
                  "first_steps": 3, "traced_steps": 2,
                  "checked_step": {"min": 1, "max": 4}},
    "toy-prefill": {"kind": "prefill", "prompts_per_request": 2,
                    "lengths": {"dist": "lognormal", "median": 96,
                                "sigma": 0.8, "min": 64, "max": 256,
                                "multiple": 64, "per_round": 8},
                    "check_requests": 3},
}
TOY_CELLS = {"toy.train": "toy-train", "toy.prefill": "toy-prefill"}
# the toy's own limits, set as the real cells' are from the CPU's readings
# at this size (4 seeds): the program's largest (loss 1.07e-3, grad 7.4e-3,
# change 4.5e-3, window loss 5.5e-4, window grad 4.0e-3, served gap 0.021)
# and the float8 control's smallest (2.3e-3, 1.74e-2, 1.49e-2, 3.05e-3,
# 1.73e-2, 0.319)
TOY_LIMITS = {
    "toy.train": {"loss_gap": {"limit": 1.5e-3}, "grad_gap": {"limit": 1.2e-2},
                  "change_gap": {"limit": 9e-3},
                  "window_loss_gap": {"limit": 1.5e-3},
                  "window_grad_gap": {"limit": 1e-2}},
    "toy.prefill": {"max_gap": {"limit": 0.15}},
}
TOY_METRIC = '''"""toy_calls: the calls the traced window made."""


def read(t):
    return float(len(t.work))
'''


def toy_root(tmp: Path) -> Path:
    """A copy of BENCHMARK.json and benchmark/ under ``tmp`` with the toy
    configuration, traffic, cells, limits and a toy metric added as new
    files and entries."""
    shutil.copytree(ROOT / "benchmark", tmp / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    b = tmp / "benchmark"
    (b / "configs" / "toy.json").write_text(json.dumps(TOY_CONFIG))
    bench["configs"].append({"name": "toy", "source": TOY_CONFIG["source"],
                             "file": "benchmark/configs/toy.json",
                             "reduced": [], "why": "tests"})
    for name, mix in TOY_TRAFFIC.items():
        (b / "traffic" / f"{name}.json").write_text(json.dumps(mix))
    for cell, mix in TOY_CELLS.items():
        bench["workloads"].append({"name": cell, "config": "toy",
                                   "traffic": mix, "chips": 1,
                                   "why": "tests"})
        (b / "limits" / f"{cell}.json").write_text(
            json.dumps(TOY_LIMITS[cell]))
        kind = TOY_TRAFFIC[mix]["kind"]
        for m in bench["end_to_end"] + bench["per_layer"]:
            if "workloads" in m and _kind_of(m, bench) == kind:
                m["workloads"].append(cell)
    (b / "metrics" / "toy_calls.py").write_text(TOY_METRIC)
    bench["per_layer"].append({
        "name": "toy_calls", "unit": "calls", "better": "higher",
        "source": "program_counter", "layer": "tests",
        "moves": "setup_s", "workloads": list(TOY_CELLS)})
    (tmp / "BENCHMARK.json").write_text(json.dumps(bench, indent=1))
    return tmp


def _kind_of(metric: dict, bench: dict) -> str:
    """The traffic kind of the real cells a metric lists."""
    cells = {w["name"]: w["traffic"] for w in bench["workloads"]}
    kinds = set()
    for w in metric["workloads"]:
        if w in cells and not w.startswith("toy."):
            mix = json.loads((ROOT / "benchmark" / "traffic"
                              / f"{cells[w]}.json").read_text())
            kinds.add(mix["kind"])
    return kinds.pop() if len(kinds) == 1 else ""


def run_toy(root: Path, cell: str, seed: int = 12345678901,
            seconds: float = 0.5, trace: int = 0) -> subprocess.CompletedProcess:
    """The harness on the CPU in a fresh process, from the copy at
    ``root``: prints the result line as ``run.py`` would."""
    code = (
        "import json, sys\n"
        f"sys.path[:0] = [{str(root)!r}, {str(ROOT)!r}]\n"
        "from benchmark import run\n"
        f"args = run.parse(['--workload', {cell!r}, '--seed', '{seed}', "
        f"'--seconds', '{seconds}', '--trace', '{trace}'])\n"
        "out = run.run(args, device='cpu', root=run.Path(sys.path[0]))\n"
        "print(json.dumps(out))\n"
        "print(json.dumps(run.forbidden_modules()), file=sys.stderr)\n")
    return subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, timeout=600, cwd=root)
