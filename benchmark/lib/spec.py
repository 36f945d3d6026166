"""The benchmark's data, found by name: ``BENCHMARK.json`` at the root of
the checkout lists the cells and metrics; a cell's configuration is the file
it names, its traffic ``benchmark/traffic/<traffic>.json``, its correctness
limits ``benchmark/limits/<cell>.json``, and each per-layer metric's reader
``benchmark/metrics/<metric>.py`` (a function ``read(traced)``), or, where
that file is missing, the reader of the metric's stem, the part of its name
before the first dot: ``glue_share.train`` and ``glue_share.prefill`` both
read ``benchmark/metrics/glue_share.py``. A per-layer metric names the cells
that report it under ``workloads``."""

from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from typing import Callable, Dict, List

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent


@dataclasses.dataclass
class Cell:
    name: str
    config: dict
    traffic: dict
    chips: int
    end_to_end: List[dict]
    per_layer: List[dict]
    limits: dict


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def reader_path(metric: str, root: Path = ROOT) -> Path:
    """The reader file of a per-layer metric: its own, else its stem's."""
    metrics = root / "benchmark" / "metrics"
    own = metrics / f"{metric}.py"
    return own if own.exists() else metrics / f"{metric.split('.')[0]}.py"


def load_cell(name: str, root: Path = ROOT) -> Cell:
    bench = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if name not in cells:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    w = cells[name]
    configs = {c["name"]: c for c in bench["configs"]}
    e2e = [m for m in bench["end_to_end"] if _reports(m, name)]
    per_layer = [m for m in bench["per_layer"] if name in m["workloads"]]
    bench_dir = root / "benchmark"
    return Cell(
        name=name,
        config=json.loads((root / configs[w["config"]]["file"]).read_text()),
        traffic=json.loads((bench_dir / "traffic"
                            / f"{w['traffic']}.json").read_text()),
        chips=w["chips"], end_to_end=e2e, per_layer=per_layer,
        limits=json.loads((bench_dir / "limits"
                           / f"{name}.json").read_text()))


def reader(metric: str, root: Path = ROOT) -> Callable:
    """The ``read`` function of the metric's reader file."""
    path = reader_path(metric, root)
    spec = importlib.util.spec_from_file_location(
        "benchmark_metric_" + metric.replace(".", "_").replace("-", "_"),
        path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def read_all(cell: Cell, traced, root: Path = ROOT) -> Dict[str, dict]:
    """Every per-layer metric of the cell that finds something to read."""
    out = {}
    for m in cell.per_layer:
        value = reader(m["name"], root)(traced)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out
