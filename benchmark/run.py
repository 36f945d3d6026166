"""Run one cell of the benchmark once and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell, its configuration, traffic, correctness limits and per-layer
readers are found by name from ``BENCHMARK.json`` (see ``lib/spec.py``).
The program under test is ``ompi_tpu_torch`` from this checkout. The run
sets up (weights on the card from the seed, the first steps or every prompt
shape once), measures for ``--seconds`` (with ``--trace 1`` the first part
of the window under torch.profiler), then checks what the window produced
against the plain reference in ``reference/``. The last line of standard
output is one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number with its limit; the same numbers end
standard error. Without a CUDA card, or with fewer cards than the cell asks
for, it exits 2 and prints no result.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "ompi_tpu"}


def parse(argv):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def forbidden_modules():
    """Top-level names of loaded modules that are JAX or the JAX package,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FORBIDDEN)


def _import_program(root: Path):
    """Import the program from ``root``; raise where it is missing or comes
    from elsewhere."""
    import ompi_tpu_torch

    where = Path(ompi_tpu_torch.__file__).resolve()
    if root not in where.parents:
        raise ImportError(f"ompi_tpu_torch comes from {where}, not from the "
                          f"checkout {root}")


def run(args, device: str = "cuda", root: Path = ROOT,
        t_start: float = T_START) -> dict:
    """One run of a cell on ``device``; returns the result line's object.
    ``device="cpu"`` runs the same path on the CPU at a tiny size, for the
    tests."""
    from benchmark.lib import cells, check, spec, trace

    cell = spec.load_cell(args.workload, root)
    driver = cells.DRIVERS[cell.traffic["kind"]]
    res = driver(cell, args.seed, args.seconds, bool(args.trace), device)
    if args.trace:
        traced = res["traced"]
        metrics = spec.read_all(cell, traced, root)
        res["device"].update(busy_s=trace.busy_s(traced),
                             window_s=traced.window_s)
    else:
        values = dict(res["e2e"], setup_s=res["setup_end"] - t_start)
        metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                   for m in cell.end_to_end}
    correct, checks = check.judge(res["numbers"], cell.limits)
    out = {"correct": correct and res["failed"] == 0,
           "attempted": res["attempted"], "failed": res["failed"],
           "metrics": metrics, "device": res["device"]}
    if args.trace:
        out["breakdown"] = trace.breakdown(traced)
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    args = parse(argv)
    import torch

    from benchmark.lib import spec

    need = spec.load_cell(args.workload).chips
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"{args.workload} needs {need} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    _import_program(ROOT)
    out = run(args)
    found = forbidden_modules()
    if found:
        print(f"loaded in the run's process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
