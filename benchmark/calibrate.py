"""Readings for the correctness limits of a cell, on the card, in one
process: the program on many seeds, the control (the plain reference in
float8 in the program's place) and the planted faults on a few.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 \
        [--control-seeds 3] [--faults half_batch] [--seconds 0]

Each run goes through the cell's own driver, as ``run.py`` does, with a
window of ``--seconds`` (0: one step, or one round of requests). One JSON
line a run, and at the end, for each compared number, the largest reading
of the program and the smallest of the control and of each fault. The
benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", type=int, default=3)
    p.add_argument("--faults", default="")
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out", default=str(ROOT / "chiprun_out"))
    args = p.parse_args(argv)

    from benchmark.lib import cells, faults, spec

    cell = spec.load_cell(args.workload)
    driver = cells.DRIVERS[cell.traffic["kind"]]
    seeds = [int(s) for s in args.seeds.split(",")]
    plan = [("program", s, contextlib.nullcontext) for s in seeds]
    plan += [("control.fp8", s, faults.reference_in_place)
             for s in seeds[:args.control_seeds]]
    for name in filter(None, args.faults.split(",")):
        plan += [(f"fault.{name}", s, faults.FAULTS[name])
                 for s in seeds[:args.control_seeds]]
    out = Path(args.out) / f"calibrate-{args.workload}.jsonl"
    out.parent.mkdir(parents=True, exist_ok=True)
    rows = []
    with out.open("a") as f:
        for variant, seed, planted in plan:
            t0 = time.perf_counter()
            with planted():
                res = driver(cell, seed, args.seconds, False, "cuda")
            row = {"workload": args.workload, "variant": variant,
                   "seed": seed, "numbers": res["numbers"],
                   "e2e": res["e2e"], "attempted": res["attempted"],
                   "peak_bytes": res["device"]["memory_peak_bytes"],
                   "wall_s": time.perf_counter() - t0}
            rows.append(row)
            line = json.dumps(row)
            print(line, flush=True)
            f.write(line + "\n")
            del res
            cells._free("cuda")
    summary = {}
    for row in rows:
        pick = max if row["variant"] == "program" else min
        mine = summary.setdefault(row["variant"], {})
        for k, v in row["numbers"].items():
            mine[k] = v if k not in mine else pick(mine[k], v)
    print(json.dumps({"summary": summary}), flush=True)
    return 0


if __name__ == "__main__":
    sys.path.insert(0, str(ROOT))
    sys.exit(main())
