#!/usr/bin/env python3
"""The verb layer's dispatch tax of two or more checkouts, by one method.

    python3 dispatch_ab.py ROOT [ROOT ...] [--rounds N] [--device cpu]

Each ROOT is a checkout of this repo: an older commit unpacked by
``git archive``, or ``.`` for this one. Roots are measured in the order
given, so ``OLD . . OLD`` runs parent, change, change, parent. For each
root a child process imports that root's ``ompi_tpu_torch``, builds
``mesh_world(8)`` on the card and calls the root's own
``tools.bench.bench_dispatch_tax`` ``--rounds`` times (the timing code is
the same in every root that has it): ``prologue_us``, the verb layer alone
over 50,000 calls with each cached callable stubbed; ``ours_us``, the
allreduce's dispatch floor; ``raw_us``, the raw expression's; and each
verb's layer overhead over its cached callable. Where the root has trace
spans (``ompi_tpu_torch/runtime/trace.py``) the rounds run again with
``trace_enable`` set.

One line per run, then each root's medians; the last line is one JSON
object of every run and the medians, with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
from pathlib import Path

KEYS = ("prologue_us", "ours_us", "raw_us")


def child(root: str, rounds: int, device: str) -> dict:
    """``rounds`` dispatch taxes of ``root``, tracing off (and on)."""
    sys.path.insert(0, str(Path(root).resolve()))
    import torch

    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.tools import bench

    world = mesh_world(8, device)
    modes = {"off": False}
    traced = (Path(root) / "ompi_tpu_torch/runtime/trace.py").exists()
    if traced:
        from ompi_tpu_torch.mca.var import set_var
        from ompi_tpu_torch.runtime import trace

        modes["on"] = True
    out = {}
    for mode, on in modes.items():
        runs = []
        for _ in range(rounds):
            if traced:
                set_var("trace", "enable", on)
            try:
                tax = bench.bench_dispatch_tax(world)
            finally:
                if traced:
                    set_var("trace", "enable", False)
                    trace.reset()
            row = {k: tax[k] for k in KEYS}
            row.update({f"{v}_layer_us": r["layer_overhead_us"]
                        for v, r in tax["verb_sweep"].items()})
            runs.append(row)
        out[mode] = runs
    if device == "cuda":
        torch.cuda.synchronize()
    return out


def _median(runs):
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("roots", nargs="+")
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--child", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        print(json.dumps(child(args.roots[0], args.rounds, args.device)))
        return 0
    card = "cpu"
    if args.device == "cuda":
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60)
        card = smi.stdout.strip().splitlines()[0]
    print(card, flush=True)
    runs = []
    for root in args.roots:
        p = subprocess.run(
            [sys.executable, __file__, root, "--child", "--rounds",
             str(args.rounds), "--device", args.device],
            capture_output=True, text=True, timeout=900)
        if p.returncode != 0:
            print(p.stderr[-3000:], file=sys.stderr)
            return 1
        res = json.loads(p.stdout.strip().splitlines()[-1])
        runs.append({"root": root, **res})
        for mode, rows in res.items():
            med = _median(rows)
            print(f"{root} tracing {mode}: " + ", ".join(
                f"{k} {v:.3f}" for k, v in med.items()), flush=True)
    medians = {}
    for root in dict.fromkeys(r["root"] for r in runs):
        for mode in ("off", "on"):
            rows = [row for r in runs if r["root"] == root
                    for row in r.get(mode, [])]
            if rows:
                medians[f"{root} {mode}"] = _median(rows)
    for label, med in medians.items():
        print(f"median {label}: " + ", ".join(
            f"{k} {v:.3f}" for k, v in med.items()), flush=True)
    print(json.dumps({"card": card, "runs": runs, "medians": medians}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
