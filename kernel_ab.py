"""The flash kernels of two or more checkouts, timed by one method.

    python3 kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout of this repo: an older commit unpacked by
``git archive``, or ``.`` for this one. Roots are measured in the order
given, so ``OLD . . OLD`` runs parent, change, change, parent. For each
root a child process imports ``ompi_tpu_torch`` from that root, builds its
kernels there and times ``flash_fwd``, ``flash_dq`` and ``flash_dkv``
through their wrappers at the flagship shape ([8, 8, 1024, 128] bf16,
causal, 'bhtd'), with this checkout's functions whatever the root:

- ``ms``: ``time_ms`` of ``ompi_tpu_torch/tools/bench.py`` (as
  ``chip_smoke`` imports it), CUDA events around calls back to back;
- ``device_ms``: the kernel's device time per launch, from torch.profiler;
- ``host_ms``: the wrapper's host time per call (its ``host_ms``).

One line per run, then each root's medians over its runs; the last line
is one JSON object of every run and the medians, with the card's name and
power limit. Needs a CUDA device and ``nvcc``.
"""

from __future__ import annotations

import importlib.util
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv")
PROFILED_CALLS = 20


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def device_ms(fn, kernel: str) -> float:
    """Mean device time per launch of the CUDA kernel ``<kernel>_kernel``
    over PROFILED_CALLS calls of ``fn``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(PROFILED_CALLS):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA
            and f"{kernel}_kernel<" in e.key]
    # the profiler may drop an event now and then (19 of 20 seen on an
    # H100), so the mean is over the launches it saw
    seen = sum(e.count for e in hits)
    if not seen:
        raise RuntimeError(f"the profiler saw no {kernel}_kernel launch")
    return sum(e.device_time_total for e in hits) / 1e3 / seen


def child(root: str) -> dict:
    """Times of ``root``'s three kernels; runs in a process of its own."""
    import torch

    cs = _chip_smoke()
    # chip_smoke imports this checkout's timers (ompi_tpu_torch.tools.bench):
    # forget the package so that the root's own is imported below
    for mod in [m for m in sys.modules
                if m == "ompi_tpu_torch" or m.startswith("ompi_tpu_torch.")]:
        del sys.modules[mod]
    sys.path.insert(0, str(Path(root).resolve()))
    from ompi_tpu_torch.ops import _build
    from ompi_tpu_torch.ops import flash_attention as fa

    if not str(Path(fa.__file__).resolve()).startswith(
            str(Path(root).resolve())):
        raise RuntimeError(f"imported {fa.__file__}, not {root}'s")
    torch.backends.cuda.matmul.allow_tf32 = False
    _build.build()
    B, H, T, D = 8, 8, 1024, 128
    sm = D ** -0.5
    q, k, v = cs.qkv((B, H, T, D), 3, torch.bfloat16)
    bwd = cs.bwd_inputs(fa, (B, H, T, D), "bhtd", torch.bfloat16, 3, False,
                        True)
    calls = {
        "flash_fwd": lambda: fa.flash_fwd(q, k, v, False, True, sm, "bhtd"),
        "flash_dq": lambda: fa.flash_dq(*bwd, False, True, sm, "bhtd"),
        "flash_dkv": lambda: fa.flash_dkv(*bwd, False, True, sm, "bhtd"),
    }
    out = {"root": root}
    for name in KERNELS:
        fn = calls[name]
        out[name] = {"ms": cs.time_ms(fn), "device_ms": device_ms(fn, name),
                     "host_ms": cs.host_ms(fn)}
    return out


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--child":
        print(json.dumps(child(sys.argv[2])), flush=True)
        return 0
    if len(sys.argv) < 2 or sys.argv[1].startswith("-"):
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else ""
    print(card, flush=True)
    runs = []
    for root in sys.argv[1:]:
        proc = subprocess.run([sys.executable, str(Path(__file__).resolve()),
                               "--child", root], capture_output=True,
                              text=True, timeout=900, cwd=os.getcwd())
        if proc.returncode:
            print(proc.stdout + proc.stderr, file=sys.stderr)
            print(f"kernel_ab: {root} failed", file=sys.stderr)
            return 1
        res = json.loads(proc.stdout.strip().splitlines()[-1])
        runs.append(res)
        print(f"{root}: " + "; ".join(
            f"{n} {res[n]['ms']:.4f} ms (device {res[n]['device_ms']:.4f} "
            f"ms, host {1e3 * res[n]['host_ms']:.1f} us a call)"
            for n in KERNELS), flush=True)
    medians = {root: {n: {m: statistics.median(
        r[n][m] for r in runs if r["root"] == root)
        for m in ("ms", "device_ms", "host_ms")} for n in KERNELS}
        for root in dict.fromkeys(sys.argv[1:])}
    for root, med in medians.items():
        print(f"median of {root}'s runs: " + "; ".join(
            f"{n} {med[n]['ms']:.4f} ms (device {med[n]['device_ms']:.4f} "
            f"ms, host {1e3 * med[n]['host_ms']:.1f} us a call)"
            for n in KERNELS), flush=True)
    print(json.dumps({"card": card, "runs": runs, "medians": medians}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
