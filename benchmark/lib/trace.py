"""The reduction of a traced window to what the per-layer readers read.

On the card only the device's activity is traced (kernels, copies, sets,
and the CUDA runtime and driver calls that the host made): recording every
host operation as well would lengthen a window that the host paces. The
window then runs from the end of the first ``cudaDeviceSynchronize`` of the
trace to the end of the last, the two synchronisations the harness puts
around its traced calls. On the CPU, where the tests trace host operations,
it is the span of the ``WINDOW`` annotation. Device operations are cut to
the window. A kernel is ``flash`` (the port's ``flash_*`` kernels), ``gemm``
(cuBLAS and CUTLASS products, with their split-K reductions) or ``glue``
(everything else: norms, casts, elementwise, reductions, copies).
"""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

WINDOW = "benchmark.window"
SYNC = "cudaDeviceSynchronize"
HOST_CODE = "host code, in no CUDA call"
GEMM_MARKS = ("gemm", "nvjet", "xmma", "cutlass", "splitk")


def classify(name: str) -> str:
    low = name.lower()
    if "flash_" in low:
        return "flash"
    if any(m in low for m in GEMM_MARKS):
        return "gemm"
    return "glue"


@dataclasses.dataclass
class Op:
    name: str
    start: float  # us on the profiler's clock
    end: float
    thread: int = 0


@dataclasses.dataclass
class Traced:
    """One traced window: its device operations and host operations, the
    work the harness sent in it, and what the cell is; and the work and
    seconds of the untraced rest of the run's window."""
    window: Tuple[float, float]
    device_ops: List[Op]
    host_ops: List[Op]
    work: List[dict]      # {"batch": b, "seq": T} a call
    rest_work: List[dict]
    rest_s: float
    kind: str             # "train" or "prefill"
    dims: object          # weights.Dims
    peak: Optional[dict]  # flops.PEAKS entry, None off a known card

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) * 1e-6

    def seconds(self, cls: Optional[str] = None) -> float:
        """Device seconds of the operations of class ``cls`` (all with
        None), summed."""
        return 1e-6 * sum(o.end - o.start for o in self.device_ops
                          if cls is None or classify(o.name) == cls)


def from_profiler(prof, **fields) -> Traced:
    """The window's operations out of a finished ``torch.profiler``."""
    from torch.autograd import DeviceType

    events = prof.events()
    marks = [e for e in events if e.name == WINDOW
             and e.device_type == DeviceType.CPU]
    syncs = sorted((e for e in events if e.name == SYNC
                    and e.device_type == DeviceType.CPU),
                   key=lambda e: e.time_range.end)
    if len(marks) == 1:
        w0, w1 = marks[0].time_range.start, marks[0].time_range.end
    elif len(syncs) >= 2:
        w0, w1 = syncs[0].time_range.end, syncs[-1].time_range.end
    else:
        raise RuntimeError(f"expected one {WINDOW} span or two {SYNC} "
                           f"calls, found {len(marks)} and {len(syncs)}")
    device, host = [], []
    for e in events:
        s, t = max(e.time_range.start, w0), min(e.time_range.end, w1)
        if t <= s or e.name.startswith("benchmark."):
            continue
        if e.device_type == DeviceType.CUDA:
            device.append(Op(e.name, s, t))
        elif e.device_type == DeviceType.CPU:
            host.append(Op(e.name, s, t, e.thread))
    device.sort(key=lambda o: o.start)
    return Traced(window=(w0, w1), device_ops=device, host_ops=host,
                  **fields)


def busy_intervals(ops: List[Op]) -> List[Tuple[float, float]]:
    """The union of the operations' intervals, as disjoint spans."""
    out: List[List[float]] = []
    for o in sorted(ops, key=lambda o: o.start):
        if out and o.start <= out[-1][1]:
            out[-1][1] = max(out[-1][1], o.end)
        else:
            out.append([o.start, o.end])
    return [(a, b) for a, b in out]


def busy_s(t: Traced) -> float:
    return 1e-6 * sum(b - a for a, b in busy_intervals(t.device_ops))


def idle_gaps(t: Traced) -> List[Tuple[float, float]]:
    """The spans of the window in which no device operation ran."""
    gaps, at = [], t.window[0]
    for a, b in busy_intervals(t.device_ops):
        if a > at:
            gaps.append((at, a))
        at = max(at, b)
    if t.window[1] > at:
        gaps.append((at, t.window[1]))
    return gaps


def _host_labels(host_ops: List[Op], times: List[float]) -> List[str]:
    """For each time (ascending), the innermost host operation running then
    on any thread (the one that began last), or ``HOST_CODE`` where none
    runs.
    Operations of one thread nest, so a stack a thread finds it."""
    by_thread: Dict[int, List[Op]] = defaultdict(list)
    for o in host_ops:
        by_thread[o.thread].append(o)
    streams = {k: sorted(v, key=lambda o: (o.start, -o.end))
               for k, v in by_thread.items()}
    pos = {k: 0 for k in streams}
    stacks: Dict[int, List[Op]] = {k: [] for k in streams}
    labels = []
    for t in times:
        best = None
        for k, ops in streams.items():
            stack = stacks[k]
            while pos[k] < len(ops) and ops[pos[k]].start <= t:
                o = ops[pos[k]]
                while stack and stack[-1].end < o.start:
                    stack.pop()
                stack.append(o)
                pos[k] += 1
            while stack and stack[-1].end < t:
                stack.pop()
            if stack and (best is None or stack[-1].start > best.start):
                best = stack[-1]
        labels.append(best.name if best else HOST_CODE)
    return labels


def breakdown(t: Traced, top: int = 10) -> dict:
    """The device operations that took most time, and the window's idle
    time summed by what the host was doing in the middle of each gap."""
    per_op: Dict[str, float] = defaultdict(float)
    for o in t.device_ops:
        per_op[o.name[:160]] += (o.end - o.start) * 1e-6
    gaps = idle_gaps(t)
    labels = _host_labels(t.host_ops, [(a + b) / 2 for a, b in gaps])
    per_gap: Dict[str, float] = defaultdict(float)
    for (a, b), label in zip(gaps, labels):
        per_gap[label[:160]] += (b - a) * 1e-6
    rank = lambda d: [[k, v] for k, v in sorted(d.items(),
                                                key=lambda kv: -kv[1])[:top]]
    return {"device_ops": rank(per_op), "idle_gaps": rank(per_gap)}
