"""What the per-layer readers compute from a traced window (``trace.Traced``).

Each function returns a percentage, or None where the window holds nothing
to read: no device operation, no known peak, no launch of the class.
"""

from __future__ import annotations

from typing import Optional

from benchmark.lib import flops, trace


def _train(t: trace.Traced) -> bool:
    return t.kind == "train"


def model_flops(t: trace.Traced, work) -> float:
    fn = flops.train_flops if _train(t) else flops.forward_flops
    return sum(fn(t.dims, w["batch"], w["seq"]) for w in work)


def mfu(t: trace.Traced) -> Optional[float]:
    """Model FLOPs of the calls of the untraced rest of the window over its
    seconds, over the peak: the profiler's host cost is not in it. Read in
    a run whose trace shows device operations."""
    if t.peak is None or not t.device_ops or not t.rest_work:
        return None
    return (100.0 * model_flops(t, t.rest_work) / t.rest_s
            / t.peak["bf16_flops"])


def glue_share(t: trace.Traced) -> Optional[float]:
    """Device time outside the products and the flash kernels, over all
    device time."""
    total = t.seconds()
    if total <= 0:
        return None
    return 100.0 * t.seconds("glue") / total


def gemm_roofline(t: trace.Traced) -> Optional[float]:
    """Least time of the window's products over their kernels' time."""
    spent = t.seconds("gemm")
    if t.peak is None or spent <= 0:
        return None
    need = sum(flops.gemm_bound_s(t.dims, w["batch"] * w["seq"], _train(t),
                                  t.peak) for w in t.work)
    return 100.0 * need / spent


def flash_roofline(t: trace.Traced) -> Optional[float]:
    """Least time of the window's flash launches over their kernels'
    time."""
    spent = t.seconds("flash")
    if t.peak is None or spent <= 0:
        return None
    need = sum(flops.flash_bound_s(t.dims, w["batch"], w["seq"], _train(t),
                                   t.peak) for w in t.work)
    return 100.0 * need / spent


def device_idle(t: trace.Traced) -> Optional[float]:
    """Share of the untraced rest of the window in which no device
    operation ran: the traced calls' device busy time a model FLOP, times
    the rest's model FLOPs, over the rest's seconds. The traced calls are
    the same mix as the rest's (a round of requests, or steps alike), and
    the profiler lengthens what the host does, not what the device does,
    so its cost is in neither term."""
    if not t.device_ops or not t.rest_work:
        return None
    busy = trace.busy_s(t) / model_flops(t, t.work) \
        * model_flops(t, t.rest_work)
    return 100.0 * (1.0 - busy / t.rest_s)
