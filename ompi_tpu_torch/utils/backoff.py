"""One bounded exponential-backoff+jitter schedule for every retry
loop in the tree.

The port of ``ompi_tpu/utils/backoff.py``, whole.

Reference: opal's mca_btl_tcp endpoint complete-connect retry and the
orte/prte restart throttles — every reference retry loop carries the
same four knobs (base delay, doubling cap, attempt budget, total
deadline) and the same ±jitter so herds desynchronize. This tree grew
three hand-rolled copies of that loop (tcp connect establishment, the
serving admission gate, the link redial) before they were hoisted
here; the policy is now written once:

- delay for attempt *n* is ``min(base * 2**n, cap)`` multiplied by a
  uniform jitter factor in ``[1-jitter, 1+jitter)`` — a restarted peer
  is not reconnect-stormed by every rank at once;
- BOTH budgets bind: an attempt count AND a wall-clock deadline. A
  SYN-blackholed peer burning full per-attempt timeouts must not
  stretch total failure latency to ``attempts * timeout``;
- sleeps are clamped to the remaining deadline budget — backing off
  past the deadline would stretch failure latency beyond the bound the
  deadline exists to keep.

Callers iterate imperatively (the loops do real work between sleeps)::

    sched = Schedule(base_s=0.025, cap_s=2.0, retries=18, deadline_s=30)
    while True:
        try:
            return dial()
        except OSError:
            if not sched.sleep():
                raise          # budget exhausted — escalate

``rng`` is injectable for deterministic tests; the module-level default
uses the process RNG (jitter is the one place nondeterminism is the
feature).
"""

from __future__ import annotations

import random
import time
from typing import Optional


class Schedule:
    """One retry schedule instance: owns the attempt counter and the
    deadline clock for a single retry loop (construct per loop, not
    per module — the deadline starts at construction)."""

    __slots__ = ("base_s", "cap_s", "retries", "deadline", "jitter",
                 "rng", "attempt")

    def __init__(self, base_s: float, cap_s: float = 2.0,
                 retries: Optional[int] = None,
                 deadline_s: Optional[float] = None,
                 jitter: float = 0.5,
                 rng: Optional[random.Random] = None):
        self.base_s = max(float(base_s), 0.0)
        self.cap_s = max(float(cap_s), self.base_s)
        self.retries = None if retries is None else int(retries)
        self.deadline = None if deadline_s is None \
            else time.monotonic() + float(deadline_s)
        self.jitter = min(max(float(jitter), 0.0), 1.0)
        self.rng = rng  # None = module random (shared process RNG)
        self.attempt = 0

    # ------------------------------------------------------------ budget
    def remaining(self) -> float:
        """Seconds left on the deadline budget (inf when unbounded)."""
        if self.deadline is None:
            return float("inf")
        return self.deadline - time.monotonic()

    def expired(self) -> bool:
        return self.deadline is not None and self.remaining() <= 0.0

    def exhausted(self) -> bool:
        """True once EITHER budget is spent — the caller's cue to stop
        retrying and escalate."""
        if self.retries is not None and self.attempt >= self.retries:
            return True
        return self.expired()

    # ------------------------------------------------------------- delay
    def next_delay(self) -> Optional[float]:
        """The jittered, capped, deadline-clamped delay for the next
        retry, advancing the attempt counter — or ``None`` when either
        budget is exhausted (nothing consumed; the caller escalates).
        Split from :meth:`sleep` for callers with their own wait
        primitive (test seams, condition variables)."""
        if self.exhausted():
            return None
        # 1 << n overflows no sooner than float exp would; clamp the
        # exponent so a long-lived unbounded-retry schedule (the
        # admission gate under a stuck recovery) cannot build a bignum
        raw = self.base_s * (1 << min(self.attempt, 62))
        delay = min(raw, self.cap_s)
        if self.jitter:
            r = (self.rng or random).random()
            delay *= (1.0 - self.jitter) + 2.0 * self.jitter * r
        self.attempt += 1  # mpiracer: disable=cross-thread-race — a Schedule is constructed per retry loop and driven by that one thread; nothing shares an instance
        left = self.remaining()
        if left != float("inf"):
            delay = min(delay, max(left, 0.0))
        return delay

    def sleep(self) -> bool:
        """Sleep out the next delay; ``False`` (without sleeping) when
        the budget is exhausted."""
        d = self.next_delay()
        if d is None:
            return False
        if d > 0:
            time.sleep(d)
        return True
