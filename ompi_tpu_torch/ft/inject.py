"""Deterministic, seedable fault injection (the chaos harness).

The port of ``ompi_tpu/ft/inject.py``: the plan grammar, every action,
``install``/``uninstall``, the hooks and the seeded ``frac`` draws (the
same plan and seed give the same verdicts in both packages). The call
sites of the hooks are the tcp btl, ``btl/base`` and the ob1 pml of
process mode.

Reference: the reference validates ompi/communicator/ft with dedicated
failure-propagator tests and the ftagree mpiext fault hooks; MTT-style
soak rigs additionally use wire-level drop/delay shims. Here the same
discipline is a first-class framework: a *chaos plan* parsed from the
``ft_inject_plan`` cvar (which rides the normal MCA env channel, so
``mpirun --mca ft_inject_plan ...`` reaches every procmode child)
drives two choke points:

- a **btl wire hook** — ``wire_send`` consulted by ``btl/tcp.py`` before
  a frame is queued (drop / delay / dup / sever on the DCN path), and a
  ``wrap_deliver`` receive-side filter installed by ``btl/base.py`` on
  every transport for rules marked ``side=recv``;
- a **pml op-counter hook** — ``on_op`` in ``pml/ob1``'s isend/irecv,
  counting MATCH-plane operations so ``kill(rank, after=N)`` terminates
  the victim at a deterministic point mid-protocol.

Plan grammar (``;``-separated actions; ranks are universe ranks, ``*``
is a wildcard)::

    kill(rank, after=N)            die (exit 0) after N pml ops
    preempt(rank, after=N,         preemption notice: run the registered
            grace_ms=M)            preemption hooks (ft/diskless's final
                                   flush) with an M-ms grace window,
                                   then die — the spot-preemption model
    drop(src, dst, frac=F)         drop outbound frames with prob. F
    drop(src, dst, nth=N)          drop every Nth frame
    delay(src, dst, ms=M)          sleep M ms before queuing a frame
    sever(src, dst, after=N)       break the link on the Nth matching
                                   frame (default the first): conn
                                   marked dead, peer marked failed (the
                                   pml's request-failing sweep on that
                                   mark arms only with ft_enable)
    dup(src, dst, nth=N)           queue every Nth frame twice
    corrupt(src, dst, nth=N|frac=F)  flip bits in the wire payload of
                                   matching frames (reliable links CRC-
                                   NACK and retransmit; legacy links
                                   see the historical desync/_conn_failed)
    sever_transient(src, dst,      break the link on the Nth matching
            after=N, down_ms=M)    frame, then hold it DOWN for M ms —
                                   redials fail (link_down) until the
                                   window closes; drives the degraded->
                                   reconnect-and-replay path
    blackhole(src, dst, ms=M)      from the first matching frame, drop
                                   ALL matching frames for M ms (a
                                   silent wire stall: no reset, no EOF
                                   — heals via retransmit timeout)

Wire rules take an optional ``side=recv`` to apply at the receiver's
deliver funnel instead of the sender's tcp enqueue. ``frac`` draws from
a ``ft_inject_seed``-keyed PRNG (stable per rule across runs and ranks).

Hot-guard discipline: the disabled path is ONE live attribute load —
``_enable_var._value`` — the same slot shape as spc/trace/sanitizer
gates (mpilint enforces this for injection calls in hot modules).
Every injected fault counts into the ``ft_injected_faults`` pvar, an
``spc`` counter per action, and (when tracing) a trace instant.
"""

from __future__ import annotations

import random
import re
import time
import zlib
from typing import Dict, List, Optional

from ompi_tpu_torch.mca.var import register_var, register_pvar
from ompi_tpu_torch.runtime import trace as _trace
from ompi_tpu_torch.utils.output import get_logger
from ompi_tpu_torch.utils.show_help import register_topic, show_help

register_topic(
    "ft", "bad-inject-plan",
    "The ft_inject_plan cvar could not be parsed:\n  {error}\n"
    "Grammar: ';'-separated kill(rank,after=N) / preempt(rank,after=N,"
    "grace_ms=M) / drop(src,dst,frac=F|nth=N) / delay(src,dst,ms=M) / "
    "sever(src,dst,after=N) / dup(src,dst,nth=N) / "
    "corrupt(src,dst,nth=N|frac=F) / "
    "sever_transient(src,dst,after=N,down_ms=M) / "
    "blackhole(src,dst,ms=M), optional side=recv on drop/delay/dup "
    "wire rules ('*' = any rank).\n"
    "Fix the plan or unset the cvar; injection refuses to start with "
    "a plan it cannot honor.")

_plan_var = register_var(
    "ft", "inject_plan", "", typ=str,
    help="Chaos plan: ';'-separated kill(rank,after=N) / "
         "preempt(rank,after=N,grace_ms=M) / "
         "drop(src,dst,frac=F|nth=N) / delay(src,dst,ms=M) / "
         "sever(src,dst,after=N) / dup(src,dst,nth=N) / "
         "corrupt(src,dst,nth=N|frac=F) / "
         "sever_transient(src,dst,after=N,down_ms=M) / "
         "blackhole(src,dst,ms=M) actions applied at the "
         "btl wire and pml op-counter hooks (empty = injection off; "
         "drop/delay/dup take side=recv to apply at the receiver)",
    level=9)
_seed_var = register_var(
    "ft", "inject_seed", 0,
    help="Seed for probabilistic (frac=) injection decisions — the "
         "same plan+seed replays the same fault schedule", level=9)

log = get_logger("ft.inject")

# wire_send verdict bits
DROP = 1
DUP = 2
SEVER = 4
CORRUPT = 8
# rides SEVER for sever_transient: the outage is RECOVERABLE — a
# reliability-engaged btl degrades-and-redials instead of killing the
# link outright (plain sever keeps its permanent instant-death verdict
# on every datapath, reliable or not)
TRANSIENT = 16

_WIRE_ACTIONS = ("drop", "delay", "sever", "dup", "corrupt",
                 "sever_transient", "blackhole")
# send-only wire actions: they act on the sender's connection/wire
# bytes, which a receive-side deliver filter cannot reach
_SEND_ONLY = ("sever", "sever_transient", "corrupt", "blackhole")
_DIE_ACTIONS = ("kill", "preempt")  # victim-terminating op-counter rules


class _LiveFlag:
    """One-slot live gate: hot call sites load ``_enable_var._value``
    exactly like the spc/trace/sanitizer guards (a registered bool cvar
    would be wrong here — enablement is derived from the parsed plan,
    not a user knob of its own)."""

    __slots__ = ("_value",)

    def __init__(self):
        self._value = False


_enable_var = _LiveFlag()


class _Rule:
    __slots__ = ("action", "src", "dst", "frac", "nth", "ms", "after",
                 "side", "count", "rng", "fired_edges", "until")

    def __init__(self, action: str, src: Optional[int], dst: Optional[int],
                 frac: Optional[float], nth: Optional[int],
                 ms: float, after: int, side: str, seed: int):
        self.action = action
        self.src = src        # None = wildcard ('*'); kill: the victim
        self.dst = dst
        self.frac = frac
        self.nth = nth
        self.ms = ms
        self.after = after
        self.side = side
        self.count = 0
        self.fired_edges = set()  # sever one-shot latch, per (src,dst)
        self.until: Optional[float] = None  # blackhole window end (mono)
        # stable per-rule stream: identical across ranks and runs for a
        # given (plan position irrelevant) rule shape + seed
        key = zlib.crc32(f"{action}:{src}:{dst}:{frac}:{nth}".encode())
        self.rng = random.Random(seed ^ key)

    def __repr__(self) -> str:  # plan echo in logs/errors
        extra = []
        if self.frac is not None:
            extra.append(f"frac={self.frac}")
        if self.nth is not None:
            extra.append(f"nth={self.nth}")
        if self.action in ("delay", "blackhole"):
            extra.append(f"ms={self.ms:g}")
        if self.action == "sever_transient":
            extra.append(f"after={self.after}")
            extra.append(f"down_ms={self.ms:g}")
        if self.action == "kill":
            return f"kill({self.src},after={self.after})"
        if self.action == "preempt":
            return (f"preempt({self.src},after={self.after},"
                    f"grace_ms={self.ms:g})")
        if self.side == "recv":
            extra.append("side=recv")
        args = ",".join([str("*" if self.src is None else self.src),
                         str("*" if self.dst is None else self.dst)]
                        + extra)
        return f"{self.action}({args})"


_kill_rules: List[_Rule] = []
_send_rules: List[_Rule] = []
_recv_rules: List[_Rule] = []
_my_rank: Optional[int] = None
_faults: Dict[str, int] = {}
# sever_transient down-windows: unordered edge -> monotonic end time.
# Consulted by the tcp redial loop (link_down) so BOTH sides see the
# outage for the full window — the severed conn plus every reconnect
# attempt inside it — then heal together.
_down_until: Dict[tuple, float] = {}

register_pvar("ft", "injected_faults",
              lambda: sum(_faults.values()),
              help="Faults injected by the ft_inject_plan chaos harness "
                   "(all actions; per-action detail in the "
                   "spc_ft_inject_* counters)")


_ACTION_RE = re.compile(r"^\s*([a-z_]+)\s*\(([^)]*)\)\s*$")


def _parse_action(text: str, seed: int) -> _Rule:
    m = _ACTION_RE.match(text)
    if m is None:
        raise ValueError(f"ft_inject_plan: cannot parse action {text!r}")
    action, raw = m.group(1), m.group(2)
    if action not in _WIRE_ACTIONS and action not in _DIE_ACTIONS:
        raise ValueError(f"ft_inject_plan: unknown action {action!r}")
    pos: List[str] = []
    kv: Dict[str, str] = {}
    for part in raw.split(","):
        part = part.strip()
        if not part:
            continue
        if "=" in part:
            k, v = part.split("=", 1)
            kv[k.strip()] = v.strip()
        else:
            if kv:
                raise ValueError(
                    f"ft_inject_plan: positional arg after keyword "
                    f"in {text!r}")
            pos.append(part)

    def rank(s: str) -> Optional[int]:
        return None if s == "*" else int(s)

    if action in _DIE_ACTIONS:
        if len(pos) != 1 or pos[0] == "*":
            raise ValueError(
                f"ft_inject_plan: {action} needs {action}(rank, "
                f"after=N), got {text!r}")
        after = int(kv.pop("after", "0"))
        # preempt carries its grace window in the ms slot (the notice
        # hooks get grace_ms/1000 seconds to flush before death)
        grace = float(kv.pop("grace_ms", "500")) if action == "preempt" \
            else 0.0
        if kv:
            raise ValueError(
                f"ft_inject_plan: unknown {action}() args {sorted(kv)}")
        return _Rule(action, int(pos[0]), None, None, None, grace,
                     max(after, 1), "send", seed)

    if len(pos) != 2:
        raise ValueError(
            f"ft_inject_plan: {action} needs (src, dst), got {text!r}")
    src, dst = rank(pos[0]), rank(pos[1])
    side = kv.pop("side", "send")
    if side not in ("send", "recv"):
        raise ValueError(f"ft_inject_plan: side must be send|recv "
                         f"in {text!r}")
    frac = float(kv.pop("frac")) if "frac" in kv else None
    nth = int(kv.pop("nth")) if "nth" in kv else None
    ms = float(kv.pop("ms", "0"))
    after = 0
    if action == "sever":
        # optional Nth-frame gate (default: first matching frame), so a
        # permanent sever can be placed mid-stream instead of landing
        # on wireup traffic
        after = max(int(kv.pop("after", "1")), 1)
    if action == "sever_transient":
        # Nth matching frame triggers the sever; down_ms rides the ms
        # slot (the link stays DOWN — redials fail via link_down() —
        # until the window closes)
        after = max(int(kv.pop("after", "1")), 1)
        ms = float(kv.pop("down_ms", "500"))
        if ms <= 0:
            raise ValueError(
                f"ft_inject_plan: sever_transient needs down_ms>0 "
                f"in {text!r}")
    if kv:
        raise ValueError(
            f"ft_inject_plan: unknown {action}() args {sorted(kv)}")
    if action == "drop" and frac is None and nth is None:
        frac = 1.0  # drop(src,dst) = drop everything on the edge
    if action in ("dup", "corrupt") and frac is None and nth is None:
        nth = 1
    if action == "delay" and ms <= 0:
        raise ValueError(f"ft_inject_plan: delay needs ms=M in {text!r}")
    if action == "blackhole" and ms <= 0:
        raise ValueError(
            f"ft_inject_plan: blackhole needs ms=M in {text!r}")
    if action in _SEND_ONLY and side == "recv":
        raise ValueError(
            f"ft_inject_plan: {action} is send-side only (it acts on "
            f"the sender's connection/wire bytes)")
    return _Rule(action, src, dst, frac, nth, ms, after, side, seed)


def parse_plan(text: str, seed: int = 0) -> List[_Rule]:
    return [_parse_action(a, seed) for a in text.split(";") if a.strip()]


def install(plan: Optional[str] = None, seed: Optional[int] = None) -> None:
    """(Re)parse the plan and arm the hooks. Called at import with the
    cvar value; tests call it directly after set_var. Send-side and
    op-counter hooks are live-guarded at every call site; side=recv
    rules additionally need a deliver wrapper that btl/base installs at
    transport construction — they take effect immediately when SOME
    plan was already armed at that point (the rule list is live), but
    arming injection from scratch after transports exist reaches only
    the send/op hooks."""
    global _kill_rules, _send_rules, _recv_rules
    if plan is None:
        plan = str(_plan_var._value or "")
    if seed is None:
        seed = int(_seed_var._value or 0)
    rules = parse_plan(plan, seed)
    _down_until.clear()  # mpiracer: disable=cross-thread-race — stale outage windows must not survive a re-arm; install() runs before the hooks it arms, so no wire thread races the clear
    _kill_rules = [r for r in rules if r.action in _DIE_ACTIONS]
    _send_rules = [r for r in rules
                   if r.action not in _DIE_ACTIONS and r.side == "send"]
    _recv_rules = [r for r in rules if r.side == "recv"]
    _enable_var._value = bool(rules)
    if rules:
        log.warning("chaos plan armed: %s",
                    "; ".join(repr(r) for r in rules))


def uninstall() -> None:
    global _kill_rules, _send_rules, _recv_rules
    _kill_rules, _send_rules, _recv_rules = [], [], []
    _faults.clear()
    _down_until.clear()
    _enable_var._value = False


def link_down(a: int, b: int) -> bool:
    """True while a sever_transient down-window is open on the
    unordered edge (a, b) — the tcp redial loop consults this so
    reconnect attempts inside the outage fail like the real wire
    would, instead of instantly reconnecting over loopback."""
    if not _down_until:
        return False
    edge = (a, b) if a <= b else (b, a)
    t = _down_until.get(edge)
    if t is None:
        return False
    if time.monotonic() >= t:
        del _down_until[edge]
        return False
    return True


def note_rank(rank: int) -> None:
    """Identity for the receive-side filter (set by ob1 when a plan is
    armed — the pml knows the universe rank; btls are built after it)."""
    global _my_rank
    _my_rank = rank


def fault_counts() -> Dict[str, int]:
    return dict(_faults)


def has_recv_rules() -> bool:
    return bool(_recv_rules)


# Preemption-notice hooks: run on the doomed rank between the notice
# and death, with the rule's grace window (seconds) — the registration
# channel for ft/diskless.flush_final (the spot-preemption model where a
# doomed worker gets a short warning to flush state).
_preempt_hooks: List = []


def on_preempt(cb) -> None:
    """Register ``cb(grace_s: float)`` to run when a preempt() rule
    fires on this rank, before the process exits."""
    if cb not in _preempt_hooks:
        _preempt_hooks.append(cb)


def _fire(rule: _Rule, src, dst) -> None:
    from ompi_tpu_torch.runtime import spc

    _faults[rule.action] = _faults.get(rule.action, 0) + 1
    spc.record(f"ft_inject_{rule.action}")
    if _trace.enabled():
        _trace.instant(f"ft.inject.{rule.action}", cat="ft",
                       src=src, dst=dst)


def _hits(rule: _Rule) -> bool:
    if rule.frac is not None:
        return rule.rng.random() < rule.frac
    if rule.nth is not None:
        return rule.count % rule.nth == 0
    return True


def _edge(rule: _Rule, src: int, dst: int) -> bool:
    return (rule.src is None or rule.src == src) and \
           (rule.dst is None or rule.dst == dst)


# ------------------------------------------------------------------ hooks
def on_op(rank: int, tag: int) -> None:
    """pml op counter (call sites guard on ``_enable_var._value``).
    System-plane traffic (heartbeats, era, revoke floods — tag <=
    SYSTEM_TAG_BASE) is excluded so op counts stay deterministic under
    background detector chatter."""
    from ompi_tpu_torch.pml.base import SYSTEM_TAG_BASE

    if tag <= SYSTEM_TAG_BASE:
        return
    for rule in _kill_rules:
        if rule.src != rank:
            continue
        rule.count += 1
        if rule.count >= rule.after:
            import os

            _fire(rule, rank, None)
            if rule.action == "preempt":
                # latch BEFORE the hooks: a flush that sends user-tag
                # traffic would re-enter this counter and recurse
                fired = rule.count
                rule.after = 1 << 62
                log.warning("chaos preempt: rank %d notified after %d "
                            "pml ops (grace %.0fms)", rank, fired,
                            rule.ms)
                for cb in list(_preempt_hooks):
                    try:
                        cb(rule.ms / 1000.0)
                    except Exception:
                        log.warning("preempt hook failed",
                                    exc_info=True)
            else:
                log.warning("chaos kill: rank %d dying after %d pml "
                            "ops", rank, rule.count)
            # exit 0: the launcher treats nonzero as a job abort and
            # would tear down the survivors this plan exists to test
            os._exit(0)


def wire_send(my_rank: int, peer: int) -> int:
    """Send-side wire verdict for one frame: OR of DROP/DUP/SEVER bits;
    delay sleeps inline. Call sites guard on ``_enable_var._value``."""
    flags = 0
    for rule in _send_rules:
        if not _edge(rule, my_rank, peer):
            continue
        rule.count += 1
        if rule.action == "sever":
            # one-shot PER EDGE (a wildcard rule severs every matching
            # link once): the Nth matching frame (after=, default the
            # first) kills that connection; after that the dead-conn
            # check raises on its own, and re-firing would inflate
            # ft_injected_faults (one severed link = one fault) and
            # re-run the btl's failure path per frame
            if (my_rank, peer) not in rule.fired_edges and \
                    rule.count >= rule.after:
                rule.fired_edges.add((my_rank, peer))
                _fire(rule, my_rank, peer)
                flags |= SEVER
        elif rule.action == "delay":
            _fire(rule, my_rank, peer)
            time.sleep(rule.ms / 1000.0)
        elif rule.action == "sever_transient":
            # like sever's one-shot-per-edge latch, but gated on the
            # Nth matching frame, and the edge additionally enters a
            # down-window during which link_down() holds redials off
            if (my_rank, peer) not in rule.fired_edges and \
                    rule.count >= rule.after:
                rule.fired_edges.add((my_rank, peer))
                edge = (my_rank, peer) if my_rank <= peer \
                    else (peer, my_rank)
                _down_until[edge] = time.monotonic() + rule.ms / 1000.0
                _fire(rule, my_rank, peer)
                flags |= SEVER | TRANSIENT
        elif rule.action == "blackhole":
            # silent outage: from the first matching frame, every
            # matching frame vanishes for ms — no reset, no EOF, so
            # only a retransmit timeout can notice. One fault counted
            # per window (per-frame counts would make
            # ft_injected_faults depend on send timing)
            now = time.monotonic()
            if rule.until is None:
                rule.until = now + rule.ms / 1000.0
                _fire(rule, my_rank, peer)
            if now < rule.until:
                flags |= DROP
        elif rule.action == "corrupt":
            if _hits(rule):
                _fire(rule, my_rank, peer)
                flags |= CORRUPT
        elif rule.action == "drop":
            if _hits(rule):
                _fire(rule, my_rank, peer)
                flags |= DROP
        elif rule.action == "dup":
            if _hits(rule):
                _fire(rule, my_rank, peer)
                flags |= DUP
    return flags


def wrap_deliver(deliver):
    """Receive-side filter over a btl's deliver funnel — installed by
    btl/base.py at construction whenever a plan is armed (the rule list
    stays live across install()/uninstall()). With no recv-side rules
    the wrapper costs one truthiness check per frame — no Header parse
    — and the no-plan path never pays even the wrapper frame."""
    from ompi_tpu_torch.pml.base import Header

    def injected_deliver(hdr_bytes, payload):
        if not _recv_rules:
            return deliver(hdr_bytes, payload)
        h = Header(hdr_bytes)
        me = _my_rank
        drop = dup = False
        for rule in _recv_rules:
            if me is None or not _edge(rule, h.src, me):
                continue
            rule.count += 1
            if rule.action == "delay":
                _fire(rule, h.src, me)
                time.sleep(rule.ms / 1000.0)
            elif rule.action == "drop" and _hits(rule):
                _fire(rule, h.src, me)
                drop = True
            elif rule.action == "dup" and _hits(rule):
                _fire(rule, h.src, me)
                dup = True
        if drop:
            return
        deliver(hdr_bytes, payload)
        if dup:
            deliver(hdr_bytes, payload)

    return injected_deliver


try:
    install()  # arm from the cvar (env-sourced in procmode children)
except ValueError as _e:
    # an operator typo must fail LOUDLY with an MCA-style banner before
    # the import error cascade — silently disabling injection would let
    # a chaos test run with no chaos and report false confidence
    show_help("ft", "bad-inject-plan", error=str(_e))
    raise
