"""Per-communicator quant codec negotiation over the modex card plane.

The port of ``ompi_tpu/quant/negotiate.py``. If the quantized module were
selected from each rank's local settings, a rank launched with
``quant_enable`` unset would run the tuned schedule while its peers run
the quantized one — mismatched tags, a permanent hang. So every rank
publishes its settings as a modex card during wireup (``CARD_KEY``,
``card_json``, before the first fence), and by the time any communicator
is built every rank holds every member's card: the verdict is a pure
function of shared data (``decide``), and all ranks quantize, fall back to
full precision, or (``quant_strict``) raise the same error on every
rank's quant-eligible collectives. The cards are the reference's, so
ranks of the two packages reach one verdict in one job.

Mesh mode is single-controller: its verdict reads the local settings as
every member's card.

fp8 availability is whether this torch has ``float8_e4m3fn`` (the
reference asks for ``ml_dtypes``); the host codec's fp8 codes are the
port's own rounding, equal to the reference's bytes.
"""

from __future__ import annotations

import dataclasses
import json
import threading
from typing import Dict, List

import torch

from ompi_tpu_torch import quant as _quant
from ompi_tpu_torch.quant.codec import make_codec
from ompi_tpu_torch.utils.show_help import register_topic, show_help

register_topic(
    "quant", "negotiate-fallback",
    "Quantized collectives requested but not negotiated on "
    "communicator '%(comm)s': %(reason)s.\n"
    "All members fell back to full precision together (set "
    "quant_strict to turn this into an error). Every rank must "
    "launch with quant_enable set and matching quant_bits / "
    "quant_block / quant_mode for the quantized path to engage.")


@dataclasses.dataclass(frozen=True)
class QuantState:
    """A communicator's verdict."""

    active: bool
    bits: int = 8
    block: int = 64
    mode: str = "int8"
    min_bytes: int = 65536
    strict: bool = False
    reason: str = ""

    @property
    def codec(self):
        return make_codec(self.mode, self.bits, self.block)


INACTIVE = QuantState(active=False, reason="quant_enable unset")


def local_card() -> Dict[str, int]:
    """This process's card, straight off the ``quant_*`` variables."""
    return {
        "enable": int(bool(_quant._enable_var._value)),
        "bits": int(_quant._bits_var._value),
        "block": int(_quant._block_var._value),
        "mode": str(_quant._mode_var._value),
        "min_bytes": int(_quant._min_bytes_var._value),
        "strict": int(bool(_quant._strict_var._value)),
        "fp8_ok": int(hasattr(torch, "float8_e4m3fn")),
    }


def card_json() -> str:
    return json.dumps(local_card())


CARD_KEY = "quant.card"

_card_lock = threading.Lock()
_card_cache: Dict[int, Dict] = {}


def _member_card(modex, world_rank: int) -> Dict:
    with _card_lock:
        c = _card_cache.get(world_rank)
    if c is not None:
        return c
    try:
        # cards are published before the publisher's first fence, and a
        # comm holds only ranks whose init completed: post-fence a missing
        # card never appears, so don't wait
        c = json.loads(modex.get(world_rank, CARD_KEY, timeout=0.0))
    except TimeoutError:
        # a peer without a card negotiates as disabled — the verdict every
        # rank reaches alike, because the key is absent for all. Anything
        # other than an absent key propagates: mapping it to disabled
        # would let one rank's hiccup split the verdict
        c = {"enable": 0, "_missing": True}
    with _card_lock:
        _card_cache[world_rank] = c
    return c


def invalidate_cards() -> None:
    """Drop every cached member card: world membership changed
    (shrink/respawn), and a respawned rank re-publishes its card under
    its predecessor's world rank."""
    with _card_lock:
        _card_cache.clear()


def decide(cards: List[Dict]) -> QuantState:
    """The verdict over the members' cards, a pure function of them."""
    if not cards:
        return INACTIVE

    # inactive verdicts keep the enabled members' floor: a strict-armed
    # state gates on it
    def _floor() -> int:
        return max((int(c.get("min_bytes", 65536))
                    for c in cards if c.get("enable")), default=65536)

    if not all(c.get("enable") for c in cards):
        off = sum(1 for c in cards if not c.get("enable"))
        reason = f"{off}/{len(cards)} member rank(s) have " \
                 "quant_enable unset"
        strict = any(c.get("enable") and c.get("strict") for c in cards)
        wanted = any(c.get("enable") for c in cards)
        return QuantState(active=False, strict=strict and wanted,
                          min_bytes=_floor(), reason=reason)
    configs = {(int(c["bits"]), int(c["block"]), str(c["mode"]))
               for c in cards}
    strict = any(c.get("strict") for c in cards)
    if len(configs) != 1:
        return QuantState(
            active=False, strict=strict, min_bytes=_floor(),
            reason="mismatched quant config across members: "
                   + ", ".join(f"bits={b}/block={k}/mode={m}"
                               for b, k, m in sorted(configs)))
    bits, block, mode = next(iter(configs))
    if mode == "fp8" and bits != 8:
        return QuantState(active=False, strict=strict,
                          min_bytes=_floor(),
                          reason="fp8 requires quant_bits=8")
    if mode == "fp8" and not all(c.get("fp8_ok") for c in cards):
        off = sum(1 for c in cards if not c.get("fp8_ok"))
        return QuantState(
            active=False, strict=strict, min_bytes=_floor(),
            reason=f"fp8 codec unavailable on {off}/{len(cards)} "
                   "member build(s) (torch without float8_e4m3fn)")
    # the largest requested floor wins
    min_bytes = max(int(c["min_bytes"]) for c in cards)
    st = QuantState(active=True, bits=bits, block=block, mode=mode,
                    min_bytes=min_bytes, strict=strict)
    try:
        st.codec
    except ValueError as e:
        return QuantState(active=False, strict=strict,
                          min_bytes=min_bytes,
                          reason=f"codec unavailable: {e}")
    return st


_warned = set()


def for_proc_comm(comm) -> QuantState:
    """The verdict of a process-mode communicator (at coll selection): the
    members' modex cards, never a message."""
    from ompi_tpu_torch.runtime import wireup

    if comm.size < 2:
        return INACTIVE
    ctx = wireup._ctx
    if ctx is None:
        # no modex plane (hand-built comms): the local card, as every
        # member's
        cards = [local_card()] * comm.size
    else:
        modex = ctx["modex"]
        cards = [_member_card(modex, comm.group.world_rank(i))
                 for i in range(comm.size)]
    st = decide(cards)
    if not st.active and not st.strict and \
            any(c.get("enable") for c in cards):
        key = (st.reason,)
        if key not in _warned:
            _warned.add(key)
            show_help("quant", "negotiate-fallback",
                      comm=getattr(comm, "name", "?"), reason=st.reason)
    return st


def for_mesh_comm(comm) -> QuantState:
    """The mesh-mode verdict: local settings only. The mesh path quantizes
    whole-axis comms of at least two ranks at 8 bits; anything else takes
    the plain schedule."""
    if not _quant._enable_var._value:
        return INACTIVE
    st = decide([local_card()] * max(comm.world_size, 1))
    if st.active and (st.bits != 8 or comm.groups is not None
                      or comm.world_size < 2):
        return QuantState(
            active=False, strict=False,
            reason="mesh quant path needs an 8-bit codec on a "
                   "whole-axis comm with >= 2 devices")
    return st


def _reset_for_testing() -> None:
    with _card_lock:
        _card_cache.clear()
    _warned.clear()
