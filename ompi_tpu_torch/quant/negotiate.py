"""The quantization verdict of a mesh-mode communicator.

The port of the part of ``ompi_tpu/quant/negotiate.py`` that mesh mode uses
(``QuantState``, ``local_card``, ``decide`` ``:150-208``, ``for_mesh_comm``
``:241-255``). In process mode every rank publishes a card of its settings
and all ranks decide over the same cards; mesh mode is single-controller,
so its verdict reads the local settings as every member's card. The
modex-card plane is process mode and is not ported.

fp8 availability is whether this torch has ``float8_e4m3fn`` (the
reference asks for ``ml_dtypes``).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

import torch

from ompi_tpu_torch import quant as _quant
from ompi_tpu_torch.quant.codec import make_codec


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
