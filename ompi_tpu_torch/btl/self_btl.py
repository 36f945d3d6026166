"""Loopback transport (reference: opal/mca/btl/self, ~600 LoC).

The port of ``ompi_tpu/btl/self_btl.py``. Frames to our own rank
short-circuit straight into the matching engine — no serialization beyond
the header, no copies beyond what matching itself requires. A CPU tensor
is handed on as a byte view of itself; a tensor off the CPU is refused
(``btl.base.host_bytes``).
"""

from __future__ import annotations

from ompi_tpu_torch.btl.base import Btl, btl_framework, host_bytes
from ompi_tpu_torch.mca.component import Component


class SelfBtl(Btl):
    NAME = "self"
    eager_limit = None  # any size moves in one "frame"
    # delivery is inline in send(): progress() never discovers work, so
    # this transport neither needs polling nor caps the idle park
    NEEDS_POLL = False

    def send(self, peer: int, header: bytes, payload) -> None:
        self.deliver(header, host_bytes(payload))


class SelfBtlComponent(Component):
    NAME = "self"
    PRIORITY = 100  # always best for loopback (reference: btl/self exclusivity)

    def query(self, deliver=None, **ctx):
        if deliver is None:
            return None
        return SelfBtl(deliver)


btl_framework.register(SelfBtlComponent())
