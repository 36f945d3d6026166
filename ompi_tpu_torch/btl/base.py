"""BTL — Byte Transfer Layer contract.

The port of ``ompi_tpu/btl/base.py`` (reference: opal/mca/btl/btl.h:1170+,
mca_btl_base_module_t — the raw transport function table with
eager/rendezvous limits). Our contract is a slim frame interface: a BTL
moves (header, payload) frames to a peer and hands received frames to the
PML's ``handle_incoming``. RDMA verbs (put/get/atomics) are absent on the
host path: device bulk data rides the mesh path (coll/mesh, osc over the
mesh).

Payloads are ``bytes``, ndarrays, buffer-protocol objects or CPU
``torch.Tensor``s (``host_bytes`` views a tensor as bytes without a copy).
A tensor that is not on the CPU is refused with a ``TypeError``: no btl
copies device memory behind the caller's back; stage it with
``accelerator.stage_to_host`` first.
"""

from __future__ import annotations

from typing import Callable, Optional

import torch

from ompi_tpu_torch.mca.component import framework

btl_framework = framework(
    "btl", "Byte transfer layer (host/DCN transports)"
)

# a tensor is viewed through the integer dtype of its element size, which
# numpy has for every torch dtype (bf16 and the fp8s included)
_SAME_SIZE_INT = {1: torch.uint8, 2: torch.int16, 4: torch.int32,
                  8: torch.int64}


def host_bytes(payload):
    """A CPU tensor as a numpy view of its bytes, without a copy: a flat
    uint8 view when it is contiguous, else a strided view of its elements
    (the transport then owns it with one counted copy, as it does a
    strided ndarray). Anything else is returned as it is. A tensor off the
    CPU raises ``TypeError``."""
    if not isinstance(payload, torch.Tensor):
        return payload
    if payload.device.type != "cpu":
        raise TypeError(
            f"a {payload.device.type} tensor cannot be sent by a btl: the "
            "transports move host bytes and never copy from the device "
            "behind the caller's back; stage it to the host with "
            "accelerator.stage_to_host first")
    t = payload.detach().resolve_conj().resolve_neg()
    if t.is_complex():
        t = torch.view_as_real(t)
    arr = t.view(_SAME_SIZE_INT[t.element_size()]).numpy()
    if arr.flags.c_contiguous:
        return arr.reshape(-1).view("u1")
    return arr


class Btl:
    """Transport module. eager_limit=None means the transport has no
    rendezvous threshold (loopback/shm can move any size in one frame).

    Idle-blocking contract: a transport whose traffic is visible to
    select() exports ``idle_fds() -> (rfds, wfds)`` and sets
    ``NEEDS_POLL = False`` so the progress engine may PARK while idle
    (runtime/progress.py idle_block). The conservative default —
    NEEDS_POLL True, no exporter — marks a transport that discovers
    work only by polling (the sm rings): its presence keeps idle
    loops on the legacy sleep backoff instead of select-parking."""

    NAME = "base"
    eager_limit: Optional[int] = 65536
    NEEDS_POLL = True
    #: link-reliability upcall (btl/tcp reconnect-and-replay): wireup
    #: binds this to the pml's ``link_restored(rank)`` so a healed link
    #: replays the pml's dead-letter stash for that peer. Transports
    #: without link state never call it; None = no listener.
    link_restored_cb: Optional[Callable[[int], None]] = None

    def __init__(self, deliver: Callable[[bytes, bytes], None]):
        # deliver(header_bytes, payload) — the PML's handle_incoming.
        # Chaos harness receive-side choke point: with a plan armed,
        # every transport's inbound funnel is filtered (side=recv rules:
        # drop/delay/dup by frame source). The wrapper is installed at
        # CONSTRUCTION whenever ANY plan is armed — so the disabled path
        # never pays a wrapper frame, while the rule list itself stays
        # live (install()/uninstall() after btls exist re-point it).
        # Limitation: arming injection from scratch AFTER transports are
        # built only reaches the send-side and op-counter hooks.
        from ompi_tpu_torch.ft import inject as _inject

        if _inject._enable_var._value:
            deliver = _inject.wrap_deliver(deliver)
        self.deliver = deliver

    def send(self, peer: int, header: bytes, payload) -> None:
        raise NotImplementedError

    def progress(self) -> int:
        return 0

    def finalize(self) -> None:
        pass
