"""PERUSE-style request-lifecycle events.

The port of ``ompi_tpu/runtime/peruse.py``, whole.

Reference: ompi/peruse (729 LoC) — an introspection event API tools
subscribe to, with hooks inside the pml (pml_ob1_isend.c:321). Redesign:
named events with subscriber lists, fired from the communicator verb
layer; the empty-subscriber fast path is one truthiness check so the
hot path stays unencumbered.

Events: ``send_posted``, ``recv_posted``, ``request_complete`` — each
callback receives (event, info dict).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Callable, Dict, List

EVENTS = ("send_posted", "recv_posted", "request_complete")

_subscribers: Dict[str, List[Callable]] = defaultdict(list)
enabled = False  # flipped by subscribe(); checked inline at fire sites


def subscribe(event: str, fn: Callable) -> None:
    """PERUSE_Event_comm_register analog."""
    global enabled
    if event not in EVENTS:
        raise ValueError(f"unknown PERUSE event {event!r} (one of {EVENTS})")
    _subscribers[event].append(fn)
    enabled = True


def unsubscribe(event: str, fn: Callable) -> None:
    global enabled
    try:
        _subscribers[event].remove(fn)
    except ValueError:
        pass
    enabled = any(_subscribers.values())


def fire(event: str, **info) -> None:
    for fn in _subscribers.get(event, ()):
        fn(event, info)
