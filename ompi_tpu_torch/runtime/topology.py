"""The accelerator inventory of the host (the hwloc osdev analog).

The port of ``HostTopology.accelerators`` (``ompi_tpu/runtime/topology.py
:66-80``); the host's cpu and NUMA discovery and rank binding are not
ported.
"""

from __future__ import annotations

from typing import List

import torch


def accelerators() -> List[dict]:
    """The CUDA devices torch sees, each ``{id, kind, coords}``: ``kind`` is
    the device name and ``coords`` None (a card has no torus coordinates);
    ``[]`` without a card."""
    if not torch.cuda.is_available():
        return []
    return [{"id": i, "kind": torch.cuda.get_device_name(i), "coords": None}
            for i in range(torch.cuda.device_count())]
