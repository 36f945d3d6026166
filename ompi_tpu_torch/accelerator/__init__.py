"""Accelerator framework: device buffers as first-class MPI buffers.

The port of ``ompi_tpu/accelerator`` (reference: opal/mca/accelerator,
framework accelerator.h:671-712; components cuda/rocm/ze/null). Here:
``cuda`` (tensors on a card) and ``null`` (the host stub), selected by
priority in ``base.get_module``. Mesh-mode communicators keep their buffers
on the card and never stage them through this layer.
"""

from ompi_tpu_torch.accelerator.base import (
    AcceleratorModule,
    DeviceBuffer,
    get_module,
    is_device_buffer,
    stage_to_host,
)

__all__ = [
    "AcceleratorModule",
    "DeviceBuffer",
    "get_module",
    "is_device_buffer",
    "stage_to_host",
]
