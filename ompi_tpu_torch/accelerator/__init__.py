"""Accelerator framework: device buffers as first-class MPI buffers.

The port of ``ompi_tpu/accelerator`` (reference: opal/mca/accelerator,
framework accelerator.h:671-712; components cuda/rocm/ze/null). Here:
``cuda`` (tensors on a card) and ``null`` (the host stub), selected by
priority in ``base.get_module`` under the ``accelerator`` variable. Mesh-mode communicators keep their buffers
on the card and never stage them through this layer.
"""

from ompi_tpu_torch.accelerator.base import (
    AcceleratorModule,
    DeviceBuffer,
    accelerator_framework,
    get_module,
    is_device_buffer,
    stage_to_host,
)
from ompi_tpu_torch.accelerator import cuda as _cuda  # noqa: F401 registers

__all__ = [
    "AcceleratorModule",
    "DeviceBuffer",
    "accelerator_framework",
    "get_module",
    "is_device_buffer",
    "stage_to_host",
]
