"""ompi_tpu_torch — the PyTorch/CUDA port of ompi_tpu, for NVIDIA Hopper.

The package mirrors ``ompi_tpu``'s layout (``ops/``, ``models/``,
``parallel/``) and holds to its numerics, but imports nothing of it and
nothing of JAX: what it needs from the JAX package it keeps as its own copy.
Every Pallas kernel of the JAX package becomes a hand-written Hopper kernel
here (``csrc/``), built with ``nvcc`` on first use and bound with ``ctypes``;
beside each kernel sits its plain PyTorch version, which a wrapper takes only
for tensors that lie on the CPU.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``
(``device.resolve_device``).
"""

from ompi_tpu_torch.version import __version__
from ompi_tpu_torch.device import resolve_device

__all__ = ["__version__", "resolve_device"]
