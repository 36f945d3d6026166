"""accelerator/cuda — the CUDA accelerator component, over ``torch.Tensor``.

The port of ``ompi_tpu/accelerator/tpu.py:45-213``, which wraps
``jax.Array`` buffers; reference peer: opal/mca/accelerator/cuda
(accelerator_cuda.c). A device buffer is a tensor on a CUDA device; copies
are ``Tensor.to``, and bandwidth comes from a table of published memory
rates keyed by the device name (the reference component reads it from
NVML); ``accelerator_cuda_mem_bw`` overrides it where it is not 0.

IPC keeps the JAX package's contract: the handle carries dtype, shape and
data through host memory. The dtype travels by its torch name, so bf16
(which numpy lacks) round-trips, and ``torch.frombuffer`` rebuilds the
tensor.
"""

from __future__ import annotations

import struct
from typing import Any, Optional

import numpy as np
import torch

from ompi_tpu_torch.accelerator.base import (AcceleratorModule,
                                             accelerator_framework)
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG
from ompi_tpu_torch.mca.component import Component
from ompi_tpu_torch.mca.var import register_var

# Published device memory bandwidth, GB/s (NVIDIA data sheets), by the name
# torch.cuda.get_device_name gives; "cpu" is the fallback, as in the JAX
# package's table
_MEM_BW_GBS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
    "NVIDIA H100 NVL": 3900.0,
    "NVIDIA H200": 4800.0,
    "NVIDIA A100-SXM4-80GB": 2039.0,
    "NVIDIA A100-SXM4-40GB": 1555.0,
    "cpu": 50.0,
}

# the counterpart of the reference's accelerator_tpu_mem_bw
# (ompi_tpu/accelerator/tpu.py:41-43)
_mem_bw_var = register_var(
    "accelerator", "cuda_mem_bw", 0.0, float,
    help="Override the device memory bandwidth estimate (GB/s); 0=auto",
    level=7)


class CudaAccelerator(AcceleratorModule):
    """The module over tensors on ``device``'s type: ``cuda`` by default;
    ``device="cpu"`` treats CPU tensors as the device's, which is how the
    module's contract is tested on a host without a card."""

    NAME = "cuda"

    def __init__(self, device: str = "cuda"):
        self._type = torch.device(device).type

    # --- identity ------------------------------------------------------
    def check_addr(self, obj: Any) -> bool:
        return isinstance(obj, torch.Tensor) and obj.device.type == self._type

    def num_devices(self) -> int:
        return torch.cuda.device_count() if self._type == "cuda" else 1

    def get_device(self, obj: Any) -> int:
        return obj.device.index or 0

    def get_buffer_id(self, obj: Any) -> int:
        # the allocation's address: views of one buffer share it
        return obj.untyped_storage().data_ptr()

    def device_can_access_peer(self, dev_a: int, dev_b: int) -> bool:
        n = self.num_devices()
        if not (0 <= dev_a < n and 0 <= dev_b < n):
            return False
        return dev_a == dev_b or torch.cuda.can_device_access_peer(dev_a,
                                                                   dev_b)

    def get_mem_bw(self, device: int = 0) -> float:
        override = _mem_bw_var._value
        if override:
            return float(override)
        name = (torch.cuda.get_device_name(device) if self._type == "cuda"
                else "cpu")
        return _MEM_BW_GBS.get(name, _MEM_BW_GBS["cpu"])

    # --- alloc / copy --------------------------------------------------
    def _device(self, index: Optional[int]) -> torch.device:
        return torch.device(self._type, index) if self._type == "cuda" \
            else torch.device(self._type)

    def mem_alloc(self, nbytes: int, device: int = 0) -> Any:
        return torch.empty(nbytes, dtype=torch.uint8,
                           device=self._device(device))

    def mem_release(self, obj: Any) -> None:
        # the allocation goes back to the caching allocator now, as a
        # deleted jax.Array's does; the tensor can no longer be read
        obj.untyped_storage().resize_(0)

    def mem_copy_to_host(self, obj: Any) -> torch.Tensor:
        return obj.detach().to("cpu", copy=True)

    def mem_copy_to_device(self, host: Any,
                           device: Optional[int] = None) -> Any:
        # always a copy: a "device" tensor on the CPU must not alias host
        return torch.as_tensor(host).to(self._device(device), copy=True)

    def synchronize(self, obj: Any = None) -> None:
        if self._type == "cuda":
            torch.cuda.synchronize(None if obj is None else obj.device)

    # --- IPC -----------------------------------------------------------
    # Wire format: u8 dtype-name length | torch dtype name | u8 ndim |
    # i64 dims... | raw row-major bytes.
    def get_ipc_handle(self, obj: Any) -> bytes:
        host = self.mem_copy_to_host(obj).contiguous()
        name = str(host.dtype).removeprefix("torch.").encode()
        hdr = struct.pack("<B", len(name)) + name
        hdr += struct.pack("<B", host.dim())
        hdr += struct.pack(f"<{host.dim()}q", *host.shape)
        raw = host.reshape(-1).view(torch.uint8).numpy().tobytes()
        return hdr + raw

    def open_ipc_handle(self, handle: bytes) -> Any:
        mv = memoryview(handle)
        nlen = mv[0]
        dtype = getattr(torch, bytes(mv[1: 1 + nlen]).decode())
        off = 1 + nlen
        ndim = mv[off]
        off += 1
        dims = struct.unpack_from(f"<{ndim}q", mv, off)
        off += 8 * ndim
        payload = bytearray(mv[off:])  # frombuffer wants a writable buffer
        host = (torch.frombuffer(payload, dtype=dtype) if payload
                else torch.empty(0, dtype=dtype)).reshape(dims)
        return self.mem_copy_to_device(host)


class CudaComponent(Component):
    NAME = "cuda"
    PRIORITY = 50

    def query(self, **ctx: Any) -> Optional[AcceleratorModule]:
        """The module where torch sees a card, else None. Any other failure
        raises: the JAX package's component swallows every exception."""
        if not torch.cuda.is_available():
            return None
        return CudaAccelerator()


class NullAccelerator(AcceleratorModule):
    """Host-only stub (reference: opal/mca/accelerator/null): nothing is
    device memory, copies are host copies."""

    NAME = "null"

    def check_addr(self, obj: Any) -> bool:
        return False

    def num_devices(self) -> int:
        return 0

    def get_device(self, obj: Any) -> int:
        raise MPIError(ERR_ARG, "null accelerator owns no buffers")

    def get_buffer_id(self, obj: Any) -> int:
        return id(obj)

    def device_can_access_peer(self, dev_a: int, dev_b: int) -> bool:
        return False

    def get_mem_bw(self, device: int = 0) -> float:
        return _MEM_BW_GBS["cpu"]

    def mem_alloc(self, nbytes: int, device: int = 0) -> Any:
        return np.zeros(nbytes, dtype=np.uint8)

    def mem_release(self, obj: Any) -> None:
        pass

    def mem_copy_to_host(self, obj: Any) -> torch.Tensor:
        return torch.as_tensor(obj)

    def mem_copy_to_device(self, host: Any,
                           device: Optional[int] = None) -> Any:
        return torch.as_tensor(host).clone()

    def synchronize(self, obj: Any = None) -> None:
        pass

    def get_ipc_handle(self, obj: Any) -> bytes:
        raise MPIError(ERR_ARG, "null accelerator has no IPC")

    def open_ipc_handle(self, handle: bytes) -> Any:
        raise MPIError(ERR_ARG, "null accelerator has no IPC")


class NullComponent(Component):
    NAME = "null"
    PRIORITY = 0  # the last resort

    def query(self, **ctx: Any) -> Optional[AcceleratorModule]:
        return NullAccelerator()


accelerator_framework.register(CudaComponent())
accelerator_framework.register(NullComponent())
