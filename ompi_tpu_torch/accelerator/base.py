"""Accelerator framework: the device-memory abstraction.

The port of ``ompi_tpu/accelerator/base.py:31-209``. Reference:
opal/mca/accelerator/accelerator.h:671-712, the module function table that
every accelerator component (cuda, rocm, ze, null) implements: check_addr,
mem_alloc/release, mem_copy, IPC handles, host_register, get_device,
device_can_access_peer, get_buffer_id, num_devices, get_mem_bw.

Device memory here is a ``torch.Tensor`` on a card. The ``accelerator``
framework holds two components (``cuda`` at priority 50, ``null`` at 0, in
``accelerator/cuda.py``); ``get_module`` selects one, once a process,
through ``select_one`` (reference: ``accelerator/base.py:177``), so the
``accelerator`` variable (``OMPI_TPU_MCA_accelerator_accelerator``) names
or excludes them: ``null``, ``^cuda``, ``cuda,null``. A name that matches
no component raises, as the reference's ``select_one`` does.
"""

from __future__ import annotations

from typing import Any, Optional, Tuple

import numpy as np
import torch

from ompi_tpu_torch.mca.component import framework

accelerator_framework = framework(
    "accelerator", "Device memory abstraction (CUDA/HBM buffers)")


class AcceleratorModule:
    """The module contract (reference: mca_accelerator_base_module_t)."""

    NAME = "base"

    # --- identity / discovery ------------------------------------------
    def check_addr(self, obj: Any) -> bool:
        """Is ``obj`` device memory? (reference: accelerator.h:176, the
        flags out-parameter folded into the bool)."""
        raise NotImplementedError

    def num_devices(self) -> int:
        """reference: accelerator.h:647"""
        raise NotImplementedError

    def get_device(self, obj: Any) -> int:
        """Device ordinal owning the buffer (reference: get_device)."""
        raise NotImplementedError

    def get_buffer_id(self, obj: Any) -> int:
        """Stable id for a device buffer (reference: get_buffer_id, used by
        the rcache to detect buffer reuse)."""
        raise NotImplementedError

    def device_can_access_peer(self, dev_a: int, dev_b: int) -> bool:
        """reference: device_can_access_peer"""
        raise NotImplementedError

    def get_mem_bw(self, device: int = 0) -> float:
        """Device memory bandwidth estimate in GB/s (reference:
        accelerator.h:657, used by coll decision layers to weigh staging
        costs)."""
        raise NotImplementedError

    # --- alloc / copy ---------------------------------------------------
    def mem_alloc(self, nbytes: int, device: int = 0) -> Any:
        """An uninitialized device buffer of ``nbytes`` bytes (reference:
        mem_alloc, accelerator.h:364)."""
        raise NotImplementedError

    def mem_release(self, obj: Any) -> None:
        """reference: mem_release"""
        raise NotImplementedError

    def mem_copy_to_host(self, obj: Any) -> torch.Tensor:
        """DTOH copy into a CPU tensor; waits for the device value
        (reference: mem_copy with MCA_ACCELERATOR_TRANSFER_DTOH)."""
        raise NotImplementedError

    def mem_copy_to_device(self, host: Any,
                           device: Optional[int] = None) -> Any:
        """HTOD copy of a CPU tensor or numpy array (reference: mem_copy
        HTOD)."""
        raise NotImplementedError

    def synchronize(self, obj: Any = None) -> None:
        """Fence outstanding device work on a buffer's card (or every card
        when obj is None); reference: stream/event synchronize,
        accelerator.h:189-258."""
        raise NotImplementedError

    # --- IPC ------------------------------------------------------------
    def get_ipc_handle(self, obj: Any) -> bytes:
        """Serialize a device buffer so another process can rebuild it
        (reference: get_ipc_handle, accelerator.h:447). The bytes carry
        dtype, shape and data through host memory."""
        raise NotImplementedError

    def open_ipc_handle(self, handle: bytes) -> Any:
        """Rebuild a device buffer from a handle (reference:
        open_ipc_handle)."""
        raise NotImplementedError

    # --- host registration ---------------------------------------------
    def host_register(self, host: Any) -> None:
        """Pin host memory for faster DMA (reference: host_register);
        nothing by default."""

    def host_unregister(self, host: Any) -> None:
        pass


class DeviceBuffer:
    """Receive-side holder for device data: a mutable host staging copy,
    a CPU tensor (so bf16 and the other dtypes numpy lacks fit), which a
    verb writes into, and its contents as a device tensor.

    Usage::

        out = DeviceBuffer((4,), torch.float32)
        ...                       # a verb writes out.host, then _mark_dirty
        result = out.array        # a tensor on the selected device
    """

    def __init__(self, shape_or_array, dtype=None,
                 device: Optional[int] = None):
        if dtype is None and hasattr(shape_or_array, "dtype"):
            # wrap an existing tensor or array (device or host) as the
            # initial contents: a mutable host copy
            self.host = torch.as_tensor(shape_or_array).detach().to(
                "cpu", copy=True)
        else:
            shape = (shape_or_array if isinstance(shape_or_array, tuple)
                     else (int(shape_or_array),))
            self.host = torch.zeros(shape, dtype=dtype)
        self.device = device
        self._cache: Tuple[int, Any] = (-1, None)
        self._version = 0

    def _mark_dirty(self) -> None:
        self._version += 1

    @property
    def array(self):
        """The current contents on the device (copied once a version)."""
        ver, arr = self._cache
        if ver != self._version or arr is None:
            arr = get_module().mem_copy_to_device(self.host, self.device)
            self._cache = (self._version, arr)
        return arr

    def __array__(self, dtype=None, copy=None):
        host = self.host.numpy()
        return host if dtype is None else host.astype(dtype)


# ----------------------------------------------------------------- selection
_selected: Optional[AcceleratorModule] = None


def get_module() -> AcceleratorModule:
    """The process-wide accelerator module (reference: the
    opal_accelerator_base_module singleton selected at init,
    accelerator_base_select.c)."""
    global _selected
    if _selected is None:
        _, _selected = accelerator_framework.select_one()
    return _selected


def _reset_selection() -> None:
    """Test hook: select again (after changing the ``accelerator``
    variable)."""
    global _selected
    _selected = None


def is_device_buffer(obj: Any) -> bool:
    """Cheap check of a verb's buffer: only a tensor can be device memory,
    and the selected module says whether this one is."""
    if not isinstance(obj, torch.Tensor):
        return False
    return get_module().check_addr(obj)


def stage_to_host(obj: Any) -> np.ndarray:
    """DTOH-stage a device buffer for the host data path as a READ-ONLY
    ndarray: a write into the staging copy would be lost, so one must fail
    loudly. Receive-side device data goes through DeviceBuffer instead.
    (A dtype numpy lacks, such as bf16, raises TypeError here, as
    ``Tensor.numpy`` does.)"""
    host = np.ascontiguousarray(get_module().mem_copy_to_host(obj).numpy())
    host.flags.writeable = False
    return host
