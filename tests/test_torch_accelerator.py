"""The port's accelerator framework, on the CPU.

The module-level cases of ``tests/test_accelerator.py:32-146`` have a
counterpart here (its process-mode cases move buffers through
``COMM_WORLD``, which the port does not have). On a host without a card the
framework selects ``null``, as the reference does without jax; the module
contract is then held on ``CudaAccelerator(device="cpu")``, which treats
CPU tensors as its device's. Where the JAX package's own module answers
the same question (an IPC round trip, the bandwidth fallback), the test
runs it too and compares.
"""

import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ompi_tpu.accelerator import get_module as jax_get_module
from ompi_tpu_torch.accelerator import (
    DeviceBuffer,
    get_module,
    is_device_buffer,
    stage_to_host,
)
from ompi_tpu_torch.accelerator import base as accel_base
from ompi_tpu_torch.accelerator import cuda as accel_cuda
from ompi_tpu_torch.core.errors import MPIError
from ompi_tpu_torch.runtime.topology import accelerators
from ompi_tpu_torch.tools.info import print_header
from tests.test_torch_mca_fixture import mca  # noqa: F401 fixture


@pytest.fixture
def mod():
    return accel_cuda.CudaAccelerator(device="cpu")


@pytest.fixture
def fresh_selection(monkeypatch):
    """Select again in this test, and again after it."""
    accel_base._reset_selection()
    yield monkeypatch
    accel_base._reset_selection()


def test_selection_follows_the_card(fresh_selection):
    # cuda (priority 50) wins where torch sees a card, null (0) elsewhere
    want = "cuda" if torch.cuda.is_available() else "null"
    assert get_module().NAME == want
    assert get_module() is get_module()  # selected once


def test_cuda_query_is_none_only_without_a_card(fresh_selection):
    fresh_selection.setattr(torch.cuda, "is_available", lambda: False)
    assert accel_cuda.CudaComponent().query() is None

    def broken():
        raise OSError("CUDA init fault")

    # any failure but the absence of a card propagates (the JAX package's
    # component returns None for every exception)
    fresh_selection.setattr(torch.cuda, "is_available", broken)
    with pytest.raises(OSError):
        accel_cuda.CudaComponent().query()
    with pytest.raises(OSError):
        get_module()


def test_check_addr(mod):
    assert mod.check_addr(torch.arange(4))
    assert not mod.check_addr(np.arange(4))
    assert not mod.check_addr(b"bytes")
    assert not accel_cuda.CudaAccelerator().check_addr(torch.arange(4))
    # the selected module decides: null here, cuda on the card
    assert is_device_buffer(torch.arange(4)) == torch.cuda.is_available()
    assert not is_device_buffer(np.arange(4))


def test_device_queries(mod):
    assert mod.num_devices() >= 1
    arr = torch.ones(3)
    dev = mod.get_device(arr)
    assert 0 <= dev < mod.num_devices()
    assert mod.get_mem_bw(dev) > 0
    assert mod.device_can_access_peer(0, 0)
    assert not mod.device_can_access_peer(0, mod.num_devices())
    assert mod.get_buffer_id(arr) != mod.get_buffer_id(torch.ones(3))
    assert mod.get_buffer_id(arr[1:]) == mod.get_buffer_id(arr)


def test_mem_bw_table():
    jax_mod = jax_get_module()  # the JAX package's, on its CPU backend
    assert accel_cuda.CudaAccelerator("cpu").get_mem_bw() == \
        jax_mod.get_mem_bw()
    assert accel_cuda._MEM_BW_GBS["NVIDIA H100 80GB HBM3"] == 3350.0


def test_alloc_copy_roundtrip(mod):
    buf = mod.mem_alloc(64)
    assert mod.check_addr(buf) and buf.dtype == torch.uint8
    assert buf.numel() == 64
    host = np.arange(10, dtype=np.float32)
    dev = mod.mem_copy_to_device(host)
    assert mod.check_addr(dev)
    host[0] = 99  # a copy, not a view
    back = mod.mem_copy_to_host(dev)
    np.testing.assert_array_equal(back.numpy(), np.arange(10))
    mod.synchronize(dev)
    mod.synchronize()
    mod.mem_release(buf)
    assert buf.untyped_storage().nbytes() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int64", "bool"])
def test_ipc_handle_roundtrip(mod, dtype):
    x = np.random.default_rng(0).normal(size=(3, 5))
    arr = torch.from_numpy(x).to(getattr(torch, dtype))
    handle = mod.get_ipc_handle(arr)
    assert isinstance(handle, bytes)
    back = mod.open_ipc_handle(handle)
    assert mod.check_addr(back) and back.dtype == arr.dtype
    assert torch.equal(back, arr)
    if dtype in ("float32", "bfloat16"):
        # the same values through the JAX package's handle
        jmod = jax_get_module()
        jback = jmod.open_ipc_handle(jmod.get_ipc_handle(
            jnp.asarray(x, dtype=getattr(jnp, dtype))))
        np.testing.assert_array_equal(
            back.float().numpy(), np.asarray(jback, np.float32))


def test_ipc_handle_of_empty_and_scalar(mod):
    for arr in (torch.zeros((0, 4)), torch.tensor(2.5)):
        back = mod.open_ipc_handle(mod.get_ipc_handle(arr))
        assert back.shape == arr.shape and torch.equal(back, arr)


def test_stage_to_host_is_readonly():
    host = stage_to_host(torch.arange(4))
    np.testing.assert_array_equal(host, np.arange(4))
    with pytest.raises(ValueError):
        host[0] = 1


def test_devicebuffer_wraps_existing_array():
    init = torch.tensor([5, 6], dtype=torch.int32)
    db = DeviceBuffer(init)
    np.testing.assert_array_equal(db.host.numpy(), [5, 6])
    init[0] = 0  # the staging copy is the buffer's own
    assert db.host[0] == 5
    bf = DeviceBuffer((2, 3), torch.bfloat16)
    assert bf.host.dtype == torch.bfloat16 and not bf.host.any()


def test_devicebuffer_tracks_updates(fresh_selection):
    out = DeviceBuffer((2,), torch.int32)
    first = out.array
    out.host.copy_(torch.tensor([7, 8]))
    out._mark_dirty()  # what a verb does after writing the staging copy
    np.testing.assert_array_equal(np.asarray(out.array), [7, 8])
    np.testing.assert_array_equal(np.asarray(out), [7, 8])
    assert out.array is out.array  # one copy a version
    np.testing.assert_array_equal(np.asarray(first), [0, 0])


def test_null_component_forced(fresh_selection, mca):
    mca.port("accelerator", "accelerator", "null")
    m = get_module()
    assert m.NAME == "null"
    assert not m.check_addr(torch.arange(2))
    assert m.num_devices() == 0
    with pytest.raises(MPIError):
        m.get_device(torch.arange(2))
    with pytest.raises(MPIError):
        m.get_ipc_handle(torch.arange(2))


def test_forcing_cuda_without_a_card_raises(fresh_selection, mca):
    mca.port("accelerator", "accelerator", "cuda")
    fresh_selection.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError):
        get_module()


def test_inventory_and_header():
    devs = accelerators()
    assert len(devs) == torch.cuda.device_count()
    assert all(d["coords"] is None for d in devs)
    out = io.StringIO()
    print_header(out)
    text = out.getvalue()
    assert f"torch:    {torch.__version__}" in text
    assert "ompi_tpu_torch:" in text and "cuda:" in text


# ------------------------------------------------ the accelerator variables
@pytest.fixture
def both_selections(monkeypatch):
    """Select again in both packages, in this test and after it."""
    from ompi_tpu.accelerator import base as jbase

    for b in (accel_base, jbase):
        b._reset_selection()
    yield monkeypatch
    for b in (accel_base, jbase):
        b._reset_selection()


@pytest.mark.parametrize("spec,want", [
    ("^{self}", "null"), ("null", "null"), ("null,{self}", None),
    ("{self},null", None), ("^nosuch", None), ("", None)])
def test_accelerator_variable_selects_as_the_reference(both_selections,
                                                       mca, spec, want):
    """``accelerator`` names or excludes components, the port's ``cuda``
    standing where the reference's ``tpu`` stands. A list restricts, and
    priority still orders. Where the setting leaves only ``null``, both
    packages select it; elsewhere the port selects ``cuda`` with a card and
    ``null`` without one."""
    mca.port("accelerator", "accelerator", spec.format(self="cuda"))
    mca.jax("accelerator", "accelerator", spec.format(self="tpu"))
    card = "cuda" if torch.cuda.is_available() else "null"
    assert get_module().NAME == (want or card)
    if want == "null":
        assert jax_get_module().NAME == "null"


def test_accelerator_nosuch_raises_in_both(both_selections, mca):
    mca.both("accelerator", "accelerator", "nosuch")
    for get in (get_module, jax_get_module):
        with pytest.raises(RuntimeError, match="no usable component"):
            get()


def test_mem_bw_override(both_selections, mca, mod):
    """``accelerator_cuda_mem_bw`` overrides ``get_mem_bw`` where it is not
    0, as ``accelerator_tpu_mem_bw`` does the reference's."""
    assert mod.get_mem_bw() == 50.0  # the table's "cpu" row
    mca.port("accelerator", "cuda_mem_bw", "1234")
    mca.jax("accelerator", "tpu_mem_bw", "1234")
    mca.both("accelerator", "accelerator", "")
    assert mod.get_mem_bw() == 1234.0
    if jax_get_module().NAME == "tpu":
        assert jax_get_module().get_mem_bw() == 1234.0
    mca.port("accelerator", "cuda_mem_bw", 0.0)
    assert mod.get_mem_bw() == 50.0


def test_selection_emits_the_mpit_event(both_selections, mca):
    from ompi_tpu_torch import mpit

    mca.port("accelerator", "accelerator", "^cuda")
    mpit.init_thread()
    seen = []
    h = mpit.event_handle_alloc(
        mpit.event_get_index("mca_component_selected"),
        lambda e: seen.append((e.data["framework"], e.data["component"])))
    try:
        get_module()
    finally:
        h.free()
        mpit.finalize()
    assert seen == [("accelerator", "null")]
