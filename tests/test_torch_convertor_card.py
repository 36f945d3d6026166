"""The datatype engine on tensors that live on the card, staged to the host.

Device data never flows through the engine: a CUDA tensor is staged with
``accelerator.stage_to_host`` (bf16 through an int16 view), packed and
unpacked on the host, and the result is held byte for byte against a torch
expression on the card that selects the same elements. Every test but the
first needs a CUDA device and skips without one; the file imports torch
and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_convertor_card.py

The first test rehearses ``chip_smoke.py``'s phase 4j on the CPU at 64
rows (16 KB packed a case, still above ``_NATIVE_MIN_BYTES``).
"""

import importlib.util
from pathlib import Path

import numpy as np
import pytest
import torch

from ompi_tpu_torch.accelerator import get_module, stage_to_host
from ompi_tpu_torch.core import convertor as cv
from ompi_tpu_torch.core import datatype as D

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _bytes(x):
    return x.contiguous().reshape(-1).view(torch.uint8)


def test_phase_4j_rehearses_on_the_cpu():
    cs.phase_typed("cpu", device="cpu", rows=64)


@pytest.mark.cuda
def test_phase_4j_on_the_card_at_256_rows(cuda):
    cs.phase_typed(torch.cuda.get_device_name(0), device="cuda", rows=256)


DTYPES = {torch.float32: D.FLOAT32, torch.float64: D.FLOAT64,
          torch.float16: D.FLOAT16, torch.bfloat16: D.BFLOAT16,
          torch.int32: D.INT32, torch.complex64: D.COMPLEX64}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", list(DTYPES), ids=str)
@pytest.mark.parametrize("native", [True, False])
def test_staged_vector_pack_and_unpack_equal_the_card(cuda, dtype, native,
                                                      monkeypatch):
    """Every third element of a [64, 96] tensor made on the card: packed
    bytes against ``t[:, ::3]`` and the unpacked buffer against the masked
    copy, on the native engine and on the numpy path."""
    monkeypatch.setattr(cv, "_NATIVE_MIN_BYTES", 1 if native else 1 << 62)
    gen = torch.Generator(device="cuda").manual_seed(3)
    if dtype.is_floating_point or dtype.is_complex:
        t = torch.randn(64, 96, generator=gen, device=cuda, dtype=dtype)
    else:
        t = torch.randint(-1000, 1000, (64, 96), generator=gen, device=cuda,
                          dtype=dtype)
    row = t.shape[1] * t.element_size()
    dt = DTYPES[dtype].Create_vector(32, 1, 3).Create_resized(0, row).Commit()
    host = stage_to_host(t.view(torch.int16) if dtype == torch.bfloat16
                         else t)
    packed = cv.pack(host, 64, dt)
    dev = get_module().mem_copy_to_device(np.array(packed))
    assert torch.equal(dev, _bytes(t[:, ::3]))
    out = np.zeros(host.nbytes, np.uint8)
    cv.unpack(packed, out, 64, dt)
    masked = torch.zeros_like(t)
    masked[:, ::3] = t[:, ::3]
    assert torch.equal(get_module().mem_copy_to_device(out), _bytes(masked))


@pytest.mark.cuda
@pytest.mark.parametrize("frag", [4096, 65536])
def test_receive_fragments_out_of_order_on_the_card(cuda, frag):
    """The receive side of a Convertor: fragments of the whole pack,
    unpacked out of order with set_position, equal the masked copy."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    t = torch.rand(256, 512, generator=gen, device=cuda)
    dt = D.FLOAT32.Create_vector(256, 1, 2).Create_resized(0, 512 * 4)
    host = stage_to_host(t)
    packed = np.array(cv.pack(host, 256, dt))
    out = np.zeros(host.nbytes, np.uint8)
    conv = cv.Convertor(out, 256, dt, for_send=False)
    for s in np.random.default_rng(5).permutation(
            np.arange(0, packed.nbytes, frag)):
        conv.set_position(int(s))
        conv.unpack_frag(packed[s:s + frag])
    masked = torch.zeros_like(t)
    masked[:, ::2] = t[:, ::2]
    assert torch.equal(get_module().mem_copy_to_device(out), _bytes(masked))


@pytest.mark.cuda
def test_a_cuda_tensor_is_refused_by_the_engine(cuda):
    t = torch.zeros(1024, device=cuda)
    with pytest.raises(TypeError, match="stage_to_host"):
        cv.pack(t, 1024, D.FLOAT32)
    with pytest.raises(TypeError, match="stage_to_host"):
        cv.unpack(np.zeros(4096, np.uint8), t, 1024, D.FLOAT32)
