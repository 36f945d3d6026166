"""Phase 4l's checks (``chip_smoke.phase_btl``): the byte transfer layer
beside the card.

The first test rehearses the phase on the CPU with every size divided by
256 (the sm ring and the fragments with them, so that the one frame still
takes sm's overflow path and the corrupted stream still has 64 frames).
The second runs the phase at full size on the card and skips without one;
the file imports torch and the port only, so it runs where JAX is not
installed:

    python -m pytest --noconftest -q tests/test_torch_btl_card.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

PATHS = {"self", "tcp", "tcp_legacy", "tcp_compressed", "sm", "sm_python"}


def _check(out, scale):
    assert set(out["gbs"]) == PATHS
    for path, framings in out["gbs"].items():
        assert set(framings) == {"one_frame", "fragments"}
        for rates in framings.values():
            assert set(rates) == {n for n, _, _ in cs.BTL_PAYLOADS}
            assert all(len(r) == cs.BTL_CALLS for r in rates.values())
    assert out["bytes"] == {n: b // scale for n, _, b in cs.BTL_PAYLOADS}
    heal = out["corrupt_heal"]
    assert heal["crc_errors"] > 0 and heal["retransmits"] > 0
    assert heal["frames"] == (64 << 20) // (1 << 20)
    tc = out["tcp_counters"]
    assert tc["tcp_compressed"]["compressed_wire_ratio"] > 1.0
    # the reliable path retains (copies) what it sends; the legacy one
    # copies only what the kernel declines
    assert tc["tcp"]["copied_per_wire_byte"] > \
        tc["tcp_legacy"]["copied_per_wire_byte"]


def test_phase_4l_rehearses_on_the_cpu():
    _check(cs.phase_btl("cpu", device="cpu", scale=256), 256)


@pytest.mark.cuda
def test_phase_4l_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    _check(cs.phase_btl(torch.cuda.get_device_name(0)), 1)


def test_a_cuda_tensor_is_refused_by_the_btls_until_staged():
    """The phase stages every payload: a tensor off the CPU handed to a btl
    raises (a meta tensor stands in where there is no card)."""
    from ompi_tpu_torch.btl.base import host_bytes

    dev = "cuda" if torch.cuda.is_available() else "meta"
    with pytest.raises(TypeError, match="stage_to_host"):
        host_bytes(torch.zeros(4, device=dev))
