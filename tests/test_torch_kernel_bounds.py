"""The bounds and rates that chip_smoke.py reports beside each kernel.

These are pure arithmetic on shapes, so they run on the CPU: the least time
of each flash kernel at the flagship shape ([8, 8, 1024, 128], bf16,
causal) is bound by the bytes it must move, and each kernel's flops are its
products over the visible (q, k) pairs.
"""

import importlib.util
from pathlib import Path

import pytest

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

FLAGSHIP = (8, 8, 1024, 128)


def test_forward_bound_at_the_flagship_shape():
    ms, by = cs.flash_bound_ms(*FLAGSHIP, 2)
    assert by == "bytes"
    assert ms == pytest.approx(0.0251, abs=5e-5)


@pytest.mark.parametrize("which,want", [(0, 0.0302), (1, 0.0402)])
def test_backward_bounds_at_the_flagship_shape(which, want):
    ms, by = cs.flash_bwd_bounds_ms(*FLAGSHIP, 2)[which]
    assert by == "bytes"
    assert ms == pytest.approx(want, abs=5e-5)


@pytest.mark.parametrize("name,per_pair", [("flash_fwd", 4), ("flash_dq", 6),
                                           ("flash_dkv", 8)])
@pytest.mark.parametrize("shape", [FLAGSHIP, (1, 2, 64, 16), (2, 3, 192, 80)])
def test_flops_are_per_visible_pair(name, per_pair, shape):
    B, H, T, D = shape
    pairs = B * H * T * (T + 1) // 2  # the causal triangle, diagonal in
    assert cs.kernel_flops(name, B, H, T, D) == per_pair * D * pairs


def test_rates_are_flops_over_time_and_bound_over_time():
    B, H, T, D = FLAGSHIP
    bound, _ = cs.flash_bound_ms(B, H, T, D, 2)
    tfs, share = cs.rates("flash_fwd", B, H, T, D, 2 * bound, bound)
    assert share == pytest.approx(0.5)
    assert tfs == pytest.approx(
        cs.kernel_flops("flash_fwd", B, H, T, D) / (2 * bound * 1e-3) / 1e12)

