"""Phase 4k's checks (``chip_smoke.phase_diagnostics``): the diagnostic and
fault planes beside the card, at a small size.

The first test rehearses the phase on the CPU (sizes divided by 1024, the
quant sweep at 64 KB a rank), where every request completes when its verb
returns: the pending request and the timings behind queued work are left
out there. The others need a CUDA device and skip without one; the file
imports torch and the port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_diagnostics_card.py
"""

import importlib.util
from pathlib import Path

import pytest
import torch

_SPEC = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_phase_4k_rehearses_on_the_cpu():
    out = cs.phase_diagnostics("cpu", device="cpu", scale=1024,
                               quant_sizes=(1 << 16,))
    assert out["requests"]["completion_ticks"] == len(cs.DIAG_IVERBS)
    assert out["requests"]["pending_named"] == 0
    assert out["metrics"]["gauges"] == 1 * 2 + 2 + 6 + 1


@pytest.mark.cuda
def test_phase_4k_on_the_card_at_a_small_size(cuda):
    out = cs.phase_diagnostics(torch.cuda.get_device_name(0), device="cuda",
                               scale=16, quant_sizes=(1 << 16,))
    assert out["requests"]["pending_named"] == 1
    assert set(out["requests"]["iverb_host_us_behind_queued_work"]) == {
        "off", "forensics", "sanitizer_level2"}
    assert out["topology"]["accelerators"][0] == torch.cuda.get_device_name(0)


@pytest.mark.cuda
def test_a_pending_card_request_is_a_leak_until_its_wait(cuda):
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.runtime import sanitizer

    w = mesh_world(cs.COMM_W)
    x = torch.randn((cs.COMM_W, 1 << 16), device="cuda")
    cycles = cs._sleep_cycles(20.0)
    sanitizer.enable(level=2)
    try:
        torch.cuda.synchronize()
        torch.cuda._sleep(cycles)
        req = w.iallreduce(x)
        assert [r for r, _ in sanitizer.check_leaks()] == [req]
        req.Wait()
        assert sanitizer.check_leaks() == []
    finally:
        sanitizer.disable()


@pytest.mark.cuda
def test_the_completion_tick_counts_card_requests(cuda):
    from ompi_tpu_torch.mca.var import set_var
    from ompi_tpu_torch.parallel.mesh import mesh_world
    from ompi_tpu_torch.runtime import forensics

    w = mesh_world(cs.COMM_W)
    x = torch.randn((cs.COMM_W, 1 << 16), device="cuda")
    set_var("forensics", "enable", True)
    try:
        base = forensics._completions[0]
        reqs = [w.iallreduce(x), w.iallgather(x), w.ibcast(x, 1)]
        for r in reqs:
            r.Wait()
        assert forensics._completions[0] == base + 3
    finally:
        set_var("forensics", "enable", False)


@pytest.mark.cuda
def test_the_card_is_in_the_host_topology(cuda):
    from ompi_tpu_torch.runtime import topology

    acc = topology.discover().accelerators()
    assert [a["kind"] for a in acc] == [
        torch.cuda.get_device_name(i) for i in range(torch.cuda.device_count())]
