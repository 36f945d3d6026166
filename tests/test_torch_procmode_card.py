"""Phase 4m's checks (``chip_smoke.phase_procmode``): the port's process
mode beside the card.

The first test rehearses the phase on the CPU with every payload divided
by 64: the same three jobs under the port's ``mpirun`` (4 ranks over
``self,sm``, 4 over the plain tcp stream, 3 over the default btls), every
send staged, every receive through a ``DeviceBuffer`` (on the CPU the
null accelerator's copies), every result held against its closed form bit
for bit. The others need the card and skip without one: the counterpart
of the JAX package's ``tests/procmode/check_accelerator.py`` as a 2-rank
sm job with CUDA tensors and device buffers (and a raw CUDA tensor refused
as a receive buffer, as a ``jax.Array`` is), a bf16 tensor on the card
staged to the host and back, and phases 4n and 4o at full size
(``chip_smoke.phase_collstack`` and ``phase_hostcoll``; their CPU
rehearsals are ``tests/test_torch_collstack_card.py`` and
``tests/test_torch_hostcoll_card.py``). The file imports torch and the
port only, so it runs where JAX is not installed:

    python -m pytest --noconftest -q tests/test_torch_procmode_card.py
"""

import importlib.util
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

REHEARSAL_SCALE = 64

RANK = f'''\
import importlib.util
import sys

spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.exit(cs.procmode_rank(device="cpu", scale=int(sys.argv[1])))
'''


def test_phase_4m_rehearses_on_the_cpu(tmp_path):
    prog = tmp_path / "procmode_rank.py"
    prog.write_text(RANK)
    jobs = cs.phase_procmode("cpu", device="cpu", scale=REHEARSAL_SCALE,
                             rank_prog=[str(prog), str(REHEARSAL_SCALE)])
    assert [(j["ranks"], j["btls"]) for j in jobs] == [
        (n, [btl]) for n, _, btl in cs.PM_JOBS]
    for j in jobs:
        # 16 checks and one receive from each peer on every rank, an
        # Exscan on every rank but 0, and one each on the Reduce's and the
        # Gather's roots and the accelerator Send's receiver (the refused
        # raw CUDA receive is checked on the card only)
        n = j["ranks"]
        assert j["checks"] == n * (16 + n - 1) + (n - 1) + 3
        assert set(j["pingpong_gbs"]) == {
            str(b // REHEARSAL_SCALE) for b in cs.PM_PINGPONG}
        assert j["latency_us_8B"] > 0 and j["d2h_gbs"] > 0


ACCEL = '''\
"""Device buffers over the process-mode data path: the counterpart of
the JAX package's tests/procmode/check_accelerator.py, with CUDA tensors
sent and DeviceBuffers received."""
import sys

import numpy as np
import torch

import ompi_tpu_torch
from ompi_tpu_torch import COMM_WORLD
from ompi_tpu_torch.accelerator import (DeviceBuffer, get_module,
                                        is_device_buffer)


def main() -> int:
    r = COMM_WORLD.Get_rank()
    n = COMM_WORLD.Get_size()
    assert get_module().NAME == "cuda", get_module().NAME

    # pt2pt: a tensor on the card sent, a DeviceBuffer received
    if r == 0:
        COMM_WORLD.Send(torch.arange(5, dtype=torch.float32,
                                     device="cuda") * 3, dest=1, tag=1)
    elif r == 1:
        out = DeviceBuffer((5,), torch.float32)
        COMM_WORLD.Recv(out, source=0, tag=1)
        arr = out.array
        assert is_device_buffer(arr) and arr.is_cuda
        assert torch.equal(arr, torch.arange(5, dtype=torch.float32,
                                             device="cuda") * 3)

    # allreduce with device buffers on every rank, bf16
    send = torch.full((4,), float(r + 1), dtype=torch.bfloat16,
                      device="cuda")
    out = DeviceBuffer((4,), torch.bfloat16)
    COMM_WORLD.Allreduce(send, out)
    assert float(out.array[0]) == n * (n + 1) / 2, out.array

    # bcast of a staged device tensor through DeviceBuffers on all ranks
    db = DeviceBuffer(torch.arange(3, dtype=torch.int32, device="cuda")
                      + 10) if r == 0 else DeviceBuffer((3,), torch.int32)
    COMM_WORLD.Bcast(db, root=0)
    assert db.array.tolist() == [10, 11, 12]

    # a raw tensor on the card is no receive buffer: it fails loudly
    req = COMM_WORLD.Irecv(torch.zeros(2, device="cuda"), source=r, tag=4)
    try:
        COMM_WORLD.Send(np.ones(2, np.float32), dest=r, tag=4)
        req.Wait()
    except (ompi_tpu_torch.MPIError, ValueError):
        pass
    else:
        raise SystemExit("a receive into a raw CUDA tensor did not raise")

    print(f"ACCEL-OK rank {r}", flush=True)
    ompi_tpu_torch.Finalize()
    return 0


if __name__ == "__main__":
    sys.exit(main())
'''


@pytest.mark.cuda
def test_check_accelerator_counterpart_2_ranks_over_sm(tmp_path):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    prog = tmp_path / "check_accelerator.py"
    prog.write_text(ACCEL)
    env = dict(os.environ)
    env.pop("OMPI_TPU_RANK", None)
    r = subprocess.run(
        [sys.executable, "-m", "ompi_tpu_torch.tools.mpirun", "-np", "2",
         "--timeout", "110", "--mca", "btl_btl", "self,sm", str(prog)],
        cwd=ROOT, capture_output=True, text=True, timeout=120, env=env)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("ACCEL-OK") == 2


@pytest.mark.cuda
def test_bf16_on_the_card_stages_and_comes_back_equal():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ompi_tpu_torch.accelerator import stage_to_host
    from ompi_tpu_torch.comm.communicator import parse_buffer
    from ompi_tpu_torch.core.datatype import BFLOAT16

    gen = torch.Generator(device="cuda").manual_seed(5)
    t = torch.randn(1 << 20, generator=gen, device="cuda").to(torch.bfloat16)
    host = stage_to_host(t)
    assert host.dtype == np.uint16 and not host.flags.writeable
    back = torch.from_numpy(host.copy()).view(torch.bfloat16).cuda()
    assert torch.equal(back.view(torch.int16), t.view(torch.int16))
    obj, count, dt = parse_buffer(t)
    assert dt is BFLOAT16 and count == t.numel()
    assert obj.tobytes() == host.tobytes()


@pytest.mark.cuda
def test_phase_4n_on_the_card():
    """Phase 4n at full size on the card: tuned's blocking verbs at 4 KB
    and 64 MB, every i-verb at 64 MB behind queued card work,
    ``Allreduce_init`` frozen and re-issued, neighbourhood collectives on a
    ring dist-graph, a sessions-only job and a Shrink after a kill, each
    result bit-exact on the card (the rehearsal on the CPU:
    ``tests/test_torch_collstack_card.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = cs.phase_collstack(torch.cuda.get_device_name(0))
    assert [(j["ranks"], j["mode"]) for j in jobs] == [
        (n, mode) for n, _, mode, _ in cs.CS_JOBS]
    for j in jobs:
        algos = {k: v["algorithm"] for k, v in j["algorithms"].items()}
        assert algos["Allreduce SUM f32 4 KB"] == \
            "allreduce_recursive_doubling"
        assert algos["Allreduce SUM f32 64 MB"].startswith("allreduce_ring")


@pytest.mark.cuda
def test_phase_4o_on_the_card():
    """Phase 4o at full size on the card: coll/sm's slots (or its decline
    off x86_64), hier's composition on two fake nodes, han and adapt, and
    the quantized host collectives with int8 and fp8 codes and a fallback
    job, each exact result bit-exact on the card and each quantized one
    within the codec's bound (the rehearsal on the CPU:
    ``tests/test_torch_hostcoll_card.py``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    jobs = cs.phase_hostcoll(torch.cuda.get_device_name(0))
    assert [(j["job"], j["ranks"]) for j in jobs] == [
        (name, n) for name, n, _ in cs.HC_JOBS]
    comms = jobs[0]["comms"]
    assert comms["hier"]["plans"]["allreduce"] == "hier"
    assert comms["han"]["served"]["Bcast bf16 64 MB"] == "adapt"
    assert [j["quant_colls"] for j in jobs[1:]] == [4, 4, 0]


@pytest.mark.cuda
def test_a_cuda_tensor_is_never_viewed_as_host_memory():
    """The round engine's receive view of a CUDA tensor is None: the
    tensor stages to a read-only host copy, so a collective receiving into
    it fails loudly instead of writing a copy the card never sees; its
    send bytes are that staged copy."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from ompi_tpu_torch.coll import algorithms as alg

    t = torch.arange(8, dtype=torch.float32, device="cuda")
    assert alg._direct_view(t) is None
    data, count, _ = alg._packed(t)
    assert count == 8 and data.tobytes() == t.cpu().numpy().tobytes()
