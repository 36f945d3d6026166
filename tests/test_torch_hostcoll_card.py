"""Phase 4o's checks (``chip_smoke.phase_hostcoll``): the rest of the host
collectives (coll/sm, coll/hier, coll/han with coll/adapt, the quantized
host collectives) beside the card, rehearsed on the CPU with every 64 MB
payload divided by 256: the same four jobs under the port's ``mpirun`` at
the selections of the card run (the collectives job's world, and its Dups
under hier's and han's settings), every send staged, every receive through a
``DeviceBuffer`` (on the CPU the null accelerator's copies), every exact
result held against its closed form bit for bit and every quantized one
within the codec's bound, and the component that served each call. The
card run is ``tests/test_torch_procmode_card.py::test_phase_4o_on_the_card``.
The file imports torch and the port only:

    python -m pytest --noconftest -q tests/test_torch_hostcoll_card.py
"""

import importlib.util
import platform
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
_SPEC = importlib.util.spec_from_file_location("chip_smoke",
                                               ROOT / "chip_smoke.py")
cs = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(cs)

REHEARSAL_SCALE = 256

RANK = f'''\\
import importlib.util
import sys

spec = importlib.util.spec_from_file_location(
    "chip_smoke", {str(ROOT / "chip_smoke.py")!r})
cs = importlib.util.module_from_spec(spec)
spec.loader.exec_module(cs)
sys.exit(cs.hostcoll_rank(device="cpu", scale=int(sys.argv[1])))
'''


def test_phase_4o_rehearses_on_the_cpu(tmp_path):
    prog = tmp_path / "hostcoll_rank.py"
    prog.write_text(RANK)
    jobs = cs.phase_hostcoll("cpu", device="cpu", scale=REHEARSAL_SCALE,
                             rank_prog=[str(prog), str(REHEARSAL_SCALE)])
    assert [(j["job"], j["ranks"]) for j in jobs] == [
        (name, n) for name, n, _ in cs.HC_JOBS]
    colls, int8, fp8, fallback = jobs
    sm, hier, han = (colls["comms"][k]["served"] for k in ("sm", "hier",
                                                            "han"))
    if platform.machine() in ("x86_64", "AMD64"):
        assert sm["Allreduce SUM bf16 64 MB"] == "sm"
        assert sm["Alltoall bf16 indivisible"] == "sm->basic"
        assert colls["allreduce_64mb_host_ms_sm"][0] > 0
        assert colls["allreduce_64mb_host_ms_tuned"][0] > 0
    assert hier["Reduce_scatter_block SUM f32 64 MB"] == "hier"
    assert colls["comms"]["hier"]["plans"] == {v: "hier" for v in (
        "allreduce", "bcast", "allgather", "reduce_scatter_block")}
    assert (han["Barrier"], han["Bcast bf16 64 MB"]) == ("han", "adapt")
    for q in (int8, fp8):
        served = q["comms"][q["job"]]["served"]
        assert served["Allreduce SUM f32 64 MB"] == "quant"
        assert served["Allreduce SUM bf16 64 MB"] == "quant->tuned"
        assert q["quant_colls"] == 4 and q["quant_bytes_wire"] > 0
    assert fp8["quant_bytes_wire"] == int8["quant_bytes_wire"]
    assert fallback["quant_colls"] == 0
    assert fallback["comms"]["quant_fallback"]["served"][
        "Allreduce SUM f32 64 MB"] == "tuned"
