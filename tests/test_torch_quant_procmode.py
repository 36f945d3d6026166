"""The host path of the port's quantized collectives (``QuantProcColl``, the
process-mode negotiation and the host codec) against the JAX package.

- ``tests/test_quant.py``'s three process-mode cases on a renamed copy:
  the quantized Allreduce/Allgather/Reduce_scatter_block at 3 ranks
  (within the codec's bound, bitwise equal to ``simulate_allreduce``,
  the counters' >= 3.5x), one rank without ``quant_enable`` making every
  rank fall back together, and compressed tcp frames under chaos; and its
  78 codec and negotiation cases (round trips, the bound's property
  sweep, adversarial inputs, the card cache, the fallback chain).
- ``check_quant.py``'s quant and fallback modes in jobs of JAX-package and
  port ranks at the default selection, and an fp8 Allreduce in such a
  job: the ranks of both packages exchange one code stream, so a code byte
  that differed would tear the result.
- The codec's bytes: seeded inputs with adversarial values (ties, nan,
  +-inf, signed zeros, subnormals, 224, 448, f64 past the f32 range)
  through both packages' ``encode`` and ``decode`` for int8, int4 and fp8
  at several blocks and lengths are equal, and so are the fp8 codes of
  every tie and value of the e4m3fn grid against ``ml_dtypes``.
"""

import os

import ml_dtypes
import numpy as np
import pytest

from tests.test_torch_procmode_fixture import (
    JAX,
    PORT,
    REPO,
    mixed_program,
    passed,
    renamed,
    run_mpi,
    run_renamed_tests,
)

PROC_CASES = ("test_procmode_quantized_collectives or "
              "test_procmode_negotiation_fallback or "
              "test_procmode_tcp_compression_under_chaos")
# test_quant.py launches through a run_mpi of its own: its jobs run the
# renamed check script under the port's mpirun
QUANT_SUBS = (
    ("from ompi_tpu_torch.quant.codec import chunk_layout, make_codec  "
     "# noqa: E402",
     "from ompi_tpu_torch.quant.codec import chunk_layout, make_codec  "
     "# noqa: E402\n"
     "from tests.test_torch_procmode_fixture import port_script  "
     "# noqa: E402"),
    ("    cmd += [script, *args]", "    cmd += [port_script(script), *args]"),
)
QUANT_ON = (("quant_enable", "1"), ("quant_min_bytes", "2048"))
# the codec and negotiation cases that the host codec brings within reach
# (the mesh cases run in tests/test_torch_quant.py, the tcp ones in
# tests/test_torch_btl.py); the port names the counters' reset
# reset_counters
CODEC_CASES = ("roundtrip_bound or property_sweep or adversarial_inputs or "
               "f64_amax or wire_ratio or chunk_layout or rejects_bad or "
               "negotiate_verdicts or card_roundtrip or full_priority_chain "
               "or delegate_prefers or cache_and_invalidate or note_coll")
RESET = (("quant._reset_for_testing()", "quant.reset_counters()"),)


@pytest.mark.parametrize("select,subs,count", [
    (PROC_CASES, QUANT_SUBS, 3), (CODEC_CASES, QUANT_SUBS + RESET, 78)],
    ids=["procmode", "codec"])
def test_cases_on_the_port(tmp_path, select, subs, count):
    r = run_renamed_tests("test_quant.py", tmp_path, select, subs)
    assert r.returncode == 0, r.stdout + r.stderr
    assert passed(r) == count, r.stdout


@pytest.mark.parametrize("mode,mca,tag", [("quant", QUANT_ON, "QUANT-OK"),
                                          ("fallback", (), "FALLBACK-OK")])
def test_mixed_check_quant(tmp_path, mode, mca, tag):
    r = run_mpi(3, mixed_program(tmp_path),
                os.path.join(REPO, "tests", "procmode", "check_quant.py"),
                renamed("check_quant.py", tmp_path), mode, mca=mca,
                timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count(tag) == 3


FP8 = '''\
import numpy as np
import {pkg}
from {pkg} import COMM_WORLD as W
from {pkg}.mca.var import all_pvars
from {pkg}.quant.codec import make_codec

r, n = W.Get_rank(), W.Get_size()
assert W.coll.providers["allreduce"] == "quant", W.coll.providers
rng = np.random.RandomState(11)
xs = (rng.randn(n, 5000) * rng.uniform(0.01, 50.0, (n, 1))).astype(
    np.float32)
xs[:, 7] = 224.0
xs[:, 8] = -448.0
xs[:, 9] = 2.0 ** -12
out = np.zeros(5000, np.float32)
W.Allreduce(xs[r].copy(), out)
codec = make_codec("fp8", 8, 64)
assert np.array_equal(out, codec.simulate_allreduce(xs))
err = np.abs(out.astype(np.float64) - xs.astype(np.float64).sum(axis=0))
assert np.all(err <= codec.error_bound(xs))
assert all_pvars()["quant_colls"].value == 1
W.Barrier()
{pkg}.Finalize()
print(f"FP8-OK {{r}}", flush=True)
'''


def test_mixed_fp8_allreduce_equals_the_oracle(tmp_path):
    progs = []
    for pkg in (JAX, PORT):
        progs.append(tmp_path / f"fp8_{pkg}.py")
        progs[-1].write_text(FP8.format(pkg=pkg))
    r = run_mpi(3, mixed_program(tmp_path), *progs,
                mca=QUANT_ON + (("quant_mode", "fp8"),), timeout=180)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.count("FP8-OK") == 3


# ------------------------------------------------------------------ codec
def _adversarial(rng, n, dtype, block):
    x = (rng.randn(n) * 10.0 ** rng.uniform(-6, 4)).astype(dtype)
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 224.0, 448.0, 1e-40,
                -3e-45, 2.0 ** -9, 2.0 ** -10, 1.0625, 1.1875]
    if np.dtype(dtype) == np.float64:
        specials += [1e300, -1e-300]
    for i, v in enumerate(specials):
        if n > 2 * block + i:
            x[2 * block + i] = v
    if n > block:
        x[:block] = np.float32(7.0) * np.arange(block) / 8.0  # ties
    return x


CODECS = [("int8", 8, 16), ("int8", 8, 64), ("int8", 4, 64), ("int8", 4, 7),
          ("fp8", 8, 64), ("fp8", 8, 100)]


@pytest.mark.parametrize("mode,bits,block", CODECS)
def test_codec_bytes_equal_the_reference(mode, bits, block):
    from ompi_tpu.quant.codec import make_codec as jcodec
    from ompi_tpu_torch.quant.codec import make_codec as tcodec

    j, t = jcodec(mode, bits, block), tcodec(mode, bits, block)
    rng = np.random.RandomState(block * bits)
    for n in (1, 7, block, 3 * block + 5, 2000):
        for dtype in (np.float32, np.float64, np.float16):
            x = _adversarial(rng, n, dtype, block)
            enc = t.encode(x)
            assert enc.tobytes() == j.encode(x).tobytes(), (n, dtype)
            dec = t.decode(enc, n, dtype)
            ref = j.decode(enc, n, dtype)
            assert dec.dtype == ref.dtype
            assert dec.tobytes() == ref.tobytes(), (n, dtype)
    xs = _adversarial(rng, 3 * 700, np.float32, block).reshape(3, 700)
    with np.errstate(invalid="ignore"):
        assert t.simulate_allreduce(xs).tobytes() == \
            j.simulate_allreduce(xs).tobytes()


def test_fp8_codes_equal_ml_dtypes_on_the_grid_and_its_ties():
    from ompi_tpu_torch.quant.codec import _E4M3FN_VALUES, _e4m3fn_codes

    f8 = np.dtype(ml_dtypes.float8_e4m3fn)
    assert np.array_equal(
        _E4M3FN_VALUES,
        np.arange(256, dtype=np.uint8).view(f8).astype(np.float64),
        equal_nan=True)
    grid = np.unique(_E4M3FN_VALUES[np.isfinite(_E4M3FN_VALUES)])
    ties = (grid[1:] + grid[:-1]) / 2
    rng = np.random.RandomState(5)
    x = np.concatenate([grid, ties, np.nextafter(ties, np.inf),
                        np.nextafter(ties, -np.inf),
                        rng.randn(20000) * 10.0 ** rng.uniform(-12, 4, 20000),
                        [460.0, 464.0, 465.0, 480.0, 1e30, np.inf, -np.inf,
                         np.nan, -0.0, 1e-45]])
    for dtype in (np.float32, np.float64):
        v = x.astype(dtype)
        with np.errstate(over="ignore"):
            want = v.astype(f8).view(np.uint8)
        assert np.array_equal(_e4m3fn_codes(v), want), dtype
