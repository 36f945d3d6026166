"""The port's MPI_Pack/Unpack and external32 against the JAX package's.

Every case of ``tests/test_external32.py`` runs on both packages (the ``P``
fixture), through each package's top-level names. Then the two side by
side: the canonical bytes of every predefined type, of derived types
(a strided vector, a struct with out-of-order displacements, complex
components) and of bf16 (the port's uint16 storage against the
reference's ``ml_dtypes`` bfloat16) are equal, and so is what each package
unpacks from the other's stream.
"""

import importlib
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.core import datatype as jdt
from ompi_tpu.core import external32 as jx
from ompi_tpu_torch.core import datatype as tdt
from ompi_tpu_torch.core import external32 as tx


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def P(request):
    root = request.param
    top = importlib.import_module(root)
    return types.SimpleNamespace(
        **{n: getattr(top, n) for n in (
            "Pack", "Pack_external", "Pack_external_size", "Pack_size",
            "Unpack", "Unpack_external", "DOUBLE", "FLOAT", "INT32",
            "INT64")},
        MPIError=importlib.import_module(root + ".core.errors").MPIError,
        from_numpy_dtype=importlib.import_module(
            root + ".core.datatype").from_numpy_dtype)


# ----------------------------------------- tests/test_external32.py cases
def test_native_pack_roundtrip_contiguous(P):
    src = np.arange(10, dtype=np.float64)
    out = np.zeros(P.Pack_size(10, P.DOUBLE), np.uint8)
    pos = P.Pack(src, 10, P.DOUBLE, out, 0)
    assert pos == 80
    back = np.zeros(10, np.float64)
    assert P.Unpack(out, 0, back, 10, P.DOUBLE) == 80
    np.testing.assert_array_equal(back, src)


def test_native_pack_appends_at_position(P):
    a = np.array([7], np.int64)
    b = np.array([1.5], np.float64)
    out = np.zeros(16, np.uint8)
    pos = P.Pack(a, 1, P.INT64, out, 0)
    pos = P.Pack(b, 1, P.DOUBLE, out, pos)
    assert pos == 16
    ra = np.zeros(1, np.int64)
    rb = np.zeros(1, np.float64)
    pos = P.Unpack(out, 0, ra, 1, P.INT64)
    P.Unpack(out, pos, rb, 1, P.DOUBLE)
    assert ra[0] == 7 and rb[0] == 1.5


def test_external32_is_big_endian(P):
    src = np.array([0x01020304], np.uint32)
    dt = P.from_numpy_dtype(np.uint32)
    out = np.zeros(P.Pack_external_size("external32", 1, dt), np.uint8)
    P.Pack_external("external32", src, 1, dt, out, 0)
    assert bytes(out) == b"\x01\x02\x03\x04"  # canonical network order


def test_external32_roundtrip_scalars(P):
    for npdt in (np.int32, np.int64, np.float32, np.float64,
                 np.complex64, np.complex128, np.int8):
        dt = P.from_numpy_dtype(npdt)
        src = (np.arange(5) + 1).astype(npdt)
        out = np.zeros(P.Pack_external_size("external32", 5, dt), np.uint8)
        end = P.Pack_external("external32", src, 5, dt, out, 0)
        assert end == 5 * dt.size
        back = np.zeros(5, npdt)
        assert P.Unpack_external("external32", out, 0, back, 5, dt) == end
        np.testing.assert_array_equal(back, src)


def test_external32_byteswapped_fixture(P):
    """A stream written by a big-endian peer unpacks to native values."""
    vals = np.array([1.0, -2.5, 3e10], np.float64)
    fixture = vals.astype(">f8").tobytes()
    back = np.zeros(3, np.float64)
    P.Unpack_external("external32", np.frombuffer(fixture, np.uint8),
                      0, back, 3, P.DOUBLE)
    np.testing.assert_array_equal(back, vals)

    ints = np.array([-7, 1 << 40], np.int64)
    fixture = ints.astype(">i8").tobytes()
    iback = np.zeros(2, np.int64)
    P.Unpack_external("external32", np.frombuffer(fixture, np.uint8),
                      0, iback, 2, P.INT64)
    np.testing.assert_array_equal(iback, ints)


def test_external32_complex_swaps_components(P):
    z = np.array([1.0 + 2.0j], np.complex128)
    dt = P.from_numpy_dtype(np.complex128)
    out = np.zeros(16, np.uint8)
    P.Pack_external("external32", z, 1, dt, out, 0)
    # each 8-byte component is independently big-endian
    re = np.frombuffer(bytes(out[:8]), ">f8")[0]
    im = np.frombuffer(bytes(out[8:]), ">f8")[0]
    assert re == 1.0 and im == 2.0


def test_external32_derived_vector(P):
    """Strided vector: the canonical stream is dense and big-endian; holes
    survive a roundtrip untouched."""
    vec = P.from_numpy_dtype(np.int32).Create_vector(3, 1, 2).Commit()
    src = np.arange(6, dtype=np.int32)
    n = P.Pack_external_size("external32", 1, vec)
    assert n == 3 * 4
    out = np.zeros(n, np.uint8)
    P.Pack_external("external32", src, 1, vec, out, 0)
    np.testing.assert_array_equal(np.frombuffer(bytes(out), ">i4"), [0, 2, 4])
    dstbuf = np.full(6, -1, np.int32)
    P.Unpack_external("external32", out, 0, dstbuf, 1, vec)
    np.testing.assert_array_equal(dstbuf, [0, -1, 2, -1, 4, -1])


def test_external32_struct_mixed_fields(P):
    base_i = P.from_numpy_dtype(np.int32)
    base_d = P.from_numpy_dtype(np.float64)
    st = base_i.Create_struct([1, 1], [0, 8], [base_i, base_d]).Commit()
    buf = np.zeros(16, np.uint8)
    buf[:4] = np.frombuffer(np.array([9], np.int32).tobytes(), np.uint8)
    buf[8:] = np.frombuffer(np.array([2.5], np.float64).tobytes(), np.uint8)
    out = np.zeros(P.Pack_external_size("external32", 1, st), np.uint8)
    P.Pack_external("external32", buf, 1, st, out, 0)
    assert np.frombuffer(bytes(out[:4]), ">i4")[0] == 9
    assert np.frombuffer(bytes(out[4:12]), ">f8")[0] == 2.5
    back = np.zeros(16, np.uint8)
    P.Unpack_external("external32", out, 0, back, 1, st)
    np.testing.assert_array_equal(back, buf)


def test_bad_datarep_and_bounds(P):
    src = np.zeros(4, np.float32)
    out = np.zeros(64, np.uint8)
    with pytest.raises(P.MPIError):
        P.Pack_external("native", src, 4, P.FLOAT, out, 0)
    with pytest.raises(P.MPIError):
        P.Pack_external("external32", src, 4, P.FLOAT, np.zeros(8, np.uint8))
    with pytest.raises(P.MPIError):
        P.Unpack_external("external32", np.zeros(4, np.uint8), 0,
                          np.zeros(4, np.int32), 4, P.INT32)


def test_external32_struct_declaration_order(P):
    """The canonical stream follows the typemap's declaration order even
    when displacements are out of order (the interop contract)."""
    base_i = P.from_numpy_dtype(np.int32)
    base_f = P.from_numpy_dtype(np.float64)
    # int32 declared FIRST but placed at disp 8
    st = base_i.Create_struct([1, 1], [8, 0], [base_i, base_f]).Commit()
    buf = np.zeros(12, np.uint8)
    buf[8:] = np.frombuffer(np.array([5], np.int32).tobytes(), np.uint8)
    buf[:8] = np.frombuffer(np.array([1.5], np.float64).tobytes(), np.uint8)
    out = np.zeros(12, np.uint8)
    P.Pack_external("external32", buf, 1, st, out, 0)
    assert np.frombuffer(bytes(out[:4]), ">i4")[0] == 5
    assert np.frombuffer(bytes(out[4:]), ">f8")[0] == 1.5
    back = np.zeros(12, np.uint8)
    P.Unpack_external("external32", out, 0, back, 1, st)
    np.testing.assert_array_equal(back, buf)


# --------------------------------------------- the two packages side by side
PREDEFINED = ["BYTE", "CHAR", "BOOL", "INT8", "INT16", "INT32", "INT64",
              "UINT8", "UINT16", "UINT32", "UINT64", "FLOAT16", "FLOAT32",
              "FLOAT64", "COMPLEX64", "COMPLEX128", "FLOAT_INT",
              "DOUBLE_INT", "INT_INT"]
DERIVED = {
    "vector": lambda D: D.INT32.Create_vector(5, 2, 3),
    "struct_out_of_order": lambda D: D.Datatype.Create_struct(
        [1, 2], [16, 0], [D.INT16, D.COMPLEX64]),
    "subarray": lambda D: D.FLOAT64.Create_subarray([3, 4], [2, 2], [1, 1]),
    "resized": lambda D: D.UINT32.Create_resized(0, 12),
    "indexed": lambda D: D.COMPLEX128.Create_indexed([2, 1], [0, 3]),
}


def _random_bytes(t, count, seed=0):
    need = (count - 1) * t.extent + t.true_lb + t.true_extent
    return np.random.default_rng(seed).integers(0, 256, need, np.uint8)


def _both_ways(jt, tt, count, seed=0):
    """external32 bytes of one buffer through each package, and what each
    unpacks from the other's stream."""
    src = _random_bytes(jt, count, seed)
    n = jx.pack_external_size("external32", count, jt)
    assert tx.pack_external_size("external32", count, tt) == n
    jout, tout = np.zeros(n + 3, np.uint8), np.zeros(n + 3, np.uint8)
    assert jx.pack_external("external32", src, count, jt, jout, 3) == n + 3
    assert tx.pack_external("external32", src, count, tt, tout, 3) == n + 3
    assert jout.tobytes() == tout.tobytes()
    jback, tback = np.zeros_like(src), np.zeros_like(src)
    jx.unpack_external("external32", tout, 3, jback, count, jt)
    tx.unpack_external("external32", jout, 3, tback, count, tt)
    np.testing.assert_array_equal(tback, jback)
    # the native representation too (MPI_Pack at a position)
    jn, tn = np.zeros(n + 5, np.uint8), np.zeros(n + 5, np.uint8)
    assert jx.mpi_pack(src, count, jt, jn, 5) == \
        tx.mpi_pack(src, count, tt, tn, 5)
    assert jn.tobytes() == tn.tobytes()


@pytest.mark.parametrize("name", PREDEFINED)
def test_predefined_external32_bytes_equal_jax(name):
    _both_ways(getattr(jdt, name), getattr(tdt, name), 7)


@pytest.mark.parametrize("name", sorted(DERIVED))
def test_derived_external32_bytes_equal_jax(name):
    _both_ways(DERIVED[name](jdt).Commit(), DERIVED[name](tdt).Commit(), 3)


def test_bf16_external32_equals_ml_dtypes_reference():
    f = np.random.default_rng(3).standard_normal(40).astype(np.float32)
    ref = f.astype(ml_dtypes.bfloat16)
    want = np.zeros(80, np.uint8)
    jx.pack_external("external32", ref, 40, jdt.BFLOAT16, want, 0)
    # a bf16 tensor through the port's BFLOAT16
    tensor = torch.from_numpy(ref.view(np.uint16).copy()).view(torch.bfloat16)
    got = np.zeros(80, np.uint8)
    tx.pack_external("external32", tensor, 40, tdt.BFLOAT16, got, 0)
    assert got.tobytes() == want.tobytes()
    # big-endian 2-byte fields: the bf16 bits byte-swapped
    assert got.tobytes() == ref.view(np.uint16).astype(">u2").tobytes()
    back = torch.zeros(40, dtype=torch.bfloat16)
    tx.unpack_external("external32", want, 0, back, 40, tdt.BFLOAT16)
    assert back.view(torch.int16).numpy().tobytes() == \
        ref.view(np.int16).tobytes()
    # and in a derived type
    jv = jdt.BFLOAT16.Create_vector(10, 1, 4).Commit()
    tv = tdt.BFLOAT16.Create_vector(10, 1, 4).Commit()
    jo, to = np.zeros(20, np.uint8), np.zeros(20, np.uint8)
    jx.pack_external("external32", ref, 1, jv, jo, 0)
    tx.pack_external("external32", tensor, 1, tv, to, 0)
    assert jo.tobytes() == to.tobytes()
