"""The port's datatype engine against the JAX package's, on the CPU.

``ompi_tpu_torch/core/datatype.py``, ``core/convertor.py`` and the native
runs engine (``ompi_tpu_torch/native``) against ``ompi_tpu``'s:

- every case of ``tests/test_datatype.py`` runs on both packages (the
  ``P`` fixture), so each counts twice;
- for every constructor case the two packages give equal size, extent,
  true extent, envelope, contents, typemap, byte map, runs and packed and
  unpacked bytes, on the native path and on the numpy path;
- bf16: the port's ``BFLOAT16`` is 2-byte uint16 storage named
  ``MPI_BFLOAT16``, never ``FLOAT16``, and packs to the bytes the
  reference's ``ml_dtypes`` bf16 packs to; a subprocess that blocks the
  import of ``ml_dtypes`` still gets it;
- the native build: one that fails raises with the compiler's output at
  or above ``_NATIVE_MIN_BYTES`` (no quiet numpy fallback) while a pack
  below it still works; concurrent builds of one library all succeed;
- CPU tensors are viewed as bytes without a copy (bf16 included), and a
  tensor off the CPU is refused with a ``TypeError`` that names
  ``accelerator.stage_to_host``.
"""

import importlib
import os
import subprocess
import sys
import threading
import types

import ml_dtypes
import numpy as np
import pytest
import torch

from ompi_tpu.core import convertor as jcv
from ompi_tpu.core import datatype as jdt
from ompi_tpu_torch import native
from ompi_tpu_torch.core import convertor as tcv
from ompi_tpu_torch.core import datatype as tdt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load(root):
    return types.SimpleNamespace(
        top=importlib.import_module(root),
        cv=importlib.import_module(root + ".core.convertor"),
        dt=importlib.import_module(root + ".core.datatype"),
        errors=importlib.import_module(root + ".core.errors"),
        status=importlib.import_module(root + ".core.status"))


@pytest.fixture(params=["ompi_tpu", "ompi_tpu_torch"])
def P(request):
    return _load(request.param)


# ------------------------------------------- tests/test_datatype.py cases
def test_predefined_sizes(P):
    D = P.dt
    assert D.FLOAT32.size == 4 and D.FLOAT32.extent == 4
    assert D.FLOAT64.size == 8
    assert D.BYTE.size == 1
    assert D.FLOAT32.is_contiguous


def test_from_numpy_dtype(P):
    D = P.dt
    assert D.from_numpy_dtype(np.float32) is D.FLOAT32
    assert D.from_numpy_dtype("int32") is D.INT32
    with pytest.raises(P.errors.MPIError):
        D.from_numpy_dtype(np.dtype([("a", np.int32)]))


def test_contiguous_pack_roundtrip(P):
    t = P.dt.FLOAT32.Create_contiguous(5).Commit()
    assert t.size == 20 and t.extent == 20 and t.is_contiguous
    src = np.arange(10, dtype=np.float32)
    packed = P.cv.pack(src, 2, t)
    assert packed.nbytes == 40
    dst = np.zeros(10, dtype=np.float32)
    P.cv.unpack(packed, dst, 2, t)
    np.testing.assert_array_equal(src, dst)


def test_vector_pack_roundtrip(P):
    # 3 blocks of 2 floats, stride 4 floats: elements 0,1, 4,5, 8,9
    t = P.dt.FLOAT32.Create_vector(3, 2, 4).Commit()
    assert t.size == 24
    assert not t.is_contiguous
    src = np.arange(12, dtype=np.float32)
    packed = P.cv.pack(src, 1, t)
    got = np.frombuffer(packed.tobytes(), dtype=np.float32)
    np.testing.assert_array_equal(got, [0, 1, 4, 5, 8, 9])
    dst = np.zeros(12, dtype=np.float32)
    P.cv.unpack(packed, dst, 1, t)
    np.testing.assert_array_equal(dst, [0, 1, 0, 0, 4, 5, 0, 0, 8, 9, 0, 0])


def test_indexed_pack(P):
    t = P.dt.INT32.Create_indexed([2, 1], [0, 3]).Commit()
    src = np.arange(8, dtype=np.int32)
    got = np.frombuffer(P.cv.pack(src, 2, t).tobytes(), dtype=np.int32)
    # element 0: ints 0,1,3 ; element 1 starts at extent=4 ints: 4,5,7
    np.testing.assert_array_equal(got, [0, 1, 3, 4, 5, 7])


def test_struct_pack(P):
    src = np.zeros(2, dtype=[("v", np.float32), ("i", np.int32)])
    src["v"] = [1.5, 2.5]
    src["i"] = [10, 20]
    got = P.cv.pack(src, 2, P.dt.FLOAT_INT)
    back = np.frombuffer(got.tobytes(),
                         dtype=[("v", np.float32), ("i", np.int32)])
    np.testing.assert_array_equal(back["v"], [1.5, 2.5])
    np.testing.assert_array_equal(back["i"], [10, 20])


def test_subarray_pack(P):
    # 4x4 array, take 2x2 block starting at (1,1)
    t = P.dt.FLOAT32.Create_subarray([4, 4], [2, 2], [1, 1]).Commit()
    src = np.arange(16, dtype=np.float32)
    got = np.frombuffer(P.cv.pack(src, 1, t).tobytes(), dtype=np.float32)
    np.testing.assert_array_equal(got, [5, 6, 9, 10])


def test_resized_extent(P):
    t = P.dt.FLOAT32.Create_resized(0, 16)
    assert t.extent == 16 and t.size == 4
    c = t.Create_contiguous(3).Commit()
    src = np.arange(12, dtype=np.float32)
    got = np.frombuffer(P.cv.pack(src, 1, c).tobytes(), dtype=np.float32)
    np.testing.assert_array_equal(got, [0, 4, 8])  # one float every 16 bytes


def test_convertor_partial_pack(P):
    """Drain a message in odd-sized fragments and reassemble (reference:
    test/datatype/partial.c)."""
    t = P.dt.FLOAT32.Create_vector(4, 3, 5).Commit()  # 48 data bytes
    src = np.arange(20, dtype=np.float32)
    conv = P.cv.Convertor(src, 1, t, for_send=True)
    frags = []
    for frag_size in [7, 13, 1, 48]:
        if conv.remaining == 0:
            break
        frags.append(conv.pack_frag(frag_size).copy())
    stream = np.concatenate(frags)
    assert stream.nbytes == t.size

    dst = np.zeros(20, dtype=np.float32)
    rconv = P.cv.Convertor(dst, 1, t, for_send=False)
    off = 0
    for sz in [3, 20, 25]:
        rconv.unpack_frag(stream[off : off + sz])
        off += sz
    expect = np.zeros(20, dtype=np.float32)
    for b in range(4):
        expect[b * 5 : b * 5 + 3] = src[b * 5 : b * 5 + 3]
    np.testing.assert_array_equal(dst, expect)


def test_convertor_set_position(P):
    """Random repositioning (reference: test/datatype/position.c)."""
    t = P.dt.FLOAT32.Create_vector(2, 2, 3).Commit()
    src = np.arange(6, dtype=np.float32)  # packs [0,1,3,4]
    conv = P.cv.Convertor(src, 1, t, for_send=True)
    conv.set_position(8)
    frag = conv.pack_frag(8)
    got = np.frombuffer(frag.tobytes(), dtype=np.float32)
    np.testing.assert_array_equal(got, [3, 4])


def test_large_contiguous_zero_copy(P):
    """Big contiguous packs must not copy (reference: large_data.c)."""
    src = np.zeros(1 << 20, dtype=np.float32)
    packed = P.cv.pack(src, 1 << 20, P.dt.FLOAT32)
    assert packed.base is not None  # it's a view, not a copy


def test_buffer_too_small(P):
    with pytest.raises(P.errors.MPIError):
        P.cv.pack(np.zeros(3, np.float32), 4, P.dt.FLOAT32)


def test_get_elements_partial(P):
    st = P.status.Status()
    st._nbytes = 12  # 1 full float_int pair + a trailing float
    assert st.Get_count(P.dt.FLOAT_INT) == -32766  # UNDEFINED
    assert st.Get_elements(P.dt.FLOAT_INT) == 2 + 1


def test_hvector_gap_layout(P):
    t = P.dt.BYTE.Create_hvector(2, 3, 8).Commit()
    src = np.arange(16, dtype=np.uint8)
    got = P.cv.pack(src, 1, t)
    np.testing.assert_array_equal(got, [0, 1, 2, 8, 9, 10])


def test_envelope_and_contents(P):
    """MPI_Type_get_envelope / get_contents (reference:
    ompi_datatype_get_args.c)."""
    INT32, INT64, MPIError = P.top.INT32, P.top.INT64, P.errors.MPIError
    assert INT32.Get_envelope() == (0, 0, 0, "NAMED")
    with pytest.raises(MPIError):
        INT32.Get_contents()

    vec = INT32.Create_vector(3, 2, 4)
    ni, na, nd, comb = vec.Get_envelope()
    assert comb == "VECTOR" and (ni, na, nd) == (3, 0, 1)
    ints, addrs, dts = vec.Get_contents()
    assert ints == [3, 2, 4] and addrs == [] and dts[0] is INT32

    st = INT32.Create_struct([1, 2], [0, 8], [INT32, INT32])
    ni, na, nd, comb = st.Get_envelope()
    assert comb == "STRUCT" and nd == 2
    ints, addrs, _ = st.Get_contents()
    assert ints == [2, 1, 2] and addrs == [0, 8]

    dup = vec.Dup()
    assert dup.Get_envelope()[3] == "DUP"
    assert dup.Get_contents()[2][0] is vec
    d2 = INT64.Dup()  # dup of a NAMED type still reports DUP (MPI)
    assert d2.Get_envelope()[3] == "DUP"
    assert d2.Get_contents()[2][0] is INT64

    sub = INT32.Create_subarray([4, 4], [2, 2], [1, 1])
    assert sub.Get_envelope()[3] == "SUBARRAY"
    assert sub.Get_contents()[0] == [2, 4, 4, 2, 2, 1, 1]


def test_native_pack_matches_numpy_paths(P, monkeypatch):
    """The C runs engine and the numpy byte-map path agree bit for bit;
    both roundtrip."""
    cv = P.cv
    vec = P.dt.from_numpy_dtype(np.float64).Create_vector(2048, 2, 4).Commit()
    src = np.arange(2048 * 4 + 8, dtype=np.float64)
    monkeypatch.setattr(cv, "_NATIVE_MIN_BYTES", 1)  # force native
    p_native = np.array(cv.pack(src, 1, vec))
    monkeypatch.setattr(cv, "_NATIVE_MIN_BYTES", 1 << 60)  # force numpy
    p_np = np.array(cv.pack(src, 1, vec))
    np.testing.assert_array_equal(p_native, p_np)
    out_a = np.zeros_like(src)
    out_b = np.zeros_like(src)
    cv.unpack(p_np, out_a, 1, vec)
    monkeypatch.setattr(cv, "_NATIVE_MIN_BYTES", 1)
    cv.unpack(p_np, out_b, 1, vec)
    np.testing.assert_array_equal(out_a, out_b)


# --------------------------------------------- the two packages side by side
# name -> (constructor on a datatype module, count)
CONSTRUCTORS = {
    "contiguous": (lambda D: D.FLOAT32.Create_contiguous(5), 3),
    "vector": (lambda D: D.FLOAT32.Create_vector(3, 2, 4), 3),
    "vector_of_struct": (lambda D: D.DOUBLE_INT.Create_vector(3, 1, 2), 2),
    "hvector": (lambda D: D.BYTE.Create_hvector(2, 3, 8), 4),
    "indexed": (lambda D: D.INT32.Create_indexed([2, 1], [0, 3]), 3),
    "indexed_out_of_order": (
        lambda D: D.COMPLEX64.Create_indexed([1, 2], [3, 0]), 2),
    "hindexed": (lambda D: D.INT16.Create_hindexed([1, 3], [2, 10]), 3),
    "struct": (lambda D: D.Datatype.Create_struct(
        [1, 2], [8, 0], [D.INT32, D.FLOAT16]), 3),
    "float_int": (lambda D: D.FLOAT_INT, 5),
    "double_int": (lambda D: D.DOUBLE_INT, 5),
    "int_int": (lambda D: D.INT_INT, 5),
    "subarray_c": (lambda D: D.FLOAT32.Create_subarray(
        [4, 5, 3], [2, 2, 2], [1, 2, 0]), 2),
    "subarray_f": (lambda D: D.INT64.Create_subarray(
        [4, 6], [3, 2], [1, 3], order="F"), 2),
    "resized": (lambda D: D.FLOAT64.Create_resized(0, 24), 4),
    "resized_contiguous": (
        lambda D: D.FLOAT32.Create_resized(0, 16).Create_contiguous(3), 2),
    "dup": (lambda D: D.FLOAT32.Create_vector(2, 1, 3).Dup(), 3),
    "dup_named": (lambda D: D.INT64.Dup(), 4),
    "bf16_vector": (lambda D: D.BFLOAT16.Create_vector(4, 1, 2), 3),
    "bf16_struct": (lambda D: D.Datatype.Create_struct(
        [2, 1], [0, 8], [D.BFLOAT16, D.FLOAT32]), 3),
}


def _dt_key(d):
    """A typemap dtype across the packages: bf16 is ml_dtypes' bfloat16 in
    the reference and its uint16 storage in the port."""
    return "bf16" if d.name == "bfloat16" else d.str


def _describe(t):
    ni, na, nd, comb = t.Get_envelope()
    contents = None
    if comb != "NAMED":
        ints, addrs, dts = t.Get_contents()
        contents = (ints, addrs, [(d.size, d.extent, d.name) for d in dts])
    return {
        "size": t.size, "extent": t.Get_extent(),
        "true_extent": t.Get_true_extent(),
        "contiguous": t.is_contiguous, "envelope": (ni, na, nd, comb),
        "contents": contents,
        "typemap": [(_dt_key(d), disp) for d, disp in t.typemap],
        "byte_map": t._compute_byte_map().tolist(),
        "runs": t._compute_runs()}


@pytest.mark.parametrize("case", sorted(CONSTRUCTORS))
def test_constructors_agree_with_jax(case, monkeypatch):
    make, count = CONSTRUCTORS[case]
    jt, tt = make(jdt).Commit(), make(tdt).Commit()
    jd, td = _describe(jt), _describe(tt)
    if case.startswith("bf16"):
        # the port's bf16 entries are its uint16 storage
        td["typemap"] = [("bf16" if k == "<u2" else k, disp)
                         for k, disp in td["typemap"]]
    assert td == jd
    need = (count - 1) * jt.extent + jt.true_lb + jt.true_extent
    src = np.random.default_rng(0).integers(0, 256, need + 16, np.uint8)
    for threshold in (1, 1 << 60):  # the native path, then the numpy one
        monkeypatch.setattr(jcv, "_NATIVE_MIN_BYTES", threshold)
        monkeypatch.setattr(tcv, "_NATIVE_MIN_BYTES", threshold)
        jp = np.array(jcv.pack(src, count, jt))
        tp = np.array(tcv.pack(src, count, tt))
        assert jp.tobytes() == tp.tobytes()
        jback, tback = np.zeros_like(src), np.zeros_like(src)
        jcv.unpack(jp, jback, count, jt)
        tcv.unpack(tp, tback, count, tt)
        np.testing.assert_array_equal(tback, jback)


def test_predefined_types_agree_with_jax():
    names = ["BYTE", "CHAR", "BOOL", "INT8", "INT16", "INT32", "INT64",
             "UINT8", "UINT16", "UINT32", "UINT64", "FLOAT16", "BFLOAT16",
             "FLOAT32", "FLOAT64", "COMPLEX64", "COMPLEX128", "INT", "LONG",
             "FLOAT", "DOUBLE", "FLOAT_INT", "DOUBLE_INT", "INT_INT"]
    for n in names:
        j, t = getattr(jdt, n), getattr(tdt, n)
        assert (t.name, t.size, t.Get_extent(), t.Get_true_extent(),
                t.Get_envelope()) == (j.name, j.size, j.Get_extent(),
                                      j.Get_true_extent(),
                                      j.Get_envelope()), n
    import ompi_tpu as J
    import ompi_tpu_torch as T

    for n in names[:21] + ["Datatype", "Info", "Pack", "Unpack", "Pack_size",
                           "Pack_external", "Unpack_external",
                           "Pack_external_size"]:
        assert hasattr(J, n) and hasattr(T, n), n


# -------------------------------------------------------------------- bf16
def test_bf16_is_two_byte_storage_never_float16():
    B = tdt.BFLOAT16
    assert B is not tdt.FLOAT16 and B.name == "MPI_BFLOAT16"
    assert B.size == 2 and B.extent == 2 and B.np_dtype == np.uint16
    assert tdt.from_numpy_dtype(ml_dtypes.bfloat16) is B
    assert tdt.from_numpy_dtype(np.dtype(ml_dtypes.bfloat16)) is B
    assert tdt.from_numpy_dtype(torch.bfloat16) is B
    assert tdt.from_numpy_dtype(np.uint16) is tdt.UINT16
    assert tdt.from_numpy_dtype(torch.float16) is tdt.FLOAT16
    # the reference (with ml_dtypes) maps the same dtype to its own bf16
    assert jdt.from_numpy_dtype(ml_dtypes.bfloat16) is jdt.BFLOAT16


@pytest.mark.parametrize("tdtype", [
    torch.bool, torch.int8, torch.int16, torch.int32, torch.int64,
    torch.uint8, torch.float16, torch.float32, torch.float64,
    torch.complex64, torch.complex128])
def test_torch_dtypes_map_as_jax_maps_numpy(tdtype):
    npdt = torch.empty(0, dtype=tdtype).numpy().dtype
    assert tdt.from_numpy_dtype(tdtype).name == \
        jdt.from_numpy_dtype(npdt).name


def _bf16_data(n, seed=0):
    f = np.random.default_rng(seed).standard_normal(n).astype(np.float32)
    return f.astype(ml_dtypes.bfloat16)


def test_bf16_pack_unpack_equal_ml_dtypes_reference():
    ref = _bf16_data(64)
    jt = jdt.BFLOAT16.Create_vector(16, 2, 4).Commit()
    tt = tdt.BFLOAT16.Create_vector(16, 2, 4).Commit()
    want = np.array(jcv.pack(ref, 1, jt)).tobytes()
    tensor = torch.from_numpy(ref.view(np.uint16).copy()).view(torch.bfloat16)
    assert np.array(tcv.pack(tensor, 1, tt)).tobytes() == want
    assert np.array(tcv.pack(ref, 1, tt)).tobytes() == want  # the ndarray
    back = torch.zeros(64, dtype=torch.bfloat16)
    tcv.unpack(np.frombuffer(want, np.uint8), back, 1, tt)
    jback = np.zeros(64, ml_dtypes.bfloat16)
    jcv.unpack(np.frombuffer(want, np.uint8), jback, 1, jt)
    assert back.view(torch.int16).numpy().tobytes() == jback.tobytes()


def test_bf16_without_ml_dtypes_in_a_subprocess():
    code = (
        "import sys\n"
        "for m in [m for m in sys.modules if m == 'ml_dtypes' or "
        "m.startswith('ml_dtypes.')]:\n"
        "    del sys.modules[m]\n"
        "class Block:\n"
        "    def find_spec(self, name, path=None, target=None):\n"
        "        if name == 'ml_dtypes' or name.startswith('ml_dtypes.'):\n"
        "            raise ImportError('ml_dtypes blocked')\n"
        "sys.meta_path.insert(0, Block())\n"
        "from ompi_tpu_torch.core import datatype as D, external32\n"
        "import numpy as np\n"
        "assert 'ml_dtypes' not in sys.modules\n"
        "B = D.BFLOAT16\n"
        "print(B.name, B.size, B.extent, B is D.FLOAT16, B is D.UINT16,\n"
        "      D.from_numpy_dtype(np.uint16).name)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["MPI_BFLOAT16", "2", "2", "False", "False",
                                "MPI_UINT16_T"]


# ------------------------------------------------------ the native build
def test_native_library_builds_by_digest_into_the_build_dir():
    lib = native.get_lib()
    path = native.library_path()
    assert path.exists() and path.parent == native.BUILD_DIR
    assert path.name.startswith("libompi_tpu_native-")
    assert not list((native.SOURCES[0].parent).glob("*.so"))
    assert hasattr(lib, "ompi_tpu_pack_runs")
    assert hasattr(lib, "ompi_tpu_unpack_runs")


def _vec_and_src():
    vec = tdt.FLOAT64.Create_vector(2048, 2, 4).Commit()  # 32 KB packed
    return vec, np.arange(2048 * 4 + 8, dtype=np.float64)


def test_failed_native_build_raises_at_or_above_the_threshold(monkeypatch):
    monkeypatch.setattr(native, "CXX", ("false",))
    monkeypatch.setattr(native, "_lib", None)
    vec, src = _vec_and_src()
    assert vec.size >= tcv._NATIVE_MIN_BYTES
    with pytest.raises(native.NativeBuildError, match=r"exit 1.*false"):
        tcv.pack(src, 1, vec)
    with pytest.raises(native.NativeBuildError):
        tcv.unpack(np.zeros(vec.size, np.uint8), np.zeros_like(src), 1, vec)
    # below the threshold the numpy path packs, as in the reference
    small = tdt.FLOAT64.Create_vector(4, 1, 2).Commit()
    assert small.size < tcv._NATIVE_MIN_BYTES
    got = np.frombuffer(np.array(tcv.pack(src, 1, small)).tobytes(),
                        np.float64)
    np.testing.assert_array_equal(got, [0, 2, 4, 6])
    assert native._lib is None  # nothing was loaded


def test_failed_native_build_carries_the_compiler_output(monkeypatch):
    monkeypatch.setattr(native, "CXX", ("g++", "-fno-such-option-here",
                                        "-shared", "-fPIC"))
    monkeypatch.setattr(native, "_lib", None)
    vec, src = _vec_and_src()
    with pytest.raises(native.NativeBuildError,
                       match="fno-such-option-here") as e:
        tcv.pack(src, 1, vec)
    assert "unrecognized" in str(e.value) or "error" in str(e.value)


def test_concurrent_builds_of_one_library_all_succeed(tmp_path):
    dest = tmp_path / "libconcurrent.so"
    errors = []

    def build():
        try:
            native.compile_so(native.CXX, native.SOURCES, dest)
        except Exception as e:  # collected for the assertion below
            errors.append(e)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads) and not errors
    assert [p.name for p in tmp_path.iterdir()] == ["libconcurrent.so"]
    import ctypes

    assert hasattr(ctypes.CDLL(str(dest)), "ompi_tpu_pack_runs")


# ------------------------------------------------------------ torch buffers
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.complex64, torch.bool])
def test_cpu_tensor_is_viewed_without_a_copy(dtype):
    t = torch.zeros(8, dtype=dtype)
    view = tcv._as_byte_view(t)
    assert view.nbytes == t.numel() * t.element_size()
    assert view.ctypes.data == t.data_ptr()
    dt = tdt.from_numpy_dtype(dtype)
    src = torch.ones(8, dtype=dtype)
    tcv.unpack(tcv.pack(src, 8, dt), t, 8, dt)
    assert torch.equal(t, src)


def test_tensor_pack_equals_ndarray_pack():
    a = np.random.default_rng(1).standard_normal((6, 10)).astype(np.float32)
    vec = tdt.FLOAT32.Create_vector(6, 3, 10).Commit()
    want = np.array(jcv.pack(a, 1, jdt.FLOAT32.Create_vector(
        6, 3, 10).Commit())).tobytes()
    assert np.array(tcv.pack(torch.from_numpy(a), 1, vec)).tobytes() == want
    # a non-contiguous tensor packs from a flattened copy, as an ndarray's
    assert np.array(tcv.pack(torch.from_numpy(a).t(), 1, vec)).tobytes() \
        == np.array(jcv.pack(a.T, 1, jdt.FLOAT32.Create_vector(
            6, 3, 10).Commit())).tobytes()


def test_tensor_off_the_cpu_is_refused():
    t = torch.empty(16, device="meta")
    with pytest.raises(TypeError, match="stage_to_host"):
        tcv.pack(t, 16, tdt.FLOAT32)
    with pytest.raises(TypeError, match="stage_to_host"):
        tcv.unpack(np.zeros(64, np.uint8), t, 16, tdt.FLOAT32)
    with pytest.raises(TypeError, match="stage_to_host"):
        tcv.Convertor(t, 16, tdt.FLOAT32, for_send=True)


def test_undersized_unpack_destination_raises_on_both_paths(monkeypatch):
    vec, src = _vec_and_src()
    packed = np.array(tcv.pack(src, 1, vec))
    for threshold in (1, 1 << 60):
        monkeypatch.setattr(tcv, "_NATIVE_MIN_BYTES", threshold)
        with pytest.raises(tcv.MPIError):
            tcv.unpack(packed, np.zeros(100, np.float64), 1, vec)


def test_importing_the_engine_builds_nothing(tmp_path):
    """The library is built at the first pack that needs it, never at
    import (checked in a fresh process)."""
    code = (
        "import ompi_tpu_torch\n"
        "from ompi_tpu_torch import native\n"
        "from ompi_tpu_torch.core import convertor, external32\n"
        "from ompi_tpu_torch.pml import base\n"
        "from ompi_tpu_torch.runtime import progress\n"
        "print(native._lib is None)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.split() == ["True"]
