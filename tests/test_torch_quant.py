"""The port's quantized mesh allreduce against the JAX package's, on the CPU.

The mesh cases of ``tests/test_quant.py:290-505`` have a counterpart here,
each run on both packages, int8 and fp8: the same seeded numpy input goes
through JAX ``mesh_world`` (its ``quant_*`` variables set while the comm is
built, restored in ``finally``) and through the port's ``mesh_world(8,
"cpu")`` with ``ompi_tpu_torch.quant``'s settings set the same way. Then
the verdict (``decide``) on the cards of ``test_negotiate_verdicts``, the
codec's sizing and bound against JAX's, and the persistent allreduce of a
quant-selected comm (``allreduce_init``).

Tolerances:

- int8: bit for bit against JAX.
- fp8: within one quantization step of the block (``BlockCodec.quant_step``:
  the e4m3 spacing at the element's code times the block's scale). XLA on
  the CPU sums the 8 dequantized fp8 rows as a tree of halves, the port in
  rank order; an ulp there moves a block's scale by an ulp, and could move
  a requantized code by one step (ROADMAP C).
- Always within the codec's ``error_bound`` of the f64 exact sum.
- Plain (ineligible) calls: ints exact, a world float SUM within 1e-6 of
  the summed magnitudes, as in ``tests/test_torch_mesh_comm.py``.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ompi_tpu import quant as jquant
from ompi_tpu.core import op as jop
from ompi_tpu.mca.var import set_var
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.quant import codec as jcodec
from ompi_tpu.quant import negotiate as jneg
from ompi_tpu_torch import quant as tquant
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.mca.var import set_var as tset_var
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.quant import codec as tcodec
from ompi_tpu_torch.quant import negotiate as tneg

W = 8
MODES = ("int8", "fp8")
MIN_BYTES = 1024
SUM_RTOL = 1e-6
_axis = [0]


def _set(mode, enable=True, min_bytes=MIN_BYTES):
    set_var("quant", "enable", enable)
    set_var("quant", "min_bytes", min_bytes)
    set_var("quant", "mode", mode)
    tset_var("quant", "enable", enable)
    tset_var("quant", "min_bytes", min_bytes)
    tset_var("quant", "mode", mode)


def _worlds(mode, enable=True):
    """A JAX and a port world built under the quant settings, which are
    restored before returning: each comm keeps the verdict it was built
    with."""
    _set(mode, enable)
    try:
        _axis[0] += 1
        return (jax_mesh_world(jax.devices()[:W],
                               axis_name=f"tq_{mode}_{_axis[0]}"),
                mesh_world(W, "cpu"))
    finally:
        _set("int8", False, 65536)


@pytest.fixture(scope="module", params=MODES)
def quant_worlds(request):
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return (request.param,) + _worlds(request.param)


@pytest.fixture
def counters():
    jquant._reset_for_testing()
    tquant.reset_counters()
    yield
    jquant._reset_for_testing()
    tquant.reset_counters()


def _same_as_jax(got, want, mode, what=""):
    """int8 bit for bit; fp8 within one quantization step of the block."""
    got, want = np.asarray(got), np.asarray(want)
    assert got.dtype == want.dtype and got.shape == want.shape, what
    if mode == "int8":
        np.testing.assert_array_equal(got, want, err_msg=what)
        return
    c = tcodec.make_codec(mode, 8, 64)
    for g, w in zip(got.reshape(W, -1), want.reshape(W, -1)):
        step = c.quant_step(w)
        fin = np.isfinite(w)
        np.testing.assert_array_equal(g[~fin], w[~fin], err_msg=what)
        diff = np.abs(g[fin].astype(np.float64) - w[fin])
        assert np.all(diff <= step[fin] * (1 + 1e-5)), \
            f"{what}: {diff.max()} over one step"


def _within_bound(res, xs, mode):
    c = tcodec.make_codec(mode, 8, 64)
    bound = c.error_bound(xs)
    fin = np.isfinite(bound)
    with np.errstate(invalid="ignore"):
        err = np.abs(np.asarray(res, np.float64)
                     - xs.astype(np.float64).sum(axis=0))
    assert np.all(err[fin] <= bound[fin])
    return err


def _both(worlds, fn, xs):
    jw, tw = worlds
    return (np.asarray(fn(jw, jw.shard(xs))),
            fn(tw, tw.shard(xs)).numpy())


# ------------------------------------------------------------- the codec
def test_codec_sizing_and_bound_equal_jax():
    rng = np.random.RandomState(3)
    for mode, bits in (("int8", 8), ("int8", 4), ("fp8", 8)):
        for block in (16, 64, 100):
            jc, tc = (m.make_codec(mode, bits, block)
                      for m in (jcodec, tcodec))
            assert (tc.eps, tc.qmax) == (jc.eps, jc.qmax)
            for n in (1, 7, block, 3 * block + 5, 2000):
                assert tc.wire_nbytes(n) == jc.wire_nbytes(n)
                assert tc.nblocks(n) == jc.nblocks(n)
                for world in (2, 8):
                    assert tcodec.chunk_layout(n, world, block) == \
                        jcodec.chunk_layout(n, world, block)
            x = (rng.randn(8, 300) * 10).astype(np.float32)
            x[1, 7], x[2, 9], x[0, 0] = np.inf, np.nan, 1e-42
            for arr in (x, x[0], x.astype(np.float64) * 1e300):
                np.testing.assert_array_equal(tc.error_bound(arr),
                                              jc.error_bound(arr))
    for args in (("fp8", 4, 64), ("int3", 8, 64), ("int8", 8, 0)):
        with pytest.raises(ValueError):
            tcodec.make_codec(*args)


GOOD = {"enable": 1, "bits": 8, "block": 64, "mode": "int8",
        "min_bytes": 4096, "strict": 0, "fp8_ok": 1}
CARDS = [
    [GOOD] * 3, [GOOD, dict(GOOD, enable=0)],
    [dict(GOOD, strict=1), dict(GOOD, enable=0)],
    [GOOD, dict(GOOD, enable=0, strict=1)], [GOOD, dict(GOOD, block=32)],
    [dict(GOOD, min_bytes=1024, strict=1), dict(GOOD, min_bytes=1024, bits=4)],
    [dict(GOOD, min_bytes=2048, strict=1), dict(GOOD, enable=0)],
    [dict(GOOD, min_bytes=1 << 20), GOOD], [dict(GOOD, mode="fp8", bits=4)] * 2,
    [dict(GOOD, mode="fp8"), dict(GOOD, mode="fp8", fp8_ok=0)],
    [dict(GOOD, mode="fp8")] * 2, [dict(GOOD, bits=4)] * 2, [],
]


@pytest.mark.parametrize("cards", CARDS, ids=range(len(CARDS)))
def test_decide_equals_jax(cards):
    """The cards of ``test_negotiate_verdicts``, and all-int4 and none."""
    got = tneg.decide([dict(c) for c in cards])
    want = jneg.decide([dict(c) for c in cards])
    fields = ("active", "bits", "block", "mode", "min_bytes", "strict")
    assert [getattr(got, f) for f in fields] == \
        [getattr(want, f) for f in fields]
    assert got.reason.split(":")[0].split(" (")[0] == \
        want.reason.split(":")[0].split(" (")[0]


def test_local_card_reads_the_settings():
    card = tneg.local_card()
    assert set(card) == set(jneg.local_card())
    assert card["fp8_ok"] == 1 and card["enable"] == 0


# ------------------------------------------------------------- mesh mode
def test_bound_and_dispatch(quant_worlds):
    mode, jw, tw = quant_worlds
    assert jw.coll.providers.get("allreduce") == "quant"
    assert tw.coll.providers["allreduce"] == "quant"
    assert set(tw.coll.providers.values()) == {"mesh", "quant"}
    for seed, n, scale in ((0, 2048, 4), (1, 5000, 100), (2, 1553, 0.01)):
        xs = (np.random.RandomState(seed).randn(W, n) * scale).astype(
            np.float32)
        j, t = _both((jw, tw), lambda c, x: c.allreduce(x), xs)
        _same_as_jax(t, j, mode, f"seed {seed}")
        assert all(np.array_equal(t[0], r) for r in t)  # every row agrees
        _within_bound(t[0], xs, mode)
        # the cached callable again: the same result
        np.testing.assert_array_equal(
            tw.allreduce(tw.shard(xs)).numpy(), t)


def test_ineligible_calls_take_the_plain_body(quant_worlds):
    mode, jw, tw = quant_worlds
    ints = np.arange(W * 4096, dtype=np.int32).reshape(W, 4096)
    j, t = _both((jw, tw), lambda c, x: c.allreduce(x), ints)
    np.testing.assert_array_equal(t, j)
    np.testing.assert_array_equal(t[0], ints.sum(axis=0))
    small = np.random.RandomState(4).randn(W, 8).astype(np.float32)
    j, t = _both((jw, tw), lambda c, x: c.allreduce(x), small)
    sums = np.abs(small).sum(axis=0)
    assert np.all(np.abs(t - j) <= SUM_RTOL * sums)
    # a non-SUM op of an eligible size: the plain fold, bit for bit
    big = np.random.RandomState(5).randn(W, 2048).astype(np.float32)
    for jo, to in ((jop.MAX, top.MAX), (jop.PROD, top.PROD)):
        np.testing.assert_array_equal(
            tw.allreduce(tw.shard(big), to).numpy(),
            np.asarray(jw.allreduce(jw.shard(big), jo)))


@pytest.mark.parametrize("order", ["reduce_first", "allreduce_first"])
def test_reduce_stays_exact_in_both_orders(order):
    """``reduce`` shares the plain allreduce callable; the quantized one is
    cached under its own key, so the call order changes nothing: reduce is
    exact, allreduce quantized, on both packages."""
    for mode in MODES:
        jw, tw = _worlds(mode)
        xs = (np.random.RandomState(5).randn(W, 2048) * 4).astype(np.float32)
        exact = xs.astype(np.float64).sum(axis=0)
        calls = [("reduce", lambda c, x: c.reduce(x)),
                 ("allreduce", lambda c, x: c.allreduce(x))]
        if order == "allreduce_first":
            calls.reverse()
        out = {name: _both((jw, tw), fn, xs) for name, fn in calls}
        jr, tr = out["reduce"]
        sums = np.abs(xs).sum(axis=0)
        assert np.all(np.abs(tr[0] - jr[0]) <= SUM_RTOL * sums)
        np.testing.assert_allclose(tr[0].astype(np.float64), exact,
                                   rtol=1e-5, atol=1e-3)
        ja, ta = out["allreduce"]
        _same_as_jax(ta, ja, mode, order)
        assert _within_bound(ta[0], xs, mode).max() > 1e-3, \
            f"{mode} {order}: allreduce ran at full precision"
        # again, from the cache
        np.testing.assert_array_equal(tw.reduce(tw.shard(xs)).numpy(), tr)
        np.testing.assert_array_equal(tw.allreduce(tw.shard(xs)).numpy(), ta)


def test_sentinels_arrive_in_place(quant_worlds):
    mode, jw, tw = quant_worlds
    xs = (np.random.RandomState(11).randn(W, 2048) * 3).astype(np.float32)
    xs[0, 100], xs[1, 300], xs[0, 500] = np.inf, -np.inf, np.nan
    j, t = _both((jw, tw), lambda c, x: c.allreduce(x), xs)
    for res in (j[0], t[0]):
        assert res[100] == np.inf and res[300] == -np.inf
        assert np.isnan(res[500])
    np.testing.assert_array_equal(np.isnan(t), np.isnan(j))
    _same_as_jax(t, j, mode)
    _within_bound(t[0], xs, mode)


def test_counters_follow_jax(quant_worlds, counters):
    """Whole-mesh accounting, as JAX counts: floats (bf16 included) that
    quantize are counted, ints are not; the counted wire ratio is at least
    3.5."""
    mode, jw, tw = quant_worlds
    ones = np.ones((W, 4096), np.float32)
    for c in (jw, tw):
        c.allreduce(c.shard(ones))
        c.allreduce(c.shard(ones))
    jc, tc = jquant.counters(), tquant.counters()
    assert tc["colls"] == 2
    assert {k: tc[k] for k in tc} == {k: jc[k] for k in tc}
    assert (tc["bytes_saved"] + tc["bytes_wire"]) / tc["bytes_wire"] >= 3.5
    ints = np.ones((W, 4096), np.int32)
    jw.allreduce(jw.shard(ints))
    tw.allreduce(tw.shard(ints))
    assert tquant.counters()["colls"] == jquant.counters()["colls"] == 2
    j = np.asarray(jw.allreduce(jw.shard(jnp.ones((W, 4096), jnp.bfloat16))))
    t = tw.allreduce(torch.ones((W, 4096), dtype=torch.bfloat16))
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), j.astype(np.float32))
    assert tquant.counters() == {k: jquant.counters()[k] for k in tc}
    assert tquant.counters()["colls"] == 3


def test_plain_world_untouched():
    jw, tw = _worlds("int8", enable=False)
    assert jw.coll.providers.get("allreduce") == "xla"
    assert set(tw.coll.providers.values()) == {"mesh"}
    assert not tw._quant_state.active


def test_which_comms_are_selected():
    """Dup of the world is selected anew; Split and Create_group comms
    never quantize; a comm built after the settings are restored is
    plain."""
    _set("int8")
    try:
        tw = mesh_world(W, "cpu")
        dup = tw.Dup()
        split = tw.Split([r % 2 for r in range(W)])
        sub = tw.Create_group([0, 2, 5])
    finally:
        _set("int8", False, 65536)
    assert dup.coll.providers["allreduce"] == "quant"
    for c in (split, sub):
        assert c.coll.providers["allreduce"] == "mesh"
        assert not c._quant_state.active
    assert mesh_world(W, "cpu").coll.providers["allreduce"] == "mesh"
    two = mesh_world(2, "cpu")
    assert two.coll.providers["allreduce"] == "mesh"


def test_persistent_and_nonblocking_allreduce_quantize(quant_worlds):
    """allreduce_init on a quant-selected comm freezes the callable the
    allreduce slot runs, the quantized one, as JAX's fast table does:
    Start equals JAX's Start and is not the exact sum; iallreduce goes
    through the slot too; reduce_init stays exact."""
    mode, jw, tw = quant_worlds
    xs = (np.random.RandomState(6).randn(W, 2048) * 4).astype(np.float32)
    exact = xs.astype(np.float64).sum(axis=0)
    reqs = [c.allreduce_init(c.shard(xs)) for c in (jw, tw)]
    for r in reqs:
        r.Start()
        r.Wait()
    assert reqs[1]._frozen
    j, t = np.asarray(reqs[0].result), reqs[1].result.numpy()
    _same_as_jax(t, j, mode, "allreduce_init")
    np.testing.assert_array_equal(t, tw.allreduce(tw.shard(xs)).numpy())
    assert _within_bound(t[0], xs, mode).max() > 1e-3
    ireq = tw.iallreduce(tw.shard(xs))
    ireq.Wait()
    np.testing.assert_array_equal(ireq.result.numpy(), t)
    red = tw.reduce_init(tw.shard(xs))
    red.Start()
    red.Wait()
    np.testing.assert_allclose(red.result.numpy()[0].astype(np.float64),
                               exact, rtol=1e-5, atol=1e-3)


def test_other_float_dtypes_keep_their_dtype(quant_worlds):
    """f16 quantizes and comes back as f16, as in JAX; f64 (JAX without
    x64 narrows it to f32) works in f32 and comes back as f64."""
    mode, jw, tw = quant_worlds
    xs = (np.random.RandomState(8).randn(W, 2048) * 2).astype(np.float16)
    j, t = _both((jw, tw), lambda c, x: c.allreduce(x), xs)
    assert t.dtype == np.float16
    _same_as_jax(t, j, mode, "f16")
    x64 = xs.astype(np.float64)
    t64 = tw.allreduce(tw.shard(x64)).numpy()
    assert t64.dtype == np.float64
    _same_as_jax(t64.astype(np.float32),
                 np.asarray(jw.allreduce(jw.shard(x64))), mode, "f64")


# --------------------------------------------------- the quant variables
from ompi_tpu.runtime import spc as jspc  # noqa: E402
from ompi_tpu_torch.mca.var import all_pvars as tall_pvars  # noqa: E402
from ompi_tpu_torch.mca.var import all_vars as tall_vars  # noqa: E402
from ompi_tpu_torch.runtime import spc as tspc  # noqa: E402
from tests.test_torch_mca_fixture import mca  # noqa: E402,F401 fixture


@pytest.mark.parametrize("name", ["enable", "bits", "block", "min_bytes",
                                  "mode", "strict"])
def test_quant_settings_are_the_references_vars(name):
    from ompi_tpu.mca.var import all_vars as jall_vars

    t, j = tall_vars()["quant_" + name], jall_vars()["quant_" + name]
    assert (t.default, t.typ, t.enum_values, t.level) == \
        (j.default, j.typ, j.enum_values, j.level)
    assert not hasattr(tquant, name)  # no module attribute stands in


@pytest.mark.parametrize("setting,want", [
    ({"enable": True}, "quant"), ({"enable": "on", "bits": 4}, "mesh"),
    ({"enable": True, "mode": "fp8"}, "quant"), ({"enable": False}, "mesh"),
    ({"enable": True, "block": 32}, "quant")])
def test_the_vars_drive_selection_as_jax(mca, setting, want):
    for k, v in setting.items():
        mca.both("quant", k, v)
    _axis[0] += 1
    jw = jax_mesh_world(jax.devices()[:W], axis_name=f"tqv{_axis[0]}")
    tw = mesh_world(W, "cpu")
    assert tw.coll.providers["allreduce"] == want
    assert jw.coll.providers["allreduce"] == want.replace("mesh", "xla")
    if want == "quant":  # the same verdict
        assert dataclasses.asdict(tw._quant_state) == {
            f.name: getattr(jw._quant_state, f.name)
            for f in dataclasses.fields(tneg.QuantState)}
    else:
        assert not tw._quant_state.active


def test_counters_are_pvars_and_spc(mca, counters):
    mca.both("quant", "enable", True)
    mca.both("quant", "min_bytes", 1024)
    _axis[0] += 1
    jw = jax_mesh_world(jax.devices()[:W], axis_name=f"tqv{_axis[0]}")
    tw = mesh_world(W, "cpu")
    jspc.reset()
    tspc.reset()
    xs = np.random.RandomState(3).randn(W, 512).astype(np.float32)
    small = xs[:, :8]  # under min_bytes: the plain path, uncounted
    for c in (jw, tw):
        c.allreduce(c.shard(xs))
        c.allreduce(c.shard(xs))
        c.allreduce(c.shard(small))
    pv = tall_pvars()
    coll_keys = ("colls", "bytes_wire", "bytes_saved")  # the tcp wire
    # counters have no quant_ pvar, as in the reference
    assert {k: pv["quant_" + k].value for k in coll_keys} == \
        {k: tquant.counters()[k] for k in coll_keys}
    assert tquant.counters()["colls"] == 2
    assert tspc.snapshot() == jspc.snapshot() == {"allreduce": 3,
                                                  "quant_allreduce": 2}
