"""The port's mesh-mode communicator against the JAX package's, on the CPU.

Every case of ``tests/test_xla_coll.py`` but ``test_ulfm_surface_singleton``
(process-mode ``COMM_WORLD``) has a counterpart here: the same numpy input
goes through JAX ``mesh_world(jax.devices()[:8])`` on the conftest's
8-device CPU mesh and through the port's ``mesh_world(8, "cpu")``, and each
case also keeps the reference test's own check.

Tolerances: results agree bit for bit (``assert_array_equal``, dtype
included) wherever the reference is exact: integers, bools, data movement,
MAX/MIN, the 'gather' folds and every grouped schedule. A float SUM over the
whole world (allreduce, reduce, reduce_scatter) is one reduction whose
order is the library's own, so it agrees within 1e-6 of the sum of the
magnitudes it adds.
"""

import numpy as np
import pytest
import torch

import jax

from ompi_tpu.core import op as jop
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.parallel.mesh import UNDEFINED as JAX_UNDEFINED
from ompi_tpu_torch.coll import mesh as tcoll
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core.errors import MPIError, ERR_REVOKED
from ompi_tpu_torch.parallel.mesh import UNDEFINED, MeshComm, mesh_world

W = 8
SUM_RTOL = 1e-6


@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def both(pair, fn, *arrays, sum_of=None):
    """fn(comm, *sharded arrays) on the JAX comm and on the port's: the
    port's result as numpy, held to the JAX one bit for bit, or, with
    ``sum_of`` (the summed input), within SUM_RTOL of its magnitudes."""
    jc, tc = pair
    want = _np(fn(jc, *(jc.shard(a) for a in arrays)))
    got = _np(fn(tc, *(tc.shard(a) for a in arrays)))
    assert got.shape == want.shape and got.dtype == want.dtype
    if sum_of is None:
        np.testing.assert_array_equal(got, want)
        if got.dtype.kind == "f":  # -0.0 and +0.0 compare equal
            np.testing.assert_array_equal(np.signbit(got), np.signbit(want))
    else:
        tol = SUM_RTOL * np.abs(sum_of).sum(0)
        assert np.all(np.abs(got - want) <= tol), np.abs(got - want).max()
    return got


def split(worlds, *args, **kw):
    return tuple(c.Split(*args, **kw) for c in worlds)


def _ranked(shape=(4,), dtype=np.float32):
    """Per-rank distinct data: row r = r + arange."""
    base = np.arange(np.prod(shape), dtype=dtype).reshape(shape)
    return np.stack([base + r for r in range(W)])


def test_allreduce_sum(worlds):
    r = both(worlds, lambda c, x: c.allreduce(x), _ranked(),
             sum_of=_ranked())
    np.testing.assert_allclose(r, np.stack([_ranked().sum(0)] * W))


def test_allreduce_max_min(worlds):
    for jo, to, f in ((jop.MAX, top.MAX, np.max), (jop.MIN, top.MIN, np.min)):
        r = both(worlds, lambda c, x: c.allreduce(
            x, to if isinstance(c, MeshComm) else jo), _ranked())
        np.testing.assert_array_equal(r, np.stack([f(_ranked(), 0)] * W))


def _op(c, name):
    """The op called ``name`` of the package that comm ``c`` belongs to."""
    return getattr(top if isinstance(c, MeshComm) else jop, name)


def test_allreduce_prod_gather_path(worlds):
    r = both(worlds, lambda c, x: c.allreduce(x, _op(c, "PROD")),
             np.full((W, 3), 2.0, np.float32))
    np.testing.assert_array_equal(r, np.full((W, 3), 2.0 ** W))


def test_allreduce_band(worlds):
    data = np.stack([np.full(4, 0b1111 ^ (1 << (r % 4)), np.int32)
                     for r in range(W)])
    r = both(worlds, lambda c, x: c.allreduce(x, _op(c, "BAND")),
             data)
    np.testing.assert_array_equal(
        r, np.stack([np.bitwise_and.reduce(data, axis=0)] * W))


def test_allreduce_bool_land(worlds):
    data = np.ones((W, 4), dtype=bool)
    data[3, 2] = False
    r = both(worlds, lambda c, x: c.allreduce(x, _op(c, "LAND")),
             data)
    np.testing.assert_array_equal(r, np.stack([data.all(axis=0)] * W))


def test_bcast(worlds):
    data = _ranked()
    for root in (3, 5):
        r = both(worlds, lambda c, x: c.bcast(x, root=root), data)
        np.testing.assert_array_equal(r, np.stack([data[root]] * W))


def test_allgather(worlds):
    data = _ranked()
    r = both(worlds, lambda c, x: c.allgather(x), data)
    assert r.shape == (W, W, 4)
    for i in range(W):
        np.testing.assert_array_equal(r[i], data)


def test_alltoall(worlds):
    data = np.arange(W * W * 2, dtype=np.float32).reshape(W, W, 2)
    r = both(worlds, lambda c, x: c.alltoall(x), data)
    np.testing.assert_array_equal(r, data.transpose(1, 0, 2))


def test_reduce_scatter(worlds):
    data = np.arange(W * W * 3, dtype=np.float32).reshape(W, W, 3)
    r = both(worlds, lambda c, x: c.reduce_scatter(x), data, sum_of=data)
    np.testing.assert_allclose(r, data.sum(axis=0))


def test_scan_exscan(worlds):
    data = _ranked()
    r = both(worlds, lambda c, x: c.scan(x), data)
    expect = np.cumsum(data, axis=0)
    np.testing.assert_allclose(r, expect)
    re = both(worlds, lambda c, x: c.exscan(x), data)
    np.testing.assert_array_equal(re[0], np.zeros(4))
    np.testing.assert_allclose(re[1:], expect[:-1])


def test_barrier(worlds):
    for c in worlds:
        c.barrier()  # must not deadlock/throw
        c.barrier()  # the cached callable


def test_shift_ring(worlds):
    data = _ranked()
    r = both(worlds, lambda c, x: c.shift(x, 1), data)
    np.testing.assert_array_equal(r, np.roll(data, 1, axis=0))


def test_split_subcomm_allreduce(worlds):
    subs = split(worlds, [r % 2 for r in range(W)])
    assert subs[1].size == W // 2
    data = _ranked()
    r = both(subs, lambda c, x: c.allreduce(x), data)
    evens = sum(data[i] for i in range(0, W, 2))
    odds = sum(data[i] for i in range(1, W, 2))
    for i in range(W):
        np.testing.assert_array_equal(r[i], evens if i % 2 == 0 else odds)


def test_split_keys_reorder_bcast(worlds):
    # one colour, reversed keys: comm-rank 0 is mesh rank W-1
    subs = split(worlds, [0] * W, keys=list(range(W - 1, -1, -1)))
    data = _ranked()
    r = both(subs, lambda c, x: c.bcast(x, root=0), data)
    np.testing.assert_array_equal(r, np.stack([data[W - 1]] * W))


def test_create_group_padding(worlds):
    subs = tuple(c.Create_group([1, 2, 5]) for c in worlds)
    data = _ranked()
    r = both(subs, lambda c, x: c.allreduce(x), data)
    for i in (1, 2, 5):
        np.testing.assert_array_equal(r[i], data[1] + data[2] + data[5])
    for i in (0, 3, 4, 6, 7):  # padding keeps its own data
        np.testing.assert_array_equal(r[i], data[i])


def test_subcomm_alltoall(worlds):
    subs = split(worlds, [0, 0, 0, 0, 1, 1, 1, 1])
    g = subs[1].size
    data = np.arange(W * g * 2, dtype=np.float32).reshape(W, g, 2)
    r = both(subs, lambda c, x: c.alltoall(x), data)
    for grp in ([0, 1, 2, 3], [4, 5, 6, 7]):
        for pi, i in enumerate(grp):
            for pj, j in enumerate(grp):
                np.testing.assert_array_equal(r[i, pj], data[j, pi])


def test_compile_cache_reuse(worlds):
    """The port's counterpart: one resolved callable per key, reused, and
    the reuse counted as a cache hit."""
    jw, tw = worlds
    key = ("allreduce", top.SUM.uid)
    x = tw.shard(_ranked())
    tw.allreduce(x)
    f1 = tw._cache.get(key)
    assert f1 is not None
    hits, misses = tcoll.stats.hits, tcoll.stats.misses
    tw.allreduce(x)
    assert tw._cache.get(key) is f1
    assert (tcoll.stats.hits, tcoll.stats.misses) == (hits + 1, misses)
    jx = jw.shard(_ranked())
    jw.allreduce(jx)
    assert jw._jit_cache.get(("allreduce", jop.SUM.uid)) is not None


def test_coll_selection_is_mesh(worlds):
    """The port's counterpart of ``test_coll_selection_is_xla``: the comm's
    table is MeshColl's, for every verb."""
    jw, tw = worlds
    assert jw.coll.providers["allreduce"] == "xla"
    assert tw.coll.providers["allreduce"] == "mesh"
    assert set(tw.coll.providers.values()) == {"mesh"}
    assert all(fn.__self__ is tcoll.module for fn in tw.coll.slots.values())


def test_land_lor_on_ints(worlds):
    """Logical ops reduce truthiness, not numeric min/max: -3 is true."""
    data = np.zeros((W, 2), np.int32)
    data[:, 0] = -3
    data[:, 1] = [-3, 5, 0, 1, 2, 3, 4, 5]
    land = both(worlds, lambda c, x: c.allreduce(x, _op(c, "LAND")),
                data)
    assert land[0, 0] == 1 and land[0, 1] == 0
    lor_data = np.zeros((W, 2), np.int32)
    lor_data[4, 0] = -7
    lor = both(worlds, lambda c, x: c.allreduce(x, _op(c, "LOR")),
               lor_data)
    assert lor[0, 0] == 1 and lor[0, 1] == 0


def test_user_ops_distinct_cache(worlds):
    """Two user ops never share a resolved callable."""
    ops = {c: (mod.Op.Create(lambda a, b: a + b),
               mod.Op.Create(lambda a, b: a * b))
           for c, mod in zip(worlds, (jop, top))}
    data = np.full((W, 2), 2.0, np.float32)
    r_add = both(worlds, lambda c, x: c.allreduce(x, ops[c][0]), data)
    r_mul = both(worlds, lambda c, x: c.allreduce(x, ops[c][1]), data)
    np.testing.assert_array_equal(r_add[0], [16.0, 16.0])
    np.testing.assert_array_equal(r_mul[0], [256.0, 256.0])


def test_split_undefined_shift(worlds):
    """Shift on a comm with UNDEFINED (singleton) padding."""
    assert UNDEFINED == JAX_UNDEFINED
    subs = split(worlds, [0, 0, 0, 0] + [UNDEFINED] * 4)
    data = _ranked()
    r = both(subs, lambda c, x: c.shift(x, 1), data)
    np.testing.assert_array_equal(r[1], data[0])
    np.testing.assert_array_equal(r[0], data[3])


def test_bcast_root_out_of_range(worlds):
    jw, tw = worlds
    from ompi_tpu.core.errors import MPIError as JaxMPIError

    with pytest.raises(JaxMPIError):
        jw.bcast(jw.shard(_ranked()), root=12)
    with pytest.raises(MPIError):
        tw.bcast(tw.shard(_ranked()), root=12)


def test_grouped_land_ints(worlds):
    subs = split(worlds, [r % 2 for r in range(W)])
    data = np.full((W, 2), 7, np.int32)
    data[2, 0] = 0  # even group: one zero
    r = both(subs, lambda c, x: c.allreduce(x, _op(c, "LAND")), data)
    assert r[0, 0] == 0 and r[0, 1] == 1
    assert r[1, 0] == 1


def test_user_op_that_xla_fuses(worlds):
    """A difference the port states: XLA on the CPU contracts a user op's
    ``a * b + a`` into a fused multiply-add, one rounding where the port's
    tensor ops (on the CPU and on the card alike) round twice, as written.
    Integers agree exactly; floats within 1e-6 relative over the seven
    combines of a world fold, on operands in [1, 2) so that no cancellation
    magnifies the rounding."""
    fn = lambda a, b: a * b + a  # noqa: E731
    ops = {worlds[0]: jop.Op.Create(fn, commute=False),
           worlds[1]: top.Op.Create(fn, commute=False)}
    rng = np.random.RandomState(3)
    both(worlds, lambda c, x: c.allreduce(x, ops[c]),
         rng.randint(-3, 4, (W, 5)).astype(np.int32))
    x = (1 + rng.rand(W, 64)).astype(np.float32)
    j = np.asarray(worlds[0].allreduce(worlds[0].shard(x), ops[worlds[0]]))
    t = worlds[1].allreduce(worlds[1].shard(x), ops[worlds[1]]).numpy()
    np.testing.assert_allclose(t, j, rtol=1e-6, atol=0)


def test_device_minloc_maxloc(worlds):
    """MINLOC/MAXLOC reduce [..., 2] (value, index) pairs; ties take the
    lower index."""
    vals = np.array([5., 3., 7., 3., 9., 1., 4., 1.])
    pairs = np.stack([vals, np.arange(8.)], axis=-1)[:, None, :]
    pairs = pairs.astype(np.float32)
    out = both(worlds, lambda c, x: c.allreduce(x, _op(c, "MINLOC")),
               pairs)
    np.testing.assert_array_equal(out[0, 0], [1.0, 5.0])
    out = both(worlds, lambda c, x: c.allreduce(x, _op(c, "MAXLOC")),
               pairs)
    np.testing.assert_array_equal(out[0, 0], [9.0, 4.0])


def test_device_pair_op_needs_pair_layout(worlds):
    jw, tw = worlds
    from ompi_tpu.core.errors import MPIError as JaxMPIError

    bad = np.zeros((W, 3), np.float32)
    with pytest.raises(JaxMPIError):
        jw.allreduce(jw.shard(bad), op=jop.MINLOC)
    with pytest.raises(MPIError):
        tw.allreduce(tw.shard(bad), op=top.MINLOC)
    # the resolved callable checks the layout on a cache hit too
    good = np.zeros((W, 3, 2), np.float32)
    tw.allreduce(tw.shard(good), op=top.MAXLOC)
    with pytest.raises(MPIError):
        tw.allreduce(tw.shard(bad), op=top.MAXLOC)


def test_nonuniform_split_allreduce_bcast_scan(worlds):
    subs = split(worlds, [0, 0, 0, 1, 1, 2, 3, 3])
    data = np.arange(8, dtype=np.float32)[:, None] + 1
    out = both(subs, lambda c, x: c.allreduce(x), data)
    np.testing.assert_array_equal(out[:, 0], [6, 6, 6, 9, 9, 6, 15, 15])
    out = both(subs, lambda c, x: c.bcast(x, root=0), data)
    np.testing.assert_array_equal(out[:, 0], [1, 1, 1, 4, 4, 6, 7, 7])
    out = both(subs, lambda c, x: c.scan(x), data)
    np.testing.assert_array_equal(out[:, 0], [1, 3, 6, 4, 9, 6, 7, 15])


def test_scatter_real_semantics(worlds):
    """Group rank p receives ROOT's chunk p."""
    chunks = np.zeros((8, 8, 1), np.float32)
    chunks[2] = np.arange(8)[:, None] * 10.0
    out = both(worlds, lambda c, x: c.scatter(x, root=2), chunks)
    np.testing.assert_array_equal(out[:, 0], np.arange(8) * 10.0)


def test_scatter_grouped(worlds):
    subs = split(worlds, [0, 0, 0, 0, 1, 1, 1, 1])
    chunks = np.zeros((8, 4, 1), np.float32)
    chunks[1] = np.arange(4)[:, None] + 100  # root 1 of group 0
    chunks[5] = np.arange(4)[:, None] + 200  # root 1 of group 1
    out = both(subs, lambda c, x: c.scatter(x, root=1), chunks)
    np.testing.assert_array_equal(out[:4, 0], np.arange(4) + 100)
    np.testing.assert_array_equal(out[4:, 0], np.arange(4) + 200)


def test_gather_root_rows(worlds):
    out = both(worlds, lambda c, x: c.gather(x, root=0),
               np.arange(8, dtype=np.float32)[:, None])
    np.testing.assert_array_equal(out[0, :, 0], np.arange(8))


def test_mesh_agree_band(worlds):
    """MPIX_Comm_agree on a mesh comm: BAND under the single controller."""
    jw, tw = worlds
    assert jw.Agree(0b1011) == tw.Agree(0b1011) == 0b1011
    assert tw.Agree(1 << 40) == 1 << 40  # past int32: the flag itself


# ------------------------------------------------ what the port adds or keeps
def test_signed_zero_through_the_masked_sum(worlds):
    """bcast and scatter are a masked SUM: a root's -0.0 arrives as +0.0 in
    groups of two or more, and a singleton keeps its own -0.0; data
    movement keeps the sign (``both`` compares sign bits too)."""
    data = np.full((W, 3), -0.0, np.float32)
    data[:, 1] = np.arange(W)
    chunks = np.full((W, W, 2), -0.0, np.float32)
    pads = tuple(c.Create_group([1, 2, 5]) for c in worlds)
    r = both(worlds, lambda c, x: c.bcast(x, root=1), data)
    assert not np.signbit(r[:, 0]).any()
    r = both(pads, lambda c, x: c.bcast(x, root=1), data)
    np.testing.assert_array_equal(
        np.signbit(r[:, 0]), [True, False, False, True, True, False, True,
                              True])
    r = both(worlds, lambda c, x: c.scatter(x, root=3), chunks)
    assert not np.signbit(r).any()
    for pair in (worlds, pads):
        r = both(pair, lambda c, x: c.allgather(x), data)
        assert np.signbit(r[..., 0]).sum() > 0
        both(pair, lambda c, x: c.shift(x, 1), data)


@pytest.mark.parametrize("verb", ["allreduce_replace", "allreduce_no_op",
                                  "bcast", "allgather", "alltoall",
                                  "reduce_scatter_replace", "scan",
                                  "scatter", "permute"])
def test_every_row_owns_its_storage(worlds, verb):
    """A result is a real [W, ...] tensor: writing one rank's row changes
    no other row and not the input."""
    tw = worlds[1]
    x = tw.shard(np.arange(W * W * 2, dtype=np.float32).reshape(W, W, 2))
    keep = x.clone()
    out = {"allreduce_replace": lambda: tw.allreduce(x, top.REPLACE),
           "allreduce_no_op": lambda: tw.allreduce(x, top.NO_OP),
           "bcast": lambda: tw.bcast(x, 2),
           "allgather": lambda: tw.allgather(x),
           "alltoall": lambda: tw.alltoall(x),
           "reduce_scatter_replace": lambda: tw.reduce_scatter(x,
                                                               top.REPLACE),
           "scan": lambda: tw.scan(x, top.NO_OP),
           "scatter": lambda: tw.scatter(x, 0),
           "permute": lambda: tw.permute(x, [(i, i) for i in range(W)])}[
        verb]()
    before = out.clone()
    out[3] += 1000.0
    np.testing.assert_array_equal(out[[0, 1, 2, 4, 5, 6, 7]].numpy(),
                                  before[[0, 1, 2, 4, 5, 6, 7]].numpy())
    np.testing.assert_array_equal(x.numpy(), keep.numpy())


@pytest.mark.parametrize("verb,good,bad", [
    ("scatter", (W, W, 1), (W, 4, 1)),
    ("alltoall", (W, W, 1), (W, 3, 1)),
    ("reduce_scatter", (W, W, 1), (W, 2)),
    ("neighbor_alltoall", (W, 4, 1), (W, 2, 1)),
])
def test_fast_calls_recheck_the_block_contract(worlds, verb, good, bad):
    """The [W, G, ...] and [W, K, ...] contracts hold on every call, a
    repeated one served from the cache included (one callable serves every
    shape)."""
    tw = worlds[1]
    comm = tw.Create_cart([2, 4], [True, True]) \
        if verb == "neighbor_alltoall" else tw
    call = getattr(comm, verb)
    call(comm.shard(np.zeros(good, np.float32)))
    call(comm.shard(np.zeros(good, np.float32)))
    with pytest.raises(MPIError):
        call(comm.shard(np.zeros(bad, np.float32)))


def test_dtypes_are_kept_where_jax_narrows(worlds):
    """JAX runs without x64, so float64 and int64 buffers become 32-bit on
    its side; the port keeps the tensor's dtype. The values agree."""
    jw, tw = worlds
    for dt, narrow in ((np.float64, np.float32), (np.int64, np.int32)):
        data = _ranked((3,), dt)
        j = np.asarray(jw.allreduce(jw.shard(data)))
        t = tw.allreduce(tw.shard(data))
        assert j.dtype == narrow and t.dtype == torch.from_numpy(data).dtype
        np.testing.assert_array_equal(t.numpy().astype(narrow), j)


def test_world_bool_reduce_scatter_sum(worlds):
    """A difference the port states: JAX's world reduce_scatter of bools
    under SUM raises (psum_scatter takes no bool); the port gives the OR,
    the int sum cast back to bool, as allreduce and the grouped schedule
    give it on both sides."""
    jw, tw = worlds
    data = np.random.RandomState(0).rand(W, W, 3) > 0.7
    with pytest.raises(TypeError):
        jw.reduce_scatter(jw.shard(data))
    np.testing.assert_array_equal(tw.reduce_scatter(tw.shard(data)).numpy(),
                                  data.any(axis=0))


def test_port_errors_and_surface(worlds):
    jw, tw = worlds
    with pytest.raises(MPIError):
        tw.Get_rank()
    with pytest.raises(MPIError):
        tw.shard(np.zeros((W + 1, 2)))  # the rank dim is the world
    with pytest.raises(MPIError):
        tw.permute(tw.shard(_ranked()), [(0, 1), (2, 1)])
    nonuni = tw.Split([0, 0, 0, 1, 1, 2, 3, 3])
    with pytest.raises(MPIError):
        nonuni.size
    assert tw.sharding() == torch.device("cpu")
    d = tw.Dup()
    d.Revoke()
    with pytest.raises(MPIError) as e:
        d.allreduce(d.shard(_ranked()))
    assert e.value.code == ERR_REVOKED


def test_attributes_follow_dup_and_free(worlds):
    tw = worlds[1]
    deleted = []
    kv = tw.Create_keyval(copy_fn=lambda c, k, v: (True, v + 1),
                          delete_fn=lambda c, k, v: deleted.append(v))
    try:
        d = tw.Dup()
        d.Set_attr(kv, 1)
        dd = d.Dup()
        assert dd.Get_attr(kv) == 2
        dd.Free()
        assert deleted == [2] and dd.coll is None
        d.Set_attr(kv, 5)
        assert deleted == [2, 1]
    finally:
        tw.Free_keyval(kv)


def test_mesh_world_needs_cuda_unless_asked_for_the_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mesh_world(8)
    assert mesh_world(4, "cpu").device == torch.device("cpu")
