"""The port's cartesian topology against the JAX package's, on the CPU.

The mesh cases of ``tests/test_topo.py`` (``:75-140``) each have a
counterpart: the same numpy input through a cart on JAX
``mesh_world(jax.devices()[:8])`` and on the port's ``mesh_world(8, "cpu")``,
compared bit for bit (cart shifts and neighbour exchanges move data; the
sub-cart allreduce sums small integers, exact in any order). The port's
copy of the cart math (``Dims_create``, ``CartTopo``) is held to the JAX
package's on the unit cases of the same file and on every small cart.
"""

import itertools

import numpy as np
import pytest

import jax

from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.topo import CartTopo as JaxCartTopo
from ompi_tpu.topo import Dims_create as jax_Dims_create
from ompi_tpu_torch.core.errors import MPIError, ERR_TOPOLOGY
from ompi_tpu_torch.comm.communicator import PROC_NULL, UNDEFINED
from ompi_tpu_torch.parallel.mesh import mesh_world
from ompi_tpu_torch.topo import CART, CartTopo, Dims_create

W = 8


# ------------------------------------------------------------- unit: math
@pytest.mark.parametrize("args", [(8, 3), (12, 2), (6, 2, [3, 0]), (7, 1),
                                  (1, 2), (36, 3), (16, 4, [0, 2, 0, 0])])
def test_dims_create(args):
    assert Dims_create(*args) == jax_Dims_create(*args)


def test_dims_create_refuses():
    with pytest.raises(MPIError):
        Dims_create(7, 2, [2, 0])  # 7 not divisible by 2


@pytest.mark.parametrize("dims", [[2, 3, 4], [8], [2, 4], [1, 3], [2, 2, 2]])
def test_cart_math_matches_the_reference(dims):
    """rank/coords, shift at every displacement, neighbours and sub_colors
    over every period pattern."""
    for periods in itertools.product([False, True], repeat=len(dims)):
        t, j = CartTopo(dims, periods), JaxCartTopo(dims, periods)
        assert t.size == j.size and t.ndims == j.ndims
        for r in range(t.size):
            assert t.coords(r) == j.coords(r)
            assert t.rank(t.coords(r)) == r
            assert t.neighbors(r) == j.neighbors(r)
            for d in range(t.ndims):
                for disp in (1, 2, -1):
                    assert t.shift(r, d, disp) == j.shift(r, d, disp)
        for remain in itertools.product([False, True], repeat=len(dims)):
            assert t.sub_colors(remain) == j.sub_colors(remain)


def test_cart_rank_coords_roundtrip():
    t = CartTopo([2, 3, 4], [False, True, False])
    assert t.coords(0) == [0, 0, 0]
    assert t.coords(t.size - 1) == [1, 2, 3]
    assert t.rank([0, 3, 0]) == t.rank([0, 0, 0])  # periodic wrap in dim 1
    with pytest.raises(MPIError):
        t.rank([2, 0, 0])  # out of range, non-periodic


def test_cart_shift():
    assert CartTopo([4], [True]).shift(0, 0, 1) == (3, 1)
    t2 = CartTopo([4], [False])
    assert t2.shift(0, 0, 1) == (PROC_NULL, 1)
    assert t2.shift(3, 0, 1) == (2, PROC_NULL)
    assert t2.shift(1, 0, 2) == (PROC_NULL, 3)


def test_cart_neighbors_order():
    assert CartTopo([2, 2], [True, True]).neighbors(0) == [2, 2, 1, 1]


# ------------------------------------------------------- mesh-mode (8 dev)
@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


@pytest.fixture(scope="module")
def cart24(worlds):
    return tuple(c.Create_cart([2, 4], periods=[True, True]) for c in worlds)


def both(pair, fn, *arrays):
    """fn on the JAX comm and on the port's; the port's result as numpy,
    equal to the JAX one bit for bit, dtype included."""
    jc, tc = pair
    want = np.asarray(fn(jc, *(jc.shard(a) for a in arrays)))
    got = fn(tc, *(tc.shard(a) for a in arrays)).numpy()
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    return got


def test_mesh_cart_create(worlds, cart24):
    jc, tc = cart24
    assert tc.Get_dim() == jc.Get_dim() == 2
    assert tc.Get_topo() == jc.Get_topo() == ([2, 4], [True, True], None)
    assert tc.Get_cart_rank([1, 2]) == 6
    assert tc.Get_coords(6) == [1, 2]
    assert tc.Get_topology() == CART and worlds[1].Get_topology() == UNDEFINED
    for c in worlds:
        with pytest.raises(Exception):
            c.Create_cart([3, 3])  # doesn't cover the axis
    with pytest.raises(MPIError) as e:
        worlds[1].Get_dim()
    assert e.value.code == ERR_TOPOLOGY


def test_mesh_cart_shift_data(cart24):
    y = both(cart24, lambda c, x: c.cart_shift(x, 1, 1),
             np.arange(8, dtype=np.float32)[:, None])
    t = cart24[1]._cart()
    for r in range(8):
        assert y[r, 0] == float(t.shift(r, 1, 1)[0])


def test_mesh_cart_shift_nonperiodic_zero_fill(worlds):
    carts = tuple(c.Create_cart([8], periods=[False]) for c in worlds)
    y = both(carts, lambda c, x: c.cart_shift(x, 0, 1),
             np.arange(8, dtype=np.float32)[:, None] + 1)
    assert y[0, 0] == 0.0  # nothing shifts into the edge
    np.testing.assert_array_equal(y[1:, 0], np.arange(1, 8) + 0.0)


def test_mesh_neighbor_allgather_halo(cart24):
    """The cart halo exchange on 8 positions."""
    out = both(cart24, lambda c, x: c.neighbor_allgather(x),
               np.arange(8, dtype=np.float32)[:, None])  # [8, 4, 1]
    t = cart24[1]._cart()
    for r in range(8):
        for k, nb in enumerate(t.neighbors(r)):
            assert out[r, k, 0] == float(nb), (r, k)


def test_mesh_neighbor_alltoall(cart24):
    t = cart24[1]._cart()
    x = np.zeros((8, 4, 1), np.float32)
    for r in range(8):
        for k in range(4):
            x[r, k, 0] = 10 * r + k
    out = both(cart24, lambda c, x: c.neighbor_alltoall(x), x)
    for r in range(8):
        for k, nb in enumerate(t.neighbors(r)):
            d, parity = divmod(k, 2)
            opp = 2 * d + (1 - parity)
            assert out[r, k, 0] == 10 * nb + opp, (r, k)


@pytest.mark.parametrize("dims,periods", [([2, 4], [False, True]),
                                          ([8], [False]), ([2, 2, 2],
                                                           [True, False,
                                                            True])])
def test_mesh_neighbors_off_the_edges(worlds, dims, periods):
    """Non-periodic edges deliver zeros in both neighbour verbs."""
    carts = tuple(c.Create_cart(dims, periods) for c in worlds)
    K = 2 * len(dims)
    rng = np.random.RandomState(len(dims))
    both(carts, lambda c, x: c.neighbor_allgather(x),
         rng.randint(1, 100, (8, 3)).astype(np.int32))
    both(carts, lambda c, x: c.neighbor_alltoall(x),
         rng.standard_normal((8, K, 2)).astype(np.float32))


def test_mesh_cart_sub(worlds):
    carts = tuple(c.Create_cart([2, 4], periods=[False, False])
                  for c in worlds)
    subs = tuple(c.Sub([False, True]) for c in carts)  # 2 rows of 4
    assert subs[1].size == subs[0].size == 4
    assert subs[1].Get_topo() == ([4], [False], None)
    out = both(subs, lambda c, x: c.allreduce(x),
               np.ones((8, 1), np.float32))
    np.testing.assert_array_equal(out[:, 0], np.full(8, 4.0))
    both(subs, lambda c, x: c.bcast(x, 2),
         np.arange(8, dtype=np.float32)[:, None])


def test_mesh_neighbor_needs_cart(worlds):
    x = np.arange(8, dtype=np.float32)[:, None]
    for c in worlds:
        with pytest.raises(Exception):
            c.neighbor_allgather(c.shard(x))
    tw = worlds[1]
    with pytest.raises(MPIError):
        tw.neighbor_allgather(tw.shard(x))
    sub = tw.Create_cart([2, 4]).Sub([False, True])
    with pytest.raises(MPIError):  # a sub-cart's groups cover no whole axis
        sub.neighbor_alltoall(sub.shard(np.zeros((8, 2, 1))))
