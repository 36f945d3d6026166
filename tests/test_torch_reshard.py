"""The port's mesh reshard against the JAX package's, on the CPU.

``test_mesh_reshard_lowerings`` and ``test_mesh_reshard_rejects_what_it_
cannot_lower`` of ``tests/test_reshard.py`` have a counterpart here: the
same numpy buffers go through JAX ``mesh_world(jax.devices()[:8])``'s
``reshard`` on the conftest's 8-device CPU mesh and through the port's
``mesh_world(8, "cpu")``. The expected rows come from the JAX package's
``reshard.plan.Layout``, which only this test imports. Reshard moves data
and reduces nothing, so every result agrees bit for bit.
"""

import numpy as np
import pytest
import torch

import jax

from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu.reshard.plan import Layout
from ompi_tpu_torch.core.errors import (MPIError, ERR_ARG,
                                        ERR_UNSUPPORTED_OPERATION)
from ompi_tpu_torch.parallel.mesh import mesh_world

W = 8
LOWERINGS = [((0, None), (None, 0)), ((None, 0), (0, None)),
             ((0, None), (None, None)), ((None, None), (0, None))]


@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


def _rows(full, spec):
    """The [W, *local] buffer of ``full`` under ``spec``: row r is rank r's
    block of the Layout."""
    lay = Layout((W,), spec)
    g = full.shape
    return np.stack([full[tuple(slice(a, b) for a, b in lay.slices(g, r))]
                     for r in range(W)])


def _check(worlds, full, src, dst):
    jc, tc = worlds
    x = _rows(full, src)
    want = np.asarray(jc.reshard(jc.shard(x), src, dst))
    got = tc.reshard(tc.shard(x), src, dst)
    assert isinstance(got, torch.Tensor)
    got = got.numpy()
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, _rows(full, dst))


def test_mesh_reshard_lowerings(worlds):
    g = (W * 2, W * 3)
    full = np.arange(int(np.prod(g)), dtype=np.float32).reshape(g)
    for src, dst in LOWERINGS:
        _check(worlds, full, src, dst)
    # the same spec on both sides returns the buffer itself
    tc = worlds[1]
    x = tc.shard(_rows(full, (0, None)))
    assert tc.reshard(x, (0, None), (0, None)) is x


@pytest.mark.parametrize("src,dst", [
    ((0, None, None), (None, None, 0)), ((None, None, 0), (None, 0, None)),
    ((None, 0, None), (None, None, None)), ((None, None, None), (None, 0,
                                                                None)),
    ((None, 0, None), (0, None, None))])
def test_mesh_reshard_three_dims(worlds, src, dst):
    g = (W, W * 2, W)
    full = np.random.RandomState(7).randint(-9, 9, g).astype(np.int32)
    _check(worlds, full, src, dst)


def test_mesh_reshard_rejects_what_it_cannot_lower(worlds):
    jc, tc = worlds
    x = np.zeros((W, 2, 3), np.float32)
    for c in worlds:
        with pytest.raises(Exception) as e:
            c.reshard(c.shard(x), (0, None), (None, 0))  # 3 % W != 0
        assert "MPIError" in type(e.value).__name__
        with pytest.raises(Exception) as e:
            c.reshard(np.zeros((W, 2, 4)), (0, 1), (None, 0))  # 2 dims
        assert "MPIError" in type(e.value).__name__
    with pytest.raises(MPIError) as e:
        tc.reshard(tc.shard(x), (0, None), (None, 0))
    assert e.value.code == ERR_ARG
    with pytest.raises(MPIError) as e:
        tc.reshard(tc.shard(x), (0, None), (None, None, 0))
    assert e.value.code == ERR_ARG
    half = tc.Split([r % 2 for r in range(W)])
    with pytest.raises(MPIError) as e:
        half.reshard(half.shard(x), (0, None), (None, 0))
    assert e.value.code == ERR_UNSUPPORTED_OPERATION
