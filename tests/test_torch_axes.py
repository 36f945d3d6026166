"""The port's in-mesh verbs against the JAX package's, on the CPU.

One world of 8 gloo ranks at (dp, sp, tp) = (2, 2, 2) runs every case; the
JAX verbs run under ``shard_map`` on the 8-device virtual CPU mesh of the
same shape (``tests/conftest.py``). Rank ``r`` holds block ``r`` of the same
numpy input, the device order of ``Mesh(devices.reshape(2, 2, 2))``.

Gradients compare with ``jax.vjp`` under the cotangent convention that
JAX's replication typing gives each verb: a result that is replicated over
the axis (``allreduce``) takes one cotangent for the whole axis, so its
shard_map output leaves the axis out; every other result varies over the
axis and takes a cotangent of its own on each rank.

Data movement and max/min must agree bit for bit, sums and means to 1e-6
relative. The ranks import this module, so it imports JAX only inside its
fixtures.
"""

import time

import numpy as np
import pytest
import torch

from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world

SHAPE = (2, 2, 2)
AXES = ("dp", "sp", "tp")
X_SHAPE = (4, 6)
SIZES = {"dp": 2, "sp": 2, "tp": 2, ("dp", "sp"): 4}
PERMS = {2: [(0, 1)], 4: [(0, 2), (2, 1), (1, 0)]}


def _cases():
    """(id, verb, axis, kwargs, rows, grad): ``rows`` cuts the input to its
    first rows (an untiled verb needs the axis's size there); ``grad`` is
    None (no gradient), "invariant" or "varying" (the cotangent's
    convention)."""
    out = []
    for axis, n in SIZES.items():
        name = axis if isinstance(axis, str) else "+".join(axis)
        add = lambda verb, kw, grad, rows=None, tag="": out.append(
            (f"{verb}{tag}-{name}", verb, axis, kw, rows, grad))
        add("allreduce", dict(op="sum"), "invariant", tag="_sum")
        add("allreduce", dict(op="mean"), "invariant", tag="_mean")
        add("allreduce", dict(op="max"), None, tag="_max")
        add("allreduce", dict(op="min"), None, tag="_min")
        add("allgather", dict(concat_dim=0), "varying", tag="_tiled")
        add("allgather", dict(concat_dim=1, tiled=False), "varying",
            tag="_untiled")
        add("reduce_scatter", dict(scatter_dim=0), "varying", tag="_tiled")
        add("reduce_scatter", dict(scatter_dim=0, tiled=False), "varying",
            rows=n, tag="_untiled")
        add("alltoall", dict(split_dim=0, concat_dim=1), "varying")
        add("bcast", dict(root=1), "varying")
        add("permute", dict(perm=PERMS[n]), "varying")
        add("shift", dict(delta=1), "varying", tag="_up")
        add("shift", dict(delta=-1), "varying", tag="_down")
    return out


CASES = _cases()


def _coords(r):
    return {"dp": r // 4, "sp": r // 2 % 2, "tp": r % 2}


def _out_index(r, axis, grad):
    """Block of the shard_map output (and of its cotangent) that rank ``r``
    sees: the axis is left out of an invariant result."""
    if grad != "invariant":
        return r
    axis = (axis,) if isinstance(axis, str) else axis
    idx, c = 0, _coords(r)
    for a in AXES:
        if a not in axis:
            idx = idx * 2 + c[a]
    return idx


def _cotangent(i, block, shape):
    rng = np.random.RandomState(1000 * i + block)
    return rng.standard_normal(shape).astype(np.float32)


def _inputs():
    rng = np.random.RandomState(0)
    return rng.standard_normal((8,) + X_SHAPE).astype(np.float32)


# ------------------------------------------------------------ the ranks


def _rank_cases(X, W):
    """Every case on this rank: (output, gradient or None) each, then the
    copy_to case, the ranks and sizes, whether max's backward raises, and
    the mesh's backend."""
    r = torch.distributed.get_rank()
    res = []
    for i, (_, verb, axis, kw, rows, grad) in enumerate(CASES):
        x = torch.from_numpy(X[r][:rows]).requires_grad_(grad is not None)
        y = getattr(taxes, verb)(x, axis, **kw)
        dx = None
        if grad is not None:
            g = _cotangent(i, _out_index(r, axis, grad), tuple(y.shape))
            y.backward(torch.from_numpy(g))
            dx = x.grad.numpy()
        res.append((y.detach().numpy(), dx))
    # copy_to of a tp-replicated input (tp 0's block) before a product with
    # a tp-varying weight
    x = torch.from_numpy(X[r - r % 2]).requires_grad_()
    y = taxes.copy_to(x, "tp") * torch.from_numpy(W[r])
    y.backward(torch.from_numpy(_cotangent(len(CASES), r, X_SHAPE)))
    copy = (y.detach().numpy(), x.grad.numpy())
    ranks = {a: (taxes.rank(a), taxes.size(a))
             for a in ("dp", "sp", "tp", ("dp", "sp"))}
    x = torch.from_numpy(X[r]).requires_grad_()
    try:
        taxes.allreduce(x, "sp", op="max").sum().backward()
        max_raises = False
    except RuntimeError:
        max_raises = True
    return res, copy, ranks, max_raises, taxes.current_mesh().backend


def _rank_hang():
    """Rank 0 skips the allreduce the others wait in."""
    if torch.distributed.get_rank() != 0:
        taxes.allreduce(torch.ones(3), "dp")
    return True


def _rank_default_device():
    """``init_mesh`` with no device: where the mesh lives, or the error."""
    try:
        return str(taxes.init_mesh(1, 1, 1).device)
    except RuntimeError as e:
        return f"raised: {e}"


# ------------------------------------------------------------ fixtures


@pytest.fixture(scope="module")
def world():
    X = _inputs()
    W = np.random.RandomState(1).standard_normal(
        (8,) + X_SHAPE).astype(np.float32)
    return X, W, run_world(_rank_cases, 8, "cpu", X, W, shape=SHAPE)


@pytest.fixture(scope="module")
def jx():
    import jax
    from jax.sharding import Mesh, PartitionSpec as P

    from ompi_tpu.parallel import axes as jaxes

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(SHAPE), AXES)

    def vjp(local, xs, in_specs, out_spec, ct):
        """jax.vjp of ``local`` (on each device's blocks, leading dim 1)
        under shard_map: (output, the inputs' cotangents)."""
        fn = jax.jit(jax.shard_map(local, mesh=mesh, in_specs=in_specs,
                                   out_specs=out_spec))
        if ct is None:
            return np.asarray(fn(*xs)), None
        y, back = jax.vjp(fn, *xs)
        return np.asarray(y), [np.asarray(g) for g in back(ct)]

    return jax, P, jaxes, vjp


# --------------------------------------------------------------- tests


@pytest.mark.parametrize("i", range(len(CASES)), ids=[c[0] for c in CASES])
def test_verb_matches_jax(world, jx, i):
    X, _, results = world
    jax, P, jaxes, vjp = jx
    _, verb, axis, kw, rows, grad = CASES[i]
    ours = [results[r][0][i] for r in range(8)]
    axis_t = (axis,) if isinstance(axis, str) else axis
    out_axes = tuple(a for a in AXES if a not in axis_t) \
        if grad == "invariant" else AXES

    def local(xb):
        return getattr(jaxes, verb)(xb[0], axis, **kw)[None]

    ct = None
    if grad is not None:
        n_blocks = 2 ** len(out_axes)
        ct = np.stack([_cotangent(i, b, ours[0][0].shape)
                       for b in range(n_blocks)])
    y, dx = vjp(local, [X[:, :rows]], (P(AXES),),
                P(out_axes) if out_axes else P(), ct)
    exact = verb != "reduce_scatter" and kw.get("op") not in ("sum", "mean")
    for r in range(8):
        want = y[_out_index(r, axis, grad)]
        got = ours[r][0]
        assert got.shape == want.shape, (r, got.shape, want.shape)
        if exact:
            np.testing.assert_array_equal(got, want, err_msg=f"rank {r}")
        else:
            np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6,
                                       err_msg=f"rank {r}")
        if grad is None:
            assert ours[r][1] is None
            continue
        # data movement moves cotangents exactly; sums add them
        g_exact = verb in ("alltoall", "permute", "shift") or (
            verb == "allreduce" and kw["op"] == "sum")
        if g_exact:
            np.testing.assert_array_equal(ours[r][1], dx[0][r],
                                          err_msg=f"grad, rank {r}")
        else:
            np.testing.assert_allclose(ours[r][1], dx[0][r], rtol=1e-6,
                                       atol=1e-6, err_msg=f"grad, rank {r}")


def test_allreduce_gradient_is_the_identity(world):
    _, _, results = world
    i = [c[0] for c in CASES].index("allreduce_sum-tp")
    for r in range(8):
        g = _cotangent(i, _out_index(r, "tp", "invariant"), X_SHAPE)
        np.testing.assert_array_equal(results[r][0][i][1], g)


def test_shift_gradient_is_the_inverse_shift(world):
    _, _, results = world
    i = [c[0] for c in CASES].index("shift_up-sp")
    for r in range(8):
        # rank r sent its x to its sp neighbour r + 1 (mod 2): the
        # neighbour's cotangent comes back
        c = _coords(r)
        peer = r + (2 if c["sp"] == 0 else -2)
        np.testing.assert_array_equal(results[r][0][i][1],
                                      _cotangent(i, peer, X_SHAPE))


def test_copy_to_gradient_is_the_tp_allreduce(world, jx):
    """JAX's AD sums the cotangent of a tp-replicated input over tp by
    itself; the port's ``copy_to`` gives the same sum."""
    X, W, results = world
    jax, P, _, vjp = jx
    # the JAX input is replicated over tp: take the tp = 0 blocks
    Xr = X.reshape(4, 2, *X_SHAPE)[:, 0]
    ct = np.stack([_cotangent(len(CASES), r, X_SHAPE) for r in range(8)])
    y, (dx, _) = vjp(lambda xb, wb: (xb[0] * wb[0])[None], [Xr, W],
                     (P(("dp", "sp")), P(AXES)), P(AXES), ct)
    for r in range(8):
        got_y, got_dx = results[r][1]
        np.testing.assert_array_equal(got_y, y[r])
        np.testing.assert_allclose(got_dx, dx[r // 2], rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(got_dx, ct[r] * W[r] + ct[r ^ 1] * W[r ^ 1],
                                   rtol=1e-6, atol=1e-6)


def test_rank_and_size_match_jax(world, jx):
    _, _, results = world
    jax, P, jaxes, vjp = jx
    for axis in ("dp", "sp", "tp", ("dp", "sp")):
        idx, _ = vjp(lambda xb: jax.numpy.full((1, 1), jaxes.rank(axis)),
                     [np.zeros((8, 1), np.float32)], (P(AXES),), P(AXES),
                     None)
        for r in range(8):
            assert results[r][2][axis] == (int(idx[r, 0]), SIZES[axis])


def test_max_and_min_have_no_gradient(world):
    assert all(res[3] for res in world[2])


def test_unknown_or_unordered_axis_raises():
    with pytest.raises(ValueError):
        taxes.size("xp")
    with pytest.raises(ValueError):
        taxes.rank(("sp", "dp"))


def test_a_hung_world_fails_within_its_timeout():
    t0 = time.monotonic()
    with pytest.raises((RuntimeError, TimeoutError)):
        run_world(_rank_hang, 2, "cpu", timeout=5.0)
    assert time.monotonic() - t0 < 60


@pytest.mark.parametrize("device_type,ids,want", [
    ("cpu", ["cpu"] * 8, "gloo"),
    # a card each: one node, per-rank CUDA_VISIBLE_DEVICES, or many nodes
    ("cuda", ["GPU-a", "GPU-b"], "nccl"),
    ("cuda", [f"GPU-{r}" for r in range(16)], "nccl"),
    # ranks that share a card stage through host memory
    ("cuda", ["GPU-a", "GPU-a"], "gloo"),
    ("cuda", ["GPU-a", "GPU-b", "GPU-a", "GPU-b"], "gloo"),
], ids=["cpu", "two-cards", "sixteen-cards", "one-card", "two-shared"])
def test_transport_follows_the_ranks_devices(device_type, ids, want):
    assert taxes.transport(device_type, ids) == want


def test_the_mesh_takes_the_worlds_backend(world):
    assert all(res[4] == "gloo" for res in world[2])


def test_init_mesh_without_a_device_is_on_the_card():
    """Fault C.2: like every entry point of the port, ``init_mesh`` resolves
    no device to ``cuda`` and raises ``resolve_device``'s error where there
    is no card; it never drops to the CPU unasked."""
    [got] = run_world(_rank_default_device, 1, "cpu", timeout=120.0)
    if torch.cuda.is_available():
        assert got == "cuda"
    else:
        assert got.startswith("raised: ") and "device='cpu'" in got, got
