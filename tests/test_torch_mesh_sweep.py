"""A seeded sweep of the port's mesh-mode communicator against the JAX
package's, on the CPU.

Each case draws, from its seed, a communicator (the world; a Split with
random colours and keys, UNDEFINED included; a uniform Split padded with
UNDEFINED, of group size 2, 3 or 4; or a Create_group of a random subset in
random order), an op, a payload dtype (float32, int32 or bool, as the op
admits) and a root, and runs every verb of the slice on the same numpy
input through JAX ``mesh_world`` on the conftest's 8-device CPU mesh and
through the port's ``mesh_world(8, "cpu")``.

Results agree bit for bit, dtype and the sign of zeros included, except a
float SUM over the whole world (allreduce, reduce, reduce_scatter), which
agrees within 1e-6 of the sum of the magnitudes it adds. Where the JAX
communicator refuses a call (a verb that needs uniform colour sizes on a
non-uniform Split) the port raises the same MPI error class.
"""

import numpy as np
import pytest
import torch

import jax

from ompi_tpu.core import op as jop
from ompi_tpu.core.errors import MPIError as JaxMPIError
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core.errors import MPIError
from ompi_tpu_torch.parallel.mesh import UNDEFINED, mesh_world

W = 8
SUM_RTOL = 1e-6
N_CASES = 40
OPS = ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR",
       "BXOR", "REPLACE", "NO_OP", "MINLOC", "MAXLOC", "USER")
# a non-commutative user op, written with operators both packages take; its
# product is exact, so XLA contracting it into a fused multiply-add changes
# no rounding (``test_user_op_that_xla_fuses`` states what does)
USER = {jop: jop.Op.Create(lambda a, b: a * 2 - b, commute=False),
        top: top.Op.Create(lambda a, b: a * 2 - b, commute=False)}


@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


def _comms(worlds, rng, layout):
    jw, tw = worlds
    if layout == "world":
        return jw, tw
    if layout == "create_group":
        members = [int(r) for r in rng.permutation(W)[:rng.randint(2, W)]]
        return jw.Create_group(members), tw.Create_group(members)
    if layout == "uniform":
        g = rng.choice([2, 3, 4])
        colors = [i // g if i < (W // g) * g else UNDEFINED for i in range(W)]
        colors = [colors[i] for i in rng.permutation(W)]
    else:
        colors = [UNDEFINED if rng.rand() < 0.2 else int(c)
                  for c in rng.randint(0, 3, W)]
    keys = [int(k) for k in rng.randint(0, 3, W)]
    return jw.Split(colors, keys), tw.Split(colors, keys)


def _payload(rng, shape, dtype, pair):
    if pair:  # (value, index) with ties on the value
        v = rng.randint(0, 3, shape)
        return np.stack([v, rng.randint(0, W, shape)], -1).astype(dtype)
    if dtype == np.bool_:
        return rng.rand(*shape) > 0.5
    if dtype == np.int32:
        return rng.randint(-4, 5, shape).astype(np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _case(seed):
    rng = np.random.RandomState(seed)
    layout = ("world", "split", "uniform", "create_group")[seed % 4]
    name = OPS[rng.randint(len(OPS))]
    if name in ("BAND", "BOR", "BXOR"):
        dtypes = (np.int32, np.bool_)
    elif name in ("MINLOC", "MAXLOC", "USER"):
        dtypes = (np.float32, np.int32)
    else:
        dtypes = (np.float32, np.int32, np.bool_)
    return rng, layout, name, dtypes[rng.randint(len(dtypes))]


def _run(fn):
    """fn()'s result as numpy, or the MPI error class it raised."""
    try:
        out = fn()
    except (MPIError, JaxMPIError) as e:
        return ("MPIError", e.code)
    return None if out is None else (
        out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out))


@pytest.mark.parametrize("seed", range(N_CASES))
def test_every_verb_matches_jax(worlds, seed):
    rng, layout, name, dtype = _case(seed)
    jc, tc = _comms(worlds, rng, layout)
    pair = name in ("MINLOC", "MAXLOC")
    ops = {jc: USER[jop] if name == "USER" else getattr(jop, name),
           tc: USER[top] if name == "USER" else getattr(top, name)}
    sizes = [len(g) for g in (tc.groups or [range(W)]) if len(g) > 1] or [1]
    uniform = len(set(sizes)) == 1
    G = sizes[0] if uniform else 2
    root = int(rng.randint(max(sizes)))
    steps = int(rng.randint(1, 4))
    n = min(sizes)
    dst = rng.permutation(n)
    perm = [(int(s), int(d)) for s, d in zip(range(n), dst)
            if rng.rand() < 0.8]
    x = _payload(rng, (W, 3), dtype, pair)
    xb = _payload(rng, (W, G, 3), dtype, pair)
    world_float_sum = (tc.groups is None and name == "SUM"
                       and dtype == np.float32)
    verbs = {
        "allreduce": (lambda c, a: c.allreduce(a, ops[c]), x,
                      world_float_sum),
        "reduce": (lambda c, a: c.reduce(a, ops[c], root), x,
                   world_float_sum),
        "bcast": (lambda c, a: c.bcast(a, root), x, False),
        "allgather": (lambda c, a: c.allgather(a), x, False),
        "gather": (lambda c, a: c.gather(a, root), x, False),
        "alltoall": (lambda c, a: c.alltoall(a), xb, False),
        "reduce_scatter": (lambda c, a: c.reduce_scatter(a, ops[c]), xb,
                           world_float_sum),
        "scan": (lambda c, a: c.scan(a, ops[c]), x, False),
        "exscan": (lambda c, a: c.exscan(a, ops[c]), x, False),
        "scatter": (lambda c, a: c.scatter(a, root), xb, False),
        "shift": (lambda c, a: c.shift(a, steps), x, False),
        "permute": (lambda c, a: c.permute(a, perm), x, False),
    }
    if tc.groups is None and name == "SUM" and dtype == np.bool_:
        # JAX's psum_scatter takes no bool (see test_torch_mesh_comm.py)
        got = tc.reduce_scatter(tc.shard(xb)).numpy()
        np.testing.assert_array_equal(got, xb.any(axis=0))
        del verbs["reduce_scatter"]
    for verb, (fn, a, tol) in verbs.items():
        want = _run(lambda: fn(jc, jc.shard(a)))
        got = _run(lambda: fn(tc, tc.shard(a)))
        what = f"{verb} on {layout} {tc.groups}, {name}, {dtype.__name__}"
        if isinstance(want, tuple):
            assert got == want, what
            continue
        assert isinstance(got, np.ndarray), f"{what}: port raised {got}"
        assert got.shape == want.shape and got.dtype == want.dtype, what
        if tol:
            bound = SUM_RTOL * np.abs(a).sum(0)
            assert np.all(np.abs(got - want) <= bound), what
        else:
            np.testing.assert_array_equal(got, want, err_msg=what)
            if got.dtype.kind == "f":
                np.testing.assert_array_equal(np.signbit(got),
                                              np.signbit(want), err_msg=what)
    assert uniform or isinstance(_run(lambda: tc.allgather(tc.shard(x))),
                                 tuple)
    for c in (jc, tc):
        c.barrier()
