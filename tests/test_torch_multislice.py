"""The port's two-level multi-slice collectives against JAX's flat verbs.

One world of 2 gloo CPU processes (``parallel.launch.run_world``), each a
slice controller with ``MeshComm(4, "cpu")``, joined by the bridge group of
``MultiSliceComm``. Every verb and every i-verb, with every op of
``core/op.py`` and a user op, runs on the slices' blocks of one seeded
global input; JAX ``mesh_world(8)`` runs its flat verb on the whole input
(``tests/test_multislice.py``'s check, with the JAX package's 8-device CPU
mesh as the oracle in place of the closed form). Slice ``s`` must hold rows
``4s .. 4s + 3`` of the flat result: bit for bit (dtype included), but a
float SUM, which adds in another order (the slice's sum, then the bridge's)
and agrees within 1e-6 of the summed magnitudes.

Also: a blocking verb issued while an i-verb is in flight does not overtake
it; a worker's error completes its request with the error class
(``ERR_ARG`` for an MPI error, ``ERR_INTERN`` for any other); ``Free``
stops the worker. The ranks import this module, so it imports JAX only in a
fixture; one world for the file keeps ``--dist loadfile`` whole.
"""

import threading
import time

import numpy as np
import pytest
import torch

from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core.errors import MPIError, ERR_ARG, ERR_INTERN
from ompi_tpu_torch.parallel.launch import run_world

S, D = 2, 4
W = S * D
N = 37
SUM_RTOL = 1e-6
F_OPS = ("SUM", "MAX", "MIN", "PROD", "LAND", "LOR", "LXOR", "REPLACE",
         "NO_OP")
I_OPS = ("SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "BAND", "BOR",
         "BXOR", "REPLACE", "NO_OP", "user")
PAIR_OPS = ("MINLOC", "MAXLOC")
RS_OPS = (("f", "SUM"), ("f", "MAX"), ("i", "BXOR"), ("i", "PROD"))


def user_combine(a, b):
    # (a + 1)(b + 1) - 1: associative, so the slices' fold then the
    # bridge's gives the flat fold's result
    return a * b + a + b


def inputs():
    """The global inputs, [W, ...] each: one seed on every rank."""
    rng = np.random.RandomState(0)
    f = rng.randn(W, N).astype(np.float32)
    f[:, :5] = 0.0
    i = rng.randint(-3, 4, size=(W, N)).astype(np.int32)
    vals = rng.randint(0, 3, size=(W, N)).astype(np.float32)
    pair = np.stack([vals, np.broadcast_to(
        np.arange(W, dtype=np.float32)[:, None], (W, N))], axis=-1)
    return dict(
        f=f, i=i, pair=pair,
        # PROD of powers of two is exact in any order
        fprod=rng.choice([-2.0, -0.5, 0.5, 1.0, 2.0],
                         size=(W, N)).astype(np.float32),
        blocks_f=rng.randn(W, W, 5).astype(np.float32),
        blocks_i=rng.randint(-9, 10, size=(W, W, 5)).astype(np.int32))


def _op(name):
    return top.Op.Create(user_combine, name="user") if name == "user" \
        else getattr(top, name)


def _payload(x, name):
    return x["fprod"] if name == "PROD" else x["f"]


def _rank_slices():
    """One slice controller: every verb's result on this slice's block."""
    import torch.distributed as dist

    from ompi_tpu_torch.parallel.mesh import MeshComm
    from ompi_tpu_torch.parallel.multislice import MultiSliceComm

    s = dist.get_rank()
    ms = MultiSliceComm(MeshComm(D, torch.device("cpu")))
    assert (ms.n_slices, ms.slice_id, ms.world_size) == (S, s, W)
    x = {k: torch.from_numpy(v[s * D:(s + 1) * D].copy())
         for k, v in inputs().items()}
    out = {}
    for name in F_OPS:
        out["allreduce", "f", name] = ms.allreduce(_payload(x, name),
                                                   _op(name))
    for name in I_OPS:
        out["allreduce", "i", name] = ms.allreduce(x["i"], _op(name))
    for name in PAIR_OPS:
        out["allreduce", "pair", name] = ms.allreduce(x["pair"], _op(name))
    for root_slice, root in ((0, 0), (1, 2)):
        out["bcast", root_slice, root] = ms.bcast(x["f"], root_slice, root)
    out["allgather"] = ms.allgather(x["i"])
    out["alltoall"] = ms.alltoall(x["blocks_f"])
    for kind, name in RS_OPS:
        out["reduce_scatter", kind, name] = ms.reduce_scatter(
            x["blocks_" + kind], _op(name))
    ms.barrier()

    # the i-verbs: the same results as the blocking verbs
    reqs = {("allreduce", "f", "SUM"): ms.iallreduce(x["f"]),
            ("allreduce", "i", "user"): ms.iallreduce(x["i"], _op("user")),
            ("bcast", 1, 2): ms.ibcast(x["f"], 1, 2),
            "allgather": ms.iallgather(x["i"]),
            "alltoall": ms.ialltoall(x["blocks_f"]),
            ("reduce_scatter", "f", "SUM"): ms.ireduce_scatter(
                x["blocks_f"])}
    barrier = ms.ibarrier()
    same = {}
    for k, r in reqs.items():
        r.Wait()
        same[k] = torch.equal(r.result, out[k])
    barrier.Wait()

    # a blocking verb issued behind a slow i-verb does not overtake it
    def slow(a, b):
        time.sleep(0.3)
        return a + b

    req = ms.iallreduce(x["i"], top.Op.Create(slow, name="slow"))
    behind = ms.allgather(x["i"])
    in_order = req.Test()
    req.Wait()
    in_order = in_order and torch.equal(req.result,
                                        out["allreduce", "i", "SUM"]) \
        and torch.equal(behind, out["allgather"])

    # a worker's error completes the request with its class
    errors = []
    bad = ms.ireduce_scatter(x["f"])  # leading dim N, not W: ERR_ARG

    def boom(a, b):
        raise ValueError("a user op that fails")

    for r in (bad, ms.iallreduce(x["i"], top.Op.Create(boom, name="boom"))):
        try:
            r.Wait(timeout=60)
            errors.append(None)
        except MPIError as e:
            errors.append(e.code)
    ms.barrier()
    threads = threading.active_count()
    ms.Free()
    stopped = threading.active_count() == threads - 1
    return dict(out={k: v.numpy() for k, v in out.items()}, same=same,
                in_order=in_order, errors=errors, stopped=stopped)


@pytest.fixture(scope="module")
def runs():
    """The slices' results and JAX's flat verbs on the whole inputs."""
    import jax

    from ompi_tpu.core import op as jop
    from ompi_tpu.parallel import mesh_world

    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    slices = run_world(_rank_slices, S, "cpu", timeout=240)
    jw = mesh_world(jax.devices()[:W])
    x = inputs()
    jops = {name: getattr(jop, name) for name in F_OPS + I_OPS + PAIR_OPS
            if name != "user"}
    jops["user"] = jop.Op.Create(user_combine, name="user")
    flat = {}
    run = lambda fn, a: np.asarray(fn(jw.shard(a)))  # noqa: E731
    for name in F_OPS:
        flat["allreduce", "f", name] = run(
            lambda a: jw.allreduce(a, jops[name]), _payload(x, name))
    for name in I_OPS:
        flat["allreduce", "i", name] = run(
            lambda a: jw.allreduce(a, jops[name]), x["i"])
    for name in PAIR_OPS:
        flat["allreduce", "pair", name] = run(
            lambda a: jw.allreduce(a, jops[name]), x["pair"])
    for root_slice, root in ((0, 0), (1, 2)):
        flat["bcast", root_slice, root] = run(
            lambda a: jw.bcast(a, root_slice * D + root), x["f"])
    flat["allgather"] = run(jw.allgather, x["i"])
    flat["alltoall"] = run(jw.alltoall, x["blocks_f"])
    for kind, name in RS_OPS:
        flat["reduce_scatter", kind, name] = run(
            lambda a: jw.reduce_scatter(a, jops[name]), x["blocks_" + kind])
    return slices, flat, x


def _sums(key, x, s):
    """The summed magnitudes of a float SUM's terms on slice ``s``'s rows,
    else None."""
    if key[-2:] != ("f", "SUM"):
        return None
    if key[0] == "reduce_scatter":  # row r reduces chunk r
        return np.abs(x["blocks_f"]).sum(axis=0)[s * D:(s + 1) * D]
    return np.abs(x["f"]).sum(axis=0)


def test_every_verb_and_op_matches_the_flat_verb(runs):
    slices, flat, x = runs
    keys = list(flat)
    assert set(slices[0]["out"]) == set(keys)
    for s, res in enumerate(slices):
        for key in keys:
            got, want = res["out"][key], flat[key][s * D:(s + 1) * D]
            assert got.dtype == want.dtype and got.shape == want.shape, key
            sums = _sums(key, x, s)
            if sums is None:
                np.testing.assert_array_equal(got, want, err_msg=str(key))
            else:
                assert np.all(np.abs(got - want) <= SUM_RTOL * sums), key


def test_the_i_verbs_give_the_blocking_results(runs):
    for res in runs[0]:
        assert res["same"] and all(res["same"].values()), res["same"]


def test_a_blocking_verb_does_not_overtake_an_i_verb(runs):
    assert all(res["in_order"] for res in runs[0])


def test_a_worker_error_completes_its_request(runs):
    assert all(res["errors"] == [ERR_ARG, ERR_INTERN] for res in runs[0])


def test_free_stops_the_worker(runs):
    assert all(res["stopped"] for res in runs[0])


def test_partitioned_slice_comms_are_refused():
    from ompi_tpu_torch.parallel.mesh import MeshComm
    from ompi_tpu_torch.parallel.multislice import MultiSliceComm

    split = MeshComm(D, torch.device("cpu")).Split([0, 0, 1, 1])
    with pytest.raises(MPIError) as e:
        MultiSliceComm(split, bridge=object())
    assert e.value.code == ERR_ARG
