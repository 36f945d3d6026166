"""The port's mesh window against the JAX package's ``MeshWin``, on the CPU.

Each of the 8 cases of ``tests/test_meshwin.py`` runs the same sequence of
calls, with the same numpy data, on JAX ``MeshWin`` over
``mesh_world(jax.devices()[:8])`` and on the port's ``MeshWin`` over
``mesh_world(8, "cpu")``: every call that one refuses the other refuses
with the same error class, and every value read back is equal, bit for bit
(the window's dtype included). Then what only the port can get wrong: a
row read before a Put keeps its value (a torch row is a view of the
window), negative targets and indices are refused (torch reads them from
the end), and every op of Accumulate and Fetch_and_op, against JAX.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ompi_tpu.core import op as jop
from ompi_tpu.core.errors import MPIError as JaxMPIError
from ompi_tpu.osc import window as jwin
from ompi_tpu.parallel import mesh_world as jax_mesh_world
from ompi_tpu_torch.core import op as top
from ompi_tpu_torch.core.errors import MPIError, ERR_RANK, ERR_WIN
from ompi_tpu_torch.osc import window as twin
from ompi_tpu_torch.parallel.mesh import mesh_world

W = 8


@pytest.fixture(scope="module")
def worlds():
    assert jax.device_count() >= W, "conftest must force 8 CPU devices"
    return jax_mesh_world(jax.devices()[:W]), mesh_world(W, "cpu")


class Pair:
    """The two windows driven by one sequence of calls: ``call`` runs a
    verb on both and returns both results (numpy), or checks that both
    raise the same MPI error class."""

    def __init__(self, worlds, n=4, dtype="float32"):
        jw, tw = worlds
        self.j = jwin.MeshWin(jw, (n,), getattr(jnp, dtype))
        self.t = twin.MeshWin(tw, (n,), getattr(torch, dtype))

    def call(self, verb, *args, **kw):
        out = []
        for win in (self.j, self.t):
            r = getattr(win, verb)(*args, **kw)
            out.append(None if r is None else np.asarray(
                r.numpy() if isinstance(r, torch.Tensor) else r))
        if out[0] is not None:
            assert out[1].dtype == out[0].dtype
            np.testing.assert_array_equal(out[1], out[0])
        return out[1]

    def refuse(self, verb, *args, code=None, **kw):
        codes = []
        for win, err in ((self.j, JaxMPIError), (self.t, MPIError)):
            with pytest.raises(err) as e:
                getattr(win, verb)(*args, **kw)
            codes.append(e.value.code)
        assert codes[0] == codes[1]
        if code is not None:
            assert codes[1] == code

    def same_window(self):
        np.testing.assert_array_equal(self.t.array.numpy(),
                                      np.asarray(self.j.array))


def test_rma_outside_epoch_raises(worlds):
    w = Pair(worlds)
    w.refuse("Put", np.ones(4, np.float32), 2, code=ERR_WIN)
    w.refuse("Get", 1, code=ERR_WIN)
    w.refuse("Fetch_and_op", 1.0, 0, code=ERR_WIN)


def test_fence_epoch(worlds):
    w = Pair(worlds)
    w.call("Fence")
    w.call("Put", np.full(4, 5.0, np.float32), 3)
    w.call("Accumulate", np.ones(4, np.float32), 3)
    np.testing.assert_allclose(w.call("Get", 3), np.full(4, 6.0))
    w.call("Fence")
    w.call("Put", np.full(4, 8.0, np.float32), 2)
    w.call("Fence", twin.MODE_NOSUCCEED)
    w.refuse("Put", np.ones(4, np.float32), 3, code=ERR_WIN)
    w.same_window()


def test_target_validation(worlds):
    w = Pair(worlds)
    w.call("Fence")
    w.refuse("Put", np.ones(4, np.float32), 99, code=ERR_RANK)
    w.refuse("Get", -1, code=ERR_RANK)
    w.refuse("Lock", 99, code=ERR_RANK)
    w.call("Fence")


def test_lock_all_mixing_rejected(worlds):
    w = Pair(worlds)
    w.call("Lock_all")
    w.refuse("Lock", 1, code=ERR_WIN)
    w.call("Unlock_all")
    w.call("Lock", 1)
    w.refuse("Lock_all", code=ERR_WIN)
    w.call("Unlock", 1)


def test_pscw_epoch(worlds):
    w = Pair(worlds)
    w.call("Post", [1, 2])
    w.call("Start", [1, 2])
    w.call("Put", np.full(4, 2.5, np.float32), 1)
    w.refuse("Put", np.ones(4, np.float32), 5, code=ERR_WIN)
    w.call("Complete")
    w.call("Wait")
    w.refuse("Complete", code=ERR_WIN)
    w.refuse("Wait", code=ERR_WIN)
    w.same_window()


def test_pscw_test(worlds):
    w = Pair(worlds)
    w.call("Post", [0])
    w.call("Start", [0])
    w.call("Accumulate", np.ones(4, np.float32), 0)
    w.call("Complete")
    assert w.j.Test() is True and w.t.Test() is True  # the CPU has run it
    w.refuse("Test", code=ERR_WIN)
    w.same_window()


def test_lock_epochs_and_requests(worlds):
    w = Pair(worlds)
    w.call("Lock", 2)
    reqs = [win.Rput(np.full(4, 9.0, np.float32), 2) for win in (w.j, w.t)]
    for r in reqs:
        r.Wait()
    gets = [win.Rget(2) for win in (w.j, w.t)]
    for g in gets:
        g.Wait()
    np.testing.assert_array_equal(gets[1].result.numpy(),
                                  np.asarray(gets[0].result))
    np.testing.assert_array_equal(gets[1].result.numpy(), np.full(4, 9.0))
    w.refuse("Lock", 2, code=ERR_WIN)
    w.call("Unlock", 2)
    w.refuse("Unlock", 2, code=ERR_WIN)
    w.call("Lock_all")
    assert float(w.call("Fetch_and_op", 3.0, 4, index=1)) == 0.0
    assert float(w.call("Get", 4)[1]) == 3.0
    assert float(w.call("Compare_and_swap", 3.0, 7.0, 4, index=1)) == 3.0
    assert float(w.call("Get", 4)[1]) == 7.0
    assert float(w.call("Compare_and_swap", 3.0, 1.0, 4, index=1)) == 7.0
    w.call("Unlock_all")
    w.refuse("Unlock_all", code=ERR_WIN)
    w.same_window()


def test_shared_lock_and_flush(worlds):
    w = Pair(worlds)
    w.call("Lock", 0, twin.LOCK_SHARED)
    w.call("Get", 0)
    w.call("Flush", 0)
    w.call("Flush_local")
    w.call("Flush_all")
    w.call("Flush_local_all")
    w.call("Unlock", 0)
    w.call("Sync")


# ------------------------------------------------- what the port adds
def test_a_get_before_a_put_keeps_its_value(worlds):
    """JAX arrays are immutable; a torch row is a view of the window, so
    Get, Rget and the old values of the atomics must be copies."""
    win = twin.MeshWin(worlds[1], (4,))
    win.Lock_all()
    win.Put(torch.full((4,), 1.0), 3)
    got, req = win.Get(3), win.Rget(3)
    old = win.Fetch_and_op(5.0, 3, index=2)
    cas = win.Compare_and_swap(6.0, 0.5, 3, index=2)
    win.Put(torch.full((4,), 2.0), 3)
    win.Accumulate(torch.ones(4), 3)
    req.Wait()
    assert torch.equal(got, torch.full((4,), 1.0))
    assert torch.equal(req.result, torch.full((4,), 1.0))
    assert float(old) == 1.0 and float(cas) == 6.0
    assert torch.equal(win.Get(3), torch.full((4,), 3.0))
    win.Unlock_all()


def test_negative_targets_and_indices_are_refused(worlds):
    w = Pair(worlds)
    w.call("Lock_all")
    for verb, args, kw in (("Put", (np.ones(4, np.float32), -1), {}),
                           ("Accumulate", (np.ones(4, np.float32), -8), {}),
                           ("Get", (-3,), {}),
                           ("Rget", (-1,), {}),
                           ("Fetch_and_op", (1.0, 0), {"index": -1}),
                           ("Fetch_and_op", (1.0, 0), {"index": 4}),
                           ("Compare_and_swap", (0.0, 1.0, -2), {}),
                           ("Compare_and_swap", (0.0, 1.0, 0),
                            {"index": -4})):
        w.refuse(verb, *args, code=ERR_RANK, **kw)
    w.call("Unlock_all")
    w.refuse("Lock", -1, code=ERR_RANK)
    w.same_window()
    assert not w.t.array.any()


OPS = ["SUM", "PROD", "MAX", "MIN", "LAND", "LOR", "LXOR", "REPLACE",
       "NO_OP"]
INT_OPS = ["BAND", "BOR", "BXOR"]


@pytest.mark.parametrize("name", OPS + INT_OPS)
def test_accumulate_and_fetch_and_op_follow_jax(worlds, name):
    dtype = "int32" if name in INT_OPS else "float32"
    w = Pair(worlds, n=6, dtype=dtype)
    rng = np.random.RandomState(len(name))
    data = lambda: (rng.randint(-5, 6, 6) if dtype == "int32"  # noqa: E731
                    else rng.randint(-2, 3, 6) * 0.5).astype(dtype)
    w.call("Fence")
    for t in range(W):
        w.call("Put", data(), t)
    for t in (0, 5, 5):
        d = data()
        w.j.Accumulate(d, t, getattr(jop, name))
        w.t.Accumulate(d, t, getattr(top, name))
        v = np.asarray(d[0]).item()
        old_j = w.j.Fetch_and_op(v, t, 2, getattr(jop, name))
        old_t = w.t.Fetch_and_op(v, t, 2, getattr(top, name))
        np.testing.assert_array_equal(old_t.numpy(), np.asarray(old_j))
    w.call("Fence", twin.MODE_NOSUCCEED)
    w.same_window()
