"""The port's mesh checkpointer against the JAX package's, on the CPU.

- Retention, ``tests/test_checkpoint.py``'s ``test_mesh_checkpoint_retention``
  on both packages: the same steps kept, the same values restored.
- Resume, ``test_mesh_train_checkpoint_resume_identical`` at its (2, 2, 2)
  configuration, in one world of 8 gloo CPU processes: 5 steps straight,
  then 3 steps, a save of the gathered tree, a restore re-placed by specs,
  and 2 more steps. The resumed losses and final parameters equal the
  uninterrupted run's bit for bit; the losses are within 2e-3 relative of
  the JAX step's on the same weights and batch (the tolerance
  ``tests/test_torch_train_step.py`` holds the (2, 2, 2) step to). The same
  checkpoint restores on a (2, 1, 4) mesh, whose 2 steps agree with the
  (2, 2, 2) resume within 2e-3 relative (other reduction orders).
- The port's format (``torch.save``) is not orbax's: a deliberate
  difference (ROADMAP C). The ranks import this module, so it imports JAX
  only in fixtures.
"""

import os

import numpy as np
import pytest
import torch

from ompi_tpu_torch.core.errors import MPIError, ERR_FILE
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world
from ompi_tpu_torch.runtime.checkpoint import MeshCheckpointer

SHAPE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             seq_len=32)
BATCH = 4
LOSS_RTOL = 2e-3


def _data(seed=7):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, SHAPE["vocab"], (BATCH, SHAPE["seq_len"]),
                        dtype=np.int32)
    return toks, np.roll(toks, -1, axis=1)


def test_retention_follows_jax(tmp_path):
    from ompi_tpu.runtime.checkpoint import MeshCheckpointer as JaxCk

    cks = [JaxCk(str(tmp_path / "jax"), max_to_keep=2),
           MeshCheckpointer(str(tmp_path / "port"), max_to_keep=2)]
    for s in (1, 2, 3):
        for ck in cks:
            ck.save(s, {"a": np.full(2, float(s))})
    jck, tck = cks
    assert tck.latest_step() == jck.latest_step() == 3
    assert tck.all_steps() == sorted(jck._mgr.all_steps()) == [2, 3]
    got, want = tck.restore(), jck.restore()
    np.testing.assert_array_equal(got["a"].numpy(), want["a"])
    np.testing.assert_array_equal(tck.restore(2)["a"].numpy(),
                                  np.asarray(jck.restore(2)["a"]))
    for ck in cks:
        ck.close()
    assert sorted(os.listdir(tmp_path / "port")) == ["2", "3"]


def test_restore_errors_and_template(tmp_path):
    ck = MeshCheckpointer(str(tmp_path / "ck"))
    for step in (None, 4):
        with pytest.raises(MPIError) as e:
            ck.restore(step)
        assert e.value.code == ERR_FILE
    tree = {"w": torch.arange(6, dtype=torch.float32).view(2, 3),
            "blocks": [{"b": torch.ones(2, dtype=torch.float64)}]}
    ck.save(1, tree)
    with pytest.raises(MPIError) as e:
        ck.save(1, tree)
    assert e.value.code == ERR_FILE
    like = {"w": torch.zeros((2, 3), dtype=torch.bfloat16),
            "blocks": [{"b": torch.zeros(2, dtype=torch.float32)}]}
    got = ck.restore(1, template=like)
    assert got["w"].dtype == torch.bfloat16
    assert got["blocks"][0]["b"].dtype == torch.float32
    assert torch.equal(got["w"].float(), tree["w"])
    for bad in ({"w": torch.zeros(3, 2), "blocks": like["blocks"]},
                {"w": like["w"]}, {"w": like["w"], "blocks": []}):
        with pytest.raises(MPIError) as e:
            ck.restore(1, template=bad)
        assert e.value.code == ERR_FILE


def test_a_failed_save_leaves_no_step(tmp_path, monkeypatch):
    ck = MeshCheckpointer(str(tmp_path / "ck"))
    ck.save(1, {"a": torch.ones(2)})

    def torn(obj, f):
        with open(f, "wb") as fh:
            fh.write(b"half a checkpoint")
        raise OSError("disk full")

    monkeypatch.setattr(torch, "save", torn)
    with pytest.raises(OSError):
        ck.save(2, {"a": torch.zeros(2)})
    assert ck.all_steps() == [1] and ck.latest_step() == 1
    assert sorted(os.listdir(tmp_path / "ck")) == ["1"]


def _rank_resume(params_np, toks, tgts, ckdir):
    """5 steps straight; 3 steps, save, restore by specs, 2 steps; then the
    checkpoint restored on a (2, 1, 4) mesh and 2 steps there."""
    import torch.distributed as dist

    cfg = ttfm.Config(**SHAPE)
    specs = ttfm.param_specs(cfg)
    step, place = ttfm.make_train_step(cfg, "cpu", 2, 2, 2)
    # place() shares the replicated leaves with the full tree, and the step
    # updates them in place: each run starts from a fresh copy
    p, t, g = place(ttfm.params_from_jax(params_np, "cpu"), toks, tgts)
    straight = [float(step(p, t, g)[0]) for _ in range(5)]
    final = ttfm.gather_params(p, specs)

    p, t, g = place(ttfm.params_from_jax(params_np, "cpu"), toks, tgts)
    for _ in range(3):
        step(p, t, g)
    ck = MeshCheckpointer(ckdir)
    full = ttfm.gather_params(p, specs)
    if dist.get_rank() == 0:
        ck.save(3, full)
    dist.barrier()
    restored = ck.restore(specs=specs, device="cpu")
    assert all(a.data_ptr() != b.data_ptr() for a, b in zip(
        ttfm.param_leaves(restored), ttfm.param_leaves(p)))
    resumed = [float(step(restored, t, g)[0]) for _ in range(2)]
    same_params = all(torch.equal(a, b) for a, b in zip(
        ttfm.param_leaves(ttfm.gather_params(restored, specs)),
        ttfm.param_leaves(final)))

    taxes.init_mesh(2, 1, 4, device="cpu")
    step2, place2 = ttfm.make_train_step(cfg, "cpu", 2, 1, 4)
    _, t2, g2 = place2(ttfm.params_from_jax(params_np, "cpu"), toks, tgts)
    other = ck.restore(3, specs=specs, device="cpu")
    elsewhere = [float(step2(other, t2, g2)[0]) for _ in range(2)]
    return dict(straight=straight, resumed=resumed, same_params=same_params,
                elsewhere=elsewhere)


@pytest.fixture(scope="module")
def resume_runs(tmp_path_factory):
    import jax
    from jax.sharding import Mesh

    from ompi_tpu.models import transformer as jtfm

    cfg = jtfm.Config(**SHAPE)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    toks, tgts = _data()
    ranks = run_world(_rank_resume, 8, "cpu",
                      jax.tree.map(np.asarray, params), toks, tgts,
                      str(tmp_path_factory.mktemp("resume")),
                      shape=(2, 2, 2), timeout=300)
    mesh = Mesh(np.asarray(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "sp", "tp"))
    step_fn, place = jtfm.make_train_step(mesh, cfg)
    p, dt, dg = place(params, toks, tgts)
    losses = []
    for _ in range(5):
        loss, p = step_fn(p, dt, dg)
        losses.append(float(loss))
    return ranks, losses


def test_resume_is_identical_within_the_port(resume_runs):
    ranks, _ = resume_runs
    for r in ranks:
        assert r["resumed"] == r["straight"][3:]
        assert r["same_params"]
        assert r["straight"] == ranks[0]["straight"]


def test_losses_follow_jax(resume_runs):
    ranks, jax_losses = resume_runs
    np.testing.assert_allclose(ranks[0]["straight"], jax_losses,
                               rtol=LOSS_RTOL)
    np.testing.assert_allclose(ranks[0]["resumed"], jax_losses[3:],
                               rtol=LOSS_RTOL)


def test_the_checkpoint_restores_on_another_mesh(resume_runs):
    ranks, _ = resume_runs
    for r in ranks:
        np.testing.assert_allclose(r["elsewhere"], r["resumed"],
                                   rtol=LOSS_RTOL)
