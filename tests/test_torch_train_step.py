"""The port's training step against the JAX ``make_train_step``, on the CPU.

JAX ``init_params`` -> numpy -> ``params_from_jax`` gives both frameworks
the same weights; tokens and targets (tokens rolled by one) come from a
numpy seed. The JAX step runs under ``shard_map`` on a 1x1x1 CPU mesh (its
chunked lax attention and AD); the port's step on CPU tensors (its chunked
plain attention and autograd). Tolerances:

- first-step gradients: each within 2e-2 in relative L2 norm (bf16
  products on both sides; the port rounds the f32 cotangents of its
  products to bf16, JAX's AD keeps them in f32, which moves a gradient by a
  few 1e-3);
- 3-step losses at rtol 2e-3 and final params at rtol 1e-1 / atol 1e-2, the
  tolerances ``tests/test_model.py`` holds the JAX layouts to.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

import torch

from ompi_tpu.models import transformer as jtfm
from ompi_tpu.parallel.axes import shard_map_compat
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.ops import ring_attention as tra

SHAPE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             seq_len=32)
BATCH = 2
STEPS = 3


def _mesh():
    return Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))


def _data(seed=0):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, SHAPE["vocab"],
                       size=(BATCH, SHAPE["seq_len"])).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


@pytest.fixture(scope="module")
def jax_run():
    """JAX params (numpy), first-step gradients, 3 losses, final params."""
    cfg = jtfm.Config(**SHAPE)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    toks, tgts = _data()
    mesh = _mesh()
    pspecs = jtfm.param_specs(cfg)
    tok_spec = P("dp", "sp")

    def grads_local(p, t, g):
        B, T = t.shape
        loss, grads = jax.value_and_grad(lambda pp: jtfm._loss_local(
            pp, t, g, cfg, 1, 1, float(B * T)))(p)
        return lax.psum(loss, ("dp", "sp")), grads

    gfn = jax.jit(shard_map_compat(grads_local, mesh,
                                   (pspecs, tok_spec, tok_spec),
                                   (P(), pspecs)))
    loss0, grads = gfn(params, jnp.asarray(toks), jnp.asarray(tgts))

    step, place = jtfm.make_train_step(mesh, cfg)
    p, t, g = place(params, jnp.asarray(toks), jnp.asarray(tgts))
    losses = []
    for _ in range(STEPS):
        loss, p = step(p, t, g)
        losses.append(float(loss))
    tree = lambda x: jax.tree.map(np.asarray, x)
    return dict(params=tree(params), loss0=float(loss0), grads=tree(grads),
                losses=losses, final=tree(p), toks=toks, tgts=tgts)


def _port(jax_run, **cfg_kw):
    cfg = ttfm.Config(**SHAPE, **cfg_kw)
    step, place = ttfm.make_train_step(cfg, "cpu")
    params, toks, tgts = place(ttfm.params_from_jax(jax_run["params"],
                                                    "cpu"),
                               jax_run["toks"], jax_run["tgts"])
    return cfg, step, params, toks, tgts


def test_first_step_gradients_match_jax(jax_run):
    cfg, _, params, toks, tgts = _port(jax_run)
    loss, grads = ttfm.loss_and_grads(params, toks, tgts, cfg)
    assert abs(float(loss) - jax_run["loss0"]) <= 2e-3 * jax_run["loss0"]
    ref = jax.tree_util.tree_leaves(jax_run["grads"])
    assert len(grads) == len(ref)
    for g, r in zip(grads, ref):
        assert tuple(g.shape) == r.shape and g.dtype == torch.float32
        err = np.linalg.norm(g.numpy() - r) / np.linalg.norm(r)
        assert err <= 2e-2, err


def test_train_step_matches_jax_trajectory(jax_run):
    _, step, params, toks, tgts = _port(jax_run)
    for i in range(STEPS):
        loss, params = step(params, toks, tgts)
        assert loss.dtype == torch.float32 and loss.dim() == 0
        np.testing.assert_allclose(float(loss), jax_run["losses"][i],
                                   rtol=2e-3)
    ref = jax.tree_util.tree_leaves(jax_run["final"])
    for p, r in zip(ttfm.param_leaves(params), ref):
        np.testing.assert_allclose(p.numpy(), r, rtol=1e-1, atol=1e-2)


def test_step_updates_in_place_and_leaves_no_grad_state(jax_run):
    _, step, params, toks, tgts = _port(jax_run)
    before = [p.clone() for p in ttfm.param_leaves(params)]
    ids = [id(p) for p in ttfm.param_leaves(params)]
    _, out = step(params, toks, tgts)
    assert out is params
    assert [id(p) for p in ttfm.param_leaves(out)] == ids
    assert all(not p.requires_grad and p.grad is None
               for p in ttfm.param_leaves(out))
    assert any(not torch.equal(a, b)
               for a, b in zip(before, ttfm.param_leaves(out)))


def test_remat_gives_the_same_losses(jax_run):
    runs = []
    for remat in (False, True):
        _, step, params, toks, tgts = _port(jax_run, remat=remat)
        runs.append([float(step(params, toks, tgts)[0])
                     for _ in range(STEPS)])
    assert runs[0] == runs[1]


def test_flash_route_on_cpu_trains_like_the_chunked_path(jax_run):
    """use_flash=True on CPU tensors runs the kernels' plain versions
    through the same autograd Function the card uses: the same gradients
    within the flash tolerance."""
    cfg, _, params, toks, tgts = _port(jax_run)
    l_c, g_c = ttfm.loss_and_grads(params, toks, tgts, cfg)
    l_f, g_f = ttfm.loss_and_grads(params, toks, tgts, cfg, use_flash=True)
    assert abs(float(l_f) - float(l_c)) <= 1e-3 * float(l_c)
    for a, b in zip(g_f, g_c):
        assert float((a - b).norm() / b.norm()) <= 2e-2


def test_parallel_steps_are_not_ported_yet():
    cfg = ttfm.Config(**SHAPE)
    for kw in (dict(dp=2), dict(sp=2), dict(tp=2)):
        with pytest.raises(NotImplementedError):
            ttfm.make_train_step(cfg, "cpu", **kw)


def test_chunked_path_gradients_finite_on_none_block():
    """A fully masked ("none") block through the chunked path, with random
    cotangents for out and lse: finite (zero) gradients, thanks to the 1e-9
    denominator floor (1e-30 squared underflows and would give NaN)."""
    rng = np.random.RandomState(7)
    q, k, v, g_out = (torch.from_numpy(rng.standard_normal(
        (1, 16, 2, 8)).astype(np.float32)) for _ in range(4))
    g_lse = torch.from_numpy(rng.standard_normal((1, 2, 16)).astype(
        np.float32))
    for x in (q, k, v):
        x.requires_grad_()
    out, lse = tra._chunked_block(q, k, v, False, False, 0.35, None, 8)
    assert not out.any() and bool((lse == np.float32(tra.NEG_BIG)).all())
    torch.autograd.backward((out, lse), (g_out, g_lse))
    for x in (q, k, v):
        assert bool(torch.isfinite(x.grad).all())
        assert not x.grad.any()
