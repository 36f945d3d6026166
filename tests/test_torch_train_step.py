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

The multi-rank step runs in one world of 8 gloo ranks at the JAX package's
two layouts (dp, sp, tp) = (2, 2, 2) and (2, 1, 4) (``tests/test_model.py``)
against JAX ``make_train_step`` on the 8-device virtual CPU mesh: 3 steps,
losses within 2e-3 relative and every gathered parameter within 2e-2
relative L2; and the first step's loss (2e-3) and gradients, after the
("dp", "sp") allreduce and gathered over tp, within 5e-2 relative L2. At
random init each gradient is a sum whose terms largely cancel, so bf16
rounding in another order moves it by a few 1e-2, as much between JAX's
own gradients at (2, 2, 2) and (2, 1, 4) as between the port's and JAX's.
A reduction counted twice or missed gives errors of order 1. The ranks import this module, so it imports JAX only
inside a fixture.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.ops import ring_attention as tra
from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world

SHAPE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             seq_len=32)
BATCH = 2
STEPS = 3
LAYOUTS = [(2, 2, 2), (2, 1, 4)]
MESH_BATCH = 4


@pytest.fixture(scope="module", autouse=True)
def _jax_imports():
    """JAX and the JAX package, bound as this module's globals here and not
    at its top: the ranks of the world import this module."""
    global jax, jnp, lax, Mesh, P, jtfm, shard_map_compat
    import jax
    import jax.numpy as jnp
    from jax import lax
    from jax.sharding import Mesh, PartitionSpec as P

    from ompi_tpu.models import transformer as jtfm
    from ompi_tpu.parallel.axes import shard_map_compat


def _mesh(dp=1, sp=1, tp=1):
    return Mesh(np.array(jax.devices()[:dp * sp * tp]).reshape(dp, sp, tp),
                ("dp", "sp", "tp"))


def _data(seed=0, batch=BATCH):
    rng = np.random.RandomState(seed)
    toks = rng.randint(0, SHAPE["vocab"],
                       size=(batch, SHAPE["seq_len"])).astype(np.int32)
    return toks, np.roll(toks, -1, axis=1).astype(np.int32)


def _jax_reference(params, toks, tgts, layout):
    """The JAX step at ``layout``: first-step loss and gradients, STEPS
    losses and the final parameters (numpy)."""
    cfg = jtfm.Config(**SHAPE)
    mesh = _mesh(*layout)
    dp, sp, tp = layout
    pspecs = jtfm.param_specs(cfg)
    tok_spec = P("dp", "sp")

    def grads_local(p, t, g):
        B, T = t.shape
        loss, grads = jax.value_and_grad(lambda pp: jtfm._loss_local(
            pp, t, g, cfg, tp, sp, float(B * T * dp * sp)))(p)
        return lax.psum(loss, ("dp", "sp")), grads

    gfn = jax.jit(shard_map_compat(grads_local, mesh,
                                   (pspecs, tok_spec, tok_spec),
                                   (P(), pspecs)))
    step, place = jtfm.make_train_step(mesh, cfg)
    p, t, g = place(params, jnp.asarray(toks), jnp.asarray(tgts))
    loss0, grads = gfn(p, t, g)
    losses = []
    for _ in range(STEPS):
        loss, p = step(p, t, g)
        losses.append(float(loss))
    tree = lambda x: jax.tree.map(np.asarray, x)
    return dict(loss0=float(loss0), grads=tree(grads), losses=losses,
                final=tree(p))


@pytest.fixture(scope="module")
def jax_run():
    """JAX params (numpy), first-step gradients, 3 losses, final params."""
    cfg = jtfm.Config(**SHAPE)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    toks, tgts = _data()
    ref = _jax_reference(params, toks, tgts, (1, 1, 1))
    return dict(params=jax.tree.map(np.asarray, params), toks=toks,
                tgts=tgts, **ref)


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


def test_step_layout_must_match_the_mesh():
    cfg = ttfm.Config(**SHAPE)
    for kw in (dict(dp=2), dict(sp=2), dict(tp=2)):
        with pytest.raises(ValueError):
            ttfm.make_train_step(cfg, "cpu", **kw)


# ------------------------------------------------- dp x sp x tp, one world


def _rank_layout(params_np, toks, tgts, layout, remat=False):
    """First-step loss and reduced, tp-gathered gradients, then STEPS losses
    and the gathered final parameters, at ``layout``."""
    taxes.init_mesh(*layout, device="cpu")
    cfg = ttfm.Config(**SHAPE, remat=remat)
    specs = ttfm.param_leaves(ttfm.param_specs(cfg))
    step, place = ttfm.make_train_step(cfg, "cpu", *layout)
    params, t, g = place(ttfm.params_from_jax(params_np, "cpu"), toks, tgts)
    loss0, grads = ttfm.loss_and_grads(params, t, g, cfg)
    loss0 = float(taxes.allreduce(loss0, ("dp", "sp")))
    grads = ttfm.gather_params(ttfm.allreduce_grads(grads), specs)
    losses = [float(step(params, t, g)[0]) for _ in range(STEPS)]
    final = ttfm.gather_params(params, ttfm.param_specs(cfg))
    leaves = lambda xs: [x.numpy() for x in ttfm.param_leaves(xs)]
    return dict(loss0=loss0, grads=leaves(grads), losses=losses,
                final=leaves(final))


def _rank_train(params_np, toks, tgts, copies):
    """Both layouts, (2, 2, 2) again with remat, and the gradients of
    ``copies`` (two copies of one batch) at (2, 1, 4). Rank 0 returns
    everything, the others their losses."""
    out = {layout: _rank_layout(params_np, toks, tgts, layout)
           for layout in LAYOUTS}
    out["remat"] = _rank_layout(params_np, toks, tgts, (2, 2, 2), True)
    out["copies"] = _rank_layout(params_np, *copies, (2, 1, 4))
    if torch.distributed.get_rank() != 0:
        out = {k: dict(losses=v["losses"]) for k, v in out.items()}
    return out


@pytest.fixture(scope="module")
def mesh_runs():
    """The port's world and the JAX step at each layout, on one set of
    weights and one global batch of MESH_BATCH rows."""
    cfg = jtfm.Config(**SHAPE)
    params = jtfm.init_params(jax.random.PRNGKey(0), cfg)
    params_np = jax.tree.map(np.asarray, params)
    toks, tgts = _data(1, MESH_BATCH)
    copies = tuple(np.concatenate([x[:BATCH]] * 2) for x in (toks, tgts))
    ranks = run_world(_rank_train, 8, "cpu", params_np, toks, tgts, copies,
                      shape=(2, 2, 2))
    ref = {layout: _jax_reference(params, toks, tgts, layout)
           for layout in LAYOUTS}
    return dict(ranks=ranks, jax=ref, params=params_np,
                single=tuple(x[:BATCH] for x in (toks, tgts)))


def _rel_l2(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "x".join(map(str, l)))
def test_multi_rank_first_step_gradients_match_jax(mesh_runs, layout):
    got, ref = mesh_runs["ranks"][0][layout], mesh_runs["jax"][layout]
    assert abs(got["loss0"] - ref["loss0"]) <= 2e-3 * ref["loss0"]
    want = jax.tree_util.tree_leaves(ref["grads"])
    assert len(got["grads"]) == len(want)
    for g, r in zip(got["grads"], want):
        assert g.shape == r.shape
        assert _rel_l2(g, r) <= 5e-2


@pytest.mark.parametrize("layout", LAYOUTS, ids=lambda l: "x".join(map(str, l)))
def test_multi_rank_trajectory_matches_jax(mesh_runs, layout):
    got, ref = mesh_runs["ranks"][0][layout], mesh_runs["jax"][layout]
    np.testing.assert_allclose(got["losses"], ref["losses"], rtol=2e-3)
    want = jax.tree_util.tree_leaves(ref["final"])
    for p, r in zip(got["final"], want):
        assert p.shape == r.shape
        assert _rel_l2(p, r) <= 2e-2


def test_every_rank_reports_the_same_losses(mesh_runs):
    ranks = mesh_runs["ranks"]
    for key in ranks[0]:
        assert all(r[key]["losses"] == ranks[0][key]["losses"]
                   for r in ranks)


def test_remat_at_sp2_gives_the_same_losses(mesh_runs):
    """Recomputing a block repeats its ring shifts and tp allreduces in the
    backward, in the same order on every rank."""
    got = mesh_runs["ranks"][0]
    assert got["remat"]["losses"] == got[(2, 2, 2)]["losses"]
    for a, b in zip(got["remat"]["grads"], got[(2, 2, 2)]["grads"]):
        np.testing.assert_array_equal(a, b)


def test_dp_copies_give_the_single_batch_gradients(mesh_runs):
    """dp = 2 on two copies of one batch gives the gradients of that batch
    alone on one rank: the reduction over ("dp", "sp") is counted once
    (twice would double them), and tp = 4's sums are in the model."""
    cfg = ttfm.Config(**SHAPE)
    params = ttfm.params_from_jax(mesh_runs["params"], "cpu")
    toks, tgts = (torch.from_numpy(x) for x in mesh_runs["single"])
    loss, grads = ttfm.loss_and_grads(params, toks, tgts, cfg)
    got = mesh_runs["ranks"][0]["copies"]
    assert abs(got["loss0"] - float(loss)) <= 1e-5 * float(loss)
    for g, r in zip(got["grads"], grads):
        assert _rel_l2(g, r.numpy()) <= 1e-2
