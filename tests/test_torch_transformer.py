"""The port's forward, and the ops it is built from, against JAX.

JAX ``init_params`` -> numpy -> ``params_from_jax`` gives both frameworks
the same weights. The port's CPU forward is held against JAX
``forward_local(..., in_mesh=True)`` in ``shard_map`` on a 1x1x1 mesh (the
same branch, with the chunked attention path on both sides) at rtol/atol
2e-2, and against JAX ``forward()`` (dense f32 reference attention) at
5e-2: there the attention probabilities are not rounded to bf16 before
P.V, which moves the logits by up to a few bf16 ulps after two layers.

The sharding plan is held leaf by leaf against the JAX ``param_specs``, and
``shard_params``/``gather_params`` in a world of 8 gloo ranks at (2, 2, 2).
The ranks import this module, so it imports JAX only inside a fixture.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch import entry as tentry
from ompi_tpu_torch.models import transformer as ttfm
from ompi_tpu_torch.ops import mxu as tmxu
from ompi_tpu_torch.ops import softmax_xent as txent
from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world

SHAPE = dict(vocab=64, d_model=64, n_heads=4, n_layers=2, d_ff=128,
             seq_len=32)
BATCH = 2


@pytest.fixture(scope="module", autouse=True)
def _jax_imports():
    """JAX and the JAX package, bound as this module's globals here and not
    at its top: the ranks of the world import this module."""
    global jax, jnp, Mesh, P, jtfm, jmxu, jxent, shard_map_compat
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ompi_tpu.models import transformer as jtfm
    from ompi_tpu.ops import mxu as jmxu
    from ompi_tpu.ops import softmax_xent as jxent
    from ompi_tpu.parallel.axes import shard_map_compat


@pytest.fixture(scope="module")
def setup():
    jcfg = jtfm.Config(**SHAPE)
    jparams = jtfm.init_params(jax.random.PRNGKey(0), jcfg)
    params_np = jax.tree.map(np.asarray, jparams)
    rng = np.random.RandomState(0)
    toks = rng.randint(0, SHAPE["vocab"],
                       size=(BATCH, SHAPE["seq_len"])).astype(np.int32)
    tparams = ttfm.params_from_jax(params_np, "cpu")
    logits = ttfm.forward(tparams, torch.from_numpy(toks),
                          ttfm.Config(**SHAPE)).numpy()
    return jcfg, jparams, toks, logits


def test_forward_matches_jax_in_mesh_branch(setup):
    jcfg, jparams, toks, logits = setup
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("dp", "sp", "tp"))
    specs = jax.tree.map(lambda _: P(), jparams)

    def local(p, t):
        return jtfm.forward_local(p, t, jcfg, tp=1, sp=1, in_mesh=True)

    fn = jax.jit(shard_map_compat(local, mesh, (specs, P("dp", "sp")),
                                  P("dp", "sp", None)))
    ref = np.asarray(fn(jparams, jnp.asarray(toks)))
    assert logits.shape == (BATCH, SHAPE["seq_len"], SHAPE["vocab"])
    assert logits.dtype == np.float32
    np.testing.assert_allclose(logits, ref, rtol=2e-2, atol=2e-2)


def test_forward_close_to_jax_dense_forward(setup):
    jcfg, jparams, toks, logits = setup
    ref = np.asarray(jax.jit(lambda p, t: jtfm.forward(p, t, jcfg))(
        jparams, jnp.asarray(toks)))
    np.testing.assert_allclose(logits, ref, rtol=5e-2, atol=5e-2)


def test_forward_flash_route_on_cpu_matches(setup):
    """The flash route's plain version in place of the chunked path: the
    same model within the flash tolerance."""
    jcfg, jparams, toks, logits = setup
    tparams = ttfm.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    alt = ttfm.forward(tparams, torch.from_numpy(toks),
                       ttfm.Config(**SHAPE), use_flash=True).numpy()
    np.testing.assert_allclose(alt, logits, rtol=2e-2, atol=2e-2)


def test_params_from_jax_is_a_copy_of_the_layout(setup):
    _, jparams, _, _ = setup
    tparams = ttfm.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu")
    own = ttfm.init_params(ttfm.Config(**SHAPE),
                           torch.Generator().manual_seed(0), "cpu")
    flat_j = jax.tree_util.tree_leaves(jparams)
    flat_t = jax.tree_util.tree_leaves(tparams)
    flat_o = jax.tree_util.tree_leaves(own)
    assert len(flat_j) == len(flat_t) == len(flat_o)
    for a, b, c in zip(flat_j, flat_t, flat_o):
        assert b.dtype == c.dtype == torch.float32
        assert tuple(b.shape) == tuple(c.shape) == a.shape
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))


def test_init_params_is_seeded():
    cfg = ttfm.Config(**SHAPE)
    a = ttfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    b = ttfm.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    torch.testing.assert_close(a["blocks"][1]["w2"], b["blocks"][1]["w2"],
                               atol=0, rtol=0)
    # fan-in scaling as in the JAX init: std 1/sqrt(d_ff) for w2
    std = float(a["blocks"][1]["w2"].std())
    assert abs(std - 1 / np.sqrt(SHAPE["d_ff"])) < 0.02


@pytest.mark.parametrize("pattern,sa,sb", [
    ("btd,dhf->bhtf", (2, 8, 16), (16, 4, 8)),
    ("btd,df->btf", (2, 8, 16), (16, 24)),
])
def test_einsum_bf16_matches_jax(pattern, sa, sb):
    rng = np.random.RandomState(4)
    a = np.asarray(jnp.asarray(rng.standard_normal(sa), jnp.bfloat16))
    b = np.asarray(jnp.asarray(rng.standard_normal(sb), jnp.bfloat16))
    ref = np.asarray(jmxu.einsum_bf16(pattern, jnp.asarray(a),
                                      jnp.asarray(b)), np.float32)
    out = tmxu.einsum_bf16(pattern,
                           torch.from_numpy(a.astype(np.float32)).bfloat16(),
                           torch.from_numpy(b.astype(np.float32)).bfloat16())
    assert out.dtype == torch.bfloat16 and out.is_contiguous()
    # one bf16 rounding of an f32 sum: at most one ulp apart
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=8e-3,
                               atol=1e-2)


def test_contract_f32_wo_pattern_matches_numpy():
    rng = np.random.RandomState(5)
    att = rng.standard_normal((2, 4, 8, 16)).astype(np.float32)
    wo = rng.standard_normal((4, 16, 32)).astype(np.float32)
    r = lambda x: torch.from_numpy(x).bfloat16().float().numpy()
    ref = np.einsum("bhtf,hfd->btd", r(att), r(wo))
    out = tmxu.contract_f32("bhtf,hfd->btd", torch.from_numpy(att),
                            torch.from_numpy(wo))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)
    with pytest.raises(ValueError):
        tmxu.contract_f32("bij,bjk->bik", torch.from_numpy(att[0]),
                          torch.from_numpy(att[0]))


def test_logits_matmul_matches_jax():
    rng = np.random.RandomState(6)
    x = rng.standard_normal((2, 8, 32)).astype(np.float32)
    w = rng.standard_normal((48, 32)).astype(np.float32)
    ref = np.asarray(jxent.logits_matmul(jnp.asarray(x), jnp.asarray(w)))
    out = txent.logits_matmul(torch.from_numpy(x), torch.from_numpy(w))
    assert out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-4)


def test_size_one_axes_are_identities():
    x = torch.arange(6.0)
    assert taxes.rank("sp") == 0 and taxes.size("tp") == 1
    assert taxes.allreduce(x, "tp") is x
    with pytest.raises(ValueError):
        taxes.allreduce(x, "tp", op="prod")


def test_entry_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.entry()


def test_entry_on_cpu_runs():
    fn, (params, tokens) = tentry.entry(device="cpu")
    logits = fn(params, tokens)
    assert tuple(logits.shape) == (4, 256, 8192)
    assert bool(torch.isfinite(logits).all())


# ------------------------------------------------------ the sharding plan


def test_param_specs_match_the_jax_plan():
    cfg = ttfm.Config(**SHAPE)
    ours = ttfm.param_leaves(ttfm.param_specs(cfg))
    theirs = jax.tree_util.tree_leaves(
        jtfm.param_specs(jtfm.Config(**SHAPE)),
        is_leaf=lambda x: isinstance(x, P))
    assert len(ours) == len(theirs) == 3 + 6 * SHAPE["n_layers"]
    for a, b in zip(ours, theirs):
        assert a == tuple(b)


def _rank_roundtrip(params_np):
    """This rank's slice of every parameter, and the tree gathered back."""
    cfg = ttfm.Config(**SHAPE)
    specs = ttfm.param_specs(cfg)
    local = ttfm.shard_params(ttfm.params_from_jax(params_np, "cpu"), specs)
    back = ttfm.gather_params(local, specs)
    leaves = lambda t: [x.numpy() for x in ttfm.param_leaves(t)]
    return leaves(local), leaves(back)


@pytest.fixture(scope="module")
def roundtrip():
    params = jax.tree.map(np.asarray, jtfm.init_params(
        jax.random.PRNGKey(0), jtfm.Config(**SHAPE)))
    return params, run_world(_rank_roundtrip, 8, "cpu", params,
                             shape=(2, 2, 2))


def test_gather_params_of_shard_params_is_the_tree(roundtrip):
    params, ranks = roundtrip
    full = jax.tree_util.tree_leaves(params)
    for _, back in ranks:
        assert len(back) == len(full)
        for a, b in zip(back, full):
            np.testing.assert_array_equal(a, b)


def test_shard_params_gives_each_rank_its_tp_slice(roundtrip):
    """The slices are those JAX's NamedSharding gives device r of the
    (2, 2, 2) mesh: split over tp only, the same on every dp and sp."""
    params, ranks = roundtrip
    specs = jax.tree_util.tree_leaves(
        jtfm.param_specs(jtfm.Config(**SHAPE)),
        is_leaf=lambda x: isinstance(x, P))
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 2, 2),
                ("dp", "sp", "tp"))
    for leaf, spec, i in zip(jax.tree_util.tree_leaves(params), specs,
                             range(len(specs))):
        arr = jax.device_put(leaf, jax.sharding.NamedSharding(mesh, spec))
        for shard in arr.addressable_shards:
            r = list(mesh.devices.flat).index(shard.device)
            np.testing.assert_array_equal(ranks[r][0][i],
                                          np.asarray(shard.data))


# ------------------------------------------------------ dryrun_multichip


@pytest.mark.parametrize("n", range(1, 9))
def test_factor_matches_the_jax_entry(n):
    import __graft_entry__

    assert tentry._factor(n) == __graft_entry__._factor(n)


def test_dryrun_multichip_on_cpu_gives_a_finite_loss():
    loss = tentry.dryrun_multichip(8, "cpu")
    # a random-init model over 64 tokens starts in the order of log(64)
    assert np.isfinite(loss) and 0.5 * np.log(64) < loss < 2 * np.log(64)


def test_dryrun_multichip_without_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tentry.dryrun_multichip(8)


def test_dryrun_configs(monkeypatch):
    """The JAX dry run's model exactly, on the CPU and on the card alike.
    Its head dim of 4 is one the flash kernels refuse: on the card the
    default route raises there, so the dry run names the plain path."""
    from ompi_tpu_torch.ops.flash_attention import flash_supported
    from ompi_tpu_torch.ops.ring_attention import flash_default

    cfg = tentry.dryrun_config(8, "cpu")
    assert (cfg.vocab, cfg.d_model, cfg.n_heads, cfg.n_layers, cfg.d_ff,
            cfg.seq_len) == (64, 32, 8, 2, 64, 16)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    assert tentry.dryrun_config(8, "cuda") == cfg
    _, sp, tp = tentry._factor(8)
    shard = (2, cfg.n_heads // tp, cfg.seq_len // sp, cfg.head_dim)
    assert not flash_supported(shard, shard, "bhtd")
    with pytest.raises(ValueError):
        flash_default("cuda", shard, shard, "bhtd")
