"""The port's ring attention and dense reference against JAX.

At sp = 1 JAX's ``ring_attention`` runs under ``shard_map`` on a 1-device
'sp' mesh and, on the CPU, takes its chunked lax path; the port on the CPU
takes its chunked plain path. At sp = 2, 4 and 8 one world of 8 gloo ranks
runs every case (the mesh rebuilt as (8/sp, sp, 1) for each sp) against JAX
``ring_attention_sharded`` on the 8-device virtual CPU mesh, forward and
q/k/v gradients, on the chunked path and on the flash route (the kernels'
plain versions on CPU tensors).

Same algorithm, other summation order: tolerance 1e-4 where both sides
compute in f32 end to end, 1e-2 where the result is rounded to bf16 (one
bf16 ulp at these magnitudes), 2e-2 for the flash route, whose plain
version rounds q, k, v and P to bf16 where the JAX lax path does not. The
ranks import this module, so it imports JAX only inside a fixture.
"""

import numpy as np
import pytest
import torch

from ompi_tpu_torch.ops import flash_attention as tfa
from ompi_tpu_torch.ops import ring_attention as tra
from ompi_tpu_torch.parallel import axes as taxes
from ompi_tpu_torch.parallel.launch import run_world

B, T, H, D = 2, 32, 2, 16
S = 64  # the global sequence of the multi-rank cases
RING_CASES = [(sp, causal, layout, route) for sp in (2, 4, 8)
              for causal in (True, False) for layout in ("bthd", "bhtd")
              for route in ("chunked", "flash")]


@pytest.fixture(scope="module", autouse=True)
def _jax_imports():
    """JAX and the JAX package, bound as this module's globals here and not
    at its top: the ranks of the world import this module."""
    global jax, jnp, Mesh, P, jra, shard_map_compat
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh, PartitionSpec as P

    from ompi_tpu.ops import ring_attention as jra
    from ompi_tpu.parallel.axes import shard_map_compat


def _qkv(seed, layout, dtype=np.float32):
    rng = np.random.RandomState(seed)
    shape = (B, T, H, D) if layout == "bthd" else (B, H, T, D)
    return tuple(rng.standard_normal(shape).astype(dtype) for _ in range(3))


def _jax_ring(q, k, v, causal, mxu_dtype, chunk, layout):
    mesh = Mesh(np.array(jax.devices()[:1]), ("sp",))
    spec = P()

    def local(qb, kb, vb):
        return jra.ring_attention(qb, kb, vb, "sp", 1, causal=causal,
                                  mxu_dtype=mxu_dtype, chunk=chunk,
                                  use_flash=False, layout=layout)

    fn = jax.jit(shard_map_compat(local, mesh, (spec,) * 3, spec))
    return np.asarray(fn(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)))


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("bf16", [False, True])
def test_ring_sp1_matches_jax(layout, causal, bf16):
    q, k, v = _qkv(0, layout)
    if bf16:
        q, k, v = (np.asarray(jnp.asarray(x, jnp.bfloat16)) for x in (q, k, v))
    ref = _jax_ring(q, k, v, causal, jnp.bfloat16 if bf16 else None, 8,
                    layout)
    tq, tk, tv = (torch.from_numpy(np.asarray(x, np.float32)) for x in
                  (q, k, v))
    if bf16:
        tq, tk, tv = tq.bfloat16(), tk.bfloat16(), tv.bfloat16()
    out = tra.ring_attention(tq, tk, tv, "sp", 1, causal=causal,
                             mxu_dtype=torch.bfloat16 if bf16 else None,
                             chunk=8, layout=layout)
    assert out.dtype == tq.dtype and tuple(out.shape) == q.shape
    tol = 1e-2 if bf16 else 1e-4
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref, np.float32), atol=tol,
                               rtol=tol)


def test_chunked_block_sentinel_matches_jax():
    """A 'none' block: out 0 and lse -1e30 exactly, on both sides."""
    q, k, v = _qkv(1, "bthd")
    o_j, l_j = jra._lax_block(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                              jnp.bool_(False), jnp.bool_(False),
                              0.25, None, 16)
    o_t, l_t = tra._chunked_block(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), False, False, 0.25,
                                  None, 16)
    np.testing.assert_array_equal(o_t.numpy(), np.asarray(o_j))
    np.testing.assert_array_equal(l_t.numpy(), np.asarray(l_j))
    assert bool((l_t == np.float32(tra.NEG_BIG)).all())


@pytest.mark.parametrize("causal", [True, False])
def test_reference_attention_matches_jax(causal):
    q, k, v = _qkv(2, "bthd")
    ref = np.asarray(jra.reference_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=causal))
    out = tra.reference_attention(torch.from_numpy(q), torch.from_numpy(k),
                                  torch.from_numpy(v), causal=causal)
    np.testing.assert_allclose(out.numpy(), ref, atol=1e-5, rtol=1e-5)


def test_flash_route_on_cpu_matches_chunked_path():
    """use_flash=True on CPU tensors takes the kernel's plain version; it
    agrees with the chunked path within the flash tolerance."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(3, "bhtd"))
    a = tra.ring_attention(q, k, v, "sp", 1, mxu_dtype=torch.bfloat16,
                           use_flash=True, layout="bhtd")
    b = tra.ring_attention(q, k, v, "sp", 1, mxu_dtype=torch.bfloat16,
                           use_flash=False, layout="bhtd")
    torch.testing.assert_close(a, b, atol=2e-2, rtol=2e-2)


def test_cpu_tensors_take_the_plain_path():
    q = torch.zeros(1, 2, 64, 16)
    assert not tra.use_flash_default(q, q, "bhtd")


# (q shape, k shape, layout, whether the kernels take it): the flagship's
# block, every head-dim and tile refusal of ``flash_supported``, and the
# JAX dry run's per-rank block (head dim 4, 8 rows)
GATE_CASES = [
    ((8, 8, 1024, 128), (8, 8, 1024, 128), "bhtd", True),
    ((4, 256, 8, 32), (4, 256, 8, 32), "bthd", True),
    ((1, 256, 1, 128), (1, 1 << 20, 1, 128), "bthd", True),
    ((2, 96, 4, 64), (2, 96, 4, 64), "bthd", False),
    ((2, 64, 4, 24), (2, 64, 4, 24), "bthd", False),
    ((2, 64, 4, 256), (2, 64, 4, 256), "bthd", False),
    ((2, 4, 128, 8), (2, 4, 128, 8), "bhtd", False),
    ((1, 2, 64, 64), (1, 2, 32, 64), "bhtd", False),
    ((2, 4, 8, 4), (2, 4, 8, 4), "bhtd", False),
]


@pytest.mark.parametrize("device_type", ["cuda", "cpu"])
@pytest.mark.parametrize("q_shape,k_shape,layout,takes", GATE_CASES)
def test_the_default_route_refuses_what_the_kernels_refuse(
        device_type, q_shape, k_shape, layout, takes):
    """On the card the default route takes the kernels exactly where
    ``flash_supported`` admits the block pair (the JAX gate's shape check,
    ``ompi_tpu/ops/ring_attention.py:120-133``) and raises where it refuses
    it, never running plain attention there unasked; off the card it always
    takes the plain path."""
    assert tfa.flash_supported(q_shape, k_shape, layout) == takes
    if device_type == "cuda" and not takes:
        with pytest.raises(ValueError, match="use_flash=False"):
            tra.flash_default(device_type, q_shape, k_shape, layout)
    else:
        assert tra.flash_default(device_type, q_shape, k_shape, layout) == (
            device_type == "cuda")


def test_sp_size_must_match_the_mesh():
    q = torch.zeros(1, 64, 1, 16)
    with pytest.raises(ValueError):
        tra.ring_attention(q, q, q, "sp", 2)


# ------------------------------------------------------- sp > 1, one world


def _ring_inputs(case):
    """Global q, k, v and the output cotangent of a case, [B, S, H, D] or
    [B, H, S, D]; both routes of a case draw the same."""
    sp, causal, layout, _ = case
    rng = np.random.RandomState(100 * sp + 10 * causal + (layout == "bhtd"))
    shape = (B, S, H, D) if layout == "bthd" else (B, H, S, D)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(4)]


def _rank_ring():
    """Every ring case on this rank: rank 0 returns, for each, the global
    output of ``ring_attention_sharded``, the global output and q, k, v
    gradients gathered from the local shards' backward, and whether each
    rank's gradients are finite."""
    r = torch.distributed.get_rank()
    out = []
    for sp in (2, 4, 8):
        taxes.init_mesh(8 // sp, sp, 1, device="cpu")
        for case in (c for c in RING_CASES if c[0] == sp):
            _, causal, layout, route = case
            q, k, v, g = (torch.from_numpy(x) for x in _ring_inputs(case))
            kw = dict(causal=causal, layout=layout,
                      use_flash=route == "flash")
            sharded = tra.ring_attention_sharded(q, k, v, "sp", **kw)
            tdim = 2 if layout == "bhtd" else 1
            n = S // sp
            mine = lambda x: x.narrow(tdim, taxes.rank("sp") * n, n)
            local = [mine(x).clone().requires_grad_() for x in (q, k, v)]
            o = tra.ring_attention(*local, "sp", sp, **kw)
            o.backward(mine(g))
            gather = lambda x: taxes.allgather(x, "sp", concat_dim=tdim)
            with torch.no_grad():
                got = [gather(o)] + [gather(x.grad) for x in local]
            finite = all(bool(torch.isfinite(x.grad).all()) for x in local)
            if r == 0:
                out.append((sharded.numpy(), [x.numpy() for x in got],
                            finite))
            else:
                out.append((None, None, finite))
    return out


@pytest.fixture(scope="module")
def ring_world():
    return run_world(_rank_ring, 8, "cpu", shape=(4, 2, 1))


@pytest.fixture(scope="module")
def jax_ring():
    """JAX ``ring_attention_sharded`` at each sp on the virtual CPU mesh:
    (output, q/k/v gradients) per case, in the case's layout."""
    res = {}
    for sp in (2, 4, 8):
        mesh = Mesh(np.array(jax.devices()[:sp]), ("sp",))
        for causal in (True, False):
            fn = jax.jit(lambda q, k, v, c=causal, m=mesh:
                         jra.ring_attention_sharded(q, k, v, m, "sp", c))
            for layout in ("bthd", "bhtd"):
                case = (sp, causal, layout, "chunked")
                q, k, v, g = _ring_inputs(case)
                tr = (lambda x: x) if layout == "bthd" else (
                    lambda x: np.swapaxes(x, 1, 2))
                y, back = jax.vjp(fn, *(jnp.asarray(tr(x)) for x in (q, k, v)))
                grads = back(jnp.asarray(tr(g)))
                res[sp, causal, layout] = [tr(np.asarray(x))
                                           for x in (y, *grads)]
    return res


@pytest.mark.parametrize("case", RING_CASES,
                         ids=[f"sp{c[0]}-{'causal' if c[1] else 'full'}-"
                              f"{c[2]}-{c[3]}" for c in RING_CASES])
def test_ring_matches_jax_ring_attention_sharded(ring_world, jax_ring, case):
    sharded, got, _ = ring_world[0][RING_CASES.index(case)]
    sp, causal, layout, route = case
    ref = jax_ring[sp, causal, layout]
    tol = 1e-4 if route == "chunked" else 2e-2
    np.testing.assert_allclose(sharded, ref[0], rtol=tol, atol=tol)
    for name, a, b in zip(("out", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=name)
    # and the dense reference of the whole sequence
    q, k, v, _ = _ring_inputs(case)
    tr = (lambda x: x) if layout == "bthd" else (
        lambda x: np.swapaxes(x, 1, 2))
    dense = tr(np.asarray(jra.reference_attention(
        *(jnp.asarray(tr(x)) for x in (q, k, v)), causal=causal)))
    np.testing.assert_allclose(sharded, dense, rtol=tol, atol=tol)


def test_every_rank_gets_finite_ring_gradients(ring_world):
    assert all(f for rank in ring_world for _, _, f in rank)


@pytest.mark.parametrize("use_flash", [False, True],
                         ids=["chunked", "flash"])
def test_merge_with_a_fully_masked_block_has_finite_gradients(use_flash):
    """A causal triangle merged with a "none" block (every row fully
    masked: out 0, lse -1e30), as a ring step merges it, with random
    cotangents on both the merged output and the merged lse: the
    sentinel keeps every gradient finite, and the masked block's k and v
    get exact zeros."""
    rng = np.random.RandomState(9)
    q, k, v, k2, v2, g = (torch.from_numpy(rng.standard_normal(
        (1, 2, 64, 16)).astype(np.float32)).requires_grad_()
        for _ in range(6))
    g_lse = torch.from_numpy(rng.standard_normal((1, 2, 64)).astype(
        np.float32))
    block = lambda kk, vv, kf, kt: tra._one_block(
        q, kk, vv, kf, kt, 0.25, None, 16, use_flash, "bhtd")
    o1, l1 = block(k, v, False, True)
    o2, l2 = block(k2, v2, False, False)
    assert not o2.any() and bool((l2 == np.float32(tra.NEG_BIG)).all())
    lse = torch.logaddexp(l1, l2)
    out = (o1 * torch.exp(l1 - lse)[..., None]
           + o2 * torch.exp(l2 - lse)[..., None])
    torch.autograd.backward((out, lse), (g.detach(), g_lse))
    for x in (q, k, v, k2, v2):
        assert bool(torch.isfinite(x.grad).all())
    assert not k2.grad.any() and not v2.grad.any()
