"""The port's sp=1 ring attention and dense reference against JAX.

JAX's ``ring_attention`` runs under ``shard_map`` on a 1-device 'sp' mesh
and, on the CPU, takes its chunked lax path; the port on the CPU takes its
chunked plain path. Same algorithm and bf16 rounding, other summation
order: tolerance 1e-4 where both sides compute in f32 end to end, 1e-2 where
the result is rounded to bf16 (one bf16 ulp at these magnitudes).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P

import torch

from ompi_tpu.ops import ring_attention as jra
from ompi_tpu.parallel.axes import shard_map_compat
from ompi_tpu_torch.ops import ring_attention as tra

B, T, H, D = 2, 32, 2, 16


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
    assert not tra.use_flash_default(q)


def test_sp_above_one_is_not_ported_yet():
    q = torch.zeros(1, 8, 1, 16)
    with pytest.raises(NotImplementedError):
        tra.ring_attention(q, q, q, "sp", 2)
