"""Gradients of the port's bf16 products against JAX's.

``einsum_bf16`` is held against ``jax.vjp`` of the JAX ``mxu.einsum_bf16``
(its ``_mm_bwd``), and ``contract_f32`` against ``jax.vjp`` of the JAX
model's product, ``einsum`` of bf16-cast operands with
``preferred_element_type=float32``, on the same numpy inputs and
cotangents. Each cotangent comes back rounded to bf16 on both sides, so
``einsum_bf16``'s, whose products are the same on both sides, are held to
one bf16 ulp (8e-3 relative). For ``contract_f32`` the port also rounds the
f32 output cotangent g to bf16 before its products, where JAX's AD on the
CPU keeps it in f32. That moves each product by at most 2^-9 of its size,
so a gradient entry may move by 2^-9 times the sum of the absolute values
of its products (which cancellation can make large against the entry),
besides the final rounding on each side: the test holds each entry to that
bound, computed from the absolute values, plus two bf16 ulps of the entry.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ompi_tpu.ops import mxu as jmxu
from ompi_tpu_torch.ops import mxu as tmxu

PATTERNS = [("btd,dhf->bhtf", (2, 8, 16), (16, 4, 8)),
            ("btd,df->btf", (2, 8, 16), (16, 24)),
            ("bhtf,hfd->btd", (2, 4, 8, 8), (4, 8, 16)),
            ("btd,vd->btv", (2, 8, 16), (12, 16))]


def _rand(shape, rng):
    return rng.standard_normal(shape).astype(np.float32)


def _bf16(x):
    return np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)


def _port_grads(fn, pattern, a, b, g, dtype):
    ta, tb = (torch.from_numpy(x).to(dtype).requires_grad_() for x in (a, b))
    out = fn(pattern, ta, tb)
    out.backward(torch.from_numpy(g).to(out.dtype))
    return ta.grad, tb.grad


@pytest.mark.parametrize("pattern,sa,sb", PATTERNS)
def test_einsum_bf16_grads_match_jax(pattern, sa, sb):
    rng = np.random.RandomState(0)
    a, b = _bf16(_rand(sa, rng)), _bf16(_rand(sb, rng))
    out_shape = np.einsum(pattern, a, b).shape
    g = _bf16(_rand(out_shape, rng))
    _, vjp = jax.vjp(lambda x, y: jmxu.einsum_bf16(pattern, x, y),
                     jnp.asarray(a, jnp.bfloat16), jnp.asarray(b, jnp.bfloat16))
    ref = vjp(jnp.asarray(g, jnp.bfloat16))
    got = _port_grads(tmxu.einsum_bf16, pattern, a, b, g, torch.bfloat16)
    for x, r in zip(got, ref):
        assert x.dtype == torch.bfloat16
        np.testing.assert_allclose(x.float().numpy(),
                                   np.asarray(r, np.float32),
                                   rtol=8e-3, atol=1e-2)


@pytest.mark.parametrize("pattern,sa,sb", PATTERNS)
def test_contract_f32_grads_match_jax(pattern, sa, sb):
    """f32 operands, cast to bf16 inside the product as the JAX model casts
    them; their cotangents come back in f32 after a bf16 rounding."""
    rng = np.random.RandomState(1)
    a, b = _rand(sa, rng), _rand(sb, rng)
    g = _rand(np.einsum(pattern, a, b).shape, rng)

    def f(x, y):
        return jnp.einsum(pattern, x.astype(jnp.bfloat16),
                          y.astype(jnp.bfloat16),
                          preferred_element_type=jnp.float32)

    _, vjp = jax.vjp(f, jnp.asarray(a), jnp.asarray(b))
    ref = vjp(jnp.asarray(g))
    # the sums of |products| behind each gradient entry
    _, vjp_abs = jax.vjp(lambda x, y: jnp.einsum(pattern, x, y),
                         jnp.abs(_bf16(a)), jnp.abs(_bf16(b)))
    sizes = vjp_abs(jnp.abs(jnp.asarray(g)))
    got = _port_grads(tmxu.contract_f32, pattern, a, b, g, torch.float32)
    for x, r, m in zip(got, ref, sizes):
        assert x.dtype == torch.float32
        r, m = np.asarray(r), np.asarray(m)
        err = np.abs(x.numpy() - r)
        assert np.all(err <= 2.0 ** -9 * m + 2.0 ** -7 * np.abs(r) + 1e-6), \
            float(err.max())


def test_grad_of_one_operand_only():
    """A product whose weight needs no gradient computes only dx."""
    rng = np.random.RandomState(2)
    x = torch.from_numpy(_rand((2, 8, 16), rng)).requires_grad_()
    w = torch.from_numpy(_rand((16, 24), rng))
    tmxu.einsum_bf16("btd,df->btf", x, w).float().sum().backward()
    assert x.grad is not None and x.grad.dtype == torch.float32
    assert w.grad is None
