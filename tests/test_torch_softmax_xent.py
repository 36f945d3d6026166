"""The port's chunked softmax cross-entropy against the JAX op.

Same shapes as ``tests/test_softmax_xent.py`` (B=2, T=64, D=32, V=101), the
same numpy inputs on both sides. The port and the JAX op run the same
arithmetic (bf16 products with f32 sums, the gold logit from the gathered
embedding row, the bf16 (softmax - onehot) rows in the backward), so the
loss is held to 1e-5 relative and the gradients to 1e-4 (f32 sums in other
orders; a rare bf16 rounding flip of one (softmax - onehot) entry moves a
gradient by at most 2e-3 of a small value). Against the dense f32
reference the tolerances are those of the JAX op's own test: 1e-2 on the
loss, 6e-2 on the gradients.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ompi_tpu.ops import softmax_xent as jxent
from ompi_tpu_torch.ops import softmax_xent as txent


def _data(B=2, T=64, D=32, V=101, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.standard_normal((B, T, D)).astype(np.float32)
    w = rng.standard_normal((V, D)).astype(np.float32)
    t = rng.randint(0, V, size=(B, T)).astype(np.int32)
    return x, w, t


def _jax(x, w, t, chunk_t):
    f = lambda a, b: jxent.softmax_xent_sum(a, b, jnp.asarray(t), chunk_t)
    loss, vjp = jax.vjp(f, jnp.asarray(x), jnp.asarray(w))
    gx, gw = vjp(jnp.float32(1.0))
    return float(loss), np.asarray(gx), np.asarray(gw)


def _torch(x, w, t, chunk_t):
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    loss = txent.softmax_xent_sum(tx, tw, torch.from_numpy(t), chunk_t)
    loss.backward()
    return float(loss.detach()), tx.grad.numpy(), tw.grad.numpy()


@pytest.mark.parametrize("T,chunk_t", [(64, 16), (64, 64), (64, 128),
                                       (48, 32)])
def test_softmax_xent_matches_jax(T, chunk_t):
    """Value and gradients; 48 % 32 != 0, so the chunk shrinks to 16 on
    both sides."""
    x, w, t = _data(T=T)
    l_j, gx_j, gw_j = _jax(x, w, t, chunk_t)
    l_t, gx_t, gw_t = _torch(x, w, t, chunk_t)
    assert abs(l_t - l_j) <= 1e-5 * abs(l_j)
    np.testing.assert_allclose(gx_t, gx_j, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(gw_t, gw_j, rtol=1e-4, atol=1e-4)


def test_softmax_xent_matches_dense_reference():
    x, w, t = _data(seed=1)
    l_t, gx_t, gw_t = _torch(x, w, t, 16)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    ref = txent.reference_xent_sum(tx, tw, torch.from_numpy(t))
    ref.backward()
    ref = float(ref.detach())
    assert abs(l_t - ref) < 1e-2 * max(abs(ref), 1.0)
    np.testing.assert_allclose(gx_t, tx.grad.numpy(), atol=6e-2, rtol=6e-2)
    np.testing.assert_allclose(gw_t, tw.grad.numpy(), atol=6e-2, rtol=6e-2)


def test_reference_xent_sum_matches_jax():
    x, w, t = _data(seed=2)
    ref = float(jxent.reference_xent_sum(jnp.asarray(x), jnp.asarray(w),
                                         jnp.asarray(t)))
    out = float(txent.reference_xent_sum(torch.from_numpy(x),
                                         torch.from_numpy(w),
                                         torch.from_numpy(t)))
    assert abs(out - ref) <= 1e-5 * abs(ref)


def test_chunk_count_matches_jax():
    for T, c in [(64, 128), (64, 16), (48, 32), (7, 4), (1024, 128)]:
        assert txent._chunk_count(T, c) == jxent._chunk_count(T, c)


def test_loss_cotangent_scales_the_gradients():
    """The loss cotangent folds into dx and dw, as in the JAX backward."""
    x, w, t = _data(seed=3)
    _, gx, gw = _torch(x, w, t, 16)
    tx, tw = (torch.from_numpy(a).requires_grad_() for a in (x, w))
    (txent.softmax_xent_sum(tx, tw, torch.from_numpy(t), 16) * 0.5).backward()
    np.testing.assert_allclose(tx.grad.numpy(), 0.5 * gx, rtol=1e-6)
    np.testing.assert_allclose(tw.grad.numpy(), 0.5 * gw, rtol=1e-6)
