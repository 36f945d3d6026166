"""The port's flash_block gradients against the JAX Pallas kernels' VJP.

On the CPU the port's ``_Flash`` takes the plain versions of its kernels
(``flash_block_reference`` forward, ``flash_block_bwd_reference`` backward)
and the JAX ``flash_block`` runs its ``_dq_kernel``/``_dkv_kernel`` in
interpret mode under ``jax.vjp``; both get the same numpy inputs and
cotangents, a random output cotangent and a non-zero lse cotangent.
Tolerance 6e-2, JAX's own for the kernels' gradients against dense
attention (bf16 operands, P and dS rounded to bf16 on both sides, sums in
other orders). The "none" block's gradients are exact zeros on both sides.
The CUDA kernels are held against the plain version on the card by
``test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from ompi_tpu.ops import flash_attention as jfa
from ompi_tpu_torch.ops import flash_attention as tfa

B, T, H, D = 2, 64, 2, 16
RELATIONS = {"causal": (0.0, 1.0), "full": (1.0, 0.0), "none": (0.0, 0.0)}


def _inputs(layout, seed=0):
    """q, k, v, the output cotangent (in ``layout``) and the lse cotangent
    [B, H, T], as float32 numpy arrays."""
    rng = np.random.RandomState(seed)
    shape = (B, T, H, D) if layout == "bthd" else (B, H, T, D)
    q, k, v, g_out = (rng.standard_normal(shape).astype(np.float32)
                      for _ in range(4))
    g_lse = rng.standard_normal((B, H, T)).astype(np.float32)
    return q, k, v, g_out, g_lse


def _jax_grads(q, k, v, g_out, g_lse, kf, kt, layout):
    def f(q_, k_, v_):
        return jfa.flash_block(q_, k_, v_, kf, kt, interpret=True,
                               layout=layout)

    _, vjp = jax.vjp(f, jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    return [np.asarray(g) for g in vjp((jnp.asarray(g_out),
                                        jnp.asarray(g_lse)))]


def _torch_grads(q, k, v, g_out, g_lse, kf, kt, layout):
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, lse = tfa.flash_block(tq, tk, tv, kf, kt, layout=layout)
    torch.autograd.backward((out, lse), (torch.from_numpy(g_out),
                                         torch.from_numpy(g_lse)))
    return [x.grad.numpy() for x in (tq, tk, tv)]


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("relation", sorted(RELATIONS))
def test_flash_block_grads_match_jax(relation, layout):
    kf, kt = RELATIONS[relation]
    args = _inputs(layout)
    ref = _jax_grads(*args, kf, kt, layout)
    got = _torch_grads(*args, kf, kt, layout)
    for name, g, r in zip(("dq", "dk", "dv"), got, ref):
        assert g.shape == r.shape and g.dtype == np.float32, name
        if relation == "none":
            assert not g.any() and not r.any(), name
            continue
        np.testing.assert_allclose(g, r, atol=6e-2, rtol=6e-2, err_msg=name)


def test_lse_cotangent_is_honoured():
    """With a zero output cotangent, the gradient comes from g_lse alone:
    d lse / d q is the attention-weighted mean of the keys (times sm_scale)
    and must not vanish."""
    q, k, v, _, g_lse = _inputs("bthd", 1)
    zero = np.zeros_like(q)
    got = _torch_grads(q, k, v, zero, g_lse, 0.0, 1.0, "bthd")
    ref = _jax_grads(q, k, v, zero, g_lse, 0.0, 1.0, "bthd")
    assert np.abs(got[0]).max() > 0.1
    assert not got[2].any()  # v does not enter lse
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, r, atol=6e-2, rtol=6e-2)


def test_plain_backward_is_the_functions_gradient():
    """flash_block_bwd_reference called directly gives what autograd gives
    through _Flash, and bf16 inputs get bf16 gradients."""
    q, k, v, g_out, g_lse = _inputs("bhtd", 2)
    tq, tk, tv = (torch.from_numpy(x).bfloat16().requires_grad_()
                  for x in (q, k, v))
    out, lse = tfa.flash_block(tq, tk, tv, False, True, layout="bhtd")
    torch.autograd.backward((out, lse), (torch.from_numpy(g_out),
                                         torch.from_numpy(g_lse)))
    delta = tfa.flash_delta(out.detach().to(torch.bfloat16),
                            torch.from_numpy(g_out), torch.from_numpy(g_lse),
                            "bhtd")
    direct = tfa.flash_block_bwd(tq.detach(), tk.detach(), tv.detach(),
                                 torch.from_numpy(g_out), lse.detach(), delta,
                                 False, True, layout="bhtd")
    for x, d in zip((tq, tk, tv), direct):
        assert x.grad.dtype == torch.bfloat16
        torch.testing.assert_close(x.grad, d.to(torch.bfloat16), atol=0,
                                   rtol=0)


def test_grad_needs_no_lse_cotangent():
    """Only ``out`` used: autograd passes no lse cotangent, which counts as
    zeros."""
    q, k, v, g_out, _ = _inputs("bthd", 3)
    got = _torch_grads(q, k, v, g_out, np.zeros((B, H, T), np.float32),
                       0.0, 1.0, "bthd")
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out, _ = tfa.flash_block(tq, tk, tv, False, True)
    out.backward(torch.from_numpy(g_out))
    for x, g in zip((tq, tk, tv), got):
        np.testing.assert_array_equal(x.grad.numpy(), g)


def test_cpu_backward_launches_nothing_and_kernels_refuse_cpu():
    q, k, v, g_out, g_lse = (torch.from_numpy(x) for x in _inputs("bthd"))
    before = (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES)
    q.requires_grad_()
    out, _ = tfa.flash_block(q, k, v, False, True)
    out.backward(g_out)
    assert (tfa.KERNEL_LAUNCHES, tfa.DQ_LAUNCHES, tfa.DKV_LAUNCHES) == before
    lse = torch.zeros(B, H, T)
    for fn in (tfa.flash_dq, tfa.flash_dkv):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q.detach(), k, v, g_out, lse, lse, False, True, 0.25, "bthd")
