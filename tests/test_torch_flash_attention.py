"""The port's flash_block against the JAX Pallas kernel.

On the CPU the port's wrapper takes its plain version
(``flash_block_reference``) and the JAX kernel runs in interpret mode; both
get the same numpy inputs. Tolerances: 2e-2 on ``out`` and 1e-2 on ``lse``
(the JAX kernel's own test tolerance against dense attention; bf16 operands
on both sides, summed in different orders).
The CUDA kernel is held against the plain version on the card by
``test_torch_cuda_kernels.py``.
"""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from ompi_tpu.ops import flash_attention as jfa
from ompi_tpu.ops.ring_attention import reference_attention as jref
from ompi_tpu_torch.ops import flash_attention as tfa

B, T, H, D = 2, 64, 2, 16
RELATIONS = {"causal": (0.0, 1.0), "full": (1.0, 0.0), "none": (0.0, 0.0)}


def _qkv(seed=0, shape=(B, T, H, D)):
    rng = np.random.RandomState(seed)
    return tuple(rng.standard_normal(shape).astype(np.float32)
                 for _ in range(3))


def _to_layout(x, layout):
    return x if layout == "bthd" else np.ascontiguousarray(
        x.transpose(0, 2, 1, 3))


@pytest.mark.parametrize("layout", ["bthd", "bhtd"])
@pytest.mark.parametrize("relation", sorted(RELATIONS))
def test_flash_block_matches_jax(relation, layout):
    kf, kt = RELATIONS[relation]
    q, k, v = (_to_layout(x, layout) for x in _qkv())
    o_j, l_j = jfa.flash_block(jnp.asarray(q), jnp.asarray(k),
                               jnp.asarray(v), kf, kt, interpret=True,
                               layout=layout)
    o_t, l_t = tfa.flash_block(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), kf, kt, layout=layout)
    assert o_t.dtype == torch.float32 and l_t.shape == (B, H, T)
    np.testing.assert_allclose(o_t.numpy(), np.asarray(o_j), atol=2e-2,
                               rtol=2e-2)
    np.testing.assert_allclose(l_t.numpy(), np.asarray(l_j), atol=1e-2,
                               rtol=1e-2)


def test_none_block_is_exact_sentinel():
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    out, lse = tfa.flash_block(q, k, v, False, False)
    assert bool((out == 0.0).all())
    assert bool((lse == np.float32(tfa.NEG_BIG)).all())


def test_tensor_flags_and_bf16_inputs():
    """0-d tensor flags and bf16 inputs give what bools and f32 inputs do
    (the inputs are rounded to bf16 either way)."""
    q, k, v = (torch.from_numpy(x) for x in _qkv(1))
    o1, l1 = tfa.flash_block(q, k, v, torch.tensor(0.0), torch.tensor(1.0))
    o2, l2 = tfa.flash_block(q.bfloat16(), k.bfloat16(), v.bfloat16(),
                             False, True)
    torch.testing.assert_close(o1, o2, atol=0, rtol=0)
    torch.testing.assert_close(l1, l2, atol=0, rtol=0)


def test_cpu_path_launches_nothing():
    before = tfa.KERNEL_LAUNCHES
    q, k, v = (torch.from_numpy(x) for x in _qkv())
    tfa.flash_block(q, k, v, False, True)
    assert tfa.KERNEL_LAUNCHES == before


def test_ring_merge_of_two_blocks_matches_dense():
    """Two blocks merged in (out, lse) space == dense attention over the
    concatenated keys: the ring combine the lse output exists for."""
    q, k, v = _qkv(2, (1, 32, 1, 16))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    o1, l1 = tfa.flash_block(tq, tk[:, :16], tv[:, :16], True, False)
    o2, l2 = tfa.flash_block(tq, tk[:, 16:], tv[:, 16:], True, False)
    ln = torch.logaddexp(l1, l2)
    lift = lambda x: x.transpose(1, 2)[..., None]
    merged = o1 * lift(torch.exp(l1 - ln)) + o2 * lift(torch.exp(l2 - ln))
    ref = np.asarray(jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                          causal=False))
    np.testing.assert_allclose(merged.numpy(), ref, atol=2e-2, rtol=2e-2)


def test_flash_supported_gate():
    assert tfa.flash_supported((8, 8, 1024, 128), (8, 8, 1024, 128), "bhtd")
    assert tfa.flash_supported((4, 256, 8, 32), (4, 256, 8, 32))
    assert not tfa.flash_supported((2, 96, 4, 64), (2, 96, 4, 64))   # tile
    assert not tfa.flash_supported((2, 64, 4, 24), (2, 64, 4, 24))   # D%16
    assert not tfa.flash_supported((2, 64, 4, 256), (2, 64, 4, 256))  # D>128
    # K/V stream through shared memory: a long KV shard is still taken
    assert tfa.flash_supported((1, 256, 1, 128), (1, 1 << 20, 1, 128))
    with pytest.raises(ValueError):
        tfa.flash_supported((1, 64, 1, 16), (1, 64, 1, 16), "btdh")
