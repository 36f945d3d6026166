"""The plain reference against the program (ompi_tpu_torch's transformer,
its CPU path) at a tiny size: the same weights and tokens give the same
logits, loss, gradients and update, within the program's bf16 products."""

import pytest
import torch

import toy_cells  # noqa: F401  (the repository on sys.path)

from benchmark.lib import weights
from benchmark.reference import opt
from ompi_tpu_torch.models import transformer as tfm

D = weights.Dims(vocab=256, d_model=64, n_heads=4, n_layers=2, d_ff=128,
                 seq_len=128, lr=0.01)
CFG = tfm.Config(vocab=D.vocab, d_model=D.d_model, n_heads=D.n_heads,
                 n_layers=D.n_layers, d_ff=D.d_ff, seq_len=D.seq_len,
                 lr=D.lr)


def _tokens(seed, b=2, t=64):
    x = weights.token_rows(seed, "test", b, t + 1, D.vocab, "cpu")
    return x[:, :-1], x[:, 1:]


def _rel(a, b):
    return float((a - b).norm() / b.norm())


@pytest.mark.parametrize("seed", [1, 2_718_281_828_459])
def test_logits_match_the_program(seed):
    params = weights.make_params(D, seed, "cpu")
    tokens, _ = _tokens(seed)
    got = tfm.forward(params, tokens, CFG)
    ref = opt.forward_logits(params, tokens, D.n_heads)
    assert got.shape == ref.shape == (2, 64, D.vocab)
    # bf16 operands in the program (8 bits of mantissa, about 0.4% a
    # product): logits of unit scale agree to 5e-2
    assert float((got - ref).abs().max()) < 5e-2
    assert _rel(got, ref) < 1e-2


def test_query_blocks_equal_one_dense_block(monkeypatch):
    params = weights.make_params(D, 5, "cpu")
    tokens, _ = _tokens(5, t=96)
    dense = opt.forward_logits(params, tokens, D.n_heads)
    monkeypatch.setattr(opt, "QUERY_BLOCK", 32)
    blocked = opt.forward_logits(params, tokens, D.n_heads)
    assert torch.allclose(blocked, dense, atol=1e-5, rtol=1e-5)


def test_loss_gradients_and_update_match_the_program():
    params = weights.make_params(D, 7, "cpu")
    tokens, targets = _tokens(7)
    loss, grads = tfm.loss_and_grads(params, tokens, targets, CFG)
    ref_loss, ref_grads = opt.loss_and_grads(params, tokens, targets,
                                             D.n_heads)
    assert abs(float(loss) - ref_loss) < 2e-3
    got = dict(zip([k for k, _ in weights.leaves(params)],
                   [g for _, g in weights.leaves(_tree(params, grads))]))
    # bf16 cotangents (rounded at every product) through two layers and
    # the attention: 3 to 6% a leaf at this size
    for name, g in weights.leaves(ref_grads):
        assert _rel(got[name], g) < 0.1, name

    # one step each from the same start moves every leaf alike
    step, _ = tfm.make_train_step(CFG, "cpu")
    mine = weights.make_params(D, 7, "cpu")
    step(mine, tokens, targets)
    theirs = weights.make_params(D, 7, "cpu")
    opt.sgd(theirs, ref_grads, D.lr)
    start = dict(weights.leaves(weights.make_params(D, 7, "cpu")))
    for (name, a), (_, b) in zip(weights.leaves(mine),
                                 weights.leaves(theirs)):
        assert _rel(a - start[name], b - start[name]) < 0.1, name


def _tree(params, grads):
    """The program's gradient list (``param_leaves`` order) as a tree."""
    it = iter(grads)

    def build(t):
        if isinstance(t, dict):
            return {k: build(t[k]) for k in sorted(t)}
        if isinstance(t, list):
            return [build(x) for x in t]
        return next(it)

    return build(params)


def test_float8_control_is_further_from_the_reference_than_the_program():
    params = weights.make_params(D, 11, "cpu")
    tokens, _ = _tokens(11)
    ref = opt.forward_logits(params, tokens, D.n_heads)
    got = tfm.forward(params, tokens, CFG)
    low = opt.forward_logits(params, tokens, D.n_heads, "fp8")
    assert _rel(low, ref) > 4 * _rel(got, ref)


def test_exact_f32_restores_the_tf32_flags():
    before = torch.backends.cuda.matmul.allow_tf32
    with opt.exact_f32():
        assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cuda.matmul.allow_tf32 == before
